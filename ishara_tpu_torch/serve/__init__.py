from .engine import FALLBACK_IDS, BatchedEngine, InferenceEngine, make_serving_program
from .translation_engine import BatchedTranslationEngine, TranslationEngine

__all__ = ["FALLBACK_IDS", "BatchedEngine", "BatchedTranslationEngine",
           "InferenceEngine", "TranslationEngine", "make_serving_program"]
