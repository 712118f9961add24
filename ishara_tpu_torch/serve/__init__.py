from .engine import FALLBACK_IDS, BatchedEngine, InferenceEngine, make_serving_program

__all__ = ["FALLBACK_IDS", "BatchedEngine", "InferenceEngine",
           "make_serving_program"]
