from .engine import FALLBACK_IDS, BatchedEngine, InferenceEngine, make_serving_program
from .export import (
    build_task_model,
    export_model,
    export_serving_program,
    load_bundle,
    load_engine,
    load_serving_program,
)
from .import_weights import (
    diff_variables,
    import_by_structure,
    import_reference_h5,
    load_h5_weights,
    load_tflite_weights,
)
from .streaming import BlockState, StreamingEncoder, StreamState
from .translation_engine import BatchedTranslationEngine, TranslationEngine

__all__ = ["FALLBACK_IDS", "BatchedEngine", "BatchedTranslationEngine",
           "BlockState", "InferenceEngine", "StreamState", "StreamingEncoder",
           "TranslationEngine", "build_task_model",
           "diff_variables", "export_model", "export_serving_program",
           "import_by_structure", "import_reference_h5", "load_bundle",
           "load_engine", "load_h5_weights", "load_serving_program",
           "load_tflite_weights", "make_serving_program"]
