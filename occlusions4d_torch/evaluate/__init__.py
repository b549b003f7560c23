'''Evaluation: model loading, the dense inference engine, the eval driver and
the metrics / results tooling.'''

from .inference import (load_models, squash_eval, InferenceEngine, dispatch_inference,
                        finish_inference, perform_inference)
from .test_driver import run_test, main, backfill_from_train
from .results import find_test_result_files, load_test_results, merge_steps_into_long
from .metrics import frame_metrics, evaluate_results, chamfer_distance
