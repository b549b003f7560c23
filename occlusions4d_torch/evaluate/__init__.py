'''Evaluation: model loading and the dense inference engine.'''

from .inference import (load_models, squash_eval, InferenceEngine, dispatch_inference,
                        finish_inference, perform_inference)
