'''Data plane: GREATER + CARLA-4D readers, the train, val and test
loaders, synthetic fixtures, and a standard-library PNG codec (own copy of
occlusions4d_tpu/data; numpy and C++ host code, no imaging package).'''

from .greater import GreaterDataset
from .carla import CarlaDataset
from .loader import Loader, collate, create_test_loader, create_train_val_loaders
from . import synthetic
