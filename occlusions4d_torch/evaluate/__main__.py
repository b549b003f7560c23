'''python -m occlusions4d_torch.evaluate [flags of config.TestConfig]: the eval
driver on the card (evaluate/test_driver.py).'''

from ..config import test_args
from .test_driver import main

if __name__ == '__main__':
    main(test_args())
