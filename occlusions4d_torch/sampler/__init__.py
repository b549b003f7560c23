'''Guided query sampling for training (torch).'''

from .guided import SamplerConfig, GuidedPointSampler
