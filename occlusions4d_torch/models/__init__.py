'''Model stack: point-transformer encoder + implicit 4D-field decoder (torch).'''

from .layers import NormLayer, VectorAttention, PointTransformerBlock, DownTransition
from .encoder import PointEncoder
from .implicit import (BASE_FREQUENCY, positional_encode, ResnetBlockFC, ResnetFC,
                       LocalImplicitField)
from .fused import fused_field_apply, supports_fused
from .factory import (build_models, build_encoder_args, build_decoder_args,
                      decoder_out_channels, color_channels, track_idx)
