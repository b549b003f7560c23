'''Geometry operators and the kernels that serve them (kNN, FPS, fused decoder
attention and interpolation, the encoder's fused self-attention), plus the
numpy query-grid helpers.'''

from .knn import knn, knn_pruned, pairwise_sqdist, gather_neighbors, hilbert_codes
from .fps import fps_batched
from .interpolate import inverse_distance_weights, knn_interpolate
from .attention import knn_extract, fused_knn_interp, fused_knn_vector_attention
from .self_attention import fused_gathered_attention
from .bounds import Cuboid, blind_sample_bounds
from .sampling import grid_points_numpy, blind_points_numpy
