'''Host-side helpers (numpy), phase timing and logging.'''

from .misc import (accumulate_pcl_time, merge_pcl_views, elitist_shuffle,
                   multi_track_merge, get_data_kind, find_mask_ranges)
