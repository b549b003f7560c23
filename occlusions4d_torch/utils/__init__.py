'''Host-side helpers (numpy).'''

from .misc import multi_track_merge
