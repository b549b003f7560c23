'''Devices, process groups and collectives of data-parallel training and
query-sharded eval (port of occlusions4d_tpu/parallel).'''

from .mesh import (AllReduceSum, Group, all_reduce_flat, all_reduce_sum, all_true, barrier,
                   broadcast_flat, broadcast_object, destroy_group, group_backend, host_sum,
                   init_group, local_devices, rank_batches, rank_seed,
                   resolve_data_parallel, shard_rows, spawn, torchrun_env)

__all__ = ['AllReduceSum', 'Group', 'all_reduce_flat', 'all_reduce_sum', 'all_true',
           'barrier', 'broadcast_flat', 'broadcast_object', 'destroy_group', 'group_backend',
           'host_sum', 'init_group', 'local_devices', 'rank_batches',
           'rank_seed', 'resolve_data_parallel', 'shard_rows', 'spawn', 'torchrun_env']
