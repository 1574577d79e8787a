from .mesh import (TIMEOUT, distributed_init_kwargs, initialize_distributed, spawn_ranks,
                   is_master_rank, world_size, rank, all_reduce_sum,
                   data_parallel, barrier, destroy_process_group)

__all__ = ['TIMEOUT', 'distributed_init_kwargs', 'initialize_distributed', 'spawn_ranks',
           'is_master_rank', 'world_size', 'rank', 'all_reduce_sum',
           'data_parallel', 'barrier', 'destroy_process_group']
