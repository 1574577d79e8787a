from .reader import CityscapesDataset
from .synthetic import make_synthetic_cityscapes_tree
from .transforms import make_eval_transform_fn, make_eval_loader
from .augment import (AugmentConfig, sample_affine_matrices_np, warp_pair_batch,
                      make_warp_transform, photometric_params, device_post, make_device_post_fn)
from .pipeline import ShardedSampler, make_train_loader

__all__ = ['CityscapesDataset', 'make_synthetic_cityscapes_tree',
           'make_eval_transform_fn', 'make_eval_loader', 'AugmentConfig',
           'sample_affine_matrices_np', 'warp_pair_batch', 'make_warp_transform',
           'photometric_params', 'device_post', 'make_device_post_fn', 'ShardedSampler',
           'make_train_loader']
