"""Training input pipeline: epoch-seeded sample order, decode in worker
processes, pinned uint8 batches.

``ShardedSampler`` is a copy of the JAX package's (data/pipeline.py:26-67),
the reference's ``DistributedSampler(shuffle=True, seed, drop_last=True)``
semantics, so each epoch visits the samples in the JAX package's order:
batch ``b`` of epoch ``e`` holds ``indices_for_epoch(e)[b*B:(b+1)*B]``.
With ``world_size`` ranks each rank takes every ``world_size``-th sample of
that order from its ``rank`` on, as the JAX Loader does for ``(world, r)``.

``make_train_loader`` serves those batches through
``torch.utils.data.DataLoader``: spawned worker processes decode the PNG
pairs with the port's reader (they never touch CUDA), and each batch comes
as ``(images_u8 (B, H, W, 3), labels_u8 (B, H, W), epoch, batch_index)``,
pinned when the device is a card.  ``(epoch, batch_index)`` keys the
batch's warp matrices (data/augment.py::make_warp_transform).
"""

import numpy as np
import torch


class ShardedSampler:
    def __init__(self, num_samples, world_size=1, rank=0, shuffle=True,
                 seed=54321, drop_last=True):
        self.num_samples = num_samples
        self.world_size = world_size
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last

    def indices_for_epoch(self, epoch: int):
        """Per-rank sample indices.  ``drop_last=False`` pads the global
        order cyclically up to a world-size multiple and marks each pad
        entry as ``-(index + 1)``, so a consumer can mask the duplicates."""
        if self.shuffle:
            g = np.random.default_rng(self.seed + epoch)
            order = g.permutation(self.num_samples)
        else:
            order = np.arange(self.num_samples)
        if self.drop_last:
            usable = (len(order) // self.world_size) * self.world_size
            order = order[:usable]
        else:
            pad = self.pad_count()
            if pad:
                fill = np.resize(order, pad)
                order = np.concatenate([order, -(fill + 1)])
        return order[self.rank::self.world_size]

    def pad_count(self) -> int:
        return 0 if self.drop_last else (-self.num_samples) % self.world_size

    def shard_len(self) -> int:
        """len(indices_for_epoch(e)) for any epoch, O(1)."""
        if self.drop_last:
            return self.num_samples // self.world_size
        return (self.num_samples + self.pad_count()) // self.world_size


class EpochBatches(torch.utils.data.Sampler):
    """The full batches of one epoch of a ``ShardedSampler`` (drop_last), as
    lists of (epoch, batch_index, sample_index) keys; ``set_epoch`` picks
    the epoch the next iteration walks."""

    def __init__(self, sampler: ShardedSampler, batch_size: int):
        self.sampler = sampler
        self.batch_size = batch_size
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.sampler.shard_len() // self.batch_size

    def __iter__(self):
        idx = self.sampler.indices_for_epoch(self.epoch)
        for b in range(len(self)):
            yield [(self.epoch, b, int(i)) for i in idx[b * self.batch_size:(b + 1) * self.batch_size]]


class _KeyedPairs(torch.utils.data.Dataset):
    """dataset[(epoch, batch_index, i)] -> (image, label, epoch, batch_index)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, key):
        epoch, batch_index, i = key
        img, seg = self.dataset[i]
        return img, seg, epoch, batch_index


def _collate(samples):
    imgs = torch.from_numpy(np.stack([s[0] for s in samples]))
    segs = torch.from_numpy(np.stack([s[1] for s in samples]))
    return imgs, segs, samples[0][2], samples[0][3]


def make_train_loader(dataset, batch_size: int, num_workers: int, device: torch.device,
                      seed: int, world_size: int = 1, rank: int = 0):
    """Shuffled full batches of ``batch_size`` in the JAX package's order for
    ``seed``, of rank ``rank``'s shard of ``world_size``; call
    ``loader.batch_sampler.set_epoch(epoch)`` before each epoch.  Worker
    processes are spawned, never forked: the parent may hold a CUDA
    context."""
    batches = EpochBatches(ShardedSampler(len(dataset), world_size, rank, shuffle=True, seed=seed,
                                          drop_last=True), batch_size)
    return torch.utils.data.DataLoader(
        _KeyedPairs(dataset), batch_sampler=batches, num_workers=num_workers,
        collate_fn=_collate, pin_memory=device.type == 'cuda',
        multiprocessing_context='spawn' if num_workers > 0 else None)
