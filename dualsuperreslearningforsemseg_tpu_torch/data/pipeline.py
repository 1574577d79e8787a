"""Training input pipeline: epoch-seeded sample order, decode in worker
processes, pinned uint8 batches.

``ShardedSampler`` is a copy of the JAX package's (data/pipeline.py:26-67),
the reference's ``DistributedSampler(shuffle=True, seed, drop_last=True)``
semantics, so each epoch visits the samples in the JAX package's order:
batch ``b`` of epoch ``e`` holds ``indices_for_epoch(e)[b*B:(b+1)*B]``.
With ``world_size`` ranks each rank takes every ``world_size``-th sample of
that order from its ``rank`` on, as the JAX Loader does for ``(world, r)``.

``make_train_loader`` serves those batches through
``torch.utils.data.DataLoader``: spawned worker processes read a whole batch
at a time (they never touch CUDA), and each batch comes as ``(images_u8 (B,
H, W, 3), labels_u8 (B, H, W), epoch, batch_index)``, pinned when the
device is a card.  ``(epoch, batch_index)`` keys the batch's warp matrices
(data/augment.py::make_warp_transform).

A batch is read as the JAX Loader reads it (data/pipeline.py:164-212,
294-321 there): with ``DSRL_TPU_RAW_CACHE`` set, the pairs found in the raw
pair cache (data/raw_cache.py) are read back as bytes; the rest are decoded
in one call of the native batched decode (data/native.py) on the worker's
share of the CPUs, ``cpu_count // num_workers`` threads, and stored in the
cache.  Without the native library, or again for a batch its decode fails
on (with one CAUTION), the pairs are decoded with PIL one at a time.  A
dataset without file pairs (``pairs``) or with its own ``transforms`` is
read sample by sample.  ``prime_raw_cache`` fills the cache with one
epoch's shard ahead of the loader, in a background thread.
"""

import os
import threading
import time

import numpy as np
import torch
from PIL import Image

from ..utils.logging import CAUTION
from . import native
from .raw_cache import cache_from_env


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


class _Pairs(torch.utils.data.Dataset):
    """A dataset's (image, labelIds) pairs, read a batch at a time (the
    module docstring) by ``decode``; the loaders' datasets below add what
    each batch carries besides."""

    def __init__(self, dataset, num_workers: int):
        self.dataset = dataset
        self.native_threads = max(1, (os.cpu_count() or 1) // max(1, num_workers))
        self.native_hw = self.raw_cache = None
        pairs = getattr(dataset, 'pairs', None)
        if pairs and getattr(dataset, 'transforms', None) is None:
            with Image.open(pairs[0][0]) as im:
                hw = (im.height, im.width)
            self.native_hw = hw if native.native_available() else None
            self.raw_cache = cache_from_env(hw)
        self._native_warned = False

    def __len__(self):
        return len(self.dataset)

    def _decode(self, real_idx):
        """Dataset entries ``real_idx`` decoded into stacked uint8 arrays."""
        if self.native_hw is not None:
            pairs = [self.dataset.pairs[i] for i in real_idx]
            try:
                return native.decode_pair_batch([p[0] for p in pairs], [p[1] for p in pairs],
                                                self.native_hw, threads=self.native_threads)
            except RuntimeError as ex:
                # As the JAX Loader: the batch is decoded again with PIL, so
                # one odd file does not stop training, and that is said once.
                if not self._native_warned:
                    self._native_warned = True
                    print(CAUTION("native batch decode failed ({}); retrying batches that hit "
                                  "this through the slow PIL path. If it persists, check the "
                                  "dataset files it names.".format(ex)), flush=True)
        samples = [self.dataset[i] for i in real_idx]
        return np.stack([s[0] for s in samples]), np.stack([s[1] for s in samples])

    def decode(self, real_idx):
        """``_decode`` through the raw cache when one is set: hits read back,
        misses decoded in one call and stored."""
        cache = self.raw_cache
        if cache is None:
            return self._decode(real_idx)
        pairs = self.dataset.pairs
        hits = [cache.load(*pairs[i]) for i in real_idx]
        miss = [j for j, hit in enumerate(hits) if hit is None]
        if not miss:
            return np.stack([h[0] for h in hits]), np.stack([h[1] for h in hits])
        m_imgs, m_segs = self._decode([real_idx[j] for j in miss])
        for k, j in enumerate(miss):
            cache.store(*pairs[real_idx[j]], m_imgs[k], m_segs[k])
        if len(miss) == len(real_idx):
            return m_imgs, m_segs
        imgs = np.empty((len(real_idx),) + m_imgs.shape[1:], np.uint8)
        segs = np.empty((len(real_idx),) + m_segs.shape[1:], np.uint8)
        for j, hit in enumerate(hits):
            if hit is not None:
                imgs[j], segs[j] = hit
        for k, j in enumerate(miss):
            imgs[j], segs[j] = m_imgs[k], m_segs[k]
        return imgs, segs

    def prime(self, order, background=True):
        """Decodes every pair of ``order`` (dataset indices; a pad entry
        ``-(i + 1)`` stands for i) that the cache lacks, in that order, in
        chunks of 8, and stores it: JAX data/pipeline.py:217-279.
        Presence is probed with ``has`` (one stat), and again before each
        chunk, so the primer skips what the loader has stored since.
        Returns None without a cache; else the started daemon thread, whose
        ``stats`` dict ``{'primed', 'skipped', 'seconds'}`` counts as it
        goes (``background``), or that dict when done."""
        cache = self.raw_cache
        if cache is None:
            return None
        pairs = self.dataset.pairs
        real = list(dict.fromkeys(int(i) if i >= 0 else int(-(i + 1)) for i in order))
        stats = {'primed': 0, 'skipped': 0, 'seconds': 0.0}

        def run():
            t0 = time.perf_counter()
            miss = [i for i in real if not cache.has(*pairs[i])]
            stats['skipped'] = len(real) - len(miss)
            for start in range(0, len(miss), 8):
                todo = [i for i in miss[start:start + 8] if not cache.has(*pairs[i])]
                if todo:
                    imgs, segs = self._decode(todo)
                    for k, i in enumerate(todo):
                        cache.store(*pairs[i], imgs[k], segs[k])
                    stats['primed'] += len(todo)
            stats['seconds'] = time.perf_counter() - t0
            return stats

        if not background:
            return run()
        thread = threading.Thread(target=run, daemon=True, name='raw-cache-primer')
        thread.stats = stats
        thread.start()
        return thread


class _KeyedPairs(_Pairs):
    """A batch of keys (epoch, batch_index, i) -> (images, labels, epoch,
    batch_index), stacked."""

    def __getitems__(self, keys):
        imgs, segs = self.decode([i for _, _, i in keys])
        return imgs, segs, keys[0][0], keys[0][1]


def _collate(batch):
    imgs, segs, epoch, batch_index = batch
    return torch.from_numpy(imgs), torch.from_numpy(segs), epoch, batch_index


def make_train_loader(dataset, batch_size: int, num_workers: int, device: torch.device,
                      seed: int, world_size: int = 1, rank: int = 0):
    """Shuffled full batches of ``batch_size`` in the JAX package's order for
    ``seed``, of rank ``rank``'s shard of ``world_size``; call
    ``loader.batch_sampler.set_epoch(epoch)`` before each epoch.  Worker
    processes are spawned, never forked: the parent may hold a CUDA
    context.  Builds the native decode library here, in the parent, so
    the workers find it built."""
    batches = EpochBatches(ShardedSampler(len(dataset), world_size, rank, shuffle=True, seed=seed,
                                          drop_last=True), batch_size)
    return torch.utils.data.DataLoader(
        _KeyedPairs(dataset, num_workers), batch_sampler=batches, num_workers=num_workers,
        collate_fn=_collate, pin_memory=device.type == 'cuda',
        multiprocessing_context='spawn' if num_workers > 0 else None)


def prime_raw_cache(loader, epoch=0, background=True):
    """Starts filling the raw cache with this rank's shard of ``epoch`` of
    a loader from ``make_train_loader`` (in that epoch's order), or of the
    whole pass of one from ``make_eval_loader``; ``_Pairs.prime`` says what
    it returns.  Call it right after making the loader, so it decodes while
    the model is built and the card warms up: the epoch the run reads first
    is then served from the cache."""
    batches = loader.batch_sampler
    order = batches.sampler.indices_for_epoch(epoch) if isinstance(batches, EpochBatches) \
        else [i for batch in batches for i in batch]
    return loader.dataset.prime(order, background)
