"""Decoded-pair disk cache for the host input side.

The port's copy of the JAX package's ``data/raw_cache.py``, in the same file
format, so one cache directory serves both packages.  A PNG decode of a
1024x2048 Cityscapes pair costs tens of milliseconds of host CPU every
epoch; the loaders (data/pipeline.py, data/transforms.py) can instead spill
each decoded uint8 pair to a local-disk cache on first touch and read the
raw bytes back on every later epoch (PERF.md §5 has the card machine's
times).  The cost is local disk: 8 MiB a pair at 1024x2048.

Entries are one file per (image, labelIds) pair, named by the md5 of
``"{h}x{w}|abs:size:mtime_ns|abs:size:mtime_ns"`` (both source paths made
absolute, with their stat identity) plus ``.raw``, and hold the magic
``DSRLRAW2`` and then the image's three planes followed by the label plane.
Touching a source file invalidates its entry.  The cache directory is
disposable scratch with no garbage collection.  Writes go through a
same-directory temp file and ``os.replace``, so concurrent decoders (worker
processes, the primer thread, both packages) only ever see complete
entries.  A corrupt or truncated entry counts as a miss and is removed.
"""

import hashlib
import os
import tempfile

import numpy as np

_MAGIC = b'DSRLRAW2'


class RawPairCache:
    """Per-pair decoded uint8 cache under ``cache_dir`` for frames of
    ``size_hw``.

    ``load`` returns ``(img (H,W,3) u8, seg (H,W) u8)`` or ``None`` on a
    miss; ``store`` persists a decoded pair; ``has`` probes without reading
    the payload."""

    def __init__(self, cache_dir, size_hw):
        self.dir = cache_dir
        self.h, self.w = int(size_hw[0]), int(size_hw[1])
        self._nbytes = self.h * self.w * 4  # 3 image planes + 1 label plane
        os.makedirs(cache_dir, exist_ok=True)

    def _entry_path(self, img_path, seg_path):
        ident = []
        for p in (img_path, seg_path):
            st = os.stat(p)
            # The absolute path: the same file hits the same entry whatever
            # the caller's working directory.
            ident.append('{}:{}:{}'.format(os.path.abspath(p), st.st_size, st.st_mtime_ns))
        key = '{}x{}|{}'.format(self.h, self.w, '|'.join(ident))
        return os.path.join(self.dir, hashlib.md5(key.encode()).hexdigest() + '.raw')

    def has(self, img_path, seg_path):
        """Whether a complete entry exists: one stat, no read (the primer's
        probe; ``load`` would read the whole pair)."""
        try:
            return os.path.getsize(self._entry_path(img_path, seg_path)) == \
                len(_MAGIC) + self._nbytes
        except OSError:
            return False

    def load(self, img_path, seg_path):
        try:
            path = self._entry_path(img_path, seg_path)
        except OSError:
            return None
        try:
            with open(path, 'rb') as f:
                if f.read(len(_MAGIC)) != _MAGIC:
                    raise ValueError('bad magic')
                buf = np.fromfile(f, dtype=np.uint8, count=self._nbytes)
            if buf.size != self._nbytes:
                raise ValueError('truncated entry')
        except FileNotFoundError:
            return None
        except (OSError, ValueError):
            try:
                os.remove(path)
            except OSError:
                pass
            return None
        split = self.h * self.w * 3
        return buf[:split].reshape(self.h, self.w, 3), buf[split:].reshape(self.h, self.w)

    def store(self, img_path, seg_path, img, seg):
        if img.shape != (self.h, self.w, 3) or seg.shape != (self.h, self.w):
            return  # a frame of another geometry is not cached
        try:
            path = self._entry_path(img_path, seg_path)
            fd, tmp = tempfile.mkstemp(dir=self.dir, suffix='.tmp')
            try:
                with os.fdopen(fd, 'wb') as f:
                    f.write(_MAGIC)
                    f.write(np.ascontiguousarray(img, np.uint8))
                    f.write(np.ascontiguousarray(seg, np.uint8))
                os.replace(tmp, path)
            except BaseException:
                os.remove(tmp)
                raise
        except OSError:
            # A cache failure (a full disk, permissions) never stops training:
            # the decoded pair is already in hand.
            pass


def cache_from_env(size_hw):
    """A ``RawPairCache`` in the directory ``DSRL_TPU_RAW_CACHE`` names, or
    None when the variable is unset or empty (or the directory cannot be
    made)."""
    d = os.environ.get('DSRL_TPU_RAW_CACHE', '').strip()
    if not d:
        return None
    try:
        return RawPairCache(d, size_hw)
    except OSError:
        return None
