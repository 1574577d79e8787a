"""ctypes binding of the decode half of the repository's native data plane.

``native/dataplane.cpp`` decodes (image, labelIds) PNG pairs on a C++
thread pool (libpng and zlib, libdeflate's inflate where its header is
found) straight into a caller's batch buffers.  The JAX package binds it in
its own ``data/native.py``; this is the port's binding of the same source,
of ``dp_version`` and ``dp_decode_pair_batch2`` only.  The host warp
(``dp_warp_pair_batch``) and the label layout (``dp_labels_g16_t``) are not
bound: the port warps on the card (data/augment.py).

The port builds its own library from ``native/dataplane.cpp`` with ``g++``
and the flags of ``native/Makefile`` into ``build/native/`` at the root of
the checkout (a directory ``.gitignore`` lists), at first use, never while
a module is imported.  The file name carries a hash of the source, the
flags and what ``-march=native`` resolves to on this host, so an edited
source or another CPU builds anew.  It never runs ``make``, writes nothing
into ``native/`` and never loads the library the JAX package builds there.
Writes go through a temp file and ``os.replace``, so processes that build
at once (ranks, loader workers) only ever load a complete library.

When the library cannot be built or loaded, ``get_lib`` prints one CAUTION
with the compiler's own message and the loaders decode with PIL, as the
JAX package does.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from ..utils.logging import CAUTION

_REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO_DIR, 'native', 'dataplane.cpp')
BUILD_DIR = os.path.join(_REPO_DIR, 'build', 'native')
# native/Makefile's CXXFLAGS, LDFLAGS and LDLIBS (-ldeflate is added when
# libdeflate.h is found, as the Makefile's probe does).
CXXFLAGS = ('-O3', '-march=native', '-fPIC', '-std=c++17', '-Wall')
LDFLAGS = ('-shared',)
LDLIBS = ('-lpng', '-lz', '-lpthread')
# dp_version() of the source this binding was written against (v5 added
# dp_decode_pair_batch2 and its failing pair's index).
_EXPECTED_VERSION = 5

# dataplane.cpp's error codes (DecodeResult.error, and 7 for the batch).
_ERROR_NAMES = {1: 'open failed', 2: 'not a PNG', 3: 'decode failed',
                4: 'output buffer overflow', 5: 'malformed filter byte',
                6: 'allocation failure', 7: 'unexpected dimensions'}

_lock = threading.Lock()


def _cxx():
    found = shutil.which(os.environ.get('CXX', 'g++'))
    if not found:
        raise RuntimeError("g++ not found on PATH")
    return found


def library_path():
    """(path of the library for this source, flags and host CPU, the link
    libraries).  Raises RuntimeError without a C++ compiler."""
    cxx = _cxx()
    probe = subprocess.run([cxx, *CXXFLAGS, '-E', '-x', 'c++', '-include', 'libdeflate.h',
                            os.devnull], capture_output=True, timeout=60)
    libs = LDLIBS + (('-ldeflate',) if probe.returncode == 0 else ())
    # The predefined macros under -march=native name this CPU's instruction
    # sets: a library built on another host is not reused here.
    target = subprocess.run([cxx, *CXXFLAGS, '-dM', '-E', '-x', 'c++', os.devnull],
                            capture_output=True, timeout=60, check=True).stdout
    digest = hashlib.sha1(' '.join(CXXFLAGS + LDFLAGS + libs).encode() + b'\0' + target)
    with open(SOURCE, 'rb') as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, 'dataplane-{}.so'.format(digest.hexdigest()[:16])), libs


def build():
    """The library's path, compiling it first unless it exists.  Raises
    RuntimeError with the compiler's first error line when the build
    fails."""
    out, libs = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix='.so.tmp')
    os.close(fd)
    try:
        proc = subprocess.run([_cxx(), *CXXFLAGS, SOURCE, '-o', tmp, *LDFLAGS, *libs],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            lines = proc.stderr.strip().splitlines() or ['no output']
            raise RuntimeError("g++ exited {}: {}".format(
                proc.returncode, next((line for line in lines if 'error' in line), lines[-1])))
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def _load():
    try:
        lib = ctypes.CDLL(build())
    except (OSError, RuntimeError, subprocess.SubprocessError) as ex:
        print(CAUTION("Native data plane unavailable ({}); falling back to PIL decode."
                      .format(ex)))
        return None
    lib.dp_version.restype = ctypes.c_int
    lib.dp_version.argtypes = []
    if lib.dp_version() < _EXPECTED_VERSION:
        print(CAUTION("Native data plane is v{} (< v{}); falling back to PIL decode."
                      .format(lib.dp_version(), _EXPECTED_VERSION)))
        return None
    lib.dp_decode_pair_batch2.restype = ctypes.c_int
    lib.dp_decode_pair_batch2.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    return lib


def get_lib():
    """The loaded library, built first if needed, or None (after one CAUTION
    a process) when it cannot be built or loaded."""
    with _lock:
        return _load()


def native_available() -> bool:
    return get_lib() is not None


def decode_pair_batch(img_paths, seg_paths, size_hw, threads=None):
    """Decodes n (image, labelIds) PNG pairs of ``size_hw`` on ``threads``
    threads (default: the CPU count) -> (imgs (n,h,w,3) u8, segs (n,h,w)
    u8).  A pair that fails (a missing or corrupt file, another size) raises
    RuntimeError naming the error and both paths of that pair."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native data plane not available")
    n = len(img_paths)
    if len(seg_paths) != n:
        raise ValueError("{} image paths but {} label paths".format(n, len(seg_paths)))
    h, w = size_hw
    imgs = np.empty((n, h, w, 3), dtype=np.uint8)
    segs = np.empty((n, h, w), dtype=np.uint8)
    c_imgs = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in img_paths])
    c_segs = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in seg_paths])
    bad = ctypes.c_int(-1)
    err = lib.dp_decode_pair_batch2(
        c_imgs, c_segs, n, imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        segs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, None,
        max(1, threads or os.cpu_count() or 1), ctypes.byref(bad))
    with _lock:
        decode_pair_batch.calls += 1
    if err != 0:
        where = '' if bad.value < 0 else " on pair ({!r}, {!r})".format(
            img_paths[bad.value], seg_paths[bad.value])
        raise RuntimeError("native decode failed with code {} ({}){}".format(
            err, _ERROR_NAMES.get(err, 'error'), where))
    return imgs, segs


decode_pair_batch.calls = 0   # calls in this process (chip_smoke.py reads it)
