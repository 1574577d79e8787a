"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the root of the checkout (a directory ``.gitignore``
lists), and loaded with ``ctypes``.  The library's file name carries a hash
of its source, of every header under ``csrc/`` and of the flags, so an
edited source or shared header is rebuilt and a built one is reused.  Building needs ``nvcc`` (``$CUDA_HOME/bin`` or ``PATH``); nothing
is compiled when a module is imported.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), 'build', 'kernels')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')
# Every kernel source of the port; build_all compiles them side by side.
KERNELS = ('eval_tail', 'fused_tail', 'augment_post', 'fa_pairwise')


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    candidate = os.path.join(cuda_home, 'bin', 'nvcc')
    found = candidate if os.path.isfile(candidate) else shutil.which('nvcc')
    if not found:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH): "
                           "the port's CUDA kernels are built at first use.")
    return found


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to, keyed by its source, every
    ``csrc/*.cuh`` header (a kernel may include any of them) and the flags."""
    digest = hashlib.sha1(' '.join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith('.cuh'))
    for fname in [name + '.cu'] + headers:
        with open(os.path.join(CSRC_DIR, fname), 'rb') as f:
            digest.update(fname.encode() + b'\0' + f.read())
    return os.path.join(BUILD_DIR, '{}-{}.so'.format(name, digest.hexdigest()[:16]))


def _start_build(name: str):
    """Starts nvcc for one source unless its library exists; returns
    (process or None, temporary output, final output)."""
    out = library_path(name)
    if os.path.isfile(out):
        return None, None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = '{}.{}.tmp'.format(out, os.getpid())
    cmd = [_nvcc(), *NVCC_FLAGS, '-Xptxas', '-v', '-o', tmp,
           os.path.join(CSRC_DIR, name + '.cu')]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name, proc, tmp, out):
    if proc is None:
        return out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on csrc/{}.cu:\n{}".format(name, log))
    with open(out + '.log', 'w') as f:   # -Xptxas -v: registers, smem, spills
        f.write(log)
    os.replace(tmp, out)
    return out


def build_all(names=KERNELS):
    """Compiles every listed kernel source at once (one nvcc each, all
    started together); returns {name: library path}."""
    started = {name: _start_build(name) for name in names}
    return {name: _finish_build(name, *started[name]) for name in names}


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built kernel library for ``csrc/<name>.cu``, building it first if
    needed.  Loaded once per process."""
    return ctypes.CDLL(build_all((name,))[name])
