"""All-pairs L1 reduction of the FA loss, forward and backward.

The port of the JAX package's Pallas kernels ``fa_allpairs_abs_sum_rows``
and its ``custom_vjp`` (ops/pallas/fa_pairwise.py).  For rows a[r, :] and
b[r, :] of length N:

    out[r]  = sum_{i,j} |a[r,i] - b[r,j]|
    da[r,i] =  g[r] * sum_j sign(a[r,i] - b[r,j])
    db[r,j] = -g[r] * sum_i sign(a[r,i] - b[r,j])

:func:`fa_allpairs_abs_sum_rows` runs :class:`AllPairsAbsSumRows`: for CUDA
tensors its forward launches ``csrc/fa_pairwise.cu``'s forward kernel
(:func:`fa_pairwise_forward`) and its backward the backward kernel
(:func:`fa_pairwise_backward`); for CPU tensors both run the plain PyTorch
versions beside them (:func:`fa_pairwise_forward_plain`,
:func:`fa_pairwise_backward_plain`).  The plain versions walk tiles of i so
that no more than about 2^24 pair values exist at once.

Any R >= 1 and 1 <= N < 2^24 are taken: the TPU's N % 128 rule and its row
padding came from its lanes and sublanes.  The sums of signs are integers,
exact in float32 below 2^24, so the kernel's gradients equal the plain
version's bit for bit.
"""

import ctypes
import functools

import torch

from ._build import current_stream, declare, load_library, on_device

_PAIRS_PER_TILE = 1 << 24
_MAX_N = 1 << 24
_SIGNATURES = {
    'dsrl_fa_pairwise_fwd': [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    'dsrl_fa_pairwise_bwd': [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    'dsrl_fa_pairwise_tiles': [ctypes.c_int],
}


def _i_tiles(a):
    rows, n = a.shape
    step = max(1, _PAIRS_PER_TILE // max(rows * n, 1))
    return [(i0, min(i0 + step, n)) for i0 in range(0, n, step)]


def fa_pairwise_forward_plain(a, b):
    """(R, N), (R, N) float32 -> (R,) float32 sums of |a_i - b_j|."""
    out = torch.zeros(a.shape[0], dtype=torch.float32, device=a.device)
    for i0, i1 in _i_tiles(a):
        out += (a[:, i0:i1, None] - b[:, None, :]).abs().sum((1, 2))
    return out


def fa_pairwise_backward_plain(a, b, g):
    """-> (da, db): g[r] times the sign counts, as the kernel computes them."""
    da = torch.empty_like(a)
    db = torch.zeros_like(b)
    for i0, i1 in _i_tiles(a):
        d = a[:, i0:i1, None] - b[:, None, :]
        da[:, i0:i1] = d.sign().sum(2)
        db += (-d).sign().sum(1)
    return da * g[:, None], db * g[:, None]


def _check(a, b):
    if a.dim() != 2 or a.shape != b.shape or a.shape[0] < 1 or not 1 <= a.shape[1] < _MAX_N:
        raise ValueError("fa_pairwise: a and b must both be (R, N) with R >= 1 and "
                         "1 <= N < 2^24, got {} and {}".format(tuple(a.shape), tuple(b.shape)))
    for name, t in (('a', a), ('b', b)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != a.device:
            raise ValueError("fa_pairwise: {} must be a contiguous float32 tensor on {}, got {} {}"
                             .format(name, a.device, t.dtype, t.device))


@functools.lru_cache(maxsize=None)
def _library():
    return declare(load_library('fa_pairwise'), _SIGNATURES)


def cluster_blocks(rows, n):
    """Blocks of the forward's cluster for ``rows`` rows of ``n``: enough for
    about 512 blocks on the card (4 an SM), at most 8 (the portable cluster
    size) and at most one per 32 values of j."""
    return max(1, min(8, -(-512 // rows), n // 32))


def fa_pairwise_forward(a, b):
    """Launches the forward kernel on CUDA tensors (and adds one to
    ``fa_pairwise_forward.launches``) -> (R,) float32.  No autograd; see
    :class:`AllPairsAbsSumRows`."""
    _check(a, b)
    rows, n = a.shape
    cluster = cluster_blocks(rows, n)
    if rows * cluster >= 2 ** 31:
        raise ValueError("fa_pairwise: {} rows of {} values need too many blocks".format(rows, n))
    fn = _library().dsrl_fa_pairwise_fwd
    out = a.new_empty(rows)
    with on_device(a):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), rows, n, cluster, current_stream(a))
    if err:
        raise RuntimeError("fa_pairwise forward kernel launch failed: CUDA error {}".format(err))
    fa_pairwise_forward.launches += 1
    return out


def fa_pairwise_backward(a, b, g):
    """Launches the backward kernel on CUDA tensors (and adds one to
    ``fa_pairwise_backward.launches``).  ``g`` is the (R,) float32 cotangent
    of the forward's sums.  Returns (da, db), (R, N) float32 each."""
    _check(a, b)
    rows, n = a.shape
    if g.dtype != torch.float32 or g.shape != (rows,) or not g.is_contiguous() \
            or g.device != a.device:
        raise ValueError("fa_pairwise backward: g must be a contiguous float32 ({},) tensor on {}"
                         .format(rows, a.device))
    lib = _library()
    if rows * lib.dsrl_fa_pairwise_tiles(n) >= 2 ** 31:
        raise ValueError("fa_pairwise: {} rows of {} values need too many blocks".format(rows, n))
    da = torch.empty_like(a)
    db = torch.empty_like(b)
    with on_device(a):
        err = lib.dsrl_fa_pairwise_bwd(a.data_ptr(), b.data_ptr(), g.data_ptr(), da.data_ptr(),
                                       db.data_ptr(), rows, n, current_stream(a))
    if err:
        raise RuntimeError("fa_pairwise backward kernel launch failed: CUDA error {}".format(err))
    fa_pairwise_backward.launches += 1
    return da, db


fa_pairwise_forward.launches = 0
fa_pairwise_backward.launches = 0


class AllPairsAbsSumRows(torch.autograd.Function):
    """Per-row sums of |a_i - b_j| with the sign counts as their gradient
    (the JAX package's ``jax.custom_vjp``): the kernels when ``kernel``,
    else the plain versions."""

    @staticmethod
    def forward(ctx, a, b, kernel):
        ctx.save_for_backward(a, b)
        ctx.kernel = kernel
        return (fa_pairwise_forward if kernel else fa_pairwise_forward_plain)(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.detach().to(torch.float32).contiguous()
        da, db = (fa_pairwise_backward if ctx.kernel else fa_pairwise_backward_plain)(a, b, g)
        return da, db, None


def fa_allpairs_abs_sum_rows_plain(a, b):
    """The plain version of :func:`fa_allpairs_abs_sum_rows`, with autograd."""
    return AllPairsAbsSumRows.apply(a.float().contiguous(), b.float().contiguous(), False)


def fa_allpairs_abs_sum_rows(a, b):
    """a, b (R, N) -> (R,) float32 sums of |a[r,i] - b[r,j]| over all pairs,
    differentiable in both.  CPU tensors take the plain versions; CUDA
    tensors launch the kernels or raise."""
    if a.device.type == 'cpu':
        return fa_allpairs_abs_sum_rows_plain(a, b)
    if a.device.type != 'cuda':
        raise ValueError("fa_allpairs_abs_sum_rows runs on CPU or CUDA tensors, got {}".format(a.device))
    return AllPairsAbsSumRows.apply(a.float().contiguous(), b.float().contiguous(), True)


def fa_allpairs_abs_mean(a, b):
    """mean_{i,j} |a - b| of each row, then the mean over rows: the FA
    reduction (``fa_allpairs_abs_mean_pallas`` there)."""
    n = a.shape[1]
    return fa_allpairs_abs_sum_rows(a, b).mean() / (n * n)


def fa_allpairs_abs_mean_plain(a, b):
    """The plain version of :func:`fa_allpairs_abs_mean`."""
    n = a.shape[1]
    return fa_allpairs_abs_sum_rows_plain(a, b).mean() / (n * n)
