"""The port's FA loss and its all-pairs reduction K4 against the JAX package.

* K4's plain forward against the JAX Pallas kernel
  ``fa_allpairs_abs_sum_rows(..., interpret=True)`` at (8, 256) and
  (13, 128): rtol 1e-5 on the sums (float32 sums in another order); its
  autograd backward against the kernel's VJP with the same cotangent:
  equal, since both are integer sign counts times g, one rounding each.
* ``_spectral_norm_hw`` against the JAX one: 60 rounds of power iteration
  from the same start vector, within rtol 1e-5.
* ``fa_loss`` for 'dense', 'sorted', 'auto' and 'kernel' (its plain version
  here) against JAX ``fa_loss`` with the same ``impl`` ('dense' for
  'kernel') and ``fa_loss_reference_dense``, values and gradients with
  respect to both maps, at the test model's transformer output
  (2, 1, 16, 32) and the recipe's (2, 1, 64, 128).  Values within rtol
  1e-5; gradients within 1e-5 of each map's largest gradient (a chain of
  float32 einsums, the power iteration's included, summed in another order).
* ``fa_loss_per_sample`` is the JAX eval step's per-sample FA.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dualsuperreslearningforsemseg_tpu.losses import fa as jax_fa
from dualsuperreslearningforsemseg_tpu.ops.pallas.fa_pairwise import (
    fa_allpairs_abs_sum_rows as jax_sum_rows)
from dualsuperreslearningforsemseg_tpu_torch.losses import (
    fa_loss, fa_loss_per_sample, fa_loss_reference_dense)
from dualsuperreslearningforsemseg_tpu_torch.losses.fa import _spectral_norm_hw
from dualsuperreslearningforsemseg_tpu_torch.ops.fa_pairwise import (
    fa_allpairs_abs_mean, fa_allpairs_abs_sum_rows, fa_pairwise_forward_plain)


def _rows(rng, rows, n):
    a = rng.standard_normal((rows, n)).astype(np.float32)
    b = rng.standard_normal((rows, n)).astype(np.float32)
    a[:, ::4] = np.round(a[:, ::4] * 4) / 4          # exact ties between a and b
    b[:, ::4] = np.round(b[:, ::4] * 4) / 4
    return a, b


@pytest.mark.parametrize('rows,n', [(8, 256), (13, 128)])
def test_sum_rows_matches_jax_kernel(rng, rows, n):
    a, b = _rows(rng, rows, n)
    g = (rng.random(rows) + 0.5).astype(np.float32)
    ref, vjp = jax.vjp(lambda x, y: jax_sum_rows(x, y, True), jnp.asarray(a), jnp.asarray(b))
    da_ref, db_ref = vjp(jnp.asarray(g))
    at, bt = (torch.from_numpy(v).requires_grad_() for v in (a, b))
    out = fa_allpairs_abs_sum_rows(at, bt)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5)
    assert np.sum(a[:, :, None] == b[:, None, :]) > 0
    np.testing.assert_array_equal(at.grad.numpy(), np.asarray(da_ref))
    np.testing.assert_array_equal(bt.grad.numpy(), np.asarray(db_ref))


def test_plain_forward_walks_tiles_of_i(rng, monkeypatch):
    """Tiles of a few i at a time give the one-tile sum within rtol 1e-6."""
    from dualsuperreslearningforsemseg_tpu_torch.ops import fa_pairwise
    a, b = (torch.from_numpy(v) for v in _rows(rng, 3, 100))
    whole = fa_pairwise_forward_plain(a, b)
    monkeypatch.setattr(fa_pairwise, '_PAIRS_PER_TILE', 3 * 100 * 7)
    assert len(fa_pairwise._i_tiles(a)) == 15
    np.testing.assert_allclose(fa_pairwise_forward_plain(a, b).numpy(), whole.numpy(), rtol=1e-6)
    mean = fa_allpairs_abs_mean(a, b)
    np.testing.assert_allclose(float(mean), float(np.abs(a.numpy()[:, :, None] - b.numpy()[:, None, :]).mean()),
                               rtol=1e-6)


def test_spectral_norm_matches_jax(rng):
    x = rng.random((6, 8, 16)).astype(np.float32)
    x[0] = 0.0                                       # a zero slice stays finite
    got = _spectral_norm_hw(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_fa._spectral_norm_hw(jnp.asarray(x)))
    assert got.shape == ref.shape == (6, 1, 1)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(got[1:, 0, 0], np.linalg.svd(x[1:], compute_uv=False)[:, 0], rtol=1e-4)


def _maps(rng, shape):
    """Two non-negative (ReLU'd, as the transformers give them) NCHW maps."""
    return [np.maximum(rng.standard_normal(shape), 0).astype(np.float32) for _ in range(2)]


def _jax_value_and_grads(fn, m1, m2):
    nhwc = [jnp.asarray(np.transpose(m, (0, 2, 3, 1))) for m in (m1, m2)]
    value, grads = jax.value_and_grad(fn, argnums=(0, 1))(*nhwc)
    return float(value), [np.transpose(np.asarray(g), (0, 3, 1, 2)) for g in grads]


@pytest.mark.parametrize('shape', [(2, 1, 16, 32), (2, 1, 64, 128)], ids=['test_size', 'recipe'])
@pytest.mark.parametrize('impl', ['dense', 'sorted', 'auto', 'kernel'])
def test_fa_loss_matches_jax(rng, impl, shape):
    m1, m2 = _maps(rng, shape)
    t1, t2 = (torch.from_numpy(m).requires_grad_() for m in (m1, m2))
    value = fa_loss(t1, t2, impl=impl)
    value.backward()
    assert value.dtype == torch.float32 and float(value.detach()) > 0
    jax_impl = 'dense' if impl == 'kernel' else impl
    refs = [_jax_value_and_grads(lambda a, b: jax_fa.fa_loss(a, b, impl=jax_impl), m1, m2),
            _jax_value_and_grads(jax_fa.fa_loss_reference_dense, m1, m2)]
    for ref_value, ref_grads in refs:
        np.testing.assert_allclose(float(value.detach()), ref_value, rtol=1e-5)
        for got, ref in zip((t1.grad, t2.grad), ref_grads):
            scale = np.abs(ref).max()
            assert scale > 0
            np.testing.assert_allclose(got.numpy() / scale, ref / scale, rtol=0, atol=1e-5)
    dense_ref = fa_loss_reference_dense(torch.from_numpy(m1), torch.from_numpy(m2))
    np.testing.assert_allclose(float(value.detach()), float(dense_ref), rtol=1e-5)


def test_fa_loss_per_sample_matches_jax(rng):
    m1, m2 = _maps(rng, (3, 1, 64, 128))
    got = fa_loss_per_sample(torch.from_numpy(m1), torch.from_numpy(m2)).numpy()
    nhwc = [jnp.asarray(np.transpose(m, (0, 2, 3, 1))) for m in (m1, m2)]
    ref = np.asarray(jax.vmap(lambda a, b: jax_fa.fa_loss(a[None], b[None]))(*nhwc))
    assert got.shape == (3,)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_fa_loss_runs_in_float32_under_autocast(rng):
    m1, m2 = (torch.from_numpy(m).to(torch.bfloat16) for m in _maps(rng, (2, 1, 16, 32)))
    with torch.autocast('cpu', dtype=torch.bfloat16):
        value = fa_loss(m1, m2)
    assert value.dtype == torch.float32
    np.testing.assert_allclose(float(value), float(fa_loss(m1.float(), m2.float())), rtol=1e-6)
