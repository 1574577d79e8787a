"""The port's stage-1 train step against the JAX package's
``make_train_step(..., fused_tail=True)`` (its Pallas tail in interpret mode
on the CPU): three SGD steps from the same weights on the same numpy
batches, dropout off on both sides (the JAX ``FastDropout`` patched to
identity as tests/test_full_depth_parity.py:103-119 does; the port's
``nn.Dropout`` modules replaced by identities), the JAX state crossing the
jit boundary unpacked (``DSRL_TPU_PACK_SMALL=0``).

* frozen BN: losses within rtol 1e-5; every parameter's change within
  5e-3 of that leaf's largest change; running statistics untouched;
* live BN: losses within rtol 1e-4; parameter changes within 0.15 relative
  L2; running statistics within 2e-3 of their largest value;
  ``num_batches_tracked`` equal.

The tolerances are those the JAX package holds its own step to against
torch (test_full_depth_parity.py:191-250, with their reasons), at batch 4.  Also:
``PolynomialLR`` gives the JAX schedule over 10 epochs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch
from torch import nn

from dualsuperreslearningforsemseg_tpu.models import DSRL as JaxDSRL, state_dict as jax_state_dict
from dualsuperreslearningforsemseg_tpu.models import dsrl as jax_dsrl
from dualsuperreslearningforsemseg_tpu.models.schedulers import PolynomialLR as JaxPolynomialLR
from dualsuperreslearningforsemseg_tpu.train import (
    TrainState, make_train_step as jax_make_train_step, sgd_init)
from dualsuperreslearningforsemseg_tpu_torch.models import (
    DSRL, PolynomialLR, load_state_dict, port_state_dict_from_jax)
from dualsuperreslearningforsemseg_tpu_torch.train import make_sgd, make_train_step

LAYERS = (1, 1, 2, 1)
HW = (64, 128)
OHW = (128, 256)
LR, MOMENTUM, WD = 0.01, 0.9, 5e-4
# Batch 4: with live BN at batch 2 the step is so ill-conditioned at random
# init that two float32 implementations move one BN bias 0.158 apart in
# relative L2 over 3 steps (measured); at batch 4, 0.055.
BATCH = 4


class _IdentityDropout(fnn.Module):
    rate: float

    @fnn.compact
    def __call__(self, x, deterministic, pad_lanes=0):
        return x


def _perturb_batch_stats(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb_batch_stats(v, rng)
        elif k == 'running_mean':
            tree[k] = jnp.asarray(rng.standard_normal(v.shape, dtype=np.float32) * 0.05)
        elif k == 'running_var':
            tree[k] = jnp.asarray(1.0 + 0.2 * rng.random(v.shape).astype(np.float32))


def _no_dropout(model):
    for module in list(model.modules()):
        for name, child in module.named_children():
            if isinstance(child, nn.Dropout):
                setattr(module, name, nn.Identity())
    return model


def _run(rng, monkeypatch, freeze_bn):
    monkeypatch.setenv('DSRL_TPU_PACK_SMALL', '0')
    monkeypatch.setattr(jax_dsrl, 'FastDropout', _IdentityDropout)
    jax_model = JaxDSRL(stage=1, num_classes=19, backbone_layers=LAYERS)
    variables = jax_model.init({'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
                               jnp.zeros((1, *HW, 3), jnp.float32), False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {'params': variables['params'], 'batch_stats': dict(variables['batch_stats'])}
    _perturb_batch_stats(variables['batch_stats'], rng)
    before = jax_state_dict(variables)

    port = _no_dropout(DSRL(num_classes=19, backbone_layers=LAYERS))
    load_state_dict(port, port_state_dict_from_jax(variables), strict=True)
    step = make_train_step(port, make_sgd(port, LR, MOMENTUM, WD), 1, 0.0, 0.0, 255, freeze_bn)

    jax_step = jax_make_train_step(jax_model, 1, 0.0, 0.0, MOMENTUM, WD, 255, freeze_bn,
                                   fused_tail=True)
    state = TrainState(variables['params'], variables['batch_stats'], sgd_init(variables['params']))

    losses, jax_losses = [], []
    for i in range(3):
        img_lo = rng.standard_normal((BATCH, *HW, 3), dtype=np.float32)
        img_hi = rng.standard_normal((BATCH, *OHW, 3), dtype=np.float32)
        seg = rng.integers(0, 19, size=(BATCH, *OHW)).astype(np.int32)
        seg[:, :4, :4] = 255
        seg[1, -2:, :8] = 30                     # out of range, not ignored
        out = step(torch.from_numpy(img_lo), torch.from_numpy(img_hi), torch.from_numpy(seg), LR)
        losses.append(float(out['CE']))
        state, jl = jax_step(state, jnp.asarray(img_lo), jnp.asarray(img_hi), jnp.asarray(seg),
                             jnp.float32(LR), jax.random.PRNGKey(10 + i))
        jax_losses.append(float(jl['CE']))
        assert float(out['MSE']) == float(out['FA']) == 0.0 and float(out['Total']) == losses[-1]
    after_jax = jax_state_dict({'params': state.params, 'batch_stats': state.batch_stats})
    after = {k: v.numpy() for k, v in port.state_dict().items()}
    return losses, jax_losses, before, after, after_jax


def _is_stat(name):
    return name.endswith(('running_mean', 'running_var', 'num_batches_tracked'))


@pytest.mark.parametrize('batch_norm', ['frozen', 'live'])
def test_train_step_matches_jax(rng, monkeypatch, batch_norm):
    frozen = batch_norm == 'frozen'
    losses, jax_losses, before, after, after_jax = _run(rng, monkeypatch, frozen)
    assert set(after) == set(after_jax) == set(before)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5 if frozen else 1e-4)

    params = [k for k in before if not _is_stat(k)]
    assert len(params) > 80
    moved = 0.0
    for name in params:
        d_port, d_jax = after[name] - before[name], after_jax[name] - before[name]
        if frozen:
            scale = max(np.abs(d_jax).max(), 1e-10)
            np.testing.assert_allclose(d_port / scale, d_jax / scale, rtol=0, atol=5e-3, err_msg=name)
        else:
            rel_l2 = np.linalg.norm(d_port - d_jax) / max(np.linalg.norm(d_jax), 1e-10)
            assert rel_l2 < 0.15, (name, rel_l2)
        moved = max(moved, float(np.abs(d_jax).max()))
    assert moved > 1e-5

    stats = [k for k in before if _is_stat(k)]
    assert len(stats) > 50
    for name in stats:
        if frozen:
            np.testing.assert_array_equal(after[name], before[name], err_msg=name)
            np.testing.assert_array_equal(after_jax[name], before[name], err_msg=name)
        elif name.endswith('num_batches_tracked'):
            np.testing.assert_array_equal(after[name], after_jax[name], err_msg=name)
            assert int(after[name]) == int(before[name]) + 3
        else:
            assert np.abs(after[name] - before[name]).max() > 0, name
            scale = max(np.abs(after_jax[name]).max(), 1e-10)
            np.testing.assert_allclose(after[name] / scale, after_jax[name] / scale,
                                       rtol=0, atol=2e-3, err_msg=name)


def test_polynomial_lr_matches_jax():
    mine = PolynomialLR(0.006, max_decay_steps=10, end_learning_rate=0.0005, power=0.9)
    ref = JaxPolynomialLR(0.006, max_decay_steps=10, end_learning_rate=0.0005, power=0.9)
    rates = []
    for _ in range(10):
        assert mine.get_last_lr() == ref.get_last_lr()
        rates.append(mine.get_last_lr()[0])
        mine.step()
        ref.step()
    assert rates[0] == 0.006 and rates[-1] < rates[1] < rates[0]
