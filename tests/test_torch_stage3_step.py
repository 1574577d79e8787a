"""The port's stage-3 train and eval steps against the JAX package's, on the
same weights and numpy batches.  Stage 3 runs every loss term, so it covers
stage 2's too.

* Train step: the port's ``make_train_step(stage=3, w1=0.1, w2=1.0)``
  against JAX ``make_train_step(stage=3, fused_tail=True, grouped=True)``
  (its Pallas tail in interpret mode), three SGD steps from the same
  weights, BatchNorm frozen and dropout off on both sides (as
  tests/test_torch_train_step.py does for stage 1), the JAX state crossing
  the jit boundary unpacked.  CE and FA within rtol 1e-5, MSE within 3e-5:
  XLA:CPU's float32 mean over the 1.6 M values of the SISR pair lands
  1.1e-5 from their float64 mean, where torch's lands within 1e-8
  (measured on the first batch).  Every parameter's change within 5e-3 of
  that leaf's largest change (the stage-1 test's tolerance, with its
  reasons).
* Eval step: the port's ``make_eval_step(stage=3)`` against JAX
  ``make_eval_step(stage=3, fused_tail=True)`` on a batch with one masked
  sample: CE, the masked MSE and the masked FA within rtol 1e-4 (a whole
  float32 forward summed in another order, as the stage-1 eval test), the
  valid count equal and the correct count equal up to near-tie pixels.
"""

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch
from torch import nn

from dualsuperreslearningforsemseg_tpu.models import DSRL as JaxDSRL, state_dict as jax_state_dict
from dualsuperreslearningforsemseg_tpu.models import dsrl as jax_dsrl
from dualsuperreslearningforsemseg_tpu.train import (
    TrainState, make_eval_step as jax_make_eval_step, make_train_step as jax_make_train_step,
    sgd_init)
from dualsuperreslearningforsemseg_tpu_torch.models import (
    DSRL, load_state_dict, port_state_dict_from_jax)
from dualsuperreslearningforsemseg_tpu_torch.train import make_eval_step, make_sgd, make_train_step

LAYERS = (1, 1, 2, 1)
HW = (64, 128)
OHW = (128, 256)
LR, MOMENTUM, WD = 0.01, 0.9, 5e-4
W1, W2 = 0.1, 1.0
BATCH = 4


class _IdentityDropout(fnn.Module):
    rate: float

    @fnn.compact
    def __call__(self, x, deterministic, pad_lanes=0):
        return x


def _jax_variables(rng, seed):
    model = JaxDSRL(stage=3, num_classes=19, backbone_layers=LAYERS)
    variables = model.init({'params': jax.random.PRNGKey(seed), 'dropout': jax.random.PRNGKey(seed + 1)},
                           jnp.zeros((1, *HW, 3), jnp.float32), False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {'params': variables['params'], 'batch_stats': dict(variables['batch_stats'])}

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == 'running_mean':
                tree[k] = rng.standard_normal(v.shape).astype(np.float32) * 0.05
            elif k == 'running_var':
                tree[k] = (1.0 + 0.2 * rng.random(v.shape)).astype(np.float32)
    perturb(variables['batch_stats'])
    return model, variables


def _port(variables):
    port = DSRL(num_classes=19, stage=3, backbone_layers=LAYERS)
    load_state_dict(port, port_state_dict_from_jax(variables), strict=True)
    for module in list(port.modules()):
        for name, child in module.named_children():
            if isinstance(child, nn.Dropout):
                setattr(module, name, nn.Identity())
    return port


def _batch(rng, b):
    img_lo = rng.standard_normal((b, *HW, 3), dtype=np.float32)
    img_hi = rng.standard_normal((b, *OHW, 3), dtype=np.float32)
    seg = rng.integers(0, 19, size=(b, *OHW)).astype(np.int32)
    seg[:, :4, :4] = 255
    return img_lo, img_hi, seg


def test_stage3_train_step_matches_jax(rng, monkeypatch):
    monkeypatch.setenv('DSRL_TPU_PACK_SMALL', '0')
    monkeypatch.setattr(jax_dsrl, 'FastDropout', _IdentityDropout)
    jax_model, variables = _jax_variables(rng, 0)
    before = jax_state_dict(variables)
    port = _port(variables)
    step = make_train_step(port, make_sgd(port, LR, MOMENTUM, WD), 3, W1, W2, 255, True)
    jax_step = jax_make_train_step(jax_model, 3, W1, W2, MOMENTUM, WD, 255, True,
                                   fused_tail=True, grouped=True)
    state = TrainState(variables['params'], variables['batch_stats'], sgd_init(variables['params']))
    for i in range(3):
        img_lo, img_hi, seg = _batch(rng, BATCH)
        out = step(*(torch.from_numpy(a) for a in (img_lo, img_hi, seg)), LR)
        state, ref = jax_step(state, jnp.asarray(img_lo), jnp.asarray(img_hi), jnp.asarray(seg),
                              jnp.float32(LR), jax.random.PRNGKey(10 + i))
        for name, rtol in (('CE', 1e-5), ('MSE', 3e-5), ('FA', 1e-5), ('Total', 1e-5)):
            assert float(out[name]) > 0, name
            np.testing.assert_allclose(float(out[name]), float(ref[name]), rtol=rtol, err_msg=name)

    after_jax = jax_state_dict({'params': state.params, 'batch_stats': state.batch_stats})
    after = {k: v.numpy() for k, v in port.state_dict().items()}
    assert set(after) == set(after_jax) == set(before)
    params = [k for k in before if not k.endswith(('running_mean', 'running_var',
                                                   'num_batches_tracked'))]
    new = [k for k in params if k.startswith(('SISR_', 'SSSR_feature'))]
    assert len(new) == 8
    for name in params:
        d_port, d_jax = after[name] - before[name], after_jax[name] - before[name]
        scale = max(np.abs(d_jax).max(), 1e-10)
        assert name not in new or scale > 1e-7, name
        np.testing.assert_allclose(d_port / scale, d_jax / scale, rtol=0, atol=5e-3, err_msg=name)


def test_stage3_eval_step_matches_jax(rng):
    jax_model, variables = _jax_variables(rng, 4)
    b = 3
    img_lo, img_hi, seg = _batch(rng, b)
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    jax_step = jax_make_eval_step(jax_model, 3, W1, W2, 19, 255, fused_tail=True)
    ref, _, _, acc_j = jax_step(variables['params'], variables['batch_stats'], jnp.asarray(img_lo),
                                jnp.asarray(img_hi), jnp.asarray(seg), jnp.asarray(mask))
    port = _port(variables).eval()
    losses, pred, _, (correct, valid) = make_eval_step(19, 255, 3, W1, W2)(
        port, *(torch.from_numpy(a) for a in (img_lo, img_hi, seg, mask)))
    for name in ('CE', 'MSE', 'FA', 'Total'):
        assert float(losses[name]) > 0, name
        np.testing.assert_allclose(float(losses[name]), float(ref[name]), rtol=1e-4, err_msg=name)
    assert int(valid) == int(acc_j[1]) == int(((seg != 255) & (mask[:, None, None] > 0)).sum())
    logits = np.asarray(jax_model.apply(variables, jnp.asarray(img_lo), False)[0])
    top2 = np.sort(logits, axis=-1)[..., -2:]
    near = int(((top2[..., 1] - top2[..., 0] <= 1e-4) & (seg != 255) & (mask[:, None, None] > 0)).sum())
    assert abs(int(correct) - int(acc_j[0])) <= near

    # The masked sample adds nothing: the same step on the two real samples.
    keep = mask > 0
    alone, _, _, _ = make_eval_step(19, 255, 3, W1, W2)(
        port, *(torch.from_numpy(np.ascontiguousarray(a[keep]))
                for a in (img_lo, img_hi, seg, mask)))
    for name in ('MSE', 'FA'):
        np.testing.assert_allclose(float(alone[name]), float(losses[name]), rtol=1e-6)
