"""The port's stage-1 eval step against the JAX package's fused eval step
(``make_eval_step(..., stage=1, fused_tail=True)``, its Pallas tail in
interpret mode on the CPU), on the same weights and batch with one masked
sample.

CE agrees within rtol 1e-4 (a whole float32 forward summed in another
order).  The class map, the histograms and the counts may differ only at
pixels whose top-two JAX logits lie within 1e-4, where that float noise can
flip the argmax; the valid count is equal.

The bfloat16 case runs the port's step with ``amp_dtype=torch.bfloat16``
(autocast, as ``train --mixed-precision`` validates) against the JAX step
of a ``DSRL(..., dtype=jnp.bfloat16)`` model, and checks that the
activation reaching the eval tail is bfloat16.  The two frameworks round
to bfloat16 at different places (flax by each module's ``dtype``, autocast
by its own lists of operations), so the comparison is looser: CE within rtol 3e-5, and at most
0.2 % of the counted pixels may change class, as the histograms and the
correct count show (seen: 8e-6 and 0.06 %; the float32 step of the same
model is 6.6e-5 and 0.4 % away, so these bounds tell the two apart).  The
valid count is equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from dualsuperreslearningforsemseg_tpu.models import DSRL as JaxDSRL
from dualsuperreslearningforsemseg_tpu.train import make_eval_step as jax_make_eval_step
from dualsuperreslearningforsemseg_tpu_torch.models import (
    DSRL, load_state_dict, port_state_dict_from_jax)
from dualsuperreslearningforsemseg_tpu_torch.train import make_eval_step, steps

LAYERS = (1, 1, 2, 1)
HW = (64, 128)
OHW = (128, 256)


def _inputs(rng, dtype=jnp.float32):
    jax_model = JaxDSRL(stage=1, num_classes=19, backbone_layers=LAYERS, dtype=dtype)
    variables = jax_model.init({'params': jax.random.PRNGKey(2), 'dropout': jax.random.PRNGKey(3)},
                               jnp.zeros((1, *HW, 3), jnp.float32), False)
    b = 3
    img_lo = rng.standard_normal((b, *HW, 3)).astype(np.float32)
    img_hi = rng.standard_normal((b, *OHW, 3)).astype(np.float32)
    seg = rng.integers(0, 19, size=(b, *OHW)).astype(np.int32)
    seg[0, :6] = 255
    seg[1, -3:] = 30                      # out of range, not ignored
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    return jax_model, variables, b, img_lo, img_hi, seg, mask


def test_eval_step_matches_jax(rng):
    jax_model, variables, b, img_lo, img_hi, seg, mask = _inputs(rng)

    jax_step = jax_make_eval_step(jax_model, 1, 0.0, 0.0, 19, 255, fused_tail=True)
    losses_j, _, hists_j, acc_j = jax_step(
        variables['params'], variables['batch_stats'], jnp.asarray(img_lo),
        jnp.asarray(img_hi), jnp.asarray(seg), jnp.asarray(mask))

    port = DSRL(num_classes=19, backbone_layers=LAYERS)
    load_state_dict(port, port_state_dict_from_jax(variables), strict=True)
    port.eval()
    losses, pred, hists, (correct, valid) = make_eval_step(19, 255)(
        port, torch.from_numpy(img_lo), torch.from_numpy(img_hi), torch.from_numpy(seg),
        torch.from_numpy(mask))

    np.testing.assert_allclose(float(losses['CE']), float(losses_j['CE']), rtol=1e-4)
    assert float(losses['MSE']) == float(losses['FA']) == 0.0
    assert pred.dtype == torch.uint8 and tuple(pred.shape) == (b, *OHW)

    # Pixels where the argmax may legitimately flip: JAX top-two within 1e-4.
    logits = np.asarray(jax_model.apply(variables, jnp.asarray(img_lo), False)[0])
    top2 = np.sort(logits, axis=-1)[..., -2:]
    counted = (seg != 255) & (mask[:, None, None] > 0)
    near_tie = (top2[..., 1] - top2[..., 0] <= 1e-4) & counted
    n_near = int(near_tie.sum())
    pred_ref = np.argmax(logits, axis=-1)
    assert np.all((pred.numpy() == pred_ref) | ~counted | near_tie)
    for mine, ref in zip(hists, hists_j):
        assert int(np.abs(mine.numpy() - np.asarray(ref)).sum()) <= 2 * n_near
    assert abs(int(correct) - int(acc_j[0])) <= n_near
    assert int(valid) == int(acc_j[1]) == int(counted.sum())


def test_eval_step_bf16_matches_jax_bf16_model(rng, monkeypatch):
    jax_model, variables, b, img_lo, img_hi, seg, mask = _inputs(rng, jnp.bfloat16)
    jax_step = jax_make_eval_step(jax_model, 1, 0.0, 0.0, 19, 255, fused_tail=True)
    losses_j, _, hists_j, acc_j = jax_step(
        variables['params'], variables['batch_stats'], jnp.asarray(img_lo),
        jnp.asarray(img_hi), jnp.asarray(seg), jnp.asarray(mask))

    port = DSRL(num_classes=19, backbone_layers=LAYERS)
    load_state_dict(port, port_state_dict_from_jax(variables), strict=True)
    port.eval()
    seen = []
    eval_tail = steps.eval_tail

    def spy(x, *args):
        seen.append(x.dtype)
        return eval_tail(x, *args)

    monkeypatch.setattr(steps, 'eval_tail', spy)
    losses, pred, hists, (correct, valid) = make_eval_step(19, 255, amp_dtype=torch.bfloat16)(
        port, torch.from_numpy(img_lo), torch.from_numpy(img_hi), torch.from_numpy(seg),
        torch.from_numpy(mask))

    assert seen == [torch.bfloat16]
    assert losses['CE'].dtype == torch.float32 and pred.dtype == torch.uint8
    np.testing.assert_allclose(float(losses['CE']), float(losses_j['CE']), rtol=3e-5)
    counted = int(((seg != 255) & (mask[:, None, None] > 0)).sum())
    assert int(valid) == int(acc_j[1]) == counted
    flips = 0.002 * counted
    for mine, ref in zip(hists, hists_j):
        assert int(np.abs(mine.numpy() - np.asarray(ref)).sum()) <= 2 * flips
    assert abs(int(correct) - int(acc_j[0])) <= flips
