"""The port's stage-1 DSRL against the JAX package's, on the JAX weights.

Weights go from the JAX variables through ``port_state_dict_from_jax``;
running statistics are perturbed so eval-mode BatchNorm does real work
(as tests/test_full_model_parity.py does).  Forward outputs and the
pre-final-ConvT activation agree within rtol/atol 1e-4 (float32 convs
summed in another order).  A stage-3 ``.weights`` file written by the JAX
package loads with ``strict=False``, the SISR and FA keys unexpected.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dualsuperreslearningforsemseg_tpu.checkpoint import save_weights
from dualsuperreslearningforsemseg_tpu.models import DSRL as JaxDSRL, state_dict
from dualsuperreslearningforsemseg_tpu.ops.conv import TAIL_COL_BLOCK, ungroup_2x2
from dualsuperreslearningforsemseg_tpu_torch.checkpoint import load_checkpoint_or_weights
from dualsuperreslearningforsemseg_tpu_torch.models import (
    DSRL, load_state_dict, port_state_dict_from_jax)

LAYERS = (1, 1, 2, 1)
HW = (64, 128)


def _jax_variables(stage, rng, seed=0):
    model = JaxDSRL(stage=stage, num_classes=19, backbone_layers=LAYERS)
    variables = model.init({'params': jax.random.PRNGKey(seed),
                            'dropout': jax.random.PRNGKey(seed + 1)},
                           jnp.zeros((1, *HW, 3), jnp.float32), False)
    variables = jax.tree_util.tree_map(np.asarray, variables)

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


@pytest.fixture(scope='module')
def models():
    rng = np.random.default_rng(11)
    jax_model, variables = _jax_variables(1, rng)
    port = DSRL(num_classes=19, backbone_layers=LAYERS)
    load_state_dict(port, port_state_dict_from_jax(variables), strict=True)
    x = rng.standard_normal((2, *HW, 3)).astype(np.float32)
    return jax_model, variables, port.eval(), x


def test_forward_matches_jax(models):
    jax_model, variables, port, x = models
    ref = np.asarray(jax_model.apply(variables, jnp.asarray(x), False)[0])   # NHWC
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())[0]
    assert tuple(out.shape) == (2, 19, 2 * HW[0], 2 * HW[1])
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-4, atol=1e-4)


def test_pre_tail_matches_jax(models):
    jax_model, variables, port, x = models
    # JAX pre_tail returns the cols carry: (B, H/2, W/2, 4 * 32), column
    # g*32 + c = channel c at 2x2 position g of the first ConvT.
    cols = jax_model.apply(variables, jnp.asarray(x), False, False, True, True)[0]
    b, h, w, _ = cols.shape
    grouped = cols.reshape(b, h, w, 4, TAIL_COL_BLOCK)[..., :19]
    ref = np.asarray(ungroup_2x2(grouped))                               # (B, H, W, C)
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(), pre_tail=True)[0]
    assert tuple(out.shape) == (2, 19) + HW
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-4, atol=1e-4)


def test_stage3_weights_load_non_strict(tmp_path):
    _, variables = _jax_variables(3, np.random.default_rng(12), seed=3)
    save_weights(str(tmp_path), 'stage3.weights', state_dict(variables), None)
    flat = load_checkpoint_or_weights(str(tmp_path / 'stage3.weights'))['model_state_dict']
    port = DSRL(num_classes=19, backbone_layers=LAYERS)
    missing, unexpected = load_state_dict(port, flat, strict=False)
    assert missing == []
    assert unexpected and all(
        k.split('.')[0] in ('SISR_decoder', 'SSSR_feature_transformer', 'SISR_feature_transformer')
        for k in unexpected)
    assert sorted(unexpected) == sorted(k for k in flat if not k.startswith(
        ('feature_extractor.', 'SSSR_decoder.')))
    got = port.state_dict()['SSSR_decoder.upsample16_pred.6.weight'].numpy()
    np.testing.assert_array_equal(got, flat['SSSR_decoder.upsample16_pred.6.weight'])
    with pytest.raises(KeyError):
        load_state_dict(DSRL(num_classes=19, backbone_layers=LAYERS), flat, strict=True)


@pytest.mark.parametrize('stage', [2, 3])
def test_stage23_model_matches_jax(stage):
    """Stage-2/3 JAX variables load with strict=True; in eval mode the port's
    pre-tail outputs equal the JAX grouped pre-tail outputs: the activation,
    the pre-shuffle SISR output (NHWC there), and at stage 3 the two
    transformer outputs (the FA feed), within rtol/atol 1e-4."""
    rng = np.random.default_rng(20 + stage)
    jax_model, variables = _jax_variables(stage, rng, seed=stage)
    port = DSRL(num_classes=19, stage=stage, backbone_layers=LAYERS)
    load_state_dict(port, port_state_dict_from_jax(variables), strict=True)
    x = rng.standard_normal((2, *HW, 3)).astype(np.float32)
    cols, sisr, sssr_t, sisr_t = jax_model.apply(variables, jnp.asarray(x), False, False, True, True)
    b, h, w, _ = cols.shape
    pre_tail = np.asarray(ungroup_2x2(cols.reshape(b, h, w, 4, TAIL_COL_BLOCK)[..., :19]))
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(), pre_tail=True)
    refs = [pre_tail, np.asarray(sisr)] + ([np.asarray(sssr_t), np.asarray(sisr_t)] if stage == 3
                                           else [None, None])
    assert tuple(out[1].shape) == (2, 192, HW[0] // 4, HW[1] // 4)
    for got, ref in zip(out, refs):
        if ref is None:
            assert got is None
            continue
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-4, atol=1e-4)
    if stage == 3:
        assert tuple(out[2].shape) == tuple(out[3].shape) == (2, 1, HW[0] // 4, HW[1] // 4)


def test_fa_feed_equals_the_full_resolution_path():
    """The FA corner is the stride-8 sample of the final ConvT's output, and
    the pre-tail path's transformer outputs equal the plain path's stride-8
    transformers on the full-resolution logits and SISR image (eval mode,
    within 1e-5)."""
    rng = np.random.default_rng(31)
    _, variables = _jax_variables(3, rng, seed=5)
    port = DSRL(num_classes=19, stage=3, backbone_layers=LAYERS).eval()
    load_state_dict(port, port_state_dict_from_jax(variables), strict=True)
    x = torch.from_numpy(rng.standard_normal((2, 3, *HW)).astype(np.float32))
    with torch.no_grad():
        y, sisr_pre, sssr_t, sisr_t = port(x, pre_tail=True)
        logits, sisr, sssr_t_full, sisr_t_full = port(x)
        tail = port.SSSR_decoder.upsample16_pred[6]
        strided = torch.nn.functional.conv_transpose2d(y, tail.weight, tail.bias, stride=2)
        np.testing.assert_allclose(port.SSSR_decoder.fa_corner(y).numpy(),
                                   strided[..., ::8, ::8].numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(sisr, torch.nn.functional.pixel_shuffle(sisr_pre, 8))
    np.testing.assert_allclose(logits.numpy(), strided.numpy(), rtol=1e-5, atol=1e-5)
    for got, ref in ((sssr_t, sssr_t_full), (sisr_t, sisr_t_full)):
        assert got.shape == ref.shape == (2, 1, HW[0] // 4, HW[1] // 4)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_fa_corner_under_autocast_adds_the_bias_in_bf16(rng):
    """Under bfloat16 autocast the FA corner is the JAX package's
    ``conv_transpose_2x2_stride2_corner`` of a bfloat16 activation: the
    product rounded to bfloat16, then the bias rounded to bfloat16 and added
    in bfloat16.  Within one bfloat16 ulp of the product plus one of the
    result (float32 sums in another order can round the product the other
    way)."""
    from dualsuperreslearningforsemseg_tpu.ops.conv import conv_transpose_2x2_stride2_corner
    y = jnp.asarray(rng.standard_normal((2, 8, 12, 19)).astype(np.float32)).astype(jnp.bfloat16)
    wt = (rng.standard_normal((19, 19, 2, 2)) * 0.2).astype(np.float32)
    bi = rng.standard_normal((19,)).astype(np.float32)
    ref = conv_transpose_2x2_stride2_corner(y[:, ::4, ::4], jnp.asarray(wt), jnp.asarray(bi))
    ref = np.asarray(ref.astype(jnp.float32)).transpose(0, 3, 1, 2)

    decoder = DSRL(num_classes=19, backbone_layers=LAYERS).SSSR_decoder
    tail = decoder.upsample16_pred[6]
    with torch.no_grad():
        tail.weight.copy_(torch.from_numpy(wt))
        tail.bias.copy_(torch.from_numpy(bi))
    x = torch.from_numpy(np.asarray(y.astype(jnp.float32)).transpose(0, 3, 1, 2).copy())
    with torch.no_grad(), torch.autocast('cpu', dtype=torch.bfloat16):
        got = decoder.fa_corner(x.to(torch.bfloat16))
    assert got.dtype == torch.bfloat16

    def ulp(v):
        return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), np.finfo(np.float32).tiny))) - 7)

    product = ref - bi.astype(jnp.bfloat16).astype(np.float32).reshape(1, -1, 1, 1)
    assert np.all(np.abs(got.float().numpy() - ref) <= ulp(ref) + ulp(product))
