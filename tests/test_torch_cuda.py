"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc: each test skips where torch sees no CUDA
device.  Run on the GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

* K3 (eval tail): at the small shape the comparison repeats the CPU suite's
  cases (ignored labels, out-of-range labels, ties, NaN); at the
  benchmark's shape it holds the class map and every count equal on inputs
  whose logits are exact in float32, and the CE sum within rel 1e-5.
* K1 (train tail), forward and backward, float32 and bfloat16 x, at a
  ragged small shape and at (8, 19, 256, 512): the CE sum within rel 1e-5
  and the count equal; the gradients of the CE sum per element within
  rtol * (|plain| + max|plain|), rtol 1e-5 for dX and 1e-4 for dW and db,
  plus one bfloat16 ulp for a bfloat16 dX; two backward launches
  bit-identical; all pixels ignored gives 0 and zero gradients.
* K2 (photometric tail): bit-exact against the plain version in float32
  (every op is rounded alone in both), identity taps included, bfloat16
  within one ulp, at an odd width too.
  Its unshuffled second output (``unshuffle=8``) is bit-exact with
  ``F.pixel_unshuffle`` of the plain planar output in float32, and its
  planar output is the one-output launch's.
* K4 (FA all-pairs), forward and backward, at (8, 256) and (3, 100), on
  rows with exact ties: sums within rel 1e-5, da and db bit-equal to the
  plain version (integer sign counts times g), two launches bit-identical,
  and ``fa_loss`` on CUDA maps launches it.
* The warp (plain PyTorch) on the card equals its CPU run.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dualsuperreslearningforsemseg_tpu_torch.data import (
    AugmentConfig, photometric_params, sample_affine_matrices_np, warp_pair_batch)
from dualsuperreslearningforsemseg_tpu_torch.datasets import cityscapes
from dualsuperreslearningforsemseg_tpu_torch.ops.augment_post import photometric, photometric_plain
from dualsuperreslearningforsemseg_tpu_torch.losses import fa_loss
from dualsuperreslearningforsemseg_tpu_torch.ops.eval_tail import eval_tail, eval_tail_plain
from dualsuperreslearningforsemseg_tpu_torch.ops.fa_pairwise import (
    fa_pairwise_backward, fa_pairwise_backward_plain, fa_pairwise_forward,
    fa_pairwise_forward_plain)
from dualsuperreslearningforsemseg_tpu_torch.ops.fused_tail import (
    fused_convt2_ce_mean, fused_convt2_ce_sum_plain, fused_tail_backward, fused_tail_forward)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch sees none)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _exact_case(rng, b, h, w, device):
    """Values on coarse binary grids: every logit is exact in float32, so
    both versions see the same logits and ties whatever their sum order."""
    c = 19
    x = rng.integers(0, 256, size=(b, c, h, w)) / 64
    weight = rng.integers(-32, 33, size=(c, c, 2, 2)) / 64
    bias = rng.integers(-64, 65, size=(c,)) / 64
    labels = rng.integers(0, c, size=(b, 2 * h, 2 * w))
    u = rng.random(labels.shape)
    labels[u < 0.1] = 255
    labels[(u >= 0.1) & (u < 0.12)] = 25
    return (torch.tensor(x, dtype=torch.float32, device=device),
            torch.tensor(weight, dtype=torch.float32, device=device),
            torch.tensor(bias, dtype=torch.float32, device=device),
            torch.tensor(labels, dtype=torch.uint8, device=device))


def _assert_same(got, ref, rtol=1e-5):
    pred_k, ce_k, areas_k, acc_k = got
    pred_p, ce_p, areas_p, acc_p = ref
    assert torch.equal(pred_k, pred_p)
    for a, b in zip(areas_k, areas_p):
        assert torch.equal(a.cpu(), b.cpu())
    assert [int(v) for v in acc_k] == [int(v) for v in acc_p]
    np.testing.assert_allclose(float(ce_k), float(ce_p), rtol=rtol)


@pytest.mark.parametrize('case', ['mixed', 'all_ignored', 'all_ties', 'nan'])
def test_kernel_matches_plain_small(cuda, case):
    rng = np.random.default_rng(5)
    x, weight, bias, labels = _exact_case(rng, 2, 8, 40, cuda)   # 640 pixels: ragged block
    if case == 'all_ignored':
        labels.fill_(255)
    elif case == 'all_ties':
        weight.zero_()
        bias.zero_()
    elif case == 'nan':
        x.fill_(float('nan'))
    before = eval_tail.launches
    got = eval_tail(x, weight, bias, labels)
    torch.cuda.synchronize()
    assert eval_tail.launches == before + 1
    ref = eval_tail_plain(x, weight, bias, labels)
    if case == 'nan':
        assert np.isnan(float(got[1])) and np.isnan(float(ref[1]))
        assert int(got[0].min()) == int(got[0].max()) == 18
    _assert_same(got, ref)


def test_kernel_matches_plain_full_shape(cuda):
    rng = np.random.default_rng(6)
    x, weight, bias, labels = _exact_case(rng, 16, 256, 512, cuda)
    _assert_same(eval_tail(x, weight, bias, labels), eval_tail_plain(x, weight, bias, labels))


def test_kernel_gaussian_differs_only_at_ties(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((4, 19, 64, 128), generator=gen, device=cuda).clamp_(min=0)
    weight = torch.randn((19, 19, 2, 2), generator=gen, device=cuda) * 0.3
    bias = torch.randn((19,), generator=gen, device=cuda) * 0.1
    labels = torch.randint(0, 19, (4, 128, 256), generator=gen, device=cuda).to(torch.uint8)
    pred_k, ce_k, _, acc_k = eval_tail(x, weight, bias, labels)
    pred_p, ce_p, _, acc_p = eval_tail_plain(x, weight, bias, labels)
    top2 = F.conv_transpose2d(x, weight, bias, stride=2).topk(2, dim=1).values
    near_tie = (top2[:, 0] - top2[:, 1]) <= 1e-5
    assert not bool(((pred_k != pred_p) & ~near_tie).any())
    assert int(acc_k[1]) == int(acc_p[1])
    np.testing.assert_allclose(float(ce_k), float(ce_p), rtol=1e-5)


def _tail_inputs(gen, b, h, w, dtype, device):
    x = torch.randn((b, 19, h, w), generator=gen, device=device).clamp_(min=0).to(dtype)
    weight = torch.randn((19, 19, 2, 2), generator=gen, device=device) * 0.3
    bias = torch.randn((19,), generator=gen, device=device) * 0.1
    labels = torch.randint(0, 19, (b, 2 * h, 2 * w), generator=gen, device=device)
    u = torch.rand(labels.shape, generator=gen, device=device)
    labels[u < 0.1] = 255
    labels[(u >= 0.1) & (u < 0.12)] = 40
    return x.contiguous(), weight, bias, labels.to(torch.uint8)


def _assert_grad(got, ref, rtol, bf16=False):
    got, ref = got.float(), ref.float()
    allowed = rtol * (ref.abs() + ref.abs().max())
    if bf16:
        allowed = allowed + torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
    assert bool(((got - ref).abs() <= allowed).all())


@pytest.mark.parametrize('shape', [(1, 8, 40), (8, 256, 512)])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_fused_tail_matches_plain(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(11)
    x, weight, bias, labels = _tail_inputs(gen, *shape, getattr(torch, dtype), cuda)
    before = (fused_tail_forward.launches, fused_tail_backward.launches)
    ce, count = fused_tail_forward(x, weight, bias, labels)
    one = torch.ones((), device=cuda)
    grads = fused_tail_backward(x, weight, bias, labels, one)
    again = fused_tail_backward(x, weight, bias, labels, one)
    torch.cuda.synchronize()
    assert (fused_tail_forward.launches, fused_tail_backward.launches) == (before[0] + 1, before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    xr, wr, br = (t.detach().clone().requires_grad_() for t in (x, weight, bias))
    ce_p, count_p = fused_convt2_ce_sum_plain(xr, wr, br, labels)
    ce_p.backward()
    assert int(count) == int(count_p)
    np.testing.assert_allclose(float(ce), float(ce_p.detach()), rtol=1e-5)
    assert grads[0].dtype == x.dtype
    _assert_grad(grads[0], xr.grad, 1e-5, bf16=dtype == 'bfloat16')
    _assert_grad(grads[1], wr.grad, 1e-4)
    _assert_grad(grads[2], br.grad, 1e-4)


def test_fused_tail_all_ignored(cuda):
    gen = torch.Generator(device=cuda).manual_seed(12)
    x, weight, bias, labels = _tail_inputs(gen, 2, 8, 40, torch.float32, cuda)
    labels.fill_(255)
    xr, wr, br = (t.detach().clone().requires_grad_() for t in (x, weight, bias))
    loss = fused_convt2_ce_mean(xr, wr, br, labels)
    loss.backward()
    assert float(loss) == 0.0
    for g in (xr.grad, wr.grad, br.grad):
        assert float(g.abs().max()) == 0.0


@pytest.mark.parametrize('shape', [(3, 7, 45), (8, 512, 1024)])
def test_photometric_matches_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(13)
    b = shape[0]
    img = torch.randint(0, 256, (*shape, 3), generator=gen, device=cuda, dtype=torch.uint8)
    cfg = AugmentConfig(mean=cityscapes.MEAN, std=cityscapes.STD, blur_p=1.0, grayscale_p=0.5)
    taps, cmat, coff = photometric_params(gen, b, cfg, cityscapes.STD)
    taps[0::2] = torch.tensor([0.0, 1.0, 0.0], device=cuda)
    before = photometric.launches
    got = photometric(img, taps, cmat, coff, torch.float32)
    assert photometric.launches == before + 1
    assert torch.equal(got, photometric_plain(img, taps, cmat, coff, torch.float32))
    blurred = photometric(img, taps, cmat, coff, torch.bfloat16).float()
    ref = photometric_plain(img, taps, cmat, coff, torch.bfloat16).float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
    assert bool(((blurred - ref).abs() <= ulp).all())


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_photometric_unshuffled_output(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(15)
    img = torch.randint(0, 256, (4, 64, 128, 3), generator=gen, device=cuda, dtype=torch.uint8)
    cfg = AugmentConfig(mean=cityscapes.MEAN, std=cityscapes.STD, blur_p=1.0)
    taps, cmat, coff = photometric_params(gen, 4, cfg, cityscapes.STD)
    dt = getattr(torch, dtype)
    planar, un = photometric(img, taps, cmat, coff, dt, unshuffle=8)
    assert tuple(un.shape) == (4, 192, 8, 16) and un.dtype == dt
    assert torch.equal(planar, photometric(img, taps, cmat, coff, dt))
    ref = F.pixel_unshuffle(photometric_plain(img, taps, cmat, coff, dt), 8)
    if dtype == 'float32':
        assert torch.equal(un, ref)
    else:
        ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp(min=1e-30))) - 7)
        assert bool(((un.float() - ref.float()).abs() <= ulp).all())


@pytest.mark.parametrize('shape', [(8, 256), (3, 100)])
def test_fa_pairwise_matches_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(16)
    a, b = (torch.randn(shape, generator=gen, device=cuda) for _ in range(2))
    a[:, ::4], b[:, ::4] = torch.round(a[:, ::4] * 4) / 4, torch.round(b[:, ::4] * 4) / 4
    g = torch.rand(shape[0], generator=gen, device=cuda) + 0.5
    before = (fa_pairwise_forward.launches, fa_pairwise_backward.launches)
    sums, again = fa_pairwise_forward(a, b), fa_pairwise_forward(a, b)
    (da, db), (da2, db2) = fa_pairwise_backward(a, b, g), fa_pairwise_backward(a, b, g)
    torch.cuda.synchronize()
    assert (fa_pairwise_forward.launches, fa_pairwise_backward.launches) == (before[0] + 2,
                                                                           before[1] + 2)
    assert torch.equal(sums, again) and torch.equal(da, da2) and torch.equal(db, db2)
    np.testing.assert_allclose(sums.cpu().numpy(), fa_pairwise_forward_plain(a, b).cpu().numpy(),
                               rtol=1e-5)
    da_p, db_p = fa_pairwise_backward_plain(a, b, g)
    assert torch.equal(da, da_p) and torch.equal(db, db_p)


def test_fa_loss_on_the_card_launches_k4(cuda):
    gen = torch.Generator(device=cuda).manual_seed(17)
    m1, m2 = (torch.randn((2, 1, 64, 128), generator=gen, device=cuda).relu().requires_grad_()
              for _ in range(2))
    before = (fa_pairwise_forward.launches, fa_pairwise_backward.launches)
    value = fa_loss(m1, m2)
    value.backward()
    assert (fa_pairwise_forward.launches, fa_pairwise_backward.launches) == (before[0] + 1,
                                                                           before[1] + 1)
    dense = fa_loss(m1.detach(), m2.detach(), impl='dense')
    np.testing.assert_allclose(float(value.detach()), float(dense), rtol=1e-5)


def test_warp_on_the_card_matches_its_cpu_run(cuda):
    rng = np.random.default_rng(14)
    b, h0, w0, out_hw = 4, 256, 512, (128, 256)
    imgs = torch.from_numpy(rng.integers(0, 256, size=(b, h0, w0, 3)).astype(np.uint8))
    segs = torch.from_numpy(rng.integers(0, 34, size=(b, h0, w0)).astype(np.uint8))
    mats = torch.from_numpy(sample_affine_matrices_np(
        np.random.default_rng(np.random.SeedSequence([54321, 1, 0])), b, (h0, w0), out_hw,
        AugmentConfig()))
    lut = cityscapes.LABEL_MAPPING_LUT
    img_c, seg_c = warp_pair_batch(imgs, segs, mats, out_hw, lut)
    img_g, seg_g = warp_pair_batch(imgs.to(cuda), segs.to(cuda), mats.to(cuda), out_hw, lut)
    assert img_g.is_cuda and seg_g.is_cuda
    assert int((img_g.cpu().short() - img_c.short()).abs().max()) <= 1
    assert torch.equal(seg_g.cpu(), seg_c)
