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
* The tile designs of K3 (persistent grid over 128-pixel tiles, mma.sync)
  and K1 backward (persistent warpgroups over 64-pixel tiles, wgmma): a
  single pixel, tiles that cross image rows and samples (w = 40, 201),
  a pixel count that is not a multiple of the tile, more tiles than
  blocks with a grid that does not divide them (3 x 97 x 201 = 457 tiles
  of 128, 914 of 64), in float32 and bfloat16: K3 on exact inputs equal
  to the plain version, K1 as above.  K1 backward also at the edges of its
  64-pixel tile: 63 and 65 pixels (1 x 3 x 21, 1 x 5 x 13), 64-pixel
  tiles that cross samples and rows of odd width (3 x 7 x 9) and
  (2, 64, 128); and, at each shape, every pixel ignored gives gradients
  that are exactly 0 and free of NaN.  Every pixel ignored gives zero CE
  and zero counts.
* K1 forward (persistent warpgroups over 64-pixel tiles, wgmma): at
  (1, 8, 40), (3, 97, 201) and (2, 64, 128) in float32 and bfloat16, the CE
  sum within rel 1e-5 of the plain version and the count equal, two
  launches bit-identical, every pixel ignored giving 0 and 0.
* K2 (photometric tail): bit-exact against the plain version in float32
  (every op is rounded alone in both), identity taps included, bfloat16
  within one ulp, at an odd width too.
  Its unshuffled second output (``unshuffle=8``) is bit-exact with
  ``F.pixel_unshuffle`` of the plain planar output in float32, and its
  planar output is the one-output launch's.
* K4 (FA all-pairs), forward and backward, at (8, 256), (3, 100),
  (304, 1024) and the ragged and cluster-boundary shapes (5, 2049), (2, 1)
  and (1, 8192), on rows with exact ties: sums within rel 1e-5, da and db
  bit-equal to the plain version (integer sign counts times g), two
  launches bit-identical, and ``fa_loss`` on CUDA maps launches it.
* The warp (plain PyTorch) on the card equals its CPU run.
* Run-to-run determinism: one stage-1 and one stage-3 train step at the
  CPU suite's small depth, after a warm-up step (cuDNN's autotuner has
  chosen), run twice from the same saved model, optimizer and generator
  state with the port's device settings (``select_device``): losses and
  every state tensor bitwise equal (tests/test_torch_determinism.py).
* Resume: ``train --stage 3 --epochs 2`` with an autosave each epoch at the
  CPU suite's small size and depth (the sizes set on ``settings`` for the
  test), then ``resume-train`` twice from its ``epoch1.checkpoint`` in this
  process: the two ``final.weights`` bitwise equal.
* ``compile-model`` on the card at that size: the exported program's class
  map equals the eager model's except at pixels whose top-2 logits lie
  within 1e-4.
* ``train --distributed ... 1 1 nccl ' ' 0`` (world 1) at that size: its
  ``final.weights`` bitwise equal to the same ``train`` without
  ``--distributed``, each in a fresh process.
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
from dualsuperreslearningforsemseg_tpu_torch.utils import select_device
from test_torch_determinism import assert_bitwise_equal, repeated_step

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


def _assert_grad(got, ref, rtol, bf16=False, flip=None):
    """Per element within rtol * (|ref| + max|ref|) (+ one bfloat16 ulp);
    with ``flip``, at most 1e-4 of the elements may exceed that by up to
    ``flip`` (a dlogit that kernel and plain version round to bfloat16 the
    other way)."""
    got, ref = got.float(), ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
    allowed = rtol * (ref.abs() + ref.abs().max())
    if bf16:
        allowed = allowed + ulp
    diff = (got - ref).abs()
    if flip is None:
        assert bool((diff <= allowed).all())
    else:
        assert bool((diff <= allowed + flip + ulp).all())
        assert int((diff > allowed).sum()) <= 1e-4 * diff.numel()


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
    bf16 = dtype == 'bfloat16'
    _assert_grad(grads[0], xr.grad, 1e-5, bf16=bf16,
                 flip=2.0 ** -8 * float(weight.abs().max()) if bf16 else None)
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


TILE_SHAPES = [(1, 1, 1), (1, 8, 40), (3, 97, 201)]
# The 64-pixel tiles' edges: a tile that crosses image rows and samples, odd
# plane sizes, a batch that ends inside a warp's 16 pixels, whole tiles.
EDGE_TILE_SHAPES = TILE_SHAPES + [(1, 3, 21), (1, 5, 13), (3, 7, 9), (2, 64, 128)]


@pytest.mark.parametrize('shape', EDGE_TILE_SHAPES)
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_eval_tail_tiles(cuda, shape, dtype):
    rng = np.random.default_rng(13)
    x, weight, bias, labels = _exact_case(rng, *shape, cuda)   # exact in bfloat16 too
    x = x.to(getattr(torch, dtype))
    got = eval_tail(x, weight, bias, labels)
    again = eval_tail(x, weight, bias, labels)
    torch.cuda.synchronize()
    _assert_same(got, eval_tail_plain(x, weight, bias, labels))
    # Two launches on the same inputs: the same class map, CE and counts, bit for bit.
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert all(torch.equal(a, b) for a, b in zip(got[2] + got[3], again[2] + again[3]))


@pytest.mark.parametrize('shape', EDGE_TILE_SHAPES)
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_fused_tail_backward_tiles(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(14)
    x, weight, bias, labels = _tail_inputs(gen, *shape, getattr(torch, dtype), cuda)
    one = torch.ones((), device=cuda)
    grads = fused_tail_backward(x, weight, bias, labels, one)
    again = fused_tail_backward(x, weight, bias, labels, one)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    xr, wr, br = (t.detach().clone().requires_grad_() for t in (x, weight, bias))
    fused_convt2_ce_sum_plain(xr, wr, br, labels)[0].backward()
    bf16 = dtype == 'bfloat16'
    _assert_grad(grads[0], xr.grad, 1e-5, bf16=bf16,
                 flip=2.0 ** -8 * float(weight.abs().max()) if bf16 else None)
    _assert_grad(grads[1], wr.grad, 1e-4)
    _assert_grad(grads[2], br.grad, 1e-4)
    labels.fill_(255)
    for g in fused_tail_backward(x, weight, bias, labels, one):
        assert not bool(g.isnan().any()) and float(g.abs().max()) == 0.0


@pytest.mark.parametrize('shape', [(1, 8, 40), (3, 97, 201), (2, 64, 128)])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_fused_tail_forward_tiles(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(18)
    x, weight, bias, labels = _tail_inputs(gen, *shape, getattr(torch, dtype), cuda)
    before = fused_tail_forward.launches
    ce, count = fused_tail_forward(x, weight, bias, labels)
    again = fused_tail_forward(x, weight, bias, labels)
    torch.cuda.synchronize()
    assert fused_tail_forward.launches == before + 2
    assert torch.equal(ce, again[0]) and torch.equal(count, again[1])
    with torch.no_grad():
        ce_p, count_p = fused_convt2_ce_sum_plain(x, weight, bias, labels)
    assert int(count) == int(count_p)
    np.testing.assert_allclose(float(ce), float(ce_p), rtol=1e-5)
    labels.fill_(255)
    ce, count = fused_tail_forward(x, weight, bias, labels)
    assert float(ce) == 0.0 and int(count) == 0


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_tail_kernels_all_ignored(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(15)
    x, weight, bias, labels = _tail_inputs(gen, 3, 97, 201, getattr(torch, dtype), cuda)
    labels.fill_(255)
    pred, ce_sum, areas, (correct, valid) = eval_tail(x, weight, bias, labels)
    assert float(ce_sum) == 0.0 and int(correct) == int(valid) == 0
    assert int(areas[0].sum()) == int(areas[1].sum()) == int(areas[2].sum()) == 0
    assert pred.dtype == torch.uint8 and pred.shape == labels.shape
    dx, dw, db = fused_tail_backward(x, weight, bias, labels, torch.ones((), device=cuda))
    for g in (dx, dw, db):
        assert not bool(g.isnan().any()) and float(g.abs().max()) == 0.0


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


@pytest.mark.parametrize('shape', [(8, 256), (3, 100), (304, 1024), (5, 2049), (2, 1), (1, 8192)])
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


@pytest.mark.parametrize('stage', [1, 3])
def test_train_step_is_bitwise_deterministic_on_the_card(cuda, stage):
    assert_bitwise_equal(*repeated_step(select_device('cuda'), stage=stage))


def test_two_resumes_from_one_checkpoint_are_bitwise_equal(cuda, tmp_path, monkeypatch):
    from dualsuperreslearningforsemseg_tpu_torch import settings
    from dualsuperreslearningforsemseg_tpu_torch.__main__ import main
    from dualsuperreslearningforsemseg_tpu_torch.checkpoint import load_checkpoint_or_weights
    from dualsuperreslearningforsemseg_tpu_torch.data import make_synthetic_cityscapes_tree
    for name, value in (('MODEL_INPUT_SIZE', (64, 128)), ('MODEL_OUTPUT_SIZE', (128, 256)),
                        ('BACKBONE_LAYERS', (1, 1, 2, 1))):
        monkeypatch.setattr(settings, name, value)
    data_root = str(tmp_path / 'datasets' / 'Cityscapes' / 'data')
    make_synthetic_cityscapes_tree(data_root, split='train', num_images=4, size_hw=(128, 256), seed=1)
    make_synthetic_cityscapes_tree(data_root, split='val', num_images=3, size_hw=(128, 256), seed=2)
    monkeypatch.chdir(tmp_path)
    main(['train', '--stage', '3', '--epochs', '2', '--batch-size', '2', '--num-workers', '0',
          '--dataset', 'cityscapes', '--val-interval', '1', '--checkpoint-interval', '1',
          '--checkpoint-history', '2', '--experiment-id', 'resume'])
    checkpoint = str(tmp_path / 'experiments' / 'resume' / 'weights' / 'stage3' / 'checkpoints' /
                     'epoch1.checkpoint')
    finals = []
    for _ in range(2):
        res = main(['resume-train', '--checkpoint', checkpoint, '--dataset', 'cityscapes'])
        assert res['starting_epoch'] == 1 and res['steps'] == 2
        finals.append(load_checkpoint_or_weights(res['final_weights'])['model_state_dict'])
    assert set(finals[0]) == set(finals[1])
    differ = [k for k in finals[0] if not np.array_equal(finals[0][k], finals[1][k])]
    assert not differ, differ


def test_compiled_model_matches_eager_on_the_card(cuda, tmp_path, monkeypatch):
    """``compile-model`` on the card at the CPU suite's small size and
    depth, then the exported program's class map against the eager
    model's: equal except at pixels whose eager top-2 logits lie within
    1e-4 (the exported graph may run other kernels)."""
    from dualsuperreslearningforsemseg_tpu_torch import settings
    from dualsuperreslearningforsemseg_tpu_torch.checkpoint import save_weights
    from dualsuperreslearningforsemseg_tpu_torch.commands import compile_model
    from dualsuperreslearningforsemseg_tpu_torch.commands.compile_model import load_compiled_model
    from dualsuperreslearningforsemseg_tpu_torch.commands.test import load_model
    from dualsuperreslearningforsemseg_tpu_torch.models import DSRL, init_weights
    for name, value in (('MODEL_INPUT_SIZE', (64, 128)), ('MODEL_OUTPUT_SIZE', (128, 256)),
                        ('BACKBONE_LAYERS', (1, 1, 2, 1))):
        monkeypatch.setattr(settings, name, value)
    model = init_weights(DSRL(num_classes=19), torch.Generator().manual_seed(54321))
    save_weights(str(tmp_path), 'stage1.weights',
                 {k: v.numpy() for k, v in model.state_dict().items()}, None)
    weights, program = str(tmp_path / 'stage1.weights'), str(tmp_path / 'model.pt2')
    res = compile_model(weights=weights, output_file=program,
                        dataset=dict(settings.DATASETS['cityscapes']), device='cuda')
    assert res['bytes'] > 1_000_000
    x = torch.randn(2, 1, 3, 64, 128, generator=torch.Generator().manual_seed(0)).to(cuda)
    eager, compiled = load_model(weights, 19, cuda), load_compiled_model(program, cuda)
    with torch.inference_mode():
        for xi in x:
            ref, got = eager(xi)[0], compiled(xi)[0]
            assert got.is_cuda and got.shape == ref.shape == (1, 19, 128, 256)
            top2 = ref.topk(2, dim=1).values
            near_tie = (top2[:, 0] - top2[:, 1]) <= 1e-4
            assert torch.all((ref.argmax(1) == got.argmax(1)) | near_tie)


def test_world_one_nccl_train_is_bitwise_the_single_process_run(cuda, tmp_path):
    """``train --distributed 127.0.0.1 <port> 1 1 nccl ' ' 0`` at the CPU
    suite's small size and depth against the same ``train`` without
    ``--distributed``, each in a fresh process: rank 0 keeps every
    single-process stream and BatchNorm is not swapped at world 1, so the
    two ``final.weights`` are bitwise equal; one set of master files."""
    import os
    import sys
    from dualsuperreslearningforsemseg_tpu_torch.checkpoint import load_checkpoint_or_weights
    from dualsuperreslearningforsemseg_tpu_torch.data import make_synthetic_cityscapes_tree
    import torch_distributed_ranks as ranks
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data_root = str(tmp_path / 'datasets' / 'Cityscapes' / 'data')
    make_synthetic_cityscapes_tree(data_root, split='train', num_images=4, size_hw=(128, 256), seed=1)
    make_synthetic_cityscapes_tree(data_root, split='val', num_images=3, size_hw=(128, 256), seed=2)
    env = dict(os.environ, PYTHONPATH=repo, DSRL_TPU_MODEL_INPUT_SIZE='64x128',
               DSRL_TPU_BACKBONE_LAYERS='1,1,2,1')
    finals = []
    for name, extra in (('plain', []), ('nccl', ['--distributed', '127.0.0.1', str(ranks.free_port()),
                                                 '1', '1', 'nccl', ' ', '0'])):
        code, _, err = ranks.run_command(
            [sys.executable, '-m', 'dualsuperreslearningforsemseg_tpu_torch', 'train', '--stage', '1',
             '--epochs', '1', '--batch-size', '2', '--num-workers', '0', '--dataset', 'cityscapes',
             '--val-interval', '1', '--disable-cudnn-benchmark', '--experiment-id', name] + extra,
            str(tmp_path), env)
        assert code == 0, err[-3000:]
        exp = tmp_path / 'experiments' / name
        names = [f for _, _, fs in os.walk(exp) for f in fs]
        assert [names.count(n) for n in ('final.weights', 'params.txt', 'stdout.txt')] == [1, 1, 1]
        finals.append(load_checkpoint_or_weights(
            str(exp / 'weights' / 'stage1' / 'final.weights'))['model_state_dict'])
    assert set(finals[0]) == set(finals[1])
    differ = [k for k in finals[0] if not np.array_equal(finals[0][k], finals[1][k])]
    assert not differ, differ
