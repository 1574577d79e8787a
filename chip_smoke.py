#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It imports the port (``dualsuperreslearningforsemseg_tpu_torch``) and
nothing of JAX.  Phases, each fatal on failure:

1. build: compiles every CUDA kernel of the port from ``csrc/`` (one nvcc
   per source, all started together) into ``build/kernels/``, prints the
   ``-Xptxas -v`` reports and, where ``cuobjdump`` is present, the count of
   tensor-core instructions (``HMMA`` from mma.sync, ``HGMMA`` from wgmma)
   and asynchronous copies (``LDGSTS``) in each kernel function, beside its
   registers, shared memory and spills; the K1 forward kernel must have
   tensor-core instructions, both K1 backward kernels ``HGMMA``, and both
   K3 kernels (float32 and bfloat16 x) ``HGMMA`` and no ``HMMA``;
2. K3: the eval-tail kernel against its plain PyTorch version on the card
   at the benchmark's shape, x (16, 19, 256, 512), float32 with TF32 off and
   bfloat16: (a) inputs whose logits are exact in float32 (every product and
   sum is a multiple of 2^-12, and every value is exact in bfloat16 too), so
   the class map and every count must be equal; (b) Gaussian inputs, where
   the class map may differ only at pixels whose top-two plain logits lie
   within 1e-5 and the counts only by those pixels.  CE sums agree within
   rel 1e-5.  Both versions are timed with CUDA events, in both dtypes;
3. K1: the train tail's forward and backward kernels against the plain
   version (ConvT + the port's CE sum under autograd for float32 x; for
   bfloat16 x its explicit backward with the TPU kernel's rounding) at x
   (8, 19, 256, 512), float32 and bfloat16 x, with ignored and out-of-range
   labels.  Gradients are those of the CE sum (cotangent 1, so dX is O(1)):
   the value within rel 1e-5 and an equal count; per element |d| <= rtol *
   (|plain| + max|plain|) with rtol 1e-5 for dX and 1e-4 for dW and db (sums
   over 4.2 M pixels in another order); a bfloat16 dX within one bfloat16
   ulp of the plain value plus 1e-5 * max|plain|.  Two forward launches
   must give bit-identical sums and counts, two backward launches
   bit-identical gradients; at (3, 97, 201) with every pixel ignored the
   forward gives a CE sum of 0 and a count of 0.  Forward, backward and
   the plain forward + backward are timed with CUDA events, the kernels in
   both dtypes (a wrapper call, and replayed from a CUDA graph);
4. K2: the photometric kernel against its plain version at (8, 512, 1024, 3)
   uint8, per-sample taps and matrices, half of them identity taps, whose
   float32 output must be bit-exact; float32 within atol 1e-6, bfloat16
   within one ulp; then its unshuffled second output (``unshuffle=8``, the
   stages 2-3 SISR target) bit-exact in float32 with ``F.pixel_unshuffle``
   of the plain planar output, bfloat16 within one ulp; timed;
5. K4: the FA all-pairs kernels, forward and backward, against their plain
   versions at (8, 256) (the stage-3 recipe), (3, 100) (ragged),
   (304, 1024), (5, 2049) (two chunks and a ragged tile), (2, 1), (1, 8192)
   (four chunks, 8 blocks to a cluster) and (13, 1000), on rows with exact
   ties: the sums within rel 1e-5, da and db bit-equal (integer sign counts
   times g), two launches bit-identical, and the autograd mean's gradients
   equal to the plain autograd path's; kernel (a wrapper call, and
   replayed from a CUDA graph), plain and ``torch.cdist`` timed at (8, 256)
   and (304, 1024);
6. main path: writes a synthetic Cityscapes val split (36 frames at
   1024x2048, batches 16+16+4) and seeded stage-1 ``.weights`` (the port's
   init), then runs ``benchmark`` at full depth (3,4,23,3) and 256x512 through
   the CLI's ``main`` in this process, with the kernel's launch count set to
   0 just before and read just after (it must equal the batch count); checks
   one batch's eval step against the plain full-logits composition; times a
   warm eval step at batch 16 and its parts with CUDA events, and the
   bfloat16 eval step (``--mixed-precision`` validation) beside it; runs
   ``test --image-file`` on one frame;
7. train: writes a synthetic train split of 24 frames at 1024x2048 beside
   the val split and runs ``train --stage 1 --epochs 1 --batch-size 8
   --val-interval 1 --experiment-id smoke`` at full depth through the CLI's
   ``main``, with every kernel's launch count set to 0 just before and read
   just after: K1 forward, K1 backward and K2 once per step (3), K3 once per
   val batch (5), K4 never; ``final.weights`` must load with strict=True and
   every loss be finite; then ``benchmark`` of the trained weights;
8. stage-1 train step: one step with K1 against the same step with the
   plain tail on copies of one model (dropout off, BatchNorm frozen): losses
   within rel 1e-5, the updates SGD applied (lr * its momentum buffer after
   one step) within 1e-4 of the largest update; then a warm float32 step at
   batch 8 and its parts timed with CUDA events, the step again without
   cuDNN's deterministic algorithms and once more with them, one bfloat16
   (``--mixed-precision O1``) step, and both steps with the parent's
   in-graph resize (``F.interpolate``) in turns with the matmul resize;
   then each resize's forward + backward alone at the step's three shapes;
9. cascade: ``train --stage 2`` and then ``--stage 3`` in the same
   experiment, at full depth, counts reset before each run and read after:
   K1 forward and backward and K2 (unshuffling) 3 each, K3 5, and at stage 3
   K4 forward 3 + 5 (train steps + val batches) and K4 backward 3; each
   stage must print that it warm-starts from the stage before, every loss be
   finite (MSE > 0, and FA > 0 at stage 3), and each ``final.weights`` load
   into ``DSRL(stage=k)`` with strict=True; then ``benchmark`` of the
   stage-3 weights;
10. stage-3 train step: one step with K4 against the same step with the
   dense FA (as phase 8, all four losses within rel 1e-5), the warm float32
   step's parts (warp, K2 + resize, forward, K1, MSE, FA with its power
   iteration and K4 forward, backward, SGD), one bfloat16 step in which
   K4 still receives float32, and the resize timings of phase 8;
11. determinism, after phase 8 at stage 1 and after phase 10 at stage 3: a
   warm-up step, then two full-depth train steps at batch 8 from the same
   saved model, optimizer, generator and CUDA RNG state with
   ``select_device``'s settings (live dropout and BatchNorm): the losses
   and every state tensor bitwise equal;
12. training state: ``train --stage 3 --epochs 2 --val-interval 1
   --checkpoint-interval 1 --checkpoint-history 2`` from phase 9's stage-2
   weights in a new experiment, counts reset before and read after (twice
   phase 9's stage-3 counts), must leave ``epoch1.checkpoint``,
   ``epoch2.checkpoint``, one ``*_bestval.checkpoint``, ``params.txt``,
   ``stdout.txt`` and a train and a val log (event files, or JSONL where
   ``tensorboard`` is missing; which is printed), with each save's size and
   seconds; then ``resume-train`` from ``epoch1.checkpoint`` twice, each
   with one epoch's counts (phase 9's), "EPOCH 2/2" and no "EPOCH 1/2" in
   its ``stdout.txt``, its checkpoint read and first step timed, and the
   two ``final.weights`` bitwise equal; then the checkpoint's momentum,
   restored into ``DSRL(stage=3)`` + SGD on the card and exported again,
   bitwise equal to the file's;
13. the rest of the CLI, at full depth on phase 6's frames: ``compile-model``
   of phase 7's stage-1 ``final.weights`` (export seconds and bundle size
   printed), then ``test --images-dir`` over 8 frames eager and with
   ``--compiled-model`` (each one's p50 inference latency printed, and the
   batch-1 forward alone of the model and the program): the
   two class maps, in the PNGs and recomputed from the model and the
   program, must be equal except at pixels whose eager top-2 logits lie
   within 1e-4; ``test --dataset cityscapes val 30 --no-interactive`` must
   write the 6 [target | prediction] PNGs; ``prune-weights`` of phase 9's
   stage-3 ``final.weights``, and ``benchmark`` of the pruned and the
   unpruned file (``--disable-cudnn-benchmark``, so both pick the same
   algorithms): CE, mIoU and accuracy equal, K3 launched once per batch
   (counts reset before); the ``--torch-format`` file must load into the
   stage-1 model with ``strict=True``; ``print-model --stage 3`` must count
   the stage-3 model's parameters; ``inspect-checkpoint`` and
   ``edit-checkpoint`` on phase 12's ``epoch1.checkpoint``; then
   ``run_script show_augmented_inputs_targets --limit 4``, with the counts
   reset before it, must launch K2 and write 4 PNGs;
14. multi-process training: (a) two gloo ranks on cuda:0, spawned through
   the port's ``parallel.spawn_ranks``, each with phase 9's stage-3 model
   (its final ConvT scaled by 8, so the logits are far from uniform;
   dropout off, live BatchNorm, made cross-rank by the step), validate the
   first 35 val frames (4 a rank, one pad entry masked) and take one step
   of the fused train step on 4 of 8 warped train frames (the photometric
   draws off, so both sides see the same images; the second half 80
   levels brighter and 75 % of its labels ignored), against one process
   at batch 8 from the same state, both sides with cuDNN's autotuner off:
   losses within rel 1e-4, equal on both ranks; BN running statistics
   within 1e-3 of each leaf's largest; each leaf's SGD update within 1e-3
   of the leaf's largest update, or within twice the sum of the two
   steps' floors for that leaf where that is larger, and the largest gap
   of any leaf within twice the sum of their floors, over the largest
   update of any leaf (a step's floor: its largest gap to itself on the
   same frames in other orders, six for the one process, three of each
   rank's frames for the ranks; every leaf's gaps go to
   ``distributed/leaf_gaps.json``); the witness, both ranks stepping on the
   whole batch (the 2-rank arithmetic with no split), within that same
   global limit; the validation's mIoU and accuracy equal to 2 decimals
   and CE
   within 1e-3; each rank launching K1 forward and backward, K2 and K4
   backward once, K4 forward once and once a val batch, K3 once a val
   batch.  It prints what a mean of the ranks' CE means and a per-rank
   BatchNorm would have made of the global CE (each must miss by more than
   rel 1e-4), each rank's peak device memory (validation, step) and the
   2-rank and 1-process step times (both ranks share the card: not a
   scaling number).  (b) ``train --stage 1 --epochs 1 --batch-size 8
   --disable-cudnn-benchmark --distributed 127.0.0.1 <port> 1 1 nccl ' ' 0``
   and the same without ``--distributed``, each a fresh process: one set
   of master files each, ``final.weights`` bitwise equal;
15. the host input side: whether ``g++`` and libpng (``png.h``, ``-lpng
   -lz``) are on this machine and, where they are, the native batched
   decode built from ``native/dataplane.cpp`` (a failed build is fatal
   then) and held bit for bit against PIL; 32 train + 16 val synthetic
   1024x2048 frames (``noise=1``, ~2 MiB a PNG, written on a thread per
   CPU); ms a pair of a PIL decode in one process, of the native decode of
   8 pairs on the default loader worker's share of the CPUs and on all of
   them (where it builds), and of a raw-cache read; then ``train --stage 1
   --epochs 2 --batch-size 8 --val-interval 1 --disable-cudnn-benchmark``
   twice, each a fresh process (``_input_train_child``): (a) without
   ``DSRL_TPU_RAW_CACHE``, (b) with it on an empty directory, primed. Each
   must launch K1 forward and backward and K2 once a step (8) and K3 once
   a val batch (4), print no CAUTION of a failed native decode (nor of an
   unavailable library where libpng is there), and (b) the priming INFO
   line; the cache must end with one entry per frame (48) and the two
   ``final.weights`` be bitwise equal.  Each run's epochs (wall seconds,
   the step loop's wait on the loader before each step) and the pairs
   the primer stored before step 1 are printed.

Bounds (``bound``): the larger of the bytes a kernel must move over 3.35
TB/s and its operations over the card's peak for their type: the 19x19
products of K1 and K3 at the tensor cores' rate, three TF32 passes at 495
TFLOP/s for float32 x (3xTF32 keeps float32 accuracy) or one bfloat16 pass
at 989 TFLOP/s, their elementwise work at 67 TFLOP/s FP32; K2 and K4 all at
67 TFLOP/s FP32.

The line before the last is the kernels' JSON record, with every kernel's
launches from the stage-3 run (phase 10); the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
without a CUDA card or without the port beside this script.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
PEAK_FP32_OPS_PER_S = 67e12   # H100 SXM FP32, CUDA cores
PEAK_TF32_OPS_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
NUM_CLASSES = 19


def fail(message):
    print("chip_smoke FAILED: " + message, file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=200):
    """Device time of one ``fn()`` replayed from a CUDA graph: the launches
    without the host's Python and ctypes overhead around them."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


def tail_case(gen, b, h, w, exact):
    """Eval-tail inputs on the card.  ``exact``: values on coarse grids so
    every logit is exact in float32 whatever the summation order."""
    import torch
    dev = 'cuda'
    c = NUM_CLASSES
    if exact:
        x = torch.randint(0, 256, (b, c, h, w), generator=gen, device=dev).float() / 64
        weight = torch.randint(-32, 33, (c, c, 2, 2), generator=gen, device=dev).float() / 64
        bias = torch.randint(-64, 65, (c,), generator=gen, device=dev).float() / 64
    else:
        x = torch.randn((b, c, h, w), generator=gen, device=dev).clamp_(min=0)
        weight = torch.randn((c, c, 2, 2), generator=gen, device=dev) * 0.3
        bias = torch.randn((c,), generator=gen, device=dev) * 0.1
    labels = torch.randint(0, c, (b, 2 * h, 2 * w), generator=gen, device=dev)
    u = torch.rand(labels.shape, generator=gen, device=dev)
    labels[u < 0.10] = 255                                   # ignore
    labels[(u >= 0.10) & (u < 0.12)] = 40                    # out of range, not ignore
    return x, weight, bias, labels.to(torch.uint8)


def compare_tail(x, weight, bias, labels, exact, tie_eps=1e-5):
    """Kernel vs plain version on the same card inputs; returns a dict of
    the differences, failing the run where they exceed the stated rules."""
    import torch
    from dualsuperreslearningforsemseg_tpu_torch.ops.eval_tail import eval_tail, eval_tail_plain
    from dualsuperreslearningforsemseg_tpu_torch.ops.fused_tail import tail_logits_plain
    pred_k, ce_k, areas_k, acc_k = eval_tail(x, weight, bias, labels)
    torch.cuda.synchronize()
    pred_p, ce_p, areas_p, acc_p = eval_tail_plain(x, weight, bias, labels)
    top2 = tail_logits_plain(x, weight, bias).topk(2, dim=1).values
    near_tie = (top2[:, 0] - top2[:, 1]) <= tie_eps
    mismatch = pred_k != pred_p
    n_mismatch = int(mismatch.sum())
    n_far = int((mismatch & ~near_tie).sum())
    # A pixel whose class flips moves two bins of a histogram by one each:
    # every bin may differ by at most the flipped pixels.
    area_diff = max(int((a - b).abs().max()) for a, b in zip(areas_k, areas_p))
    count_diff = [int(acc_k[0] - acc_p[0]), int(acc_k[1] - acc_p[1])]
    ce_k, ce_p = float(ce_k), float(ce_p)
    rel = abs(ce_k - ce_p) / max(abs(ce_p), 1e-30)
    out = {'dtype': str(x.dtype), 'exact_inputs': exact, 'pred_mismatch': n_mismatch,
           'pred_mismatch_beyond_tie': n_far, 'near_tie_pixels': int(near_tie.sum()),
           'max_area_diff': area_diff, 'correct_diff': count_diff[0],
           'valid_diff': count_diff[1], 'ce_sum_kernel': ce_k, 'ce_sum_plain': ce_p,
           'ce_rel_err': rel, 'ce_abs_err': abs(ce_k - ce_p)}
    print("eval_tail vs plain: " + json.dumps(out), flush=True)
    allowed = 0 if exact else n_mismatch
    if n_far or (exact and n_mismatch):
        fail("eval_tail class map differs beyond ties: {}".format(out))
    if area_diff > allowed or abs(count_diff[0]) > allowed or count_diff[1]:
        fail("eval_tail counts differ: {}".format(out))
    if not rel <= 1e-5:
        fail("eval_tail CE sum differs: {}".format(out))
    return out


def tail_work(out_pixels, products, elementwise):
    """(tensor-core flops, FP32 operations) of a tail kernel over
    ``out_pixels`` output pixels: ``products`` 19x19 products and
    ``elementwise`` operations per class of each output pixel."""
    return (out_pixels * products * 2 * NUM_CLASSES * NUM_CLASSES,
            out_pixels * elementwise * NUM_CLASSES)


def bound(nbytes, ops, mma_flops=0, dtype=None):
    """(bound ms, 'bytes' or 'operations') on this card's published peaks:
    ``nbytes`` over the memory rate, ``ops`` FP32 operations on the CUDA
    cores, and ``mma_flops`` of products on the tensor cores (three TF32
    passes for float32, one bfloat16 pass), the largest of the three."""
    import torch
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_OPS_PER_S * 1e3
    if mma_flops:
        t_ops = max(t_ops, (mma_flops / PEAK_BF16_OPS_PER_S if dtype == torch.bfloat16
                            else 3 * mma_flops / PEAK_TF32_OPS_PER_S) * 1e3)
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


def record(name, source, replaces, max_abs_err, ms, plain_ms, nbytes, ops, mma_flops=0, dtype=None):
    bound_ms, bound_by = bound(nbytes, ops, mma_flops, dtype)
    return {'name': name, 'route': 'cuda', 'source': source, 'replaces': replaces,
            'launches': None, 'max_abs_err': max_abs_err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None}


def kernel_phase():
    import torch
    from dualsuperreslearningforsemseg_tpu_torch.ops.eval_tail import eval_tail, eval_tail_plain
    gen = torch.Generator(device='cuda').manual_seed(1234)
    b, h, w = 16, 256, 512
    compare_tail(*tail_case(gen, 1, 8, 40, exact=True), exact=True)   # ragged last tile
    compare_tail(*tail_case(gen, b, h, w, exact=True), exact=True)
    x, weight, bias, labels = tail_case(gen, b, h, w, exact=False)
    gaussian = compare_tail(x, weight, bias, labels, exact=False)
    # bfloat16 x: the exact inputs are exact in bfloat16 too.
    xe, we, be, le = tail_case(gen, b, h, w, exact=True)
    compare_tail(xe.to(torch.bfloat16), we, be, le, exact=True)
    xb = x.to(torch.bfloat16)
    compare_tail(xb, weight, bias, labels, exact=False)
    del xe, we, be, le

    out_pixels = labels.numel()
    rec, times = None, {}
    for xt in (x, xb):
        ms = cuda_ms(lambda: eval_tail(xt, weight, bias, labels), iters=50)
        plain_ms = cuda_ms(lambda: eval_tail_plain(xt, weight, bias, labels), iters=5, warmup=1)
        nbytes = (xt.numel() * xt.element_size() + labels.numel() + out_pixels
                  + weight.numel() * 4 + bias.numel() * 4 + (3 * NUM_CLASSES + 2) * 8)
        mma_flops, ops = tail_work(out_pixels, 1, 6)
        r = record('eval_tail', 'dualsuperreslearningforsemseg_tpu_torch/csrc/eval_tail.cu',
                   'dualsuperreslearningforsemseg_tpu/ops/pallas/eval_tail.py:132',
                   gaussian['ce_abs_err'], ms, plain_ms, nbytes, ops, mma_flops, xt.dtype)
        times[str(xt.dtype)] = r
        print("eval_tail at x {} {}: kernel {:.4f} ms, plain {:.3f} ms, bound {:.4f} ms ({}; {} bytes, "
              "{:.3g} tensor-core flops, {:.3g} FP32 ops), {:.1f} % of the bound".format(
                  tuple(xt.shape), xt.dtype, ms, plain_ms, r['bound_ms'], r['bound_by'], nbytes,
                  mma_flops, ops, 100 * r['bound_ms'] / ms), flush=True)
        if rec is None:
            rec = r
    return rec


def bf16_ulp(t):
    """One bfloat16 ulp at each |t| (8 significant bits)."""
    import torch
    a = t.abs().float().clamp(min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def grad_check(name, got, ref, rtol, bf16=False, flip=None):
    """|got - ref| <= rtol * (|ref| + max|ref|) elementwise (+ one bf16 ulp
    of ref when bf16); returns the max abs and normwise errors.  ``flip``
    (elementwise) lets at most 1e-4 of the elements exceed that by up to
    ``flip``: where kernel and plain version round a dlogit to bfloat16 the
    other way (their float32 logits differ in summation order), the dX
    entries it feeds move by one bfloat16 ulp of it times W."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    allowed = rtol * (ref.abs() + ref.abs().max())
    if bf16:
        allowed = allowed + bf16_ulp(ref)
    nan = int(diff.isnan().sum())
    out = {'max_abs': float(diff.max()), 'normwise': float(diff.max() / ref.abs().max().clamp(min=1e-30)),
           'over': int((diff > allowed).sum()) + nan}
    if flip is not None:
        out['flipped'] = out['over'] - nan
        out['over'] = int((diff > allowed + flip).sum()) + nan
        if out['flipped'] > 1e-4 * diff.numel():
            out['over'] += out['flipped']
    if out['over']:
        fail("K1 {} differs from the plain version: {}".format(name, out))
    return out


def k1_case(gen, b, h, w, dtype):
    x, weight, bias, labels = tail_case(gen, b, h, w, exact=False)
    return x.to(dtype).contiguous(), weight, bias, labels


def k1_compare(x, weight, bias, labels):
    """K1 forward and backward against the plain autograd composition on the
    same card inputs (gradients of the CE sum); returns the errors."""
    import torch
    from dualsuperreslearningforsemseg_tpu_torch.ops.fused_tail import (
        fused_tail_forward, fused_tail_backward, fused_convt2_ce_sum_plain,
        fused_convt2_ce_mean, fused_convt2_ce_mean_plain)
    bf16 = x.dtype == torch.bfloat16
    ce_k, cnt_k = fused_tail_forward(x, weight, bias, labels)
    ce_k2, cnt_k2 = fused_tail_forward(x, weight, bias, labels)
    one = torch.ones((), device='cuda')
    dx_k, dw_k, db_k = fused_tail_backward(x, weight, bias, labels, one)
    dx_k2, dw_k2, db_k2 = fused_tail_backward(x, weight, bias, labels, one)
    torch.cuda.synchronize()
    fwd_identical = torch.equal(ce_k, ce_k2) and torch.equal(cnt_k, cnt_k2)
    identical = all(torch.equal(a, b) for a, b in ((dx_k, dx_k2), (dw_k, dw_k2), (db_k, db_k2)))
    xr, wr, br = (t.detach().clone().requires_grad_() for t in (x, weight, bias))
    ce_p, cnt_p = fused_convt2_ce_sum_plain(xr, wr, br, labels)
    ce_p.backward()
    ce_p = ce_p.detach()
    rel = abs(float(ce_k) - float(ce_p)) / max(abs(float(ce_p)), 1e-30)
    out = {'dtype': str(x.dtype), 'shape': tuple(x.shape), 'ce_sum_kernel': float(ce_k),
           'ce_sum_plain': float(ce_p), 'ce_rel_err': rel, 'count_kernel': int(cnt_k),
           'count_plain': int(cnt_p), 'forward_bit_identical_rerun': fwd_identical,
           'bit_identical_rerun': identical}
    if not rel <= 1e-5 or int(cnt_k) != int(cnt_p):
        fail("K1 forward differs from the plain version: {}".format(out))
    if not fwd_identical:
        fail("K1 forward is not bit-identical across two launches: {}".format(out))
    if not identical:
        fail("K1 backward is not bit-identical across two launches: {}".format(out))
    # bfloat16: a dlogit (|d| <= 1 for the CE sum) rounded the other way
    # moves dX by at most 2^-8 max|W|, and its rounding by one more ulp.
    flip = 2.0 ** -8 * float(weight.abs().max()) + bf16_ulp(xr.grad) if bf16 else None
    out['dX'] = grad_check('dX', dx_k, xr.grad, 1e-5, bf16=bf16, flip=flip)
    out['dW'] = grad_check('dW', dw_k, wr.grad, 1e-4)
    out['db'] = grad_check('db', db_k, br.grad, 1e-4)
    # The path's own entry: the mean loss through the autograd Function.
    xm = x.detach().clone().requires_grad_()
    loss_k = fused_convt2_ce_mean(xm, weight, bias, labels)
    loss_p = fused_convt2_ce_mean_plain(x, weight, bias, labels)
    loss_k.backward()
    out['mean_kernel'], out['mean_plain'] = float(loss_k.detach()), float(loss_p)
    if not abs(float(loss_k) - float(loss_p)) <= 1e-5 * abs(float(loss_p)) or xm.grad is None \
            or xm.grad.dtype != x.dtype:
        fail("K1 mean loss differs from the plain version: {}".format(out))
    print("K1 vs plain: " + json.dumps(out), flush=True)
    return out


def k1_phase():
    import torch
    from dualsuperreslearningforsemseg_tpu_torch.ops.fused_tail import (
        fused_tail_forward, fused_tail_backward, fused_convt2_ce_sum_plain)
    gen = torch.Generator(device='cuda').manual_seed(4321)
    for dtype in (torch.float32, torch.bfloat16):
        k1_compare(*k1_case(gen, 1, 8, 40, dtype))        # ragged last tile, rows crossed
        k1_compare(*k1_case(gen, 3, 97, 201, dtype))      # ragged, odd width, more tiles than blocks
        x, weight, bias, labels = k1_case(gen, 3, 97, 201, dtype)
        labels.fill_(255)                                 # every pixel ignored
        ce, cnt = fused_tail_forward(x, weight, bias, labels)
        print("K1 forward, every pixel ignored, {}: CE sum {}, count {}".format(dtype, float(ce), int(cnt)),
              flush=True)
        if float(ce) != 0.0 or int(cnt) != 0:
            fail("K1 forward with every pixel ignored gave CE {} and count {}".format(float(ce), int(cnt)))
    cases = {torch.float32: k1_case(gen, 8, 256, 512, torch.float32)}
    f32 = k1_compare(*cases[torch.float32])
    cases[torch.bfloat16] = k1_case(gen, 8, 256, 512, torch.bfloat16)
    k1_compare(*cases[torch.bfloat16])

    one = torch.ones((), device='cuda')
    c = NUM_CLASSES
    src = 'dualsuperreslearningforsemseg_tpu_torch/csrc/fused_tail.cu'
    records = []
    for dtype, (x, weight, bias, labels) in cases.items():
        fwd_ms = cuda_ms(lambda: fused_tail_forward(x, weight, bias, labels), iters=20)
        bwd_ms = cuda_ms(lambda: fused_tail_backward(x, weight, bias, labels, one), iters=20)
        fwd_graph_ms = graph_ms(lambda: fused_tail_forward(x, weight, bias, labels))
        bwd_graph_ms = graph_ms(lambda: fused_tail_backward(x, weight, bias, labels, one))

        def plain_fwd():
            with torch.no_grad():
                fused_convt2_ce_sum_plain(x, weight, bias, labels)

        def plain_fwd_bwd():
            xr, wr, br = (t.detach().requires_grad_() for t in (x, weight, bias))
            fused_convt2_ce_sum_plain(xr, wr, br, labels)[0].backward()

        plain_fwd_ms = cuda_ms(plain_fwd, iters=5, warmup=1)
        plain_fwd_bwd_ms = cuda_ms(plain_fwd_bwd, iters=5, warmup=1)
        out_pixels, xb = labels.numel(), x.numel() * x.element_size()
        params = (weight.numel() + bias.numel()) * 4
        fwd = record('fused_tail_forward', src,
                     'dualsuperreslearningforsemseg_tpu/ops/pallas/fused_tail.py:218',
                     abs(f32['ce_sum_kernel'] - f32['ce_sum_plain']), fwd_ms, plain_fwd_ms,
                     xb + labels.numel() + params + 16, *tail_work(out_pixels, 1, 6)[::-1],
                     dtype=dtype)
        bwd = record('fused_tail_backward', src,
                     'dualsuperreslearningforsemseg_tpu/ops/pallas/fused_tail.py:251',
                     f32['dX']['max_abs'], bwd_ms, plain_fwd_bwd_ms,
                     2 * xb + labels.numel() + 2 * params + 4, *tail_work(out_pixels, 3, 9)[::-1],
                     dtype=dtype)
        for r, what, graph in ((fwd, 'plain forward', fwd_graph_ms),
                               (bwd, 'plain forward+backward', bwd_graph_ms)):
            print("{} at x {} {}: kernel {:.4f} ms a wrapper call, {:.4f} ms replayed from a CUDA graph, "
                  "{} {:.3f} ms, bound {:.4f} ms ({}), {:.1f} % of the bound".format(
                      r['name'], tuple(x.shape), dtype, r['ms'], graph, what, r['plain_ms'],
                      r['bound_ms'], r['bound_by'], 100 * r['bound_ms'] / r['ms']), flush=True)
        if not records:
            records = [fwd, bwd]
    return records


def k2_params(gen, b):
    """Per-sample photometric parameters as training draws them, then every
    other sample forced to identity taps and one to grayscale."""
    import torch
    from dualsuperreslearningforsemseg_tpu_torch import settings
    from dualsuperreslearningforsemseg_tpu_torch.data import AugmentConfig, photometric_params
    ds = settings.DATASETS['cityscapes']['settings']
    cfg = AugmentConfig(mean=ds.MEAN, std=ds.STD, blur_p=1.0, grayscale_p=0.0)
    taps, cmat, coff = photometric_params(gen, b, cfg, ds.STD)
    taps[0::2] = torch.tensor([0.0, 1.0, 0.0], device=taps.device)
    gray = photometric_params(gen, 1, AugmentConfig(mean=ds.MEAN, std=ds.STD, grayscale_p=1.0), ds.STD)[1]
    cmat[1] = gray[0]
    return taps.contiguous(), cmat.contiguous(), coff.contiguous()


def k2_phase():
    import torch
    import torch.nn.functional as F
    from dualsuperreslearningforsemseg_tpu_torch.ops.augment_post import photometric, photometric_plain
    gen = torch.Generator(device='cuda').manual_seed(99)
    results = {}
    for b, h, w in ((3, 7, 45), (8, 512, 1024)):      # odd sizes, then the recipe's
        img = torch.randint(0, 256, (b, h, w, 3), generator=gen, device='cuda', dtype=torch.uint8)
        taps, cmat, coff = k2_params(gen, b)
        for dtype in (torch.float32, torch.bfloat16):
            got = photometric(img, taps, cmat, coff, dtype)
            ref = photometric_plain(img, taps, cmat, coff, dtype)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs()
            out = {'shape': (b, h, w), 'dtype': str(dtype), 'max_abs_err': float(diff.max()),
                   'identity_taps_bit_exact': bool(torch.equal(got[0::2], ref[0::2])),
                   'bit_exact': bool(torch.equal(got, ref))}
            if dtype == torch.float32:
                ok = out['identity_taps_bit_exact'] and out['max_abs_err'] <= 1e-6
            else:
                ok = bool((diff <= bf16_ulp(ref)).all())
            print("K2 vs plain: " + json.dumps(out), flush=True)
            if not ok:
                fail("K2 differs from the plain version: {}".format(out))
            results[(b, dtype)] = (img, taps, cmat, coff, out)
    # The unshuffled second output (stages 2-3): f32 bit-exact with
    # F.pixel_unshuffle of the plain planar output, bf16 within one ulp.
    for b, h, w in ((2, 16, 40), (8, 512, 1024)):
        img = torch.randint(0, 256, (b, h, w, 3), generator=gen, device='cuda', dtype=torch.uint8)
        taps, cmat, coff = k2_params(gen, b)
        for dtype in (torch.float32, torch.bfloat16):
            planar, un = photometric(img, taps, cmat, coff, dtype, unshuffle=8)
            ref = photometric_plain(img, taps, cmat, coff, dtype)
            torch.cuda.synchronize()
            ref_un = F.pixel_unshuffle(ref, 8)
            diff = (un.float() - ref_un.float()).abs()
            out = {'shape': (b, h, w), 'dtype': str(dtype), 'unshuffled_shape': tuple(un.shape),
                   'unshuffled_max_abs_err': float(diff.max()),
                   'unshuffled_bit_exact': bool(torch.equal(un, ref_un)),
                   'planar_same_as_without': bool(torch.equal(
                       planar, photometric(img, taps, cmat, coff, dtype)))}
            print("K2 unshuffle vs plain: " + json.dumps(out), flush=True)
            ok = out['planar_same_as_without'] and tuple(un.shape) == (b, 192, h // 8, w // 8)
            ok = ok and (out['unshuffled_bit_exact'] if dtype == torch.float32
                         else bool((diff <= bf16_ulp(ref_un)).all()))
            if not ok:
                fail("K2's unshuffled output differs: {}".format(out))
            results[(b, dtype, 'un')] = (img, taps, cmat, coff, out)
    img, taps, cmat, coff, out = results[(8, torch.float32)]
    planar_ms = cuda_ms(lambda: photometric(img, taps, cmat, coff, torch.float32), iters=50)
    planar_bf16_ms = cuda_ms(lambda: photometric(img, taps, cmat, coff, torch.bfloat16), iters=50)
    img, taps, cmat, coff, out = results[(8, torch.float32, 'un')]
    ms = cuda_ms(lambda: photometric(img, taps, cmat, coff, torch.float32, 8), iters=50)
    plain_ms = cuda_ms(lambda: photometric_plain(img, taps, cmat, coff, torch.float32, 8),
                       iters=5, warmup=1)
    bf16_ms = cuda_ms(lambda: photometric(img, taps, cmat, coff, torch.bfloat16, 8), iters=50)
    pixels = img.numel() // 3
    rec = record('augment_post', 'dualsuperreslearningforsemseg_tpu_torch/csrc/augment_post.cu',
                 'dualsuperreslearningforsemseg_tpu/ops/pallas/augment_post.py:136',
                 out['unshuffled_max_abs_err'], ms, plain_ms,
                 img.numel() + 2 * pixels * 3 * 4 + 15 * 4 * img.shape[0], pixels * 78)
    print("augment_post at (8, 512, 1024, 3) uint8 -> float32 planar + unshuffled: kernel {:.4f} ms "
          "(bfloat16 out {:.4f} ms), plain {:.3f} ms, bound {:.4f} ms ({}); planar alone {:.4f} ms "
          "(bfloat16 {:.4f} ms)".format(ms, bf16_ms, plain_ms, rec['bound_ms'], rec['bound_by'],
                                        planar_ms, planar_bf16_ms), flush=True)
    return rec


def k4_case(gen, rows, n):
    """K4 inputs on the card: Gaussian rows with a quarter of each row's
    values put on a coarse grid shared by a and b, so ties (sign 0) occur."""
    import torch
    a = torch.randn((rows, n), generator=gen, device='cuda')
    b = torch.randn((rows, n), generator=gen, device='cuda')
    for t in (a, b):
        t[:, ::4] = torch.round(t[:, ::4] * 4) / 4
    return a, b


def k4_compare(a, b):
    """K4 forward and backward against their plain versions on the same card
    inputs: the sums within rel 1e-5, da and db bit-equal, two launches
    bit-identical, and the mean's autograd gradients equal."""
    import torch
    from dualsuperreslearningforsemseg_tpu_torch.ops.fa_pairwise import (
        fa_pairwise_forward, fa_pairwise_forward_plain, fa_pairwise_backward,
        fa_pairwise_backward_plain, fa_allpairs_abs_mean, fa_allpairs_abs_mean_plain)
    g = torch.rand(a.shape[0], device='cuda') + 0.5
    s_k, s_k2 = fa_pairwise_forward(a, b), fa_pairwise_forward(a, b)
    (da_k, db_k), (da_k2, db_k2) = fa_pairwise_backward(a, b, g), fa_pairwise_backward(a, b, g)
    torch.cuda.synchronize()
    s_p = fa_pairwise_forward_plain(a, b)
    da_p, db_p = fa_pairwise_backward_plain(a, b, g)
    rel = float(((s_k.double() - s_p.double()).abs() / s_p.double().abs().clamp(min=1e-30)).max())
    grad_err = max(float((da_k - da_p).abs().max()), float((db_k - db_p).abs().max()))
    grads = []
    for fn in (fa_allpairs_abs_mean, fa_allpairs_abs_mean_plain):
        ar, br = (t.detach().clone().requires_grad_() for t in (a, b))
        fn(ar, br).backward()
        grads.append((ar.grad, br.grad))
    out = {'shape': tuple(a.shape), 'sum_rel_err': rel,
           'max_abs_err': float((s_k - s_p).abs().max()), 'grad_max_abs_err': grad_err,
           'da_bit_equal': bool(torch.equal(da_k, da_p)), 'db_bit_equal': bool(torch.equal(db_k, db_p)),
           'bit_identical_rerun': bool(torch.equal(s_k, s_k2) and torch.equal(da_k, da_k2)
                                       and torch.equal(db_k, db_k2)),
           'mean_grads_equal': all(torch.equal(x, y) for x, y in zip(*grads)),
           'equal_pairs': int((a[:, :, None] == b[:, None, :]).sum())}
    print("K4 vs plain: " + json.dumps(out), flush=True)
    if not (rel <= 1e-5 and out['da_bit_equal'] and out['db_bit_equal']
            and out['bit_identical_rerun'] and out['mean_grads_equal']):
        fail("K4 differs from the plain version: {}".format(out))
    return out


def k4_phase():
    import torch
    from dualsuperreslearningforsemseg_tpu_torch.ops.fa_pairwise import (
        fa_pairwise_forward, fa_pairwise_forward_plain, fa_pairwise_backward,
        fa_pairwise_backward_plain)
    gen = torch.Generator(device='cuda').manual_seed(777)
    shapes = ((8, 256), (3, 100), (304, 1024), (5, 2049), (2, 1), (1, 8192), (13, 1000))
    cases = {shape: k4_case(gen, *shape) for shape in shapes}
    results = {shape: k4_compare(*ab) for shape, ab in cases.items()}
    records = []
    for (rows, n), (a, b) in cases.items():
        if (rows, n) not in ((8, 256), (304, 1024)):
            continue
        g = torch.ones(rows, device='cuda')
        iters = 200 if rows == 8 else 20
        t = {'fwd': cuda_ms(lambda: fa_pairwise_forward(a, b), iters=iters),
             'bwd': cuda_ms(lambda: fa_pairwise_backward(a, b, g), iters=iters),
             'plain_fwd': cuda_ms(lambda: fa_pairwise_forward_plain(a, b), iters=10, warmup=2),
             'plain_bwd': cuda_ms(lambda: fa_pairwise_backward_plain(a, b, g), iters=10, warmup=2),
             'cdist': cuda_ms(lambda: torch.cdist(a[..., None], b[..., None], p=1).sum((1, 2)),
                              iters=10, warmup=2),
             'fwd_graph': graph_ms(lambda: fa_pairwise_forward(a, b)),
             'bwd_graph': graph_ms(lambda: fa_pairwise_backward(a, b, g))}
        pairs = rows * n * n
        src = 'dualsuperreslearningforsemseg_tpu_torch/csrc/fa_pairwise.cu'
        fwd = record('fa_pairwise_forward', src,
                     'dualsuperreslearningforsemseg_tpu/ops/pallas/fa_pairwise.py:116',
                     results[(rows, n)]['max_abs_err'], t['fwd'], t['plain_fwd'],
                     8 * rows * n + 4 * rows, 3 * pairs)
        fwd['library_ms'] = t['cdist']
        bwd = record('fa_pairwise_backward', src,
                     'dualsuperreslearningforsemseg_tpu/ops/pallas/fa_pairwise.py:145',
                     results[(rows, n)]['grad_max_abs_err'], t['bwd'], t['plain_bwd'],
                     16 * rows * n + 4 * rows, 4 * pairs)
        print("K4 at ({}, {}): forward {:.5f} ms (replayed from a CUDA graph {:.5f} ms; plain {:.4f}, "
              "cdist {:.4f}, bound {:.5f} {}), backward {:.5f} ms (graph {:.5f} ms; plain {:.4f}, "
              "bound {:.5f} {})".format(
                  rows, n, fwd['ms'], t['fwd_graph'], fwd['plain_ms'], t['cdist'], fwd['bound_ms'],
                  fwd['bound_by'], bwd['ms'], t['bwd_graph'], bwd['plain_ms'], bwd['bound_ms'],
                  bwd['bound_by']), flush=True)
        if rows == 8:
            records = [fwd, bwd]
    return records


def check_eval_step(model, loader_batch, transform, eval_step, tie_eps=1e-4):
    """One batch through the port's eval step (the kernel) against the plain
    full-logits composition of the same model on the card."""
    import torch
    from dualsuperreslearningforsemseg_tpu_torch.losses import cross_entropy_loss
    from dualsuperreslearningforsemseg_tpu_torch.metrics import (
        argmax_lastdim, batch_histograms, batch_accuracy_counts)
    imgs, segs = (t.cuda() for t in loader_batch)
    (img_lo, img_hi), (seg_hi, _) = transform(imgs, segs)
    losses, pred, areas, acc = eval_step(model, img_lo, img_hi, seg_hi,
                                         torch.ones(imgs.shape[0], device='cuda'))
    with torch.inference_mode():
        logits = model(img_lo.permute(0, 3, 1, 2).contiguous())[0].permute(0, 2, 3, 1)
        ce_ref = float(cross_entropy_loss(logits, seg_hi))
        pred_ref = argmax_lastdim(logits)
        areas_ref = batch_histograms(pred_ref, seg_hi, NUM_CLASSES)
        acc_ref = batch_accuracy_counts(pred_ref, seg_hi)
        top2 = logits.topk(2, dim=-1).values
        near_tie = (top2[..., 0] - top2[..., 1]) <= tie_eps
    mismatch = pred.long() != pred_ref
    n_mismatch, n_far = int(mismatch.sum()), int((mismatch & ~near_tie).sum())
    area_diff = max(int((a - b).abs().max()) for a, b in zip(areas, areas_ref))   # per bin
    ce = float(losses['CE'])
    out = {'ce_step': ce, 'ce_plain': ce_ref, 'pred_mismatch': n_mismatch,
           'pred_mismatch_beyond_tie': n_far, 'max_area_diff': area_diff,
           'correct_diff': int(acc[0] - acc_ref[0]), 'valid_diff': int(acc[1] - acc_ref[1])}
    print("eval step vs plain composition: " + json.dumps(out), flush=True)
    if not (abs(ce - ce_ref) <= 1e-4 * abs(ce_ref) and n_far == 0 and area_diff <= n_mismatch
            and abs(out['correct_diff']) <= n_mismatch and out['valid_diff'] == 0):
        fail("eval step disagrees with the plain composition: {}".format(out))


def bf16_step_activation(model, x):
    """The pre-tail activation as the bfloat16 eval step computes it."""
    import torch
    with torch.autocast('cuda', dtype=torch.bfloat16):
        return model(x, pre_tail=True)[0].contiguous()


def step_breakdown(model, batch, transform, eval_step, device_name):
    """Device time of one warm eval step at batch 16 and of its parts, with
    CUDA events (these launches come after the main path's count), and of
    the bfloat16 eval step."""
    import numpy as np
    import torch
    from dualsuperreslearningforsemseg_tpu_torch.ops.eval_tail import eval_tail, eval_tail_plain
    from dualsuperreslearningforsemseg_tpu_torch.train import make_eval_step, steps
    imgs, segs = (t.cuda() for t in batch)
    (img_lo, img_hi), (seg_hi, _) = transform(imgs, segs)
    ones = torch.ones(imgs.shape[0], device='cuda')
    tail = model.SSSR_decoder.upsample16_pred[6]
    with torch.inference_mode():
        x = img_lo.permute(0, 3, 1, 2).contiguous()
        y = model(x, pre_tail=True)[0]
        times = {
            'transform_ms': cuda_ms(lambda: transform(imgs, segs), iters=5),
            'forward_pre_tail_ms': cuda_ms(lambda: model(x, pre_tail=True), iters=5, warmup=2),
            'tail_kernel_ms': cuda_ms(lambda: eval_tail(y, tail.weight, tail.bias, seg_hi), iters=20),
            'tail_plain_ms': cuda_ms(lambda: eval_tail_plain(y, tail.weight, tail.bias, seg_hi),
                                     iters=5, warmup=1),
            'forward_full_logits_ms': cuda_ms(lambda: model(x), iters=5, warmup=2),
            'eval_step_ms': cuda_ms(lambda: eval_step(model, img_lo, img_hi, seg_hi, ones),
                                    iters=5, warmup=2),
        }
    # The bfloat16 step that validates under --mixed-precision: K3 gets bfloat16.
    bf16_step = make_eval_step(NUM_CLASSES, 255, amp_dtype=torch.bfloat16)
    seen = []

    def spy(x, *args):
        seen.append(x.dtype)
        return eval_tail(x, *args)

    steps.eval_tail = spy
    try:
        ce_bf16 = float(bf16_step(model, img_lo, img_hi, seg_hi, ones)[0]['CE'])
    finally:
        steps.eval_tail = eval_tail
    times['eval_step_bf16_ms'] = cuda_ms(lambda: bf16_step(model, img_lo, img_hi, seg_hi, ones),
                                         iters=5, warmup=2)
    times['eval_step_bf16_img_per_s'] = imgs.shape[0] / times['eval_step_bf16_ms'] * 1e3
    with torch.inference_mode():
        y16 = bf16_step_activation(model, x)
        times['tail_kernel_bf16_ms'] = cuda_ms(
            lambda: eval_tail(y16, tail.weight, tail.bias, seg_hi), iters=20)
    times['eval_step_ce'], times['eval_step_bf16_ce'] = float(eval_step(
        model, img_lo, img_hi, seg_hi, ones)[0]['CE']), ce_bf16
    if seen != [torch.bfloat16] or not np.isfinite(ce_bf16):
        fail("the bfloat16 eval step handed K3 {} and gave CE {}".format(seen, ce_bf16))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eval_step(model, img_lo, img_hi, seg_hi, ones)
    torch.cuda.synchronize()
    times['eval_step_peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
    times['eval_step_img_per_s'] = imgs.shape[0] / times['eval_step_ms'] * 1e3
    print("eval step at batch {} on {}: {}".format(imgs.shape[0], device_name, json.dumps(times)),
          flush=True)


def main_path_phase(device_name):
    import numpy as np
    import torch
    from PIL import Image
    from dualsuperreslearningforsemseg_tpu_torch import settings
    from dualsuperreslearningforsemseg_tpu_torch.__main__ import main as cli_main
    from dualsuperreslearningforsemseg_tpu_torch.checkpoint import save_weights
    from dualsuperreslearningforsemseg_tpu_torch.commands.test import load_model
    from dualsuperreslearningforsemseg_tpu_torch.data import (
        make_synthetic_cityscapes_tree, make_eval_transform_fn, CityscapesDataset)
    from dualsuperreslearningforsemseg_tpu_torch.models import DSRL, init_weights
    from dualsuperreslearningforsemseg_tpu_torch.ops.eval_tail import eval_tail
    from dualsuperreslearningforsemseg_tpu_torch.train import make_eval_step

    if settings.MODEL_INPUT_SIZE != (256, 512) or settings.BACKBONE_LAYERS != (3, 4, 23, 3):
        fail("not at full size: {} {}".format(settings.MODEL_INPUT_SIZE, settings.BACKBONE_LAYERS))
    work = os.path.join(HERE, 'build', 'chip_smoke')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    os.chdir(work)
    t0 = time.time()
    data_root = os.path.join('datasets', 'Cityscapes', 'data')
    make_synthetic_cityscapes_tree(data_root, split='val', num_images=36,
                                   size_hw=(1024, 2048), seed=7, noise=1)
    model = init_weights(DSRL(num_classes=NUM_CLASSES),
                         torch.Generator().manual_seed(settings.RANDOM_SEED))
    weights = os.path.join('weights', 'stage1.weights')
    save_weights('weights', 'stage1.weights',
                 {k: v.numpy() for k, v in model.state_dict().items()}, None)
    print("set-up: 36 synthetic 1024x2048 val frames + seeded stage-1 weights in {:.1f} s"
          .format(time.time() - t0), flush=True)

    torch.cuda.reset_peak_memory_stats()
    eval_tail.launches = 0
    res = cli_main(['benchmark', '--weights', weights, '--dataset', 'cityscapes', 'val',
                    '--batch-size', '16'])
    launches = eval_tail.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_batches = -(-36 // 16)
    print("benchmark on {}: CE {:.6f}, mIoU {:.4f} %, accuracy {:.4f} %, {} images in {:.2f} s "
          "= {:.2f} img/s end to end (incl. model load, decode of 1024x2048 PNGs), "
          "peak device memory {:.2f} GiB, eval_tail launches {} for {} batches".format(
              device_name, res['CE'], res['mIoU'], res['accuracy'], res['images'],
              res['seconds'], res['images'] / res['seconds'], peak_gib, launches, n_batches),
          flush=True)
    if launches != n_batches:
        fail("eval_tail launched {} times for {} batches".format(launches, n_batches))
    if res['images'] != 36 or not np.isfinite(res['CE']) or not (0 <= res['mIoU'] <= 100) \
            or not (0 <= res['accuracy'] <= 100):
        fail("benchmark results out of range: {}".format(res))

    ds = settings.DATASETS['cityscapes']['settings']
    transform = make_eval_transform_fn(settings.MODEL_INPUT_SIZE, settings.MODEL_OUTPUT_SIZE,
                                       ds.MEAN, ds.STD, ds.LABEL_MAPPING_LUT)
    val = CityscapesDataset(data_root, split='val')
    model = load_model(weights, NUM_CLASSES, torch.device('cuda'))
    eval_step = make_eval_step(NUM_CLASSES, ds.IGNORE_CLASS_LABEL)
    batch = [torch.from_numpy(np.stack(a)) for a in zip(*(val[i] for i in range(16)))]
    check_eval_step(model, [t[:4] for t in batch], transform, eval_step)
    step_breakdown(model, batch, transform, eval_step, device_name)

    frame = val.pairs[0][0]
    cli_main(['test', '--image-file', frame, '--weights', weights, '--output-dir', 'outputs'])
    png = os.path.join('outputs', os.path.splitext(os.path.basename(frame))[0] + '.png')
    with Image.open(png) as im:
        size = im.size
    print("test --image-file wrote {} ({}x{})".format(png, *size), flush=True)
    if size != (3 * 1024, 512):
        fail("test output has size {}".format(size))
    return launches


def reset_counts():
    from dualsuperreslearningforsemseg_tpu_torch.ops.augment_post import photometric
    from dualsuperreslearningforsemseg_tpu_torch.ops.eval_tail import eval_tail
    from dualsuperreslearningforsemseg_tpu_torch.ops.fa_pairwise import (
        fa_pairwise_forward, fa_pairwise_backward)
    from dualsuperreslearningforsemseg_tpu_torch.ops.fused_tail import (
        fused_tail_forward, fused_tail_backward)
    fns = {'fused_tail_forward': fused_tail_forward, 'fused_tail_backward': fused_tail_backward,
           'augment_post': photometric, 'eval_tail': eval_tail,
           'fa_pairwise_forward': fa_pairwise_forward, 'fa_pairwise_backward': fa_pairwise_backward}
    for fn in fns.values():
        fn.launches = 0
    return fns


def train_phase(device_name):
    """``train`` of 3 steps at full depth through the CLI; returns the
    launch counts of that run and the final weights' path."""
    import math
    import numpy as np
    import torch
    from dualsuperreslearningforsemseg_tpu_torch.__main__ import main as cli_main
    from dualsuperreslearningforsemseg_tpu_torch.checkpoint import load_checkpoint_or_weights
    from dualsuperreslearningforsemseg_tpu_torch.data import make_synthetic_cityscapes_tree
    from dualsuperreslearningforsemseg_tpu_torch.models import DSRL, load_state_dict
    t0 = time.time()
    make_synthetic_cityscapes_tree(os.path.join('datasets', 'Cityscapes', 'data'), split='train',
                                   num_images=24, size_hw=(1024, 2048), seed=8, noise=1)
    print("set-up: 24 synthetic 1024x2048 train frames in {:.1f} s".format(time.time() - t0), flush=True)
    torch.cuda.reset_peak_memory_stats()
    fns = reset_counts()
    res = cli_main(['train', '--stage', '1', '--epochs', '1', '--batch-size', '8', '--dataset',
                    'cityscapes', '--val-interval', '1', '--experiment-id', 'smoke'])
    counts = {name: fn.launches for name, fn in fns.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steps, val_batches = 24 // 8, -(-36 // 8)
    print("train on {}: {} steps in {:.2f} s end to end (incl. model init, worker start-up, decode), "
          "train CE {:.6f}, val CE {:.6f}, mIoU {:.4f} %, accuracy {:.4f} %, peak device memory "
          "{:.2f} GiB, launches {}".format(
              device_name, res['steps'], res['seconds'], res['train_losses'][0]['CE'],
              res['val']['CE'], res['val']['mIoU'], res['val']['accuracy'], peak_gib,
              json.dumps(counts)), flush=True)
    want = {'fused_tail_forward': steps, 'fused_tail_backward': steps, 'augment_post': steps,
            'eval_tail': val_batches, 'fa_pairwise_forward': 0, 'fa_pairwise_backward': 0}
    if counts != want or res['steps'] != steps:
        fail("train launched {} for {} steps and {} val batches (want {})".format(
            counts, res['steps'], val_batches, want))
    losses = [v for d in res['train_losses'] for v in d.values()] + [res['val']['CE']]
    if not all(math.isfinite(v) for v in losses):
        fail("train losses are not finite: {}".format(res))
    state = load_checkpoint_or_weights(res['final_weights'])['model_state_dict']
    load_state_dict(DSRL(num_classes=NUM_CLASSES), state, strict=True)
    print("final.weights {} loads with strict=True ({} tensors)".format(res['final_weights'], len(state)),
          flush=True)
    bench = cli_main(['benchmark', '--weights', res['final_weights'], '--dataset', 'cityscapes',
                      'val', '--batch-size', '16'])
    print("benchmark of the trained weights: CE {:.6f}, mIoU {:.4f} %, accuracy {:.4f} %".format(
        bench['CE'], bench['mIoU'], bench['accuracy']), flush=True)
    if not np.isfinite(bench['CE']):
        fail("benchmark of the trained weights: {}".format(bench))
    return counts, res['final_weights']


def no_dropout(model):
    from torch import nn
    for module in list(model.modules()):
        for name, child in module.named_children():
            if isinstance(child, nn.Dropout):
                setattr(module, name, nn.Identity())
    return model


class _Tee:
    """Writes to several text streams (the CLI's output is shown and kept)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for stream in self.streams:
            stream.write(text)
        return len(text)

    def flush(self):
        for stream in self.streams:
            stream.flush()


def cascade_phase(device_name):
    """``train --stage 2`` and then ``--stage 3`` at full depth through the
    CLI, in the stage-1 run's experiment, each warm-starting from the stage
    before; returns the launch counts of the stage-3 run and its weights."""
    import contextlib
    import io
    import math
    import numpy as np
    import torch
    from dualsuperreslearningforsemseg_tpu_torch.__main__ import main as cli_main
    from dualsuperreslearningforsemseg_tpu_torch.checkpoint import load_checkpoint_or_weights
    from dualsuperreslearningforsemseg_tpu_torch.models import DSRL, load_state_dict
    steps, val_batches = 24 // 8, -(-36 // 8)
    for stage in (2, 3):
        previous = os.path.join('experiments', 'smoke', 'weights', 'stage{}'.format(stage - 1),
                                'final.weights')
        torch.cuda.reset_peak_memory_stats()
        fns = reset_counts()
        log = io.StringIO()
        with contextlib.redirect_stdout(_Tee(sys.stdout, log)):
            res = cli_main(['train', '--stage', str(stage), '--epochs', '1', '--batch-size', '8',
                            '--dataset', 'cityscapes', '--val-interval', '1',
                            '--experiment-id', 'smoke'])
        counts = {name: fn.launches for name, fn in fns.items()}
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        train, val = res['train_losses'][0], res['val']
        print("train --stage {} on {}: {} steps in {:.2f} s end to end, train losses {}, val losses "
              "CE {:.6f} MSE {:.6f} FA {:.6f}, mIoU {:.4f} %, peak device memory {:.2f} GiB, "
              "launches {}".format(stage, device_name, res['steps'], res['seconds'],
                                   json.dumps(train), val['CE'], val['MSE'], val['FA'], val['mIoU'],
                                   peak_gib, json.dumps(counts)), flush=True)
        k4 = stage == 3
        want = {'fused_tail_forward': steps, 'fused_tail_backward': steps, 'augment_post': steps,
                'eval_tail': val_batches, 'fa_pairwise_forward': (steps + val_batches) if k4 else 0,
                'fa_pairwise_backward': steps if k4 else 0}
        if counts != want or res['steps'] != steps:
            fail("train --stage {} launched {} (want {})".format(stage, counts, want))
        found = "'{}' weights file from previous stage was found".format(previous)
        if res['warm_start'] != previous or found not in log.getvalue():
            fail("stage {} did not warm-start from {}: {}".format(stage, previous, res['warm_start']))
        losses = list(train.values()) + [val[k] for k in ('CE', 'MSE', 'FA', 'Total')]
        if not all(math.isfinite(v) for v in losses) or not (train['MSE'] > 0 and val['MSE'] > 0) \
                or (k4 and not (train['FA'] > 0 and val['FA'] > 0)):
            fail("stage {} losses: {} {}".format(stage, train, val))
        state = load_checkpoint_or_weights(res['final_weights'])['model_state_dict']
        load_state_dict(DSRL(num_classes=NUM_CLASSES, stage=stage), state, strict=True)
        print("stage {} warm-started from {}; its final.weights loads into DSRL(stage={}) with "
              "strict=True ({} tensors)".format(stage, previous, stage, len(state)), flush=True)
    bench = cli_main(['benchmark', '--weights', res['final_weights'], '--dataset', 'cityscapes',
                      'val', '--batch-size', '16'])
    print("benchmark of the stage-3 weights (stage-1 model, strict=False): CE {:.6f}, mIoU {:.4f} %"
          .format(bench['CE'], bench['mIoU']), flush=True)
    if not np.isfinite(bench['CE']):
        fail("benchmark of the stage-3 weights: {}".format(bench))
    return counts, res['final_weights']


def load_stage_model(weights, stage):
    import torch
    from dualsuperreslearningforsemseg_tpu_torch.checkpoint import load_checkpoint_or_weights
    from dualsuperreslearningforsemseg_tpu_torch.models import DSRL, load_state_dict
    model = DSRL(num_classes=NUM_CLASSES, stage=stage)
    load_state_dict(model, load_checkpoint_or_weights(weights)['model_state_dict'], strict=True)
    return model.to(torch.device('cuda'))


def sgd_updates(optimizer, model, lr):
    """The update SGD applied, lr * (grad + wd * p), read from its momentum
    buffers, since p_after - p_before is quantised to an ulp of p."""
    return {k: lr * optimizer.state[v]['momentum_buffer'] for k, v in model.named_parameters()}


def interpolate_resize(x, out_hw):
    """The parent's in-graph resize: ``F.interpolate`` with align_corners."""
    import torch.nn.functional as F
    return F.interpolate(x, size=tuple(int(v) for v in out_hw), mode='bilinear', align_corners=True)


def timed_with_resize(fn, resize):
    """cuda_ms of ``fn`` with the model's three in-graph resizes (the
    ``resize_bilinear_matmul`` that models/dsrl.py and models/aspp.py call)
    replaced by ``resize``."""
    from dualsuperreslearningforsemseg_tpu_torch.models import aspp, dsrl
    saved = dsrl.resize_bilinear_matmul, aspp.resize_bilinear_matmul
    dsrl.resize_bilinear_matmul = aspp.resize_bilinear_matmul = resize
    try:
        return cuda_ms(fn, iters=5, warmup=1)
    finally:
        dsrl.resize_bilinear_matmul, aspp.resize_bilinear_matmul = saved


def resize_times(device_name):
    """Forward + backward of each in-graph resize at batch 8, the parent's
    ``F.interpolate`` against the matmul resize, float32 and bfloat16, with
    CUDA events: the ASPP's pooled branch, x4 after the ASPP and the
    decoder's x2."""
    import torch
    from dualsuperreslearningforsemseg_tpu_torch.ops.resize import resize_bilinear_matmul
    gen = torch.Generator(device='cuda').manual_seed(3)
    sites = {'pooled (8,256,1,1)->(16,32)': ((8, 256, 1, 1), (16, 32)),
             'x4 (8,256,16,32)->(64,128)': ((8, 256, 16, 32), (64, 128)),
             'x2 (8,19,64,128)->(128,256)': ((8, 19, 64, 128), (128, 256))}
    times = {}
    for site, (shape, out_hw) in sites.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device='cuda').to(dtype).requires_grad_()
            g = torch.randn(shape[:2] + out_hw, generator=gen, device='cuda').to(dtype)
            for name, fn in (('interpolate', interpolate_resize), ('matmul', resize_bilinear_matmul)):
                times['{} {} {}'.format(site, str(dtype)[6:], name)] = cuda_ms(
                    lambda: fn(x, out_hw).backward(g), iters=20)
    print("resize forward + backward on {}, ms: {}".format(device_name, json.dumps(times)), flush=True)
    return times


def train_step_phase(device_name, weights, stage):
    """One step against the same step with a plain part (stage 1: the plain
    tail instead of K1; stage 3: the dense FA instead of K4), then the warm
    step's breakdown at batch 8 (float32) and one bfloat16 step."""
    import copy
    import numpy as np
    import torch
    from dualsuperreslearningforsemseg_tpu_torch import settings
    from dualsuperreslearningforsemseg_tpu_torch.data import (
        AugmentConfig, CityscapesDataset, make_warp_transform, make_device_post_fn)
    from dualsuperreslearningforsemseg_tpu_torch.losses import fa as fa_module, mse_loss
    from dualsuperreslearningforsemseg_tpu_torch.models.dsrl import SISR_UPSCALE
    from dualsuperreslearningforsemseg_tpu_torch.ops import fa_pairwise, fused_tail
    from dualsuperreslearningforsemseg_tpu_torch.ops.resize import resize_bilinear_matmul
    from dualsuperreslearningforsemseg_tpu_torch.train import make_train_step, make_sgd, steps
    ds = settings.DATASETS['cityscapes']['settings']
    cfg = AugmentConfig(input_hw=settings.MODEL_INPUT_SIZE, output_hw=settings.MODEL_OUTPUT_SIZE,
                        mean=ds.MEAN, std=ds.STD)
    unshuffle = SISR_UPSCALE if stage > 1 else 0
    train_set = CityscapesDataset(os.path.join('datasets', 'Cityscapes', 'data'), split='train')
    imgs, segs = (torch.from_numpy(np.stack(a)).cuda()
                  for a in zip(*(train_set[i] for i in range(8))))
    warp = make_warp_transform(cfg, ds.LABEL_MAPPING_LUT, settings.RANDOM_SEED)
    lr, ignore = 0.006, ds.IGNORE_CLASS_LABEL
    w1, w2 = settings.DEFAULT_LOSS_WEIGHTS

    # (a) The kernel against the plain part, one step each from the same state.
    if stage == 1:
        swap = ('fused_convt2_ce_sum', fused_tail.fused_convt2_ce_sum,
                fused_tail.fused_convt2_ce_sum_plain, 'K1', 'the plain tail')
    else:
        swap = ('fa_loss', fa_module.fa_loss, lambda a, b: fa_module.fa_loss(a, b, impl='dense'),
                'K4', 'the dense FA')
    base = no_dropout(load_stage_model(weights, stage))
    runs = {}
    for name, fn in (('kernel', swap[1]), ('plain', swap[2])):
        model = copy.deepcopy(base)
        optimizer = make_sgd(model, lr, 0.9, 0.0005)
        step = make_train_step(model, optimizer, stage, w1, w2, ignore, True,
                               post_fn=make_device_post_fn(cfg, unshuffle_hi=unshuffle))
        setattr(steps, swap[0], fn)
        try:
            imgs_w, segs_w = warp(1, 0, imgs, segs)
            losses = step(imgs_w, segs_w, lr, torch.Generator(device='cuda').manual_seed(5))
            torch.cuda.synchronize()
        finally:
            setattr(steps, swap[0], swap[1])
        runs[name] = ({k: float(v) for k, v in losses.items()}, sgd_updates(optimizer, model, lr))
    (loss_k, upd_k), (loss_p, upd_p) = runs['kernel'], runs['plain']
    largest = max(float(u.abs().max()) for u in upd_p.values())
    worst = max(float((upd_k[k] - upd_p[k]).abs().max()) for k in upd_p)
    rel = {k: abs(loss_k[k] - loss_p[k]) / max(abs(loss_p[k]), 1e-30) for k in loss_p}
    out = {'losses_kernel': loss_k, 'losses_plain': loss_p, 'rel_err': rel,
           'largest_update': largest, 'max_update_diff': worst,
           'update_diff_over_largest': worst / largest, 'tensors': len(upd_p)}
    print("stage-{} train step with {} vs {} (dropout off, BN frozen): {}".format(
        stage, swap[3], swap[4], json.dumps(out)), flush=True)
    if not (max(rel.values()) <= 1e-5 and worst <= 1e-4 * largest) \
            or (stage == 3 and not loss_k['FA'] > 0):
        fail("stage-{} train step with {} disagrees with {}: {}".format(stage, swap[3], swap[4], out))
    del runs, upd_k, upd_p, base

    # (b) The warm float32 step at batch 8 and its parts.
    model = load_stage_model(weights, stage)
    optimizer = make_sgd(model, lr, 0.9, 0.0005)
    post = make_device_post_fn(cfg, unshuffle_hi=unshuffle)
    gen = torch.Generator(device='cuda').manual_seed(6)
    step = make_train_step(model, optimizer, stage, w1, w2, ignore, False, post_fn=post)
    tail = model.SSSR_decoder.upsample16_pred[6]
    parts = ['warp', 'k2_resize', 'forward', 'k1_forward'] + (['mse', 'fa'] if stage == 3 else []) \
        + ['backward', 'optimizer']
    totals = dict.fromkeys(parts, 0.0)
    n_timed, n_warm = 5, 2
    for i in range(n_warm + n_timed):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(parts) + 1)]
        marks = iter(ev)
        next(marks).record()
        imgs_w, segs_w = warp(1, i, imgs, segs)
        next(marks).record()
        (img_lo, img_hi), (seg_hi, _) = post(imgs_w, segs_w, gen)
        next(marks).record()
        model.train()
        for group in optimizer.param_groups:
            group['lr'] = lr
        sssr, sisr, sssr_t, sisr_t = model(img_lo.permute(0, 3, 1, 2).contiguous(), pre_tail=True)
        next(marks).record()
        total = fused_tail.fused_convt2_ce_mean(sssr, tail.weight, tail.bias, seg_hi.contiguous(),
                                                ignore)
        next(marks).record()
        if stage == 3:
            total = total + w1 * mse_loss(sisr, img_hi.permute(0, 3, 1, 2))
            next(marks).record()
            total = total + w2 * fa_module.fa_loss(sssr_t, sisr_t)
            next(marks).record()
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        next(marks).record()
        optimizer.step()
        next(marks).record()
        torch.cuda.synchronize()
        if i >= n_warm:
            for k, name in enumerate(parts):
                totals[name] += ev[k].elapsed_time(ev[k + 1]) / n_timed
    times = {name + '_ms': totals[name] for name in parts}
    times['k1_backward_ms (inside backward)'] = cuda_ms(
        lambda: fused_tail.fused_tail_backward(sssr.detach(), tail.weight.detach(), tail.bias.detach(),
                                               seg_hi.contiguous(), torch.ones((), device='cuda')),
        iters=10)
    if stage == 3:
        pooled = [fa_module._pooled_slices(t.detach(), 8) for t in (sssr_t, sisr_t)]
        rows = [fa_module._similarity_rows(p) for p in pooled]
        g = torch.ones(rows[0].shape[0], device='cuda')
        times['fa_power_iteration_ms (inside fa, both maps)'] = cuda_ms(
            lambda: [fa_module._spectral_norm_hw(p) for p in pooled], iters=10)
        times['k4_forward_ms (inside fa)'] = cuda_ms(
            lambda: fa_pairwise.fa_pairwise_forward(*rows), iters=50)
        times['k4_backward_ms (inside backward)'] = cuda_ms(
            lambda: fa_pairwise.fa_pairwise_backward(*rows, g), iters=50)
        times['fa_rows_shape'] = list(rows[0].shape)

    def whole_step():
        imgs_w, segs_w = warp(1, 0, imgs, segs)
        step(imgs_w, segs_w, lr, gen)

    times['step_ms'] = cuda_ms(whole_step, iters=5, warmup=1)
    # The cost of cuDNN's deterministic algorithms (select_device sets them):
    # the same step without them, then with them again.
    torch.backends.cudnn.deterministic = False
    times['step_ms_cudnn_nondeterministic'] = cuda_ms(whole_step, iters=5, warmup=2)
    torch.backends.cudnn.deterministic = True
    times['step_ms_again'] = cuda_ms(whole_step, iters=5, warmup=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    whole_step()
    torch.cuda.synchronize()
    times['step_peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
    times['step_img_per_s'] = 8 / times['step_ms'] * 1e3

    # (c) One bfloat16 step (--mixed-precision O1): K1 must receive bfloat16,
    # and at stage 3 K4 float32.
    seen = {'K1': [], 'K4': []}

    def spy_k1(x, *args):
        seen['K1'].append(x.dtype)
        return fused_tail.fused_convt2_ce_sum(x, *args)

    def spy_k4(a, b):
        seen['K4'].append(a.dtype)
        return k4_mean(a, b)

    bf16_step = make_train_step(model, optimizer, stage, w1, w2, ignore, False,
                                post_fn=make_device_post_fn(cfg, dtype=torch.bfloat16,
                                                            unshuffle_hi=unshuffle),
                                amp_dtype=torch.bfloat16)

    def whole_bf16_step():
        imgs_w, segs_w = warp(1, 0, imgs, segs)
        return bf16_step(imgs_w, segs_w, lr, gen)

    k4_mean = fa_module.fa_allpairs_abs_mean
    steps.fused_convt2_ce_sum, fa_module.fa_allpairs_abs_mean = spy_k1, spy_k4
    try:
        bf16_losses = {k: (float(v), str(v.dtype)) for k, v in whole_bf16_step().items()}
    finally:
        steps.fused_convt2_ce_sum = fused_tail.fused_convt2_ce_sum
        fa_module.fa_allpairs_abs_mean = k4_mean
    times['bf16_step_ms'] = cuda_ms(whole_bf16_step, iters=5, warmup=1)
    times['bf16_step_img_per_s'] = 8 / times['bf16_step_ms'] * 1e3
    # The step with the parent's resize (F.interpolate, whose backward adds
    # with atomics) against the matmul resize, in turns: parent, this,
    # this, parent, float32 and bfloat16.
    for label, fn in (('step_ms', whole_step), ('bf16_step_ms', whole_bf16_step)):
        times[label + ' (parent resize, this, this, parent resize)'] = [
            timed_with_resize(fn, resize) for resize in
            (interpolate_resize, resize_bilinear_matmul, resize_bilinear_matmul, interpolate_resize)]
    print("stage-{} train step at batch 8 on {}: {}".format(stage, device_name, json.dumps(times)),
          flush=True)
    print("stage-{} bfloat16 step: K1 received {}, K4 received {}, losses {}".format(
        stage, seen['K1'], seen['K4'], json.dumps(bf16_losses)), flush=True)
    want_k4 = [torch.float32] if stage == 3 else []
    if seen['K1'] != [torch.bfloat16] or seen['K4'] != want_k4 \
            or not all(np.isfinite(v) and d == 'torch.float32' for v, d in bf16_losses.values()):
        fail("the bfloat16 step handed K1 {} and K4 {}: {}".format(seen['K1'], seen['K4'],
                                                                  bf16_losses))
    return times


def determinism_phase(device_name, weights, stage):
    """Two full-depth train steps at batch 8 from one saved model, optimizer,
    photometric generator and CUDA RNG state, after a warm-up step (the
    momentum buffers exist and cuDNN's autotuner has chosen), with
    ``select_device``'s settings and live dropout and BatchNorm: the losses
    and every state tensor must be bitwise equal."""
    import copy
    import numpy as np
    import torch
    from dualsuperreslearningforsemseg_tpu_torch import settings
    from dualsuperreslearningforsemseg_tpu_torch.data import (
        AugmentConfig, CityscapesDataset, make_warp_transform, make_device_post_fn)
    from dualsuperreslearningforsemseg_tpu_torch.models.dsrl import SISR_UPSCALE
    from dualsuperreslearningforsemseg_tpu_torch.train import make_train_step, make_sgd
    ds = settings.DATASETS['cityscapes']['settings']
    cfg = AugmentConfig(input_hw=settings.MODEL_INPUT_SIZE, output_hw=settings.MODEL_OUTPUT_SIZE,
                        mean=ds.MEAN, std=ds.STD)
    train_set = CityscapesDataset(os.path.join('datasets', 'Cityscapes', 'data'), split='train')
    imgs, segs = (torch.from_numpy(np.stack(a)).cuda()
                  for a in zip(*(train_set[i] for i in range(8, 16))))
    imgs, segs = make_warp_transform(cfg, ds.LABEL_MAPPING_LUT, settings.RANDOM_SEED)(1, 1, imgs, segs)
    model = load_stage_model(weights, stage)
    optimizer = make_sgd(model, 0.006, 0.9, 0.0005)
    w1, w2 = settings.DEFAULT_LOSS_WEIGHTS
    post = make_device_post_fn(cfg, unshuffle_hi=SISR_UPSCALE if stage > 1 else 0)
    step = make_train_step(model, optimizer, stage, w1, w2, ds.IGNORE_CLASS_LABEL, False, post_fn=post)
    gen = torch.Generator(device='cuda').manual_seed(9)
    step(imgs, segs, 0.006, gen)
    saved = (copy.deepcopy(model.state_dict()), copy.deepcopy(optimizer.state_dict()),
             gen.get_state(), torch.cuda.get_rng_state())
    runs = []
    for _ in range(2):
        model.load_state_dict(saved[0])
        optimizer.load_state_dict(copy.deepcopy(saved[1]))
        gen.set_state(saved[2])
        torch.cuda.set_rng_state(saved[3])
        losses = step(imgs, segs, 0.006, gen)
        runs.append(({k: v.detach().clone() for k, v in losses.items()},
                     {k: v.detach().clone() for k, v in model.state_dict().items()}))
    (losses_a, state_a), (losses_b, state_b) = runs
    differ = [k for k in losses_a if not torch.equal(losses_a[k], losses_b[k])]
    differ += [k for k in state_a if not torch.equal(state_a[k], state_b[k])]
    moved = sum(not torch.equal(state_a[k], saved[0][k]) for k in saved[0])
    out = {'stage': stage, 'losses': {k: float(v) for k, v in losses_a.items()},
           'state_tensors': len(state_a), 'moved_by_the_step': moved, 'differ': differ,
           'cudnn_deterministic': torch.backends.cudnn.deterministic}
    print("determinism at stage {} on {}, full depth, batch 8: {}".format(stage, device_name,
                                                                        json.dumps(out)), flush=True)
    if differ or not moved or not all(np.isfinite(v) for v in out['losses'].values()):
        fail("two stage-{} train steps from one state are not bitwise equal: {}".format(stage, out))


def _same_arrays(a, b):
    """Names whose arrays differ in dtype, shape or any bit."""
    import numpy as np
    differ = sorted(set(a) ^ set(b))
    for k in set(a) & set(b):
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
            differ.append(k)
    return differ


def state_phase(device_name, counts3):
    """Autosaved and best-validation checkpoints at stage 3, two resumes from
    one of them and the momentum restored on the card (phase 12)."""
    import importlib
    import numpy as np
    import torch
    from dualsuperreslearningforsemseg_tpu_torch.__main__ import main as cli_main
    from dualsuperreslearningforsemseg_tpu_torch.checkpoint import load_checkpoint_or_weights
    engine = importlib.import_module('dualsuperreslearningforsemseg_tpu_torch.commands.train_or_resume')
    from dualsuperreslearningforsemseg_tpu_torch.models import DSRL, load_state_dict
    from dualsuperreslearningforsemseg_tpu_torch.train import (
        make_sgd, load_optimizer_state_dict, optimizer_state_dict)
    t_phase = time.time()
    exp = os.path.join('experiments', 'smoke_state')
    ckdir = os.path.join(exp, 'weights', 'stage3', 'checkpoints')
    logs = os.path.join(exp, 'logs', 'stage3')
    fns = reset_counts()
    res = cli_main(['train', '--stage', '3', '--epochs', '2', '--batch-size', '8', '--dataset',
                    'cityscapes', '--val-interval', '1', '--checkpoint-interval', '1',
                    '--checkpoint-history', '2', '--init-weights',
                    os.path.join('experiments', 'smoke', 'weights', 'stage2', 'final.weights'),
                    '--experiment-id', 'smoke_state'])
    counts = {name: fn.launches for name, fn in fns.items()}
    want = {k: 2 * v for k, v in counts3.items()}
    print("train --stage 3 --epochs 2 with autosaves on {}: {:.2f} s end to end, launches {}".format(
        device_name, res['seconds'], json.dumps(counts)), flush=True)
    if counts != want:
        fail("two epochs launched {} (want {})".format(counts, want))
    for c in res['checkpoints']:
        print("checkpoint {}: {} bytes ({:.1f} MiB), saved in {:.3f} s (state to the host + "
              "zip write)".format(c['path'], c['bytes'], c['bytes'] / 2 ** 20, c['seconds']), flush=True)
    names = sorted(os.listdir(ckdir))
    bestval = [n for n in names if n.endswith('_bestval.checkpoint')]
    log_files = {mode: sorted(os.listdir(os.path.join(logs, mode))) for mode in ('train', 'val')}
    formats = {mode: ('event files' if any(f.startswith('events.out.tfevents.') for f in files)
                      else 'JSONL' if 'events.jsonl' in files else None)
               for mode, files in log_files.items()}
    print("checkpoints {}; logs {}; train log {}, val log {}".format(
        names, json.dumps(log_files), formats['train'], formats['val']), flush=True)
    if not {'epoch1.checkpoint', 'epoch2.checkpoint'} <= set(names) or len(bestval) != 1 \
            or not {'params.txt', 'stdout.txt'} <= set(log_files['train']) or None in formats.values():
        fail("training state files missing: {} {}".format(names, log_files))

    epoch1 = os.path.join(ckdir, 'epoch1.checkpoint')
    final = os.path.join(exp, 'weights', 'stage3', 'final.weights')
    first_step = {}
    make_step = engine.make_train_step

    def timed_make_train_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def timed(*step_args):
            if 'seconds' in first_step:
                return step(*step_args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*step_args)
            torch.cuda.synchronize()
            first_step['seconds'] = time.perf_counter() - t0
            return out
        return timed

    finals = []
    for run in (1, 2):
        first_step.clear()
        fns = reset_counts()
        engine.make_train_step = timed_make_train_step
        try:
            res = cli_main(['resume-train', '--checkpoint', epoch1, '--dataset', 'cityscapes'])
        finally:
            engine.make_train_step = make_step
        counts = {name: fn.launches for name, fn in fns.items()}
        with open(os.path.join(logs, 'train', 'stdout.txt')) as f:
            stdout = f.read()
        print("resume-train {} from {} on {}: {:.2f} s end to end, first resumed step {:.3f} s, "
              "launches {}".format(run, epoch1, device_name, res['seconds'], first_step['seconds'],
                                   json.dumps(counts)), flush=True)
        if counts != counts3 or res['starting_epoch'] != 1:
            fail("resume {} launched {} (want {}), started after epoch {}".format(
                run, counts, counts3, res['starting_epoch']))
        if 'EPOCH 2/2' not in stdout or 'EPOCH 1/2' in stdout:
            fail("resume {} did not run epoch 2 alone".format(run))
        finals.append(load_checkpoint_or_weights(final)['model_state_dict'])
    differ = _same_arrays(*finals)
    print("the two resumes' final.weights: {} tensors, {} differ".format(len(finals[0]), len(differ)),
          flush=True)
    if differ:
        fail("two resumes from one checkpoint differ in {}".format(differ[:8]))

    t0 = time.perf_counter()
    ckpt = load_checkpoint_or_weights(epoch1)
    read_s = time.perf_counter() - t0
    model = DSRL(num_classes=NUM_CLASSES, stage=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    load_state_dict(model, ckpt['model_state_dict'], strict=True)
    model.to(torch.device('cuda'))
    optimizer = make_sgd(model, ckpt['learning_rate'], ckpt['momentum'], ckpt['weights_decay'])
    load_optimizer_state_dict(optimizer, model, ckpt['optimizer_state_dict'])
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    saved = ckpt['optimizer_state_dict']['momentum_buffers']
    again = optimizer_state_dict(optimizer, model, ckpt['learning_rate'], ckpt['momentum'],
                                 ckpt['weights_decay'])['momentum_buffers']
    differ = _same_arrays(saved, again)
    nonzero = sum(bool(np.any(v)) for v in saved.values())
    n_param = sum(p.numel() for p in model.parameters())
    n_buffer = sum(b.numel() for b in model.buffers() if b.is_floating_point())
    print("checkpoint read {:.3f} s, restored onto the card (model + momentum) {:.3f} s; "
          "{} momentum buffers ({} non-zero), {} differ from the file's; {} parameters, {} float "
          "BN buffers ({:.1f} MiB of float32 state with the momentum); phase {:.1f} s".format(
              read_s, restore_s, len(saved), nonzero, len(differ), n_param, n_buffer,
              (2 * n_param + n_buffer) * 4 / 2 ** 20, time.time() - t_phase), flush=True)
    if differ or len(saved) != len(list(model.parameters())) or not nonzero:
        fail("restored momentum is not the file's: {} differ, {} of {} buffers".format(
            differ[:8], len(saved), len(list(model.parameters()))))


def _png(path):
    import numpy as np
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im)


def commands_phase(device_name):
    """compile-model and test --compiled-model, test --dataset, prune-weights
    with benchmark, print-model, inspect/edit-checkpoint and the augmentation
    script on the card (phase 13)."""
    import contextlib
    import io
    import statistics
    import numpy as np
    import torch
    from PIL import Image, ImageOps
    from dualsuperreslearningforsemseg_tpu_torch import settings
    from dualsuperreslearningforsemseg_tpu_torch.__main__ import main as cli_main
    from dualsuperreslearningforsemseg_tpu_torch.checkpoint import load_checkpoint_or_weights
    from dualsuperreslearningforsemseg_tpu_torch.commands.compile_model import load_compiled_model
    from dualsuperreslearningforsemseg_tpu_torch.commands.test import load_model, network_input
    from dualsuperreslearningforsemseg_tpu_torch.data import CityscapesDataset
    from dualsuperreslearningforsemseg_tpu_torch.models import DSRL
    from dualsuperreslearningforsemseg_tpu_torch.run_script import main as run_script
    t_phase = time.time()
    cuda = torch.device('cuda')
    ds = settings.DATASETS['cityscapes']['settings']
    oh, ow = settings.MODEL_OUTPUT_SIZE
    stage1 = os.path.join('experiments', 'smoke', 'weights', 'stage1', 'final.weights')
    stage3 = os.path.join('experiments', 'smoke', 'weights', 'stage3', 'final.weights')

    # (a) compile-model; test --images-dir eager and from the program.
    res = cli_main(['compile-model', '--weights', stage1, '--output-file', 'model.pt2'])
    print("compile-model on {}: export + save {:.3f} s, bundle {} bytes ({:.1f} MiB)".format(
        device_name, res['seconds'], res['bytes'], res['bytes'] / 2 ** 20), flush=True)
    val = CityscapesDataset(os.path.join('datasets', 'Cityscapes', 'data'), split='val')
    os.makedirs('frames8', exist_ok=True)
    for path, _ in val.pairs[:8]:
        shutil.copy(path, 'frames8')
    runs = {}
    for mode, extra in (('eager', ['--weights', stage1]),
                        ('compiled', ['--weights', 'model.pt2', '--compiled-model'])):
        runs[mode] = cli_main(['test', '--images-dir', 'frames8', '--output-dir', 'out_' + mode]
                              + extra)
        sec = runs[mode]['seconds']
        print("test --images-dir ({}) on {}: {} frames, inference p50 {:.3f} ms (uint8 frame to "
              "the card, normalize, resize, forward, argmax, class map back), each {}".format(
                  mode, device_name, len(sec), 1e3 * statistics.median(sec),
                  [round(1e3 * v, 3) for v in sec]), flush=True)
    eager, program = load_model(stage1, NUM_CLASSES, cuda), load_compiled_model('model.pt2', cuda)
    flips = png_differ = beyond = 0
    for (frame, _), a, b in zip(val.pairs[:8], runs['eager']['outputs'], runs['compiled']['outputs']):
        with Image.open(frame) as src:
            arr = np.asarray(ImageOps.exif_transpose(src).convert('RGB')
                             .resize((ow, oh), resample=Image.BILINEAR), dtype=np.uint8)
        with torch.inference_mode():
            x = network_input(arr, ds, cuda)
            ref, got = eager(x)[0][0], program(x)[0][0]
            top2 = ref.topk(2, dim=0).values
            near = ((top2[0] - top2[1]) <= 1e-4).cpu().numpy()
            flip = (ref.argmax(0) != got.argmax(0)).cpu().numpy()
        png_a, png_b = _png(a), _png(b)
        differ = np.any(png_a != png_b, axis=-1)
        differ = differ[:, ow:2 * ow] | differ[:, 2 * ow:]
        flips, png_differ = flips + int(flip.sum()), png_differ + int(differ.sum())
        beyond += int((flip & ~near).sum()) + int((differ & ~near).sum())
        beyond += int(np.any(png_a[:, :ow] != png_b[:, :ow]))
    print("compiled vs eager class maps over 8 frames: {} pixels differ recomputed, {} in the PNGs, "
          "{} of them not near-ties (top-2 within 1e-4)".format(flips, png_differ, beyond), flush=True)
    with torch.inference_mode():
        forward_ms = {mode: cuda_ms(lambda f=f: f(x), iters=20)
                      for mode, f in (('eager', eager), ('compiled', program))}
    print("batch-1 forward alone on {} (CUDA events over 20 calls, the last frame): eager {:.3f} ms, "
          "compiled {:.3f} ms".format(device_name, forward_ms['eager'], forward_ms['compiled']),
          flush=True)
    if beyond:
        fail("the compiled model's class map differs from the eager one beyond near-ties")

    # (b) test --dataset from index 30 of the 36-frame split.
    res = cli_main(['test', '--dataset', 'cityscapes', 'val', '30', '--no-interactive',
                    '--weights', stage1, '--output-dir', 'out_dataset'])
    sizes = [_png(p).shape for p in res['outputs']]
    print("test --dataset cityscapes val 30 on {}: {} pairs {}, inference p50 {:.3f} ms".format(
        device_name, len(sizes), sorted(os.listdir('out_dataset')),
        1e3 * statistics.median(res['seconds'])), flush=True)
    if sorted(os.listdir('out_dataset')) != ['{}.png'.format(i) for i in range(30, 36)] \
            or set(sizes) != {(2 * oh, 3 * ow, 3)}:
        fail("test --dataset wrote {} of shapes {}".format(os.listdir('out_dataset'), set(sizes)))

    # (c) prune-weights, the benchmark of the pruned file, --torch-format.
    cli_main(['prune-weights', '--src-weights', stage3, '--dest-weights', 'pruned.weights', '--yes'])
    cli_main(['prune-weights', '--src-weights', stage3, '--dest-weights', 'pruned.pth',
              '--torch-format', '--yes'])
    pth = torch.load('pruned.pth', map_location='cpu', weights_only=True)
    DSRL(num_classes=NUM_CLASSES).load_state_dict(pth, strict=True)
    bench, k3 = {}, {}
    for name, weights in (('unpruned', stage3), ('pruned', 'pruned.weights')):
        fns = reset_counts()
        bench[name] = cli_main(['benchmark', '--weights', weights, '--dataset', 'cityscapes', 'val',
                                '--batch-size', '16', '--disable-cudnn-benchmark'])
        k3[name] = fns['eval_tail'].launches
    results = {name: (r['CE'], r['mIoU'], r['accuracy']) for name, r in bench.items()}
    print("benchmark of the stage-3 weights, unpruned / pruned: {} / {}; eval_tail launches {}; "
          "pruned .pth: {} tensors, loads with strict=True".format(
              results['unpruned'], results['pruned'], k3, len(pth)), flush=True)
    if results['pruned'] != results['unpruned'] or k3['pruned'] != -(-36 // 16):
        fail("pruned benchmark {} vs {}, K3 launches {}".format(results['pruned'],
                                                                results['unpruned'], k3))

    # (d) print-model, inspect-checkpoint, edit-checkpoint.
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        counts = cli_main(['print-model', '--stage', '3'])
    n_params = sum(p.numel() for p in DSRL(num_classes=NUM_CLASSES, stage=3).parameters())
    print("print-model --stage 3: {} lines, counts {}".format(len(log.getvalue().splitlines()), counts),
          flush=True)
    if counts != (n_params, n_params):
        fail("print-model counted {} (want {})".format(counts, n_params))
    checkpoint = os.path.join('experiments', 'smoke_state', 'weights', 'stage3', 'checkpoints',
                              'epoch1.checkpoint')
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        cli_main(['inspect-checkpoint', '--checkpoint', checkpoint])
    inspect_s, t0 = time.perf_counter() - t0, time.perf_counter()
    cli_main(['edit-checkpoint', '--checkpoint', checkpoint, '--key', 'description', '--value',
              'edited on the card', '--typeof', 'str'])
    edit_s = time.perf_counter() - t0
    edited = load_checkpoint_or_weights(checkpoint)
    print("inspect-checkpoint {:.3f} s: {}; edit-checkpoint {:.3f} s".format(
        inspect_s, log.getvalue().strip()[:200], edit_s), flush=True)
    if 'epochs: 2' not in log.getvalue() or edited['description'] != 'edited on the card' \
            or edited['epoch'] != 1:
        fail("inspect/edit-checkpoint: {}".format(log.getvalue()[:400]))

    # (e) the augmentation script: K2 on the card.
    fns = reset_counts()
    rc = run_script(['show_augmented_inputs_targets', '--dataset', 'cityscapes', 'train',
                     '--limit', '4', '--output-dir', 'augmented'])
    k2 = fns['augment_post'].launches
    shapes = {_png(os.path.join('augmented', n)).shape for n in os.listdir('augmented')}
    print("run_script show_augmented_inputs_targets --limit 4: rc {}, {} PNGs of {}, augment_post "
          "launches {}; phase {:.1f} s".format(rc, len(os.listdir('augmented')), shapes, k2,
                                              time.time() - t_phase), flush=True)
    if rc != 0 or k2 < 1 or len(os.listdir('augmented')) != 4 or shapes != {(oh, 3 * ow, 3)}:
        fail("show_augmented_inputs_targets: rc {}, K2 launches {}, {}".format(
            rc, k2, os.listdir('augmented')))


# Phase 14: multi-process training.  The ranks are spawned processes that run
# this module's _distributed_rank; every number they report goes through a
# JSON file in the phase's work directory.
DIST_LR = 0.006
DIST_VAL_FRAMES = 35      # an odd count: the 2-rank pass pads one entry
DIST_TAIL_SCALE = 8.0
# The noise floors of the two steps compared: the same frames in other
# orders (the same sums, rounded in another order), the 8 frames of the
# one-process step and each rank's 4.
DIST_REORDERS = {'halves_swapped': [4, 5, 6, 7, 0, 1, 2, 3], 'reversed': [7, 6, 5, 4, 3, 2, 1, 0],
                 'interleaved': [0, 4, 1, 5, 2, 6, 3, 7], 'shuffled_a': [2, 7, 4, 1, 6, 0, 5, 3],
                 'shuffled_b': [5, 0, 3, 6, 1, 7, 2, 4], 'shuffled_c': [1, 3, 0, 7, 5, 2, 6, 4]}
DIST_RANK_REORDERS = {'reversed': [3, 2, 1, 0], 'rotated': [1, 2, 3, 0], 'shuffled': [2, 0, 3, 1]}


def _distributed_inputs(work):
    import torch
    return (torch.load(os.path.join(work, 'state.pt')), torch.load(os.path.join(work, 'frames.pt')))


def _distributed_parts(stage_model_state, device):
    """The stage-3 model (dropout off) on ``device``, its SGD and the fused
    train step with a photometric tail that draws nothing (blur and
    grayscale off), so one process and two ranks see the same images."""
    from dualsuperreslearningforsemseg_tpu_torch import settings
    from dualsuperreslearningforsemseg_tpu_torch.data import AugmentConfig, make_device_post_fn
    from dualsuperreslearningforsemseg_tpu_torch.models import DSRL, load_state_dict
    from dualsuperreslearningforsemseg_tpu_torch.models.dsrl import SISR_UPSCALE
    from dualsuperreslearningforsemseg_tpu_torch.train import make_sgd
    ds = settings.DATASETS['cityscapes']['settings']
    model = DSRL(num_classes=NUM_CLASSES, stage=3)
    load_state_dict(model, stage_model_state, strict=True)
    model = no_dropout(model).to(device)
    cfg = AugmentConfig(input_hw=settings.MODEL_INPUT_SIZE, output_hw=settings.MODEL_OUTPUT_SIZE,
                        mean=ds.MEAN, std=ds.STD, blur_p=0.0, grayscale_p=0.0)
    return model, make_sgd(model, DIST_LR, 0.9, 0.0005), make_device_post_fn(cfg, unshuffle_hi=SISR_UPSCALE)


def _distributed_validation(model, device, world, rank):
    """The port's collective validation (commands/train_or_resume.py::validate)
    of the model in eval mode over the first DIST_VAL_FRAMES val frames, 4 a
    rank (8 in one process)."""
    from dualsuperreslearningforsemseg_tpu_torch import settings
    from dualsuperreslearningforsemseg_tpu_torch.commands.train_or_resume import validate
    from dualsuperreslearningforsemseg_tpu_torch.data import (
        CityscapesDataset, make_eval_loader, make_eval_transform_fn)
    from dualsuperreslearningforsemseg_tpu_torch.train import make_eval_step
    ds = settings.DATASETS['cityscapes']['settings']
    w1, w2 = settings.DEFAULT_LOSS_WEIGHTS
    val = CityscapesDataset(os.path.join('datasets', 'Cityscapes', 'data'), split='val')
    val.pairs = val.pairs[:DIST_VAL_FRAMES]
    transform = make_eval_transform_fn(settings.MODEL_INPUT_SIZE, settings.MODEL_OUTPUT_SIZE,
                                       ds.MEAN, ds.STD, ds.LABEL_MAPPING_LUT)
    loader = make_eval_loader(val, 8 // world, 0, device, world, rank)
    losses, miou, accuracy = validate(model, make_eval_step(NUM_CLASSES, 255, 3, w1, w2), loader,
                                      transform, device, NUM_CLASSES)
    return {'CE': losses[0], 'MSE': losses[1], 'FA': losses[2], 'mIoU': miou, 'accuracy': accuracy,
            'batches': len(loader)}


def _leaf_gaps(got, ref):
    """max |got - ref| over max |ref| for each leaf (0/0 counts as 0)."""
    gaps = {}
    for k, r in ref.items():
        d = float((got[k].detach().float().cpu() - r.float()).abs().max())
        scale = float(r.float().abs().max())
        gaps[k] = d / scale if scale > 0 else (0.0 if d == 0 else float('inf'))
    return gaps


def _top(gaps, k=5):
    return dict(sorted(gaps.items(), key=lambda kv: -kv[1])[:k])


def _gap_over_largest(got, ref):
    """max |got - ref| over every leaf, over the largest |ref| of any leaf."""
    largest = max(float(r.float().abs().max()) for r in ref.values())
    return max(float((got[k].detach().float().cpu() - r.float()).abs().max())
               for k, r in ref.items()) / largest


def _distributed_rank(local_rank, work, port):
    """One of two gloo ranks on cuda:0 (phase 14 (a)): the collective
    validation, one train step on its half of the frames against the
    one-process reference, timed steps, the witness (one step from the
    same state on the whole global batch in both ranks: the 2-rank path's
    arithmetic with no split), then the 2-rank step's own floor (the step
    again with each rank's frames in DIST_RANK_REORDERS' orders); writes
    rank{r}.json."""
    import torch
    from dualsuperreslearningforsemseg_tpu_torch import parallel, settings
    from dualsuperreslearningforsemseg_tpu_torch.models import load_state_dict
    from dualsuperreslearningforsemseg_tpu_torch.models.norm import CrossRankBatchNorm2d
    from dualsuperreslearningforsemseg_tpu_torch.train import make_train_step
    from dualsuperreslearningforsemseg_tpu_torch.utils import select_device
    # Both ranks share the one card; no autotuning workspaces beside each other.
    device = select_device('cuda', cudnn_benchmark=False, local_rank=0)
    parallel.initialize_distributed(dict(MASTER_ADDR='127.0.0.1', MASTER_PORT=port, NODES=1,
                                         DEVICES_PER_NODE=2, BACKEND='gloo', INIT_METHOD=None,
                                         NODE_ID=0), local_rank, device)
    rank = parallel.rank()
    w1, w2 = settings.DEFAULT_LOSS_WEIGHTS
    state, frames = _distributed_inputs(work)
    model, optimizer, post = _distributed_parts(state, device)
    torch.cuda.reset_peak_memory_stats(device)
    fns = reset_counts()
    val = _distributed_validation(model, device, 2, rank)
    val_peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    torch.cuda.reset_peak_memory_stats(device)
    step = make_train_step(model, optimizer, 3, w1, w2, 255, False, post_fn=post)
    imgs, segs = (frames[k][4 * rank:4 * rank + 4].to(device) for k in ('imgs', 'segs'))
    gen = torch.Generator(device=device).manual_seed(5)
    losses = {k: float(v) for k, v in step(imgs, segs, DIST_LR, gen).items()}
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in fns.items()}
    ref = torch.load(os.path.join(work, 'reference.pt'))
    updates = {k: v.cpu() for k, v in sgd_updates(optimizer, model, DIST_LR).items()}
    buffers = {k: v for k, v in model.state_dict().items() if k.endswith(('running_mean', 'running_var'))}
    tracked = {k: int(v) for k, v in model.state_dict().items() if k.endswith('num_batches_tracked')}
    upd_gap, bn_gap = _leaf_gaps(updates, ref['updates']), _leaf_gaps(buffers, ref['buffers'])
    parallel.barrier()
    step_ms = cuda_ms(lambda: step(imgs, segs, DIST_LR, gen), iters=3, warmup=1)
    step_peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    load_state_dict(model, state, strict=True)
    optimizer.state.clear()
    step(frames['imgs'].to(device), frames['segs'].to(device), DIST_LR,
         torch.Generator(device=device).manual_seed(5))
    whole = {k: v.cpu() for k, v in sgd_updates(optimizer, model, DIST_LR).items()}
    own_floor, own_floor_global = {}, 0.0
    for order in DIST_RANK_REORDERS.values():
        load_state_dict(model, state, strict=True)
        optimizer.state.clear()
        order = torch.tensor(order, device=device)
        step(imgs[order], segs[order], DIST_LR, torch.Generator(device=device).manual_seed(5))
        reordered = {k: v.cpu() for k, v in sgd_updates(optimizer, model, DIST_LR).items()}
        for k, g in _leaf_gaps(reordered, updates).items():
            own_floor[k] = max(own_floor.get(k, 0.0), g)
        own_floor_global = max(own_floor_global, _gap_over_largest(reordered, updates))
    out = {'rank': rank, 'losses': losses, 'counts': counts, 'val': val,
           'cross_rank_bn_modules': sum(isinstance(m, CrossRankBatchNorm2d) for m in model.modules()),
           'update_gaps': upd_gap, 'update_gaps_top5': _top(upd_gap),
           'update_gap_over_largest_update': _gap_over_largest(updates, ref['updates']),
           'own_floor_gaps': own_floor, 'own_floor_gap_over_largest_update': own_floor_global,
           'witness_gaps': _leaf_gaps(whole, ref['updates']),
           'witness_gap_over_largest_update': _gap_over_largest(whole, ref['updates']),
           'split_vs_witness_gaps_top5': _top(_leaf_gaps(updates, whole)),
           'split_vs_witness_gap_over_largest_update': _gap_over_largest(updates, whole),
           'max_bn_gap': max(bn_gap.values()), 'worst_bn': max(bn_gap, key=bn_gap.get),
           'num_batches_tracked_equal': tracked == ref['tracked'],
           'update_digest': float(sum(u.double().sum() for u in updates.values())),
           'step_ms': step_ms, 'val_peak_gib': val_peak,
           'step_peak_gib': step_peak}
    with open(os.path.join(work, 'rank{}.json'.format(rank)), 'w') as f:
        json.dump(out, f)
    parallel.barrier()
    parallel.destroy_process_group()


def _ce_miss(model, imgs_w, segs_w, post):
    """What two faults would report as the CE of the step's first forward, beside the
    true global CE: the mean of the two halves' CE means, and the global CE
    with BatchNorm statistics per half.  Train mode, no gradient; the
    running statistics this moves are reloaded by the caller."""
    import torch
    from dualsuperreslearningforsemseg_tpu_torch.ops.fused_tail import fused_convt2_ce_sum
    tail = model.SSSR_decoder.upsample16_pred[6]
    gen = torch.Generator(device='cuda').manual_seed(5)
    (img_lo, _), (seg_hi, _) = post(imgs_w, segs_w, gen)
    x = img_lo.permute(0, 3, 1, 2).contiguous()
    model.train()

    def sums(sssr, labels):
        return fused_convt2_ce_sum(sssr.contiguous(), tail.weight, tail.bias, labels.contiguous())

    with torch.no_grad():
        whole = model(x, pre_tail=True)[0]
        halves = [sums(whole[h:h + 4], seg_hi[h:h + 4]) for h in (0, 4)]
        per_half_bn = [sums(model(x[h:h + 4], pre_tail=True)[0], seg_hi[h:h + 4]) for h in (0, 4)]
    total = sum(float(s) for s, _ in halves) / sum(float(c) for _, c in halves)
    mean_of_means = sum(float(s) / float(c) for s, c in halves) / 2
    per_rank_bn = sum(float(s) for s, _ in per_half_bn) / sum(float(c) for _, c in per_half_bn)
    return total, mean_of_means, per_rank_bn


def distributed_phase(device_name, smi, weights3):
    """Multi-process training (phase 14): (a) two gloo ranks on cuda:0 at
    full depth, stage 3, against one process at the global batch; (b)
    ``train --distributed`` at world 1 under nccl against ``train``; (c)
    the two step times."""
    import copy
    import numpy as np
    import torch
    from dualsuperreslearningforsemseg_tpu_torch import parallel, settings
    from dualsuperreslearningforsemseg_tpu_torch.checkpoint import load_checkpoint_or_weights
    from dualsuperreslearningforsemseg_tpu_torch.data import (
        AugmentConfig, CityscapesDataset, make_warp_transform)
    from dualsuperreslearningforsemseg_tpu_torch.models import load_state_dict
    from dualsuperreslearningforsemseg_tpu_torch.train import make_train_step
    t_phase = time.time()
    work = os.path.abspath('distributed')
    os.makedirs(work, exist_ok=True)
    ds = settings.DATASETS['cityscapes']['settings']
    w1, w2 = settings.DEFAULT_LOSS_WEIGHTS

    # The global batch: 8 warped train frames; the second half brighter by
    # 80 levels and with 75 % of its labels ignored.
    train_set = CityscapesDataset(os.path.join('datasets', 'Cityscapes', 'data'), split='train')
    imgs, segs = (torch.from_numpy(np.stack(a)).cuda() for a in zip(*(train_set[i] for i in range(8))))
    cfg = AugmentConfig(input_hw=settings.MODEL_INPUT_SIZE, output_hw=settings.MODEL_OUTPUT_SIZE,
                        mean=ds.MEAN, std=ds.STD)
    imgs, segs = make_warp_transform(cfg, ds.LABEL_MAPPING_LUT, settings.RANDOM_SEED)(1, 0, imgs, segs)
    imgs[4:] = (imgs[4:].int() + 80).clamp(max=255).to(torch.uint8)
    gen = torch.Generator(device='cuda').manual_seed(11)
    drop = torch.rand(segs[4:].shape, generator=gen, device='cuda') < 0.75
    segs[4:] = torch.where(drop, torch.full_like(segs[4:], 255), segs[4:])
    state = {k: torch.as_tensor(v) for k, v in
             load_checkpoint_or_weights(weights3)['model_state_dict'].items()}
    # Logits far from uniform: near ln 19 at every pixel, no weighting of the
    # pixels (the fault of a mean of per-rank means) would show.
    for k in ('SSSR_decoder.upsample16_pred.6.weight', 'SSSR_decoder.upsample16_pred.6.bias'):
        state[k] = state[k] * DIST_TAIL_SCALE
    torch.save(state, os.path.join(work, 'state.pt'))
    torch.save({'imgs': imgs.cpu(), 'segs': segs.cpu()}, os.path.join(work, 'frames.pt'))

    # One process at batch 8: the validation, the misses, the step, its time.
    # cuDNN picks its algorithms as in the ranks (no autotuning): another
    # algorithm would round the same sums in another order.
    torch.backends.cudnn.benchmark = False
    model, optimizer, post = _distributed_parts(state, torch.device('cuda'))
    val_1 = _distributed_validation(model, torch.device('cuda'), 1, 0)
    total, mean_of_means, per_rank_bn = _ce_miss(model, imgs, segs, post)
    load_state_dict(model, state, strict=True)
    step = make_train_step(model, optimizer, 3, w1, w2, 255, False, post_fn=post)
    step_gen = torch.Generator(device='cuda').manual_seed(5)
    loss_1 = {k: float(v) for k, v in step(imgs, segs, DIST_LR, step_gen).items()}
    torch.cuda.synchronize()
    sd = model.state_dict()
    updates_1 = {k: v.cpu() for k, v in sgd_updates(optimizer, model, DIST_LR).items()}
    torch.save({'updates': updates_1,
                'buffers': {k: v.cpu() for k, v in sd.items()
                            if k.endswith(('running_mean', 'running_var'))},
                'tracked': {k: int(v) for k, v in sd.items() if k.endswith('num_batches_tracked')}},
               os.path.join(work, 'reference.pt'))
    one_ms = cuda_ms(lambda: step(imgs, segs, DIST_LR, step_gen), iters=3, warmup=1)
    # The noise floor of the one-process step in float32: the same step on
    # the same frames in DIST_REORDERS' orders; each leaf's floor is its
    # largest gap to the step above over the orders, and so is the floor
    # of the gap over the largest update.
    floor_gap, floor_global, order_gaps = {}, {}, {}
    for order_name, order in DIST_REORDERS.items():
        load_state_dict(model, state, strict=True)
        optimizer.state.clear()
        order = torch.tensor(order, device='cuda')
        step(imgs[order], segs[order], DIST_LR, torch.Generator(device='cuda').manual_seed(5))
        reordered = {k: v.cpu() for k, v in sgd_updates(optimizer, model, DIST_LR).items()}
        order_gaps[order_name] = _leaf_gaps(reordered, updates_1)
        for k, g in order_gaps[order_name].items():
            floor_gap[k] = max(floor_gap.get(k, 0.0), g)
        floor_global[order_name] = _gap_over_largest(reordered, updates_1)
    floor = {'max_update_gap': max(floor_gap.values()), 'update_gaps_top5': _top(floor_gap),
             'update_gap_over_largest_update': max(floor_global.values()),
             'gap_over_largest_update_by_order': floor_global}
    del model, optimizer, step, sd, updates_1
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = True

    # (a) Two ranks.
    t0 = time.time()
    parallel.spawn_ranks(_distributed_rank, 2, (work, free_port()))
    ranks = []
    for r in range(2):
        with open(os.path.join(work, 'rank{}.json'.format(r))) as f:
            ranks.append(json.load(f))
    rel = {k: abs(ranks[0]['losses'][k] - loss_1[k]) / max(abs(loss_1[k]), 1e-30) for k in loss_1}
    misses = {'mean_of_rank_CE_means': abs(mean_of_means - total) / total,
              'per_rank_batchnorm': abs(per_rank_bn - total) / total}
    want = {'fused_tail_forward': 1, 'fused_tail_backward': 1, 'augment_post': 1,
            'fa_pairwise_forward': 1 + ranks[0]['val']['batches'], 'fa_pairwise_backward': 1,
            'eval_tail': ranks[0]['val']['batches']}
    out = {'loss_rel_gaps': rel, 'misses_of_the_faults_rel': misses, 'global_CE': total,
           'one_process_losses': loss_1, 'one_process_val': val_1, 'one_process_step_ms': one_ms,
           'one_process_reorders_floor': floor, 'ranks': ranks, 'seconds': time.time() - t0}
    # Two float32 computations of one step differ by their rounding: each
    # leaf's SGD update is held within 1e-3 of the leaf's largest, or
    # within twice the sum of the two steps' own floors for that leaf where
    # that is larger (a BatchNorm's bias gradient sums terms that nearly
    # cancel); the largest gap of any leaf, and the witness's, within twice
    # the sum of the floors', over the largest update of any leaf.  A
    # reorder does not move a fault of the step, so a fault does not
    # raise its own limit.
    with open(os.path.join(work, 'leaf_gaps.json'), 'w') as f:
        json.dump({'one_process_orders': order_gaps,
                   'ranks': [{k: r[k] for k in ('update_gaps', 'own_floor_gaps', 'witness_gaps')}
                             for r in ranks]}, f)
    for r in ranks:
        own = r.pop('own_floor_gaps')
        r['witness_gaps_top5'] = _top(r.pop('witness_gaps'))
        excess = {k: g / max(1e-3, 2 * (floor_gap[k] + own[k]))
                  for k, g in r.pop('update_gaps').items()}
        r['own_floor_top5'] = _top(own)
        r['update_gap_over_limit_top5'] = _top(excess)
        r['max_update_gap_over_limit'] = max(excess.values())
        r['global_update_limit'] = 2 * (floor['update_gap_over_largest_update']
                                        + r['own_floor_gap_over_largest_update'])
    print("2 gloo ranks on cuda:0 ({}), full depth, stage 3, batch 4 a rank vs one process at "
          "batch 8: {}".format(device_name, json.dumps(out)), flush=True)
    for r in ranks:
        if r['counts'] != want:
            fail("rank {} launched {} (want {})".format(r['rank'], r['counts'], want))
        if not (r['max_update_gap_over_limit'] <= 1
                and r['update_gap_over_largest_update'] <= r['global_update_limit']
                and r['witness_gap_over_largest_update'] <= r['global_update_limit']
                and r['max_bn_gap'] <= 1e-3
                and r['num_batches_tracked_equal']
                and r['cross_rank_bn_modules'] > 0 and r['losses'] == ranks[0]['losses']):
            fail("rank {} differs from the one-process step: {}".format(r['rank'], r))
        for key in ('mIoU', 'accuracy'):
            if '{:.2f}'.format(r['val'][key]) != '{:.2f}'.format(val_1[key]):
                fail("rank {}'s validation {} {} vs one process's {}".format(
                    r['rank'], key, r['val'][key], val_1[key]))
        if abs(r['val']['CE'] - val_1['CE']) > 1e-3:
            fail("rank {}'s validation CE {} vs one process's {}".format(r['rank'], r['val']['CE'],
                                                                         val_1['CE']))
    if max(rel.values()) > 1e-4 or ranks[0]['update_digest'] != ranks[1]['update_digest']:
        fail("the 2-rank step's losses or updates: {} {}".format(rel, [r['update_digest'] for r in ranks]))
    if min(misses.values()) <= 1e-4:
        fail("these inputs do not show the faults: {}".format(misses))

    # (b) train --distributed at world 1 under nccl against train.
    finals, seconds, written = {}, {}, {}
    for name, extra in (('smoke_plain1', []),
                        ('smoke_nccl1', ['--distributed', '127.0.0.1', str(free_port()), '1', '1',
                                         'nccl', ' ', '0'])):
        t0 = time.time()
        proc = subprocess.run([sys.executable, '-m', 'dualsuperreslearningforsemseg_tpu_torch', 'train',
                               '--stage', '1', '--epochs', '1', '--batch-size', '8', '--dataset',
                               'cityscapes', '--disable-cudnn-benchmark', '--experiment-id', name]
                              + extra, env=dict(os.environ, PYTHONPATH=HERE), capture_output=True,
                              text=True, timeout=600)
        seconds[name] = time.time() - t0
        if proc.returncode != 0:
            fail("train {}: exit {}\n{}".format(name, proc.returncode, proc.stderr[-4000:]))
        exp = os.path.join('experiments', name)
        files = sorted(os.path.relpath(os.path.join(d, f), exp) for d, _, fs in os.walk(exp) for f in fs)
        names = [os.path.basename(f) for f in files]
        if [names.count(n) for n in ('final.weights', 'params.txt', 'stdout.txt')] != [1, 1, 1] \
                or len(files) != len(written.get('smoke_plain1', files)):
            fail("train {} wrote {}".format(name, files))
        written[name] = files
        finals[name] = load_checkpoint_or_weights(os.path.join(exp, 'weights', 'stage1',
                                                               'final.weights'))['model_state_dict']
    differ = _same_arrays(finals['smoke_plain1'], finals['smoke_nccl1'])
    print("train --stage 1 at world 1 under nccl vs without --distributed ({}): {} tensors, {} differ; "
          "seconds {}".format(device_name, len(finals['smoke_nccl1']), len(differ), json.dumps(seconds)),
          flush=True)
    if differ:
        fail("world-1 nccl final.weights differ from the single-process run's: {}".format(differ[:5]))

    # (c) The step times (both ranks share the one card: not a scaling number).
    print("phase 14 step times on {} ({}): one process at batch 8 {:.2f} ms, 2 gloo ranks at "
          "batch 4 each {:.2f} / {:.2f} ms; peak device memory per rank, validation {:.2f} / "
          "{:.2f} GiB, train step {:.2f} / {:.2f} GiB; phase {:.1f} s".format(
              device_name, smi, one_ms, ranks[0]['step_ms'], ranks[1]['step_ms'],
              ranks[0]['val_peak_gib'], ranks[1]['val_peak_gib'], ranks[0]['step_peak_gib'],
              ranks[1]['step_peak_gib'], time.time() - t_phase), flush=True)


INPUT_TRAIN = ['train', '--stage', '1', '--epochs', '2', '--batch-size', '8', '--dataset',
               'cityscapes', '--val-interval', '1', '--disable-cudnn-benchmark']
INPUT_FAULTS = ('Native data plane unavailable', 'native batch decode failed')


def _input_train_child(out_path, *argv):
    """One ``train`` of phase 15 in a fresh process: the CLI's ``main`` with
    every launch count at 0, then the summary, the counts and the native
    decode's state of this process into ``out_path``."""
    sys.path.insert(0, HERE)
    from dualsuperreslearningforsemseg_tpu_torch.__main__ import main as cli_main
    from dualsuperreslearningforsemseg_tpu_torch.data import native
    fns = reset_counts()
    summary = cli_main(list(argv))
    out = {'summary': summary, 'counts': {name: fn.launches for name, fn in fns.items()},
           'native': native.native_available(), 'native_calls': native.decode_pair_batch.calls}
    with open(out_path, 'w') as f:
        json.dump(out, f, default=float)


def _ms_per_pair(fn, pairs, repeats=2):
    """The best of ``repeats`` runs of ``fn()`` over ``pairs`` pairs, in ms a pair."""
    best = float('inf')
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best / pairs


def input_phase(device_name, smi):
    """The host input side on the card's machine (phase 15): whether g++
    and libpng are there, and then the native decode's build; PIL, native
    (where it builds) and raw-cache read times a pair at 1024x2048; and
    ``train --stage 1 --epochs 2`` without and with the raw pair cache
    (primed), whose ``final.weights`` must be bitwise equal."""
    import numpy as np
    from dualsuperreslearningforsemseg_tpu_torch import settings
    from dualsuperreslearningforsemseg_tpu_torch.checkpoint import load_checkpoint_or_weights
    from dualsuperreslearningforsemseg_tpu_torch.data import (
        CityscapesDataset, RawPairCache, make_synthetic_cityscapes_tree, native)
    t_phase = time.time()
    work = os.path.join(HERE, 'build', 'chip_smoke', 'input')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    os.chdir(work)
    # The native decode builds against libpng: where this machine lacks its
    # header or library, the loaders decode with PIL (one CAUTION a
    # process), and the phase times PIL against the raw-cache read.
    cxx = shutil.which('g++')
    has_libpng = False
    if cxx:
        with open('png_probe.cpp', 'w') as f:
            f.write('#include <png.h>\nint main() { return png_access_version_number() ? 0 : 1; }\n')
        probe = subprocess.run([cxx, 'png_probe.cpp', '-o', 'png_probe', '-lpng', '-lz'],
                               capture_output=True, text=True, timeout=120)
        has_libpng = probe.returncode == 0
        version = subprocess.run([cxx, '--version'], capture_output=True, text=True,
                                 timeout=60).stdout.splitlines()[0]
        print("g++: {} | libpng (png.h, -lpng -lz): {}".format(version, 'found' if has_libpng else next(
            (line for line in probe.stderr.splitlines() if 'error' in line), probe.stderr[-300:])),
              flush=True)
    if has_libpng:
        t0 = time.time()
        lib = native.get_lib()
        if lib is None:
            fail("the native decode library did not build or load (its CAUTION above says why)")
        print("native decode library {} (dp_version {}) ready in {:.1f} s, built with {}".format(
            os.path.relpath(lib._name, HERE), lib.dp_version(), time.time() - t0,
            ' '.join(native.CXXFLAGS + native.LDFLAGS + native.library_path()[1])), flush=True)
    else:
        print("no g++ or libpng here: the native decode is not on this machine's path, the loaders "
              "decode with PIL; timing PIL against the raw-cache read", flush=True)

    t0 = time.time()
    data_root = os.path.join('datasets', 'Cityscapes', 'data')
    make_synthetic_cityscapes_tree(data_root, split='train', num_images=32, size_hw=(1024, 2048),
                                   seed=15, noise=1)
    make_synthetic_cityscapes_tree(data_root, split='val', num_images=16, size_hw=(1024, 2048),
                                   seed=16, noise=1)
    train = CityscapesDataset(data_root, split='train')
    png_mb = np.mean([os.path.getsize(p) for pair in train.pairs for p in pair[:1]]) / 2 ** 20
    print("set-up: 32 train + 16 val synthetic 1024x2048 frames (noise=1, {:.2f} MiB a frame "
          "PNG) in {:.1f} s".format(png_mb, time.time() - t0), flush=True)

    # Decode times a pair, on the 8 pairs of one batch (their PNGs in the
    # page cache after the first repeat).
    cpus = os.cpu_count()
    share = max(1, cpus // settings.DEFAULT_NUM_WORKERS)
    pairs = train.pairs[:8]
    img_paths, seg_paths = [p[0] for p in pairs], [p[1] for p in pairs]
    pil = [train[i] for i in range(8)]
    imgs, segs = np.stack([p[0] for p in pil]), np.stack([p[1] for p in pil])
    times = {'pil_one_process': _ms_per_pair(lambda: [train[i] for i in range(8)], 8)}
    if has_libpng:
        got = native.decode_pair_batch(img_paths, seg_paths, (1024, 2048), threads=share)
        if not (np.array_equal(got[0], imgs) and np.array_equal(got[1], segs)):
            fail("the native decode differs from PIL's")
        for threads in sorted({share, cpus}):
            times['native_batch8_threads{}'.format(threads)] = _ms_per_pair(
                lambda: native.decode_pair_batch(img_paths, seg_paths, (1024, 2048),
                                                 threads=threads), 8)
    cache = RawPairCache(os.path.join(work, 'timing_cache'), (1024, 2048))
    for k, (img_path, seg_path) in enumerate(pairs):
        cache.store(img_path, seg_path, imgs[k], segs[k])
    times['raw_cache_read'] = _ms_per_pair(lambda: [cache.load(*pair) for pair in pairs], 8)
    shutil.rmtree(cache.dir)
    print("decode ms a pair at 1024x2048 on {} ({}), os.cpu_count() {}, the default {} loader "
          "workers' share {} thread(s): {}".format(device_name, smi, cpus,
                                                  settings.DEFAULT_NUM_WORKERS, share,
                                                  json.dumps(times)), flush=True)

    # (a) without the cache, (b) with it on an empty directory, primed: each
    # a fresh process with cuDNN's autotuner off, so both train alike.
    steps, val_batches = 2 * 32 // 8, 2 * 16 // 8
    want = {'fused_tail_forward': steps, 'fused_tail_backward': steps, 'augment_post': steps,
            'eval_tail': val_batches, 'fa_pairwise_forward': 0, 'fa_pairwise_backward': 0}
    cache_dir = os.path.join(work, 'raw_cache')
    runs = {}
    for name, env in (('input_plain', {}), ('input_cached', {'DSRL_TPU_RAW_CACHE': cache_dir})):
        out_path = os.path.join(work, name + '.json')
        env = dict({k: v for k, v in os.environ.items() if not k.startswith('DSRL_TPU_')},
                   PYTHONPATH=HERE, **env)
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, '-c', 'import sys, chip_smoke; chip_smoke._input_train_child(*sys.argv[1:])',
             out_path] + INPUT_TRAIN + ['--experiment-id', name],
            env=env, capture_output=True, text=True, timeout=600)
        wall = time.time() - t0
        with open(os.path.join(work, name + '.log'), 'w') as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            fail("train {}: exit {}\n{}".format(name, proc.returncode, proc.stderr[-4000:]))
        faults = [line for line in (proc.stdout + proc.stderr).splitlines()
                  if any(fault in line for fault in INPUT_FAULTS[0 if has_libpng else 1:])]
        with open(out_path) as f:
            run = json.load(f)
        summary = run['summary']
        epochs = [{'epoch': e['epoch'], 'seconds': e['seconds'],
                   'input_wait_first_step_s': e['input_waits'][0],
                   'input_wait_later_steps_mean_s': float(np.mean(e['input_waits'][1:])),
                   'input_wait_per_step_mean_s': float(np.mean(e['input_waits']))}
                  for e in summary['epochs']]
        runs[name] = run
        print("train {} on {} ({}): {:.2f} s in the process, {:.2f} s with its start-up; native "
              "decode {}, {} native calls in the main process; primed before step 1: {}; epochs "
              "{}; launches {}".format(
                  name, device_name, smi, summary['seconds'], wall, run['native'],
                  run['native_calls'], summary.get('primed_before_first_step'),
                  json.dumps(epochs), json.dumps(run['counts'])), flush=True)
        if faults or run['native'] != has_libpng:
            fail("train {}: native decode {} where libpng is {}: {}".format(
                name, run['native'], 'found' if has_libpng else 'missing', faults))
        if run['counts'] != want or summary['steps'] != steps:
            fail("train {} launched {} in {} steps (want {})".format(name, run['counts'],
                                                                     summary['steps'], want))
        primed = name == 'input_cached'
        if ("Priming raw pair cache for the 'train' split" in proc.stdout) != primed:
            fail("train {}: the priming INFO line is {}".format(
                name, 'missing' if primed else 'printed'))
    entries = sorted(os.listdir(cache_dir))
    if len(entries) != 48 or not all(e.endswith('.raw') for e in entries) \
            or (runs['input_cached']['native_calls'] > 0) != has_libpng:
        fail("the raw cache holds {} files (want 48 entries), {} native calls in the primed "
             "run".format(len(entries), runs['input_cached']['native_calls']))
    finals = {name: load_checkpoint_or_weights(run['summary']['final_weights'])['model_state_dict']
              for name, run in runs.items()}
    differ = _same_arrays(finals['input_plain'], finals['input_cached'])
    print("train with the raw cache vs without ({}): {} tensors, {} differ; the cache holds {} "
          "entries, {:.1f} MiB; phase {:.1f} s".format(
              device_name, len(finals['input_plain']), len(differ), len(entries),
              sum(os.path.getsize(os.path.join(cache_dir, e)) for e in entries) / 2 ** 20,
              time.time() - t_phase), flush=True)
    if differ:
        fail("final.weights with the raw cache differ from those without: {}".format(differ[:5]))


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def ptxas_report(log):
    """{mangled kernel name: 'N registers, B bytes smem, S bytes spill
    stores/loads'} from an ``-Xptxas -v`` log."""
    import re
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            report.setdefault(name, {})['spills'] = '{}/{} bytes spill stores/loads'.format(*m.groups())
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            report.setdefault(name, {})['used'] = '{} registers, {} bytes static smem'.format(
                m.group(1), m.group(2) or 0)
    return {k: ', '.join(v[f] for f in ('used', 'spills') if f in v) for k, v in report.items()}


def demangle(names):
    tool = shutil.which('c++filt')
    if not tool or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input='\n'.join(names), capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}


def sass_counts(libs):
    """Counts of tensor-core (``HMMA``: mma.sync; ``HGMMA``: wgmma) and
    asynchronous-copy (``LDGSTS``) instructions in each kernel function's
    SASS (cuobjdump prints them function by function), with the function's
    ``-Xptxas -v`` registers, shared memory and spills beside them (and
    the K1 backward kernels' dynamic shared memory).  Fails
    if the K1 forward kernel has no tensor-core instruction, a K1
    backward kernel (float32 and bfloat16 x) no ``HGMMA``, or a K3 kernel
    no ``HGMMA`` or any ``HMMA`` (its logits are one ``wgmma`` chain)."""
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    tool = os.path.join(cuda_home, 'bin', 'cuobjdump')
    tool = tool if os.path.isfile(tool) else shutil.which('cuobjdump')
    if not tool:
        print("cuobjdump not found: no SASS counts", flush=True)
        return
    for lib, path in sorted(libs.items()):
        with open(path + '.log') as f:
            ptxas = ptxas_report(f.read())
        sass = subprocess.run([tool, '-sass', path], capture_output=True, text=True, timeout=120).stdout
        functions = {}
        name = None
        for line in sass.splitlines():
            if 'Function : ' in line:
                name = line.split('Function : ', 1)[1].strip()
                functions[name] = {'HMMA': 0, 'HGMMA': 0, 'LDGSTS': 0}
            elif name:
                for op in ('HGMMA', 'HMMA', 'LDGSTS'):
                    if op + '.' in line or op + ' ' in line:
                        functions[name][op] += 1
                        break
        readable = demangle(sorted(functions))
        for fn, n in sorted(functions.items()):
            print("SASS of {} {}: {} HMMA, {} HGMMA, {} LDGSTS; ptxas: {}".format(
                lib, readable[fn], n['HMMA'], n['HGMMA'], n['LDGSTS'], ptxas.get(fn, 'not reported')),
                flush=True)
        if lib == 'fused_tail':
            fwd = [n for fn, n in functions.items() if 'fused_tail_fwd_kernel' in fn]
            if not fwd or not all(n['HMMA'] + n['HGMMA'] for n in fwd):
                fail("the K1 forward kernel has no tensor-core instruction: {}".format(fwd))
            bwd = {fn: n for fn, n in functions.items() if 'fused_tail_bwd_kernel' in fn}
            smem = ctypes.CDLL(path).dsrl_fused_tail_bwd_smem
            for fn, n in sorted(bwd.items()):
                print("K1 backward {}: {} HGMMA (wgmma: logits, dX, dW^T rows 0-63), {} HMMA (mma.sync: "
                      "rows 64-79); ptxas: {}; {} bytes of dynamic shared memory a block".format(
                          readable[fn], n['HGMMA'], n['HMMA'], ptxas.get(fn, 'not reported'),
                          smem(1 if 'bfloat16' in fn else 0)), flush=True)
            if len(bwd) != 2 or not all(n['HGMMA'] for n in bwd.values()):
                fail("the K1 backward kernel has no HGMMA (wgmma) instruction: {}".format(bwd))
        if lib == 'eval_tail':
            k3 = {fn: n for fn, n in functions.items() if 'eval_tail_kernel' in fn}
            for fn, n in sorted(k3.items()):
                print("K3 {}: {} HGMMA (wgmma: logits), {} HMMA; ptxas: {}".format(
                    readable[fn], n['HGMMA'], n['HMMA'], ptxas.get(fn, 'not reported')), flush=True)
            if len(k3) != 2 or not all(n['HGMMA'] and not n['HMMA'] for n in k3.values()):
                fail("a K3 kernel has no HGMMA (wgmma) instruction or still an HMMA (mma.sync): {}"
                     .format(k3))


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    if not os.path.isdir(os.path.join(HERE, 'dualsuperreslearningforsemseg_tpu_torch')):
        fail("the port package is not beside this script")
    # Full size: no test-size overrides (settings reads them at import).
    for var in ('DSRL_TPU_MODEL_INPUT_SIZE', 'DSRL_TPU_BACKBONE_LAYERS'):
        os.environ.pop(var, None)
    sys.path.insert(0, HERE)
    from dualsuperreslearningforsemseg_tpu_torch.ops._build import build_all
    from dualsuperreslearningforsemseg_tpu_torch.utils import select_device
    select_device('cuda')   # TF32 off for the plain versions too
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print("device: {} | nvidia-smi: {} | torch {} CUDA {}".format(
        name, smi, torch.__version__, torch.version.cuda), flush=True)

    t0 = time.time()
    libs = build_all()
    print("built {} in {:.1f} s".format(sorted(libs), time.time() - t0), flush=True)
    for path in libs.values():
        with open(path + '.log') as f:
            print(f.read().strip(), flush=True)
    sass_counts(libs)

    k3 = kernel_phase()
    k1 = k1_phase()
    k2 = k2_phase()
    k4 = k4_phase()
    main_path_phase(name)
    _, weights1 = train_phase(name)
    train_step_phase(name, weights1, 1)
    resize_times(name)
    determinism_phase(name, weights1, 1)
    counts, weights3 = cascade_phase(name)
    kernels = [k3] + k1 + [k2] + k4
    for rec in kernels:
        rec['launches'] = counts[rec['name']]
    train_step_phase(name, weights3, 3)
    determinism_phase(name, weights3, 3)
    state_phase(name, counts)
    commands_phase(name)
    distributed_phase(name, smi, weights3)
    input_phase(name, smi)
    print(smi, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                             'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
