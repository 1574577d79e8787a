#!/usr/bin/env python3
"""Where the time of the tail kernels K3, K1 forward and K1 backward goes,
on one GPU; and K4 against the parent's K4.

    python3 tail_variants.py [--parent DIR]
    python3 tail_variants.py --k4 [--parent DIR]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Builds variants of ``csrc/eval_tail.cu`` (K3) and ``csrc/fused_tail.cu``
(K1, forward and backward) from edited copies of the sources under
``build/variants/``, each with one part removed or changed, and times each
with CUDA events at the main path's shapes, x (16, 19, 256, 512) for K3 and
(8, 19, 256, 512) for K1, float32 and bfloat16: a call from the host, and
the same launches replayed from a CUDA graph (device time).  A variant's
results are wrong by construction: only its time means something, next to
the unchanged build's from the same run; each variant is built only for
the kernels whose sources it edits (both for an edit of the shared
header).  ``--parent DIR`` also builds the ``eval_tail.cu`` and
``fused_tail.cu`` of another checkout (e.g. the parent commit unpacked
with ``git archive``) and times its K3 and its K1 forward and backward in
turns with this checkout's unchanged build, parent, this, this, parent
(the first two before all the variants, the last two after them), so the
two are compared on one card in one run.  Prints each build's ``-Xptxas -v``
summary, one line per timing, then the card's name and power limit and a
JSON object of all the timings.

``--k4`` times K4 (``csrc/fa_pairwise.cu``) instead: ``chip_smoke.py``'s
K4 phase (correctness at every shape, then a wrapper call and a CUDA-graph
replay of forward and backward at (8, 256) and (304, 1024)) of this
checkout and of ``--parent`` in turns, parent, this, this, parent, each in
a process of its own that builds its own kernel; then the host time of
each part of the forward wrapper, and variants of ``fa_pairwise.cu``
(``K4_VARIANTS``, edited copies under ``build/variants/k4/``) forward and
backward replayed from CUDA graphs, the source as built at each cluster
size 1, 2, 4 and 8, each checked against the plain version.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

ATOMICS = ('  if (valid) atomicAdd(&hist[cls], 1);\n  if (hit) atomicAdd(&hist[kC + cls], 1);\n'
           '  if (active && lab < kC) atomicAdd(&hist[2 * kC + lab], 1);\n')
CLASS_MAP_STORE = ('  if (!(t & 1) && active)\n'
                   '    *reinterpret_cast<uchar2*>(w.pred + warp_out(w.s_x)[buf * kWarpP + p] + (t >> 1) * 2LL * '
                   'w.width) =\n        make_uchar2((uint8_t)cls, (uint8_t)right);\n')
EVAL_SHAPE = 'static constexpr int kWG = sizeof(T) == 4 ? 4 : 6;'
BWD_DX = '  issue_dx_wgmma<T>(dxa, acc, lo, pk, w.desc_wt);\n'
BWD_DW = '  issue_dw_wgmma<T>(dw[0], w.desc_stage, w.desc_slab, w.desc_lo, buf);\n'
BWD_DW_TAIL = '  tail_rows_dw<T>(dw[1], w.stage, slab, w.s_xlo, w.w4, w.lane);\n'
BWD_DX_3XTF32 = ('      wgmma_n24_tf32(dxa, lo_a, hi_b, nt > 0);\n      wgmma_n24_tf32(dxa, hi_a, lo_b, 1);\n'
                 '      wgmma_n24_tf32(dxa, hi_a, hi_b, 1);\n')
BWD_DW_3XTF32 = ('      wgmma_n24_ss<T>(dw, a_lo, b_hi);\n      wgmma_n24_ss<T>(dw, a_hi, b_lo);\n'
                 '      wgmma_n24_ss<T>(dw, a_hi, b_hi);\n')
BWD_SHAPE = 'static constexpr int kWG = sizeof(T) == 4 ? 3 : 4;'
CE_NLL = 'const float nll = dsrl_tail::ce_nll(m, dsrl_tail::exp_sum(l, m), picked);'   # K3 and K1 forward
WG_3XTF32 = ('      wgmma_tf32(d, a.lo[s], hi, s > 0);\n      wgmma_tf32(d, a.hi[s], lo, 1);\n'
             '      wgmma_tf32(d, a.hi[s], hi, 1);\n')
FWD_SHAPE = 'static constexpr int kWG = sizeof(T) == 4 ? 5 : 6;'
# name -> {source file: [(text, replacement), ...]}
VARIANTS = {
    'as_built': {},
    'one_tf32_pass': {'tail_common.cuh': [
        ('  mma_tf32(d, a_lo, b_hi);\n  mma_tf32(d, a_hi, b_lo);\n  mma_tf32(d, a_hi, b_hi);',
         '  mma_tf32(d, a_hi, b_hi);'),
        (WG_3XTF32, '      wgmma_tf32(d, a.hi[s], hi, s > 0);\n')],
        'fused_tail.cu': [(BWD_DX_3XTF32, '      wgmma_n24_tf32(dxa, hi_a, hi_b, nt > 0);\n'),
                          (BWD_DW_3XTF32, '      wgmma_n24_ss<T>(dw, a_hi, b_hi);\n')]},
    'no_logits_mma': {'tail_common.cuh': [
        (WG_3XTF32, '      d[s][0] += __uint_as_float(a.hi[s][0] ^ a.lo[s][0]);\n'),
        ('      wgmma_bf16(d, a.hi[s], hi, s > 0);', '      d[s][0] += __uint_as_float(a.hi[s][0]);')]},
    'no_exp': {
        'eval_tail.cu': [(CE_NLL, 'const float nll = m - picked;')],
        'fused_tail.cu': [('const float inv_z = 1.f / dsrl_tail::exp_sum(l, dsrl_tail::row_max(l));',
                           'const float inv_z = 1.f / (1.f + l[3]);'),
                          (CE_NLL, 'const float nll = m - picked;')]},
    # K3 only: without its three histogram atomics, without its class-map
    # stores, one warpgroup a block fewer or more (float32 x / bfloat16 x).
    'no_histograms': {'eval_tail.cu': [(ATOMICS, '')]},
    'no_class_map_stores': {'eval_tail.cu': [(CLASS_MAP_STORE, '')]},
    'eval_warpgroups_3_5': {'eval_tail.cu': [(EVAL_SHAPE, EVAL_SHAPE.replace('4 : 6', '3 : 5'))]},
    'eval_warpgroups_5_7': {'eval_tail.cu': [(EVAL_SHAPE, EVAL_SHAPE.replace('4 : 6', '5 : 7'))]},
    'no_async_loads': {'tail_common.cuh': [
        ('      cp_async16(dst, src);\n', '      dst[0] = from_float<T>(0.f);\n'),
        ('    cp_async16(slab + Layout::off(ci, c * V), part + ci * (long long)hw + c * V);\n',
         '    slab[Layout::off(ci, c * V)] = from_float<T>(0.f);\n')]},
    # K1 backward: without its dX product (dX's stores stay), without dW^T's
    # wgmma product (rows 0-63) or without its mma.sync rows 64-79.
    'no_dx': {'fused_tail.cu': [(BWD_DX, '')]},
    'no_dw': {'fused_tail.cu': [(BWD_DW, '')]},
    'no_dw_rows_64_79': {'fused_tail.cu': [(BWD_DW_TAIL, '')]},
    # K1 forward only: one warpgroup a block fewer or more (float32 x / bfloat16 x).
    'fwd_warpgroups_4_5': {'fused_tail.cu': [(FWD_SHAPE, FWD_SHAPE.replace('5 : 6', '4 : 5'))]},
    'fwd_warpgroups_6_7': {'fused_tail.cu': [(FWD_SHAPE, FWD_SHAPE.replace('5 : 6', '6 : 7'))]},
    # K1 backward only: 2 or 3 warpgroups a block for both dtypes (float32
    # x has not the shared memory for 4).
    'bwd_warpgroups_2': {'fused_tail.cu': [(BWD_SHAPE, BWD_SHAPE.replace('sizeof(T) == 4 ? 3 : 4', '2'))]},
    'bwd_warpgroups_3': {'fused_tail.cu': [(BWD_SHAPE, BWD_SHAPE.replace('sizeof(T) == 4 ? 3 : 4', '3'))]},
}
FWD_ONLY = tuple(name for name in VARIANTS if name.startswith('fwd_'))
KERNELS = ('eval_tail', 'fused_tail')


def kernels_of(name):
    """The kernels a variant changes: those whose source it edits, both
    for an edit of the shared header (or none, as built)."""
    edited = VARIANTS[name]
    if not edited or 'tail_common.cuh' in edited:
        return KERNELS
    return tuple(k for k in KERNELS if k + '.cu' in edited)


def edited_sources(csrc, out):
    """Writes each variant's copy of csrc under out/<variant>/; returns
    {variant: directory}.  Fails if an edit's text is not in the source."""
    shutil.rmtree(out, ignore_errors=True)
    dirs = {}
    for name, edits in VARIANTS.items():
        d = os.path.join(out, name)
        shutil.copytree(csrc, d)
        for fname, pairs in edits.items():
            path = os.path.join(d, fname)
            with open(path) as f:
                text = f.read()
            for old, new in pairs:
                if old not in text:
                    raise SystemExit("variant {}: {} has no {!r}".format(name, fname, old[:60]))
                text = text.replace(old, new)
            with open(path, 'w') as f:
                f.write(text)
        dirs[name] = d
    return dirs


def start_build(src_dir, kern, so):
    from dualsuperreslearningforsemseg_tpu_torch.ops import _build
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, '-Xptxas', '-v', '-o', so,
           os.path.join(src_dir, kern + '.cu')]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


K4_PHASE = ("import sys; sys.path.insert(0, '.'); import chip_smoke; "
            "from dualsuperreslearningforsemseg_tpu_torch.ops._build import build_all; "
            "from dualsuperreslearningforsemseg_tpu_torch.utils import select_device; "
            "select_device('cuda'); build_all(('fa_pairwise',)); chip_smoke.k4_phase()")
K4_LINE = re.compile(r"K4 at \((\d+), (\d+)\): forward ([\d.]+) ms \(replayed from a CUDA graph "
                     r"([\d.]+) ms.*backward ([\d.]+) ms \(graph ([\d.]+) ms")


K4_SIGN = ('__device__ __forceinline__ float sign_of(float x, float y) {\n'
           '  return (float)(x > y) - (float)(x < y);')
# K4 variants of csrc/fa_pairwise.cu: {name: [(text, replacement), ...]}.
K4_VARIANTS = {
    'as_built': [],
    'runs_of_64': [('constexpr int kRunQuads = 8;', 'constexpr int kRunQuads = 16;')],
    'e_2': [('constexpr int kE = 4;', 'constexpr int kE = 2;')],
    'e_8': [('constexpr int kE = 4;', 'constexpr int kE = 8;')],
    'threads_128': [('constexpr int kThreads = 256;', 'constexpr int kThreads = 128;')],
    'int_counts': [(K4_SIGN, K4_SIGN.replace('float sign_of', 'int sign_of').replace('(float)', '(int)')),
                   ('void sign_quad(float (&c)[kE]', 'void sign_quad(int (&c)[kE]'),
                   ('float c[kE] = {};   // sums', 'int c[kE] = {};   // sums'),
                   ('__shared__ float s_count', '__shared__ int s_count'),
                   ('__fmul_rn(c[e], gr)', '__fmul_rn((float)c[e], gr)')],
    # Signs on the FP32 pipe: both operands scaled by 2^22 (exact below
    # 2^106), q = sat(fma(x - y, 2^127, 0.5)) in {0, 1/2, 1}, count =
    # 2 sum(q) - n: three FP32 instructions a pair for the comparisons'
    # four, two of them at half rate.
    'fp32_signs': [(K4_SIGN, '__device__ __forceinline__ float sign_of(float x, float y) {\n'
                             '  float q;\n  asm("fma.rn.sat.f32 %0, %1, %2, %3;" : "=f"(q) : '
                             '"f"(x - y), "f"(0x1p127f), "f"(0.5f));\n  return q;'),
                   ('for (int e = 0; e < kE; ++e) x[e] = i0 + e < n ? self[i0 + e] : 0.f;',
                    'for (int e = 0; e < kE; ++e) x[e] = (i0 + e < n ? self[i0 + e] : 0.f) * 0x1p22f;'),
                   ('    stage(s_o, other + c0, len);\n',
                    '    __syncthreads();\n    for (int k = threadIdx.x; k < len; k += kThreads) '
                    's_o[k] = other[c0 + k] * 0x1p22f;\n    __syncthreads();\n'),
                   ('__fmul_rn(c[e], gr)', '__fmul_rn(2.f * c[e] - (float)n, gr)')],
}


def k4_variant_libs(csrc, out):
    """Builds each K4 variant from an edited copy of csrc/fa_pairwise.cu;
    returns {name: library with its C signatures declared}."""
    from dualsuperreslearningforsemseg_tpu_torch.ops import _build, fa_pairwise
    with open(os.path.join(csrc, 'fa_pairwise.cu')) as f:
        source = f.read()
    shutil.rmtree(out, ignore_errors=True)
    procs = {}
    for name, edits in K4_VARIANTS.items():
        d = os.path.join(out, name)
        os.makedirs(d)
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit("K4 variant {}: no {!r}".format(name, old[:60]))
            text = text.replace(old, new)
        with open(os.path.join(d, 'fa_pairwise.cu'), 'w') as f:
            f.write(text)
        procs[name] = start_build(d, 'fa_pairwise', os.path.join(d, 'fa_pairwise.so'))
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        kept = [line.strip() for line in log.splitlines() if 'registers' in line or 'spill' in line
                or 'error' in line]
        print("K4 variant {}: {}".format(name, ' | '.join(kept)), flush=True)
        if not proc.returncode:
            libs[name] = _build.declare(ctypes.CDLL(so), fa_pairwise._SIGNATURES)
    return libs


def k4_time(lib, a, b, g, cluster):
    """(forward ms, backward ms) replayed from CUDA graphs, the forward's
    largest relative error and whether da and db equal the plain version's."""
    import torch
    import chip_smoke
    from dualsuperreslearningforsemseg_tpu_torch.ops import fa_pairwise
    rows, n = a.shape
    out, da, db = torch.empty(rows, device='cuda'), torch.empty_like(a), torch.empty_like(b)

    def forward():
        if lib.dsrl_fa_pairwise_fwd(a.data_ptr(), b.data_ptr(), out.data_ptr(), rows, n, cluster,
                                    torch.cuda.current_stream().cuda_stream):
            raise SystemExit("K4 forward launch failed")

    def backward():
        if lib.dsrl_fa_pairwise_bwd(a.data_ptr(), b.data_ptr(), g.data_ptr(), da.data_ptr(),
                                    db.data_ptr(), rows, n, torch.cuda.current_stream().cuda_stream):
            raise SystemExit("K4 backward launch failed")

    forward()
    backward()
    ref = fa_pairwise.fa_pairwise_forward_plain(a, b)
    da_p, db_p = fa_pairwise.fa_pairwise_backward_plain(a, b, g)
    rel = float(((out - ref).abs() / ref.abs()).max())
    equal = bool(torch.equal(da, da_p) and torch.equal(db, db_p))
    return chip_smoke.graph_ms(forward), chip_smoke.graph_ms(backward), rel, equal


def k4_host_breakdown(a, b):
    """Host microseconds a call of each part of the K4 forward wrapper, over
    2000 calls (the kernel launches only in the whole call)."""
    import time
    import torch
    from dualsuperreslearningforsemseg_tpu_torch.ops import _build, fa_pairwise
    lib = fa_pairwise._library()
    rows, n = a.shape
    ones = torch.ones(rows, device='cuda')

    def enter_exit():
        with _build.on_device(a):
            pass

    out, da, db = torch.empty(rows, device='cuda'), torch.empty_like(a), torch.empty_like(b)
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), rows, n, fa_pairwise.cluster_blocks(rows, n),
            _build.current_stream(a))
    bwd_args = (a.data_ptr(), b.data_ptr(), ones.data_ptr(), da.data_ptr(), db.data_ptr(), rows, n,
                _build.current_stream(a))

    parts = {
        '_check': lambda: fa_pairwise._check(a, b),
        'a.new_empty': lambda: a.new_empty(rows),
        'on_device enter/exit': enter_exit,
        'current_stream().cuda_stream': lambda: torch.cuda.current_stream().cuda_stream,
        '_build.current_stream': lambda: _build.current_stream(a),
        'a ctypes call (dsrl_fa_pairwise_tiles)': lambda: lib.dsrl_fa_pairwise_tiles(n),
        'the C forward launch alone': lambda: lib.dsrl_fa_pairwise_fwd(*args),
        'the C backward launch alone': lambda: lib.dsrl_fa_pairwise_bwd(*bwd_args),
        'whole forward call': lambda: fa_pairwise.fa_pairwise_forward(a, b),
        'whole backward call': lambda: fa_pairwise.fa_pairwise_backward(a, b, ones),
    }
    out = {}
    for name, fn in parts.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        out[name] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
        print("K4 host, {} at ({}, {}): {:.2f} us a call".format(name, rows, n, out[name]), flush=True)
    return out


def k4_main(parent):
    import torch
    import chip_smoke
    from dualsuperreslearningforsemseg_tpu_torch.ops import _build, fa_pairwise
    times = {}
    roots = [parent, HERE, HERE, parent] if parent else [HERE]
    for turn, root in enumerate(roots):
        who = 'parent' if root == parent else 'this'
        run = subprocess.run([sys.executable, '-c', K4_PHASE], cwd=root, capture_output=True,
                             text=True, timeout=900)
        print(run.stdout + run.stderr[-3000:], flush=True)
        if run.returncode:
            raise SystemExit("K4 phase of {} failed".format(root))
        for m in K4_LINE.finditer(run.stdout):
            key = '{} ({}, {}) turn {}'.format(who, m.group(1), m.group(2), turn)
            times[key] = {'forward_ms': float(m.group(3)), 'forward_graph_ms': float(m.group(4)),
                          'backward_ms': float(m.group(5)), 'backward_graph_ms': float(m.group(6))}
    libs = k4_variant_libs(_build.CSRC_DIR, os.path.join(HERE, 'build', 'variants', 'k4'))
    gen = torch.Generator(device='cuda').manual_seed(2)
    for rows, n in ((8, 256), (304, 1024)):
        a, b = chip_smoke.k4_case(gen, rows, n)
        g = torch.rand(rows, generator=gen, device='cuda') + 0.5
        times['host ({}, {})'.format(rows, n)] = k4_host_breakdown(a, b)
        chosen = fa_pairwise.cluster_blocks(rows, n)
        for name, lib in libs.items():
            for cluster in ((1, 2, 4, 8) if name == 'as_built' else (chosen,)):
                fwd, bwd, rel, equal = k4_time(lib, a, b, g, cluster)
                times['{} ({}, {}) cluster {}'.format(name, rows, n, cluster)] = {
                    'forward_graph_ms': fwd, 'backward_graph_ms': bwd, 'rel_err': rel,
                    'grads_equal': equal}
                print("K4 {} at ({}, {}), cluster of {}{}: forward {:.5f} ms, backward {:.5f} ms "
                      "device (graph); forward rel err {:.2e}, da and db equal to plain: {}".format(
                          name, rows, n, cluster, " (the wrapper's)" if cluster == chosen else "",
                          fwd, bwd, rel, equal), flush=True)
    return times


def main():
    import argparse
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--parent', help="a checkout whose K3 and K1 forward and backward (with "
                                         "--k4: K4) are timed beside this one's")
    parser.add_argument('--k4', action='store_true', help="time K4 instead of the tail kernels")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tail_variants: torch sees no CUDA device")
    sys.path.insert(0, HERE)
    if args.k4:
        from dualsuperreslearningforsemseg_tpu_torch.utils import select_device
        select_device('cuda')
        times = k4_main(os.path.abspath(args.parent) if args.parent else None)
        smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                             capture_output=True, text=True, timeout=60).stdout.strip()
        print(smi, flush=True)
        print(json.dumps(times), flush=True)
        return
    import chip_smoke
    from dualsuperreslearningforsemseg_tpu_torch.ops import _build
    from dualsuperreslearningforsemseg_tpu_torch.ops.eval_tail import _C_SIGNATURE as K3_SIGNATURE
    from dualsuperreslearningforsemseg_tpu_torch.ops.fused_tail import (
        _BWD_SIGNATURE as K1_SIGNATURE, _FWD_SIGNATURE as K1_FWD_SIGNATURE)
    from dualsuperreslearningforsemseg_tpu_torch.utils import select_device
    select_device('cuda')
    out = os.path.join(HERE, 'build', 'variants')
    dirs = edited_sources(_build.CSRC_DIR, out)
    procs = {}
    for name, d in dirs.items():
        for kern in kernels_of(name):
            procs[(name, kern)] = start_build(d, kern, os.path.join(d, kern + '.so'))
    if args.parent:
        for kern in KERNELS:
            procs[('parent', kern)] = start_build(
                os.path.join(os.path.abspath(args.parent), 'dualsuperreslearningforsemseg_tpu_torch', 'csrc'),
                kern, os.path.join(out, 'parent_{}.so'.format(kern)))
    libs = {}
    for (name, kern), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:   # e.g. too few registers for wgmma: reported, not timed
            fatal = [line.strip() for line in log.splitlines() if 'fatal' in line or 'error' in line]
            print("{} {}: nvcc failed: {}".format(name, kern, ' | '.join(fatal)[-2000:]), flush=True)
            continue
        kept = [line.strip() for line in log.splitlines()
                if 'registers' in line or 'spill' in line or 'entry function' in line or 'wgmma' in line]
        print("{} {}: {}".format(name, kern, ' | '.join(kept)), flush=True)
        libs[(name, kern)] = ctypes.CDLL(so)

    gen = torch.Generator(device='cuda').manual_seed(1)
    x3, weight, bias, labels3 = chip_smoke.tail_case(gen, 16, 256, 512, exact=False)
    x1, _, _, labels1 = chip_smoke.tail_case(gen, 8, 256, 512, exact=False)
    stream = torch.cuda.current_stream().cuda_stream
    one = torch.ones((), device='cuda')
    times = {}

    def grid_of(query, code, npix):
        grid = ctypes.c_int(0)
        if query(ctypes.c_int(code), ctypes.c_longlong(npix), ctypes.byref(grid)):
            raise SystemExit("grid query failed")
        return grid.value

    def k1_forward_args(lib, code, x, labels):
        """The forward's entry and arguments; a library that still has
        ``dsrl_fused_tail_fwd_threads`` (the one-thread-per-pixel design)
        sizes its partials by it and takes no grid."""
        b, _, h, w = x.shape
        fn = lib.dsrl_fused_tail_fwd
        ce, cnt = (torch.empty((), dtype=dt, device='cuda') for dt in (torch.float64, torch.int64))
        if hasattr(lib, 'dsrl_fused_tail_fwd_threads'):
            grid = -(-b * h * w // lib.dsrl_fused_tail_fwd_threads())
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        else:
            grid = grid_of(lib.dsrl_fused_tail_fwd_grid, code, b * h * w)
            fn.argtypes = K1_FWD_SIGNATURE
        fn.restype = ctypes.c_int
        parts = [torch.empty(grid, dtype=dt, device='cuda') for dt in (torch.float64, torch.int64)]
        head = (code, x.data_ptr(), weight.data_ptr(), bias.data_ptr(), labels.data_ptr(),
                parts[0].data_ptr(), parts[1].data_ptr())
        tail = (ce.data_ptr(), cnt.data_ptr(), b, h, w, 255, stream)
        keep = (parts, ce, cnt)
        if hasattr(lib, 'dsrl_fused_tail_fwd_threads'):
            return fn, head + tail, grid, keep
        return fn, head + (grid,) + tail, grid, keep

    def timed(key, fn, fargs, grid):
        """A call's time (CUDA events over 30 calls) and its device time
        (replayed from a CUDA graph: no host launch cost); the stream
        argument comes last and is taken at call time."""
        def run():
            if fn(*fargs[:-1], torch.cuda.current_stream().cuda_stream):
                raise SystemExit("launch of {} failed".format(key))

        ms = chip_smoke.cuda_ms(run, iters=30)
        graph = chip_smoke.graph_ms(run)
        times[key] = {'ms': ms, 'graph_ms': graph, 'grid': grid}
        print("{}: {:.4f} ms a call, {:.4f} ms replayed from a graph (grid {})".format(key, ms, graph, grid),
              flush=True)

    def time_k1(lib, label, backward=True):
        """K1 forward and (unless not asked) backward of one build, both dtypes."""
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            suffix = '{} {}'.format(label, str(dtype).replace('torch.', ''))
            x, labels = x1.to(dtype), labels1
            fn, fargs, grid, _keep = k1_forward_args(lib, code, x, labels)
            timed('K1 forward ' + suffix, fn, fargs, grid)
            if not backward:
                continue
            b, _, h, w = x.shape
            grid = grid_of(lib.dsrl_fused_tail_bwd_grid, code, b * h * w)
            fn = lib.dsrl_fused_tail_bwd
            fn.argtypes, fn.restype = K1_SIGNATURE, ctypes.c_int
            dx, dw, db = torch.empty_like(x), torch.empty_like(weight), torch.empty_like(bias)
            partials = torch.empty(grid * lib.dsrl_fused_tail_partial_size(),
                                   dtype=torch.float64, device='cuda')
            timed('K1 backward ' + suffix, fn, (code, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                                                labels.data_ptr(), one.data_ptr(), dx.data_ptr(),
                                                partials.data_ptr(), grid, dw.data_ptr(), db.data_ptr(),
                                                b, h, w, 255, stream), grid)

    def time_k3(lib, label):
        """K3 of one build, both dtypes (its counts add up over the calls:
        only the time means something here)."""
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            suffix = '{} {}'.format(label, str(dtype).replace('torch.', ''))
            x, labels = x3.to(dtype), labels3
            b, _, h, w = x.shape
            grid = grid_of(lib.dsrl_eval_tail_grid, code, b * h * w)
            fn = lib.dsrl_eval_tail
            fn.argtypes, fn.restype = K3_SIGNATURE, ctypes.c_int
            pred = torch.empty_like(labels)
            partials = torch.empty(grid, dtype=torch.float64, device='cuda')
            ce = torch.empty((), dtype=torch.float64, device='cuda')
            counts = torch.zeros(3 * 19 + 2, dtype=torch.int64, device='cuda')
            timed('K3 ' + suffix, fn, (code, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                                       labels.data_ptr(), pred.data_ptr(), partials.data_ptr(), grid,
                                       ce.data_ptr(), counts.data_ptr(), b, h, w, 255, stream), grid)

    def parent_and_this(when):
        """The parent's K3 and K1 and this build's, in this order 'first'
        and in the other 'last': parent, this, this, parent."""
        turns = [('parent', 'parent ({})'.format(when)), ('as_built', 'as_built ({})'.format(when))]
        for name, label in (turns if when == 'first' else turns[::-1]):
            if (name, 'eval_tail') in libs:
                time_k3(libs[(name, 'eval_tail')], label)
            if (name, 'fused_tail') in libs:
                time_k1(libs[(name, 'fused_tail')], label)

    parent_and_this('first')
    for (name, kern), lib in sorted(libs.items()):
        if name in ('parent', 'as_built'):
            continue
        if kern == 'fused_tail':
            time_k1(lib, name, backward=name not in FWD_ONLY)
        else:
            time_k3(lib, name)
    parent_and_this('last')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(json.dumps(times), flush=True)


if __name__ == '__main__':
    main()
