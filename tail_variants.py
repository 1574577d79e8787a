#!/usr/bin/env python3
"""Where the time of the tail kernels K3 and K1 backward goes, on one GPU.

    python3 tail_variants.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Builds variants of ``csrc/eval_tail.cu`` (K3) and ``csrc/fused_tail.cu``
(K1; its backward is timed) from edited copies of the sources under
``build/variants/``, each with one part removed or changed, and times each
with CUDA events at the main path's shapes, x (16, 19, 256, 512) for K3 and
(8, 19, 256, 512) for K1 backward, float32 and bfloat16.  A variant's
results are wrong by construction: only its time means something, next to
the unchanged build's from the same run.  Prints each build's
``-Xptxas -v`` summary, one line per timing, then the card's name and power
limit and a JSON object of all the timings.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

ATOMICS = ('  if (valid) atomicAdd(&hist[cls], 1);\n  if (hit) atomicAdd(&hist[kC + cls], 1);\n'
           '  if (active && lab < kC) atomicAdd(&hist[2 * kC + lab], 1);\n')
LAUNCH_BOUNDS = '__global__ void __launch_bounds__(kThreads, 2)'
# name -> {source file: [(text, replacement), ...]}
VARIANTS = {
    'as_built': {},
    'one_tf32_pass': {'tail_common.cuh': [(
        '  mma_tf32(d, a_lo, b_hi);\n  mma_tf32(d, a_hi, b_lo);\n  mma_tf32(d, a_hi, b_hi);',
        '  mma_tf32(d, a_hi, b_hi);')]},
    'no_logits_mma': {'tail_common.cuh': [
        ('mma_3xtf32(acc[nt], a_hi, a_lo, b_hi, b_lo);', 'acc[nt][0] += __uint_as_float(b_hi[0] ^ a_lo[0]);'),
        ('mma_bf16(acc[nt], a, b);', 'acc[nt][0] += __uint_as_float(b[0] ^ a[0]);')]},
    'no_exp': {
        'eval_tail.cu': [('ce += (double)dsrl_tail::ce_nll(m, dsrl_tail::exp_sum(l, m), picked);',
                          'ce += (double)(m - picked);')],
        'fused_tail.cu': [('const float inv_z = 1.f / dsrl_tail::exp_sum(l, dsrl_tail::row_max(l));',
                           'const float inv_z = 1.f / (1.f + l[3]);')]},
    'no_histograms': {'eval_tail.cu': [(ATOMICS, '')]},
    'no_async_loads': {'tail_common.cuh': [('      cp_async16(dst, src);\n',
                                            '      dst[0] = from_float<T>(0.f);\n')]},
    'no_dx': {'fused_tail.cu': [(
        '    part_dx<T>(s_l, s_wtb, s_off + cur * kWarpP, dx, p0, npix, hw, lane);\n', '')]},
    'no_dw': {'fused_tail.cu': [(
        '    tile_dw<T>(s_lall, xs, 2 * kSlabElems, warp, lane, dw_acc[0]);\n'
        '    if (warp + 8 < 15) tile_dw<T>(s_lall, xs, 2 * kSlabElems, warp + 8, lane, dw_acc[1]);\n',
        '')]},
    'three_blocks_per_sm': {'eval_tail.cu': [(LAUNCH_BOUNDS, LAUNCH_BOUNDS.replace('2)', '3)'))],
                            'fused_tail.cu': [(LAUNCH_BOUNDS, LAUNCH_BOUNDS.replace('2)', '3)'))]},
    'one_block_per_sm': {'eval_tail.cu': [(LAUNCH_BOUNDS, LAUNCH_BOUNDS.replace('2)', '1)'))],
                         'fused_tail.cu': [(LAUNCH_BOUNDS, LAUNCH_BOUNDS.replace('2)', '1)'))]},
}
KERNELS = ('eval_tail', 'fused_tail')


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


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("tail_variants: torch sees no CUDA device")
    sys.path.insert(0, HERE)
    import chip_smoke
    from dualsuperreslearningforsemseg_tpu_torch.ops import _build
    from dualsuperreslearningforsemseg_tpu_torch.ops.eval_tail import _C_SIGNATURE as K3_SIGNATURE
    from dualsuperreslearningforsemseg_tpu_torch.ops.fused_tail import _BWD_SIGNATURE as K1_SIGNATURE
    from dualsuperreslearningforsemseg_tpu_torch.utils import select_device
    select_device('cuda')
    dirs = edited_sources(_build.CSRC_DIR, os.path.join(HERE, 'build', 'variants'))
    procs = {}
    for name, d in dirs.items():
        for kern in KERNELS:
            so = os.path.join(d, kern + '.so')
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, '-Xptxas', '-v', '-o', so,
                   os.path.join(d, kern + '.cu')]
            procs[(name, kern)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for (name, kern), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit("nvcc failed on variant {} of {}:\n{}".format(name, kern, log[-4000:]))
        kept = [line.strip() for line in log.splitlines() if 'registers' in line or 'spill' in line]
        print("{} {}: {}".format(name, kern, ' | '.join(kept)), flush=True)
        libs[(name, kern)] = ctypes.CDLL(so)

    gen = torch.Generator(device='cuda').manual_seed(1)
    x3, weight, bias, labels3 = chip_smoke.tail_case(gen, 16, 256, 512, exact=False)
    x1, _, _, labels1 = chip_smoke.tail_case(gen, 8, 256, 512, exact=False)
    stream = torch.cuda.current_stream().cuda_stream
    one = torch.ones((), device='cuda')
    times = {}
    for (name, kern), lib in sorted(libs.items()):
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            grid = ctypes.c_int(0)
            if kern == 'eval_tail':
                x, labels = x3.to(dtype), labels3
                b, _, h, w = x.shape
                if lib.dsrl_eval_tail_grid(ctypes.c_int(code), ctypes.c_longlong(b * h * w),
                                           ctypes.byref(grid)):
                    raise SystemExit("grid query failed")
                fn = lib.dsrl_eval_tail
                fn.argtypes, fn.restype = K3_SIGNATURE, ctypes.c_int
                pred = torch.empty_like(labels)
                partials = torch.empty(grid.value, dtype=torch.float64, device='cuda')
                ce = torch.empty((), dtype=torch.float64, device='cuda')
                counts = torch.zeros(3 * 19 + 2, dtype=torch.int64, device='cuda')
                args = (code, x.data_ptr(), weight.data_ptr(), bias.data_ptr(), labels.data_ptr(),
                        pred.data_ptr(), partials.data_ptr(), grid.value, ce.data_ptr(),
                        counts.data_ptr(), b, h, w, 255, stream)
            else:
                x, labels = x1.to(dtype), labels1
                b, _, h, w = x.shape
                if lib.dsrl_fused_tail_bwd_grid(ctypes.c_int(code), ctypes.c_longlong(b * h * w),
                                                ctypes.byref(grid)):
                    raise SystemExit("grid query failed")
                fn = lib.dsrl_fused_tail_bwd
                fn.argtypes, fn.restype = K1_SIGNATURE, ctypes.c_int
                dx, dw, db = torch.empty_like(x), torch.empty_like(weight), torch.empty_like(bias)
                partials = torch.empty(grid.value * lib.dsrl_fused_tail_partial_size(),
                                       dtype=torch.float64, device='cuda')
                args = (code, x.data_ptr(), weight.data_ptr(), bias.data_ptr(), labels.data_ptr(),
                        one.data_ptr(), dx.data_ptr(), partials.data_ptr(), grid.value,
                        dw.data_ptr(), db.data_ptr(), b, h, w, 255, stream)

            def run():
                if fn(*args):
                    raise SystemExit("launch of variant {} of {} failed".format(name, kern))

            ms = chip_smoke.cuda_ms(run, iters=30)
            key = '{} {} {}'.format('K3' if kern == 'eval_tail' else 'K1 backward', name,
                                    str(dtype).replace('torch.', ''))
            times[key] = {'ms': ms, 'grid': grid.value}
            print("{}: {:.4f} ms (grid {})".format(key, ms, grid.value), flush=True)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(json.dumps(times), flush=True)


if __name__ == '__main__':
    main()
