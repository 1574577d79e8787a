"""Runs one cell of the benchmark once and prints its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs a CUDA card (as many as the cell asks for) and exits non-zero without
a result where torch sees fewer.  Set-up (``setup_s``) runs from the start
of this process to the first timed step.  With ``--trace 0`` the result
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read from a profiler trace and CUDA events over the window.  The
last lines of standard error, and the result's last key, give each number
that decided ``correct`` beside its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'dualsuperreslearningforsemseg_tpu')


def cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout (the
    program's own kernels build into ``build/kernels``)."""
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'), ('TRITON_CACHE_DIR', 'triton'),
                     ('CUDA_CACHE_PATH', 'cuda_cache')):
        os.environ[var] = os.path.join(ROOT, 'build', 'portbench', sub)


def port_settings(cfg):
    """Sets the program's own overrides of its sizes from the cell's
    configuration, as its model module names them; the program reads them
    when it is first imported, so before that."""
    from portbench.models import find
    os.environ.update(find(cfg).program_env(cfg))


def forbidden_modules():
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a whole number >= 0")
    cache_dirs()
    os.environ.setdefault('USE_FLAX', '0')
    sys.path.insert(0, ROOT)
    import torch
    from portbench import core
    start = {'imports': time.perf_counter() - T_START}
    cell = core.Cell(args.workload)
    port_settings(cell.cfg)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("portbench: {} needs {} CUDA card(s); torch sees {}".format(
            args.workload, cell.chips, torch.cuda.device_count() if torch.cuda.is_available() else 0),
            file=sys.stderr)
        return 2
    core.select_device()
    start['program_import'] = time.perf_counter() - T_START - start['imports']
    drv, setup_s, obs, readings = core.measure(cell, args.seed, args.seconds, bool(args.trace), 'cuda',
                                               T_START)
    out = core.result(cell, setup_s, obs, readings[0], bool(args.trace), 'cuda')
    info = {k: v for k, v in readings[0].items() if k not in cell.limits}
    info.update(setup_phases_s=dict(start, **(getattr(drv, 'phases', None) or {})),
                window=getattr(drv, 'diag', None), reference_s=obs['reference_s'])
    print("portbench: {} seed {} {}".format(args.workload, args.seed, json.dumps(info)), file=sys.stderr)
    for name, c in out['checks'].items():
        print("check {}: {!r} (limit {!r})".format(name, c['value'], c['limit']), file=sys.stderr)
    # Last before the result: whatever the window, the reference and the
    # per-layer readers loaded is in sys.modules by now.
    found = forbidden_modules()
    if found:
        print("portbench: the run loaded {}; no result".format(', '.join(found)), file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0

if __name__ == '__main__':
    # Python's compiled modules at a fixed path inside the checkout too, so
    # that only a checkout's first run compiles what it imports, also where
    # the environment sets PYTHONDONTWRITEBYTECODE and the installed
    # packages ship no bytecode.
    sys.pycache_prefix = os.path.join(ROOT, 'build', 'portbench', 'pycache')
    sys.dont_write_bytecode = False
    sys.exit(main())
