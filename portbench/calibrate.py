"""Readings for the limits that decide ``correct``: for each seed, one run of
a cell through ``core.measure`` and ``core.result`` (set-up, window, the
comparison with the reference), and with ``--control`` the reference itself
in TF32, judged by the same ``core.result``; with ``--fault`` the run's
timed path is broken as ``drivers/<driver>.py``'s FAULTS name it.  All seeds
run in one process, one JSON line each.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 --seconds 20 [--control] [--fault F]

Not part of a benchmark run; its readings are what the limits in
``workloads/<cell>.json`` were set from.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import core, run  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True, help="comma-separated whole numbers")
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--control', action='store_true')
    p.add_argument('--fault', default=None)
    p.add_argument('--out', default=None, help="also append the lines to this file")
    args = p.parse_args(argv)
    run.cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("portbench.calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = core.Cell(args.workload)
    run.port_settings(cell.cfg)
    core.select_device()
    for seed in (int(s) for s in args.seeds.split(',')):
        drv, setup_s, obs, readings = core.measure(cell, seed, args.seconds, False, 'cuda',
                                                   time.perf_counter(), args.fault, args.control)
        out = core.result(cell, setup_s, obs, readings[0], False, 'cuda')
        line = {'workload': cell.name, 'seed': seed, 'fault': args.fault, 'setup_s': setup_s,
                'setup_phases_s': getattr(drv, 'phases', None), 'e2e': obs['e2e'],
                'attempted': out['attempted'], 'failed': out['failed'],
                'memory_peak_bytes': obs['memory_peak_bytes'], 'reference_s': obs['reference_s'],
                'correct': out['correct'], 'program': readings[0]}
        if args.control:
            line['control'] = readings[1]
            line['control_correct'] = core.result(cell, setup_s, obs, readings[1], False, 'cuda')['correct']
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(text + '\n')
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
