"""One run of one cell: find its files by name, set up, measure the window,
check the outputs, and assemble the result line.

A cell ``<name>`` is ``workloads/<name>.json``: its configuration
(``configs/<config>.json``, whose ``model`` names the module of ``models/``
that builds it), its traffic (``traffic/<traffic>.json``, whose ``driver``
names the module of ``drivers/`` that runs it) and the limits
of the numbers that decide ``correct``.  Which metrics the cell reports is
read from ``BENCHMARK.json``; each per-layer metric ``<metric>`` is read
by ``layer_metrics/<metric>.py``.
"""

import importlib
import importlib.util
import json
import math
import os
import subprocess
import time

import torch

from .drivers.common import NO_ANSWER

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(kind, name):
    with open(os.path.join(HERE, kind, name + '.json')) as f:
        return json.load(f)


class Cell:
    def __init__(self, name):
        self.name = name
        spec = self.spec = _load('workloads', name)
        self.cfg = _load('configs', spec['config'])
        self.traffic = _load('traffic', spec['traffic'])
        self.limits = spec['limits']
        with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
            bench = json.load(f)
        mine = [w for w in bench['workloads'] if w['name'] == name]
        if not mine:
            raise KeyError("BENCHMARK.json has no workload {!r}".format(name))
        self.chips = mine[0]['chips']
        self.end_to_end = [m for m in bench['end_to_end'] if name in m.get('workloads', [name])]
        reported = {m['name'] for m in self.end_to_end}
        self.per_layer = [m for m in bench['per_layer']
                          if name in m.get('workloads', [name] if m['moves'] in reported else [])]


def driver(cell, seed, device, fault=None):
    module = importlib.import_module('portbench.drivers.' + cell.traffic['driver'])
    return module.Driver(cell.cfg, cell.traffic, seed, device, fault, cell.spec)


def layer_reader(name):
    path = os.path.join(HERE, 'layer_metrics', name + '.py')
    spec = importlib.util.spec_from_file_location('portbench.layer_metrics.' + name.replace('.', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def power_limit_w():
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=power.limit', '--format=csv,noheader,nounits'],
                             capture_output=True, text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def measure(cell, seed, seconds, trace, device, t_start, fault=None, control=False):
    """Set-up, the window and the readings -> (driver, setup_s, window
    observations, [the program's numbers compared, and with ``control`` the
    same numbers of the reference in TF32 put in its place]).

    A traced run measures two windows, one after the other: ``seconds``
    untraced (its steps, the program's spans and ``step_mfu`` come from
    it), then at most the traffic's ``trace_seconds`` under the profiler
    (the device's busy share, the kernels' times and the breakdown).  The
    profiler's reading of its events takes several times its window, and a
    run has 360 s.
    ``memory_peak_bytes`` is the windows' peak; the set-up's, which holds
    cuDNN's autotuner trying algorithms, is ``memory_setup_peak_bytes``."""
    from .trace import Tracer
    cuda = device == 'cuda'
    drv = driver(cell, seed, device, fault)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    obs = drv.window(seconds)
    if trace:
        with Tracer() as tracer:
            with tracer.window():
                traced = drv.window(min(seconds, cell.traffic['trace_seconds']))
        obs['trace'] = dict(tracer.summary(), steps=traced['steps'])
        obs['attempted'] += traced['attempted']
        obs['failed'] += traced['failed']
        obs['power_limit_w'] = power_limit_w()
        del tracer
    obs['memory_peak_bytes'] = torch.cuda.max_memory_allocated() if cuda else 0
    obs['memory_setup_peak_bytes'] = setup_peak
    drv.release()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    readings = drv.readings(control)
    obs['reference_s'] = time.perf_counter() - t0
    obs['failed'] = getattr(drv, 'failed', obs['failed'])
    return drv, setup_s, obs, readings


def result(cell, setup_s, obs, numbers, trace, device):
    """The result line's object; its last key holds each number compared
    beside its limit."""
    checks = {k: {'value': numbers[k] if math.isfinite(numbers[k]) else NO_ANSWER, 'limit': lim}
              for k, lim in cell.limits.items()}
    correct = all(c['value'] <= c['limit'] for c in checks.values()) and obs['attempted'] > 0
    metrics = {}
    if trace:
        obs['cfg'], obs['traffic'] = cell.cfg, cell.traffic
        for m in cell.per_layer:
            value = layer_reader(m['name'])(obs)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        values = dict(obs['e2e'], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m['name']] = {'value': values[m['name']], 'unit': m['unit']}
    dev = {'platform': 'gpu' if device == 'cuda' else device,
           'kind': torch.cuda.get_device_name(0) if device == 'cuda' else device,
           'count': cell.chips, 'memory_peak_bytes': obs['memory_peak_bytes'],
           'memory_setup_peak_bytes': obs['memory_setup_peak_bytes']}
    out = {'correct': correct, 'attempted': obs['attempted'], 'failed': obs['failed'],
           'metrics': metrics, 'device': dev}
    if trace:
        t = obs['trace']
        dev.update(busy_s=t['busy_s'], window_s=t['window_s'], power_limit_w=obs['power_limit_w'])
        out['breakdown'] = {'device_ops': t['device_ops'], 'idle_gaps': t['idle_gaps']}
    out['checks'] = checks
    return out


def select_device():
    """The card with the program's precision switches (TF32 off,
    deterministic cuDNN, autotuner on), as its command line sets them."""
    from .drivers.common import port
    return port().utils.select_device('cuda')
