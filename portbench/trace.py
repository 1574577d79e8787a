"""The traced window: ``torch.profiler`` over it, reduced to the device's
busy time, each device operation's time, and the idle gaps named by what
the host was doing.

Only the window is traced, and nothing is written to disk: the events are
read from the profiler's results in memory.
"""

import bisect
import re

import torch

MARKER = 'portbench.window'
MIN_GAP_NS = 5_000          # shorter gaps are launch spacing, not named one by one
NAME_CHARS = 160


class Tracer:
    """``with Tracer() as t: with t.window(): ...`` then ``t.summary()``."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    @staticmethod
    def window():
        return torch.profiler.record_function(MARKER)

    def summary(self):
        return reduce_events(_events(self.prof))


def _events(prof):
    """[(is_device, name, start_ns, end_ns)] of every event."""
    results = getattr(prof.profiler, 'kineto_results', None)
    out = []
    if results is not None:
        for e in results.events():
            is_dev = e.device_type() == torch.autograd.DeviceType.CUDA
            annotation = getattr(e, 'is_user_annotation', None)
            if is_dev and annotation is not None and annotation():
                continue                     # a host range mirrored on the device, not work
            start = e.start_ns()
            out.append((is_dev, e.name(), start, start + e.duration_ns()))
        return out
    for e in prof.events():
        is_dev = e.device_type == torch.autograd.DeviceType.CUDA
        out.append((is_dev, e.name, int(e.time_range.start * 1000), int(e.time_range.end * 1000)))
    return out


def reduce_events(events):
    """-> {'window_s', 'busy_s', 'kernel_s': {name: s}, 'kernel_n': {name: n},
    'device_ops': top 10 [name, s], 'idle_gaps': top 10 [host op, s]}."""
    marks = [e for e in events if not e[0] and e[1] == MARKER]
    if not marks:
        raise RuntimeError("the trace holds no window marker")
    ws, we = marks[0][2], marks[0][3]
    dev, host = [], []
    for is_dev, name, s, e in events:
        if name == MARKER:
            continue
        if is_dev:
            s, e = max(s, ws), min(e, we)
            if e > s:
                dev.append((s, e, name))
        elif e > ws and s < we:
            host.append((s, e, name))
    kernel_s, kernel_n = {}, {}
    for s, e, name in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (e - s) * 1e-9
        kernel_n[name] = kernel_n.get(name, 0) + 1
    dev.sort()
    busy, gaps, cur_s, cur_e = 0, [], None, ws
    for s, e, _ in dev:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s - cur_e >= MIN_GAP_NS:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if we - cur_e >= MIN_GAP_NS:
        gaps.append((cur_e, we))
    host.sort()
    starts = [h[0] for h in host]
    by_host = {}
    for gs, ge in gaps:
        name = _host_op_at(host, starts, (gs + ge) // 2)
        by_host[name] = by_host.get(name, 0.0) + (ge - gs) * 1e-9
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return {'window_s': (we - ws) * 1e-9, 'busy_s': busy * 1e-9, 'kernel_s': kernel_s,
            'kernel_n': kernel_n,
            'device_ops': [[n[:NAME_CHARS], s] for n, s in top],
            'idle_gaps': [[n[:NAME_CHARS], s] for n, s in
                          sorted(by_host.items(), key=lambda kv: -kv[1])[:10]]}


def _host_op_at(host, starts, t, scan=20000):
    """The innermost host event covering time ``t``: the latest-starting one."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - scan, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return '(no host op)'


def kernel_seconds(summary, patterns):
    """(seconds, launches) of the device operations whose names match any of
    ``patterns`` (regular expressions)."""
    rx = re.compile('|'.join(patterns))
    secs = sum(s for n, s in summary['kernel_s'].items() if rx.search(n))
    count = sum(c for n, c in summary['kernel_n'].items() if rx.search(n))
    return secs, count
