"""What the readers of the program's spans share: the milliseconds a step
of named spans over the untraced window of a traced run.

The program keeps its spans in a ring in this process's memory
(``dualsuperreslearningforsemseg_tpu_torch/utils/spans.py``); its
``window(marker, n)`` returns the records of the last ``n`` steps run with
the profiler off, each step opened by a ``marker`` span, which in a traced
run are those of the untraced window.  A program without the ring, a ring
that no longer holds the window, and a window without the named spans all
read None.
"""

import importlib

# The span that opens each step of a traffic's driver.
MARKERS = {'train': 'data.warp', 'eval': 'data.eval_transform', 'test': 'test.input'}


def window(obs):
    try:
        spans = importlib.import_module('dualsuperreslearningforsemseg_tpu_torch.utils.spans')
    except ImportError:
        return None
    return spans.window(MARKERS[obs['traffic']['driver']], obs['steps'])


def ms_per_step(obs, names, clock):
    """The summed ``clock`` ('host' or 'device') milliseconds of the spans
    ``names`` in the window, over its steps."""
    records = window(obs) if obs['steps'] else None
    if records is None:
        return None
    values = [r.host_ms if clock == 'host' else r.device_ms for r in records if r.name in names]
    if not values or None in values:
        return None
    return sum(values) / obs['steps']
