"""The test traffic: one client in a closed loop of single frames through
the ``test`` command's per-frame pipeline.

Each frame is a seeded (H, W, 3) uint8 image at the model's output size
(what ``commands/test.py::_test_images`` hands its pipeline after the PIL
resize), drawn from a pool in an order drawn from the seed; it goes through
``commands.test._build_pipeline`` over the model's class logits (its model
module's ``logits`` of the eval forward, as ``_build_forward`` returns them
in eager mode, with the seeded weights already on the card) to a host uint8
class map.  A frame's latency runs from the host frame to the host class
map.  The class maps of every ``check_every``-th frame (from a phase drawn
from the seed) are kept for the comparison.
"""

import time
import types

import torch

from .. import seeds
from ..inputs import frame_pool
from ..models import find
from ..reference import augment
from ..stats import percentile
from ..weights import load_into, make_state
from .common import NO_ANSWER, Phases, port, port_model
from .train import tf32

FAULTS = ('altered_answer',)


class Driver:
    e2e = 'test_p95_ms'

    def __init__(self, cfg, traffic, seed, device, fault=None, cell_spec=None):
        if fault not in (None,) + FAULTS:
            raise ValueError("unknown fault {!r}".format(fault))
        self.cfg, self.traffic, self.seed, self.device, self.fault = cfg, traffic, seed, device, fault

    def setup(self):
        cfg, tr, dev = self.cfg, self.traffic, self.device
        P = port()
        phases = Phases()
        model = port_model(cfg)
        phases.mark('program')
        self.model = load_into(model, make_state(cfg, seeds.subseed(self.seed, seeds.WEIGHTS), dev))
        self.model.eval()
        phases.mark('weights')
        model, arch = self.model, find(cfg)
        ds = types.SimpleNamespace(MEAN=tuple(cfg['mean']), STD=tuple(cfg['std']))
        self.pipeline = P.test._build_pipeline(lambda x: arch.logits(model(x)), ds, torch.device(dev))
        frames, _ = frame_pool(self.seed, tr['pool_frames'], cfg['output_hw'], dev, labels=False)
        self.frames = [f.numpy() for f in frames]
        phases.mark('pool')
        self.order = seeds.rng(self.seed, seeds.ORDER).integers(
            0, tr['pool_frames'], size=tr['max_frames']).tolist()
        self.phase = int(seeds.rng(self.seed, seeds.SAMPLE).integers(0, tr['check_every']))
        self.k = 0
        for _ in range(tr['warm_frames']):
            self._frame()
        self.k = 0
        self.kept = []
        self.phases = phases.mark('warm_frames')

    def _frame(self):
        j = self.order[self.k]
        pred = self.pipeline(self.frames[j])
        if self.fault == 'altered_answer':        # the class map, shifted
            pred = (pred + 1) % self.cfg['num_classes']
        self.k += 1
        return j, pred

    def window(self, seconds):
        """Frames until ``seconds`` have passed; every window's kept frames
        are judged after the last."""
        latencies = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds and self.k < len(self.order):
            k = self.k
            t = time.perf_counter()
            j, pred = self._frame()
            latencies.append(time.perf_counter() - t)
            if (k + self.phase) % self.traffic['check_every'] == 0:
                self.kept.append((j, pred))
        window_s = time.perf_counter() - t0
        n = len(latencies)
        self.diag = {q: 1e3 * percentile(latencies, v) for q, v in
                     (('p50_ms', 50), ('p90_ms', 90), ('p99_ms', 99), ('max_ms', 100))}
        return {'e2e': {self.e2e: 1e3 * percentile(latencies, 95)}, 'steps': n, 'images': n,
                'window_s': window_s, 'attempted': n, 'failed': 0}

    def release(self):
        del self.model, self.pipeline

    def readings(self, control=False):
        """Each kept frame: the widest gap by which a pixel's class lies below
        the reference's best logit for that frame."""
        cfg, nc, arch = self.cfg, self.cfg['num_classes'], find(self.cfg)
        with torch.device(self.device):
            ref = arch.reference(cfg)
        load_into(ref, make_state(cfg, seeds.subseed(self.seed, seeds.WEIGHTS), self.device)).eval()
        prog, ctl = {'class_gap': 0.0}, {'class_gap': 0.0}
        logits = {}
        with torch.no_grad():
            for j in sorted({j for j, _ in self.kept}):
                x = torch.from_numpy(self.frames[j])[None].to(self.device)
                x = augment.resize(augment.normalise(x, cfg['mean'], cfg['std']), cfg['input_hw'])
                logits[j] = arch.logits(ref(x))[0]
                if control:
                    with tf32():
                        c_pred = arch.logits(ref(x))[0].argmax(0)
                    ctl['class_gap'] = max(ctl['class_gap'], _gap(logits[j], c_pred, nc))
            for j, pred in self.kept:
                pred = torch.from_numpy(pred).to(self.device)
                gap = _gap(logits[j], pred, nc) if pred.shape == logits[j].shape[1:] else NO_ANSWER
                prog['class_gap'] = max(prog['class_gap'], gap)
        prog['checked_frames'] = len(self.kept)
        return [prog, ctl] if control else [prog]


def _gap(logits, pred, nc):
    """max over pixels of (best logit - the logit of ``pred``'s class)."""
    if int(pred.max()) >= nc:
        return NO_ANSWER
    picked = logits.gather(0, pred.long().unsqueeze(0)).squeeze(0)
    return float((logits.max(0).values - picked).max())
