"""The eval traffic: the loop of ``commands/benchmark.py`` and
``train_or_resume.validate``, batch after batch.

Each batch is ``batch`` consecutive frames of a seeded pool, from an offset
drawn from the seed, copied pinned to the card without blocking, through
``data.make_eval_transform_fn`` and ``train.make_eval_step``; each batch's
CE, histograms and counts stay on the card until the window ends.  The
class maps of every ``check_every``-th batch (from a phase drawn from the
seed) are kept for the comparison.
"""

import math
import time

import torch

from .. import seeds
from ..inputs import frame_pool
from ..models import find
from ..reference import augment
from ..reference.losses import cross_entropy, tallies
from ..weights import load_into, make_state
from .common import NO_ANSWER, Phases, port, port_model, rel_gap
from .train import tf32

FAULTS = ('half_batch', 'altered_answer')


class Driver:
    e2e = 'eval_img_per_s'

    def __init__(self, cfg, traffic, seed, device, fault=None, cell_spec=None):
        if fault not in (None,) + FAULTS:
            raise ValueError("unknown fault {!r}".format(fault))
        self.cfg, self.traffic, self.seed, self.device, self.fault = cfg, traffic, seed, device, fault

    def setup(self):
        cfg, tr, dev = self.cfg, self.traffic, self.device
        P = port()
        phases = Phases()
        b, n = tr['batch'], tr['pool_frames']
        model = port_model(cfg)
        phases.mark('program')
        self.model = load_into(model, make_state(cfg, seeds.subseed(self.seed, seeds.WEIGHTS), dev))
        self.model.eval()
        phases.mark('weights')
        lut = torch.tensor(cfg['label_map'], dtype=torch.uint8).numpy()
        self.transform = P.data.make_eval_transform_fn(tuple(cfg['input_hw']), tuple(cfg['output_hw']),
                                                       tuple(cfg['mean']), tuple(cfg['std']), lut)
        self.eval_step = P.train.make_eval_step(cfg['num_classes'], 255)
        self.pool_img, self.pool_seg = frame_pool(self.seed, n, tr['frame_hw'], dev,
                                                  label_block=tr['label_block'])
        phases.mark('pool')
        self.valid = torch.ones(b, dtype=torch.float32, pin_memory=torch.device(dev).type == 'cuda')
        order = seeds.rng(self.seed, seeds.ORDER)
        self.offsets = order.integers(0, n - b + 1, size=tr['max_batches']).tolist()
        self.phase = int(seeds.rng(self.seed, seeds.SAMPLE).integers(0, tr['check_every']))
        self.k = 0
        for _ in range(tr['warm_batches']):
            self._batch()
        self._sync()
        self.k = 0
        self.tallies, self.kept = [], []
        self.phases = phases.mark('warm_batches')

    def _sync(self):
        if torch.device(self.device).type == 'cuda':
            torch.cuda.synchronize()

    def _batch(self):
        b, o = self.traffic['batch'], self.offsets[self.k]
        imgs = self.pool_img[o:o + b].to(self.device, non_blocking=True)
        segs = self.pool_seg[o:o + b].to(self.device, non_blocking=True)
        (img_lo, img_hi), (seg_hi, _) = self.transform(imgs, segs)
        mask = self.valid.to(self.device, non_blocking=True)
        if self.fault == 'half_batch':
            img_lo, img_hi, seg_hi, mask = img_lo[:b // 2], img_hi[:b // 2], seg_hi[:b // 2], mask[:b // 2]
        losses, pred, hists, acc = self.eval_step(self.model, img_lo, img_hi, seg_hi, mask)
        if self.fault == 'altered_answer':        # the first sample's class map, shifted
            pred = pred.clone()
            pred[0] = (pred[0] + 1) % self.cfg['num_classes']
        self.k += 1
        return o, losses['CE'], pred, hists, acc

    def window(self, seconds):
        """Batches until ``seconds`` have passed, then a sync; every window's
        tallies and kept batches are judged after the last."""
        tallies, kept = [], []
        self._sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds and self.k < len(self.offsets):
            k = self.k
            o, ce, pred, hists, acc = self._batch()
            tallies.append((o, ce, hists, acc))
            if (k + self.phase) % self.traffic['check_every'] == 0:
                kept.append((o, ce, pred, hists, acc))
        self._sync()
        window_s = time.perf_counter() - t0
        batches = len(tallies)
        images = batches * self.traffic['batch']
        self.tallies += [(o, float(ce), [h.cpu() for h in hists], [int(a) for a in acc])
                         for o, ce, hists, acc in tallies]
        self.kept += [(o, float(ce), pred, [h.cpu() for h in hists], [int(a) for a in acc])
                      for o, ce, pred, hists, acc in kept]
        return {'e2e': {self.e2e: images / window_s}, 'steps': batches, 'images': images,
                'window_s': window_s, 'attempted': batches, 'failed': 0}

    def release(self):
        del self.model, self.eval_step, self.transform

    def _labels(self, o):
        b = self.traffic['batch']
        segs = self.pool_seg[o:o + b].to(self.device)
        return augment.eval_labels(segs, self.cfg['output_hw'], self.cfg['label_map'])

    def readings(self, control=False):
        """Every batch: its labelled-pixel count and target areas against the
        reference's, and a finite CE.  Each kept batch: the widest gap by
        which a pixel's class lies below the reference's best logit, the CE
        against the reference's, and its areas and counts against the
        reference's tallies of its own class map."""
        cfg, b, nc = self.cfg, self.traffic['batch'], self.cfg['num_classes']
        failed = 0
        targets = {}
        for o, ce, hists, acc in self.tallies:
            if o not in targets:
                lab = self._labels(o)
                targets[o] = (tallies(torch.zeros_like(lab), lab, nc)[0][2].cpu(), int((lab != 255).sum()))
            area_target, labelled = targets[o]
            failed += not (math.isfinite(ce) and acc[1] == labelled
                           and torch.equal(hists[2], area_target))
        self.failed = failed
        arch = find(cfg)
        with torch.device(self.device):
            ref = arch.reference(cfg)
        load_into(ref, make_state(cfg, seeds.subseed(self.seed, seeds.WEIGHTS), self.device)).eval()
        prog = {'class_gap': 0.0, 'ce_gap': 0.0, 'count_gap': float(failed)}
        ctl = {'class_gap': 0.0, 'ce_gap': 0.0, 'count_gap': 0.0}
        for o, ce, pred, hists, acc in self.kept:
            lab = self._labels(o)
            imgs = self.pool_img[o:o + b].to(self.device)
            with torch.no_grad():
                x = augment.resize(augment.normalise(imgs, cfg['mean'], cfg['std']), cfg['input_hw'])
                logits = arch.logits(ref(x))
                ref_ce = float(cross_entropy(logits, lab)[0])
                _merge(prog, _judge(logits, lab, pred, ce, hists, acc, ref_ce, nc))
                if control:
                    with tf32():
                        c_logits = arch.logits(ref(x))
                    c_pred = c_logits.argmax(1).to(torch.uint8)
                    c_areas, c_acc = tallies(c_pred, lab, nc)
                    _merge(ctl, _judge(logits, lab, c_pred, float(cross_entropy(c_logits, lab)[0]),
                                       [a.cpu() for a in c_areas], list(c_acc), ref_ce, nc))
                    del c_logits
            del logits
        prog['checked_batches'] = len(self.kept)
        return [prog, ctl] if control else [prog]


def _judge(logits, labels, pred, ce, hists, acc, ref_ce, nc):
    if pred.shape != labels.shape:
        return {'class_gap': NO_ANSWER, 'ce_gap': NO_ANSWER, 'count_gap': NO_ANSWER}
    best = logits.max(1).values
    picked = logits.gather(1, pred.long().clamp(max=nc - 1).unsqueeze(1)).squeeze(1)
    gap = float((best - picked).max()) if int(pred.max()) < nc else NO_ANSWER
    areas, counts = tallies(pred, labels, nc)
    count_gap = sum(int((a.cpu() - h).abs().sum()) for a, h in zip(areas, hists)) \
        + abs(counts[0] - acc[0]) + abs(counts[1] - acc[1])
    return {'class_gap': gap, 'ce_gap': rel_gap(ce, ref_ce), 'count_gap': float(count_gap)}


def _merge(into, numbers):
    for k, v in numbers.items():
        into[k] = max(into[k], v)
