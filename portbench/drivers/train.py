"""The train traffic: a closed loop of the program's train steps.

Each step is what ``commands/train_or_resume.py::_train_epoch`` runs: a
pinned uint8 batch copied to the card without blocking, the warp
(``data.augment.make_warp_transform``), then the step of
``train.steps.make_train_step`` with the device photometric tail
(``data.augment.make_device_post_fn``) as its ``post_fn``; the losses are
read one step late.  Batches are consecutive frames of a seeded pool; the
first ``checked_steps`` take disjoint frames.

Set-up builds the model and its optimizer once, loads the seeded weights,
and drives that same step object through its first ``checked_steps``
steps (which the reference follows after the window) and
``warm_steps`` more; the window then runs on from there.
"""

import time

import torch

from .. import seeds
from ..inputs import frame_pool
from ..models import find
from ..reference import train as reference_train
from ..weights import load_into, make_state, reference_on_meta
from .common import Phases, norms, port, port_model, rel_gap, worst_leaf_gaps

FAULTS = ('half_batch', 'frozen_state')


class Driver:
    e2e = 'train_img_per_s'

    def __init__(self, cfg, traffic, seed, device, fault=None, cell_spec=None):
        if fault not in (None,) + FAULTS:
            raise ValueError("unknown fault {!r}".format(fault))
        self.cfg, self.traffic, self.seed, self.device, self.fault = cfg, traffic, seed, device, fault
        self.cell_spec = cell_spec or {}

    def setup(self):
        cfg, tr, dev = self.cfg, self.traffic, self.device
        P = port()
        phases = Phases()
        b, n = tr['batch'], tr['pool_frames']
        model = port_model(cfg)
        phases.mark('program')
        self.model = load_into(model, make_state(cfg, seeds.subseed(self.seed, seeds.WEIGHTS), dev))
        phases.mark('weights')
        self.optimizer = P.train.make_sgd(self.model, tr['lr'], tr['momentum'], tr['weight_decay'])
        aug = P.data.AugmentConfig(input_hw=tuple(cfg['input_hw']), output_hw=tuple(cfg['output_hw']),
                                   mean=tuple(cfg['mean']), std=tuple(cfg['std']), ignore_label=255,
                                   **{k: (tuple(v) if isinstance(v, list) else v)
                                      for k, v in cfg['augment'].items()})
        lut = torch.tensor(cfg['label_map'], dtype=torch.uint8).numpy()
        self.run = {'warp_seed': seeds.subseed(self.seed, seeds.WARP),
                    'photometric_seed': seeds.subseed(self.seed, seeds.PHOTOMETRIC),
                    'dropout_seed': seeds.subseed(self.seed, seeds.DROPOUT)}
        self.warp = P.data.make_warp_transform(aug, lut, self.run['warp_seed'])
        post = P.data.make_device_post_fn(aug, torch.float32,
                                          unshuffle_hi=8 if cfg['stage'] > 1 else 0)
        w1, w2 = cfg['loss_weights']
        self.step_fn = P.train.make_train_step(self.model, self.optimizer, cfg['stage'], w1, w2, 255,
                                               post_fn=post)
        phases.mark('step')
        pool_img, pool_seg = frame_pool(self.seed, n, tr['frame_hw'], dev,
                                        label_block=tr['label_block'])
        phases.mark('pool')
        order = seeds.rng(self.seed, seeds.ORDER)
        checked = tr['checked_steps']
        offsets = [(k * b) % (n - b + 1) for k in range(checked)]
        offsets += order.integers(0, n - b + 1, size=tr['max_steps']).tolist()
        self.run.update(pool_img=pool_img, pool_seg=pool_seg, offsets=offsets)
        self.generator = torch.Generator(device=dev).manual_seed(self.run['photometric_seed'])
        self.k = 0
        # The checked steps: the reference follows them after the window.
        params = [p for _, p in self.model.named_parameters()]
        p0 = [p.detach().clone() for p in params]
        reference_train.seed_dropout(dev, self.run['dropout_seed'])
        losses = []
        for _ in range(checked):
            losses.append(self._step())
            if self.k == 1:
                bufs = [self.optimizer.state[p]['momentum_buffer'] for p in params]
                self.grad_norms = norms([u - tr['weight_decay'] * q for u, q in zip(bufs, p0)])
        with torch.no_grad():
            self.update_norms = norms([p - q for p, q in zip(params, p0)])
        del p0
        self.losses = [{t: float(v) for t, v in l.items() if t != 'Total'} for l in losses]
        phases.mark('checked_steps')
        for _ in range(tr['warm_steps']):
            _finite(self._step())          # the window's own check, warmed too
        self._sync()
        self.phases = phases.mark('warm_steps')

    def _sync(self):
        if torch.device(self.device).type == 'cuda':
            torch.cuda.synchronize()

    def _step(self):
        b, o = self.traffic['batch'], self.run['offsets'][self.k]
        imgs = self.run['pool_img'][o:o + b].to(self.device, non_blocking=True)
        segs = self.run['pool_seg'][o:o + b].to(self.device, non_blocking=True)
        imgs_w, segs_w = self.warp(0, self.k, imgs, segs)
        if self.fault == 'half_batch':
            imgs_w, segs_w = imgs_w[:b // 2], segs_w[:b // 2]
        if self.fault == 'frozen_state':
            saved = [p.detach().clone() for p in self.model.parameters()]
        losses = self.step_fn(imgs_w, segs_w, self.traffic['lr'], self.generator)
        if self.fault == 'frozen_state':
            with torch.no_grad():
                for p, q in zip(self.model.parameters(), saved):
                    p.copy_(q)
        self.k += 1
        return losses

    def window(self, seconds):
        """Steps until ``seconds`` have passed, then a sync: the window."""
        steps = failed = 0
        pending = None
        self._sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds and self.k < len(self.run['offsets']):
            losses = self._step()
            if pending is not None:
                failed += not _finite(pending)
            pending = losses
            steps += 1
        if pending is not None:
            failed += not _finite(pending)
        self._sync()
        window_s = time.perf_counter() - t0
        b = self.traffic['batch']
        return {'e2e': {self.e2e: steps * b / window_s}, 'steps': steps, 'images': steps * b,
                'window_s': window_s, 'attempted': steps, 'failed': failed}

    def release(self):
        del self.model, self.optimizer, self.step_fn, self.warp

    def readings(self, control=False):
        """The reference's first steps on the same weights and inputs, and the
        numbers that compare the program's (or, with ``control``, the
        reference's in TF32) with them."""
        state = make_state(self.cfg, seeds.subseed(self.seed, seeds.WEIGHTS), self.device)
        arch = find(self.cfg)
        ref = reference_train.follow(self.cfg, self.traffic, self.run, state, self.device, arch,
                                     self.traffic['checked_steps'])
        names = [n for n, _ in reference_on_meta(self.cfg).named_parameters()]
        out = [self._numbers(ref, self.losses, self.grad_norms, self.update_norms, names)]
        if control:
            with tf32():
                ctl = reference_train.follow(self.cfg, self.traffic, self.run, state, self.device,
                                             arch, self.traffic['checked_steps'])
            out.append(self._numbers(ref, ctl['losses'], ctl['grad_norms'], ctl['update_norms'],
                                     names))
        return out

    def _numbers(self, ref, losses, grad_norms, update_norms, names):
        """The numbers compared: each step's loss terms against the
        reference's (a term the cell lists in ``first_step_terms`` only at
        the first step; its later steps are reported beside), and the
        worst leaf's first-gradient and update norms."""
        first_only = set(self.cell_spec.get('first_step_terms', ()))
        gaps = [{t: rel_gap(l[t], r[t]) for t in r} for l, r in zip(losses, ref['losses'])]
        compared = [g for k, step in enumerate(gaps) for t, g in step.items()
                    if k == 0 or t not in first_only]
        grad_gap, update_gap, kept, (wg, wu) = worst_leaf_gaps(ref['grad_norms'], grad_norms,
                                                               ref['update_norms'], update_norms)
        return {'loss_gap': max(compared), 'grad_gap': grad_gap, 'update_gap': update_gap,
                'leaves': kept, 'loss_gaps_by_step': gaps, 'worst_grad_leaf': names[wg],
                'worst_update_leaf': names[wu]}


def _finite(losses):
    return bool(torch.isfinite(torch.stack(list(losses.values()))).all())


class tf32:
    """TF32 on for cuDNN and matmuls inside, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved
