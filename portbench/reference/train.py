"""The reference training steps: the first steps of a train cell followed on
the same seeded weights and inputs, the update written out by hand.

SGD as the recipe states it: g <- grad + wd * p; buf <- g on the first
step, m * buf + g after; p <- p - lr * buf, on every parameter.
"""

import numpy as np
import torch

from . import augment


def seed_dropout(device, seed):
    if torch.device(device).type == 'cuda':
        torch.cuda.manual_seed(seed)
    else:
        torch.manual_seed(seed)


def follow(cfg, traffic, run, state, device, arch, steps=3):
    """Runs ``steps`` reference steps of the model module ``arch``'s reference
    model and loss terms.  ``run`` holds the run's inputs:
    ``pool_img``/``pool_seg`` (host frames and label ids), ``offsets`` (the
    first frame of each step's batch), ``warp_seed``, ``photometric_seed``
    and ``dropout_seed``.  Returns {'losses': [{term: float}] a step,
    'grad_norms': the first step's gradient norm of each parameter,
    'update_norms': the norm of each parameter's change after the steps},
    the norms as float64 host tensors in ``named_parameters`` order."""
    aug, b = cfg['augment'], traffic['batch']
    out_hw, in_hw = tuple(cfg['output_hw']), tuple(cfg['input_hw'])
    with torch.device(device):
        model = arch.reference(cfg)
    model.load_state_dict(state)
    model.train()
    params = [p for _, p in model.named_parameters()]
    p0 = [p.detach().clone() for p in params]
    lr, m, wd = traffic['lr'], traffic['momentum'], traffic['weight_decay']
    gen = torch.Generator(device=device).manual_seed(run['photometric_seed'])
    seed_dropout(device, run['dropout_seed'])
    src_hw = tuple(run['pool_img'].shape[1:3])
    losses, bufs, grad_norms = [], None, None
    for k in range(steps):
        o = run['offsets'][k]
        imgs = run['pool_img'][o:o + b].to(device)
        segs = run['pool_seg'][o:o + b].to(device)
        rng = np.random.default_rng(np.random.SeedSequence([run['warp_seed'], 0, k]))
        mats = augment.affine_matrices(rng, b, src_hw, out_hw, aug)
        img_w, seg_w = augment.warp(imgs, segs, mats, out_hw, cfg['label_map'])
        taps, mix = augment.photometric_draws(gen, b, aug)
        hi = augment.photometric(img_w, taps, mix, cfg['mean'], cfg['std'])
        terms = arch.terms(cfg, model(augment.resize(hi, in_hw)), hi, seg_w)
        grads = torch.autograd.grad(sum(terms.values()), params)
        if k == 0:
            grad_norms = _norms(grads)
        with torch.no_grad():
            d = [g + wd * p for g, p in zip(grads, params)]
            bufs = d if bufs is None else [m * u + v for u, v in zip(bufs, d)]
            for p, u in zip(params, bufs):
                p.sub_(lr * u)
        losses.append({n: float(v.detach()) for n, v in terms.items()})
        del grads, d, terms
    with torch.no_grad():
        update_norms = _norms([p - q for p, q in zip(params, p0)])
    return {'losses': losses, 'grad_norms': grad_norms, 'update_norms': update_norms}


def _norms(tensors):
    return torch.stack([torch.linalg.vector_norm(t.double()) for t in tensors]).cpu()
