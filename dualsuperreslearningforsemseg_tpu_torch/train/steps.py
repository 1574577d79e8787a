"""The train and evaluation steps of stages 1, 2 and 3.

Both are the JAX package's steps (train/steps.py) on their default fused
paths: the model runs up to the pre-final-ConvT activation
(``pre_tail=True``) and one fused pass computes the final ConvT and what
follows without writing the logits.  Inputs are the JAX steps': NHWC
images and (B, H, W) labels.  The loss is ``CE + w1 * MSE + w2 * FA``
(steps.py:211-213 there), the MSE from stage 2 and the FA from stage 3.

* ``make_train_step`` (steps.py:55-249 there): forward, the final ConvT +
  masked CE through kernel K1 (ops/fused_tail.py; its backward kernel is the
  ConvT's and the CE's gradient), the MSE of the pre-shuffle SISR output
  against the pixel-unshuffled target, the FA loss of the two transformer
  outputs through kernel K4 (losses/fa.py, ops/fa_pairwise.py; forward and
  backward), backward, SGD.  With the device photometric tail
  (data/augment.py, kernel K2) it takes the warped uint8 batch, as the JAX
  step with ``post_fn`` does, and at stages 2-3 K2 writes the unshuffled
  target itself.
* ``make_eval_step`` (steps.py:252-503 there): the eval tail
  (ops/eval_tail.py, kernel K3) computes the CE, the class map and every
  metric count; the MSE and the FA are taken per sample and weighted by the
  sample mask (``_aux_losses``, ``_fa_masked`` there), the FA from one K4
  launch whose rows are the samples.

On the card the kernels run; on the CPU their plain versions.
"""

import contextlib

import torch
import torch.nn.functional as F

from ..losses import fa_loss, fa_loss_per_sample, mse_loss
from ..models.dsrl import SISR_UPSCALE, freeze_batch_norms
from ..ops.eval_tail import eval_tail
from ..ops.fused_tail import fused_convt2_ce_mean


def _sisr_target(img_hi, unshuffled: bool):
    """The SISR target in the pre-shuffle layout (B, 192, OH/8, OW/8): an
    NCHW view of K2's unshuffled output, else the unshuffled (B, OH, OW, 3)
    image."""
    hi = img_hi.permute(0, 3, 1, 2)
    return hi if unshuffled else F.pixel_unshuffle(hi, SISR_UPSCALE)


def _check_stage(model, stage):
    if getattr(model, 'stage', None) != stage:
        raise ValueError("the step is for stage {}, the model is stage {}".format(
            stage, getattr(model, 'stage', None)))


def make_train_step(model, optimizer, stage: int, w1: float, w2: float, ignore_label: int = 255,
                    freeze_batch_norm: bool = False, post_fn=None, amp_dtype=None):
    """Returns fn(img_lo (B, H, W, 3), img_hi (B, 2H, 2W, 3), seg (B, 2H, 2W),
    lr) -> losses, or with ``post_fn`` (data/augment.py::make_device_post_fn)
    fn(imgs_w_u8 (B, 2H, 2W, 3), segs_w_u8 (B, 2H, 2W), lr, generator) ->
    losses, where ``generator`` (on the images' device) draws the
    photometric parameters; a ``post_fn`` with ``unshuffled_hi_factor`` 8
    hands over img_hi already unshuffled.

    One call: the model of ``stage`` in train mode (every BatchNorm in eval
    mode under ``freeze_batch_norm``), ``model(x, pre_tail=True)``, the
    fused ConvT + CE (K1) on the final ConvT's own parameters, ``w1`` times
    the MSE (stage >= 2) and ``w2`` times the FA loss (stage 3), backward of
    their sum, and one step of ``optimizer`` at learning rate ``lr``.
    ``amp_dtype`` (torch.bfloat16 for ``--mixed-precision``) runs the
    forward under autocast with float32 parameters; K1 then receives the
    bfloat16 activation, the MSE subtracts in bfloat16, and the FA loss
    still runs in float32.  ``losses`` is ``{'CE', 'MSE', 'FA', 'Total'}``,
    float32 scalars on the device (the terms a stage lacks are 0); nothing
    syncs to the host.
    """
    _check_stage(model, stage)
    hi_unshuffled = getattr(post_fn, 'unshuffled_hi_factor', 0) if post_fn is not None else 0
    if hi_unshuffled not in (0, SISR_UPSCALE):
        raise ValueError("img_hi can arrive unshuffled by {} only, got {}".format(
            SISR_UPSCALE, hi_unshuffled))
    tail = model.SSSR_decoder.upsample16_pred[6]

    def step(img_lo, img_hi, seg, lr, unshuffled):
        model.train()
        if freeze_batch_norm:
            freeze_batch_norms(model)
        for group in optimizer.param_groups:
            group['lr'] = lr
        x = img_lo.permute(0, 3, 1, 2).contiguous()
        with (torch.autocast(x.device.type, dtype=amp_dtype) if amp_dtype is not None
              else contextlib.nullcontext()):
            sssr, sisr, sssr_t, sisr_t = model(x, pre_tail=True)
        ce = fused_convt2_ce_mean(sssr.contiguous(), tail.weight, tail.bias,
                                  seg.to(torch.uint8).contiguous(), ignore_label)
        zero = torch.zeros((), device=ce.device)
        mse = w1 * mse_loss(sisr, _sisr_target(img_hi, unshuffled)) if stage > 1 else zero
        fa = w2 * fa_loss(sssr_t, sisr_t) if stage > 2 else zero
        total = ce + mse + fa
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        optimizer.step()
        return {'CE': ce.detach(), 'MSE': mse.detach(), 'FA': fa.detach(), 'Total': total.detach()}

    if post_fn is None:
        def train_core(img_lo, img_hi, seg, lr):
            return step(img_lo, img_hi, seg, lr, False)

        return train_core

    def fused_step(imgs_w_u8, segs_w_u8, lr, generator):
        (img_lo, img_hi), (seg_hi, _) = post_fn(imgs_w_u8, segs_w_u8, generator)
        return step(img_lo, img_hi, seg_hi, lr, bool(hi_unshuffled))

    return fused_step


def make_eval_step(num_classes: int, ignore_label: int = 255, stage: int = 1, w1: float = 0.0,
                   w2: float = 0.0):
    """Returns fn(model, img_lo, img_hi, seg, sample_mask) ->
    (losses, pred, (area_pred, area_inter, area_target), (correct, valid)).

    ``img_lo`` is the (B, H, W, 3) network input and ``img_hi`` the
    (B, 2H, 2W, 3) SISR target (unused at stage 1).  ``seg`` holds
    (B, 2H, 2W) labels in [0, 256); ``sample_mask`` ((B,), 1 = real sample)
    turns a padded sample's labels to ignore and gives its MSE and FA weight
    0, so it adds nothing to any loss or count.  ``pred`` is the (B, 2H, 2W)
    uint8 class map; losses are float32 scalars (the terms the stage lacks
    are 0), counts int64.  The caller puts the model (of ``stage``) in eval
    mode.
    """
    def eval_step(model, img_lo, img_hi, seg, sample_mask):
        _check_stage(model, stage)
        tail = model.SSSR_decoder.upsample16_pred[6]
        if tail.out_channels != num_classes:
            raise ValueError("model has {} classes, the step {}".format(tail.out_channels, num_classes))
        with torch.inference_mode():
            mask = sample_mask.to(seg.device).float()
            seg = torch.where(mask.reshape(-1, 1, 1) > 0, seg.to(torch.uint8), ignore_label)
            x = img_lo.permute(0, 3, 1, 2).contiguous()
            sssr, sisr, sssr_t, sisr_t = model(x, pre_tail=True)
            pred, ce_sum, areas, (correct, valid) = eval_tail(
                sssr, tail.weight, tail.bias, seg.contiguous(), ignore_label)
            ce = torch.where(valid > 0, ce_sum / valid.clamp(min=1), 0.0).float()
            mse = fa = torch.zeros((), device=ce.device)
            n_real = mask.sum().clamp(min=1)
            if stage > 1:
                diff = sisr.float() - _sisr_target(img_hi, False).float()
                mse = w1 * ((diff * diff).mean((1, 2, 3)) * mask).sum() / n_real
            if stage > 2:
                fa = w2 * (fa_loss_per_sample(sssr_t, sisr_t) * mask).sum() / n_real
            losses = {'CE': ce, 'MSE': mse, 'FA': fa, 'Total': ce + mse + fa}
        return losses, pred, areas, (correct, valid)

    return eval_step
