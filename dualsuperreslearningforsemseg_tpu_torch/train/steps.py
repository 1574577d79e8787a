"""The stage-1 train and evaluation steps.

Both are the JAX package's steps (train/steps.py) on their default fused
paths: the model runs up to the pre-final-ConvT activation
(``pre_tail=True``) and one fused pass computes the final ConvT and what
follows without writing the logits.  Inputs are the JAX steps': NHWC
images and (B, H, W) labels.

* ``make_train_step`` (steps.py:55-249 there): forward, the final ConvT +
  masked CE through kernel K1 (ops/fused_tail.py; its backward kernel is the
  ConvT's and the CE's gradient), backward, SGD.  With the device
  photometric tail (data/augment.py, kernel K2) it takes the warped uint8
  batch, as the JAX step with ``post_fn`` does.
* ``make_eval_step`` (steps.py:252-503 there): the eval tail
  (ops/eval_tail.py, kernel K3) computes the CE, the class map and every
  metric count.

On the card the kernels run; on the CPU their plain versions.
"""

import contextlib

import torch

from ..models.dsrl import freeze_batch_norms
from ..ops.eval_tail import eval_tail
from ..ops.fused_tail import fused_convt2_ce_mean


def make_train_step(model, optimizer, stage: int, ignore_label: int = 255,
                    freeze_batch_norm: bool = False, post_fn=None, amp_dtype=None):
    """Returns fn(img_lo (B, H, W, 3), img_hi, seg (B, 2H, 2W), lr) -> losses,
    or with ``post_fn`` (data/augment.py::make_device_post_fn)
    fn(imgs_w_u8 (B, 2H, 2W, 3), segs_w_u8 (B, 2H, 2W), lr, generator) ->
    losses, where ``generator`` (on the images' device) draws the
    photometric parameters.

    One call: the model in train mode (every BatchNorm in eval mode under
    ``freeze_batch_norm``), ``model(x, pre_tail=True)``, the fused ConvT + CE
    (K1) on the final ConvT's own parameters, backward, and one step of
    ``optimizer`` at learning rate ``lr``.  ``amp_dtype`` (torch.bfloat16
    for ``--mixed-precision``) runs the forward under autocast with float32
    parameters; K1 then receives the bfloat16 activation.  ``losses`` is
    ``{'CE', 'MSE', 'FA', 'Total'}``, float32 scalars on the device (MSE and
    FA are 0 at stage 1); nothing syncs to the host.  ``img_hi`` (the SISR
    target) is unused at stage 1.
    """
    if stage != 1:
        raise NotImplementedError("stage {} training is not ported yet (ROADMAP.md queue 1, "
                                  "the stages 2-3 slice).".format(stage))
    tail = model.SSSR_decoder.upsample16_pred[6]

    def train_core(img_lo, img_hi, seg, lr):
        model.train()
        if freeze_batch_norm:
            freeze_batch_norms(model)
        for group in optimizer.param_groups:
            group['lr'] = lr
        x = img_lo.permute(0, 3, 1, 2).contiguous()
        with (torch.autocast(x.device.type, dtype=amp_dtype) if amp_dtype is not None
              else contextlib.nullcontext()):
            y = model(x, pre_tail=True)
        ce = fused_convt2_ce_mean(y.contiguous(), tail.weight, tail.bias,
                                  seg.to(torch.uint8).contiguous(), ignore_label)
        optimizer.zero_grad(set_to_none=True)
        ce.backward()
        optimizer.step()
        ce = ce.detach()
        zero = torch.zeros((), device=ce.device)
        return {'CE': ce, 'MSE': zero, 'FA': zero, 'Total': ce}

    if post_fn is None:
        return train_core

    def fused_step(imgs_w_u8, segs_w_u8, lr, generator):
        (img_lo, img_hi), (seg_hi, _) = post_fn(imgs_w_u8, segs_w_u8, generator)
        return train_core(img_lo, img_hi, seg_hi, lr)

    return fused_step


def make_eval_step(num_classes: int, ignore_label: int = 255):
    """Returns fn(model, img_lo, img_hi, seg, sample_mask) ->
    (losses, pred, (area_pred, area_inter, area_target), (correct, valid)).

    ``img_lo`` is the (B, H, W, 3) network input; ``img_hi`` (the SISR
    target) is unused at stage 1 and kept for the JAX signature.  ``seg``
    holds (B, 2H, 2W) labels in [0, 256); ``sample_mask`` ((B,), 1 = real
    sample) turns a padded sample's labels to ignore, so it adds nothing to
    any loss or count.  ``pred`` is the (B, 2H, 2W) uint8 class map; losses
    are float32 scalars (MSE and FA are 0 at stage 1), counts int64.
    The caller puts the model in eval mode.
    """
    def eval_step(model, img_lo, img_hi, seg, sample_mask):
        tail = model.SSSR_decoder.upsample16_pred[6]
        if tail.out_channels != num_classes:
            raise ValueError("model has {} classes, the step {}".format(tail.out_channels, num_classes))
        with torch.inference_mode():
            keep = sample_mask.to(seg.device).reshape(-1, 1, 1) > 0
            seg = torch.where(keep, seg.to(torch.uint8), ignore_label)
            x = img_lo.permute(0, 3, 1, 2).contiguous()
            y = model(x, pre_tail=True)
            pred, ce_sum, areas, (correct, valid) = eval_tail(
                y, tail.weight, tail.bias, seg.contiguous(), ignore_label)
            ce = torch.where(valid > 0, ce_sum / valid.clamp(min=1), 0.0).float()
            zero = torch.zeros((), device=ce.device)
            losses = {'CE': ce, 'MSE': zero, 'FA': zero, 'Total': ce}
        return losses, pred, areas, (correct, valid)

    return eval_step
