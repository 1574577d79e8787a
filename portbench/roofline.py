"""The yardstick's arithmetic: the card's published peaks, the least time
of each hand-written kernel's work from its shapes, and a step's model
FLOPs counted on the plain reference.

Peaks are NVIDIA's data-sheet figures for one H100 SXM (dense, at the
full 700 W): HBM3 at 3.35 TB/s, 67 TFLOP/s float32 on the CUDA cores,
495 TFLOP/s TF32 and 989 TFLOP/s bfloat16 on the tensor cores.

A kernel's bound is the larger of its bytes over the memory rate (each
input byte read once, each output byte written once) and its operations
over the compute rate: the 19x19 class products at the TF32 rate over
three passes for float32 (3xTF32 keeps float32 accuracy) or at the
bfloat16 rate, and every other operation at the float32 rate.
"""

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
PEAK_TF32_OPS_PER_S = 495e12
PEAK_BF16_OPS_PER_S = 989e12
# The whole step's share is taken of the dense bfloat16 peak: the highest
# rate at which the card could run this model's products, so no faster
# kernel or precision a later change brings can pass it.
STEP_PEAK_OPS_PER_S = PEAK_BF16_OPS_PER_S


def tail_work(out_pixels, classes, products, elementwise):
    """(tensor-core flops, float32 operations) of a tail kernel: ``products``
    CxC products and ``elementwise`` operations per class of each output
    pixel."""
    return out_pixels * products * 2 * classes * classes, out_pixels * elementwise * classes


def bound_s(nbytes, ops, mma_flops=0, bf16=False):
    """The least seconds of a kernel's work on the published peaks."""
    t_ops = ops / PEAK_FP32_OPS_PER_S
    if mma_flops:
        t_ops = max(t_ops, mma_flops / PEAK_BF16_OPS_PER_S if bf16
                    else 3 * mma_flops / PEAK_TF32_OPS_PER_S)
    return max(nbytes / PEAK_BYTES_PER_S, t_ops)


def k1_bound_s(batch, out_hw, classes, bf16=False):
    """K1, the final ConvT(2, 2) + masked CE: forward plus backward of one
    train step.  The forward reads the pre-tail activation (B, C, OH/2,
    OW/2), the labels and the parameters; the backward reads them again and
    writes dX and the parameter gradients."""
    out_pixels = batch * out_hw[0] * out_hw[1]
    xb = out_pixels // 4 * classes * (2 if bf16 else 4)
    params = (classes * classes * 4 + classes) * 4
    fwd = bound_s(xb + out_pixels + params + 16,
                  tail_work(out_pixels, classes, 1, 6)[1], tail_work(out_pixels, classes, 1, 6)[0], bf16)
    bwd = bound_s(2 * xb + out_pixels + 2 * params + 4,
                  tail_work(out_pixels, classes, 3, 9)[1], tail_work(out_pixels, classes, 3, 9)[0], bf16)
    return fwd + bwd


def k3_bound_s(batch, out_hw, classes, bf16=False):
    """K3, the eval tail: reads the activation, labels and parameters,
    writes the uint8 class map, the CE and the 3C + 2 counts."""
    out_pixels = batch * out_hw[0] * out_hw[1]
    xb = out_pixels // 4 * classes * (2 if bf16 else 4)
    nbytes = xb + 2 * out_pixels + (classes * classes * 4 + classes) * 4 + (3 * classes + 2) * 8
    mma, ops = tail_work(out_pixels, classes, 1, 6)
    return bound_s(nbytes, ops, mma, bf16)


def conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation,
                        transposed, _output_padding, _groups, output_mask, out_shape=None, **_):
    """A convolution's backward: each gradient asked for costs what its
    forward costs, 2 x batch x the spatial points it slides over x the
    weight's elements.  (torch's own formula counts a grouped convolution's
    weight gradient as if every input channel met every output channel.)"""
    points = (x_shape if transposed else grad_out_shape)[2:]
    fwd = 2 * x_shape[0] * math.prod(points) * math.prod(w_shape)
    return fwd * (int(output_mask[0]) + int(output_mask[1]))


def model_flops(cfg, batch, train):
    """FLOPs of one step of the plain reference at the cell's shapes, counted
    by ``FlopCounterMode`` on the meta device: the forward, and for
    training the backward of its model module's loss terms too."""
    from .models import find
    from .weights import reference_on_meta
    arch = find(cfg)
    model = reference_on_meta(cfg)
    model.train(train)
    with torch.device('meta'):
        x = torch.empty(batch, 3, *cfg['input_hw'])
        labels = torch.zeros(batch, *cfg['output_hw'], dtype=torch.uint8)
        target = torch.empty(batch, 3, *cfg['output_hw'])
    counter = FlopCounterMode(display=False,
                              custom_mapping={torch.ops.aten.convolution_backward: conv_backward_flops})
    with counter, torch.set_grad_enabled(train):
        outputs = model(x)
        if train:
            sum(arch.terms(cfg, outputs, target, labels).values()).backward()
    return counter.get_total_flops()
