"""Run-to-run determinism of the port's train step: the counterpart of the
JAX package's tests/test_determinism.py, which guarantees bitwise-identical
steps for the same keys.

One step of ``make_train_step`` (with the photometric tail, K2's plain
version on the CPU, and live dropout and BatchNorm) runs twice from the same
model, optimizer, photometric generator and global RNG state: the losses
and every tensor of the model's state must be bitwise equal.  A warm-up step
comes first, so that the momentum buffers exist and, on the card, cuDNN's
autotuner has chosen its algorithms.  ``repeated_step`` is shared with the
card's case in tests/test_torch_cuda.py.
"""

import copy

import numpy as np
import pytest
import torch

from dualsuperreslearningforsemseg_tpu_torch.data import AugmentConfig, make_device_post_fn
from dualsuperreslearningforsemseg_tpu_torch.datasets import cityscapes
from dualsuperreslearningforsemseg_tpu_torch.models import DSRL, init_weights
from dualsuperreslearningforsemseg_tpu_torch.models.dsrl import SISR_UPSCALE
from dualsuperreslearningforsemseg_tpu_torch.train import make_sgd, make_train_step

LAYERS = (1, 1, 2, 1)
HW, OHW = (64, 128), (128, 256)
LR = 0.01


def _rng_state(device):
    return torch.cuda.get_rng_state(device) if device.type == 'cuda' else torch.get_rng_state()


def _set_rng_state(device, state):
    if device.type == 'cuda':
        torch.cuda.set_rng_state(state, device)
    else:
        torch.set_rng_state(state)


def repeated_step(device, stage=1, batch=2, seed=54321):
    """Two runs of one train step from one saved state on ``device``;
    returns [(losses, state_dict)] * 2 on the CPU and the state before."""
    torch.manual_seed(seed)
    model = init_weights(DSRL(num_classes=19, stage=stage, backbone_layers=LAYERS),
                         torch.Generator().manual_seed(seed)).to(device)
    optimizer = make_sgd(model, LR, 0.9, 5e-4)
    cfg = AugmentConfig(input_hw=HW, output_hw=OHW, mean=cityscapes.MEAN, std=cityscapes.STD)
    post = make_device_post_fn(cfg, unshuffle_hi=SISR_UPSCALE if stage > 1 else 0)
    step = make_train_step(model, optimizer, stage, 0.1, 1.0, 255, False, post_fn=post)
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(rng.integers(0, 256, size=(batch, *OHW, 3), dtype=np.uint8)).to(device)
    segs = rng.integers(0, 19, size=(batch, *OHW)).astype(np.uint8)
    segs[:, :8, :8] = 255
    segs = torch.from_numpy(segs).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    step(imgs, segs, LR, gen)
    saved = (copy.deepcopy(model.state_dict()), copy.deepcopy(optimizer.state_dict()),
             gen.get_state(), _rng_state(device))
    runs = []
    for _ in range(2):
        model.load_state_dict(saved[0])
        optimizer.load_state_dict(copy.deepcopy(saved[1]))   # it keeps the tensors it is given
        gen.set_state(saved[2])
        _set_rng_state(device, saved[3])
        losses = step(imgs, segs, LR, gen)
        runs.append(({k: v.detach().cpu() for k, v in losses.items()},
                     {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}))
    return runs, {k: v.cpu() for k, v in saved[0].items()}


def assert_bitwise_equal(runs, before):
    """Both runs' losses and state tensors equal bit for bit; the step
    moved the parameters."""
    (losses_a, state_a), (losses_b, state_b) = runs
    assert set(losses_a) == set(losses_b) and np.isfinite(float(losses_a['Total']))
    differ = [k for k in losses_a if not torch.equal(losses_a[k], losses_b[k])]
    differ += [k for k in state_a if not torch.equal(state_a[k], state_b[k])]
    assert not differ, "not bitwise equal across two runs: {}".format(differ)
    assert any(not torch.equal(state_a[k], before[k]) for k in before if k.endswith('weight'))


@pytest.mark.parametrize('stage', [1, 3])
def test_train_step_is_bitwise_deterministic_on_cpu(stage):
    assert_bitwise_equal(*repeated_step(torch.device('cpu'), stage))
