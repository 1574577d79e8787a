"""Weight initialisation matching the reference's recipe.

The reference Kaiming-normal-initialises every Conv2d/ConvTranspose2d with
``mode='fan_out', nonlinearity='relu'`` and leaves conv biases at torch's
default U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (reference models/DSRL.py:143-151,
models/modules/backbone/ResNet101.py:44-55).  torch's own fan rules give
both for conv (OIHW) and transposed-conv (IOHW) weights alike: for the
latter fan_out reads dim 0 (I*kh*kw) and the bias's fan_in dim 1 (O*kh*kw),
as the JAX package's ``models/init.py`` spells out.

BatchNorm starts at weight 1, bias 0, except the last BN of every bottleneck
when ``zero_init_last_bn`` (the JAX package's default, models/resnet.py).
Every draw comes from the ``torch.Generator`` passed in, so a seed fixes the
weights.  Only weights made from a seed need this; loaded weights replace it.
"""

import math
import os.path

import torch
from torch import nn

from ..utils import CAUTION, INFO


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator,
                 zero_init_last_bn: bool = True) -> nn.Module:
    for name, module in model.named_modules():
        if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
            nn.init.kaiming_normal_(module.weight, mode='fan_out',
                                    nonlinearity='relu', generator=generator)
            if module.bias is not None:
                fan_in = module.weight.shape[1] * module.weight[0, 0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                nn.init.uniform_(module.bias, -bound, bound, generator=generator)
        elif isinstance(module, nn.BatchNorm2d):
            last_bn = zero_init_last_bn and name.endswith('.bn3')
            nn.init.constant_(module.weight, 0.0 if last_bn else 1.0)
            nn.init.zeros_(module.bias)
            module.reset_running_stats()
    return model


def load_pretrained_backbone(model: nn.Module, weights_dir: str) -> bool:
    """Loads the torchvision ResNet-101 zoo weights
    ``<weights_dir>/resnet101_pretrained.pth`` into the backbone when the file
    exists (JAX package commands/train_or_resume.py:60-87): ``fc.*`` dropped,
    every key prefixed ``feature_extractor.backbone.``, and no backbone key
    may be missing.  Without the file the seeded Kaiming init stays; the port
    never downloads.  Returns whether the weights were loaded."""
    from ..checkpoint import load_checkpoint_or_weights
    from .state_dict import load_state_dict
    path = os.path.join(weights_dir, 'resnet101_pretrained.pth')
    if not os.path.isfile(path):
        print(CAUTION("Pretrained ResNet101 weights unavailable ('{}' not found; nothing is "
                      "downloaded); the backbone keeps its Kaiming initialization.".format(path)))
        return False
    zoo = load_checkpoint_or_weights(path)
    prefixed = {'feature_extractor.backbone.' + k: v for k, v in zoo.items()
                if not k.startswith('fc.')}
    missing, _ = load_state_dict(model, prefixed, strict=False)
    backbone_missing = [k for k in missing if k.startswith('feature_extractor.backbone.')
                        and not k.endswith('num_batches_tracked')]
    assert not backbone_missing, \
        "BUG CHECK: Pretrained weights from model zoo for ResNet101 has missing keys: {}.".format(backbone_missing)
    print(INFO("Pretrained ResNet101 weights loaded from '{}'.".format(path)))
    return True
