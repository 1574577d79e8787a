"""DSRL model, stage 1: shared encoder + SSSR decoder, NCHW.

The reference network (reference models/DSRL.py:11-186) as the JAX package's
``models/dsrl.py`` builds it for stage 1:

* feature extractor: ResNet-101 (output stride 16) -> ASPP -> bilinear x4
  (align_corners) -> concat with a 1x1+BN+ReLU shortcut of the low-level
  features -> (B, 304, H/4, W/4);
* SSSR decoder: two 3x3 Conv+BN+ReLU+Dropout(0.2) (304->256->256), a 1x1
  classifier to NUM_CLASSES, then the upsample tail ``upsample16_pred``:
  bilinear x2 + Dropout + ConvT(2,2)+BN+ReLU+Dropout + ConvT(2,2), a total
  x8 upsample to twice the network input size.

``forward(x, pre_tail=True)`` stops after ``upsample16_pred.5``: it returns
the (B, C, H, W) activation that the final ConvT (``upsample16_pred.6``)
would expand to the (B, C, 2H, 2W) logits, so the eval and train steps can
hand that ConvT to the fused tail kernels (ops/eval_tail.py,
ops/fused_tail.py) and never write the logits.  In train mode that
activation is the one after the last Dropout, as the JAX ``pre_tail``
returns it (models/dsrl.py:196-216 there).  ``nn.Dropout`` is the exact
dropout the JAX package's ``FastDropout`` approximates with u16 thresholds.  The SISR decoder and the FA transformers of stages 2 and 3 are not
built; their keys in a stage-2/3 file load as "unexpected" under
``strict=False``.

Attribute paths are the torch names the JAX package writes
(``feature_extractor.backbone.layer1.0.conv1.weight``,
``SSSR_decoder.cat_conv.0.weight``, ``SSSR_decoder.upsample16_pred.6.weight``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import ResNet101
from .aspp import ASPP


def _conv_bn_relu(in_channels, out_channels, kernel):
    return [nn.Conv2d(in_channels, out_channels, kernel, padding=kernel // 2, bias=False),
            nn.BatchNorm2d(out_channels), nn.ReLU(inplace=True)]


class FeatureExtractor(nn.Module):
    """backbone + aspp + shortcut -> concatenated decoder features."""

    def __init__(self, backbone_layers=(3, 4, 23, 3)):
        super().__init__()
        self.backbone = ResNet101(layers=backbone_layers)
        self.aspp = ASPP(2048, 256, rate=1)
        self.shortcut_conv = nn.Sequential(*_conv_bn_relu(256, 48, 1))

    def forward(self, x):
        backbone_features, lowlevel_features = self.backbone(x)
        aspp_features = self.aspp(backbone_features)
        h, w = aspp_features.shape[2:]
        aspp_features = F.interpolate(aspp_features, size=(4 * h, 4 * w),
                                      mode='bilinear', align_corners=True)
        return torch.cat([aspp_features, self.shortcut_conv(lowlevel_features)], dim=1)


class SSSRDecoder(nn.Module):
    def __init__(self, num_classes: int):
        super().__init__()
        self.cat_conv = nn.Sequential(
            *_conv_bn_relu(304, 256, 3), nn.Dropout(0.2),
            *_conv_bn_relu(256, 256, 3), nn.Dropout(0.2))
        self.cls_conv = nn.Conv2d(256, num_classes, 1, bias=True)
        self.upsample16_pred = nn.Sequential(
            nn.UpsamplingBilinear2d(scale_factor=2.0), nn.Dropout(0.2),
            nn.ConvTranspose2d(num_classes, num_classes, 2, stride=2, bias=False),
            nn.BatchNorm2d(num_classes), nn.ReLU(inplace=True), nn.Dropout(0.2),
            nn.ConvTranspose2d(num_classes, num_classes, 2, stride=2, bias=True))

    def forward(self, x, pre_tail: bool = False):
        y = self.cls_conv(self.cat_conv(x))
        if pre_tail:
            return self.upsample16_pred[:6](y)
        return self.upsample16_pred(y)


class DSRL(nn.Module):
    """Stage-1 DSRL: returns the SSSR logits (B, C, 2H, 2W), or with
    ``pre_tail`` the activation before the final ConvT (B, C, H, W)."""

    def __init__(self, num_classes: int, backbone_layers=None):
        super().__init__()
        from .. import settings
        self.feature_extractor = FeatureExtractor(
            tuple(backbone_layers or settings.BACKBONE_LAYERS))
        self.SSSR_decoder = SSSRDecoder(num_classes)

    def forward(self, x, pre_tail: bool = False):
        return self.SSSR_decoder(self.feature_extractor(x), pre_tail=pre_tail)


def freeze_batch_norms(model: nn.Module) -> nn.Module:
    """``--freeze-batch-norm``: every BatchNorm2d in eval mode, so it
    normalises with its running statistics and updates none of them, while
    its weight and bias still train (the JAX package's
    ``use_running_average`` under ``freeze_bn``, models/norm.py:97-98)."""
    for module in model.modules():
        if isinstance(module, nn.BatchNorm2d):
            module.eval()
    return model
