"""DSRL model: shared encoder + SSSR decoder (+ SISR decoder + FA
transformers), NCHW.

The reference network (reference models/DSRL.py:11-186) as the JAX package's
``models/dsrl.py`` builds it:

* feature extractor: ResNet-101 (output stride 16) -> ASPP -> bilinear x4
  (align_corners, as two products: ops/resize.py) -> concat with a
  1x1+BN+ReLU shortcut of the low-level features -> (B, 304, H/4, W/4);
* SSSR decoder: two 3x3 Conv+BN+ReLU+Dropout(0.2) (304->256->256), a 1x1
  classifier to NUM_CLASSES, then the upsample tail ``upsample16_pred``:
  bilinear x2 + Dropout + ConvT(2,2)+BN+ReLU+Dropout + ConvT(2,2), a total
  x8 upsample to twice the network input size;
* stage >= 2 adds the SISR decoder: a 3x3 conv (with bias) to 3*8^2
  channels + PixelShuffle(8);
* stage 3 adds the two feature transformers: a 1x1 conv with stride 8 to
  one channel (no bias) + BN + ReLU, on the SSSR logits and the SISR image,
  feeding the FA loss.

``forward`` returns ``(sssr, sisr, sssr_t, sisr_t)``, ``None`` for a branch
the stage does not build.  With ``pre_tail=True`` it stops before the two
full-resolution layers and returns what the train and eval steps hand to
their fused passes:

* ``sssr`` is the (B, C, H, W) activation after ``upsample16_pred.5`` that
  the final ConvT (``upsample16_pred.6``) would expand to the (B, C, 2H, 2W)
  logits (ops/eval_tail.py, ops/fused_tail.py), in train mode the one after
  the last Dropout, as the JAX ``pre_tail`` returns it;
* ``sisr`` is the pre-shuffle conv output (B, 192, H/4, W/4): channel
  c*64 + i*8 + j is full-resolution pixel (8h+i, 8w+j) of RGB channel c,
  so the MSE compares it with the pixel-unshuffled target;
* the transformers see the stride-8 samples of the full-resolution outputs
  without those outputs being made (the JAX grouped feed,
  models/dsrl.py:234-244, 321-334 there): logit pixel (8m, 8n) is the (0, 0)
  corner of the final ConvT at activation pixel (4m, 4n), i.e.
  ``einsum('bihw,io->bohw', y[:, :, ::4, ::4], W6[:, :, 0, 0]) + b6``, and
  SISR pixel (8m, 8n) is the pre-shuffle channels [0, 64, 128]; both
  transformers then run their conv at stride 1.

``nn.Dropout`` is the exact dropout the JAX package's ``FastDropout``
approximates with u16 thresholds.  Attribute paths are the torch names the
JAX package writes (``feature_extractor.backbone.layer1.0.conv1.weight``,
``SSSR_decoder.upsample16_pred.6.weight``, ``SISR_decoder.0.bias``,
``SSSR_feature_transformer.1.running_var``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..consts import NUM_RGB_CHANNELS
from ..ops.resize import resize_bilinear_matmul
from .resnet import ResNet101
from .aspp import ASPP

SISR_UPSCALE = 8


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
        aspp_features = resize_bilinear_matmul(aspp_features, (4 * h, 4 * w))
        return torch.cat([aspp_features, self.shortcut_conv(lowlevel_features)], dim=1)


class BilinearUpsample2x(nn.Module):
    """x2 bilinear align-corners upsampling through the matmul resize (the
    JAX package's decoder upsample), in ``nn.UpsamplingBilinear2d``'s place:
    parameterless, so the Sequential's indices and state-dict names stay."""

    def forward(self, x):
        return resize_bilinear_matmul(x, (2 * x.shape[2], 2 * x.shape[3]))


class SSSRDecoder(nn.Module):
    def __init__(self, num_classes: int):
        super().__init__()
        self.cat_conv = nn.Sequential(
            *_conv_bn_relu(304, 256, 3), nn.Dropout(0.2),
            *_conv_bn_relu(256, 256, 3), nn.Dropout(0.2))
        self.cls_conv = nn.Conv2d(256, num_classes, 1, bias=True)
        self.upsample16_pred = nn.Sequential(
            BilinearUpsample2x(), nn.Dropout(0.2),
            nn.ConvTranspose2d(num_classes, num_classes, 2, stride=2, bias=False),
            nn.BatchNorm2d(num_classes), nn.ReLU(inplace=True), nn.Dropout(0.2),
            nn.ConvTranspose2d(num_classes, num_classes, 2, stride=2, bias=True))

    def forward(self, x, pre_tail: bool = False):
        y = self.cls_conv(self.cat_conv(x))
        if pre_tail:
            return self.upsample16_pred[:6](y)
        return self.upsample16_pred(y)

    def fa_corner(self, y):
        """The stride-8 sample of the logits, from the pre-tail activation
        ``y``: the final ConvT's (0, 0) tap at every 4th pixel.  Under
        autocast the product is bfloat16 and the bias is added in bfloat16,
        as the JAX package's ``conv_transpose_2x2_stride2_corner`` adds it."""
        tail = self.upsample16_pred[6]
        corner = torch.einsum('bihw,io->bohw', y[:, :, ::4, ::4], tail.weight[:, :, 0, 0])
        return corner + tail.bias.to(corner.dtype).reshape(1, -1, 1, 1)


class FeatureTransformer(nn.Sequential):
    """1x1 conv with stride 8 to one channel + BN + ReLU (reference
    DSRL.py:87-95).  ``sampled=True`` takes an input already sampled at
    stride 8 and runs the same conv at stride 1."""

    def __init__(self, in_channels: int):
        super().__init__(nn.Conv2d(in_channels, 1, 1, stride=8, bias=False), nn.BatchNorm2d(1),
                         nn.ReLU(inplace=True))

    def forward(self, x, sampled: bool = False):
        y = F.conv2d(x, self[0].weight) if sampled else self[0](x)
        return self[2](self[1](y))


class DSRL(nn.Module):
    """DSRL of ``stage`` 1, 2 or 3: returns (sssr, sisr, sssr_t, sisr_t), with
    ``None`` for what the stage does not build (the module docstring)."""

    def __init__(self, num_classes: int, stage: int = 1, backbone_layers=None):
        super().__init__()
        from .. import settings
        if stage not in (1, 2, 3):
            raise ValueError("DSRL: stage must be 1, 2 or 3, got {}".format(stage))
        self.stage = stage
        self.feature_extractor = FeatureExtractor(
            tuple(backbone_layers or settings.BACKBONE_LAYERS))
        self.SSSR_decoder = SSSRDecoder(num_classes)
        if stage > 1:
            self.SISR_decoder = nn.Sequential(
                nn.Conv2d(304, NUM_RGB_CHANNELS * SISR_UPSCALE ** 2, 3, padding=1, bias=True))
        if stage > 2:
            self.SSSR_feature_transformer = FeatureTransformer(num_classes)
            self.SISR_feature_transformer = FeatureTransformer(NUM_RGB_CHANNELS)

    def forward(self, x, pre_tail: bool = False):
        features = self.feature_extractor(x)
        sssr = self.SSSR_decoder(features, pre_tail=pre_tail)
        sisr = sssr_t = sisr_t = None
        if self.stage > 1:
            sisr = self.SISR_decoder(features)
            if not pre_tail:
                sisr = F.pixel_shuffle(sisr, SISR_UPSCALE)
        if self.stage > 2:
            if pre_tail:
                sssr_t = self.SSSR_feature_transformer(self.SSSR_decoder.fa_corner(sssr),
                                                       sampled=True)
                sisr_t = self.SISR_feature_transformer(sisr[:, ::SISR_UPSCALE ** 2], sampled=True)
            else:
                sssr_t = self.SSSR_feature_transformer(sssr)
                sisr_t = self.SISR_feature_transformer(sisr)
        return sssr, sisr, sssr_t, sisr_t


def freeze_batch_norms(model: nn.Module) -> nn.Module:
    """``--freeze-batch-norm``: every BatchNorm2d in eval mode, so it
    normalises with its running statistics and updates none of them, while
    its weight and bias still train (the JAX package's
    ``use_running_average`` under ``freeze_bn``, models/norm.py:97-98)."""
    for module in model.modules():
        if isinstance(module, nn.BatchNorm2d):
            module.eval()
    return model
