"""The plain DSRL network, NCHW, float32, in plain PyTorch.

Wang et al., "Dual Super-Resolution Learning for Semantic Segmentation"
(CVPR 2020), as its public reference code builds it:

* ResNet-101 (Bottleneck blocks 3, 4, 23, 3; the last stage dilated, so the
  output stride is 16) -> ASPP (1x1, 3x3 at dilations 6/12/18, image
  pooling, 1x1 fuse) -> bilinear x4 (align_corners) -> concat with a
  1x1+BN+ReLU shortcut of layer1's output -> 304 channels at H/4 x W/4;
* SSSR decoder: two 3x3 Conv+BN+ReLU+Dropout(0.2), a 1x1 classifier, then
  bilinear x2 + Dropout + ConvT(2, 2)+BN+ReLU+Dropout + ConvT(2, 2): class
  logits at twice the input size;
* stage >= 2: the SISR decoder, a 3x3 conv (with bias) to 3 * 8^2 channels
  and PixelShuffle(8): an RGB image at twice the input size;
* stage 3: two feature transformers, 1x1 conv at stride 8 to one channel
  + BN + ReLU, on the SSSR logits and the SISR image.

Every output is made whole: nothing is fused, sampled or shortcut.  The
module and parameter names are the public reference's, so one state dict
loads here and into the program alike.
"""

import torch
import torch.nn.functional as F
from torch import nn

SISR_UPSCALE = 8


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        if downsample:
            self.downsample = nn.Sequential(nn.Conv2d(inplanes, out, 1, stride=stride, bias=False),
                                            nn.BatchNorm2d(out))
        else:
            self.downsample = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNet101(nn.Module):
    """Returns (layer4 output, layer1 output)."""

    def __init__(self, layers=(3, 4, 23, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes, dilation = 64, 1
        for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if i == 0 else 2
            first_dilation = dilation
            if i == 3:                      # replace_stride_with_dilation=(False, False, True)
                dilation, stride = dilation * stride, 1
            out = planes * Bottleneck.expansion
            blocks_ = [Bottleneck(inplanes, planes, stride, first_dilation,
                                  downsample=stride != 1 or inplanes != out)]
            blocks_ += [Bottleneck(out, planes, 1, dilation) for _ in range(1, blocks)]
            inplanes = out
            self.add_module('layer{}'.format(i + 1), nn.Sequential(*blocks_))

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)
        low = x = self.layer1(x)
        return self.layer4(self.layer3(self.layer2(x))), low


def _cbr(cin, cout, kernel, dilation=1):
    pad = 0 if kernel == 1 else dilation
    return nn.Sequential(nn.Conv2d(cin, cout, kernel, padding=pad, dilation=dilation, bias=False),
                         nn.BatchNorm2d(cout), nn.ReLU())


def _up(x, hw):
    return F.interpolate(x, size=tuple(hw), mode='bilinear', align_corners=True)


class ASPP(nn.Module):
    def __init__(self, cin=2048, cout=256):
        super().__init__()
        self.branches = nn.ModuleList([_cbr(cin, cout, 1)] + [_cbr(cin, cout, 3, d) for d in (6, 12, 18)]
                                      + [_cbr(cin, cout, 1), _cbr(5 * cout, cout, 1)])

    def forward(self, x):
        outs = [b(x) for b in self.branches[:4]]
        outs.append(_up(self.branches[4](x.mean(dim=(2, 3), keepdim=True)), x.shape[2:]))
        return self.branches[5](torch.cat(outs, 1))


class FeatureExtractor(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.backbone = ResNet101(layers)
        self.aspp = ASPP()
        self.shortcut_conv = _cbr(256, 48, 1)

    def forward(self, x):
        deep, low = self.backbone(x)
        a = self.aspp(deep)
        a = _up(a, (4 * a.shape[2], 4 * a.shape[3]))
        return torch.cat([a, self.shortcut_conv(low)], 1)


class Upsample2x(nn.Module):
    def forward(self, x):
        return _up(x, (2 * x.shape[2], 2 * x.shape[3]))


class SSSRDecoder(nn.Module):
    def __init__(self, num_classes):
        super().__init__()
        self.cat_conv = nn.Sequential(
            nn.Conv2d(304, 256, 3, padding=1, bias=False), nn.BatchNorm2d(256), nn.ReLU(),
            nn.Dropout(0.2),
            nn.Conv2d(256, 256, 3, padding=1, bias=False), nn.BatchNorm2d(256), nn.ReLU(),
            nn.Dropout(0.2))
        self.cls_conv = nn.Conv2d(256, num_classes, 1, bias=True)
        self.upsample16_pred = nn.Sequential(
            Upsample2x(), nn.Dropout(0.2),
            nn.ConvTranspose2d(num_classes, num_classes, 2, stride=2, bias=False),
            nn.BatchNorm2d(num_classes), nn.ReLU(), nn.Dropout(0.2),
            nn.ConvTranspose2d(num_classes, num_classes, 2, stride=2, bias=True))

    def forward(self, x):
        return self.upsample16_pred(self.cls_conv(self.cat_conv(x)))


def _transformer(cin):
    return nn.Sequential(nn.Conv2d(cin, 1, 1, stride=8, bias=False), nn.BatchNorm2d(1), nn.ReLU())


class DSRL(nn.Module):
    """forward(x) -> (sssr logits, sisr image, sssr_t, sisr_t), None for what
    the stage does not build."""

    def __init__(self, num_classes=19, stage=1, layers=(3, 4, 23, 3)):
        super().__init__()
        self.stage = stage
        self.feature_extractor = FeatureExtractor(tuple(layers))
        self.SSSR_decoder = SSSRDecoder(num_classes)
        if stage > 1:
            self.SISR_decoder = nn.Sequential(nn.Conv2d(304, 3 * SISR_UPSCALE ** 2, 3, padding=1))
        if stage > 2:
            self.SSSR_feature_transformer = _transformer(num_classes)
            self.SISR_feature_transformer = _transformer(3)

    def forward(self, x):
        f = self.feature_extractor(x)
        sssr = self.SSSR_decoder(f)
        sisr = sssr_t = sisr_t = None
        if self.stage > 1:
            sisr = F.pixel_shuffle(self.SISR_decoder(f), SISR_UPSCALE)
        if self.stage > 2:
            sssr_t = self.SSSR_feature_transformer(sssr)
            sisr_t = self.SISR_feature_transformer(sisr)
        return sssr, sisr, sssr_t, sisr_t
