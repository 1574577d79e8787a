"""DSRL (Wang et al., CVPR 2020) with its ResNet encoder: the program's
``models.DSRL`` and the plain one of ``reference/model.py``, which share
module and parameter names, so one state dict loads into both."""

import torch

from ..drivers.common import port
from ..reference.losses import cross_entropy, fa, mse
from ..reference.model import DSRL
from ..weights import batchnorm


def program_env(cfg):
    """The program's overrides of its input size and backbone depth
    (``settings.py``), which it reads at import."""
    return {'DSRL_TPU_MODEL_INPUT_SIZE': '{}x{}'.format(*cfg['input_hw']),
            'DSRL_TPU_BACKBONE_LAYERS': ','.join(str(n) for n in cfg['backbone_layers'])}


def program(cfg):
    P = port()
    if tuple(P.settings.MODEL_INPUT_SIZE) != tuple(cfg['input_hw']):
        raise RuntimeError("the program's input size is {}, the configuration's {}".format(
            P.settings.MODEL_INPUT_SIZE, cfg['input_hw']))
    with torch.device('meta'):
        return P.models.DSRL(cfg['num_classes'], cfg['stage'], tuple(cfg['backbone_layers']))


def reference(cfg):
    return DSRL(cfg['num_classes'], cfg['stage'], cfg['backbone_layers'])


def weight_rules(cfg):
    """The last BatchNorm of each bottleneck (``.bn3``) at weight ``bn3_gamma``."""
    def bn3(name, mod):
        if isinstance(mod, torch.nn.BatchNorm2d) and name.endswith('.bn3'):
            return batchnorm(mod, cfg['bn3_gamma'])
        return None
    return [bn3]


def terms(cfg, outputs, hi, seg):
    """CE; + MSE x w1 from stage 2; + FA x w2 at stage 3."""
    sssr, sisr, sssr_t, sisr_t = outputs
    w1, w2 = cfg['loss_weights']
    out = {'CE': cross_entropy(sssr, seg)[0].float()}
    if cfg['stage'] > 1:
        out['MSE'] = w1 * mse(sisr, hi)
    if cfg['stage'] > 2:
        out['FA'] = w2 * fa(sssr_t, sisr_t)
    return out


def logits(outputs):
    return outputs[0]


def tiny(cfg):
    return {'backbone_layers': [1, 1, 2, 1]}
