from .dsrl import DSRL, FeatureExtractor, SSSRDecoder, freeze_batch_norms
from .resnet import ResNet101, Bottleneck
from .aspp import ASPP
from .init import init_weights, load_pretrained_backbone
from .schedulers import PolynomialLR
from .state_dict import port_state_dict_from_jax, load_state_dict, count_params

__all__ = ['DSRL', 'FeatureExtractor', 'SSSRDecoder', 'freeze_batch_norms', 'ResNet101',
           'Bottleneck', 'ASPP', 'init_weights', 'load_pretrained_backbone', 'PolynomialLR',
           'port_state_dict_from_jax', 'load_state_dict', 'count_params']
