from .cross_entropy import cross_entropy_loss, cross_entropy_sum
from .fa import fa_loss, fa_loss_per_sample, fa_loss_reference_dense
from .mse import mse_loss

__all__ = ['cross_entropy_loss', 'cross_entropy_sum', 'fa_loss', 'fa_loss_per_sample',
           'fa_loss_reference_dense', 'mse_loss']
