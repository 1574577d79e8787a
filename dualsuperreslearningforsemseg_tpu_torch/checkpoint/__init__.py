from .io import load_checkpoint_or_weights, save_checkpoint, save_torch_pth, save_weights

__all__ = ['load_checkpoint_or_weights', 'save_checkpoint', 'save_torch_pth', 'save_weights']
