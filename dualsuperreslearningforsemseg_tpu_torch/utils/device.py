"""Device selection for the entry points.

``cuda`` is the default and needs a card: without one the entry points raise
instead of falling back to the CPU.  The CPU serves tests and runs only when
the caller asks for it.  Float32 stays full float32 on the card: both TF32
switches are set explicitly (cuDNN's own default would run every float32
convolution in TF32).  cuDNN runs only its deterministic algorithms (the
autotuner picks among those), as the JAX package's steps are
deterministic (tests/test_determinism.py there).
"""

import torch


def select_device(device: str, cudnn_benchmark: bool = True) -> torch.device:
    """``'cpu'`` or ``'cuda'`` -> the torch device, with the precision
    switches set; raises when ``'cuda'`` is asked for and there is no card."""
    device = device.casefold()
    if device == 'cpu':
        return torch.device('cpu')
    if device != 'cuda':
        raise ValueError("Unsupported device '{}': use 'cpu' or 'cuda'.".format(device))
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs an NVIDIA GPU, and torch sees none. "
                           "Pass '--device cpu' to run on the CPU.")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = cudnn_benchmark
    torch.backends.cudnn.deterministic = True
    return torch.device('cuda')


def device_description(device: torch.device) -> str:
    """The device as results name it: the card's name on CUDA."""
    if device.type == 'cuda':
        return torch.cuda.get_device_name(device)
    return 'cpu'
