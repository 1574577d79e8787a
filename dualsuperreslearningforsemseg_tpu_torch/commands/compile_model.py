"""`compile-model` command: ahead-of-time export of the inference forward.

The port's counterpart of the JAX package's ``jax.export`` of the stage-1
forward (itself in place of the reference's TorchScript trace, reference
command_handlers/compile_model.py:11-21): the stage-1 model in eval mode,
its weights inside, is exported with ``torch.export`` on one
``(1, 3, *MODEL_INPUT_SIZE)`` float32 input (static shapes) and saved with
``torch.export.save`` as a ``.pt2`` program.  `test --compiled-model` loads
it with :func:`load_compiled_model`.  The bundle is a PyTorch
ExportedProgram, not the JAX package's StableHLO file, and the export runs
on ``--device`` (the JAX command takes its backend from the environment).
"""

import os.path
import time

import torch

from .. import settings
from ..utils import INFO, select_device
from .test import load_model


def compile_model(weights, output_file, dataset, device, **other_args):
    """Returns ``{'seconds': export + save, 'bytes': bundle size}``."""
    device = select_device(device)
    model = load_model(weights, dataset['settings'].NUM_CLASSES, device)
    x = torch.zeros((1, 3, *settings.MODEL_INPUT_SIZE), dtype=torch.float32, device=device)
    print(INFO("Exporting model with torch.export..."))
    t0 = time.perf_counter()
    program = torch.export.export(model, (x,))
    torch.export.save(program, output_file)
    seconds = time.perf_counter() - t0
    print(INFO("Compiled model saved to specified file."))
    return {'seconds': seconds, 'bytes': os.path.getsize(output_file)}


def load_compiled_model(path, device):
    """The program `compile-model` saved at ``path``, as a callable module
    on ``device``: fn(x) -> the model's (sssr, sisr, sssr_t, sisr_t)."""
    from torch.export.passes import move_to_device_pass
    program = torch.export.load(path)
    tensors = list(program.state_dict.values()) + list(program.constants.values())
    if any(isinstance(t, torch.Tensor) and t.device.type != device.type for t in tensors):
        program = move_to_device_pass(program, device)
    return program.module()
