"""`prune-weights` command: strip a checkpoint/weights file down to the
stage-1 inference parameters (reference command_handlers/
prune_weights.py:11-19) — drops SISR/FA-transformer params + optimizer state.

As in the JAX package, the source loads with ``strict=False`` so that a
stage-2/3 file prunes (the reference's ``strict=True`` errors on their
extra keys).  ``--torch-format`` writes the stage-1 state dict with
``torch.save`` as a ``.pth`` that ``torch.load`` reads: the keys, shapes
and dtypes of the JAX package's hand-written torch-zip file."""

import os.path

from ..checkpoint import load_checkpoint_or_weights, save_torch_pth, save_weights
from ..models import DSRL, load_state_dict
from ..utils import INFO


def prune_weights(src_weights, dest_weights, dataset, torch_format=False, **other_args):
    model = DSRL(num_classes=dataset['settings'].NUM_CLASSES)
    src_dict = load_checkpoint_or_weights(src_weights)
    load_state_dict(model, src_dict['model_state_dict'], strict=False)
    state = {k: v.detach().cpu().contiguous() for k, v in model.state_dict().items()}
    if torch_format:
        save_torch_pth(state, dest_weights)
    else:
        save_weights(*os.path.split(dest_weights), {k: v.numpy() for k, v in state.items()},
                     src_dict.get('mixed_precision'), src_dict.get('amp_state_dict'))
    print(INFO("Output weight saved in '{:s}'.".format(dest_weights)))
