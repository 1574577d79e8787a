"""`edit-checkpoint` command (reference command_handlers/
edit_checkpoint.py:8-11): coerce a string value to a named type, store it
under the given key, and re-save the checkpoint in place."""

import os.path
import pydoc

from ..checkpoint import load_checkpoint_or_weights, save_checkpoint


def edit_checkpoint(checkpoint, key, value, typeof, **other_args):
    state = load_checkpoint_or_weights(checkpoint)
    # 'typeof' names a builtin or dotted type ('int', 'float', 'str', ...);
    # pydoc.locate resolves it exactly like the reference does.
    coerce = pydoc.locate(typeof)
    if coerce is None:
        raise ValueError(
            "Unknown type {!r} for --typeof: must name a builtin or importable "
            "dotted type (e.g. 'int', 'float', 'str', 'bool').".format(typeof))
    state[key] = coerce(value)
    directory, filename = os.path.split(checkpoint)
    save_checkpoint(directory, filename, **state)
