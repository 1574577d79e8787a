"""Checkpoint/weights I/O.

File semantics mirror the reference exactly (SURVEY.md §5, north star):

* ``.checkpoint`` — a dict with the 36 keys of
  ``settings.VARIABLES_IN_CHECKPOINT`` (reference settings.py:76-80):
  every hyperparameter + per-loss averages + epoch + best_validation_dict +
  model/optimizer state dicts;
* ``.weights`` — ``{'model_state_dict', 'mixed_precision', 'amp_state_dict'}``
  (reference utils.py:277-282);
* ``.pth`` — the torch model-zoo format, read with ``torch.load`` and
  written by ``prune-weights --torch-format`` with ``torch.save``.

Storage: a zip container holding ``data.json`` (structure + scalars) and one
``.npy`` entry per array — self-describing, fast, dependency-free, and
streamable.  ``load_checkpoint_or_weights`` auto-detects our format vs a
torch zipfile and dispatches accordingly, so ``--init-weights`` accepts
either (the reference loads both through ``t.load``).

Under a process group only the master rank writes: ``save_checkpoint`` and
``save_weights`` do nothing on the other ranks.
"""

import io as _io
import json
import os
import os.path
import zipfile

import numpy as np

from ..parallel import is_master_rank

_MAGIC = 'dsrl_tpu_checkpoint_v1'
_ARRAY_TOKEN = '__ndarray__'


def _encode(obj, arrays, path):
    if isinstance(obj, np.ndarray):
        key = 'arr{}'.format(len(arrays))
        arrays[key] = obj
        return {_ARRAY_TOKEN: key}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, dict):
        return {str(k): _encode(v, arrays, path + '.' + str(k)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v, arrays, path) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    # torch tensors and other array-likes
    if hasattr(obj, 'detach'):
        obj = obj.detach().cpu()
    try:
        return _encode(np.asarray(obj), arrays, path)
    except Exception as exc:  # pragma: no cover
        raise TypeError("Cannot serialize '{}' of type {}: {}".format(path, type(obj), exc))


def _decode(obj, arrays):
    if isinstance(obj, dict):
        if set(obj.keys()) == {_ARRAY_TOKEN}:
            return arrays[obj[_ARRAY_TOKEN]]
        return {k: _decode(v, arrays) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v, arrays) for v in obj]
    return obj


def _save_dict(filename, payload: dict):
    arrays = {}
    structure = _encode(payload, arrays, '')
    tmp = filename + '.tmp'
    with zipfile.ZipFile(tmp, 'w', compression=zipfile.ZIP_STORED) as zf:
        zf.writestr('magic', _MAGIC)
        zf.writestr('data.json', json.dumps(structure))
        for key, arr in arrays.items():
            buf = _io.BytesIO()
            np.save(buf, arr, allow_pickle=False)
            zf.writestr(key + '.npy', buf.getvalue())
    os.replace(tmp, filename)


def _load_dict(filename) -> dict:
    with zipfile.ZipFile(filename, 'r') as zf:
        structure = json.loads(zf.read('data.json').decode())
        arrays = {}
        for name in zf.namelist():
            if name.endswith('.npy'):
                arrays[name[:-4]] = np.load(_io.BytesIO(zf.read(name)), allow_pickle=False)
    return _decode(structure, arrays)


def _is_our_format(filename) -> bool:
    try:
        with zipfile.ZipFile(filename, 'r') as zf:
            return 'magic' in zf.namelist() and zf.read('magic').decode() == _MAGIC
    except (zipfile.BadZipFile, OSError, KeyError):
        return False


def load_checkpoint_or_weights(filename, map_location=None):
    """Load a ``.checkpoint``/``.weights``/``.pth`` file as a plain dict of
    python scalars and numpy arrays (API parity: reference utils.py:270); a
    torch ``.pth`` comes back as ``torch.load`` gives it, tensors on the CPU.
    ``map_location`` accepted for signature parity and ignored."""
    if _is_our_format(filename):
        return _load_dict(filename)
    import torch
    return torch.load(filename, map_location='cpu', weights_only=True)


def save_checkpoint(dir_, filename, **checkpoint_vars):
    dir_ = dir_ or '.'
    os.makedirs(dir_, exist_ok=True)
    _save_dict(os.path.join(dir_, filename), checkpoint_vars)


def save_weights(dir_, filename, model_state_dict, mixed_precision, amp_state_dict=None):
    dir_ = dir_ or '.'
    os.makedirs(dir_, exist_ok=True)
    _save_dict(os.path.join(dir_, filename),
               {'model_state_dict': model_state_dict,
                'mixed_precision': mixed_precision,
                'amp_state_dict': amp_state_dict})


def save_torch_pth(state: dict, filename):
    """Write a flat dict of tensors (or numpy arrays) as a ``.pth`` that
    ``torch.load`` reads: contiguous CPU tensors under the same keys (the
    JAX package writes the same file with its own zip writer)."""
    import torch
    torch.save({k: torch.as_tensor(v).detach().cpu().contiguous() for k, v in state.items()},
               filename)
