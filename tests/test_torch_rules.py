"""Rules of the PyTorch port that hold on any machine.

* No module of the port, and no line of ``chip_smoke.py``, imports JAX,
  Flax or the JAX package (an AST scan of every import).
* The entry points run on ``cuda`` unless asked for the CPU: without a card
  ``benchmark`` and ``train`` raise instead of falling back.
"""

import ast
import glob
import os

import pytest
import torch

from dualsuperreslearningforsemseg_tpu_torch.__main__ import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'dualsuperreslearningforsemseg_tpu')


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, 'attr', None) == 'import_module' \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_port_imports_nothing_of_jax():
    files = glob.glob(os.path.join(REPO, 'dualsuperreslearningforsemseg_tpu_torch', '**', '*.py'),
                      recursive=True) + [os.path.join(REPO, 'chip_smoke.py')]
    assert len(files) > 20
    bad = [(os.path.relpath(f, REPO), name) for f in files for name in _imported_modules(f)
           if name.split('.')[0] in FORBIDDEN]
    assert not bad, bad


def test_benchmark_without_device_raises_on_a_cardless_machine(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card, so the default device is usable")
    weights = tmp_path / 'stage1.weights'
    weights.write_bytes(b'')
    with pytest.raises(RuntimeError, match='--device cpu'):
        main(['benchmark', '--weights', str(weights), '--dataset', 'cityscapes', 'val'])


def test_train_without_device_raises_on_a_cardless_machine(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card, so the default device is usable")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='--device cpu'):
        main(['train', '--stage', '1', '--epochs', '1', '--dataset', 'cityscapes'])
