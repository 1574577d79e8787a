"""Rules of the PyTorch port that hold on any machine.

* No module of the port, and no line of ``chip_smoke.py`` or
  ``tail_variants.py``, imports JAX,
  Flax or the JAX package (an AST scan of every import).
* The entry points run on ``cuda`` unless asked for the CPU: without a card
  ``benchmark`` and ``train`` raise instead of falling back.
* Every kernel wrapper module (K3, K1, K2, K4) has its plain version beside
  the kernel, one ``launches`` counter per kernel, raised in one place only,
  and no ``try`` anywhere (so nothing falls back to the plain version).
"""

import ast
import glob
import importlib
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
                      recursive=True) + [os.path.join(REPO, f) for f in ('chip_smoke.py',
                                                                         'tail_variants.py')]
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


WRAPPERS = {
    'eval_tail': (['eval_tail'], ['eval_tail_plain']),
    'fused_tail': (['fused_tail_forward', 'fused_tail_backward'],
                   ['fused_convt2_ce_sum_plain', 'fused_convt2_ce_mean_plain']),
    'augment_post': (['photometric'], ['photometric_plain']),
    'fa_pairwise': (['fa_pairwise_forward', 'fa_pairwise_backward'],
                    ['fa_pairwise_forward_plain', 'fa_pairwise_backward_plain',
                     'fa_allpairs_abs_sum_rows_plain', 'fa_allpairs_abs_mean_plain']),
}


@pytest.mark.parametrize('module', sorted(WRAPPERS))
def test_kernel_wrappers_keep_the_port_rules(module):
    launchers, plains = WRAPPERS[module]
    mod = importlib.import_module('dualsuperreslearningforsemseg_tpu_torch.ops.' + module)
    for name in plains:
        assert callable(getattr(mod, name)), name
    for name in launchers:
        assert isinstance(getattr(mod, name).launches, int), name
    with open(mod.__file__) as f:
        tree = ast.parse(f.read())
    assert not [n for n in ast.walk(tree) if isinstance(n, (ast.Try, ast.TryStar))]
    raised = {}
    for fn in (n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)):
        for node in ast.walk(fn):
            if isinstance(node, ast.AugAssign) and getattr(node.target, 'attr', None) == 'launches':
                raised.setdefault(node.target.value.id, []).append(fn.name)
    assert raised == {name: [name] for name in launchers}


def test_fa_pairwise_sends_cpu_tensors_to_the_plain_version():
    from dualsuperreslearningforsemseg_tpu_torch.ops import fa_pairwise
    a = torch.arange(12, dtype=torch.float32).reshape(3, 4).requires_grad_()
    b = torch.ones(3, 4)
    before = fa_pairwise.fa_pairwise_forward.launches, fa_pairwise.fa_pairwise_backward.launches
    out = fa_pairwise.fa_allpairs_abs_sum_rows(a, b)
    out.sum().backward()
    assert (fa_pairwise.fa_pairwise_forward.launches,
            fa_pairwise.fa_pairwise_backward.launches) == before
    assert torch.equal(out.detach(), fa_pairwise.fa_pairwise_forward_plain(a.detach(), b))
    assert torch.equal(a.grad, torch.sign(a.detach() - 1.0) * 4)
