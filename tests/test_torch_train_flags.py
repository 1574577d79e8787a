"""The port's ``train --dry-run``, ``--debug-nans``, ``--profile`` and
``config-train`` on the CPU, at the conftest's 64x128 and depth 1,1,2,1,
as the JAX CLI has them (main.py:67-71,138,180,269-288,364-368;
train/steps.py:74,145-150,434-440 there).

* ``--dry-run`` draws the network's outputs: the fused tail (K1), the eval
  tail (K3) and the FA reduction (K4) are never called, K2 still runs
  without its unshuffled output, the losses come from the plain functions
  and are finite, and every parameter and BatchNorm buffer of the written
  ``final.weights`` equals the ``--init-weights`` file bitwise; an empty
  dataset runs 0 steps.
* ``--debug-nans`` raises ``FloatingPointError`` naming the loss, the
  epoch and the step when the model's final bias holds a NaN, and not
  without the NaN; without the flag the NaN run goes through.
* ``--profile`` writes a Chrome trace into ``outputs/profile`` for
  ``train`` and ``test`` and prints the JAX CLI's INFO line.
* ``config-train`` runs ``train`` from a JSON file in a spawned child and
  exits with its code: 0 for a small run, 2 for a missing file or bad
  JSON; the recipes' ``"device": "tpu"`` maps to ``cuda``.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from dualsuperreslearningforsemseg_tpu_torch import settings
from dualsuperreslearningforsemseg_tpu_torch.__main__ import _config_train_argv, main
from dualsuperreslearningforsemseg_tpu_torch.checkpoint import load_checkpoint_or_weights, save_weights
from dualsuperreslearningforsemseg_tpu_torch.data import make_synthetic_cityscapes_tree
from dualsuperreslearningforsemseg_tpu_torch.losses import fa as fa_module
from dualsuperreslearningforsemseg_tpu_torch.data import augment
from dualsuperreslearningforsemseg_tpu_torch.models import DSRL, init_weights
from dualsuperreslearningforsemseg_tpu_torch.train import steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ['train', '--device', 'cpu', '--epochs', '1', '--batch-size', '2', '--num-workers', '0',
        '--dataset', 'cityscapes', '--val-interval', '1', '--checkpoint-history', '0']


@pytest.fixture
def tmp(tmp_path):
    """``tmp_path``, emptied afterwards: the weights written here are 0.1 GB each."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def workdir(tmp, monkeypatch):
    data_root = os.path.join(str(tmp), 'datasets', 'Cityscapes', 'data')
    make_synthetic_cityscapes_tree(data_root, split='train', num_images=4, size_hw=(128, 256), seed=1)
    make_synthetic_cityscapes_tree(data_root, split='val', num_images=3, size_hw=(128, 256), seed=2)
    monkeypatch.chdir(tmp)
    return str(tmp)


def _seeded_weights(stage, nan_bias=False):
    model = init_weights(DSRL(num_classes=19, stage=stage), torch.Generator().manual_seed(7))
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    if nan_bias:
        state['SSSR_decoder.upsample16_pred.6.bias'][3] = np.nan
    save_weights('init', 'stage{}.weights'.format(stage), state, None)
    return os.path.join('init', 'stage{}.weights'.format(stage)), state


@pytest.mark.parametrize('stage', [1, 3])
def test_dry_run_skips_the_network_and_the_update(workdir, monkeypatch, stage):
    called = {'K1': 0, 'K3': 0, 'K4': 0, 'K2 unshuffle': []}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            called[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(steps, 'fused_convt2_ce_sum', spy('K1', steps.fused_convt2_ce_sum))
    monkeypatch.setattr(steps, 'eval_tail', spy('K3', steps.eval_tail))
    monkeypatch.setattr(steps, 'fa_loss_per_sample', spy('K4', steps.fa_loss_per_sample))
    monkeypatch.setattr(fa_module, 'fa_allpairs_abs_mean', spy('K4', fa_module.fa_allpairs_abs_mean))
    k2 = augment.photometric

    def spy_k2(*args, **kwargs):
        called['K2 unshuffle'].append(args[5] if len(args) > 5 else kwargs.get('unshuffle', 0))
        return k2(*args, **kwargs)

    monkeypatch.setattr(augment, 'photometric', spy_k2)
    weights, state = _seeded_weights(stage)
    res = main(ARGS + ['--stage', str(stage), '--dry-run', '--init-weights', weights,
                       '--experiment-id', 'dry'])
    assert called == {'K1': 0, 'K3': 0, 'K4': 0, 'K2 unshuffle': [0, 0]}
    assert res['steps'] == 2
    losses = list(res['train_losses'][0].values()) + [res['val'][k] for k in ('CE', 'MSE', 'FA', 'Total')]
    assert all(np.isfinite(v) for v in losses)
    assert (res['train_losses'][0]['MSE'] > 0) == (stage > 1) == (res['val']['MSE'] > 0)
    assert (res['train_losses'][0]['FA'] > 0) == (stage == 3) == (res['val']['FA'] > 0)
    final = load_checkpoint_or_weights(res['final_weights'])['model_state_dict']
    assert set(final) == set(state)
    for key, value in state.items():
        np.testing.assert_array_equal(final[key], value, err_msg=key)


def test_dry_run_takes_an_empty_dataset(tmp, monkeypatch):
    monkeypatch.chdir(tmp)
    res = main(ARGS + ['--stage', '2', '--dry-run', '--experiment-id', 'empty'])
    assert res['steps'] == 0 and os.path.isfile(res['final_weights'])
    with pytest.raises(Exception, match='dataset was not found'):
        main(ARGS + ['--stage', '2', '--experiment-id', 'empty_real'])


@pytest.mark.parametrize('flag,nan', [(True, True), (True, False), (False, True)])
def test_debug_nans_raises_at_the_first_nan(workdir, flag, nan):
    weights, _ = _seeded_weights(1, nan_bias=nan)
    argv = ARGS + ['--stage', '1', '--init-weights', weights, '--experiment-id', 'nans'] + \
        (['--debug-nans'] if flag else [])
    if flag and nan:
        with pytest.raises(FloatingPointError,
                           match=r'--debug-nans: the CE loss is nan at epoch 1, step 1\.'):
            main(argv)
        with open(os.path.join('experiments', 'nans', 'logs', 'stage1', 'train', 'stdout.txt')) as f:
            assert 'Exception caught: --debug-nans: the CE loss is nan' in f.read()
        return
    res = main(argv)
    assert res['steps'] == 2
    assert np.isfinite(res['train_losses'][0]['CE']) != nan


@pytest.mark.parametrize('command', ['train', 'test'])
def test_profile_writes_a_chrome_trace(workdir, capsys, command):
    if command == 'train':
        main(ARGS + ['--stage', '1', '--profile', '--experiment-id', 'prof'])
    else:
        weights, _ = _seeded_weights(1)
        Image.fromarray(np.zeros((64, 128, 3), np.uint8)).save('frame.png')
        main(['test', '--image-file', 'frame.png', '--weights', weights, '--device', 'cpu',
              '--profile'])
        assert os.path.isfile(os.path.join('outputs', 'frame.png'))
    path = os.path.join('outputs', 'profile', 'profiling.json')
    with open(path) as f:
        trace = json.load(f)
    names = {e.get('name') for e in trace['traceEvents']}
    assert any(n and n.startswith('aten::conv') for n in names)
    out = capsys.readouterr().out
    assert "Profiling output has been saved to '{}'.".format(settings.PROFILING_DIR) in out


def test_config_train_maps_the_recipes_device():
    for stage in (1, 2, 3):
        argv = _config_train_argv(os.path.join(REPO, 'train_stage{}_cmdline.json'.format(stage)))
        assert argv[:3] == ['train', '--device', 'cuda'] and argv[argv.index('--stage') + 1] == str(stage)
    assert [settings.port_device(d) for d in ('cpu', 'CPU', 'tpu', 'gpu', 'cuda')] == \
        ['cpu', 'cpu', 'cuda', 'cuda', 'cuda']
    with pytest.raises(ValueError, match='Unknown device'):
        settings.port_device('ipu')


def test_config_train_runs_train_in_a_child(workdir):
    config = {'device': 'cpu', 'num-workers': 0, 'dataset': 'cityscapes', 'val-interval': 1,
              'checkpoint-history': 0, 'batch-size': 2, 'epochs': 1, 'stage': 1,
              'experiment-id': 'from_config', 'description': 'config-train test'}
    with open('small.json', 'w') as f:
        json.dump(config, f)
    with pytest.raises(SystemExit) as exc:
        main(['config-train', '--file', 'small.json'])
    assert exc.value.code == 0
    assert os.path.isfile(os.path.join('experiments', 'from_config', 'weights', 'stage1', 'final.weights'))
    with open(os.path.join('experiments', 'from_config', 'logs', 'stage1', 'train', 'params.txt')) as f:
        assert 'Description: config-train test' in f.read()


@pytest.mark.parametrize('content,message', [(None, "No such config file: 'bad.json'."),
                                             ('{"epochs": 1,', "'bad.json' is not valid JSON")])
def test_config_train_refuses_a_bad_file(workdir, capsys, content, message):
    if content is not None:
        with open('bad.json', 'w') as f:
            f.write(content)
    with pytest.raises(SystemExit) as exc:
        main(['config-train', '--file', 'bad.json'])
    assert exc.value.code == 2
    assert message in capsys.readouterr().out
    assert not os.path.exists('experiments')
