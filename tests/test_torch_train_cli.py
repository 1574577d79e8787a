"""The port's ``train`` command on the CPU: one epoch of stage 1 on a
4-frame synthetic train split (batch 2, so 2 steps) with validation, as
``python -m dualsuperreslearningforsemseg_tpu_torch train`` runs it, and the
stage cascade: ``--stage 2`` and then ``--stage 3`` in the stage-1 run's
experiment, each printing the JAX engine's INFO line as it warm-starts from
the stage before and writing a ``final.weights`` that the JAX package's
``DSRL(stage=k)`` loads with ``strict=True``; without the earlier stage's
weights the JAX CAUTION line is printed and the backbone init is kept.

It writes ``<experiment>/weights/stage1/final.weights``, which the JAX
package loads (``load_checkpoint_or_weights`` + ``load_state_dict(strict=
True)``) with the same key set and shapes as its own stage-1 model; the
losses it returns are finite.  With ``--mixed-precision O1`` the train
step hands K1 and the validation step hands K3 a bfloat16 activation, as
the JAX package trains and validates its bfloat16 model.  The ``train`` flags the port does not have
yet exit with the "not ported yet" error naming the ROADMAP queue, before
any work, at every stage.
"""

import math
import os

import numpy as np
import pytest
import torch

from dualsuperreslearningforsemseg_tpu import settings as jax_settings
from dualsuperreslearningforsemseg_tpu.checkpoint import load_checkpoint_or_weights
from dualsuperreslearningforsemseg_tpu.models import (
    DSRL as JaxDSRL, init_model_host, load_state_dict, state_dict)
from dualsuperreslearningforsemseg_tpu_torch.__main__ import main
from dualsuperreslearningforsemseg_tpu_torch.data import make_synthetic_cityscapes_tree
from dualsuperreslearningforsemseg_tpu_torch.train import steps

ARGS = ['train', '--device', 'cpu', '--epochs', '1', '--batch-size', '2', '--num-workers', '0',
        '--dataset', 'cityscapes', '--val-interval', '1']


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    data_root = os.path.join(str(tmp_path), 'datasets', 'Cityscapes', 'data')
    make_synthetic_cityscapes_tree(data_root, split='train', num_images=4, size_hw=(128, 256), seed=1)
    make_synthetic_cityscapes_tree(data_root, split='val', num_images=3, size_hw=(128, 256), seed=2)
    monkeypatch.chdir(tmp_path)
    return str(tmp_path)


def test_train_writes_weights_the_jax_package_loads(workdir):
    res = main(ARGS + ['--stage', '1', '--experiment-id', 'cpu_run'])
    assert res['steps'] == 2
    assert all(math.isfinite(v) for v in res['train_losses'][0].values())
    assert math.isfinite(res['val']['CE']) and 0 <= res['val']['mIoU'] <= 100
    path = os.path.join('experiments', 'cpu_run', 'weights', 'stage1', 'final.weights')
    assert res['final_weights'] == path and os.path.isfile(path)

    weights = load_checkpoint_or_weights(path)
    assert weights['mixed_precision'] is None
    variables = init_model_host(JaxDSRL(stage=1, num_classes=19), jax_settings.MODEL_INPUT_SIZE)
    reference = state_dict(variables)
    mine = weights['model_state_dict']
    assert set(mine) == set(reference)
    for key, value in reference.items():
        assert np.asarray(mine[key]).shape == value.shape, key
    loaded, missing, unexpected = load_state_dict(variables, mine, strict=True)
    assert not missing and not unexpected
    np.testing.assert_array_equal(
        np.asarray(loaded['params']['SSSR_decoder']['upsample16_pred.6']['bias']),
        mine['SSSR_decoder.upsample16_pred.6.bias'])


def test_mixed_precision_trains_and_validates_in_bf16(workdir, monkeypatch):
    seen = {'K1': [], 'K3': []}
    k1, k3 = steps.fused_convt2_ce_mean, steps.eval_tail

    def spy_k1(x, *args):
        seen['K1'].append(x.dtype)
        return k1(x, *args)

    def spy_k3(x, *args):
        seen['K3'].append(x.dtype)
        return k3(x, *args)

    monkeypatch.setattr(steps, 'fused_convt2_ce_mean', spy_k1)
    monkeypatch.setattr(steps, 'eval_tail', spy_k3)
    res = main(ARGS + ['--stage', '1', '--mixed-precision', 'O1', '--experiment-id', 'bf16'])
    assert seen == {'K1': [torch.bfloat16] * 2, 'K3': [torch.bfloat16] * 2}
    assert all(math.isfinite(v) for v in res['train_losses'][0].values())
    assert math.isfinite(res['val']['CE']) and 0 <= res['val']['mIoU'] <= 100
    assert load_checkpoint_or_weights(res['final_weights'])['mixed_precision'] == 'O1'


@pytest.mark.parametrize('extra', [['--stage', '2', '--profile'], ['--stage', '3', '--debug-nans'],
                                   ['--stage', '1', '--early-stopping'],
                                   ['--stage', '1', '--dry-run']])
def test_unported_requests_exit_with_an_error(workdir, capsys, extra):
    with pytest.raises(SystemExit) as exc:
        main(ARGS + extra + ['--experiment-id', 'refused'])
    assert exc.value.code == 2
    out = capsys.readouterr().out
    assert 'not ported yet' in out and 'ROADMAP.md queue' in out
    assert not os.path.exists('experiments')


def _load_into_jax(path, stage):
    variables = init_model_host(JaxDSRL(stage=stage, num_classes=19), jax_settings.MODEL_INPUT_SIZE)
    mine = load_checkpoint_or_weights(path)['model_state_dict']
    assert set(mine) == set(state_dict(variables))
    _, missing, unexpected = load_state_dict(variables, mine, strict=True)
    assert not missing and not unexpected


def test_stage_cascade_warm_starts_from_the_stage_before(workdir, capsys):
    main(ARGS + ['--stage', '1', '--experiment-id', 'cascade'])
    capsys.readouterr()
    for stage in (2, 3):
        res = main(ARGS + ['--stage', str(stage), '--experiment-id', 'cascade'])
        out = capsys.readouterr().out
        previous = os.path.join('experiments', 'cascade', 'weights', 'stage{}'.format(stage - 1),
                                'final.weights')
        assert res['warm_start'] == previous
        assert "'{}' weights file from previous stage was found".format(previous) in out
        assert 'Avg. MSE: ' in out and ('Avg. FA: ' in out) == (stage == 3)
        train, val = res['train_losses'][0], res['val']
        assert all(math.isfinite(v) for v in list(train.values()) + [val[k] for k in train])
        assert train['MSE'] > 0 and val['MSE'] > 0
        assert (train['FA'] > 0 and val['FA'] > 0) == (stage == 3)
        np.testing.assert_allclose(train['Total'], train['CE'] + train['MSE'] + train['FA'], rtol=1e-6)
        _load_into_jax(res['final_weights'], stage)


def test_stage2_without_stage1_weights_prints_the_caution(workdir, capsys):
    res = main(ARGS + ['--stage', '2', '--experiment-id', 'fresh'])
    out = capsys.readouterr().out
    assert res['warm_start'] is None
    assert "weights file from previous stage was not found; initializing with pretrained " \
           "ResNet101 + Kaiming init." in out
    assert os.path.isfile(res['final_weights'])
