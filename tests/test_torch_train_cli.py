"""The port's ``train`` command on the CPU: one epoch of stage 1 on a
4-frame synthetic train split (batch 2, so 2 steps) with validation, as
``python -m dualsuperreslearningforsemseg_tpu_torch train`` runs it.

It writes ``<experiment>/weights/stage1/final.weights``, which the JAX
package loads (``load_checkpoint_or_weights`` + ``load_state_dict(strict=
True)``) with the same key set and shapes as its own stage-1 model; the
losses it returns are finite.  A stage-2 or stage-3 request, and the
``train`` flags the port does not have yet, exit with the "not ported yet"
error naming the ROADMAP queue, before any work.
"""

import math
import os

import numpy as np
import pytest

from dualsuperreslearningforsemseg_tpu import settings as jax_settings
from dualsuperreslearningforsemseg_tpu.checkpoint import load_checkpoint_or_weights
from dualsuperreslearningforsemseg_tpu.models import (
    DSRL as JaxDSRL, init_model_host, load_state_dict, state_dict)
from dualsuperreslearningforsemseg_tpu_torch.__main__ import main
from dualsuperreslearningforsemseg_tpu_torch.data import make_synthetic_cityscapes_tree

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


@pytest.mark.parametrize('extra', [['--stage', '2'], ['--stage', '3'],
                                   ['--stage', '1', '--early-stopping'],
                                   ['--stage', '1', '--dry-run']])
def test_unported_requests_exit_with_an_error(workdir, capsys, extra):
    with pytest.raises(SystemExit) as exc:
        main(ARGS + extra + ['--experiment-id', 'refused'])
    assert exc.value.code == 2
    out = capsys.readouterr().out
    assert 'not ported yet' in out and 'ROADMAP.md queue' in out
    assert not os.path.exists('experiments')
