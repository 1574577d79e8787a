"""The port's training state against the JAX package's: the SGD momentum
carried between the two layouts, the autosaved and best-validation
checkpoints, ``params.txt``, the TensorBoard logs, ``resume-train`` and
early stopping, at the conftest's 64x128 and depth 1,1,2,1 on the CPU.

* The carry: random momentum from a numpy seed goes through JAX
  ``optimizer_state_dict``, the port's ``load_optimizer_state_dict`` and
  the port's ``optimizer_state_dict`` bitwise unchanged, and the port's
  export loads into the JAX package strictly; from one carried state and
  the same numpy gradients, a JAX ``sgd_update`` and a port
  ``optimizer.step()`` at stage 3 agree within rtol 1e-6 of each leaf's
  largest value (float32: the two add the weight decay and the momentum in
  the same order; 1e-6 leaves room for a fused multiply-add); the
  reference's id-keyed torch layout gives the port the buffers the JAX
  loader gives, bitwise, and keeps torch's lazy start where an id is
  absent.
* The CLI: ``train --epochs 3 --checkpoint-interval 1 --checkpoint-history
  2`` leaves epoch2, epoch3 and one ``_bestval`` checkpoint, each with the
  36 entries of ``VARIABLES_IN_CHECKPOINT`` (35 names: 'amp_state_dict'
  is listed twice) and loading into the JAX package, model and momentum,
  strictly; ``params.txt`` has the JAX engine's lines; the logs read back
  through tensorboard's ``EventAccumulator`` under the JAX tags;
  ``resume-train`` from epoch2 runs epoch 3 alone at the uninterrupted
  run's learning rate and carries ``best_validation_dict``; checkpoints
  written by the JAX package and in the reference's torch layout resume;
  one of device 'tpu' resumes on the card, so it raises here; early
  stopping stops and still writes ``final.weights``.
"""

import glob
import os
import re
import shutil

import numpy as np
import pytest
import torch

import jax
from dualsuperreslearningforsemseg_tpu import settings as jax_settings
from dualsuperreslearningforsemseg_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from dualsuperreslearningforsemseg_tpu.models import (
    DSRL as JaxDSRL, flatten_variables, init_model_host, load_state_dict as jax_load_state_dict,
    state_dict as jax_state_dict)
from dualsuperreslearningforsemseg_tpu.models.state_dict import _to_torch_name_and_array
from dualsuperreslearningforsemseg_tpu.train import (
    load_optimizer_state_dict as jax_load_optimizer_state_dict,
    optimizer_state_dict as jax_optimizer_state_dict, sgd_init, sgd_update)
from dualsuperreslearningforsemseg_tpu_torch import settings
from dualsuperreslearningforsemseg_tpu_torch.__main__ import main
from dualsuperreslearningforsemseg_tpu_torch.checkpoint import (
    load_checkpoint_or_weights, save_checkpoint)
from dualsuperreslearningforsemseg_tpu_torch.data import make_synthetic_cityscapes_tree
from dualsuperreslearningforsemseg_tpu_torch.models import DSRL, load_state_dict, \
    port_state_dict_from_jax
from dualsuperreslearningforsemseg_tpu_torch.train import (
    load_optimizer_state_dict, make_sgd, momentum_tensors, optimizer_state_dict)
from tests.test_optim_torch_interop import _torch_trained_checkpoint

LR, MOMENTUM, WD = 0.01, 0.9, 5e-4
ARGS = ['train', '--device', 'cpu', '--batch-size', '2', '--num-workers', '0',
        '--dataset', 'cityscapes', '--val-interval', '1']


@pytest.fixture
def tmp(tmp_path):
    """``tmp_path``, emptied afterwards: a checkpoint here is 0.2 GB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _jax_variables(stage):
    return init_model_host(JaxDSRL(stage=stage, num_classes=19), jax_settings.MODEL_INPUT_SIZE)


def _torch_named(tree):
    """A JAX params-shaped tree -> {torch name: array in torch's layout}."""
    return dict(_to_torch_name_and_array(k, v) for k, v in flatten_variables({'params': tree}).items())


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: rng.standard_normal(np.shape(x)).astype(np.float32), tree)


def _port_model(stage, variables=None):
    model = DSRL(num_classes=19, stage=stage)
    if variables is not None:
        load_state_dict(model, port_state_dict_from_jax(variables), strict=True)
    return model, make_sgd(model, LR, MOMENTUM, WD)


def _jax_momentum_from(variables, export):
    """The JAX package's strict loaders on a port export."""
    _, missing, unexpected = jax_load_state_dict(variables, export['model_state_dict'], strict=True)
    assert not missing and not unexpected
    return jax_load_optimizer_state_dict(sgd_init(variables['params']),
                                         export['optimizer_state_dict'])


def test_momentum_round_trips_through_the_jax_layout():
    variables = _jax_variables(3)
    jax_export = jax_optimizer_state_dict(_random_like(variables['params'], 1), LR, MOMENTUM, WD)
    model, optimizer = _port_model(3, variables)
    load_optimizer_state_dict(optimizer, model, jax_export)
    mine = optimizer_state_dict(optimizer, model, LR, MOMENTUM, WD)
    assert mine['hyperparameters'] == jax_export['hyperparameters']
    assert set(mine['momentum_buffers']) == set(jax_export['momentum_buffers'])
    for name, buf in jax_export['momentum_buffers'].items():
        np.testing.assert_array_equal(mine['momentum_buffers'][name], buf, err_msg=name)

    momentum = _jax_momentum_from(variables, {
        'model_state_dict': {k: v.numpy() for k, v in model.state_dict().items()},
        'optimizer_state_dict': mine})
    back = _torch_named(momentum)
    assert set(back) == set(mine["momentum_buffers"]) and len(back) > 100
    for name, buf in mine['momentum_buffers'].items():
        np.testing.assert_array_equal(back[name], buf, err_msg=name)


def test_load_rejects_missing_and_unknown_names():
    model, optimizer = _port_model(1)
    export = optimizer_state_dict(optimizer, model, LR, MOMENTUM, WD)
    missing = dict(export, momentum_buffers=dict(export['momentum_buffers']))
    missing['momentum_buffers'].pop(next(iter(missing['momentum_buffers'])))
    with pytest.raises(KeyError, match='lacks'):
        load_optimizer_state_dict(optimizer, model, missing)
    unknown = dict(export, momentum_buffers=dict(export['momentum_buffers'], nowhere=np.zeros(1)))
    with pytest.raises(KeyError, match='unknown'):
        load_optimizer_state_dict(optimizer, model, unknown)


def test_one_sgd_step_after_the_carry_matches_jax():
    variables = _jax_variables(3)
    params = variables['params']
    momentum = _random_like(params, 2)
    grads = _random_like(params, 3)
    lr = 0.0072
    new_params, new_bufs = sgd_update(params, grads, momentum, lr, MOMENTUM, WD)

    model, optimizer = _port_model(3, variables)
    load_optimizer_state_dict(optimizer, model, jax_optimizer_state_dict(momentum, LR, MOMENTUM, WD))
    torch_grads = _torch_named(grads)
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(np.ascontiguousarray(torch_grads[name]))
    optimizer.param_groups[0]['lr'] = lr
    optimizer.step()

    want_params, want_bufs = _torch_named(new_params), _torch_named(new_bufs)
    got_bufs = momentum_tensors(optimizer, model)
    for name, p in model.named_parameters():
        for got, want in ((p.detach().numpy(), want_params[name]), (got_bufs[name].numpy(), want_bufs[name])):
            scale = max(float(np.abs(want).max()), 1e-30)
            assert np.abs(got - np.asarray(want)).max() <= 1e-6 * scale, name


@pytest.mark.parametrize('drop_first', [False, True])
def test_reference_layout_gives_the_jax_buffers(tmp, drop_first):
    path = str(tmp / 'epoch1.checkpoint')
    _torch_trained_checkpoint(path)
    loaded = load_checkpoint_or_weights(path)
    osd = loaded['optimizer_state_dict']
    if drop_first:   # a parameter torch never stepped has no state entry
        del osd['state'][osd['param_groups'][0]['params'][0]]
    msd = {k: v.numpy() for k, v in loaded['model_state_dict'].items()}

    variables = _jax_variables(3)
    variables, _, _ = jax_load_state_dict(variables, msd, strict=True)
    want = _torch_named(jax_load_optimizer_state_dict(sgd_init(variables['params']), osd,
                                                      model_state_dict=msd))
    model, optimizer = _port_model(3)
    load_state_dict(model, loaded['model_state_dict'], strict=True)
    load_optimizer_state_dict(optimizer, model, osd, model_state_dict=loaded['model_state_dict'])
    got = momentum_tensors(optimizer, model)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=name)
    first = next(iter(msd))
    params = dict(model.named_parameters())
    assert ('momentum_buffer' in optimizer.state[params[first]]) != drop_first
    assert any(np.abs(v).max() > 0 for v in want.values())


def _write_data(root):
    data = os.path.join(root, 'datasets', 'Cityscapes', 'data')
    make_synthetic_cityscapes_tree(data, split='train', num_images=4, size_hw=(128, 256), seed=1)
    make_synthetic_cityscapes_tree(data, split='val', num_images=3, size_hw=(128, 256), seed=2)


@pytest.fixture(scope='module')
def run3(tmp_path_factory):
    """One ``train`` of 3 epochs with an autosave each epoch and history 2;
    its summary and stdout, before any resume rewrites them."""
    root = str(tmp_path_factory.mktemp('torch_resume'))
    _write_data(root)
    old = os.getcwd()
    os.chdir(root)
    res = main(ARGS + ['--stage', '1', '--epochs', '3', '--checkpoint-interval', '1',
                       '--checkpoint-history', '2', '--experiment-id', 'state',
                       '--description', 'resume test'])
    logs = os.path.join('experiments', 'state', 'logs', 'stage1')
    with open(os.path.join(logs, 'train', 'stdout.txt')) as f:
        stdout = f.read()
    with open(os.path.join(logs, 'train', 'params.txt')) as f:
        params = f.read()
    yield {'res': res, 'stdout': stdout, 'params': params, 'logs': logs}
    os.chdir(old)
    shutil.rmtree(root, ignore_errors=True)


def _checkpoints():
    return sorted(os.path.basename(p) for p in glob.glob(
        os.path.join('experiments', 'state', 'weights', 'stage1', 'checkpoints', '*.checkpoint')))


def test_autosave_prunes_and_keeps_one_bestval(run3):
    names = _checkpoints()
    bestval = [n for n in names if n.endswith('_bestval.checkpoint')]
    assert [n for n in names if n not in bestval] == ['epoch2.checkpoint', 'epoch3.checkpoint']
    assert len(bestval) == 1
    assert bestval[0] == 'epoch{}_bestval.checkpoint'.format(run3['res']['best_validation']['epoch'])
    variables = _jax_variables(1)
    for name in ('epoch2.checkpoint', 'epoch3.checkpoint') + tuple(bestval):
        ckpt = load_checkpoint_or_weights(os.path.join(
            'experiments', 'state', 'weights', 'stage1', 'checkpoints', name))
        assert len(settings.VARIABLES_IN_CHECKPOINT) == 36
        assert set(ckpt) == set(settings.VARIABLES_IN_CHECKPOINT), name
        assert ckpt['device'] == 'cpu' and ckpt['stage'] == 1 and ckpt['epochs'] == 3
        assert ckpt['experiment_id'] == os.path.join('experiments', 'state')
        momentum = _torch_named(_jax_momentum_from(variables, ckpt))
        for key, buf in ckpt['optimizer_state_dict']['momentum_buffers'].items():
            np.testing.assert_array_equal(momentum[key], buf, err_msg=key)
        assert any(np.abs(b).max() > 0 for b in ckpt['optimizer_state_dict']['momentum_buffers'].values())
    epoch3 = load_checkpoint_or_weights(os.path.join(
        'experiments', 'state', 'weights', 'stage1', 'checkpoints', 'epoch3.checkpoint'))
    assert epoch3['epoch'] == 3
    # The autosave precedes the epoch's validation (train_or_resume.py:357-401
    # there): epoch 3's holds epoch 3's train losses and epoch 2's val losses.
    val_ce = [float(x) for x in re.findall(r"Validation results:\nAvg. CE: ([0-9.]+)", run3['stdout'])]
    assert len(val_ce) == 3
    assert epoch3['CE_val_avg_loss'] == pytest.approx(val_ce[1], abs=5e-5)
    assert epoch3['CE_train_avg_loss'] == run3['res']['train_losses'][2]['CE']


def test_params_file_has_the_jax_engine_lines(run3):
    lines = run3['params'].split('\n')
    assert re.fullmatch(r'Timestamp: .+', lines[0])
    assert lines[1:] == [
        'Device: cpu', 'No. of workers: 0', 'Dataset: cityscapes',
        'Dataset path: ' + os.path.join('datasets', 'Cityscapes', 'data'),
        'Validation interval: 1', 'Checkpoint interval: 1', 'Checkpoint history: 2',
        'Batch size: 2', 'Epochs: 3', 'Learning rate: 0.010000', 'End learning rate: 0.001000',
        'Momentum: 0.900000', 'Weights decay: 0.000500', 'Poly power: 0.900000', 'Stage: 1',
        'Freeze batch normalization: False',
        'Experiment ID: ' + os.path.join('experiments', 'state'),
        'Description: resume test', 'Early stopping: False', 'Devices: 1 x cpu']


def test_logs_read_back_under_the_jax_tags(run3):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    train = EventAccumulator(os.path.join(run3['logs'], 'train'))
    train.Reload()
    val = EventAccumulator(os.path.join(run3['logs'], 'val'))
    val.Reload()
    assert sorted(train.Tags()['scalars']) == ['Stage 1/CE Loss', 'Stage 1/Learning rate']
    assert sorted(val.Tags()['scalars']) == ['Stage 1/Accuracy %', 'Stage 1/CE Loss', 'Stage 1/mIoU %']
    ce = train.Scalars('Stage 1/CE Loss')
    assert [e.step for e in ce] == [1, 2, 3]
    np.testing.assert_allclose([e.value for e in ce],
                               [d['CE'] for d in run3['res']['train_losses']], rtol=1e-6)
    assert train.Scalars('Stage 1/Learning rate')[0].value == pytest.approx(0.01)
    assert val.Scalars('Stage 1/mIoU %')[-1].value == pytest.approx(run3['res']['val']['mIoU'], rel=1e-6)
    texts = [e.tensor_proto.string_val[0].decode() for e in train.Tensors('INFO/text_summary')]
    assert texts[0].startswith('Total training parameters: ') and 'Training took' in texts[-1]
    images = val.Images('EXAMPLE')
    oh, ow = settings.MODEL_OUTPUT_SIZE
    assert [e.step for e in images] == [1, 2, 3] and (images[0].height, images[0].width) == (oh, 3 * ow)


def _epoch_lr(stdout, epoch, epochs):
    return re.search(r"=> EPOCH {}/{}\nLearning Rate: ([0-9.]+)".format(epoch, epochs), stdout).group(1)


def test_resume_runs_the_last_epoch_at_its_learning_rate(run3):
    ckpt_dir = os.path.join('experiments', 'state', 'weights', 'stage1', 'checkpoints')
    best = load_checkpoint_or_weights(os.path.join(ckpt_dir, 'epoch2.checkpoint'))['best_validation_dict']
    res = main(['resume-train', '--checkpoint', os.path.join(ckpt_dir, 'epoch2.checkpoint'),
                '--dataset', 'cityscapes'])
    with open(os.path.join(run3['logs'], 'train', 'stdout.txt')) as f:
        stdout = f.read()
    assert 'EPOCH 3/3' in stdout and 'EPOCH 1/3' not in stdout and 'EPOCH 2/3' not in stdout
    assert _epoch_lr(stdout, 3, 3) == _epoch_lr(run3['stdout'], 3, 3)
    assert res['starting_epoch'] == 2 and res['steps'] == 2 and len(res['train_losses']) == 1
    if res['val']['mIoU'] > best['best_miou_percent']:
        assert res['best_validation'] == {'epoch': 3, 'best_miou_percent': res['val']['mIoU'],
                                          'loss': res['val']['Total']}
    else:
        assert res['best_validation'] == best


def test_resume_carries_the_best_validation(run3):
    """An epoch-2 checkpoint whose best mIoU no run reaches: the resumed run
    keeps it, writes no new best-validation checkpoint and reports it."""
    src = os.path.join('experiments', 'state', 'weights', 'stage1', 'checkpoints', 'epoch2.checkpoint')
    ckpt = load_checkpoint_or_weights(src)
    carried = {'epoch': 2, 'best_miou_percent': 99.5, 'loss': 0.25}
    ckpt.update(best_validation_dict=carried, experiment_id=os.path.join('experiments', 'carry'))
    save_checkpoint('carry', 'epoch2.checkpoint', **ckpt)
    res = main(['resume-train', '--checkpoint', os.path.join('carry', 'epoch2.checkpoint'),
                '--dataset', 'cityscapes'])
    assert res['best_validation'] == carried
    assert [c['path'] for c in res['checkpoints']] == [os.path.join(
        'experiments', 'carry', 'weights', 'stage1', 'checkpoints', 'epoch3.checkpoint')]
    with open(os.path.join('experiments', 'carry', 'logs', 'stage1', 'train', 'stdout.txt')) as f:
        assert 'Best mIoU % yet is 99.50 at epoch 2.' in f.read()
    again = load_checkpoint_or_weights(res['checkpoints'][0]['path'])
    assert again['best_validation_dict'] == carried and again['epoch'] == 3
    _remove('carry', os.path.join('experiments', 'carry'))


def _remove(*dirs):
    """Drops a finished test's checkpoints (0.2 GB each) from the module's
    shared directory."""
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)


def _jax_checkpoint(path, device, stage=2):
    """A checkpoint written with the JAX package's own functions."""
    variables = _jax_variables(stage)
    momentum = _random_like(variables['params'], 4)
    jax_save_checkpoint(
        os.path.dirname(path), os.path.basename(path),
        device=device, mixed_precision=None, amp_state_dict=None, disable_cudnn_benchmark=False,
        num_workers=0, val_interval=1, checkpoint_interval=1, checkpoint_history=1,
        init_weights=None, batch_size=2, epochs=2, learning_rate=0.01, end_learning_rate=0.001,
        momentum=0.9, weights_decay=5e-4, poly_power=0.9, stage=stage, w1=0.1, w2=1.0,
        freeze_batch_norm=False, experiment_id=os.path.join('experiments', 'from_jax'),
        description='written by the JAX package', early_stopping=False,
        CE_train_avg_loss=3.0, MSE_train_avg_loss=0.5, FA_train_avg_loss=0.0, Avg_train_loss=3.5,
        CE_val_avg_loss=3.0, MSE_val_avg_loss=0.5, FA_val_avg_loss=0.0, Avg_val_loss=3.5, epoch=1,
        best_validation_dict={'epoch': 1, 'best_miou_percent': 1.0, 'loss': 3.5},
        model_state_dict=jax_state_dict(variables),
        optimizer_state_dict=jax_optimizer_state_dict(momentum, 0.01, 0.9, 5e-4))


def test_a_jax_checkpoint_resumes_in_the_port(run3):
    path = os.path.join('from_jax', 'epoch1.checkpoint')
    _jax_checkpoint(path, 'cpu')
    res = main(['resume-train', '--checkpoint', path, '--dataset', 'cityscapes'])
    assert res['starting_epoch'] == 1 and len(res['train_losses']) == 1
    assert all(np.isfinite(v) for v in res['train_losses'][0].values())
    with open(os.path.join('experiments', 'from_jax', 'logs', 'stage2', 'train', 'stdout.txt')) as f:
        stdout = f.read()
    assert 'EPOCH 2/2' in stdout and 'EPOCH 1/2' not in stdout
    assert os.path.isfile(res['final_weights'])
    _remove('from_jax', os.path.join('experiments', 'from_jax'))


def test_a_tpu_checkpoint_needs_the_card(run3):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card, so the checkpoint's device is usable")
    path = os.path.join('from_tpu', 'epoch1.checkpoint')
    _jax_checkpoint(path, 'tpu', stage=1)
    with pytest.raises(RuntimeError, match='--device cpu'):
        main(['resume-train', '--checkpoint', path, '--dataset', 'cityscapes'])
    _remove('from_tpu')


def test_a_reference_checkpoint_resumes_at_stage_3(run3):
    path = os.path.join('reference', 'epoch1.checkpoint')
    os.makedirs('reference', exist_ok=True)
    _torch_trained_checkpoint(path, epoch=1, epochs=2)
    res = main(['resume-train', '--checkpoint', path, '--dataset', 'cityscapes'])
    assert res['final_weights'] == os.path.join('weights', 'stage3', 'final.weights')
    assert set(res['train_losses'][0]) == {'CE', 'MSE', 'FA', 'Total'}
    assert res['train_losses'][0]['FA'] > 0 and res['starting_epoch'] == 1
    with open(os.path.join('logs', 'stage3', 'train', 'stdout.txt')) as f:
        stdout = f.read()
    assert 'EPOCH 2/2' in stdout and 'EPOCH 1/2' not in stdout
    _remove('reference', 'weights', 'logs')


def test_early_stopping_stops_and_writes_the_weights(tmp, monkeypatch):
    """As tests/test_cli.py's early-stopping case: the val labels are one
    class whatever the image shows, so the validation loss stays above the
    training loss, which falls as the model learns the colours."""
    _write_data(str(tmp))
    for path in glob.glob(str(tmp / 'datasets' / 'Cityscapes' / 'data' / 'gtFine' / 'val' / '*' /
                              '*.png')):
        from PIL import Image
        Image.fromarray(np.full((128, 256), 26, np.uint8)).save(path)   # labelId 26: car
    monkeypatch.chdir(tmp)
    res = main(ARGS + ['--stage', '1', '--epochs', '50', '--checkpoint-history', '0',
                       '--learning-rate', '0.05', '--early-stopping', '--experiment-id', 'stop'])
    with open(os.path.join('experiments', 'stop', 'logs', 'stage1', 'train', 'stdout.txt')) as f:
        stdout = f.read()
    assert 'Early stopping was triggered at epoch {}.'.format(res['early_stopped_at']) in stdout
    assert res['early_stopped_at'] < 50 and len(res['train_losses']) == res['early_stopped_at']
    assert os.path.isfile(os.path.join('experiments', 'stop', 'weights', 'stage1', 'final.weights'))
    assert not glob.glob(os.path.join('experiments', 'stop', 'weights', 'stage1', 'checkpoints',
                                      'epoch?.checkpoint'))
