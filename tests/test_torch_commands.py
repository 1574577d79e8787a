"""The port's small commands and scripts on the CPU, each against its JAX
counterpart on the same files:

* ``--help`` lists every command of ``main.py``; ``test --dataset`` takes
  ``NAME SPLIT START_INDEX`` with the JAX error for a negative index and
  excludes ``--image-file``;
* ``print-model --stage k``: the JAX counts line, with JAX ``count_params``'
  numbers, for stages 1-3;
* ``prune-weights`` and ``purne-weights`` of a JAX stage-3 ``.weights``:
  the result loads into the JAX stage-1 model with ``strict=True``, its
  tensors bitwise equal to the JAX command's; with ``--torch-format``
  ``torch.load`` of both ``.pth`` files gives the same keys, dtypes and
  bitwise-equal tensors (the JAX writer stores the 0-d ``num_batches_tracked``
  as shape (1,), the port as torch's 0-d tensor, which the port's model
  loads with ``strict=True``);
* ``inspect-checkpoint`` prints the JAX command's text;
* ``edit-checkpoint`` leaves the same dict as the JAX command, and an
  unknown ``--typeof`` raises its error;
* ``purge-weights-logs --stage 2`` and ``--all`` remove the directories the
  JAX command removes and exit 0;
* the scripts, through ``python -m
  dualsuperreslearningforsemseg_tpu_torch.run_script``'s ``main``: the help
  and exit codes of ``run_script.py``; ``calculate_dataset_mean_std``
  within 1e-12 of the JAX script; ``show_augmented_inputs_targets --limit 2
  --device cpu`` writes 2 [input | target | overlay] PNGs of the output
  size whose target colours are Cityscapes classes.
"""

import argparse
import importlib
import os
import re
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import main as jax_main
from dualsuperreslearningforsemseg_tpu import settings as jax_settings
from dualsuperreslearningforsemseg_tpu.checkpoint import (
    load_checkpoint_or_weights, save_checkpoint, save_weights)
from dualsuperreslearningforsemseg_tpu.data import make_synthetic_cityscapes_tree
from dualsuperreslearningforsemseg_tpu.models import (
    DSRL as JaxDSRL, count_params as jax_count_params, init_model_host, load_state_dict,
    state_dict)
from dualsuperreslearningforsemseg_tpu_torch import run_script, settings
from dualsuperreslearningforsemseg_tpu_torch.__main__ import _NOT_PORTED, build_parser, main
from dualsuperreslearningforsemseg_tpu_torch.datasets import cityscapes

ANSI = re.compile(r'\x1b\[[0-9;]*m')
JAX_DATASET = dict(jax_settings.DATASETS['cityscapes'])


def _jax_command(name):
    return getattr(importlib.import_module('dualsuperreslearningforsemseg_tpu.commands.' + name), name)


@pytest.fixture(scope='module')
def workdir(tmp_path_factory):
    wd = tmp_path_factory.mktemp('torch_commands')
    make_synthetic_cityscapes_tree(os.path.join(str(wd), 'datasets', 'Cityscapes', 'data'),
                                   split='train', num_images=3, size_hw=(64, 128), seed=5)
    variables = init_model_host(JaxDSRL(stage=3, num_classes=19), jax_settings.MODEL_INPUT_SIZE)
    save_weights(str(wd), 'stage3.weights', state_dict(variables), 'O1')
    save_checkpoint(str(wd), 'run.checkpoint', device='tpu', mixed_precision=None, epochs=3,
                    learning_rate=0.01, description='a "run"', freeze_batch_norm=False,
                    experiment_id='experiments/x', epoch=2,
                    best_validation_dict={'epoch': 1, 'mIoU': 2.5, 'loss': None},
                    model_state_dict={'a.weight': np.ones((2, 2), np.float32)},
                    optimizer_state_dict={'param_groups': [{'lr': 0.01}],
                                          'momentum_buffers': {'a.weight': np.zeros(2)}})
    old = os.getcwd()
    os.chdir(str(wd))
    try:
        yield str(wd)
    finally:   # 0.4 GB of weights and checkpoints
        os.chdir(old)
        shutil.rmtree(str(wd), ignore_errors=True)


def test_help_lists_every_command_of_main_py():
    def commands(parser):
        return set(next(a for a in parser._actions
                        if isinstance(a, argparse._SubParsersAction)).choices)

    jax_parser_source = open(jax_main.__file__).read()
    jax_commands = set(re.findall(r"add_parser\('([a-z-]+)'", jax_parser_source)) | \
        {'purne-weights', 'prune-weights'}
    assert commands(build_parser()) == jax_commands
    assert _NOT_PORTED == ()


def test_test_dataset_option_is_validated(workdir):
    parser = build_parser()
    args = parser.parse_args(['test', '--dataset', 'CityScapes', 'VAL', '7', '--weights', 'w'])
    assert args.dataset == ['cityscapes', 'val', 7]
    with pytest.raises(ValueError, match='Starting index must be an integer greater or equal to 0!'):
        parser.parse_args(['test', '--dataset', 'cityscapes', 'val', '-1', '--weights', 'w'])
    with pytest.raises(SystemExit):
        parser.parse_args(['test', '--dataset', 'cityscapes', 'val', '0', '--image-file', 'x.png',
                           '--weights', 'w'])


@pytest.mark.parametrize('stage', [1, 2, 3])
def test_print_model_counts_match_jax(workdir, capsys, stage):
    variables = init_model_host(JaxDSRL(stage=stage, num_classes=19), jax_settings.MODEL_INPUT_SIZE)
    trainable, total = jax_count_params(variables)
    assert main(['print-model', '--stage', str(stage)]) == (trainable, total)
    out = ANSI.sub('', capsys.readouterr().out)
    assert "INFO: Total training parameters: {0:,}\nTotal parameters: {1:,}".format(
        trainable, total) in out


@pytest.fixture(scope='module')
def jax_pruned(workdir):
    """The JAX command's pruned ``.weights`` and ``.pth`` of stage3.weights."""
    prune = _jax_command('prune_weights')
    prune(src_weights='stage3.weights', dest_weights='jax_pruned.weights', dataset=JAX_DATASET)
    prune(src_weights='stage3.weights', dest_weights='jax.pth', dataset=JAX_DATASET,
          torch_format=True)
    return 'jax_pruned.weights', 'jax.pth'


@pytest.mark.parametrize('command', ['prune-weights', 'purne-weights'])
def test_prune_weights_matches_jax(workdir, jax_pruned, command):
    main([command, '--src-weights', 'stage3.weights', '--dest-weights', 'pruned.weights'])
    ref, mine = load_checkpoint_or_weights(jax_pruned[0]), load_checkpoint_or_weights('pruned.weights')
    assert mine['mixed_precision'] == ref['mixed_precision'] == 'O1'
    variables = init_model_host(JaxDSRL(stage=1, num_classes=19), jax_settings.MODEL_INPUT_SIZE)
    load_state_dict(variables, mine['model_state_dict'], strict=True)
    assert set(mine['model_state_dict']) == set(ref['model_state_dict'])
    for key, value in ref['model_state_dict'].items():
        got = mine['model_state_dict'][key]
        assert got.dtype == value.dtype and np.array_equal(got, value), key
    os.remove('pruned.weights')


def test_prune_weights_torch_format_matches_jax(workdir, jax_pruned):
    main(['prune-weights', '--src-weights', 'stage3.weights', '--dest-weights', 'port.pth',
          '--torch-format'])
    ref = torch.load(jax_pruned[1], map_location='cpu', weights_only=True)
    mine = torch.load('port.pth', map_location='cpu', weights_only=True)
    assert set(mine) == set(ref) and len(mine) > 100
    for key, value in ref.items():
        if key.endswith('num_batches_tracked'):
            # The JAX writer's np.ascontiguousarray stores a 0-d array as
            # shape (1,); the port keeps torch's 0-d counter.
            assert value.shape == (1,) and mine[key].shape == ()
            value = value.reshape(())
        assert mine[key].dtype == value.dtype and torch.equal(mine[key], value), key
        assert mine[key].is_contiguous() and mine[key].device.type == 'cpu'
    from dualsuperreslearningforsemseg_tpu_torch.models import DSRL
    DSRL(num_classes=19).load_state_dict(mine, strict=True)


def test_inspect_checkpoint_prints_the_jax_text(workdir, capsys):
    _jax_command('inspect_checkpoint')(checkpoint='run.checkpoint')
    ref = capsys.readouterr().out
    main(['inspect-checkpoint', '--checkpoint', 'run.checkpoint'])
    assert capsys.readouterr().out == ref
    assert 'epochs: 3' in ref and 'model_state_dict: {a.weight}' in ref


@pytest.mark.parametrize('key, value, typeof', [
    ('description', 'edited', 'str'), ('epochs', '7', 'int'), ('learning_rate', '0.5', 'float'),
    ('freeze_batch_norm', 'yes', 'bool'), ('epochs', '1', 'no.such.type')])
def test_edit_checkpoint_matches_jax(workdir, key, value, typeof):
    for name in ('jax_edit.checkpoint', 'port_edit.checkpoint'):
        shutil.copy('run.checkpoint', name)
    edit = _jax_command('edit_checkpoint')
    if typeof == 'no.such.type':
        with pytest.raises(ValueError) as ref:
            edit(checkpoint='jax_edit.checkpoint', key=key, value=value, typeof=typeof)
        with pytest.raises(ValueError) as mine:
            main(['edit-checkpoint', '--checkpoint', 'port_edit.checkpoint', '--key', key,
                  '--value', value, '--typeof', typeof])
        assert str(mine.value) == str(ref.value)
        return
    edit(checkpoint='jax_edit.checkpoint', key=key, value=value, typeof=typeof)
    main(['edit-checkpoint', '--checkpoint', 'port_edit.checkpoint', '--key', key,
          '--value', value, '--typeof', typeof])
    ref = load_checkpoint_or_weights('jax_edit.checkpoint')
    mine = load_checkpoint_or_weights('port_edit.checkpoint')
    assert mine[key] == ref[key] and type(mine[key]) is type(ref[key])
    assert set(mine) == set(ref)
    for k in ref:
        if k not in ('model_state_dict', 'optimizer_state_dict'):
            assert mine[k] == ref[k], k
    np.testing.assert_array_equal(mine['model_state_dict']['a.weight'],
                                  ref['model_state_dict']['a.weight'])


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, dirs, files in os.walk(root) for n in dirs + files)


@pytest.mark.parametrize('which', [['--stage', '2'], ['--all']])
def test_purge_weights_logs_matches_jax(workdir, which):
    trees = {}
    for side in ('jax', 'port'):
        root = os.path.join(workdir, 'purge_' + side)
        for stage in (1, 2, 3):
            for d in (jax_settings.LOGS_DIR.format(stage=stage, mode='train'),
                      jax_settings.WEIGHTS_DIR.format(stage=stage)):
                os.makedirs(os.path.join(root, d), exist_ok=True)
                open(os.path.join(root, d, 'f'), 'w').close()
        os.makedirs(os.path.join(root, 'datasets'), exist_ok=True)
        os.chdir(root)
        try:
            with pytest.raises(SystemExit) as exc:
                if side == 'jax':
                    jax_main.parse_cmdline_and_invoke_main(['purge-weights-logs', '--yes'] + which)
                else:
                    main(['purge-weights-logs', '--yes'] + which)
            assert exc.value.code == 0
        finally:
            os.chdir(workdir)
        trees[side] = _tree(root)
    assert trees['port'] == trees['jax']
    assert ('weights/stage1' in trees['port']) == (which != ['--all'])


def test_run_script_help_and_unknown_name(capsys):
    assert run_script.main([]) == 0
    out = capsys.readouterr().out
    assert 'calculate_dataset_mean_std' in out and 'show_augmented_inputs_targets' in out
    assert run_script.main(['no_such_script']) == 1
    assert 'no_such_script' in capsys.readouterr().out


def test_calculate_dataset_mean_std_matches_jax(workdir):
    from scripts import calculate_dataset_mean_std as jax_script
    ref = jax_script(['--dataset', 'cityscapes', 'train'])
    mine = run_script.scripts.calculate_dataset_mean_std(['--dataset', 'cityscapes', 'train'])
    np.testing.assert_allclose(np.array(mine), np.array(ref), rtol=0, atol=1e-12)
    assert run_script.main(['calculate_dataset_mean_std', '--dataset', 'cityscapes', 'train']) == 0


def test_show_augmented_inputs_targets_writes_pngs(workdir):
    assert run_script.main(['show_augmented_inputs_targets', '--dataset', 'cityscapes', 'train',
                            '--limit', '2', '--device', 'cpu', '--output-dir', 'augmented']) == 0
    saved = sorted(os.listdir('augmented'))
    assert saved == ['augmented_0.png', 'augmented_1.png']
    oh, ow = settings.MODEL_OUTPUT_SIZE
    colours = {tuple(c) for c in cityscapes.CLASS_RGB_COLOR.values()}
    for name in saved:
        with Image.open(os.path.join('augmented', name)) as im:
            strip = np.asarray(im)
        assert strip.shape == (oh, 3 * ow, 3)
        target = {tuple(c) for c in strip[:, ow:2 * ow].reshape(-1, 3)}
        assert target <= colours and len(target) > 1
