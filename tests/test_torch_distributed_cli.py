"""``train --distributed`` and ``resume-train --distributed`` of the port's
CLI on two CPU ranks (gloo), each command in a session of its own that is
killed when its timeout passes (tests/torch_distributed_ranks.py).

``train --device cpu --stage 1 --epochs 2 --batch-size 1 --val-interval 1
--checkpoint-interval 1 --distributed 127.0.0.1 <port> 1 2 gloo ' ' 0`` on
4 train and 5 val frames (2 steps an epoch; the val split padded to 6, one
entry masked):

* both ranks print the same ``PARAM_DIGEST`` of their final parameters;
* one ``final.weights``, one ``epoch{1,2}.checkpoint``, one best-validation
  checkpoint, one ``params.txt``, one ``stdout.txt`` (the master's) and one
  event file in each log directory;
* the last validation's mIoU and accuracy are those of the single-process
  ``benchmark --batch-size 2`` of ``final.weights`` to the printed 2
  decimals, and its CE within 1e-3: with rank-strided shards the 2-rank
  pass sees the benchmark's batches of 2 (the last one a single frame), and
  both weight each batch's pixel-mean CE by its real frames;
* ``resume-train --distributed`` from ``epoch1.checkpoint`` runs epoch 2 on
  both ranks, whose digests agree, at the uninterrupted run's learning rate;
* with ``--profile`` every rank writes its own Chrome trace,
  ``outputs/profile/profiling_rank{0,1}.json``, and the master alone prints
  where they went.
"""

import json
import os
import re
import shutil
import sys

import pytest

from dualsuperreslearningforsemseg_tpu_torch.__main__ import main
from dualsuperreslearningforsemseg_tpu_torch.data import make_synthetic_cityscapes_tree

import torch_distributed_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(workdir, *argv):
    env = dict(os.environ, PYTHONPATH=REPO, DSRL_TPU_DEBUG_PARAM_DIGEST='1', OMP_NUM_THREADS='2')
    code, out, err = ranks.run_command(
        [sys.executable, '-m', 'dualsuperreslearningforsemseg_tpu_torch', *argv,
         '--distributed', '127.0.0.1', str(ranks.free_port()), '1', '2', 'gloo', ' ', '0'],
        workdir, env)
    assert code == 0, err[-3000:]
    digests = dict(re.findall(r'PARAM_DIGEST rank=(\d) epoch=2 ([0-9a-f]{64})', out))
    assert sorted(digests) == ['0', '1'] and digests['0'] == digests['1'], out[-2000:]
    return out


def _files(root, name):
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f == name]


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """The work tree, deleted when the test ends, passed or failed: its
    checkpoints, weights and traces take ~0.7 GB."""
    try:
        data_root = os.path.join(str(tmp_path), 'datasets', 'Cityscapes', 'data')
        make_synthetic_cityscapes_tree(data_root, split='train', num_images=4,
                                       size_hw=(128, 256), seed=1)
        make_synthetic_cityscapes_tree(data_root, split='val', num_images=5,
                                       size_hw=(128, 256), seed=2)
        monkeypatch.chdir(tmp_path)
        yield str(tmp_path)
    finally:
        monkeypatch.undo()
        shutil.rmtree(str(tmp_path), ignore_errors=True)


def test_two_cpu_ranks_train_resume_and_validate_as_one_process(workdir):
    out = _cli(workdir, 'train', '--device', 'cpu', '--stage', '1', '--epochs', '2',
               '--batch-size', '1', '--num-workers', '0', '--dataset', 'cityscapes',
               '--val-interval', '1', '--checkpoint-interval', '1', '--experiment-id', 'dist',
               '--profile')
    profile_dir = os.path.join('outputs', 'profile')
    assert sorted(os.listdir(profile_dir)) == ['profiling_rank0.json', 'profiling_rank1.json']
    for name in os.listdir(profile_dir):
        with open(os.path.join(profile_dir, name)) as f:
            assert json.load(f)['traceEvents'], name
    assert out.count("Profiling output has been saved to '{}'.".format(profile_dir)) == 1
    stage = os.path.join('experiments', 'dist', 'weights', 'stage1')
    final = os.path.join(stage, 'final.weights')
    assert _files(workdir, 'final.weights') == [os.path.join(workdir, final)]
    checkpoints = set(os.listdir(os.path.join(stage, 'checkpoints')))
    bestval = [f for f in checkpoints if f.endswith('_bestval.checkpoint')]
    assert len(bestval) == 1 and checkpoints - set(bestval) == {'epoch1.checkpoint',
                                                                 'epoch2.checkpoint'}
    assert len(_files(workdir, 'params.txt')) == 1
    [stdout_file] = _files(workdir, 'stdout.txt')
    with open(stdout_file) as f:
        kept = f.read()
    assert 'PARAM_DIGEST rank=0' in kept and 'PARAM_DIGEST rank=1' not in kept
    for mode in ('train', 'val'):
        logs = os.path.join('experiments', 'dist', 'logs', 'stage1', mode)
        assert len([f for f in os.listdir(logs) if f not in ('params.txt', 'stdout.txt')]) == 1
    assert out.count('Validation results:') == 2 and 'Distributed: ' in open(_files(
        workdir, 'params.txt')[0]).read()

    ce, accuracy, miou = re.findall(
        r'Avg\. CE: ([0-9.]+), Accuracy %: ([0-9.]+), mIoU %: ([0-9.]+)', out)[-1]
    bench = main(['benchmark', '--weights', final, '--dataset', 'cityscapes', 'val', '--device',
                  'cpu', '--num-workers', '0', '--batch-size', '2'])
    assert bench['images'] == 5
    assert '{:.2f}'.format(bench['mIoU']) == miou and '{:.2f}'.format(bench['accuracy']) == accuracy
    assert abs(bench['CE'] - float(ce)) <= 1e-3

    rates = re.findall(r'=> EPOCH (\d)/2\s+Learning Rate: ([0-9.]+)', out)
    assert [epoch for epoch, _ in rates] == ['1', '2']
    resumed = _cli(workdir, 'resume-train', '--checkpoint',
                   os.path.join(stage, 'checkpoints', 'epoch1.checkpoint'), '--dataset', 'cityscapes')
    assert '=> EPOCH 1/2' not in resumed
    assert re.findall(r'=> EPOCH (\d)/2\s+Learning Rate: ([0-9.]+)', resumed) == rates[1:]
