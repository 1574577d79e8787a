"""The port's command line against the JAX package's, on a synthetic
Cityscapes tree and the same stage-1 ``.weights`` (written by the JAX
package).

``benchmark``: mIoU and accuracy agree to the 2 printed decimals and CE
within 1e-3 (the JAX figure is printed to 3 decimals).  ``test
--image-file`` writes its [input | classes | overlay] PNG.
"""

import importlib
import os
import re
import shutil

import numpy as np
import pytest
from PIL import Image

from dualsuperreslearningforsemseg_tpu import settings as jax_settings
from dualsuperreslearningforsemseg_tpu.checkpoint import save_weights
from dualsuperreslearningforsemseg_tpu.data import make_synthetic_cityscapes_tree
from dualsuperreslearningforsemseg_tpu.models import DSRL as JaxDSRL, init_model_host, state_dict
from dualsuperreslearningforsemseg_tpu_torch import settings
from dualsuperreslearningforsemseg_tpu_torch.__main__ import main


@pytest.fixture(scope='module')
def workdir(tmp_path_factory):
    wd = tmp_path_factory.mktemp('torch_cli')
    data_root = os.path.join(str(wd), 'datasets', 'Cityscapes', 'data')
    make_synthetic_cityscapes_tree(data_root, split='val', num_images=6, size_hw=(64, 128), seed=7)
    variables = init_model_host(JaxDSRL(stage=1, num_classes=19), jax_settings.MODEL_INPUT_SIZE)
    save_weights(os.path.join(str(wd), 'weights'), 'stage1.weights', state_dict(variables), None)
    old = os.getcwd()
    os.chdir(str(wd))
    try:
        yield str(wd)
    finally:   # 0.1 GB of weights
        os.chdir(old)
        shutil.rmtree(str(wd), ignore_errors=True)


def _results(text):
    return {m.group(1): m.group(2) for m in re.finditer(
        r'(Cross Entropy Error|mIoU %|Mean Accuracy %): ([0-9.nan]+)', text)}


def test_benchmark_matches_jax(workdir):
    assert settings.MODEL_INPUT_SIZE == jax_settings.MODEL_INPUT_SIZE == (64, 128)
    weights = os.path.join('weights', 'stage1.weights')
    jax_benchmark = importlib.import_module('dualsuperreslearningforsemseg_tpu.commands.benchmark')
    jax_benchmark.benchmark(weights=weights, dataset=dict(jax_settings.DATASETS['cityscapes'], split='val'),
                            device='cpu', num_workers=1, batch_size=4)
    with open(os.path.join('outputs', 'benchmark.txt')) as f:
        ref = _results(f.read())

    res = main(['benchmark', '--weights', weights, '--dataset', 'cityscapes', 'val',
                '--device', 'cpu', '--batch-size', '4', '--num-workers', '0'])
    with open(os.path.join('outputs', 'benchmark.txt')) as f:
        mine = _results(f.read())
    assert res['images'] == 6 and 'nan' not in mine.values()
    assert mine['mIoU %'] == ref['mIoU %'] and mine['Mean Accuracy %'] == ref['Mean Accuracy %']
    assert abs(res['CE'] - float(ref['Cross Entropy Error'])) <= 1e-3


def test_single_image_writes_png(workdir):
    img = np.random.default_rng(3).integers(0, 255, size=(100, 150, 3)).astype(np.uint8)
    Image.fromarray(img).save('sample.png')
    main(['test', '--image-file', 'sample.png', '--device', 'cpu',
          '--weights', os.path.join('weights', 'stage1.weights'), '--output-dir', 'outputs'])
    with Image.open(os.path.join('outputs', 'sample.png')) as out:
        oh, ow = settings.MODEL_OUTPUT_SIZE
        assert out.size == (3 * ow, oh)
        strip = np.asarray(out)
    assert strip.dtype == np.uint8 and np.any(strip[:, ow:2 * ow] != 0)
