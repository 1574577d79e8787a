"""The port's ``test`` dataset mode, ``compile-model`` and ``test
--compiled-model`` on the CPU, against the JAX package's commands on the
same stage-1 ``.weights`` (written by the JAX package) and the same
synthetic Cityscapes val split.

* ``test --dataset cityscapes val 2 --no-interactive`` writes the JAX
  command's files (``2.png`` ...), each a [target | prediction] pair of
  [input | classes | overlay] strips: the target halves bitwise equal, the
  prediction halves equal except at pixels whose JAX top-2 logits lie
  within 1e-4 (the two forwards sum in another order).
* ``compile-model`` writes a ``torch.export`` program of more than 1 MB
  (the weights are inside); ``test --compiled-model`` then writes the same
  PNGs as the eager ``test``, and the program's logits equal the eager
  model's bitwise on the CPU.
* An export that is the first forward of a process leaves the in-graph
  resize's matrix cache (``ops/resize.py``) clean: the eager forward after
  it, in that process, returns a real tensor bitwise equal to this
  process's eager result.
"""

import importlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from dualsuperreslearningforsemseg_tpu import settings as jax_settings
from dualsuperreslearningforsemseg_tpu.checkpoint import save_weights
from dualsuperreslearningforsemseg_tpu.data import make_synthetic_cityscapes_tree
from dualsuperreslearningforsemseg_tpu.models import DSRL as JaxDSRL, init_model_host, state_dict
from dualsuperreslearningforsemseg_tpu_torch import settings
from dualsuperreslearningforsemseg_tpu_torch.__main__ import main
from dualsuperreslearningforsemseg_tpu_torch.commands.compile_model import load_compiled_model
from dualsuperreslearningforsemseg_tpu_torch.commands.test import load_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join('weights', 'stage1.weights')
TIE_EPS = 1e-4


@pytest.fixture(scope='module')
def workdir(tmp_path_factory):
    wd = tmp_path_factory.mktemp('torch_test_modes')
    data_root = os.path.join(str(wd), 'datasets', 'Cityscapes', 'data')
    make_synthetic_cityscapes_tree(data_root, split='val', num_images=4, size_hw=(64, 128), seed=7)
    variables = init_model_host(JaxDSRL(stage=1, num_classes=19), jax_settings.MODEL_INPUT_SIZE)
    save_weights(os.path.join(str(wd), 'weights'), 'stage1.weights', state_dict(variables), None)
    old = os.getcwd()
    os.chdir(str(wd))
    try:
        yield str(wd)
    finally:   # 0.2 GB of weights and exported programs
        os.chdir(old)
        shutil.rmtree(str(wd), ignore_errors=True)


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im)


def _jax_logits(index):
    """The JAX stage-1 logits (H, W, C) of val frame ``index``, through the
    JAX package's eval transform and forward."""
    jax_test = importlib.import_module('dualsuperreslearningforsemseg_tpu.commands.test')
    from dualsuperreslearningforsemseg_tpu.data import AugmentConfig, make_eval_transform_fn
    dataset = dict(jax_settings.DATASETS['cityscapes'], split='val')
    ds = dataset['settings']
    forward = jax_test._build_forward(WEIGHTS, dataset, False)
    eval_fn = make_eval_transform_fn(AugmentConfig(input_hw=jax_settings.MODEL_INPUT_SIZE,
                                                   output_hw=jax_settings.MODEL_OUTPUT_SIZE,
                                                   mean=ds.MEAN, std=ds.STD), ds.LABEL_MAPPING_LUT)
    img, seg = dataset['class'](dataset['path'], split='val')[index]
    (img_lo, _), _ = eval_fn(img[None], seg[None])
    return np.asarray(forward(img_lo))[0]


def test_dataset_mode_matches_jax(workdir):
    jax_test = importlib.import_module('dualsuperreslearningforsemseg_tpu.commands.test')
    jax_test.test(image_file=None, images_dir=None, output_dir='out_jax', weights=WEIGHTS,
                  device='cpu', compiled_model=False, no_interactive=True,
                  dataset=dict(jax_settings.DATASETS['cityscapes'], split='val', starting_index=2))
    res = main(['test', '--dataset', 'cityscapes', 'val', '2', '--no-interactive', '--device', 'cpu',
                '--weights', WEIGHTS, '--output-dir', 'out_port'])
    names = sorted(os.listdir('out_jax'))
    assert names == ['2.png', '3.png'] == sorted(os.listdir('out_port'))
    assert res['outputs'] == [os.path.join('out_port', n) for n in names]
    oh, ow = settings.MODEL_OUTPUT_SIZE
    for name in names:
        ref, mine = _png(os.path.join('out_jax', name)), _png(os.path.join('out_port', name))
        assert ref.shape == mine.shape == (2 * oh, 3 * ow, 3)
        np.testing.assert_array_equal(mine[:oh], ref[:oh])          # target half
        np.testing.assert_array_equal(mine[oh:, :ow], ref[oh:, :ow])  # its input panel
        differ = np.any(mine[oh:] != ref[oh:], axis=-1)
        differ = differ[:, ow:2 * ow] | differ[:, 2 * ow:]           # classes, overlay
        if differ.any():
            top2 = np.sort(_jax_logits(int(name[:-4])), axis=-1)[..., -2:]
            near_tie = (top2[..., 1] - top2[..., 0]) <= TIE_EPS
            assert np.all(near_tie[differ]), int((differ & ~near_tie).sum())


def test_compiled_model_matches_eager(workdir):
    res = main(['compile-model', '--weights', WEIGHTS, '--output-file', 'model.pt2',
                '--device', 'cpu'])
    assert res['bytes'] == os.path.getsize('model.pt2') > 1_000_000 and res['seconds'] > 0
    rng = np.random.default_rng(11)
    os.makedirs('frames', exist_ok=True)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, size=(70, 150, 3)).astype(np.uint8)).save(
            os.path.join('frames', 'f{}.png'.format(i)))
    eager = main(['test', '--images-dir', 'frames', '--device', 'cpu', '--weights', WEIGHTS,
                  '--output-dir', 'out_eager'])
    compiled = main(['test', '--images-dir', 'frames', '--device', 'cpu', '--weights', 'model.pt2',
                     '--compiled-model', '--output-dir', 'out_compiled'])
    assert len(eager['outputs']) == len(compiled['outputs']) == 2
    for a, b in zip(eager['outputs'], compiled['outputs']):
        np.testing.assert_array_equal(_png(a), _png(b))

    cpu = torch.device('cpu')
    x = torch.from_numpy(rng.standard_normal((1, 3, *settings.MODEL_INPUT_SIZE)).astype(np.float32))
    with torch.inference_mode():
        ref = load_model(WEIGHTS, 19, cpu)(x)[0]
        got = load_compiled_model('model.pt2', cpu)(x)[0]
    assert type(got) is torch.Tensor and got.shape == (1, 19, *settings.MODEL_OUTPUT_SIZE)
    assert torch.equal(got, ref)


_EXPORT_FIRST = """
import sys
import numpy as np
import torch
from dualsuperreslearningforsemseg_tpu_torch.models import DSRL
torch.manual_seed(3)
model = DSRL(19).eval()
x = torch.from_numpy(np.load(sys.argv[1]))
torch.export.export(model, (x,))
with torch.no_grad():
    y = model(x)[0]
assert type(y) is torch.Tensor, type(y)
np.save(sys.argv[2], y.numpy())
"""


def test_eager_forward_after_an_export_is_real(workdir):
    from dualsuperreslearningforsemseg_tpu_torch.models import DSRL
    x = np.random.default_rng(5).standard_normal((1, 3, *settings.MODEL_INPUT_SIZE)).astype(np.float32)
    np.save('x.npy', x)
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, '-c', _EXPORT_FIRST, 'x.npy', 'y.npy'], env=env, check=True,
                   timeout=300)
    torch.manual_seed(3)
    model = DSRL(19).eval()
    with torch.no_grad():
        ref = model(torch.from_numpy(x))[0].numpy()
    np.testing.assert_array_equal(np.load('y.npy'), ref)
