"""CPU tests of the benchmark.  The program runs here at the test suite's
small size: the model input 64x128 and a (1, 1, 2, 1) backbone, set before
anything imports it.  Tests that need a card carry the ``cuda`` marker and
skip where torch sees none."""

import os
import sys

import pytest

os.environ['DSRL_TPU_MODEL_INPUT_SIZE'] = '64x128'
os.environ['DSRL_TPU_BACKBONE_LAYERS'] = '1,1,2,1'
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips where torch sees none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; torch sees none")


def tiny_cell(name):
    """The cell ``name`` at the small size, on its own limits: the program's
    input size above, the output scaled alike, and what its model module's
    ``tiny`` shrinks."""
    from portbench import core
    from portbench.models import find
    cell = core.Cell(name)
    cfg = cell.cfg
    out_hw = [n * o // i for n, o, i in zip((64, 128), cfg['output_hw'], cfg['input_hw'])]
    cell.cfg = dict(cfg, input_hw=[64, 128], output_hw=out_hw, **find(cfg).tiny(cfg))
    traffic = dict(cell.traffic)
    if traffic['driver'] == 'test':
        traffic.update(pool_frames=3, check_every=1)
    else:
        traffic.update(batch=4, pool_frames=9, frame_hw=[256, 512], check_every=1)
    cell.traffic = traffic
    return cell
