"""The model modules (``portbench/models/``): the DSRL one keeps the seeded
weights and the FLOP counts the harness had before it, a second model is
added by its own module alone, a parameter that no seeding rule covers is
refused by name, and the run hands a configuration's sizes to the
program's settings."""

import hashlib
import os
import sys
import tokenize

import pytest
import torch

from portbench import core, roofline, run, weights
from portbench.drivers.common import port_model
from portbench.inputs import frame_pool
from portbench.models import find
from portbench.reference import train as reference_train

from . import tinynet
from .conftest import ROOT

# sha256 of every (name, dtype, shape, bytes) of make_state(cfg, seed, 'cpu'),
# in order, as the harness made them before its model modules.
STATE_DIGESTS = {
    ('dsrl_r101_stage1', 0): 'f9976de3f43b2b05afaf48d56d9d20bddf9451bfc2882ac8503166fdd135fbea',
    ('dsrl_r101_stage1', 7): '219d5d064add399cce6dc67d012f4130ebaa52cbf49fb6e19cb0d809fcf9d16b',
    ('dsrl_r101_stage1', 2 ** 31 + 99): '29a56775efe7e00b37ab854394ed4a001625dc3091d4ab9a98423c5c398d4af3',
    ('dsrl_r101_stage3', 0): '0cfa19bb1f1d2757665e747db6ba139745f35ab6b894b17f9530afdac59de223',
    ('dsrl_r101_stage3', 7): '326c9c9ae46addfcc3ad8b7d49abc2976d484528bb89b60a7b046dccd4fcdc32',
    ('dsrl_r101_stage3', 2 ** 31 + 99): '27cda5a8ade9733a1077da2267753bdd12f35b1c5cea662e633b9fe80e427c9b',
}
# roofline.model_flops of each cell at its batch, as the harness counted it
# before: the forward, and a train step's CE (+ MSE) backward.
FLOPS = {'stage1_train_b8': 2133061533696, 'stage3_train_b8': 2339625500672,
         'stage1_eval_b16': 1425329356800, 'stage1_test_b1': 89083084800}
# What stage 3's FA term adds now that a train step counts every loss term:
# its (16 x 8) slice products and the backward through both feature
# transformers, 2.6e-6 of the step.
FA_FLOPS = 5996544


def _digest(state):
    h = hashlib.sha256()
    for name, t in state.items():
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize('config', ['dsrl_r101_stage1', 'dsrl_r101_stage3'])
def test_the_seeded_weights_are_the_same_bits_as_before(config):
    cfg = core._load('configs', config)
    for (name, seed), digest in STATE_DIGESTS.items():
        if name == config:
            assert _digest(weights.make_state(cfg, seed, 'cpu')) == digest, seed


@pytest.mark.parametrize('name', sorted(FLOPS))
def test_the_flop_counts_are_the_same_as_before(monkeypatch, name):
    cell = core.Cell(name)
    tr = cell.traffic
    count = roofline.model_flops(cell.cfg, tr.get('batch', 1), tr['driver'] == 'train')
    assert count == FLOPS[name] + (FA_FLOPS if name == 'stage3_train_b8' else 0)
    if count != FLOPS[name]:               # the same count with stage 2's terms, CE and MSE
        arch = find(cell.cfg)
        terms = arch.terms
        monkeypatch.setattr(arch, 'terms', lambda cfg, *a: terms(dict(cfg, stage=2), *a))
        assert roofline.model_flops(cell.cfg, tr['batch'], True) == FLOPS[name]


@pytest.fixture
def tiny_model(monkeypatch):
    """The configuration of a model the harness has no file for, its module
    registered under ``portbench.models``."""
    monkeypatch.setitem(sys.modules, 'portbench.models.tinynet', tinynet)
    base = core.Cell('stage1_train_b8').cfg
    cfg = {k: base[k] for k in ('num_classes', 'mean', 'std', 'label_map', 'augment')}
    return dict(cfg, model='TinyNet', width=64, input_hw=[16, 32], output_hw=[32, 64])


def test_a_second_model_is_added_by_its_own_module(tiny_model):
    cfg, seed = tiny_model, 2 ** 31 + 3
    arch = find(cfg)
    assert arch is tinynet
    state = weights.make_state(cfg, seed, 'cpu')
    again, other = weights.make_state(cfg, seed, 'cpu'), weights.make_state(cfg, seed + 1, 'cpu')
    assert all(torch.equal(state[k], again[k]) for k in state)
    assert not torch.equal(state['head.weight'], other['head.weight'])
    assert abs(float(state['head.weight'].std()) - 0.02) < 0.004
    w = state['dw.weight']                     # depthwise: fan-out 64 x 9
    assert abs(float(w.std()) - (2.0 / (64 * 9)) ** 0.5) < 0.15 * (2.0 / (64 * 9)) ** 0.5
    assert float(state['stem.bias'].abs().max()) <= 1.0 / (3 * 9) ** 0.5
    assert not state['head.bias'].any() and not state['norm.bias'].any()
    assert bool((state['norm.weight'] == 1).all())
    assert abs(float(state['scale'].std()) - 0.1) < 0.06 and len(set(state['scale'].tolist())) == 19
    prog = weights.load_into(port_model(cfg), state)           # strictly, both
    ref = weights.load_into(arch.reference(cfg), state)
    x = torch.randn(2, 3, *cfg['input_hw'], generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = ref(x)
        assert torch.equal(arch.logits(prog(x)), arch.logits(out))
    assert arch.logits(out).shape == (2, 19, *cfg['output_hw'])
    labels = torch.randint(0, 19, (2, *cfg['output_hw']), generator=torch.Generator().manual_seed(1))
    (name, ce), = arch.terms(cfg, out, None, labels.to(torch.uint8)).items()
    assert name == 'CE' and torch.isfinite(ce)
    # the FLOPs, 2 x MACs at 8 x 16: the stem, the depthwise convolution and
    # the head forward; backward, the stem's weight gradient and both
    # gradients of the other two
    pixels = 2 * 8 * 16
    stem, dw, head = 2 * pixels * 64 * 3 * 9, 2 * pixels * 64 * 9, 2 * pixels * 64 * 19
    assert roofline.model_flops(cfg, 2, False) == stem + dw + head
    assert roofline.model_flops(cfg, 2, True) == 2 * stem + 3 * dw + 3 * head


def test_the_reference_steps_a_second_model(tiny_model):
    """Two steps of the train reference on the module's model and terms."""
    cfg, seed = tiny_model, 2 ** 31 + 4
    pool_img, pool_seg = frame_pool(seed, 4, (64, 128), 'cpu')
    run_ = {'pool_img': pool_img, 'pool_seg': pool_seg, 'offsets': [0, 2], 'warp_seed': 1,
            'photometric_seed': 2, 'dropout_seed': 3}
    traffic = {'batch': 2, 'lr': 0.01, 'momentum': 0.9, 'weight_decay': 5e-4}
    state = weights.make_state(cfg, seed, 'cpu')
    out = reference_train.follow(cfg, traffic, run_, state, 'cpu', find(cfg), steps=2)
    assert [list(step) for step in out['losses']] == [['CE'], ['CE']]
    assert len(out['grad_norms']) == len(state) and bool((out['update_norms'] > 0).all())


def test_a_parameter_no_rule_covers_is_refused_by_name(tiny_model, monkeypatch):
    model = weights.reference_on_meta(tiny_model)
    model.extra = torch.nn.Embedding(4, 8)
    with pytest.raises(KeyError, match=r"covers \['extra.weight'\]"):
        weights._plan(model, list(tinynet.weight_rules(tiny_model)) + list(weights.DEFAULT_RULES))
    monkeypatch.setattr(tinynet, 'weight_rules', lambda cfg: [])
    with pytest.raises(KeyError, match=r"covers \['scale'\]"):
        weights.make_state(tiny_model, 5, 'cpu')


def test_the_run_hands_the_configuration_s_sizes_to_the_program(monkeypatch):
    for var in ('DSRL_TPU_MODEL_INPUT_SIZE', 'DSRL_TPU_BACKBONE_LAYERS'):
        monkeypatch.setenv(var, 'unset')
    for var in ('TORCH_EXTENSIONS_DIR', 'TRITON_CACHE_DIR', 'CUDA_CACHE_PATH'):   # run.main sets them
        monkeypatch.delenv(var, raising=False)
    cfg = dict(core._load('configs', 'dsrl_r101_stage1'), input_hw=[512, 1024],
               backbone_layers=[3, 4, 6, 3])
    run.port_settings(cfg)
    assert os.environ['DSRL_TPU_MODEL_INPUT_SIZE'] == '512x1024'
    assert os.environ['DSRL_TPU_BACKBONE_LAYERS'] == '3,4,6,3'
    # the command sets them from the cell before it looks for a card
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    args = ['--workload', 'stage3_train_b8', '--seed', '1', '--seconds', '1', '--trace', '0']
    assert run.main(args) == 2
    assert os.environ['DSRL_TPU_MODEL_INPUT_SIZE'] == '256x512'
    assert os.environ['DSRL_TPU_BACKBONE_LAYERS'] == '3,4,23,3'


def _code_words(path):
    with open(path) as f:
        for tok in tokenize.generate_tokens(f.readline):
            if tok.type in (tokenize.NAME, tokenize.STRING) and not tok.string.startswith(('"""', "'''")):
                yield tok.string


def test_only_the_model_modules_and_the_reference_name_the_architecture():
    pb = os.path.join(ROOT, 'portbench')
    for d, dirs, files in os.walk(pb):
        dirs[:] = [x for x in dirs if x not in ('models', 'reference', 'tests', '__pycache__')]
        for f in files:
            if f.endswith('.py'):
                path = os.path.join(d, f)
                assert not any('DSRL' in w for w in _code_words(path)), path
