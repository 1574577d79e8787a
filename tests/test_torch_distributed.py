"""The port's multi-process training against the JAX package's data-parallel
step, on the CPU: two gloo ranks, spawned (tests/torch_distributed_ranks.py),
each killed when its test's timeout passes.

* The train step (``test_two_rank_step_equals_jax_sharded_step``): the
  port's stage-3 ``make_train_step`` on two ranks of 2 samples each, against
  JAX ``make_train_step(..., mesh=make_mesh(jax.devices()[:2]))`` on the
  same weights (the numpy weight carry) and the same global batch of 4,
  dropout off on both sides, at tests/test_sharded_equivalence.py's
  tolerances (rtol 3e-3, atol 1e-4 with BatchNorm frozen and 1e-3 in
  training mode) for the losses, every parameter and every BN running
  statistic: 3 SGD steps with BatchNorm frozen, 1 in training mode.  With
  training-mode BatchNorm over 4 samples (the ASPP's pooled branch
  normalises 4 values) float rounding grows by orders of magnitude a step:
  on these inputs the JAX package's own 2-device and 1-device steps agree
  at the tolerances after one step and not after three
  (``test_training_bn_steps_drift_apart_in_the_jax_package_itself``
  checks this and prints the gaps).  Rank 1's images are shifted by +3 and 75 % of its
  labels are ignored, and the classifier's final ConvT is scaled by 8 so
  that the logits are far from uniform; then the mean of the two ranks' CE
  means misses the global CE by more than 10x the tolerance, which the
  test asserts: a step
  that averaged per-rank means would fail it, and a per-rank BatchNorm
  would move the running variances by far more than 1e-3.
* Cross-rank BatchNorm alone (models/norm.py): the output, the running
  mean and variance, and the input, weight and bias gradients equal
  ``nn.BatchNorm2d`` on the concatenated batch within 1e-5 of each
  tensor's largest value (the sums run in another order); the output
  equals JAX ``TorchBatchNorm(axis_name='data')`` under ``shard_map`` (the
  pattern of tests/test_sync_bn.py).
* ``distributed_init_kwargs`` against the JAX package's on address, port
  and node id, with the world, rank and backend rules.
* Data per rank: rank 1's warp matrices are the JAX draws for
  ``SeedSequence([1, seed, epoch, batch])``; the train loader's batches and
  the sharded val loader's indices and masks are the JAX ``ShardedSampler``'s.
* A rank that raises makes the spawned ranks' parent raise at once.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch
from torch import nn

from dualsuperreslearningforsemseg_tpu.data import augment as jax_augment
from dualsuperreslearningforsemseg_tpu.data.pipeline import ShardedSampler as JaxShardedSampler
from dualsuperreslearningforsemseg_tpu.models import DSRL as JaxDSRL, state_dict as jax_state_dict
from dualsuperreslearningforsemseg_tpu.models import dsrl as jax_dsrl
from dualsuperreslearningforsemseg_tpu.models.norm import TorchBatchNorm
from dualsuperreslearningforsemseg_tpu.parallel import (
    distributed_init_kwargs as jax_init_kwargs, make_mesh, replicate, shard_batch)
from dualsuperreslearningforsemseg_tpu.train import TrainState, make_train_step as jax_train_step, sgd_init
from dualsuperreslearningforsemseg_tpu_torch.data import AugmentConfig, augment, make_eval_loader, \
    make_train_loader, make_warp_transform
from dualsuperreslearningforsemseg_tpu_torch.models import DSRL, port_state_dict_from_jax
from dualsuperreslearningforsemseg_tpu_torch.parallel import distributed_init_kwargs

import torch_distributed_ranks as ranks

IN_HW, OUT_HW = (32, 64), (64, 128)
GLOBAL_BATCH = 4
TAIL_SCALE = 8.0


class _IdentityDropout(fnn.Module):
    rate: float

    @fnn.compact
    def __call__(self, x, deterministic, pad_lanes=0):
        return x


def _global_batch(rng):
    """Two halves of 2: rank 1's images shifted by +3, 75 % of its labels
    ignored."""
    img_lo = rng.standard_normal((GLOBAL_BATCH, *IN_HW, 3)).astype(np.float32)
    img_hi = rng.standard_normal((GLOBAL_BATCH, *OUT_HW, 3)).astype(np.float32)
    seg = rng.integers(0, 19, size=(GLOBAL_BATCH, *OUT_HW)).astype(np.int32)
    img_lo[2:] += 3.0
    img_hi[2:] += 3.0
    seg[2:][rng.random(seg[2:].shape) < 0.75] = 255
    return img_lo, img_hi, seg


def _jax_inputs(rng):
    """The JAX init (dropout off, the final ConvT scaled) and the global
    batch of the step tests."""
    model = JaxDSRL(stage=3, num_classes=19, backbone_layers=ranks.LAYERS)
    variables = model.init({'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
                           jnp.zeros((1, *IN_HW, 3), jnp.float32), False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {'params': variables['params'], 'batch_stats': dict(variables['batch_stats'])}
    # Logits far from uniform: at the init's scale every pixel's CE is close
    # to ln 19 whatever its label, and no weighting of the pixels would show.
    tail = variables['params']['SSSR_decoder']['upsample16_pred.6']
    tail['weight'], tail['bias'] = tail['weight'] * TAIL_SCALE, tail['bias'] * TAIL_SCALE
    return variables, _global_batch(rng)


def _jax_sharded_run(variables, batch, freeze_bn, n_steps, n_devices=2):
    """-> (the losses of each step, the state dict after each step) of the
    JAX step on ``n_devices`` of the virtual CPU devices."""
    model = JaxDSRL(stage=3, num_classes=19, backbone_layers=ranks.LAYERS)
    mesh = make_mesh(jax.devices()[:n_devices])
    state = TrainState(params=replicate(variables['params'], mesh),
                       batch_stats=replicate(variables['batch_stats'], mesh),
                       momentum=replicate(sgd_init(variables['params']), mesh))
    step = jax_train_step(model, 3, ranks.W1, ranks.W2, ranks.MOMENTUM, ranks.WD, 255, freeze_bn,
                          mesh=mesh)
    img_lo, img_hi, seg = shard_batch(tuple(jnp.asarray(a) for a in batch), mesh)
    losses, states = [], []
    for i in range(n_steps):
        state, out = step(state, img_lo, img_hi, seg, jnp.float32(ranks.LR), jax.random.PRNGKey(i))
        losses.append({k: float(v) for k, v in out.items()})
        states.append(jax_state_dict({'params': jax.device_get(state.params),
                                      'batch_stats': jax.device_get(state.batch_stats)}))
    return losses, states


def _per_rank_ce_means(state, batch):
    """Each half's CE mean at the first step's weights, with the global
    batch's BatchNorm statistics (one process, train mode): what a step
    averaging per-rank means would report."""
    from dualsuperreslearningforsemseg_tpu_torch.models import load_state_dict
    from dualsuperreslearningforsemseg_tpu_torch.ops.fused_tail import fused_convt2_ce_sum
    model = ranks._no_dropout(DSRL(num_classes=19, stage=3, backbone_layers=ranks.LAYERS))
    load_state_dict(model, state, strict=True)
    tail = model.SSSR_decoder.upsample16_pred[6]
    with torch.no_grad():
        sssr = model.train()(torch.from_numpy(batch[0]).permute(0, 3, 1, 2).contiguous(),
                             pre_tail=True)[0]
        labels = torch.from_numpy(batch[2]).to(torch.uint8)
        halves = [fused_convt2_ce_sum(sssr[h:h + 2].contiguous(), tail.weight, tail.bias,
                                      labels[h:h + 2].contiguous()) for h in (0, 2)]
    return [float(s / c) for s, c in halves]


@pytest.mark.parametrize('freeze_bn, n_steps', [(True, 3), (False, 1)],
                         ids=['frozen-bn', 'training-bn'])
def test_two_rank_step_equals_jax_sharded_step(tmp_path, rng, monkeypatch, freeze_bn, n_steps):
    monkeypatch.setenv('DSRL_TPU_PACK_SMALL', '0')
    monkeypatch.setattr(jax_dsrl, 'FastDropout', _IdentityDropout)
    atol, rtol = (1e-4 if freeze_bn else 1e-3), 3e-3
    variables, batch = _jax_inputs(rng)
    state = {k: torch.from_numpy(np.array(v)) for k, v in port_state_dict_from_jax(variables).items()}
    torch.save({'state': state, 'img_lo': torch.from_numpy(batch[0]),
                'img_hi': torch.from_numpy(batch[1]), 'seg': torch.from_numpy(batch[2])},
               str(tmp_path / 'inputs.pt'))
    running = ranks.start_ranks(ranks.rank_train_steps, 2, str(tmp_path), freeze_bn, n_steps)
    ref_losses, ref_states = _jax_sharded_run(variables, batch, freeze_bn, n_steps)   # meanwhile
    ref_state = ref_states[-1]
    ranks.join_ranks(running)
    out = [torch.load(str(tmp_path / 'rank{}.pt'.format(r))) for r in range(2)]
    for name in ('inputs.pt', 'rank0.pt', 'rank1.pt'):   # ~100 MB each
        os.remove(str(tmp_path / name))

    n_bn = sum(isinstance(m, nn.BatchNorm2d)
               for m in DSRL(num_classes=19, stage=3, backbone_layers=ranks.LAYERS).modules())
    assert out[0]['swapped'] == out[1]['swapped'] == n_bn
    assert out[0]['losses'] == out[1]['losses']
    for step, (mine, ref) in enumerate(zip(out[0]['losses'], ref_losses)):
        for name in ('CE', 'MSE', 'FA', 'Total'):
            np.testing.assert_allclose(mine[name], ref[name], rtol=rtol, atol=atol,
                                       err_msg="step {} loss {}".format(step, name))
    assert set(out[0]['state']) == set(ref_state)
    for name, ref in ref_state.items():
        assert torch.equal(out[0]['state'][name], out[1]['state'][name]), name
        if name.endswith('num_batches_tracked'):
            assert int(out[0]['state'][name]) == int(np.asarray(ref)), name
            continue
        np.testing.assert_allclose(out[0]['state'][name].numpy(), np.asarray(ref), rtol=rtol,
                                   atol=atol, err_msg=name)

    # The fault these inputs are there to show.
    means = _per_rank_ce_means(state, batch)
    miss = abs(np.mean(means) - ref_losses[0]['CE'])
    assert miss > 10 * (atol + rtol * abs(ref_losses[0]['CE'])), (means, ref_losses[0]['CE'])


def _misses(got, want, rtol, atol):
    """The leaves of ``got`` outside ``assert_allclose(got, want, rtol, atol)``."""
    return sorted(k for k, w in want.items() if not k.endswith('num_batches_tracked')
                  and not np.allclose(np.asarray(got[k]), np.asarray(w), rtol=rtol, atol=atol))


def test_training_bn_steps_drift_apart_in_the_jax_package_itself(rng, monkeypatch):
    """Why the training-BN case above takes one step, not three: on its
    inputs the JAX package's own 2-device and 1-device steps agree at that
    case's tolerances after one step and no longer after three.  Prints, for
    each step, the largest gap over the leaves, over the leaf's largest
    change since the init."""
    monkeypatch.setenv('DSRL_TPU_PACK_SMALL', '0')
    monkeypatch.setattr(jax_dsrl, 'FastDropout', _IdentityDropout)
    variables, batch = _jax_inputs(rng)
    init = jax_state_dict(variables)
    _, two = _jax_sharded_run(variables, batch, False, 3, n_devices=2)
    _, one = _jax_sharded_run(variables, batch, False, 3, n_devices=1)
    for i in range(3):
        drift = max(float(np.abs(np.asarray(two[i][k]) - np.asarray(one[i][k])).max())
                    / max(float(np.abs(np.asarray(one[i][k]) - np.asarray(v)).max()), 1e-30)
                    for k, v in init.items() if not k.endswith('num_batches_tracked'))
        print("JAX 2-device vs 1-device, training BatchNorm, step {}: largest gap over the "
              "leaf's change {:.3g}, leaves outside rtol 3e-3 / atol 1e-3: {}".format(
                  i + 1, drift, len(_misses(two[i], one[i], 3e-3, 1e-3))))
    assert _misses(two[0], one[0], 3e-3, 1e-3) == []
    assert _misses(two[2], one[2], 3e-3, 1e-3) != []


def test_cross_rank_batch_norm_equals_the_global_batch(tmp_path, rng):
    c = 8
    x = rng.standard_normal((8, c, 4, 4)).astype(np.float32)
    x[4:] += 3.0
    dy = rng.standard_normal(x.shape).astype(np.float32)
    ref = nn.BatchNorm2d(c)
    with torch.no_grad():
        ref.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
        ref.bias.copy_(torch.from_numpy(rng.standard_normal(c).astype(np.float32)))
    torch.save({'x': torch.from_numpy(x), 'dy': torch.from_numpy(dy),
                'bn': {k: v.clone() for k, v in ref.state_dict().items()}},
               str(tmp_path / 'bn_inputs.pt'))
    ranks.run_ranks(ranks.rank_batch_norm, 2, str(tmp_path))
    out = [torch.load(str(tmp_path / 'bn{}.pt'.format(r))) for r in range(2)]

    xt = torch.from_numpy(x).requires_grad_()
    y = ref(xt)
    y.backward(torch.from_numpy(dy))
    assert [o['type'] for o in out] == ['CrossRankBatchNorm2d'] * 2
    for name, got, want in (
            ('y', torch.cat([o['y'] for o in out]), y.detach()),
            ('dx', torch.cat([o['dx'] for o in out]), xt.grad),
            ('dweight', out[0]['dweight'] + out[1]['dweight'], ref.weight.grad),
            ('dbias', out[0]['dbias'] + out[1]['dbias'], ref.bias.grad),
            ('running_mean', out[1]['running_mean'], ref.running_mean),
            ('running_var', out[1]['running_var'], ref.running_var)):
        # rtol 1e-5 of each tensor's largest value: the sums run in another order.
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()), err_msg=name)
    assert torch.equal(out[0]['running_var'], out[1]['running_var'])

    # The JAX package's cross-replica BatchNorm on the same two shards.
    from jax.sharding import Mesh, PartitionSpec as P
    bn = TorchBatchNorm(c, axis_name='data')
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    variables = {'params': {'weight': jnp.asarray(ref.weight.detach().numpy()),
                            'bias': jnp.asarray(ref.bias.detach().numpy())},
                 'batch_stats': TorchBatchNorm(c).init(jax.random.PRNGKey(0), xj, False)['batch_stats']}
    fn = jax.shard_map(lambda v: bn.apply(variables, v, False, mutable=['batch_stats'])[0],
                   mesh=Mesh(np.array(jax.devices()[:2]), ('data',)), in_specs=P('data'),
                   out_specs=P('data'))
    np.testing.assert_allclose(torch.cat([o['y'] for o in out]).numpy(),
                               np.asarray(fn(xj)).transpose(0, 3, 1, 2), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('nodes, per_node, node_id, local_rank', [
    (1, 2, 0, 1), (2, 4, 1, 3), (3, 1, 2, 0)])
def test_distributed_tuple_matches_the_jax_package(nodes, per_node, node_id, local_rank):
    tup = dict(MASTER_ADDR='10.0.0.7', MASTER_PORT=29511, NODES=nodes, DEVICES_PER_NODE=per_node,
               BACKEND='gloo', INIT_METHOD=None, NODE_ID=node_id)
    ref, _ = jax_init_kwargs(tup)
    kwargs, env, cautions = distributed_init_kwargs(tup, local_rank, 'cpu')
    assert '{}:{}'.format(env['MASTER_ADDR'], env['MASTER_PORT']) == ref['coordinator_address']
    assert kwargs['rank'] // per_node == ref['process_id'] == node_id
    assert kwargs == dict(backend='gloo', init_method='env://', world_size=nodes * per_node,
                          rank=node_id * per_node + local_rank)
    assert cautions == []
    # INIT_METHOD: ' ' (stored as None), '' and env:// rendezvous over the
    # master's address; anything else is passed through.
    for init in ('', 'env://'):
        assert distributed_init_kwargs(dict(tup, INIT_METHOD=init), 0, 'cpu')[0]['init_method'] == 'env://'
    kwargs, env, _ = distributed_init_kwargs(dict(tup, INIT_METHOD='tcp://h:1'), 0, 'cpu')
    assert kwargs['init_method'] == 'tcp://h:1' and env == {}
    # Backends: nccl on cuda only, mpi only with MPI, xla -> the device's default.
    assert distributed_init_kwargs(dict(tup, BACKEND='nccl'), 0, 'cuda')[0]['backend'] == 'nccl'
    with pytest.raises(ValueError, match="'nccl' needs CUDA"):
        distributed_init_kwargs(dict(tup, BACKEND='nccl'), 0, 'cpu')
    for device, backend in (('cpu', 'gloo'), ('cuda', 'nccl')):
        kwargs, _, cautions = distributed_init_kwargs(dict(tup, BACKEND='xla'), 0, device)
        assert kwargs['backend'] == backend and len(cautions) == 1
    if not torch.distributed.is_mpi_available():
        with pytest.raises(ValueError, match="'mpi' is not available"):
            distributed_init_kwargs(dict(tup, BACKEND='mpi'), 0, 'cpu')
    with pytest.raises(ValueError, match='outside DEVICES_PER_NODE'):
        distributed_init_kwargs(tup, per_node, 'cpu')


def test_rank_one_warps_with_the_jax_rank_stream(monkeypatch):
    cfg = AugmentConfig(input_hw=IN_HW, output_hw=OUT_HW)
    seen = []
    monkeypatch.setattr(augment, 'warp_pair_batch',
                        lambda imgs, segs, mats, out_hw, lut: seen.append(mats.numpy()) or (imgs, segs))
    imgs = torch.zeros((3, 80, 160, 3), dtype=torch.uint8)
    segs = torch.zeros((3, 80, 160), dtype=torch.uint8)
    jax_cfg = jax_augment.AugmentConfig(input_hw=IN_HW, output_hw=OUT_HW)
    for rank in (0, 1):
        make_warp_transform(cfg, None, 54321, rank=rank)(4, 2, imgs, segs)
        entropy = ([rank] if rank else []) + [54321, 4, 2]
        want = jax_augment.sample_affine_matrices_np(
            np.random.default_rng(np.random.SeedSequence(entropy)), 3, (80, 160), OUT_HW, jax_cfg)
        np.testing.assert_array_equal(seen[-1], want)
    assert not np.array_equal(seen[0], seen[1])


class _IndexedPairs:
    """Sample i is a 2x2 image and label filled with i."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2, 2, 3), i, np.uint8), np.full((2, 2), i, np.uint8)


def test_loaders_serve_the_jax_shards():
    device = torch.device('cpu')
    for rank in (0, 1):
        loader = make_train_loader(_IndexedPairs(11), 2, 0, device, seed=7, world_size=2, rank=rank)
        loader.batch_sampler.set_epoch(3)
        got = [(imgs[:, 0, 0, 0].tolist(), e, b) for imgs, _, e, b in loader]
        order = JaxShardedSampler(11, 2, rank, shuffle=True, seed=7, drop_last=True).indices_for_epoch(3)
        assert got == [(order[2 * b:2 * b + 2].tolist(), 3, b) for b in range(len(order) // 2)]

    # Val: 7 samples over 2 ranks, 2 a batch: one pad entry, masked.
    seen = []
    for rank in (0, 1):
        order = JaxShardedSampler(7, 2, rank, shuffle=False, drop_last=False).indices_for_epoch(0)
        batches = list(make_eval_loader(_IndexedPairs(7), 2, 0, device, 2, rank))
        assert len(batches) == 2
        idx = np.concatenate([imgs[:, 0, 0, 0].numpy() for imgs, _, _ in batches])
        valid = np.concatenate([v.numpy() for _, _, v in batches])
        np.testing.assert_array_equal(idx, np.where(order >= 0, order, -(order + 1)))
        np.testing.assert_array_equal(valid, (order >= 0).astype(np.float32))
        seen += idx[valid > 0].tolist()
    assert sorted(seen) == list(range(7))


def test_a_rank_that_raises_fails_the_spawning_process(tmp_path):
    script = ("import sys; sys.path.insert(0, {!r}); import torch_distributed_ranks as r; "
              "from dualsuperreslearningforsemseg_tpu_torch.parallel import spawn_ranks; "
              "spawn_ranks(r.rank_fails, 2, (2, r.free_port()))").format(os.path.dirname(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    code, _, err = ranks.run_command([sys.executable, '-c', script], str(tmp_path), env, timeout=120)
    assert code != 0 and 'rank 1 fails on purpose' in err
