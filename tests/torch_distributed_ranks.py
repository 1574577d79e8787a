"""Rank functions of the port's multi-process CPU tests
(tests/test_torch_distributed*.py) and the harness that runs them.

The ranks are spawned processes joined in a gloo process group through the
port's ``parallel.initialize_distributed``; they import torch and the port
only.  ``run_ranks`` kills every rank still alive when its timeout passes,
so a deadlock fails the test that started it.
"""

import os
import signal
import socket
import subprocess
import time

import torch
import torch.multiprocessing as mp

LAYERS = (1, 1, 2, 1)
W1, W2, LR, MOMENTUM, WD = 0.1, 1.0, 0.01, 0.9, 5e-4
TIMEOUT_S = 240


def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def distributed_tuple(port, per_node, backend='gloo'):
    """The mapping ``--distributed 127.0.0.1 <port> 1 <per_node> <backend> ' ' 0`` parses to."""
    return dict(MASTER_ADDR='127.0.0.1', MASTER_PORT=port, NODES=1, DEVICES_PER_NODE=per_node,
                BACKEND=backend, INIT_METHOD=None, NODE_ID=0)


def start_ranks(fn, world, *args):
    """Starts ``fn(rank, world, port, *args)`` in ``world`` spawned processes."""
    return mp.start_processes(fn, args=(world, free_port()) + args, nprocs=world, join=False,
                              start_method='spawn')


def join_ranks(context, timeout=TIMEOUT_S):
    """Waits for every rank; kills them all and fails after ``timeout``."""
    deadline = time.monotonic() + timeout
    while not context.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in context.processes:
                if p.is_alive():
                    p.kill()
            raise AssertionError("the ranks did not finish within {} s".format(timeout))


def run_ranks(fn, world, *args, timeout=TIMEOUT_S):
    join_ranks(start_ranks(fn, world, *args), timeout)


def run_command(argv, cwd, env, timeout=TIMEOUT_S):
    """Runs a command in a session of its own (the CLI spawns its ranks in
    it) and returns (exit code, stdout, stderr); kills the whole session and
    fails when ``timeout`` passes."""
    proc = subprocess.Popen(argv, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError("{} did not finish within {} s".format(argv, timeout))
    return proc.returncode, out, err


def _join(rank, world, port):
    from dualsuperreslearningforsemseg_tpu_torch.parallel import initialize_distributed
    torch.set_num_threads(2)
    initialize_distributed(distributed_tuple(port, world), rank, 'cpu')


def _no_dropout(model):
    from torch import nn
    for module in list(model.modules()):
        for name, child in module.named_children():
            if isinstance(child, nn.Dropout):
                setattr(module, name, nn.Identity())
    return model


def rank_train_steps(rank, world, port, workdir, freeze_bn, n_steps):
    """``n_steps`` port train steps (stage 3) on this rank's share of
    ``workdir/inputs.pt``; writes losses and state to ``rank{r}.pt``."""
    from dualsuperreslearningforsemseg_tpu_torch import parallel
    from dualsuperreslearningforsemseg_tpu_torch.models import DSRL, load_state_dict
    from dualsuperreslearningforsemseg_tpu_torch.models.norm import CrossRankBatchNorm2d
    from dualsuperreslearningforsemseg_tpu_torch.train import make_sgd, make_train_step
    _join(rank, world, port)
    inputs = torch.load(os.path.join(workdir, 'inputs.pt'))
    model = _no_dropout(DSRL(num_classes=19, stage=3, backbone_layers=LAYERS))
    load_state_dict(model, inputs['state'], strict=True)
    step = make_train_step(model, make_sgd(model, LR, MOMENTUM, WD), 3, W1, W2, 255, freeze_bn)
    n = inputs['img_lo'].shape[0] // world
    share = [inputs[k][rank * n:(rank + 1) * n] for k in ('img_lo', 'img_hi', 'seg')]
    losses = [{k: float(v) for k, v in step(*share, LR).items()} for _ in range(n_steps)]
    swapped = sum(isinstance(m, CrossRankBatchNorm2d) for m in model.modules())
    torch.save({'losses': losses, 'swapped': swapped,
                'state': {k: v.clone() for k, v in model.state_dict().items()}},
               os.path.join(workdir, 'rank{}.pt'.format(rank)))
    parallel.destroy_process_group()


def rank_batch_norm(rank, world, port, workdir):
    """One cross-rank BatchNorm forward and backward on this rank's share of
    ``workdir/bn_inputs.pt``; writes the output, the input and parameter
    gradients and the running statistics to ``bn{r}.pt``."""
    from torch import nn
    from dualsuperreslearningforsemseg_tpu_torch import parallel
    from dualsuperreslearningforsemseg_tpu_torch.models.norm import convert_sync_batchnorm
    _join(rank, world, port)
    inputs = torch.load(os.path.join(workdir, 'bn_inputs.pt'))
    n = inputs['x'].shape[0] // world
    holder = nn.Sequential(nn.BatchNorm2d(inputs['x'].shape[1]))
    holder[0].load_state_dict(inputs['bn'])
    bn = convert_sync_batchnorm(holder)[0]
    x = inputs['x'][rank * n:(rank + 1) * n].clone().requires_grad_()
    y = bn(x)
    y.backward(inputs['dy'][rank * n:(rank + 1) * n])
    torch.save({'type': type(bn).__name__, 'y': y.detach(), 'dx': x.grad,
                'dweight': bn.weight.grad, 'dbias': bn.bias.grad,
                'running_mean': bn.running_mean, 'running_var': bn.running_var},
               os.path.join(workdir, 'bn{}.pt'.format(rank)))
    parallel.destroy_process_group()


def rank_fails(rank, world, port):
    """Rank 1 raises; the others wait for it at a barrier."""
    from dualsuperreslearningforsemseg_tpu_torch import parallel
    _join(rank, world, port)
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    parallel.barrier()
