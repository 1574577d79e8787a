"""The process group of multi-process training: a ``torch.distributed``
process group with one process per device, not a device mesh.  The file
keeps the JAX package's name (parallel/mesh.py there) so a reader finds
the counterpart of each function.

Topology: the reference CLI's ``--distributed MASTER_ADDR MASTER_PORT NODES
DEVICES_PER_NODE BACKEND INIT_METHOD NODE_ID`` spawns ``DEVICES_PER_NODE``
processes on each node; the world is ``NODES * DEVICES_PER_NODE`` ranks,
rank ``NODE_ID * DEVICES_PER_NODE + local_rank`` drives ``cuda:local_rank``
(or the CPU).  The JAX package runs one process per node over every local
chip instead; the global batch (``--batch-size`` per device) is the same.

Nothing here moves work to the CPU or to one process: a backend the device
cannot serve is refused, and a collective that waits for a dead rank fails
after ``TIMEOUT``.
"""

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from ..utils.logging import CAUTION

# How long a collective waits for the other ranks before it fails (the
# master's checkpoint writes, which the others wait for, take seconds).
TIMEOUT = timedelta(minutes=10)


def _device_type(device) -> str:
    return torch.device(device).type


def distributed_init_kwargs(distributed: dict, local_rank: int, device):
    """The ``--distributed`` mapping (utils/validators.py) of the rank with
    ``local_rank`` on its node, on ``device`` (``'cpu'``/``'cuda'`` or a
    torch device) -> ``(init_process_group kwargs, environment, cautions)``;
    pure.  The counterpart of the JAX package's ``distributed_init_kwargs``
    (parallel/mesh.py:129-160 there).

    * backend: ``gloo`` on either device; ``nccl`` on ``cuda`` only; ``mpi``
      only where torch was built with MPI; ``xla`` maps to the device's
      default backend (``nccl`` on ``cuda``, ``gloo`` on the CPU) with a
      caution.  Anything else raises ValueError.
    * INIT_METHOD None, ``''``, ``' '`` or ``env://``: ``env://`` with
      ``MASTER_ADDR`` and ``MASTER_PORT`` in the returned environment; any
      other value is passed through.
    """
    per_node = int(distributed['DEVICES_PER_NODE'])
    if not 0 <= local_rank < per_node:
        raise ValueError("local rank {} is outside DEVICES_PER_NODE={}".format(local_rank, per_node))
    kind = _device_type(device)
    backend = str(distributed['BACKEND']).casefold()
    cautions = []
    if backend == 'xla':
        backend = 'nccl' if kind == 'cuda' else 'gloo'
        cautions.append("Distributed backend 'xla' names the JAX package's fabric; "
                        "the port uses '{}' on {}.".format(backend, kind))
    elif backend == 'nccl' and kind != 'cuda':
        raise ValueError("Distributed backend 'nccl' needs CUDA devices; "
                         "use 'gloo' with --device cpu.")
    elif backend == 'mpi' and not dist.is_mpi_available():
        raise ValueError("Distributed backend 'mpi' is not available: this torch was built "
                         "without MPI. Use 'gloo' or 'nccl'.")
    elif backend not in ('gloo', 'nccl', 'mpi'):
        raise ValueError("Unknown distributed backend '{}'.".format(distributed['BACKEND']))
    init_method = (distributed.get('INIT_METHOD') or '').strip()
    env = {}
    if init_method in ('', 'env://'):
        init_method = 'env://'
        env = {'MASTER_ADDR': str(distributed['MASTER_ADDR']),
               'MASTER_PORT': str(distributed['MASTER_PORT'])}
    kwargs = dict(backend=backend, init_method=init_method,
                  world_size=int(distributed['NODES']) * per_node,
                  rank=int(distributed['NODE_ID']) * per_node + local_rank)
    return kwargs, env, cautions


def initialize_distributed(distributed: dict, local_rank: int, device, timeout=TIMEOUT):
    """Joins the process group of ``distributed`` as ``local_rank`` on
    ``device`` (the JAX package's ``initialize_distributed``,
    parallel/mesh.py:241-252 there); every collective then fails after
    ``timeout`` instead of waiting for a dead rank."""
    kwargs, env, cautions = distributed_init_kwargs(distributed, local_rank, device)
    for message in cautions:
        print(CAUTION(message))
    os.environ.update(env)
    device = torch.device(device)
    if kwargs['backend'] == 'nccl':
        kwargs['device_id'] = device
    dist.init_process_group(timeout=timeout, **kwargs)


def spawn_ranks(fn, devices_per_node: int, args=()):
    """Runs ``fn(local_rank, *args)`` in ``devices_per_node`` spawned
    processes and waits for all of them.  When one raises or dies, the
    others are terminated and this raises, so the caller exits non-zero."""
    torch.multiprocessing.spawn(fn, args=tuple(args), nprocs=devices_per_node, join=True)


def is_master_rank() -> bool:
    """Rank 0 of the process group, or the only process without one (the
    reference's ``RANK == 0`` gating, main.py:40)."""
    return rank() == 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place (returned); ``t`` unchanged in
    a single process.  Under nccl ``t`` must be on the rank's card."""
    if world_size() > 1:
        dist.all_reduce(t)
    return t


def data_parallel(module: torch.nn.Module, device) -> torch.nn.Module:
    """``module`` under ``DistributedDataParallel`` for the rank's
    ``device``: gradients averaged over the ranks in backward.  Buffers are
    not broadcast (cross-rank BatchNorm keeps its statistics global,
    models/norm.py), and every parameter must get a gradient each step."""
    device = torch.device(device)
    return torch.nn.parallel.DistributedDataParallel(
        module, device_ids=[device] if device.type == 'cuda' else None, broadcast_buffers=False)


def barrier():
    """Every rank waits for the others (the JAX package's
    ``rendezvous_barrier``); a no-op in a single process."""
    if dist.is_initialized():
        dist.barrier()


def destroy_process_group():
    if dist.is_initialized():
        dist.destroy_process_group()
