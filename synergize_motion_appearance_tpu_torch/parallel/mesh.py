"""Process groups and device meshes of the port, on ``torch.distributed``
(counterpart of the JAX package's parallel/mesh.py; the reference's
utils/dist_util.py).

The JAX package trains data-parallel as one jitted step over a batch
sharded on a mesh, where XLA inserts the gradient all-reduce and the
global BatchNorm statistics. Here every rank is a process that holds the
whole model and its slice of the global batch:
- ``init_distributed`` joins the ranks of a ``torchrun`` or slurm launch
  (NCCL for CUDA, gloo for the CPU);
- ``shard_batch`` takes this rank's slice of a global batch, and
  ``gather_batch`` puts the ranks' slices back together on every rank;
- ``all_reduce_mean`` averages a dict of tensors (the gradients, the logs)
  over the ranks in a few flat float32 buckets, ``broadcast_tensors``
  copies rank 0's tensors to every rank (JAX's ``replicate``);
- ``all_reduce_`` sums a tensor over the ranks in place, for
  ``models.layers.BatchNorm2d``'s global statistics and their gradient;
- ``create_mesh`` lists the devices of frame-parallel inference.

``collectives`` and ``collective_bytes`` count the collectives this module
has issued since ``reset_collectives``.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch
import torch.distributed as dist

# collectives issued since the last reset, and the bytes they carried
collectives = 0
collective_bytes = 0

# flat buckets of all_reduce_mean and broadcast_tensors: at most this
# many bytes each (one tensor larger than that gets a bucket of its own)
BUCKET_BYTES = 64 << 20


def reset_collectives() -> None:
    global collectives, collective_bytes
    collectives = 0
    collective_bytes = 0


def _count(t: torch.Tensor) -> None:
    global collectives, collective_bytes
    collectives += 1
    collective_bytes += t.numel() * t.element_size()


class DistInfo(NamedTuple):
    rank: int
    world_size: int
    local_rank: int


def _slurm_first_hostname(node_list: str) -> str:
    """First hostname of a slurm nodelist. Prefers `scontrol show
    hostname` (what the reference shells out to, dist_util.py:44); falls
    back to a pure-Python expansion of the `prefix[a-b,c]` syntax so the
    rendezvous also works off-cluster (tests, login nodes)."""
    import shutil
    import subprocess

    if shutil.which("scontrol"):
        out = subprocess.run(
            ["scontrol", "show", "hostname", node_list],
            capture_output=True, text=True, check=False,
        ).stdout.strip().splitlines()
        if out:
            return out[0]
    # pure-Python fallback: "node[003-005,9],other" -> "node003"
    head = node_list.split(",")[0]
    if "[" in head:
        prefix, rest = head.split("[", 1)
        first = rest.split("]", 1)[0].split(",")[0].split("-")[0]
        return prefix + first
    return head


def slurm_rendezvous(environ=None, port: Optional[int] = None):
    """(coordinator address "host:port", world size, rank) from the slurm
    environment, as `_init_dist_slurm` (utils/dist_util.py:28-57) derives
    them: SLURM_PROCID is the rank, SLURM_NTASKS the world size, the first
    host of SLURM_NODELIST the coordinator; the port is the argument, else
    MASTER_PORT, else 29500."""
    env = os.environ if environ is None else environ
    proc_id = int(env["SLURM_PROCID"])
    ntasks = int(env["SLURM_NTASKS"])
    addr = _slurm_first_hostname(env["SLURM_NODELIST"])
    if port is None:
        port = int(env.get("MASTER_PORT", 29500))
    return f"{addr}:{port}", ntasks, proc_id


def init_distributed(launcher: str, port: Optional[int] = None,
                     backend: Optional[str] = None, device="cuda",
                     environ=None) -> DistInfo:
    """Join the process group of a multi-process launch (the reference's
    `init_dist`, utils/dist_util.py:10-57) and return this process's
    (rank, world size, local rank).

    - ``none``: one process; nothing to join.
    - ``pytorch``: the variables ``torchrun`` sets (RANK, WORLD_SIZE,
      LOCAL_RANK, MASTER_ADDR, MASTER_PORT; ``port`` overrides the last).
      A world of one still joins a group, so its collectives run.
    - ``slurm``: ``slurm_rendezvous``; the local rank is SLURM_LOCALID (else
      the rank modulo the visible cards). A job of one task joins nothing.

    The backend follows ``device``'s type: NCCL for CUDA, which also makes
    ``cuda:<local rank>`` the current device, and gloo for the CPU. A caller
    may name another, as gloo for two ranks on one card, which NCCL
    refuses."""
    env = os.environ if environ is None else environ
    if launcher == "none":
        return DistInfo(0, 1, 0)
    if launcher == "pytorch":
        rank = int(env["RANK"])
        world = int(env["WORLD_SIZE"])
        local_rank = int(env.get("LOCAL_RANK", rank))
        addr = f"{env.get('MASTER_ADDR', 'localhost')}:" \
               f"{port if port is not None else env.get('MASTER_PORT', 29500)}"
    elif launcher == "slurm":
        if "SLURM_PROCID" not in env or "SLURM_NTASKS" not in env:
            raise RuntimeError(
                "launcher='slurm' but SLURM_PROCID/SLURM_NTASKS are not "
                "set — not inside a slurm step")
        addr, world, rank = slurm_rendezvous(env, port)
        if world == 1:
            return DistInfo(0, 1, 0)  # single-task slurm job
        n_cards = max(torch.cuda.device_count(), 1)
        local_rank = int(env.get("SLURM_LOCALID", rank % n_cards))
    else:
        raise ValueError(f"no launcher {launcher!r}; want none, pytorch or "
                         f"slurm")
    dev_type = torch.device(device).type
    if backend is None:
        backend = "nccl" if dev_type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            rank=rank, world_size=world)
    return DistInfo(rank, world, local_rank)


def get_dist_info():
    """(rank, world size): (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_master() -> bool:
    """`master_only` predicate (utils/dist_util.py:74-82)."""
    return get_dist_info()[0] == 0


def in_process_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def barrier() -> None:
    if in_process_group():
        dist.barrier()


def create_mesh(devices: Optional[Iterable] = None) -> List[torch.device]:
    """The devices that frame-parallel inference splits each frame batch
    across: ``devices`` as torch devices (a device may repeat), else every
    visible card."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise RuntimeError("create_mesh: no CUDA device is visible")
    return mesh


def shard_batch(batch: Dict[str, torch.Tensor], rank: Optional[int] = None,
                world: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """This rank's equal slice of the leading dim of each tensor of a
    global batch (the process group's rank and world size by default);
    raises when the batch does not split evenly."""
    if rank is None or world is None:
        rank, world = get_dist_info()
    n = {v.shape[0] for v in batch.values()}
    if len(n) != 1 or next(iter(n)) % world:
        raise ValueError(f"a global batch of {sorted(n)} does not split "
                         f"evenly across {world} ranks")
    b = next(iter(n)) // world
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def gather_batch(t: torch.Tensor) -> torch.Tensor:
    """The ranks' ``t`` concatenated along the leading dim in rank order,
    on every rank (the global batch of slices ``shard_batch`` took); ``t``
    itself outside a process group."""
    if not in_process_group():
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    _count(t)
    dist.all_gather(parts, t)
    return torch.cat(parts)


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place and return it."""
    _count(t)
    dist.all_reduce(t)
    return t


def _buckets(tensors: List[torch.Tensor]) -> List[List[int]]:
    """Indices of ``tensors`` in runs of one dtype and device and at most
    BUCKET_BYTES each, in order."""
    out: List[List[int]] = []
    size, key = 0, None
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        k = (t.dtype, t.device)
        if not out or k != key or size + nbytes > BUCKET_BYTES:
            out.append([])
            size, key = 0, k
        out[-1].append(i)
        size += nbytes
    return out


@torch.no_grad()
def all_reduce_mean(tensors: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """The mean over the ranks of each tensor of the dict, reduced in flat
    float32 buckets: a new dict of tensors of the same shapes and dtypes.
    Outside a process group it returns the dict itself."""
    if not in_process_group():
        return tensors
    world = dist.get_world_size()
    keys, vals = list(tensors), list(tensors.values())
    out = {}
    for idx in _buckets(vals):
        flat = torch.cat([vals[i].reshape(-1).float() for i in idx])
        _count(flat)
        dist.all_reduce(flat)
        flat /= world
        off = 0
        for i in idx:
            n = vals[i].numel()
            out[keys[i]] = flat[off:off + n].view(vals[i].shape).to(
                vals[i].dtype)
            off += n
    return {k: out[k] for k in keys}


@torch.no_grad()
def broadcast_tensors(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Copy rank ``src``'s values of ``tensors`` into every rank's, in
    place, by flat buckets of one dtype (no-op outside a process group)."""
    if not in_process_group():
        return
    vals = list(tensors)
    for idx in _buckets(vals):
        flat = torch.cat([vals[i].reshape(-1) for i in idx])
        _count(flat)
        dist.broadcast(flat, src)
        off = 0
        for i in idx:
            n = vals[i].numel()
            vals[i].copy_(flat[off:off + n].view_as(vals[i]))
            off += n


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers in every rank's ``module``."""
    broadcast_tensors([t.data for t in module.parameters()]
                      + list(module.buffers()), src)
