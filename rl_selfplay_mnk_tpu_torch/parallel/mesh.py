"""Data-parallel ranks over ``torch.distributed`` (counterpart of the JAX
package's ``parallel/mesh.py``).

The JAX package spans a 1-D device mesh (axis "env") with one jitted
program; GSPMD inserts the collectives. The port runs one process a rank
and writes the collectives out:

  * a JAX mesh of ``d`` devices is a world of ``d`` ranks, one card each;
    a JAX run of "2 processes x 2 devices" is a port run of world 4, and
    ``use_mesh`` over several local devices in one process is run as one
    rank a card through the same ``--multihost`` flags;
  * rank ``r`` owns envs ``[r E/d, (r+1) E/d)``, the rows that
    ``shard_batched`` gives device ``r`` (``EnvShard``, ``shard_batched``);
  * parameters, BatchNorm running statistics and, outside ZeRO, the
    optimizer state are replicated: every rank builds them from the same
    seed, and ``replicate`` broadcasts rank 0's copy;
  * every reduction that GSPMD makes global over the batch is a collective
    here (``Collectives``; ``alg/ppo.py`` and ``alg/zero_epochs.py`` say
    where): BatchNorm statistics, the advantage normalisation, the
    gradients, the metrics and the finished-episode sums;
  * random draws do not depend on the world size: every rank draws the
    global tensor from the same seeded generator and keeps its rows
    (``EnvShard.uniform``, ``EnvShard.sides``).

Backend, fixed by the device: ``nccl`` where every rank has a card of its
own, ``gloo`` on the CPU and where ranks share a card (NCCL refuses two
ranks on one device). A gloo collective on a CUDA tensor is staged through
host memory (``Collectives``). Ranks are taken to run on one host: a rank
uses ``cuda:<rank>`` unless the caller names a device.

Not ported, as not applicable: ``parallel/audit.py`` (an HLO audit; torch
has no HLO) and ``put_global``'s per-device shard assembly (a rank holds
its rows as ordinary tensors).
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..utils.hardware import resolve_device

# How long a collective may wait for the other ranks before it raises.
COLLECTIVE_TIMEOUT_S = 300


def backend_for(device, world: int) -> str:
    """``nccl`` for ranks with a card each, else ``gloo``."""
    device = torch.device(device)
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _init_method(address: Optional[str]) -> str:
    if address is None:
        return "env://"
    if address.startswith(("tcp://", "file://", "env://")):
        return address
    return f"tcp://{address}"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> None:
    """Join the process group (no-op for one process or when already
    joined). ``coordinator_address`` is ``host:port`` (or a ``tcp://``,
    ``file://`` or ``env://`` init method); ``device`` is the rank's device
    (None = its card), which fixes the backend."""
    if num_processes is not None and num_processes <= 1:
        return
    if dist.is_initialized():
        return
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed needs num_processes and process_id: nothing on "
                         "the machine tells a process of its cluster")
    join_group(coordinator_address, num_processes, process_id, device)


def join_group(address: Optional[str], world: int, rank: int, device=None) -> None:
    """Join a process group of ``world`` ranks as ``rank``, a group of one
    included (``init_distributed`` skips that one), with the backend of
    ``device`` (None = the rank's card)."""
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        resolve_device(dev)  # raises without CUDA, before any rendezvous
    backend = backend_for(dev, world)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=_init_method(address), world_size=world,
                            rank=rank, timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    """True on the rank that owns host-side I/O (exports, metric streams,
    stdout, checkpoints). One process: always True."""
    return process_index() == 0


def rank_device(device=None, rank: Optional[int] = None) -> torch.device:
    """The rank's device: as named, or for None and a bare ``"cuda"`` the
    card ``cuda:<rank>`` (``cuda`` itself without a process group)."""
    if device is not None and str(device) not in ("cuda",):
        return torch.device(device)
    if rank is None:
        if not dist.is_initialized():
            return torch.device("cuda")
        rank = process_index()
    return torch.device(f"cuda:{rank}")


@dataclass(frozen=True)
class EnvShard:
    """Rows ``[start, stop)`` of a batch of ``total`` envs."""

    start: int
    stop: int
    total: int

    @property
    def size(self) -> int:
        return self.stop - self.start

    def take(self, x: torch.Tensor) -> torch.Tensor:
        return x[self.start:self.stop]

    def uniform(self, tail, generator: Optional[torch.Generator], device) -> torch.Tensor:
        """This shard's rows of a (total, *tail) draw of uniforms in (0, 1)
        (``ops.masked.masked_sample``'s noise)."""
        u = torch.rand((self.total,) + tuple(tail), generator=generator, device=device)
        return self.take(u).clamp_(min=torch.finfo(torch.float32).tiny)

    def sides(self, generator: Optional[torch.Generator], device) -> torch.Tensor:
        """This shard's rows of a (total,) side draw
        (``selfplay.wrapper.draw_sides``)."""
        return self.take(torch.randint(0, 2, (self.total,), generator=generator, device=device,
                                       dtype=torch.int32))


def env_shard(num_envs: int, world: Optional[int] = None, rank: Optional[int] = None) -> EnvShard:
    """The env rows of ``rank`` (default: this process) in a world of
    ``world`` ranks."""
    world = world_size() if world is None else world
    rank = process_index() if rank is None else rank
    if num_envs % world:
        raise ValueError(f"num_envs ({num_envs}) must divide evenly over {world} ranks")
    per = num_envs // world
    return EnvShard(rank * per, (rank + 1) * per, num_envs)


def _flatten(tree):
    """Leaves of a nest of dicts, lists, tuples and NamedTuples, and a
    function that rebuilds the nest from new leaves."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, i = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(leaves[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)

    return [leaf for p in parts for leaf in p[0]], rebuild


def shard_batched(tree: Any, world: int, rank: int, batch_size: Optional[int] = None) -> Any:
    """Rank ``rank``'s rows of every leaf whose leading axis is the batch;
    other leaves are kept whole (replicated).

    With ``batch_size`` (the env count) exactly the leaves whose leading
    dimension equals it are sliced. Without it the nest must be
    homogeneous, as the JAX package's ``shard_batched`` requires: two
    distinct divisible leading dims, none divisible, or one divisible dim
    beside non-divisible non-scalar leaves raise instead of slicing a
    coincidental table. Scalars are always kept whole."""
    leaves, rebuild = _flatten(tree)
    leaves = [torch.as_tensor(x) for x in leaves]
    if batch_size is None:
        nonscalar = {x.shape[0] for x in leaves if x.dim() >= 1 and x.shape[0] > 0}
        divisible = {d for d in nonscalar if d % world == 0}
        if len(divisible) > 1:
            raise ValueError(
                "shard_batched without batch_size on a mixed nest: leading dims "
                f"{sorted(divisible)} are all divisible by the world size ({world}) — pass "
                "batch_size=<env count> to pick which axis is the batch")
        if nonscalar and not divisible:
            raise ValueError(
                f"shard_batched without batch_size: no leading dim in {sorted(nonscalar)} "
                f"divides the world size ({world}) — nothing would shard. Pass batch_size "
                "(and a divisible env count) or use replicate()")
        if nonscalar - divisible:
            raise ValueError(
                f"shard_batched without batch_size on a non-homogeneous nest: dim0 "
                f"{sorted(divisible)} would shard while {sorted(nonscalar - divisible)} is "
                "kept whole — pass batch_size=<env count> to make placement explicit")

    def is_batch(x) -> bool:
        if x.dim() < 1 or x.shape[0] == 0 or x.shape[0] % world:
            return False
        return batch_size is None or x.shape[0] == batch_size

    def part(x):
        if not is_batch(x):
            return x
        per = x.shape[0] // world
        return x[rank * per:(rank + 1) * per]

    return rebuild([part(x) for x in leaves])


class Collectives:
    """The collectives the data-parallel learner uses, over the default
    process group: ``all_reduce`` (sum), ``reduce_scatter`` (sum, this
    rank's chunk), ``all_gather`` and ``broadcast``.

    On ``nccl`` they are the library's own (``reduce_scatter_tensor``,
    ``all_gather_into_tensor``). On ``gloo`` a CUDA tensor is staged
    through host memory, ``reduce_scatter`` is an all-reduce of which the
    rank keeps its chunk, and ``all_gather`` is the list form: the calls
    that gloo has in every torch release the port runs on.

    While ``timed`` is set each call synchronises the device before and
    after and adds its wall time to ``stats[name] = [calls, seconds]`` (off
    on the training path; the chip check sets it around the update)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.world = world_size()
        self.rank = process_index()
        self.backend = dist.get_backend() if dist.is_initialized() else "none"
        self.stage = self.backend == "gloo" and self.device.type == "cuda"
        self.timed = False
        self.stats = defaultdict(lambda: [0, 0.0])

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, name, fn, *tensors):
        if not self.timed:
            return fn(*tensors)
        self._sync()
        t0 = time.perf_counter()
        out = fn(*tensors)
        self._sync()
        entry = self.stats[name]
        entry[0] += 1
        entry[1] += time.perf_counter() - t0
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks, in place; returns ``x``."""
        def op(x):
            if self.stage:
                host = x.cpu()
                dist.all_reduce(host)
                x.copy_(host)
            else:
                dist.all_reduce(x)
            return x
        return self._run("all_reduce", op, x)

    def reduce_scatter(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of the sum over ranks of ``flat`` (a 1-D tensor
        whose length divides by the world size)."""
        per = flat.shape[0] // self.world

        def op(flat):
            if self.backend == "gloo":
                summed = flat.cpu() if self.stage else flat.clone()
                dist.all_reduce(summed)
                return summed[self.rank * per:(self.rank + 1) * per].to(flat.device)
            out = torch.empty((per,), dtype=flat.dtype, device=flat.device)
            dist.reduce_scatter_tensor(out, flat.contiguous())
            return out
        return self._run("reduce_scatter", op, flat)

    def all_gather(self, chunk: torch.Tensor) -> torch.Tensor:
        """The ranks' chunks, concatenated in rank order."""
        def op(chunk):
            if self.backend == "gloo":
                src = chunk.cpu() if self.stage else chunk.contiguous()
                parts = [torch.empty_like(src) for _ in range(self.world)]
                dist.all_gather(parts, src)
                return torch.cat(parts).to(chunk.device)
            out = torch.empty((self.world * chunk.shape[0],), dtype=chunk.dtype,
                              device=chunk.device)
            dist.all_gather_into_tensor(out, chunk.contiguous())
            return out
        return self._run("all_gather", op, chunk)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank, in place."""
        def op(x):
            if self.stage:
                host = x.cpu()
                dist.broadcast(host, src)
                x.copy_(host)
            else:
                dist.broadcast(x, src)
            return x
        return self._run("broadcast", op, x)


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks, differentiable: the backward of a sum that every
    rank uses is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, coll):
        ctx.coll = coll
        return coll.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.coll.all_reduce(grad.contiguous().clone()), None


def all_reduce_mean(x: torch.Tensor, coll: Collectives) -> torch.Tensor:
    """The mean over ranks of ``x``, differentiable (a rank's mean of equal
    shards is its share of the global mean)."""
    return _AllReduceSum.apply(x, coll) / coll.world


class DataParallel:
    """What the data-parallel learner needs of its world (more than one
    rank): the collectives and this rank's env rows. Snapshots and deep
    copies share it."""

    def __init__(self, coll: Collectives, shard: EnvShard):
        self.coll, self.shard = coll, shard
        self.world, self.rank = coll.world, coll.rank

    def __deepcopy__(self, memo):
        return self

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over ranks of ``x`` (not differentiable)."""
        return self.coll.all_reduce(x.detach().clone()) / self.world

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x`` (the same shape on each), in rank
        order, on the CPU in ``x``'s dtype (sent as float64, which holds the
        env state's integers, booleans and float32 values exactly)."""
        flat = self.coll.all_gather(x.detach().reshape(-1).to(torch.float64))
        return flat.reshape((-1,) + tuple(x.shape[1:])).to(x.dtype).cpu()

    def batch_stats(self, stats: torch.Tensor) -> torch.Tensor:
        """BatchNorm's statistics over the ranks' rows: the mean over ranks
        of each rank's means, with the backward that carries the other
        ranks' terms (``models.common.BatchNorm.stat_sync``)."""
        return all_reduce_mean(stats, self.coll)


def data_parallel(num_envs: int, device) -> Optional[DataParallel]:
    """The learner's ``DataParallel`` in a process group of more than one
    rank; None otherwise (one rank trains as without a process group)."""
    if world_size() == 1:
        return None
    return DataParallel(Collectives(device), env_shard(num_envs))


def replicate(tensors, coll: Collectives) -> None:
    """Rank 0's values of ``tensors`` on every rank, in place."""
    with torch.no_grad():
        for t in tensors:
            coll.broadcast(t)
