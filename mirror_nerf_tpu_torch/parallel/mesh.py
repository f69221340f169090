"""Data-parallel groups over `torch.distributed` (torch counterpart of
`mirror_nerf_tpu/parallel/mesh.py`).

The JAX package shards the flat ray batch over a 1-D `data` mesh and lets
XLA insert the gradient all-reduce; every device then holds the global
batch's loss. The port runs one process a rank, and a `DataGroup` stands
for the mesh:

  * `shard_rows` gives a rank its contiguous rows of a batch, in rank
    order, as `P("data")` lays them out;
  * `gather_rows` joins every rank's rows into the global batch, an
    autograd Function whose backward hands each rank its own rows of the
    incoming gradient. Every rank computes the same global loss from the
    gathered rows, so that slice is this rank's exact share, and no
    reduce-scatter is needed;
  * `all_reduce_grads` sums the ranks' parameter gradients (SUM: each
    rank's are its rows' share of the one global loss).

Backends: NCCL when each rank has a card of its own (`cuda:{local_rank}`),
gloo on the CPU, and gloo with CUDA tensors only when the caller names it
(several ranks on one card, which NCCL refuses); gloo's collectives on
CUDA tensors go through the host.

`launch` is the CLIs' entry: under `torchrun` (WORLD_SIZE set) a process
joins its group; otherwise `--num_gpus N > 1` runs ranks 1 … N−1 in
spawned processes beside rank 0 in the calling one (`run_ranks`), over a
file rendezvous in a fresh temporary directory.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# a rank that waits longer than this on a collective gives up (a peer that
# died, or one still building its kernels, which takes a few minutes)
TIMEOUT_S = 900


@dataclass(frozen=True)
class DataGroup:
    """One rank's view of a 1-D data-parallel group: its rank, the world,
    the device its tensors live on and the backend."""

    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        """gloo moves CUDA tensors through the host."""
        return x.cpu() if self.backend == "gloo" and x.is_cuda else x

    # ---- rows ----

    def shard_slice(self, n: int) -> slice:
        if n % self.world:
            raise ValueError(f"{n} rows do not split over {self.world} "
                             "ranks")
        k = n // self.world
        return slice(self.rank * k, (self.rank + 1) * k)

    def shard_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous rows of `x` (leading axis)."""
        return x[self.shard_slice(x.shape[0])]

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's `x` (the same shape on each), concatenated along
        the leading axis in rank order; no gradient."""
        x = x.detach().contiguous()
        if self.backend == "nccl":
            out = x.new_empty((self.world * x.shape[0],) + x.shape[1:])
            dist.all_gather_into_tensor(out, x)
            return out
        h = self._host(x)
        parts = [torch.empty_like(h) for _ in range(self.world)]
        dist.all_gather(parts, h)
        return torch.cat(parts).to(x.device)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """`all_gather` with a backward that returns this rank's rows of
        the gradient (exact when every rank computes the same loss from the
        gathered tensor)."""
        if x.requires_grad:
            return _GatherRows.apply(x, self)
        return self.all_gather(x)

    # ---- reductions ----

    def all_reduce_(self, x: torch.Tensor, op=dist.ReduceOp.SUM):
        h = self._host(x)
        dist.all_reduce(h, op=op)
        if h is not x:
            x.copy_(h)
        return x

    def broadcast_(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        h = self._host(x)
        dist.broadcast(h, src)
        if h is not x:
            x.copy_(h)
        return x

    def broadcast_object(self, obj, src: int = 0):
        box = [obj]
        dist.broadcast_object_list(box, src)
        return box[0]

    def all_ints(self, value: int) -> list:
        """Every rank's integer, in rank order."""
        t = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        return [int(v) for v in self.all_gather(t).tolist()]

    def any(self, flag: torch.Tensor) -> torch.Tensor:
        """The logical OR over ranks of a boolean scalar tensor."""
        t = flag.to(torch.int32).reshape(1).clone()
        return self.all_reduce_(t, dist.ReduceOp.MAX)[0] > 0

    def all(self, flag: torch.Tensor) -> torch.Tensor:
        t = flag.to(torch.int32).reshape(1).clone()
        return self.all_reduce_(t, dist.ReduceOp.MIN)[0] > 0

    def all_reduce_grads(self, leaves: Sequence[torch.Tensor]) -> None:
        """SUM every leaf's `.grad` over the ranks, in one flat buffer (a
        leaf without a gradient counts as zeros)."""
        for leaf in leaves:
            if leaf.grad is None:
                leaf.grad = torch.zeros_like(leaf)
        grads = [leaf.grad for leaf in leaves]
        flat = self.all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def broadcast_params(self, leaves: Sequence[torch.Tensor]) -> None:
        """Every rank starts from rank 0's parameters."""
        with torch.no_grad():
            flat = torch.cat([x.reshape(-1) for x in leaves])
            self.broadcast_(flat)
            offset = 0
            for x in leaves:
                x.copy_(flat[offset:offset + x.numel()].view_as(x))
                offset += x.numel()


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_gather(x)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.group.shard_slice(grad.shape[0])], None


def compact_slots(keep: torch.Tensor, cap: int,
                  group: Optional[DataGroup] = None):
    """Fixed-capacity compaction's slots: the kept rays in cumsum order,
    the first `cap` of them valid. With a group the order is the global
    one (rank 0's rows first), as one device holding every row compacts
    them. Returns (pos, valid, size, real): each ray's slot in this rank's
    buffer, whether it got one, the buffer's size (`cap` on one device;
    the ranks' largest fill rounded up to 128 with a group) and, with a
    group, which of the buffer's slots hold a ray (None on one device,
    whose empty slots come after every ray and never take a slot
    deeper)."""
    pos = torch.cumsum(keep.to(torch.int64), dim=0) - 1
    if group is None:
        return pos, keep & (pos < cap), cap, None
    counts = group.all_ints(int(keep.sum()))
    starts = np.cumsum([0] + counts[:-1])
    fill = [max(0, min(c, cap - int(s))) for c, s in zip(counts, starts)]
    valid = keep & (pos + int(starts[group.rank]) < cap)
    size = min(max(pad_to_multiple(max(fill), 128), 128), keep.shape[0])
    real = torch.arange(size, device=keep.device) < fill[group.rank]
    return pos, valid, size, real


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def generator_seed(seed: int, rank: int) -> int:
    """The seed of a rank's own random stream: `seed` itself on rank 0 (one
    rank draws what a one-device run draws), a derived one elsewhere."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(rank)])
               .generate_state(1)[0])


# ---- process groups ----


def init_distributed(rank: int, world: int, device, init_method: str,
                     backend: Optional[str] = None,
                     timeout_s: float = TIMEOUT_S) -> DataGroup:
    """Join a `world`-rank group as `rank`. The backend defaults to NCCL on
    a card (the device then `cuda:{local rank}`) and gloo on the CPU;
    `backend="gloo"` with a CUDA device shares that card among ranks. A
    collective that waits longer than `timeout_s` raises."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return DataGroup(rank=rank, world=world, device=device, backend=backend)


def close(group: Optional[DataGroup]) -> None:
    if group is not None and dist.is_initialized():
        dist.destroy_process_group()


def check_world(world: int, device,
                batch_size: Optional[int] = None) -> None:
    """Refuse what a CLI's `world`-rank run cannot do before any rank
    starts: a batch that does not split over the ranks, or more ranks than
    cards (a card is never shared or dropped quietly)."""
    if batch_size is not None and batch_size % world:
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"{world} devices")
    if torch.device(device).type == "cuda":
        have = torch.cuda.device_count()
        if world > have:
            raise ValueError(f"--num_gpus {world} needs {world} cards; "
                             f"this machine has {have}")


def _run_rank(rank: int, fn: Callable, world: int, device, init_method: str,
              backend: Optional[str], timeout_s: float, args: tuple):
    dev = torch.device(device)
    if dev.type == "cuda" and (backend or "nccl") == "nccl":
        dev = torch.device("cuda", rank)
    group = init_distributed(rank, world, dev, init_method, backend,
                             timeout_s)
    try:
        return fn(group, *args)
    finally:
        close(group)


def _spawned_rank(i: int, fn: Callable, world: int, device, init_method: str,
                  backend: Optional[str], timeout_s: float, threads: int,
                  args: tuple):
    """Rank i + 1 of a `run_ranks` group (the spawn context counts from
    0; rank 0 is the caller)."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(threads)
    _run_rank(i + 1, fn, world, device, init_method, backend, timeout_s,
              args)


def run_ranks(fn: Callable, world: int, device="cuda", args: tuple = (),
              backend: Optional[str] = None,
              init_method: Optional[str] = None,
              timeout_s: float = TIMEOUT_S):
    """`fn(group, *args)` on `world` ranks: rank 0 in this process, ranks
    1 … world − 1 in spawned ones (`fn` must be importable). Returns rank
    0's result; a rank that fails ends the others, or leaves them waiting
    on a collective until `timeout_s`. The rendezvous is `init_method`, by
    default a file in a fresh temporary directory. On the CPU each spawned
    rank takes this process's threads over the world."""
    import torch.multiprocessing as mp

    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="mnerf_rdv_")
        init_method = "file://" + os.path.join(tmp, "rendezvous")
    threads = max(torch.get_num_threads() // world, 1)
    ctx = mp.start_processes(
        _spawned_rank, args=(fn, world, device, init_method, backend,
                             timeout_s, threads, args),
        nprocs=world - 1, join=False, start_method="spawn")
    ok = False
    try:
        out = _run_rank(0, fn, world, device, init_method, backend,
                        timeout_s, args)
        ok = True
        while not ctx.join():
            pass
        return out
    finally:
        if not ok:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def launch(fn: Callable, num_procs: int, device, args: tuple = (),
           batch_size: Optional[int] = None):
    """A CLI's entry: `fn(group, *args)` with `group` None on one device;
    under `torchrun` (WORLD_SIZE set) this process joins its group, on
    `cuda:{LOCAL_RANK}`; else `num_procs > 1` runs that many ranks
    (`run_ranks`)."""
    if "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if num_procs > 1 and num_procs != world:
            raise ValueError(f"--num_gpus {num_procs} under a launcher of "
                             f"{world} processes")
        check_world(world, device, batch_size)
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        group = init_distributed(int(os.environ.get("RANK", 0)), world, dev,
                                 "env://")
        try:
            return fn(group, *args)
        finally:
            close(group)
    if num_procs <= 1:
        return fn(None, *args)
    check_world(num_procs, device, batch_size)
    return run_ranks(fn, num_procs, device, args)
