"""Training across processes on torch.distributed, the counterpart of
lora_tpu/parallel/mesh.py.

One device per rank. A mesh is the process group's ranks laid out
(dp, fsdp, tp) row-major, as lora_tpu reshapes its device list:

  - dp:   data parallel. Each dp index holds its block of the global batch
          (train_batch_size rows: global batch = train_batch_size x dp), and
          the trainable leaves' gradients (LoRA, TI rows, scale leaves) are
          averaged over dp in one flat bucket before the optimizer
          (training/train_step.py). The base is frozen, so that bucket is
          the only gradient traffic.
  - fsdp: sharding of the frozen base. Each weight keeps only its block of
          its largest evenly dividing axis (param_pspec); the forward
          all-gathers it within the fsdp sub-group where it reads it
          (ShardedParams), and the gathered copy goes when autograd lets it
          go. Under gradient checkpointing the recompute gathers again.
  - tp:   tensor parallelism is not ported: tensor_parallel > 1 raises
          (ROADMAP Slice 7b).

The ranks of one dp index (its fsdp peers) hold the same rows. Every rank
draws the global batch's random draws from the same seeded generator and
keeps its own rows (training/loss.py), so a run over the group is the run of
one process at the global batch.

Backends: NCCL where every rank has a GPU of its own; gloo on the CPU and for
ranks that share a card. Collectives of a gloo group on CUDA tensors are
staged through host memory. lora_tpu's make_multislice_mesh has no
counterpart: its dcn axis is a TPU slice topology, and across GPU nodes dp
spans every rank of the group.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import os
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "tp")
TIMEOUT_ENV = "LORA_TPU_TORCH_DIST_TIMEOUT_S"  # handshake / collective wait
DEVICE_ENV = "LORA_TPU_TORCH_DIST_DEVICE"      # "cpu": ranks on the CPU
NO_TP = ("tensor parallelism is not ported yet (ROADMAP Slice 7b): the "
         "Megatron-style splits of the functional dense layers with LoRA on "
         "both halves are a slice of their own; use data_parallel / fsdp")

_host_group = None  # gloo over every rank: barriers and host-side flags
_device: Optional[torch.device] = None


def _timeout(seconds: Optional[float] = None) -> datetime.timedelta:
    if seconds is None:
        seconds = float(os.environ.get(TIMEOUT_ENV, 1800))
    return datetime.timedelta(seconds=seconds)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _backend_and_device(local_world: int) -> Tuple[str, torch.device]:
    if os.environ.get(DEVICE_ENV) == "cpu" or not torch.cuda.is_available():
        return "gloo", torch.device("cpu")
    n = torch.cuda.device_count()
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % n)
    return ("nccl" if n >= local_world else "gloo"), dev


def initialize_distributed_from_env() -> bool:
    """Join the process group that lora_launch_torch (or torchrun) describes
    in the environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE,
    LOCAL_RANK), called by the trainer CLIs before they load anything.
    Returns True when a group of more than one rank was joined; without
    WORLD_SIZE it does nothing and returns False.

    A failed or short handshake raises (after $LORA_TPU_TORCH_DIST_TIMEOUT_S
    seconds, default 1800): a rank never runs on alone, believing it is
    rank 0 and writing into the shared output directory. Rank 0 prints the
    backend, the world size and each rank's device."""
    global _host_group, _device
    if "WORLD_SIZE" not in os.environ:
        return False
    world = int(os.environ["WORLD_SIZE"])
    if dist.is_initialized():
        return world_size() > 1
    backend, device = _backend_and_device(
        int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=int(os.environ["RANK"]), timeout=_timeout())
    if dist.get_world_size() != world:
        raise RuntimeError(f"distributed handshake joined "
                           f"{dist.get_world_size()} ranks, the launcher "
                           f"expected {world}")
    _device = device
    ones = torch.ones(1, device=device)  # every rank, on the backend
    if int(_all_reduce(ones, dist.group.WORLD).item()) != world:
        raise RuntimeError(f"distributed handshake summed {ones.item()} "
                           f"ranks, the launcher expected {world}")
    _host_group = (dist.new_group(backend="gloo", timeout=_timeout())
                   if backend != "gloo" else dist.group.WORLD)
    devices: List[Optional[str]] = [None] * world
    dist.all_gather_object(devices, str(device), group=_host_group)
    if dist.get_rank() == 0:
        print(f"lora_tpu_torch: joined a process group: backend={backend} "
              f"world_size={world} devices={devices}", flush=True)
    return world > 1


def finalize_distributed() -> None:
    """Leave the process group, if one was joined (the CLIs' last act)."""
    global _host_group, _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group, _device = None, None


def rank_device(device) -> torch.device:
    """The device a rank trains on: under a process group a bare "cuda" is
    this rank's card (cuda:LOCAL_RANK, modulo the cards there are, so ranks
    may share one); anything else is itself."""
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None
            and dist.is_initialized()):
        if _device is not None and _device.type == "cuda":
            return _device
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                            % torch.cuda.device_count())
    return device


def is_main_process() -> bool:
    """Only rank 0 writes to the shared output directory: metrics, periodic
    and final artifacts, preemption state."""
    return rank() == 0


def _host():
    return _host_group if _host_group is not None else dist.group.WORLD


def multihost_barrier(name: str = "barrier",
                      timeout_s: float = 1800.0) -> None:
    """Every rank waits here, up to timeout_s (no-op on one process): the
    other ranks outlive rank 0's class-image generation. A gloo monitored
    barrier, which names the ranks that did not arrive."""
    del name  # the barrier is positional; the name documents the call site
    if world_size() > 1:
        dist.monitored_barrier(group=_host(), timeout=_timeout(timeout_s),
                               wait_all_ranks=True)


def _is_gloo(group) -> bool:
    return dist.get_backend(group) == dist.Backend.GLOO


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce; a gloo group's CUDA tensor goes through a host
    copy."""
    if t.is_cuda and _is_gloo(group):
        host = t.detach().cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def _broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    if t.is_cuda and _is_gloo(group):
        host = t.detach().cpu()
        dist.broadcast(host, src=src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def _all_gather0(shard: torch.Tensor, n: int, group) -> torch.Tensor:
    """The n ranks' shards concatenated along dim 0, bit for bit."""
    shard = shard.contiguous()
    if not _is_gloo(group):
        out = shard.new_empty((n * shard.shape[0],) + tuple(shard.shape[1:]))
        dist.all_gather_into_tensor(out, shard, group=group)
        return out
    # gloo: a byte view on the host (every dtype, exact)
    host = shard.detach().cpu().reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(host) for _ in range(n)]
    dist.all_gather(parts, host, group=group)
    out = torch.cat(parts).view(shard.dtype).reshape(
        (n * shard.shape[0],) + tuple(shard.shape[1:]))
    return out.to(shard.device)


class Mesh:
    """The group's ranks laid out (dp, fsdp, tp), one device per rank.
    `shape` is {"dp", "fsdp", "tp"} -> size, `coords` this rank's index on
    each axis, `groups` the sub-group of each axis longer than 1 that holds
    this rank (every rank creates every sub-group, in one order). A mesh
    made with no process group (or a world that differs from its size) is
    geometry only: its collectives raise."""

    axis_names = AXES

    def __init__(self, dp: int, fsdp: int = 1, tp: int = 1):
        self.shape = {"dp": int(dp), "fsdp": int(fsdp), "tp": int(tp)}
        self.size = int(dp) * int(fsdp) * int(tp)
        self.distributed = dist.is_initialized() and (
            world_size() == self.size)
        self.rank = rank() if self.distributed else 0
        grid = np.arange(self.size).reshape(dp, fsdp, tp)
        self.coords = dict(zip(AXES, (int(i) for i in
                                      np.argwhere(grid == self.rank)[0])))
        self.groups: Dict[str, object] = {}
        if not self.distributed:
            return
        for i, ax in enumerate(AXES):
            n = self.shape[ax]
            if n == 1:
                continue
            for line in np.moveaxis(grid, i, -1).reshape(-1, n):
                ranks = [int(r) for r in line]
                g = dist.new_group(ranks=ranks, timeout=_timeout())
                if self.rank in ranks:
                    self.groups[ax] = g

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, fsdp={self.shape['fsdp']}, "
                f"tp={self.shape['tp']}, rank={self.rank})")

    def group(self, axis: str):
        if axis not in self.groups:
            raise RuntimeError(f"{self!r} has no process group on {axis!r}")
        return self.groups[axis]

    def all_reduce(self, t: torch.Tensor, axis: str = "dp",
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In place over the axis (nothing for an axis of 1)."""
        if self.shape[axis] > 1:
            _all_reduce(t, self.group(axis), op)
        return t

    def all_gather0(self, shard: torch.Tensor,
                    axis: str = "fsdp") -> torch.Tensor:
        n = self.shape[axis]
        return shard if n == 1 else _all_gather0(shard, n, self.group(axis))

    def mean_grads(self, params: Sequence[torch.Tensor],
                   loss: torch.Tensor) -> torch.Tensor:
        """Average the params' .grad (zeros where None) and the loss over dp
        in one flat f32 bucket; the grads are set to the averages and the
        global loss is returned."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        bucket = torch.cat([g.reshape(-1).float() for g in grads]
                           + [loss.detach().reshape(1).float()])
        self.all_reduce(bucket).div_(self.shape["dp"])
        for p, g in zip(params, bucket[:-1].split([p.numel()
                                                   for p in params])):
            p.grad = g.view_as(p).to(p.dtype)
        return bucket[-1]


def warm_collectives(mesh: Optional[Mesh]) -> None:
    """Open each sub-group's communicator while the ranks are in lockstep
    (right after the handshake or a barrier), not at the first step, whose
    start skews across ranks: one barrier on the host group, then one tiny
    all-reduce per sub-group on the rank's device. No-op on one process."""
    if mesh is None or not mesh.distributed or mesh.size == 1:
        return
    dist.monitored_barrier(group=_host(), timeout=_timeout(),
                           wait_all_ranks=True)
    dev = _device if _device is not None else torch.device("cpu")
    for ax in AXES:
        if mesh.shape[ax] > 1:
            mesh.all_reduce(torch.zeros(1, device=dev), ax)


class PreemptionCoordinator:
    """One stop decision for every rank. SIGTERM reaches ranks at different
    times (or only some of them); a rank acting on its own flag would leave
    its peers blocked in the next collective. Every `every` micro-steps the
    ranks MAX-reduce their local flags on the host group, so a signal to any
    rank stops all of them at the same step and rank 0 checkpoints even if
    the signal never reached it. One process: the local flag."""

    def __init__(self, every: int = 10):
        self.every = max(int(every), 1)
        self.nproc = world_size()
        self._agreed = False

    def should_stop(self, local_flag: bool, step: int) -> bool:
        if self.nproc == 1:
            return local_flag
        if not self._agreed and step % self.every == 0:
            t = torch.tensor([1 if local_flag else 0], dtype=torch.int32)
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host())
            self._agreed = bool(t.item())
        return self._agreed


def make_mesh(dp: int = -1, fsdp: int = 1, tp: int = 1,
              world: Optional[int] = None) -> Mesh:
    """Mesh (dp, fsdp, tp) over the group's ranks (`world`, default the
    group's size); dp=-1 takes the ranks left over."""
    if tp > 1:
        raise NotImplementedError(NO_TP)
    n = world_size() if world is None else int(world)
    if dp == -1:
        dp = n // (fsdp * tp)
    if dp * fsdp * tp != n:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp} != {n} devices")
    return Mesh(dp, fsdp, tp)


BatchShard = collections.namedtuple("BatchShard", "index count")


def batch_sharding(mesh: Optional[Mesh]) -> BatchShard:
    """The block of the global batch this rank holds: the dp index and the
    dp size (fsdp peers hold the same block)."""
    if mesh is None:
        return BatchShard(0, 1)
    return BatchShard(mesh.coords["dp"], mesh.shape["dp"])


def data_parallel_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.shape["dp"]


def param_pspec(name: str, shape: Tuple[int, ...], mesh,
                use_fsdp: bool = False, use_tp: bool = False
                ) -> Tuple[Optional[str], ...]:
    """lora_tpu's PartitionSpec of one base weight, as a tuple: with fsdp,
    the largest axis that the fsdp size divides evenly (the first of equal
    ones, never an axis of 1) is "fsdp"; every other axis is None."""
    del name  # the tensor-parallel rules read it (Slice 7b)
    if use_tp and mesh.shape["tp"] > 1:
        raise NotImplementedError(NO_TP)
    spec: List[Optional[str]] = [None] * len(shape)
    n = mesh.shape["fsdp"]
    if use_fsdp and n > 1:
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if shape[i] % n == 0 and shape[i] > 1:
                spec[i] = "fsdp"
                break
    return tuple(spec)


class ShardedParams(Mapping):
    """A flat base-param dict sharded over the mesh's fsdp axis: each weight
    that param_pspec shards keeps its own block (the sharded axis moved to
    the front), and reading it (params[name], params.get(name)) all-gathers
    the whole weight within the fsdp sub-group. Every rank of the sub-group
    must read the same names in the same order, which one forward does."""

    def __init__(self, params: Mapping[str, torch.Tensor], mesh: Mesh):
        self.mesh = mesh
        n, i = mesh.shape["fsdp"], mesh.coords["fsdp"]
        self._p: Dict[str, torch.Tensor] = {}
        self._dim: Dict[str, int] = {}
        for name, w in params.items():
            spec = param_pspec(name, tuple(w.shape), mesh, use_fsdp=True)
            if "fsdp" in spec:
                d = spec.index("fsdp")
                self._p[name] = w.detach().movedim(d, 0).chunk(n)[i].clone()
                self._dim[name] = d
            else:  # an alias: host_offloaded may move the module's copy
                self._p[name] = w.detach()

    def __getitem__(self, name: str) -> torch.Tensor:
        w = self._p[name]
        d = self._dim.get(name)
        if d is None:
            return w
        # the unsharded layout, so the forward sums as it does unsharded
        return self.mesh.all_gather0(w).movedim(0, d).contiguous()

    def __contains__(self, name) -> bool:
        return name in self._p

    def __iter__(self):
        return iter(self._p)

    def __len__(self) -> int:
        return len(self._p)

    def local(self, name: str) -> torch.Tensor:
        """This rank's block of the weight (the whole weight if unsharded)."""
        return self._p[name]


def shard_params(params: Mapping[str, torch.Tensor], mesh: Mesh,
                 use_fsdp: bool = False, use_tp: bool = False):
    """The base params under the mesh: sharded over fsdp (ShardedParams)
    with use_fsdp and an fsdp axis longer than 1, else the same dict."""
    if use_tp and mesh.shape["tp"] > 1:
        raise NotImplementedError(NO_TP)
    if use_fsdp and mesh.shape["fsdp"] > 1:
        return ShardedParams(params, mesh)
    return params


@torch.no_grad()
def replicate_tree(tree, mesh: Optional[Mesh]):
    """Broadcast every leaf of a trainable tree from rank 0 in one flat
    bucket, in place, so every rank starts from the same values; returns
    the tree."""
    from ..training.optim import tree_leaves

    if mesh is None or not mesh.distributed or mesh.size == 1:
        return tree
    leaves = tree_leaves(tree)
    if not leaves:
        return tree
    bucket = torch.cat([x.detach().reshape(-1).float() for x in leaves])
    _broadcast(bucket, 0, dist.group.WORLD)
    for x, v in zip(leaves, bucket.split([x.numel() for x in leaves])):
        x.copy_(v.view_as(x))
    return tree


def shard_batch(batch: Mapping, mesh: Optional[Mesh]) -> Dict:
    """This rank's rows of a global batch (numpy arrays or tensors): the
    dp index's contiguous block. The global batch axis must divide by dp."""
    index, dp = batch_sharding(mesh)
    for name, v in batch.items():
        if v.shape[0] % dp != 0:
            raise ValueError(
                f"global batch axis of {name!r} ({v.shape[0]}) is not "
                f"divisible by dp={dp}. Batch semantics are per-chip: the "
                f"global batch is train_batch_size x dp, so pass the loader "
                f"a multiple of dp (the trainers do this automatically).")
    if dp == 1:
        return dict(batch)
    out = {}
    for name, v in batch.items():
        per = v.shape[0] // dp
        out[name] = v[index * per:(index + 1) * per]
    return out


def mesh_from_flags(data_parallel: bool = False, fsdp: int = 1, tp: int = 1,
                    world: Optional[int] = None) -> Optional[Mesh]:
    """The trainers' mesh: None when no parallelism is asked for or the
    group has one rank, else (dp, fsdp, tp) where dp takes the ranks left
    after fsdp x tp when data_parallel is set (else 1)."""
    if tp > 1:
        raise NotImplementedError(NO_TP)
    n = world_size() if world is None else int(world)
    if not (data_parallel or fsdp > 1) or n == 1:
        return None
    if n % (fsdp * tp) != 0:
        raise ValueError(
            f"fsdp({fsdp}) x tp({tp}) must divide the device count ({n})")
    dp = n // (fsdp * tp) if data_parallel else 1
    if dp * fsdp * tp != n:
        raise ValueError(
            f"mesh {dp}x{fsdp}x{tp} does not cover {n} devices; enable "
            f"data_parallel or raise fsdp/tp")
    return make_mesh(dp=dp, fsdp=fsdp, tp=tp, world=n)


@contextlib.contextmanager
def host_offloaded(modules: Iterable[torch.nn.Module]):
    """Move the modules' parameters to host memory for the block and back
    after it, raise or not: under fsdp the device keeps only the shards.
    CPU modules stay as they are."""
    moved = []
    try:
        for m in modules:
            for p in m.parameters():
                if p.is_cuda:
                    moved.append((p, p.device))
                    p.data = p.data.to("cpu")
        if moved:
            torch.cuda.empty_cache()
        yield
    finally:
        for p, dev in moved:
            p.data = p.data.to(dev)
