"""Process groups, the device mesh, and the collectives of the multi-device layer.

Counterpart of ``vub_image_denoising_tpu/parallel/mesh.py``.  JAX runs one
process per host over one global mesh of devices, and GSPMD inserts the
collectives into each jitted step.  Here, as is torch's way, each device is
driven by a process of its own (a rank), the ranks form a
``torch.distributed`` group, and every collective is written out: the
trainers all-reduce gradients, FSDP gathers parameters, tensor parallelism
gathers channels, the pipeline sends microbatches.

- ``init_distributed`` reads torchrun's environment (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``); JAX reads
  ``JAX_COORDINATOR_ADDRESS`` and its kin.  The caller names the backend:
  ``nccl`` when each rank has its own card, ``gloo`` for CPU ranks or for
  ranks that share one card (NCCL refuses two ranks on one GPU).  Nothing
  picks it for the caller.
- ``Mesh`` lays the ranks out row-major over named axes (``"data"``,
  ``"model"``, ``"stage"``) and holds one process group per line of each
  axis.  ``torch.distributed.device_mesh`` is not used: it needs an
  initialized group even for one process and binds each rank to a device
  of its own, where two ranks here may share ``cuda:0``.
- With one process every function here is the identity, as in JAX.
- gloo runs its collectives on host memory.  A CUDA tensor under gloo goes
  through ``_via_host``: one copy to the host and back, counted in
  ``host_copies``; nccl takes CUDA tensors as they are.
"""

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..utils.device import resolve_device


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def init_distributed(backend: str = "nccl", init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None) -> bool:
    """Join the process group: ``torch.distributed.init_process_group`` from
    the arguments or torchrun's environment.  Returns True if the group is
    up, False when no coordinator is configured (no ``init_method`` and no
    ``MASTER_ADDR``), as JAX's does; a second call is a no-op.  With
    ``backend="nccl"`` each rank first takes the card ``LOCAL_RANK`` (or its
    rank) as its current device."""
    if is_distributed():
        return True
    if init_method is None and "MASTER_ADDR" not in os.environ:
        return False
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


class Mesh:
    """The ranks laid out row-major over named axes, with a process group
    per line of each axis (every rank creates every group, in one order, as
    ``torch.distributed.new_group`` asks).  ``device`` is where this rank
    computes."""

    def __init__(self, shape: Optional[Sequence[int]] = None,
                 axis_names: Sequence[str] = ("data",), device=None):
        n = world_size()
        if shape is None:
            shape = [n] + [1] * (len(axis_names) - 1)
        shape = [int(s) for s in shape]
        if int(np.prod(shape)) != n or len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} over {axis_names} does not hold {n} ranks")
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = tuple(axis_names)
        self.device = resolve_device(device)
        coords = np.unravel_index(rank(), shape)
        self.coords = {a: int(c) for a, c in zip(axis_names, coords)}
        self.groups = {}
        grid = np.arange(n).reshape(shape)
        for i, axis in enumerate(axis_names):
            lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
            self.groups[axis] = None
            for line in lines:
                group = dist.new_group([int(r) for r in line]) if n > 1 else None
                if rank() in line:
                    self.groups[axis] = group

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (None: alone)."""
        return self.groups.get(axis) if self.size(axis) > 1 else None


def make_mesh(shape: Optional[Sequence[int]] = None, axis_names: Sequence[str] = ("data",),
              device=None) -> Mesh:
    """A mesh over every rank; ``shape`` defaults to all of them on the
    first axis."""
    return Mesh(shape, axis_names, device)


# ---------------------------------------------------------------------------
# Collectives (group None: the whole world; a group of one: the identity)
# ---------------------------------------------------------------------------

def group_size(group=None) -> int:
    return dist.get_world_size(group) if is_distributed() else 1


def _via_host(t, op):
    """Run ``op`` on ``t``, through one copy to the host and back when gloo
    would be handed a CUDA tensor."""
    if t.device.type == "cuda" and dist.get_backend() == "gloo":
        host = t.detach().cpu()
        out = op(host)
        _via_host.host_copies += 1
        return out.to(t.device)
    return op(t)


_via_host.host_copies = 0  # collectives that took the host copy since the last reset


def host_copies() -> int:
    return _via_host.host_copies


def all_reduce(t, group=None, op=None):
    """Sum (or ``op``) of ``t`` over the group, as a new tensor."""
    if group_size(group) == 1:
        return t

    def run(x):
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op, group=group)
        return x

    return _via_host(t.contiguous(), run)


def all_gather(t, dim: int = 0, group=None):
    """The group's tensors (equal shapes), concatenated along ``dim`` in rank order."""
    n = group_size(group)
    if n == 1:
        return t

    def run(x):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    return _via_host(t.contiguous(), run)


def all_gather_many(tensors, dims, group=None):
    """``all_gather`` of each of ``tensors`` (one dtype) along its dim in
    ``dims``, in one collective on their flattened concatenation."""
    n = group_size(group)
    if n == 1:
        return list(tensors)
    g = all_gather(torch.cat([t.reshape(-1) for t in tensors])[None], 0, group)
    out, off = [], 0
    for t, d in zip(tensors, dims):
        k = t.numel()
        out.append(torch.cat([g[r, off:off + k].view(t.shape) for r in range(n)], d))
        off += k
    return out


def reduce_scatter(t, dim: int = 0, group=None):
    """The sum over the group of ``t``, cut into equal chunks along ``dim``:
    this rank's chunk.  nccl only: gloo has no reduce-scatter (FSDP
    all-reduces there, ``fsdp.FullyShardedDataParallel.reduce``)."""
    n = group_size(group)
    if n == 1:
        return t
    parts = [p.contiguous() for p in t.chunk(n, dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def broadcast(t, src: int = 0, group=None):
    """``t`` as rank ``src`` (a global rank) holds it, copied into ``t``."""
    if group_size(group) == 1:
        return t

    def run(x):
        x = x.clone()
        dist.broadcast(x, src, group=group)
        return x

    with torch.no_grad():
        t.copy_(_via_host(t.contiguous(), run))
    return t


def send(t, dst: int):
    def run(x):
        dist.send(x.contiguous(), dst)
        return x

    _via_host(t, run)


def recv(like, src: int):
    """A tensor like ``like`` received from rank ``src``."""
    def run(x):
        x = torch.empty(x.shape, dtype=x.dtype, device=x.device)  # contiguous, as gloo needs
        dist.recv(x, src)
        return x

    return _via_host(like, run)


def all_reduce_mean_flat(tensors, group=None):
    """The mean over the group of each of ``tensors``, in one all-reduce of
    their concatenation."""
    n = group_size(group)
    if n == 1:
        return list(tensors)
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group) / n
    return [x.view_as(t) for x, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def barrier():
    if is_distributed():
        dist.barrier()


def is_writer() -> bool:
    """True on the rank that writes files (rank 0)."""
    return rank() == 0


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group whose gradient is the sum over the group too: each
    rank's loss depends on the sum, so each rank's share of it gets every
    rank's gradient (cross-rank BatchNorm statistics).  Twice
    differentiable."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def all_reduce_sum_autograd(x, group=None):
    return x if group_size(group) == 1 else _AllReduceSum.apply(x, group)


class _GatherMany(torch.autograd.Function):
    """``all_gather_many`` whose backward keeps each gradient's own chunk:
    the gathered tensors feed compute that every rank repeats alike
    (tensor parallelism's whole blocks)."""

    @staticmethod
    def forward(ctx, dims, group, *xs):
        ctx.dims, ctx.group = dims, group
        return tuple(all_gather_many(xs, dims, group))

    @staticmethod
    def backward(ctx, *gs):
        n, i = group_size(ctx.group), dist.get_rank(ctx.group)
        return (None, None, *(g.chunk(n, d)[i].contiguous() for g, d in zip(gs, ctx.dims)))


def gather_many_autograd(tensors, dims, group=None):
    if group_size(group) == 1:
        return list(tensors)
    return list(_GatherMany.apply(tuple(dims), group, *tensors))


class _GatherRows(torch.autograd.Function):
    """The group's rows, concatenated in rank order; each rank's loss on
    them is one global term, so the backward sums the ranks' gradients and
    keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, 0, group)

    @staticmethod
    def backward(ctx, g):
        g = _AllReduceSum.apply(g, ctx.group)
        return g.chunk(group_size(ctx.group), 0)[dist.get_rank(ctx.group)], None


def all_gather_rows(x, group=None):
    """Every rank's rows of a batch (dim 0), differentiable (``_GatherRows``)."""
    return x if group_size(group) == 1 else _GatherRows.apply(x, group)


# ---------------------------------------------------------------------------
# Batches and replicated state
# ---------------------------------------------------------------------------

def local_batch_rows(n_rows: int, mesh: Optional[Mesh] = None, axis: str = "data"):
    """Rows of a global batch of ``n_rows`` that this rank holds: one
    contiguous block per index along ``axis``, as JAX's data-sharded batch
    gives each device.  ``n_rows`` must divide by the axis size."""
    n = 1 if mesh is None else mesh.size(axis)
    if n_rows % n:
        raise ValueError(f"a batch of {n_rows} does not split over the {n}-way {axis} axis")
    k = n_rows // n
    i = 0 if mesh is None else mesh.index(axis)
    return list(range(i * k, (i + 1) * k))


def shard_batch(x, mesh: Optional[Mesh] = None, axis: str = "data"):
    """This rank's rows (``local_batch_rows``) of a global batch ``x`` that
    every rank holds, on the mesh's device."""
    rows = local_batch_rows(x.shape[0], mesh, axis)
    x = torch.as_tensor(x)[rows[0]:rows[-1] + 1] if rows else torch.as_tensor(x)[:0]
    return x if mesh is None else x.to(mesh.device)


def put_batch(batch, mesh: Optional[Mesh] = None, axis: str = "data"):
    """``shard_batch`` of each tensor of a tuple (or one tensor)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(x, mesh, axis) for x in batch)
    return shard_batch(batch, mesh, axis)


make_global_batch = shard_batch  # every process holds the host batch; each keeps its rows


def make_global_batch_from_local(x_local, rows, n_global: int, mesh: Optional[Mesh] = None,
                                 axis: str = "data"):
    """This rank's part of the global batch from the rows it fetched alone:
    ``rows`` must be ``local_batch_rows(n_global)``, in that order."""
    if list(rows) != local_batch_rows(n_global, mesh, axis):
        raise ValueError("rows are not this rank's rows of the global batch")
    x = torch.as_tensor(x_local)
    return x if mesh is None else x.to(mesh.device)


def replicate(t, mesh: Optional[Mesh] = None):
    """``t`` as rank 0 holds it, on every rank (broadcast in place)."""
    return t if mesh is None else broadcast(t, 0)


def put_replicated(tree, mesh: Optional[Mesh] = None):
    """``replicate`` the tensors of a dict, list or tuple, in one broadcast
    per dtype (a state_dict's tensors share their parameters' memory, so
    this replicates a model)."""
    if mesh is None or world_size() == 1:
        return tree
    values = tree.values() if isinstance(tree, dict) else tree
    by_dtype = {}
    for t in values:
        if torch.is_tensor(t):
            by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = broadcast(torch.cat([t.reshape(-1) for t in ts]), 0)
            for t, v in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(v.view(t.shape))
    return tree


def all_processes_mean(x):
    """Mean of a per-process scalar or array over the processes (host
    metrics): the identity with one process, else an all-gather and a mean
    over the processes, as numpy."""
    if world_size() == 1:
        return x
    t = torch.as_tensor(np.asarray(x, np.float64))
    if dist.get_backend() == "nccl":
        t = t.cuda()
    gathered = all_gather(t[None], 0)
    return np.mean(gathered.cpu().numpy(), axis=0)


# ---------------------------------------------------------------------------
# BatchNorm over the data axis
# ---------------------------------------------------------------------------

def batch_moments(x, group=None):
    """Per-channel mean and unbiased variance of an NCHW ``x`` over its batch
    and pixels, (1, C, 1, 1) each: over every rank's rows of ``group``
    (two passes of ``all_reduce_sum_autograd``), or this rank's alone."""
    dims = (0, 2, 3)
    if group_size(group) == 1:
        return x.mean(dim=dims, keepdim=True), x.var(dim=dims, keepdim=True, unbiased=True)
    count = torch.full((1,), x.numel() // x.shape[1], dtype=x.dtype, device=x.device)
    s = all_reduce_sum_autograd(torch.cat([x.sum(dims), count]), group)
    n = s[-1]
    mean = (s[:-1] / n).view(1, -1, 1, 1)
    ss = all_reduce_sum_autograd((x - mean).square().sum(dims), group)
    return mean, (ss / (n - 1)).view(1, -1, 1, 1)


class CrossRankBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training statistics are those of the global
    batch: the per-channel sums and the count, then the squared deviations,
    summed over the data axis's group (``all_reduce_sum_autograd``, so the
    gradient reaches every rank's rows).  As JAX's BatchNorm sees the whole
    sharded batch.  Running statistics as ``nn.BatchNorm2d`` keeps them
    (biased variance to normalize, unbiased into ``running_var``).  In eval
    mode, or with a group of one, it is ``nn.BatchNorm2d``."""

    group = None

    def forward(self, x):
        if not self.training or group_size(self.group) == 1:
            return super().forward(x)
        dims = (0, 2, 3)
        count = torch.full((1,), x.numel() // x.shape[1], dtype=x.dtype, device=x.device)
        s = all_reduce_sum_autograd(torch.cat([x.sum(dims), count]), self.group)
        n = s[-1]
        mean = s[:-1] / n
        d = x - mean.view(1, -1, 1, 1)
        var = all_reduce_sum_autograd(d.square().sum(dims), self.group) / n
        y = d * torch.rsqrt(var + self.eps).view(1, -1, 1, 1)
        if self.affine:
            y = y * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)
        if self.track_running_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1 - m).add_(var.detach() * (n / (n - 1)), alpha=m)
                self.num_batches_tracked.add_(1)
        return y


def sync_batchnorm_(module: nn.Module, mesh: Optional[Mesh] = None, axis: str = "data"):
    """Take every batch statistic in ``module`` over ``mesh``'s ``axis``
    group, in place: each ``nn.BatchNorm2d`` becomes a
    ``CrossRankBatchNorm2d`` (same parameters, buffers and state_dict keys),
    and a module with a ``batch_group`` attribute (the RCA-GAN's channel
    attention) gets the group.  A no-op with one rank on the axis."""
    if mesh is None or mesh.size(axis) == 1:
        return module
    for m in module.modules():
        if type(m) is nn.BatchNorm2d:
            m.__class__ = CrossRankBatchNorm2d
            m.group = mesh.group(axis)
        elif hasattr(m, "batch_group"):
            m.batch_group = mesh.group(axis)
    return module


class DataParallel:
    """Replicated parameters, the batch split over ``mesh``'s data axis: the
    step's gradients are averaged over the axis in one all-reduce (the
    trainers take them with ``torch.autograd.grad``, which DDP's hooks do
    not see), before the clip, which then sees the global gradient."""

    def __init__(self, params, mesh):
        self.leaves = list(params.values())
        self.group, self.mesh = mesh.group("data"), mesh

    def opt_params(self):
        return self.leaves

    def reduce(self, grads):
        return all_reduce_mean_flat(list(grads), self.group)

    def after_step(self):
        pass
