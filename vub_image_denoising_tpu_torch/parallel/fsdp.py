"""FSDP-style (ZeRO) sharding of the parameters and Adam moments over the data axis.

Counterpart of ``vub_image_denoising_tpu/parallel/fsdp.py``.  The leaf rule
is JAX's, a pure function of the leaf's JAX shape (conv kernels HWIO,
transpose convs (kh, kw, ci, co), dense (in, out)): split the largest dim
divisible by the axis size, the first such dim on a tie; leave small or
indivisible leaves (biases, PReLU alphas) replicated.  ``jax_layout`` maps a
state_dict leaf to that shape, so the port splits the same dimension.

JAX lets GSPMD insert the all-gathers and reduce-scatters.  Here
``FullyShardedDataParallel`` writes them out around the trainers' step:

- each rank's optimizer holds only its shard of each sharded parameter, and
  Adam keeps moments only for that shard, from init on (every rank inits the
  whole model from the seed and keeps its slice);
- the model's parameters are the compute copies: after each update the
  shards are all-gathered into them, ready for the next forward;
- the step's gradients (each rank's rows) are reduce-scattered to the shards
  and averaged (gloo: all-reduced, and the shard kept), replicated leaves
  all-reduced;
- the global-norm clip takes its norm over every rank's shards.

FSDP2's ``fully_shard`` is not used: it reduces gradients from hooks that
``.backward()`` fires as it fills ``.grad``, and the trainers take their
gradients with ``torch.autograd.grad`` (``train/supervised.py``
``accumulate_and_apply``), which fills no ``.grad``.
"""

from typing import Optional

import numpy as np
import torch
from torch import nn

from .mesh import all_gather_many, all_reduce, all_reduce_mean_flat, reduce_scatter


def _is_transpose_conv(key: str) -> bool:
    return any(n == "conv_t" or n.startswith("upconv") for n in key.split("."))


def jax_layout(key: str, shape):
    """(the JAX package's shape of state_dict leaf ``key``, and for each of
    its dims the torch dim it is): OIHW convs are HWIO there, transpose convs
    (ci, co, kh, kw) are (kh, kw, ci, co), dense (out, in) is (in, out)."""
    nd = len(shape)
    if nd == 4:
        perm = (2, 3, 0, 1) if _is_transpose_conv(key) else (2, 3, 1, 0)
    elif nd == 2:
        perm = (1, 0)
    else:
        perm = tuple(range(nd))
    return tuple(int(shape[d]) for d in perm), perm


def fsdp_spec_for_shape(shape, n_shards: int, min_shard_elems: int = 1024):
    """JAX's rule on a JAX shape, as a PartitionSpec's tuple: ``()`` for a
    replicated leaf, else ``"data"`` at the largest dim divisible by
    ``n_shards`` (the first on a tie) and None elsewhere."""
    if n_shards <= 1 or int(np.prod(shape, dtype=np.int64)) < min_shard_elems:
        return ()
    divisible = [d for d, s in enumerate(shape) if s % n_shards == 0 and s > 0]
    if not divisible:
        return ()
    best = max(divisible, key=lambda d: shape[d])
    spec = [None] * len(shape)
    spec[best] = "data"
    return tuple(spec)


def torch_dim(key: str, shape, spec):
    """The torch dim of leaf ``key`` that ``spec`` (over its JAX shape) splits,
    or None."""
    _, perm = jax_layout(key, shape)
    for jdim, axis in enumerate(spec):
        if axis is not None:
            return perm[jdim]
    return None


def fsdp_shardings(params, n_shards: int, min_shard_elems: int = 1024):
    """{state_dict key: the torch dim FSDP splits, or None}."""
    return {k: torch_dim(k, p.shape, fsdp_spec_for_shape(
        jax_layout(k, p.shape)[0], n_shards, min_shard_elems)) for k, p in params.items()}


class ShardedParams:
    """The model's parameters (``params``, the compute copies) and this rank's
    shards of them along ``dims`` over ``mesh``'s ``axis`` (``shards``: a
    new leaf per split parameter, the parameter itself where it is
    replicated).  Base of the FSDP and tensor-parallel states."""

    def __init__(self, params, dims, mesh, axis):
        self.full = dict(params)
        self.dims = dict(dims)
        self.mesh, self.axis = mesh, axis
        self.group, n, i = mesh.group(axis), mesh.size(axis), mesh.index(axis)
        self.shards = {}
        for k, p in self.full.items():
            d = self.dims[k]
            self.shards[k] = p if d is None else nn.Parameter(
                p.detach().chunk(n, d)[i].clone())

    def opt_params(self):
        """The optimizer's leaves, in ``params`` order."""
        return list(self.shards.values())

    def sq_norm(self, grads):
        """Squared global norm of gradients in ``opt_params`` layout: the split
        leaves' squares summed over the axis, the replicated ones once."""
        split = [g for g, d in zip(grads, self.dims.values()) if d is not None]
        whole = [g for g, d in zip(grads, self.dims.values()) if d is None]

        def sq(gs):
            return sum((g.float().square().sum() for g in gs), torch.zeros(()))
        total = all_reduce(sq(split).to(grads[0].device), self.group) if split else 0.0
        return total + (sq(whole).to(grads[0].device) if whole else 0.0)

    def after_step(self):
        """All-gather the updated shards into the model's parameters (one
        collective)."""
        keys = [k for k, d in self.dims.items() if d is not None]
        with torch.no_grad():
            gathered = all_gather_many([self.shards[k].detach() for k in keys],
                                       [self.dims[k] for k in keys], self.group)
            for k, v in zip(keys, gathered):
                self.full[k].copy_(v)

    def reshard(self):
        """Cut the shards again from the model's parameters (after a load)."""
        n, i = self.mesh.size(self.axis), self.mesh.index(self.axis)
        with torch.no_grad():
            for k, d in self.dims.items():
                if d is not None:
                    self.shards[k].copy_(self.full[k].chunk(n, d)[i])

    def full_optimizer_state(self, optimizer):
        """``optimizer.state_dict()`` with each split moment all-gathered to
        its parameter's shape: what a replicated optimizer over the model's
        parameters holds."""
        sd = optimizer.state_dict()
        dims, shards = list(self.dims.values()), self.opt_params()
        state = {idx: dict(entry) for idx, entry in sd["state"].items()}
        split = [(idx, name) for idx, entry in state.items() for name, v in entry.items()
                 if dims[idx] is not None and torch.is_tensor(v) and v.shape == shards[idx].shape]
        gathered = all_gather_many([state[i][n] for i, n in split], [dims[i] for i, _ in split],
                                   self.group)
        for (idx, name), v in zip(split, gathered):
            state[idx][name] = v
        return {**sd, "state": state}

    def shard_optimizer_state(self, sd):
        """The inverse of ``full_optimizer_state``: this rank's slice of each
        full-shape moment of a replicated optimizer's ``state_dict``."""
        dims, n, i = list(self.dims.values()), self.mesh.size(self.axis), self.mesh.index(self.axis)
        full = list(self.full.values())
        state = {}
        for idx, entry in sd["state"].items():
            d = dims[idx]
            state[idx] = {name: (v.chunk(n, d)[i].clone()
                                 if d is not None and torch.is_tensor(v)
                                 and v.shape == full[idx].shape else v)
                          for name, v in entry.items()}
        return {**sd, "state": state}


class FullyShardedDataParallel(ShardedParams):
    """FSDP over ``mesh``'s ``"data"`` axis (module docstring).  The step
    differentiates the model's parameters; ``reduce`` turns each rank's
    gradients into the averaged gradients of its shards."""

    def __init__(self, params, mesh, min_shard_elems: int = 1024):
        dims = fsdp_shardings(params, mesh.size("data"), min_shard_elems)
        super().__init__(params, dims, mesh, "data")

    def reduce(self, grads):
        """nccl: each split leaf's gradient reduce-scattered, the replicated
        ones all-reduced in one collective; gloo (no reduce-scatter): one
        all-reduce of them all, each split leaf then cut to this rank's
        shard.  Averaged over the ranks."""
        n = self.mesh.size("data")
        grads, dims = list(grads), list(self.dims.values())
        if n == 1:
            return grads
        i = self.mesh.index("data")
        if torch.distributed.get_backend(self.group) == "gloo":
            return [g if d is None else g.chunk(n, d)[i].contiguous()
                    for g, d in zip(all_reduce_mean_flat(grads, self.group), dims)]
        whole = iter(all_reduce_mean_flat([g for g, d in zip(grads, dims) if d is None],
                                          self.group))
        return [next(whole) if d is None else reduce_scatter(g, d, self.group) / n
                for g, d in zip(grads, dims)]


def sharded_fraction(state) -> float:
    """Diagnostic: the fraction of the parameters' elements that are split
    over more than one rank (0.0: replicated), of a ``TrainState`` or a
    ``ShardedParams``."""
    sharded = getattr(state, "parallel", state)
    if not isinstance(sharded, ShardedParams) or sharded.mesh.size(sharded.axis) == 1:
        return 0.0
    total = sum(p.numel() for p in sharded.full.values())
    split = sum(p.numel() for k, p in sharded.full.items() if sharded.dims[k] is not None)
    return split / total if total else 0.0


def put_fsdp(params, mesh, min_shard_elems: int = 1024) -> Optional[FullyShardedDataParallel]:
    """FSDP state of ``params`` (a model's named parameters) over ``mesh``."""
    return FullyShardedDataParallel(dict(params), mesh, min_shard_elems)


init_fsdp_state = put_fsdp  # every rank inits from the seed; the shards are cut from it
