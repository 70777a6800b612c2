"""Channel tensor parallelism over a ``model`` axis.

Counterpart of ``vub_image_denoising_tpu/parallel/tp.py``.  The leaf rule is
JAX's, on the JAX shape (``fsdp.jax_layout``): shard the last dim (output
channels) when it divides by the axis size, else the second-to-last (input
channels), else replicate; rank-1 and small leaves stay replicated.  Each
rank stores only its shards of the weights (and the optimizer its moments).

JAX gives GSPMD the sharded weights and lets it split every op.  Here the
RDUNet / RDUNetT forward is written out over the shards (``TensorParallel``,
the Megatron recipe on convs):

- a glue conv (input, down, up, output blocks) whose weight is split on its
  output channels computes its slice of them and all-gathers it; one split on
  its input channels takes its slice of the input and all-reduces the
  partial sums; bias and PReLU run whole after the collective;
- a DenoisingBlock's weights are all-gathered and the whole block runs on
  every rank, on the card through kernel 1, as a ``pallas_call`` stays whole
  under GSPMD.  A per-level split of the block over its channels is not done.

The collectives are autograd functions (``_CopyIn``: identity forward,
all-reduce backward; ``_Gather``: all-gather forward, own slice backward;
``_ReduceOut``: all-reduce forward, identity backward), so
``--param-sharding tp`` trains through the same forward.  The batch is
replicated over the model axis.
"""

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.fused_apply import (BLOCK_KEYS, _DENSE_BLOCKS, _prelu, fused_block_trainable,
                                  t_plane)
from ..ops.fused_block import fused_denoising_block, pack_block_params
from .fsdp import ShardedParams, jax_layout, torch_dim
from .mesh import Mesh, all_gather, all_reduce, gather_many_autograd, group_size, world_size


def tp_spec_for_shape(shape, n_shards: int, axis: str = "model", min_shard_elems: int = 1024):
    """JAX's rule on a JAX shape, as a PartitionSpec's tuple (``()``:
    replicated)."""
    if n_shards <= 1 or len(shape) < 2:
        return ()
    if int(np.prod(shape, dtype=np.int64)) < min_shard_elems:
        return ()
    spec = [None] * len(shape)
    if shape[-1] % n_shards == 0 and shape[-1] > 0:
        spec[-1] = axis
    elif shape[-2] % n_shards == 0 and shape[-2] > 0:
        spec[-2] = axis
    else:
        return ()
    return tuple(spec)


def tp_shardings(params, n_shards: int, min_shard_elems: int = 1024):
    """{state_dict key: the torch dim tensor parallelism splits, or None}."""
    return {k: torch_dim(k, p.shape, tp_spec_for_shape(
        jax_layout(k, p.shape)[0], n_shards, "model", min_shard_elems))
        for k, p in params.items()}


def make_tp_mesh(n_data: Optional[int] = None, device=None) -> Mesh:
    """A ("data", "model") mesh: ``n_data``-way data parallel (default 1,
    pure TP), model parallel over the other ranks."""
    n = world_size()
    n_data = 1 if n_data is None else n_data
    if n % n_data:
        raise ValueError(f"{n} ranks not divisible by n_data={n_data}")
    return Mesh((n_data, n // n_data), ("data", "model"), device)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        n = group_size(ctx.group)
        return g.chunk(n, ctx.dim)[torch.distributed.get_rank(ctx.group)].contiguous(), None, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class TensorParallel(ShardedParams):
    """Tensor parallelism of an ``RDUNet`` / ``RDUNetT`` (``model``) over
    ``mesh``'s ``"model"`` axis (module docstring).  ``shards`` are the
    leaves the forward and the optimizer take; ``apply(params, x, t)`` is
    the forward on them; ``after_step`` gathers them into ``model``."""

    def __init__(self, model, mesh, min_shard_elems: int = 1024):
        params = dict(model.named_parameters())
        super().__init__(params, tp_shardings(params, mesh.size("model"), min_shard_elems),
                         mesh, "model")
        self.n, self.i = mesh.size("model"), mesh.index("model")

    def reduce(self, grads):
        """The step's gradients of the shards, averaged over the data axis
        (the model axis computes one batch; its gradients need no reduce)."""
        n = self.mesh.size("data")
        if n == 1:
            return list(grads)
        return [all_reduce(g, self.mesh.group("data")) / n for g in grads]

    def _conv(self, x, p, key, bias_key, transpose=False, **kw):
        """One glue conv on the (replicated) input ``x`` with the weight
        ``p[key]`` split as ``dims`` says, then its bias: a whole output."""
        w = p[key].to(x.dtype)
        d = self.dims[key] if self.n > 1 else None
        conv = F.conv_transpose2d if transpose else F.conv2d
        out_dim = 1 if transpose else 0
        if d is None:
            y = conv(x, w, **kw)
        elif d == out_dim:
            y = _Gather.apply(conv(_CopyIn.apply(x, self.group), w, **kw), 1, self.group)
        else:
            xs = _CopyIn.apply(x, self.group).chunk(self.n, 1)[self.i]
            y = _ReduceOut.apply(conv(xs, w, **kw), self.group)
        return y + p[bias_key].to(y.dtype).view(1, -1, 1, 1)

    def _glue(self, p, prefix, x, conv, actv, **kw):
        return _prelu(self._conv(x, p, f"{prefix}.{conv}.weight", f"{prefix}.{conv}.bias", **kw),
                      p[f"{prefix}.{actv}.weight"])

    def _blocks(self, params):
        """Every DenoisingBlock's whole params from ``params``: the split
        leaves all-gathered in one differentiable collective."""
        keys = [f"{name}.{k}" for name in _DENSE_BLOCKS for k in BLOCK_KEYS]
        split = [k for k in keys if self.dims[k] is not None and self.n > 1]
        full = dict(zip(split, gather_many_autograd([params[k] for k in split],
                                                    [self.dims[k] for k in split], self.group)))
        return {name: {k: full.get(f"{name}.{k}", params[f"{name}.{k}"]) for k in BLOCK_KEYS}
                for name in _DENSE_BLOCKS}

    def block_cache(self, dtype):
        """Every DenoisingBlock's gathered params and, on the card, their
        kernel weights in ``dtype``: gathered once, for inference (the
        weights do not change between forwards)."""
        with torch.no_grad():
            cache = {}
            for name, full in self._blocks(self.shards).items():
                dev = full["conv_0.weight"].device
                cache[name] = (full, None if dev.type == "cpu"
                               else pack_block_params(full, dtype, dev))
        return cache

    def apply(self, params, x, t=None, cache=None):
        """The forward on the shards ``params`` (this object's ``shards``, or
        the trainer's view of them): ``RDUNet`` when ``t`` is None, else
        ``RDUNetT`` at the normalized timestep ``t``.  Differentiable;
        ``cache`` is ``block_cache``'s, for inference."""
        if x.device.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        h0 = x if t is None else torch.cat([x, t_plane(t, x)], 1)
        blocks = None if cache is not None else self._blocks(params)

        def block(name, h):
            if cache is not None:
                full, kw = cache[name]
                return fused_denoising_block(h.contiguous(memory_format=torch.channels_last)
                                             if h.device.type == "cuda" else h, full, kw)
            full = blocks[name]
            kw = None
            if h.device.type == "cuda":
                h = h.contiguous(memory_format=torch.channels_last)
                kw = pack_block_params(full, h.dtype, h.device)
            if torch.is_grad_enabled():
                return fused_block_trainable(h, full, kernel_weights=kw)
            return fused_denoising_block(h, full, kw)

        def pair(scale, first, h):
            return block(f"block_{scale}_{first + 1}", block(f"block_{scale}_{first}", h))

        def inout(prefix, h):
            h = self._glue(params, prefix, h, "conv_1", "actv_1", padding=1)
            return self._glue(params, prefix, h, "conv_2", "actv_2", padding=1)

        def down(prefix, h):
            return self._glue(params, prefix, h, "conv", "actv", stride=2)

        def up(prefix, h, skip):
            y = self._glue(params, prefix, h, "conv_t", "actv_t", transpose=True, stride=2)
            return self._glue(params, prefix, torch.cat([skip, y], 1), "conv", "actv", padding=1)

        out0 = pair(0, 0, inout("input_block", h0))
        out1 = pair(1, 0, down("down_0", out0))
        out2 = pair(2, 0, down("down_1", out1))
        out3 = pair(3, 0, down("down_2", out2))
        out4 = pair(2, 2, up("up_2", out3, out2))
        out5 = pair(1, 2, up("up_1", out4, out1))
        out6 = pair(0, 2, up("up_0", out5, out0))
        return inout("output_block", out6) + x


def put_tp(model, mesh, min_shard_elems: int = 1024) -> TensorParallel:
    """Tensor-parallel state of ``model`` over ``mesh``'s model axis."""
    return TensorParallel(model, mesh, min_shard_elems)


init_tp_state = put_tp  # every rank inits from the seed; the shards are cut from it

