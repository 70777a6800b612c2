"""Functional RDUNet / RDUNetT forward with a choice of block engine.

Counterpart of ``vub_image_denoising_tpu/models/fused_apply.py``.  The
forward takes a model's state_dict (reference keys, or as grouped by
``prepare_fused_params``) and an NCHW input, and runs:

- the glue layers in plain PyTorch: the input and output blocks, the
  downsample as a VALID stride-2 conv, the upsample as a matmul conv-T
  followed by the split-concat conv;
- each of the 14 DenoisingBlocks on the chosen engine:
  ``"pallas"``  the hand-written block kernel (``ops/fused_block.py``) on the
                card, its plain version on the CPU;
  ``"xla"``     the eager block ``_dense_block_xla`` (cuDNN convs);
  ``"auto"``    ``"pallas"`` when the input holds at most 2**21 pixels
                (N*H*W), else ``"xla"``.

``trainable=True`` routes the kernel through ``fused_block_trainable``,
whose backward recomputes the eager block and differentiates it.  The
kernel's weight layout is built by the caller, once per set of parameter
values (``block_kernel_weights``), and passed as ``kernel_weights``;
without it each forward builds them once.  The kernel engine runs for every
width: the JAX package's TPU gate (``c % 128 == 0`` and weights <= 4 MB)
is not carried over.

Three switches of the JAX module, read once at import from the same
environment variables and off by default, change how the eager engine
computes (the same function, another summation order):

- ``VUB_PRECOMBINE_MIN_C=c``: eager blocks of width >= c run
  ``_dense_block_xla_precombined`` (weights regrouped by source tensor);
- ``VUB_BWD_PRECOMBINE=c``: eager blocks of width >= c run the standard
  forward with the precombined graph's backward
  (``_dense_block_precombined_bwd``);
- ``VUB_DOWN_MATMUL_BWD=1``: every engine's downsample runs the VALID
  stride-2 conv forward with the space-to-depth matmul backward
  (``_down_fast_bwd``).

As in the JAX package they act on the eager path only: the kernel
engine's blocks and the recompute in ``fused_block_trainable``'s backward
stay ``_dense_block_xla``.
"""

import os
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.fused_block import (
    fused_denoising_block,
    fused_denoising_block_packed,
    pack_block_params,
    pack_block_params_packed,
)
from ..ops.packing import pack2x2, unpack2x2

_DENSE_BLOCKS = [
    "block_0_0", "block_0_1", "block_1_0", "block_1_1", "block_2_0", "block_2_1",
    "block_3_0", "block_3_1", "block_2_2", "block_2_3", "block_1_2", "block_1_3",
    "block_0_2", "block_0_3",
]
# A DenoisingBlock's parameters, in the order fused_block_trainable takes them.
BLOCK_KEYS = tuple(f"conv_{i}.{p}" for i in range(4) for p in ("weight", "bias")) + tuple(
    f"actv_{i}.weight" for i in range(4))
# "auto" picks the kernel engine up to this many input pixels (N*H*W): the
# JAX package's TPU threshold, not yet re-measured on the card.
AUTO_MAX_PIXELS = 1 << 21
ENGINES = ("auto", "pallas", "xla")


def prepare_fused_params(variables):
    """Group a state_dict by module: {"block_0_0": {"conv_0.weight": ...}, ...}.

    The engine's parameter hook, like the JAX package's; a grouped dict is
    returned as it is."""
    if all(isinstance(v, dict) for v in variables.values()):
        return variables
    grouped: Dict[str, Dict[str, Any]] = {}
    for key, value in variables.items():
        module, _, name = key.partition(".")
        grouped.setdefault(module, {})[name] = value
    return grouped


def block_kernel_weights(variables, dtype):
    """Kernel 1's weight layout of each of the 14 DenoisingBlocks, in the
    compute ``dtype``: ``{block name: pack_block_params(...)}``, built on the
    parameters' device from their values now.  The owner builds it once per
    set of values (a loaded model once, a trainer once per optimizer step)
    and passes it to every forward until the values change.  None for
    parameters on the CPU, where the plain block reads them directly."""
    p = prepare_fused_params(variables)
    device = p[_DENSE_BLOCKS[0]]["conv_0.weight"].device
    if device.type == "cpu":
        return None
    return {name: pack_block_params(p[name], dtype, device) for name in _DENSE_BLOCKS}


def _prelu(x, alpha):
    return torch.clamp_min(x, 0) + alpha.to(x.dtype).view(1, -1, 1, 1) * torch.clamp_max(x, 0)


def _conv3x3(x, w, b):
    return F.conv2d(x, w.to(x.dtype), padding=1) + b.to(x.dtype).view(1, -1, 1, 1)


def _input_block(p, x):
    x = _prelu(_conv3x3(x, p["conv_1.weight"], p["conv_1.bias"]), p["actv_1.weight"])
    return _prelu(_conv3x3(x, p["conv_2.weight"], p["conv_2.bias"]), p["actv_2.weight"])


_output_block = _input_block  # conv3x3 + PReLU twice, with the same keys


def _down(p, x):
    y = F.conv2d(x, p["conv.weight"].to(x.dtype), stride=2)
    return _prelu(y + p["conv.bias"].to(x.dtype).view(1, -1, 1, 1), p["actv.weight"])


def _up(p, upsample, concat):
    """Conv-T (k2 s2) as one matmul, PReLU, then conv(cat[skip, y]) computed as
    conv_a(skip) + conv_b(y): the concat is never built."""
    n, cin, h, w = upsample.shape
    k = p["conv_t.weight"]  # (cin, cout, 2, 2)
    cout = k.shape[1]
    wk = k.permute(0, 2, 3, 1).reshape(cin, 4 * cout).to(upsample.dtype)
    y = upsample.permute(0, 2, 3, 1) @ wk  # (n, h, w, [kh, kw, cout])
    y = y.reshape(n, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, cout)
    y = y.permute(0, 3, 1, 2) + p["conv_t.bias"].to(y.dtype).view(1, -1, 1, 1)
    y = _prelu(y, p["actv_t.weight"])
    wc = p["conv.weight"].to(y.dtype)
    c_skip = concat.shape[1]
    out = F.conv2d(concat, wc[:, :c_skip], padding=1) + F.conv2d(y, wc[:, c_skip:], padding=1)
    return _prelu(out + p["conv.bias"].to(y.dtype).view(1, -1, 1, 1), p["actv.weight"])


def _dense_block_xla(params, x):
    """The eager DenoisingBlock (the math of ``nn.blocks.DenoisingBlock``)."""
    def conv(h, i):
        y = _conv3x3(h, params[f"conv_{i}.weight"], params[f"conv_{i}.bias"])
        return _prelu(y, params[f"actv_{i}.weight"])

    cat0 = torch.cat([x, conv(x, 0)], 1)
    cat1 = torch.cat([cat0, conv(cat0, 1)], 1)
    cat2 = torch.cat([cat1, conv(cat1, 2)], 1)
    return conv(cat2, 3) + x


def _dense_block_xla_precombined(params, x):
    """The eager DenoisingBlock with every weight split along its input
    channels and regrouped by SOURCE tensor: conv_i(cat(x, o_0..o_{i-1})) is
    the sum over sources of conv(source_j, W_i[:, source_j]), so the four
    (c->g, ..->g, ..->g, ..->c) convs become (c->3g+c, g->2g+c, g->g+c,
    g->c) convs at the same FLOPs, and no concat is built.  The same
    linear map as ``_dense_block_xla`` in another summation order."""
    c = x.shape[1]
    k = [params[f"conv_{i}.weight"].to(x.dtype) for i in range(4)]
    b = [params[f"conv_{i}.bias"].to(x.dtype).view(1, -1, 1, 1) for i in range(4)]
    al = [params[f"actv_{i}.weight"] for i in range(4)]
    g = k[0].shape[0]

    # weights regrouped by source tensor (OIHW: input channels on axis 1)
    w_x = torch.cat([k[0], k[1][:, :c], k[2][:, :c], k[3][:, :c]], 0)
    w_0 = torch.cat([k[1][:, c:], k[2][:, c:c + g], k[3][:, c:c + g]], 0)
    w_1 = torch.cat([k[2][:, c + g:], k[3][:, c + g:c + 2 * g]], 0)
    w_2 = k[3][:, c + 2 * g:]

    a = F.conv2d(x, w_x, padding=1)      # [g | g | g | c] contributions of x
    out0 = _prelu(a[:, :g] + b[0], al[0])
    bb = F.conv2d(out0, w_0, padding=1)  # [g | g | c] contributions of out0
    out1 = _prelu(a[:, g:2 * g] + bb[:, :g] + b[1], al[1])
    cc = F.conv2d(out1, w_1, padding=1)  # [g | c] contributions of out1
    out2 = _prelu(a[:, 2 * g:3 * g] + bb[:, g:2 * g] + cc[:, :g] + b[2], al[2])
    dd = F.conv2d(out2, w_2, padding=1)  # [c] contributions of out2
    out3 = _prelu(a[:, 3 * g:] + bb[:, 2 * g:] + cc[:, g:] + dd + b[3], al[3])
    return out3 + x


def _recompute_grads(fn, keys, saved, needs, g):
    """The gradients of ``fn(dict(zip(keys, params)), x)`` for ``saved`` =
    (x, *params), recomputed and differentiated against the cotangent
    ``g``; None where ``needs`` is False."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        y = fn(dict(zip(keys, leaves[1:])), leaves[0])
        grads = iter(torch.autograd.grad(y, [t for t in leaves if t.requires_grad], g))
    return [next(grads) if n else None for n in needs]


class _PrecombinedBwdBlock(torch.autograd.Function):
    """The standard eager block forward, the precombined graph's backward."""

    @staticmethod
    def forward(ctx, x, *params):
        ctx.save_for_backward(x, *params)
        return _dense_block_xla(dict(zip(BLOCK_KEYS, params)), x)

    @staticmethod
    def backward(ctx, g):
        return tuple(_recompute_grads(_dense_block_xla_precombined, BLOCK_KEYS,
                                      ctx.saved_tensors, ctx.needs_input_grad, g))


def _dense_block_precombined_bwd(params, x):
    """DenoisingBlock with the STANDARD forward and the precombined
    backward: both formulations compute the same function, so the VJP of
    the precombined graph gives the same gradients (up to reassociation)
    through wider weight-gradient convs and no concat splits."""
    return _PrecombinedBwdBlock.apply(x, *(params[k] for k in BLOCK_KEYS))


DOWN_KEYS = ("conv.weight", "conv.bias", "actv.weight")


def _down_s2d(p, x):
    """The k2 s2 downsample as space-to-depth + one matmul (the same math as
    ``_down``); its VJP is two matmuls and reshapes, no conv-transpose."""
    n, cin, h, w = x.shape
    k = p["conv.weight"]  # (cout, cin, 2, 2)
    cout = k.shape[0]
    xs = x.reshape(n, cin, h // 2, 2, w // 2, 2).permute(0, 2, 4, 3, 5, 1)
    xs = xs.reshape(n, h // 2, w // 2, 4 * cin)  # (kh, kw, cin) per output pixel
    wk = k.permute(2, 3, 1, 0).reshape(4 * cin, cout).to(x.dtype)
    y = (xs @ wk).permute(0, 3, 1, 2) + p["conv.bias"].to(x.dtype).view(1, -1, 1, 1)
    return _prelu(y, p["actv.weight"])


class _DownFastBwd(torch.autograd.Function):
    """The VALID stride-2 conv forward, the space-to-depth matmul backward."""

    @staticmethod
    def forward(ctx, x, *params):
        ctx.save_for_backward(x, *params)
        return _down(dict(zip(DOWN_KEYS, params)), x)

    @staticmethod
    def backward(ctx, g):
        return tuple(_recompute_grads(_down_s2d, DOWN_KEYS, ctx.saved_tensors,
                                      ctx.needs_input_grad, g))


def _down_fast_bwd(p, x):
    """Downsample: VALID stride-2 conv forward, matmul backward."""
    return _DownFastBwd.apply(x, *(p[k] for k in DOWN_KEYS))


# The JAX module's switches (off by default; measured negative on a TPU, see
# its notes), read once at import: eager blocks of width >= the first run
# precombined, of width >= the second with the precombined backward; the
# third gives every downsample the matmul backward.
_PRECOMBINE_MIN_CHANNELS = int(os.environ.get("VUB_PRECOMBINE_MIN_C", str(1 << 30)))
_BWD_PRECOMBINE_MIN_C = int(os.environ.get("VUB_BWD_PRECOMBINE", str(1 << 30)))
_DOWN_MATMUL_BWD = os.environ.get("VUB_DOWN_MATMUL_BWD", "0") == "1"


def _eager_block_for(c):
    """The eager block of width ``c`` under the switches."""
    if c >= _PRECOMBINE_MIN_CHANNELS:
        return _dense_block_xla_precombined
    if c >= _BWD_PRECOMBINE_MIN_C:
        return _dense_block_precombined_bwd
    return _dense_block_xla


def _fused_block_semantic(x, params, packed=False, kernel_weights=None):
    """One DenoisingBlock on unpacked x through kernel 1, or through kernel 2
    between ``pack2x2`` and ``unpack2x2``.  ``kernel_weights`` is the
    kernel's cached weight layout, or None."""
    if x.device.type == "cuda":
        x = x.contiguous(memory_format=torch.channels_last)
    if packed:
        pq = pack_block_params_packed(params)
        return unpack2x2(fused_denoising_block_packed(pack2x2(x), pq, kernel_weights))
    return fused_denoising_block(x, params, kernel_weights)


class _FusedBlock(torch.autograd.Function):
    """Kernel forward, eager-block backward (``jax.custom_vjp`` counterpart)."""

    @staticmethod
    def forward(ctx, x, packed, kernel_weights, *params):
        ctx.save_for_backward(x, *params)
        return _fused_block_semantic(x, dict(zip(BLOCK_KEYS, params)), packed, kernel_weights)

    @staticmethod
    def backward(ctx, g):
        needs = (ctx.needs_input_grad[0], *ctx.needs_input_grad[3:])
        out = _recompute_grads(_dense_block_xla, BLOCK_KEYS, ctx.saved_tensors, needs, g)
        return out[0], None, None, *out[1:]


def fused_block_trainable(x, params, packed=False, kernel_weights=None):
    """Differentiable fused DenoisingBlock: one kernel launch forward (kernel 1,
    or kernel 2 with ``packed=True``), and a backward that recomputes
    ``_dense_block_xla`` and differentiates it, launching no kernel.

    ``params`` maps ``BLOCK_KEYS`` to tensors; gradients flow to ``x`` and to
    each parameter that requires them (in bf16 compute, through the cast of
    the f32 parameters)."""
    return _FusedBlock.apply(x, packed, kernel_weights, *(params[k] for k in BLOCK_KEYS))


def pick_engine(engine, x):
    """The block engine for input ``x``: "auto" resolves by its pixel count."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (want one of {ENGINES})")
    if engine == "auto":
        n, _, h, w = x.shape
        return "pallas" if n * h * w <= AUTO_MAX_PIXELS else "xla"
    return engine


def _core(p, x, engine="auto", trainable=False, remat=False, kernel_weights=None):
    eng = pick_engine(engine, x)
    if eng != "xla" and kernel_weights is None:
        kernel_weights = block_kernel_weights(p, x.dtype)
    down = _down_fast_bwd if _DOWN_MATMUL_BWD else _down

    def block(name, h):
        if eng == "xla":
            fn = _eager_block_for(h.shape[1])
            if remat:
                return checkpoint(fn, p[name], h, use_reentrant=False)
            return fn(p[name], h)
        kw = kernel_weights[name] if kernel_weights is not None else None
        if trainable:
            return fused_block_trainable(h, p[name], kernel_weights=kw)
        return _fused_block_semantic(h, p[name], kernel_weights=kw)

    def dense_pair(name_a, name_b, h):
        return block(name_b, block(name_a, h))

    out0 = dense_pair("block_0_0", "block_0_1", _input_block(p["input_block"], x))
    out1 = dense_pair("block_1_0", "block_1_1", down(p["down_0"], out0))
    out2 = dense_pair("block_2_0", "block_2_1", down(p["down_1"], out1))
    out3 = dense_pair("block_3_0", "block_3_1", down(p["down_2"], out2))
    out4 = dense_pair("block_2_2", "block_2_3", _up(p["up_2"], out3, out2))
    out5 = dense_pair("block_1_2", "block_1_3", _up(p["up_1"], out4, out1))
    out6 = dense_pair("block_0_2", "block_0_3", _up(p["up_0"], out5, out0))
    return _output_block(p["output_block"], out6)


def _channels_last(x):
    return x.contiguous(memory_format=torch.channels_last) if x.device.type == "cuda" else x


def rdunet_apply_fused(variables, x, engine="auto", trainable=False, remat=False,
                       kernel_weights=None):
    """``RDUNet`` forward from its state_dict: ``core(x) + x`` for x (N, C, H, W).

    ``trainable=True`` makes the kernel engine differentiable (kernel
    forward, eager backward); ``remat=True`` recomputes the eager engine's
    blocks in the backward (``torch.utils.checkpoint``).  ``kernel_weights``
    is ``block_kernel_weights(variables, x.dtype)`` of these values, or None
    to build them in this forward."""
    x = _channels_last(x)
    return _core(prepare_fused_params(variables), x, engine, trainable, remat,
                 kernel_weights) + x


def rdunet_t_apply_fused(variables, x, t, engine="auto", trainable=False, remat=False,
                         kernel_weights=None):
    """``RDUNetT`` forward from its state_dict: the timestep ``t`` (a scalar,
    an (N,) vector or an (N, 1, H, W) plane) is broadcast to one plane and
    concatenated as the last input channel; the residual adds x."""
    x = _channels_last(x)
    xt = torch.cat([x, t_plane(t, x)], 1)
    return _core(prepare_fused_params(variables), xt, engine, trainable, remat,
                 kernel_weights) + x


def t_plane(t, x):
    """The timestep as one (N, 1, H, W) plane in x's dtype and device."""
    n, _, h, w = x.shape
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    if t.dim() <= 1:
        t = t.reshape(-1, 1, 1, 1)
    return t.expand(n, 1, h, w)
