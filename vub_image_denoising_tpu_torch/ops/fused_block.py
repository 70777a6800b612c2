"""The whole DenoisingBlock as one Hopper kernel, with its plain PyTorch version.

Replaces the Pallas TPU kernel ``fused_denoising_block``
(``vub_image_denoising_tpu/ops/fused_block.py:193``).  What it computes, with
every conv a 3x3 SAME conv with bias:

    o0 = PReLU(conv0(x))
    o1 = PReLU(conv1([x, o0]))
    o2 = PReLU(conv2([x, o0, o1]))
    y  = PReLU(conv3([x, o0, o1, o2])) + x

Rounding sits where the TPU kernel puts it: f32 accumulation, bias added in
f32, one cast to the compute dtype (x's dtype, f32 or bf16), PReLU in the
compute dtype, o0..o2 kept in it, residual added in it.  Conv weights are cast
to the compute dtype, bias and alpha stay f32 until used.

Two tensor-core kernels compute it; the choice between them is static
(``block_variant``):

- f32 and bf16 with c in ``TC_WIDTHS[dtype]`` (RDUNet-32's 32, 64, 128, 256;
  the search's 16; in bf16 also RDUNet(152)'s 152) launch
  ``csrc/fused_block_tc.cu``: an implicit GEMM per level on the tensor cores,
  operands staged with ``cp.async``, with a grid-aware tile
  (``pick_tile_tc``); inner channels that do not fill whole mma steps are
  zero-padded inside the kernel (``tc_inner_p``).  bf16 runs
  ``mma.sync`` bf16 -> f32; f32 runs
  error-compensated TF32 (3xTF32: each operand split into two TF32 values,
  three products per pair), which keeps exact-f32 accuracy, where one TF32
  product would not;
- f32 and bf16 at every other width launch the wide form: every c > 256
  (512, 1024: RDUNet-64's and RDUNet-128's; 304, 384, 608, 1216, ...: the
  other bases'), and below 256 the search's 48, 96, 192, f32 152, and the
  other bases' widths (40, 80, 160 with 16-byte channel runs; 25, 50, ...
  without, on its element-wise loads), where it was measured faster than
  the fused body or the CUDA-core kernel.  The wide form is
  ``csrc/fused_block_wide_tc.cu``: the same tensor-core arithmetic as four
  launches of one implicit-GEMM conv (an 8 x 16 pixel tile by a chunk of
  ``WIDE_N`` output channels, the last chunk and the last K slab partial
  where c is no multiple of them, K streamed in slabs), with o0..o2 in a device
  workspace (``wide_workspace_shape``) instead of shared memory, so its
  shared memory (``wide_smem_bytes``) does not grow with c.  Counted as a
  tensor-core launch, and in ``.wide_launches``.

The rule has no option and no fallback: a dtype and width decide the kernel.
The CUDA-core kernel of the first port, ``csrc/fused_block.cu`` (tile
``pick_tile``), takes no width any more; ``chip_smoke.py`` and the card
tests launch it directly (``_library``) to time and check it beside the
kernels that replaced it.

The fused body and the CUDA-core kernel give each thread block one (image,
th x tw output tile) and keep o0..o2 in shared memory over a halo pyramid of
th+6 -> th+4 -> th+2 -> th rows; o0..o2 never reach device memory.  A build or launch error raises; nothing
falls back.  Bound on an H100 SXM: 85.5*c^2*H*W*N FLOP per launch
(5.74 GFLOP per 256^2 image per block at c = 32; at batch 8 about 46 us at the
989 TFLOP/s bf16 dense peak, or 278 us for f32's three TF32 products at the
494.7 TFLOP/s TF32 peak, against about 20 us / 40 us for the bf16 / f32 bytes
of x and y at 3.35 TB/s), so it is compute-bound.

Tensors are logically NCHW, as everywhere in PyTorch, and the kernel takes
them in NHWC memory (``torch.channels_last``).  The wrapper runs the plain
version only for a tensor on the CPU; for a CUDA tensor it launches the kernel
or raises.  The launch is the operator ``vub_torch::fused_denoising_block``
(``fused_denoising_block_op``), so ``torch.export`` keeps each block as one
node that launches the kernel when the exported program runs
(``eval/export.py``).

``fused_denoising_block_packed`` is the same block on the 2x2 even-packed
layout of ``ops/packing.py`` (kernel 2), by the same static rule: at c in
``TC_WIDTHS[dtype]`` the same tensor-core body with the packed pixel address
(``csrc/fused_block_packed_tc.cu``, from ``csrc/fused_block_tc.cuh``, as
kernel 1's ``csrc/fused_block_tc.cu`` is), elsewhere the wide form with the
packed pixel address; see its docstring.
"""

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .cuda_build import load_library
from .packing import pack_conv3x3_weights, pack_vec, packed_taps_conv, reshift2d

# The CUDA-core kernel (csrc/fused_block.cu, launched directly only).
# Candidate output tiles (rows, cols), largest first.  The first that fits two
# blocks on one SM (2 x 113 KB of its 228 KB) is taken, else the first that fits
# one block's 227 KB.
TILES = ((16, 16), (16, 8), (8, 8), (8, 4), (4, 4))
_SMEM_TWO_PER_SM = 113 * 1024
_SMEM_MAX = 232448


def smem_bytes(inner: int, th: int, tw: int, itemsize: int) -> int:
    """Shared memory for o0, o1, o2 of one (th x tw) tile."""
    positions = (th + 6) * (tw + 6) + (th + 4) * (tw + 4) + (th + 2) * (tw + 2)
    return positions * inner * itemsize


def pick_tile(inner: int, itemsize: int):
    for limit in (_SMEM_TWO_PER_SM, _SMEM_MAX):
        for th, tw in TILES:
            if smem_bytes(inner, th, tw, itemsize) <= limit:
                return th, tw
    raise ValueError(f"no tile fits {inner} inner channels in shared memory")


# The tensor-core kernel (csrc/fused_block_tc.cu).  For element size e its
# shared memory holds o0..o2 (a position's ``tc_inner_p`` channels, padded by
# 16 bytes), x in slabs of 64 bytes of channels over the (th+8) x (tw+8)
# region (two buffers when c spans more than one slab), and two weight stages
# of 32 K rows (3 taps when N <= 64, else 1) of N + 8 columns (N + 16 when N
# is an odd number of 8-column tiles), N a level's ``tc_np`` outputs.
#
# TC_WIDTHS: the widths each dtype runs on it (its FB_TC_CASES): RDUNet-32's,
# and below 256 those at which chip_smoke.py's phases 16-17 measured it
# faster than the wide form on an H100 at the search's and RDUNet(152)'s
# shapes: c = 16 in both dtypes (8 x 16 x 256^2: f32 0.95 ms against 1.73,
# bf16 0.33 against 0.42) and 152 in bf16 (1 x 152 x 128^2: 0.70 against
# 0.75).  At c = 48, 96, 192 in both dtypes and at 152 in f32 the wide form
# was 1.7-5x faster: there this kernel fits one thread block per SM (8x8
# tiles in f32, 4x4 at f32 192) and recomputes 1.24-2.29x the work over its
# halo, where the wide form fits two and recomputes nothing; so they take
# the wide form (block_variant), as every width outside TC_WIDTHS does.
TC_WIDTHS = {torch.bfloat16: (16, 32, 64, 128, 152, 256),
             torch.float32: (16, 32, 64, 128, 256)}
TC_TILES = ((16, 16), (8, 8), (4, 4))


def tc_inner_p(c: int, itemsize: int) -> int:
    """The inner channels the tensor-core kernel keeps for o0..o2: c/2
    rounded up to one mma k step of 32 bytes (16 bf16, 8 f32).  The padded
    channels hold zeros and meet zero weight rows, so every sum is the
    unpadded block's; mirrors ``tc_inner_p`` in ``csrc/fused_block_tc.cuh``."""
    k = 32 // itemsize
    return -(-(c // 2) // k) * k


def tc_np(c: int, itemsize: int, level: int) -> int:
    """Outputs level ``level`` of the tensor-core kernel computes:
    ``tc_inner_p`` at levels 0-2, c rounded up to 8 at level 3."""
    return tc_inner_p(c, itemsize) if level < 3 else -(-c // 8) * 8


def tc_smem_bytes(c: int, th: int, tw: int, itemsize: int) -> int:
    """Shared memory of the tensor-core kernel for one (th x tw) tile of
    elements of ``itemsize`` bytes (2: bf16, 4: f32); mirrors
    ``tc_smem_bytes`` in ``csrc/fused_block_tc.cuh``."""
    positions = (th + 6) * (tw + 6) + (th + 4) * (tw + 4) + (th + 2) * (tw + 2)
    x_bufs = 2 if c * itemsize > 64 else 1

    def stage(n):
        return (3 if n <= 64 else 1) * 32 * (n + (16 if n % 16 else 8)) * itemsize

    return (positions * (tc_inner_p(c, itemsize) * itemsize + 16)
            + x_bufs * (th + 8) * (tw + 8) * 80
            + 2 * max(stage(tc_np(c, itemsize, 0)), stage(tc_np(c, itemsize, 3))))


def tc_tiles(c: int, itemsize: int):
    """The tiles the tensor-core kernel is built for at width ``c`` and
    element size ``itemsize``."""
    return [t for t in TC_TILES if tc_smem_bytes(c, *t, itemsize) <= _SMEM_MAX]


def tile_macs(c: int, th: int, tw: int) -> int:
    """Multiply-adds one thread block executes, halo levels included."""
    inner = c // 2
    return sum(9 * (c + i * inner) * (inner if i < 3 else c)
               * (th + 6 - 2 * i) * (tw + 6 - 2 * i) for i in range(4))


def pick_tile_tc(n: int, c: int, h: int, w: int, sms: int, itemsize: int):
    """The tensor-core kernel's tile for an (n, c, h, w) input of elements
    of ``itemsize`` bytes on a card with ``sms`` streaming multiprocessors
    (``sm_count``).

    Weighs waves over the SMs against halo recompute: a tile whose
    blocks fit ``per_sm`` to an SM (1 or 2, by shared memory) costs
    ceil(blocks / (sms * per_sm)) waves, each as long as ``per_sm`` blocks'
    multiply-adds run back to back on one SM (fewer when one wave does not
    fill every SM twice).  The cheapest tile wins; ties go to the larger."""
    best, best_cost = None, None
    for th, tw in tc_tiles(c, itemsize):
        blocks = n * -(-h // th) * -(-w // tw)
        per_sm = 2 if tc_smem_bytes(c, th, tw, itemsize) <= _SMEM_TWO_PER_SM else 1
        waves = -(-blocks // (sms * per_sm))
        cost = waves * min(per_sm, -(-blocks // sms)) * tile_macs(c, th, tw)
        if best_cost is None or cost < best_cost:
            best, best_cost = (th, tw), cost
    return best


def sm_count(device) -> int:
    """Streaming multiprocessors of the CUDA device ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# The wide form (csrc/fused_block_wide_tc.cu): an (8 x 16)-pixel tile by
# WIDE_N output channels per thread block; its shared memory holds two
# buffers of (one 64-byte channel slab over the (8+2) x (16+2) halo region,
# rows padded to 80 bytes) and (the nine taps of that slab's 64 / e weight
# rows, WIDE_N + 8 columns of e bytes).
WIDE_TILE = (8, 16)
WIDE_N = 64


def wide_smem_bytes(itemsize: int) -> int:
    """Shared memory of the wide form for elements of ``itemsize`` bytes;
    mirrors ``kWideSmem`` in ``csrc/fused_block_wide_tc.cu``."""
    th, tw = WIDE_TILE
    return 2 * ((th + 2) * (tw + 2) * 80 + 9 * (64 // itemsize) * (WIDE_N + 8) * itemsize)


def wide_workspace_shape(n: int, c: int, h: int, w: int):
    """The wide form's workspace for an (n, c, h, w) image: o0..o2, NHWC."""
    return (n, h, w, 3 * (c // 2))


def block_variant(dtype, c: int) -> str:
    """Which kernel a CUDA input of this dtype (f32 or bf16) and width
    launches: ``"tc"`` (the fused tensor-core body, at c in
    TC_WIDTHS[dtype]) or ``"tc_wide"`` (the wide form on the tensor cores,
    at every other width; its element-wise loads where c or c/2 is no
    multiple of 16 bytes, measured faster than the CUDA-core kernel at base
    25's 25 and 50 in both dtypes)."""
    return "tc" if c in TC_WIDTHS.get(dtype, ()) else "tc_wide"


def block_tile(dtype, n: int, c: int, h: int, w: int, sms: int):
    """(variant, th, tw, shared-memory bytes) of a launch at this input on a
    card with ``sms`` SMs."""
    variant = block_variant(dtype, c)
    if variant == "tc":
        th, tw = pick_tile_tc(n, c, h, w, sms, dtype.itemsize)
        return "tc", th, tw, tc_smem_bytes(c, th, tw, dtype.itemsize)
    return ("tc_wide", *WIDE_TILE, wide_smem_bytes(dtype.itemsize))


def block_weight_count(c: int, inner: int) -> int:
    """Conv weights of one DenoisingBlock: conv_i is 3x3, (c + i*inner) -> inner
    (conv_3: -> c).  Also its multiply-adds per output position."""
    return 9 * sum((c + i * inner) * (inner if i < 3 else c) for i in range(4))


def block_flops(n: int, c: int, h: int, w: int) -> int:
    """Multiply-adds x2 of one DenoisingBlock (cin = cout = c, inner = c/2)."""
    return 2 * block_weight_count(c, c // 2) * n * h * w


def fused_denoising_block_plain(x, params):
    """The block in plain PyTorch ops, with the kernel's casts.

    ``params`` maps the block's state_dict keys (``conv_i.weight`` OIHW,
    ``conv_i.bias``, ``actv_i.weight``) to tensors."""
    dtype = x.dtype

    def level(parts, i):
        inp = torch.cat(parts, 1) if len(parts) > 1 else parts[0]
        wgt = params[f"conv_{i}.weight"].to(dtype).float()
        y = F.conv2d(inp.float(), wgt, padding=1)
        y = (y + params[f"conv_{i}.bias"].float().view(1, -1, 1, 1)).to(dtype)
        alpha = params[f"actv_{i}.weight"].to(dtype).view(1, -1, 1, 1)
        return torch.clamp_min(y, 0) + alpha * torch.clamp_max(y, 0)

    o0 = level([x], 0)
    o1 = level([x, o0], 1)
    o2 = level([x, o0, o1], 2)
    return level([x, o0, o1, o2], 3) + x


def pack_block_params(params, dtype, device):
    """Kernel layout of the block's weights: (packed conv weights, bias+alpha).

    Each conv weight OIHW (N, K, 3, 3) becomes tap-major (9, K, N) in ``dtype``;
    the four are concatenated flat.  Biases then alphas, f32, concatenated."""
    ws = [params[f"conv_{i}.weight"].detach().permute(2, 3, 1, 0).reshape(-1) for i in range(4)]
    ba = [params[f"conv_{i}.bias"].detach() for i in range(4)]
    ba += [params[f"actv_{i}.weight"].detach() for i in range(4)]
    w = torch.cat(ws).to(device=device, dtype=dtype).contiguous()
    return w, torch.cat(ba).to(device=device, dtype=torch.float32).contiguous()


def unpack_block_params(w, ba, c: int, inner: int):
    """The block's params (state_dict keys) from ``pack_block_params``'s
    layout: its exact inverse, the conv weights in ``w``'s dtype."""
    out, off = {}, 0
    nouts = [inner] * 3 + [c]
    for i in range(4):
        k = c + i * inner
        size = 9 * k * nouts[i]
        out[f"conv_{i}.weight"] = w[off:off + size].reshape(3, 3, k, nouts[i]).permute(3, 2, 0, 1)
        off += size
    parts = ba.split(nouts + nouts)
    for i in range(4):
        out[f"conv_{i}.bias"], out[f"actv_{i}.weight"] = parts[i], parts[4 + i]
    return out


def _library():
    lib = load_library("fused_block", "fused_block.cu", ("fused_block.cuh",))
    _declare(lib, "fused_block")
    return lib


def _tc_library():
    lib = load_library("fused_block_tc", "fused_block_tc.cu",
                       ("fused_block.cuh", "fused_block_tc.cuh"))
    _declare(lib, "fused_block_tc")
    return lib


def _packed_library():
    lib = load_library("fused_block_packed", "fused_block_packed.cu", ("fused_block.cuh",))
    _declare(lib, "fused_block_packed")
    return lib


def _packed_tc_library():
    lib = load_library("fused_block_packed_tc", "fused_block_packed_tc.cu",
                       ("fused_block.cuh", "fused_block_tc.cuh"))
    _declare(lib, "fused_block_packed_tc")
    return lib


def _wide_library():
    lib = load_library("fused_block_wide_tc", "fused_block_wide_tc.cu",
                       ("fused_block.cuh", "fused_block_tc.cuh"))
    fn = lib.fused_block_wide_tc_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.fused_block_wide_tc_error_string.argtypes = [ctypes.c_int]
        lib.fused_block_wide_tc_error_string.restype = ctypes.c_char_p
    return lib


def _declare(lib, prefix):
    fn = getattr(lib, f"{prefix}_launch")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{prefix}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p


def _check_input(name, x, params_desc, layout=True):
    """``layout=False``: leave the memory layout to the operator (under
    torch.export, whose symbolic strides cannot be asked)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {x.dtype} (want float32 or bfloat16)")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be 4-D (N,C,H,W), got {tuple(x.shape)}")
    if layout and not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: x must be NHWC memory "
                         "(x.contiguous(memory_format=torch.channels_last))")
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in params_desc.values())):
        raise RuntimeError(f"{name} has no backward: call it under torch.no_grad() or "
                           "torch.inference_mode(), or use models.fused_apply."
                           "fused_block_trainable")


def _check_kernel_weights(name, weights, x, c, inner):
    wpk, ba = weights
    if wpk.dtype != x.dtype or wpk.device != x.device or ba.device != x.device:
        raise ValueError(f"{name}: kernel weights are for another dtype/device")
    if (wpk.numel() != block_weight_count(c, inner) or ba.numel() != 2 * (3 * inner + c)
            or ba.dtype != torch.float32 or not (wpk.is_contiguous() and ba.is_contiguous())):
        raise ValueError(f"{name}: kernel weights are not pack_block_params of this block")


def _launch(name, lib, prefix, x, weights, n, h, w, c, inner, tile=None):
    """Allocate y like x and launch the block kernel over the (h x w) image;
    ``tile`` is (th, tw, shared-memory bytes), by default ``pick_tile``'s."""
    wpk, ba = weights
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    if tile is None:
        th, tw = pick_tile(inner, x.element_size())
        tile = (th, tw, smem_bytes(inner, th, tw, x.element_size()))
    th, tw, smem = tile
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"{prefix}_launch")(
            x.data_ptr(), wpk.data_ptr(), ba.data_ptr(), y.data_ptr(),
            n, h, w, c, inner, th, tw, int(x.dtype == torch.bfloat16), smem,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        msg = getattr(lib, f"{prefix}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {rc})")
    return y


def _launch_wide(name, x, weights, n, h, w, c, inner, smem, packed_layout=False):
    """Allocate y like x and the o0..o2 workspace from the caching allocator
    (freed when this returns, once the stream's work is queued), and launch
    the wide form's four levels over the (h x w) image on the current
    stream; ``packed_layout``: x and y are 2x2 even-packed."""
    wpk, ba = weights
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    ws = torch.empty(wide_workspace_shape(n, c, h, w), dtype=x.dtype, device=x.device)
    lib = _wide_library()
    with torch.cuda.device(x.device):
        rc = lib.fused_block_wide_tc_launch(
            x.data_ptr(), wpk.data_ptr(), ba.data_ptr(), y.data_ptr(), ws.data_ptr(),
            n, h, w, c, inner, int(x.dtype == torch.bfloat16), int(packed_layout), smem,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.fused_block_wide_tc_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {rc})")
    return y


@torch.library.custom_op("vub_torch::fused_denoising_block", mutates_args=())
def fused_denoising_block_op(x: torch.Tensor, w: torch.Tensor, ba: torch.Tensor) -> torch.Tensor:
    """Kernel 1's launch as one operator, ``vub_torch::fused_denoising_block``:
    x (N, C, H, W) in channels_last memory on the card, and the block's
    weights as ``pack_block_params`` lays them out (w, ba).  It picks the
    variant and tile from the shapes it is called with (``block_tile``),
    launches, and counts the launch on ``fused_denoising_block``.  As an
    operator, ``torch.export`` records it as one node of the graph (its
    ``register_fake`` gives the output's shape and strides), and the exported
    program launches the kernel when it runs; ``fused_denoising_block`` is
    the checked entry for eager callers.  On a CPU tensor (a program
    exported for the CPU) it is the plain version, on the weights unpacked."""
    n, c, h, w_ = x.shape
    inner = (ba.numel() // 2 - c) // 3  # ba holds 3*inner + c biases, then as many alphas
    if x.device.type == "cpu":
        return fused_denoising_block_plain(x, unpack_block_params(w, ba, c, inner))
    # an exported program's input comes as its graph computed it; eager
    # callers were held to NHWC memory by fused_denoising_block
    x = x.contiguous(memory_format=torch.channels_last)
    variant, th, tw, smem = block_tile(x.dtype, n, c, h, w_, sm_count(x.device))
    if variant == "tc":
        y = _launch("fused_denoising_block", _tc_library(), "fused_block_tc", x, (w, ba),
                    n, h, w_, c, inner, (th, tw, smem))
    else:
        y = _launch_wide("fused_denoising_block", x, (w, ba), n, h, w_, c, inner, smem)
        fused_denoising_block.wide_launches += 1
    fused_denoising_block.tc_launches += 1
    fused_denoising_block.launches += 1
    return y


@fused_denoising_block_op.register_fake
def _(x, w, ba):
    return torch.empty_like(x, memory_format=torch.channels_last)


def fused_denoising_block(x, params, packed=None):
    """Apply one DenoisingBlock to ``x`` (N, C, H, W).

    On a CPU tensor this is ``fused_denoising_block_plain``.  On a CUDA tensor
    it launches a kernel through the operator ``fused_denoising_block_op``,
    by this static rule (``block_variant``): f32 or
    bf16 with c in ``TC_WIDTHS[dtype]`` launches the tensor-core kernel
    (``csrc/fused_block_tc.cu``, 3xTF32 for f32; counted in
    ``.tc_launches``); every other width the wide form on the tensor cores
    (``csrc/fused_block_wide_tc.cu``, four CUDA launches counted once, in
    ``.tc_launches`` and ``.wide_launches``).  Every block counts once in
    ``.launches``.  ``x`` must be f32 or bf16 in
    channels_last memory; ``packed`` is ``pack_block_params(params, x.dtype,
    x.device)``, which callers cache (it is built here when omitted).  The
    kernels have no backward: call this under ``torch.no_grad()`` or
    ``torch.inference_mode()``, or train through
    ``models.fused_apply.fused_block_trainable``."""
    exporting = torch.compiler.is_exporting()
    if x.device.type == "cpu" and not exporting:
        return fused_denoising_block_plain(x, params)
    if x.device.type != "cpu":
        _check_input("fused_denoising_block", x, params, layout=not exporting)
    c = x.shape[1]
    inner = params["conv_0.weight"].shape[0]
    if params["conv_0.weight"].shape[1] != c or params["conv_3.weight"].shape[0] != c:
        raise ValueError("DenoisingBlock is residual: cout == cin == x's channels")
    for i in range(4):
        want = (inner if i < 3 else c, c + i * inner, 3, 3)
        if tuple(params[f"conv_{i}.weight"].shape) != want:
            raise ValueError(f"fused_denoising_block: conv_{i}.weight is "
                             f"{tuple(params[f'conv_{i}.weight'].shape)}, want {want}")
    if packed is None:
        packed = pack_block_params(params, x.dtype, x.device)
    _check_kernel_weights("fused_denoising_block", packed, x, c, inner)
    return fused_denoising_block_op(x, *packed)


fused_denoising_block.launches = 0  # blocks launched (every variant) since the last reset
fused_denoising_block.tc_launches = 0  # of those, on the tensor cores (tc and tc_wide)
fused_denoising_block.wide_launches = 0  # of those, the wide form


# ---------------------------------------------------------------------------
# The block on the 2x2 even-packed layout (kernel 2)
# ---------------------------------------------------------------------------

def pack_block_params_packed(params):
    """The block's params (state_dict keys) in the packed kernel's form.

    Counterpart of ``pack_block_params_packed``: ``conv_i.weight`` becomes the
    tap-stacked packed taps (4K, 16N), column t*4N + (a*2+b)*N + n, from
    ``pack_conv3x3_weights(..., in_segments=[c, inner, ...], "desc")``;
    ``conv_i.bias`` and ``actv_i.weight`` are tiled 4x.  Differentiable."""
    c, inner = params["conv_0.weight"].shape[1], params["conv_0.weight"].shape[0]
    out = {}
    for i in range(4):
        w2 = pack_conv3x3_weights(params[f"conv_{i}.weight"], [c] + [inner] * i, "desc")
        t, k4, n4 = w2.shape
        out[f"conv_{i}.weight"] = w2.permute(1, 0, 2).reshape(k4, t * n4)
        out[f"conv_{i}.bias"] = pack_vec(params[f"conv_{i}.bias"])
        out[f"actv_{i}.weight"] = pack_vec(params[f"actv_{i}.weight"])
    return out


def packed_block_tile(dtype, n: int, c4: int, hq: int, wq: int, sms: int):
    """(variant, th, tw, shared-memory bytes) of kernel 2's launch at an
    even-packed (n, c4, hq, wq) input: ``block_tile`` of the unpacked
    (n, c4/4, 2hq, 2wq) image, since the kernels tile image coordinates."""
    return block_tile(dtype, n, c4 // 4, 2 * hq, 2 * wq, sms)


def packed_block_dims(packed_params):
    """(c, inner) of the unpacked block that ``packed_params`` describe."""
    k4, n16 = packed_params["conv_0.weight"].shape
    return k4 // 4, n16 // 16


@functools.lru_cache(maxsize=32)
def _tap_major_index(c, inner, device):
    """Flat index into the four packed conv weights, flattened and concatenated,
    that gathers kernel 1's tap-major (9, K, N) weights, conv_0..conv_3.

    Tap (ky, kx) of a 3x3 conv is the packed entry for output sub-pixel
    (a, b) = (0, 0): dy = 2u-1+abar, so ky = 0, 1, 2 is (u, abar) = (0, 0),
    (0, 1), (1, 0), and likewise kx; the row is the shifted sub-pixel's block
    of k's segment in 'desc' order."""
    u_of, sub_of = np.array([0, 0, 1]), np.array([0, 1, 0])
    ky = np.arange(3)[:, None, None, None]
    kx = np.arange(3)[None, :, None, None]
    parts, base = [], 0
    for i in range(4):
        k_total, n_out = c + i * inner, inner if i < 3 else c
        k = np.arange(k_total)
        seg = np.where(k < c, c, inner)
        seg_off = np.where(k < c, 0, c + (k - c) // inner * inner)
        s_pos = 3 - (sub_of[ky] * 2 + sub_of[kx])
        row = 4 * seg_off[None, None, :, None] + s_pos * seg[None, None, :, None] + (
            k - seg_off)[None, None, :, None]
        col = (u_of[ky] * 2 + u_of[kx]) * 4 * n_out + np.arange(n_out)[None, None, None, :]
        parts.append((base + row * 16 * n_out + col).reshape(-1))
        base += 4 * k_total * 16 * n_out
    return torch.from_numpy(np.concatenate(parts)).to(device)


def kernel_weights_from_packed(packed_params, dtype):
    """Kernel 1's weight layout (``pack_block_params``) recovered from the
    packed params by one gather on their device: the nine 3x3 taps of each
    conv, and the bias and alpha of sub-pixel (0, 0).  Exact inverse of
    ``pack_block_params_packed``."""
    c, inner = packed_block_dims(packed_params)
    flat = torch.cat([packed_params[f"conv_{i}.weight"].detach().reshape(-1) for i in range(4)])
    w = flat[_tap_major_index(c, inner, flat.device)].to(dtype).contiguous()
    nouts = [inner] * 3 + [c]
    ba = [packed_params[f"conv_{i}.bias"].detach()[:nouts[i]] for i in range(4)]
    ba += [packed_params[f"actv_{i}.weight"].detach()[:nouts[i]] for i in range(4)]
    return w, torch.cat(ba).to(torch.float32).contiguous()


def fused_denoising_block_packed_plain(xq, packed_params):
    """The packed block in plain PyTorch ops, with kernel 1's casts.

    Runs the TPU kernel's arithmetic: at each level every part is re-expressed
    as shifted-packed in 'desc' order (``reshift2d``), the parts are
    concatenated, and the 2x2 packed taps are one VALID conv in f32 (16/9 of
    the useful FLOPs).  Bias in f32, one cast, PReLU in the compute dtype."""
    dtype = xq.dtype

    def level(parts, i):
        xs = torch.cat([reshift2d(F.pad(p, (0, 1, 0, 1)), p.shape[1] // 4, "desc")
                        for p in parts], 1)
        w = packed_params[f"conv_{i}.weight"]
        w2 = w.to(dtype).float().reshape(w.shape[0], 4, w.shape[1] // 4).permute(1, 0, 2)
        y = packed_taps_conv(xs.float(), w2)
        y = (y + packed_params[f"conv_{i}.bias"].float().view(1, -1, 1, 1)).to(dtype)
        alpha = packed_params[f"actv_{i}.weight"].to(dtype).view(1, -1, 1, 1)
        return torch.clamp_min(y, 0) + alpha * torch.clamp_max(y, 0)

    o0 = level([xq], 0)
    o1 = level([xq, o0], 1)
    o2 = level([xq, o0, o1], 2)
    return level([xq, o0, o1, o2], 3) + xq


def fused_denoising_block_packed(xq, packed_params, kernel_weights=None):
    """Apply one DenoisingBlock to an even-packed ``xq`` (N, 4C, H/2, W/2).

    Replaces the Pallas TPU kernel ``fused_denoising_block_packed``
    (``vub_image_denoising_tpu/ops/fused_block.py:360``), with its contract:
    ``unpack2x2(fused_denoising_block_packed(pack2x2(x),
    pack_block_params_packed(p))) == fused_denoising_block(x, p)``.

    On a CPU tensor this is ``fused_denoising_block_packed_plain``.  On a CUDA
    tensor it launches a kernel that addresses the packed layout by index and
    computes the nine 3x3 taps of kernel 1, by kernel 1's static rule
    (``packed_block_tile``): f32 or bf16 with c in ``TC_WIDTHS[dtype]``
    launches ``csrc/fused_block_packed_tc.cu``, kernel 1's tensor-core body
    with the packed pixel address, whose unpacked output equals kernel 1's
    bit for bit (counted in ``.tc_launches``); every other width the wide
    form ``csrc/fused_block_wide_tc.cu`` with the packed pixel address (in
    ``.tc_launches`` and ``.wide_launches``).  Every block counts once in
    ``.launches``.  ``csrc/fused_block_packed.cu``, kernel 2 on the CUDA
    cores, takes no width any more; ``chip_smoke.py`` and the card tests
    launch it directly (``_packed_library``).  ``kernel_weights`` is ``kernel_weights_from_packed(
    packed_params, xq.dtype)``, which callers cache per parameter version (it
    is gathered here when omitted).  No backward, like kernel 1."""
    name = "fused_denoising_block_packed"
    c, inner = packed_block_dims(packed_params)
    if xq.dim() != 4 or xq.shape[1] != 4 * c:
        raise ValueError(f"{name}: x {tuple(xq.shape)} has not the 4 x {c} packed channels "
                         "of these params")
    if xq.device.type == "cpu":
        return fused_denoising_block_packed_plain(xq, packed_params)
    _check_input(name, xq, packed_params)
    n, _, hq, wq = xq.shape
    for i in range(4):
        want = (4 * (c + i * inner), 16 * (inner if i < 3 else c))
        if tuple(packed_params[f"conv_{i}.weight"].shape) != want:
            raise ValueError(f"{name}: conv_{i}.weight is "
                             f"{tuple(packed_params[f'conv_{i}.weight'].shape)}, want {want}")
    if kernel_weights is None:
        kernel_weights = kernel_weights_from_packed(packed_params, xq.dtype)
    _check_kernel_weights(name, kernel_weights, xq, c, inner)
    variant, th, tw, smem = packed_block_tile(xq.dtype, n, 4 * c, hq, wq, sm_count(xq.device))
    if variant == "tc":
        y = _launch(name, _packed_tc_library(), "fused_block_packed_tc", xq, kernel_weights,
                    n, 2 * hq, 2 * wq, c, inner, (th, tw, smem))
    else:
        y = _launch_wide(name, xq, kernel_weights, n, 2 * hq, 2 * wq, c, inner, smem,
                         packed_layout=True)
        fused_denoising_block_packed.wide_launches += 1
    fused_denoising_block_packed.tc_launches += 1
    fused_denoising_block_packed.launches += 1
    return y


fused_denoising_block_packed.launches = 0  # blocks launched (every variant) since the last reset
fused_denoising_block_packed.tc_launches = 0  # of those, on the tensor cores (tc and tc_wide)
fused_denoising_block_packed.wide_launches = 0  # of those, the wide form


def pad_block_params(params, cpad):
    """Zero-pad a DenoisingBlock's params (state_dict keys, OIHW) so the block
    runs on ``cpad``-channel inputs whose extra channels are zero.

    Counterpart of ``pad_block_params``: each conv's x-slice of input
    channels gets zero rows, conv_3 zero output channels with zero bias and
    alpha, so the padded channels stay zero through the residual.  Inner
    channels are untouched."""
    cin = params["conv_0.weight"].shape[1]
    extra = cpad - cin
    if extra == 0:
        return dict(params)
    out = dict(params)
    out["conv_0.weight"] = F.pad(params["conv_0.weight"], (0, 0, 0, 0, 0, extra))
    for i in (1, 2, 3):
        k = params[f"conv_{i}.weight"]
        out[f"conv_{i}.weight"] = torch.cat(
            [F.pad(k[:, :cin], (0, 0, 0, 0, 0, extra)), k[:, cin:]], 1)
    out["conv_3.weight"] = F.pad(out["conv_3.weight"], (0, 0, 0, 0, 0, 0, 0, extra))
    out["conv_3.bias"] = F.pad(params["conv_3.bias"], (0, extra))
    out["actv_3.weight"] = F.pad(params["actv_3.weight"], (0, extra))
    return out
