"""The fused DenoisingBlock kernels (plain NHWC and 2x2 even-packed), the
differentiable block and a module backward, against their plain versions on
the card.

Every test here needs an NVIDIA GPU with the CUDA toolkit and skips without
one.  The file imports neither JAX nor the JAX package, so it also runs where
only the port is installed (``--noconftest`` skips the suite's JAX set-up):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 (TF32 off) atol = rtol = 1e-4, since kernel and cuDNN differ
only in summation order (the tensor-core kernel's 3xTF32 products keep f32
accuracy); bf16 max-abs error <= 2e-2 * max|y| against the f32
plain result, a few bf16 ulps (2^-8 relative) through four rounded levels."""

import pytest
import torch

from vub_image_denoising_tpu_torch import enable_strict_precision
from vub_image_denoising_tpu_torch.models import RDUNet
from vub_image_denoising_tpu_torch.models import fused_apply as fa
from vub_image_denoising_tpu_torch.nn.blocks import DenoisingBlock
from vub_image_denoising_tpu_torch.ops import fused_block as fb
from vub_image_denoising_tpu_torch.ops.packing import pack2x2, unpack2x2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda is unavailable")
    enable_strict_precision()
    return torch.device("cuda")


def _block(c, device, seed=0):
    block = DenoisingBlock(c, c // 2, c, generator=torch.Generator().manual_seed(seed))
    return {k: v.detach().to(device) for k, v in block.named_parameters()}


def _check(y, x, params):
    want = fb.fused_denoising_block_plain(x.float(), params)
    assert y.dtype == x.dtype and y.shape == x.shape
    assert bool(torch.isfinite(y.float()).all())
    if x.dtype == torch.float32:
        torch.testing.assert_close(y, want, atol=1e-4, rtol=1e-4)
    else:
        assert (y.float() - want).abs().max().item() <= 2e-2 * want.abs().max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 32, 37, 45), (1, 64, 20, 19), (1, 256, 9, 11)])
def test_cuda_kernel_matches_plain(cuda, dtype, shape):
    """Ragged images (H, W not multiples of any tile) at every tile size."""
    params = _block(shape[1], cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(shape, generator=gen, device=cuda).to(getattr(torch, dtype))
    x = x.contiguous(memory_format=torch.channels_last)
    before = fb.fused_denoising_block.launches
    y = fb.fused_denoising_block(x, params)
    torch.cuda.synchronize()
    assert fb.fused_denoising_block.launches == before + 1
    _check(y, x, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_border_padding(cuda, dtype):
    """A constant input: only the nested SAME zero padding makes borders differ."""
    params = _block(32, cuda, seed=2)
    x = torch.ones(1, 32, 24, 24, device=cuda, dtype=getattr(torch, dtype))
    y = fb.fused_denoising_block(x.contiguous(memory_format=torch.channels_last), params)
    torch.cuda.synchronize()
    _check(y, x, params)
    assert not torch.allclose(y[0, :, 0, 12].float(), y[0, :, 12, 12].float(), atol=1e-3)


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    params = _block(32, cuda)
    x = torch.randn(1, 32, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="NHWC"):
        fb.fused_denoising_block(x.contiguous(), params)
    nhwc = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(TypeError, match="dtype"):
        fb.fused_denoising_block(nhwc.half(), params)
    with pytest.raises(ValueError, match="another dtype"):
        fb.fused_denoising_block(nhwc, params, fb.pack_block_params(params, torch.bfloat16, cuda))
    with pytest.raises(ValueError, match="cout == cin"):
        fb.fused_denoising_block(nhwc[:, :16].contiguous(memory_format=torch.channels_last),
                                 params)
    with pytest.raises(ValueError, match="conv_1.weight is"):
        fb.fused_denoising_block(nhwc, {**params, "conv_1.weight": params["conv_1.weight"][:, :40]})
    narrow = DenoisingBlock(32, 8, 32)
    with pytest.raises(ValueError, match="not pack_block_params"):
        fb.fused_denoising_block(nhwc, params, fb.pack_block_params(
            dict(narrow.named_parameters()), torch.float32, cuda))
    with pytest.raises(RuntimeError, match="no backward"):
        fb.fused_denoising_block(nhwc.requires_grad_(), params)


def test_cuda_rdunet_forward_runs_14_kernels(cuda):
    """One RDUNet forward on the card launches the kernel once per block and
    matches the plain forward on the CPU (2e-4, the full-model tolerance)."""
    model = RDUNet(3, 8, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.rand(2, 3, 64, 48, generator=torch.Generator().manual_seed(1)) * 2 - 1
    with torch.inference_mode():
        want = model(x)
        gpu = model.to(cuda).to(memory_format=torch.channels_last)
        before = fb.fused_denoising_block.launches
        y = gpu(x.to(cuda).contiguous(memory_format=torch.channels_last))
        torch.cuda.synchronize()
    assert fb.fused_denoising_block.launches == before + 14
    torch.testing.assert_close(y.cpu(), want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 64, 38, 46), (1, 32, 20, 18), (1, 256, 10, 12)])
def test_cuda_packed_kernel_matches_plain(cuda, dtype, shape):
    """Kernel 2 on pack2x2(x) against its plain version (f32) and, unpacked,
    against kernel 1 on x (the contract)."""
    params = _block(shape[1], cuda)
    pq = fb.pack_block_params_packed(params)
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=gen, device=cuda).to(getattr(torch, dtype))
    xq = pack2x2(x.contiguous(memory_format=torch.channels_last))
    before = fb.fused_denoising_block_packed.launches
    yq = fb.fused_denoising_block_packed(xq, pq)
    torch.cuda.synchronize()
    assert fb.fused_denoising_block_packed.launches == before + 1
    assert yq.dtype == xq.dtype and yq.shape == xq.shape
    want = fb.fused_denoising_block_packed_plain(xq.float(), pq)
    if x.dtype == torch.float32:
        torch.testing.assert_close(yq, want, atol=1e-4, rtol=1e-4)
        one = fb.fused_denoising_block(x.contiguous(memory_format=torch.channels_last), params)
        torch.testing.assert_close(unpack2x2(yq), one, atol=1e-4, rtol=1e-4)
    else:
        assert (yq.float() - want).abs().max().item() <= 2e-2 * want.abs().max().item()


def test_cuda_packed_kernel_border_and_checks(cuda):
    params = _block(32, cuda, seed=2)
    pq = fb.pack_block_params_packed(params)
    x = torch.ones(1, 32, 24, 24, device=cuda)
    y = unpack2x2(fb.fused_denoising_block_packed(pack2x2(x), pq))
    torch.cuda.synchronize()
    torch.testing.assert_close(y, fb.fused_denoising_block_plain(x, params), atol=1e-4, rtol=1e-4)
    assert not torch.allclose(y[0, :, 0, 12], y[0, :, 12, 12], atol=1e-3)
    xq = pack2x2(x)
    with pytest.raises(ValueError, match="NHWC"):
        fb.fused_denoising_block_packed(xq.contiguous(), pq)
    with pytest.raises(ValueError, match="packed channels"):
        fb.fused_denoising_block_packed(xq[:, :64].contiguous(memory_format=torch.channels_last),
                                        pq)
    with pytest.raises(ValueError, match="another dtype"):
        fb.fused_denoising_block_packed(xq, pq, fb.kernel_weights_from_packed(pq, torch.bfloat16))


@pytest.mark.parametrize("packed", [False, True])
def test_cuda_fused_block_trainable_matches_eager_grads(cuda, packed):
    """One kernel launch forward, none backward; loss and grads equal autograd
    through the eager block on the card."""
    params = {k: v.clone().requires_grad_() for k, v in _block(32, cuda, seed=4).items()}
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(2, 32, 24, 20, generator=gen, device=cuda).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    target = torch.randn(x.shape, generator=gen, device=cuda)
    counter = fb.fused_denoising_block_packed if packed else fb.fused_denoising_block
    before = counter.launches
    loss = (fa.fused_block_trainable(x, params, packed=packed) - target).abs().mean()
    assert counter.launches == before + 1
    grads = torch.autograd.grad(loss, [x, *params.values()])
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want_loss = (fa._dense_block_xla(params, x) - target).abs().mean()
    want = torch.autograd.grad(want_loss, [x, *params.values()])
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_cuda_rdunet_backward_runs_14_kernels(cuda):
    """loss.backward() through RDUNet's modules on the card: 14 kernel
    launches forward, grads equal the CPU module path's (plain blocks).  The
    loss is smooth (squares): an L1 loss flips the sign of its cotangent
    where an output is within the CPU-vs-card rounding of zero."""
    model = RDUNet(3, 8, generator=torch.Generator().manual_seed(0))
    x = torch.rand(2, 3, 32, 48, generator=torch.Generator().manual_seed(1)) * 2 - 1
    ((model(x) - x) ** 2).mean().backward()
    want = {k: p.grad.clone() for k, p in model.named_parameters()}
    gpu = model.to(cuda).to(memory_format=torch.channels_last)
    gpu.zero_grad(set_to_none=True)
    before = fb.fused_denoising_block.launches
    xc = x.to(cuda).contiguous(memory_format=torch.channels_last)
    ((gpu(xc) - xc) ** 2).mean().backward()
    torch.cuda.synchronize()
    assert fb.fused_denoising_block.launches == before + 14
    for k, p in gpu.named_parameters():
        torch.testing.assert_close(p.grad.cpu(), want[k], rtol=1e-3, atol=1e-5, msg=k)


# ---------------------------------------------------------------------------
# The tensor-core variant of kernel 1 (csrc/fused_block_tc.cu): f32 (3xTF32)
# and bf16 at c in TC_WIDTHS.  Same tolerances as every case above: f32 is
# held to exact f32 (atol = rtol = 1e-4, TF32 off in the plain version).
# ---------------------------------------------------------------------------

def _input(shape, device, dtype, seed=1):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device).to(getattr(torch, dtype))
    return x.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 32, 37, 45), (1, 64, 20, 19), (1, 128, 13, 11),
                                   (1, 256, 9, 11), (2, 256, 32, 32)])
def test_cuda_tc_kernel_matches_plain(cuda, shape, dtype):
    """Ragged images at every RDUNet-32 width, and the micro-batch-2 shape of
    a train step at c = 256 (4x4 tiles); one tensor-core launch each."""
    params = _block(shape[1], cuda)
    x = _input(shape, cuda, dtype)
    before, tc_before = fb.fused_denoising_block.launches, fb.fused_denoising_block.tc_launches
    y = fb.fused_denoising_block(x, params)
    torch.cuda.synchronize()
    assert fb.fused_denoising_block.launches == before + 1
    assert fb.fused_denoising_block.tc_launches == tc_before + 1
    _check(y, x, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 16, 37, 45), (1, 48, 20, 19), (2, 48, 64, 64),
                                   (1, 96, 13, 11), (1, 152, 13, 11), (1, 192, 9, 11)])
def test_cuda_tc_kernel_padded_widths(cuda, shape, dtype):
    """The search's and RDUNet(152)'s widths below 256 (c = 16, 48, 96, 152,
    192: the fused body with padded inner channels, or the wide form) on
    ragged images, and c = 48 at 64^2: one tensor-core launch each, held to
    the plain block."""
    params = _block(shape[1], cuda, seed=3)
    x = _input(shape, cuda, dtype, seed=4)
    counter = fb.fused_denoising_block
    before = (counter.launches, counter.tc_launches, counter.wide_launches)
    y = counter(x, params)
    torch.cuda.synchronize()
    wide = fb.block_variant(x.dtype, shape[1]) == "tc_wide"
    assert (counter.launches, counter.tc_launches, counter.wide_launches) == (
        before[0] + 1, before[1] + 1, before[2] + wide)
    _check(y, x, params)


@pytest.mark.parametrize("dtype,c,tile", [
    (dtype, c, t) for dtype in ("float32", "bfloat16")
    for c in fb.TC_WIDTHS[getattr(torch, dtype)]
    for t in fb.tc_tiles(c, getattr(torch, dtype).itemsize)])
def test_cuda_tc_kernel_every_tile(cuda, dtype, c, tile):
    """Each (dtype, c, tile) the kernel is built for, forced, on a ragged image."""
    params = _block(c, cuda, seed=6)
    x = _input((1, c, 19, 13), cuda, dtype, seed=7)
    y = fb._launch("fused_denoising_block", fb._tc_library(), "fused_block_tc", x,
                   fb.pack_block_params(params, x.dtype, cuda), 1, 19, 13, c, c // 2,
                   (*tile, fb.tc_smem_bytes(c, *tile, x.element_size())))
    torch.cuda.synchronize()
    _check(y, x, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_tc_kernel_border_padding(cuda, dtype):
    params = _block(32, cuda, seed=2)
    x = torch.ones(1, 32, 24, 24, device=cuda, dtype=getattr(torch, dtype))
    tc_before = fb.fused_denoising_block.tc_launches
    y = fb.fused_denoising_block(x.contiguous(memory_format=torch.channels_last), params)
    torch.cuda.synchronize()
    assert fb.fused_denoising_block.tc_launches == tc_before + 1
    _check(y, x, params)
    assert not torch.allclose(y[0, :, 0, 12].float(), y[0, :, 12, 12].float(), atol=1e-3)


@pytest.mark.parametrize("dtype,c,tc", [("float32", 32, 1), ("float32", 18, 1),
                                         ("bfloat16", 18, 1), ("bfloat16", 512, 1),
                                         ("bfloat16", 1024, 1), ("bfloat16", 64, 1),
                                         ("float32", 16, 1), ("bfloat16", 16, 1)])
def test_cuda_variant_counters(cuda, dtype, c, tc):
    """f32 and bf16 at c in TC_WIDTHS, at c = 512 and 1024, and at c = 18
    (36 bytes of bf16 channels, no 16-byte run: the wide form's element-wise
    loads) count as a tensor-core launch.  Each output is held against the
    plain version."""
    params = _block(c, cuda)
    x = torch.randn(1, c, 10, 12, device=cuda).to(getattr(torch, dtype)).contiguous(
        memory_format=torch.channels_last)
    before, tc_before = fb.fused_denoising_block.launches, fb.fused_denoising_block.tc_launches
    y = fb.fused_denoising_block(x, params)
    torch.cuda.synchronize()
    assert fb.fused_denoising_block.launches == before + 1
    assert fb.fused_denoising_block.tc_launches == tc_before + tc
    _check(y, x, params)


def _cuda_core_at_tc_width(shape, device, dtype):
    n, c, h, w = shape
    params = _block(c, device)
    x = _input(shape, device, dtype)
    y = fb._launch("fused_denoising_block", fb._library(), "fused_block", x,
                   fb.pack_block_params(params, x.dtype, device), n, h, w, c, c // 2)
    torch.cuda.synchronize()
    _check(y, x, params)


@pytest.mark.parametrize("shape", [(2, 32, 37, 45), (1, 64, 20, 19), (1, 256, 9, 11)])
def test_cuda_core_kernel_bf16_at_tc_widths(cuda, shape):
    """The CUDA-core kernel's bf16 build, forced at widths the wrapper sends
    to the tensor cores (it takes no width itself; chip_smoke.py times it beside
    the kernels that replaced it)."""
    _cuda_core_at_tc_width(shape, cuda, "bfloat16")


@pytest.mark.parametrize("shape", [(2, 32, 37, 45), (1, 64, 20, 19), (1, 256, 9, 11)])
def test_cuda_core_kernel_f32_at_tc_widths(cuda, shape):
    """The CUDA-core kernel's f32 build, forced at widths the wrapper sends
    to the tensor cores (it takes no width itself; chip_smoke.py times it beside
    the kernels that replaced it)."""
    _cuda_core_at_tc_width(shape, cuda, "float32")


@pytest.mark.parametrize("shape", [(1, 512, 64, 64), (1, 1024, 32, 32)])
def test_cuda_core_kernel_bf16_at_rdunet128_widths(cuda, shape):
    """The CUDA-core kernel's bf16 build, forced at the shapes of RDUNet(128)'s
    deepest blocks on a 256x256 image, where the wrapper now launches the
    wide form: held against the plain block in f32."""
    _cuda_core_at_tc_width(shape, cuda, "bfloat16")


# ---------------------------------------------------------------------------
# The wide form (csrc/fused_block_wide_tc.cu) at c > 256: four launches of
# one tensor-core conv with o0..o2 in a device workspace, for kernel 1 and,
# with the packed pixel address, kernel 2.  The same tolerances; unpacked,
# kernel 2's output equals kernel 1's bit for bit.
# ---------------------------------------------------------------------------

WIDE_SHAPES = [(1, 512, 64, 64), (1, 1024, 32, 32), (4, 512, 64, 64), (2, 512, 20, 36)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_cuda_wide_kernel_matches_plain(cuda, shape, dtype):
    """RDUNet(128)'s c = 512 and 1024 blocks on a 256x256 image, batch 4, and
    a ragged image (neither side a multiple of the 8 x 16 tile): one block,
    counted once as a tensor-core launch and a wide one."""
    params = _block(shape[1], cuda)
    x = _input(shape, cuda, dtype)
    counter = fb.fused_denoising_block
    before = (counter.launches, counter.tc_launches, counter.wide_launches)
    y = counter(x, params)
    torch.cuda.synchronize()
    assert (counter.launches, counter.tc_launches, counter.wide_launches) == tuple(
        v + 1 for v in before)
    _check(y, x, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 512, 64, 64), (2, 1024, 20, 36)])
def test_cuda_packed_wide_kernel_matches_kernel_1(cuda, shape, dtype):
    params, pq, x, xq = _packed_case(shape, cuda, dtype)
    counter = fb.fused_denoising_block_packed
    before = (counter.launches, counter.tc_launches, counter.wide_launches)
    yq = counter(xq, pq)
    torch.cuda.synchronize()
    assert (counter.launches, counter.tc_launches, counter.wide_launches) == tuple(
        v + 1 for v in before)
    _check_packed(yq, xq, pq)
    assert torch.equal(unpack2x2(yq), fb.fused_denoising_block(x, params))


def test_cuda_wide_kernel_rejects_what_it_does_not_take(cuda):
    """An odd side in the packed layout, a shared-memory size that is not the
    kernel's and an inner width that is not c / 2: the launch fails and the
    wrapper raises."""
    params = _block(512, cuda)
    x = _input((1, 512, 7, 8), cuda, "float32")
    kw = fb.pack_block_params(params, x.dtype, cuda)
    smem = fb.wide_smem_bytes(4)
    for args in ((1, 7, 8, 512, 256, smem, True), (1, 7, 8, 512, 256, smem - 16, False),
                 (1, 7, 8, 512, 192, smem, False)):
        with pytest.raises(RuntimeError, match="launch failed"):
            fb._launch_wide("fused_denoising_block", x, kw, *args)


# Widths above 256 that are no multiple of the 64-channel chunk: RDUNet(152)
# on a 128x128 image (304 at 64^2, 608 at 32^2, 1216 at 16^2), base 80's and
# 88's third level (320, 352 at 32^2), a ragged image, and two widths whose
# channels are no multiple of 16 bytes (258 = 2 x 129, inner 129; 260 =
# 4 x 65, inner 130), which take the element-wise loads.
PARTIAL_SHAPES = [(1, 304, 64, 64), (1, 320, 32, 32), (1, 352, 32, 32), (1, 608, 32, 32),
                  (1, 1216, 16, 16), (2, 304, 20, 36), (1, 258, 64, 64), (1, 260, 32, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PARTIAL_SHAPES)
def test_cuda_wide_kernel_partial_chunks_match_plain(cuda, shape, dtype):
    """The wide form takes every c > 256: a partial last chunk of output
    channels and a partial last K slab, held against the plain block; one
    block, counted once as a tensor-core launch and a wide one."""
    params = _block(shape[1], cuda)
    x = _input(shape, cuda, dtype)
    counter = fb.fused_denoising_block
    before = (counter.launches, counter.tc_launches, counter.wide_launches)
    y = counter(x, params)
    torch.cuda.synchronize()
    assert (counter.launches, counter.tc_launches, counter.wide_launches) == tuple(
        v + 1 for v in before)
    _check(y, x, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 608, 32, 32), (1, 258, 20, 36)])
def test_cuda_packed_wide_kernel_partial_chunks_match_kernel_1(cuda, shape, dtype):
    params, pq, x, xq = _packed_case(shape, cuda, dtype)
    yq = fb.fused_denoising_block_packed(xq, pq)
    torch.cuda.synchronize()
    _check_packed(yq, xq, pq)
    assert torch.equal(unpack2x2(yq), fb.fused_denoising_block(x, params))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rdunet128_forward(cuda, dtype):
    """RDUNet(128) on the card, 14 blocks all on the tensor cores (4 through
    the wide form at 64x64 input: c = 512 and 1024), against the CPU forward
    (f32 to 2e-4, TF32 off; bf16 to 5e-2 of max|y|)."""
    model = RDUNet(3, 128, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(1)) * 2 - 1
    with torch.no_grad():
        want = model(x)
        gpu = model.to(cuda).to(memory_format=torch.channels_last)
        xd = x.to(cuda).to(getattr(torch, dtype)).contiguous(memory_format=torch.channels_last)
        counter = fb.fused_denoising_block
        counter.launches = counter.tc_launches = counter.wide_launches = 0
        y = gpu(xd).float().cpu()
    assert (counter.launches, counter.tc_launches, counter.wide_launches) == (14, 14, 6)
    if dtype == "float32":
        torch.testing.assert_close(y, want, atol=2e-4, rtol=0)
    else:
        assert (y - want).abs().max().item() <= 5e-2 * want.abs().max().item()


# ---------------------------------------------------------------------------
# The tensor-core variant of kernel 2 (csrc/fused_block_packed_tc.cu): kernel
# 1's tensor-core body with the packed pixel address, at c in TC_WIDTHS.
# The same tolerances against its plain version; unpacked, its output must
# equal kernel 1's on the same image bit for bit (the same products in the
# same summation order).
# ---------------------------------------------------------------------------

def _packed_case(shape, device, dtype, seed=1):
    """(params, packed params, x, pack2x2(x)) of a block at image shape ``shape``."""
    params = _block(shape[1], device, seed=seed)
    x = _input(shape, device, dtype, seed=seed + 1)
    return params, fb.pack_block_params_packed(params), x, pack2x2(x)


def _check_packed(yq, xq, pq):
    want = fb.fused_denoising_block_packed_plain(xq.float(), pq)
    assert yq.dtype == xq.dtype and yq.shape == xq.shape
    assert bool(torch.isfinite(yq.float()).all())
    if xq.dtype == torch.float32:
        torch.testing.assert_close(yq, want, atol=1e-4, rtol=1e-4)
    else:
        assert (yq.float() - want).abs().max().item() <= 2e-2 * want.abs().max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 32, 38, 46), (1, 64, 20, 18), (1, 128, 14, 10),
                                   (1, 256, 10, 12), (2, 256, 32, 32)])
def test_cuda_packed_tc_kernel_matches_plain_and_kernel_1(cuda, shape, dtype):
    """Even ragged images at every RDUNet-32 width, and the micro-batch-2
    shape at c = 256; one tensor-core launch each."""
    params, pq, x, xq = _packed_case(shape, cuda, dtype)
    counter = fb.fused_denoising_block_packed
    before, tc_before = counter.launches, counter.tc_launches
    yq = counter(xq, pq)
    torch.cuda.synchronize()
    assert (counter.launches, counter.tc_launches) == (before + 1, tc_before + 1)
    _check_packed(yq, xq, pq)
    assert torch.equal(unpack2x2(yq), fb.fused_denoising_block(x, params))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 16, 38, 46), (1, 48, 20, 18), (1, 96, 14, 10)])
def test_cuda_packed_tc_kernel_padded_widths(cuda, shape, dtype):
    """Kernel 2 at the search's widths it runs packed (c = 16, 48, 96: the
    fused body, the wide form): one tensor-core launch, and unpacked equal
    to kernel 1 bit for bit."""
    params, pq, x, xq = _packed_case(shape, cuda, dtype, seed=5)
    counter = fb.fused_denoising_block_packed
    before, tc_before = counter.launches, counter.tc_launches
    yq = counter(xq, pq)
    torch.cuda.synchronize()
    assert (counter.launches, counter.tc_launches) == (before + 1, tc_before + 1)
    _check_packed(yq, xq, pq)
    assert torch.equal(unpack2x2(yq), fb.fused_denoising_block(x, params))


@pytest.mark.parametrize("dtype,c,tile", [
    (dtype, c, t) for dtype in ("float32", "bfloat16")
    for c in fb.TC_WIDTHS[getattr(torch, dtype)]
    for t in fb.tc_tiles(c, getattr(torch, dtype).itemsize)])
def test_cuda_packed_tc_kernel_every_tile(cuda, dtype, c, tile):
    """Each (dtype, c, tile) kernel 2 is built for, forced, on an even
    ragged image, against kernel 1 forced to the same tile."""
    params, pq, x, xq = _packed_case((1, c, 18, 14), cuda, dtype, seed=6)
    launch = (*tile, fb.tc_smem_bytes(c, *tile, x.element_size()))
    yq = fb._launch("fused_denoising_block_packed", fb._packed_tc_library(),
                    "fused_block_packed_tc", xq, fb.kernel_weights_from_packed(pq, x.dtype),
                    1, 18, 14, c, c // 2, launch)
    y1 = fb._launch("fused_denoising_block", fb._tc_library(), "fused_block_tc", x,
                    fb.pack_block_params(params, x.dtype, cuda), 1, 18, 14, c, c // 2, launch)
    torch.cuda.synchronize()
    _check_packed(yq, xq, pq)
    assert torch.equal(unpack2x2(yq), y1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_packed_tc_kernel_border_padding(cuda, dtype):
    params = _block(32, cuda, seed=2)
    pq = fb.pack_block_params_packed(params)
    x = torch.ones(1, 32, 24, 24, device=cuda, dtype=getattr(torch, dtype)).contiguous(
        memory_format=torch.channels_last)
    tc_before = fb.fused_denoising_block_packed.tc_launches
    yq = fb.fused_denoising_block_packed(pack2x2(x), pq)
    torch.cuda.synchronize()
    assert fb.fused_denoising_block_packed.tc_launches == tc_before + 1
    _check_packed(yq, pack2x2(x), pq)
    y = unpack2x2(yq)
    assert torch.equal(y, fb.fused_denoising_block(x, params))
    assert not torch.allclose(y[0, :, 0, 12].float(), y[0, :, 12, 12].float(), atol=1e-3)


@pytest.mark.parametrize("dtype,c,tc", [("float32", 32, 1), ("bfloat16", 64, 1),
                                         ("float32", 18, 1), ("bfloat16", 18, 1),
                                         ("float32", 512, 1), ("bfloat16", 512, 1),
                                         ("float32", 16, 1), ("bfloat16", 48, 1)])
def test_cuda_packed_variant_counters(cuda, dtype, c, tc):
    """Kernel 2 at c in TC_WIDTHS, and at c = 18, 48 and 512 (the wide
    form), counts as a tensor-core launch.  Each output is held against the
    plain version."""
    _, pq, _, xq = _packed_case((1, c, 10, 12), cuda, dtype)
    counter = fb.fused_denoising_block_packed
    before, tc_before = counter.launches, counter.tc_launches
    yq = counter(xq, pq)
    torch.cuda.synchronize()
    assert (counter.launches, counter.tc_launches) == (before + 1, tc_before + tc)
    _check_packed(yq, xq, pq)


@pytest.mark.parametrize("variant", ["tc", "cuda_core"])
def test_cuda_packed_kernels_reject_an_odd_side(cuda, variant):
    """The packed layout needs an even image: both kernel 2 entries refuse an
    odd height, and the wrapper raises."""
    _, pq, _, xq = _packed_case((1, 32, 8, 8), cuda, "float32")
    kw = fb.kernel_weights_from_packed(pq, torch.float32)
    if variant == "tc":
        lib, prefix = fb._packed_tc_library(), "fused_block_packed_tc"
        tile = (4, 4, fb.tc_smem_bytes(32, 4, 4, 4))
    else:
        lib, prefix, tile = fb._packed_library(), "fused_block_packed", None
    with pytest.raises(RuntimeError, match="launch failed"):
        fb._launch("fused_denoising_block_packed", lib, prefix, xq, kw, 1, 7, 8, 32, 16, tile)


# ---------------------------------------------------------------------------
# The interpolation-diffusion sampler and trainer on RDUNetT: every block of
# every step is a kernel-1 launch, on the tensor cores at base 32.  The f32
# sampler is held to the eager engine's (cuDNN, TF32 off) at 2T times the
# full-model tolerance 2e-4: its output sums differences of 2T forwards.
# ---------------------------------------------------------------------------

def _rdunet_t(cuda, base=32):
    from vub_image_denoising_tpu_torch.models import RDUNetT

    model = RDUNetT(base, generator=torch.Generator().manual_seed(0)).eval()
    return model.to(cuda).to(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_sampler_launches_14_per_step_on_tensor_cores(cuda, dtype):
    from vub_image_denoising_tpu_torch.diffusion import InterpolationDiffusion

    steps = 3
    model = _rdunet_t(cuda)
    x = _input((2, 3, 32, 40), cuda, dtype)
    counter = fb.fused_denoising_block
    before, tc_before = counter.launches, counter.tc_launches
    with torch.inference_mode():
        y = InterpolationDiffusion(steps).improved_sampling(model, x)
    torch.cuda.synchronize()
    assert (counter.launches - before, counter.tc_launches - tc_before) == (14 * steps,) * 2
    assert y.dtype == x.dtype and y.shape == x.shape and bool(torch.isfinite(y.float()).all())


def test_cuda_f32_sampler_matches_the_eager_engine(cuda):
    from vub_image_denoising_tpu_torch.diffusion import InterpolationDiffusion

    steps = 3
    model = _rdunet_t(cuda)
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    x = _input((2, 3, 32, 40), cuda, "float32")
    diff = InterpolationDiffusion(steps)
    with torch.inference_mode():
        got = diff.improved_sampling(model, x)
        want = diff.improved_sampling(lambda v, t: fa.rdunet_t_apply_fused(sd, v, t, engine="xla"),
                                      x)
    tol = 2 * steps * 2e-4
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("engine,launches", [("flax", 28), ("pallas", 28), ("xla", 0)])
def test_cuda_diffusion_trainer_step(cuda, engine, launches):
    """One DiffusionTrainer step on RDUNetT-32 per engine, from one seed:
    14 launches per micro-batch on the kernel engines, none on "xla"; the
    losses agree with the "xla" step's (the same weights and timesteps)."""
    from vub_image_denoising_tpu_torch.train import DiffusionTrainer

    gen = torch.Generator(device=cuda).manual_seed(2)
    clean = torch.rand(4, 3, 32, 32, generator=gen, device=cuda) * 2 - 1
    noisy = clean + 0.2 * torch.randn(clean.shape, generator=gen, device=cuda)
    losses = {}
    for eng in (engine, "xla"):
        trainer = DiffusionTrainer(base_filters=32, timesteps=4, accumulation_steps=2, engine=eng)
        state = trainer.init(steps_per_epoch=1, seed=3)
        counter = fb.fused_denoising_block
        before, tc_before = counter.launches, counter.tc_launches
        state, loss = trainer.train_step(state, noisy, clean)
        torch.cuda.synchronize()
        if eng == engine:
            assert (counter.launches - before, counter.tc_launches - tc_before) == (launches,) * 2
        losses[eng] = loss.item()
        assert state.step == 1 and torch.isfinite(loss)
    assert abs(losses[engine] - losses["xla"]) <= 1e-5 * abs(losses["xla"])


def _near_tie(src, tol=1e-4):
    return (src.double() - src.double().floor() - 0.5).abs() < tol


def test_cuda_data_transforms_match_the_cpu(cuda):
    """The on-card noise, augmentation and normalization against the same
    functions on the CPU with the same draws (``noise=``, ``flips=``,
    ``angles=``): byte-equal, but for a rotated pixel whose f32 source
    coordinate lies within 1e-4 of a .5 rounding tie (the card's cos/sin
    may differ from the CPU's in the last bit); such pixels are counted and
    printed."""
    import math

    from vub_image_denoising_tpu_torch.data import device as dev

    gen = torch.Generator().manual_seed(0)
    n, h, w = 6, 64, 48
    clean = torch.randint(0, 256, (n, h, w, 3), generator=gen, dtype=torch.uint8)
    noisy = torch.randint(0, 256, (n, h, w, 3), generator=gen, dtype=torch.uint8)
    noise = torch.randn((n, h, w, 3), generator=gen)
    sigma = torch.tensor([0.0, 15.0, 25.0, 50.0, 75.0, 100.0])
    flips = torch.rand(n, generator=gen) < 0.5
    angles = torch.empty(n).uniform_(-10.0, 10.0, generator=gen)
    # the source coordinates as the CPU computes them (dev._rotation_map before rounding)
    theta = (-angles * math.pi / 180.0).reshape(-1, 1, 1)
    yy = torch.arange(h, dtype=torch.float32).reshape(1, h, 1) - (h - 1) / 2.0
    xx = torch.arange(w, dtype=torch.float32).reshape(1, 1, w) - (w - 1) / 2.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    tie = (_near_tie(cos * yy - sin * xx + (h - 1) / 2.0)
           | _near_tie(sin * yy + cos * xx + (w - 1) / 2.0))
    for augment in (False, True):
        draws = dict(flips=flips, angles=angles) if augment else {}
        for name, fn, args, kw in (
                ("degrade_and_normalize", dev.degrade_and_normalize, (clean, sigma),
                 dict(noise=noise, **draws)),
                ("normalize_pair", dev.normalize_pair, (noisy, clean), draws)):
            want = fn(None, *args, augment=augment, **kw)
            got = fn(None, *(a.to(cuda) for a in args), augment=augment,
                     **{k: v.to(cuda) for k, v in kw.items()})
            for g, wv in zip(got, want):
                assert g.is_cuda and g.shape == wv.shape == (n, 3, h, w)
                off = (g.cpu() != wv).any(1)  # (N, H, W)
                print(f"{name} augment={augment}: {int(off.sum())} pixels differ, "
                      f"{int((off & tie).sum())} at ties, {int(tie.sum())} tie pixels")
                allowed = tie if augment else torch.zeros_like(tie)
                assert not (off & ~allowed).any(), f"{name}: pixels off outside a rounding tie"


# ---------------------------------------------------------------------------
# Evaluation and the utils on the card: the metrics stay f32 exact with TF32
# on (their 7x7 mean is avg_pool2d, no conv); every inference engine but
# "xla" runs kernel 1, "pallas" with its weights packed once per load; the
# FLOP count does not depend on the device; the health probe.
# ---------------------------------------------------------------------------

def test_cuda_metrics_match_the_cpu_with_tf32_on(cuda):
    from vub_image_denoising_tpu_torch.eval import metrics

    gen = torch.Generator().manual_seed(0)
    gt = torch.rand(8, 64, 64, 3, generator=gen) * 2 - 1
    out = (gt + 0.1 * torch.randn(8, 64, 64, 3, generator=gen)).clamp(-1, 1)
    want_p = metrics.psnr_per_image(gt, out, 2.0)
    want_s = metrics.ssim_ref_per_image(gt, out, 2.0)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        got_p = metrics.psnr_per_image(gt.to(cuda), out.to(cuda), 2.0)
        got_s = metrics.ssim_ref_per_image(gt.to(cuda), out.to(cuda), 2.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert got_p.is_cuda and got_s.is_cuda
    assert (got_p.cpu() - want_p).abs().max().item() <= 1e-4
    assert (got_s.cpu() - want_s).abs().max().item() <= 1e-5


def test_cuda_model_summary_equals_the_cpu_count(cuda):
    from vub_image_denoising_tpu_torch.utils.info import model_summary

    model = RDUNet(3, 32, generator=torch.Generator().manual_seed(0)).eval()
    want = model_summary(model, torch.zeros(1, 3, 64, 64))
    model = model.to(cuda).to(memory_format=torch.channels_last)
    x = torch.zeros(1, 3, 64, 64, device=cuda).contiguous(memory_format=torch.channels_last)
    before = fb.fused_denoising_block.launches
    assert model_summary(model, x) == want
    assert fb.fused_denoising_block.launches == before  # counted on meta tensors


def test_cuda_probe_device_exec(cuda):
    from vub_image_denoising_tpu_torch.utils.health import probe_device_exec

    ok, dt, detail = probe_device_exec(timeout_s=120.0)
    assert ok, detail
    assert float(detail.split()[1]) == 128.0


@pytest.mark.parametrize("engine,launches", [("auto", 14), ("flax", 14), ("pallas", 14),
                                             ("xla", 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_engines_launch_kernel_1(cuda, tmp_path, engine, launches, dtype):
    """``build_apply``'s engines on the sampler: 14*T kernel-1 launches per
    call on "auto", "flax" and "pallas", all on the tensor cores, none on
    "xla"; "pallas" packs the 14 blocks' weights once, at load.  Every
    engine's output is finite and within the bf16/f32 bound of "flax"'s."""
    from vub_image_denoising_tpu_torch.eval.denoise_cli import build_apply
    from vub_image_denoising_tpu_torch.utils.checkpoint import save_pth

    steps = 2
    ck = str(tmp_path / "ck.pth")
    save_pth(ck, _rdunet_t(torch.device("cpu")).state_dict(), prefix="unet.")
    packs = []
    real = fb.pack_block_params

    def counting(*args):
        packs.append(args)
        return real(*args)

    bf16 = dtype == "bfloat16"
    ref, _ = build_apply(ck, "diffusion", 32, steps, bf16=bf16, engine="flax")
    orig_fb, orig_fa = fb.pack_block_params, fa.pack_block_params
    fb.pack_block_params = fa.pack_block_params = counting
    try:
        forward, _ = build_apply(ck, "diffusion", 32, steps, bf16=bf16, engine=engine)
        loaded = len(packs)
        x = torch.rand(2, 32, 40, 3, generator=torch.Generator().manual_seed(1)).to(cuda) * 2 - 1
        counter = fb.fused_denoising_block
        before, tc_before = counter.launches, counter.tc_launches
        y = forward(x)
        y = forward(x)
        torch.cuda.synchronize()
        got = (counter.launches - before, counter.tc_launches - tc_before)
    finally:
        fb.pack_block_params, fa.pack_block_params = orig_fb, orig_fa
    assert got == (2 * launches * steps,) * 2
    if engine == "pallas":
        assert loaded == 14 and len(packs) == 14
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    want = ref(x)
    tol = 2e-2 * want.abs().max().item() if bf16 else 2 * steps * 2e-4
    assert (y - want).abs().max().item() <= tol


@pytest.mark.parametrize("remat,per_micro_batch", [(False, 14), (True, 28), ("highres", 22)])
def test_cuda_remat_launch_counts(cuda, remat, per_micro_batch):
    """DiffusionTrainer(engine="flax", remat=...) on the card: each
    micro-batch forward launches kernel 1 14 times, and the backward
    launches it once more per rematerialized block (all 14, or the 8 at
    scales 0 and 1); the step's loss is finite."""
    from vub_image_denoising_tpu_torch.train import DiffusionTrainer

    trainer = DiffusionTrainer(base_filters=32, timesteps=4, accumulation_steps=2, engine="flax",
                               remat=remat)
    state = trainer.init(steps_per_epoch=1, seed=0)
    gen = torch.Generator(device=cuda).manual_seed(3)
    clean = torch.rand(4, 3, 32, 32, generator=gen, device=cuda) * 2 - 1
    counter = fb.fused_denoising_block
    before = (counter.launches, counter.tc_launches)
    state, loss = trainer.train_step(state, clean + 0.1 * torch.randn_like(clean), clean)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss))
    assert (counter.launches - before[0], counter.tc_launches - before[1]) == (
        2 * per_micro_batch, 2 * per_micro_batch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_exported_program_launches_kernel_1(cuda, tmp_path, dtype):
    """``eval/export.py`` on the card: the program holds 14 kernel-1 operator
    nodes, and the artifact, saved and loaded, launches kernel 1 14 times per
    call (all on the tensor cores) at two batches, within the f32 / bf16
    bound of the module path."""
    from vub_image_denoising_tpu_torch.eval.denoise_cli import build_apply
    from vub_image_denoising_tpu_torch.eval.export import (build_exported, kernel_nodes,
                                                           load_exported, save_exported)
    from vub_image_denoising_tpu_torch.utils.checkpoint import save_pth

    ck = str(tmp_path / "ck.pth")
    save_pth(ck, RDUNet(3, 32, generator=torch.Generator().manual_seed(0)).state_dict())
    bf16 = dtype == "bfloat16"
    programs = build_exported(ck, base_filters=32, size=32, bf16=bf16)
    assert kernel_nodes(programs["cuda"]) == 14
    fn = load_exported(save_exported(programs, str(tmp_path / "m.pt2")))
    forward, _ = build_apply(ck, base_filters=32, bf16=bf16)
    counter = fb.fused_denoising_block
    for batch in (3, 1):
        x = torch.rand(batch, 32, 32, 3, generator=torch.Generator().manual_seed(batch))
        x = (x * 2 - 1).to(cuda)
        before = (counter.launches, counter.tc_launches)
        y = fn(x)
        torch.cuda.synchronize()
        assert (counter.launches - before[0], counter.tc_launches - before[1]) == (14, 14)
        want = forward(x)
        tol = 2e-2 * want.abs().max().item() if bf16 else 2e-4
        assert y.shape == x.shape and (y - want).abs().max().item() <= tol


_TWO_RANKS = r"""
import sys
import torch
rank, port, tmp, root = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
sys.path.insert(0, root)
from vub_image_denoising_tpu_torch import enable_strict_precision
from vub_image_denoising_tpu_torch.models import RDUNet
from vub_image_denoising_tpu_torch.ops import fused_block as fb
from vub_image_denoising_tpu_torch.parallel import mesh as pm
from vub_image_denoising_tpu_torch.train import SupervisedTrainer, TrainState


class SGD:
    clip_norm = 1.0

    def build(self, leaves):
        opt = torch.optim.SGD(list(leaves), lr=1e-2)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda k: 1.0)


enable_strict_precision()
pm.init_distributed("gloo", f"tcp://127.0.0.1:{port}", 2, rank)
inp = torch.load(f"{tmp}/inputs.pt")
model = RDUNet(3, 32)
model.load_state_dict(inp["sd"])
trainer = SupervisedTrainer(model, accumulation_steps=2, param_sharding=sys.argv[5])
state = trainer.init(steps_per_epoch=1)
sgd = TrainState.create(state.params, SGD(), state.parallel)
rows = (lambda t: t) if sys.argv[5] == "tp" else (lambda t: pm.shard_batch(t, trainer.mesh))
before = fb.fused_denoising_block.launches
_, loss = trainer._step(sgd, rows(inp["x"]).cuda(), rows(inp["y"]).cuda())
loss = trainer.global_mean(loss)
torch.cuda.synchronize()
torch.save({"loss": float(loss), "launches": fb.fused_denoising_block.launches - before,
            "copies": pm.host_copies(), "params": {k: v.cpu() for k, v in model.state_dict().items()}},
           f"{tmp}/rank{rank}.pt")
pm.barrier()
"""


@pytest.mark.parametrize("param_sharding", ["replicated", "fsdp", "tp"])
def test_cuda_two_gloo_ranks_share_the_card(cuda, tmp_path, param_sharding):
    """Two ranks on cuda:0 over gloo (whose collectives take the counted host
    copy): an accumulate -> clip 1.0 -> SGD(1e-2) step of RDUNet-32 on 4 x
    32^2, accumulation 2, under each param sharding; each rank launches
    kernel 1 14 times per micro-batch and ends with the one-process loss
    (rtol 1e-5) and params (rtol 1e-4, atol 1e-6)."""
    import os
    import socket
    import subprocess
    import sys

    from vub_image_denoising_tpu_torch.train import SupervisedTrainer, TrainState

    class SGD:
        clip_norm = 1.0

        def build(self, leaves):
            opt = torch.optim.SGD(list(leaves), lr=1e-2)
            return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda k: 1.0)

    gen = torch.Generator().manual_seed(5)
    inp = {"sd": RDUNet(3, 32, generator=gen).state_dict(),
           "x": torch.rand(4, 3, 32, 32, generator=gen) * 2 - 1,
           "y": torch.rand(4, 3, 32, 32, generator=gen) * 2 - 1}
    torch.save(inp, tmp_path / "inputs.pt")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_RANKS, str(r), port, str(tmp_path),
                               root, param_sharding], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    model = RDUNet(3, 32)
    model.load_state_dict(inp["sd"])
    trainer = SupervisedTrainer(model, accumulation_steps=2)
    state = trainer.init(steps_per_epoch=1)
    _, loss = trainer._step(TrainState.create(state.params, SGD()), trainer.put(inp["x"]),
                            trainer.put(inp["y"]))
    want = {k: v.cpu() for k, v in model.state_dict().items()}
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert got["launches"] == 28 and got["copies"] > 0
        assert got["loss"] == pytest.approx(float(loss), rel=1e-5)
        for k, v in want.items():
            torch.testing.assert_close(got["params"][k], v, rtol=1e-4, atol=1e-6, msg=k)
