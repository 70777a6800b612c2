#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end, and check it.

Run from the root of a checkout:  python3 chip_smoke.py [--profile]

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the five DenoisingBlock libraries from ``csrc/`` with nvcc, in
   parallel: kernel 1 on the CUDA cores (NHWC, f32 and bf16 at c = 16, 48,
   ...), kernel 1 on the tensor cores (bf16, and f32 as 3xTF32,
   ``fused_block_tc.cu``), kernel 2 (2x2 even-packed) on the tensor cores
   (``fused_block_packed_tc.cu``, the same body as kernel 1's) and on the
   CUDA cores, and the wide form of both above width 256
   (``fused_block_wide_tc.cu``); prints each nvcc time and each kernel's
   ptxas registers and spills, by library.  Meanwhile one thread makes the
   synthetic images of steps 23, 26 and 27 and another runs step 9's plain
   sampler on the CPU.
3. Holds kernel 1 against its plain PyTorch version on the card at every
   block shape of an RDUNet-32 forward on 8 x 256^2 images, at the four
   micro-batch-2 shapes of a train step, on a ragged shape and on a constant
   input (border case), in f32 (to F32_TOL, TF32 off in the plain version)
   and bf16; each launch at these widths must be a tensor-core launch.  The
   CUDA-core kernel is held on the same inputs in both dtypes too, since it
   serves them at other widths.  Times both kernels in both dtypes at the
   batch-8 and micro-batch shapes beside each shape's bound, tile and thread
   blocks, and sweeps the tensor-core tiles at the micro-batch shapes.
   The same checks and times at the four batch-16 shapes of the diffusion
   sampler's 2N stack (step 9).
4. Holds kernel 2 against its plain version at the packed shapes of the
   RDUNet-32 blocks at c <= 128, a ragged and a border case, f32 and bf16;
   each launch must be a tensor-core launch, and its output, unpacked, must
   equal kernel 1's on the same image bit for bit (its contract).  Times it
   at the slice shapes beside kernel 1, the CUDA-core kernel 2 (held on the
   same inputs too), the plain version and the bound.
5. Serves a random-weight RDUNet-32 (seeded, saved as a reference-layout
   .pth) through the port's BatchingDenoiseService over HTTP, in bf16 and in
   f32: 8 concurrent raw 256x256x3 requests, one PNG request and /healthz
   each.  Checks the responses, that every dispatched batch launched the
   kernel 14 times, all on the tensor cores, and that the served f32 output
   matches the plain-version forward on the CPU.
6. Times each block shape (kernel, plain version, bound) and the forward.
7. The differentiable block: ``fused_block_trainable`` through kernel 1 and
   kernel 2 at two RDUNet-32 block shapes, f32: loss and every gradient
   against autograd through the eager block, one launch per forward, on the
   tensor cores, none in the backward.
8. Trains: ``SupervisedTrainer(engine="pallas")`` on RDUNet-32, 8 x 3 x 256^2
   super-batches, accumulation 4, AdamW + StepLR + clip 1.0, 3 steps in f32
   and in bf16: 56 kernel launches per step, all 56 on the tensor cores in
   both dtypes, finite losses, and one f32 step
   against the same step on ``engine="xla"`` (see ``compare_with_xla``).
   Times a step on each engine
   and splits a "pallas" step into forward blocks, glue, backward recompute,
   the rest of the backward, and the optimizer; the glue with the kernel
   weights built once per step, as the step builds them, and by every
   launch.
9. Serves a random-weight RDUNetT-32 (seeded, saved with ``unet.`` keys)
   with ``arch="diffusion"`` and T = 20 the same way, bf16 and f32: every
   dispatched batch launches kernel 1 14*T times, all on the tensor cores;
   the served f32 output matches the same sampler through the plain version
   on the CPU (to SERVED_SAMPLER_F32_TOL), bf16 matches f32.  Times the
   sampler per batch of 8, one RDUNetT forward at batch 16 (the 2N stack),
   the sampler's host share (1 - T * forward(16) / sampler), the served
   latency, and the sampler on the "pallas" engine with its kernel weights
   packed once and by every forward.
10. Trains: ``DiffusionTrainer(engine="pallas")`` on RDUNetT-32, 8 x 3 x
   256^2 super-batches, accumulation 4, AdamW + StepLR + clip 0.1, 3 steps
   in f32 and in bf16: 56 kernel launches per step, all on the tensor cores,
   finite losses, one f32 SGD step against ``engine="xla"`` with the same
   timesteps, and one ``validate`` (a full sampler pass).  Times a step on
   each engine.
11. Trains from a folder through the command line: writes a synthetic
   DIV2K-style folder (8 RGB PNGs of 768x512: 48 patches of 256^2, 144
   samples) and a SIDD tree of 4 pairs, then runs
   ``train.diffusion.main`` on RDUNetT-32, batch 8, engine "pallas", f32,
   default augmentation, 2 epochs: the epoch and final checkpoints load
   strict, kernel 1 launches 56 x steps + 280 x epochs times, all on the
   tensor cores, losses are finite and the native gather ran.  A second run
   resumes from the epoch-1 checkpoint through ``train(args, loaders)``, the
   loaders' ``.epoch`` set to 1 (the CLI, like JAX's, leaves it at 0); its
   final params are held to the
   straight run's (STEP_RTOL / STEP_ATOL; both runs take cuDNN's
   deterministic algorithms, whose default weight gradients are not
   deterministic).  One epoch each with ``--device-data`` and with
   ``--dataset_choice SIDD``.  Times the host loader and the device bank
   per batch, a "pallas" f32 epoch fed by each (against phase 10's step)
   and the card's idle share over such an epoch.
12. Evaluates on SIDD through the command line: writes a synthetic
   validation pair in the SIDD files' layout and keys ((20, 32, 256, 256,
   3) uint8 blocks, half the real file's 40 images; smooth fields plus
   noise) and a (2, 8, 256, 256, 3)
   benchmark file, then runs ``sidd_cli validate`` on a random-weight
   RDUNetT-32 with the CLI's defaults (10% of the blocks, batch 8, seed 0,
   T = 20) in f32 (``--engine auto``) and in bf16, and ``sidd_cli
   benchmark --bf16 --fused``: kernel 1 launches 14*T times per sampler
   call, all on the tensor cores; the metric vectors of the run's outputs
   on the card equal the CPU's with TF32 off and on; the CSVs have the JAX
   package's layout; bf16's average PSNR is within EVAL_BF16_PSNR_GAP of
   f32's.  Prints the time per block (wall, device) and the host share
   beside step 9's sampler, and runs the device health probe.
13. Kernel 1 above width 256: holds the wide form
   (``csrc/fused_block_wide_tc.cu``) against the plain block at
   RDUNet(128)'s c = 512 and 1024 shapes on a 256^2 image, at batch 4 and
   on a ragged image, f32 (F32_TOL) and bf16, each launch counted once as
   a tensor-core block of the wide form, timed beside the plain cuDNN block
   (TF32 off) and the bound; kernel 2's wide form against its plain
   version and, unpacked, kernel 1 bit for bit.  Runs
   ``utils.info.print_info`` in f32 and in bf16 (RDUNet(128) and the T = 20
   sampler, FLOPs, peak memory, latency): 3234 kernel-1 launches each, all
   on the tensor cores, 66 through the wide form; and the f32 RDUNet(128)
   forward on a 256^2 image against the CPU's (SERVED_F32_TOL).
14. Trains ``rdunet_supervised_main``'s trainer (RDUNet(128), f32, engine
   "flax", AdamW, accumulation 4) on batches of 4 x 256^2: 3 steps of 56
   launches (24 wide), all on the tensor cores, finite losses, params that
   move; one SGD step against the "xla" engine's; the step's ms.
15. Trains the GAN family at full width on grayscale 256^2 pairs, batch 8,
   3 rounds each through its trainer's ``fit``: the RCA-GAN (critic fc1
   262,144 -> 1024), the attention-U-Net GAN and the diffusion-GAN hybrid
   (``rca_gan_diffusion_trainer``): finite losses, params that move, a
   checkpoint read back equal, ms per round.  One round of each at 2 x 64^2
   on the card equals the CPU's in f64 (losses GAN_RTOL, clipped gradients
   GAN_RTOL / GAN_ATOL_OF_MAX * max|g|; TF32 off, cuDNN deterministic); in
   f32 both devices' rounds stay within GAN_F32_LOSS_RTOL and
   GAN_F32_GRAD_OF_LEAF / GAN_F32_GRAD_FLOOR of that f64 round.

16. Kernel 1's wide form at every width above 256 (PARTIAL_SHAPES): a
   partial last chunk of output channels and a partial last K slab, at
   RDUNet(152)'s 304, 608 and 1216 on a 128^2 image, 320, 352, a ragged
   image, and 258 and 260 (channels no multiple of 16 bytes: element-wise
   loads), f32 and bf16, held and timed as in step 13; kernel 2's wide form
   unpacked equal to kernel 1 at c = 608; the f32 RDUNet(152) forward
   against the CPU's (SERVED_F32_TOL), 10 blocks wide, 4 on the CUDA cores
   (c = 152).
17. The search space's widths at batch 8 (SEARCH_SHAPES: c = 16, 48, 96
   and 192 on the CUDA cores, 384 on the wide form), f32 and bf16, held
   against the plain block and timed beside cuDNN (TF32 off) and the bound.
18. Module-level remat: ``DiffusionTrainer(engine="flax", remat=...)`` on
   RDUNetT-32, 8 x 256^2, acc 4, f32, 2 steps per mode: kernel-1 launches
   56 / 112 / 88 per step (False, True, "highres"), all on the tensor
   cores, finite losses, peak memory and step ms; one SGD step under each
   mode equal to remat=False's (STEP_RTOL / STEP_ATOL).
19. The searches on the card: ``run_search`` (3 trials x 1 epoch) on
   loaders from step 11's folder, ``objective`` on two fixed trials (base
   16 and 48 at T = 10: every width from 16 to 384), ``run_gan_search`` (2
   trials x 1 epoch) on grayscale 256^2 pairs: the trial CSVs' column
   order, finite values, kernel-1 launches per trial by variant, seconds
   per trial.
20. The comparative runner's metric loop (``eval.compare.evaluate_models``)
   on seeded RDUNet(128) and RDUNetT-32 checkpoints at T = 20, LPIPS and
   DISTS on seeded weights: 2 batches of 8 x 256^2, timed, 14 + 14*T
   launches per batch; one batch of 2 x 128^2 with BM3D on the card and on
   the CPU, the metric tables within COMPARE_PSNR_TOL / COMPARE_TOL.

21. Export (``eval/export.py``): RDUNet-32 in f32 and bf16 and the
   sampler of RDUNetT-32 at 256^2, cut to T = EXPORT_TIMESTEPS = 4, from
   seeded weights: 14, 14 and 56 kernel-1 operator nodes in the programs;
   each artifact saved, then loaded and called in a fresh process
   (``--export-worker``) at batch 8 and 3: 14 / 56 launches per call, all
   on the tensor cores, outputs held to the module path on the card
   (SERVED_F32_TOL, the sampler 2 * 4 * SERVED_F32_TOL, bf16 BF16_REL_TOL *
   max|y|), times beside it.
22. Two ranks on the one card (``--multirank-worker``, gloo: NCCL refuses
   two ranks on one GPU): the supervised and diffusion "flax" SGD steps of
   RDUNet(T)-32, 8 x 256^2, acc 4, f32, under replicated, fsdp and tp
   against one process (STEP_RTOL / STEP_ATOL; sharded fraction > 0.5 for
   fsdp and tp), ``--tile-parallel`` on 2048^2 (rtol 1e-4, atol 1e-5),
   ``--tensor-parallel`` and the pipelined T = 20 sampler at S = 2,
   microbatch 2 (1e-4), ``all_processes_mean``; kernel-1 launches and
   times per rank beside one process's (two ranks share one card: no
   speedup); spatially partitioned training (``batch_sharding="spatial"``):
   two "flax" SGD steps of RDUNet-32, f32, acc 1, on one 2048^2 image split
   in two bands of 1024 rows, the first held against one process's
   (STEP_RTOL / STEP_ATOL), 14 kernel-1 launches a step on each rank, all
   on the tensor cores, no block input that is not channels_last; per step
   and rank the gloo host copies, ms and peak memory beside one process's;
   the same for ``DiffusionTrainer(batch_sharding="spatial")`` on
   RDUNetT-32 with loss weights (0, 1, 0.3) (the SSIM window's own halo) and
   one process's timesteps, then one banded ``validate`` on 1 x 512^2 at
   T = 20: 280 launches a rank, the gathered output within
   SERVED_SAMPLER_F32_TOL of one process's; then one nccl rank through
   ``denoise_cli --tensor-parallel`` with torchrun's environment.

23. The accuracy protocol (``scripts/train_accuracy.py``), cut: RDUNet-32
   supervised at 256^2, bf16, engine "flax", 64 train and 16 held-out
   synthetic images, batch 32 (acc 4), 8 epochs from the device bank, lr
   3e-4: the loss falls and the held-out PSNR ends above the noisy
   input's; 56 kernel-1 launches per step and 14 per evaluation, all on the
   tensor cores; the same run as 4 epochs + 4 resumed from its mid_
   checkpoint equals the straight run's final params (STEP_RTOL /
   STEP_ATOL; cuDNN deterministic); the final checkpoint scored in f32 on
   the card and on the CPU within PROTOCOL_PSNR_TOL per image; a cut
   diffusion run (2 epochs) evaluated through the T = 20 sampler (280
   launches per sampler call).
24. The GAN protocol: ``train_gan_accuracy --algo attention`` at its recorded
   settings (40 epochs of 16 steps, 64^2, batch 16; cuDNN, no kernel of
   ours): best and final held-out PSNR, seconds; the best above the noisy
   input's.
25. ``run_comparative_suite`` on step 23's two checkpoints (3 images of
   64^2, BM3D) on the card and on the CPU: the metric tables within
   COMPARE_PSNR_TOL / COMPARE_TOL, 14 + 14*T launches on the card; then an
   "xla" supervised step of RDUNet-32, 8 x 256^2, acc 4, under each
   ``fused_apply`` switch (``VUB_PRECOMBINE_MIN_C``, ``VUB_BWD_PRECOMBINE``,
   ``VUB_DOWN_MATMUL_BWD``) beside all off, each in a fresh process
   (``--switch-worker``; the switches are read at import): f32 and bf16 step
   times, params after one f32 SGD step within STEP_RTOL / STEP_ATOL of
   the off step's.  The four workers start together and warm up; each then
   waits at a gate until the one before it has finished, so no two time or
   step at once.
26. The runner scripts in this process: ``scripts/measure_sidd_eval.py
   --scenes 1 --engines flax,pallas`` (RDUNetT-32, bf16, T = 20, 24 blocks
   of 256^2; the engines within 0.05 dB) and ``scripts/run_search.py
   --trials 2 --epochs 1 --size 64``: exit 0, finite PSNR/SSIM and trial
   values, kernel-1 launches all on the tensor cores; then the protocol's
   tooling: ``run_diffusion_gap --dry-run`` (the eight stage-1 commands),
   ``run_diffusion_gap_stage2 --dry-run`` on a synthetic stage-1 log (the
   composed winner's command), ``regen_artifacts --check``, and the
   ``gap-ssim`` configuration through ``run_diffusion_gap --only gap-ssim``,
   cut to 2 epochs of 128 images and 8 held-out ones: exit 0, a finite
   PSNR, 56 launches a step and 280 per sampler call.
27. The flagship protocol: ``train_accuracy`` with the flags of
   ``regen_artifacts``' ``flagship`` entry (RDUNet(3, 128), batch 8 of
   256^2, acc 4, bf16, engine "flax", ``--remat false --device-data``), cut
   in data and epochs only (32 train and 8 held-out images, 3 epochs of 4
   steps): finite losses that fall; 56 kernel-1 launches a step, 24 of them
   on the wide form (c = 512, 1024), and 14 an evaluation (6 wide), all on
   the tensor cores; the run as 2 epochs + 1 resumed from its mid_
   checkpoint equals the straight run's final params (STEP_RTOL /
   STEP_ATOL; cuDNN deterministic); then the bf16 step timed (the first
   steps excluded) with its peak memory.

Prints one JSON line of kernel numbers, then, as the last line,
{"ok": true, "device": {...}}.  Exits non-zero, without that line, on any
failure, and when CUDA or the port's package is missing.

With ``--profile`` it runs steps 1, 2 and then only ``profile_main``: the
train phase's step, "pallas" and "xla", bf16 and f32, and one served batch
of the diffusion sampler in each dtype, timed and traced with
torch.profiler in a fresh process (device-busy time, idle share, the top
kernels), ending with one JSON line of those numbers.
"""

import concurrent.futures
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = "vub_image_denoising_tpu_torch/csrc/"

# Block shapes (N, C, H, W) of one RDUNet-32 forward at batch 8, 256^2, and how
# many of the 14 DenoisingBlocks run at each.
SLICE_SHAPES = [((8, 32, 256, 256), 4), ((8, 64, 128, 128), 4),
                ((8, 128, 64, 64), 4), ((8, 256, 32, 32), 2)]
# The same blocks at micro-batch 2: a train step on 8 x 256^2 with accumulation 4.
MB2_SHAPES = [((2, 32, 256, 256), 4), ((2, 64, 128, 128), 4),
              ((2, 128, 64, 64), 4), ((2, 256, 32, 32), 2)]
# The diffusion sampler: each of its T steps runs RDUNetT-32 on the 2N stack,
# so a served batch of 8 runs these blocks at batch 16.
TIMESTEPS = 20
B16_SHAPES = [((16, 32, 256, 256), 4), ((16, 64, 128, 128), 4),
              ((16, 128, 64, 64), 4), ((16, 256, 32, 32), 2)]
RAGGED_SHAPE = (2, 64, 37, 45)
BORDER_SHAPE = (1, 32, 24, 24)
# Kernel 2: the unpacked shapes of the RDUNet-32 blocks at c <= 128 (packed:
# (8, 128, 128, 128), (8, 256, 64, 64), (8, 512, 32, 32)), a ragged one with
# even sides, and the border case.
PACKED_SHAPES = [((8, 32, 256, 256), 4), ((8, 64, 128, 128), 4), ((8, 128, 64, 64), 4)]
PACKED_RAGGED_SHAPE = (2, 64, 38, 46)
TRAINABLE_SHAPES = [(8, 32, 256, 256), (8, 64, 128, 128)]
GRAD_RTOL, GRAD_ATOL, LOSS_RTOL = 1e-4, 1e-5, 1e-5
# Training: RDUNet-32 on 256^2 patches (data/datasets.py:26), super-batch 8
# (train/presets.py:39), accumulation 4 (train/supervised.py:113), sigma 25.
TRAIN_BATCH, ACCUMULATION, TRAIN_STEPS = 8, 4, 3
SIGMA = 25 / 127.5
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6  # "pallas" vs "xla" params after one f32 step
F32_TOL = 1e-4          # atol and rtol: summation order (and 3xTF32 splits) differ
BF16_REL_TOL = 2e-2     # max |kernel_bf16 - plain_f32| <= this * max |plain_f32|
SERVED_F32_TOL = 2e-4   # served f32 forward vs the plain forward on the CPU
SERVED_BF16_REL_TOL = 5e-2  # served bf16 vs served f32, relative to max |y_f32|
# The served f32 sampler vs the plain sampler on the CPU: its output sums
# (1 - alpha)-weighted differences of 2T forwards, each held to SERVED_F32_TOL.
SERVED_SAMPLER_F32_TOL = 2 * TIMESTEPS * SERVED_F32_TOL
# H100 SXM dense peaks: bf16 and TF32 on the tensor cores, f32 FMA on the CUDA cores
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 494.7e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
BASE_FILTERS = 32
IMAGE_SIZE = 256


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def block_params(torch, c, seed, device):
    from vub_image_denoising_tpu_torch.nn.blocks import DenoisingBlock

    block = DenoisingBlock(c, c // 2, c, generator=torch.Generator().manual_seed(seed))
    return {k: v.detach().to(device) for k, v in block.named_parameters()}


def bound_ms(shape, dtype_name, itemsize, variant="tc"):
    """(least ms, "operations" or "bytes") of one block at ``shape``: x and y
    and the weights moved once, against the products at the route's peak.
    bf16 at the bf16 peak; f32 on the tensor cores as 3xTF32, three TF32
    products per multiply-add; f32 on the CUDA cores (``variant
    "cuda_core"``) at the f32 FMA peak."""
    from vub_image_denoising_tpu_torch.ops.fused_block import block_flops, block_weight_count

    n, c, h, w = shape
    inner = c // 2
    weights = block_weight_count(c, inner)
    nbytes = 2 * n * c * h * w * itemsize + weights * itemsize + 4 * 2 * (3 * inner + c)
    flops = block_flops(n, c, h, w)
    if dtype_name == "float32" and variant == "tc":
        t_ops = 3 * flops / PEAK_FLOPS["tf32"]
    else:
        t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def tile_report(shape, dtype, packed=False):
    """The kernel variant and tile a launch at the image shape ``shape``
    takes on this card (kernel 2's with ``packed``, from the even-packed
    input's shape), its grid size and the work it does per useful FLOP
    (every tile recomputes its halo)."""
    from vub_image_denoising_tpu_torch.ops.fused_block import (block_tile, block_weight_count,
                                                               packed_block_tile, sm_count,
                                                               tile_macs)

    n, c, h, w = shape
    if packed:
        variant, th, tw, _ = packed_block_tile(dtype, n, 4 * c, h // 2, w // 2, sm_count("cuda"))
    else:
        variant, th, tw, _ = block_tile(dtype, n, c, h, w, sm_count("cuda"))
    blocks = n * -(-h // th) * -(-w // tw)
    work = tile_macs(c, th, tw) / (block_weight_count(c, c // 2) * th * tw)
    return f"{variant} tile {th}x{tw}, {blocks} thread blocks, x{work:.2f} work"


def held(torch, plain, y, x, ref32):
    """Holds a kernel's output y on x against its plain version ``plain``
    (a function of x): f32 to F32_TOL, bf16 to BF16_REL_TOL * max|y| of the
    plain f32 result.  Returns (max error vs plain at x's dtype, vs the
    reference, ok, tol); ok also needs y finite."""
    err_same = (y.float() - plain(x).float()).abs().max().item()
    finite = bool(torch.isfinite(y.float()).all())
    if x.dtype == torch.float32:
        ok = torch.allclose(y, ref32, atol=F32_TOL, rtol=F32_TOL)
        return err_same, err_same, ok and finite, f"atol=rtol={F32_TOL}"
    scale = ref32.abs().max().item()
    err_ref = (y.float() - plain(x.float())).abs().max().item()
    return (err_same, err_ref, err_ref <= BF16_REL_TOL * scale and finite,
            f"<= {BF16_REL_TOL}*max|y| = {BF16_REL_TOL * scale:.4g} vs plain f32")


def check_kernel(torch, device):
    """Kernel 1 vs its plain version at every shape (batch 8, micro-batch 2,
    the sampler's batch 16, ragged, border); returns per-shape records.
    Each launch at c in TC_WIDTHS, f32 or bf16, must go to the tensor-core
    variant; the CUDA-core kernel is also held, and timed, on the same
    inputs, and the wide form timed beside them (``wide_ms``)."""
    from vub_image_denoising_tpu_torch.ops import fused_block as fb

    records = []
    cases = ([(s, "slice") for s, _ in SLICE_SHAPES] + [(s, "microbatch") for s, _ in MB2_SHAPES]
             + [(s, "sampler") for s, _ in B16_SHAPES]
             + [(RAGGED_SHAPE, "ragged"), (BORDER_SHAPE, "border")])
    for shape, kind in cases:
        n, c, h, w = shape
        params = block_params(torch, c, seed=c, device=device)
        gen = torch.Generator(device=device).manual_seed(1)
        x32 = (torch.ones(shape, device=device) if kind == "border"
               else torch.randn(shape, generator=gen, device=device))
        ref32 = fb.fused_denoising_block_plain(x32, params)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x = x32.to(dtype).contiguous(memory_format=torch.channels_last)
            packed = fb.pack_block_params(params, dtype, device)
            tc_before = fb.fused_denoising_block.tc_launches
            y = fb.fused_denoising_block(x, params, packed)
            torch.cuda.synchronize()
            variant = "tc" if fb.fused_denoising_block.tc_launches > tc_before else "cuda_core"
            if variant != fb.block_variant(dtype, c):
                fail(f"{shape} {name} launched the {variant} variant")
            plain = lambda v: fb.fused_denoising_block_plain(v, params)
            err_same, err_ref, ok, tol = held(torch, plain, y, x, ref32)
            print(f"check {kind} {shape} {name} ({variant}): max_abs_err vs plain({name}) "
                  f"{err_same:.3e}, vs reference {err_ref:.3e} ({tol}) -> "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"kernel disagrees with its plain version at {shape} {name}")
            rec = {"shape": shape, "kind": kind, "dtype": name, "variant": variant,
                   "max_abs_err": err_same}
            if variant == "tc":  # the CUDA-core kernel on the same inputs, not counted
                cuda_core = lambda: fb._launch("fused_denoising_block", fb._library(),
                                               "fused_block", x, packed, n, h, w, c, c // 2)
                y_cc = cuda_core()
                torch.cuda.synchronize()
                rec["cuda_core_max_abs_err"], err_ref, ok, tol = held(torch, plain, y_cc, x,
                                                                      ref32)
                print(f"check {kind} {shape} {name} (cuda_core): max_abs_err vs plain({name}) "
                      f"{rec['cuda_core_max_abs_err']:.3e}, vs reference {err_ref:.3e} ({tol}) "
                      f"-> {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"the CUDA-core kernel disagrees with its plain version at {shape} "
                         f"{name}")
            if kind in ("slice", "microbatch", "sampler"):
                iters = 5 if c == 32 and variant == "cuda_core" else 10
                rec["ms"] = cuda_ms(torch, lambda: fb.fused_denoising_block(x, params, packed),
                                    iters)
                rec["plain_ms"] = cuda_ms(torch, lambda: fb.fused_denoising_block_plain(x, params),
                                          iters)
                rec["bound_ms"], rec["bound_by"] = bound_ms(shape, name, x.element_size(), variant)
                rec["tile"] = tile_report(shape, dtype)
                extra = ""
                if variant == "tc":
                    rec["cuda_core_ms"] = cuda_ms(torch, cuda_core, 5 if c == 32 else 3)
                    rec["wide_ms"] = cuda_ms(torch, lambda: fb._launch_wide(
                        "fused_denoising_block", x, packed, n, h, w, c, c // 2,
                        fb.wide_smem_bytes(x.element_size())), 10)
                    extra = (f", CUDA-core kernel {rec['cuda_core_ms']:.4f} ms, wide form "
                             f"{rec['wide_ms']:.4f} ms")
                    if dtype == torch.float32:
                        rec["cuda_core_bound_ms"] = bound_ms(shape, name, 4, "cuda_core")[0]
                        extra += f" (bound {rec['cuda_core_bound_ms']:.4f} ms at the f32 FMA peak)"
                    if kind == "microbatch":
                        rec["tile_sweep_ms"] = tile_sweep(torch, fb, x, packed)
                print(f"time {kind} {shape} {name}: kernel {rec['ms']:.4f} ms, plain "
                      f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                      f"({rec['bound_by']}), {block_flops_tflops(shape, rec['ms']):.2f} TFLOP/s"
                      f"{extra}; {rec['tile']}", flush=True)
            records.append(rec)
    return records


def tile_sweep(torch, fb, x, packed):
    """The tensor-core kernel forced to each tile it is built for at x's
    width: checks pick_tile_tc's choice against the alternatives."""
    n, c, h, w = x.shape
    e = x.element_size()
    out = {}
    for th, tw in fb.tc_tiles(c, e):
        tile = (th, tw, fb.tc_smem_bytes(c, th, tw, e))
        out[f"{th}x{tw}"] = cuda_ms(torch, lambda: fb._launch(
            "fused_denoising_block", fb._tc_library(), "fused_block_tc", x, packed,
            n, h, w, c, c // 2, tile), 10)
    picked = fb.pick_tile_tc(n, c, h, w, fb.sm_count(x.device), e)
    print(f"tile sweep {tuple(x.shape)} {str(x.dtype).split('.')[-1]} (picked {picked}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items()), flush=True)
    return out


def block_flops_tflops(shape, ms):
    from vub_image_denoising_tpu_torch.ops.fused_block import block_flops

    return block_flops(shape[0], shape[1], shape[2], shape[3]) / (ms * 1e-3) / 1e12


def http(url, data=None, headers=None):
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method="POST" if data is not None else "GET")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, dict(r.headers), r.read()


def start_server(ck, bf16, arch):
    from vub_image_denoising_tpu_torch.eval.denoise_cli import build_denoiser
    from vub_image_denoising_tpu_torch.eval.serve import (BatchingDenoiseService,
                                                          device_name, make_server)

    denoise_fn = build_denoiser(ck, arch, BASE_FILTERS, TIMESTEPS, bf16=bf16, batched=True)
    service = BatchingDenoiseService(denoise_fn, max_batch=8)
    service.prewarm((IMAGE_SIZE, IMAGE_SIZE, 3))
    info = {"arch": arch, "base_filters": BASE_FILTERS, "bf16": bf16, "max_batch": 8,
            "devices": [device_name("cuda")]}
    server = make_server(service, info, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, service, denoise_fn, f"http://127.0.0.1:{server.server_address[1]}"


def drive(base, images):
    """8 concurrent raw requests, one PNG request (of the first image),
    /healthz.  Returns the raw responses, the PNG response, /healthz, and
    each request's latency on the client, ms."""
    import numpy as np
    from PIL import Image

    results, errors, latency_ms = [None] * len(images), [], []

    def fire(i):
        try:
            shape = images[i].shape
            t0 = time.perf_counter()
            status, hdr, body = http(f"{base}/denoise", images[i].tobytes(), {
                "Content-Type": "application/octet-stream",
                "X-Shape": ",".join(map(str, shape)), "Accept": "application/octet-stream"})
            if (status != 200 or hdr.get("X-Shape") != ",".join(map(str, shape))
                    or len(body) != images[i].size):
                raise ValueError(f"bad raw response {status} {hdr.get('X-Shape')} {len(body)}")
            latency_ms.append((time.perf_counter() - t0) * 1e3)
            results[i] = np.frombuffer(body, np.uint8).reshape(shape)
        except Exception as e:  # noqa: BLE001 — reported below, fails the run
            errors.append(repr(e))

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(len(images))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        fail(f"raw requests failed: {errors}")
    buf = io.BytesIO()
    Image.fromarray(images[0]).save(buf, format="PNG")
    t0 = time.perf_counter()
    status, hdr, body = http(f"{base}/denoise", buf.getvalue())
    latency_ms.append((time.perf_counter() - t0) * 1e3)
    png = np.asarray(Image.open(io.BytesIO(body)))
    if status != 200 or hdr.get("Content-Type") != "image/png" or png.shape != images[0].shape:
        fail(f"bad PNG response {status} {hdr.get('Content-Type')} {png.shape}")
    _, _, body = http(f"{base}/healthz")
    return results, png, json.loads(body), latency_ms


def served_images():
    """The 8 raw 256^2 images every served path is driven with."""
    import numpy as np

    rng = np.random.RandomState(0)
    return [rng.randint(0, 256, (IMAGE_SIZE, IMAGE_SIZE, 3), np.uint8) for _ in range(8)]


def serve_main_path(torch, ck, arch="rdunet", sampler_ref=None):
    """Serves ``ck`` in bf16 and f32 and checks it (module docstring, steps 5
    and 9; for ``arch="diffusion"`` ``sampler_ref`` is ``reference_sampler``'s
    output).  Returns the kernel-1 launches of the run, all and tensor-core,
    and the client latencies, per dtype."""
    import numpy as np

    from vub_image_denoising_tpu_torch.ops.fused_block import fused_denoising_block

    per_batch = 14 * (TIMESTEPS if arch == "diffusion" else 1)
    images = served_images()
    runs = {bf16: start_server(ck, bf16, arch) for bf16 in (True, False)}
    try:
        for _, service, _, _ in runs.values():
            service.reset_stats()
        fused_denoising_block.launches = fused_denoising_block.tc_launches = 0
        outs = {bf16: drive(base, images) for bf16, (_, _, _, base) in runs.items()}
        launches = fused_denoising_block.launches
        tc_launches = fused_denoising_block.tc_launches
        batches = sum(s.stats["batches"] for _, s, _, _ in runs.values())
        latency = {}
        for bf16, (_, _, health, lat) in outs.items():
            b = health["batching"]
            name = "bf16" if bf16 else "f32"
            latency[name] = {"median_ms": float(np.median(lat)), "max_ms": max(lat)}
            print(f"served {arch} {name}: {b}, device {health['devices']}, "
                  f"latency {health['latency']}; on the client median "
                  f"{latency[name]['median_ms']:.2f} ms, max {latency[name]['max_ms']:.2f} ms",
                  flush=True)
            if b["requests"] != 9 or b["rejected"] != 0:
                fail(f"healthz batching counters wrong: {b}")
        print(f"main path ({arch}): {launches} kernel launches for {batches} dispatched batches "
              f"(bf16 {runs[True][1].stats['batches']}, f32 {runs[False][1].stats['batches']}), "
              f"{tc_launches} of them on the tensor cores", flush=True)
        if (launches != per_batch * batches
                or min(s.stats["batches"] for _, s, _, _ in runs.values()) == 0):
            fail(f"expected {per_batch} launches per batch, got {launches} for {batches}")
        if tc_launches != launches:
            fail(f"expected every launch on the tensor cores, got {tc_launches} of {launches}")

        # served outputs vs references, on the same 8 images.  Bytes may differ
        # by 1 level of rounding; the bf16 sampler's output also moves with the
        # batch it ran in (the PNG request runs alone, the raw ones together),
        # by bf16 rounding carried through 2T forwards, so there it is held to
        # the bf16 bound, SERVED_BF16_REL_TOL * max|y_f32|, in levels of 255.
        x = np.stack(images).astype(np.float32) / 255.0 * 2.0 - 1.0
        y32 = runs[False][2](x)
        y16 = runs[True][2](x)
        scale = float(np.abs(y32).max())
        levels = {"f32": 1, "bf16": 1}
        if arch == "diffusion":
            levels["bf16"] = max(1, math.ceil(SERVED_BF16_REL_TOL * scale * 127.5))
        for name, y, (served, png, _, _) in (("f32", y32, outs[False]),
                                             ("bf16", y16, outs[True])):
            q = np.clip((y + 1.0) * 0.5 * 255.0 + 0.5, 0, 255).astype(np.uint8)
            d_png = int(np.abs(png.astype(int) - served[0].astype(int)).max())
            d_served = int(np.abs(q.astype(int) - np.stack(served)).max())
            print(f"served {arch} {name} bytes: PNG vs raw response to the same image, max diff "
                  f"{d_png}; raw responses vs the denoiser's output, max diff {d_served} "
                  f"(tol {levels[name]})", flush=True)
            if d_png > levels[name]:
                fail(f"PNG and raw {name} responses to the same image differ")
            if not np.isfinite(y).all() or d_served > levels[name]:
                fail(f"served {name} bytes do not match the denoiser's output")
        if arch == "diffusion":
            ref, what, tol = sampler_ref, "plain sampler", SERVED_SAMPLER_F32_TOL
        else:
            ref, what, tol = reference_forward(torch, ck, x[:1]), "plain forward", SERVED_F32_TOL
        err32 = float(np.abs(y32[:1] - ref).max())
        err16 = float(np.abs(y16 - y32).max())
        print(f"served f32 vs {what} on the CPU: max_abs_err {err32:.3e} (tol {tol})",
              flush=True)
        print(f"served bf16 vs served f32: max_abs_err {err16:.3e}, mean "
              f"{float(np.abs(y16 - y32).mean()):.3e} (tol {SERVED_BF16_REL_TOL}*{scale:.3f})",
              flush=True)
        if err32 > tol:
            fail(f"served f32 output disagrees with the {what}")
        if err16 > SERVED_BF16_REL_TOL * scale:
            fail("served bf16 output too far from f32")
        return {"all": launches, "tc": tc_launches, "served_f32_max_abs_err": err32,
                "served_bf16_max_abs_err": err16, "latency": latency}
    finally:
        for server, service, _, _ in runs.values():
            server.shutdown()
            server.server_close()
            service.close()


def reference_forward(torch, ck, x):
    """The same checkpoint through the plain version, f32, on the CPU."""
    from vub_image_denoising_tpu_torch.models import RDUNet
    from vub_image_denoising_tpu_torch.utils.checkpoint import load_pth

    model, _ = load_pth(ck, RDUNet(3, BASE_FILTERS))
    with torch.inference_mode():
        y = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).numpy()


def seeded_rdunet_t(torch):
    """The random-weight RDUNetT-32 that step 9 serves."""
    from vub_image_denoising_tpu_torch.models import RDUNetT

    return RDUNetT(BASE_FILTERS, generator=torch.Generator().manual_seed(0))


def reference_sampler(torch, threads):
    """Step 9's check: the served RDUNetT's T-step sampler through the plain
    version, f32, on the CPU, on the first served image, in ``threads``
    threads (it runs while nvcc builds)."""
    import numpy as np

    from vub_image_denoising_tpu_torch.diffusion import InterpolationDiffusion

    torch.set_num_threads(threads)
    x = np.stack(served_images()[:1]).astype(np.float32) / 255.0 * 2.0 - 1.0
    model = seeded_rdunet_t(torch)
    t0 = time.monotonic()
    with torch.inference_mode():
        y = InterpolationDiffusion(TIMESTEPS).improved_sampling(
            model.eval(), torch.from_numpy(x).permute(0, 3, 1, 2))
    print(f"plain sampler on the CPU, {x.shape[0]} image(s), T = {TIMESTEPS}, {threads} "
          f"threads: {time.monotonic() - t0:.1f} s", flush=True)
    return y.permute(0, 2, 3, 1).numpy()


def time_sampler(torch, ck):
    """Per dtype: the served sampler's time per batch of 8 at T = TIMESTEPS,
    one RDUNetT forward at batch 16 (the 2N stack), and the sampler's host
    share 1 - T * forward(16) / sampler."""
    from vub_image_denoising_tpu_torch.eval.denoise_cli import build_apply

    out = {}
    for bf16 in (True, False):
        name, dtype = ("bf16", torch.bfloat16) if bf16 else ("f32", torch.float32)
        forward, model = build_apply(ck, "diffusion", BASE_FILTERS, TIMESTEPS, bf16=bf16)
        device = next(model.parameters()).device
        x = torch.rand(8, IMAGE_SIZE, IMAGE_SIZE, 3, device=device) * 2 - 1
        sampler_ms = cuda_ms(torch, lambda: forward(x), 2)
        x16 = (torch.rand(16, 3, IMAGE_SIZE, IMAGE_SIZE, device=device) * 2 - 1).to(dtype)
        x16 = x16.contiguous(memory_format=torch.channels_last)
        t16 = torch.rand(16, device=device).to(dtype)
        with torch.inference_mode():
            fwd16_ms = cuda_ms(torch, lambda: model(x16, t16), 3)
        out[name] = {"sampler_ms": sampler_ms, "forward16_ms": fwd16_ms,
                     "host_share": 1 - TIMESTEPS * fwd16_ms / sampler_ms,
                     "pallas": time_pallas_sampler(torch, model, x, dtype)}
        print(f"sampler RDUNetT-32 8x256x256 T={TIMESTEPS} {name}: {sampler_ms:.3f} ms per batch; "
              f"forward at batch 16 {fwd16_ms:.3f} ms; host share "
              f"{out[name]['host_share']:.4f}; engine pallas {out[name]['pallas']}", flush=True)
    return out


def time_pallas_sampler(torch, model, x, dtype):
    """The sampler per batch on the "pallas" engine, in turns: its kernel
    weights packed by every forward (``kernel_weights=None``: each block
    launches once per forward, so as many packs as when every launch packed
    its own, before they were shared), once, once, by every forward."""
    from vub_image_denoising_tpu_torch.diffusion import InterpolationDiffusion
    from vub_image_denoising_tpu_torch.models.fused_apply import (block_kernel_weights,
                                                                  prepare_fused_params,
                                                                  rdunet_t_apply_fused)

    params = prepare_fused_params(model.state_dict())
    x = x.permute(0, 3, 1, 2).to(dtype).contiguous(memory_format=torch.channels_last)
    diffusion = InterpolationDiffusion(TIMESTEPS)

    def run(once):
        kw = block_kernel_weights(params, dtype) if once else None
        diffusion.improved_sampling(
            lambda v, t: rdunet_t_apply_fused(params, v, t, engine="pallas", kernel_weights=kw), x)

    with torch.inference_mode():
        times = [cuda_ms(torch, lambda: run(once), 1, warmup=int(i == 0))
                 for i, once in enumerate((False, True, True, False))]
    return {"sampler_ms": min(times[1:3]), "sampler_repacking_ms": min(times[0], times[3])}


def time_forward(torch, ck):
    from vub_image_denoising_tpu_torch.eval.denoise_cli import build_apply

    out = {}
    for bf16 in (True, False):
        forward, _ = build_apply(ck, "rdunet", BASE_FILTERS, bf16=bf16)
        x = torch.rand(8, IMAGE_SIZE, IMAGE_SIZE, 3, device="cuda") * 2 - 1
        out["bf16" if bf16 else "f32"] = ms = cuda_ms(torch, lambda: forward(x), 3)
        print(f"forward RDUNet-32 8x256x256 {'bf16' if bf16 else 'f32'}: {ms:.3f} ms per batch",
              flush=True)
    return out


LIBRARIES = ("fused_block", "fused_block_tc", "fused_block_packed", "fused_block_packed_tc",
             "fused_block_wide_tc")


def build_kernels():
    """Build the kernel libraries at once (one nvcc each) and print each
    nvcc time and each kernel's registers and spills as ptxas reports them.
    Returns {library: {kernel: ptxas numbers}}: the two tensor-core libraries
    hold kernels of one name, told apart by the layout argument."""
    import re

    from vub_image_denoising_tpu_torch.ops import cuda_build
    from vub_image_denoising_tpu_torch.ops import fused_block as fb

    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES)) as pool:
        for fut in [pool.submit(f) for f in (fb._library, fb._tc_library, fb._packed_library,
                                             fb._packed_tc_library, fb._wide_library)]:
            fut.result()
    print(f"build {', '.join(l + '.cu' for l in LIBRARIES)}: {time.monotonic() - t0:.1f} s wall "
          "(nvcc " + ", ".join(f"{l} {cuda_build.build_seconds[l]:.1f} s" for l in LIBRARIES)
          + ")", flush=True)
    ptxas = {}
    for lib in LIBRARIES:
        ptxas[lib] = {}
        for entry, body in re.findall(r"Compiling entry function '([^']+)' for 'sm_90a'\n(.*?)"
                                      r"(?=ptxas info    : Compiling|\Z)",
                                      cuda_build.ptxas_log[lib], re.S):
            kernel = re.search(r"(?<=\d)(fused_block\w*?_kernel)I(.*?)Ev9BlockArgs", entry)
            if kernel:
                args = kernel.group(2)
                args = ",".join(["bf16" if "bfloat16" in args else "f32",
                                 *(n if k == "i" else ("packed" if n == "1" else "nhwc")
                                   for k, n in re.findall(r"L([ib])(\d+)E", args))])
                name = f"{kernel.group(1)}<{args}>"
            else:
                name = entry
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
            ptxas[lib][name] = {"registers": int(regs.group(1)) if regs else None,
                                "spill_stores": int(spill.group(1)) if spill else None,
                                "spill_loads": int(spill.group(2)) if spill else None}
            print(f"ptxas {lib}: {name}: {ptxas[lib][name]}", flush=True)
    return ptxas


def check_packed_kernel(torch, device):
    """Kernel 2 vs its plain version and, unpacked, vs kernel 1 on the same
    image, which it must equal bit for bit; per-shape records.  Each launch
    at c in TC_WIDTHS must go to the tensor-core variant.  At the slice
    shapes it is timed beside kernel 1 and the CUDA-core kernel 2
    (``fused_block_packed.cu``, also held) on the same inputs."""
    from vub_image_denoising_tpu_torch.ops import fused_block as fb
    from vub_image_denoising_tpu_torch.ops.packing import pack2x2, unpack2x2

    records = []
    cases = [(s, "slice") for s, _ in PACKED_SHAPES] + [(PACKED_RAGGED_SHAPE, "ragged"),
                                                         (BORDER_SHAPE, "border")]
    for shape, kind in cases:
        n, c, h, w = shape
        params = block_params(torch, c, seed=c, device=device)
        pq = fb.pack_block_params_packed(params)
        gen = torch.Generator(device=device).manual_seed(1)
        x32 = (torch.ones(shape, device=device) if kind == "border"
               else torch.randn(shape, generator=gen, device=device))
        x32 = x32.contiguous(memory_format=torch.channels_last)
        ref32 = fb.fused_denoising_block_packed_plain(pack2x2(x32), pq)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x = x32.to(dtype)
            xq = pack2x2(x)
            kw = fb.kernel_weights_from_packed(pq, dtype)
            tc_before = fb.fused_denoising_block_packed.tc_launches
            yq = fb.fused_denoising_block_packed(xq, pq, kw)
            torch.cuda.synchronize()
            variant = ("tc" if fb.fused_denoising_block_packed.tc_launches > tc_before
                       else "cuda_core")
            if variant != fb.block_variant(dtype, c):
                fail(f"kernel 2 at {shape} {name} launched the {variant} variant")
            plain = lambda v: fb.fused_denoising_block_packed_plain(v, pq)
            err_same, err_ref, ok, tol = held(torch, plain, yq, xq, ref32)
            kw1 = fb.pack_block_params(params, dtype, device)
            one = fb.fused_denoising_block(x, params, kw1)
            torch.cuda.synchronize()
            diff_one = (unpack2x2(yq).float() - one.float()).abs().max().item()
            same = torch.equal(unpack2x2(yq), one)
            print(f"check packed {kind} {shape} {name} ({variant}): max_abs_err vs plain({name}) "
                  f"{err_same:.3e}, vs reference {err_ref:.3e} ({tol}); unpacked vs kernel 1: "
                  f"max abs diff {diff_one} (must be 0.0) -> "
                  f"{'ok' if ok and same else 'FAIL'}", flush=True)
            if not ok:
                fail(f"kernel 2 disagrees with its plain version at {shape} {name}")
            if not same:
                fail(f"kernel 2, unpacked, differs from kernel 1 at {shape} {name}")
            rec = {"shape": shape, "kind": kind, "dtype": name, "variant": variant,
                   "max_abs_err": err_same, "kernel1_max_abs_diff": diff_one}
            if kind == "slice":
                cuda_core = lambda: fb._launch("fused_denoising_block_packed",
                                               fb._packed_library(), "fused_block_packed",
                                               xq, kw, n, h, w, c, c // 2)
                y_cc = cuda_core()
                torch.cuda.synchronize()
                rec["cuda_core_max_abs_err"], err_ref, ok, tol = held(torch, plain, y_cc, xq,
                                                                      ref32)
                print(f"check packed {kind} {shape} {name} (cuda_core): max_abs_err vs "
                      f"plain({name}) {rec['cuda_core_max_abs_err']:.3e}, vs reference "
                      f"{err_ref:.3e} ({tol}) -> {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"the CUDA-core kernel 2 disagrees with its plain version at {shape} "
                         f"{name}")
                # in turns (kernel 2, kernel 1, kernel 1, kernel 2): neither gains by
                # going first
                k2 = lambda: fb.fused_denoising_block_packed(xq, pq, kw)
                k1 = lambda: fb.fused_denoising_block(x, params, kw1)
                t2a, t1a, t1b, t2b = (cuda_ms(torch, f, 10) for f in (k2, k1, k1, k2))
                rec["ms"], rec["kernel1_ms"] = (t2a + t2b) / 2, (t1a + t1b) / 2
                rec["plain_ms"] = cuda_ms(torch, lambda: plain(xq), 10)
                rec["cuda_core_ms"] = cuda_ms(torch, cuda_core, 3)
                rec["bound_ms"], rec["bound_by"] = bound_ms(shape, name, xq.element_size(),
                                                            variant)
                rec["tile"] = tile_report(shape, dtype, packed=True)
                print(f"time packed {shape} {name}: kernel {rec['ms']:.4f} ms ({variant}), "
                      f"kernel 1 {rec['kernel1_ms']:.4f} ms, CUDA-core kernel 2 "
                      f"{rec['cuda_core_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
                      f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
                      f"{block_flops_tflops(shape, rec['ms']):.2f} TFLOP/s; {rec['tile']}",
                      flush=True)
            records.append(rec)
    return records


def check_trainable(torch, device):
    """fused_block_trainable, both forms, vs autograd through the eager block:
    one tensor-core launch forward, none backward.  Returns the launches of
    each kernel in this run, all and tensor-core (counts reset first)."""
    from vub_image_denoising_tpu_torch.models.fused_apply import (_dense_block_xla,
                                                                  fused_block_trainable)
    from vub_image_denoising_tpu_torch.ops.fused_block import (fused_denoising_block,
                                                               fused_denoising_block_packed)

    for counter in (fused_denoising_block, fused_denoising_block_packed):
        counter.launches = counter.tc_launches = 0
    max_err = 0.0
    for shape in TRAINABLE_SHAPES:
        c = shape[1]
        gen = torch.Generator(device=device).manual_seed(3)
        params = {k: v.clone().requires_grad_()
                  for k, v in block_params(torch, c, seed=c + 1, device=device).items()}
        x = torch.randn(shape, generator=gen, device=device).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        target = torch.randn(shape, generator=gen, device=device)
        want_loss = (_dense_block_xla(params, x) - target).abs().mean()
        want = torch.autograd.grad(want_loss, [x, *params.values()])
        for packed, counter in ((False, fused_denoising_block),
                                (True, fused_denoising_block_packed)):
            before, tc_before = counter.launches, counter.tc_launches
            loss = (fused_block_trainable(x, params, packed=packed) - target).abs().mean()
            fwd, tc_fwd = counter.launches - before, counter.tc_launches - tc_before
            grads = torch.autograd.grad(loss, [x, *params.values()])
            torch.cuda.synchronize()
            bwd = counter.launches - before - fwd
            loss_ok = abs(loss.item() - want_loss.item()) <= LOSS_RTOL * abs(want_loss.item())
            grads_ok = all(torch.allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL)
                           for g, w in zip(grads, want))
            err = max((g - w).abs().max().item() for g, w in zip(grads, want))
            max_err = max(max_err, err)
            print(f"trainable block {shape} packed={packed}: loss {loss.item():.7f} vs "
                  f"{want_loss.item():.7f}, max grad err {err:.3e} (rtol {GRAD_RTOL}, atol "
                  f"{GRAD_ATOL}), launches forward {fwd} ({tc_fwd} on the tensor cores) "
                  f"backward {bwd}", flush=True)
            if not (loss_ok and grads_ok and fwd == 1 and tc_fwd == 1 and bwd == 0):
                fail(f"fused_block_trainable(packed={packed}) at {shape} is wrong")
    return {"fused_denoising_block": fused_denoising_block.launches,
            "fused_denoising_block_packed": {"all": fused_denoising_block_packed.launches,
                                             "tc": fused_denoising_block_packed.tc_launches},
            "max_grad_err": max_err}


def make_trainer(torch, init, engine, dtype):
    from vub_image_denoising_tpu_torch.models import RDUNet
    from vub_image_denoising_tpu_torch.train import SupervisedTrainer

    model = RDUNet(3, BASE_FILTERS)
    model.load_state_dict(init)
    trainer = SupervisedTrainer(model, lr=1e-4, weight_decay=1e-5,
                                accumulation_steps=ACCUMULATION, clip_norm=1.0,
                                compute_dtype=dtype, engine=engine)
    return trainer, trainer.init(steps_per_epoch=TRAIN_STEPS)


def make_batches(torch, device):
    """TRAIN_STEPS synthetic (noisy, clean) super-batches from a seed."""
    gen = torch.Generator(device=device).manual_seed(2)
    batches = []
    for _ in range(TRAIN_STEPS):
        clean = torch.rand(TRAIN_BATCH, 3, IMAGE_SIZE, IMAGE_SIZE, generator=gen,
                           device=device) * 2 - 1
        batches.append((clean + SIGMA * torch.randn(clean.shape, generator=gen, device=device),
                        clean))
    return batches


def train_main_path(torch, device):
    """SupervisedTrainer(engine="pallas") steps in f32 and bf16, checked;
    returns (kernel-1 launches of the run, all and tensor-core, in total and
    per dtype, per-engine step times, breakdowns)."""
    from vub_image_denoising_tpu_torch.models import RDUNet
    from vub_image_denoising_tpu_torch.ops.fused_block import fused_denoising_block

    init = RDUNet(3, BASE_FILTERS, generator=torch.Generator().manual_seed(0)).state_dict()
    batches = make_batches(torch, device)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}

    fused_denoising_block.launches = fused_denoising_block.tc_launches = 0
    after_one, first_loss = None, None
    launches = {}
    for name, dtype in dtypes.items():
        launches[name] = {"all": 0, "tc": 0}
        trainer, state = make_trainer(torch, init, "pallas", dtype)
        for i, (noisy, clean) in enumerate(batches):
            before = fused_denoising_block.launches
            tc_before = fused_denoising_block.tc_launches
            state, loss = trainer.train_step(state, noisy, clean)
            step = fused_denoising_block.launches - before
            tc = fused_denoising_block.tc_launches - tc_before
            launches[name]["all"] += step
            launches[name]["tc"] += tc
            print(f"train pallas {name} step {i}: loss {loss.item():.6f}, {step} kernel "
                  f"launches, {tc} on the tensor cores", flush=True)
            if not bool(torch.isfinite(loss)) or step != 14 * ACCUMULATION or tc != step:
                fail(f"train step {i} ({name}): loss {loss.item()}, {step} launches, "
                     f"{tc} tensor-core launches (want {14 * ACCUMULATION} of each)")
            if name == "f32" and i == 0:
                after_one = {k: v.detach().clone() for k, v in state.params.items()}
                first_loss = loss.item()
    launches.update(all=fused_denoising_block.launches, tc=fused_denoising_block.tc_launches)
    compare_with_xla(torch, init, batches[0], after_one, first_loss)

    step_ms, breakdowns = {}, {}
    for name, dtype in dtypes.items():
        for engine in ("pallas", "xla", "flax"):
            trainer, state = make_trainer(torch, init, engine, dtype)
            ms = cuda_ms(torch, lambda: trainer.train_step(state, *batches[0]), 4, warmup=2)
            step_ms[f"{engine}_{name}"] = ms
            print(f"train step RDUNet-32 {TRAIN_BATCH}x256x256 acc {ACCUMULATION} {engine} "
                  f"{name}: {ms:.2f} ms", flush=True)
            if engine == "pallas":
                breakdowns[name] = step_breakdown(torch, trainer, state, batches[0], ms)
    return launches, step_ms, breakdowns


def compare_with_xla(torch, init, batch, adamw_params, adamw_loss):
    """One f32 step on "pallas" against the same step on "xla" from the same
    weights.  The params are held to the "xla" step's (rtol 1e-4, atol 1e-6)
    after one accumulate -> clip 1.0 -> SGD(1e-2) step, the recipe of
    tests/test_fused_apply.py:108-136.  AdamW's first update is lr * sign(g):
    an element whose gradient is within the engines' f32 rounding of zero may
    move by 2 lr the other way, so for the AdamW step the losses are held
    (rtol 1e-5) and the elements off the tolerance are counted."""
    from vub_image_denoising_tpu_torch.train import TrainState, make_supervised_train_step

    trainer, state = make_trainer(torch, init, "xla", torch.float32)
    _, loss = trainer.train_step(state, *batch)
    off = sum(int(((v - adamw_params[k]).abs() > STEP_ATOL + STEP_RTOL * v.abs()).sum())
              for k, v in state.params.items())
    total = sum(v.numel() for v in state.params.values())
    print(f"AdamW step, pallas vs xla: loss {adamw_loss:.7f} vs {loss.item():.7f}; {off} of "
          f"{total} param elements off rtol {STEP_RTOL} / atol {STEP_ATOL}", flush=True)
    if abs(adamw_loss - loss.item()) > LOSS_RTOL * abs(loss.item()):
        fail("the pallas train step's loss disagrees with the xla step's")

    after = {}
    for engine in ("pallas", "xla"):
        trainer, state = make_trainer(torch, init, engine, torch.float32)
        opt = torch.optim.SGD(list(state.params.values()), lr=1e-2)
        sgd = TrainState(state.params, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda k: 1.0),
                         clip_norm=1.0)
        make_supervised_train_step(trainer.forward_fn, ACCUMULATION)(
            sgd, *(trainer.put(t) for t in batch))
        after[engine] = {k: v.detach() for k, v in state.params.items()}
    worst = max(((v - after["pallas"][k]).abs() / (STEP_ATOL + STEP_RTOL * v.abs())).max().item()
                for k, v in after["xla"].items())
    print(f"SGD step, pallas vs xla params: worst |diff| / (atol {STEP_ATOL} + rtol "
          f"{STEP_RTOL}*|p|) = {worst:.3f} (must be <= 1)", flush=True)
    if worst > 1:
        fail("the pallas train step disagrees with the xla step")


def make_diffusion_trainer(torch, engine, dtype):
    """RDUNetT-32 from seed 0 with the trainer's defaults (AdamW 1e-4, wd
    1e-4, StepLR, clip 0.1); the timesteps' generator is seeded alike."""
    from vub_image_denoising_tpu_torch.train import DiffusionTrainer

    trainer = DiffusionTrainer(base_filters=BASE_FILTERS, timesteps=TIMESTEPS,
                               accumulation_steps=ACCUMULATION, compute_dtype=dtype,
                               engine=engine)
    return trainer, trainer.init(steps_per_epoch=TRAIN_STEPS, seed=0)


def diffusion_train_main_path(torch, device):
    """DiffusionTrainer(engine="pallas") steps in f32 and bf16 and one f32
    validate, checked; returns (kernel-1 launches of the run, all and
    tensor-core, per-engine step times, the validation)."""
    from vub_image_denoising_tpu_torch.ops.fused_block import fused_denoising_block

    batches = make_batches(torch, device)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    fused_denoising_block.launches = fused_denoising_block.tc_launches = 0
    validation = None
    for name, dtype in dtypes.items():
        trainer, state = make_diffusion_trainer(torch, "pallas", dtype)
        for i, (noisy, clean) in enumerate(batches):
            before = fused_denoising_block.launches
            tc_before = fused_denoising_block.tc_launches
            state, loss = trainer.train_step(state, noisy, clean)
            step = fused_denoising_block.launches - before
            tc = fused_denoising_block.tc_launches - tc_before
            print(f"diffusion train pallas {name} step {i}: loss {loss.item():.6f}, {step} "
                  f"kernel launches, {tc} on the tensor cores", flush=True)
            if not bool(torch.isfinite(loss)) or step != 14 * ACCUMULATION or tc != step:
                fail(f"diffusion train step {i} ({name}): loss {loss.item()}, {step} launches, "
                     f"{tc} tensor-core launches (want {14 * ACCUMULATION} of each)")
        if name == "f32":
            before = fused_denoising_block.tc_launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vloss, denoised = trainer.validate(state, [batches[0]])
            torch.cuda.synchronize()
            validation = {"loss": vloss, "ms": (time.perf_counter() - t0) * 1e3,
                          "launches": fused_denoising_block.tc_launches - before}
            print(f"diffusion validate f32 (T={TIMESTEPS} sampler on {TRAIN_BATCH} images): loss "
                  f"{vloss:.6f}, {validation['ms']:.1f} ms, {validation['launches']} tensor-core "
                  "launches", flush=True)
            if (not math.isfinite(vloss) or tuple(denoised.shape) != tuple(batches[0][0].shape)
                    or validation["launches"] != 14 * TIMESTEPS):
                fail(f"diffusion validate: loss {vloss}, shape {tuple(denoised.shape)}, "
                     f"{validation['launches']} launches (want {14 * TIMESTEPS})")
    launches = {"all": fused_denoising_block.launches, "tc": fused_denoising_block.tc_launches}
    compare_diffusion_with_xla(torch, batches[0])

    step_ms = {}
    for name, dtype in dtypes.items():
        for engine in ("pallas", "xla", "flax"):
            trainer, state = make_diffusion_trainer(torch, engine, dtype)
            step_ms[f"{engine}_{name}"] = ms = cuda_ms(
                torch, lambda: trainer.train_step(state, *batches[0]), 4, warmup=2)
            print(f"diffusion train step RDUNetT-32 {TRAIN_BATCH}x256x256 acc {ACCUMULATION} "
                  f"{engine} {name}: {ms:.2f} ms", flush=True)
    return launches, step_ms, validation


def compare_diffusion_with_xla(torch, batch):
    """One f32 diffusion step on "pallas" against the same step on "xla":
    the same weights and the same timesteps (each trainer's generator seeded
    alike), accumulate -> clip 0.1 -> SGD(1e-2); losses to LOSS_RTOL, params
    to STEP_RTOL / STEP_ATOL (see compare_with_xla)."""
    from vub_image_denoising_tpu_torch.train import TrainState, make_diffusion_train_step

    after, losses = {}, {}
    for engine in ("pallas", "xla"):
        trainer, state = make_diffusion_trainer(torch, engine, torch.float32)
        opt = torch.optim.SGD(list(state.params.values()), lr=1e-2)
        sgd = TrainState(state.params, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda k: 1.0),
                         clip_norm=trainer.clip_norm)
        _, loss = make_diffusion_train_step(trainer.unet_apply, trainer.diffusion, ACCUMULATION)(
            sgd, trainer.generator, *(trainer.put(t) for t in batch))
        losses[engine] = loss.item()
        after[engine] = {k: v.detach() for k, v in state.params.items()}
    worst = max(((v - after["pallas"][k]).abs() / (STEP_ATOL + STEP_RTOL * v.abs())).max().item()
                for k, v in after["xla"].items())
    print(f"diffusion SGD step, pallas vs xla: loss {losses['pallas']:.7f} vs "
          f"{losses['xla']:.7f}; params worst |diff| / (atol {STEP_ATOL} + rtol {STEP_RTOL}*|p|) "
          f"= {worst:.3f} (must be <= 1)", flush=True)
    if abs(losses["pallas"] - losses["xla"]) > LOSS_RTOL * abs(losses["xla"]) or worst > 1:
        fail("the pallas diffusion step disagrees with the xla step")


# Phase 11: a synthetic DIV2K-style folder (768x512 RGB PNGs, 6 patches of
# 256^2 each: 48 patches, 144 samples with sigma in {15, 25, 50}) and a small
# SIDD tree (4 scenes, one NOISY/GT pair each: 24 pairs), trained through the
# CLI at full width.  Split 0.2: 115 train samples, 14 steps of 8 per epoch.
FOLDER_IMAGES, FOLDER_SIZE, SIDD_SCENES = 8, (768, 512), 4
FOLDER_EPOCHS, FOLDER_STEPS = 2, 14


def write_folder(root, seed=11):
    """The DIV2K-style folder and the SIDD tree under ``root``, in the CLI's
    layout (``DIV2K_train_HR.nosync``, ``SIDD_dataset.nosync/SIDD_Medium_Srgb``),
    from a seeded numpy generator: smooth random fields plus noise."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    w, h = FOLDER_SIZE

    def image():
        coarse = rng.randint(0, 256, (h // 32 + 1, w // 32 + 1, 3)).astype(np.float32)
        smooth = np.kron(coarse, np.ones((32, 32, 1), np.float32))[:h, :w]
        return np.clip(smooth + rng.randn(h, w, 3) * 8, 0, 255).astype(np.uint8)

    div2k = os.path.join(root, "DIV2K_train_HR.nosync")
    os.makedirs(div2k)
    for i in range(FOLDER_IMAGES):
        Image.fromarray(image()).save(os.path.join(div2k, f"{i:04d}.png"))
    sidd = os.path.join(root, "SIDD_dataset.nosync", "SIDD_Medium_Srgb")
    scenes = [f"{i:04d}_001_S6_00100_00060_3200_L" for i in range(1, SIDD_SCENES + 1)]
    for name in scenes:
        d = os.path.join(sidd, "Data", name)
        os.makedirs(d)
        gt = image()
        noisy = np.clip(gt + rng.randn(*gt.shape) * 20, 0, 255).astype(np.uint8)
        Image.fromarray(gt).save(os.path.join(d, f"{name[:4]}_GT_SRGB_010.png"))
        Image.fromarray(noisy).save(os.path.join(d, f"{name[:4]}_NOISY_SRGB_010.png"))
    with open(os.path.join(sidd, "Scene_Instances.txt"), "w") as f:
        f.write("\n".join(scenes) + "\n")


def cli_run(torch, root, out, *extra, loader_epoch=None):
    """One run of the port's CLI on the folder at full width: RDUNetT-32,
    batch 8, 256^2 patches, engine "pallas", f32, dataset_percentage 1.0,
    default --augment (on).  Through ``train.diffusion.main``, or with
    ``loader_epoch`` through ``train(args, train_loader, val_loader)`` with
    the loaders' ``.epoch`` set to it (a resumed run that shuffles and draws
    noise as the straight run did).  Returns (state, history, kernel-1
    launches of the run, its tensor-core launches, native gathers, wall
    seconds)."""
    from vub_image_denoising_tpu_torch import native
    from vub_image_denoising_tpu_torch.ops.fused_block import fused_denoising_block
    from vub_image_denoising_tpu_torch.train.diffusion import build_arg_parser, load_data_for
    from vub_image_denoising_tpu_torch.train.diffusion import main as train_main
    from vub_image_denoising_tpu_torch.train.diffusion import train

    argv = ["--dataset_choice", "DIV2K", "--data_root", root, "--batch_size", str(TRAIN_BATCH),
            "--dataset_percentage", "1.0", "--base_filters", str(BASE_FILTERS),
            "--timesteps", str(TIMESTEPS), "--engine", "pallas", "--output_dir", out, *extra]
    fused_denoising_block.launches = fused_denoising_block.tc_launches = 0
    native.gather_patches.native_calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if loader_epoch is None:
        state, history = train_main(argv)
    else:
        args = build_arg_parser().parse_args(argv)
        loaders = load_data_for(args, device=torch.device("cuda"))
        for loader in loaders:
            loader.epoch = loader_epoch
        state, history = train(args, *loaders)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    return (state, history, fused_denoising_block.launches, fused_denoising_block.tc_launches,
            native.gather_patches.native_calls, sec)


def check_cli_run(name, run, epochs, steps, total_steps, card):
    """The run took ``epochs`` epochs of ``steps`` steps in all (the state
    counts ``total_steps``, the resumed ones too); every block of every step
    (56) and of each validation (14*T) launched kernel 1 on the tensor
    cores; losses finite."""
    state, history, launches, tc, gathers, sec = run
    want = 14 * ACCUMULATION * steps + 14 * TIMESTEPS * epochs
    losses = [h["loss"] for h in history] + [h["val_loss"] for h in history]
    print(f"folder train {name}: {len(history)} epochs, {state.step} steps, losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}; kernel 1 launches {launches} ({tc} on the "
          f"tensor cores; want 56 x steps + 280 x epochs = {want}), {gathers} native gathers, "
          f"{sec:.2f} s ({card})", flush=True)
    if (len(history) != epochs or state.step != total_steps or launches != want
            or tc != launches or gathers == 0 or not all(math.isfinite(x) for x in losses)):
        fail(f"folder train {name}: {len(history)} epochs (want {epochs}), {state.step} steps "
             f"(want {total_steps}), {launches} launches ({tc} tc; want {want}), {gathers} "
             f"native gathers, losses {losses}")
    return {"epochs": len(history), "steps": steps, "all": launches, "tc": tc,
            "native_gathers": gathers, "sec": sec,
            "epoch_sec": [h["sec"] for h in history], "losses": losses}


def load_final(torch, path):
    """A checkpoint of the run, loaded strict into RDUNetT-32."""
    from vub_image_denoising_tpu_torch.models import RDUNetT
    from vub_image_denoising_tpu_torch.utils.checkpoint import load_pth

    if not os.path.isfile(path):
        fail(f"missing checkpoint {path}")
    model, _ = load_pth(path, RDUNetT(BASE_FILTERS), prefix="unet.")
    return {k: v.detach() for k, v in model.state_dict().items()}


def folder_train_main_path(torch, device, card, synthetic_step_ms):
    """Phase 11: train RDUNetT-32 from an image folder through the CLI, check
    the checkpoints, the launches and a resumed run; one epoch each from the
    device bank and from SIDD; time the loaders, the epochs and the card's
    idle share.  TensorBoard is left out (tensorboardX blocked): the CLI
    then trains without a writer, as where it is not installed."""
    sys.modules["tensorboardX"] = None
    epoch_file = "diffusion_RDUNet_model_checkpointed_epoch_{}.pth"
    out = {}
    phase_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_folder(tmp)
        print(f"folder train: wrote {FOLDER_IMAGES} PNGs of {FOLDER_SIZE[0]}x{FOLDER_SIZE[1]} and "
              f"{SIDD_SCENES} SIDD pairs in {time.perf_counter() - t0:.2f} s", flush=True)
        straight_dir, resumed_dir = os.path.join(tmp, "straight"), os.path.join(tmp, "resumed")
        # cuDNN's default weight-gradient algorithms are not deterministic, and
        # AdamW moves an element whose gradient is near zero by about lr either
        # way: the straight and the resumed run take cuDNN's deterministic ones
        torch.backends.cudnn.deterministic = True
        run = cli_run(torch, tmp, straight_dir, "--num_epochs", str(FOLDER_EPOCHS))
        steps = FOLDER_EPOCHS * FOLDER_STEPS
        out["straight"] = check_cli_run("straight", run, FOLDER_EPOCHS, steps, steps, card)
        for e in range(1, FOLDER_EPOCHS + 1):
            load_final(torch, os.path.join(straight_dir, epoch_file.format(e)))
        final = os.path.join(straight_dir, "diffusion_RDUNet_model_checkpointed_final.pth")
        straight = load_final(torch, final)

        run = cli_run(torch, tmp, resumed_dir, "--num_epochs", str(FOLDER_EPOCHS),
                      "--checkpoint_path", os.path.join(straight_dir, epoch_file.format(1)),
                      loader_epoch=1)
        out["resumed"] = check_cli_run("resumed", run, FOLDER_EPOCHS - 1, FOLDER_STEPS, steps,
                                       card)
        torch.backends.cudnn.deterministic = False
        resumed = load_final(torch, final.replace(straight_dir, resumed_dir))
        worst = max(((v - resumed[k]).abs() / (STEP_ATOL + STEP_RTOL * v.abs())).max().item()
                    for k, v in straight.items())
        diff = max((v - resumed[k]).abs().max().item() for k, v in straight.items())
        out["resume_worst_over_tol"], out["resume_max_abs_diff"] = worst, diff
        print(f"folder train resumed vs straight final params: max |diff| {diff:.3e}, worst "
              f"|diff| / (atol {STEP_ATOL} + rtol {STEP_RTOL}*|p|) = {worst:.4f} (must be <= 1)",
              flush=True)
        if worst > 1:
            fail("the resumed run's params disagree with the straight run's")

        run = cli_run(torch, tmp, os.path.join(tmp, "bank"), "--num_epochs", "1", "--device-data")
        out["device_data"] = check_cli_run("device-data", run, 1, FOLDER_STEPS, FOLDER_STEPS,
                                           card)
        run = cli_run(torch, tmp, os.path.join(tmp, "sidd"), "--num_epochs", "1",
                      "--dataset_choice", "SIDD")
        sidd_steps = int(0.8 * SIDD_SCENES * 6) // TRAIN_BATCH  # 6 patches a pair
        out["sidd"] = check_cli_run("SIDD", run, 1, sidd_steps, sidd_steps, card)
        out["timing"] = time_folder_loaders(torch, device, tmp, card, synthetic_step_ms)
    out["phase_sec"] = time.perf_counter() - phase_t0
    print(f"folder train phase: {out['phase_sec']:.1f} s", flush=True)
    return out


def trace_busy(torch, fn):
    """fn() once under torch.profiler, CUDA activity only: wall ms, the
    card's busy ms (the union of its kernel, memcpy and memset intervals,
    user annotations left out, read from the profiler's raw events: its
    own event tables take minutes to build for an epoch) and the idle
    share 1 - busy / wall."""
    from torch._C._autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA and not e.is_user_annotation())
    busy_ns, end = 0, -math.inf
    for a, b in spans:
        if b > end:
            busy_ns += b - max(a, end)
            end = b
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ns / 1e6,
            "idle_share": 1 - busy_ns / 1e6 / wall_ms, "device_events": len(spans)}


def time_folder_loaders(torch, device, root, card, synthetic_step_ms):
    """ms per batch of 8 x 256^2 of the host PatchLoader (fetch, pinned H2D
    copy, on-card noise/augment/normalize) and of the device bank, each over
    one epoch alone (CUDA events); then "pallas" f32 epochs fed by each, in
    turns (host, bank, bank, host), beside phase 10's synthetic-batch step;
    then one traced epoch of each for the card's idle share."""
    from vub_image_denoising_tpu_torch.data.loader import load_data
    from vub_image_denoising_tpu_torch.train import DiffusionTrainer

    folder = os.path.join(root, "DIV2K_train_HR.nosync")
    runs, out = {}, {}
    for name, bank in (("host", False), ("bank", True)):
        loader, _ = load_data(folder, batch_size=TRAIN_BATCH, augment=True, use_rgb=True,
                              num_workers=8, device=device, device_data=bank)
        trainer = DiffusionTrainer(base_filters=BASE_FILTERS, timesteps=TIMESTEPS,
                                   accumulation_steps=ACCUMULATION, engine="pallas")
        runs[name] = (loader, trainer, trainer.init(steps_per_epoch=len(loader)))
        out[name] = {"batches": len(loader), "synthetic_step_ms": synthetic_step_ms,
                     "loader_ms_per_batch": cuda_ms(
                         torch, lambda: sum(1 for _ in loader), 1) / len(loader),
                     "epoch_ms_runs": []}
    for name in ("host", "bank", "bank", "host"):
        loader, trainer, state = runs[name]
        out[name]["epoch_ms_runs"].append(
            cuda_ms(torch, lambda: trainer.train_epoch(state, loader, 0), 1, warmup=0))
    for name, (loader, trainer, state) in runs.items():
        rec = out[name]
        rec.update(trace_busy(torch, lambda: trainer.train_epoch(state, loader, 1)))
        rec["step_ms_runs"] = [ms / rec["batches"] for ms in rec["epoch_ms_runs"]]
        rec["busy_share_of_untraced_epoch"] = rec["device_busy_ms"] / min(rec["epoch_ms_runs"])
        print(f"folder loader {name}: {rec['loader_ms_per_batch']:.3f} ms per batch of "
              f"{TRAIN_BATCH}x256x256 alone; pallas f32 step fed by it "
              f"{', '.join(f'{ms:.2f}' for ms in rec['step_ms_runs'])} ms (epochs of "
              f"{rec['batches']}, in turns) against {synthetic_step_ms:.2f} ms on synthetic "
              f"batches (phase 10); traced epoch: wall {rec['wall_ms']:.1f} ms, card busy "
              f"{rec['device_busy_ms']:.1f} ms, idle share {rec['idle_share']:.3f}; busy over "
              f"the faster untraced epoch {rec['busy_share_of_untraced_epoch']:.3f} ({card})",
              flush=True)
    return out


# SIDD evaluation (phase 12): the validation pair in the real files' layout
# and keys, (images, blocks, 256, 256, 3) uint8, and a small benchmark file.
SIDD_VAL_SHAPE = (20, 32, IMAGE_SIZE, IMAGE_SIZE, 3)  # the real file's 40 images cut to 20
SIDD_BENCH_SHAPE = (2, 8, IMAGE_SIZE, IMAGE_SIZE, 3)
SIDD_CSV_HEADER = ["Method", "MACs (G)", "Inference Time (ms)", "PSNR", "SSIM"]
EVAL_PSNR_TOL, EVAL_SSIM_TOL = 1e-4, 1e-5  # card metrics vs the CPU's, dB and SSIM units
EVAL_BF16_PSNR_GAP = 0.1  # |avg_psnr bf16 - f32| in dB on the same blocks


def sidd_blocks(seed, shape):
    """uint8 (images, blocks, H, W, 3) GT blocks: smooth random fields (cells
    of 32x32 pixels) plus mild texture; and their noisy counterpart (sigma
    20 on the 0..255 scale, clipped).  One image per thread, each from its
    own generator spawned from ``seed``."""
    import numpy as np

    i, p, h, w, c = shape
    # MATLAB's column-major order, which savemat writes without a transpose
    gt = np.empty(shape, np.uint8, order="F")
    noisy = np.empty(shape, np.uint8, order="F")

    def image(k, ss):
        rng = np.random.default_rng(ss)
        coarse = rng.integers(0, 256, (p, h // 32, w // 32, c), dtype=np.int16)
        smooth = np.repeat(np.repeat(coarse, 32, axis=1), 32, axis=2)
        np.clip(smooth + rng.integers(-12, 13, smooth.shape, dtype=np.int16), 0, 255,
                out=smooth)
        gt[k] = smooth
        smooth += np.rint(rng.standard_normal(smooth.shape, np.float32) * 20).astype(np.int16)
        noisy[k] = np.clip(smooth, 0, 255)

    seeds = np.random.SeedSequence(seed).spawn(i)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        for f in [pool.submit(image, k, ss) for k, ss in enumerate(seeds)]:
            f.result()
    return gt, noisy


def write_sidd_mats(root, seed=12):
    """The validation pair and the benchmark file under ``root``, with the
    SIDD files' keys; returns their paths and the arrays written."""
    import scipy.io

    gt, noisy = sidd_blocks(seed, SIDD_VAL_SHAPE)
    _, bench = sidd_blocks(seed + 1, SIDD_BENCH_SHAPE)
    paths = {k: os.path.join(root, f"{k}.mat") for k in ("noisy", "gt", "bench")}
    scipy.io.savemat(paths["noisy"], {"ValidationNoisyBlocksSrgb": noisy})
    scipy.io.savemat(paths["gt"], {"ValidationGtBlocksSrgb": gt})
    scipy.io.savemat(paths["bench"], {"BenchmarkNoisyBlocksSrgb": bench})
    return paths, gt


def sidd_cli_run(torch, argv):
    """``sidd_cli.main(argv)`` with every sampler call recorded: the kernel-1
    launches (all, tensor-core) of the run, and each call's output tensor,
    left on the card (no sync, so the loop's timing is untouched)."""
    from vub_image_denoising_tpu_torch.eval import sidd_cli
    from vub_image_denoising_tpu_torch.ops.fused_block import fused_denoising_block

    outputs = []
    real = sidd_cli.load_sampler

    def load(*args, **kwargs):
        sampler = real(*args, **kwargs)

        def record(x):
            y = sampler(x)
            outputs.append(y)
            return y
        return record

    sidd_cli.load_sampler = load
    fused_denoising_block.launches = fused_denoising_block.tc_launches = 0
    try:
        t0 = time.perf_counter()
        result = sidd_cli.main(argv)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    finally:
        sidd_cli.load_sampler = real
    return result, outputs, fused_denoising_block.launches, fused_denoising_block.tc_launches, sec


def check_eval_metrics(torch, gt_dev, out_dev, result):
    """The metric vectors of the run's outputs on the card (as evaluate_sidd
    computes them), with TF32 off and on, against the same functions on the
    CPU; the run's avg_psnr is their mean.  Returns the worst errors."""
    import numpy as np

    from vub_image_denoising_tpu_torch.eval.metrics import psnr_per_image, ssim_ref_per_image

    cpu_p = psnr_per_image(gt_dev.cpu(), out_dev.cpu(), 2.0)
    cpu_s = ssim_ref_per_image(gt_dev.cpu(), out_dev.cpu(), 2.0)
    errs = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        for on in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
            p = psnr_per_image(gt_dev, out_dev, 2.0).cpu()
            s = ssim_ref_per_image(gt_dev, out_dev, 2.0).cpu()
            errs[f"tf32_{'on' if on else 'off'}"] = {
                "psnr": (p - cpu_p).abs().max().item(), "ssim": (s - cpu_s).abs().max().item()}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    errs["avg_psnr_vs_mean"] = abs(result["avg_psnr"] - float(np.mean(cpu_p.double().numpy())))
    errs["avg_ssim_vs_mean"] = abs(result["avg_ssim"] - float(np.mean(cpu_s.double().numpy())))
    return errs


def eval_main_path(torch, card, sampler_ms):
    """Phase 12: SIDD validation (f32 and bf16) and the Kaggle submission
    (bf16, --fused) through the port's CLI, on RDUNetT-32 at T = 20 with the
    CLI's defaults; the launches, the metrics on the card against the CPU,
    the CSVs; the health probe."""
    import csv

    import numpy as np

    from vub_image_denoising_tpu_torch.eval.sidd import _normalize_blocks, base64string_to_array
    from vub_image_denoising_tpu_torch.models import RDUNetT
    from vub_image_denoising_tpu_torch.utils.checkpoint import save_pth
    from vub_image_denoising_tpu_torch.utils.health import probe_device_exec

    per_call = 14 * TIMESTEPS
    out = {}
    csv.field_size_limit(1 << 24)  # a base64 block of 256x256x3 is 262144 characters
    phase_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths, gt_u8 = write_sidd_mats(tmp)
        out["write_sec"] = time.perf_counter() - t0
        print(f"eval: wrote the SIDD validation pair {SIDD_VAL_SHAPE} and the benchmark file "
              f"{SIDD_BENCH_SHAPE} in {out['write_sec']:.2f} s", flush=True)
        ck = os.path.join(tmp, "rdunet_t32.pth")
        save_pth(ck, RDUNetT(BASE_FILTERS, generator=torch.Generator().manual_seed(0)).state_dict(),
                 prefix="unet.")
        n_all = SIDD_VAL_SHAPE[0] * SIDD_VAL_SHAPE[1]
        n_eval = int(n_all * 0.1)
        n_batches = -(-n_eval // 8)
        idx = np.random.RandomState(0).choice(n_all, n_eval, replace=False)
        gt = _normalize_blocks(gt_u8.reshape(n_all, *SIDD_VAL_SHAPE[2:])[idx])
        gt_dev = torch.from_numpy(gt).cuda()
        launches = {"validate_f32": 0, "validate_bf16": 0, "benchmark_bf16": 0}
        tc = dict(launches)
        for name, extra in (("f32", ["--engine", "auto"]), ("bf16", ["--bf16"])):
            csv_path = os.path.join(tmp, f"benchmark_results_{name}.csv")
            result, outputs, n_launch, n_tc, sec = sidd_cli_run(torch, [
                "validate", "--checkpoint", ck, "--noisy-mat", paths["noisy"],
                "--gt-mat", paths["gt"], "--csv", csv_path, *extra])
            calls = len(outputs)
            launches[f"validate_{name}"], tc[f"validate_{name}"] = n_launch, n_tc
            rec = {k: result[k] for k in ("avg_psnr", "avg_ssim", "avg_inference_time_ms",
                                          "device_inference_time_ms", "warmup_compile_ms",
                                          "n_blocks")}
            rec["host_share"] = 1 - rec["device_inference_time_ms"] / rec["avg_inference_time_ms"]
            rec["sampler_calls"], rec["sec"] = calls, sec
            rec["phase9_sampler_ms_per_block"] = sampler_ms[name]["sampler_ms"] / 8
            rec["metrics"] = check_eval_metrics(
                torch, gt_dev, torch.cat(outputs[1:1 + n_batches]), result)
            with open(csv_path, newline="") as f:
                rows = list(csv.reader(f))
            out[f"validate_{name}"] = rec
            print(f"eval validate {name}: {rec['n_blocks']} blocks, avg PSNR "
                  f"{rec['avg_psnr']:.4f} dB, SSIM {rec['avg_ssim']:.6f}; "
                  f"{rec['avg_inference_time_ms']:.3f} ms per block wall, "
                  f"{rec['device_inference_time_ms']:.3f} device, host share "
                  f"{rec['host_share']:.4f} (phase 9 sampler per block "
                  f"{rec['phase9_sampler_ms_per_block']:.3f} ms); warm-up "
                  f"{rec['warmup_compile_ms']:.1f} ms; {calls} sampler calls, {n_launch} kernel-1 "
                  f"launches ({n_tc} on the tensor cores); metrics on the card vs the CPU "
                  f"{rec['metrics']}; {sec:.1f} s ({card})", flush=True)
            if calls != n_batches + 3 or n_launch != per_call * calls or n_tc != n_launch:
                fail(f"eval validate {name}: {calls} sampler calls (want {n_batches + 3}), "
                     f"{n_launch} launches ({n_tc} tc; want {per_call} per call)")
            if rec["n_blocks"] != n_eval or rows[0] != SIDD_CSV_HEADER or len(rows) != 2:
                fail(f"eval validate {name}: {rec['n_blocks']} blocks (want {n_eval}), CSV {rows}")
            if not (math.isfinite(rec["avg_psnr"]) and math.isfinite(rec["avg_ssim"])):
                fail(f"eval validate {name}: metrics not finite")
            for on in ("tf32_off", "tf32_on"):
                e = rec["metrics"][on]
                if e["psnr"] > EVAL_PSNR_TOL or e["ssim"] > EVAL_SSIM_TOL:
                    fail(f"eval {name}: the card's metrics ({on}) disagree with the CPU's: {e}")
            if rec["metrics"]["avg_psnr_vs_mean"] > 1e-6 * abs(rec["avg_psnr"]):
                fail(f"eval {name}: avg_psnr is not the mean of the per-block PSNR")
            if rec["metrics"]["avg_ssim_vs_mean"] > 1e-6 * abs(rec["avg_ssim"]):
                fail(f"eval {name}: avg_ssim is not the mean of the per-block SSIM")
            del outputs
        gap = abs(out["validate_bf16"]["avg_psnr"] - out["validate_f32"]["avg_psnr"])
        out["bf16_psnr_gap_db"] = gap
        print(f"eval: |avg PSNR bf16 - f32| on the same {n_eval} blocks {gap:.4f} dB (bound "
              f"{EVAL_BF16_PSNR_GAP})", flush=True)
        if gap > EVAL_BF16_PSNR_GAP:
            fail(f"eval: bf16 avg PSNR {gap:.4f} dB from f32")

        submit = os.path.join(tmp, "SubmitSrgb.csv")
        result, outputs, n_launch, n_tc, sec = sidd_cli_run(torch, [
            "benchmark", "--checkpoint", ck, "--benchmark-mat", paths["bench"],
            "--output", submit, "--bf16", "--fused"])
        calls = len(outputs)
        launches["benchmark_bf16"], tc["benchmark_bf16"] = n_launch, n_tc
        with open(submit, newline="") as f:
            rows = list(csv.reader(f))
        n_bench = SIDD_BENCH_SHAPE[0] * SIDD_BENCH_SHAPE[1]
        blocks = [base64string_to_array(r[1], np.uint8, SIDD_BENCH_SHAPE[2:]) for r in rows[1:]]
        out["benchmark_bf16"] = {"rows": len(rows) - 1, "sampler_calls": calls, "sec": sec}
        print(f"eval benchmark bf16 --fused: {len(rows) - 1} rows, {calls} sampler calls, "
              f"{n_launch} kernel-1 launches ({n_tc} on the tensor cores), {sec:.1f} s",
              flush=True)
        if (rows[0] != ["ID", "BLOCK"] or len(blocks) != n_bench
                or [r[0] for r in rows[1:]] != [str(i) for i in range(n_bench)]
                or calls != -(-n_bench // 8) or n_launch != per_call * calls or n_tc != n_launch):
            fail(f"eval benchmark: {len(rows) - 1} rows, {calls} calls, {n_launch} launches")

    ok, dt, detail = probe_device_exec()
    out["health"] = {"ok": ok, "sec": dt, "detail": detail}
    print(f"eval health probe: ok={ok} in {dt:.1f} s: {detail}", flush=True)
    if not ok:
        fail(f"the device health probe failed: {detail}")
    out["launches"], out["tc_launches"] = launches, tc
    out["phase_sec"] = time.perf_counter() - phase_t0
    print(f"eval phase: {out['phase_sec']:.1f} s", flush=True)
    return out


# Phase 13: kernel 1's wide form (csrc/fused_block_wide_tc.cu) at c > 256:
# RDUNet(128)'s c = 512 and 1024 blocks on one 256^2 image, the c = 512
# block at batch 4, and a ragged image (neither side a multiple of the 8 x 16
# tile); kernel 2's wide form at the first shape.
WIDE_SHAPES = [(1, 512, 64, 64), (1, 1024, 32, 32), (4, 512, 64, 64), (2, 512, 20, 36)]
WIDE_PACKED_SHAPE = (1, 512, 64, 64)
# print_info's RDUNet(128) on one 256x256 image: (width, side, blocks per
# forward) per level; c = 512 and 1024 run the wide form.
RDUNET128_BLOCKS = [(128, 256, 4), (256, 128, 4), (512, 64, 4), (1024, 32, 2)]
INFO_CALLS = 11  # per model: measure_inference_metrics' warm-up and 10 timed calls
# Phase 14: rdunet_supervised_main's trainer (train/presets.py): RDUNet(128),
# f32, batch 4 of 256^2 (UNet/RDUNet_model.py:270-283), accumulation 4.
SUPERVISED128_BATCH = 4
# Phase 15: the GAN family on grayscale 256^2 pairs, batch 8, 3 rounds each;
# one round at 2 x 64^2 on the card against the CPU.
GAN_SIDE, GAN_BATCH, GAN_ROUNDS = 256, 8, 3
GAN_CHECK_SHAPE = (2, 1, 64, 64)
GAN_RTOL, GAN_ATOL_OF_MAX = 1e-4, 1e-6  # losses rtol; grads rtol, atol * max|g|
# An f32 round against the f64 round, as tests/test_torch_gan.py holds one
# (ROUND_*): at 2 x 64^2 f32 rounding alone moves a round's losses by up
# to 9e-4 of themselves and a gradient leaf by up to 0.2 of this limit,
# which is each leaf's own max|g| times GAN_F32_GRAD_OF_LEAF plus the
# largest leaf's times GAN_F32_GRAD_FLOOR (the floor for leaves whose exact
# gradient is zero: a conv bias before a training-mode BatchNorm).
GAN_F32_LOSS_RTOL, GAN_F32_GRAD_OF_LEAF, GAN_F32_GRAD_FLOOR = 5e-3, 0.5, 1e-3


def counts(counter):
    return (counter.launches, counter.tc_launches, counter.wide_launches)


def reset_counts(counter):
    counter.launches = counter.tc_launches = counter.wide_launches = 0


def check_wide_kernel(torch, device):
    """Kernel 1's wide form against the plain block at WIDE_SHAPES in f32
    and bf16 (``held``), each launch one block on the tensor cores through
    the wide form; kernel 2's wide form at WIDE_PACKED_SHAPE against its
    plain version and, unpacked, kernel 1 (bit for bit).  Times each beside
    the plain cuDNN block (TF32 off) and the bound.  Returns the records."""
    from vub_image_denoising_tpu_torch.ops import fused_block as fb
    from vub_image_denoising_tpu_torch.ops.packing import pack2x2, unpack2x2

    k1, k2 = fb.fused_denoising_block, fb.fused_denoising_block_packed
    records, packed_records = [], []
    for shape in WIDE_SHAPES:
        c = shape[1]
        params = block_params(torch, c, seed=c, device=device)
        gen = torch.Generator(device=device).manual_seed(1)
        x32 = torch.randn(shape, generator=gen, device=device)
        ref32 = fb.fused_denoising_block_plain(x32, params)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x = x32.to(dtype).contiguous(memory_format=torch.channels_last)
            packed = fb.pack_block_params(params, dtype, device)
            before = counts(k1)
            y = k1(x, params, packed)
            torch.cuda.synchronize()
            counted = tuple(a - b for a, b in zip(counts(k1), before))
            plain = lambda v: fb.fused_denoising_block_plain(v, params)
            err_same, err_ref, ok, tol = held(torch, plain, y, x, ref32)
            rec = {"shape": shape, "dtype": name, "variant": fb.block_variant(dtype, c),
                   "max_abs_err": err_same, "max_abs_err_vs_f32": err_ref,
                   "ms": cuda_ms(torch, lambda: k1(x, params, packed), 10),
                   "plain_ms": cuda_ms(torch, lambda: plain(x), 5)}
            rec["bound_ms"], rec["bound_by"] = bound_ms(shape, name, x.element_size())
            print(f"check wide {shape} {name}: max_abs_err vs plain({name}) {err_same:.3e}, "
                  f"vs reference {err_ref:.3e} ({tol}) -> {'ok' if ok else 'FAIL'}; kernel "
                  f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
                  f"{block_flops_tflops(shape, rec['ms']):.2f} TFLOP/s", flush=True)
            if rec["variant"] != "tc_wide" or counted != (1, 1, 1):
                fail(f"kernel 1 at {shape} {name}: variant {rec['variant']}, counted "
                     f"(launches, tc, wide) {counted}, want (1, 1, 1)")
            if not ok:
                fail(f"the wide form disagrees with the plain block at {shape} {name}")
            records.append(rec)
        del params, x32, ref32, x, y, packed

    shape = WIDE_PACKED_SHAPE
    c = shape[1]
    params = block_params(torch, c, seed=c, device=device)
    pq = fb.pack_block_params_packed(params)
    gen = torch.Generator(device=device).manual_seed(1)
    x32 = torch.randn(shape, generator=gen, device=device).contiguous(
        memory_format=torch.channels_last)
    ref32 = fb.fused_denoising_block_packed_plain(pack2x2(x32), pq)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        x = x32.to(dtype)
        xq = pack2x2(x)
        kw = fb.kernel_weights_from_packed(pq, dtype)
        kw1 = fb.pack_block_params(params, dtype, device)
        before = counts(k2)
        yq = k2(xq, pq, kw)
        torch.cuda.synchronize()
        counted = tuple(a - b for a, b in zip(counts(k2), before))
        plain = lambda v: fb.fused_denoising_block_packed_plain(v, pq)
        err_same, err_ref, ok, tol = held(torch, plain, yq, xq, ref32)
        one = k1(x, params, kw1)
        torch.cuda.synchronize()
        same = torch.equal(unpack2x2(yq), one)
        rec = {"shape": shape, "dtype": name, "variant": "tc_wide", "max_abs_err": err_same,
               "kernel1_max_abs_diff": (unpack2x2(yq).float() - one.float()).abs().max().item(),
               "ms": cuda_ms(torch, lambda: k2(xq, pq, kw), 10),
               "kernel1_ms": cuda_ms(torch, lambda: k1(x, params, kw1), 10),
               "plain_ms": cuda_ms(torch, lambda: plain(xq), 5)}
        rec["bound_ms"], rec["bound_by"] = bound_ms(shape, name, xq.element_size())
        print(f"check packed wide {shape} {name}: max_abs_err vs plain({name}) {err_same:.3e}, "
              f"vs reference {err_ref:.3e} ({tol}); unpacked vs kernel 1: max abs diff "
              f"{rec['kernel1_max_abs_diff']} (must be 0.0) -> "
              f"{'ok' if ok and same else 'FAIL'}; kernel {rec['ms']:.4f} ms, kernel 1 "
              f"{rec['kernel1_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms", flush=True)
        if counted != (1, 1, 1) or not ok or not same:
            fail(f"kernel 2's wide form at {shape} {name}: counted {counted}, ok={ok}, "
                 f"equal to kernel 1: {same}")
        packed_records.append(rec)
    return records, packed_records


def rdunet128_main_path(torch, device):
    """Phase 13's main path: ``print_info`` in f32 and in bf16 (RDUNet(128)
    and the T = 20 sampler, 11 calls each): every kernel-1 launch on the
    tensor cores, 6 of RDUNet(128)'s 14 through the wide form; then the f32
    RDUNet(128) forward on a 256^2 image against the same forward on the CPU
    (TF32 off), and both dtypes' forward timed."""
    from vub_image_denoising_tpu_torch.models import RDUNet
    from vub_image_denoising_tpu_torch.ops.fused_block import fused_denoising_block as k1
    from vub_image_denoising_tpu_torch.utils.info import print_info

    blocks = sum(n for _, _, n in RDUNET128_BLOCKS)
    wide = sum(n for c, _, n in RDUNET128_BLOCKS if c > 256)
    per_call = 14 * TIMESTEPS
    out = {"launches": {}}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        reset_counts(k1)
        info = print_info(dtype=dtype)
        torch.cuda.synchronize()
        got = counts(k1)
        want = (INFO_CALLS * (blocks + per_call),) * 2 + (INFO_CALLS * wide,)
        out["launches"][f"info_{name}"] = dict(zip(("all", "tc", "wide"), got))
        lat = info["rdunet128_latency"]
        out[f"info_{name}"] = {
            "rdunet128_flops": info["rdunet128"]["flops"],
            "rdunet128_params": info["rdunet128"].get("params"),
            "rdunet128_ms": lat["avg_inference_sec"] * 1e3,
            "rdunet128_std_ms": lat["std_inference_sec"] * 1e3,
            "rdunet128_peak_memory_bytes": lat.get("peak_memory_bytes"),
            "sampler_ms": info["sampler_latency"]["avg_inference_sec"] * 1e3}
        print(f"print_info {name}: RDUNet(128) {out[f'info_{name}']['rdunet128_ms']:.3f} ms; "
              f"{got[0]} kernel-1 launches ({got[1]} on the tensor cores, {got[2]} through the "
              f"wide form; want {want})", flush=True)
        if got != want:
            fail(f"print_info {name}: (launches, tc, wide) {got}, want {want}")
        for key in ("rdunet128", "sampler"):
            if not info[key]["flops"] > 0 or not info[f"{key}_latency"].get("peak_memory_bytes"):
                fail(f"print_info {name}: no FLOPs or peak memory for {key}")

    model = RDUNet(3, 128, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.rand(1, 3, IMAGE_SIZE, IMAGE_SIZE, generator=torch.Generator().manual_seed(3)) * 2 - 1
    with torch.no_grad():
        t0 = time.perf_counter()
        want = model(x)
        out["cpu_forward_sec"] = time.perf_counter() - t0
        gpu = model.to(device).to(memory_format=torch.channels_last)
        xd = x.to(device).contiguous(memory_format=torch.channels_last)
        reset_counts(k1)
        y = gpu(xd)
        torch.cuda.synchronize()
        got = counts(k1)
        out["launches"]["forward_f32"] = dict(zip(("all", "tc", "wide"), got))
        err = (y.cpu() - want).abs().max().item()
        yb = gpu(xd.to(torch.bfloat16)).float()
        err_bf16 = (yb - y).abs().max().item() / y.abs().max().item()
        out["forward_f32_max_abs_err_vs_cpu"], out["forward_bf16_rel_err_vs_f32"] = err, err_bf16
        out["forward_ms"] = {
            "f32": cuda_ms(torch, lambda: gpu(xd), 10),
            "bf16": cuda_ms(torch, lambda: gpu(xd.to(torch.bfloat16)), 10)}
    print(f"RDUNet(128) forward 1x256x256: f32 {out['forward_ms']['f32']:.3f} ms, bf16 "
          f"{out['forward_ms']['bf16']:.3f} ms; f32 vs the CPU forward max abs err {err:.3e} "
          f"(<= {SERVED_F32_TOL}), bf16 vs f32 {err_bf16:.3e} of max|y| (<= "
          f"{SERVED_BF16_REL_TOL}); {got} (launches, tc, wide); CPU forward "
          f"{out['cpu_forward_sec']:.1f} s", flush=True)
    if got != (blocks, blocks, wide) or not err <= SERVED_F32_TOL or not (
            err_bf16 <= SERVED_BF16_REL_TOL):
        fail(f"RDUNet(128) forward: (launches, tc, wide) {got}, f32 error {err}, bf16 {err_bf16}")
    return out


def supervised128_main_path(torch, device):
    """Phase 14: rdunet_supervised_main's trainer (RDUNet(128), f32, engine
    "flax", AdamW(1e-4, wd 1e-5), accumulation 4) takes TRAIN_STEPS steps on
    batches of 4 x 256^2 at sigma 25: finite losses, params that move, 14
    kernel-1 launches per micro-batch forward, all on the tensor cores (6
    through the wide form); one SGD step against the same step on the
    "xla" engine (STEP_RTOL / STEP_ATOL, as compare_with_xla); the step's ms."""
    from vub_image_denoising_tpu_torch.models import RDUNet
    from vub_image_denoising_tpu_torch.ops.fused_block import fused_denoising_block as k1
    from vub_image_denoising_tpu_torch.train import TrainState, make_supervised_train_step
    from vub_image_denoising_tpu_torch.train.presets import rdunet_supervised_trainer

    init = RDUNet(3, 128, generator=torch.Generator().manual_seed(0)).state_dict()

    def make(engine):
        model = RDUNet(3, 128)
        model.load_state_dict(init)
        trainer = rdunet_supervised_trainer(model, engine=engine, device=device)
        return trainer, trainer.init(steps_per_epoch=TRAIN_STEPS)

    gen = torch.Generator(device=device).manual_seed(4)
    batches = []
    for _ in range(TRAIN_STEPS):
        clean = torch.rand(SUPERVISED128_BATCH, 3, IMAGE_SIZE, IMAGE_SIZE, generator=gen,
                           device=device) * 2 - 1
        batches.append((clean + SIGMA * torch.randn(clean.shape, generator=gen, device=device),
                        clean))
    acc = 4
    want = (14 * acc, 14 * acc, 6 * acc)
    out = {"steps": []}
    trainer, state = make("flax")
    if trainer.accumulation_steps != acc:
        fail(f"rdunet_supervised_trainer accumulates {trainer.accumulation_steps}, want {acc}")
    reset_counts(k1)
    for i, (noisy, clean) in enumerate(batches):
        before = counts(k1)
        state, loss = trainer.train_step(state, noisy, clean)
        got = tuple(a - b for a, b in zip(counts(k1), before))
        out["steps"].append({"loss": loss.item(), "launches": got})
        print(f"train RDUNet(128) flax f32 step {i}: loss {loss.item():.6f}, (launches, tc, "
              f"wide) {got}", flush=True)
        if not math.isfinite(loss.item()) or got != want:
            fail(f"RDUNet(128) step {i}: loss {loss.item()}, (launches, tc, wide) {got}, want "
                 f"{want}")
    out["launches"] = dict(zip(("all", "tc", "wide"), counts(k1)))
    moved = sum(int(not torch.equal(v.detach().cpu(), init[k]))
                for k, v in state.params.items())
    finite = all(bool(torch.isfinite(v).all()) for v in state.params.values())
    out["params_moved"] = f"{moved} of {len(state.params)}"
    print(f"RDUNet(128) after {TRAIN_STEPS} steps: {out['params_moved']} tensors moved, "
          f"finite {finite}", flush=True)
    if moved == 0 or not finite:
        fail(f"RDUNet(128) steps: {moved} tensors moved, finite {finite}")
    out["step_ms"] = cuda_ms(torch, lambda: trainer.train_step(state, *batches[0]), 3)
    print(f"train step RDUNet(128) {SUPERVISED128_BATCH}x256x256 acc {acc} flax f32: "
          f"{out['step_ms']:.2f} ms", flush=True)
    del trainer, state
    torch.cuda.empty_cache()

    after, losses = {}, {}
    for engine in ("flax", "xla"):
        trainer, state = make(engine)
        opt = torch.optim.SGD(list(state.params.values()), lr=1e-2)
        sgd = TrainState(state.params, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda k: 1.0),
                         clip_norm=1.0)
        _, loss = make_supervised_train_step(trainer.forward_fn, acc)(
            sgd, *(trainer.put(t) for t in batches[0]))
        losses[engine] = loss.item()
        after[engine] = {k: v.detach() for k, v in state.params.items()}
        del trainer, state, sgd, opt
    worst = max(((v - after["flax"][k]).abs() / (STEP_ATOL + STEP_RTOL * v.abs())).max().item()
                for k, v in after["xla"].items())
    out["sgd_vs_xla"] = {"losses": losses, "worst_over_tol": worst}
    print(f"RDUNet(128) SGD step, flax vs xla: loss {losses['flax']:.7f} vs {losses['xla']:.7f}; "
          f"params worst |diff| / (atol {STEP_ATOL} + rtol {STEP_RTOL}*|p|) = {worst:.3f} "
          "(must be <= 1)", flush=True)
    if abs(losses["flax"] - losses["xla"]) > LOSS_RTOL * abs(losses["xla"]) or worst > 1:
        fail("the RDUNet(128) step through the kernel disagrees with the xla step")
    del after
    torch.cuda.empty_cache()
    return out


class TimedLoader:
    """Batches that record a CUDA event as each is handed out and once after
    the last: the card's time of each round of the loop that consumes them."""

    def __init__(self, torch, batches):
        self.torch, self.batches, self.events = torch, batches, []

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        self.events = []
        for batch in self.batches:
            self.events.append(self.torch.cuda.Event(enable_timing=True))
            self.events[-1].record()
            yield batch
        self.events.append(self.torch.cuda.Event(enable_timing=True))
        self.events[-1].record()

    def round_ms(self):
        self.events[-1].synchronize()
        return [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]


def gan_pairs(torch, device, n, shape, seed):
    """``n`` (degraded, gt) grayscale pairs: smooth fields in [-1, 1] (cells
    of 16 pixels, bilinear) plus Gaussian noise at sigma 25."""
    import torch.nn.functional as F

    gen = torch.Generator(device=device).manual_seed(seed)
    pairs = []
    for _ in range(n):
        b, c, h, w = shape
        coarse = torch.rand(b, c, h // 16, w // 16, generator=gen, device=device) * 2 - 1
        gt = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
        pairs.append((gt + SIGMA * torch.randn(gt.shape, generator=gen, device=device), gt))
    return pairs


def make_gan(kind, device, side, checkpoint_dir, seed=0):
    """(trainer, state) of one GAN of the family, critic built for ``side``."""
    from vub_image_denoising_tpu_torch.train.denoising_gan import DenoisingGANTrainer
    from vub_image_denoising_tpu_torch.train.gan import RCAGANTrainer, rca_gan_diffusion_trainer

    if kind == "rca_gan":
        trainer = RCAGANTrainer(disc_input_hw=side, checkpoint_dir=checkpoint_dir, device=device,
                                seed=seed)
        return trainer, trainer.init(steps_per_epoch=GAN_ROUNDS)
    if kind == "attention_gan":
        trainer = DenoisingGANTrainer(checkpoint_dir=checkpoint_dir, device=device, seed=seed)
        return trainer, trainer.init(steps_per_epoch=GAN_ROUNDS)
    return rca_gan_diffusion_trainer(GAN_ROUNDS, side, checkpoint_dir=checkpoint_dir,
                                     device=device, seed=seed)


def state_tensors(torch, state):
    """Every tensor of a GAN state: both nets' state_dicts and both
    optimizers' per-parameter state."""
    out = {}
    for name in ("generator", "discriminator"):
        out.update({f"{name}.{k}": v for k, v in getattr(state, name).state_dict().items()})
    for name in ("g_opt", "d_opt"):
        for i, st in getattr(state, name).state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": v for k, v in st.items() if torch.is_tensor(v)})
    return out


def gan_train_run(torch, device, kind, tmp):
    """One GAN at full width: GAN_ROUNDS rounds (D step + G step) of its
    trainer's ``fit`` on 256^2 pairs, batch 8, one epoch, a checkpoint
    written and read back into a fresh state equal; finite losses, params
    that move; ms per round (CUDA events)."""
    ck = os.path.join(tmp, kind)
    trainer, state = make_gan(kind, device, GAN_SIDE, ck)
    before = {f"{n}.{k}": v.detach().clone()
              for n in ("generator", "discriminator")
              for k, v in getattr(state, n).named_parameters()}
    loader = TimedLoader(torch, gan_pairs(torch, device, GAN_ROUNDS,
                                          (GAN_BATCH, 1, GAN_SIDE, GAN_SIDE), 5))
    val = gan_pairs(torch, device, 1, (GAN_BATCH, 1, GAN_SIDE, GAN_SIDE), 6)
    t0 = time.perf_counter()
    state, history = trainer.fit(state, loader, val, num_epochs=1, checkpoint_every=1)
    rounds = loader.round_ms()
    sec = time.perf_counter() - t0
    losses = {k: v for k, v in history[0].items() if k.endswith("loss")}
    after = {f"{n}.{k}": v.detach() for n in ("generator", "discriminator")
             for k, v in getattr(state, n).named_parameters()}
    moved = {n: sum(int(not torch.equal(v, before[k])) for k, v in after.items()
                    if k.startswith(n)) for n in ("generator", "discriminator")}
    finite = all(bool(torch.isfinite(v).all()) for v in after.values())
    del before
    fresh_trainer, fresh = make_gan(kind, device, GAN_SIDE, ck, seed=1)
    if kind == "attention_gan":
        for name, module in (("generator", fresh.generator),
                             ("discriminator", fresh.discriminator)):
            module.load_state_dict(torch.load(os.path.join(
                ck, f"{fresh_trainer.checkpoint_prefix}_{name}_1.pth"), weights_only=True),
                strict=True)
        want = {k: v for k, v in state_tensors(torch, state).items()
                if k.startswith(("generator.", "discriminator."))}
    else:
        epoch = fresh_trainer.load_checkpoint(fresh, os.path.join(ck, "checkpoint_epoch_1.pth"))
        if epoch != 1:
            fail(f"{kind}: the checkpoint says epoch {epoch}, want 1")
        want = state_tensors(torch, state)
    got = state_tensors(torch, fresh)
    equal = set(want) <= set(got) and all(torch.equal(got[k].to(v.device), v)
                                          for k, v in want.items())
    files = sorted(os.listdir(ck))
    del fresh, fresh_trainer, got, want
    out = {"losses": losses, "round_ms": rounds, "fit_sec": sec, "params_moved": moved,
           "checkpoint_files": files, "checkpoint_equal": equal}
    print(f"gan {kind} {GAN_BATCH}x1x{GAN_SIDE}x{GAN_SIDE}: {GAN_ROUNDS} rounds, ms per round "
          f"{', '.join(f'{r:.1f}' for r in rounds)}; losses {losses}; params moved {moved}; "
          f"checkpoint {files} read back equal: {equal}; fit {sec:.1f} s", flush=True)
    if not all(math.isfinite(v) for v in losses.values()) or not finite:
        fail(f"gan {kind}: losses {losses}, params finite {finite}")
    if not all(moved.values()) or not equal:
        fail(f"gan {kind}: params moved {moved}, checkpoint read back equal {equal}")
    del trainer, state, loader, val
    torch.cuda.empty_cache()
    return out


def gan_round(torch, kind, device, dtype, weights, batch, draws, tmp):
    """One D step and one G step of ``kind`` on ``device`` in ``dtype`` from
    ``weights`` (G, D and VGG state_dicts) and the given draws, the
    optimizers at lr 0: (D loss, G loss, D's clipped grads, G's), on the CPU
    in f64."""
    trainer, state = make_gan(kind, device, GAN_CHECK_SHAPE[-1], tmp)
    for module, sd in zip((state.generator, state.discriminator, trainer.vgg), weights):
        module.load_state_dict(sd)
        module.to(dtype)
    for net, opt, sched in (("generator", "g_opt", "g_sched"),
                            ("discriminator", "d_opt", "d_sched")):
        o = torch.optim.SGD(getattr(state, net).parameters(), lr=0.0)
        setattr(state, opt, o)
        setattr(state, sched, torch.optim.lr_scheduler.LambdaLR(o, lambda k: 1.0))
    x, y = (t.to(device, dtype) for t in batch)
    eps_d, eps_g, t, noise = (v.to(device, dtype if v.is_floating_point() else v.dtype)
                              for v in draws)
    if kind == "attention_gan":
        d_loss = trainer.d_step(state, x, y, alpha=eps_d)
        d_grads = {k: p.grad.double().cpu() for k, p in state.discriminator.named_parameters()}
        g_loss = trainer.g_step(state, x, y)[0]
    else:
        g_draws = (t, noise) if kind == "hybrid" else None
        d_loss = trainer.d_step(state, x, y, eps=eps_d, g_draws=g_draws)
        d_grads = {k: p.grad.double().cpu() for k, p in state.discriminator.named_parameters()}
        g_loss = trainer.g_step(state, x, y, eps=eps_g, g_draws=g_draws)[0]
    g_grads = {k: p.grad.double().cpu() for k, p in state.generator.named_parameters()}
    return d_loss.item(), g_loss.item(), d_grads, g_grads


def round_errors(a, b):
    """Of two rounds (``gan_round``), b the reference: the losses' relative
    errors and, for each net, the worst |grad diff| / (GAN_RTOL*|g| +
    GAN_ATOL_OF_MAX * max|g|) (``grads_over_tol``), the worst leaf's max
    |grad diff| / (GAN_F32_GRAD_OF_LEAF * its max|g| + GAN_F32_GRAD_FLOOR *
    max|g|) (``grads_f32_excess``; each <= 1 holds), and max |grad diff| /
    max|g|."""
    out = {"d_loss_rel": abs(a[0] - b[0]) / abs(b[0]), "g_loss_rel": abs(a[1] - b[1]) / abs(b[1])}
    for net, i in (("d", 2), ("g", 3)):
        gmax = max(g.abs().max().item() for g in b[i].values())
        out[f"{net}_grads_over_tol"] = max(
            ((a[i][k] - g).abs() / (GAN_RTOL * g.abs() + GAN_ATOL_OF_MAX * gmax)).max().item()
            for k, g in b[i].items())
        out[f"{net}_grads_f32_excess"] = max(
            (a[i][k] - g).abs().max().item()
            / (GAN_F32_GRAD_OF_LEAF * g.abs().max().item() + GAN_F32_GRAD_FLOOR * gmax)
            for k, g in b[i].items())
        out[f"{net}_grads_of_max"] = max((a[i][k] - g).abs().max().item()
                                         for k, g in b[i].items()) / gmax
    return out


def f32_round_held(e):
    """An f32 round's ``round_errors`` against the f64 round within the
    GAN_F32_* limits."""
    return (max(e["d_loss_rel"], e["g_loss_rel"]) <= GAN_F32_LOSS_RTOL
            and max(e["d_grads_f32_excess"], e["g_grads_f32_excess"]) <= 1)


def gan_card_vs_cpu(torch, device, kind, tmp):
    """One round of ``kind`` at GAN_CHECK_SHAPE on the card against the same
    round on the CPU, from the same weights and draws, TF32 off and cuDNN
    deterministic: in f64, losses to GAN_RTOL and clipped gradients to
    GAN_RTOL / GAN_ATOL_OF_MAX * max|g|.  The critic's batch-2 BatchNorm and
    the penalty's second derivatives make a round's f32 rounding alone move
    gradients by up to a few percent of max|g| on either device, so the f32
    rounds, the card's (the program trained above) and the CPU's, are each
    held to the CPU's f64 round within the GAN_F32_* limits instead."""
    trainer, state = make_gan(kind, "cpu", GAN_CHECK_SHAPE[-1], tmp)
    weights = tuple({k: v.clone() for k, v in m.state_dict().items()}
                    for m in (state.generator, state.discriminator, trainer.vgg))
    del trainer, state
    gen = torch.Generator().manual_seed(7)
    batch = gan_pairs(torch, "cpu", 1, GAN_CHECK_SHAPE, 8)[0]
    n, _, h, w = GAN_CHECK_SHAPE
    draws = (torch.rand(n, 1, 1, 1, generator=gen), torch.rand(n, 1, 1, 1, generator=gen),
             torch.randint(0, 1000, (n,), generator=gen),
             torch.randn(n, 64, h, w, generator=gen))
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        rounds = {(dev, str(dt).split(".")[-1]): gan_round(torch, kind, dev, dt, weights, batch,
                                                           draws, tmp)
                  for dev in ("cpu", device) for dt in (torch.float64, torch.float32)}
    finally:
        torch.backends.cudnn.deterministic = det
    cpu64, card64 = rounds[("cpu", "float64")], rounds[(device, "float64")]
    out = {"f64_card_vs_cpu": round_errors(card64, cpu64),
           "f32_card_vs_cpu": round_errors(rounds[(device, "float32")], rounds[("cpu", "float32")]),
           "f32_card_vs_f64": round_errors(rounds[(device, "float32")], cpu64),
           "f32_cpu_vs_f64": round_errors(rounds[("cpu", "float32")], cpu64)}
    e = out["f64_card_vs_cpu"]
    print(f"gan {kind} one round {GAN_CHECK_SHAPE}, card vs CPU: f64 {e} (losses <= {GAN_RTOL}, "
          f"grads_over_tol <= 1); f32 card vs CPU {out['f32_card_vs_cpu']}; f32 card vs f64 "
          f"{out['f32_card_vs_f64']}; f32 CPU vs f64 {out['f32_cpu_vs_f64']} (f32 vs f64: "
          f"losses <= {GAN_F32_LOSS_RTOL}, grads_f32_excess <= 1)", flush=True)
    if not (e["d_loss_rel"] <= GAN_RTOL and e["g_loss_rel"] <= GAN_RTOL
            and e["d_grads_over_tol"] <= 1 and e["g_grads_over_tol"] <= 1):
        fail(f"gan {kind}: the round on the card disagrees with the CPU's in f64: {e}")
    for name in ("f32_card_vs_f64", "f32_cpu_vs_f64"):
        if not f32_round_held(out[name]):
            fail(f"gan {kind}: {name} beyond the f32 limits: {out[name]}")
    return out


def gan_main_path(torch, device):
    """Phase 15: the RCA-GAN, the attention-U-Net GAN and the diffusion-GAN
    hybrid trained on the card (``gan_train_run``) and one round of each
    held to the CPU's (``gan_card_vs_cpu``)."""
    out = {}
    phase_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for kind in ("rca_gan", "attention_gan", "hybrid"):
            out[kind] = gan_train_run(torch, device, kind, tmp)
            out[kind]["card_vs_cpu"] = gan_card_vs_cpu(torch, device, kind, tmp)
            shutil.rmtree(os.path.join(tmp, kind), ignore_errors=True)
    out["phase_sec"] = time.perf_counter() - phase_t0
    print(f"gan phase: {out['phase_sec']:.1f} s", flush=True)
    return out


# Phase 16: the wide form at the widths it refused before: RDUNet(152) on a
# 128^2 image (304 at 64^2, 608 at 32^2, 1216 at 16^2), base 80's and 88's
# third level (320, 352 at 32^2), a ragged image, and two widths whose
# channels are no multiple of 16 bytes (258: base 129's second level, inner
# 129; 260: base 65's third, inner 130), which take the element-wise loads.
PARTIAL_SHAPES = [(1, 304, 64, 64), (1, 320, 32, 32), (1, 352, 32, 32), (1, 608, 32, 32),
                  (1, 1216, 16, 16), (2, 304, 20, 36), (1, 258, 64, 64), (1, 260, 32, 32)]
PARTIAL_PACKED_SHAPE = (1, 608, 32, 32)
RDUNET152_SIDE = 128
# RDUNet(152)'s widths on a 128^2 image, blocks per forward: c = 152 takes the
# fused tensor-core body in bf16 and the wide form in f32, the others the
# wide form.
RDUNET152_BLOCKS = [(152, 4), (304, 4), (608, 4), (1216, 2)]
# Phase 17: the search space's new widths (base_filters 16 and 48) at batch 8
# on 256^2 patches, and base 48's deepest block (the wide form); each below
# 256 also timed on the kernels its route does not take (the CUDA cores, the
# wide form).  Then other bases' widths below 256 at batch 8, on the wide
# form beside the CUDA cores: base 40's (16-byte channel runs) and base
# 25's 25 and 50 (none: the wide form's element-wise loads); and kernel 2 at
# the search's widths that trainable blocks run packed.
SEARCH_SHAPES = [(8, 16, 256, 256), (8, 48, 256, 256), (8, 96, 128, 128), (8, 192, 64, 64),
                 (8, 384, 32, 32)]
OTHER_WIDTH_SHAPES = [(8, 40, 256, 256), (8, 80, 128, 128), (8, 160, 64, 64),
                      (8, 25, 256, 256), (8, 50, 128, 128)]
SEARCH_PACKED_SHAPES = [(8, 16, 256, 256), (8, 48, 256, 256), (8, 96, 128, 128)]
# Seconds per fixed trial (phase 19) when the blocks below 256 outside
# {32, 64, 128, 256} ran on the CUDA-core kernel (NVIDIA H100 80GB HBM3, 700 W)
FIXED_TRIAL_SEC_CUDA_CORE = {16: 2.1, 48: 22.6}
# Phase 18: module-level remat, kernel-1 launches per train step (accumulation
# 4): 14 forward per micro-batch, and one recompute per rematerialized block.
REMAT_LAUNCHES = {False: 56, True: 112, "highres": 88}
REMAT_STEPS = 2
# Phase 19: the searches on the card, their trials cut to a fraction of the
# phase-11 folder (one epoch of a few steps each).
SEARCH_TRIALS, GAN_SEARCH_TRIALS, SEARCH_PERCENTAGE = 3, 2, 0.35
FIXED_TRIALS = ({"base_filters": 16, "timesteps": 10, "optimizer_choice": "adamw",
                 "scheduler_choice": "step", "lr": 1e-4, "weight_decay": 1e-4},
                {"base_filters": 48, "timesteps": 10, "optimizer_choice": "adam",
                 "scheduler_choice": "cosine", "lr": 1e-4})
# Phase 20: the comparative runner: RDUNet(128) (its default U-Net) and
# RDUNetT-32 at T = 20 on batches of 8 x 256^2, and the card against the CPU
# on one batch of 2 x 128^2 with BM3D (the CPU tests' tolerances).
COMPARE_BATCHES, COMPARE_SIGMAS = 2, (15.0, 30.0)
COMPARE_CHECK_SHAPE = (2, 3, 128, 128)
COMPARE_PSNR_TOL, COMPARE_TOL = 1e-3, 1e-5


def variant_counts(counter, before):
    """(all, tensor cores, wide, CUDA cores) launched since ``before``."""
    a, t, w = (x - y for x, y in zip(counts(counter), before))
    return {"all": a, "tc": t, "wide": w, "cuda_core": a - t}


def check_block_shapes(torch, device, shapes, label):
    """Kernel 1 against the plain block at ``shapes`` in f32 (F32_TOL) and
    bf16 (BF16_REL_TOL of max|y|), each one launch of the variant
    ``block_variant`` names; timed beside the plain cuDNN block (TF32 off)
    and the bound (f32 as 3xTF32, the least an f32-exact block can take on
    this card; on the CUDA cores also at the f32 FMA peak).  Below 256 the
    kernels the route does not take (the CUDA-core kernel, the wide form)
    are launched directly on the same input, uncounted, held to the same
    tolerance and timed beside it (``alt_ms``); the fused route's tiles too
    (``tile_sweep_ms``).  Returns the records."""
    from vub_image_denoising_tpu_torch.ops import fused_block as fb

    k1 = fb.fused_denoising_block
    want_counts = {"tc_wide": (1, 1, 1, 0), "tc": (1, 1, 0, 0)}
    records = []
    for shape in shapes:
        n, c, h, w = shape
        params = block_params(torch, c, seed=c, device=device)
        gen = torch.Generator(device=device).manual_seed(1)
        x32 = torch.randn(shape, generator=gen, device=device)
        ref32 = fb.fused_denoising_block_plain(x32, params)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            e = dtype.itemsize
            x = x32.to(dtype).contiguous(memory_format=torch.channels_last)
            kw = fb.pack_block_params(params, dtype, device)
            variant = fb.block_variant(dtype, c)
            before = counts(k1)
            y = k1(x, params, kw)
            torch.cuda.synchronize()
            got = variant_counts(k1, before)
            plain = lambda v: fb.fused_denoising_block_plain(v, params)
            err_same, err_ref, ok, tol = held(torch, plain, y, x, ref32)
            big = c * h * w > 2 ** 20
            rec = {"shape": shape, "dtype": name, "variant": variant, "max_abs_err": err_same,
                   "max_abs_err_vs_f32": err_ref, "ms": cuda_ms(torch, lambda: k1(x, params, kw),
                                                                10),
                   "plain_ms": cuda_ms(torch, lambda: plain(x), 5), "library_ms": None}
            rec["bound_ms"], rec["bound_by"] = bound_ms(shape, name, x.element_size())
            if dtype == torch.float32:
                rec["cuda_core_bound_ms"] = bound_ms(shape, name, 4, "cuda_core")[0]
            rec["tile"] = tile_report(shape, dtype)
            print(f"check {label} {shape} {name} ({variant}): max_abs_err vs plain({name}) "
                  f"{err_same:.3e}, vs reference {err_ref:.3e} ({tol}) -> "
                  f"{'ok' if ok else 'FAIL'}; kernel {rec['ms']:.4f} ms, plain (cuDNN) "
                  f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})"
                  + (f", f32 FMA bound {rec['cuda_core_bound_ms']:.4f} ms"
                     if "cuda_core_bound_ms" in rec else "")
                  + f", {block_flops_tflops(shape, rec['ms']):.2f} TFLOP/s; {rec['tile']}",
                  flush=True)
            if tuple(got.values()) != want_counts[variant]:
                fail(f"kernel 1 at {shape} {name}: counted {got}, want {variant} once")
            if not ok:
                fail(f"kernel 1 ({variant}) disagrees with the plain block at {shape} {name}")
            alts = {}
            if c < 256:
                alts["cuda_core"] = lambda: fb._launch("fused_denoising_block", fb._library(),
                                                       "fused_block", x, kw, n, h, w, c, c // 2)
                alts["tc_wide"] = lambda: fb._launch_wide("fused_denoising_block", x, kw, n, h,
                                                          w, c, c // 2, fb.wide_smem_bytes(e))
            rec["alt_ms"], rec["alt_max_abs_err"] = {}, {}
            for alt, fn in alts.items():
                if alt == variant:
                    continue
                y_alt = fn()
                torch.cuda.synchronize()
                err_alt, _, ok_alt, _ = held(torch, plain, y_alt, x, ref32)
                rec["alt_max_abs_err"][alt] = err_alt
                rec["alt_ms"][alt] = cuda_ms(torch, fn, 3 if alt == "cuda_core" and big else 10)
                if not ok_alt:
                    fail(f"kernel 1's {alt} kernel disagrees with the plain block at {shape} "
                         f"{name} (max abs err {err_alt})")
            if variant == "tc":
                rec["tile_sweep_ms"] = tile_sweep(torch, fb, x, kw)
            print(f"time {label} {shape} {name}: route {variant} {rec['ms']:.4f} ms; "
                  + "".join(f"{k} {v:.4f} ms, " for k, v in rec["alt_ms"].items())
                  + f"cuDNN {rec['plain_ms']:.4f} ms", flush=True)
            records.append(rec)
        del params, x32, ref32, x, y, kw
    return records


def check_packed_shapes(torch, device, shapes, label):
    """Kernel 2 at ``shapes``, f32 and bf16: one launch of kernel 1's
    variant, and its output, unpacked, equal to kernel 1's on the same image
    bit for bit; timed beside kernel 1.  Returns the records."""
    from vub_image_denoising_tpu_torch.ops import fused_block as fb
    from vub_image_denoising_tpu_torch.ops.packing import pack2x2, unpack2x2

    k1, k2 = fb.fused_denoising_block, fb.fused_denoising_block_packed
    records = []
    for shape in shapes:
        c = shape[1]
        params = block_params(torch, c, seed=c, device=device)
        pq = fb.pack_block_params_packed(params)
        x32 = torch.randn(shape, generator=torch.Generator(device=device).manual_seed(1),
                          device=device).contiguous(memory_format=torch.channels_last)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x = x32.to(dtype)
            xq = pack2x2(x)
            kw2 = fb.kernel_weights_from_packed(pq, dtype)
            kw1 = fb.pack_block_params(params, dtype, device)
            before = counts(k2)
            yq = k2(xq, pq, kw2)
            torch.cuda.synchronize()
            got = variant_counts(k2, before)
            y1 = k1(x, params, kw1)
            torch.cuda.synchronize()
            diff = (unpack2x2(yq).float() - y1.float()).abs().max().item()
            same = torch.equal(unpack2x2(yq), y1)
            variant = fb.block_variant(dtype, c)
            want = {"all": 1, "tc": 1, "wide": int(variant == "tc_wide"), "cuda_core": 0}
            rec = {"shape": shape, "dtype": name, "variant": variant, "launches": got,
                   "kernel1_max_abs_diff": diff,
                   "ms": cuda_ms(torch, lambda: k2(xq, pq, kw2), 10),
                   "kernel1_ms": cuda_ms(torch, lambda: k1(x, params, kw1), 10)}
            print(f"check packed {label} {shape} {name} ({variant}): unpacked vs kernel 1 "
                  f"max abs diff {diff} (must be 0.0); launches {got}; kernel 2 "
                  f"{rec['ms']:.4f} ms, kernel 1 {rec['kernel1_ms']:.4f} ms", flush=True)
            if not same or got != want:
                fail(f"kernel 2 at {shape} {name}: diff {diff}, counted {got}, want {want}")
            records.append(rec)
        del params, pq, x32, x, xq
    return records


def partial_widths_main_path(torch, device):
    """Phase 16: the wide form at PARTIAL_SHAPES, and RDUNet(152)'s c = 152
    blocks on 128^2 (the fused tensor-core body in bf16, the wide form in
    f32); kernel 2's wide form at
    PARTIAL_PACKED_SHAPE unpacked equal to kernel 1 bit for bit; the f32
    RDUNet(152) forward on a 128^2 image against the CPU's (SERVED_F32_TOL),
    all 14 blocks on the tensor cores, none on the CUDA cores (in f32 the
    c = 152 blocks take the wide form too)."""
    from vub_image_denoising_tpu_torch.models import RDUNet
    from vub_image_denoising_tpu_torch.ops import fused_block as fb

    out = {"per_shape": check_block_shapes(
        torch, device, PARTIAL_SHAPES + [(1, 152, RDUNET152_SIDE, RDUNET152_SIDE)], "width")}
    out["packed"] = check_packed_shapes(torch, device, [PARTIAL_PACKED_SHAPE], "partial width")
    k1 = fb.fused_denoising_block

    model = RDUNet(3, 152, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.rand(1, 3, RDUNET152_SIDE, RDUNET152_SIDE,
                   generator=torch.Generator().manual_seed(3)) * 2 - 1
    with torch.no_grad():
        want = model(x)
        gpu = model.to(device).to(memory_format=torch.channels_last)
        xd = x.to(device).contiguous(memory_format=torch.channels_last)
        reset_counts(k1)
        y = gpu(xd)
        torch.cuda.synchronize()
        got = variant_counts(k1, (0, 0, 0))
        err = (y.cpu() - want).abs().max().item()
        out["rdunet152"] = {"launches": got, "max_abs_err_vs_cpu": err,
                            "forward_ms": {"f32": cuda_ms(torch, lambda: gpu(xd), 5),
                                           "bf16": cuda_ms(torch,
                                                           lambda: gpu(xd.to(torch.bfloat16)), 5)}}
    wide = sum(n for c, n in RDUNET152_BLOCKS
               if fb.block_variant(torch.float32, c) == "tc_wide")
    want_counts = {"all": 14, "tc": 14, "wide": wide, "cuda_core": 0}
    print(f"RDUNet(152) forward 1x{RDUNET152_SIDE}^2: f32 vs the CPU forward max abs err "
          f"{err:.3e} (<= {SERVED_F32_TOL}); launches {got} (want {want_counts}); f32 "
          f"{out['rdunet152']['forward_ms']['f32']:.3f} ms, bf16 "
          f"{out['rdunet152']['forward_ms']['bf16']:.3f} ms", flush=True)
    if got != want_counts or not err <= SERVED_F32_TOL:
        fail(f"RDUNet(152) forward: launches {got}, f32 error {err}")
    return out


def remat_main_path(torch, device):
    """Phase 18: DiffusionTrainer(engine="flax") on RDUNetT-32, 8 x 256^2,
    accumulation 4, f32, REMAT_STEPS steps under each remat mode: kernel-1
    launches per step REMAT_LAUNCHES, all on the tensor cores, finite
    losses; the peak memory and the step's ms; one SGD step under each mode
    equal to remat=False's (STEP_RTOL / STEP_ATOL)."""
    from vub_image_denoising_tpu_torch.ops.fused_block import fused_denoising_block as k1
    from vub_image_denoising_tpu_torch.train import (DiffusionTrainer, TrainState,
                                                     make_diffusion_train_step)

    batches = make_batches(torch, device)[:REMAT_STEPS]

    def trainer_for(mode):
        trainer = DiffusionTrainer(base_filters=BASE_FILTERS, timesteps=TIMESTEPS,
                                   accumulation_steps=ACCUMULATION, engine="flax", remat=mode)
        return trainer, trainer.init(steps_per_epoch=TRAIN_STEPS, seed=0)

    out, sgd = {}, {}
    for mode, want in REMAT_LAUNCHES.items():
        trainer, state = trainer_for(mode)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = {"launches": [], "losses": [], "step_ms": []}
        for noisy, clean in batches:
            reset_counts(k1)
            t0 = time.perf_counter()
            state, loss = trainer.train_step(state, noisy, clean)
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["launches"].append(variant_counts(k1, (0, 0, 0)))
            rec["losses"].append(loss.item())
        rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        print(f"remat={mode!r} diffusion train RDUNetT-32 {TRAIN_BATCH}x256x256 acc "
              f"{ACCUMULATION} f32: losses {rec['losses']}, step ms {rec['step_ms']}, launches "
              f"per step {[r['all'] for r in rec['launches']]} (want {want}, all on the tensor "
              f"cores), peak memory {rec['peak_memory_bytes'] / 2 ** 30:.3f} GiB", flush=True)
        if (not all(math.isfinite(v) for v in rec["losses"])
                or any((r["all"], r["tc"]) != (want, want) for r in rec["launches"])):
            fail(f"remat={mode!r}: losses {rec['losses']}, launches {rec['launches']}")
        del trainer, state
        trainer, state = trainer_for(mode)
        opt = torch.optim.SGD(list(state.params.values()), lr=1e-2)
        sgd_state = TrainState(state.params, opt,
                               torch.optim.lr_scheduler.LambdaLR(opt, lambda k: 1.0),
                               clip_norm=trainer.clip_norm)
        make_diffusion_train_step(trainer.unet_apply, trainer.diffusion, ACCUMULATION)(
            sgd_state, trainer.generator, *batches[0])
        sgd[mode] = {k: v.detach().clone() for k, v in state.params.items()}
        out[repr(mode)] = rec
        del trainer, state, opt, sgd_state
    for mode in (True, "highres"):
        worst = max(((v - sgd[mode][k]).abs() / (STEP_ATOL + STEP_RTOL * v.abs())).max().item()
                    for k, v in sgd[False].items())
        out[repr(mode)]["sgd_step_worst_vs_plain"] = worst
        print(f"remat={mode!r} SGD step vs remat=False: params worst |diff| / (atol "
              f"{STEP_ATOL} + rtol {STEP_RTOL}*|p|) = {worst:.3f} (must be <= 1)", flush=True)
        if worst > 1:
            fail(f"remat={mode!r} trains another model than remat=False")
    return out


class FixedTrial:
    """A search trial that answers every suggestion from ``values`` (for
    timing chosen widths through ``objective``); it never prunes."""

    def __init__(self, values, number):
        self.values, self.number, self.params, self.reports = values, number, {}, []

    def _take(self, name, *args, **kwargs):
        self.params[name] = self.values[name]
        return self.values[name]

    suggest_int = suggest_float = suggest_categorical = _take

    def report(self, value, step):
        self.reports.append((step, value))

    def should_prune(self):
        return False


def csv_header(path):
    with open(path) as f:
        return f.readline().strip().split(",")


def search_main_path(torch, device):
    """Phase 19: ``run_search`` (SEARCH_TRIALS trials x 1 epoch) on loaders
    from the phase-11 folder, ``objective`` on FIXED_TRIALS (base 16 and 48
    at T = 10: every width from 16 to 384), ``run_gan_search``
    (GAN_SEARCH_TRIALS x 1 epoch) on grayscale 256^2 pairs: the trial CSVs'
    headers in pandas' column order, finite values, kernel-1 launches per
    trial split by variant (each trial's steps and samplers, all through the
    kernels), seconds per trial."""
    from vub_image_denoising_tpu_torch.data.loader import load_data
    from vub_image_denoising_tpu_torch.ops import fused_block as fb
    from vub_image_denoising_tpu_torch.ops.fused_block import fused_denoising_block as k1
    from vub_image_denoising_tpu_torch.search import gan_search, hyperparams
    from vub_image_denoising_tpu_torch.search.optuna_compat import TrialPruned

    out = {"trials": [], "fixed": [], "gan_trials": []}
    with tempfile.TemporaryDirectory() as tmp:
        write_folder(tmp)
        train_loader, val_loader = load_data(
            os.path.join(tmp, "DIV2K_train_HR.nosync"), batch_size=TRAIN_BATCH,
            dataset_percentage=SEARCH_PERCENTAGE, use_rgb=True, device=device, seed=0)
        steps = len(train_loader)

        def want_launches(trial):
            # the epoch's micro-batch forwards, and two samplers (the epoch's
            # report and the returned value) of 14 * T forwards
            return 14 * ACCUMULATION * steps + 2 * 14 * trial.params["timesteps"]

        def counted(objective, records):
            def run(trial, *args, **kwargs):
                before = counts(k1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pruned = False
                try:
                    value = objective(trial, *args, **kwargs)
                except TrialPruned:
                    # pruned after the epoch's report: one sampler, no value
                    value, pruned = None, True
                torch.cuda.synchronize()
                rec = {"number": trial.number, "params": dict(trial.params), "value": value,
                       "pruned": pruned, "sec": time.perf_counter() - t0,
                       "launches": variant_counts(k1, before)}
                records.append(rec)
                want = want_launches(trial) - (14 * trial.params["timesteps"] if pruned else 0)
                print(f"search trial {trial.number} {rec['params']}: "
                      + ("pruned" if pruned else f"-psnr {value:.4f}")
                      + f", {rec['sec']:.1f} s, kernel-1 launches {rec['launches']} (want "
                      f"{want})", flush=True)
                if rec["launches"]["all"] != want or not (pruned or math.isfinite(value)):
                    fail(f"search trial {trial.number}: value {value}, launches "
                         f"{rec['launches']}")
                if pruned:
                    raise TrialPruned()
                return value
            return run

        csv_path = os.path.join(tmp, "trial_results.csv")
        objective = hyperparams.objective
        hyperparams.objective = counted(objective, out["trials"])
        try:
            study = hyperparams.run_search(train_loader, val_loader, n_trials=SEARCH_TRIALS,
                                           num_epochs=1, csv_path=csv_path, seed=0)
        finally:
            hyperparams.objective = objective
        header = []
        for t in study.trials:
            header += [k for k in (*t.params, "psnr") if k not in header]
        out["csv_header"] = csv_header(csv_path)
        if out["csv_header"] != header or len(study.trials) != SEARCH_TRIALS:
            fail(f"search CSV header {out['csv_header']}, want {header}")

        for i, values in enumerate(FIXED_TRIALS):
            trial = FixedTrial(values, 100 + i)
            counted(objective, out["fixed"])(trial, train_loader, val_loader, num_epochs=1,
                                             output_root=os.path.join(tmp, "fixed"))
            rec, forwards = out["fixed"][-1], want_launches(trial) // 14
            base = values["base_filters"]
            widths = [base, 2 * base, 4 * base, 8 * base]
            wide = sum(4 if level < 3 else 2 for level, c in enumerate(widths)
                       if fb.block_variant(torch.float32, c) == "tc_wide")
            want = {"all": 14 * forwards, "tc": 14 * forwards, "wide": wide * forwards,
                    "cuda_core": 0}
            print(f"fixed trial base {base}: {rec['sec']:.1f} s (with CUDA-core blocks: "
                  f"{FIXED_TRIAL_SEC_CUDA_CORE[base]} s), launches {rec['launches']}", flush=True)
            if rec["launches"] != want:
                fail(f"fixed trial base {base}: launches {rec['launches']}, want {want}")

        gen_train = gan_pairs(torch, device, 2, (GAN_BATCH, 1, GAN_SIDE, GAN_SIDE), seed=21)
        gen_val = gan_pairs(torch, device, 1, (GAN_BATCH, 1, GAN_SIDE, GAN_SIDE), seed=22)
        gan_csv = os.path.join(tmp, "gan_trials.csv")
        objective_gan = gan_search.objective_gan

        def timed_gan(trial, *args, **kwargs):
            torch.cuda.synchronize()
            t0, value = time.perf_counter(), None
            try:
                value = objective_gan(trial, *args, **kwargs)
            finally:
                torch.cuda.synchronize()
                out["gan_trials"].append({"number": trial.number, "params": dict(trial.params),
                                          "value": value, "pruned": value is None,
                                          "reported": getattr(trial, "intermediate", {}).get(0),
                                          "sec": time.perf_counter() - t0})
                print(f"gan search trial {trial.number}: val L1 reported "
                      f"{out['gan_trials'][-1]['reported']}, "
                      + ("pruned" if value is None else "completed")
                      + f", {out['gan_trials'][-1]['sec']:.1f} s", flush=True)
            return value

        gan_search.objective_gan = timed_gan
        try:
            gan_search.run_gan_search(gen_train, gen_val, n_trials=GAN_SEARCH_TRIALS,
                                      num_epochs=1, csv_path=gan_csv, device=device)
        finally:
            gan_search.objective_gan = objective_gan
        out["gan_csv_header"] = csv_header(gan_csv)
        want = ["lambda_pixel", "lambda_perceptual", "lambda_edge", "lr", "val_l1"]
        if (out["gan_csv_header"] != want or len(out["gan_trials"]) != GAN_SEARCH_TRIALS
                or not all(t["reported"] is not None and math.isfinite(t["reported"])
                           for t in out["gan_trials"])):
            fail(f"gan search: header {out['gan_csv_header']}, trials {out['gan_trials']}")
    out["train_steps_per_trial"] = steps
    return out


def compare_batches(torch, device, shape, sigmas, seed):
    """(degraded, gt, sigma) batches: smooth RGB fields in [-1, 1] plus
    Gaussian noise at each sigma (of 255)."""
    import torch.nn.functional as F

    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for sigma in sigmas:
        n, c, h, w = shape
        coarse = torch.rand(n, c, h // 16, w // 16, generator=gen, device=device) * 2 - 1
        gt = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
        noisy = gt + (sigma / 127.5) * torch.randn(gt.shape, generator=gen, device=device)
        out.append((noisy.clamp(-1, 1), gt, torch.full((n,), sigma, device=device)))
    return out


def compare_main_path(torch, device):
    """Phase 20: ``eval.compare.evaluate_models`` (the metric loop of
    ``evaluate_model_and_plot``, no figures) on seeded random-weight
    checkpoints saved as reference .pth files, RDUNet(128) and RDUNetT-32 at
    T = 20, LPIPS and DISTS on seeded synthetic weights: COMPARE_BATCHES
    batches of 8 x 256^2, timed, kernel 1 launched 14 times per U-Net
    forward and 14 * T per sampler call, all on the tensor cores; then one
    batch of 2 x 128^2 with BM3D on the card and on the CPU (TF32 off): the
    metric tables equal to COMPARE_PSNR_TOL (dB) and COMPARE_TOL."""
    from vub_image_denoising_tpu_torch.eval.compare import KEYS, VARIANTS, evaluate_models
    from vub_image_denoising_tpu_torch.models import RDUNet, RDUNetT
    from vub_image_denoising_tpu_torch.ops.fused_block import fused_denoising_block as k1
    from vub_image_denoising_tpu_torch.utils.checkpoint import save_pth

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        unet_path, diff_path = os.path.join(tmp, "rdunet128.pth"), os.path.join(tmp, "diff.pth")
        save_pth(unet_path, RDUNet(3, 128, generator=torch.Generator().manual_seed(0)).state_dict())
        save_pth(diff_path, RDUNetT(BASE_FILTERS, generator=torch.Generator().manual_seed(1))
                 .state_dict(), epoch=1, prefix="unet.")
        kwargs = dict(epochs=[1], diffusion_model_paths=[diff_path], unet_model_path=unet_path,
                      include_noise_level=True, timesteps=TIMESTEPS, unet_base_filters=128,
                      diffusion_base_filters=BASE_FILTERS)
        batches = compare_batches(torch, device, (TRAIN_BATCH, 3, IMAGE_SIZE, IMAGE_SIZE),
                                  COMPARE_SIGMAS[:COMPARE_BATCHES], seed=31)
        reset_counts(k1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev = evaluate_models(val_loader=batches, device=device, **kwargs)
        torch.cuda.synchronize()
        out["sec"] = time.perf_counter() - t0
        got = variant_counts(k1, (0, 0, 0))
        per_batch = 14 + 14 * TIMESTEPS
        want = {"all": COMPARE_BATCHES * per_batch, "tc": COMPARE_BATCHES * per_batch,
                "wide": COMPARE_BATCHES * 6, "cuda_core": 0}
        out["launches"] = got
        out["unet_ms"] = [t * 1e3 for t in ev.inference_times["unet"]]
        out["sampler_ms"] = [t * 1e3 for t in ev.inference_times["diffusion"]]
        out["means"] = {f"{k}_{v}": float(sum(ev.metrics[f"{k}_{v}"]) / len(ev.metrics[f"{k}_{v}"]))
                        for k in KEYS for v in VARIANTS if v != "bm3d"}
        print(f"compare {COMPARE_BATCHES} x {TRAIN_BATCH}x256x256 (RDUNet(128), RDUNetT-32 "
              f"T={TIMESTEPS}): {out['sec']:.1f} s; U-Net ms per batch {out['unet_ms']}, sampler "
              f"ms per batch {out['sampler_ms']}; kernel-1 launches {got} (want {want}); means "
              f"{out['means']}", flush=True)
        if got != want or not all(math.isfinite(v) for v in out["means"].values()):
            fail(f"compare: launches {got}, means {out['means']}")

        small = compare_batches(torch, device, COMPARE_CHECK_SHAPE, COMPARE_SIGMAS[1:], seed=32)
        t0 = time.perf_counter()
        card_ev = evaluate_models(val_loader=small, device=device, use_bm3d=True, **kwargs)
        cpu_ev = evaluate_models(val_loader=[tuple(t.cpu() for t in b) for b in small],
                                 device="cpu", use_bm3d=True, **kwargs)
        out["check_sec"] = time.perf_counter() - t0
        worst = {}
        for k in KEYS:
            for v in VARIANTS:
                a, b = card_ev.metrics[f"{k}_{v}"], cpu_ev.metrics[f"{k}_{v}"]
                if v == "bm3d" and k in ("lpips", "dists"):
                    continue
                worst[f"{k}_{v}"] = max(abs(x - y) for x, y in zip(a, b))
        out["card_vs_cpu"] = worst
        bad = {key: e for key, e in worst.items()
               if not e <= (COMPARE_PSNR_TOL if key.startswith("psnr") else COMPARE_TOL)}
        print(f"compare card vs CPU, {COMPARE_CHECK_SHAPE} with BM3D: worst |diff| {worst} "
              f"(psnr <= {COMPARE_PSNR_TOL} dB, others <= {COMPARE_TOL}); "
              f"{out['check_sec']:.1f} s", flush=True)
        if bad:
            fail(f"compare: the card's metrics differ from the CPU's: {bad}")
    return out


def step_breakdown(torch, trainer, state, batch, step_ms):
    """Split one "pallas" step: forward (kernel-1 blocks, the rest), backward
    (the eager blocks' recompute, the rest), the optimizer (clip, AdamW,
    schedule), and what is left (gradient sums, launch gaps)."""
    from vub_image_denoising_tpu_torch.models.fused_apply import (_dense_block_xla,
                                                                  block_kernel_weights)
    from vub_image_denoising_tpu_torch.ops.fused_block import (fused_denoising_block,
                                                               pack_block_params)
    from vub_image_denoising_tpu_torch.train.supervised import l1_loss

    dtype = trainer.compute_dtype
    noisy, clean = (trainer.put(t) for t in batch)
    mb = TRAIN_BATCH // ACCUMULATION
    params = list(state.params.values())

    def forward(with_backward, once=True):
        """The step's micro-batch forwards (and backwards): the kernel
        weights built once for them, as the step builds them, or with
        ``once=False`` by every forward, as many packs as before they were
        shared."""
        kw = {"kernel_weights": block_kernel_weights(state.params, dtype)} if once else {}
        for i in range(ACCUMULATION):
            sl = slice(i * mb, (i + 1) * mb)
            loss = l1_loss(trainer.forward_fn(state.params, noisy[sl].to(dtype), **kw).float(),
                           clean[sl].float())
            if with_backward:
                grads = torch.autograd.grad(loss, params)
        return grads if with_backward else None

    # in turns: packed by every forward, once, once, by every forward
    times = [cuda_ms(torch, lambda: forward(False, once), 3) for once in (False, True, True, False)]
    fwd_ms, fwd_repack_ms = min(times[1:3]), min(times[0], times[3])
    fwd_bwd_ms = cuda_ms(torch, lambda: forward(True), 3)
    grads = forward(True)
    opt_ms = cuda_ms(torch, lambda: state.apply_gradients(grads), 5)
    blocks_ms = recompute_ms = 0.0
    for (n, c, h, w), count in SLICE_SHAPES:
        x = torch.randn(mb, c, h, w, device=noisy.device, dtype=dtype).contiguous(
            memory_format=torch.channels_last)
        p = {k: v.detach() for k, v in block_params(torch, c, c, noisy.device).items()}
        kw = pack_block_params(p, dtype, x.device)
        with torch.no_grad():
            blocks_ms += count * ACCUMULATION * cuda_ms(
                torch, lambda: fused_denoising_block(x, p, kw), 3)
        for t in (x, *p.values()):  # the recompute builds the graph the backward uses
            t.requires_grad_()
        recompute_ms += count * ACCUMULATION * cuda_ms(torch, lambda: _dense_block_xla(p, x), 3)
    out = {"step_ms": step_ms, "forward_ms": fwd_ms, "forward_blocks_ms": blocks_ms,
           "forward_glue_and_loss_ms": fwd_ms - blocks_ms,
           "forward_glue_and_loss_repacking_ms": fwd_repack_ms - blocks_ms,
           "backward_ms": fwd_bwd_ms - fwd_ms, "backward_recompute_ms": recompute_ms,
           "backward_rest_ms": fwd_bwd_ms - fwd_ms - recompute_ms,
           "optimizer_ms": opt_ms, "unattributed_ms": step_ms - fwd_bwd_ms - opt_ms,
           "forward_share": fwd_ms / step_ms}
    print(f"pallas step breakdown {str(dtype).split('.')[-1]}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in out.items()), flush=True)
    return out


def trace_steps(torch, fn, steps):
    """``steps`` calls of fn under torch.profiler: wall and device-busy ms
    per step, the idle share of the traced window (1 - busy / wall), and
    the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        if (us > 0 and "CUDA" in str(ev.device_type)
                and not getattr(ev, "is_user_annotation", False)):  # e.g. Optimizer.step spans
            kernels[ev.key] = (us / 1e3 / steps, ev.count // steps)
    busy = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_ms_per_step": wall_ms / steps, "device_busy_ms_per_step": busy,
            "idle_share": 1 - busy / (wall_ms / steps),
            "top_kernels": [{"name": k[:120], "ms_per_step": ms, "launches_per_step": n}
                            for k, (ms, n) in top]}


def profile_main(torch, device):
    """``--profile``: where one train step of the train phase (same trainer,
    same first batch) spends the card's time, in a process that runs
    nothing else.  For bf16 then f32, engines "pallas" and "xla": step times
    by CUDA events in turns (pallas, xla, xla, pallas), then TRAIN_STEPS
    traced steps of each.  Prints one JSON line of those numbers."""
    from vub_image_denoising_tpu_torch.models import RDUNet

    init = RDUNet(3, BASE_FILTERS, generator=torch.Generator().manual_seed(0)).state_dict()
    batch = make_batches(torch, device)[0]
    out = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        fns = {}
        for engine in ("pallas", "xla"):
            trainer, state = make_trainer(torch, init, engine, dtype)
            fns[engine] = lambda t=trainer, st=state: t.train_step(st, *batch)
        times = {e: [] for e in fns}
        for e in ("pallas", "xla", "xla", "pallas"):
            times[e].append(cuda_ms(torch, fns[e], 3))
        for e, fn in fns.items():
            rec = {"step_ms_runs": times[e], **trace_steps(torch, fn, TRAIN_STEPS)}
            out[f"{e}_{name}"] = rec
            print(f"profile {e} {name}: step {', '.join(f'{t:.2f}' for t in times[e])} ms (CUDA "
                  f"events); traced wall {rec['wall_ms_per_step']:.2f} ms, device busy "
                  f"{rec['device_busy_ms_per_step']:.2f} ms, idle share {rec['idle_share']:.3f}",
                  flush=True)
            print_top_kernels(rec)
    out.update(profile_sampler(torch))
    print(json.dumps({"profile": out}), flush=True)


def print_top_kernels(rec):
    for k in rec["top_kernels"]:
        print(f"    {k['ms_per_step']:9.3f} ms  x{k['launches_per_step']:<4d} {k['name']}",
              flush=True)


def profile_sampler(torch):
    """One served batch of 8 through the diffusion sampler (T = TIMESTEPS,
    RDUNetT-32 from seed 0), bf16 and f32, traced: the card's busy time and
    idle share, and the kernels by time (a layout copy per block would show
    as a copy kernel launched 14*T times)."""
    from vub_image_denoising_tpu_torch.eval.denoise_cli import build_apply
    from vub_image_denoising_tpu_torch.models import RDUNetT
    from vub_image_denoising_tpu_torch.utils.checkpoint import save_pth

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "rdunet_t32.pth")
        save_pth(ck, RDUNetT(BASE_FILTERS, generator=torch.Generator().manual_seed(0)).state_dict(),
                 prefix="unet.")
        for name, bf16 in (("bf16", True), ("f32", False)):
            forward, model = build_apply(ck, "diffusion", BASE_FILTERS, TIMESTEPS, bf16=bf16)
            x = torch.rand(8, IMAGE_SIZE, IMAGE_SIZE, 3,
                           device=next(model.parameters()).device) * 2 - 1
            rec = trace_steps(torch, lambda: forward(x), 1)
            out[f"sampler_{name}"] = rec
            print(f"profile sampler {name}: traced wall {rec['wall_ms_per_step']:.2f} ms per batch "
                  f"of 8, device busy {rec['device_busy_ms_per_step']:.2f} ms, idle share "
                  f"{rec['idle_share']:.3f}", flush=True)
            print_top_kernels(rec)
    return out


# Phase 21: ahead-of-time export (eval/export.py).  Each artifact is traced
# on the card from seeded weights, saved, and loaded and called in a fresh
# process at both batches from the one file.
EXPORT_CASES = (("rdunet_f32", "rdunet", False), ("rdunet_bf16", "rdunet", True),
                ("sampler_f32", "diffusion", False))
EXPORT_BATCHES = (8, 3)
EXPORT_TIMESTEPS = 4  # the exported sampler's T, cut from 20 (its trace time grows with T)
# Phase 22: two ranks on the one card (gloo; NCCL refuses two ranks on one
# GPU): the trainers' steps under each param sharding, tiles, tensor
# parallelism, the pipelined sampler.
MULTI_WORLD, TILE_SIDE, PP_MICROBATCH = 2, 2048, 2
PARAM_SHARDINGS = ("replicated", "fsdp", "tp")
# ... and spatially partitioned training: one image of SPATIAL_SIDE^2, its
# rows split in MULTI_WORLD bands, two "flax" SGD steps at accumulation 1 of
# each trainer (the diffusion step with SSIM on, whose window takes a halo of
# its own), then one banded diffusion validate on 1 x 3 x SPATIAL_VAL_SIDE^2
SPATIAL_SIDE, SPATIAL_VAL_SIDE = 2048, 512
SPATIAL_DIFFUSION_WEIGHTS = (0.0, 1.0, 0.3)  # mse, charbonnier, ssim
TILE_RTOL, TILE_ATOL = 1e-4, 1e-5  # tests/test_tiles_and_tb.py:30
MULTI_TOL = 1e-4                   # TP forward, pipelined sampler (__graft_entry__.py:159,180)


def seeded_checkpoints(torch, tmp):
    """RDUNet-32 and RDUNetT-32 (``unet.`` keys) from seed 0, as .pth files."""
    from vub_image_denoising_tpu_torch.models import RDUNet, RDUNetT
    from vub_image_denoising_tpu_torch.utils.checkpoint import save_pth

    cks = {"rdunet": os.path.join(tmp, "rdunet32.pth"),
           "diffusion": os.path.join(tmp, "rdunet_t32.pth")}
    save_pth(cks["rdunet"], RDUNet(3, BASE_FILTERS,
                                   generator=torch.Generator().manual_seed(0)).state_dict())
    save_pth(cks["diffusion"], RDUNetT(BASE_FILTERS, generator=torch.Generator().manual_seed(0))
             .state_dict(), prefix="unet.")
    return cks


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def export_main_path(torch, device):
    """Phase 21 (module docstring): the artifacts of EXPORT_CASES against the
    module path on the card; returns the records."""
    import numpy as np

    from vub_image_denoising_tpu_torch.eval.denoise_cli import build_apply
    from vub_image_denoising_tpu_torch.eval.export import (build_exported, kernel_nodes,
                                                           save_exported)

    phase_t0 = time.perf_counter()
    out = {"cases": {}}
    with tempfile.TemporaryDirectory() as tmp:
        cks = seeded_checkpoints(torch, tmp)
        rng = np.random.RandomState(21)
        xs = {b: torch.from_numpy(rng.uniform(-1, 1, (b, IMAGE_SIZE, IMAGE_SIZE, 3))
                                  .astype(np.float32)) for b in EXPORT_BATCHES}
        torch.save(xs, os.path.join(tmp, "inputs.pt"))
        refs = {}
        for name, arch, bf16 in EXPORT_CASES:
            t0 = time.perf_counter()
            programs = build_exported(cks[arch], arch, BASE_FILTERS, EXPORT_TIMESTEPS,
                                      size=IMAGE_SIZE, bf16=bf16, platforms=(device.type,))
            export_sec = time.perf_counter() - t0
            nodes = kernel_nodes(programs[device.type])
            path = save_exported(programs, os.path.join(tmp, f"{name}.pt2"))
            want = 14 * (EXPORT_TIMESTEPS if arch == "diffusion" else 1)
            forward, _ = build_apply(cks[arch], arch, BASE_FILTERS, EXPORT_TIMESTEPS, bf16=bf16,
                                     device=device)
            x8 = xs[8].to(device)
            refs[name] = {b: forward(x.to(device)).cpu() for b, x in xs.items()}
            ms = cuda_ms(torch, lambda: forward(x8), 2 if arch == "diffusion" else 10)
            out["cases"][name] = {"export_sec": export_sec, "kernel_nodes": nodes,
                                  "artifact_mb": os.path.getsize(path) / 1e6, "module_ms": ms}
            print(f"export {name}: traced in {export_sec:.1f} s, {nodes} kernel-1 operator nodes "
                  f"(want {want}), {os.path.getsize(path) / 1e6:.1f} MB; module path {ms:.3f} ms "
                  f"per batch of 8", flush=True)
            if nodes != want:
                fail(f"export {name}: {nodes} kernel operator nodes, want {want}")
        # a fresh process loads each artifact from its file and calls it
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--export-worker", tmp],
                              capture_output=True, text=True, timeout=900)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            fail(f"the export worker failed:\n{proc.stderr[-4000:]}")
        got = torch.load(os.path.join(tmp, "export_results.pt"))
        for name, arch, bf16 in EXPORT_CASES:
            rec, res = out["cases"][name], got[name]
            per_call = 14 * (EXPORT_TIMESTEPS if arch == "diffusion" else 1)
            errs = {b: max_err(res["y"][b], refs[name][b]) for b in EXPORT_BATCHES}
            scale = refs[name][8].abs().max().item()
            tol = (BF16_REL_TOL * scale if bf16 else 2 * EXPORT_TIMESTEPS * SERVED_F32_TOL
                   if arch == "diffusion" else SERVED_F32_TOL)
            rec.update({"artifact_ms": res["ms"], "load_sec": res["load_sec"],
                        "launches": res["launches"], "max_abs_err": max(errs.values()),
                        "tol": tol})
            print(f"export {name} artifact in a fresh process: loaded in {res['load_sec']:.1f} s, "
                  f"{res['ms']:.3f} ms per batch of 8 (module path {rec['module_ms']:.3f} ms); "
                  f"launches per call {res['launches']} (want {per_call}, all on the tensor "
                  f"cores); max_abs_err vs the module path {errs} (tol {tol:.3g})", flush=True)
            if any(v != {"all": per_call, "tc": per_call} for v in res["launches"].values()):
                fail(f"export {name}: launches per call {res['launches']}, want {per_call}")
            if any(tuple(res["y"][b].shape) != (b, IMAGE_SIZE, IMAGE_SIZE, 3)
                   for b in EXPORT_BATCHES) or max(errs.values()) > tol:
                fail(f"export {name}: the artifact's output disagrees with the module path")
    out["launches"] = sum(sum(v["all"] for v in rec["launches"].values())
                          for rec in out["cases"].values())
    out["phase_sec"] = time.perf_counter() - phase_t0
    print(f"export phase: {out['phase_sec']:.1f} s", flush=True)
    return out


def export_worker(tmp):
    """``--export-worker``: load each artifact of phase 21 in this fresh
    process, call it at EXPORT_BATCHES, count the launches, time batch 8."""
    import torch

    sys.path.insert(0, ROOT)
    from vub_image_denoising_tpu_torch import enable_strict_precision
    from vub_image_denoising_tpu_torch.eval.export import load_exported
    from vub_image_denoising_tpu_torch.ops.fused_block import fused_denoising_block as fb

    enable_strict_precision()  # f32 convs without TF32, as build_apply sets it
    xs = torch.load(os.path.join(tmp, "inputs.pt"))
    results = {}
    for name, arch, _ in EXPORT_CASES:
        t0 = time.perf_counter()
        fn = load_exported(os.path.join(tmp, f"{name}.pt2"))
        load_sec = time.perf_counter() - t0
        res = {"load_sec": load_sec, "y": {}, "launches": {}}
        for b in EXPORT_BATCHES:
            x = xs[b].cuda()
            before, tc_before = fb.launches, fb.tc_launches
            res["y"][b] = fn(x).cpu()
            res["launches"][b] = {"all": fb.launches - before, "tc": fb.tc_launches - tc_before}
        x8 = xs[8].cuda()
        res["ms"] = cuda_ms(torch, lambda: fn(x8), 2 if arch == "diffusion" else 10)
        results[name] = res
        print(f"export worker {name}: loaded, called at {EXPORT_BATCHES}", flush=True)
    torch.save(results, os.path.join(tmp, "export_results.pt"))


class _SGD:
    """An optimizer spec for ``TrainState.create``: SGD(1e-2), a flat
    schedule, the trainer's clip (the recipe of ``compare_with_xla``)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def build(self, leaves):
        import torch

        opt = torch.optim.SGD(list(leaves), lr=1e-2)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda k: 1.0)


def multi_device_trainer(torch, kind, mode, cks, device):
    """The phase-22 trainer of ``kind`` under ``param_sharding=mode`` on
    RDUNet(T)-32 from seed 0, engine "flax", acc 4, f32."""
    from vub_image_denoising_tpu_torch.models import RDUNet
    from vub_image_denoising_tpu_torch.train import DiffusionTrainer, SupervisedTrainer
    from vub_image_denoising_tpu_torch.utils.checkpoint import load_pth

    if kind == "supervised":
        model, _ = load_pth(cks["rdunet"], RDUNet(3, BASE_FILTERS))
        trainer = SupervisedTrainer(model, accumulation_steps=ACCUMULATION, engine="flax",
                                    device=device, param_sharding=mode)
        return trainer, trainer.init(steps_per_epoch=TRAIN_STEPS), model
    trainer = DiffusionTrainer(base_filters=BASE_FILTERS, timesteps=TIMESTEPS,
                               accumulation_steps=ACCUMULATION, engine="flax", device=device,
                               param_sharding=mode)
    state = trainer.init(steps_per_epoch=TRAIN_STEPS, seed=0)
    return trainer, state, trainer.unet


def multi_device_sgd_step(torch, kind, mode, cks, device, batch, rows=None):
    """One accumulate -> clip -> SGD(1e-2) step of the phase-22 trainer on
    ``batch`` (this rank's ``rows`` of it, where the batch is split);
    returns (params after, global loss, ms, kernel-1 launches, sharded
    fraction)."""
    from vub_image_denoising_tpu_torch.ops.fused_block import fused_denoising_block as fb
    from vub_image_denoising_tpu_torch.parallel.fsdp import sharded_fraction
    from vub_image_denoising_tpu_torch.train import TrainState

    trainer, state, model = multi_device_trainer(torch, kind, mode, cks, device)
    sgd = TrainState.create(state.params, _SGD(trainer.clip_norm), state.parallel)
    noisy, clean = (t.to(device) for t in batch)
    if rows is not None and mode != "tp":
        noisy, clean = noisy[rows[0]:rows[1]], clean[rows[0]:rows[1]]
    noisy = noisy.contiguous(memory_format=torch.channels_last)
    clean = clean.contiguous(memory_format=torch.channels_last)
    args = (sgd, noisy, clean) if kind == "supervised" else (sgd, trainer.generator, noisy, clean)
    torch.cuda.synchronize()
    before = fb.launches
    t0 = time.perf_counter()
    _, loss = trainer._step(*args)
    loss = float(trainer.global_mean(loss))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    params = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    return params, loss, ms, fb.launches - before, sharded_fraction(state)


def spatial_sgd_steps(torch, cks, device, batch, layout, kind="supervised", val=None):
    """Two "flax" SGD steps (f32, accumulation 1) on one image under
    ``batch_sharding=layout`` (``"spatial"``: this rank's band): of RDUNet-32
    (``kind="supervised"``) or of ``DiffusionTrainer``'s RDUNetT-32 from seed
    0 with loss weights SPATIAL_DIFFUSION_WEIGHTS, its timesteps drawn from
    the trainer's seed-0 generator alike in every process
    (``"diffusion"``).  Returns the params and global loss after the first;
    per step the kernel-1 launches (all, tensor-core), the gloo host copies,
    DenoisingBlock inputs that were not channels_last (each a layout copy
    before the kernel), ms (the second step: the first picks cuDNN's
    algorithms), and the second step's peak memory, absolute and above what
    was allocated before it.  With ``val`` (a (noisy, clean) pair) the
    diffusion trainer then runs ``validate`` on it: its loss, its output
    (gathered from the bands), launches and ms."""
    from vub_image_denoising_tpu_torch.models import RDUNet
    from vub_image_denoising_tpu_torch.nn.blocks import DenoisingBlock
    from vub_image_denoising_tpu_torch.ops.fused_block import fused_denoising_block as fb
    from vub_image_denoising_tpu_torch.parallel import mesh as pm
    from vub_image_denoising_tpu_torch.train import DiffusionTrainer, SupervisedTrainer, TrainState
    from vub_image_denoising_tpu_torch.utils.checkpoint import load_pth

    if kind == "supervised":
        model, _ = load_pth(cks["rdunet"], RDUNet(3, BASE_FILTERS))
        trainer = SupervisedTrainer(model, accumulation_steps=1, engine="flax", device=device,
                                    batch_sharding=layout)
        state = trainer.init(steps_per_epoch=TRAIN_STEPS)
    else:
        trainer = DiffusionTrainer(base_filters=BASE_FILTERS, timesteps=TIMESTEPS,
                                   accumulation_steps=1, loss_weights=SPATIAL_DIFFUSION_WEIGHTS,
                                   engine="flax", device=device, batch_sharding=layout)
        state = trainer.init(steps_per_epoch=TRAIN_STEPS, seed=0)
        model = trainer.unet
    sgd = TrainState.create(state.params, _SGD(trainer.clip_norm), state.parallel)
    noisy, clean = (trainer.put(t) for t in batch)
    step_args = (sgd, noisy, clean) if kind == "supervised" else (sgd, trainer.generator, noisy,
                                                                  clean)
    not_cl = []
    hooks = [m.register_forward_pre_hook(lambda m, a: not_cl.append(
        not a[0].is_contiguous(memory_format=torch.channels_last)))
        for m in model.modules() if isinstance(m, DenoisingBlock)]
    out = {"rows": noisy.shape[2], "steps": []}
    try:
        for i in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            allocated = torch.cuda.memory_allocated()
            before = (fb.launches, fb.tc_launches, pm.host_copies(), len(not_cl))
            t0 = time.perf_counter()
            _, loss = trainer._step(*step_args)
            loss = float(trainer.global_mean(loss))
            torch.cuda.synchronize()
            out["steps"].append({
                "ms": (time.perf_counter() - t0) * 1e3, "launches": fb.launches - before[0],
                "tc_launches": fb.tc_launches - before[1],
                "host_copies": pm.host_copies() - before[2],
                "layout_copies": sum(not_cl[before[3]:]),
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "peak_above_bytes": torch.cuda.max_memory_allocated() - allocated})
            if i == 0:
                out["loss"] = loss
                out["params"] = {k: v.detach().cpu().clone()
                                 for k, v in model.state_dict().items()}
        if val is not None:
            torch.cuda.synchronize()
            before = (fb.launches, fb.tc_launches, pm.host_copies(), len(not_cl))
            t0 = time.perf_counter()
            vloss, y = trainer.validate(state, [val])
            torch.cuda.synchronize()
            out["validate"] = {
                "ms": (time.perf_counter() - t0) * 1e3, "loss": vloss, "y": y.float().cpu(),
                "launches": fb.launches - before[0], "tc_launches": fb.tc_launches - before[1],
                "host_copies": pm.host_copies() - before[2],
                "layout_copies": sum(not_cl[before[3]:])}
    finally:
        for h in hooks:
            h.remove()
    return out


def multi_device_main_path(torch, device):
    """Phase 22 (module docstring): two gloo ranks on the card against one
    process, and one nccl rank through the CLI's init path."""
    import numpy as np

    phase_t0 = time.perf_counter()
    out = {"world": MULTI_WORLD, "backend": "gloo (two ranks share cuda:0)"}
    with tempfile.TemporaryDirectory() as tmp:
        cks = seeded_checkpoints(torch, tmp)
        gen = torch.Generator().manual_seed(22)
        clean = torch.rand(TRAIN_BATCH, 3, IMAGE_SIZE, IMAGE_SIZE, generator=gen) * 2 - 1
        batch = (clean + SIGMA * torch.randn(clean.shape, generator=gen), clean)
        clean = torch.rand(1, 3, SPATIAL_SIDE, SPATIAL_SIDE, generator=gen) * 2 - 1
        spatial_batch = (clean + SIGMA * torch.randn(clean.shape, generator=gen), clean)
        clean = torch.rand(1, 3, SPATIAL_VAL_SIDE, SPATIAL_VAL_SIDE, generator=gen) * 2 - 1
        spatial_val = (clean + SIGMA * torch.randn(clean.shape, generator=gen), clean)
        rng = np.random.RandomState(22)
        inp = {"batch": batch, "cks": cks, "spatial_batch": spatial_batch,
               "spatial_val": spatial_val,
               "tile": (rng.uniform(-1, 1, (TILE_SIDE, TILE_SIDE, 3)) * 0.5).astype(np.float32),
               "x8": rng.uniform(-1, 1, (8, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)}
        torch.save(inp, os.path.join(tmp, "inputs.pt"))

        # one process: the references and their times
        refs, one = {}, {}
        for kind in ("supervised", "diffusion"):
            refs[kind] = multi_device_sgd_step(torch, kind, "replicated", cks, device, batch)
            one[f"{kind}_step_ms"] = refs[kind][2]
        refs["spatial"] = spatial_sgd_steps(torch, cks, device, spatial_batch, "batch")
        refs["spatial_diffusion"] = spatial_sgd_steps(torch, cks, device, spatial_batch, "batch",
                                                      "diffusion", spatial_val)
        for key in ("spatial", "spatial_diffusion"):
            one[key] = {k: v for k, v in refs[key].items() if k != "params"}
            print(f"{key} reference, one process, 1 x 3 x {SPATIAL_SIDE}^2: steps "
                  f"{[round(st['ms'], 1) for st in one[key]['steps']]} ms, kernel-1 launches "
                  f"{[st['launches'] for st in one[key]['steps']]}", flush=True)
        one["spatial_diffusion"]["validate"] = {
            k: v for k, v in refs["spatial_diffusion"]["validate"].items() if k != "y"}
        from vub_image_denoising_tpu_torch.eval.denoise_cli import build_apply

        forward, _ = build_apply(cks["rdunet"], "rdunet", BASE_FILTERS, device=device)
        tile_x = torch.from_numpy(inp["tile"])[None].to(device)
        x8 = torch.from_numpy(inp["x8"]).to(device)
        refs["tiles"] = forward(tile_x)[0].cpu().numpy()
        one["tiles_ms"] = cuda_ms(torch, lambda: forward(tile_x), 2)
        refs["tp_forward"] = forward(x8).cpu().numpy()
        one["forward_ms"] = cuda_ms(torch, lambda: forward(x8), 5)
        sampler, _ = build_apply(cks["diffusion"], "diffusion", BASE_FILTERS, TIMESTEPS,
                                 device=device)
        refs["pipeline"] = sampler(x8).cpu().numpy()
        one["sampler_ms"] = cuda_ms(torch, lambda: sampler(x8), 1)
        out["one_process"] = one
        torch.cuda.empty_cache()  # the ranks share the card with this process

        port = free_port()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--multirank-worker",
                                   str(r), str(MULTI_WORLD), port, tmp],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(MULTI_WORLD)]
        try:
            logs = [p.communicate(timeout=900)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for r, log in enumerate(logs):
            print("".join(f"[rank {r}] {line}\n" for line in log.splitlines()
                          if not line.startswith("[W")), end="", flush=True)
        if any(p.returncode != 0 for p in procs):
            fail(f"multi-device ranks failed (rc {[p.returncode for p in procs]})")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)  # the ranks wrote them
                 for r in range(MULTI_WORLD)]

        per_rank = []
        for r, res in enumerate(ranks):
            rec = {"launches": res["launches"], "ms": res["ms"], "host_copies": res["host_copies"],
                   "sharded_fraction": res["fraction"]}
            for kind in ("supervised", "diffusion"):
                ref_params, ref_loss = refs[kind][0], refs[kind][1]
                for mode in PARAM_SHARDINGS:
                    params, loss = res["params"][f"{kind}_{mode}"], res["loss"][f"{kind}_{mode}"]
                    worst = max(((v - ref_params[k]).abs()
                                 / (STEP_ATOL + STEP_RTOL * ref_params[k].abs())).max().item()
                                for k, v in params.items())
                    rec[f"{kind}_{mode}_worst"] = worst
                    print(f"multi-device rank {r} {kind} {mode} SGD step: loss {loss:.7f} vs one "
                          f"process {ref_loss:.7f}; params worst |diff| / (atol {STEP_ATOL} + "
                          f"rtol {STEP_RTOL}*|p|) = {worst:.3f} (must be <= 1); sharded fraction "
                          f"{res['fraction'][f'{kind}_{mode}']:.3f}; "
                          f"{res['launches'][f'{kind}_{mode}']} kernel-1 launches", flush=True)
                    if (worst > 1 or abs(loss - ref_loss) > LOSS_RTOL * abs(ref_loss)
                            or res["launches"][f"{kind}_{mode}"] != 14 * ACCUMULATION):
                        fail(f"rank {r}: the {kind} step under {mode} disagrees with one process")
                    if mode != "replicated" and res["fraction"][f"{kind}_{mode}"] <= 0.5:
                        fail(f"rank {r}: {mode} left most params replicated")
            checks = (("tiles", TILE_RTOL, TILE_ATOL), ("tp_forward", MULTI_TOL, MULTI_TOL),
                      ("pipeline", MULTI_TOL, MULTI_TOL))
            for name, rtol, atol in checks:
                got = res["out"][name]
                err = float(np.abs(got - refs[name]).max())
                rec[f"{name}_max_abs_err"] = err
                ok = got.shape == refs[name].shape and np.allclose(got, refs[name], rtol=rtol,
                                                                   atol=atol)
                print(f"multi-device rank {r} {name}: max_abs_err {err:.3e} vs one process "
                      f"(rtol {rtol}, atol {atol}); {res['launches'][name]} kernel-1 launches, "
                      f"{res['ms'][name]:.1f} ms", flush=True)
                if not ok:
                    fail(f"rank {r}: {name} disagrees with one process")
            rec["spatial"] = check_spatial_rank(r, res["spatial"], refs["spatial"])
            rec["spatial_diffusion"] = check_spatial_rank(r, res["spatial_diffusion"],
                                                          refs["spatial_diffusion"], "diffusion")
            if abs(res["mean"] - 0.5) > 1e-12 or res["host_copies"] == 0:
                fail(f"rank {r}: all_processes_mean {res['mean']}, host copies "
                     f"{res['host_copies']}")
            per_rank.append(rec)
        out["ranks"] = per_rank
        out["cli_nccl"] = nccl_cli_check(torch, tmp, cks)
    out["launches"] = sum(sum(rec["launches"].values()) for rec in out["ranks"])
    out["phase_sec"] = time.perf_counter() - phase_t0
    print(f"multi-device phase: {out['phase_sec']:.1f} s (two ranks share one card: their "
          "times are not a speedup)", flush=True)
    return out


def check_spatial_rank(r, res, ref, kind="supervised"):
    """Phase 22's spatial case of ``kind`` on rank ``r`` against one process:
    params after the first SGD step within STEP_RTOL / STEP_ATOL, the loss
    within LOSS_RTOL, 14 kernel-1 launches a step, all on the tensor cores,
    no layout copy before the kernel; for the diffusion case also the banded
    validate: 14 * TIMESTEPS launches, all on the tensor cores, and its
    gathered output within SERVED_SAMPLER_F32_TOL of one process's.  Prints
    and returns the record."""
    worst = max(((v - ref["params"][k]).abs() / (STEP_ATOL + STEP_RTOL * ref["params"][k].abs()))
                .max().item() for k, v in res["params"].items())
    rec = {k: v for k, v in res.items() if k not in ("params", "validate")}
    rec["worst"] = worst
    print(f"multi-device rank {r} spatial {kind} SGD step, 1 x 3 x {SPATIAL_SIDE}^2 in bands of "
          f"{res['rows']} rows: loss {res['loss']:.7f} vs one process {ref['loss']:.7f}; params "
          f"worst |diff| / (atol {STEP_ATOL} + rtol {STEP_RTOL}*|p|) = {worst:.3f} (must be <= 1)",
          flush=True)
    for i, (st, one) in enumerate(zip(res["steps"], ref["steps"])):
        print(f"multi-device rank {r} spatial {kind} step {i}: {st['ms']:.1f} ms (one process "
              f"{one['ms']:.1f}); {st['launches']} kernel-1 launches, {st['tc_launches']} on the "
              f"tensor cores; {st['host_copies']} gloo host copies; {st['layout_copies']} "
              f"layout copies before the kernel; peak {st['peak_bytes'] / 2**30:.3f} GiB, "
              f"{st['peak_above_bytes'] / 2**30:.3f} above the step's start (one process "
              f"{one['peak_bytes'] / 2**30:.3f}, {one['peak_above_bytes'] / 2**30:.3f})",
              flush=True)
        if (st["launches"] != 14 or st["tc_launches"] != 14 or st["layout_copies"]
                or st["host_copies"] == 0):
            fail(f"rank {r}: the spatial {kind} step {i} launched {st['launches']} blocks "
                 f"({st['tc_launches']} tensor-core), {st['layout_copies']} layout copies")
    if worst > 1 or abs(res["loss"] - ref["loss"]) > LOSS_RTOL * abs(ref["loss"]):
        fail(f"rank {r}: the spatial {kind} step disagrees with one process")
    if "validate" in ref:
        v, one = res["validate"], ref["validate"]
        err = max_err(v["y"], one["y"])
        want = 14 * TIMESTEPS
        rec["validate"] = {k: x for k, x in v.items() if k != "y"}
        rec["validate"]["max_abs_err"] = err
        print(f"multi-device rank {r} banded validate, 1 x 3 x {SPATIAL_VAL_SIDE}^2 at T = "
              f"{TIMESTEPS}: {v['ms']:.1f} ms (one process {one['ms']:.1f}); loss {v['loss']:.7f} "
              f"vs {one['loss']:.7f}; gathered output max_abs_err {err:.3e} vs one process (tol "
              f"{SERVED_SAMPLER_F32_TOL}); {v['launches']} kernel-1 launches (want {want}), "
              f"{v['tc_launches']} on the tensor cores; {v['host_copies']} gloo host copies; "
              f"{v['layout_copies']} layout copies", flush=True)
        if (tuple(v["y"].shape) != tuple(one["y"].shape) or not err <= SERVED_SAMPLER_F32_TOL
                or v["launches"] != want or v["tc_launches"] != want or v["layout_copies"]):
            fail(f"rank {r}: the banded validate disagrees with one process")
    return rec


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def nccl_cli_check(torch, tmp, cks):
    """One nccl rank through denoise_cli's init path (torchrun's environment,
    world 1, --tensor-parallel) against the CLI without a group: the PNGs
    within 1 level."""
    import numpy as np
    from PIL import Image

    img = os.path.join(tmp, "cli_in.png")
    Image.fromarray(np.random.RandomState(3).randint(0, 256, (IMAGE_SIZE, IMAGE_SIZE, 3),
                                                     np.uint8)).save(img)
    outs = {}
    for name, extra_env, flags in (("plain", {}, []),
                                   ("nccl", {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": free_port(),
                                             "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"},
                                    ["--tensor-parallel"])):
        outs[name] = os.path.join(tmp, f"cli_{name}.png")
        proc = subprocess.run(
            [sys.executable, "-m", "vub_image_denoising_tpu_torch.eval.denoise_cli",
             "--checkpoint", cks["rdunet"], "--input", img, "--output", outs[name], *flags],
            capture_output=True, text=True, timeout=600, cwd=ROOT, env={**os.environ, **extra_env})
        if proc.returncode != 0:
            fail(f"denoise_cli ({name}) failed:\n{proc.stderr[-3000:]}")
    a, b = (np.asarray(Image.open(outs[k]), np.int16) for k in ("plain", "nccl"))
    diff = int(np.abs(a - b).max())
    print(f"denoise_cli --tensor-parallel on one nccl rank (torchrun's environment) vs without a "
          f"group: max diff {diff} levels (tol 1)", flush=True)
    if diff > 1:
        fail("the nccl CLI run disagrees with the plain one")
    return {"max_diff_levels": diff}


def multirank_worker(rank, world, port, tmp):
    """``--multirank-worker``: one of phase 22's ranks (gloo, on cuda:0)."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from vub_image_denoising_tpu_torch import enable_strict_precision
    from vub_image_denoising_tpu_torch.eval.denoise_cli import build_denoiser
    from vub_image_denoising_tpu_torch.eval.sidd_cli import load_sampler
    from vub_image_denoising_tpu_torch.ops.fused_block import fused_denoising_block as fb
    from vub_image_denoising_tpu_torch.parallel import mesh as pm

    enable_strict_precision()
    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    pm.init_distributed("gloo", f"tcp://127.0.0.1:{port}", world, rank)
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)  # written by the parent
    cks = inp["cks"]
    res = {"params": {}, "loss": {}, "launches": {}, "ms": {}, "fraction": {}, "out": {}}
    lo = rank * TRAIN_BATCH // world
    for kind in ("supervised", "diffusion"):
        for mode in PARAM_SHARDINGS:
            key = f"{kind}_{mode}"
            (res["params"][key], res["loss"][key], res["ms"][key], res["launches"][key],
             res["fraction"][key]) = multi_device_sgd_step(
                torch, kind, mode, cks, device, inp["batch"], (lo, lo + TRAIN_BATCH // world))
            print(f"{key} step: {res['ms'][key]:.1f} ms", flush=True)
    res["spatial"] = spatial_sgd_steps(torch, cks, device, inp["spatial_batch"], "spatial")
    res["launches"]["spatial"] = sum(st["launches"] for st in res["spatial"]["steps"])
    res["spatial_diffusion"] = spatial_sgd_steps(torch, cks, device, inp["spatial_batch"],
                                                 "spatial", "diffusion", inp["spatial_val"])
    res["launches"]["spatial_diffusion"] = (
        sum(st["launches"] for st in res["spatial_diffusion"]["steps"])
        + res["spatial_diffusion"]["validate"]["launches"])
    for key in ("spatial", "spatial_diffusion"):
        print(f"{key} steps: {[round(st['ms'], 1) for st in res[key]['steps']]} ms", flush=True)

    def timed(name, fn):
        torch.cuda.synchronize()
        before = fb.launches
        t0 = time.perf_counter()
        y = fn()
        torch.cuda.synchronize()
        res["ms"][name] = (time.perf_counter() - t0) * 1e3
        res["launches"][name] = fb.launches - before
        res["out"][name] = np.asarray(y.cpu() if torch.is_tensor(y) else y)

    tiles = build_denoiser(cks["rdunet"], "rdunet", BASE_FILTERS, device=device, tile_parallel=True)
    timed("tiles", lambda: tiles(inp["tile"]))
    tp = build_denoiser(cks["rdunet"], "rdunet", BASE_FILTERS, device=device, tensor_parallel=True,
                        batched=True)
    timed("tp_forward", lambda: tp(inp["x8"]))
    sampler = load_sampler(cks["diffusion"], BASE_FILTERS, TIMESTEPS, device=device,
                           pipeline_parallel=True, pipeline_microbatch=PP_MICROBATCH)
    timed("pipeline", lambda: sampler(torch.from_numpy(inp["x8"]).to(device)))
    res["mean"] = float(pm.all_processes_mean(float(rank)))
    res["host_copies"] = pm.host_copies()
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    pm.barrier()
    torch.distributed.destroy_process_group()


# Phase 23: the accuracy protocol (scripts/train_accuracy.py), cut: RDUNet-32
# supervised at 256^2, bf16, engine "flax", on PROTOCOL_TRAIN + PROTOCOL_VAL
# synthetic images, batch 32, PROTOCOL_EPOCHS epochs from the device bank,
# a mid_ checkpoint after PROTOCOL_SPLIT of them, then the rest resumed
# from it; the written checkpoint scored on the card and on the CPU in f32;
# a cut diffusion run evaluated through the T = 20 sampler.
PROTOCOL_TRAIN, PROTOCOL_VAL, PROTOCOL_BATCH = 64, 16, 32
PROTOCOL_EPOCHS, PROTOCOL_SPLIT, PROTOCOL_DIFFUSION_EPOCHS = 8, 4, 2
PROTOCOL_ARGS = ["--size", str(IMAGE_SIZE), "--n-train", str(PROTOCOL_TRAIN),
                 "--n-val", str(PROTOCOL_VAL), "--batch-size", str(PROTOCOL_BATCH),
                 "--lr", "3e-4", "--sched-steps-per-epoch", "100", "--device-data",
                 "--eval-every", str(PROTOCOL_SPLIT)]
PROTOCOL_CPU_IMAGES = 8     # held-out images scored on the CPU beside the card
PROTOCOL_PSNR_TOL = 1e-3    # dB, per image, card vs CPU in f32
# Phase 24: the GAN protocol at its recorded settings (the script's defaults:
# 40 epochs of 16 steps, 64^2, batch 16).
GAN_PROTOCOL_ARGS = ["--algo", "attention"]
# Phase 25: the comparative runner on phase 23's two checkpoints, cut to a
# few small images, on the card and on the CPU; then one "xla" supervised
# step of RDUNet-32 under each fused_apply switch in a fresh process.
RUNNER_ARGS = ["--n-images", "3", "--size", "64", "--batch-size", "3",
               "--timesteps", str(TIMESTEPS), "--epoch-label", str(PROTOCOL_DIFFUSION_EPOCHS)]
SWITCH_CASES = {"off": {}, "precombine": {"VUB_PRECOMBINE_MIN_C": "32"},
                "bwd_precombine": {"VUB_BWD_PRECOMBINE": "32"},
                "down_matmul_bwd": {"VUB_DOWN_MATMUL_BWD": "1"}}


# Phase 26: the port's runner scripts, in this process on the card:
# measure_sidd_eval at its defaults (RDUNetT-32, bf16, T = 20, 24 blocks of
# 256^2 a scene) on one scene through two engines, and run_search (2 trials
# of one epoch at 64^2, its other defaults).
SIDD_SCRIPT_ARGS = ["--scenes", "1", "--engines", "flax,pallas"]
# evaluate_sidd's sampler calls per engine: one warm-up, a batch of 8 per
# call over the scene's 24 blocks, two for the device time
SIDD_SCRIPT_CALLS = 1 + 24 // 8 + 2
RUN_SEARCH_ARGS = ["--trials", "2", "--epochs", "1", "--size", "64"]
RUN_SEARCH_STEPS = 64 // 16  # the runner's --n-train over its --batch-size
# ... and the protocol's tooling: the dry runs, the manifest's check, and the
# gap-ssim configuration of run_diffusion_gap (its COMMON flags: batch 128,
# acc 4, bf16, T = 20) cut to GAP_EPOCHS epochs of one step and GAP_VAL
# held-out images (one sampler call an evaluation)
GAP_CONFIG, GAP_EPOCHS, GAP_TRAIN, GAP_VAL = "gap-ssim", 2, 128, 8
GAP_CUT_ARGS = ["--epochs", str(GAP_EPOCHS), "--n-train", str(GAP_TRAIN), "--n-val", str(GAP_VAL)]
# Phase 27: the flagship entry of the manifest, cut in data and epochs only:
# FLAGSHIP_TRAIN + FLAGSHIP_VAL images (FLAGSHIP_TRAIN // 8 steps an epoch),
# FLAGSHIP_EPOCHS epochs, a mid_ checkpoint after FLAGSHIP_SPLIT of them;
# then FLAGSHIP_TIMED steps timed after FLAGSHIP_WARMUP.
FLAGSHIP_TRAIN, FLAGSHIP_VAL, FLAGSHIP_EPOCHS, FLAGSHIP_SPLIT = 32, 8, 3, 2
FLAGSHIP_CUT_ARGS = ["--n-train", str(FLAGSHIP_TRAIN), "--n-val", str(FLAGSHIP_VAL),
                     "--eval-every", str(FLAGSHIP_SPLIT)]
FLAGSHIP_WARMUP, FLAGSHIP_TIMED = 2, 6
# RDUNet(128)'s blocks per forward on the wide form: 4 at c = 512, 2 at 1024
FLAGSHIP_WIDE = 6


class _Tee(io.TextIOBase):
    """Standard output that is also kept."""

    def __init__(self, out):
        self.out, self.lines = out, io.StringIO()

    def write(self, s):
        self.lines.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def make_synthetic(cache):
    """The synthetic images of the protocol phases (23, 26's gap run, 27)
    into ``cache``, where ``train_accuracy`` finds them by recipe; returns
    the seconds."""
    from vub_image_denoising_tpu_torch.scripts import train_accuracy as ta

    t0 = time.perf_counter()
    for n_train, n_val in ((PROTOCOL_TRAIN, PROTOCOL_VAL), (GAP_TRAIN, GAP_VAL),
                           (FLAGSHIP_TRAIN, FLAGSHIP_VAL)):
        ta.synth_train_val(n_train, n_val, IMAGE_SIZE, cache_dir=cache)
    return time.perf_counter() - t0


def run_protocol(torch, ta, argv, per_eval, steps_per_epoch=PROTOCOL_TRAIN // PROTOCOL_BATCH,
                 wide=0):
    """``ta.main(argv)`` on the card with kernel 1's launches counted: those
    of each held-out evaluation apart from the training's.  Fails unless
    every training step (``steps_per_epoch`` an epoch) launched 14 *
    ACCUMULATION blocks, ``wide`` * ACCUMULATION of them on the wide form,
    every evaluation ``per_eval`` (``wide`` * ``per_eval`` / 14 wide), all
    on the tensor cores, and the losses are finite.  Returns the row, the
    losses, the launches and the seconds."""
    import contextlib

    from vub_image_denoising_tpu_torch.ops.fused_block import fused_denoising_block as k1

    evals, evaluate = [], ta.evaluate_psnr

    def counted(*args, **kwargs):
        before = counts(k1)
        out = evaluate(*args, **kwargs)
        evals.append([a - b for a, b in zip(counts(k1), before)])
        return out

    reset_counts(k1)
    tee = _Tee(sys.stdout)
    ta.evaluate_psnr = counted
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            row = ta.main(argv)
    finally:
        ta.evaluate_psnr = evaluate
    sec = time.perf_counter() - t0
    losses = [float(line.split(" loss ")[1].split()[0])
              for line in tee.lines.getvalue().splitlines()
              if line.startswith("epoch ") and " loss " in line]
    total = counts(k1)
    epochs = len(losses)
    steps = epochs * steps_per_epoch
    train = [t - sum(e[i] for e in evals) for i, t in enumerate(total)]
    rec = {"row": row, "losses": losses, "sec": sec, "steps": steps,
           "launches": {"all": total[0], "tc": total[1], "wide": total[2]},
           "per_step": train[0] / steps, "wide_per_step": train[2] / steps,
           "per_eval": [e[0] for e in evals], "sec_per_epoch": sec / epochs}
    wide_eval = wide * per_eval // 14
    print(f"protocol {row['metric']} ({' '.join(argv[-4:])}): {epochs} epochs, {steps} steps in "
          f"{sec:.1f} s ({rec['sec_per_epoch']:.2f} s/epoch); losses {losses}; noisy-input PSNR "
          f"{row['psnr_noisy_db']} dB, held-out {row['psnr_denoised_db']} dB; kernel-1 launches "
          f"{rec['launches']}: {rec['per_step']:.0f} per step (want {14 * ACCUMULATION}), "
          f"{rec['wide_per_step']:.0f} wide (want {wide * ACCUMULATION}), per eval "
          f"{rec['per_eval']} (want {per_eval} each, {wide_eval} wide)", flush=True)
    if (train[0] != steps * 14 * ACCUMULATION or train[2] != steps * wide * ACCUMULATION
            or any(e != [per_eval, per_eval, wide_eval] for e in evals)
            or total[1] != total[0] or not all(math.isfinite(v) for v in losses)):
        fail(f"protocol run {argv}: launches {total}, evals {evals}, losses {losses}")
    return rec


def max_param_ratio(a, b):
    """max |a - b| / (STEP_ATOL + STEP_RTOL * |b|) over two state_dicts."""
    return max(((a[k].float() - v.float()).abs() / (STEP_ATOL + STEP_RTOL * v.float().abs()))
               .max().item() for k, v in b.items())


def protocol_main_path(torch, device, tmp, cache):
    """Phase 23 (module docstring), its images from ``cache``: returns the
    records and the two checkpoints' paths for phase 25."""
    import numpy as np

    from vub_image_denoising_tpu_torch.models import RDUNet
    from vub_image_denoising_tpu_torch.scripts import train_accuracy as ta
    from vub_image_denoising_tpu_torch.train import SupervisedTrainer
    from vub_image_denoising_tpu_torch.utils.checkpoint import load_pth

    phase_t0 = time.perf_counter()
    common = ["--cache-dir", cache, "--out", os.path.join(tmp, "log.jsonl"),
              *PROTOCOL_ARGS]
    ck, ck_resumed, ck_diff = (os.path.join(tmp, d) for d in ("ck", "ck_resumed", "ck_diff"))
    out = {}
    # the straight and the resumed run take cuDNN's deterministic algorithms
    # (its default weight gradients are not deterministic)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        out["straight"] = run_protocol(torch, ta, common + [
            "--epochs", str(PROTOCOL_EPOCHS), "--ckpt-every", str(PROTOCOL_SPLIT),
            "--ckpt-dir", ck], 14)
        out["resumed"] = run_protocol(torch, ta, common + [
            "--epochs", str(PROTOCOL_EPOCHS - PROTOCOL_SPLIT), "--ckpt-dir", ck_resumed,
            "--resume", os.path.join(ck, "mid_rdunet_denoising.pth")], 14)
    finally:
        torch.backends.cudnn.deterministic = False
    straight = out["straight"]
    row, losses = straight["row"], straight["losses"]
    if not (losses[-1] < losses[0] and row["psnr_denoised_db"] > row["psnr_noisy_db"]):
        fail(f"the cut protocol did not learn: losses {losses}, held-out "
             f"{row['psnr_denoised_db']} dB against the noisy input's {row['psnr_noisy_db']}")
    final = os.path.join(ck, "rdunet_denoising.pth")
    a = torch.load(final, map_location="cpu", weights_only=True)["model_state_dict"]
    b = torch.load(os.path.join(ck_resumed, "rdunet_denoising.pth"), map_location="cpu",
                   weights_only=True)["model_state_dict"]
    out["resume_ratio"] = max_param_ratio(b, a)
    out["resume_max_abs_diff"] = max((a[k] - b[k]).abs().max().item() for k in a)
    print(f"protocol {PROTOCOL_SPLIT} + resumed {PROTOCOL_EPOCHS - PROTOCOL_SPLIT} epochs vs "
          f"{PROTOCOL_EPOCHS} straight: final params max |diff| {out['resume_max_abs_diff']:.3e}, "
          f"worst |diff| / (atol {STEP_ATOL} + rtol {STEP_RTOL}*|p|) = {out['resume_ratio']:.3f} "
          f"(must be <= 1)", flush=True)
    if out["resume_ratio"] > 1 or out["resumed"]["row"].get("resumed_from_epoch") != PROTOCOL_SPLIT:
        fail("the resumed protocol run disagrees with the straight run")

    # the written checkpoint scored in f32 on the card and on the CPU
    _, val = ta.synth_train_val(PROTOCOL_TRAIN, PROTOCOL_VAL, IMAGE_SIZE,
                                cache_dir=cache)
    val = val[:PROTOCOL_CPU_IMAGES]
    noisy = ta.heldout_noisy(val, np.full(len(val), 25.0, np.float32))
    from vub_image_denoising_tpu_torch.ops.fused_block import fused_denoising_block as k1

    scores = {}
    for name, dev in (("card", device), ("cpu", torch.device("cpu"))):
        model = RDUNet(3, BASE_FILTERS)
        load_pth(final, model)
        trainer = SupervisedTrainer(model, device=dev)
        state = trainer.init(1)
        reset_counts(k1)
        scores[name] = ta.evaluate_psnr(lambda x: trainer.evaluate_batch(state, x), noisy, val,
                                        ta.EVAL_BATCH["supervised"], dev)
        if name == "card":
            out["eval_f32_launches"] = variant_counts(k1, (0, 0, 0))
    err = float(np.abs(scores["card"] - scores["cpu"]).max())
    out["card_vs_cpu_psnr"] = {"card": scores["card"].tolist(), "cpu": scores["cpu"].tolist(),
                               "max_abs_diff_db": err}
    print(f"protocol checkpoint in f32, {len(val)} held-out images: card PSNR "
          f"{scores['card'].mean():.4f} dB, CPU {scores['cpu'].mean():.4f} dB, per-image max "
          f"|diff| {err:.3e} dB (tol {PROTOCOL_PSNR_TOL}); card launches "
          f"{out['eval_f32_launches']}", flush=True)
    if not err <= PROTOCOL_PSNR_TOL or out["eval_f32_launches"]["tc"] != 14:
        fail("the protocol checkpoint scores differently on the card and the CPU")

    out["diffusion"] = run_protocol(torch, ta, common + [
        "--epochs", str(PROTOCOL_DIFFUSION_EPOCHS), "--ckpt-dir", ck_diff,
        "--algo", "diffusion", "--timesteps", str(TIMESTEPS)],
        14 * TIMESTEPS * -(-PROTOCOL_VAL // ta.EVAL_BATCH["diffusion"]))
    if not math.isfinite(out["diffusion"]["row"]["psnr_denoised_db"]):
        fail("the cut diffusion protocol gave no finite PSNR")
    out["launches"] = {k: out[k]["launches"] for k in ("straight", "resumed", "diffusion")}
    out["launches"]["eval_f32"] = out["eval_f32_launches"]
    out["phase_sec"] = time.perf_counter() - phase_t0
    print(f"protocol phase: {out['phase_sec']:.1f} s", flush=True)
    paths = {"unet": final, "diffusion": os.path.join(
        ck_diff, f"diffusion_RDUNet_model_checkpointed_epoch_{PROTOCOL_DIFFUSION_EPOCHS}.pth")}
    return out, paths


def gan_protocol_main_path(torch, tmp):
    """Phase 24: ``train_gan_accuracy --algo attention`` at its recorded
    settings; the generator must end above the noisy input."""
    from vub_image_denoising_tpu_torch.scripts import train_gan_accuracy as tg

    t0 = time.perf_counter()
    rec = tg.main(GAN_PROTOCOL_ARGS + ["--cache-dir", os.path.join(tmp, "cache"),
                                       "--ckpt-dir", os.path.join(tmp, "gan"),
                                       "--out", os.path.join(tmp, "log.jsonl")])
    out = {"row": rec, "phase_sec": time.perf_counter() - t0}
    print(f"GAN protocol attention: {rec['steps']} steps, train {rec['train_seconds']} s, phase "
          f"{out['phase_sec']:.1f} s; held-out best {rec['psnr_best_db']} dB, final "
          f"{rec['psnr_denoised_db']} dB (noisy input {rec['psnr_noisy_db']} dB)", flush=True)
    if not rec["psnr_best_db"] > rec["psnr_noisy_db"]:
        fail("the attention GAN did not learn")
    return out


def runner_and_switches_main_path(torch, device, tmp, paths):
    """Phase 25: the comparative runner on the trained checkpoints on the
    card and the CPU (metric tables within COMPARE_PSNR_TOL / COMPARE_TOL;
    14 + 14*T launches per batch on the card), then ``switch_step`` in a
    fresh process per switch: params after one SGD step within STEP_RTOL /
    STEP_ATOL of the switches-off step's, step times beside it."""
    from vub_image_denoising_tpu_torch.eval.compare import KEYS, VARIANTS
    from vub_image_denoising_tpu_torch.ops.fused_block import fused_denoising_block as k1
    from vub_image_denoising_tpu_torch.scripts import run_comparative_suite as rcs

    phase_t0 = time.perf_counter()
    out = {}
    metrics = {}
    for name, dev in (("card", device.type), ("cpu", "cpu")):
        args = rcs.build_arg_parser().parse_args(RUNNER_ARGS + [
            "--unet-ckpt", paths["unet"], "--diffusion-ckpt", paths["diffusion"],
            "--device", dev, "--save-dir", os.path.join(tmp, f"runner_{name}")])
        reset_counts(k1)
        t0 = time.perf_counter()
        summary, metrics[name] = rcs.run_suite(args)
        out[f"{name}_sec"] = time.perf_counter() - t0
        if name == "card":
            out["launches"] = variant_counts(k1, (0, 0, 0))
            out["summary"] = summary
    worst = {}
    for k in KEYS:
        for v in VARIANTS:
            if v == "bm3d" and k in ("lpips", "dists"):
                continue
            worst[f"{k}_{v}"] = max(abs(x - y) for x, y in zip(metrics["card"][f"{k}_{v}"],
                                                             metrics["cpu"][f"{k}_{v}"]))
    out["card_vs_cpu"] = worst
    want = 14 + 14 * TIMESTEPS
    bad = {key: e for key, e in worst.items()
           if not e <= (COMPARE_PSNR_TOL if key.startswith("psnr") else COMPARE_TOL)}
    print(f"runner on the trained checkpoints ({' '.join(RUNNER_ARGS[:6])}, BM3D): card "
          f"{out['card_sec']:.1f} s, CPU {out['cpu_sec']:.1f} s; summary {out['summary']}; card vs "
          f"CPU worst |diff| {worst}; kernel-1 launches {out['launches']} (want {want})",
          flush=True)
    if bad or out["launches"] != {"all": want, "tc": want, "wide": 0, "cuda_core": 0}:
        fail(f"runner: card vs CPU {bad}, launches {out['launches']}")

    out["switches"] = {}
    # the workers start together and warm up; each times and steps only
    # once its gate file is there, which is made after the previous one ended
    logs, procs = {}, {}
    try:
        for name, env in SWITCH_CASES.items():
            logs[name] = open(os.path.join(tmp, f"switch_{name}.log"), "w+")
            procs[name] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--switch-worker", tmp, name],
                stdout=logs[name], stderr=subprocess.STDOUT, text=True,
                env={**os.environ, **env})
        for name, env in SWITCH_CASES.items():
            open(os.path.join(tmp, f"switch_{name}.go"), "w").close()
            rc = procs[name].wait(timeout=600)
            logs[name].seek(0)
            log = logs[name].read()
            print("".join(line + "\n" for line in log.splitlines()
                          if line.startswith("switch worker")), end="", flush=True)
            if rc != 0:
                fail(f"the switch worker {name} failed:\n{log[-4000:]}")
            res = torch.load(os.path.join(tmp, f"switch_{name}.pt"), weights_only=False)
            out["switches"][name] = {"env": env, "ms": res["ms"], "launches": res["launches"]}
    finally:
        for name, proc in procs.items():
            proc.kill()
            logs[name].close()
    off = torch.load(os.path.join(tmp, "switch_off.pt"), weights_only=False)["params"]
    for name in SWITCH_CASES:
        rec = out["switches"][name]
        rec["ratio"] = max_param_ratio(
            torch.load(os.path.join(tmp, f"switch_{name}.pt"), weights_only=False)["params"], off)
        print(f"switch {name} {rec['env']}: xla step f32 {rec['ms']['f32']:.2f} ms, bf16 "
              f"{rec['ms']['bf16']:.2f} ms (off {out['switches']['off']['ms']}); SGD-step params "
              f"vs off worst |diff| / (atol {STEP_ATOL} + rtol {STEP_RTOL}*|p|) = "
              f"{rec['ratio']:.3f} (must be <= 1)", flush=True)
        if rec["ratio"] > 1 or rec["launches"] != 0:
            fail(f"switch {name}: params ratio {rec['ratio']}, {rec['launches']} launches")
    out["phase_sec"] = time.perf_counter() - phase_t0
    print(f"runner and switches phase: {out['phase_sec']:.1f} s", flush=True)
    return out


def runner_scripts_main_path(torch, cache):
    """Phase 26 (module docstring): each script's exit code, seconds and
    kernel-1 launches by variant (all on the tensor cores, as many as the
    samplers and steps it ran); measure_sidd_eval's finite PSNR/SSIM per
    engine (it fails itself unless the engines agree within 0.05 dB),
    run_search's trial CSV with a finite PSNR a trial and its sidecar."""
    import csv

    from vub_image_denoising_tpu_torch.ops.fused_block import fused_denoising_block as k1
    from vub_image_denoising_tpu_torch.scripts import measure_sidd_eval, run_search
    from vub_image_denoising_tpu_torch.search import hyperparams

    phase_t0 = time.perf_counter()
    out, results = {}, {}
    measure = measure_sidd_eval.measure

    def kept(*args, **kwargs):  # main's results, kept for the checks
        results.update(measure(*args, **kwargs))
        return results

    def run(name, main, argv):
        before = counts(k1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = main(argv)
        torch.cuda.synchronize()
        out[name] = {"rc": rc, "sec": time.perf_counter() - t0,
                     "launches": variant_counts(k1, before)}
        print(f"{name}: rc {rc}, {out[name]['sec']:.1f} s, kernel-1 launches "
              f"{out[name]['launches']}", flush=True)
        if rc != 0 or out[name]["launches"]["tc"] != out[name]["launches"]["all"]:
            fail(f"{name} {argv}: rc {rc}, launches {out[name]['launches']}")

    def check_launches(name, want):
        out[name]["want_launches"] = want
        print(f"{name}: {out[name]['launches']['all']} kernel-1 launches, want {want}",
              flush=True)
        if out[name]["launches"]["all"] != want:
            fail(f"{name}: {out[name]['launches']} kernel-1 launches, want {want}")

    measure_sidd_eval.measure = kept
    try:
        run("sidd_script", measure_sidd_eval.main, SIDD_SCRIPT_ARGS)
    finally:
        measure_sidd_eval.measure = measure
    keys = ("avg_psnr", "avg_ssim", "avg_inference_time_ms", "device_inference_time_ms",
            "n_blocks")
    out["sidd_script"]["engines"] = {e: {k: r[k] for k in keys} for e, r in results.items()}
    if sorted(results) != ["flax", "pallas"] or not all(
            math.isfinite(r["avg_psnr"]) and math.isfinite(r["avg_ssim"])
            and r["n_blocks"] == measure_sidd_eval.BLOCKS_PER_SCENE for r in results.values()):
        fail(f"measure_sidd_eval: {out['sidd_script']['engines']}")
    check_launches("sidd_script", len(results) * SIDD_SCRIPT_CALLS * 14 * TIMESTEPS)
    evaluate, sampled = hyperparams.evaluate_trial_psnr, []

    def counted_evaluate(trainer, *args):  # each trial's samplers' T (a pruned trial runs one)
        sampled.append(trainer.timesteps)
        return evaluate(trainer, *args)

    hyperparams.evaluate_trial_psnr = counted_evaluate
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = os.path.join(tmp, "trials.csv")
        try:
            run("search_script", run_search.main,
                RUN_SEARCH_ARGS + ["--csv", csv_path, "--cache-dir", os.path.join(tmp, "cache")])
        finally:
            hyperparams.evaluate_trial_psnr = evaluate
        with open(csv_path) as f:
            rows = list(csv.DictReader(f))
        with open(csv_path + ".study.json") as f:
            out["search_script"]["study"] = json.load(f)
    out["search_script"]["psnr"] = [float(r["psnr"]) for r in rows]
    if (out["search_script"]["study"]["trials"] != 2 or not rows
            or not all(math.isfinite(v) for v in out["search_script"]["psnr"])):
        fail(f"run_search: trial rows {rows}, study {out['search_script']['study']}")
    # each trial's epoch of steps at accumulation 4, and the T-step samplers
    check_launches("search_script", 14 * (2 * RUN_SEARCH_STEPS * ACCUMULATION + sum(sampled)))
    out.update(tooling_main_path(torch, cache))
    out["phase_sec"] = time.perf_counter() - phase_t0
    return out


def tooling_main_path(torch, cache):
    """Phase 26's protocol tooling (module docstring): the dry runs' commands,
    the manifest's check on an empty tree, and GAP_CONFIG through
    ``run_diffusion_gap --only`` with ``train_accuracy`` run in this process
    on images from ``cache`` (``run_protocol``'s launch checks: 56 a step,
    280 an evaluation)."""
    import contextlib

    from vub_image_denoising_tpu_torch.scripts import (regen_artifacts, run_diffusion_gap,
                                                       run_diffusion_gap_stage2, sweep)
    from vub_image_denoising_tpu_torch.scripts import train_accuracy as ta

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            rc = run_diffusion_gap.main(["--dry-run"])
        cmds = [ln for ln in tee.lines.getvalue().splitlines() if ln.startswith("+ python -m ")]
        out["gap_dry_run"] = {"rc": rc, "commands": len(cmds)}
        if rc != 0 or len(cmds) != len(run_diffusion_gap.CONFIGS) or not all(
                run_diffusion_gap.MODULE in c for c in cmds):
            fail(f"run_diffusion_gap --dry-run: rc {rc}, commands {cmds}")
        # a stage-1 log: the biased-t and lr 4e-4 rows beat gap-base by more
        # than MIN_GAIN_DB, the others do not
        log = os.path.join(tmp, "stage1.jsonl")
        gains = {"gap-biased": 0.6, "gap-lr4": 0.9, "gap-ssim": 0.1, "gap-mse": -0.5}
        with open(log, "w") as f:
            for tag, argv in run_diffusion_gap.grid():
                args = ta.build_arg_parser().parse_args(argv)
                f.write(json.dumps({
                    "tag": tag, "psnr_best_db": 26.0 + gains.get(tag, 0.0), "lr": args.lr,
                    "loss_weights": args.loss_weights, "t_dist": args.t_dist,
                    "timesteps": args.timesteps, "base_filters": args.base_filters,
                    "epochs": args.epochs, "train_seconds": 600.0}) + "\n")
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            rc = run_diffusion_gap_stage2.main(["--log", log, "--dry-run"])
        running = [ln for ln in tee.lines.getvalue().splitlines() if ln.startswith("running:")]
        out["stage2_dry_run"] = {"rc": rc, "command": running}
        if rc != 0 or len(running) != 1 or not all(
                k in running[0] for k in ("--lr 0.0004", "--t-dist biased",
                                          "--loss-weights 0,1,0 ", "--epochs 200")):
            fail(f"run_diffusion_gap_stage2 --dry-run: rc {rc}, {running}")
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            rc = regen_artifacts.main(["--check", "--root", tmp])
        summary = json.loads(tee.lines.getvalue().splitlines()[-1])
        out["regen_check"] = {"rc": rc, **summary}
        if rc != 0 or summary != {"live": 0,
                                  "missing": [e[0] for e in regen_artifacts.MANIFEST]}:
            fail(f"regen_artifacts --check on an empty tree: rc {rc}, {summary}")
        out["dry_runs_sec"] = time.perf_counter() - t0

        runs, run_command = [], sweep.run_command

        def in_process(module, argv):
            if module != run_diffusion_gap.MODULE:
                fail(f"run_diffusion_gap ran {module}")
            runs.append(run_protocol(torch, ta, argv, 14 * TIMESTEPS * -(-GAP_VAL // ta.EVAL_BATCH[
                "diffusion"]), steps_per_epoch=GAP_TRAIN // 128))
            return 0

        sweep.run_command = in_process
        t0 = time.perf_counter()
        try:
            rc = run_diffusion_gap.main(["--only", GAP_CONFIG, *GAP_CUT_ARGS,
                                         "--cache-dir", cache,
                                         "--out", os.path.join(tmp, "log.jsonl"),
                                         "--ckpt-dir", os.path.join(tmp, "gap")])
        finally:
            sweep.run_command = run_command
    rec = runs[0] if len(runs) == 1 else None
    out["gap_script"] = {"rc": rc, "sec": time.perf_counter() - t0, "config": GAP_CONFIG,
                         "row": rec and rec["row"], "launches": rec and rec["launches"],
                         "per_step": rec and rec["per_step"], "per_eval": rec and rec["per_eval"]}
    print(f"gap_script {GAP_CONFIG} ({' '.join(GAP_CUT_ARGS)}): rc {rc}, "
          f"{out['gap_script']['sec']:.1f} s; dry runs {out['dry_runs_sec']:.1f} s", flush=True)
    if (rc != 0 or rec is None or rec["row"]["tag"] != GAP_CONFIG
            or rec["row"]["loss_weights"] != "0,1,0.3"
            or not math.isfinite(rec["row"]["psnr_denoised_db"])):
        fail(f"run_diffusion_gap --only {GAP_CONFIG}: rc {rc}, row {rec and rec['row']}")
    return out


def flagship_main_path(torch, device, cache):
    """Phase 27 (module docstring): the manifest's ``flagship`` command with
    FLAGSHIP_CUT_ARGS, straight and as FLAGSHIP_SPLIT epochs + the rest
    resumed, through ``run_protocol`` (56 launches a step, FLAGSHIP_WIDE *
    ACCUMULATION wide; 14 an evaluation); then the bf16 step's ms and peak
    GiB over FLAGSHIP_TIMED steps after FLAGSHIP_WARMUP.  Images from
    ``cache``."""
    import shlex

    from vub_image_denoising_tpu_torch.ops.fused_block import fused_denoising_block as k1
    from vub_image_denoising_tpu_torch.scripts import regen_artifacts
    from vub_image_denoising_tpu_torch.scripts import train_accuracy as ta

    phase_t0 = time.perf_counter()
    # the entry's flags after "python -m <module>"; the cut's flags follow
    # them, and argparse keeps the last of a repeated flag
    command = shlex.split(dict((e[0], e[3]) for e in regen_artifacts.MANIFEST)["flagship"])
    if command[2] != "vub_image_denoising_tpu_torch.scripts.train_accuracy":
        fail(f"the manifest's flagship entry runs {command[2]}")
    flags = command[3:] + FLAGSHIP_CUT_ARGS
    args = ta.build_arg_parser().parse_args(flags)
    if (args.base_filters, args.batch_size, args.remat, args.engine, args.device_data,
            args.algo) != (128, 8, "false", "flax", True, "supervised"):
        fail(f"the manifest's flagship entry is not the flagship protocol: {command}")
    steps_per_epoch = FLAGSHIP_TRAIN // args.batch_size
    out = {"command": " ".join(command), "cut": FLAGSHIP_CUT_ARGS}
    with tempfile.TemporaryDirectory() as tmp:
        common = flags + ["--cache-dir", cache,
                          "--out", os.path.join(tmp, "log.jsonl")]
        ck, ck_resumed = os.path.join(tmp, "ck"), os.path.join(tmp, "ck_resumed")
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            out["straight"] = run_protocol(torch, ta, common + [
                "--epochs", str(FLAGSHIP_EPOCHS), "--ckpt-every", str(FLAGSHIP_SPLIT),
                "--ckpt-dir", ck], 14, steps_per_epoch, FLAGSHIP_WIDE)
            out["resumed"] = run_protocol(torch, ta, common + [
                "--epochs", str(FLAGSHIP_EPOCHS - FLAGSHIP_SPLIT), "--ckpt-dir", ck_resumed,
                "--resume", os.path.join(ck, "mid_rdunet_denoising.pth")], 14, steps_per_epoch,
                FLAGSHIP_WIDE)
        finally:
            torch.backends.cudnn.deterministic = False
        losses = out["straight"]["losses"]
        if not losses[-1] < losses[0]:
            fail(f"the cut flagship protocol did not learn: losses {losses}")
        a = torch.load(os.path.join(ck, "rdunet_denoising.pth"), map_location="cpu",
                       weights_only=True)["model_state_dict"]
        b = torch.load(os.path.join(ck_resumed, "rdunet_denoising.pth"), map_location="cpu",
                       weights_only=True)["model_state_dict"]
        out["resume_ratio"] = max_param_ratio(b, a)
        out["resume_max_abs_diff"] = max((a[k] - b[k]).abs().max().item() for k in a)
        out["params"] = sum(v.numel() for v in a.values())
        del a, b
        print(f"flagship {FLAGSHIP_SPLIT} + resumed {FLAGSHIP_EPOCHS - FLAGSHIP_SPLIT} epochs vs "
              f"{FLAGSHIP_EPOCHS} straight ({out['params']} params): final params max |diff| "
              f"{out['resume_max_abs_diff']:.3e}, worst |diff| / (atol {STEP_ATOL} + rtol "
              f"{STEP_RTOL}*|p|) = {out['resume_ratio']:.3f} (must be <= 1)", flush=True)
        if (out["resume_ratio"] > 1
                or out["resumed"]["row"].get("resumed_from_epoch") != FLAGSHIP_SPLIT):
            fail("the resumed flagship run disagrees with the straight run")

        # the step as the recorded run takes it (cuDNN's default algorithms),
        # on one batch of the run's shape
        trainer = ta.make_trainer(args, device, os.path.join(tmp, "ck_timed"))
        state = trainer.init(steps_per_epoch)
        gen = torch.Generator(device=device).manual_seed(27)
        clean = torch.rand(args.batch_size, 3, args.size, args.size, generator=gen,
                           device=device) * 2 - 1
        noisy = clean + SIGMA * torch.randn(clean.shape, generator=gen, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(k1)
        step_ms = []
        for _ in range(FLAGSHIP_WARMUP + FLAGSHIP_TIMED):
            t0 = time.perf_counter()
            state, loss = trainer.train_step(state, noisy, clean)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = variant_counts(k1, (0, 0, 0))
        timed = step_ms[FLAGSHIP_WARMUP:]
        out["step"] = {"ms": sum(timed) / len(timed), "step_ms": step_ms,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                       "loss": loss.item(), "launches": launches}
        del trainer, state
        torch.cuda.empty_cache()
    steps = FLAGSHIP_WARMUP + FLAGSHIP_TIMED
    want = {"all": 14 * ACCUMULATION * steps, "tc": 14 * ACCUMULATION * steps,
            "wide": FLAGSHIP_WIDE * ACCUMULATION * steps, "cuda_core": 0}
    st = out["step"]
    print(f"flagship step RDUNet(128) {args.batch_size}x{args.size}x{args.size} acc "
          f"{ACCUMULATION} bf16 flax: {st['ms']:.2f} ms (mean of {FLAGSHIP_TIMED} after "
          f"{FLAGSHIP_WARMUP}; each {[round(t, 2) for t in step_ms]}), peak "
          f"{st['peak_gib']:.3f} GiB; kernel-1 launches {launches} (want {want})", flush=True)
    if launches != want or not math.isfinite(st["loss"]):
        fail(f"flagship step: launches {launches}, loss {st['loss']}")
    out["launches"] = {k: out[k]["launches"] for k in ("straight", "resumed")}
    out["launches"]["step"] = {k: launches[k] for k in ("all", "tc", "wide")}
    out["phase_sec"] = time.perf_counter() - phase_t0
    print(f"flagship phase: {out['phase_sec']:.1f} s", flush=True)
    return out


def switch_worker(tmp, name):
    """``--switch-worker``: in this fresh process (the switches are read at
    import) take a warm-up "xla" supervised step of RDUNet-32 on 8 x 256^2,
    acc 4, in f32 and in bf16; once ``<tmp>/switch_<name>.go`` exists, time
    the step in both and take one f32 SGD step (``compare_with_xla``'s
    recipe); save the params, times and kernel-1 launches."""
    import torch

    sys.path.insert(0, ROOT)
    from vub_image_denoising_tpu_torch import enable_strict_precision
    from vub_image_denoising_tpu_torch.models import RDUNet
    from vub_image_denoising_tpu_torch.ops.fused_block import fused_denoising_block as k1
    from vub_image_denoising_tpu_torch.train import TrainState, make_supervised_train_step

    enable_strict_precision()
    device = torch.device("cuda")
    init = RDUNet(3, BASE_FILTERS, generator=torch.Generator().manual_seed(0)).state_dict()
    batches = make_batches(torch, device)
    res = {"ms": {}}
    timed = {short: make_trainer(torch, init, "xla", dtype)
             for short, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    for trainer, state in timed.values():  # a warm-up step each, before the gate
        trainer.train_step(state, *batches[0])
    torch.cuda.synchronize()
    while not os.path.exists(os.path.join(tmp, f"switch_{name}.go")):
        time.sleep(0.05)
    for short, (trainer, state) in timed.items():
        res["ms"][short] = cuda_ms(torch, lambda: trainer.train_step(state, *batches[0]), 4,
                                   warmup=1)
    trainer, state = make_trainer(torch, init, "xla", torch.float32)
    opt = torch.optim.SGD(list(state.params.values()), lr=1e-2)
    sgd = TrainState(state.params, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda k: 1.0),
                     clip_norm=1.0)
    reset_counts(k1)
    make_supervised_train_step(trainer.forward_fn, ACCUMULATION)(
        sgd, *(trainer.put(t) for t in batches[0]))
    res["launches"] = k1.launches
    res["params"] = {k: v.detach().cpu() for k, v in state.params.items()}
    torch.save(res, os.path.join(tmp, f"switch_{name}.pt"))
    print(f"switch worker {name}: xla step {res['ms']}", flush=True)


def main():
    import torch

    args = sys.argv[1:]
    if args[:1] == ["--export-worker"] and len(args) == 2:
        return export_worker(args[1])
    if args[:1] == ["--multirank-worker"] and len(args) == 5:
        return multirank_worker(int(args[1]), int(args[2]), args[3], args[4])
    if args[:1] == ["--switch-worker"] and len(args) == 3:
        return switch_worker(args[1], args[2])
    if args not in ([], ["--profile"]):
        fail(f"usage: python3 chip_smoke.py [--profile]  (got {args})")

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, ROOT)
    try:
        from vub_image_denoising_tpu_torch import enable_strict_precision
        from vub_image_denoising_tpu_torch.models import RDUNet
        from vub_image_denoising_tpu_torch.utils.checkpoint import save_pth
    except ImportError as e:
        fail(f"the port's package is not beside chip_smoke.py ({e})")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)
    enable_strict_precision()
    device = torch.device("cuda")

    if args:
        build_kernels()
        profile_main(torch, device)
        return
    # while nvcc runs (three processes after the first seconds): the protocol
    # phases' synthetic images on one core, step 9's CPU sampler on the rest
    synth, threads = tempfile.TemporaryDirectory(), torch.get_num_threads()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        made = pool.submit(make_synthetic, synth.name)
        sampler_ref = pool.submit(reference_sampler, torch, max(1, (os.cpu_count() or 8) - 4))
        ptxas = build_kernels()
        print(f"synthetic images of phases 23, 26, 27 made in {made.result():.1f} s, beside "
              "the build", flush=True)
        sampler_ref = sampler_ref.result()
    torch.set_num_threads(threads)
    records = check_kernel(torch, device)
    packed_records = check_packed_kernel(torch, device)

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "rdunet32.pth")
        save_pth(ck, RDUNet(3, BASE_FILTERS, generator=torch.Generator().manual_seed(0)).state_dict())
        serve_launches = serve_main_path(torch, ck)
        fwd = time_forward(torch, ck)

    trainable = check_trainable(torch, device)
    train_launches, step_ms, breakdowns = train_main_path(torch, device)

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "rdunet_t32.pth")
        save_pth(ck, seeded_rdunet_t(torch).state_dict(), prefix="unet.")
        diffusion_serve_launches = serve_main_path(torch, ck, "diffusion", sampler_ref)
        sampler = time_sampler(torch, ck)
    diffusion_train_launches, diffusion_step_ms, validation = diffusion_train_main_path(
        torch, device)
    folder = folder_train_main_path(torch, device, card, diffusion_step_ms["pallas_f32"])
    folder_launches = {k: folder[k]["tc"] for k in ("straight", "resumed", "device_data", "sidd")}
    evaluation = eval_main_path(torch, card, sampler)
    eval_launches = {k: {"all": evaluation["launches"][k], "tc": evaluation["tc_launches"][k]}
                     for k in evaluation["launches"]}
    phase_t0 = time.perf_counter()
    wide_records, wide_packed_records = check_wide_kernel(torch, device)
    rdunet128 = rdunet128_main_path(torch, device)
    rdunet128["phase_sec"] = time.perf_counter() - phase_t0
    print(f"wide phase: {rdunet128['phase_sec']:.1f} s", flush=True)
    phase_t0 = time.perf_counter()
    supervised128 = supervised128_main_path(torch, device)
    supervised128["phase_sec"] = time.perf_counter() - phase_t0
    print(f"RDUNet(128) train phase: {supervised128['phase_sec']:.1f} s", flush=True)
    gans = gan_main_path(torch, device)
    phase_t0, phase_sec = time.perf_counter(), {}
    partial = partial_widths_main_path(torch, device)
    phase_sec[16] = time.perf_counter() - phase_t0
    search_widths = {"kernel1": check_block_shapes(torch, device, SEARCH_SHAPES, "search width"),
                     "other_widths": check_block_shapes(torch, device, OTHER_WIDTH_SHAPES,
                                                        "other width"),
                     "kernel2": check_packed_shapes(torch, device, SEARCH_PACKED_SHAPES,
                                                    "search width")}
    phase_sec[17] = time.perf_counter() - phase_t0 - sum(phase_sec.values())
    remat = remat_main_path(torch, device)
    phase_sec[18] = time.perf_counter() - phase_t0 - sum(phase_sec.values())
    search = search_main_path(torch, device)
    phase_sec[19] = time.perf_counter() - phase_t0 - sum(phase_sec.values())
    comparison = compare_main_path(torch, device)
    phase_sec[20] = time.perf_counter() - phase_t0 - sum(phase_sec.values())
    print("phases 16-20: " + ", ".join(f"{k}: {v:.1f} s" for k, v in phase_sec.items())
          + f"; {sum(phase_sec.values()):.1f} s together", flush=True)
    export = export_main_path(torch, device)
    phase_sec[21] = export["phase_sec"]
    multi = multi_device_main_path(torch, device)
    phase_sec[22] = multi["phase_sec"]
    with tempfile.TemporaryDirectory() as tmp:
        protocol, trained = protocol_main_path(torch, device, tmp, synth.name)
        phase_sec[23] = protocol["phase_sec"]
        gan_protocol = gan_protocol_main_path(torch, tmp)
        phase_sec[24] = gan_protocol["phase_sec"]
        runner = runner_and_switches_main_path(torch, device, tmp, trained)
        phase_sec[25] = runner["phase_sec"]
    scripts = runner_scripts_main_path(torch, synth.name)
    phase_sec[26] = scripts["phase_sec"]
    flagship = flagship_main_path(torch, device, synth.name)
    synth.cleanup()
    phase_sec[27] = flagship["phase_sec"]
    print("phases 23-27: " + ", ".join(f"{k}: {phase_sec[k]:.1f} s" for k in range(23, 28))
          + f"; {sum(phase_sec[k] for k in range(23, 28)):.1f} s together", flush=True)
    remat_launches = {k: sum(r["tc"] for r in v["launches"]) for k, v in remat.items()}
    search_launches = {"run_search": sum(t["launches"]["all"] for t in search["trials"]),
                       "fixed": sum(t["launches"]["all"] for t in search["fixed"])}

    def per_forward(recs, shapes, dtype):
        return [(r, cnt) for r in recs for s, cnt in shapes
                if "ms" in r and r["shape"] == s and r["dtype"] == dtype]

    def timing(recs, shapes, dtype):
        rows = per_forward(recs, shapes, dtype)
        return {
            "max_abs_err": max(r["max_abs_err"] for r in recs if r["dtype"] == dtype),
            "ms": sum(r["ms"] * cnt for r, cnt in rows),
            "plain_ms": sum(r["plain_ms"] * cnt for r, cnt in rows),
            "bound_ms": sum(r["bound_ms"] * cnt for r, cnt in rows),
            "bound_by": "operations" if all(r["bound_by"] == "operations" for r, _ in rows)
            else "bytes",
            "library_ms": None,
        }

    def tc_variant(recs, shapes, dtype, source, cuda_core_source):
        """One kernel's tensor-core variant in one dtype, per forward, with the
        CUDA-core kernel on the same inputs beside it."""
        rows = per_forward(recs, shapes, dtype)
        out = {"variant": "tc", "dtype": dtype, "source": CSRC + source,
               **timing(recs, shapes, dtype),
               "cuda_core": {
                   "source": CSRC + cuda_core_source,
                   "ms": sum(r["cuda_core_ms"] * cnt for r, cnt in rows),
                   "max_abs_err": max(r["cuda_core_max_abs_err"] for r in recs
                                      if r["dtype"] == dtype and "cuda_core_max_abs_err" in r)}}
        if dtype == "float32":
            out["products"] = "3xTF32: three TF32 mma.sync products per multiply-add"
        return out

    variants, packed_variants = [], []
    for dtype, short in (("float32", "f32"), ("bfloat16", "bf16")):
        v = tc_variant(records, SLICE_SHAPES, dtype, "fused_block_tc.cu", "fused_block.cu")
        v["launches"] = train_launches[short]["tc"]
        v["microbatch_ms"] = timing(records, MB2_SHAPES, dtype)["ms"]
        v["sampler_batch16_ms"] = timing(records, B16_SHAPES, dtype)["ms"]
        if dtype == "float32":
            v["cuda_core"]["bound_ms"] = sum(r["cuda_core_bound_ms"] * cnt for r, cnt
                                             in per_forward(records, SLICE_SHAPES, dtype))
        variants.append(v)
        print(f"blocks RDUNet-32 8x256x256 {dtype}: 14 blocks {v['ms']:.3f} ms on the tensor "
              f"cores (bound {v['bound_ms']:.3f} ms), CUDA-core kernel {v['cuda_core']['ms']:.3f} "
              f"ms, plain {v['plain_ms']:.3f} ms; max_abs_err vs plain {v['max_abs_err']:.3e}",
              flush=True)
        v = tc_variant(packed_records, PACKED_SHAPES, dtype, "fused_block_packed_tc.cu",
                       "fused_block_packed.cu")
        v["kernel1_ms"] = sum(r["kernel1_ms"] * cnt
                              for r, cnt in per_forward(packed_records, PACKED_SHAPES, dtype))
        v["kernel1_max_abs_diff"] = max(r["kernel1_max_abs_diff"] for r in packed_records
                                        if r["dtype"] == dtype)
        packed_variants.append(v)
        print(f"packed blocks RDUNet-32 8x256x256 {dtype}: 12 blocks {v['ms']:.3f} ms on the "
              f"tensor cores (bound {v['bound_ms']:.3f} ms), kernel 1 {v['kernel1_ms']:.3f} ms, "
              f"CUDA-core kernel 2 {v['cuda_core']['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms; "
              f"max_abs_err vs plain {v['max_abs_err']:.3e}, unpacked vs kernel 1 "
              f"{v['kernel1_max_abs_diff']}", flush=True)

    def per_shape(recs, keys):
        return [{k: r[k] for k in ("shape", "kind", "dtype", "variant", "ms", "plain_ms",
                                   "bound_ms", "tile", *keys) if k in r}
                for r in recs if "ms" in r]

    kernels = [
        {
            "name": "fused_denoising_block",
            "route": "cuda",
            "source": CSRC + "fused_block_tc.cu",
            "replaces": "vub_image_denoising_tpu/ops/fused_block.py:193",
            "launches": (serve_launches["tc"] + train_launches["tc"]
                         + diffusion_serve_launches["tc"] + diffusion_train_launches["tc"]
                         + sum(folder_launches.values())
                         + sum(evaluation["tc_launches"].values())
                         + sum(v["tc"] for v in rdunet128["launches"].values())
                         + supervised128["launches"]["tc"]
                         + partial["rdunet152"]["launches"]["all"]
                         + sum(remat_launches.values()) + sum(search_launches.values())
                         + comparison["launches"]["all"] + export["launches"]
                         + multi["launches"]
                         + sum(v["all"] for v in protocol["launches"].values())
                         + runner["launches"]["all"]
                         + scripts["sidd_script"]["launches"]["all"]
                         + scripts["search_script"]["launches"]["all"]
                         + scripts["gap_script"]["launches"]["all"]
                         + sum(v["all"] for v in flagship["launches"].values())),
            **timing(records, SLICE_SHAPES, "float32"),
            "work": "the 14 blocks of one RDUNet-32 forward, batch 8, 256x256, f32 "
                    "(tensor-core variant, 3xTF32); bf16 under variants",
            "variants": variants,
            "per_shape": per_shape(records, ("cuda_core_ms", "cuda_core_bound_ms",
                                             "cuda_core_max_abs_err", "tile_sweep_ms",
                                             "wide_ms")),
            "launches_by_path": {"train": train_launches, "serve": serve_launches,
                                 "diffusion_serve": diffusion_serve_launches,
                                 "diffusion_train": diffusion_train_launches,
                                 "diffusion_fit": folder_launches,
                                 "eval": eval_launches,
                                 "rdunet128": rdunet128["launches"],
                                 "supervised128": supervised128["launches"],
                                 "rdunet152": partial["rdunet152"]["launches"],
                                 "remat": remat_launches, "search": search_launches,
                                 "compare": comparison["launches"],
                                 "export": {k: v["launches"] for k, v in export["cases"].items()},
                                 "multi_device": [r["launches"] for r in multi["ranks"]],
                                 "spatial": [[st["launches"] for st in r["spatial"]["steps"]]
                                             for r in multi["ranks"]],
                                 "spatial_diffusion": [
                                     [st["launches"] for st in r["spatial_diffusion"]["steps"]]
                                     + [r["spatial_diffusion"]["validate"]["launches"]]
                                     for r in multi["ranks"]],
                                 "sidd_script": scripts["sidd_script"]["launches"],
                                 "search_script": scripts["search_script"]["launches"],
                                 "gap_script": scripts["gap_script"]["launches"],
                                 "protocol": protocol["launches"],
                                 "flagship": flagship["launches"],
                                 "runner_trained": runner["launches"],
                                 "trainable_block": trainable["fused_denoising_block"]},
            "forward_ms": fwd,
            "train_step_ms": step_ms,
            "train_step_breakdown": breakdowns,
            "sampler": {"timesteps": TIMESTEPS, "batch": 8, **sampler,
                        "batch16_blocks": {d: timing(records, B16_SHAPES, d)
                                           for d in ("float32", "bfloat16")}},
            "diffusion_train_step_ms": diffusion_step_ms,
            "diffusion_validate": validation,
            "folder_train": folder,
            "sidd_eval": evaluation,
            "wide": {"variant": "tc_wide", "widths": "every c > 256",
                     "source": CSRC + "fused_block_wide_tc.cu", "per_shape": wide_records,
                     "ptxas": ptxas["fused_block_wide_tc"]},
            "rdunet128": rdunet128,
            "supervised128": supervised128,
            "gan": gans,
            "partial_wide": partial,
            "search_widths": search_widths,
            "remat": remat,
            "search": search,
            "compare": comparison,
            "export": export,
            "multi_device": multi,
            "protocol": protocol,
            "gan_protocol": gan_protocol,
            "runner_and_switches": runner,
            "runner_scripts": scripts,
            "flagship": flagship,
            "phase_sec": phase_sec,
            "ptxas": {lib: ptxas[lib] for lib in ("fused_block", "fused_block_tc",
                                                  "fused_block_wide_tc")},
            "card": card,
        },
        {
            "name": "fused_denoising_block_packed",
            "route": "cuda",
            "source": CSRC + "fused_block_packed_tc.cu",
            "replaces": "vub_image_denoising_tpu/ops/fused_block.py:360",
            "launches": trainable["fused_denoising_block_packed"]["tc"],
            **timing(packed_records, PACKED_SHAPES, "float32"),
            "work": "the 12 blocks at c <= 128 of one RDUNet-32 forward, batch 8, "
                    "256x256, run packed, f32 (tensor-core variant, 3xTF32); bf16 under "
                    "variants",
            "variants": packed_variants,
            "per_shape": per_shape(packed_records, ("kernel1_ms", "kernel1_max_abs_diff",
                                                    "cuda_core_ms", "cuda_core_max_abs_err")),
            "launches_by_path": {"trainable_block": trainable["fused_denoising_block_packed"]},
            "trainable_max_grad_err": trainable["max_grad_err"],
            "wide": {"variant": "tc_wide", "source": CSRC + "fused_block_wide_tc.cu",
                     "per_shape": wide_packed_records, "partial": partial["packed"]},
            "ptxas": {lib: ptxas[lib] for lib in ("fused_block_packed", "fused_block_packed_tc")},
            "card": card,
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
