"""Command line for SIDD validation and the Kaggle benchmark submission.

Counterpart of ``vub_image_denoising_tpu/eval/sidd_cli.py``:

- ``validate``, from evaluate_SIDD/evaluate_SIDD.py:102-154: evaluate a
  diffusion checkpoint over a random 10% of the SIDD validation blocks,
  print the average PSNR, SSIM and inference time, write
  benchmark_results.csv.
- ``benchmark``, from evaluate_SIDD/benchmark.py: denoise the benchmark
  blocks and write SubmitSrgb.csv for
  kaggle.com/competitions/sidd-benchmark-srgb-psnr.  The reference
  downloads a missing .mat; here a missing file is an error with the URL.

The sampler runs on the card unless ``--device cpu``; ``--engine`` is
``denoise_cli``'s (``auto`` is ``flax``: every DenoisingBlock a kernel
launch), and ``--fused`` means ``--engine pallas``.

Usage:
  python -m vub_image_denoising_tpu_torch.eval.sidd_cli validate --checkpoint ck.pth \\
      --noisy-mat ValidationNoisyBlocksSrgb.mat --gt-mat ValidationGtBlocksSrgb.mat
  python -m vub_image_denoising_tpu_torch.eval.sidd_cli benchmark --checkpoint ck.pth \\
      --benchmark-mat BenchmarkNoisyBlocksSrgb.mat
"""

import argparse
import os

from .denoise_cli import ENGINES, build_apply
from .sidd import SIDDMatBlocks, evaluate_sidd, make_kaggle_submission

BENCHMARK_URL = (
    "https://competitions.codalab.org/my/datasets/download/"
    "0d8a1e68-155d-4301-a8cd-9b829030d719"
)


def load_sampler(checkpoint_path: str, base_filters: int = 32, timesteps: int = 20,
                 bf16: bool = False, fused: bool = False, engine: str = "auto",
                 trusted: bool = False, device=None, pipeline_parallel: bool = False,
                 pipeline_microbatch: int = 0):
    """The T-step improved sampler of a ``unet.``-prefixed RDUNetT ``.pth``:
    a function from normalized (N, H, W, 3) [-1, 1] f32 tensors on
    ``device`` to the denoised f32 tensors, built by
    ``denoise_cli.build_apply(arch="diffusion")``.  ``fused=True`` means
    ``engine="pallas"``; ``trusted=True`` allows the full-unpickling
    ``torch.load`` fallback for files the user supplied themselves.

    ``pipeline_parallel`` chunks the T steps over the ranks
    (``parallel/pipeline.py``: the deepest pipeline that divides T, each
    stage data parallel over the ranks left), streaming microbatches of
    ``pipeline_microbatch`` blocks (0: 2); every rank gets the outputs."""
    forward, model = build_apply(checkpoint_path, "diffusion", base_filters, timesteps,
                                 bf16=bf16, engine="pallas" if fused else engine,
                                 trusted=trusted, device=device)
    if not pipeline_parallel:
        return forward
    import torch

    from ..diffusion.interpolation import InterpolationDiffusion
    from ..parallel.pipeline import best_pipeline_depth, make_ppdp_mesh, pipeline_sample_fn

    depth = best_pipeline_depth(timesteps)
    dev = next(model.parameters()).device
    mesh = make_ppdp_mesh(depth, device=dev)
    inner = pipeline_sample_fn(InterpolationDiffusion(timesteps=timesteps), forward.unet, mesh,
                               microbatch=pipeline_microbatch or 2)
    print(f"pipeline-parallel sampling: {depth} stages x {timesteps // depth} steps")

    @torch.inference_mode()
    def sampler(noisy):
        x = noisy.permute(0, 3, 1, 2).to(forward.dtype)
        if dev.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        return inner(x).float().permute(0, 2, 3, 1)

    return sampler


def main_validate(args):
    from ..parallel.mesh import init_distributed, is_writer

    # a no-op unless torchrun's environment is set: nccl for a card per rank,
    # gloo for CPU ranks
    init_distributed("gloo" if args.device == "cpu" else "nccl")
    blocks = SIDDMatBlocks(args.noisy_mat, args.gt_mat)
    sampler = load_sampler(args.checkpoint, args.base_filters, args.timesteps, args.bf16,
                           args.fused, args.engine, trusted=args.trusted_checkpoint,
                           device=args.device, pipeline_parallel=args.pipeline_parallel,
                           pipeline_microbatch=args.pipeline_microbatch)
    results = evaluate_sidd(
        sampler, blocks, evaluation_percentage=args.evaluation_percentage,
        batch_size=args.batch_size, seed=args.seed,
        csv_path=args.csv if is_writer() else None, device=args.device,
    )
    print(f"Average PSNR: {results['avg_psnr']:.2f}")
    print(f"Average SSIM: {results['avg_ssim']:.4f}")
    print(f"Average Inference Time: {results['avg_inference_time_ms']:.2f} ms")
    print(f"On-device Inference Time: {results['device_inference_time_ms']:.2f} ms")
    return results


def main_benchmark(args):
    if not os.path.exists(args.benchmark_mat):
        raise FileNotFoundError(
            f"{args.benchmark_mat} not found; download it from {BENCHMARK_URL}"
        )
    sampler = load_sampler(args.checkpoint, args.base_filters, args.timesteps, args.bf16,
                           args.fused, trusted=args.trusted_checkpoint, device=args.device)
    out = make_kaggle_submission(sampler, args.benchmark_mat, args.output,
                                 batch_size=args.batch_size, device=args.device)
    print(f"Saved submission to {out}")
    print("Submit the output file SubmitSrgb.csv at")
    print("kaggle.com/competitions/sidd-benchmark-srgb-psnr")
    return out


def main(argv=None):
    from ..utils.cache import enable_compilation_cache

    enable_compilation_cache()
    p = argparse.ArgumentParser(description="SIDD evaluation / benchmark")
    sub = p.add_subparsers(dest="cmd", required=True)

    v = sub.add_parser("validate")
    v.add_argument("--checkpoint", required=True)
    v.add_argument("--noisy-mat", default="evaluate_SIDD/ValidationNoisyBlocksSrgb.mat")
    v.add_argument("--gt-mat", default="evaluate_SIDD/ValidationGtBlocksSrgb.mat")
    v.add_argument("--base-filters", type=int, default=32)
    v.add_argument("--timesteps", type=int, default=20)
    v.add_argument("--evaluation-percentage", type=float, default=0.1)
    v.add_argument("--batch-size", type=int, default=8)
    v.add_argument("--seed", type=int, default=0)
    v.add_argument("--csv", default="benchmark_results.csv")
    v.add_argument("--bf16", action="store_true")
    v.add_argument("--fused", action="store_true",
                   help="the functional forward with the block kernel (--engine pallas)")
    v.add_argument("--engine", default="auto", choices=list(ENGINES))
    v.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    v.add_argument("--trusted-checkpoint", action="store_true",
                   help="allow the full-unpickling torch.load fallback for a "
                        "checkpoint that fails the safe weights-only load "
                        "(trusted files only)")
    v.add_argument("--pipeline-parallel", action="store_true",
                   help="chunk the T sampler steps over the ranks (torchrun) and "
                        "stream blocks through (parallel/pipeline.py)")
    v.add_argument("--pipeline-microbatch", type=int, default=0,
                   help="blocks per in-flight pipeline microbatch (0 -> 2)")

    b = sub.add_parser("benchmark")
    b.add_argument("--checkpoint", required=True)
    b.add_argument("--trusted-checkpoint", action="store_true",
                   help="allow the full-unpickling torch.load fallback "
                        "(trusted files only)")
    b.add_argument("--benchmark-mat", default="evaluate_SIDD/BenchmarkNoisyBlocksSrgb.mat")
    b.add_argument("--output", default="SubmitSrgb.csv")
    b.add_argument("--base-filters", type=int, default=32)
    b.add_argument("--timesteps", type=int, default=20)
    b.add_argument("--batch-size", type=int, default=8)
    b.add_argument("--bf16", action="store_true")
    b.add_argument("--fused", action="store_true")
    b.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    args = p.parse_args(argv)
    if args.cmd == "validate":
        return main_validate(args)
    return main_benchmark(args)


if __name__ == "__main__":
    main()
