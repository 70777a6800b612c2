"""Run the comparative evaluation suite end to end on trained checkpoints.

Counterpart of ``scripts/run_comparative_suite.py``: drives
``eval.compare``'s ``evaluate_models`` and ``plot_evaluation`` (together
``evaluate_model_and_plot``, evaluate_Unet_diffusion/
evaluate_model.py:73-327) the way the reference does (:313-327): a
noise-level-cycling validation loader (sigma in {10, 20, 30, 40, 50},
``include_noise_level=True``) over synthetic images (``RandomState(7)``),
a supervised RDUNet checkpoint, a diffusion RDUNetT checkpoint (both as
``train_accuracy`` writes them) and BM3D.  Writes the figures (skipped
where matplotlib is not installed) and ``summary.json`` (mean PSNR and
SSIM per variant per sigma) to ``--save-dir``; like the JAX script's, its
compare module writes no metrics CSV.  The noise comes from a CPU torch generator
(``NOISE_SEED``) where the JAX script uses ``PRNGKey(99)``.  Added flag:
``--device`` (the card unless ``cpu``).

Usage:
    python -m vub_image_denoising_tpu_torch.scripts.run_comparative_suite \\
        --unet-ckpt runs/torch_accuracy_ckpt/rdunet_denoising.pth \\
        --diffusion-ckpt runs/torch_accuracy_ckpt_diffusion/diffusion_RDUNet_model_checkpointed_epoch_150.pth
"""

import argparse
import json
import os
import time

import numpy as np

from .train_accuracy import heldout_noisy, synth_images

NOISE_LEVELS = [10, 20, 30, 40, 50]
IMAGE_SEED = 7
NOISE_SEED = 99


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--unet-ckpt", default="runs/torch_accuracy_ckpt/rdunet_denoising.pth")
    ap.add_argument(
        "--diffusion-ckpt",
        default="runs/torch_accuracy_ckpt_diffusion/"
                "diffusion_RDUNet_model_checkpointed_epoch_150.pth",
    )
    ap.add_argument("--epoch-label", type=int, default=150)
    ap.add_argument("--n-images", type=int, default=25)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=5)
    ap.add_argument("--base-filters", type=int, default=32)
    ap.add_argument("--unet-base-filters", type=int, default=0,
                    help="UNet width when it differs from --base-filters; 0 = same")
    ap.add_argument("--timesteps", type=int, default=20)
    ap.add_argument("--no-bm3d", action="store_true")
    ap.add_argument("--save-dir", default="runs/torch_comparative")
    ap.add_argument("--corrected", action="store_true",
                    help="corrected metric conventions instead of the reference's "
                         "strict ones (see eval/compare.py)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    return ap


def val_batches(n_images, size, batch_size):
    """The (noisy, clean, sigma) batches: NCHW f32 tensors in [-1, 1] and the
    per-image sigma, cycled over ``NOISE_LEVELS``."""
    import torch

    clean = synth_images(n_images, size, np.random.RandomState(IMAGE_SEED))
    sigmas = np.asarray([NOISE_LEVELS[i % len(NOISE_LEVELS)] for i in range(n_images)],
                        np.float32)
    noisy = heldout_noisy(clean, sigmas, NOISE_SEED)

    def norm(u8):
        return torch.from_numpy((u8.astype(np.float32) / 255.0 - 0.5) / 0.5).permute(0, 3, 1, 2)

    return [(norm(noisy[s:s + batch_size]), norm(clean[s:s + batch_size]),
             torch.from_numpy(sigmas[s:s + batch_size]))
            for s in range(0, n_images, batch_size)]


def summarize(metrics, times, wall, n_images, corrected):
    """Mean PSNR and SSIM per variant per sigma (variants not run are left
    out), and the mean inference ms per variant."""
    nl = np.asarray(metrics["noise_level"])
    summary = {"wall_seconds": round(wall, 1), "n_images": n_images,
               "convention": "corrected" if corrected else "strict_reference"}
    for variant in ("degraded", "unet", "diffusion", "bm3d"):
        for key in ("psnr", "ssim"):
            vals = np.asarray(metrics[f"{key}_{variant}"], np.float64)
            if not np.isfinite(vals).any():
                continue
            summary[f"{key}_{variant}_by_sigma"] = {
                str(int(lv)): (round(float(np.nanmean(vals[nl == lv])), 3)
                               if np.isfinite(vals[nl == lv]).any() else None)
                for lv in NOISE_LEVELS
            }
    summary["inference_ms_mean"] = {
        k: round(1e3 * float(np.mean(v)), 1) for k, v in times.items() if v
    }
    return summary


def have_matplotlib():
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def run_suite(args):
    """The suite for parsed ``args`` (``evaluate_model_and_plot``'s two
    parts): returns ``(summary, metrics)`` and writes ``summary.json``
    beside the figures.  Without matplotlib (the card's machine has none)
    the figures are skipped and said so; the metrics are the same."""
    from ..eval.compare import evaluate_models, plot_evaluation
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    print(f"generating {args.n_images} synthetic {args.size}^2 val images...", flush=True)
    batches = val_batches(args.n_images, args.size, args.batch_size)
    t0 = time.time()
    ev = evaluate_models(
        [args.epoch_label], [args.diffusion_ckpt], args.unet_ckpt, batches,
        include_noise_level=True,
        use_bm3d=not args.no_bm3d,
        timesteps=args.timesteps,
        unet_base_filters=args.unet_base_filters or args.base_filters,
        diffusion_base_filters=args.base_filters,
        strict_reference_conventions=not args.corrected,
        # checkpoints this package's train_accuracy wrote
        trusted_checkpoints=True,
        device=device,
    )
    os.makedirs(args.save_dir, exist_ok=True)
    if have_matplotlib():
        plot_evaluation(ev, [args.epoch_label], not args.no_bm3d, args.save_dir)
    else:
        print("matplotlib is not installed: the figures are skipped", flush=True)
    summary = summarize(ev.metrics, ev.inference_times, time.time() - t0, args.n_images,
                        args.corrected)
    with open(os.path.join(args.save_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary, ev.metrics


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    summary, _ = run_suite(args)
    print(json.dumps(summary), flush=True)
    print(f"summary and figures in {args.save_dir}", flush=True)
    return summary


if __name__ == "__main__":
    main()
