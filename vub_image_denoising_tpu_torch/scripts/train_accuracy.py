"""The accuracy protocol: train RDUNet (supervised) or RDUNetT (diffusion) on
synthetic DIV2K-style images under Gaussian noise and report the held-out PSNR.

Counterpart of ``scripts/train_tpu_accuracy.py``.  The synthetic images
(``synth_images``, ``synth_train_val``) are the same numpy ``RandomState``
and scipy recipe, byte for byte; each clean batch is degraded on the device
(quantized uint8 noise, the reference's synthetic-noise protocol,
custom_dataset.py:83-87) and normalized to [-1, 1]; the trainer trains in
bf16.  The held-out pairs take their noise from their own seeded generator,
on the CPU, so every device evaluates the same noisy images.  The U-Net is
scored at batch 32, the diffusion model through the whole T-step improved
sampler at batch 8; PSNR of ``clip(denormalize(out), 0, 1)`` against the
clean image with ``data_range=1`` (evaluate_model.py:36-51).

Differences from the JAX script: ``--engine`` defaults to ``"flax"`` (every
DenoisingBlock through the block kernel, trained through
``fused_block_trainable``) and ``--remat`` to ``false``; the draws come
from torch generators (the loader's stream ``seed=1``, the held-out noise
``VAL_NOISE_SEED``, the diffusion timesteps the trainer's seed 0); the
cache, the checkpoints and the log are the port's own paths.  Added flags:
``--device`` (the card unless ``cpu``) and ``--cache-dir``.

Usage (the recorded sigma = 25 protocol):
    python -m vub_image_denoising_tpu_torch.scripts.train_accuracy --epochs 150 \\
        --batch-size 128 --lr 3e-4 --sched-steps-per-epoch 100 --device-data
Prints one JSON line at the end and appends it to ``--out``.  Every eval
rewrites ``<ckpt-dir>/progress.json``; SIGTERM appends a ``{"partial": true}``
row and exits 143; ``--ckpt-every N`` writes ``mid_*`` checkpoints that
``--resume`` continues from for ``--epochs`` more epochs.
"""

import argparse
import json
import os
import signal
import sys
import threading
import time

import numpy as np

CACHE_DIR = "runs/torch_synth_cache"
CKPT_DIR = "runs/torch_accuracy_ckpt"
OUT = "runs/torch_accuracy_log.jsonl"
# the held-out pairs' noise generator (a CPU torch.Generator)
VAL_NOISE_SEED = 123
# the loader's stream (the JAX script's seed=1)
LOADER_SEED = 1
# U-Net eval batch; the diffusion sampler's batch
EVAL_BATCH = {"supervised": 32, "diffusion": 8}


def synth_images(n, size, rng):
    """DIV2K-stand-in synthetic content: multi-scale smooth fields + flat
    geometric regions + soft stripes — structured enough that a denoiser can
    exploit spatial redundancy, varied enough not to be memorized."""
    from scipy.ndimage import gaussian_filter

    imgs = np.empty((n, size, size, 3), np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n):
        img = np.zeros((size, size, 3), np.float32)
        for blur, amp in ((16.0, 0.5), (6.0, 0.25), (2.0, 0.1)):
            f = gaussian_filter(
                rng.randn(size, size, 3).astype(np.float32), (blur, blur, 0)
            )
            img += amp * f / (np.abs(f).max() + 1e-6)
        for _ in range(rng.randint(4, 9)):  # flat ellipses
            cy, cx = rng.randint(0, size, 2)
            ry, rx = rng.randint(size // 16, size // 3, 2)
            mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
            color = rng.uniform(-0.8, 0.8, 3).astype(np.float32)
            img[mask] = img[mask] * 0.3 + color * 0.7
        if rng.rand() < 0.5:  # soft stripes
            period = rng.randint(8, 40)
            phase = rng.rand() * 6.28
            stripes = 0.15 * np.sin(2 * np.pi * xx / period + phase)
            img += stripes[..., None].astype(np.float32)
        lo, hi = img.min(), img.max()
        imgs[i] = np.clip((img - lo) / (hi - lo + 1e-6) * 255, 0, 255).astype(np.uint8)
    return imgs


def synth_train_val(n_train, n_val, size, seed=0, cache_dir=CACHE_DIR):
    """Deterministic (train, val) synthetic pair with an on-disk cache.

    The two calls share one RandomState, so the val set depends on the
    train draw; the cache, keyed by the whole recipe, stores both together
    and is written atomically."""
    path = os.path.join(cache_dir, f"synth_{seed}_{size}_{n_train}_{n_val}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["train"], z["val"]
    rng = np.random.RandomState(seed)
    train = synth_images(n_train, size, rng)
    val = synth_images(n_val, size, rng)
    os.makedirs(cache_dir, exist_ok=True)
    # keep the .npz suffix LAST — np.savez appends one otherwise
    tmp = f"{path[:-4]}.{os.getpid()}.tmp.npz"
    np.savez_compressed(tmp, train=train, val=val)
    os.replace(tmp, path)
    return train, val


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--algo", choices=("supervised", "diffusion"), default="supervised")
    ap.add_argument("--timesteps", type=int, default=20)
    ap.add_argument("--loss-weights", default="0,1,0",
                    help="diffusion combined_loss mse,charbonnier,ssim weights "
                         "(diffusion_RDUnet.py:60-65; reference default 0,1,0)")
    ap.add_argument("--t-dist", choices=("uniform", "biased"), default="uniform",
                    help="diffusion timestep sampling: uniform ints or the "
                         "reference's Beta(2,1) bias toward T (:71-73)")
    ap.add_argument("--tag", default="", help="extra label for the output record")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--base-filters", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--n-train", type=int, default=512)
    ap.add_argument("--n-val", type=int, default=64)
    ap.add_argument("--sigma", type=float, default=25.0)
    ap.add_argument(
        "--sigma-list", default="",
        help="comma-separated noise levels (e.g. '10,20,30,40,50') for blind "
        "denoising: per-sample sigma drawn uniformly from the list at train "
        "time, val noise cycled per image (i %% len(levels)) with a per-level "
        "PSNR breakdown; overrides --sigma",
    )
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--optimizer", default="", choices=("", "adam", "adamw"),
                    help="diffusion optimizer_choice override (empty = trainer default)")
    ap.add_argument("--scheduler", default="", choices=("", "cosine", "step"),
                    help="diffusion scheduler_choice override (empty = trainer default)")
    ap.add_argument("--engine", default="flax", choices=("flax", "xla", "pallas"),
                    help="flax: the modules, every DenoisingBlock through the block "
                         "kernel; xla: the eager blocks (cuDNN); pallas: the "
                         "functional engine with the block kernel")
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument(
        "--sched-steps-per-epoch", type=int, default=0,
        help="virtual epoch length for the StepLR(3,.5) decay cadence (0 = the "
        "loader's epoch length)",
    )
    ap.add_argument(
        "--device-data", action="store_true",
        help="keep the uint8 image bank on the device and draw each batch there "
        "(data/resident.py); another stream than the host loader's",
    )
    ap.add_argument("--remat", choices=("true", "false"), default="false",
                    help="recompute the blocks in the backward (torch.utils.checkpoint)")
    ap.add_argument("--ckpt-dir", default="",
                    help=f"checkpoint directory (default {CKPT_DIR}[_diffusion])")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="also checkpoint every N epochs mid-run under a mid_ name "
                         "(0 = final only); --resume accepts it")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--resume", default="",
                    help="checkpoint path to resume from (continues for --epochs MORE epochs)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    ap.add_argument("--cache-dir", default=CACHE_DIR,
                    help="where the synthetic images are cached")
    return ap


def append_row(out, rec):
    """Append one JSON row to ``out`` and print it."""
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec), flush=True)


def flush_progress(ckpt_dir, partial):
    """Rewrite ``<ckpt_dir>/progress.json`` atomically (survives a kill)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".progress.{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        f.write(json.dumps(partial) + "\n")
    os.replace(tmp, os.path.join(ckpt_dir, "progress.json"))


def write_partial_row(partial, out):
    """The SIGTERM row: ``partial`` marked ``{"partial": true}`` appended to
    ``out``.  None (nothing written) before the first eval."""
    if "psnr_best_db" not in partial:
        return None
    rec = dict(partial)
    rec["partial"] = True
    append_row(out, rec)
    return rec


def exit_on_sigterm(partial, out):
    """Install a SIGTERM handler that writes the partial row and exits 143;
    returns the handler it replaced (None off the main thread)."""
    if threading.current_thread() is not threading.main_thread():
        return None

    def on_sigterm(signum, frame):
        write_partial_row(partial, out)
        os._exit(143)

    return signal.signal(signal.SIGTERM, on_sigterm)


def heldout_noisy(clean_u8, sigmas, seed=VAL_NOISE_SEED):
    """The held-out noisy images: quantized uint8 noise at per-image
    ``sigmas`` from a CPU generator seeded with ``seed``."""
    import torch

    from ..data.device import add_gaussian_noise_u8

    return add_gaussian_noise_u8(torch.Generator().manual_seed(seed), torch.from_numpy(clean_u8),
                                 torch.from_numpy(np.asarray(sigmas, np.float32))).numpy()


def noisy_psnr(clean_u8, noisy_u8):
    """Per-image PSNR of the noisy input, in numpy (f32 MSE, as JAX's)."""
    out = []
    for s in range(0, len(clean_u8), 32):
        c = clean_u8[s:s + 32].astype(np.float32) / 255.0
        nz = noisy_u8[s:s + 32].astype(np.float32) / 255.0
        mse = ((c - nz) ** 2).mean(axis=(1, 2, 3))
        out.extend((10 * np.log10(1.0 / mse)).tolist())
    return np.asarray(out)


def evaluate_psnr(predict, noisy_u8, clean_u8, batch, device):
    """Per-image PSNR (f64 numpy) of ``predict`` on the held-out pairs:
    ``predict(noisy)`` takes an NCHW batch in [-1, 1] on ``device``; its
    output is denormalized, clipped to [0, 1] and scored against the clean
    image with ``data_range=1``."""
    import torch

    from ..data.device import denormalize, normalize_u8
    from ..eval.metrics import psnr_per_image

    psnrs = []
    for s in range(0, len(clean_u8), batch):
        noisy = normalize_u8(torch.from_numpy(noisy_u8[s:s + batch]).to(device))
        clean01 = torch.from_numpy(clean_u8[s:s + batch]).to(device).float() / 255.0
        out = predict(noisy.permute(0, 3, 1, 2))
        out01 = torch.clamp(denormalize(out.float()), 0.0, 1.0).permute(0, 2, 3, 1)
        psnrs.extend(psnr_per_image(clean01, out01, data_range=1.0).double().cpu().tolist())
    return np.asarray(psnrs, np.float64)


class CleanImages:
    """The clean training images as a ``PatchLoader`` dataset (batched
    gather)."""

    def __init__(self, images):
        self.images = images

    def __len__(self):
        return len(self.images)

    def gather_batch(self, indices):
        return (self.images[np.asarray(indices, np.int64)],)


def make_transform(device, sigma, sigma_list):
    """The loader's on-device transform: noise at ``sigma``, or at a level
    drawn per sample from ``sigma_list``, then normalization."""
    import torch

    from ..data.device import degrade_and_normalize

    if sigma_list is None:
        return lambda g, clean_u8: degrade_and_normalize(g, clean_u8, sigma)
    levels = torch.tensor(sigma_list, dtype=torch.float32, device=device)

    def tf(g, clean_u8):
        pick = torch.randint(0, len(levels), (clean_u8.shape[0],), generator=g,
                             device=g.device)
        return degrade_and_normalize(g, clean_u8, levels[pick])

    return tf


def make_trainer(args, device, ckpt_dir):
    import torch

    from ..models.rdunet import RDUNet
    from ..train.diffusion import DiffusionTrainer
    from ..train.supervised import SupervisedTrainer

    remat = args.remat == "true"
    if args.algo == "diffusion":
        opt_kw = {}
        if args.optimizer:
            opt_kw["optimizer_choice"] = args.optimizer
        if args.scheduler:
            opt_kw["scheduler_choice"] = args.scheduler
        return DiffusionTrainer(
            base_filters=args.base_filters, timesteps=args.timesteps, lr=args.lr,
            engine=args.engine, remat=remat, compute_dtype=torch.bfloat16,
            loss_weights=tuple(float(w) for w in args.loss_weights.split(",")),
            distribution_choice=args.t_dist, output_dir=ckpt_dir, device=device, **opt_kw)
    # "flax" recomputes through the model's own remat, the eager engines through the trainer's
    model = RDUNet(3, args.base_filters, generator=torch.Generator().manual_seed(0),
                   remat=remat and args.engine == "flax")
    return SupervisedTrainer(model, lr=args.lr, engine=args.engine, remat=remat,
                             compute_dtype=torch.bfloat16, checkpoint_dir=ckpt_dir,
                             device=device)


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    # diffusion-only knobs must not label a supervised run as an ablation it
    # never ran: reject before any data or device work
    if args.algo == "supervised" and (
        args.loss_weights != "0,1,0" or args.t_dist != "uniform"
        or args.optimizer or args.scheduler
    ):
        sys.exit("--loss-weights/--t-dist/--optimizer/--scheduler only apply "
                 "to --algo diffusion")

    from ..data.loader import PatchLoader
    from ..data.resident import DeviceBankLoader
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    diffusion = args.algo == "diffusion"
    print(f"generating {args.n_train}+{args.n_val} synthetic {args.size}^2 images...",
          flush=True)
    t0 = time.time()
    train_clean, val_clean = synth_train_val(args.n_train, args.n_val, args.size,
                                             cache_dir=args.cache_dir)
    print(f"  done in {time.time() - t0:.0f}s", flush=True)

    sigma = args.sigma
    sigma_list = [float(s) for s in args.sigma_list.split(",")] if args.sigma_list else None
    tf = make_transform(device, sigma, sigma_list)
    ckpt_dir = args.ckpt_dir or (CKPT_DIR + "_diffusion" if diffusion else CKPT_DIR)
    trainer = make_trainer(args, device, ckpt_dir)
    if args.device_data:
        loader = DeviceBankLoader(
            train_clean, args.batch_size, transform=tf,
            steps_per_epoch=max(1, len(train_clean) // args.batch_size),
            device=device, seed=LOADER_SEED)
    else:
        loader = PatchLoader(CleanImages(train_clean), args.batch_size, shuffle=True,
                             transform=tf, device=device, seed=LOADER_SEED)
    steps_per_epoch = max(1, len(loader))
    sched_steps = args.sched_steps_per_epoch or steps_per_epoch
    state = trainer.init(sched_steps, seed=0) if diffusion else trainer.init(sched_steps)
    start_epoch = 0
    if args.resume:
        state, start_epoch = trainer.load_checkpoint(state, args.resume)
        # continue the streams: the loader's draws and the timesteps fold in
        # the epoch, so a continuation must not replay the original run's
        loader.epoch = start_epoch
        print(f"resumed from {args.resume} (epoch {start_epoch})", flush=True)

    # fixed held-out noisy/clean pairs (quantized-uint8 noise)
    if sigma_list is not None:
        val_sigmas = np.asarray([sigma_list[i % len(sigma_list)] for i in range(len(val_clean))],
                                np.float32)
    else:
        val_sigmas = np.full((len(val_clean),), sigma, np.float32)
    val_noisy_u8 = heldout_noisy(val_clean, val_sigmas)

    if diffusion:
        def predict(noisy):
            return trainer.sample(state, noisy)
    else:
        def predict(noisy):
            return trainer.evaluate_batch(state, noisy)

    def evaluate():
        per_image = evaluate_psnr(predict, val_noisy_u8, val_clean, EVAL_BATCH[args.algo],
                                  device)
        return float(np.mean(per_image)), per_image

    base_psnrs = noisy_psnr(val_clean, val_noisy_u8)
    psnr_noisy = float(np.mean(base_psnrs))
    sig_desc = sigma_list if sigma_list is not None else sigma
    print(f"noisy-input PSNR @ sigma={sig_desc}: {psnr_noisy:.2f} dB", flush=True)

    best = -1.0
    t_train0 = time.time()
    end_epoch = start_epoch + args.epochs
    partial = {
        "metric": f"rdunet_{args.algo}_synthetic_psnr",
        "sigma": None if sigma_list is not None else sigma,
        "tag": args.tag or None,
        "base_filters": args.base_filters,
        "epochs_target": end_epoch,
        "psnr_noisy_db": round(psnr_noisy, 2),
    }
    previous = exit_on_sigterm(partial, args.out)
    try:
        for epoch in range(start_epoch, end_epoch):
            te = time.time()
            state, loss = trainer.train_epoch(state, loader, epoch)
            if (epoch + 1) % args.eval_every == 0 or epoch == end_epoch - 1:
                p, _ = evaluate()
                best = max(best, p)
                partial.update(epochs_done=epoch + 1, psnr_denoised_db=round(p, 2),
                               psnr_best_db=round(best, 2),
                               train_seconds=round(time.time() - t_train0, 1))
                flush_progress(ckpt_dir, partial)
                print(f"epoch {epoch + 1}/{end_epoch} loss {loss:.4f} val PSNR {p:.2f} dB "
                      f"(best {best:.2f}) [{time.time() - te:.1f}s/epoch]", flush=True)
            else:
                print(f"epoch {epoch + 1}/{end_epoch} loss {loss:.4f} "
                      f"[{time.time() - te:.1f}s/epoch]", flush=True)
            # a mid-run checkpoint under a distinct mid_ name: the final save
            # below is the run's artifact; --resume accepts the mid_ path
            if (args.ckpt_every and (epoch + 1) % args.ckpt_every == 0
                    and epoch != end_epoch - 1):
                if diffusion:
                    trainer.save_epoch_checkpoint(state, epoch, name="mid_checkpoint.pth")
                else:
                    trainer.maybe_checkpoint(state, epoch, force=True,
                                             name="mid_rdunet_denoising.pth")

        final, per_image = evaluate()
        best = max(best, final)
        # label checkpoints and results with the global epoch (resume offset
        # included), so a continuation never overwrites the file it resumed from
        global_last = start_epoch + args.epochs - 1
        if diffusion:
            trainer.save_epoch_checkpoint(state, global_last)
        else:
            trainer.maybe_checkpoint(state, global_last, force=True)
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
    result = {
        "metric": f"rdunet_{args.algo}_synthetic_psnr",
        # the scalar sigma is unused under --sigma-list
        "sigma": None if sigma_list is not None else sigma,
        "tag": args.tag or None,
        "base_filters": args.base_filters,
        "epochs": global_last + 1,
        "steps": (global_last + 1) * steps_per_epoch,
        "psnr_noisy_db": round(psnr_noisy, 2),
        "psnr_denoised_db": round(final, 2),
        "psnr_best_db": round(best, 2),
        "train_seconds": round(time.time() - t_train0, 1),
        "lr": args.lr,
    }
    if diffusion:
        result["timesteps"] = args.timesteps
        result["loss_weights"] = args.loss_weights
        result["t_dist"] = args.t_dist
        if args.optimizer:
            result["optimizer"] = args.optimizer
        if args.scheduler:
            result["scheduler"] = args.scheduler
    if start_epoch:
        result["resumed_from_epoch"] = start_epoch
    if sigma_list is not None:
        result["sigma_list"] = sigma_list
        result["psnr_by_sigma_db"] = {
            str(int(lv)): round(float(per_image[val_sigmas == lv].mean()), 2)
            for lv in sigma_list
        }
        result["psnr_noisy_by_sigma_db"] = {
            str(int(lv)): round(float(base_psnrs[val_sigmas == lv].mean()), 2)
            for lv in sigma_list
        }
    append_row(args.out, result)
    return result


if __name__ == "__main__":
    main()
