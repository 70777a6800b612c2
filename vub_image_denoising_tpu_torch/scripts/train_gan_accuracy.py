"""GAN-family accuracy run: train the RCA-GAN, the attention-U-Net GAN or the
diffusion-GAN hybrid on fixed noisy/clean grayscale pairs and report the
held-out PSNR of the eval-mode generator.

Counterpart of ``scripts/train_tpu_gan_accuracy.py``: grayscale
DIV2K-stand-in content (the luma of ``train_accuracy.synth_train_val``'s
images), FIXED sigma-noise degraded/gt pairs (the reference GANs train on
fixed paired folders, not per-step noise), shuffled minibatches normalized
to [-1, 1].  The GANs run on cuDNN convs, no kernel of ours.  The pairs'
noise comes from CPU torch generators (``TRAIN_NOISE_SEED``,
``train_accuracy.VAL_NOISE_SEED``) where the JAX script uses
``PRNGKey(7)`` / ``(123)``; the log and checkpoints go to the port's own
paths.  Added flags: ``--device`` (the card unless ``cpu``) and
``--cache-dir``.

Usage:
    python -m vub_image_denoising_tpu_torch.scripts.train_gan_accuracy --algo attention --epochs 40
Prints one JSON line at the end and appends it to ``--out``; every eval
rewrites ``<ckpt-dir>/progress.json``, SIGTERM appends a
``{"partial": true}`` row and exits 143.
"""

import argparse
import signal
import sys
import time

import numpy as np

from .train_accuracy import (CACHE_DIR, OUT, VAL_NOISE_SEED, exit_on_sigterm, append_row,
                             flush_progress, heldout_noisy, synth_train_val)

TRAIN_NOISE_SEED = 7
LAMBDA_FLAGS = (("lam_feat", "lambda_pixel"), ("lam_content", "lambda_perceptual"),
                ("lam_texture", "lambda_texture"), ("lam_adv", "lambda_adv"))


class PairLoader:
    """Shuffled minibatches over FIXED (degraded, gt) uint8 NHWC pairs, as
    NCHW f32 tensors in [-1, 1] (Normalize(0.5, 0.5)); one RandomState
    for the whole run."""

    def __init__(self, deg_u8, gt_u8, batch_size, seed=0, shuffle=True):
        self.deg, self.gt = deg_u8, gt_u8
        self.bs = int(batch_size)
        self.rng = np.random.RandomState(seed)
        self.shuffle = shuffle

    def __len__(self):
        return max(1, len(self.deg) // self.bs)

    @staticmethod
    def _norm(u8):
        import torch

        return torch.from_numpy(u8.astype(np.float32) / 255.0 * 2.0 - 1.0).permute(0, 3, 1, 2)

    def __iter__(self):
        order = (self.rng.permutation(len(self.deg)) if self.shuffle
                 else np.arange(len(self.deg)))
        for s in range(len(self)):
            idx = order[s * self.bs:(s + 1) * self.bs]
            yield self._norm(self.deg[idx]), self._norm(self.gt[idx])


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--algo", choices=("rca", "attention", "hybrid"), default="rca")
    ap.add_argument("--critic-norm", choices=("bn", "none", "layernorm"), default="bn",
                    help="RCA critic normalization ('bn' is the reference architecture)")
    ap.add_argument("--num-timesteps", type=int, default=1000,
                    help="DDPM timesteps for --algo hybrid")
    ap.add_argument("--tag", default="", help="extra label for the output record")
    # RCA G-objective slot weights, named by slot: feat = VGG-feature MSE,
    # content = pixel L1, texture = gram MSE, adv = WGAN adversarial;
    # -1 keeps the reference values (1, 0.01, 0.001, 1)
    ap.add_argument("--lam-feat", type=float, default=-1.0)
    ap.add_argument("--lam-content", type=float, default=-1.0)
    ap.add_argument("--lam-texture", type=float, default=-1.0)
    ap.add_argument("--lam-adv", type=float, default=-1.0)
    ap.add_argument("--adv-ramp-steps", type=int, default=0,
                    help="linear warm-up of the adversarial G slot over this many "
                         "steps (0 = reference behavior; rca/hybrid only)")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--n-train", type=int, default=256)
    ap.add_argument("--n-val", type=int, default=64)
    ap.add_argument("--sigma", type=float, default=25.0)
    ap.add_argument("--lr", type=float, default=0.0,
                    help="0 = the reference default (rca 5e-5, attention 1e-4)")
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    ap.add_argument("--cache-dir", default=CACHE_DIR,
                    help="where the synthetic images are cached")
    return ap


def make_trainer(args, device, ckpt_dir, lam_kw, steps_per_epoch):
    """The trainer of ``args.algo`` and its state (the hybrid re-initialized
    with ``weights_init_normal``, experimental_diffusion_gan.py:405-414)."""
    lr_kw = {"lr": args.lr} if args.lr else {}
    if args.algo == "attention":
        from ..train.denoising_gan import DenoisingGANTrainer

        trainer = DenoisingGANTrainer(checkpoint_dir=ckpt_dir, device=device, **lr_kw)
        return trainer, trainer.init(steps_per_epoch)
    if args.algo == "hybrid":
        from ..train.gan import rca_gan_diffusion_trainer

        return rca_gan_diffusion_trainer(
            steps_per_epoch, disc_input_hw=args.size, num_timesteps=args.num_timesteps,
            checkpoint_dir=ckpt_dir, critic_norm=args.critic_norm,
            adv_ramp_steps=args.adv_ramp_steps, device=device, **lam_kw, **lr_kw)
    from ..train.gan import RCAGANTrainer

    trainer = RCAGANTrainer(checkpoint_dir=ckpt_dir, disc_input_hw=args.size,
                            critic_norm=args.critic_norm, adv_ramp_steps=args.adv_ramp_steps,
                            device=device, **lam_kw, **lr_kw)
    return trainer, trainer.init(steps_per_epoch)


def evaluate_gan(generate, val_deg_u8, val_gt_u8, device, batch=32):
    """Mean held-out PSNR of ``generate(x, s)`` (x an NCHW batch in [-1, 1]
    starting at row s): its output mapped to [0, 1], clipped, against the
    clean image with ``data_range=1``."""
    import torch

    from ..eval.metrics import psnr_per_image

    outs = []
    for s in range(0, len(val_deg_u8), batch):
        x = PairLoader._norm(val_deg_u8[s:s + batch]).to(device)
        out = generate(x, s)
        outs.append(torch.clamp((out.float() + 1.0) * 0.5, 0.0, 1.0).permute(0, 2, 3, 1))
    gt01 = torch.from_numpy(val_gt_u8.astype(np.float32) / 255.0).to(device)
    p = psnr_per_image(gt01, torch.cat(outs), data_range=1.0)
    return float(np.mean(p.double().cpu().numpy()))


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    # the attention GAN applies neither the RCA critic norm nor the slot
    # weights: reject before any data or device work
    if args.algo == "attention" and (
        args.critic_norm != "bn" or args.adv_ramp_steps
        or any(getattr(args, f) >= 0 for f, _ in LAMBDA_FLAGS)
    ):
        sys.exit("--critic-norm/--lam-*/--adv-ramp-steps only apply to "
                 "--algo rca/hybrid")

    import torch

    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    print(f"generating {args.n_train}+{args.n_val} synthetic {args.size}^2 "
          "grayscale images...", flush=True)
    t0 = time.time()
    # grayscale = luma of the RGB recipe (the paper GANs train on 1-channel pairs)
    train_rgb, val_rgb = synth_train_val(args.n_train, args.n_val, args.size,
                                         cache_dir=args.cache_dir)
    train_gt = train_rgb.mean(axis=-1, keepdims=True).astype(np.uint8)
    val_gt = val_rgb.mean(axis=-1, keepdims=True).astype(np.uint8)
    print(f"  done in {time.time() - t0:.0f}s", flush=True)

    # FIXED degraded pairs (quantized-uint8 noise)
    train_deg = heldout_noisy(train_gt, np.full(len(train_gt), args.sigma), TRAIN_NOISE_SEED)
    val_deg = heldout_noisy(val_gt, np.full(len(val_gt), args.sigma), VAL_NOISE_SEED)

    ckpt_dir = args.ckpt_dir or f"runs/torch_accuracy_ckpt_gan_{args.algo}"
    lam_kw = {field: getattr(args, flag) for flag, field in LAMBDA_FLAGS
              if getattr(args, flag) >= 0}
    loader = PairLoader(train_deg, train_gt, args.batch_size, seed=1)
    trainer, state = make_trainer(args, device, ckpt_dir, lam_kw, len(loader))

    if args.algo == "hybrid":
        def generate(x, s):
            return trainer.generate(state, x, torch.Generator(device=device).manual_seed(s))
    else:
        def generate(x, s):
            return trainer.generate(state, x)

    mse = ((val_gt.astype(np.float32) / 255 - val_deg.astype(np.float32) / 255) ** 2
           ).mean(axis=(1, 2, 3))
    psnr_noisy = float(np.mean(10 * np.log10(1.0 / mse)))
    print(f"noisy-input PSNR @ sigma={args.sigma}: {psnr_noisy:.2f} dB", flush=True)

    partial = {"metric": "gan_synthetic_psnr", "algo": args.algo,
               "tag": args.tag or None, "size": args.size,
               "n_train": args.n_train, "epochs_target": args.epochs,
               "psnr_noisy_db": round(psnr_noisy, 2)}
    previous = exit_on_sigterm(partial, args.out)
    best = -1.0
    t0 = time.time()
    try:
        for epoch in range(args.epochs):
            te = time.time()
            state, d_loss, g_loss = trainer.train_epoch(state, loader, epoch)
            line = (f"epoch {epoch + 1}/{args.epochs} d {d_loss:.4f} g {g_loss:.4f} "
                    f"[{time.time() - te:.1f}s/epoch]")
            if (epoch + 1) % args.eval_every == 0 or epoch == args.epochs - 1:
                psnr = evaluate_gan(generate, val_deg, val_gt, device)
                best = max(best, psnr)
                partial.update(epochs_done=epoch + 1, psnr_denoised_db=round(psnr, 2),
                               psnr_best_db=round(best, 2), d_loss=round(d_loss, 3),
                               train_seconds=round(time.time() - t0, 1))
                flush_progress(ckpt_dir, partial)
                line += f" val PSNR {psnr:.2f} dB (best {best:.2f})"
            print(line, flush=True)
        train_seconds = time.time() - t0
        trainer.save_checkpoint(state, args.epochs - 1)
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)

    rec = {
        "metric": "gan_synthetic_psnr",
        "algo": args.algo,
        # None for algos where the knob does not exist (attention)
        "critic_norm": args.critic_norm if args.algo in ("rca", "hybrid") else None,
        "n_train": args.n_train,
        "lr": args.lr or None,
        "tag": args.tag or None,
        "lambdas": lam_kw or None,
        "adv_ramp_steps": args.adv_ramp_steps or None,
        "sigma": args.sigma,
        "size": args.size,
        "epochs": args.epochs,
        "steps": args.epochs * len(loader),
        "psnr_noisy_db": round(psnr_noisy, 2),
        "psnr_denoised_db": round(psnr, 2),
        "psnr_best_db": round(best, 2),
        "d_loss_final": round(d_loss, 3),
        "g_loss_final": round(g_loss, 3),
        "train_seconds": round(train_seconds, 1),
    }
    append_row(args.out, rec)
    return rec


if __name__ == "__main__":
    main()
