"""SIDD evaluation on synthetic .mat blocks, per engine: time per block and PSNR/SSIM.

Counterpart of ``scripts/measure_sidd_eval.py``.  Writes a
ValidationNoisy/GtBlocksSrgb.mat pair and a seeded RDUNetT-32 checkpoint
(``unet.`` keys), then runs ``eval/sidd.py::evaluate_sidd`` through
``eval/sidd_cli.py::load_sampler`` (bf16, T = 20) for each engine, printing
the wall and device ms per block and the PSNR/SSIM, and fails unless the
engines agree within 0.05 dB.

Default mode (random blocks, random weights) measures time only.  With
``--checkpoint <trained.pth> --content synthetic`` the blocks are
``scripts/train_accuracy.py``'s ``synth_images`` under the training noise
model (quantized uint8 Gaussian, drawn from a CPU generator seeded 5), so
the PSNR/SSIM is an end-to-end accuracy figure through the SIDD path
(evaluate_SIDD.py conventions: data_range = 2 on [-1, 1]).

Differences from the JAX script: the random checkpoint comes from a torch
generator seeded 0, the synthetic noise from one seeded 5 (JAX:
``PRNGKey(0)``, ``PRNGKey(5)``); ``--device`` (the card unless ``cpu``).

Usage: python -m vub_image_denoising_tpu_torch.scripts.measure_sidd_eval [--engines flax,pallas]
"""

import argparse
import os
import tempfile

import numpy as np

BLOCKS_PER_SCENE, BLOCK_SIZE = 24, 256
NOISE_SEED = 5
ENGINE_PSNR_TOL = 0.05  # dB between engines


def write_blocks(tmp, scenes, content="random", sigma=25.0, blocks_per_scene=BLOCKS_PER_SCENE,
                 size=BLOCK_SIZE):
    """The noisy and GT .mat files under ``tmp``; returns their paths."""
    import scipy.io
    import torch

    from ..data.device import add_gaussian_noise_u8

    rng = np.random.RandomState(0)
    shape = (scenes, blocks_per_scene, size, size, 3)
    if content == "synthetic":
        from .train_accuracy import synth_images

        imgs = synth_images(scenes * blocks_per_scene, size, rng)
        gt = imgs.reshape(shape)
        noisy = add_gaussian_noise_u8(torch.Generator().manual_seed(NOISE_SEED),
                                      torch.from_numpy(imgs), sigma).numpy().reshape(shape)
    else:
        gt = rng.randint(0, 256, shape, np.uint8)
        noisy = np.clip(gt.astype(np.int32) + rng.randint(-25, 25, shape), 0, 255).astype(np.uint8)
    paths = os.path.join(tmp, "noisy.mat"), os.path.join(tmp, "gt.mat")
    scipy.io.savemat(paths[0], {"ValidationNoisyBlocksSrgb": noisy})
    scipy.io.savemat(paths[1], {"ValidationGtBlocksSrgb": gt})
    return paths


def measure(engines, scenes=2, checkpoint="", content="random", sigma=25.0, base_filters=32,
            timesteps=20, blocks_per_scene=BLOCKS_PER_SCENE, size=BLOCK_SIZE, device=None):
    """``evaluate_sidd`` of each engine on the same blocks; returns
    ``{engine: results}``.  Raises ``RuntimeError`` when an engine's PSNR is
    more than ENGINE_PSNR_TOL from the first's."""
    import torch

    from ..eval.sidd import SIDDMatBlocks, evaluate_sidd
    from ..eval.sidd_cli import load_sampler
    from ..models.rdunet import RDUNetT
    from ..utils import checkpoint as ckpt_io
    from ..utils.device import resolve_device

    device = resolve_device(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})", flush=True)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        noisy_mat, gt_mat = write_blocks(tmp, scenes, content, sigma, blocks_per_scene, size)
        ckpt = checkpoint
        if not ckpt:
            unet = RDUNetT(base_filters, generator=torch.Generator().manual_seed(0))
            ckpt = os.path.join(tmp, "ck.pth")
            ckpt_io.save_pth(ckpt, unet.state_dict(), prefix="unet.")
        blocks = SIDDMatBlocks(noisy_mat, gt_mat)
        for engine in engines:
            # --checkpoint files are the user's own: trusted for the unpickling fallback
            sampler = load_sampler(ckpt, base_filters, timesteps, bf16=True, engine=engine,
                                   trusted=bool(checkpoint), device=device)
            res = evaluate_sidd(sampler, blocks, evaluation_percentage=1.0, batch_size=8,
                                csv_path=None, device=device)
            print(f"{engine:7s} wall {res['avg_inference_time_ms']:7.1f} ms/blk  "
                  f"device {res['device_inference_time_ms']:7.1f} ms/blk  "
                  f"psnr {res['avg_psnr']:.3f} ssim {res['avg_ssim']:.4f} "
                  f"({res['n_blocks']} blocks)", flush=True)
            out[engine] = res
    first = out[engines[0]]["avg_psnr"]
    for engine, res in out.items():
        if abs(res["avg_psnr"] - first) >= ENGINE_PSNR_TOL:
            raise RuntimeError(f"engines disagree: {engine} {res['avg_psnr']:.3f} dB against "
                               f"{engines[0]} {first:.3f}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", default="",
                    help="trained .pth (default: random init — timing only)")
    ap.add_argument("--content", choices=("random", "synthetic"), default="random")
    ap.add_argument("--sigma", type=float, default=25.0,
                    help="noise level for --content synthetic")
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--engines", default="flax,xla,pallas")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    measure(args.engines.split(","), args.scenes, args.checkpoint, args.content, args.sigma,
            device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
