"""The comparative suite's degraded and BM3D rows depend on the images and
the noise only, never on the checkpoints or the sampler's steps.

``run_comparative_suite`` makes its noisy images from ``RandomState(7)``'s
synthetic images and a CPU generator seeded ``NOISE_SEED``, and BM3D runs
on the noisy image's grayscale mean at a fixed sigma.  So the two recorded
rows (``comparative``: RDUNet-32 and RDUNetT-32; ``comparative_flagship``:
RDUNet-128 and the gap_stage2 RDUNetT-32) score BM3D on identical inputs,
and one BM3D pass serves both: here two runs of the runner on differently
seeded checkpoints, written as ``train_accuracy`` writes them, at T = 2
and T = 3, give the same degraded and BM3D rows bit for bit and different
U-Net and diffusion rows.
"""

import numpy as np
import torch

from test_torch_rdunet import one_thread  # noqa: F401 — autouse
from vub_image_denoising_tpu_torch.eval.compare import KEYS
from vub_image_denoising_tpu_torch.models import RDUNet
from vub_image_denoising_tpu_torch.scripts import run_comparative_suite as rcs
from vub_image_denoising_tpu_torch.train.diffusion import DiffusionTrainer
from vub_image_denoising_tpu_torch.train.supervised import SupervisedTrainer

BASE, SIZE, N_IMAGES = 8, 32, 2


def write_checkpoints(ckpt_dir, seed):
    """The final files of a supervised and a diffusion ``train_accuracy``
    run (weights, AdamW and schedule state) for models drawn from ``seed``."""
    model = RDUNet(3, BASE, generator=torch.Generator().manual_seed(seed))
    sup = SupervisedTrainer(model, checkpoint_dir=str(ckpt_dir), device="cpu")
    unet = sup.maybe_checkpoint(sup.init(1), 0, force=True)
    diff = DiffusionTrainer(base_filters=BASE, output_dir=str(ckpt_dir), device="cpu")
    diff.save_epoch_checkpoint(diff.init(1, seed=seed), 0)
    return unet, str(ckpt_dir / "diffusion_RDUNet_model_checkpointed_epoch_1.pth")


def test_degraded_and_bm3d_rows_do_not_depend_on_the_checkpoints(tmp_path, monkeypatch):
    monkeypatch.setattr(rcs, "have_matplotlib", lambda: False)
    runs = {}
    for seed, timesteps in ((0, 2), (1, 3)):
        unet, diffusion = write_checkpoints(tmp_path / f"ck{seed}", seed)
        args = rcs.build_arg_parser().parse_args([
            "--device", "cpu", "--n-images", str(N_IMAGES), "--size", str(SIZE),
            "--batch-size", "2", "--base-filters", str(BASE), "--timesteps", str(timesteps),
            "--epoch-label", "1", "--unet-ckpt", unet, "--diffusion-ckpt", diffusion,
            "--save-dir", str(tmp_path / f"out{seed}")])
        runs[seed] = rcs.run_suite(args)
    (sum_a, met_a), (sum_b, met_b) = runs[0], runs[1]
    assert met_a["noise_level"] == met_b["noise_level"] == [10.0, 20.0]
    for variant in ("degraded", "bm3d"):
        for k in KEYS:
            a, b = np.asarray(met_a[f"{k}_{variant}"]), np.asarray(met_b[f"{k}_{variant}"])
            assert a.shape == (N_IMAGES,) and np.array_equal(a, b, equal_nan=True), (k, variant)
        for k in ("psnr", "ssim"):
            assert sum_a[f"{k}_{variant}_by_sigma"] == sum_b[f"{k}_{variant}_by_sigma"]
    assert np.isfinite(met_a["psnr_bm3d"]).all()
    for variant in ("unet", "diffusion"):
        a, b = np.asarray(met_a[f"psnr_{variant}"]), np.asarray(met_b[f"psnr_{variant}"])
        assert np.isfinite(a).all() and np.isfinite(b).all()
        assert not np.any(a == b), variant
