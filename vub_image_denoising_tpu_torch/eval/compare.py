"""Comparative evaluation suite.  Counterpart of
``vub_image_denoising_tpu/eval/compare.py`` (reference
evaluate_Unet_diffusion/evaluate_model.py:24-327, ``evaluate_model_and_plot``).

Evaluates a supervised RDUNet checkpoint and one or more diffusion
checkpoints (by epoch) over a validation loader across noise levels:
per-image PSNR, SSIM, LPIPS and DISTS, wall-clock inference times,
aggregated |gt - pred| difference maps and example images
(``evaluate_models``), then the full figure suite of ``eval/plots.py``
(``plot_evaluation``; ``evaluate_model_and_plot`` is the two).  The U-Net
forward and the T-step sampler run the port's models on ``device`` (the
card unless ``"cpu"``), so every DenoisingBlock runs kernel 1 there: 14
launches per U-Net forward, 14*T per sampler call.

Reference conventions replicated exactly (including quirks):

- PSNR/SSIM are computed on the raw [-1,1] loader tensors with data_range=1.0
  (evaluate_model.py:50-51), about 6 dB below the standard [0,1] convention;
- LPIPS/DISTS inputs go through ``normalize_to_neg1_1`` (2x-1) even though
  the tensors are already [-1,1] (:27-28,60-61);
- grayscale LPIPS inputs are channel-repeated to 3 (:57-58);
- BM3D runs on grayscale-averaged denormalized images with sigma_psd=30/255
  and per-sample exception swallowing (:164-218), through the ``bm3d``
  package when it is installed, else ``ops/bm3d.py``.

``strict_reference_conventions=False`` gives the corrected metrics
(denormalized [0,1], data_range=1).  Batches are (degraded, gt[, sigma])
with NCHW images in [-1, 1]; the figures take HWC images in [0, 1].
"""

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..diffusion.interpolation import InterpolationDiffusion
from ..models.rdunet import RDUNet, RDUNetT
from ..utils import checkpoint as ckpt_io
from ..utils.device import resolve_device
from . import plots
from .metrics import psnr as psnr_metric
from .metrics import psnr_per_image, ssim_ref, ssim_ref_per_image
from .perceptual import make_dists, make_lpips

KEYS = ["psnr", "ssim", "lpips", "dists"]
VARIANTS = ["degraded", "diffusion", "unet", "bm3d"]


def denormalize(x, mean=0.5, std=0.5):
    return x * std + mean


def _nhwc(x):
    return x.float().permute(0, 2, 3, 1)


def make_batch_metrics(lpips_fn, dists_fn, strict=True):
    """One call computing per-image PSNR/SSIM/LPIPS/DISTS vectors for a
    batch of NCHW images on their device: the reference's per-image values
    (evaluate_model.py:46-71, its conventions; see the module docstring)
    without a host round-trip per image."""

    def f(gt, proc):
        with torch.no_grad():
            gt, proc = gt.float(), proc.float()
            a, b = (gt, proc) if strict else (denormalize(gt), denormalize(proc))
            p = psnr_per_image(_nhwc(a), _nhwc(b), data_range=1.0)
            s = ssim_ref_per_image(_nhwc(a), _nhwc(b), data_range=1.0)
            ga, gb = (2 * gt - 1, 2 * proc - 1) if strict else (gt, proc)
            if ga.shape[1] == 1:
                ga, gb = ga.repeat(1, 3, 1, 1), gb.repeat(1, 3, 1, 1)
            nan = torch.full(p.shape, float("nan"), device=p.device)
            lp = lpips_fn(ga, gb).to(p.device) if lpips_fn else nan
            di = dists_fn(ga, gb).to(p.device) if dists_fn else nan
            return p, s, lp, di

    return f


def compute_metrics(gt, processed, lpips_fn, dists_fn, strict=True):
    """Per-image metrics; gt/processed are (H, W, C) arrays in [-1, 1]."""
    gt = torch.from_numpy(np.asarray(gt, np.float32))
    processed = torch.from_numpy(np.asarray(processed, np.float32))
    # reference quirk: metrics on [-1, 1] with range 1
    a, b = (gt, processed) if strict else (denormalize(gt), denormalize(processed))
    psnr_v = float(psnr_metric(a, b, data_range=1.0))
    ssim_v = float(ssim_ref(a, b, data_range=1.0))
    ga, gb = (2 * gt - 1, 2 * processed - 1) if strict else (gt, processed)
    ga, gb = ga.permute(2, 0, 1)[None], gb.permute(2, 0, 1)[None]
    if ga.shape[1] == 1:
        ga, gb = ga.repeat(1, 3, 1, 1), gb.repeat(1, 3, 1, 1)
    lpips_v = float(lpips_fn(ga, gb)[0]) if lpips_fn else float("nan")
    dists_v = float(dists_fn(ga, gb)[0]) if dists_fn else float("nan")
    return psnr_v, ssim_v, lpips_v, dists_v


def _load_model(model, path, device, prefix="", allow_pickle=False):
    """A reference ``.pth`` (dict-wrapped or bare; evaluate_model.py:94-110)
    loaded strictly, the model on ``device`` for inference."""
    ckpt_io.load_pth(path, model, prefix=prefix, allow_pickle=allow_pickle)
    model = model.to(device).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def _timed(fn, x, device):
    """fn(x) and its wall time; on the card, to the end of its work."""
    t0 = time.perf_counter()
    with torch.no_grad():
        y = fn(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return y, time.perf_counter() - t0


def _host_hwc(x):
    return np.asarray(_nhwc(x).cpu())


@dataclasses.dataclass
class Evaluation:
    """What ``evaluate_models`` measured, and what the figures need."""

    metrics: Dict[str, List[Any]]
    inference_times: Dict[str, List[float]]
    example_images: Dict[Any, tuple]
    mean_diff_unet: Optional[np.ndarray]
    mean_diff_diffusion: Optional[np.ndarray]
    evaluate_unet: bool


def evaluate_models(
    epochs: Sequence[int],
    diffusion_model_paths: Sequence[str],
    unet_model_path: str,
    val_loader,
    include_noise_level: bool = False,
    use_bm3d: bool = False,
    timesteps: int = 20,
    unet_base_filters: int = 128,
    diffusion_base_filters: int = 32,
    strict_reference_conventions: bool = True,
    lpips_weights: Optional[str] = None,
    max_batches: Optional[int] = None,
    trusted_checkpoints: bool = False,
    device=None,
) -> Evaluation:
    """The metric loop of ``evaluate_model_and_plot``, without figures.

    ``trusted_checkpoints=True`` allows the full-unpickling ``torch.load``
    fallback for checkpoints that fail the safe weights-only path; pass it
    only for files you wrote yourself."""
    device = resolve_device(device)
    # exact-f32 convs for the metric/eval path (TF32 off)
    from .. import enable_strict_precision

    enable_strict_precision()

    lpips_fn, _ = make_lpips(weights_path=lpips_weights, device=device)
    dists_fn, _ = make_dists(device=device)
    batch_metrics = make_batch_metrics(lpips_fn, dists_fn, strict_reference_conventions)

    metrics = {f"{k}_{v}": [] for k in KEYS for v in VARIANTS}
    metrics.update({"epoch": [], "noise_level": [], "gt_image": [],
                    "degraded_image": [], "predicted_unet_image": [],
                    "predicted_diffusion_image": []})
    example_images = {}
    agg_diff_unet, agg_diff_diffusion, agg_count = None, None, 0
    inference_times = {"unet": [], "diffusion": []}

    evaluate_unet = os.path.exists(unet_model_path)
    if evaluate_unet:
        unet = _load_model(RDUNet(3, unet_base_filters), unet_model_path, device,
                           allow_pickle=trusted_checkpoints)
    else:
        print(f"UNet model path '{unet_model_path}' does not exist. Skipping UNet evaluation.")

    diffusion = InterpolationDiffusion(timesteps=timesteps)

    if use_bm3d:
        try:
            import bm3d  # noqa: F401
        except ImportError:
            # the pip package is absent: the native numpy two-stage
            # implementation has its call surface
            from ..ops import bm3d  # noqa: F401

            print("bm3d package not available; using the native BM3D implementation.")

    for epoch, dpath in zip(epochs, diffusion_model_paths):
        unet_t = _load_model(RDUNetT(diffusion_base_filters), dpath, device, prefix="unet.",
                             allow_pickle=trusted_checkpoints)

        for batch_idx, data in enumerate(val_loader):
            if max_batches is not None and batch_idx >= max_batches:
                break
            if include_noise_level:
                degraded, gt, noise_levels = data
            else:
                (degraded, gt), noise_levels = data, None
            degraded = torch.as_tensor(degraded).to(device, torch.float32)
            gt = torch.as_tensor(gt).to(device, torch.float32)
            if device.type == "cuda":
                degraded = degraded.contiguous(memory_format=torch.channels_last)

            # the reference's cuda.synchronize timing (evaluate_model.py:126-143)
            pred_diffusion, sec = _timed(
                lambda x: diffusion.improved_sampling(unet_t, x), degraded, device)
            inference_times["diffusion"].append(sec)
            if evaluate_unet:
                pred_unet, sec = _timed(unet, degraded, device)
                inference_times["unet"].append(sec)
            else:
                pred_unet = pred_diffusion

            # batched metrics: one call per variant instead of per image
            res_deg_b = [v.cpu().numpy() for v in batch_metrics(gt, degraded)]
            res_dif_b = [v.cpu().numpy() for v in batch_metrics(gt, pred_diffusion)]
            res_un_b = ([v.cpu().numpy() for v in batch_metrics(gt, pred_unet)]
                        if evaluate_unet else None)

            degraded_np, gt_np = _host_hwc(degraded), _host_hwc(gt)
            pd_np, pu_np = _host_hwc(pred_diffusion), _host_hwc(pred_unet)

            for j in range(degraded_np.shape[0]):
                res_deg = tuple(float(v[j]) for v in res_deg_b)
                res_dif = tuple(float(v[j]) for v in res_dif_b)
                res_un = tuple(float(v[j]) for v in res_un_b) if evaluate_unet else (np.nan,) * 4

                if use_bm3d:
                    try:
                        deg01 = denormalize(degraded_np[j]).mean(axis=-1)
                        gt01 = torch.from_numpy(denormalize(gt_np[j]).mean(axis=-1))[..., None]
                        den = bm3d.bm3d(deg01, sigma_psd=30 / 255,
                                        stage_arg=bm3d.BM3DStages.ALL_STAGES)
                        den = torch.from_numpy(np.asarray(den, np.float32))[..., None]
                        res_bm = (float(psnr_metric(gt01, den, 1.0)),
                                  float(ssim_ref(gt01, den, 1.0)), np.nan, np.nan)
                    except Exception as e:  # per-sample swallow (evaluate_model.py:207-218)
                        print(f"BM3D failed: {e}")
                        res_bm = (np.nan,) * 4
                else:
                    res_bm = (np.nan,) * 4

                for ki, k in enumerate(KEYS):
                    metrics[f"{k}_degraded"].append(res_deg[ki])
                    metrics[f"{k}_diffusion"].append(res_dif[ki])
                    metrics[f"{k}_unet"].append(res_un[ki])
                    metrics[f"{k}_bm3d"].append(res_bm[ki])

                nl = float(noise_levels[j]) if noise_levels is not None else 0.0
                metrics["epoch"].append(epoch)
                metrics["noise_level"].append(nl)
                gt01, deg01 = denormalize(gt_np[j]), denormalize(degraded_np[j])
                pd01, pu01 = denormalize(pd_np[j]), denormalize(pu_np[j])
                metrics["gt_image"].append(gt01)
                metrics["degraded_image"].append(deg01)
                metrics["predicted_unet_image"].append(pu01)
                metrics["predicted_diffusion_image"].append(pd01)

                diff_u, diff_d = np.abs(gt01 - pu01), np.abs(gt01 - pd01)
                if agg_diff_unet is None:
                    agg_diff_unet, agg_diff_diffusion = diff_u, diff_d
                else:
                    agg_diff_unet = agg_diff_unet + diff_u
                    agg_diff_diffusion = agg_diff_diffusion + diff_d
                agg_count += 1

                if nl in (10, 15, 30, 50):
                    example_images.setdefault(int(nl), (gt01, deg01, pu01, pd01))
                    example_images.setdefault((epoch, int(nl)), (gt01, deg01, pu01, pd01))

    if agg_count:
        agg_diff_unet = agg_diff_unet / agg_count
        agg_diff_diffusion = agg_diff_diffusion / agg_count
    return Evaluation(metrics, inference_times, example_images, agg_diff_unet,
                      agg_diff_diffusion, evaluate_unet)


def plot_evaluation(ev: Evaluation, epochs: Sequence[int], use_bm3d: bool = False,
                    save_dir: str = "results"):
    """The figure suite of ``evaluate_model_and_plot`` from an evaluation."""
    os.makedirs(save_dir, exist_ok=True)
    metrics, last_epoch = ev.metrics, epochs[-1]
    if ev.mean_diff_unet is not None:
        plots.save_heatmaps(ev.mean_diff_unet, ev.mean_diff_diffusion, save_dir)
    plots.save_example_images({k: v for k, v in ev.example_images.items()
                               if isinstance(k, int)}, save_dir)
    plots.save_histograms_of_differences(
        {k: v for k, v in ev.example_images.items() if isinstance(k, tuple)},
        last_epoch, save_dir)
    plots.save_frequency_domain_analysis(metrics, last_epoch, save_dir)
    plots.save_frequency_domain_analysis_multiple_epochs(metrics, list(epochs), save_dir)
    plots.plot_psd_comparison(metrics, last_epoch, save_dir)
    plots.save_dists(metrics, last_epoch, save_dir)
    plots.save_inference_time_plot(ev.inference_times, save_dir)
    if ev.evaluate_unet:
        plots.generate_comparison_plot(metrics, list(epochs), save_dir, use_bm3d=use_bm3d)
    plots.save_metrics(metrics, last_epoch, use_bm3d, save_dir)


def evaluate_model_and_plot(
    epochs: Sequence[int],
    diffusion_model_paths: Sequence[str],
    unet_model_path: str,
    val_loader,
    include_noise_level: bool = False,
    use_bm3d: bool = False,
    save_dir: str = "results",
    timesteps: int = 20,
    unet_base_filters: int = 128,
    diffusion_base_filters: int = 32,
    strict_reference_conventions: bool = True,
    lpips_weights: Optional[str] = None,
    max_batches: Optional[int] = None,
    trusted_checkpoints: bool = False,
    device=None,
):
    """``evaluate_models`` then ``plot_evaluation`` into ``save_dir``;
    returns ``(metrics, inference_times)``."""
    os.makedirs(save_dir, exist_ok=True)
    ev = evaluate_models(
        epochs, diffusion_model_paths, unet_model_path, val_loader,
        include_noise_level=include_noise_level, use_bm3d=use_bm3d, timesteps=timesteps,
        unet_base_filters=unet_base_filters, diffusion_base_filters=diffusion_base_filters,
        strict_reference_conventions=strict_reference_conventions,
        lpips_weights=lpips_weights, max_batches=max_batches,
        trusted_checkpoints=trusted_checkpoints, device=device)
    plot_evaluation(ev, epochs, use_bm3d, save_dir)
    return ev.metrics, ev.inference_times
