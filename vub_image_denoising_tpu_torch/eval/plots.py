"""Publication figure library.  Counterpart of
``vub_image_denoising_tpu/eval/plots.py``, figure-for-figure the reference's
evaluate_Unet_diffusion/plot.py (629 lines), emitting the same PNG set as the
reference's committed ``evaluation_results/`` from host numpy arrays (HWC
images in [0, 1]); matplotlib and scipy are imported when a figure is drawn:

- example_images_comparison.png        (save_example_images, plot.py:21-66)
- error_map.png                        (save_error_map, :68-74)
- histograms_of_differences.png        (save_histograms_of_differences, :76-108)
- heatmaps.png                         (save_heatmaps, :110-130)
- high_frequency_domain_analysis.png   (save_frequency_domain_analysis, :132-209)
- high_frequency_domain_analysis_multiple_epochs.png (:211-261)
- psd_comparison_noise_level_{nl}.png  (plot_psd_comparison, :263-344)
- dists.png                            (save_dists, :346-374)
- inference_time_comparison.png        (save_inference_time_plot, :376-388)
- comparison_plot_with_zones_and_arrows.png (generate_comparison_plot, :390-496)
- metrics.png                          (save_metrics, :498-628)

Deviation: the reference enables LaTeX text rendering (plt.rc('text', usetex=True),
plot.py:18) which requires a TeX install; we use matplotlib's built-in mathtext so the
figures render anywhere.  Palette and layout match.
"""

import os

import numpy as np

PALE_RED = "#FF4136"
PALE_BLUE = "#0074D9"
PALE_GREEN = "#2ECC40"
PALE_YELLOW = "#FFDC00"
PALE_PURPLE = "#B10DC9"


def _plt():
    """matplotlib's pyplot on the headless backend, imported at call time
    (the card's machine need not have matplotlib for the metrics)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.rc("font", family="serif")
    return plt


def _to_u8_hwc(img):
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
        img = np.transpose(img, (1, 2, 0))
    img = img.squeeze()
    if img.dtype != np.uint8:
        img = np.clip(img * 255, 0, 255).astype(np.uint8)
    return img


def _mean_sem(values):
    values = np.asarray(values, np.float64)
    return values.mean(), values.std() / np.sqrt(max(len(values), 1))


def _group_by_noise(values, noise_levels, mask=None):
    values = np.asarray(values)
    noise_levels = np.asarray(noise_levels)
    if mask is None:
        mask = np.ones(len(values), bool)
    uniq = sorted(np.unique(noise_levels))
    means, sems = [], []
    for nl in uniq:
        sel = values[(noise_levels == nl) & mask]
        m, s = _mean_sem(sel) if len(sel) else (np.nan, np.nan)
        means.append(m)
        sems.append(s)
    return uniq, means, sems


def _high_freq_psd(image, threshold=0.5):
    from scipy.signal import welch

    f, pxx = welch(np.asarray(image).squeeze().flatten(), nperseg=256)
    idx = f >= threshold * np.max(f)
    return f[idx], pxx[idx]


def save_example_images(example_images, save_dir, noise_levels_to_plot=(10, 30, 50)):
    plt = _plt()
    filtered = {k: v for k, v in example_images.items() if k in noise_levels_to_plot}
    if not filtered:
        print("No example images to plot.")
        return
    n = len(filtered)
    fig, axs = plt.subplots(n, 4, figsize=(16, 5 * n), constrained_layout=True, squeeze=False)
    titles = ["Ground Truth", "Noisy", "Denoised (UNet)", "Denoised (Diffusion)"]
    for i, (sigma, images) in enumerate(filtered.items()):
        for j, (title, img) in enumerate(zip(titles, images)):
            img = _to_u8_hwc(img)
            axs[i, j].imshow(img, cmap="gray" if img.ndim == 2 else None, vmin=0, vmax=255)
            axs[i, j].set_title(rf"{title} ($\sigma = {sigma}$)", fontsize=12)
            axs[i, j].axis("off")
    fig.suptitle("Image Denoising Comparison Across Noise Levels", fontsize=16)
    plt.savefig(os.path.join(save_dir, "example_images_comparison.png"), dpi=300,
                bbox_inches="tight")
    plt.close(fig)


def save_error_map(gt_image, predicted_image, save_dir):
    plt = _plt()
    error_map = np.abs(np.asarray(gt_image) - np.asarray(predicted_image)).squeeze()
    if error_map.ndim == 3:
        error_map = error_map.mean(axis=-1 if error_map.shape[-1] in (1, 3) else 0)
    plt.figure()
    plt.imshow(error_map, cmap="hot", interpolation="nearest")
    plt.colorbar()
    plt.title("Error Map", fontsize=14)
    plt.savefig(os.path.join(save_dir, "error_map.png"))
    plt.close()


def save_histograms_of_differences(example_images, last_epoch, save_dir,
                                   noise_levels_to_plot=(15, 30, 50)):
    plt = _plt()
    filtered = {
        k: v for k, v in example_images.items()
        if isinstance(k, tuple) and k[1] in noise_levels_to_plot and k[0] == last_epoch
    }
    if not filtered:
        print("No example images to plot.")
        return
    n = len(filtered)
    fig, axs = plt.subplots(n, 2, figsize=(20, 5 * n), constrained_layout=True, squeeze=False)
    for i, ((epoch, sigma), images) in enumerate(filtered.items()):
        gt, _, pred_unet, pred_diff = [np.asarray(im, np.float64) for im in images]
        axs[i, 0].hist((gt - pred_unet).flatten(), bins=50, color=PALE_BLUE, alpha=0.7)
        axs[i, 0].set_title(rf"Histogram of Differences (UNet) - Epoch: {epoch}, $\sigma$: {sigma}")
        axs[i, 0].set_xlabel("Difference")
        axs[i, 0].set_ylabel("Frequency")
        axs[i, 1].hist((gt - pred_diff).flatten(), bins=50, color=PALE_GREEN, alpha=0.7)
        axs[i, 1].set_title(rf"Histogram of Differences (Diffusion) - Epoch: {epoch}, $\sigma$: {sigma}")
        axs[i, 1].set_xlabel("Difference")
        axs[i, 1].set_ylabel("Frequency")
    plt.savefig(os.path.join(save_dir, "histograms_of_differences.png"), dpi=300)
    plt.close(fig)


def save_heatmaps(aggregated_diff_map_unet, aggregated_diff_map_diffusion, save_dir):
    plt = _plt()
    maps = []
    for m in (aggregated_diff_map_unet, aggregated_diff_map_diffusion):
        m = np.asarray(m)
        if m.ndim == 3:
            m = m.mean(axis=0 if m.shape[0] in (1, 3) else -1)
        maps.append(m)
    vmin = min(m.min() for m in maps)
    vmax = max(m.max() for m in maps)
    fig, axs = plt.subplots(1, 2, figsize=(20, 10), constrained_layout=True)
    for ax, m, title in zip(axs, maps, ["Aggregated Difference Map (UNet)",
                                        "Aggregated Difference Map (Diffusion)"]):
        im = ax.imshow(m, cmap="hot", interpolation="nearest", vmin=vmin, vmax=vmax)
        ax.set_title(title, fontsize=14)
        fig.colorbar(im, ax=ax, orientation="vertical")
    plt.savefig(os.path.join(save_dir, "heatmaps.png"), dpi=300)
    plt.close(fig)


def _hf_mae_by_noise(metrics, mask, threshold):
    """Per-noise-level mean/sem of high-frequency PSD MAE for unet and diffusion."""
    noise_levels = np.asarray(metrics["noise_level"])
    uniq = sorted(np.unique(noise_levels))
    out = {"unet": ([], []), "diffusion": ([], [])}
    for nl in uniq:
        sel = np.where((noise_levels == nl) & mask)[0]
        maes = {"unet": [], "diffusion": []}
        for i in sel:
            _, p_gt = _high_freq_psd(metrics["gt_image"][i], threshold)
            _, p_u = _high_freq_psd(metrics["predicted_unet_image"][i], threshold)
            _, p_d = _high_freq_psd(metrics["predicted_diffusion_image"][i], threshold)
            maes["unet"].append(np.mean(np.abs(p_gt - p_u)))
            maes["diffusion"].append(np.mean(np.abs(p_gt - p_d)))
        for k in out:
            m, s = _mean_sem(maes[k]) if maes[k] else (np.nan, np.nan)
            out[k][0].append(m)
            out[k][1].append(s)
    return uniq, out


def save_frequency_domain_analysis(metrics, last_epoch, save_dir, high_freq_threshold=0.5):
    plt = _plt()
    mask = np.asarray(metrics["epoch"]) == last_epoch
    uniq, out = _hf_mae_by_noise(metrics, mask, high_freq_threshold)
    fig, ax = plt.subplots(figsize=(12, 8), constrained_layout=True)
    for key, color, marker, label in [("unet", PALE_BLUE, "o", "UNet Model"),
                                      ("diffusion", PALE_GREEN, "s", "Diffusion Model")]:
        means, sems = np.asarray(out[key][0]), np.asarray(out[key][1])
        ax.plot(uniq, means, "-", label=label, color=color, linewidth=2.5,
                marker=marker, markersize=8)
        ax.fill_between(uniq, means - sems, means + sems, color=color, alpha=0.2)
    ax.set_xlabel(r"Noise Standard Deviation ($\sigma$)", fontsize=14)
    ax.set_ylabel("MAE in High-Frequency Domain", fontsize=14)
    ax.set_title("High-Frequency Domain Analysis of Denoising Models", fontsize=16)
    ax.legend(fontsize=12, loc="upper right", frameon=True, facecolor="white")
    ax.grid(True, which="both", ls="--", alpha=0.3, color="gray")
    ax.set_yscale("log")
    ax.tick_params(axis="both", which="major", labelsize=12)
    plt.savefig(os.path.join(save_dir, "high_frequency_domain_analysis.png"), dpi=300,
                bbox_inches="tight")
    plt.close(fig)


def save_frequency_domain_analysis_multiple_epochs(metrics, epochs, save_dir,
                                                   high_freq_threshold=0.5):
    plt = _plt()
    epoch_arr = np.asarray(metrics["epoch"])
    plt.figure(figsize=(10, 6), constrained_layout=True)
    uniq, out = _hf_mae_by_noise(metrics, np.ones(len(epoch_arr), bool), high_freq_threshold)
    plt.plot(uniq, out["unet"][0], "o-", label="UNet Model", color=PALE_PURPLE)
    colors = [PALE_GREEN, PALE_BLUE, PALE_RED, PALE_YELLOW, "black", "brown",
              "pink", "gray", "cyan", "magenta"]
    for idx, epoch in enumerate(epochs):
        uniq_e, out_e = _hf_mae_by_noise(metrics, epoch_arr == epoch, high_freq_threshold)
        plt.plot(uniq_e, out_e["diffusion"][0], "o-",
                 label=f"Diffusion Model (Epoch {epoch})", color=colors[idx % len(colors)])
    plt.xlabel(r"Noise Standard Deviation ($\sigma$)", fontsize=14)
    plt.ylabel("MAE in High-Frequency Domain", fontsize=14)
    plt.title("MAE in High-Frequency Domain Analysis", fontsize=16)
    plt.legend()
    plt.grid()
    plt.savefig(os.path.join(save_dir, "high_frequency_domain_analysis_multiple_epochs.png"))
    plt.close()


def plot_psd_comparison(metrics, last_epoch, save_dir, high_freq_threshold=0.5):
    plt = _plt()
    from matplotlib.ticker import ScalarFormatter

    noise_levels = np.asarray(metrics["noise_level"])
    epoch_arr = np.asarray(metrics["epoch"])
    for nl in sorted(np.unique(noise_levels)):
        sel = np.where((noise_levels == nl) & (epoch_arr == last_epoch))[0]
        if len(sel) == 0:
            continue
        series = {"gt": [], "degraded": [], "unet": [], "diffusion": []}
        freqs = None
        for i in sel:
            freqs, p = _high_freq_psd(metrics["gt_image"][i], high_freq_threshold)
            series["gt"].append(p)
            series["degraded"].append(_high_freq_psd(metrics["degraded_image"][i], high_freq_threshold)[1])
            series["unet"].append(_high_freq_psd(metrics["predicted_unet_image"][i], high_freq_threshold)[1])
            series["diffusion"].append(_high_freq_psd(metrics["predicted_diffusion_image"][i], high_freq_threshold)[1])

        fig, ax = plt.subplots(figsize=(12, 8), constrained_layout=True)
        styles = [("gt", "Ground Truth", "#000000", 0.1),
                  ("degraded", "Degraded", "#FF4136", 0.1),
                  ("unet", "UNet Model", "#7FDBFF", 0.2),
                  ("diffusion", "Diffusion Model", "#2ECC40", 0.1)]
        for key, label, color, band_alpha in styles:
            arr = np.asarray(series[key])
            avg = arr.mean(axis=0)
            se = arr.std(axis=0) / np.sqrt(len(arr))
            ax.plot(freqs, avg, label=label, color=color, linewidth=2.5)
            ax.fill_between(freqs, avg - se, avg + se, color=color, alpha=band_alpha)
        ax.set_xlabel("Frequency (Hz)", fontsize=14)
        ax.set_ylabel("Power Spectral Density (dB/Hz)", fontsize=14)
        ax.set_yscale("log")
        ax.set_xscale("log")
        ax.set_title(rf"Power Spectral Density Comparison, Noise Level $\sigma$ = {nl:.2f}",
                     fontsize=16)
        ax.legend(fontsize=12, loc="lower left", frameon=True, facecolor="white")
        ax.grid(True, which="both", ls="--", alpha=0.3, color="gray")
        ax.xaxis.set_major_formatter(ScalarFormatter())
        plt.savefig(os.path.join(save_dir, f"psd_comparison_noise_level_{nl:.2f}.png"),
                    dpi=300, bbox_inches="tight")
        plt.close(fig)


def save_dists(metrics, last_epoch, save_dir):
    plt = _plt()
    noise_levels = np.asarray(metrics["noise_level"])
    epoch_mask = np.asarray(metrics["epoch"]) == last_epoch
    fig, ax = plt.subplots(figsize=(10, 6), constrained_layout=True)
    for key, label, color, mask in [
        ("dists_degraded", "Degraded", PALE_RED, None),
        ("dists_unet", "UNet Model", PALE_PURPLE, None),
        ("dists_diffusion", f"Diffusion Model (Epoch {last_epoch})", PALE_GREEN, epoch_mask),
        ("dists_bm3d", "BM3D", PALE_BLUE, None),
    ]:
        vals = np.asarray(metrics.get(key, []), np.float64)
        if len(vals) == 0 or np.all(np.isnan(vals)):
            continue
        uniq, means, _ = _group_by_noise(vals, noise_levels, mask)
        ax.plot(uniq, means, "o-", label=label, color=color)
    ax.set_xlabel(r"Noise Standard Deviation ($\sigma$)", fontsize=14)
    ax.set_ylabel("DISTS", fontsize=14)
    ax.set_title("DISTS Value Variation", fontsize=16)
    ax.legend(fontsize=12)
    ax.grid(True, which="both", ls="--", alpha=0.3)
    plt.savefig(os.path.join(save_dir, "dists.png"), dpi=300, bbox_inches="tight")
    plt.close(fig)


def save_inference_time_plot(inference_times, save_dir):
    plt = _plt()
    plt.figure(figsize=(10, 6), constrained_layout=True)
    plt.bar(["UNet", "Diffusion"],
            [np.mean(inference_times["unet"]) if inference_times["unet"] else 0,
             np.mean(inference_times["diffusion"]) if inference_times["diffusion"] else 0],
            color=[PALE_PURPLE, PALE_GREEN])
    plt.ylabel("Average Inference Time (s)", fontsize=14)
    plt.title("Average Inference Time Comparison", fontsize=16)
    plt.savefig(os.path.join(save_dir, "inference_time_comparison.png"), dpi=300,
                bbox_inches="tight")
    plt.close()


def generate_comparison_plot(metrics, epochs, save_dir, use_bm3d=False):
    plt = _plt()
    from matplotlib.colors import LinearSegmentedColormap

    from scipy.spatial import ConvexHull

    noise_levels = np.asarray(metrics["noise_level"])
    uniq = sorted(np.unique(noise_levels))
    use_bm3d = use_bm3d and "psnr_bm3d" in metrics and "lpips_bm3d" in metrics

    def series(key):
        vals = np.asarray(metrics[key], np.float64)
        pairs = [_mean_sem(vals[noise_levels == nl]) for nl in uniq]
        return [p[0] for p in pairs], [p[1] for p in pairs]

    avg_psnr_d, se_psnr_d = series("psnr_diffusion")
    avg_psnr_u, se_psnr_u = series("psnr_unet")
    avg_lpips_d, se_lpips_d = series("lpips_diffusion")
    avg_lpips_u, se_lpips_u = series("lpips_unet")
    if use_bm3d:
        avg_psnr_b, se_psnr_b = series("psnr_bm3d")
        avg_lpips_b, se_lpips_b = series("lpips_bm3d")

    fig, ax = plt.subplots(figsize=(12, 8), constrained_layout=True)
    cmap = LinearSegmentedColormap.from_list("custom_vibrant", ["#4575B4", "#D73027"], N=256)
    norm = plt.Normalize(vmin=min(uniq), vmax=max(uniq))
    sm = plt.cm.ScalarMappable(cmap=cmap, norm=norm)
    sm.set_array([])

    hull_data = {"diffusion": list(zip(avg_lpips_d, avg_psnr_d)),
                 "unet": list(zip(avg_lpips_u, avg_psnr_u))}
    if use_bm3d:
        hull_data["bm3d"] = list(zip(avg_lpips_b, avg_psnr_b))
    for model, points in hull_data.items():
        pts = np.asarray(points)
        if len(pts) >= 3 and np.ptp(pts, axis=0).min() > 0:
            hull = ConvexHull(pts)
            for simplex in hull.simplices:
                ax.plot(pts[simplex, 0], pts[simplex, 1], color="gray", alpha=0.5,
                        linestyle="--")
            ax.fill(pts[hull.vertices, 0], pts[hull.vertices, 1], alpha=0.1,
                    label=f"{model.capitalize()} Zone")

    for i, nl in enumerate(uniq):
        color = sm.to_rgba(nl)
        ax.errorbar(avg_lpips_d[i], avg_psnr_d[i], xerr=se_lpips_d[i], yerr=se_psnr_d[i],
                    color=color, marker="s", markersize=10, linestyle="", capsize=5,
                    label=f"Diffusion Model ({nl})" if i == 0 else "")
        ax.errorbar(avg_lpips_u[i], avg_psnr_u[i], xerr=se_lpips_u[i], yerr=se_psnr_u[i],
                    color=color, marker="o", markersize=10, linestyle="", capsize=5,
                    label=f"UNet Model ({nl})" if i == 0 else "")
        ax.annotate("", xy=(avg_lpips_d[i], avg_psnr_d[i]),
                    xytext=(avg_lpips_u[i], avg_psnr_u[i]),
                    arrowprops=dict(arrowstyle="->", color=color, alpha=0.7, linewidth=1.5))
        if use_bm3d:
            ax.errorbar(avg_lpips_b[i], avg_psnr_b[i], xerr=se_lpips_b[i], yerr=se_psnr_b[i],
                        color=color, marker="^", markersize=10, linestyle="", capsize=5,
                        label=f"BM3D ({nl})" if i == 0 else "")

    cbar = fig.colorbar(sm, ax=ax)
    cbar.set_label(r"Noise Level ($\sigma$)", rotation=270, labelpad=15)
    ax.set_xlabel("LPIPS (lower is better)", fontsize=14)
    ax.set_ylabel("PSNR (higher is better)", fontsize=14)
    ax.set_title("Model Comparison Across Noise Levels", fontsize=16)
    ax.legend(fontsize=12)
    ax.grid(True, linestyle="--", alpha=0.7)
    ax.annotate("", xy=(0.05, 0.95), xytext=(0.15, 0.95), xycoords="axes fraction",
                textcoords="axes fraction", arrowprops=dict(arrowstyle="->", color="gray"))
    ax.text(0.1, 0.97, "Better LPIPS", ha="center", va="center", transform=ax.transAxes,
            fontsize=10, color="gray")
    ax.annotate("", xy=(0.95, 0.85), xytext=(0.95, 0.95), xycoords="axes fraction",
                textcoords="axes fraction", arrowprops=dict(arrowstyle="<-", color="gray"))
    ax.text(0.97, 0.9, "Better PSNR", ha="center", va="center", transform=ax.transAxes,
            fontsize=10, color="gray", rotation=90)
    plt.savefig(os.path.join(save_dir, "comparison_plot_with_zones_and_arrows.png"),
                dpi=300, bbox_inches="tight")
    plt.close(fig)


def save_metrics(metrics, last_epoch, use_bm3d, save_dir):
    plt = _plt()
    epochs = sorted(set(metrics["epoch"]))
    noise_levels = np.asarray(metrics["noise_level"])
    epoch_arr = np.asarray(metrics["epoch"])
    last_mask = epoch_arr == last_epoch

    fig, axs = plt.subplots(3, 2, figsize=(20, 18), constrained_layout=True)
    rows = [("psnr", "PSNR"), ("ssim", "SSIM"), ("lpips", "LPIPS")]
    for r, (key, label) in enumerate(rows):
        # left column: degraded/unet/diffusion(last)/bm3d
        for suffix, lbl, color, mask in [
            ("degraded", "Degraded", PALE_RED, None),
            ("unet", "UNet Model", PALE_PURPLE, None),
            ("diffusion", f"Diffusion Model (Epoch {last_epoch})", PALE_GREEN, last_mask),
            ("bm3d", "BM3D", PALE_BLUE, None),
        ]:
            if suffix == "bm3d" and not use_bm3d:
                continue
            vals = np.asarray(metrics.get(f"{key}_{suffix}", []), np.float64)
            if len(vals) == 0 or np.all(np.isnan(vals)):
                continue
            uniq, means, sems = _group_by_noise(vals, noise_levels, mask)
            axs[r, 0].errorbar(uniq, means, yerr=sems, fmt="o-", label=lbl, color=color,
                               capsize=5, capthick=2, elinewidth=1)
        axs[r, 0].set_xlabel(r"Noise Standard Deviation ($\sigma$)", fontsize=14)
        axs[r, 0].set_ylabel(label, fontsize=14)
        axs[r, 0].set_title(f"{label} Value Variation Curve", fontsize=16)
        axs[r, 0].legend(fontsize=12)
        axs[r, 0].grid(True, which="both", ls="--", alpha=0.3, color="gray")

        # right column: diffusion per epoch
        colors = ["blue", "orange", "cyan", "magenta", "black", "yellow", "green", "red"]
        for idx, epoch in enumerate(epochs):
            vals = np.asarray(metrics[f"{key}_diffusion"], np.float64)
            uniq, means, sems = _group_by_noise(vals, noise_levels, epoch_arr == epoch)
            axs[r, 1].errorbar(uniq, means, yerr=sems, fmt="o-",
                               label=f"Diffusion Model (Epoch {epoch})",
                               color=colors[idx % len(colors)], capsize=5, capthick=2,
                               elinewidth=1)
        axs[r, 1].set_xlabel(r"Noise Standard Deviation ($\sigma$)", fontsize=14)
        axs[r, 1].set_ylabel(label, fontsize=14)
        axs[r, 1].set_title(f"{label} Value Variation Curve (Diffusion Model)", fontsize=16)
        axs[r, 1].legend(fontsize=12)
        axs[r, 1].grid(True, which="both", ls="--", alpha=0.3, color="gray")

    plt.savefig(os.path.join(save_dir, "metrics.png"), dpi=300, bbox_inches="tight")
    plt.close(fig)
