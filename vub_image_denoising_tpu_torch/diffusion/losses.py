"""Training losses for the diffusion denoiser.

Counterpart of ``vub_image_denoising_tpu/diffusion/losses.py`` (reference
diffusion_denoising/diffusion_RDUnet.py:57-65).  ``combined_loss =
mse_w*MSE + charb_w*Charbonnier + ssim_w*(1 - SSIM)`` with default weights
(0, 1, 0); the SSIM term follows ``pytorch_msssim.ssim``'s defaults (11x11
gaussian window, sigma 1.5, K = (0.01, 0.03), mean over everything).

Tensors are (N, C, H, W).  SSIM's blur is a depthwise f32 convolution; on the
card it matches the reference only with TF32 off (``enable_strict_precision``).
"""

import torch
import torch.nn.functional as F


def charbonnier_loss(pred, target, epsilon=1e-3):
    """mean(sqrt((pred - target)^2 + eps^2))."""
    return torch.mean(torch.sqrt((pred - target) ** 2 + epsilon**2))


def _gaussian_window(size=11, sigma=1.5, device=None):
    coords = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(coords**2) / (2.0 * sigma**2))
    return g / torch.sum(g)


def ssim_map(pred, target, data_range=1.0, win_size=11, sigma=1.5, k1=0.01, k2=0.03):
    """The SSIM map of two (N, C, H, W) batches: a separable gaussian blur per
    channel with VALID padding, one value per window, (N, C, H - win_size + 1,
    W - win_size + 1)."""
    pred = pred.float()
    target = target.float()
    c = pred.shape[1]
    win = _gaussian_window(win_size, sigma, pred.device)
    kh = win.view(1, 1, win_size, 1).expand(c, 1, win_size, 1).contiguous()
    kw = win.view(1, 1, 1, win_size).expand(c, 1, 1, win_size).contiguous()

    def blur(x):
        return F.conv2d(F.conv2d(x, kh, groups=c), kw, groups=c)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_x = blur(pred)
    mu_y = blur(target)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_xx = blur(pred * pred) - mu_xx
    sigma_yy = blur(target * target) - mu_yy
    sigma_xy = blur(pred * target) - mu_xy

    cs = (2 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    return ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs


def ssim(pred, target, data_range=1.0, win_size=11, sigma=1.5, k1=0.01, k2=0.03):
    """Single-scale SSIM of two (N, C, H, W) batches as a scalar: ``ssim_map``
    averaged over all windows, channels and images (pytorch_msssim's
    ``size_average=True``)."""
    return torch.mean(ssim_map(pred, target, data_range, win_size, sigma, k1, k2))


def combined_loss(pred, target, mse_weight=0.0, charbonnier_weight=1.0, ssim_weight=0.0,
                  epsilon=1e-3):
    """Weighted MSE + Charbonnier + (1 - SSIM); a zero-weight MSE or SSIM term
    is not computed."""
    loss = charbonnier_weight * charbonnier_loss(pred, target, epsilon)
    if mse_weight:
        loss = loss + mse_weight * torch.mean((pred - target) ** 2)
    if ssim_weight:
        loss = loss + ssim_weight * (1.0 - ssim(pred, target, data_range=1.0))
    return loss
