"""Image-quality metrics in the reference's conventions, on the input's device.

Counterpart of ``vub_image_denoising_tpu/eval/metrics.py``.  Two conventions
coexist in the reference and both are kept:

- SIDD eval (evaluate_SIDD/evaluate_SIDD.py:63-64): skimage metrics on [-1, 1]
  arrays with ``data_range=2``; SSIM is skimage ``structural_similarity``
  with its defaults: a uniform 7x7 window (not gaussian), unbiased
  covariance (N/(N-1)), border crop, mean over channels.
- comparative suite (evaluate_Unet_diffusion/evaluate_model.py:36-51):
  denormalized [0, 1] arrays with ``data_range=1``; PSNR = 10*log10(range^2/mse).

Inputs are NHWC, (N, H, W, C) or one (H, W, C) image, in any float dtype;
the metrics are computed in f32 and returned as tensors on the input's
device.  The 7x7 mean is ``F.avg_pool2d``, which has no TF32 path, so the
metrics stay f32 exact whatever ``torch.backends`` allow.
"""

import torch
import torch.nn.functional as F


def mse(pred, target, axis=None):
    d = pred.float() - target.float()
    return torch.mean(d * d) if axis is None else torch.mean(d * d, dim=axis)


def _batched(pred, target):
    if pred.dim() == 3:
        return pred[None], target[None]
    return pred, target


def psnr_per_image(pred, target, data_range=1.0):
    """Per-image PSNR vector over an (N, H, W, C) batch: 10*log10(range^2 / mse)."""
    pred, target = _batched(pred, target)
    m = mse(pred, target, axis=(1, 2, 3))
    return 10.0 * torch.log10((data_range ** 2) / m)


def psnr(pred, target, data_range=1.0):
    """Per-image PSNR over (H, W, C), mean over the batch.  Accepts (H, W, C)
    or (N, H, W, C)."""
    return torch.mean(psnr_per_image(pred, target, data_range))


def _ssim_map(pred, target, data_range, win_size, k1, k2):
    """The skimage SSIM map, (N, C, H - win + 1, W - win + 1): the VALID
    window mean is skimage's border crop of win // 2."""
    pred, target = _batched(pred, target)
    x = pred.float().permute(0, 3, 1, 2)
    y = target.float().permute(0, 3, 1, 2)
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    def mean(v):
        return F.avg_pool2d(v, win_size, stride=1)

    ux, uy = mean(x), mean(y)
    uxx, uyy, uxy = mean(x * x), mean(y * y), mean(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    a1 = 2 * ux * uy + c1
    a2 = 2 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    return (a1 * a2) / (b1 * b2)


def ssim_ref(pred, target, data_range=2.0, win_size=7, k1=0.01, k2=0.03):
    """skimage.structural_similarity-compatible SSIM (defaults, multichannel):
    the SSIM map averaged over pixels, channels and the batch.  Accepts
    (H, W, C) or (N, H, W, C)."""
    return torch.mean(_ssim_map(pred, target, data_range, win_size, k1, k2))


def ssim_ref_per_image(pred, target, data_range=2.0, win_size=7, k1=0.01, k2=0.03):
    """Per-image skimage-convention SSIM vector over an (N, H, W, C) batch:
    each image's map averaged over (C, H', W')."""
    return torch.mean(_ssim_map(pred, target, data_range, win_size, k1, k2), dim=(1, 2, 3))
