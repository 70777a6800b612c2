"""On-device data transforms: noise injection, augmentation, normalization.

Counterpart of ``vub_image_denoising_tpu/data/device.py``:

- Gaussian noise is added in [0, 255], clipped, and cast to uint8, which
  truncates (the reference's quantization, custom_dataset.py:83-87).
- Augmentation: one horizontal flip (p = 0.5) and one rotation in ±10° per
  pair, applied to both images (nearest neighbour, zero fill; torchvision's
  RandomRotation defaults).
- Normalization maps uint8 -> [0, 1] -> [-1, 1] (ToTensor + Normalize(0.5, 0.5)).

Images are NHWC tensors on the caller's device.  The pipelines compute in
NHWC and return ``x.permute(0, 3, 1, 2)``: NCHW in ``channels_last`` memory,
which the trainers take, with no copy.  Where the JAX functions take a PRNG
``key``, these take a ``torch.Generator`` on the images' device; the optional
``noise=``, ``flips=`` and ``angles=`` replace its draws (the tests hand
JAX's draws over).  ``fold_generator`` stands in for ``jax.random.fold_in``.
"""

import math

import numpy as np
import torch


def fold_generator(device, *path) -> torch.Generator:
    """A generator on ``device`` seeded from ``path``, a sequence of
    non-negative ints or tuples of them (e.g. ``((seed, split), epoch, step)``): the
    counterpart of ``fold_in(fold_in(key, epoch), step)``.  Equal paths give
    equal streams; distinct paths give unrelated ones."""
    flat = []
    for p in path:
        flat.extend(p if isinstance(p, (tuple, list)) else (p,))
    # the length leads: SeedSequence pads short entropy with zeros, so (a, b)
    # and (a, b, 0) would otherwise name one stream
    entropy = [len(flat), *(int(v) for v in flat)]
    seed = int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def add_gaussian_noise_u8(generator, clean_u8, sigma, noise=None):
    """Reference noise model: clip(clean + N(0, sigma^2), 0, 255) cast to uint8.

    ``clean_u8``: (N, H, W, C) uint8.  ``sigma``: scalar or (N,) per-sample
    levels in [0, 255] units.  ``noise``: the standard-normal draws, in place
    of the generator's.  Returns uint8.
    """
    device = clean_u8.device
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=device)
    if sigma.ndim == 1:
        sigma = sigma.reshape(-1, 1, 1, 1)
    if noise is None:
        noise = torch.randn(clean_u8.shape, generator=generator, device=device)
    noisy = torch.clamp(clean_u8.float() + noise.to(device) * sigma, 0.0, 255.0)
    return noisy.to(torch.uint8)


# f32(1/255): XLA turns the JAX function's x / 255 into a multiply by it
_INV_255 = float(np.float32(1 / 255))


def normalize_u8(x_u8, dtype=torch.float32):
    """uint8 -> [-1, 1]: ToTensor (x/255) then Normalize(mean .5, std .5).

    Rounded as the compiled JAX function rounds it: x * f32(1/255) - 0.5
    fused into one rounding (exact in f64, then one cast), then * 2 (exact)."""
    return ((x_u8.double() * _INV_255 - 0.5).float() * 2).to(dtype)


def denormalize(x):
    """[-1, 1] -> [0, 1] (reference ``denormalize``, diffusion_RDUnet.py:67-68)."""
    return x * 0.5 + 0.5


def _rotation_map(angles_deg, h: int, w: int):
    """Source pixel (iy, ix) and in-image mask of each output pixel, per
    angle: the inverse map of a rotation about the centre, in f32 in the JAX
    function's order of operations, rounded half to even."""
    device = angles_deg.device
    theta = (-angles_deg.float() * math.pi / 180.0).reshape(-1, 1, 1)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=device).reshape(1, h, 1) - cy
    xx = torch.arange(w, dtype=torch.float32, device=device).reshape(1, 1, w) - cx
    cos, sin = torch.cos(theta), torch.sin(theta)
    src_y = cos * yy - sin * xx + cy
    src_x = sin * yy + cos * xx + cx
    iy = torch.round(src_y).long()
    ix = torch.round(src_x).long()
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    return iy.clamp(0, h - 1), ix.clamp(0, w - 1), valid


def _apply_map(img, iy, ix, valid):
    n = torch.arange(img.shape[0], device=img.device).reshape(-1, 1, 1)
    out = img[n, iy, ix]
    return torch.where(valid.unsqueeze(-1), out, torch.zeros((), dtype=out.dtype,
                                                             device=out.device))


def _rotate_nearest(img, angle_deg):
    """Rotate each (H, W, C) image of the (N, H, W, C) batch ``img`` by its
    angle in ``angle_deg`` (N,) (degrees, counter-clockwise like PIL) about
    the centre: nearest neighbour, zero fill.  The JAX function takes one
    image; this is its ``vmap``."""
    return _apply_map(img, *_rotation_map(angle_deg, img.shape[1], img.shape[2]))


def augment_pair(generator, a, b, max_rotation_deg=10.0, flips=None, angles=None):
    """Random horizontal flip (p = 0.5) and uniform rotation in
    ±max_rotation_deg, the same for both images of each (N, H, W, C) pair.
    ``flips`` (N,) bool and ``angles`` (N,) f32 replace the draws."""
    n, device = a.shape[0], a.device
    if flips is None:
        flips = torch.rand(n, generator=generator, device=device) < 0.5
    if angles is None:
        angles = torch.empty(n, device=device).uniform_(-max_rotation_deg, max_rotation_deg,
                                                        generator=generator)
    flips = torch.as_tensor(flips, device=device).reshape(-1, 1, 1, 1)
    rot = _rotation_map(torch.as_tensor(angles, device=device), a.shape[1], a.shape[2])

    def one(img):
        return _apply_map(torch.where(flips, img.flip(2), img), *rot)

    return one(a), one(b)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def degrade_and_normalize(generator, clean_u8, sigma, augment=False, noise=None, flips=None,
                          angles=None):
    """Synthetic-noise pipeline: noise -> (augment) -> normalize to [-1, 1].

    Returns (noisy, clean) f32 NCHW (channels_last memory), the reference's
    sample order (custom_dataset.py:97-100).  Draws noise, then flips and
    angles, from ``generator``.
    """
    noisy_u8 = add_gaussian_noise_u8(generator, clean_u8, sigma, noise=noise)
    if augment:
        noisy_u8, clean_u8 = augment_pair(generator, noisy_u8, clean_u8, flips=flips,
                                          angles=angles)
    return _nchw(normalize_u8(noisy_u8)), _nchw(normalize_u8(clean_u8))


def normalize_pair(generator, noisy_u8, clean_u8, augment=False, flips=None, angles=None):
    """Real-noise pipeline (SIDD pairs): (augment) -> normalize to [-1, 1], NCHW."""
    if augment:
        noisy_u8, clean_u8 = augment_pair(generator, noisy_u8, clean_u8, flips=flips,
                                          angles=angles)
    return _nchw(normalize_u8(noisy_u8)), _nchw(normalize_u8(clean_u8))


def rank_rows(n: int, mesh=None):
    """(lo, hi): this rank's rows of a batch of ``n`` split over ``mesh``'s
    data axis, the batch first cut to a multiple of the axis size (JAX's
    multi-process tail policy); (0, n) with one rank.  An empty range when
    the batch is smaller than the axis."""
    k = 1 if mesh is None else mesh.size("data")
    if k == 1:
        return 0, n
    per = n // k
    i = mesh.index("data")
    return i * per, (i + 1) * per


def transform_rows(transform, generator, local, lo: int, hi: int, n: int, aux=()):
    """``transform(generator, *batch, *aux)`` of a global batch of ``n`` rows
    of which this rank fetched rows ``lo:hi`` (``local``): the others are
    zeros, so every draw is made for the whole batch, as one rank makes it;
    returns this rank's rows of each output."""
    if (lo, hi) == (0, n):
        return transform(generator, *local, *aux)
    full = []
    for x in local:
        z = x.new_zeros((n,) + tuple(x.shape[1:]))
        z[lo:hi] = x
        full.append(z)
    out = transform(generator, *full, *aux)
    return tuple(y[lo:hi] for y in out) if isinstance(out, tuple) else out[lo:hi]
