"""Native two-stage grayscale BM3D baseline (host-side numpy).  A copy of
``vub_image_denoising_tpu/ops/bm3d.py``, so the port imports nothing of the
JAX package; the same inputs give the same array bit for bit.

The reference's comparative suite runs ``bm3d.bm3d(img01, sigma_psd=30/255,
stage_arg=bm3d.BM3DStages.ALL_STAGES)`` as its classical baseline
(evaluate_Unet_diffusion/evaluate_model.py:164-218) via the optional ``bm3d``
pip package.  This module implements the algorithm itself (Dabov et al. 2007,
"Image denoising by sparse 3-D transform-domain collaborative filtering") with
the pip package's call surface (``bm3d(z, sigma_psd, stage_arg)`` +
``BM3DStages``), so ``eval/compare.py`` can use either.

Two stages, both on 8x8 blocks with orthonormal 2-D DCT + 1-D Hadamard along
the similarity stack:

1. **Hard-thresholding**: for each reference block on a coarse grid, the N2=16
   most similar blocks in a local search window are stacked, the 3-D spectrum
   hard-thresholded at ``lambda3d * sigma``, and the inverse-transformed block
   estimates aggregated with weights 1/(sigma^2 * nnz) under a Kaiser window.
2. **Wiener**: block matching re-run on the basic estimate; the basic
   estimate's 3-D spectrum defines per-coefficient Wiener shrinkage applied to
   the *noisy* group's spectrum, aggregated with weights 1/(sigma^2 * ||W||^2).

Simplifications against the full algorithm (a baseline, not the paper
artifact): every group uses exactly N2 nearest blocks (no tau-match cut),
matching distance is plain spatial SSD, and both stages share the 8x8/DCT
transform pair.

Host code by design: block matching is irregular gather/scatter, the
reference runs it on the CPU too (the pip package is C/OpenMP), and it sits
outside every training and inference hot path.
"""

import numpy as np

__all__ = ["bm3d", "BM3DStages"]


class BM3DStages:
    """Stage selector, API-compatible with the pip package's enum."""

    HARD_THRESHOLDING = "hard_thresholding"
    ALL_STAGES = "all_stages"


def _dct_mat(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (rows are basis vectors)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    m[0] /= np.sqrt(2.0)
    return m


def _hadamard(n: int) -> np.ndarray:
    """Orthonormal Hadamard matrix (n must be a power of two)."""
    h = np.ones((1, 1))
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h / np.sqrt(n)


def _ref_grid(n: int, bs: int, step: int) -> np.ndarray:
    g = list(range(0, n - bs + 1, step))
    if g[-1] != n - bs:
        g.append(n - bs)
    return np.asarray(g, np.int64)


def _match_topk(blocks, ref_i, ref_j, search: int, k: int):
    """Top-k most-similar block positions for every reference position.

    blocks: (Hb, Wb, bs, bs) sliding-window view.  Returns (idx_i, idx_j) of
    shape (nr, nc, k).  Vectorized over the whole reference grid per offset;
    out-of-bounds candidates are clipped to the edge (a clipped duplicate of an
    in-bounds block merely repeats a candidate, which the top-k then ranks).
    """
    hb, wb = blocks.shape[:2]
    bref = blocks[ref_i[:, None], ref_j[None, :]]  # (nr, nc, bs, bs)
    offs = [
        (dy, dx)
        for dy in range(-search, search + 1)
        for dx in range(-search, search + 1)
    ]
    nr, nc = len(ref_i), len(ref_j)
    dists = np.empty((nr, nc, len(offs)), np.float32)
    cand_i = np.empty((nr, len(offs)), np.int64)
    cand_j = np.empty((nc, len(offs)), np.int64)
    for o, (dy, dx) in enumerate(offs):
        ci = np.clip(ref_i + dy, 0, hb - 1)
        cj = np.clip(ref_j + dx, 0, wb - 1)
        cand_i[:, o], cand_j[:, o] = ci, cj
        diff = bref - blocks[ci[:, None], cj[None, :]]
        dists[:, :, o] = np.einsum("rcxy,rcxy->rc", diff, diff)
    top = np.argpartition(dists, k - 1, axis=2)[:, :, :k]  # (nr, nc, k)
    idx_i = np.take_along_axis(
        np.broadcast_to(cand_i[:, None, :], dists.shape), top, axis=2
    )
    idx_j = np.take_along_axis(
        np.broadcast_to(cand_j[None, :, :], dists.shape), top, axis=2
    )
    return idx_i, idx_j


def _aggregate(num, den, est_groups, weights, idx_i, idx_j, kaiser, w_img):
    """Scatter-add weighted block estimates into the numerator/denominator."""
    bs = est_groups.shape[-1]
    nr, nc, k = idx_i.shape
    # flat pixel index of every (block, in-block-pixel) pair
    byx = (np.arange(bs)[:, None] * w_img + np.arange(bs)[None, :]).ravel()  # (bs*bs,)
    base = (idx_i * w_img + idx_j).reshape(-1)  # (nr*nc*k,)
    flat_idx = (base[:, None] + byx[None, :]).ravel()
    wk = (weights[:, :, None] * np.ones((1, 1, k), np.float32)).reshape(-1, 1)
    contrib = (est_groups.reshape(-1, bs * bs) * kaiser.ravel()[None, :]) * wk
    np.add.at(num, flat_idx, contrib.ravel())
    np.add.at(den, flat_idx, (wk * kaiser.ravel()[None, :]).ravel())


def _stage(z, sigma, basic=None, bs=8, step=4, search=10, k=16, lambda3d=2.7):
    """One BM3D stage.  ``basic=None`` -> hard-thresholding; else Wiener."""
    from numpy.lib.stride_tricks import sliding_window_view

    h, w = z.shape
    match_src = z if basic is None else basic
    blocks_match = sliding_window_view(match_src, (bs, bs))
    blocks_noisy = sliding_window_view(z, (bs, bs))

    ref_i = _ref_grid(h, bs, step)
    ref_j = _ref_grid(w, bs, step)
    idx_i, idx_j = _match_topk(blocks_match, ref_i, ref_j, search, k)

    d2 = _dct_mat(bs).astype(np.float32)
    hd = _hadamard(k).astype(np.float32)

    def spectrum(blocks):
        g = blocks[idx_i, idx_j].astype(np.float32)  # (nr, nc, k, bs, bs)
        g = np.einsum("ab,rckbx->rckax", d2, g)
        g = np.einsum("xy,rckay->rckax", d2, g)  # 2-D DCT per block
        return np.einsum("lk,rckax->rclax", hd, g)  # 1-D Hadamard along stack

    spec_noisy = spectrum(blocks_noisy)
    if basic is None:
        thr = lambda3d * sigma
        mask = np.abs(spec_noisy) > thr
        spec_est = spec_noisy * mask
        nnz = np.maximum(mask.reshape(*mask.shape[:2], -1).sum(axis=2), 1)
        weights = (1.0 / (sigma * sigma * nnz)).astype(np.float32)
    else:
        spec_basic = spectrum(sliding_window_view(basic, (bs, bs)))
        wien = spec_basic**2 / (spec_basic**2 + sigma * sigma)
        spec_est = spec_noisy * wien
        wsum = np.maximum((wien**2).reshape(*wien.shape[:2], -1).sum(axis=2), 1e-8)
        weights = (1.0 / (sigma * sigma * wsum)).astype(np.float32)

    est = np.einsum("lk,rclax->rckax", hd.T, spec_est)
    est = np.einsum("ab,rckbx->rckax", d2.T, est)
    est = np.einsum("xy,rckay->rckax", d2.T, est)  # back to pixel domain

    kaiser = np.outer(np.kaiser(bs, 2.0), np.kaiser(bs, 2.0)).astype(np.float32)
    num = np.zeros(h * w, np.float32)
    den = np.zeros(h * w, np.float32)
    _aggregate(num, den, est, weights, idx_i, idx_j, kaiser, w)
    return (num / np.maximum(den, 1e-12)).reshape(h, w)


def bm3d(z, sigma_psd, stage_arg=BM3DStages.ALL_STAGES, **kwargs):
    """Denoise a grayscale image in [0, 1] with two-stage BM3D.

    Drop-in for the pip package's call shape used by the reference
    (evaluate_model.py:194): ``bm3d(img, sigma_psd=30/255, stage_arg=ALL_STAGES)``.
    ``sigma_psd`` is the noise standard deviation on the image's scale.
    """
    z = np.asarray(z, np.float32)
    if z.ndim != 2:
        raise ValueError(f"native bm3d handles grayscale 2-D images, got {z.shape}")
    if min(z.shape) < 16:
        raise ValueError(f"image {z.shape} too small for 8x8 block matching")
    sigma = float(sigma_psd)
    # stage parameters follow Dabov et al. 2007 (normal profile): HT matches
    # N2=16 blocks, Wiener N2=32, both on a step-3 reference grid
    basic = _stage(z, sigma, basic=None, step=3, k=16)
    if stage_arg in (BM3DStages.HARD_THRESHOLDING, "hard_thresholding"):
        return basic
    return _stage(z, sigma, basic=basic, step=3, k=32)
