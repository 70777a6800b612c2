"""Space-to-depth (2x2) packing.  Counterpart of ``vub_image_denoising_tpu/ops/packing.py``.

The JAX package packs 2x2 sub-pixels into channels so that the narrow
RDUNet scales fill the TPU's 128-lane matrix unit; a 3x3 SAME conv then
becomes a 2x2-tap conv over 4x wider channels (16/9 of the FLOPs).  The
port keeps the layout as the input and output contract of the packed block
(``ops/fused_block.py``) and as the weight format it is given.

Tensors are NCHW-logical, as everywhere in PyTorch:

- EVEN packing: packed pixel (I, J) holds originals (2I+a, 2J+b), a, b in
  {0, 1}; packed channel index (a*2 + b)*C + k.
- SHIFTED packing: packed pixel (I, J) holds originals (2I-1+a, 2J-1+b).
  A 3x3 SAME conv maps a shifted input to an even output with 2x2 packed
  taps: out[I, J] = sum_{u,v} shifted[I+u, J+v] @ W2[u*2+v].

``pack2x2``/``unpack2x2`` return channels_last memory (one copy each).  The
weight packing is one gather from the OIHW weight (index cached per shape),
so it is differentiable and runs on the weight's device.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

_SUB_PIXELS = ((0, 0), (0, 1), (1, 0), (1, 1))


def pack2x2(x):
    """(n, C, H, W) -> even-packed (n, 4C, H/2, W/2), channel (a*2+b)*C + k."""
    n, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"pack2x2 needs even H and W, got {h}x{w}")
    q = x.permute(0, 2, 3, 1).reshape(n, h // 2, 2, w // 2, 2, c)
    q = q.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)
    return q.permute(0, 3, 1, 2)


def unpack2x2(xq):
    """Inverse of ``pack2x2``: (n, 4C, Hq, Wq) -> (n, C, 2Hq, 2Wq)."""
    n, c4, hq, wq = xq.shape
    c = c4 // 4
    q = xq.permute(0, 2, 3, 1).reshape(n, hq, wq, 2, 2, c)
    q = q.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * hq, 2 * wq, c)
    return q.permute(0, 3, 1, 2)


def reshift2d(x, c, order="asc"):
    """Even-packed -> shifted-packed, same size (rows/cols above the image are
    zero).  ``c`` is the per-sub-pixel channel count.  'asc': channel block s
    holds shifted sub-pixel s, sourced from even sub-pixel 3-s of the packed
    pixel up/left of it; 'desc' reverses the four blocks (the fused kernel's
    order: block g holds shifted sub-pixel 3-g = even sub-pixel g)."""
    h, w = x.shape[2], x.shape[3]

    def sh(part, dr, dc):
        return F.pad(part, (dc, 0, dr, 0))[:, :, :h, :w]

    g = [x[:, i * c:(i + 1) * c] for i in range(4)]
    blocks = [sh(g[3], 1, 1), sh(g[2], 1, 0), sh(g[1], 0, 1), g[0]]
    if order == "desc":
        blocks = blocks[::-1]
    elif order != "asc":
        raise ValueError(f"shifted order {order!r} (want 'asc' or 'desc')")
    return torch.cat(blocks, 1)


@functools.lru_cache(maxsize=64)
def _pack_index(n_out, k_total, in_segments, shifted_order, device):
    """Flat index into an OIHW (n_out, k_total, 3, 3) weight for every entry of
    its packed taps (4, 4K, 4N); ``numel`` marks a structural zero."""
    zero = n_out * k_total * 9
    idx = np.full((4, 4 * k_total, 4 * n_out), zero, np.int64)
    order = _SUB_PIXELS[::-1] if shifted_order == "desc" else _SUB_PIXELS
    n = np.arange(n_out)[None, :]
    for t, (u, v) in enumerate(_SUB_PIXELS):
        row, seg_start = 0, 0
        for seg in in_segments:
            k = seg_start + np.arange(seg)[:, None]
            for s_pos, (abar, bbar) in enumerate(order):
                rows = row + s_pos * seg + np.arange(seg)[:, None]
                for a, b in _SUB_PIXELS:
                    dy, dx = 2 * u - 1 + abar - a, 2 * v - 1 + bbar - b
                    if -1 <= dy <= 1 and -1 <= dx <= 1:
                        cols = (a * 2 + b) * n_out + n
                        idx[t, rows, cols] = ((n * k_total + k) * 3 + dy + 1) * 3 + dx + 1
            row += 4 * seg
            seg_start += seg
    return torch.from_numpy(idx).to(device)


def pack_conv3x3_weights(w, in_segments=None, shifted_order="asc"):
    """OIHW (N, K, 3, 3) -> packed taps (4, 4K, 4N) for the shifted->even 2x2 conv.

    ``in_segments``: channel sizes of the parts of a channel-concatenated
    input, each part packed separately (the dense block's [x, o0, o1, o2]):
    packed input index = 4*sum(earlier segments) + (abar*2+bbar)*seg + k.
    ``shifted_order``: 'asc' (``reshift2d``'s order) or 'desc' (the fused
    kernel's).  Tap t = u*2+v; output index (a*2+b)*N + n.
    W2[t][(abar,bbar,k), (a,b,n)] = w[n, k, dy+1, dx+1], dy = 2u-1+abar-a,
    dx = 2v-1+bbar-b, zero outside [-1, 1]."""
    n_out, k_total = w.shape[0], w.shape[1]
    segs = tuple(in_segments) if in_segments is not None else (k_total,)
    if sum(segs) != k_total:
        raise ValueError(f"in_segments {segs} do not sum to the weight's {k_total} inputs")
    if shifted_order not in ("asc", "desc"):
        raise ValueError(f"shifted order {shifted_order!r} (want 'asc' or 'desc')")
    idx = _pack_index(n_out, k_total, segs, shifted_order, w.device)
    return torch.cat([w.reshape(-1), w.new_zeros(1)])[idx]


def pack_vec(v):
    """Per-channel vector (N,) -> packed (4N,), (a, b, n)-major."""
    return v.repeat(4)


def packed_taps_conv(xs, w2):
    """out[I, J] = sum_{u,v} xs[I+u, J+v] @ w2[u*2+v]: the 2x2 VALID conv of a
    shifted-packed ``xs`` (n, 4K, Hq+1, Wq+1) with packed taps (4, 4K, 4N),
    as given (no casts)."""
    return F.conv2d(xs, w2.reshape(2, 2, w2.shape[1], w2.shape[2]).permute(3, 2, 0, 1))


def conv3x3_packed(x_even, w, bias=None):
    """Packed 3x3 SAME conv: even-packed input -> even-packed output.

    Counterpart of ``conv3x3_packed_xla``; equal to unpack -> conv -> pack.
    Weights are cast to x's dtype, the sum is f32, the result is cast back."""
    c = x_even.shape[1] // 4
    # the shifted grid needs one more row and column: shifted pixel Hq holds
    # original rows {2Hq-1, 2Hq}, and the image's last row lives only there
    xs = reshift2d(F.pad(x_even, (0, 1, 0, 1)), c)
    w2 = pack_conv3x3_weights(w).to(x_even.dtype).float()
    out = packed_taps_conv(xs.float(), w2)
    if bias is not None:
        out = out + pack_vec(bias).float().view(1, -1, 1, 1)
    return out.to(x_even.dtype)
