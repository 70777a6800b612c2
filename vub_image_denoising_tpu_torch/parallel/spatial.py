"""Spatially partitioned training: each rank runs the model on a band of rows.

The rows of every image are split over the ranks (``parallel.mesh.shard_spatial``),
for images larger than one device's memory.  The JAX package has no module
for this: there the same jitted step runs on an H-sharded batch and XLA's
SPMD partitioner inserts every conv's halo exchange.  Here the exchanges are
written out: before each layer that reads its neighbours' rows,
``halo_exchange`` fetches them from the ranks above and below, the layer
runs on the extended band, and the rows that saw the extended band's edge
are cropped off again.

- Each 3x3 conv spoils one more row, inward from an edge whose neighbour
  rows are missing.  The input and output blocks (two convs) take 2 rows
  from each neighbour, a DenoisingBlock (four) 4, the up block's conv 1.
- A DenoisingBlock runs its own ``forward`` on the extended band, so on the
  card kernel 1 runs it exactly as on the main path.  The kernel zeroes the
  samples outside its input, as SAME padding does, so the image's own top
  and bottom edges (rank 0's top, the last rank's bottom) get no halo and
  no padding rows: zero rows there would give o0..o2 = PReLU(conv(0)) != 0.
- The k2 s2 down conv and the k2 s2 transposed up conv take no halo: the
  band edges fall on even rows at every scale (``spatial_band_rows``).
- The halos come from the neighbours only, so a band at the deepest scale
  must hold a DenoisingBlock's 4 rows; XLA's partitioner also fetches from
  ranks further away.
- The backward of an exchange sends the gradient of the halo rows back to
  the rank that owns them, which adds it into its edge rows.  With the
  bands equal, the mean of the ranks' gradients of their band losses is the
  gradient of the whole image's loss.
- ``RDUNetT``'s timestep plane is constant over an image, so its band is
  the band's own plane.  The diffusion loss's SSIM term is no per-pixel
  mean: ``band_combined_loss`` gives each rank its share of the whole
  image's loss from the windows centred in its band.
"""

import torch
import torch.distributed as dist

from ..diffusion.losses import combined_loss, ssim_map
from ..models.fused_apply import t_plane
from ..models.rdunet import RDUNet, RDUNetT
from .mesh import BLOCK_HALO, group_size, recv, send

IO_HALO = 2  # the input and output blocks: two 3x3 convs
UP_HALO = 1  # the up block's 3x3 conv
SSIM_WIN = 11  # diffusion/losses.py ssim's window


def _neighbours(group):
    """Global ranks of the ranks above and below this one in ``group``
    (None at the image's edges)."""
    n, i = group_size(group), dist.get_rank(group)
    glob = (lambda r: r) if group is None else (lambda r: dist.get_global_rank(group, r))
    return (glob(i - 1) if i > 0 else None), (glob(i + 1) if i < n - 1 else None), i


def _like(t, x):
    """``t`` in ``x``'s memory format (channels_last stays channels_last, so
    the concatenated band needs no layout copy before kernel 1)."""
    if x.dim() == 4 and x.shape[1] > 1 and x.stride(1) == 1:
        return t.contiguous(memory_format=torch.channels_last)
    return t


def _swap(to_up, to_down, from_up_rows, from_down_rows, x, group):
    """Send ``to_up`` to the rank above and ``to_down`` to the rank below;
    receive ``from_up_rows`` rows (shaped as ``x``'s rows) from above and
    ``from_down_rows`` from below.  Blocking sends and receives, ordered by
    the rank's parity so that two neighbours never both send first."""
    up, down, i = _neighbours(group)
    got = {}

    def with_down():
        if down is not None:
            send(to_down, down)
            got["down"] = _like(recv(x[:, :, :from_down_rows], down), x)

    def with_up():
        if up is not None:
            got["up"] = _like(recv(x[:, :, :from_up_rows], up), x)
            send(to_up, up)

    if i % 2 == 0:
        with_down()
        with_up()
    else:
        with_up()
        with_down()
    return got.get("up"), got.get("down")


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top, bottom, group):
        h = x.shape[2]
        # every rank asks alike: the rank above takes this band's first
        # ``bottom`` rows as its bottom halo, the rank below its last ``top``
        from_up, from_down = _swap(x[:, :, :bottom], x[:, :, h - top:], top, bottom, x, group)
        ctx.meta = (top, bottom, from_up is not None, h, group)
        return torch.cat([p for p in (from_up, x, from_down) if p is not None], 2)

    @staticmethod
    def backward(ctx, g):
        top, bottom, has_up, h, group = ctx.meta
        start = top if has_up else 0
        # the halo rows' gradient goes back to the rank that owns those rows
        from_up, from_down = _swap(g[:, :, :start], g[:, :, start + h:], bottom, top, g, group)
        dx = g[:, :, start:start + h].clone()
        if from_up is not None:
            dx[:, :, :bottom] += from_up
        if from_down is not None:
            dx[:, :, h - top:] += from_down
        return dx, None, None, None


def halo_exchange(x, top: int, bottom: int, group=None):
    """The band ``x`` (NCHW, rows on dim 2) with ``top`` rows of the rank
    above and ``bottom`` rows of the rank below concatenated around it;
    none at the image's edges (rank 0's top, the last rank's bottom).  Every
    rank of ``group`` calls it with the same ``top`` and ``bottom``.
    Differentiable: the halos' gradient is added into the owners' rows.  The
    identity with one rank."""
    if group_size(group) == 1:
        return x
    return _HaloExchange.apply(x, top, bottom, group)


def with_halo(fn, x, rows: int, group=None):
    """``fn`` on the band ``x`` extended by ``rows`` rows from each
    neighbour, the exchanged rows cropped off its output: the rows ``fn``
    would give on the whole image, where ``fn`` looks at most ``rows`` rows
    away."""
    if group_size(group) == 1:
        return fn(x)
    up, down, _ = _neighbours(group)
    y = fn(halo_exchange(x, rows, rows, group))
    return y[:, :, (rows if up is not None else 0):y.shape[2] - (rows if down is not None else 0)]


def band_trunk(core, x, group=None):
    """``core.trunk`` (``models/rdunet.py _RDUNetCore``) on this rank's band
    of rows, in the trunk's order and with the model's own modules (and
    ``remat``); returns the band of the trunk's output."""
    def pair(scale, first, h):
        for i in (first, first + 1):
            name = f"block_{scale}_{i}"
            h = with_halo(lambda z: core.run_block(name, z), h, BLOCK_HALO, group)
        return h

    def up(block, u, skip):
        u = block.actv_t(block.conv_t(u))
        return with_halo(lambda z: block.actv(block.conv(z)), torch.cat([skip, u], 1), UP_HALO,
                         group)

    out_0 = pair(0, 0, with_halo(core.input_block, x, IO_HALO, group))
    out_1 = pair(1, 0, core.down_0(out_0))
    out_2 = pair(2, 0, core.down_1(out_1))
    out_3 = pair(3, 0, core.down_2(out_2))
    out_4 = pair(2, 2, up(core.up_2, out_3, out_2))
    out_5 = pair(1, 2, up(core.up_1, out_4, out_1))
    out_6 = pair(0, 2, up(core.up_0, out_5, out_0))
    return with_halo(core.output_block, out_6, IO_HALO, group)


def band_forward(model, x, group=None, t=None):
    """``RDUNet``'s forward, or ``RDUNetT``'s at the normalized timestep ``t``
    (a scalar or an (N,) vector), on this rank's band ``x``
    (``shard_spatial``): the band of the whole image's output."""
    if isinstance(model, RDUNetT):
        return band_trunk(model, torch.cat([x, t_plane(t, x)], 1), group) + x
    if not isinstance(model, RDUNet):
        raise TypeError(f"the band forward takes an RDUNet or an RDUNetT, got "
                        f"{type(model).__name__}")
    return band_trunk(model, x, group) + x


def band_combined_loss(pred, target, group=None, mse_weight=0.0, charbonnier_weight=1.0,
                       ssim_weight=0.0, epsilon=1e-3):
    """This rank's share of ``combined_loss`` of the whole image, from its
    bands of ``pred`` and ``target``: the mean of the shares over the ranks
    of ``group`` is the whole image's loss, and of their gradients its
    gradient.  Charbonnier and MSE are per-pixel means, so an equal band's
    mean is its share.  SSIM averages a map of VALID windows: each band
    takes ``SSIM_WIN // 2`` rows of both images from each neighbour
    (``halo_exchange``, so the gradient of ``pred``'s halo goes back to its
    owner) and sums the map of the windows centred in its rows (the outer
    bands hold fewer), scaled to the whole map's mean.  With one rank,
    ``combined_loss``."""
    n = group_size(group)
    if n == 1 or not ssim_weight:
        return combined_loss(pred, target, mse_weight, charbonnier_weight, ssim_weight, epsilon)
    halo = SSIM_WIN // 2
    b, c, h, w = pred.shape
    windows = b * c * (h * n - 2 * halo) * (w - 2 * halo)
    band_map = ssim_map(halo_exchange(pred.float(), halo, halo, group),
                        halo_exchange(target.float(), halo, halo, group), data_range=1.0,
                        win_size=SSIM_WIN)
    return (combined_loss(pred, target, mse_weight, charbonnier_weight, 0.0, epsilon)
            + ssim_weight * (1.0 - n * band_map.sum() / windows))
