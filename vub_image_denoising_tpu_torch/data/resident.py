"""Device-resident dataset: draw training batches entirely in the card's memory.

Counterpart of ``vub_image_denoising_tpu/data/resident.py``.  A whole uint8
image bank lives on the device, and each step's batch is drawn, augmented,
degraded and normalized there; per step the host sends nothing
but the launches.

``DeviceBankLoader`` keeps the ``PatchLoader`` iteration contract and stream
convention: ``__len__`` is the steps per epoch; each epoch's stream is
``fold_generator(device, seed, split, epoch)`` and each step's
``fold_generator(device, seed, split, epoch, step)``; ``.epoch`` is mutable,
so a resumed run can set it.  In ``sequential`` mode with the same seed and
split it yields batches byte-identical to an unshuffled ``PatchLoader`` over
the same items.  JAX's ``key``/``sharding`` arguments are ``seed``/``split``
and ``device`` and ``mesh`` here: over several ranks each rank gathers only
its rows of every batch from the bank, and the transform's draws are made
for the whole batch (``data.device.transform_rows``), as ``PatchLoader``
does.  The bank holds whole patches: JAX's random-crop
``patch`` option is not ported.

Not for datasets that do not fit in the card's memory beside the train state.
"""

import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .device import fold_generator, rank_rows, transform_rows


class DeviceBankLoader:
    """Loader-compatible iterable over a device-resident uint8 image bank.

    Args:
      images_u8: ``(N, H, W, C)`` uint8 host array, copied to the device once.
      batch_size: samples per yielded batch.
      transform: ``(generator, clean_u8_batch, *aux) -> batch`` (e.g.
        ``device.degrade_and_normalize``).  Defaults to identity.
      mode: ``"sample"`` — indices drawn with replacement each step;
        ``"permute"`` — one permutation of the logical index space per epoch,
        batches are its slices (shuffle=True semantics); ``"sequential"`` —
        identity order (shuffle=False validation semantics; honours ``drop_last``).
      n_logical: size of the logical index space (defaults to N).  With
        ``index_map`` one stored patch backs many logical samples (the
        reference's patch x noise-level space, custom_dataset.py:62-69).
      index_map: ``(idx,) -> (bank_indices, aux_tuple)`` on the device, mapping
        logical indices to bank rows plus per-sample aux tensors forwarded to
        ``transform`` (e.g. sigma).  Default: identity, no aux.
      steps_per_epoch: batches per epoch (default the mode's natural length;
        in ``"sequential"`` mode, when given, it replaces that length).
      drop_last: sequential mode only — keep (False) or drop the short tail.
      device: where the bank lives (default the card).
      seed, split: the stream, as ``PatchLoader``'s.
      mesh: the ``parallel.mesh.Mesh`` whose data axis splits each batch.
    """

    def __init__(
        self,
        images_u8: np.ndarray,
        batch_size: int,
        transform: Optional[Callable] = None,
        mode: str = "sample",
        n_logical: Optional[int] = None,
        index_map: Optional[Callable] = None,
        steps_per_epoch: Optional[int] = None,
        drop_last: bool = False,
        device=None,
        seed: int = 0,
        split: int = 0,
        mesh=None,
    ):
        self.mesh = mesh
        images_u8 = np.asarray(images_u8)
        if images_u8.dtype != np.uint8 or images_u8.ndim != 4:
            raise ValueError(
                f"bank must be (N,H,W,C) uint8, got {images_u8.dtype} {images_u8.shape}"
            )
        if mode not in ("sample", "permute", "sequential"):
            raise ValueError(f"unknown mode '{mode}'")
        self.batch_size = int(batch_size)
        self.mode = mode
        self.epoch = 0
        self.stream = (seed, split)
        self.device = resolve_device(device)
        self.n_logical = int(n_logical if n_logical is not None else len(images_u8))
        self.bank = torch.from_numpy(np.ascontiguousarray(images_u8)).to(self.device)
        self.transform = transform if transform is not None else (lambda g, x: x)
        self.index_map = index_map if index_map is not None else (lambda i: (i, ()))

        if mode == "sequential":
            full, tail = divmod(self.n_logical, self.batch_size)
            self._steps = full + (1 if tail and not drop_last else 0)
        else:
            if mode == "permute" and self.batch_size > self.n_logical:
                # PatchLoader's short-batch policy: one short batch, not a crash
                warnings.warn(
                    f"batch_size {self.batch_size} exceeds the {self.n_logical}-item "
                    f"logical space; yielding one short batch of {self.n_logical} per epoch",
                    stacklevel=3,
                )
                self.batch_size = self.n_logical
            self._steps = int(steps_per_epoch or max(1, self.n_logical // self.batch_size))
            if mode == "permute" and self._steps * self.batch_size > self.n_logical:
                raise ValueError(f"permute mode: {self._steps} steps x {self.batch_size} "
                                 f"exceeds the {self.n_logical}-item logical space")
        if steps_per_epoch is not None and mode == "sequential":
            self._steps = int(steps_per_epoch)

    def __len__(self):
        return self._steps

    def _gather(self, g, idx):
        bank_idx, aux = self.index_map(idx)
        lo, hi = rank_rows(len(idx), self.mesh)
        return transform_rows(self.transform, g, (self.bank[bank_idx[lo:hi]],), lo, hi,
                              len(idx), aux)

    def __iter__(self):
        epoch = self.epoch
        self.epoch += 1
        perm = None
        if self.mode == "permute":
            perm = torch.randperm(self.n_logical, device=self.device,
                                  generator=fold_generator(self.device, self.stream, epoch))
        for step in range(self._steps):
            g = fold_generator(self.device, self.stream, epoch, step)
            if self.mode == "sample":
                idx = torch.randint(0, self.n_logical, (self.batch_size,), generator=g,
                                    device=self.device)
            elif self.mode == "permute":
                idx = perm[step * self.batch_size : (step + 1) * self.batch_size]
            else:
                start = step * self.batch_size
                stop = min(start + self.batch_size, self.n_logical)
                idx = torch.arange(start, stop, device=self.device)
            if len(idx) >= (1 if self.mesh is None else self.mesh.size("data")):
                yield self._gather(g, idx)


def bank_loader_from_patches(
    ds,
    batch_size: int,
    transform: Callable,
    mode: str = "permute",
    device=None,
    seed: int = 0,
    split: int = 0,
    drop_last: bool = False,
    verbose: bool = True,
    mesh=None,
):
    """Build a :class:`DeviceBankLoader` from a ``FolderPatchDataset`` (or a
    ``Subset`` chain over one, as ``load_data``'s splits give).

    The logical index space is (patch x noise level) (custom_dataset.py:62-69:
    ``idx % len(levels)`` picks sigma).  The bank keeps each UNIQUE patch
    once, and a device ``index_map`` carries logical index -> (bank row,
    sigma).  ``transform`` receives ``(generator, clean_u8, sigma)``, the
    signature ``load_data`` gives its host loaders.
    """
    from .loader import Subset

    device = resolve_device(device)
    li = np.arange(len(ds), dtype=np.int64)
    base = ds
    while isinstance(base, Subset):
        li = np.asarray(base.indices, np.int64)[li]
        base = base.dataset
    n_levels = len(base.noise_levels)
    levels = np.asarray(base.noise_levels, np.float32)
    patch_idx = li // n_levels
    uniq, inv = np.unique(patch_idx, return_inverse=True)
    clean, _ = base.gather_batch(uniq * n_levels)  # sigma of level 0, unused
    if verbose:
        print(f"device bank: {len(uniq)} unique patches ({clean.nbytes / 1e6:.0f} MB uint8 "
              f"on {device}) backing {len(li)} logical samples", flush=True)
    inv_dev = torch.from_numpy(inv.astype(np.int64)).to(device)
    sig_dev = torch.from_numpy(levels[li % n_levels]).to(device)

    def index_map(idx):
        return inv_dev[idx], (sig_dev[idx],)

    return DeviceBankLoader(
        clean, batch_size, transform=transform, mode=mode, n_logical=len(li),
        index_map=index_map, device=device, seed=seed, split=split, drop_last=drop_last,
        mesh=mesh,
    )
