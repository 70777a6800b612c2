"""Host -> card data loading: threaded patch fetch, pinned copy, on-card transform.

Counterpart of ``vub_image_denoising_tpu/data/loader.py``.  A thread pool
fetches uint8 batches (PIL decode releases the GIL; the native gather copies
the patches), each batch is pinned and copied to the card with
``non_blocking=True``, and its transform (noise, augment, normalize;
data/device.py) is queued there, while the card computes the step before it.

``load_data`` / ``load_sidd_data`` mirror the reference loader APIs
(data_loader.py:7-79, SIDD_dataset.py:99-168): validation_split,
dataset_percentage, only_validation, augment, per-split noise-level lists,
use_rgb.  The splits and the per-epoch shuffle use numpy's ``RandomState``,
as the JAX package does, so they are its splits and orders index for index.

In place of JAX's ``key``, the transforms' random stream comes from
``seed`` and the loader's ``split`` (0 train, 1 validation; JAX's
``random.split(key)``): each batch's generator is
``fold_generator(device, (seed, split), epoch, step)``.  In place of
``sharding``, ``device`` (the card unless ``device="cpu"``) and ``mesh``
(``parallel.mesh``): a loader feeds its rank's device.  Over several ranks
each rank fetches only its rows of every global batch
(``data.device.rank_rows``, as JAX's ``local_batch_rows`` path) and runs the
transform's draws for the whole batch (``transform_rows``), so its rows are
those one rank would give.
"""

import collections
import concurrent.futures
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from .device import (degrade_and_normalize, fold_generator, normalize_pair, rank_rows,
                     transform_rows)


class Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices)

    @property
    def channels(self):
        return self.dataset.channels

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[int(self.indices[idx])]

    def __getattr__(self, name):
        # expose gather_batch only when the base dataset has one, so the loader's
        # hasattr capability check stays honest through nested Subsets
        if name == "gather_batch":
            base = getattr(self.dataset, "gather_batch")

            def gather(indices):
                return base(self.indices[np.asarray(indices, np.int64)])

            return gather
        raise AttributeError(name)


def random_split(dataset, sizes: Sequence[int], seed: int = 0):
    """Shuffle-split a dataset into Subsets (torch.utils.data.random_split analog)."""
    assert sum(sizes) == len(dataset)
    perm = np.random.RandomState(seed).permutation(len(dataset))
    out, start = [], 0
    for s in sizes:
        out.append(Subset(dataset, perm[start : start + s]))
        start += s
    return out


def _collate(items):
    """Stack a list of per-sample tuples into a tuple of batched numpy arrays."""
    ncols = len(items[0])
    cols = []
    for c in range(ncols):
        col = [it[c] for it in items]
        if np.isscalar(col[0]) or np.ndim(col[0]) == 0:
            cols.append(np.asarray(col, np.float32))
        else:
            cols.append(np.stack(col))
    return tuple(cols)


class PatchLoader:
    """Iterable over batches on the device.

    Args:
      dataset: indexable with __len__, items are tuples of arrays/scalars.
      batch_size: samples per batch.
      shuffle: reshuffle each epoch with ``RandomState(seed + epoch)``.
      transform: optional ``(generator, *device_batch) -> batch`` run on the
        device (noise injection / augmentation / normalization), with the
        generator ``fold_generator(device, (seed, split), epoch, step)``.
      device: where batches go (default the card).
      num_workers: fetch threads.  prefetch: batches queued on the device.
      drop_last: drop the trailing partial batch.
      seed: the shuffle's and the transforms' seed.
      split: which of the seed's transform streams (0 train, 1 validation).
      mesh: the ``parallel.mesh.Mesh`` whose data axis splits each batch
        (this rank's rows only; a tail batch smaller than the axis is
        skipped); None: one rank.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        transform: Optional[Callable] = None,
        device=None,
        num_workers: int = 8,
        prefetch: int = 2,
        drop_last: bool = True,
        seed: int = 0,
        split: int = 0,
        mesh=None,
    ):
        self.dataset = dataset
        self.mesh = mesh
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.transform = transform
        self.device = resolve_device(device)
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self.seed = seed
        self.stream = (seed, split)
        self.epoch = 0

    def __len__(self):
        """Number of batches __iter__ yields."""
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        for b in range(len(self)):
            yield idx[b * self.batch_size : (b + 1) * self.batch_size]

    def __iter__(self) -> Iterator[Any]:
        epoch = self.epoch
        self.epoch += 1
        gather = getattr(self.dataset, "gather_batch", None)
        pin = self.device.type == "cuda"

        def fetch(batch_idx):
            lo, hi = rank_rows(len(batch_idx), self.mesh)
            batch_idx = batch_idx[lo:hi]
            if gather is not None:
                # batched path: decode cache + native patch gather (one C call)
                host = tuple(gather(batch_idx))
            else:
                host = _collate([self.dataset[int(i)] for i in batch_idx])
            host = tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in host)
            # pinned here, in the worker; the caching host allocator keeps each
            # pinned block alive until the copy that reads it has finished
            return tuple(x.pin_memory() for x in host) if pin else host

        def to_device(host, step, n):
            batch = tuple(x.to(self.device, non_blocking=True) for x in host)
            if self.transform is not None:
                batch = transform_rows(self.transform,
                                       fold_generator(self.device, self.stream, epoch, step),
                                       batch, *rank_rows(n, self.mesh), n)
            return batch

        ranks = 1 if self.mesh is None else self.mesh.size("data")
        work = [idx for idx in self._batch_indices() if len(idx) >= ranks]
        if not work:
            return
        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
            pending = collections.deque(enumerate(work))
            futures = collections.deque()

            def submit_next():
                if pending:
                    step, idx = pending.popleft()
                    futures.append((step, len(idx), pool.submit(fetch, idx)))

            # keep `prefetch` host fetches + device transfers in flight
            for _ in range(self.prefetch + 1):
                submit_next()
            device_queue = collections.deque()
            while futures or device_queue:
                while futures and len(device_queue) <= self.prefetch:
                    step, n, fut = futures.popleft()
                    device_queue.append(to_device(fut.result(), step, n))
                    submit_next()
                yield device_queue.popleft()


def _split_subsets(dataset, validation_split, dataset_percentage, seed):
    """The canonical percentage + train/val split (seeded identically for the
    host PatchLoader and the device-bank paths)."""
    total = len(dataset)
    subset_size = int(total * dataset_percentage)
    if subset_size < total:
        dataset, _ = random_split(dataset, [subset_size, total - subset_size], seed=seed)
    train_size = int((1 - validation_split) * len(dataset))
    val_size = len(dataset) - train_size
    return random_split(dataset, [train_size, val_size], seed=seed + 1)


def _split_loaders(dataset, batch_size, validation_split, dataset_percentage, num_workers,
                   train_transform, val_transform, device, seed, mesh=None):
    train_ds, val_ds = _split_subsets(dataset, validation_split, dataset_percentage, seed)
    train_loader = PatchLoader(
        train_ds, batch_size, shuffle=True, transform=train_transform,
        device=device, num_workers=num_workers, seed=seed, split=0, mesh=mesh,
    )
    # validation keeps the tail batch: drop_last would yield ZERO val batches for
    # small splits (val_size < batch_size)
    val_loader = PatchLoader(
        val_ds, batch_size, shuffle=False, transform=val_transform,
        device=device, num_workers=num_workers, seed=seed, split=1, drop_last=False, mesh=mesh,
    )
    return train_loader, val_loader


def load_data(
    image_folder: str,
    batch_size: int = 4,
    num_workers: int = 4,
    validation_split: float = 0.2,
    augment: bool = False,
    dataset_percentage: float = 1.0,
    only_validation: bool = False,
    include_noise_level: bool = False,
    train_noise_levels=None,
    val_noise_levels=None,
    use_rgb: bool = False,
    device=None,
    seed: int = 0,
    device_data: bool = False,
    mesh=None,
):
    """Synthetic Gaussian-noise loaders over an image folder.

    API parity with dataset_creation/data_loader.py:7-79.  Yields device
    batches (noisy, clean) in [-1, 1], NCHW, or (noisy, clean, sigma) with
    include_noise_level.

    ``device_data=True`` swaps the host PatchLoaders for ``DeviceBankLoader``s
    (data/resident.py): the deduped uint8 patch bank is copied to the device
    once, and batches are drawn, degraded and normalized there.  Same splits
    and streams as the host path; the train shuffle differs (a permutation
    drawn on the device in place of numpy's).
    """
    from .datasets import FolderPatchDataset

    def make_transform(do_augment):
        def tf(g, clean_u8, sigma):
            noisy, clean = degrade_and_normalize(g, clean_u8, sigma, augment=do_augment)
            if include_noise_level:
                return noisy, clean, sigma
            return noisy, clean

        return tf

    if only_validation:
        ds = FolderPatchDataset(image_folder, noise_levels=val_noise_levels, use_rgb=use_rgb)
        if device_data:
            from .resident import bank_loader_from_patches

            return None, bank_loader_from_patches(
                ds, batch_size, make_transform(augment), mode="sequential",
                device=device, seed=seed, mesh=mesh,
            )
        loader = PatchLoader(
            ds, batch_size, shuffle=False, transform=make_transform(augment),
            device=device, num_workers=num_workers, seed=seed, mesh=mesh,
        )
        return None, loader

    train_ds = FolderPatchDataset(image_folder, noise_levels=train_noise_levels, use_rgb=use_rgb)
    if device_data:
        from .resident import bank_loader_from_patches

        tr, va = _split_subsets(train_ds, validation_split, dataset_percentage, seed)
        train_loader = bank_loader_from_patches(
            tr, batch_size, make_transform(augment), mode="permute",
            device=device, seed=seed, split=0, mesh=mesh,
        )
        val_loader = bank_loader_from_patches(
            va, batch_size, make_transform(False), mode="sequential",
            device=device, seed=seed, split=1, drop_last=False, mesh=mesh,
        )
        return train_loader, val_loader
    return _split_loaders(
        train_ds, batch_size, validation_split, dataset_percentage, num_workers,
        make_transform(augment), make_transform(False), device, seed, mesh,
    )


def plot_examples(data_loader, num_examples: int = 4, path: str = "examples.png"):
    """Plot degraded/GT pairs from a loader (data_loader.py:81-126 /
    SIDD_dataset.py:178-232) to ``path`` on matplotlib's headless backend,
    imported here.  Batches hold NCHW images in [-1, 1] on any device."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(num_examples, 2, figsize=(10, 5 * num_examples), squeeze=False)
    count = 0
    for batch in data_loader:
        degraded, gt = batch[0], batch[1]
        for i in range(degraded.shape[0]):
            if count >= num_examples:
                break
            for j, (img, title) in enumerate([(degraded[i], "Degraded Image"),
                                              (gt[i], "Ground Truth Image")]):
                chw = torch.as_tensor(img).float().cpu().numpy()
                arr = np.clip(np.transpose(chw, (1, 2, 0)).squeeze() * 0.5 + 0.5, 0, 1)
                axs[count, j].imshow(arr, cmap="gray" if arr.ndim == 2 else None)
                axs[count, j].set_title(title)
                axs[count, j].axis("off")
            count += 1
        if count >= num_examples:
            break
    plt.tight_layout()
    plt.savefig(path)
    plt.close(fig)
    return path


def load_sidd_data(
    root_folder: str,
    batch_size: int = 4,
    num_workers: int = 2,
    validation_split: float = 0.2,
    augment: bool = False,
    dataset_percentage: float = 1.0,
    only_validation: bool = False,
    use_rgb: bool = False,
    device=None,
    seed: int = 0,
    mesh=None,
):
    """Real-noise SIDD pair loaders.  API parity with SIDD_dataset.py:99-168."""
    from .datasets import SIDDPatchDataset

    def make_transform(do_augment):
        def tf(g, noisy_u8, clean_u8):
            return normalize_pair(g, noisy_u8, clean_u8, augment=do_augment)

        return tf

    ds = SIDDPatchDataset(root_folder, use_rgb=use_rgb)
    if only_validation:
        loader = PatchLoader(
            ds, batch_size, shuffle=False, transform=make_transform(augment),
            device=device, num_workers=num_workers, seed=seed, mesh=mesh,
        )
        return None, loader
    return _split_loaders(
        ds, batch_size, validation_split, dataset_percentage, num_workers,
        make_transform(augment), make_transform(False), device, seed, mesh,
    )
