"""Patch datasets: host-side indexing + uint8 patch IO.

Counterpart of ``vub_image_denoising_tpu/data/datasets.py``: numpy and PIL
only, no device, the same code.  The host decodes images and crops uint8
patches; Gaussian-noise injection, augmentation and normalization run on the
card (data/device.py).

- ``FolderPatchDataset``  — reference ``CustomDataset``
  (dataset_creation/custom_dataset.py:10-100): scan a folder for png/jpg/jpeg, index all
  non-overlapping 256x256 patches fully inside each image; sample = (patch, sigma) with
  dataset length = n_patches * n_noise_levels, noise index = idx % n_levels, patch
  index = idx // n_levels.
- ``SIDDPatchDataset``    — reference ``CustomSIDD_Dataset``
  (dataset_creation/SIDD_dataset.py:10-97): read Scene_Instances.txt, pair *NOISY*/*GT*
  files per scene dir, index 256x256 patch pairs.
- ``PairedFolderDataset`` — same-named pairs from a GT and a degraded folder.
- ``ArrayPatchDataset``   — in-memory pairs (tests and synthetic runs).
"""

import collections
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

PATCH_SIZE = 256
# dotted: bare suffixes would match any name merely ENDING in "png"
IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg")


class DecodeCache:
    """Thread-safe byte-budgeted LRU of decoded images.

    The patch index maps every sample back to its source image, so without a
    cache each image is re-decoded once *per patch per epoch* (the reference
    pays the same cost in its torch Dataset, custom_dataset.py:74-81, hidden
    behind DataLoader worker processes).  Budget via ``VUB_DECODE_CACHE_MB``
    (default 4096; 0 disables).  Safe under the loader's fetch thread pool.
    """

    def __init__(self, budget_bytes: Optional[int] = None):
        if budget_bytes is None:
            budget_bytes = int(os.environ.get("VUB_DECODE_CACHE_MB", "4096")) * (1 << 20)
        self.budget = budget_bytes
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[tuple, np.ndarray]" = collections.OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, key, decode_fn) -> np.ndarray:
        if self.budget <= 0:
            return decode_fn()
        with self._lock:
            arr = self._entries.get(key)
            if arr is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return arr
            self.misses += 1
        arr = decode_fn()  # decode outside the lock (PIL releases the GIL)
        with self._lock:
            if key not in self._entries:
                self._entries[key] = arr
                self._bytes += arr.nbytes
                while self._bytes > self.budget and len(self._entries) > 1:
                    _, old = self._entries.popitem(last=False)
                    self._bytes -= old.nbytes
            return self._entries[key]


_decode_cache = DecodeCache()


def _decode_nocache(path: str, use_rgb: bool) -> np.ndarray:
    """Decode an image file to uint8 HWC (C=3) or HW1 (grayscale)."""
    from PIL import Image

    img = Image.open(path)
    if img.mode == "RGBA":
        img = img.convert("RGB")
    if use_rgb:
        if img.mode != "RGB":
            img = img.convert("RGB")
        arr = np.asarray(img, dtype=np.uint8)
    else:
        arr = np.asarray(img.convert("L"), dtype=np.uint8)[..., None]
    return arr


def _decode(path: str, use_rgb: bool) -> np.ndarray:
    """Cached decode — one decode per image per process, not per patch."""
    return _decode_cache.get((path, use_rgb), lambda: _decode_nocache(path, use_rgb))


def _index_patches(size: Tuple[int, int], patch_size: int = PATCH_SIZE):
    """All (top, left) of non-overlapping patches fully inside a (width, height) image.

    Same walk order as the reference (custom_dataset.py:44-58): rows outer, cols inner.
    """
    width, height = size
    coords = []
    for top in range(0, height, patch_size):
        for left in range(0, width, patch_size):
            if top + patch_size <= height and left + patch_size <= width:
                coords.append((top, left))
    return coords


class FolderPatchDataset:
    """Clean patches from an image folder + per-sample Gaussian noise level.

    ``__getitem__`` returns (clean_u8 HWC, sigma float); the noisy counterpart is
    produced on-device to replicate custom_dataset.py:83-87 (noise added in [0,255]
    space, clipped, cast to uint8) without host-side work.
    """

    def __init__(
        self,
        image_folder: str,
        noise_levels: Optional[Sequence[float]] = None,
        use_rgb: bool = False,
        patch_size: int = PATCH_SIZE,
    ):
        from PIL import Image

        self.use_rgb = use_rgb
        self.noise_levels = list(noise_levels) if noise_levels is not None else [15, 25, 50]
        self.patch_size = patch_size
        self.image_paths = sorted(
            os.path.join(image_folder, f)
            for f in os.listdir(image_folder)
            if f.lower().endswith(IMAGE_EXTENSIONS)
        )
        self.patches: List[Tuple[str, int, int]] = []
        for path in self.image_paths:
            with Image.open(path) as img:
                size = img.size
            for top, left in _index_patches(size, patch_size):
                self.patches.append((path, top, left))

    @property
    def channels(self) -> int:
        return 3 if self.use_rgb else 1

    def __len__(self):
        return len(self.patches) * len(self.noise_levels)

    def __getitem__(self, idx: int):
        noise_idx = idx % len(self.noise_levels)
        patch_idx = idx // len(self.noise_levels)
        path, top, left = self.patches[patch_idx]
        arr = _decode(path, self.use_rgb)
        p = self.patch_size
        clean = arr[top : top + p, left : left + p]
        return clean, float(self.noise_levels[noise_idx])

    def gather_batch(self, indices):
        """Batched fetch: one native gather over cached frames (native/patchio).

        Returns the same (clean_u8 [N,p,p,C], sigma_f32 [N]) a per-item fetch +
        collate would.
        """
        from ..native import gather_patches

        frames, tops, lefts, sigmas = [], [], [], []
        for idx in indices:
            idx = int(idx)
            path, top, left = self.patches[idx // len(self.noise_levels)]
            frames.append(_decode(path, self.use_rgb))
            tops.append(top)
            lefts.append(left)
            sigmas.append(self.noise_levels[idx % len(self.noise_levels)])
        clean = gather_patches(frames, tops, lefts, self.patch_size)
        return clean, np.asarray(sigmas, np.float32)


class SIDDPatchDataset:
    """Real-noise (noisy, GT) patch pairs from an SIDD_Medium_Srgb tree."""

    def __init__(self, root_folder: str, use_rgb: bool = True, patch_size: int = PATCH_SIZE):
        from PIL import Image

        self.use_rgb = use_rgb
        self.patch_size = patch_size
        data_folder = os.path.join(root_folder, "Data")
        scene_file = os.path.join(root_folder, "Scene_Instances.txt")
        with open(scene_file) as f:
            # strip per line: CRLF/whitespace would make every isdir check fail
            # and silently yield an EMPTY dataset
            scenes = [line.strip() for line in f if line.strip()]

        self.image_pairs: List[Tuple[str, str]] = []
        for scene in scenes:
            dir_path = os.path.join(data_folder, scene)
            if not os.path.isdir(dir_path):
                continue
            files = os.listdir(dir_path)
            noisy = sorted(os.path.join(dir_path, f) for f in files if "NOISY" in f)
            gt = sorted(os.path.join(dir_path, f) for f in files if "GT" in f)
            if len(noisy) != len(gt):
                import warnings

                warnings.warn(
                    f"SIDD scene '{scene}': {len(noisy)} NOISY vs {len(gt)} GT files; "
                    f"pairing the first {min(len(noisy), len(gt))}", stacklevel=2,
                )
            self.image_pairs.extend(zip(noisy, gt))
        if scenes and not self.image_pairs:
            raise FileNotFoundError(
                f"no NOISY/GT pairs found under {data_folder} for the "
                f"{len(scenes)} scenes listed in {scene_file}"
            )

        self.patches: List[Tuple[str, str, int, int]] = []
        for noisy_path, gt_path in self.image_pairs:
            with Image.open(noisy_path) as img:
                size = img.size
            for top, left in _index_patches(size, patch_size):
                self.patches.append((noisy_path, gt_path, top, left))

    @property
    def channels(self) -> int:
        return 3 if self.use_rgb else 1

    def __len__(self):
        return len(self.patches)

    def __getitem__(self, idx: int):
        noisy_path, gt_path, top, left = self.patches[idx]
        p = self.patch_size
        noisy = _decode(noisy_path, self.use_rgb)[top : top + p, left : left + p]
        gt = _decode(gt_path, self.use_rgb)[top : top + p, left : left + p]
        return noisy, gt

    def gather_batch(self, indices):
        """Batched (noisy, gt) fetch via the native gather over cached frames."""
        from ..native import gather_patches

        n_frames, g_frames, tops, lefts = [], [], [], []
        for idx in indices:
            noisy_path, gt_path, top, left = self.patches[int(idx)]
            n_frames.append(_decode(noisy_path, self.use_rgb))
            g_frames.append(_decode(gt_path, self.use_rgb))
            tops.append(top)
            lefts.append(left)
        noisy = gather_patches(n_frames, tops, lefts, self.patch_size)
        gt = gather_patches(g_frames, tops, lefts, self.patch_size)
        return noisy, gt


class PairedFolderDataset:
    """Legacy pre-paired (gt_folder, degraded_folder) dataset.

    Reference: the bytecode-only root ``__pycache__/custom_dataset.pyc`` (orig 107
    lines) pairs same-named files from a GT folder and a degraded folder, validating
    that both folders list the same files.  Full images (no patch index) like the
    legacy loader.
    """

    def __init__(self, gt_folder: str, degraded_folder: str, use_rgb: bool = False):
        gt_files = sorted(
            f for f in os.listdir(gt_folder) if f.lower().endswith(IMAGE_EXTENSIONS)
        )
        deg_files = sorted(
            f for f in os.listdir(degraded_folder) if f.lower().endswith(IMAGE_EXTENSIONS)
        )
        if gt_files != deg_files:
            raise ValueError(
                "gt and degraded folders must contain identically-named images "
                f"({len(gt_files)} vs {len(deg_files)} files)"
            )
        self.pairs = [
            (os.path.join(degraded_folder, f), os.path.join(gt_folder, f))
            for f in gt_files
        ]
        self.use_rgb = use_rgb

    @property
    def channels(self) -> int:
        return 3 if self.use_rgb else 1

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int):
        degraded_path, gt_path = self.pairs[idx]
        return _decode(degraded_path, self.use_rgb), _decode(gt_path, self.use_rgb)


class ArrayPatchDataset:
    """In-memory (noisy, gt) uint8 pairs — synthetic smoke data and .mat block adapter."""

    def __init__(self, noisy: np.ndarray, gt: np.ndarray):
        assert noisy.shape == gt.shape and noisy.dtype == np.uint8
        self.noisy = noisy
        self.gt = gt

    @property
    def channels(self) -> int:
        return self.noisy.shape[-1]

    def __len__(self):
        return len(self.noisy)

    def __getitem__(self, idx: int):
        return self.noisy[idx], self.gt[idx]

    def gather_batch(self, indices):
        idx = np.asarray(indices, np.int64)
        return self.noisy[idx], self.gt[idx]
