"""Data: patch datasets (host), the native gather, noise/augment/normalize on
the device, the threaded host loader and the device-resident bank loader."""

from .datasets import (
    ArrayPatchDataset,
    FolderPatchDataset,
    PairedFolderDataset,
    SIDDPatchDataset,
)
from .device import augment_pair, degrade_and_normalize, denormalize, normalize_pair
from .loader import PatchLoader, load_data, load_sidd_data
from .resident import DeviceBankLoader
