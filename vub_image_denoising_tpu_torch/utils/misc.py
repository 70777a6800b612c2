"""Small utilities mirroring the reference's scripts (SURVEY.md C25).

Counterpart of ``vub_image_denoising_tpu/utils/misc.py``:

- ``clear_runs``: clear_runs.py:1-11 (remove the TensorBoard runs dir).
- ``probe_devices``: test_cuda.py:3-13, print the CUDA devices.
- ``summarize_dataset``: dataset_creation/test.py:6-40, image/patch/sample
  counts of a folder dataset.
- ``probe_mat``: evaluate_SIDD/test.py:1-8, print a ``.mat`` file's keys.
"""

import os
import shutil

import torch


def clear_runs(runs_dir: str = "runs"):
    if os.path.isdir(runs_dir):
        shutil.rmtree(runs_dir)
        print(f"Removed '{runs_dir}'")
    else:
        print(f"No '{runs_dir}' directory found")


def probe_devices():
    """Print whether CUDA is available and each card; return the cards as
    ``torch.device``s (none without CUDA)."""
    available = torch.cuda.is_available()
    print(f"CUDA available: {available}")
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())] \
        if available else []
    print(f"device count: {len(devices)}")
    for d in devices:
        print(f"  {d}: {torch.cuda.get_device_name(d)}")
    return devices


def probe_mat(mat_file: str):
    """Print (and return) a ``.mat`` file's keys, evaluate_SIDD/test.py:1-8."""
    import scipy.io

    keys = list(scipy.io.loadmat(mat_file).keys())
    print(keys)
    return keys


def summarize_dataset(image_folder: str, noise_levels=None, use_rgb: bool = True):
    from ..data.datasets import FolderPatchDataset

    ds = FolderPatchDataset(image_folder, noise_levels=noise_levels, use_rgb=use_rgb)
    info = {
        "images": len(ds.image_paths),
        "patches": len(ds.patches),
        "noise_levels": ds.noise_levels,
        "samples": len(ds),
    }
    for k, v in info.items():
        print(f"{k}: {v}")
    return info
