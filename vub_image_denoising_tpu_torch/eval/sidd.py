"""SIDD validation and the Kaggle benchmark submission.

Counterpart of ``vub_image_denoising_tpu/eval/sidd.py``:

- ``SIDDMatBlocks`` / ``evaluate_sidd``, from evaluate_SIDD/evaluate_SIDD.py:
  load ValidationNoisyBlocksSrgb.mat / ValidationGtBlocksSrgb.mat (keys of
  the same names), flatten the (image, patch) grid, normalize to [-1, 1], run
  the sampler on a random subset of blocks, and report skimage-convention
  PSNR/SSIM with data_range=2 and the time per block (:43-78, 134-136); the
  results go to ``benchmark_results.csv`` (:139-148).
- ``make_kaggle_submission``, from evaluate_SIDD/benchmark.py: denoise the
  benchmark blocks, base64-encode each uint8 output block and write
  ``SubmitSrgb.csv`` (:77-103) for kaggle.com/competitions/sidd-benchmark-srgb-psnr.

Blocks run in batches (the reference runs batch 1), the metrics of a batch
in one call on the device; the time per block is the batch time over the
batch size.  Both CSVs are written with the standard ``csv`` module in the
layout pandas gives them (header, column order, ``repr`` floats, ``\\n``).
"""

import base64
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.table import write_csv
from .metrics import psnr_per_image, ssim_ref_per_image

# At most this many batches are enqueued on the device and not yet synced:
# syncing batch k-2's metric vectors waits for its whole chain, so its
# buffers are released and device memory stays O(1) in the eval size.
MAX_IN_FLIGHT = 2


def _c_order(a):
    """A loaded .mat array in C order.  ``loadmat`` returns MATLAB's
    column-major layout, in which neighbouring pixels of one block lie
    I*P bytes apart, so fetching a batch of blocks reads cache lines from
    the whole file (41 ms per batch of 8 noisy + 8 GT blocks against 0.6 ms
    in C order, at 40x32 blocks of 256^2 on the H100 machine's host, PERF.md
    §6).  One transposing copy at load, on torch's threads, saves it."""
    if a.flags.c_contiguous:
        return a
    return torch.from_numpy(a.T).permute(*reversed(range(a.ndim))).contiguous().numpy()


class SIDDMatBlocks:
    """256x256 uint8 sRGB blocks from SIDD .mat files (evaluate_SIDD.py:18-41)."""

    def __init__(self, noisy_mat_file: str, gt_mat_file: Optional[str] = None,
                 noisy_key: str = "ValidationNoisyBlocksSrgb",
                 gt_key: str = "ValidationGtBlocksSrgb"):
        import scipy.io

        # (I, P, H, W, C) uint8
        self.noisy = _c_order(scipy.io.loadmat(noisy_mat_file)[noisy_key])
        self.gt = _c_order(scipy.io.loadmat(gt_mat_file)[gt_key]) if gt_mat_file else None

    @property
    def n_images(self):
        return self.noisy.shape[0]

    @property
    def n_patches(self):
        return self.noisy.shape[1]

    def __len__(self):
        return self.n_images * self.n_patches

    def __getitem__(self, idx):
        i, p = idx // self.n_patches, idx % self.n_patches
        if self.gt is None:
            return self.noisy[i, p]
        return self.noisy[i, p], self.gt[i, p]


def _normalize_blocks(blocks_u8):
    """uint8 blocks -> f32 in [-1, 1], (x / 255 - 0.5) / 0.5 in f32 as JAX computes it."""
    x = np.asarray(blocks_u8, np.float32) / np.float32(255.0)
    return (x - np.float32(0.5)) / np.float32(0.5)


def _to_device(array, device):
    """A host array on ``device``: through pinned memory and a non-blocking
    copy on the card, so the copy is queued behind the work in flight."""
    t = torch.from_numpy(array)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate_sidd(
    sampler: Callable,
    blocks: SIDDMatBlocks,
    evaluation_percentage: float = 0.1,
    batch_size: int = 8,
    seed: int = 0,
    csv_path: Optional[str] = "benchmark_results.csv",
    method_name: str = "tpu-diffusion-rdunet",
    sample_plot_path: Optional[str] = None,
    n_samples: int = 4,
    device=None,
):
    """Run ``sampler(noisy) -> denoised`` over a random subset of blocks.

    ``sampler`` maps a normalized (N, H, W, C) [-1, 1] f32 tensor on
    ``device`` (the card unless ``device="cpu"``) to its denoised f32
    counterpart.  The subset is ``np.random.RandomState(seed).choice`` as in
    the JAX package, so both score the same blocks.  Returns avg_psnr,
    avg_ssim, avg_inference_time_ms (wall per block, after one warm-up call),
    device_inference_time_ms (one call on a resident batch, per block),
    warmup_compile_ms and n_blocks.  With ``sample_plot_path``, saves debug
    triptychs of the first ``n_samples`` blocks (evaluate_SIDD.py:70-72, 84-100)."""
    assert blocks.gt is not None, "evaluation needs GT blocks"
    device = resolve_device(device)
    n = len(blocks)
    idx = np.random.RandomState(seed).choice(n, int(n * evaluation_percentage), replace=False)
    batches = [idx[s: s + batch_size] for s in range(0, len(idx), batch_size)]

    def make_inputs(sel):
        noisy_u8 = np.stack([blocks[int(i)][0] for i in sel])
        gt_u8 = np.stack([blocks[int(i)][1] for i in sel])
        return (_to_device(_normalize_blocks(noisy_u8), device),
                _to_device(_normalize_blocks(gt_u8), device))

    def batch_metrics(gt_b, out_b):
        return (psnr_per_image(gt_b, out_b, data_range=2.0),
                ssim_ref_per_image(gt_b, out_b, data_range=2.0))

    psnrs, ssims, samples = [], [], []
    pending = []  # (psnr vector, ssim vector, count): device tensors until synced
    first_inputs = inputs = make_inputs(batches[0]) if batches else None
    # one call of the sampler and the metrics before the wall timer: the
    # first call loads the kernels and picks cuDNN's algorithms
    warmup_compile_ms = 0.0
    with torch.inference_mode():
        if inputs is not None:
            t_c0 = time.perf_counter()
            batch_metrics(inputs[1], sampler(inputs[0]))[0].cpu()
            warmup_compile_ms = (time.perf_counter() - t_c0) * 1000.0
        t_loop0 = time.perf_counter()

        def sync(entry):
            p_vec, s_vec, cnt = entry
            return p_vec.cpu().numpy(), s_vec.cpu().numpy(), cnt

        # batch k+1's host fetch and copy are queued before batch k's
        # metrics are read, so the host's work overlaps the sampler's
        for k, sel in enumerate(batches):
            nxt = make_inputs(batches[k + 1]) if k + 1 < len(batches) else None
            noisy, gt = inputs
            out = sampler(noisy)
            p_vec, s_vec = batch_metrics(gt, out)
            pending.append((p_vec, s_vec, len(sel)))
            if sample_plot_path and len(samples) < n_samples:
                for j in range(min(noisy.shape[0], n_samples - len(samples))):
                    samples.append((noisy[j].cpu().numpy(), gt[j].cpu().numpy(),
                                    out[j].cpu().numpy()))
            if len(pending) > MAX_IN_FLIGHT:
                pending[-MAX_IN_FLIGHT - 1] = sync(pending[-MAX_IN_FLIGHT - 1])
            inputs = nxt
        pending = [e if isinstance(e[0], np.ndarray) else sync(e) for e in pending]
        wall_ms = (time.perf_counter() - t_loop0) * 1000.0

        n_eval = 0
        for p_vec, s_vec, cnt in pending:
            psnrs.extend(np.asarray(p_vec, np.float64).tolist())
            ssims.extend(np.asarray(s_vec, np.float64).tolist())
            n_eval += cnt

        # steady-state device time per block, transfers excluded: the second
        # of two calls on the first batch, already on the device
        device_ms = float("nan")
        if first_inputs is not None:
            noisy0 = first_inputs[0]
            sampler(noisy0)
            _sync(device)
            t0 = time.perf_counter()
            sampler(noisy0)
            _sync(device)
            device_ms = (time.perf_counter() - t0) * 1000.0 / noisy0.shape[0]

    results = {
        "avg_psnr": float(np.mean(psnrs)),
        "avg_ssim": float(np.mean(ssims)),
        "avg_inference_time_ms": wall_ms / max(1, n_eval),
        "device_inference_time_ms": device_ms,
        "warmup_compile_ms": warmup_compile_ms,  # the first call, excluded above
        "n_blocks": len(psnrs),
    }
    if csv_path:
        write_csv(csv_path, ["Method", "MACs (G)", "Inference Time (ms)", "PSNR", "SSIM"],
                   [[method_name, "-", results["avg_inference_time_ms"], results["avg_psnr"],
                     results["avg_ssim"]]])
    if sample_plot_path and samples:
        plot_sample_images(samples, sample_plot_path)
    return results


def plot_sample_images(sample_images, path: str = "sidd_samples.png"):
    """Debug triptychs (noisy / GT / denoised), evaluate_SIDD.py:84-100.

    ``sample_images``: list of (noisy, gt, output) HWC arrays in [-1, 1]."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def denorm(img):
        return np.clip((np.asarray(img) + 1.0) / 2.0, 0, 1)

    n = len(sample_images)
    if n == 0:
        return None
    fig, axs = plt.subplots(n, 3, figsize=(15, 5 * n), squeeze=False)
    for i, (noisy, gt, output) in enumerate(sample_images):
        for j, (img, title) in enumerate(
            [(noisy, "Noisy"), (gt, "Ground Truth"), (output, "Denoised")]
        ):
            axs[i, j].imshow(denorm(img))
            axs[i, j].set_title(title)
            axs[i, j].axis("off")
    plt.tight_layout()
    plt.savefig(path)
    plt.close(fig)
    return path


def array_to_base64string(x: np.ndarray) -> str:
    return base64.b64encode(x.tobytes()).decode("utf-8")


def base64string_to_array(s: str, array_dtype, array_shape) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), dtype=array_dtype).reshape(array_shape)


def make_kaggle_submission(
    sampler: Callable,
    benchmark_mat_file: str,
    output_file: str = "SubmitSrgb.csv",
    batch_size: int = 8,
    device=None,
):
    """Denoise the BenchmarkNoisyBlocksSrgb blocks and write the Kaggle CSV.

    ``sampler`` is ``evaluate_sidd``'s.  Outputs are denormalized and
    quantized as the reference does (benchmark.py:42-44): (x + 1) / 2, then
    ``clip(x * 255, 0, 255).astype(uint8)``, which truncates (the image CLI
    rounds)."""
    device = resolve_device(device)
    blocks = SIDDMatBlocks(benchmark_mat_file, None, noisy_key="BenchmarkNoisyBlocksSrgb")
    n = len(blocks)
    out_strings = []
    with torch.inference_mode():
        for start in range(0, n, batch_size):
            sel = range(start, min(start + batch_size, n))
            noisy_u8 = np.stack([blocks[i] for i in sel])
            out = sampler(_to_device(_normalize_blocks(noisy_u8), device))
            out = np.asarray(out.cpu().numpy(), np.float32)
            out = (out + 1.0) / 2.0
            out_u8 = np.clip(out * 255.0, 0, 255).astype(np.uint8)
            assert out_u8.shape == noisy_u8.shape and out_u8.dtype == noisy_u8.dtype
            out_strings.extend(array_to_base64string(out_u8[k]) for k in range(len(out_u8)))

    write_csv(output_file, ["ID", "BLOCK"], [[i, s] for i, s in enumerate(out_strings)])
    return output_file
