"""vub_image_denoising_tpu_torch — the denoising framework in PyTorch, for NVIDIA Hopper.

The PyTorch and CUDA counterpart of ``vub_image_denoising_tpu``, module for
module under the same names.  It imports torch and never JAX.

- ``nn``        — layers and RDUNet blocks (state_dict keys = the reference ``.pth``)
- ``models``    — ``RDUNet``, the time-conditioned ``RDUNetT``, and the
  functional forward with a choice of block engine (``fused_apply``)
- ``ops``       — hand-written CUDA kernels (``csrc/``) with their plain versions
- ``diffusion`` — the interpolation-diffusion sampler and its losses
- ``data``      — patch datasets, the host and device-resident loaders, and
  noise / augmentation / normalization on the device
- ``native``    — the C++ batched patch gather (``patchio.cpp``, ctypes)
- ``train``     — the supervised and the diffusion trainers (``fit``,
  checkpoints, resume), presets, and the diffusion training CLI
- ``utils``     — ``.pth`` checkpoint IO and the JAX param-tree converter,
  preemption-safe stops, TensorBoard logging, model info (FLOPs, latency,
  peak memory), profiling, the device health probe, random streams
- ``eval``      — the denoising CLI and the HTTP server (``rdunet`` and
  ``diffusion``), image metrics, SIDD validation and the Kaggle submission,
  LPIPS and DISTS, the comparative runner and its figures
- ``search``    — the hyperparameter searches over the diffusion trainer and
  the denoising GAN (optuna, or a built-in TPE engine)
"""

__version__ = "0.1.0"


def enable_strict_precision():
    """Exact f32 matmuls and convs on the card.

    cuDNN runs f32 convolutions in TF32 by default (about three decimal
    digits), so an f32 run that must match a reference turns TF32 off for
    both matmuls and convs.  bf16 runs are unaffected."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
