"""Standalone training presets mirroring the reference's hardcoded __main__ scripts.

Counterpart of ``vub_image_denoising_tpu/train/presets.py``, over the port's
trainers and loaders.  The reference duplicates the diffusion trainer into
files that differ only in config; here each is a preset over one trainer:

- ``main_diffusion_rdunet``       — diffusion_denoising/main_diffusion_RDUnet.py:361-387:
  folder dataset, batch 8, base_filters 32, Adam(2e-4) + CosineAnnealingLR(T_max=10),
  300 epochs, optional resume.
- ``main_diffusion_rdunet_sidd``  — main_diffusion_RDUnet_SIDD.py:361-382: the same
  with the SIDD loader and dataset_percentage 0.1.
- ``diffusion_rdunet_direct``     — diffusion_RDUnet_direct.py:352-373: validation
  samples directly at t = 1 (:187-206).
- ``rdunet_supervised_main``      — UNet/RDUNet_model.py:270-283: RDUNet(128) supervised
  on DIV2K 10%, batch 4, 21 epochs, AdamW(1e-4, wd 1e-5), StepLR(3, 0.5), accum 4.

Each takes ``device`` (default the card) where the JAX presets shard over a mesh.
"""

from typing import Optional

import torch

from ..data.loader import load_data as load_folder_data
from ..data.loader import load_sidd_data
from ..models.rdunet import RDUNet
from .diffusion import DiffusionTrainer
from .supervised import SupervisedTrainer


def _run_diffusion(trainer: DiffusionTrainer, train_loader, val_loader,
                   num_epochs: int, checkpoint_path: Optional[str] = None):
    state = trainer.init(steps_per_epoch=len(train_loader))
    state, start_epoch = trainer.load_checkpoint(state, checkpoint_path)
    return trainer.fit(state, train_loader, val_loader, num_epochs, start_epoch=start_epoch)


def _adam_cosine_trainer(output_dir, device, **kw):
    """The diffusion presets' trainer: Adam(2e-4) + cosine(T_max 10), base 32, T = 20."""
    return DiffusionTrainer(
        base_filters=32, timesteps=20, optimizer_choice="adam",
        scheduler_choice="cosine", lr=2e-4, output_dir=output_dir, device=device, **kw,
    )


def main_diffusion_rdunet(image_folder: str, num_epochs: int = 300,
                          checkpoint_path: Optional[str] = None,
                          output_dir: str = "checkpoints", batch_size: int = 8, device=None):
    """main_diffusion_RDUnet.py config: Adam(2e-4) + cosine(T_max 10), base 32, T=20."""
    trainer = _adam_cosine_trainer(output_dir, device)
    train_loader, val_loader = load_folder_data(
        image_folder, batch_size=batch_size, use_rgb=True, dataset_percentage=1.0,
        device=device,
    )
    return _run_diffusion(trainer, train_loader, val_loader, num_epochs, checkpoint_path)


def main_diffusion_rdunet_sidd(root_folder: str, num_epochs: int = 300,
                               checkpoint_path: Optional[str] = None,
                               output_dir: str = "checkpoints", batch_size: int = 8,
                               device=None):
    """main_diffusion_RDUnet_SIDD.py config: SIDD pairs, dataset_percentage 0.1."""
    trainer = _adam_cosine_trainer(output_dir, device)
    train_loader, val_loader = load_sidd_data(
        root_folder, batch_size=batch_size, use_rgb=True, dataset_percentage=0.1,
        device=device,
    )
    return _run_diffusion(trainer, train_loader, val_loader, num_epochs, checkpoint_path)


def diffusion_rdunet_direct(image_folder: str, num_epochs: int = 300,
                            checkpoint_path: Optional[str] = None,
                            output_dir: str = "checkpoints", batch_size: int = 8, device=None):
    """diffusion_RDUnet_direct.py: single-call t=1 sampling ablation (:187-206)."""
    trainer = _adam_cosine_trainer(output_dir, device, sampling="direct")
    train_loader, val_loader = load_folder_data(
        image_folder, batch_size=batch_size, use_rgb=True, dataset_percentage=1.0,
        device=device,
    )
    return _run_diffusion(trainer, train_loader, val_loader, num_epochs, checkpoint_path)


def rdunet_supervised_trainer(model=None, engine: str = "flax", device=None):
    """rdunet_supervised_main's trainer: RDUNet(128) (``model``, when given,
    takes its place), f32, AdamW(1e-4, wd 1e-5), accumulation 4, a checkpoint
    every 5 epochs.  Its blocks at c = 512 and 1024 run kernel 1's wide form."""
    return SupervisedTrainer(
        model if model is not None else RDUNet(channels=3, base_filters=128), lr=1e-4,
        weight_decay=1e-5, accumulation_steps=4, checkpoint_every=5,
        engine=engine, remat=False, compute_dtype=torch.float32, device=device,
    )


def rdunet_supervised_main(image_folder: str, num_epochs: int = 21,
                           batch_size: int = 4, device=None):
    """UNet/RDUNet_model.py __main__: RDUNet(128), DIV2K 10%, AdamW, 21 epochs.

    The JAX preset's ``fast`` option (a geometry tuned on a TPU) is not
    ported.
    """
    trainer = rdunet_supervised_trainer(device=device)
    train_loader, val_loader = load_folder_data(
        image_folder, batch_size=batch_size, augment=False, dataset_percentage=0.1,
        use_rgb=True, device=device,
    )
    state = trainer.init(steps_per_epoch=len(train_loader))
    return trainer.fit(state, train_loader, num_epochs, val_loader=val_loader)
