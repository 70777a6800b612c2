"""The interpolation-diffusion sampler and its training losses."""

from .interpolation import InterpolationDiffusion
from .losses import charbonnier_loss, combined_loss, ssim

__all__ = ["InterpolationDiffusion", "charbonnier_loss", "combined_loss", "ssim"]
