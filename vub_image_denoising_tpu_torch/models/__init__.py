"""Models."""

from .rdunet import RDUNet, RDUNetT

__all__ = ["RDUNet", "RDUNetT"]
