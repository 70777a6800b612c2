"""Where the port's entry points run."""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Without CUDA this raises: the CPU is used only
    when the caller asks for it with ``device="cpu"``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device
