"""VGG19 feature extractor for the GANs' perceptual losses.

Counterpart of ``vub_image_denoising_tpu/models/vgg.py``.  The reference uses
``torchvision.models.vgg19(weights=IMAGENET1K_V1).features[:N]``
(paper_gan.py:203-216, N = 8; train_denoising_gan.py:114-126, N = 16).
``VGG19Features`` is those layers, its convs named ``conv0``, ``conv1``, ...
as in the JAX package; ``load_torch_vgg19`` fills it from a torchvision
``vgg19`` state_dict (``features.{i}.weight``) at an explicit path or at
``VGG19_WEIGHTS``.  Nothing is downloaded: without a file the module keeps
its random kaiming init (a random-feature perceptual loss), as the JAX
package does.
"""

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.torch_layers import TorchConv, max_pool_2x2
from ..utils.checkpoint import load_torch_payload

_VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


def _torch_layer_indices():
    """Conv order -> torchvision ``features`` index (convs at 0, 2, 5, 7, 10, ...)."""
    idx, out = 0, []
    for c in _VGG19_CFG:
        if c == "M":
            idx += 1
        else:
            out.append(idx)
            idx += 2  # conv + relu
    return out


def _plan(num_layers):
    """The first ``num_layers`` torchvision layers as ("conv", cout) /
    ("relu",) / ("pool",) steps."""
    steps = []
    for c in _VGG19_CFG:
        if c == "M":
            steps.append(("pool",))
        else:
            steps += [("conv", c), ("relu",)]
    return steps[:num_layers]


class VGG19Features(nn.Module):
    """The first ``num_layers`` entries of torchvision's ``vgg19().features``.
    Grayscale inputs are repeated to 3 channels, as in the reference
    (paper_gan.py:210-214)."""

    def __init__(self, num_layers: int = 8, generator=None):
        super().__init__()
        self.num_layers = num_layers
        self._plan = _plan(num_layers)
        cin, i = 3, 0
        for step in self._plan:
            if step[0] == "conv":
                self.add_module(f"conv{i}", TorchConv(cin, step[1], 3, 1, 1, generator=generator))
                cin, i = step[1], i + 1

    def forward(self, x):
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        i = 0
        for step in self._plan:
            if step[0] == "conv":
                x = getattr(self, f"conv{i}")(x)
                i += 1
            elif step[0] == "relu":
                x = F.relu(x)
            else:
                x = max_pool_2x2(x)
        return x


def load_torch_vgg19(model: VGG19Features, path: Optional[str] = None):
    """Fill ``model`` from a torchvision ``vgg19`` state_dict ``.pth`` (bare or
    under ``state_dict``) at ``path`` or ``$VGG19_WEIGHTS``.  Returns the
    model, or None when there is no such file."""
    path = path or os.environ.get("VGG19_WEIGHTS")
    if not path or not os.path.isfile(path):
        return None
    sd = load_torch_payload(path)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    torch_idx = _torch_layer_indices()
    with torch.no_grad():
        for name, conv in model.named_children():
            ti = torch_idx[int(name.replace("conv", ""))]
            conv.weight.copy_(sd[f"features.{ti}.weight"])
            conv.bias.copy_(sd[f"features.{ti}.bias"])
    return model
