"""Perceptual metrics: LPIPS (AlexNet) and DISTS, as torch modules.

Counterpart of ``vub_image_denoising_tpu/eval/perceptual.py``.  The
reference's comparative suite uses ``lpips.LPIPS(net='alex')`` and
``DISTS_pytorch.DISTS`` (evaluate_Unet_diffusion/evaluate_model.py:79-80) on
[-1, 1] 3-channel images.  Those packages and their pretrained weights are
not in the repository and nothing is fetched, so:

- the architectures are rebuilt on ``nn/torch_layers.py`` (``TorchConv``):
  AlexNet's features with a tap after each ReLU for LPIPS; VGG16's stages
  with structure and texture statistics for DISTS;
- ``load_lpips_torch`` / ``load_dists_torch`` fill a module from the
  original packages' files when the user has them (an explicit path, or
  ``LPIPS_WEIGHTS`` with ``ALEXNET_WEIGHTS``, ``DISTS_WEIGHTS`` with
  ``VGG16_WEIGHTS``) and load the result with ``load_state_dict(strict=True)``;
- without a file, ``make_lpips``/``make_dists`` draw the weights from an
  explicit generator seeded by ``seed``: LPIPS(x, x) = DISTS(x, x) = 0
  still hold, so the metrics stay usable as relative distances, but their
  values are not the published metrics'.

Inputs are NCHW in [-1, 1]; each returns (N,) distances.  The parameter
names are the JAX package's (``backbone.conv{i}``, ``lin{i}``,
``alpha{i}``, ``beta{i}``), so its parameter trees carry across with
``utils.checkpoint.params_to_state_dict``.
"""

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.torch_layers import TorchConv
from ..utils.checkpoint import load_torch_payload
from ..utils.device import resolve_device

# lpips input normalization (lpips/lpips.py ScalingLayer constants)
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_LPIPS_CHANNELS = [64, 192, 384, 256, 256]
_DISTS_CHANNELS = [3, 64, 128, 256, 512, 512]
# torchvision ``features`` indices of the convs
_ALEXNET_CONVS = [0, 3, 6, 8, 10]
_VGG16_CONVS = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


def _per_channel(values, x):
    return torch.tensor(values, dtype=x.dtype, device=x.device).view(1, -1, 1, 1)


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet.features with taps after each ReLU (5 taps)."""

    def __init__(self, generator=None):
        super().__init__()
        g = generator
        self.conv0 = TorchConv(3, 64, 11, 4, 2, generator=g)
        self.conv1 = TorchConv(64, 192, 5, 1, 2, generator=g)
        self.conv2 = TorchConv(192, 384, 3, 1, 1, generator=g)
        self.conv3 = TorchConv(384, 256, 3, 1, 1, generator=g)
        self.conv4 = TorchConv(256, 256, 3, 1, 1, generator=g)

    def forward(self, x):
        taps = []
        x = F.relu(self.conv0(x))
        taps.append(x)
        x = F.relu(self.conv1(F.max_pool2d(x, 3, 2)))
        taps.append(x)
        x = F.relu(self.conv2(F.max_pool2d(x, 3, 2)))
        taps.append(x)
        x = F.relu(self.conv3(x))
        taps.append(x)
        x = F.relu(self.conv4(x))
        taps.append(x)
        return taps


def _unit_normalize(f, eps=1e-10):
    return f / (torch.sqrt(torch.sum(f ** 2, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """lpips.LPIPS(net='alex') equivalent: unit-normalized feature
    differences, non-negative 1x1 linear heads, spatial mean, sum over taps.
    The heads start U[0, 0.1) (the JAX package's init)."""

    def __init__(self, generator=None):
        super().__init__()
        self.backbone = AlexNetFeatures(generator)
        for i, c in enumerate(_LPIPS_CHANNELS):
            self.register_parameter(f"lin{i}", nn.Parameter(
                torch.rand(c, generator=generator) * 0.1))

    def forward(self, x, y):
        shift, scale = _per_channel(_LPIPS_SHIFT, x), _per_channel(_LPIPS_SCALE, x)
        fx = self.backbone((x - shift) / scale)
        fy = self.backbone((y - shift) / scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            w = torch.abs(getattr(self, f"lin{i}")).to(d.dtype).view(1, -1, 1, 1)
            total = total + torch.mean(torch.sum(d * w, dim=1), dim=(1, 2))
        return total


class VGG16Stages(nn.Module):
    """VGG16 conv stages with taps at relu1_2, relu2_2, relu3_3, relu4_3, relu5_3."""

    CFG = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]

    def __init__(self, generator=None):
        super().__init__()
        cin, ci = 3, 0
        for n_convs, ch in self.CFG:
            for _ in range(n_convs):
                self.add_module(f"conv{ci}", TorchConv(cin, ch, 3, 1, 1, generator=generator))
                cin, ci = ch, ci + 1

    def forward(self, x):
        taps, ci = [], 0
        for stage, (n_convs, _) in enumerate(self.CFG):
            for _ in range(n_convs):
                x = F.relu(getattr(self, f"conv{ci}")(x))
                ci += 1
            taps.append(x)
            if stage < 4:
                x = F.max_pool2d(x, 2, 2)
        return taps


class DISTS(nn.Module):
    """DISTS_pytorch.DISTS equivalent.

    Stages = [input] + 5 VGG16 taps; per-stage per-channel spatial mean,
    variance and covariance; structure and texture similarities weighted by
    alpha and beta (normalized by their joint sum; both start at 0.1).
    Input in [-1, 1], taken to [0, 1] and ImageNet-normalized."""

    def __init__(self, generator=None):
        super().__init__()
        self.backbone = VGG16Stages(generator)
        for i, c in enumerate(_DISTS_CHANNELS):
            self.register_parameter(f"alpha{i}", nn.Parameter(torch.full((c,), 0.1)))
            self.register_parameter(f"beta{i}", nn.Parameter(torch.full((c,), 0.1)))

    def _features(self, x):
        xn = ((x + 1.0) / 2.0 - _per_channel(_IMAGENET_MEAN, x)) / _per_channel(_IMAGENET_STD, x)
        return [xn] + self.backbone(xn)

    def forward(self, x, y, eps=1e-6):
        fx, fy = self._features(x), self._features(y)
        alpha = [getattr(self, f"alpha{i}") for i in range(len(_DISTS_CHANNELS))]
        beta = [getattr(self, f"beta{i}") for i in range(len(_DISTS_CHANNELS))]
        w_sum = torch.cat(alpha).sum() + torch.cat(beta).sum()
        dist1 = dist2 = 0.0
        for a, b, al, be in zip(fx, fy, alpha, beta):
            mu_a, mu_b = a.mean(dim=(2, 3)), b.mean(dim=(2, 3))
            var_a = a.var(dim=(2, 3), unbiased=False)
            var_b = b.var(dim=(2, 3), unbiased=False)
            cov = (a * b).mean(dim=(2, 3)) - mu_a * mu_b
            s1 = (2 * mu_a * mu_b + eps) / (mu_a ** 2 + mu_b ** 2 + eps)
            s2 = (2 * cov + eps) / (var_a + var_b + eps)
            dist1 = dist1 + torch.sum((al / w_sum).to(s1.dtype) * s1, dim=-1)
            dist2 = dist2 + torch.sum((be / w_sum).to(s2.dtype) * s2, dim=-1)
        return 1.0 - (dist1 + dist2)


def _torchvision_convs(sd, indices):
    """``backbone.conv{i}.*`` entries from a torchvision ``features.{j}.*``
    state_dict (bare or under ``state_dict``)."""
    if "state_dict" in sd:
        sd = sd["state_dict"]
    out = {}
    for i, j in enumerate(indices):
        out[f"backbone.conv{i}.weight"] = sd[f"features.{j}.weight"]
        out[f"backbone.conv{i}.bias"] = sd[f"features.{j}.bias"]
    return out


def load_lpips_torch(model: LPIPS, path: Optional[str] = None):
    """Fill ``model`` from the lpips package's alex ``.pth`` (its
    ``lin{i}.model.1.weight`` heads) at ``path`` or ``$LPIPS_WEIGHTS``, and
    its backbone from a torchvision ``alexnet`` state_dict at
    ``$ALEXNET_WEIGHTS`` when set; strict.  Returns the model, or None when
    there is no heads file."""
    path = path or os.environ.get("LPIPS_WEIGHTS")
    if not path or not os.path.isfile(path):
        return None
    sd = load_torch_payload(path)
    new = dict(model.state_dict())
    for i in range(len(_LPIPS_CHANNELS)):
        key = f"lin{i}.model.1.weight"
        if key in sd:
            new[f"lin{i}"] = sd[key].reshape(-1)
    alex_path = os.environ.get("ALEXNET_WEIGHTS")
    if alex_path and os.path.isfile(alex_path):
        new.update(_torchvision_convs(load_torch_payload(alex_path), _ALEXNET_CONVS))
    model.load_state_dict(new, strict=True)
    return model


def load_dists_torch(model: DISTS, path: Optional[str] = None,
                     vgg16_path: Optional[str] = None):
    """Fill ``model`` from DISTS_pytorch's weights.pt (``alpha``/``beta`` of
    shape (1, sum(stage channels), 1, 1)) at ``path`` or ``$DISTS_WEIGHTS``,
    and its backbone from a torchvision ``vgg16`` state_dict at
    ``vgg16_path`` or ``$VGG16_WEIGHTS`` when there is one; strict.
    Returns the model, or None when there is no DISTS file."""
    path = path or os.environ.get("DISTS_WEIGHTS")
    if not path or not os.path.isfile(path):
        return None
    sd = load_torch_payload(path)
    new = dict(model.state_dict())
    for name in ("alpha", "beta"):
        flat, start = sd[name].reshape(-1), 0
        for i, c in enumerate(_DISTS_CHANNELS):
            new[f"{name}{i}"] = flat[start:start + c]
            start += c
    vgg16_path = vgg16_path or os.environ.get("VGG16_WEIGHTS")
    if vgg16_path and os.path.isfile(vgg16_path):
        new.update(_torchvision_convs(load_torch_payload(vgg16_path), _VGG16_CONVS))
    model.load_state_dict(new, strict=True)
    return model


def _metric_fn(model, device):
    model = model.to(resolve_device(device)).eval().requires_grad_(False)
    dev = next(model.parameters()).device

    def fn(x, y):
        with torch.no_grad():
            return model(torch.as_tensor(x).to(dev), torch.as_tensor(y).to(dev))

    return fn


def make_lpips(seed: int = 0, weights_path: Optional[str] = None, device=None):
    """``(fn(x, y) -> (N,), model)`` on ``device`` (the card unless
    ``"cpu"``); x, y NCHW in [-1, 1], moved to the model's device.  The
    weights come from the files ``load_lpips_torch`` finds, else from a
    generator seeded by ``seed``."""
    model = LPIPS(generator=torch.Generator().manual_seed(seed))
    load_lpips_torch(model, weights_path)
    return _metric_fn(model, device), model


def make_dists(seed: int = 0, weights_path: Optional[str] = None, device=None):
    """As ``make_lpips``, for DISTS (``load_dists_torch``'s files)."""
    model = DISTS(generator=torch.Generator().manual_seed(seed))
    load_dists_torch(model, weights_path)
    return _metric_fn(model, device), model
