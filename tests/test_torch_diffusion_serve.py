"""The port's diffusion entry points against the JAX package's, on the CPU:
``build_denoiser(arch="diffusion")``, the CLI and the HTTP server.

A tiny RDUNetT (base 4, seeded weights) at T = 2, written by the port with
``unet.`` keys and read by both packages.  The denoiser is held to
the JAX one at 1e-4 (the samplers' tolerance, tests/test_torch_diffusion.py);
served bytes to the denoiser's output within 1 level of 255."""

import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from vub_image_denoising_tpu.eval.denoise_cli import build_denoiser as jax_build_denoiser
from vub_image_denoising_tpu_torch.eval import denoise_cli, serve
from vub_image_denoising_tpu_torch.models import RDUNetT
from vub_image_denoising_tpu_torch.utils import checkpoint as ckpt

BASE, T = 4, 2


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A seeded RDUNetT saved with ``unet.`` keys, as the reference diffusion
    checkpoints are."""
    ck = str(tmp_path_factory.mktemp("ck") / "diffusion.pth")
    model = RDUNetT(BASE, generator=torch.Generator().manual_seed(1))
    ckpt.save_pth(ck, model.state_dict(), epoch=2, prefix="unet.")
    return ck


def _to_u8(y):
    return np.clip((y + 1.0) * 0.5 * 255.0 + 0.5, 0, 255).astype(np.uint8)


def test_build_denoiser_diffusion_matches_jax_on_odd_size(checkpoint):
    """An odd size takes the reflect-pad-to-8 path shared with rdunet."""
    ck = checkpoint
    image = np.random.RandomState(2).rand(13, 11, 3).astype(np.float32) * 2 - 1
    # the JAX denoiser jits its own forward: compile it with XLA's
    # optimizations off, as run_jax does (tests/test_torch_fused_apply.py)
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        with jax.default_matmul_precision("highest"):
            want = np.asarray(jax_build_denoiser(ck, arch="diffusion", base_filters=BASE,
                                                 timesteps=T)(image))
    finally:
        jax.config.update("jax_disable_most_optimizations", before)
    got = denoise_cli.build_denoiser(ck, "diffusion", BASE, T, device="cpu")(image)
    assert got.shape == (13, 11, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_denoise_cli_main_diffusion_writes_image(checkpoint, tmp_path):
    from PIL import Image

    ck = checkpoint
    arr = np.random.RandomState(3).randint(0, 256, (20, 13, 3), np.uint8)
    Image.fromarray(arr).save(tmp_path / "noisy.png")
    denoise_cli.main(["--checkpoint", ck, "--arch", "diffusion", "--timesteps", str(T),
                      "--base-filters", str(BASE), "--device", "cpu",
                      "--input", str(tmp_path / "noisy.png"),
                      "--output", str(tmp_path / "clean.png")])
    out = np.asarray(Image.open(tmp_path / "clean.png"))
    y = denoise_cli.build_denoiser(ck, "diffusion", BASE, T, device="cpu")(
        arr.astype(np.float32) / 255.0 * 2.0 - 1.0)
    np.testing.assert_array_equal(out, _to_u8(y))
    with pytest.raises(ValueError, match="requires RGB"):
        denoise_cli.main(["--checkpoint", ck, "--arch", "diffusion", "--grayscale",
                          "--base-filters", str(BASE), "--device", "cpu",
                          "--input", str(tmp_path / "noisy.png")])


def test_serve_diffusion_roundtrip(checkpoint):
    ck = checkpoint
    fn = denoise_cli.build_denoiser(ck, "diffusion", BASE, T, batched=True, device="cpu")
    service = serve.BatchingDenoiseService(fn, max_batch=2, max_wait_ms=50.0)
    server = serve.make_server(service, {"arch": "diffusion"}, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        arr = np.random.RandomState(4).randint(0, 256, (16, 24, 3), np.uint8)
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/denoise", data=arr.tobytes(),
            method="POST", headers={"Content-Type": "application/octet-stream",
                                    "X-Shape": "16,24,3", "Accept": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=120) as r:
            got = np.frombuffer(r.read(), np.uint8).reshape(arr.shape)
        want = _to_u8(fn((arr.astype(np.float32) / 255.0 * 2.0 - 1.0)[None])[0])
        assert np.abs(got.astype(int) - want).max() <= 1
        assert service.stats["requests"] == 1
    finally:
        server.shutdown()
        service.close()


def test_serve_main_passes_timesteps(monkeypatch):
    seen = {}

    def fake_build_denoiser(*args, **kwargs):
        seen["args"] = args
        raise KeyboardInterrupt  # stop before the server starts

    monkeypatch.setattr(serve, "build_denoiser", fake_build_denoiser)
    with pytest.raises(KeyboardInterrupt):
        serve.main(["--checkpoint", "x.pth", "--arch", "diffusion", "--timesteps", "7",
                    "--device", "cpu"])
    assert seen["args"] == ("x.pth", "diffusion", 32, 7)

