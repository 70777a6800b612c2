"""The port's checkpoint IO, denoiser and HTTP server against the JAX package's,
on the CPU (``device="cpu"``), and the port's import boundary."""

import ast
import io
import json
import pathlib
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from test_torch_rdunet import numpy_params
from vub_image_denoising_tpu.eval.denoise_cli import build_denoiser as jax_build_denoiser
from vub_image_denoising_tpu.models.rdunet import RDUNet as JRDUNet
from vub_image_denoising_tpu.utils import checkpoint as jax_ckpt
from vub_image_denoising_tpu_torch.eval import denoise_cli, serve
from vub_image_denoising_tpu_torch.models import RDUNet
from vub_image_denoising_tpu_torch.utils import checkpoint as ckpt

REPO = pathlib.Path(__file__).resolve().parent.parent


def _jax_params(base, seed=0):
    return numpy_params(JRDUNet(3, base), np.zeros((1, 16, 16, 3), np.float32), seed)


def _port_checkpoint(tmp_path, base=4):
    ck = str(tmp_path / "port.pth")
    model = RDUNet(3, base, generator=torch.Generator().manual_seed(0))
    ckpt.save_pth(ck, model.state_dict(), epoch=1)
    return ck


def test_pth_interop_both_ways(tmp_path):
    params = _jax_params(4)
    # JAX writes, the port reads
    ck = str(tmp_path / "jax.pth")
    jax_ckpt.save_pth(ck, params, epoch=3)
    model, payload = ckpt.load_pth(ck, RDUNet(3, 4))
    assert payload["epoch"] == 3
    want = ckpt.params_to_state_dict(params)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    # the port writes (bare and wrapped), JAX reads
    for bare in (False, True):
        ck2 = str(tmp_path / f"port_{bare}.pth")
        ckpt.save_pth(ck2, model.state_dict(), epoch=5, bare=bare)
        back, payload2 = jax_ckpt.load_pth(ck2, params)
        assert (payload2 is None) if bare else (payload2["epoch"] == 5)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_build_denoiser_matches_jax_on_odd_size(tmp_path):
    ck = str(tmp_path / "jax.pth")
    jax_ckpt.save_pth(ck, _jax_params(8, seed=1), epoch=1)
    image = np.random.RandomState(2).rand(61, 47, 3).astype(np.float32) * 2 - 1
    want = np.asarray(jax_build_denoiser(ck, base_filters=8)(image))
    got = denoise_cli.build_denoiser(ck, base_filters=8, device="cpu")(image)
    assert got.shape == (61, 47, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    batched = denoise_cli.build_denoiser(ck, base_filters=8, batched=True, device="cpu")
    np.testing.assert_allclose(batched(np.stack([image, -image]))[0], got, rtol=1e-5, atol=1e-5)


def _serve(service):
    server = serve.make_server(service, {"arch": "rdunet"}, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _post(url, data, headers=None):
    req = urllib.request.Request(url, data=data, method="POST", headers=headers or {})
    with urllib.request.urlopen(req, timeout=120) as r:
        return dict(r.headers), r.read()


def _png(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_serve_raw_and_png_roundtrip_and_bad_input(tmp_path):
    from PIL import Image

    fn = denoise_cli.build_denoiser(_port_checkpoint(tmp_path), base_filters=4, device="cpu")
    server, base = _serve(serve.DenoiseService(fn))
    try:
        arr = np.random.RandomState(0).randint(0, 256, (37, 29, 3), np.uint8)
        hdr, body = _post(f"{base}/denoise", _png(arr))
        assert hdr["Content-Type"] == "image/png"
        out = np.asarray(Image.open(io.BytesIO(body)))
        y = fn(arr.astype(np.float32) / 255.0 * 2.0 - 1.0)
        np.testing.assert_array_equal(
            out, np.clip((y + 1.0) * 0.5 * 255.0 + 0.5, 0, 255).astype(np.uint8))
        hdr, body = _post(f"{base}/denoise", arr.tobytes(), {
            "Content-Type": "application/octet-stream", "X-Shape": "37,29,3",
            "Accept": "application/octet-stream"})
        assert hdr["X-Shape"] == "37,29,3"
        np.testing.assert_array_equal(np.frombuffer(body, np.uint8).reshape(arr.shape), out)
        for data, headers in [(b"not an image", {}),
                              (arr.tobytes()[:-1], {"Content-Type": "application/octet-stream",
                                                    "X-Shape": "37,29,3"})]:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{base}/denoise", data, headers)
            assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert e.value.code == 404
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert [37, 29, 3] in health["shapes_compiled"] and health["latency"]["n"] == 2
    finally:
        server.shutdown()


def test_serve_dynamic_batching_coalesces(tmp_path):
    ck = _port_checkpoint(tmp_path)
    single = denoise_cli.build_denoiser(ck, base_filters=4, device="cpu")
    service = serve.BatchingDenoiseService(
        denoise_cli.build_denoiser(ck, base_filters=4, batched=True, device="cpu"),
        max_batch=4, max_wait_ms=200.0)
    server, base = _serve(service)
    try:
        arrs = [np.random.RandomState(i).randint(0, 256, (24, 24, 3), np.uint8) for i in range(6)]
        results = [None] * 6

        def fire(i):
            results[i] = _post(f"{base}/denoise", arrs[i].tobytes(), {
                "Content-Type": "application/octet-stream", "X-Shape": "24,24,3",
                "Accept": "application/octet-stream"})[1]

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for a, body in zip(arrs, results):
            y = single(a.astype(np.float32) / 255.0 * 2.0 - 1.0)
            want = np.clip((y + 1.0) * 0.5 * 255.0 + 0.5, 0, 255).astype(np.uint8)
            got = np.frombuffer(body, np.uint8).reshape(a.shape)
            assert np.abs(got.astype(int) - want).max() <= 1
        assert service.stats["requests"] == 6 and service.stats["batches"] < 6
    finally:
        server.shutdown()
        service.close()


def test_entry_points_need_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    ck = _port_checkpoint(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        denoise_cli.build_apply(ck, base_filters=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        denoise_cli.build_denoiser(ck, base_filters=4, batched=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--checkpoint", ck, "--base-filters", "4"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        denoise_cli.build_apply(ck, arch="diffusion", base_filters=4)
    with pytest.raises(KeyError, match="unet."):  # a supervised RDUNet checkpoint
        denoise_cli.build_apply(ck, arch="diffusion", base_filters=4, device="cpu")


def test_denoise_cli_main_writes_image(tmp_path):
    from PIL import Image

    ck = _port_checkpoint(tmp_path)
    arr = np.random.RandomState(3).randint(0, 256, (20, 13, 3), np.uint8)
    Image.fromarray(arr).save(tmp_path / "noisy.png")
    denoise_cli.main(["--checkpoint", ck, "--base-filters", "4", "--device", "cpu",
                      "--input", str(tmp_path / "noisy.png"),
                      "--output", str(tmp_path / "clean.png")])
    out = np.asarray(Image.open(tmp_path / "clean.png"))
    y = denoise_cli.build_denoiser(ck, base_filters=4, device="cpu")(
        arr.astype(np.float32) / 255.0 * 2.0 - 1.0)
    np.testing.assert_array_equal(
        out, np.clip((y + 1.0) * 0.5 * 255.0 + 0.5, 0, 255).astype(np.uint8))


def test_port_imports_no_jax():
    """The port and chip_smoke.py import neither jax/flax nor the JAX package."""
    files = sorted((REPO / "vub_image_denoising_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    banned = ("jax", "jaxlib", "flax", "optax", "vub_image_denoising_tpu")
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{f}: imports {name}"
