"""The port's utils (misc, info, health, prng, profiling, cache, tb) on the
CPU, against the JAX package's where both compute the same thing.

Mirrors tests/test_experimental_and_misc.py (``test_misc_utils``,
``test_model_summary_and_latency``, ``test_probe_device_exec_cpu_and_timeout``)
and tests/test_tiles_and_tb.py (``test_log_activations_captures_feature_maps``,
on an RDUNet: the GANs are not ported yet).  ``model_summary``'s params
equal JAX's; its FLOPs equal the conv count of the model's shapes, and are
within 10% of the JAX package's XLA cost analysis, which counts only the
in-image taps of SAME-padded convs (port / JAX = 1.0344 at 64x64, RDUNet-4)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rdunet import numpy_params, one_thread  # noqa: F401 — autouse
from vub_image_denoising_tpu.models.rdunet import RDUNet as JRDUNet
from vub_image_denoising_tpu.utils import info as jinfo
from vub_image_denoising_tpu.utils import misc as jmisc
from vub_image_denoising_tpu_torch.models import RDUNet, RDUNetT
from vub_image_denoising_tpu_torch.nn.blocks import DenoisingBlock
from vub_image_denoising_tpu_torch.nn.layers import Conv3x3, Downsample2x2, Upsample2x2
from vub_image_denoising_tpu_torch.utils import cache, health, info, misc, prng, profiling, tb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_misc_utils(tmp_path, capsys):
    runs = tmp_path / "runs"
    runs.mkdir()
    (runs / "x.txt").write_text("y")
    misc.clear_runs(str(runs))
    assert not runs.exists()
    misc.clear_runs(str(runs))
    assert "No '" in capsys.readouterr().out

    devices = misc.probe_devices()
    assert devices == [torch.device("cuda", i) for i in range(torch.cuda.device_count())]

    from PIL import Image

    folder = tmp_path / "imgs"
    folder.mkdir()
    Image.fromarray(np.zeros((512, 256, 3), np.uint8)).save(folder / "a.png")
    got = misc.summarize_dataset(str(folder))
    assert got == {"images": 1, "patches": 2, "noise_levels": [15, 25, 50], "samples": 6}
    assert got == jmisc.summarize_dataset(str(folder))

    import scipy.io

    mat = tmp_path / "blocks.mat"
    scipy.io.savemat(str(mat), {"ValidationNoisyBlocksSrgb": np.zeros((1, 1, 4, 4, 3), np.uint8)})
    assert "ValidationNoisyBlocksSrgb" in misc.probe_mat(str(mat))


def conv_flops(model, x):
    """FLOPs (2 per multiply-add) of every conv of ``model(x)``, from the
    shapes each module sees: a DenoisingBlock's four convs at its input's
    size, other 3x3 and stride-2 convs at their output's, the 2x2 conv-T at
    its input's."""
    total = [0]

    def count(mod, inputs, out):
        n, _, h, w = (inputs[0] if isinstance(mod, (DenoisingBlock, Upsample2x2)) else out).shape
        convs = [getattr(mod, f"conv_{i}") for i in range(4)] if isinstance(mod, DenoisingBlock) \
            else [mod]
        total[0] += sum(2 * c.weight.numel() * n * h * w for c in convs)

    blocks = [m for m in model.modules() if isinstance(m, DenoisingBlock)]
    inner = {id(c) for b in blocks for c in b.modules()}  # a block's convs run inside it
    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, DenoisingBlock)
             or (isinstance(m, (Conv3x3, Downsample2x2, Upsample2x2)) and id(m) not in inner)]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return total[0]


def test_model_summary_matches_jax():
    model = RDUNet(3, 4, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.zeros(1, 3, 64, 64)
    s = info.model_summary(model, x)
    assert s["flops"] == conv_flops(model, x)

    jmodel = JRDUNet(channels=3, base_filters=4)
    jx = jnp.zeros((1, 64, 64, 3))
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        want = jinfo.model_summary(jmodel.apply, numpy_params(jmodel, jx, 0), jx)
    finally:
        jax.config.update("jax_disable_most_optimizations", before)
    assert s["params"] == want["params"] == 163838
    assert s["param_bytes"] == want["param_bytes"]
    assert abs(s["flops"] / want["flops"] - 1) < 0.1


def test_model_summary_and_latency():
    model = RDUNet(3, 4, generator=torch.Generator().manual_seed(0)).eval()
    m = info.measure_inference_metrics(model, torch.zeros(1, 3, 16, 16), num_iterations=2)
    assert m["avg_inference_sec"] > 0 and m["num_iterations"] == 2 and m["device"] == "cpu"
    assert "peak_memory_bytes" not in m  # a device measurement: the card only
    assert m["flops"] == info.count_flops(model, torch.zeros(1, 3, 16, 16))
    assert m["mfu"] == m["flops"] / m["avg_inference_sec"] / info.H100_BF16_PEAK_FLOPS


def test_print_info_takes_f32_alone_on_the_cpu():
    """Other activations than f32 are for the card: on the CPU print_info
    refuses them before it builds a model."""
    with pytest.raises(ValueError, match="f32 only"):
        info.print_info(device="cpu", dtype=torch.bfloat16)


def test_sampler_flops_are_t_forwards_of_the_stack():
    """The sampler's count: T forwards of RDUNetT on the 2N stack; the
    elementwise sampler update adds none."""
    unet = RDUNetT(4, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.zeros(2, 3, 16, 16)
    sampler = info.DiffusionSampler(unet, timesteps=3)
    want = 3 * info.count_flops(unet, torch.zeros(4, 3, 16, 16), torch.zeros(4))
    assert info.model_summary(sampler, x)["flops"] == want > 0


def test_probe_device_exec_cpu_and_timeout():
    """The probe reports healthy on a working (CPU) device and comes back
    from a timeout as a clean failure, never a hang."""
    ok, dt, detail = health.probe_device_exec(timeout_s=120.0, platform="cpu")
    assert ok, detail
    assert detail.startswith("EXEC_OK") and float(detail.split()[1]) == 128.0
    # a sub-second timeout cannot fit interpreter start and the torch import
    ok2, dt2, detail2 = health.probe_device_exec(timeout_s=0.5, platform="cpu")
    assert not ok2 and detail2 == "timeout" and dt2 < 30, (dt2, detail2)


def test_probe_device_exec_needs_the_card():
    """Without a card the default probe fails, with the child's error."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py probes it")
    ok, _, detail = health.probe_device_exec(timeout_s=120.0)
    assert not ok and detail and "EXEC_OK" not in detail


def test_key_for_is_stable_across_processes():
    """``key_for`` folds the tag in by CRC-32: two processes with different
    hash seeds draw the same stream (JAX's ``hash(tag)`` would not)."""
    draw = "import torch; from vub_image_denoising_tpu_torch.utils.prng import key_for; " \
           "print(torch.rand(4, generator=key_for(7, 'noise', 3)).tolist())"
    env = dict(os.environ, PYTHONHASHSEED="123")
    out = subprocess.run([sys.executable, "-c", draw], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120, check=True).stdout.strip()
    here = torch.rand(4, generator=prng.key_for(7, "noise", 3))
    assert out == str(here.tolist())
    for other in (prng.key_for(7, "noise", 4), prng.key_for(7, "flip", 3),
                  prng.key_for(8, "noise", 3)):
        assert not torch.equal(torch.rand(4, generator=other), here)
    assert prng.key_for(7, "noise", 3).device.type == "cpu"


def test_profiling(tmp_path):
    assert profiling.force_completion({"b": torch.ones(2), "a": (torch.arange(3.0) + 5,)}) == 5.0
    assert profiling.force_completion(3) == 3
    timer = profiling.StepTimer(pixels_per_step=2e6, window=2)
    assert np.isnan(timer.mp_per_s)
    timer.start()
    for _ in range(3):
        timer.tick(torch.ones(1))
    assert timer.steps == 3 and len(timer.times) == 2
    assert timer.mp_per_s == pytest.approx(2e6 / timer.avg_step_sec / 1e6)
    with profiling.trace(str(tmp_path / "profile")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert any(f.endswith(".json") for _, _, fs in os.walk(tmp_path / "profile") for f in fs)


def test_enable_compilation_cache():
    from vub_image_denoising_tpu_torch.native import BUILD_DIR as native_dir
    from vub_image_denoising_tpu_torch.ops.cuda_build import BUILD_DIR as kernel_dir

    path = cache.enable_compilation_cache()
    assert path == str(kernel_dir.parent) == os.path.join(REPO, "build")
    assert kernel_dir.is_dir() and native_dir.is_dir()


class Recorder:
    def __init__(self):
        self.tags = []

    def add_image(self, tag, img, step, dataformats=None):
        assert img.ndim == 3 and img.shape[-1] == 1 and np.isfinite(img).all()
        assert dataformats == "HWC"
        self.tags.append(tag)


def test_log_activations_captures_feature_maps():
    """Forward hooks on every submodule write one channel-mean heat map grid
    each (reference: paper_gan.py:292-309) and are removed afterwards."""
    model = RDUNet(3, 4, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 3, 16, 16, generator=torch.Generator().manual_seed(1))
    rec = Recorder()
    tags = tb.log_activations(rec, model, x, max_layers=64)
    assert tags and tags == rec.tags
    assert all(t.startswith("debug/") for t in tags)
    assert tags[0] == "debug/" and "debug/block_0_0" in tags and "debug/down_0/conv" in tags
    assert tags == sorted(tags)
    assert all(not m._forward_hooks for m in model.modules())
    assert tb.log_activations(Recorder(), model, x, max_layers=3) == tags[:3]


def test_create_writer_and_fallback(tmp_path, monkeypatch, capsys):
    writer = tb.create_writer(str(tmp_path / "tb"))
    writer.add_scalar("a", 1.0, 0)
    writer.close()
    assert os.listdir(tmp_path / "tb")
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    null = tb.create_writer(str(tmp_path / "none"))
    null.add_scalar("loss", 0.5, 3)
    null.add_image("img", np.zeros((2, 2, 1)), 0)
    assert "[tb] loss=0.5 step=3" in capsys.readouterr().out


def test_start_tensorboard_reports_a_missing_binary(monkeypatch, capsys):
    def missing(*args, **kwargs):
        raise FileNotFoundError("tensorboard")

    monkeypatch.setattr(tb.subprocess, "Popen", missing)
    tb.start_tensorboard("runs")
    assert "Failed to start TensorBoard" in capsys.readouterr().out


def test_port_imports_no_jax_at_run_time():
    """Every module of the port, imported in a fresh interpreter, loads
    neither JAX nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vub_image_denoising_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'vub_image_denoising_tpu')]\n"
        "print(len(names), bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, check=True).stdout.split()
    assert int(out[0]) >= 40 and out[1] == "[]", out
