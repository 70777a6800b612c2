"""The port's comparative suite against the JAX package's, on the CPU:
LPIPS and DISTS (``eval/perceptual.py``), the native BM3D
(``ops/bm3d.py``), the figure library (``eval/plots.py``), the compare
runner (``eval/compare.py``), ``data/loader.py::plot_examples`` and the
RCA-GAN critic's reference-layout load.

- LPIPS and DISTS on the same synthetic weights (a JAX parameter tree
  carried across with ``params_to_state_dict``, loaded strictly) equal
  JAX's to 1e-5 at 64x64 and read 0 on identical inputs; the loaders read
  torchvision-layout files (tests/test_perceptual_loaders.py's fixtures).
- BM3D equals JAX's bit for bit (the same numpy code).
- The runner's metric table on one pair of checkpoints (written by the JAX
  package) and the same batches equals JAX's: PSNR within 1e-3 dB, SSIM,
  LPIPS and DISTS within 1e-5 (BM3D's too: its arrays are equal bit for
  bit, its metrics differ by f32 rounding); neither package draws its
  figures there (``plots`` stubbed: the port's are drawn by
  ``test_plots_smoke``, at 20 dpi (``low_dpi``), since the figures' 300 dpi
  took most of a minute to render here).

Sizes: base 4, T = 2, 32x32 batches of 2 for the runner (as
tests/test_search_and_eval.py::test_compare_runner_end_to_end); JAX
compiles with most XLA optimisations off, at HIGHEST precision."""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_rdunet import numpy_params, one_thread  # noqa: F401 — an autouse fixture
from vub_image_denoising_tpu import enable_strict_precision as jax_strict
from vub_image_denoising_tpu.eval import compare as jcompare
from vub_image_denoising_tpu.eval import perceptual as jperc
from vub_image_denoising_tpu.ops import bm3d as jbm3d
from vub_image_denoising_tpu_torch.data.loader import plot_examples
from vub_image_denoising_tpu_torch.eval import compare, perceptual, plots
from vub_image_denoising_tpu_torch.models import RDUNet, RDUNetT
from vub_image_denoising_tpu_torch.models.rca_gan import Discriminator, fc1_nchw_to_nhwc
from vub_image_denoising_tpu_torch.ops import bm3d
from vub_image_denoising_tpu_torch.utils import checkpoint as ckpt
from vub_image_denoising_tpu_torch.utils.checkpoint import params_to_state_dict


@pytest.fixture
def no_jax_opt():
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    jax_strict()
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.fixture
def low_dpi(monkeypatch):
    """Figures drawn in full and saved at 20 dpi."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    save = plt.savefig
    monkeypatch.setattr(plt, "savefig", lambda *a, **k: save(*a, **{**k, "dpi": 20}))


@pytest.mark.parametrize("name", ["LPIPS", "DISTS"])
def test_perceptual_metric_matches_jax(name, no_jax_opt):
    """The same weights (JAX's tree, carried across and loaded strictly) and
    inputs at 64x64: the port's distances equal JAX's to 1e-5; identical
    inputs read 0 in both."""
    rng = np.random.RandomState(7)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    y = np.clip(x + 0.3 * rng.randn(*x.shape), -1, 1).astype(np.float32)
    jmodel = getattr(jperc, name)()
    variables = numpy_params(SimpleNamespace(init=lambda k, a: jmodel.init(k, a, a)), x, seed=1)
    model = getattr(perceptual, name)()
    model.load_state_dict(params_to_state_dict(variables), strict=True)
    apply = jax.jit(jmodel.apply)
    with jax.default_matmul_precision("highest"), torch.no_grad():
        for a, b in ((x, y), (x, x)):
            want = np.asarray(apply(variables, a, b))
            got = model(nchw(a), nchw(b)).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert float(np.abs(model(nchw(x), nchw(x)).numpy()).max()) < 1e-5


def _conv_sd(rng, entries):
    """{features.i: (cin, cout, k)} -> a torchvision-style state_dict."""
    sd = {}
    for i, (cin, cout, k) in entries.items():
        sd[f"features.{i}.weight"] = torch.tensor(
            rng.randn(cout, cin, k, k).astype(np.float32) * 0.05)
        sd[f"features.{i}.bias"] = torch.tensor(rng.randn(cout).astype(np.float32) * 0.05)
    return sd


@pytest.fixture
def weight_files(tmp_path, monkeypatch):
    """Synthetic files in the original packages' layouts (torchvision
    alexnet/vgg16 ``features.{i}``, lpips ``lin{i}.model.1.weight``, DISTS
    ``alpha``/``beta``), found through the environment as users give them."""
    rng = np.random.RandomState(3)
    alex = _conv_sd(rng, {0: (3, 64, 11), 3: (64, 192, 5), 6: (192, 384, 3),
                          8: (384, 256, 3), 10: (256, 256, 3)})
    lins = {f"lin{i}.model.1.weight": torch.tensor(rng.rand(1, c, 1, 1).astype(np.float32))
            for i, c in enumerate(perceptual._LPIPS_CHANNELS)}
    cfg = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 256),
           (256, 512), (512, 512), (512, 512), (512, 512), (512, 512), (512, 512)]
    vgg = _conv_sd(rng, {i: (a, b, 3) for i, (a, b) in zip(perceptual._VGG16_CONVS, cfg)})
    total = sum(perceptual._DISTS_CHANNELS)
    dists = {k: torch.tensor(rng.rand(1, total, 1, 1).astype(np.float32))
             for k in ("alpha", "beta")}
    paths = {}
    for name, sd in (("alex", alex), ("lins", lins), ("vgg16", vgg), ("dists", dists)):
        paths[name] = str(tmp_path / f"{name}.pth")
        torch.save(sd, paths[name])
    monkeypatch.setenv("ALEXNET_WEIGHTS", paths["alex"])
    monkeypatch.setenv("VGG16_WEIGHTS", paths["vgg16"])
    monkeypatch.setenv("DISTS_WEIGHTS", paths["dists"])
    return {"paths": paths, "alex": alex, "lins": lins, "vgg16": vgg, "dists": dists}


def test_loaders_read_the_original_layouts(weight_files):
    """Every tensor of the files lands where the original packages use it;
    without a file the loaders return None and the seeded weights stay."""
    lp = perceptual.LPIPS()
    assert perceptual.load_lpips_torch(lp, weight_files["paths"]["lins"]) is lp
    for i, j in enumerate(perceptual._ALEXNET_CONVS):
        assert torch.equal(getattr(lp.backbone, f"conv{i}").weight,
                           weight_files["alex"][f"features.{j}.weight"])
    assert torch.equal(lp.lin2, weight_files["lins"]["lin2.model.1.weight"].reshape(-1))
    ds = perceptual.DISTS()
    assert perceptual.load_dists_torch(ds) is ds
    assert torch.equal(ds.backbone.conv12.bias, weight_files["vgg16"]["features.28.bias"])
    assert torch.equal(ds.beta1, weight_files["dists"]["beta"].reshape(-1)[3:67])
    assert perceptual.load_lpips_torch(perceptual.LPIPS(), "missing.pth") is None
    a = perceptual.make_lpips(seed=4, weights_path="missing.pth", device="cpu")[1]
    b = perceptual.LPIPS(generator=torch.Generator().manual_seed(4))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k


def test_bm3d_equals_jax_bit_for_bit():
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:32, 0:32]
    img = np.clip(0.3 + 0.4 * xx / 32 + 0.3 * ((yy - 14) ** 2 + (xx - 12) ** 2 < 60), 0, 1)
    noisy = np.clip(img + rng.normal(scale=30 / 255, size=img.shape), 0, 1).astype(np.float32)
    for stage in (bm3d.BM3DStages.HARD_THRESHOLDING, bm3d.BM3DStages.ALL_STAGES):
        got = bm3d.bm3d(noisy, 30 / 255, stage_arg=stage)
        want = jbm3d.bm3d(noisy, 30 / 255, stage_arg=stage)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError):
        bm3d.bm3d(np.zeros((8, 8), np.float32), 0.1)


FIGURE_CALLS = ["save_heatmaps", "save_example_images", "save_histograms_of_differences",
                "save_frequency_domain_analysis",
                "save_frequency_domain_analysis_multiple_epochs", "plot_psd_comparison",
                "save_dists", "save_inference_time_plot", "generate_comparison_plot",
                "save_metrics"]
FIGURES = ["metrics.png", "dists.png", "comparison_plot_with_zones_and_arrows.png",
           "high_frequency_domain_analysis.png",
           "high_frequency_domain_analysis_multiple_epochs.png",
           "inference_time_comparison.png", "heatmaps.png", "example_images_comparison.png",
           "histograms_of_differences.png", "error_map.png"]


def test_plots_smoke(tmp_path, low_dpi):
    """All 11 figures of the library (tests/test_search_and_eval.py's)."""
    rng = np.random.RandomState(0)
    n = 24
    imgs = [rng.rand(32, 32, 3).astype(np.float32) for _ in range(n)]
    metrics = {"epoch": [40] * (n // 2) + [43] * (n // 2),
               "noise_level": list(np.tile([15, 30, 50], n // 3)),
               "gt_image": imgs, "degraded_image": imgs, "predicted_unet_image": imgs,
               "predicted_diffusion_image": imgs}
    for k in compare.KEYS:
        for v in compare.VARIANTS:
            metrics[f"{k}_{v}"] = list(rng.rand(n))
    d = str(tmp_path)
    plots.save_metrics(metrics, 43, use_bm3d=True, save_dir=d)
    plots.save_dists(metrics, 43, save_dir=d)
    plots.generate_comparison_plot(metrics, [40, 43], save_dir=d, use_bm3d=True)
    plots.save_frequency_domain_analysis(metrics, 43, save_dir=d)
    plots.save_frequency_domain_analysis_multiple_epochs(metrics, [40, 43], save_dir=d)
    plots.plot_psd_comparison(metrics, 43, save_dir=d)
    plots.save_inference_time_plot({"unet": [0.1], "diffusion": [1.0]}, save_dir=d)
    plots.save_heatmaps(imgs[0], imgs[1], save_dir=d)
    plots.save_example_images({15: (imgs[0], imgs[1], imgs[2], imgs[3])}, save_dir=d,
                              noise_levels_to_plot=(15,))
    plots.save_histograms_of_differences({(43, 15): (imgs[0], imgs[1], imgs[2], imgs[3])}, 43,
                                         save_dir=d)
    plots.save_error_map(imgs[0], imgs[1], save_dir=d)
    for name in FIGURES:
        assert os.path.exists(os.path.join(d, name)), name
    assert any(f.startswith("psd_comparison_noise_level_") for f in os.listdir(d))


def jax_metric_from_files(name, load):
    """JAX's ``make_lpips``/``make_dists`` with flax's init skipped (about
    20 s here): every parameter comes from the weight files, so the
    template only names the leaves that the loaders fill."""
    if name == "lpips":
        convs, heads = perceptual._ALEXNET_CONVS, {f"lin{i}": np.zeros(c, np.float32)
                                                   for i, c in
                                                   enumerate(perceptual._LPIPS_CHANNELS)}
    else:
        convs, heads = perceptual._VGG16_CONVS, {f"{k}{i}": np.zeros(c, np.float32)
                                                 for k in ("alpha", "beta")
                                                 for i, c in
                                                 enumerate(perceptual._DISTS_CHANNELS)}
    template = {"params": {"backbone": {f"conv{i}": {"kernel": None, "bias": None}
                                        for i in range(len(convs))}, **heads}}

    def make(key=None, weights_path=None):
        model = getattr(jperc, name.upper())()
        params = load(template, weights_path)
        return jax.jit(lambda a, b: model.apply(params, a, b)), params

    return make


def test_compare_runner_matches_jax(tmp_path, weight_files, no_jax_opt, monkeypatch):
    """One RDUNet and one RDUNetT checkpoint (reference layout, loaded by
    both packages), two batches at sigma 15 and 30, BM3D on: the port's
    metric table equals JAX's, and the port asks for the ten figures
    ``test_plots_smoke`` draws."""
    rng = np.random.RandomState(0)
    unet_path, diff_path = str(tmp_path / "rdunet.pth"), str(tmp_path / "diff_epoch_1.pth")
    ckpt.save_pth(unet_path, RDUNet(3, 4, generator=torch.Generator().manual_seed(5)).state_dict())
    ckpt.save_pth(diff_path, RDUNetT(4, generator=torch.Generator().manual_seed(6)).state_dict(),
                  epoch=1, prefix="unet.")
    batches = []
    for sigma in (15.0, 30.0):
        gt = rng.rand(2, 32, 32, 3).astype(np.float32) * 2 - 1
        noisy = np.clip(gt + rng.randn(*gt.shape).astype(np.float32) * sigma / 127.5, -1, 1)
        batches.append((noisy, gt, np.full((2,), sigma, np.float32)))
    kwargs = dict(epochs=[1], diffusion_model_paths=[diff_path], unet_model_path=unet_path,
                  include_noise_level=True, use_bm3d=True, timesteps=2, unet_base_filters=4,
                  diffusion_base_filters=4, lpips_weights=weight_files["paths"]["lins"])
    monkeypatch.setattr(jcompare, "plots", SimpleNamespace(
        **{f: (lambda *a, **k: None) for f in dir(plots) if not f.startswith("_")}))
    for name, load in (("lpips", jperc.load_lpips_torch), ("dists", jperc.load_dists_torch)):
        monkeypatch.setattr(jcompare, f"make_{name}", jax_metric_from_files(name, load))
    with jax.default_matmul_precision("highest"):
        want, _ = jcompare.evaluate_model_and_plot(
            val_loader=[tuple(jnp.asarray(a) for a in b) for b in batches],
            save_dir=str(tmp_path / "jax"), **kwargs)
    drawn = []
    monkeypatch.setattr(compare, "plots", SimpleNamespace(
        **{f: (lambda *a, f=f, **k: drawn.append(f)) for f in dir(plots) if f[0] != "_"}))
    got, times = compare.evaluate_model_and_plot(
        val_loader=[(nchw(n), nchw(g), torch.from_numpy(s)) for n, g, s in batches],
        save_dir=str(tmp_path / "port"), device="cpu", **kwargs)
    assert len(times["diffusion"]) == len(times["unet"]) == 2
    for k in compare.KEYS:
        for v in compare.VARIANTS:
            a, b = np.asarray(got[f"{k}_{v}"]), np.asarray(want[f"{k}_{v}"])
            assert a.shape == b.shape == (4,), (k, v)
            if v == "bm3d" and k in ("lpips", "dists"):
                assert np.isnan(a).all() and np.isnan(b).all(), (k, v)
                continue
            assert np.isfinite(a).all(), (k, v)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 if k == "psnr" else 1e-5,
                                       err_msg=f"{k}_{v}")
    assert got["noise_level"] == want["noise_level"] and got["epoch"] == want["epoch"]
    for k in ("gt_image", "predicted_diffusion_image", "predicted_unet_image"):
        np.testing.assert_allclose(np.stack(got[k]), np.stack(want[k]), rtol=0, atol=1e-5)
    assert sorted(drawn) == sorted(FIGURE_CALLS)


def test_plot_examples_writes_its_file(tmp_path, low_dpi):
    gen = torch.Generator().manual_seed(0)
    loader = [(torch.rand(3, 3, 16, 16, generator=gen) * 2 - 1,
               torch.rand(3, 3, 16, 16, generator=gen) * 2 - 1) for _ in range(2)]
    path = plot_examples(loader, num_examples=4, path=str(tmp_path / "examples.png"))
    assert os.path.getsize(path) > 0
    gray = [(torch.rand(2, 1, 16, 16) * 2 - 1, torch.rand(2, 1, 16, 16) * 2 - 1)]
    assert os.path.getsize(plot_examples(gray, 2, str(tmp_path / "gray.png"))) > 0


def test_critic_loads_a_reference_fc1(tmp_path):
    """A critic state_dict in the original reference's layout (fc1 reading
    NCHW-flat features), loaded with ``nchw_flatten=True``, computes what
    the reference computes: its convs, an NCHW flatten, the file's fc1."""
    gen = torch.Generator().manual_seed(0)
    ref = Discriminator(1, input_hw=32, generator=gen).eval()
    sd = {k: v.clone() for k, v in ref.state_dict().items()}
    sd["fc_layers.0.weight"] = torch.randn(sd["fc_layers.0.weight"].shape, generator=gen) * 0.02
    torch.save(sd, tmp_path / "critic.pth")
    x = torch.rand(2, 1, 32, 32, generator=gen) * 2 - 1
    with torch.no_grad():
        h = x
        for blk in ref.conv_layers:
            h = blk(h)
        h = F.linear(h.reshape(2, -1), sd["fc_layers.0.weight"], sd["fc_layers.0.bias"])
        want = F.linear(F.relu(h), sd["fc_layers.2.weight"], sd["fc_layers.2.bias"])
        critic = Discriminator(1, input_hw=32, generator=torch.Generator().manual_seed(1)).eval()
        critic.load_state_dict(torch.load(tmp_path / "critic.pth", weights_only=True),
                               nchw_flatten=True)
        torch.testing.assert_close(critic(x), want, rtol=1e-5, atol=1e-6)
        critic.load_state_dict(sd)  # the default load keeps the file's order
        assert torch.equal(critic.fc_layers[0].weight, sd["fc_layers.0.weight"])
        assert not torch.allclose(critic(x), want, rtol=1e-3, atol=1e-4)
    back = fc1_nchw_to_nhwc(sd)["fc_layers.0.weight"]
    assert back.shape == sd["fc_layers.0.weight"].shape
