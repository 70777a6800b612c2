"""The port's evaluation (metrics, SIDD validation, the Kaggle submission,
the inference engines) against the JAX package's, on the CPU.

The cases of tests/test_metrics.py, tests/test_sidd_eval.py and the engine
choice of the inference CLIs, and the two packages held to each other:
metrics on the same arrays to rtol 1e-6; ``sidd_cli validate`` of both on
one checkpoint (written by JAX's ``save_pth``) and one synthetic ``.mat``
pair, per engine: the same blocks in the same order, per-block PSNR within
0.01 dB and SSIM within 1e-4, ``avg_psnr`` within 0.05 dB (the BASELINE
budget), the CSVs field by field; the submission with an identity sampler
byte for byte, and through the model within one level of 255 per pixel
(truncation can flip a level on a 1e-6 difference).  A tiny RDUNetT (base
4) at T = 2 on 32x32 blocks; JAX compiles at XLA's lowest optimization
level."""

import csv
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch
from scipy.ndimage import uniform_filter

from test_torch_rdunet import numpy_params, one_thread  # noqa: F401 — autouse
from vub_image_denoising_tpu.eval import metrics as jmetrics
from vub_image_denoising_tpu.eval import sidd as jsidd
from vub_image_denoising_tpu.eval import sidd_cli as jsidd_cli
from vub_image_denoising_tpu.models.rdunet import RDUNetT as JRDUNetT
from vub_image_denoising_tpu.utils import checkpoint as jckpt
from vub_image_denoising_tpu_torch.eval import denoise_cli, metrics, sidd, sidd_cli
from vub_image_denoising_tpu_torch.ops import fused_block as fb

BASE, T = 4, 2
METRIC_RTOL = 1e-6


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def no_jax_opt():
    """The JAX samplers jit their own functions: compile them with XLA's
    optimizations off, as tests/test_torch_diffusion_serve.py does."""
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A seeded RDUNetT-4 checkpoint written by JAX's ``save_pth`` with
    ``unet.`` keys, and a (1, 4, 32, 32, 3) validation pair and benchmark
    file in the SIDD files' keys."""
    d = tmp_path_factory.mktemp("sidd")
    unet = JRDUNetT(base_filters=BASE)
    model = types.SimpleNamespace(init=lambda k, x: unet.init(k, x, jnp.zeros((1,))))
    params = numpy_params(model, jnp.zeros((1, 32, 32, 3)), seed=3)
    ck = str(d / "ck.pth")
    jckpt.save_pth(ck, params, epoch=1, prefix="unet.")
    rng = np.random.RandomState(0)
    gt = rng.randint(0, 256, (1, 4, 32, 32, 3), np.uint8)
    noisy = np.clip(gt + rng.normal(scale=10, size=gt.shape), 0, 255).astype(np.uint8)
    paths = {f"{k}_mat": str(d / f"{k}.mat") for k in ("noisy", "gt", "bench")}
    scipy.io.savemat(paths["noisy_mat"], {"ValidationNoisyBlocksSrgb": noisy})
    scipy.io.savemat(paths["gt_mat"], {"ValidationGtBlocksSrgb": gt})
    scipy.io.savemat(paths["bench_mat"], {"BenchmarkNoisyBlocksSrgb": noisy})
    return types.SimpleNamespace(ck=ck, noisy_u8=noisy, gt_u8=gt, **paths)


def read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


# ---------------------------------------------------------------------------
# metrics (tests/test_metrics.py)
# ---------------------------------------------------------------------------

def test_psnr_golden():
    a = torch.zeros(1, 8, 8, 3)
    b = torch.full((1, 8, 8, 3), 0.1)
    # mse = 0.01 -> psnr = 10*log10(1/0.01) = 20
    np.testing.assert_allclose(float(metrics.psnr(a, b, 1.0)), 20.0, rtol=1e-5)
    # data_range=2 convention (evaluate_SIDD.py:63): 10*log10(4/0.01)
    np.testing.assert_allclose(float(metrics.psnr(a, b, 2.0)), 10 * np.log10(400), rtol=1e-5)


def _ssim_skimage_numpy(x, y, data_range, win=7, k1=0.01, k2=0.03):
    """skimage.metrics.structural_similarity's defaults, per channel (the
    replica of tests/test_metrics.py)."""
    pad = (win - 1) // 2
    np_ = win * win
    cov_norm = np_ / (np_ - 1)
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    vals = []
    for c in range(x.shape[-1]):
        xc, yc = x[..., c], y[..., c]
        f = lambda im: uniform_filter(im, size=win)  # noqa: E731
        ux, uy = f(xc), f(yc)
        vx = cov_norm * (f(xc * xc) - ux * ux)
        vy = cov_norm * (f(yc * yc) - uy * uy)
        vxy = cov_norm * (f(xc * yc) - ux * uy)
        s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
        vals.append(s[pad:-pad, pad:-pad].mean())
    return float(np.mean(vals))


def test_ssim_ref_identity():
    x = t(np.random.RandomState(0).rand(1, 32, 32, 3).astype(np.float32))
    np.testing.assert_allclose(float(metrics.ssim_ref(x, x, 1.0)), 1.0, atol=1e-6)


def test_ssim_ref_matches_skimage_algorithm():
    rng = np.random.RandomState(1)
    x = (rng.rand(40, 40, 3) * 2 - 1).astype(np.float64)
    y = np.clip(x + 0.2 * rng.randn(40, 40, 3), -1, 1)
    got = float(metrics.ssim_ref(t(x.astype(np.float32)), t(y.astype(np.float32)), 2.0))
    np.testing.assert_allclose(got, _ssim_skimage_numpy(x, y, data_range=2.0), rtol=2e-3)


def test_psnr_batch_is_mean_of_per_image():
    rng = np.random.RandomState(2)
    a = t(rng.rand(4, 16, 16, 3).astype(np.float32))
    b = t(rng.rand(4, 16, 16, 3).astype(np.float32))
    singles = np.mean([float(metrics.psnr(a[i], b[i], 1.0)) for i in range(4)])
    np.testing.assert_allclose(float(metrics.psnr(a, b, 1.0)), singles, rtol=1e-5)
    per = metrics.ssim_ref_per_image(a, b, 1.0)
    np.testing.assert_allclose(float(metrics.ssim_ref(a, b, 1.0)), float(per.mean()), rtol=1e-6)


@pytest.mark.parametrize("name", ["psnr", "psnr_per_image", "ssim_ref", "ssim_ref_per_image"])
def test_metrics_match_jax(name):
    """Both packages on the same arrays, batched and one (H, W, C) image."""
    rng = np.random.RandomState(1)
    x = (rng.rand(3, 40, 40, 3) * 2 - 1).astype(np.float32)
    y = np.clip(x + 0.2 * rng.randn(*x.shape), -1, 1).astype(np.float32)
    for a, b in ((x, y), (x[0], y[0])):
        want = np.asarray(getattr(jmetrics, name)(jnp.asarray(a), jnp.asarray(b), 2.0))
        got = getattr(metrics, name)(t(a), t(b), 2.0)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), want, rtol=METRIC_RTOL)


# ---------------------------------------------------------------------------
# SIDD blocks, validation and submission (tests/test_sidd_eval.py)
# ---------------------------------------------------------------------------

def test_mat_blocks_indexing(files):
    blocks = sidd.SIDDMatBlocks(files.noisy_mat, files.gt_mat)
    assert len(blocks) == 4 and blocks.n_images == 1 and blocks.n_patches == 4
    n0, g0 = blocks[3]
    np.testing.assert_array_equal(n0, files.noisy_u8[0, 3])
    np.testing.assert_array_equal(g0, files.gt_u8[0, 3])
    bench = sidd.SIDDMatBlocks(files.bench_mat, None, noisy_key="BenchmarkNoisyBlocksSrgb")
    assert bench.gt is None and bench[2].shape == (32, 32, 3)


def test_evaluate_sidd_identity_sampler_csv_as_jax(files, tmp_path):
    """The identity sampler: the same PSNR/SSIM as JAX's, the CSV in pandas'
    layout (header, column order, ``repr`` floats, ``\\n`` line ends)."""
    port_csv, jax_csv = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    res = sidd.evaluate_sidd(lambda x: x, sidd.SIDDMatBlocks(files.noisy_mat, files.gt_mat),
                             evaluation_percentage=1.0, batch_size=3, csv_path=port_csv,
                             device="cpu")
    want = jsidd.evaluate_sidd(lambda x: x, jsidd.SIDDMatBlocks(files.noisy_mat, files.gt_mat),
                               evaluation_percentage=1.0, batch_size=3, csv_path=jax_csv)
    assert res["n_blocks"] == want["n_blocks"] == 4
    assert 24 < res["avg_psnr"] < 32 and 0 < res["avg_ssim"] <= 1
    np.testing.assert_allclose(res["avg_psnr"], want["avg_psnr"], rtol=METRIC_RTOL)
    np.testing.assert_allclose(res["avg_ssim"], want["avg_ssim"], rtol=METRIC_RTOL)
    assert set(res) == set(want)
    got, ref = read_csv(port_csv), read_csv(jax_csv)
    assert got[0] == ref[0] == ["Method", "MACs (G)", "Inference Time (ms)", "PSNR", "SSIM"]
    assert got[1][:2] == ref[1][:2] and float(got[1][3]) == res["avg_psnr"]
    assert got[1][3] == repr(res["avg_psnr"]) and got[1][4] == repr(res["avg_ssim"])
    with open(port_csv, "rb") as f:
        assert b"\r" not in f.read()


def test_base64_roundtrip():
    x = np.random.RandomState(0).randint(0, 256, (8, 8, 3), np.uint8)
    s = sidd.array_to_base64string(x)
    assert s == jsidd.array_to_base64string(x)
    np.testing.assert_array_equal(sidd.base64string_to_array(s, np.uint8, (8, 8, 3)), x)


def test_kaggle_submission_identity_matches_jax_bytes(files, tmp_path):
    port_csv, jax_csv = tmp_path / "port.csv", tmp_path / "jax.csv"
    sidd.make_kaggle_submission(lambda x: x, files.bench_mat, str(port_csv), batch_size=3,
                                device="cpu")
    jsidd.make_kaggle_submission(lambda x: x, files.bench_mat, str(jax_csv), batch_size=3)
    assert port_csv.read_bytes() == jax_csv.read_bytes()
    rows = read_csv(port_csv)
    assert rows[0] == ["ID", "BLOCK"] and len(rows) == 5
    dec = sidd.base64string_to_array(rows[1][1], np.uint8, (32, 32, 3))
    # normalize and denormalize lose at most the level that truncation drops
    assert np.abs(dec.astype(int) - files.noisy_u8[0, 0].astype(int)).max() <= 1


def test_kaggle_submission_model_within_one_level(files, tmp_path, no_jax_opt):
    port_csv, jax_csv = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    sidd_cli.main(["benchmark", "--checkpoint", files.ck, "--benchmark-mat", files.bench_mat,
                   "--output", port_csv, "--base-filters", str(BASE), "--timesteps", str(T),
                   "--batch-size", "4", "--device", "cpu"])
    with jax.default_matmul_precision("highest"):
        jsidd_cli.main(["benchmark", "--checkpoint", files.ck, "--benchmark-mat", files.bench_mat,
                        "--output", jax_csv, "--base-filters", str(BASE), "--timesteps", str(T),
                        "--batch-size", "4"])
    got, want = read_csv(port_csv), read_csv(jax_csv)
    assert got[0] == want[0] and [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got[1:], want[1:]):
        a = sidd.base64string_to_array(g[1], np.uint8, (32, 32, 3)).astype(int)
        b = sidd.base64string_to_array(w[1], np.uint8, (32, 32, 3)).astype(int)
        assert np.abs(a - b).max() <= 1


def _recording(module, calls, monkeypatch):
    """Wrap ``module.load_sampler`` so each sampler call's input and output
    are kept, as numpy arrays."""
    real = module.load_sampler

    def load(*args, **kwargs):
        sampler = real(*args, **kwargs)

        def record(x):
            y = sampler(x)
            calls.append((np.asarray(x), np.asarray(y)))
            return y
        return record

    monkeypatch.setattr(module, "load_sampler", load)


@pytest.mark.parametrize("engine", ["flax", "xla", "pallas"])
def test_sidd_cli_validate_matches_jax(files, tmp_path, monkeypatch, no_jax_opt, engine):
    """Both packages' ``validate`` on one checkpoint and .mat pair, f32, all
    blocks in a seeded order in batches of 2 (one shape: one JAX compile):
    the same blocks in the same order, per block PSNR within 0.01 dB and
    SSIM within 1e-4, the averages and CSVs within the same bounds."""
    port_calls, jax_calls = [], []
    _recording(sidd_cli, port_calls, monkeypatch)
    _recording(jsidd_cli, jax_calls, monkeypatch)
    common = ["validate", "--checkpoint", files.ck, "--noisy-mat", files.noisy_mat,
              "--gt-mat", files.gt_mat, "--base-filters", str(BASE), "--timesteps", str(T),
              "--evaluation-percentage", "1.0", "--batch-size", "2", "--engine", engine]
    port_csv, jax_csv = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    before = fb.fused_denoising_block.launches
    res = sidd_cli.main(common + ["--csv", port_csv, "--device", "cpu"])
    assert fb.fused_denoising_block.launches == before  # the CPU runs the plain block
    with jax.default_matmul_precision("highest"):
        want = jsidd_cli.main(common + ["--csv", jax_csv])

    assert res["n_blocks"] == want["n_blocks"] == 4
    # the calls: one warm-up, the batches in order, two for the device time
    assert len(port_calls) == len(jax_calls) == 1 + 2 + 2
    loop_p, loop_j = port_calls[1:3], jax_calls[1:3]
    for (xp, _), (xj, _) in zip(loop_p, loop_j):
        np.testing.assert_array_equal(xp, xj)  # the same blocks, normalized alike
    idx = np.random.RandomState(0).choice(4, 4, replace=False)
    gt = sidd._normalize_blocks(files.gt_u8[0, idx])
    np.testing.assert_array_equal(np.concatenate([x for x, _ in loop_p]),
                                  sidd._normalize_blocks(files.noisy_u8[0, idx]))
    out_p = np.concatenate([y for _, y in loop_p])
    out_j = np.concatenate([y for _, y in loop_j])
    psnr_p = metrics.psnr_per_image(t(gt), t(out_p), 2.0).numpy()
    psnr_j = metrics.psnr_per_image(t(gt), t(out_j), 2.0).numpy()
    np.testing.assert_allclose(psnr_p, psnr_j, atol=0.01)
    np.testing.assert_allclose(metrics.ssim_ref_per_image(t(gt), t(out_p), 2.0).numpy(),
                               metrics.ssim_ref_per_image(t(gt), t(out_j), 2.0).numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(res["avg_psnr"], float(np.mean(psnr_p)), rtol=METRIC_RTOL)
    assert abs(res["avg_psnr"] - want["avg_psnr"]) < 0.05
    assert abs(res["avg_ssim"] - want["avg_ssim"]) < 1e-4
    got, ref = read_csv(port_csv), read_csv(jax_csv)
    assert got[0] == ref[0] and got[1][:2] == ref[1][:2]
    assert float(got[1][2]) > 0
    assert abs(float(got[1][3]) - float(ref[1][3])) < 0.05
    assert abs(float(got[1][4]) - float(ref[1][4])) < 1e-4


# ---------------------------------------------------------------------------
# the engines of the inference CLIs (denoise_cli, serve, sidd_cli)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["auto", "xla", "pallas"])
def test_build_apply_engines_match_flax(files, engine):
    """Every engine computes the module path's sampler (to the f32 model
    tolerance, 2T forwards deep)."""
    x = t(sidd._normalize_blocks(files.noisy_u8[0, :2]))
    want, _ = denoise_cli.build_apply(files.ck, "diffusion", BASE, T, engine="flax",
                                      device="cpu")
    got, _ = denoise_cli.build_apply(files.ck, "diffusion", BASE, T, engine=engine,
                                     device="cpu")
    torch.testing.assert_close(got(x), want(x), rtol=1e-4, atol=2 * T * 2e-4)


def test_engine_flag_in_every_inference_cli(files, monkeypatch):
    """``--engine`` reaches ``build_denoiser``/``build_apply`` from denoise_cli,
    serve and sidd_cli (``--fused`` is ``pallas``); an unknown engine is
    refused."""
    from vub_image_denoising_tpu_torch.eval import serve

    seen = []

    def fake(*args, engine="auto", **kwargs):
        seen.append(engine)
        raise SystemExit(0)

    monkeypatch.setattr(denoise_cli, "build_denoiser", fake)
    monkeypatch.setattr(serve, "build_denoiser", fake)
    monkeypatch.setattr(sidd_cli, "build_apply", fake)
    for main, argv in ((denoise_cli.main, ["--checkpoint", files.ck, "--input", "x.png"]),
                       (serve.main, ["--checkpoint", files.ck]),
                       (sidd_cli.main, ["validate", "--checkpoint", files.ck, "--noisy-mat",
                                        files.noisy_mat, "--gt-mat", files.gt_mat])):
        for extra in (["--engine", "xla"], []):
            with pytest.raises(SystemExit):
                main(argv + extra + ["--device", "cpu"])
        with pytest.raises(SystemExit):
            main(argv + ["--engine", "tpu"])
    with pytest.raises(SystemExit):
        sidd_cli.main(["validate", "--checkpoint", files.ck, "--noisy-mat", files.noisy_mat,
                       "--gt-mat", files.gt_mat, "--fused", "--device", "cpu"])
    assert seen == ["xla", "auto"] * 3 + ["pallas"]
    with pytest.raises(ValueError, match="unknown engine"):
        denoise_cli.build_apply(files.ck, "diffusion", BASE, T, engine="tpu", device="cpu")


def test_sidd_cli_needs_cuda_unless_cpu_is_asked(files, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sidd_cli.main(["validate", "--checkpoint", files.ck, "--noisy-mat", files.noisy_mat,
                       "--gt-mat", files.gt_mat, "--base-filters", str(BASE)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sidd_cli.main(["benchmark", "--checkpoint", files.ck, "--benchmark-mat", files.bench_mat,
                       "--base-filters", str(BASE), "--output", str(tmp_path / "s.csv")])
    with pytest.raises(FileNotFoundError, match="download it from"):
        sidd_cli.main(["benchmark", "--checkpoint", files.ck, "--benchmark-mat",
                       str(tmp_path / "missing.mat"), "--device", "cpu"])


def test_pallas_engine_builds_kernel_weights_once(files, monkeypatch):
    """On the "pallas" engine the block kernels' weights are built once per
    load (``build_apply``) and once per optimizer step and per ``validate``
    (the trainers), and every block launch gets its block's entry of the
    latest build.  The CPU's plain block reads the params instead, so
    ``block_kernel_weights`` is replaced by a stand-in that hands out
    markers, and the launches are recorded."""
    from vub_image_denoising_tpu_torch.models import RDUNet
    from vub_image_denoising_tpu_torch.models import fused_apply as fa
    from vub_image_denoising_tpu_torch.train import diffusion as dtrain
    from vub_image_denoising_tpu_torch.train import supervised

    builds, launches = [], []

    def build(variables, dtype):
        builds.append(dtype)
        return {name: (len(builds), name) for name in fa._DENSE_BLOCKS}

    def launch(x, params, kernel_weights):
        launches.append(kernel_weights)
        return fb.fused_denoising_block_plain(x, params)

    for module in (denoise_cli, supervised, dtrain):
        monkeypatch.setattr(module, "block_kernel_weights", build)
    monkeypatch.setattr(fa, "fused_denoising_block", launch)

    def check(n_builds, per_build):
        assert len(builds) == n_builds
        for b in range(n_builds):
            got = launches[b * per_build:(b + 1) * per_build]
            assert [k[0] for k in got] == [b + 1] * per_build
            assert sorted({k[1] for k in got}) == sorted(fa._DENSE_BLOCKS)
        builds.clear()
        launches.clear()

    forward, _ = denoise_cli.build_apply(files.ck, "diffusion", BASE, T, engine="pallas",
                                         device="cpu")
    x = t(sidd._normalize_blocks(files.noisy_u8[0, :2]))
    forward(x)
    forward(x)
    assert len(builds) == 1 and len(launches) == 2 * 14 * T
    check(1, 2 * 14 * T)

    g = torch.Generator().manual_seed(0)
    batch = [torch.rand(4, 3, 16, 16, generator=g) * 2 - 1 for _ in range(2)]
    trainer = supervised.SupervisedTrainer(RDUNet(3, BASE, generator=g), engine="pallas",
                                           accumulation_steps=2, device="cpu")
    state = trainer.init(steps_per_epoch=2)
    for _ in range(2):
        state, _ = trainer.train_step(state, *batch)
    check(2, 2 * 14)  # two micro-batches share each step's build

    dtrainer = dtrain.DiffusionTrainer(base_filters=BASE, timesteps=T, engine="pallas",
                                       accumulation_steps=2, device="cpu")
    dstate = dtrainer.init(steps_per_epoch=1)
    dstate, _ = dtrainer.train_step(dstate, *batch)
    dtrainer.validate(dstate, [batch])
    check(2, 2 * 14)  # the step's two micro-batches, then validate's T forwards
