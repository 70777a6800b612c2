"""The port's data pipeline against the JAX package's, on the CPU.

Random parts are held by handing JAX's draws over: the port's transforms
take ``noise=``, ``flips=`` and ``angles=``.  Noise, normalization, the
datasets, the gathers and the loaders' clean batches must be byte-equal.
Rotation is equal pixel for pixel but for one allowed exception: a pixel
whose f32 source coordinate, as JAX computes it, lies within TIE_TOL of a .5
rounding tie may round the other way (the two libraries' cos/sin may differ
in the last bit); the test counts and prints such pixels.  Patches are 32
(both packages' datasets take ``patch_size``; the loaders' datasets are
swapped for 32-patch ones), images at most 96x80.  The JAX references of
noise and augmentation compile once, at XLA's lowest backend optimization
level; normalization compiles as the JAX package compiles it, and the JAX
loaders normalize their clean batches with it (their noisy half holds JAX's
own draws)."""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rdunet import one_thread  # noqa: F401 — an autouse fixture
from vub_image_denoising_tpu.data import datasets as jds
from vub_image_denoising_tpu.data import device as jdev
from vub_image_denoising_tpu.data import loader as jloader
from vub_image_denoising_tpu_torch import native
from vub_image_denoising_tpu_torch.data import datasets as pds
from vub_image_denoising_tpu_torch.data import device as pdev
from vub_image_denoising_tpu_torch.data import loader as ploader
from vub_image_denoising_tpu_torch.data.resident import DeviceBankLoader

PATCH = 32
TIE_TOL = 1e-4
SIZES = [(96, 80), (64, 64), (40, 70)]  # (width, height): 6 + 4 + 2 patches of 32


def write_pngs(folder, sizes, channels=3, seed=0):
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i, (w, h) in enumerate(sizes):
        arr = rng.randint(0, 256, (h, w, channels), dtype=np.uint8)
        Image.fromarray(arr.squeeze(-1) if channels == 1 else arr).save(
            os.path.join(folder, f"img_{i}.png"))


def write_sidd(root, scenes=("0001_S6", "0002_S6"), size=(96, 64), seed=1):
    """A synthetic SIDD_Medium_Srgb tree: Scene_Instances.txt, Data/<scene>/
    one NOISY and one GT PNG per scene."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    with open(os.path.join(root, "Scene_Instances.txt"), "w") as f:
        f.write("\n".join(scenes) + "\n")
    for s in scenes:
        d = os.path.join(root, "Data", s)
        os.makedirs(d)
        gt = rng.randint(0, 256, (size[1], size[0], 3), dtype=np.uint8)
        noisy = np.clip(gt + rng.randint(-20, 21, gt.shape), 0, 255).astype(np.uint8)
        Image.fromarray(noisy).save(os.path.join(d, f"{s}_NOISY_SRGB_010.png"))
        Image.fromarray(gt).save(os.path.join(d, f"{s}_GT_SRGB_010.png"))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def run_jax(fn, *args):
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return jax.tree_util.tree_map(np.asarray, compiled(*args))


@pytest.fixture(scope="module")
def jax_transforms():
    """JAX's noise, normalization and augmentation on seeded uint8 batches,
    with the draws each function made, from one compiled function."""
    rng = np.random.RandomState(0)
    clean = rng.randint(0, 256, (4, 24, 24, 3)).astype(np.uint8)
    clean[0, :12], clean[1, :12] = 3, 252  # pixels that clip at 0 and 255
    sigmas = np.array([15, 25, 50, 75], np.float32)
    a = rng.randint(0, 256, (8, 80, 96, 3)).astype(np.uint8)
    b = rng.randint(0, 256, (8, 80, 96, 3)).astype(np.uint8)
    h, w = a.shape[1:3]

    def ref(clean, sigmas, a, b):
        kn, ka = jax.random.PRNGKey(3), jax.random.PRNGKey(4)
        kf, kr = jax.random.split(ka)
        flips = jax.random.bernoulli(kf, 0.5, (a.shape[0],))
        angles = jax.random.uniform(kr, (a.shape[0],), jnp.float32, -10.0, 10.0)

        def src(angle):  # JAX's _rotate_nearest source coordinates
            theta = -angle * jnp.pi / 180.0
            yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0) - (h - 1) / 2.0
            xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1) - (w - 1) / 2.0
            cos, sin = jnp.cos(theta), jnp.sin(theta)
            return (cos * yy - sin * xx + (h - 1) / 2.0, sin * yy + cos * xx + (w - 1) / 2.0)

        return {
            "noise_draws": jax.random.normal(kn, clean.shape, jnp.float32),
            "noisy_scalar": jdev.add_gaussian_noise_u8(kn, clean, 25.0),
            "noisy_per_sample": jdev.add_gaussian_noise_u8(kn, clean, sigmas),
            "flips": flips, "angles": angles, "src": jax.vmap(src)(angles),
            "rotated": jax.vmap(jdev._rotate_nearest)(a, angles),
            "augmented": jdev.augment_pair(ka, a, b),
        }

    return {"clean": clean, "sigmas": sigmas, "a": a, "b": b,
            **run_jax(ref, clean, sigmas, a, b)}


def test_noise_is_byte_equal_to_jax(jax_transforms):
    r = jax_transforms
    clean, noise = torch.from_numpy(r["clean"]), torch.from_numpy(r["noise_draws"])
    for sigma, want in ((25.0, r["noisy_scalar"]),
                        (torch.from_numpy(r["sigmas"]), r["noisy_per_sample"])):
        got = pdev.add_gaussian_noise_u8(None, clean, sigma, noise=noise)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
    assert (r["noisy_per_sample"] == 0).any() and (r["noisy_per_sample"] == 255).any()


def test_normalize_and_denormalize_equal_jax(jax_transforms):
    """Against the functions compiled as the JAX package runs them (inside
    the jitted ``degrade_and_normalize``, XLA's default optimization): there
    x / 255 becomes one fused multiply-add, which the port reproduces."""
    clean = jax_transforms["clean"]
    want = np.asarray(jax.jit(jdev.normalize_u8)(clean))
    x = pdev.normalize_u8(torch.from_numpy(clean))
    np.testing.assert_array_equal(x.numpy(), want)
    np.testing.assert_array_equal(pdev.denormalize(x).numpy(),
                                  np.asarray(jax.jit(jdev.denormalize)(want)))


def _near_tie(src):
    frac = np.abs(np.asarray(src, np.float64) - np.floor(src) - 0.5)
    return frac < TIE_TOL


def test_rotation_and_augment_match_jax_but_ties(jax_transforms):
    """Every pixel equal, except where JAX's f32 source coordinate is within
    TIE_TOL of a .5 tie (counted and printed); the flips and angles are JAX's."""
    r = jax_transforms
    tie = _near_tie(r["src"][0]) | _near_tie(r["src"][1])  # (N, H, W)
    angles, flips = torch.from_numpy(r["angles"]), torch.from_numpy(r["flips"])
    got_rot = pdev._rotate_nearest(torch.from_numpy(r["a"]), angles).numpy()
    got_a, got_b = pdev.augment_pair(None, torch.from_numpy(r["a"]), torch.from_numpy(r["b"]),
                                     flips=flips, angles=angles)
    # a flipped image samples the mirrored source pixel: the tie mask is per output pixel
    for name, got, want in (("rotate", got_rot, r["rotated"]),
                            ("augment a", got_a.numpy(), r["augmented"][0]),
                            ("augment b", got_b.numpy(), r["augmented"][1])):
        off = (got != want).any(-1)
        print(f"{name}: {int(off.sum())} pixels differ, {int((off & tie).sum())} at ties, "
              f"{int(tie.sum())} tie pixels of {tie.size}")
        assert not (off & ~tie).any(), f"{name}: pixels off outside a rounding tie"
    assert r["flips"].any() and not r["flips"].all()


def test_pipelines_return_channels_last_nchw():
    clean = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (2, 8, 8, 3), np.uint8))
    g = torch.Generator().manual_seed(0)
    noisy, clean_n = pdev.degrade_and_normalize(g, clean, torch.tensor([15.0, 50.0]),
                                                augment=True)
    assert noisy.shape == clean_n.shape == (2, 3, 8, 8)
    assert noisy.is_contiguous(memory_format=torch.channels_last)
    a, b = pdev.normalize_pair(g, clean, clean, augment=True)
    np.testing.assert_array_equal(a.numpy(), b.numpy())  # one flip and angle per pair
    g1 = pdev.fold_generator("cpu", (5, 0), 1, 2)
    g2 = pdev.fold_generator("cpu", 5, 0, 1, 2)
    g3 = pdev.fold_generator("cpu", (5, 0), 1, 2, 0)
    x1, x2, x3 = (torch.rand(4, generator=g) for g in (g1, g2, g3))
    assert torch.equal(x1, x2) and not torch.equal(x1, x3)


@pytest.mark.parametrize("channels", [1, 3])
def test_folder_dataset_byte_equal_to_jax(tmp_path, channels):
    """The patch rule, len = patches x levels, every item and gather_batch;
    grayscale (use_rgb=False) and RGB."""
    write_pngs(tmp_path, SIZES, channels=channels)
    assert pds._index_patches((96, 80), PATCH) == jds._index_patches((96, 80), PATCH)
    assert pds._index_patches((31, 64), PATCH) == []
    kw = dict(noise_levels=[15, 25, 50], use_rgb=channels == 3, patch_size=PATCH)
    jd, pd_ = jds.FolderPatchDataset(str(tmp_path), **kw), pds.FolderPatchDataset(str(tmp_path), **kw)
    assert pd_.patches == jd.patches and len(pd_.patches) == 12
    assert len(pd_) == len(jd) == 36 and pd_.channels == channels
    for i in range(len(jd)):
        (pc, ps), (jc, js) = pd_[i], jd[i]
        assert pc.shape == (PATCH, PATCH, channels) and ps == js
        np.testing.assert_array_equal(pc, jc)
    idx = np.random.RandomState(0).permutation(len(jd))[:10]
    for p, j in zip(pd_.gather_batch(idx), jd.gather_batch(idx)):
        assert p.dtype == j.dtype
        np.testing.assert_array_equal(p, j)


def test_sidd_dataset_byte_equal_to_jax(tmp_path):
    write_sidd(tmp_path)
    jd = jds.SIDDPatchDataset(str(tmp_path), patch_size=PATCH)
    pd_ = pds.SIDDPatchDataset(str(tmp_path), patch_size=PATCH)
    assert pd_.patches == jd.patches and len(pd_) == len(jd) == 12
    for i in range(len(jd)):
        for p, j in zip(pd_[i], jd[i]):
            np.testing.assert_array_equal(p, j)
    idx = [5, 0, 11, 5]
    for p, j in zip(pd_.gather_batch(idx), jd.gather_batch(idx)):
        np.testing.assert_array_equal(p, j)


def _random_frames(rng, n, channels):
    frames, tops, lefts = [], [], []
    for _ in range(n):
        h, w = rng.randint(40, 100), rng.randint(40, 100)
        frames.append(rng.randint(0, 256, (h, w, channels), dtype=np.uint8))
        tops.append(rng.randint(0, h - PATCH + 1))
        lefts.append(rng.randint(0, w - PATCH + 1))
    return frames, tops, lefts


@pytest.mark.parametrize("channels", [1, 3])
def test_native_gather_byte_identical_to_numpy(channels):
    """The C++ gather against the numpy one: random frames, one frame many
    times, one thread; each native call counted.  The port's source is the
    JAX package's code byte for byte from its first ``#include`` on (the
    header comment above it names the port's own loader)."""
    assert native.native_available()

    def code(src):
        return src[src.index(b"#include"):]

    assert code(native._SRC.read_bytes()) == code(open(
        os.path.join(os.path.dirname(jds.__file__), "..", "native", "patchio.cpp"), "rb").read())
    rng = np.random.RandomState(7 + channels)
    frames, tops, lefts = _random_frames(rng, 17, channels)
    before = native.gather_patches.native_calls
    out = native.gather_patches(frames, tops, lefts, PATCH)
    assert out.shape == (17, PATCH, PATCH, channels) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, native._gather_numpy(frames, tops, lefts, PATCH))
    frame = rng.randint(0, 256, (90, 90, channels), dtype=np.uint8)
    t, l = list(rng.randint(0, 90 - PATCH, 24)), list(rng.randint(0, 90 - PATCH, 24))
    ref = native._gather_numpy([frame] * 24, t, l, PATCH)
    np.testing.assert_array_equal(native.gather_patches([frame] * 24, t, l, PATCH), ref)
    np.testing.assert_array_equal(
        native.gather_patches([frame] * 24, t, l, PATCH, n_threads=1), ref)
    assert native.gather_patches.native_calls == before + 3
    assert next(native.BUILD_DIR.glob("patchio_*.so"))


def test_native_gather_fallback_and_bounds():
    rng = np.random.RandomState(5)
    big = rng.randint(0, 256, (64, 64, 6), dtype=np.uint8)
    view = big[:, :, ::2]  # strided channels: the numpy gather takes it
    before = native.gather_patches.native_calls
    np.testing.assert_array_equal(native.gather_patches([view], [10], [20], PATCH),
                                  native._gather_numpy([view], [10], [20], PATCH))
    assert native.gather_patches.native_calls == before
    frame = np.zeros((40, 40, 3), np.uint8)
    with pytest.raises(ValueError, match="exceeds frame"):
        native.gather_patches([frame], [10], [0], PATCH)
    with pytest.raises(ValueError, match="empty"):
        native.gather_patches([], [], [], PATCH)


@pytest.fixture
def patch32(monkeypatch):
    """Both packages' loaders build 32-patch datasets."""
    for mod in (jds, pds):
        for name in ("FolderPatchDataset", "SIDDPatchDataset"):
            base = getattr(mod, name)
            monkeypatch.setattr(mod, name, type(name, (base,), {
                "__init__": lambda self, *a, _b=base, **k: _b.__init__(
                    self, *a, patch_size=PATCH, **k)}))


def _jax_normalized(loader, pairs=False):
    """A JAX loader whose transform is JAX's ``normalize_u8`` of the uint8
    batch (of both images with ``pairs``), compiled as the package compiles
    it: the noise differs by design, and compiling the whole of JAX's
    transform takes a second."""
    norm = jax.jit(jdev.normalize_u8)
    if pairs:
        loader.transform = lambda k, noisy, clean: (norm(noisy), norm(clean))
    else:
        loader.transform = lambda k, clean, sigma: (None, norm(clean), sigma)
    return loader


def _clean_batches(loader, cols=(1,)):
    return [[nhwc(b[c]) if b[c].ndim == 4 else b[c].numpy() for c in cols] for b in loader]


def _jax_batches(loader, cols=(1,)):
    return [[np.asarray(b[c]) for c in cols] for b in loader]


def test_load_data_matches_jax(tmp_path, patch32):
    """Splits index for index, two epochs of batch order (clean batches and
    sigmas), __len__ with drop_last true and false, only_validation."""
    write_pngs(tmp_path, SIZES)
    kw = dict(batch_size=4, validation_split=0.25, dataset_percentage=0.75, use_rgb=True,
              include_noise_level=True, seed=3)  # 27 of 36 items: 20 train, 7 val
    jtr, jva = map(_jax_normalized, jloader.load_data(str(tmp_path), **kw))
    ptr, pva = ploader.load_data(str(tmp_path), device="cpu", **kw)
    for p, j in ((ptr, jtr), (pva, jva)):
        np.testing.assert_array_equal(p.dataset.indices, j.dataset.indices)
        np.testing.assert_array_equal(p.dataset.dataset.indices, j.dataset.dataset.indices)
        assert len(p) == len(j) and p.drop_last == j.drop_last
    assert ptr.drop_last and not pva.drop_last and len(pva) == 2  # 7 items, one short batch
    for _ in range(2):  # the shuffle moves with .epoch
        got, want = _clean_batches(ptr, (1, 2)), _jax_batches(jtr, (1, 2))
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
    for g, w in zip(_clean_batches(pva, (1, 2)), _jax_batches(jva, (1, 2))):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    noisy, clean, sigma = next(iter(ptr))
    assert noisy.shape == clean.shape == (4, 3, PATCH, PATCH) and noisy.dtype == torch.float32
    jv = _jax_normalized(jloader.load_data(str(tmp_path), batch_size=4, only_validation=True,
                                           use_rgb=True)[1])
    _, pv = ploader.load_data(str(tmp_path), batch_size=4, only_validation=True, use_rgb=True,
                              device="cpu")
    assert len(pv) == len(jv) == 9  # 36 items
    got, want = _clean_batches(pv), _jax_batches(jv)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])


def test_load_sidd_data_matches_jax(tmp_path, patch32):
    write_sidd(tmp_path)
    kw = dict(batch_size=3, validation_split=0.25, use_rgb=True, seed=1)
    jtr, jva = (_jax_normalized(j, pairs=True) for j in jloader.load_sidd_data(str(tmp_path), **kw))
    ptr, pva = ploader.load_sidd_data(str(tmp_path), device="cpu", **kw)
    np.testing.assert_array_equal(ptr.dataset.indices, jtr.dataset.indices)
    np.testing.assert_array_equal(pva.dataset.indices, jva.dataset.indices)
    assert (len(ptr), len(pva)) == (len(jtr), len(jva)) == (3, 1)
    for p, j in ((ptr, jtr), (pva, jva)):
        for g, w in zip(_clean_batches(p, (0, 1)), _jax_batches(j, (0, 1))):
            np.testing.assert_array_equal(g[0], w[0])  # real noise: no draws
            np.testing.assert_array_equal(g[1], w[1])


def test_bank_sequential_equals_host_loader_and_permute_covers(tmp_path, patch32):
    """Sequential bank batches byte-equal to the unshuffled PatchLoader's
    with the same stream; permute takes each logical index once per epoch."""
    write_pngs(tmp_path, SIZES[:2])  # 10 patches x 3 levels
    _, host = ploader.load_data(str(tmp_path), batch_size=4, only_validation=True,
                                use_rgb=True, seed=5, device="cpu")
    _, bank = ploader.load_data(str(tmp_path), batch_size=4, only_validation=True,
                                use_rgb=True, seed=5, device="cpu", device_data=True)
    assert len(host) == 7 and len(bank) == 8  # the bank keeps the short tail
    for (hn, hc), (bn, bc) in zip(host, bank):
        np.testing.assert_array_equal(hn.numpy(), bn.numpy())
        np.testing.assert_array_equal(hc.numpy(), bc.numpy())
    kw = dict(batch_size=3, validation_split=0.5, use_rgb=True, seed=2, include_noise_level=True)
    th, _ = ploader.load_data(str(tmp_path), device="cpu", **kw)
    td, _ = ploader.load_data(str(tmp_path), device="cpu", device_data=True, **kw)
    assert len(th) == len(td) == 5

    def collect(loader):
        return sorted((float(s), c.numpy().tobytes()) for _, cs, ss in loader
                      for c, s in zip(cs, ss))

    assert collect(th) == collect(td) == collect(td)


def test_bank_rejects_and_warns():
    with pytest.raises(ValueError, match="uint8"):
        DeviceBankLoader(np.zeros((2, 8, 8, 3), np.float32), batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        DeviceBankLoader(np.zeros((2, 8, 8, 3), np.uint8), batch_size=2, mode="crop",
                         device="cpu")
    bank = np.arange(5 * 24 * 24 * 3).reshape(5, 24, 24, 3).astype(np.uint8)
    with pytest.warns(UserWarning, match="short batch"):
        loader = DeviceBankLoader(bank, batch_size=16, mode="permute", device="cpu")
    (batch,) = list(loader)
    assert batch.shape == (5, 24, 24, 3)
    drawn = DeviceBankLoader(bank, batch_size=2, device="cpu")
    first = list(drawn)
    drawn.epoch = 0
    again = list(drawn)
    assert len(first) == 2 and first[0].shape == (2, 24, 24, 3)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_loaders_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    write_pngs(tmp_path, SIZES[:1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ploader.PatchLoader([], 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceBankLoader(np.zeros((2, 8, 8, 3), np.uint8), batch_size=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ploader.load_data(str(tmp_path), batch_size=2)
