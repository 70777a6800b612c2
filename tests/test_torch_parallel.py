"""The port's multi-device rules against the JAX package's, and one process's identities.

The leaf rules of ``parallel/fsdp.py`` and ``parallel/tp.py`` are pure
functions of a leaf's JAX shape: held to JAX's ``fsdp_spec_for_shape`` /
``tp_spec_for_shape`` on every leaf of RDUNet and RDUNetT (their real
shapes, from ``jax.eval_shape``) at 2, 4 and 8 shards, and the torch leaf
each state_dict key names must be split on the same dimension.
``best_pipeline_depth`` and ``local_batch_rows`` are held to JAX's over a
range of sizes (JAX's rows from a ``NamedSharding`` over the suite's 8
virtual CPU devices).  With one process every function of ``parallel/mesh.py``
is the identity, as in JAX.  The new modules import no JAX.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from vub_image_denoising_tpu.models.rdunet import RDUNet as JRDUNet
from vub_image_denoising_tpu.models.rdunet import RDUNetT as JRDUNetT
from vub_image_denoising_tpu.parallel import fsdp as jfsdp
from vub_image_denoising_tpu.parallel import pipeline as jpipe
from vub_image_denoising_tpu.parallel import tp as jtp
from vub_image_denoising_tpu_torch.models import RDUNet, RDUNetT
from vub_image_denoising_tpu_torch.parallel import fsdp, mesh, pipeline, tiles, tp
from vub_image_denoising_tpu_torch.utils.checkpoint import params_to_state_dict

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def leaves():
    """(state_dict key, torch shape, JAX shape) of every leaf of RDUNet(3, 16)
    and RDUNetT(16)."""
    out = []
    for jm, pm, example in ((JRDUNet(3, 16), RDUNet(3, 16), (jnp.zeros((1, 32, 32, 3)),)),
                            (JRDUNetT(16), RDUNetT(16),
                             (jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,))))):
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *example)
        flat = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
        carried = params_to_state_dict(flat)
        jax_shapes = {k: np.shape(v) for k, v in _leaves_by_key(flat).items()}
        sd = pm.state_dict()
        assert set(carried) == set(sd) == set(jax_shapes)
        out += [(k, tuple(sd[k].shape), jax_shapes[k]) for k in sd]
    return out


def _leaves_by_key(tree):
    """The JAX leaves by the state_dict key ``params_to_state_dict`` gives them."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        single = {}
        node = single
        names = [p.key for p in path]
        for n in names[:-1]:
            node = node.setdefault(n, {})
        node[names[-1]] = leaf
        (key,) = params_to_state_dict(single)
        out[key] = leaf
    return out


@pytest.mark.parametrize("rule", ["fsdp", "tp"])
def test_leaf_rules_match_jax_on_the_models_leaves(leaves, rule):
    mine = fsdp.fsdp_spec_for_shape if rule == "fsdp" else tp.tp_spec_for_shape
    theirs = jfsdp.fsdp_spec_for_shape if rule == "fsdp" else jtp.tp_spec_for_shape
    shardings = fsdp.fsdp_shardings if rule == "fsdp" else tp.tp_shardings
    split = 0
    for n in (2, 4, 8):
        dims = shardings({k: torch.empty(s) for k, s, _ in leaves}, n)
        for key, tshape, jshape in leaves:
            assert fsdp.jax_layout(key, tshape)[0] == jshape, key
            spec = tuple(theirs(jshape, n))
            assert mine(jshape, n) == spec, (key, n)
            jdim = next((i for i, a in enumerate(spec) if a is not None), None)
            want = None if jdim is None else fsdp.jax_layout(key, tshape)[1][jdim]
            assert dims[key] == want, (key, n)
            split += want is not None
    assert split > 0


def test_leaf_rules_explicit_cases():
    # tests/test_tp.py's cases, and the FSDP tie going to the first largest dim
    assert tp.tp_spec_for_shape((3, 3, 64, 128), 8) == (None, None, None, "model")
    assert tp.tp_spec_for_shape((3, 3, 64, 3), 8) == (None, None, "model", None)
    assert tp.tp_spec_for_shape((128,), 8) == ()
    assert tp.tp_spec_for_shape((3, 3, 5, 7), 8) == ()
    assert tp.tp_spec_for_shape((3, 3, 64, 128), 1) == ()
    assert fsdp.fsdp_spec_for_shape((3, 3, 64, 64), 2) == (None, None, "data", None)
    assert fsdp.fsdp_spec_for_shape((4, 4), 2) == ()  # below min_shard_elems


def test_best_pipeline_depth_matches_jax():
    for timesteps in range(1, 41):
        for n in range(1, 9):
            assert pipeline.best_pipeline_depth(timesteps, n) == jpipe.best_pipeline_depth(
                timesteps, n), (timesteps, n)


class _Line:
    """A mesh view of rank ``index`` of ``size`` along "data"."""

    def __init__(self, size, index):
        self._size, self._index = size, index

    def size(self, axis):
        return self._size if axis == "data" else 1

    def index(self, axis):
        return self._index if axis == "data" else 0


def test_local_batch_rows_match_jax_devices_rows():
    devices = jax.devices()
    for k in (1, 2, 4, 8):
        sharding = NamedSharding(JMesh(np.asarray(devices[:k]), ("data",)), P("data"))
        for n_rows in (k, 2 * k, 8 * k):
            index_map = sharding.devices_indices_map((n_rows,))
            for d, dev in enumerate(devices[:k]):
                sl = index_map[dev][0]
                want = list(range(sl.start or 0, n_rows if sl.stop is None else sl.stop))
                assert mesh.local_batch_rows(n_rows, _Line(k, d)) == want
    with pytest.raises(ValueError):
        mesh.local_batch_rows(5, _Line(2, 0))


def test_one_process_is_the_identity(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert mesh.init_distributed("gloo") is False
    m = mesh.make_mesh(device="cpu")
    assert m.shape == {"data": 1} and m.group("data") is None
    x = torch.arange(24.0).reshape(4, 6)
    assert mesh.shard_batch(x, m) is not None and torch.equal(mesh.shard_batch(x, m), x)
    assert all(torch.equal(a, b) for a, b in zip(mesh.put_batch((x, x + 1), m), (x, x + 1)))
    assert torch.equal(mesh.make_global_batch(x, m), x)
    assert torch.equal(mesh.make_global_batch_from_local(x, [0, 1, 2, 3], 4, m), x)
    assert mesh.all_reduce(x) is x
    assert mesh.all_gather(x, 1) is x and mesh.reduce_scatter(x, 0) is x
    assert mesh.all_processes_mean(3.5) == 3.5
    sd = {"w": x.clone()}
    assert torch.equal(mesh.put_replicated(sd, m)["w"], x)
    bn = torch.nn.Sequential(torch.nn.BatchNorm2d(3))
    assert type(mesh.sync_batchnorm_(bn, m)[0]) is torch.nn.BatchNorm2d
    assert pipeline.make_pp_mesh("cpu").shape == {"stage": 1}
    assert tp.make_tp_mesh(device="cpu").shape == {"data": 1, "model": 1}


def test_one_process_shardings_hold_everything():
    model = RDUNet(3, 8)
    m = mesh.make_mesh(device="cpu")
    state = fsdp.put_fsdp(dict(model.named_parameters()), m)
    assert fsdp.sharded_fraction(state) == 0.0 and all(d is None for d in state.dims.values())
    tstate = tp.put_tp(model, tp.make_tp_mesh(device="cpu"))
    assert fsdp.sharded_fraction(tstate) == 0.0
    x = torch.randn(1, 3, 16, 16)
    with torch.no_grad():
        torch.testing.assert_close(tstate.apply(tstate.shards, x), model(x))


def test_tiles_halo_covers_the_receptive_field_and_one_band_is_the_forward():
    assert tiles.halo_rows() % 8 == 0 and tiles.halo_rows() >= tiles.receptive_radius() > 100
    model = RDUNet(3, 4).eval()
    image = np.random.RandomState(0).uniform(-1, 1, (21, 13, 3)).astype(np.float32)

    def forward(batch):
        with torch.no_grad():
            return model(batch.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    got = tiles.denoise_large_image(forward, image, None)
    pad = np.pad(image, ((0, 3), (0, 3), (0, 0)), mode="reflect")[None]
    np.testing.assert_allclose(got, forward(torch.from_numpy(pad))[0, :21, :13].numpy())


def test_new_modules_import_no_jax():
    files = sorted((REPO / "vub_image_denoising_tpu_torch" / "parallel").glob("*.py"))
    files.append(REPO / "vub_image_denoising_tpu_torch" / "eval" / "export.py")
    banned = ("jax", "jaxlib", "flax", "optax", "vub_image_denoising_tpu")
    assert len(files) == 7
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


def test_loaders_fetch_this_ranks_rows_with_the_global_batch_draws():
    """Over two ranks each loader yields its rows of what one rank yields:
    the host loader fetches only those rows, the bank gathers only them, and
    the noise, flips and angles are drawn for the whole batch (a tail batch
    of 3 keeps 2 rows, one each; JAX's multi-process tail policy)."""
    from vub_image_denoising_tpu_torch.data.device import degrade_and_normalize
    from vub_image_denoising_tpu_torch.data.loader import PatchLoader
    from vub_image_denoising_tpu_torch.data.resident import DeviceBankLoader

    rng = np.random.RandomState(4)
    images = rng.randint(0, 256, (11, 16, 16, 3), np.uint8)
    sigmas = rng.choice([15.0, 25.0, 50.0], 11).astype(np.float32)

    class Pairs:
        def __len__(self):
            return len(images)

        def __getitem__(self, i):
            return images[i], sigmas[i]

    def tf(g, clean_u8, sigma):
        return degrade_and_normalize(g, clean_u8, sigma, augment=True)

    sig = torch.from_numpy(sigmas)

    def loaders(mesh):
        yield PatchLoader(Pairs(), 4, shuffle=True, transform=tf, device="cpu", num_workers=1,
                          seed=3, drop_last=False, mesh=mesh)
        for mode in ("permute", "sequential"):
            yield DeviceBankLoader(images, 4, transform=tf, mode=mode, device="cpu", seed=3,
                                   index_map=lambda i: (i, (sig[i],)), mesh=mesh)

    for whole, *ranks in zip(loaders(None), *(loaders(_Line(2, r)) for r in range(2))):
        for full, *parts in zip(whole, *ranks):
            n = full[0].shape[0] // 2 * 2
            for k in range(2):
                torch.testing.assert_close(torch.cat([p[k] for p in parts]), full[k][:n],
                                           rtol=0, atol=0)
