"""Spatially partitioned training in one process: the band math and the identities.

``parallel.mesh.shard_spatial``'s bands and refusals, ``halo_exchange`` and
``with_halo`` as the identity with one rank, the band forward of the one
band equal to the module's forward for ``RDUNet`` and ``RDUNetT`` (with and
without remat), the one-rank band step of both trainers equal to the batch
step, and the trainers' refusals under ``batch_sharding="spatial"``.  Two
ranks run in ``tests/test_torch_multirank.py``.
"""

import pytest
import torch

from test_torch_rdunet import one_thread  # noqa: F401 — autouse
from vub_image_denoising_tpu_torch.models import RDUNet, RDUNetT
from vub_image_denoising_tpu_torch.parallel import shard_spatial
from vub_image_denoising_tpu_torch.parallel.mesh import spatial_band_rows
from vub_image_denoising_tpu_torch.parallel.spatial import band_forward, halo_exchange, with_halo
from vub_image_denoising_tpu_torch.train import DiffusionTrainer, SupervisedTrainer


class RankMesh:
    """The data axis of ``n`` ranks as rank ``i`` sees it, on the CPU."""

    device = torch.device("cpu")

    def __init__(self, i, n):
        self.i, self.n = i, n

    def size(self, axis):
        return self.n

    def index(self, axis):
        return self.i


@pytest.mark.parametrize("h, n", [(64, 2), (128, 4), (32, 1), (8, 1)])
def test_shard_spatial_gives_each_rank_its_band(h, n):
    x = torch.arange(2 * 3 * h * 5, dtype=torch.float32).reshape(2, 3, h, 5)
    bands = [shard_spatial(x, RankMesh(i, n)) for i in range(n)]
    assert all(b.shape == (2, 3, h // n, 5) for b in bands)
    assert torch.equal(torch.cat(bands, 2), x)
    assert torch.equal(shard_spatial(x), x)
    assert spatial_band_rows(h, n, n - 1) == (h - h // n, h)


@pytest.mark.parametrize("h, n, match", [(60, 1, "divide"), (40, 2, "divide"),
                                         (48, 2, "deepest"), (64, 4, "deepest")])
def test_shard_spatial_refuses_uneven_or_shallow_bands(h, n, match):
    with pytest.raises(ValueError, match=match):
        shard_spatial(torch.zeros(1, 3, h, 8), RankMesh(0, n))


def test_halo_exchange_is_the_identity_with_one_rank():
    x = torch.randn(2, 4, 8, 8, requires_grad=True)
    assert halo_exchange(x, 4, 4) is x
    assert torch.equal(with_halo(lambda z: z * 2, x, 4), x * 2)


@pytest.mark.parametrize("remat", [False, True])
def test_band_forward_of_one_band_equals_the_forward(remat):
    model = RDUNet(3, 4, generator=torch.Generator().manual_seed(0), remat=remat)
    x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(1), requires_grad=True)
    want = model(x)
    got = band_forward(model, x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    g_want = torch.autograd.grad(want.square().sum(), x)[0]
    g_got = torch.autograd.grad(got.square().sum(), x)[0]
    torch.testing.assert_close(g_got, g_want, rtol=0, atol=0)
    with pytest.raises(TypeError, match="RDUNet or an RDUNetT"):
        band_forward(torch.nn.Identity(), x)


@pytest.mark.parametrize("remat", [False, True])
def test_band_forward_of_one_rdunet_t_band_equals_the_forward(remat):
    model = RDUNetT(4, generator=torch.Generator().manual_seed(0), remat=remat)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1), requires_grad=True)
    t = torch.tensor([0.25, 0.9])
    want = model(x, t)
    got = band_forward(model, x, t=t)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    g_want = torch.autograd.grad(want.square().sum(), x)[0]
    g_got = torch.autograd.grad(got.square().sum(), x)[0]
    torch.testing.assert_close(g_got, g_want, rtol=0, atol=0)


@pytest.mark.parametrize("kw", [{"param_sharding": "fsdp"}, {"param_sharding": "tp"},
                                {"engine": "pallas"}, {"apply_fn": lambda p, x: x}])
def test_trainer_refuses_what_the_band_layout_does_not_take(kw):
    trainer = SupervisedTrainer(RDUNet(3, 4), device="cpu", batch_sharding="spatial", **kw)
    with pytest.raises(ValueError, match="spatial"):
        trainer.init(steps_per_epoch=1)
    with pytest.raises(ValueError, match="batch_sharding"):
        SupervisedTrainer(RDUNet(3, 4), device="cpu", batch_sharding="rows").init(1)


@pytest.mark.parametrize("kw", [{"param_sharding": "fsdp"}, {"param_sharding": "tp"},
                                {"engine": "xla"}, {"engine": "pallas"},
                                {"batch_sharding": "rows"}])
def test_diffusion_trainer_refuses_what_the_band_layout_does_not_take(kw):
    trainer = DiffusionTrainer(base_filters=4, device="cpu", **{"batch_sharding": "spatial", **kw})
    with pytest.raises(ValueError, match="spatial" if "batch_sharding" not in kw
                       else "batch_sharding"):
        trainer.init(steps_per_epoch=1)


def test_one_rank_band_step_equals_the_batch_step():
    x, y = torch.rand(2, 2, 3, 16, 16, generator=torch.Generator().manual_seed(2)) * 2 - 1
    losses, params = [], []
    for layout in ("batch", "spatial"):
        model = RDUNet(3, 4, generator=torch.Generator().manual_seed(0))
        trainer = SupervisedTrainer(model, accumulation_steps=2, device="cpu",
                                    batch_sharding=layout)
        state = trainer.init(steps_per_epoch=1)
        _, loss = trainer.train_step(state, x, y)
        losses.append(float(loss))
        params.append(model.state_dict())
        assert trainer.evaluate_batch(state, x).shape == x.shape
    assert losses[0] == losses[1]
    for k, v in params[0].items():
        torch.testing.assert_close(params[1][k], v, rtol=0, atol=0, msg=k)


def test_one_rank_diffusion_band_step_equals_the_batch_step():
    """SSIM on: with one rank the banded loss is ``combined_loss``."""
    noisy, clean = torch.rand(2, 2, 3, 32, 32, generator=torch.Generator().manual_seed(3)) * 2 - 1
    losses, params, samples = [], [], []
    for layout in ("batch", "spatial"):
        trainer = DiffusionTrainer(base_filters=4, timesteps=2, accumulation_steps=2,
                                   loss_weights=(0.5, 1.0, 0.3), device="cpu",
                                   batch_sharding=layout)
        state = trainer.init(steps_per_epoch=1, seed=0)
        _, loss = trainer.train_step(state, noisy, clean)
        losses.append(float(loss))
        params.append(trainer.unet.state_dict())
        samples.append(trainer.sample(state, noisy[:1]))
        vloss, denoised = trainer.validate(state, [(noisy[:1], clean[:1])])
        assert denoised.shape == (1, 3, 32, 32) and vloss == vloss
    assert losses[0] == losses[1]
    for k, v in params[0].items():
        torch.testing.assert_close(params[1][k], v, rtol=0, atol=0, msg=k)
    torch.testing.assert_close(samples[1], samples[0], rtol=0, atol=0)
