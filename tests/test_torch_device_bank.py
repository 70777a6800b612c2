"""The port's device bank with the random crop (``DeviceBankLoader(patch=...)``).

Counterparts of ``tests/test_device_bank.py``'s crop tests: crops come from
the bank, the same seed gives the same stream (and the next epoch another),
a patch larger than the bank's images raises.  The draws cannot be compared
across the packages (torch generators, JAX keys), so the crop itself is held
against JAX's ``vmap`` of ``dynamic_slice`` on the same offsets, and the
loader's crop against ``crop`` on the offsets drawn from the step's stream
after the indices.  Over two ranks the offsets are drawn for the whole batch.
"""

import jax
import numpy as np
import pytest
import torch

from vub_image_denoising_tpu_torch.data.device import fold_generator
from vub_image_denoising_tpu_torch.data.resident import DeviceBankLoader, crop


def iota_bank(n=5, h=24, w=24, c=3):
    """Image i = i*48 + row + col (values < 256): any crop of image i is an
    exact 2-D iota sheet, so a patch betrays its source image and offsets."""
    base = (np.arange(h)[:, None] + np.arange(w)[None])[None] + 48 * np.arange(n)[:, None, None]
    return np.repeat(base[..., None], c, axis=-1).astype(np.uint8)


class RankMesh:
    """The two-rank data axis ``rank_rows`` reads, as rank ``i`` sees it."""

    def __init__(self, i, n=2):
        self.i, self.n = i, n

    def size(self, axis):
        return self.n

    def index(self, axis):
        return self.i


def test_crops_come_from_the_bank():
    loader = DeviceBankLoader(iota_bank(), batch_size=16, patch=8, steps_per_epoch=2, seed=3,
                              device="cpu")
    rr = np.arange(8)[:, None] + np.arange(8)[None]
    seen = set()
    for batch in loader:
        arr = batch.numpy()
        assert arr.shape == (16, 8, 8, 3) and arr.dtype == np.uint8
        for p in arr:
            np.testing.assert_array_equal(p[..., 0].astype(np.int32) - int(p[0, 0, 0]), rr)
            img, off = divmod(int(p[0, 0, 0]), 48)
            assert 0 <= img < 5 and 0 <= off <= (24 - 8) * 2
            seen.add(img)
    assert len(seen) > 2, "sampler stuck on very few bank images"


def test_epoch_folding_matches_loader_convention():
    def make(epoch=0):
        loader = DeviceBankLoader(iota_bank(), batch_size=4, patch=8, steps_per_epoch=3, seed=0,
                                  device="cpu")
        loader.epoch = epoch
        return loader

    a = make()
    ea1, ea2 = list(a), list(a)
    assert all(torch.equal(x, y) for x, y in zip(ea1, make()))
    assert not all(torch.equal(x, y) for x, y in zip(ea1, ea2)), "epochs 0 and 1 alike"
    assert all(torch.equal(x, y) for x, y in zip(ea2, make(epoch=1)))


def test_rejects_bad_patch_and_takes_the_whole_image():
    with pytest.raises(ValueError, match="exceeds"):
        DeviceBankLoader(np.zeros((2, 8, 8, 3), np.uint8), batch_size=2, patch=16, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        DeviceBankLoader(np.zeros((2, 8, 16, 3), np.uint8), batch_size=2, patch=12, device="cpu")
    bank = iota_bank()
    whole = DeviceBankLoader(bank, batch_size=4, patch=24, mode="sequential", device="cpu")
    assert whole.patch is None
    np.testing.assert_array_equal(next(iter(whole)).numpy(), bank[:4])


def test_crop_equals_jax_dynamic_slice_on_the_same_offsets():
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (6, 20, 28, 3)).astype(np.uint8)
    tops, lefts = rng.randint(0, 20 - 9 + 1, 6), rng.randint(0, 28 - 9 + 1, 6)
    want = jax.vmap(lambda im, t, l: jax.lax.dynamic_slice(im, (t, l, 0), (9, 9, 3)))(
        images, tops, lefts)
    got = crop(torch.from_numpy(images), torch.from_numpy(tops), torch.from_numpy(lefts), 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["sample", "permute", "sequential"])
def test_offsets_follow_the_indices_in_the_step_stream(mode):
    bank = iota_bank(n=8, h=20, w=28)

    def tf(g, x):
        return x, torch.rand(1, generator=g)

    loader = DeviceBankLoader(bank, batch_size=4, transform=tf, patch=8, mode=mode,
                              steps_per_epoch=1, seed=5, device="cpu")
    batch, after = next(iter(loader))
    g = fold_generator("cpu", (5, 0), 0, 0)
    if mode == "sample":
        idx = torch.randint(0, 8, (4,), generator=g)
    elif mode == "permute":
        idx = torch.randperm(8, generator=fold_generator("cpu", (5, 0), 0))[:4]
    else:
        idx = torch.arange(4)
    tops = torch.randint(0, 20 - 8 + 1, (4,), generator=g)
    lefts = torch.randint(0, 28 - 8 + 1, (4,), generator=g)
    assert torch.equal(batch, crop(torch.from_numpy(bank)[idx], tops, lefts, 8))
    assert torch.equal(after, torch.rand(1, generator=g))  # the transform's stream follows


def test_two_ranks_keep_their_rows_of_the_batch_draws():
    bank = iota_bank(n=8, h=20, w=28)

    def rows(mesh):
        loader = DeviceBankLoader(bank, batch_size=6, patch=8, steps_per_epoch=2, seed=1,
                                  device="cpu", mesh=mesh)
        return list(loader)

    one = rows(None)
    split = [rows(RankMesh(i)) for i in range(2)]
    for step, whole in enumerate(one):
        assert torch.equal(torch.cat([split[0][step], split[1][step]]), whole)
