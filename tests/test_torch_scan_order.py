"""The split scan's prefix sums against the reference's, at level (a).

``lightgbm_tpu_torch.ops.split.prefix_sum`` adds in the order that XLA's
CPU build gives ``jnp.cumsum`` (blocks of 16, then the block totals), so
on the same f32 input the two are bit-equal: over values that cancel
(``randn * 1e3``) and values that do not (``rand``), below, at and above
each block boundary and the recursion's (B > 256).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops.split import prefix_sum

torch.set_num_threads(1)


def _values(F, B, kind):
    rng = np.random.RandomState(1000 * F + B)
    if kind == "cancel":
        return (rng.randn(F, B) * 1e3).astype(np.float32)
    return rng.rand(F, B).astype(np.float32)


@pytest.mark.parametrize("kind", ["cancel", "positive"])
@pytest.mark.parametrize("F", [1, 8, 32])
@pytest.mark.parametrize("B", [1, 2, 15, 16, 17, 64, 100, 255, 256, 257,
                               1024])
def test_prefix_sum_bit_equal_to_jnp_cumsum(B, F, kind):
    x = _values(F, B, kind)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=1))
    t = torch.from_numpy(x.copy())
    got = prefix_sum(t)
    assert got.dtype == torch.float32 and got.shape == (F, B)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert np.array_equal(t.numpy(), x)          # the input is not touched


def test_prefix_sum_over_leading_axes():
    """A stacked [4, F, B] input (the four histogram channels in one
    call) gives each channel's own scan."""
    x = np.stack([_values(8, 256, "cancel"), _values(8, 256, "positive"),
                  _values(8, 256, "cancel") * 0.5,
                  _values(8, 256, "positive") * 3.0])
    got = prefix_sum(torch.from_numpy(x)).numpy()
    for ch in range(4):
        want = np.asarray(jnp.cumsum(jnp.asarray(x[ch]), axis=1))
        assert np.array_equal(got[ch].view(np.int32), want.view(np.int32))
