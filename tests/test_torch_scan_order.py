"""The split scan's prefix sums against the reference's, at level (a).

``lightgbm_tpu_torch.ops.split.prefix_sum`` adds in the order that XLA's
CPU build gives ``jnp.cumsum`` (blocks of 16, then the block totals), so
on the same f32 input the two are bit-equal: over values that cancel
(``randn * 1e3``) and values that do not (``rand``), below, at and above
each block boundary and the recursion's (B > 256).

At the wide bins' widths (B = 512 to 4096, where the block totals
recurse) the whole split scan is held to the reference's
``find_best_split`` on the same histogram: numerical features under
each missing type and monotone constraints bit-equal in every f32
column of the record (level a); categorical features the same winner
and left-bin mask, with gains and outputs within rtol 1e-5 (the
categorical scan's sort, as in tests/test_torch_categorical.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu.config as ref_config
from lightgbm_tpu.ops import split as ref_split
import lightgbm_tpu_torch.config as port_config
from lightgbm_tpu_torch.ops import split as S
from lightgbm_tpu_torch.ops.histogram import build_histogram
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
                               512, 1024, 2048, 4096])
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


WIDE_F = 8


def _wide_case(B, seed, missing, categorical=False):
    """A histogram of 6000 random rows over uint16 bins: feature f has
    num_bin[f] bins, between B/2 and B (so its bins span several of the
    kernel's 256-bin slabs); categorical features hold few, dense
    bins."""
    rng = np.random.RandomState(seed)
    n = 6000
    num_bin = rng.randint(B // 2 + 1, B + 1, size=WIDE_F).astype(np.int32)
    is_cat = np.zeros(WIDE_F, dtype=bool)
    if categorical:
        is_cat[:4] = True
        num_bin[:4] = rng.randint(3, 40, size=4)
    bins = np.stack([rng.randint(0, nb, size=n) for nb in num_bin],
                    axis=1).astype(np.uint16)
    zero_bin = np.array([rng.randint(0, nb) for nb in num_bin],
                        dtype=np.int32)
    missing_type = np.full(WIDE_F, missing, dtype=np.int32)
    missing_type[is_cat] = 0
    signal = (bins[:, 1] > num_bin[1] // 3) * 2.0 - 1.0
    gh = np.stack([rng.randn(n) + signal, rng.rand(n) + 0.05, np.ones(n),
                   np.ones(n)], axis=1).astype(np.float32)
    hist = build_histogram(torch.from_numpy(bins), torch.from_numpy(gh), B)
    sums = gh.sum(axis=0, dtype=np.float32)
    return hist, sums, num_bin, missing_type, zero_bin, is_cat


def _bits(v):
    return int(np.asarray(v, dtype=np.float32).view(np.int32))


@pytest.mark.parametrize("case", ["none", "zero", "nan", "monotone",
                                  "categorical"])
@pytest.mark.parametrize("B", [512, 1024, 2048, 4096])
def test_wide_scan_equals_reference(B, case):
    missing = {"zero": 1, "nan": 2}.get(case, 0)
    cat = case == "categorical"
    hist, sums, num_bin, missing_type, zero_bin, is_cat = _wide_case(
        B, B + missing + 3 * cat, missing, cat)
    mono = np.zeros(WIDE_F, dtype=np.int8)
    if case == "monotone":
        mono[1], mono[2] = 1, -1
    params = {"verbose": -1, "min_data_in_leaf": 20, "lambda_l2": 1.0}
    rc = ref_config.Config.from_params(params)
    pc = port_config.Config.from_params(dict(params, device_type="cpu"))
    onehot = is_cat & (num_bin <= pc.max_cat_to_onehot)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    pp = S.SplitParams.from_config(pc, torch.device("cpu"))
    parent = S.calculate_leaf_output(f32(sums[0]), f32(sums[1]), pp)
    mask = np.ones(WIDE_F, dtype=bool)
    rmeta = ref_split.FeatureMeta(
        num_bin=jnp.asarray(num_bin), missing_type=jnp.asarray(missing_type),
        zero_bin=jnp.asarray(zero_bin), is_categorical=jnp.asarray(is_cat),
        use_onehot=jnp.asarray(onehot), monotone=jnp.asarray(mono))
    ref = ref_split.find_best_split(
        jnp.asarray(hist.numpy()), *[jnp.float32(v) for v in sums], rmeta,
        ref_split.SplitParams.from_config(rc), jnp.asarray(mask),
        parent_output=jnp.float32(float(parent)), has_categorical=cat)
    pmeta = S.FeatureMeta(
        num_bin=torch.from_numpy(num_bin),
        missing_type=torch.from_numpy(missing_type),
        zero_bin=torch.from_numpy(zero_bin),
        is_categorical=torch.from_numpy(is_cat) if cat else None,
        use_onehot=torch.from_numpy(onehot) if cat else None,
        monotone=torch.from_numpy(mono) if case == "monotone" else None,
        cat_positions=int((num_bin[is_cat] // 2).max()) if cat else 0)
    got = S.find_best_split(
        hist, *[f32(v) for v in sums], pmeta, pp, torch.from_numpy(mask),
        parent, has_categorical=cat,
        has_monotone=case == "monotone").tolist()
    assert int(ref.feature) >= 0, "the case must have a valid split"
    assert int(got[S.FEATURE]) == int(ref.feature)
    assert int(got[S.THRESHOLD_BIN]) == int(ref.threshold_bin)
    assert bool(got[S.DEFAULT_LEFT]) == bool(ref.default_left)
    cols = ((S.GAIN, ref.gain), (S.LEFT_OUTPUT, ref.left_output),
            (S.RIGHT_OUTPUT, ref.right_output),
            (S.LEFT_SUM_GRAD, ref.left_sum_grad),
            (S.LEFT_SUM_HESS, ref.left_sum_hess),
            (S.LEFT_COUNT, ref.left_count),
            (S.RIGHT_SUM_GRAD, ref.right_sum_grad),
            (S.RIGHT_SUM_HESS, ref.right_sum_hess),
            (S.RIGHT_COUNT, ref.right_count))
    if cat:
        assert bool(got[S.IS_CATEGORICAL]) == bool(ref.is_categorical)
        np.testing.assert_array_equal(S.cat_mask_of_row(got, B),
                                      np.asarray(ref.cat_mask))
        for col, val in cols:
            np.testing.assert_allclose(got[col], float(val), rtol=1e-5,
                                       atol=1e-6)
        return
    for col, val in cols:
        assert _bits(got[col]) == _bits(val), (col, got[col], float(val))
