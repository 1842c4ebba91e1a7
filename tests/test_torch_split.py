"""The port's split scan against the JAX package's, at level (b): on the
same tie-free histogram both pick the same (feature, threshold_bin,
default_left), with gains and child outputs within 1e-5 relative (the
two packages round the f32 cumulative sums in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu.config as ref_config
from lightgbm_tpu.ops import split as ref_split
import lightgbm_tpu_torch.config as port_config
from lightgbm_tpu_torch.ops import split as port_split
from lightgbm_tpu_torch.ops.histogram import build_histogram

torch.set_num_threads(1)

F, B = 8, 64
NONE, ZERO, NAN = 0, 1, 2


def _case(seed, missing):
    """A histogram of random rows: feature f has num_bin[f] bins; a
    NaN-missing feature's NaN rows sit in its last bin."""
    rng = np.random.RandomState(seed)
    n = 4000
    num_bin = rng.randint(3, B + 1, size=F).astype(np.int32)
    num_bin[-1] = 1                                  # a trivial feature
    bins = np.stack([rng.randint(0, nb, size=n) for nb in num_bin],
                    axis=1).astype(np.uint8)
    zero_bin = np.array([rng.randint(0, nb) for nb in num_bin],
                        dtype=np.int32)
    missing_type = np.array([missing] * F, dtype=np.int32)
    missing_type[-1] = NONE
    gh = np.stack([rng.randn(n), rng.rand(n) + 0.05, np.ones(n),
                   np.ones(n)], axis=1).astype(np.float32)
    hist = build_histogram(torch.from_numpy(bins),
                           torch.from_numpy(gh), B)
    sums = gh.sum(axis=0, dtype=np.float32)
    return hist, sums, num_bin, missing_type, zero_bin


PARAMS = [
    {},
    {"lambda_l1": 0.5, "lambda_l2": 2.0},
    {"max_delta_step": 0.05},
    {"path_smooth": 3.0},
    {"min_data_in_leaf": 900},
    {"min_sum_hessian_in_leaf": 500.0, "min_gain_to_split": 0.5},
]


def _scan_both(hist, sums, num_bin, missing_type, zero_bin, params,
               mask):
    rp = ref_split.SplitParams.from_config(
        ref_config.Config.from_params(dict(params, verbose=-1)))
    pp = port_split.SplitParams.from_config(
        port_config.Config.from_params(dict(params, verbose=-1,
                                            device_type="cpu")),
        torch.device("cpu"))
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    parent = port_split.calculate_leaf_output(f32(sums[0]), f32(sums[1]),
                                              pp)
    rmeta = ref_split.FeatureMeta(
        num_bin=jnp.asarray(num_bin), missing_type=jnp.asarray(missing_type),
        zero_bin=jnp.asarray(zero_bin),
        is_categorical=jnp.zeros(F, dtype=bool),
        use_onehot=jnp.zeros(F, dtype=bool),
        monotone=jnp.zeros(F, dtype=jnp.int8))
    ref = ref_split.find_best_split(
        jnp.asarray(hist.numpy()), *[jnp.float32(v) for v in sums], rmeta,
        rp, jnp.asarray(mask), parent_output=jnp.float32(float(parent)),
        has_categorical=False)
    pmeta = port_split.FeatureMeta(
        num_bin=torch.from_numpy(num_bin),
        missing_type=torch.from_numpy(missing_type),
        zero_bin=torch.from_numpy(zero_bin))
    got = port_split.find_best_split(
        hist, *[f32(v) for v in sums], pmeta, pp, torch.from_numpy(mask),
        parent).tolist()
    return ref, got


@pytest.mark.parametrize("missing", [NONE, ZERO, NAN])
@pytest.mark.parametrize("params", PARAMS, ids=lambda p: ",".join(p) or
                         "default")
def test_same_split_as_reference(missing, params):
    hist, sums, num_bin, missing_type, zero_bin = _case(17 + missing,
                                                        missing)
    mask = np.ones(F, dtype=bool)
    ref, got = _scan_both(hist, sums, num_bin, missing_type, zero_bin,
                          params, mask)
    S = port_split
    ref_valid = int(ref.feature) >= 0
    assert (got[S.FEATURE] >= 0) == ref_valid
    if not ref_valid:
        assert got[S.GAIN] == float("-inf")
        return
    assert int(got[S.FEATURE]) == int(ref.feature)
    assert int(got[S.THRESHOLD_BIN]) == int(ref.threshold_bin)
    assert bool(got[S.DEFAULT_LEFT]) == bool(ref.default_left)
    assert got[S.LEFT_COUNT] == float(ref.left_count)
    assert got[S.RIGHT_TOTAL_COUNT] == float(ref.right_total_count)
    for col, val in ((S.GAIN, ref.gain), (S.LEFT_OUTPUT, ref.left_output),
                     (S.RIGHT_OUTPUT, ref.right_output),
                     (S.LEFT_SUM_GRAD, ref.left_sum_grad),
                     (S.RIGHT_SUM_HESS, ref.right_sum_hess)):
        np.testing.assert_allclose(got[col], float(val), rtol=1e-5,
                                   atol=1e-6)


def test_feature_mask_excludes_the_winner():
    hist, sums, num_bin, missing_type, zero_bin = _case(5, NAN)
    mask = np.ones(F, dtype=bool)
    _, first = _scan_both(hist, sums, num_bin, missing_type, zero_bin, {},
                          mask)
    mask[int(first[port_split.FEATURE])] = False
    ref, got = _scan_both(hist, sums, num_bin, missing_type, zero_bin, {},
                          mask)
    assert int(got[port_split.FEATURE]) == int(ref.feature)
    assert int(got[port_split.FEATURE]) != int(first[port_split.FEATURE])
    assert int(got[port_split.THRESHOLD_BIN]) == int(ref.threshold_bin)


def test_padded_features_never_win():
    """Features padded with num_bin 1 (the learner pads to a multiple of
    8) carry no valid threshold even with rows in bin 0."""
    hist, sums, num_bin, missing_type, zero_bin = _case(9, NONE)
    meta = port_split.pad_feature_meta(port_split.FeatureMeta(
        num_bin=torch.from_numpy(num_bin[:4]),
        missing_type=torch.from_numpy(missing_type[:4]),
        zero_bin=torch.from_numpy(zero_bin[:4])), 4)
    assert meta.num_bin[4:].tolist() == [1, 1, 1, 1]
    pp = port_split.SplitParams.from_config(
        port_config.Config.from_params({"device_type": "cpu"}),
        torch.device("cpu"))
    rec = port_split.find_best_split(
        hist, *[torch.tensor(v) for v in sums], meta, pp,
        torch.ones(F, dtype=torch.bool), torch.tensor(0.0))
    assert 0 <= int(rec[port_split.FEATURE]) < 4


def test_leaf_output_and_gain_closed_forms():
    pp = port_split.SplitParams.from_config(
        port_config.Config.from_params({"device_type": "cpu",
                                        "lambda_l1": 1.0, "lambda_l2": 2.0,
                                        "max_delta_step": 0.5}),
        torch.device("cpu"))
    rp = ref_split.SplitParams.from_config(ref_config.Config.from_params(
        {"lambda_l1": 1.0, "lambda_l2": 2.0, "max_delta_step": 0.5}))
    g = np.linspace(-20, 20, 41).astype(np.float32)
    h = np.linspace(1, 9, 41).astype(np.float32)
    for pf, rf in ((port_split.calculate_leaf_output,
                    ref_split.calculate_leaf_output),
                   (port_split.leaf_gain, ref_split.leaf_gain)):
        got = pf(torch.from_numpy(g), torch.from_numpy(h), pp).numpy()
        want = np.asarray(rf(jnp.asarray(g), jnp.asarray(h), rp))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
