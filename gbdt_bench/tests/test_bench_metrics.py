"""Each per-layer metric's arithmetic on a synthetic profile and tree."""
import numpy as np
import pytest

from gbdt_bench import harness
from gbdt_bench.reference.model_text import PlainTree
from gbdt_bench.trace import ProfileResult
from gbdt_bench.yardstick import work

HBM = 3.35e12


def _stump(left=600, right=400):
    return PlainTree(
        num_leaves=2, split_feature=np.array([0]), threshold=np.array([0.5]),
        decision_type=np.array([0]), left_child=np.array([-1]),
        right_child=np.array([-2]), split_gain=np.array([1.0]),
        internal_count=np.array([left + right]),
        leaf_value=np.array([0.1, -0.1]), leaf_count=np.array([left, right]))


def _profile():
    device = [("void hist_rows_kernel<float>(Args)", 0.0, 10.0),
              ("k2", 20.0, 30.0), ("Memcpy HtoD (Pageable -> Device)",
                                   25.0, 40.0)]
    host = [("aten::add", 9.0, 22.0), ("Activity Buffer Request", 40.0, 60.0),
            ("python_op", 60.0, 100.0)]
    return ProfileResult(device, host, (0.0, 100.0),
                         {"bench::gradients": [(18.0, 22.0), (24.0, 26.0)],
                          "bench::learner": [(-1.0, 1.0)]})


def _layer(**rec):
    return harness.Layer(rec, {}, {})


def test_profile_reductions():
    p = _profile()
    assert p.busy_us() == 30.0
    # idle: 10-20 and 40-100, less the profiler's own 40-60
    assert p.idle() == [(10.0, 20.0), (60.0, 100.0)]
    assert p.window_us() == 80.0
    assert p.idle_gaps() == [["python_op", 40e-6], ["aten::add", 10e-6]]
    assert p.top_ops()[0] == ["Memcpy HtoD (Pageable -> Device)", 15e-6]


def test_device_idle_ops_and_gradients():
    ctx = _layer(profile=_profile(), profiled_trees=[_stump()],
                 profiled_iterations=2)
    read = harness.metric_reader
    assert read("device_idle_pct.train")(ctx) == pytest.approx(62.5)
    assert read("device_idle_pct.predict")(ctx) == pytest.approx(62.5)
    # the learner's range saw hist_rows_kernel start; the gradients' saw
    # k2 and the copy start (k2 20-30 and the copy 25-40: 20 us busy)
    assert read("ops_per_split")(ctx) == 1.0
    assert [d[0] for d in ctx.profile.ops_in("bench::gradients")] == [
        "k2", "Memcpy HtoD (Pageable -> Device)"]
    assert read("gradients_ms")(ctx) == pytest.approx(0.010)
    empty = _layer(profile=ProfileResult([], [], (0.0, 1.0), {}),
                   profiled_iterations=1, profiled_trees=[_stump()])
    assert read("gradients_ms")(empty) is None
    assert read("ops_per_split")(empty) is None


def test_hist_roofline_and_mfu():
    t = _stump()
    # root 1000 rows + the smaller child's 400 rows, each 2 bin bytes and
    # 8 gradient bytes, 400 row indices, 2 histograms of 2 x 256 x 12
    b = 1400 * (2 + 8) + 400 * 4 + 2 * 2 * 256 * 12
    assert work.histogram_work([t], 1000, 2, 255) == (b, 1400 * 2 * 3)
    ctx = _layer(profile=_profile(), profiled_trees=[t], rows=1000,
                 features=2, max_bin=255, window_trees=[t], window_s=1e-3,
                 group=None)
    assert harness.metric_reader("hist_roofline_pct")(ctx) == pytest.approx(
        100 * b / HBM / 10e-6)
    it = b + 1000 * 16 + 1000 * 12 + 1000 * 9
    assert harness.metric_reader("train_mfu_pct")(ctx) == pytest.approx(
        100 * it / HBM / 1e-3)
    # lambdarank's pairs count as operations
    assert work.iteration_work([t], 1000, 2, 255, np.array([3, 4]))[1] == \
        1400 * 2 * 3 + 25 * work.PAIR_OPS


def test_split_ms_and_predict_mfu():
    t = _stump()
    ctx = _layer(stages={"tree::split_batches": 0.5, "other": 9.0},
                 window_trees=[t, t])
    assert harness.metric_reader("split_ms")(ctx) == pytest.approx(250.0)
    assert harness.metric_reader("split_ms")(_layer(
        stages={}, window_trees=[t])) is None
    ctx = _layer(calls=4, batch_rows=10, features=2, model_trees=[t],
                 s_per_call=1e-6)
    assert harness.metric_reader("predict_mfu_pct")(ctx) == pytest.approx(
        100 * (10 * 2 * 4 + 20 + 2 * 8 + 10 * 8) / HBM / 1e-6)
