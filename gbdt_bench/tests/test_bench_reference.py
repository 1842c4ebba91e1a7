"""The plain reference against hand-worked cases: the binary and lambdarank
gradients (a query with tied scores among them), a leaf's value and a
split's gain, the walk of raw rows, the held-out metrics."""
import math

import numpy as np
import pytest
import torch

from gbdt_bench.reference import metrics as ref_metrics
from gbdt_bench.reference.model_text import parse_model
from gbdt_bench.reference.objectives import objective_for
from gbdt_bench.reference.train_check import TrainCheck
from gbdt_bench.reference.walk import StackedTrees, route

CPU = torch.device("cpu")
RANK = {"objective": "lambdarank", "sigmoid": 1.0,
        "lambdarank_truncation_level": 30, "lambdarank_norm": True}


def test_binary_gradients_by_hand():
    obj = objective_for("binary")(np.array([1.0, 0.0]), None, {}, CPU)
    g, h, ga, ha = obj.gradients(torch.tensor([0.0, 2.0], dtype=torch.float64))
    # y = +1 at s = 0: -1 / (1 + e^0); y = -1 at s = 2: 1 / (1 + e^-2)
    assert g[0].item() == pytest.approx(-0.5, abs=1e-15)
    assert g[1].item() == pytest.approx(1 / (1 + math.exp(-2)), abs=1e-15)
    assert h[0].item() == pytest.approx(0.25, abs=1e-15)
    r = 1 / (1 + math.exp(-2))
    assert h[1].item() == pytest.approx(r * (1 - r), abs=1e-15)
    assert torch.equal(ga, g.abs())
    assert obj.init_score() == pytest.approx(0.0, abs=1e-15)


def test_lambdarank_two_docs_by_hand():
    obj = objective_for("lambdarank")(np.array([1, 0]), [2], RANK, CPU)
    g, h, ga, _ = obj.gradients(torch.zeros(2, dtype=torch.float64))
    dndcg = 1.0 * (1.0 - 1.0 / math.log2(3.0))     # gain 1, discounts
    lam = 0.5 * dndcg                                # p = 1/2 at a tie
    S = 2 * lam
    f = math.log2(1 + S) / S
    assert g[0].item() == pytest.approx(-lam * f, rel=1e-14)
    assert g[1].item() == pytest.approx(lam * f, rel=1e-14)
    assert h[0].item() == pytest.approx(dndcg * 0.25 * f, rel=1e-14)
    assert ga[0].item() == pytest.approx(lam * f, rel=1e-14)


def _plain_lambdarank(labels, scores, trunc=30, sigma=1.0):
    """One query, loop by loop: ranks by a stable sort on -score."""
    n = len(labels)
    order = sorted(range(n), key=lambda i: -scores[i])
    rank = {d: r for r, d in enumerate(order)}
    gain = [2.0 ** l - 1 for l in labels]
    disc = [1 / math.log2(2 + r) for r in range(n)]
    ideal = sorted(gain, reverse=True)
    mx = sum(ideal[r] * disc[r] for r in range(min(trunc, n)))
    inv = 1 / mx if mx > 0 else 0.0
    spread = max(scores) != min(scores)
    g, h = [0.0] * n, [0.0] * n
    S = 0.0
    for a in range(n):
        for b in range(n):
            if labels[a] <= labels[b] or min(rank[a], rank[b]) >= trunc:
                continue
            ds = scores[a] - scores[b]
            d = abs(gain[a] - gain[b]) * abs(disc[rank[a]] - disc[rank[b]]) \
                * inv
            if spread:
                d /= 0.01 + abs(ds)
            p = 1 / (1 + math.exp(sigma * ds))
            lam = sigma * d * p
            g[a] -= lam
            g[b] += lam
            h[a] += sigma * sigma * d * p * (1 - p)
            h[b] += sigma * sigma * d * p * (1 - p)
            S += 2 * lam
    f = math.log2(1 + S) / S if S > 0 else 1.0
    return [v * f for v in g], [v * f for v in h]


@pytest.mark.parametrize("labels,scores", [
    ([1, 2, 0], [0.3, 0.3, 0.1]),           # docs 0 and 1 tie: 0 ranks first
    ([0, 2, 1, 2], [0.2, 0.2, 0.2, 0.2]),   # all tied: no 0.01 + |ds| norm
    ([3, 0, 1, 4, 0], [1.5, -0.2, 0.7, 0.7, 0.0]),
])
def test_lambdarank_matches_loops_with_ties(labels, scores):
    sizes = [len(labels), 2]
    lab = np.array(labels + [1, 0])
    obj = objective_for("lambdarank")(lab, sizes, RANK, CPU)
    s = torch.tensor(scores + [0.0, 0.0], dtype=torch.float64)
    g, h, _, _ = obj.gradients(s)
    pg, ph = _plain_lambdarank(labels, scores)
    np.testing.assert_allclose(g[:len(labels)].numpy(), pg, rtol=1e-13,
                               atol=1e-16)
    np.testing.assert_allclose(h[:len(labels)].numpy(), ph, rtol=1e-13,
                               atol=1e-16)


def _stump_text(thr, values, counts, gain, dtype=0):
    return ("tree\nversion=v3\nnum_class=1\nmax_feature_idx=1\n"
            "objective=binary sigmoid:1\n\nTree=0\nnum_leaves=2\nnum_cat=0\n"
            "split_feature=1\nsplit_gain=%r\nthreshold=%r\ndecision_type=%d\n"
            "left_child=-1\nright_child=-2\nleaf_value=%r %r\n"
            "leaf_count=%d %d\ninternal_count=%d\nis_linear=0\nshrinkage=1\n"
            "\nend of trees\n" % (gain, thr, dtype, values[0], values[1],
                                  counts[0], counts[1], sum(counts)))


def test_walk_by_hand():
    tree = parse_model(_stump_text(1.5, (0.1, 0.2), (2, 2), 1.0, 8)
                       )["trees"][0]
    X = torch.tensor([[0, 1.0], [0, 1.5], [0, 2.0], [0, float("nan")]])
    # decision type 8: NaN missing, default right
    assert route(X, tree).tolist() == [0, 0, 1, 1]
    tree = parse_model(_stump_text(1.5, (0.1, 0.2), (2, 2), 1.0, 8 | 2)
                       )["trees"][0]
    assert route(X, tree).tolist() == [0, 0, 1, 0]
    # zero missing (4) with default left: 0 goes left whatever the
    # threshold; NaN counts as 0 there
    tree = parse_model(_stump_text(-1.0, (0.1, 0.2), (2, 2), 1.0, 4 | 2)
                       )["trees"][0]
    X0 = torch.tensor([[0, 0.0], [0, -2.0], [0, 3.0], [0, float("nan")]])
    assert route(X0, tree).tolist() == [0, 0, 1, 0]
    st = StackedTrees([tree, tree], CPU)
    assert st.leaves(X0).tolist() == [[0, 0, 1, 0]] * 2
    assert st.raw_sum(X0).tolist() == [0.2, 0.2, 0.4, 0.2]


def test_leaf_value_and_gain_by_hand():
    X = torch.tensor([[0, 0.0], [0, 1.0], [0, 2.0], [0, 3.0]])
    y = np.array([1.0, 1.0, 0.0, 1.0])
    init = math.log(0.75 / 0.25)
    # every row starts at the f32 start score: y = 1 rows have grad
    # -(1 - p), the y = 0 row p
    p = 1 / (1 + math.exp(-float(np.float32(init))))
    gl, hl = 2 * -(1 - p), 2 * p * (1 - p)
    gr, hr = p - (1 - p), 2 * p * (1 - p)
    lr = 0.1
    vl, vr = -lr * gl / hl + init, -lr * gr / hr + init
    gain = gl ** 2 / hl + gr ** 2 / hr - (gl + gr) ** 2 / (hl + hr)
    text = _stump_text(1.5, (vl, vr), (2, 2), gain)
    params = {"objective": "binary", "learning_rate": lr, "metric": "auc"}
    lv = np.array([vl - init, vr - init], dtype=np.float32)
    score = (np.float32(init) + lv[[0, 0, 1, 1]]).astype(np.float32)
    chk = TrainCheck().run(X, y, None, params, text, score, 1)
    n = chk.numbers()
    assert n["count_gap"] == 0 and n["score_gap"] == 0 and n["tree_gap"] == 0
    assert n["leaf_gap"] < 1e-6 and n["gain_gap"] < 1e-6
    bad = _stump_text(1.5, (vl * (1 + 1e-4), vr), (2, 2), gain)
    assert TrainCheck().run(X, y, None, params, bad, score, 1
                            ).numbers()["leaf_gap"] > 100
    bad = _stump_text(1.5, (vl, vr), (3, 1), gain)
    assert TrainCheck().run(X, y, None, params, bad, score, 1
                            ).numbers()["count_gap"] == 1
    n = TrainCheck().run(X, y, None, params, text, score, 2).numbers()
    assert n["tree_gap"] == 1


def test_metrics_by_hand():
    # pairs (pos, neg): (0.9, 0.1) win, (0.9, 0.5) win, (0.5, 0.1) win,
    # (0.5, 0.5) tie at half
    assert ref_metrics.auc(np.array([1, 1, 0, 0]),
                           np.array([0.9, 0.5, 0.5, 0.1])) == 0.875
    # one query, labels 2, 0, 1 ranked by score 0.1, 0.3 (tie), 0.3:
    # the two tied docs keep their order, so doc 1 (label 0) ranks first
    out = ref_metrics.ndcg(np.array([2, 0, 1]), np.array([0.1, 0.3, 0.3]),
                           np.array([3]), [1, 3])
    d = [1, 1 / math.log2(3), 0.5]
    assert out[1] == 0.0
    assert out[3] == pytest.approx((0 + 1 * d[1] + 3 * d[2])
                                   / (3 + 1 * d[1]), rel=1e-15)


def _stumps_text(stumps):
    """A model of stumps, each (feature, threshold, (left, right) values,
    (left, right) counts, gain)."""
    blocks = []
    for i, (f, thr, values, counts, gain) in enumerate(stumps):
        blocks.append(
            "Tree=%d\nnum_leaves=2\nnum_cat=0\nsplit_feature=%d\n"
            "split_gain=%r\nthreshold=%r\ndecision_type=0\nleft_child=-1\n"
            "right_child=-2\nleaf_value=%r %r\nleaf_count=%d %d\n"
            "internal_count=%d\nis_linear=0\nshrinkage=1\n\n"
            % (i, f, gain, thr, values[0], values[1], counts[0], counts[1],
               sum(counts)))
    return ("tree\nversion=v3\nnum_class=1\nmax_feature_idx=1\n"
            "objective=binary sigmoid:1\n\n" + "".join(blocks)
            + "end of trees\n")


# feature 0 parts the labels at 3.5; feature 1 is noise
_X8 = torch.tensor([[0, 3.0], [1, 1], [2, 4], [3, 1], [4, 5], [5, 9],
                    [6, 2], [7, 6]])
_Y8 = np.array([1.0, 1, 1, 1, 0, 0, 0, 0])
_FLOORS = {"objective": "binary", "learning_rate": 0.1, "metric": "auc",
           "min_data_in_leaf": 1, "min_sum_hessian_in_leaf": 0.1}


def _split_numbers(stumps, **params):
    p = dict(_FLOORS, **params)
    text = _stumps_text(stumps)
    score = np.zeros(8, np.float32)
    for f, thr, values, _, _ in stumps:
        left = _X8[:, f].numpy() <= thr
        score += np.where(left, np.float32(values[0]), np.float32(values[1]))
    return TrainCheck().run(_X8, _Y8, None, p, text, score, len(stumps)
                            ).numbers()


def test_best_split_by_hand():
    # every row starts at score 0: y = 1 rows grad -0.5, y = 0 rows 0.5,
    # hess 0.25; feature 0 at 3.5 gains 2^2 / 1 + 2^2 / 1 - 0 = 8
    best = (0, 3.5, (0.2, -0.2), (4, 4), 8.0)
    assert _split_numbers([best])["split_gap"] == 0.0
    # feature 1 at 2.5: left rows 1, 3, 6 (G -0.5, H 0.75), right G 0.5,
    # H 1.25: gain 1/3 + 1/5; a later tree makes feature 0's 3.5 a
    # candidate, and it gains 8 at that root
    worse = (1, 2.5, (1 / 15, -0.04), (3, 5), 0.25 / 0.75 + 0.25 / 1.25)
    n = _split_numbers([worse, best])
    assert n["split_gap"] > 1e6
    # a candidate whose side falls under min_sum_hessian_in_leaf is none:
    # with a floor of 1.1 (above 4 rows x 0.25) feature 0's 3.5 is out
    assert _split_numbers([worse, best], min_sum_hessian_in_leaf=1.1
                          )["split_gap"] == 0.0


def test_leaf_floors_by_hand():
    best = (0, 3.5, (0.2, -0.2), (4, 4), 8.0)
    assert _split_numbers([best])["leaf_floor_gap"] == 0.0
    # each leaf's hessian sum is 1.0: 0.5 under a floor of 1.5, in units
    # of u times the leaf's path sum of hessians (2 + 1)
    n = _split_numbers([best], min_sum_hessian_in_leaf=1.5)
    assert n["leaf_floor_gap"] == pytest.approx(0.5 / (2.0 ** -24 * 3.0))
    assert _split_numbers([best], min_data_in_leaf=5
                          )["leaf_floor_gap"] == math.inf
