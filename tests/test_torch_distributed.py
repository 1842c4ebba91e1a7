"""The port's multi-process training (``parallel/distributed.py``,
``parallel/dtrain.py``) on the CPU: two ranks as subprocesses over gloo,
the group started from a ``file://`` store in ``tmp_path`` (no port to
race for under xdist), each rank bounded by its own
``communicate(timeout=...)``.

- Both ranks' model text is identical, and equal to ``lgb.train`` with
  an in-process two-shard data learner over the same rows and mappers
  (level a: a sum of two partials is the same in either order).
- One tree of the distributed learner equals the in-process two-shard
  learner's (level a), each rank's ``local_leaf_assignment`` is its
  slice of the full partition, the loop ran eagerly (no capture) with
  one all-reduce per split plus two at the root.
- Quantized gradients fall back to f32 with the reference's warning.
- ``distributed_binned_dataset``'s gathered layout (unequal takes, so
  the pad and trim run) gives the mappers and bins of the JAX package's
  construction from the same rank-ordered sample (level a, the case of
  tests/test_distributed_multiproc.py:233).
- A rank whose peer never starts exits non-zero within the collective
  timeout.

The JAX package's own multi-process tests cannot run here (its CPU
backend refuses multi-process collectives), so the port's multi-process
learner is held to its in-process counterpart, which
tests/test_torch_parallel.py holds to the JAX package.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.parallel import DataParallelTreeLearner, make_mesh

import _torch_dist_worker as W

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")


def _env(timeout_s=60):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("LIGHTGBM_TPU_", "MASTER_", "RANK",
                                "WORLD_SIZE"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["LIGHTGBM_TPU_DTRAIN_TIMEOUT_S"] = str(timeout_s)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run(tmp_path, mode, ranks=(0, 1), world=2, timeout_s=60):
    """Start ``ranks`` of a ``world``-rank group; returns (returncodes,
    logs, output stems)."""
    init = str(tmp_path / "rendezvous")
    outs = [str(tmp_path / ("r%d" % r)) for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), init, outs[r], mode],
        env=_env(timeout_s), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in ranks]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout_s + 60)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        logs.append(out)
    return [p.returncode for p in procs], logs, outs


def _trees(text):
    return text.split("end of trees")[0]


def test_two_ranks_f32_equal_the_in_process_two_shard_learner(tmp_path):
    rcs, logs, outs = _run(tmp_path, "f32")
    for r, (rc, log) in enumerate(zip(rcs, logs)):
        assert rc == 0 and "RANK_DONE" in log, "rank %d:\n%s" % (r, log)
    texts = [open(o + ".txt").read() for o in outs]
    assert texts[0] == texts[1]
    np.testing.assert_array_equal(np.load(outs[0] + ".pred.npy"),
                                  np.load(outs[1] + ".pred.npy"))
    w = [np.load(o + ".npz") for o in outs]

    X, y = W.make_data()
    params = W.params("f32")
    # the in-process run: every row, two shards, the same mappers (the
    # sample is every row in both)
    single = lgb.train(dict(params, tree_learner="data",
                            mesh_shape="data=2"),
                       lgb.Dataset(X, label=y), num_boost_round=4)
    assert _trees(single.model_to_string()) == _trees(texts[0])

    cfg = Config.from_params(params)
    learner = DataParallelTreeLearner(cfg, BinnedDataset.from_matrix(X, cfg),
                                      torch.device("cpu"),
                                      make_mesh(2, "cpu"))
    grad = torch.from_numpy(np.where(y > 0, -0.5, 0.5).astype(np.float32))
    tree, part = learner.train(grad, torch.full_like(grad, 0.25))
    ni = tree.num_internal
    half = W.N_ROWS // 2
    for r in range(2):
        assert w[r]["split_feature"].tolist() == \
            tree.split_feature[:ni].tolist()
        assert w[r]["threshold_in_bin"].tolist() == \
            tree.threshold_in_bin[:ni].tolist()
        assert w[r]["leaf_value"].tolist() == \
            tree.leaf_value[:tree.num_leaves].tolist()
        np.testing.assert_array_equal(
            w[r]["local_leaf"], part.numpy()[r * half:(r + 1) * half])
        # eager: no graph; the root's sums and histogram, then one
        # all-reduce per split step
        assert int(w[r]["captures"][0]) == 0
        assert int(w[r]["allreduces"][0]) == 2 + int(w[r]["steps"][0])


def test_two_ranks_quantized_fall_back_and_bin_like_the_reference(tmp_path):
    from lightgbm_tpu.config import Config as RefConfig
    from lightgbm_tpu.io.dataset import BinnedDataset as RefDataset

    rcs, logs, outs = _run(tmp_path, "quantized")
    for r, (rc, log) in enumerate(zip(rcs, logs)):
        assert rc == 0 and "RANK_DONE" in log, "rank %d:\n%s" % (r, log)
        assert "falls back to exact f32 histograms" in log
    texts = [open(o + ".txt").read() for o in outs]
    assert texts[0] == texts[1]
    w = [np.load(o + ".npz") for o in outs]

    # the reference's construction from the same rank-ordered sample
    X, _ = W.make_binning_data()
    rcfg = RefConfig.from_params({"bin_construct_sample_cnt": 256,
                                  "max_bin": 16, "verbosity": -1})
    per_proc = rcfg.bin_construct_sample_cnt // 2
    parts = []
    for rank in range(2):
        local = W.halves(X, rank, W.BIN_SPLIT)
        take = min(per_proc, len(local))
        rng = np.random.RandomState(rcfg.data_random_seed + rank)
        idx = (np.sort(rng.choice(len(local), take, replace=False))
               if take < len(local) else np.arange(len(local)))
        parts.append(local[idx])
    assert len(parts[0]) != len(parts[1])
    sample = np.concatenate(parts)
    template = RefDataset.from_matrix(sample, RefConfig.from_params(dict(
        rcfg.raw_params, bin_construct_sample_cnt=len(sample))))
    bounds = np.concatenate([np.asarray(m.bin_upper_bound)
                             for m in template.bin_mappers])
    for rank in range(2):
        np.testing.assert_array_equal(w[rank]["bounds"], bounds)
        assert w[rank]["sizes"].tolist() == [
            len(m.bin_upper_bound) for m in template.bin_mappers]
        assert w[rank]["used"].tolist() == list(template.used_feature_map)
        expected = RefDataset.from_matrix(
            W.halves(X, rank, W.BIN_SPLIT), rcfg, reference=template).bins
        np.testing.assert_array_equal(w[rank]["bins"],
                                      expected.astype(np.int64))


def test_a_rank_whose_peer_never_starts_exits_nonzero(tmp_path):
    t0 = time.perf_counter()
    rcs, logs, _ = _run(tmp_path, "f32", ranks=(0,), timeout_s=5)
    assert rcs[0] not in (0, None), logs[0]
    assert "RANK_DONE" not in logs[0]
    assert time.perf_counter() - t0 < 60


@pytest.mark.parametrize("case", ["local_rank", "rank_modulo", "device_id",
                                  "shared_card", "gloo"])
def test_each_nccl_rank_takes_its_own_card(monkeypatch, case):
    """Under NCCL a rank's card is ``gpu_device_id``'s when set, else
    ``LOCAL_RANK``, else the rank modulo the visible cards, and becomes
    the current device; two ranks of one host on one card raise. Under
    gloo ranks keep ``gpu_device_id``'s card (the first). The group and
    the cards are stood in for: NCCL needs two cards."""
    from lightgbm_tpu_torch.parallel import distributed as D
    from lightgbm_tpu_torch.utils.log import LightGBMError
    picked, peer = [], ("other-host", 1)
    monkeypatch.setattr(D.dist, "get_backend",
                        lambda *a: "gloo" if case == "gloo" else "nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    monkeypatch.setattr(D, "rank", lambda: 3)
    monkeypatch.setattr(D, "world_size", lambda: 2)
    monkeypatch.setattr(D, "host_group", lambda: None)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    params = {"device_type": "cuda"}
    if case == "local_rank":
        monkeypatch.setenv("LOCAL_RANK", "0")
    if case == "device_id":
        params["gpu_device_id"] = 1
    if case == "shared_card":
        monkeypatch.setattr(D.socket, "gethostname", lambda: "this-host")
        peer = ("this-host", 1)

    def gather(out, obj, group=None):
        out[:] = [obj, peer]
    monkeypatch.setattr(D.dist, "all_gather_object", gather)
    cfg = Config.from_params(params)
    if case == "shared_card":
        with pytest.raises(LightGBMError, match="a card per rank"):
            D.rank_device(cfg)
        return
    want = {"local_rank": 0, "rank_modulo": 1, "device_id": 1, "gloo": 0}
    assert D.rank_device(cfg) == torch.device("cuda", want[case])
    assert picked == ([] if case == "gloo"
                      else [torch.device("cuda", want[case])])
