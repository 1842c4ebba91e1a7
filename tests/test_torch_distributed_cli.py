"""The port's distributed CLI on the CPU: a two-rank fake cluster driven
only through conf files (the JAX package's
``tests/test_distributed_cli.py``; reference:
tests/distributed/_test_distributed.py:53 DistributedMockup: a shared
machine list, a ``local_listen_port`` per rank, rank 0's model checked).

Each rank is ``python -m lightgbm_tpu_torch.application config=...`` in
a subprocess with ``device_type=cpu`` (so gloo, by the layout rule),
bounded by ``communicate(timeout=...)``. With ``pre_partition=false``
each rank keeps the rows ``rank::2`` of the shared file. Rank 0's model
text must equal ``lgb.train`` with an in-process two-shard data learner
over the same two row sets (rank 0's rows as shard 0, rank 1's as
shard 1) and the same mappers (level a: the sum of two partials is the
same in either order). Each rank's ``dtrain_done`` event (its event
log) reports its trees, roots, split steps and no capture. The CLI's
``predict`` task then reads the distributed model.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.application import _load_tabular, run
from lightgbm_tpu_torch.config import Config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ROWS = 600
TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("LIGHTGBM_TPU_", "MASTER_", "RANK",
                                "WORLD_SIZE", "LOCAL_RANK"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["LIGHTGBM_TPU_DTRAIN_TIMEOUT_S"] = "60"
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_cli_two_machine_train_and_predict(tmp_path):
    d = str(tmp_path)
    rng = np.random.RandomState(5)
    X = rng.randn(N_ROWS, 5)
    y = (X[:, 0] - 0.6 * X[:, 1] + 0.25 * rng.randn(N_ROWS)
         > 0).astype(float)
    train = os.path.join(d, "train.tsv")
    np.savetxt(train, np.column_stack([y, X]), delimiter="\t", fmt="%.8g")
    ports = [_free_port(), _free_port()]
    with open(os.path.join(d, "mlist.txt"), "w") as f:
        for p in ports:
            f.write("127.0.0.1 %d\n" % p)
    model = os.path.join(d, "model.txt")
    params = {"objective": "binary", "num_leaves": 15,
              "min_data_in_leaf": 5, "verbosity": -1,
              "bin_construct_sample_cnt": N_ROWS, "device_type": "cpu"}
    base = "".join("%s=%s\n" % kv for kv in params.items())
    base += ("task=train\ndata=%s\nnum_trees=10\ntree_learner=data\n"
             "num_machines=2\nmachine_list_file=%s\npre_partition=false\n"
             "output_model=%s\n"
             % (train, os.path.join(d, "mlist.txt"), model))
    confs = []
    for r, p in enumerate(ports):
        cpath = os.path.join(d, "train%d.conf" % r)
        with open(cpath, "w") as f:
            f.write(base + "local_listen_port=%d\n" % p)
        confs.append(cpath)
    events = [os.path.join(d, "events%d.jsonl" % r) for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch.application",
         "config=" + c, "verbosity=1"],
        env=dict(_env(), LIGHTGBM_TPU_EVENT_LOG=ev), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c, ev in zip(confs, events)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        logs.append(out)
    for r, p in enumerate(procs):
        assert p.returncode == 0, "rank %d failed:\n%s" % (r, logs[r])
        # the backend was chosen by the layout and said so
        assert "rank %d of 2 over gloo (device_type=cpu)" % r in logs[r]
    assert os.path.exists(model)
    # each rank's summary event: 10 trees, each a root, the eager loop
    for r, ev in enumerate(events):
        with open(ev) as fh:
            done = [json.loads(line) for line in fh
                    if '"dtrain_done"' in line]
        assert len(done) == 1 and done[0]["rank"] == r
        assert (done[0]["trees"], done[0]["roots"], done[0]["captures"]) \
            == (10, 10, 0)
        assert done[0]["steps"] >= 10

    # the in-process two-shard learner over the same rows: the parsed
    # file, rank 0's rows (0, 2, 4, ...) then rank 1's
    Xf, yf, _, _ = _load_tabular(train, Config.from_params({}))
    order = np.concatenate([np.arange(0, N_ROWS, 2),
                            np.arange(1, N_ROWS, 2)])
    single = lgb.train(dict(params, tree_learner="data",
                            mesh_shape="data=2"),
                       lgb.Dataset(Xf[order], label=yf[order]),
                       num_boost_round=10)
    with open(model) as fh:
        text = fh.read()
    assert single.model_to_string().split("end of trees")[0] == \
        text.split("end of trees")[0]

    # the saved model predicts well on the full data
    bst = lgb.Booster(model_file=model, params={"device_type": "cpu"})
    pred = bst.predict(X)
    assert pred[y == 1].mean() - pred[y == 0].mean() > 0.3

    # the CLI predict task reads the distributed model too
    test = os.path.join(d, "test.tsv")
    np.savetxt(test, np.column_stack([np.zeros(100), X[:100]]),
               delimiter="\t", fmt="%.8g")
    out_path = os.path.join(d, "preds.txt")
    assert run(["task=predict", "data=" + test, "input_model=" + model,
                "output_result=" + out_path, "verbosity=-1",
                "device_type=cpu"]) == 0
    np.testing.assert_allclose(np.loadtxt(out_path), pred[:100], rtol=0,
                               atol=1e-9)
