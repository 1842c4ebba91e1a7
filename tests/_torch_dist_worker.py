"""One rank of the port's multi-process tests
(tests/test_torch_distributed.py), on the CPU over gloo.

    python tests/_torch_dist_worker.py RANK WORLD INIT_FILE OUT MODE

``MODE``:

- ``f32``: the rows of :func:`make_data` split in two equal halves; one
  tree of ``DistributedDataParallelLearner`` from fixed gradients (its
  arrays, the rank's ``local_leaf_assignment`` and the learner's counts
  to ``OUT.npz``), then ``dtrain.train`` (binary, 4 rounds), its model
  text to ``OUT.txt``;
- ``quantized``: the binning rows split 500 / 100 (unequal sample takes,
  so the all-gather's pad and trim run): the gathered mapper layout and
  the local bins to ``OUT.npz``, then ``dtrain.train`` with
  ``use_quantized_grad`` (the f32 fallback), its text to ``OUT.txt``.

Imports no JAX. Prints ``RANK_DONE`` at the end.
"""
import os
import sys

import numpy as np

N_ROWS, N_FEATURES = 600, 5
BIN_SEED, BIN_SPLIT = 7, 500


def make_data():
    """Training rows and binary labels (both classes in each half)."""
    rng = np.random.RandomState(0)
    X = rng.randn(N_ROWS, N_FEATURES)
    y = (X[:, 0] - 0.7 * X[:, 1] + 0.2 * rng.randn(N_ROWS) > 0).astype(float)
    return X, y


def make_binning_data():
    """tests/distributed/_binning_worker.py's rows."""
    rng = np.random.RandomState(BIN_SEED)
    X = rng.randn(N_ROWS, N_FEATURES)
    X[:, 3] = np.round(X[:, 3] * 2.0)
    X[rng.rand(N_ROWS) < 0.2, 1] = 0.0
    y = (X[:, 0] + 0.3 * X[:, 2] > 0).astype(float)
    return X, y


def params(mode):
    base = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
            "verbose": -1, "device_type": "cpu", "learning_rate": 0.2}
    if mode == "f32":
        return dict(base, bin_construct_sample_cnt=N_ROWS)
    # verbosity 0 shows the fallback's warning
    return dict(base, bin_construct_sample_cnt=256, max_bin=16,
                use_quantized_grad=True, verbose=0)


def halves(a, rank, split):
    return a[:split] if rank == 0 else a[split:]


def main():
    rank, world, init_file, out, mode = (int(sys.argv[1]),
                                         int(sys.argv[2]), sys.argv[3],
                                         sys.argv[4], sys.argv[5])
    import torch
    torch.set_num_threads(1)
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.parallel import distributed, dtrain

    distributed.initialize("file://" + init_file, world, rank,
                           backend="gloo")
    if mode == "f32":
        X, y = make_data()
        split = N_ROWS // 2
    else:
        X, y = make_binning_data()
        split = BIN_SPLIT
    lx, ly = halves(X, rank, split), halves(y, rank, split)
    cfg = Config.from_params(params(mode))
    ds = distributed.distributed_binned_dataset(lx, cfg, label=ly)
    arrays = {}
    if mode == "f32":
        learner = distributed.DistributedDataParallelLearner(
            cfg, ds, torch.device("cpu"))
        grad = torch.from_numpy(np.where(ly > 0, -0.5, 0.5).astype(
            np.float32))
        tree, part = learner.train(grad, torch.full_like(grad, 0.25))
        ni = tree.num_internal
        arrays.update(
            split_feature=tree.split_feature[:ni],
            threshold_in_bin=tree.threshold_in_bin[:ni],
            leaf_value=tree.leaf_value[:tree.num_leaves],
            local_leaf=learner.local_leaf_assignment(part),
            allreduces=np.asarray([learner.comm_stats["allreduces"]]),
            steps=np.asarray([learner.grow_stats["steps"]]),
            captures=np.asarray([learner.grow_stats["captures"]]))
    else:
        bounds = [np.asarray(m.bin_upper_bound, dtype=np.float64)
                  for m in ds.bin_mappers]
        arrays.update(
            sizes=np.asarray([len(b) for b in bounds], dtype=np.int64),
            bounds=np.concatenate(bounds),
            used=np.asarray(ds.used_feature_map, dtype=np.int64),
            bins=ds.bins.astype(np.int64))
    np.savez(out + ".npz", **arrays)
    booster = dtrain.train(params(mode), lx, ly, num_boost_round=4)
    with open(out + ".txt", "w") as fh:
        fh.write(booster.model_to_string())
    np.save(out + ".pred.npy", booster.predict(X))
    torch.distributed.destroy_process_group()
    print("RANK_DONE", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
