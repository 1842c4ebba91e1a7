"""Shared setup of the port's serving tests: one model served by both
packages.

The model is trained once by the JAX package; the port loads its v3 text,
so both packages' servers walk the same trees and their answers can be
compared byte for byte. :class:`Side` gives one package's serving
classes, telemetry and fault injection under the same names, so a test
runs one scenario through each and compares what came out.
"""
import contextlib
import types

import numpy as np

import lightgbm_tpu as ref_lgb
import lightgbm_tpu_torch as lgb

#: every Future wait and thread join of these tests is bounded
kWait = 60.0

kParams = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
           "min_data_in_leaf": 5, "max_bin": 63, "categorical_feature": [4]}


def data(n=640, seed=11):
    """f32-representable rows with NaNs and a categorical column."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32).astype(np.float64)
    X[rng.rand(n) < 0.15, 2] = np.nan
    X[:, 4] = rng.randint(0, 9, n)
    y = (X[:, 0] + 0.5 * np.nan_to_num(X[:, 2])
         + (X[:, 4] % 3 == 1) > 0.2).astype(float)
    return X, y


def shared_model(rounds=12, **extra):
    """(X, {"ref": JAX booster, "port": port booster of its text}, host
    predictions of the JAX booster)."""
    X, y = data()
    params = dict(kParams, **extra)
    ref = ref_lgb.train(params, ref_lgb.Dataset(X, label=y),
                        num_boost_round=rounds)
    port = lgb.Booster(model_str=ref.model_to_string(),
                       params={"device_type": "cpu"})
    host = ref.predict(X, predict_on_device=False)
    assert np.array_equal(port.predict(X, predict_on_device=False), host)
    return X, {"ref": ref, "port": port}, host


class Side:
    """One package's serving plane under common names."""

    def __init__(self, name: str):
        self.name = name
        if name == "ref":
            from lightgbm_tpu import serve
            from lightgbm_tpu.models.tree import Tree
            from lightgbm_tpu.obs import events, faults
            from lightgbm_tpu.obs.registry import registry
            self.kw = {}
        else:
            from lightgbm_tpu_torch import serve
            from lightgbm_tpu_torch.models.tree import Tree
            from lightgbm_tpu_torch.obs import events, faults
            from lightgbm_tpu_torch.obs.registry import registry
            self.kw = {"devices": ["cpu"]}
        self.serve, self.Tree = serve, Tree
        self.events, self.faults, self.registry = events, faults, registry

    def __getattr__(self, item):
        # the serving classes and errors by name: side.PredictServer, ...
        return getattr(self.serve, item)

    def server(self, model, **kw):
        return self.serve.PredictServer(model, **dict(self.kw, **kw))

    def forest(self, booster, **kw):
        return self.serve.StackedForest.from_gbdt(booster, **kw)

    @contextlib.contextmanager
    def recording(self):
        """Collect the events emitted inside the block and the change of
        every counter (``out.events``, ``out.delta(name)``)."""
        out = types.SimpleNamespace(events=[])
        before = dict(self.registry.counters)
        self.events.register_event_callback(out.events.append)
        try:
            yield out
        finally:
            self.events.register_event_callback(None)
            after = dict(self.registry.counters)
            out.delta = lambda name: (after.get(name, 0)
                                      - before.get(name, 0))

    def reset(self):
        self.faults.reset()
        self.events.register_event_callback(None)


SIDES = ("ref", "port")


def kinds(events, wanted):
    """The kinds of ``events`` that are in ``wanted``, in order."""
    return [e["event"] for e in events if e["event"] in wanted]


def outcome(fut, timeout=kWait):
    """A resolved Future as ("ok", value) or (error class name, None)."""
    try:
        return "ok", fut.result(timeout=timeout)
    except Exception as e:  # noqa: BLE001 — the type is the outcome
        return type(e).__name__, None
