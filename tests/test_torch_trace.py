"""The port's span trace (``lightgbm_tpu_torch/obs/trace.py``) and its
compact segments (``obs/trace_compact.py``) on the CPU, against the JAX
package's where the two can be compared.

- a traced training run exports Chrome-trace JSON that parses, with a
  span per stage scope, parent links (``tree::root_histogram`` under
  ``tree::grow``), instant events and the readiness lane of sample mode;
- the streaming spool finalizes segments atomically (no ``.tmp`` left,
  every segment parses) and counts whole dropped chunks when its writer
  is saturated;
- ``trace_compact.encode_events`` gives the reference's bytes on the
  same events (level a), and each package decodes the other's segment
  to the same document.
"""
import json
import os
import time

import numpy as np
import pytest

from lightgbm_tpu.obs import trace_compact as ref_compact

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.obs import events, trace, trace_compact
from lightgbm_tpu_torch.obs.registry import registry


@pytest.fixture(autouse=True)
def _clean():
    yield
    trace.configure(None)
    trace.configure_stream(None)
    trace.set_process_index(0)
    events.register_event_callback(None)
    registry.drain_ready(timeout=10.0)
    registry.disable()
    registry.timer.sampling = False


def _train(rounds=2):
    rng = np.random.RandomState(0)
    X = rng.randn(500, 6)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    return lgb.train({"objective": "binary", "num_leaves": 7,
                      "verbose": -1, "device_type": "cpu"},
                     lgb.Dataset(X, label=y), num_boost_round=rounds)


def _spans(doc):
    return [e for e in doc["traceEvents"] if e.get("ph") == "X"]


def test_trace_json_parses_with_parent_links(tmp_path):
    path = str(tmp_path / "trace.json")
    registry.reset()
    registry.enable(sampling=True)
    trace.configure(path)
    _train(rounds=2)
    trace.flush()
    with open(path) as f:
        doc = json.load(f)
    spans = _spans(doc)
    names = {e["name"] for e in spans}
    for required in ("io::apply_bins", "gbdt::gradients", "tree::grow",
                     "tree::stage_gh", "tree::root_histogram",
                     "tree::split_batches", "tree::apply_records",
                     "gbdt::score_update"):
        assert required in names, sorted(names)
    # the readiness lane: one span per watched stage at least
    for stage in ("gbdt::gradients", "tree::stage_gh",
                  "tree::root_histogram", "gbdt::score_update"):
        ready = [e for e in spans if e["name"] == stage + "::ready"]
        assert ready and all(e["cat"] == "ready" for e in ready), stage
    by_id = {e["args"]["span_id"]: e for e in spans}
    parents = {(e["name"], by_id[e["args"]["parent_span_id"]]["name"])
               for e in spans
               if e["args"].get("parent_span_id") in by_id}
    assert ("tree::root_histogram", "tree::grow") in parents
    assert ("tree::split_batches", "tree::grow") in parents
    instants = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "i"}
    assert {"train_iter", "dataset"} <= instants
    assert len({e["args"]["trace_id"] for e in spans}) == 1
    assert doc["otherData"]["producer"] == "lightgbm_tpu_torch/obs/trace.py"


def test_stream_segments_finalize_atomically(tmp_path):
    d = str(tmp_path / "segs")
    registry.reset()
    trace.configure_stream(d, segment_bytes=20_000)
    for _ in range(2000):
        with registry.scope("probe::seg"):
            pass
    trace.flush()
    files = sorted(os.listdir(d))
    assert not [f for f in files if f.endswith(".tmp")]
    assert len(files) >= 2
    total = 0
    for f in files:
        with open(os.path.join(d, f)) as fh:
            doc = json.load(fh)
        total += sum(1 for e in _spans(doc))
        assert doc["otherData"]["run_id"] == events.run_id()
    assert total == 2000


def test_stream_drops_whole_chunks_and_counts_them(tmp_path, monkeypatch):
    d = str(tmp_path / "segs")
    registry.reset()
    trace.configure_stream(d, segment_bytes=1 << 20, stage_events=32,
                           max_pending=2)
    sp = trace._spool
    real = sp._write_chunk

    def slow_write(chunk):
        time.sleep(0.05)
        real(chunk)

    monkeypatch.setattr(sp, "_write_chunk", slow_write)
    for _ in range(3200):
        with registry.scope("probe::flood"):
            pass
    monkeypatch.setattr(sp, "_write_chunk", real)
    trace.flush()
    dropped = registry.count("trace/dropped_events")
    assert dropped > 0 and dropped == sp.dropped and dropped % 32 == 0
    spans = dropped_meta = 0
    for f in os.listdir(d):
        with open(os.path.join(d, f)) as fh:
            doc = json.load(fh)
        spans += len(_spans(doc))
        dropped_meta = max(dropped_meta, doc["otherData"]["dropped_events"])
    assert dropped_meta == dropped
    assert spans == 3200 - dropped


def _events():
    return [
        {"name": "uniçode ☃", "ph": "X", "ts": 1.5, "dur": 0.25, "pid": 0,
         "tid": 3, "cat": "stage",
         "args": {"nested": {"list": [1, 2.0, "three", None, True],
                             "empty": {}, "neg": -(2 ** 40)},
                  "flag": False}},
        {"name": "ints", "ph": "i", "ts": 2, "pid": 0, "tid": 0,
         "args": {"zero": 0, "big": 2 ** 52, "tiny": -1}},
    ] + [{"name": "tree::grow", "ph": "X", "ts": float(i), "dur": 42.5,
          "pid": 0, "tid": 0, "cat": "stage",
          "args": {"span_id": i, "trace_id": "t-0", "parent_span_id": 0}}
         for i in range(50)]


def test_compact_encode_is_byte_equal_to_reference():
    header = {"trace_id": "abc", "run_id": "r", "n_events": 52}
    port = trace_compact.encode_events(_events(), header)
    ref = ref_compact.encode_events(_events(), header)
    assert port == ref
    assert port.startswith(trace_compact.MAGIC)
    hdr, back = trace_compact.decode_segment(port)
    assert hdr == header and back == _events()


def test_each_package_decodes_the_others_segment(tmp_path):
    """A compact segment the port's spool wrote reads the same through
    the reference's decoder, and a reference encoding through the
    port's."""
    d = str(tmp_path / "segs")
    registry.reset()
    trace.configure_stream(d, segment_format="compact")
    for _ in range(40):
        with registry.scope("probe::xpkg"):
            pass
    trace.flush()
    segs = [os.path.join(d, f) for f in os.listdir(d)]
    assert len(segs) == 1 and segs[0].endswith(trace_compact.EXTENSION)
    mine, theirs = (trace_compact.read_segment(segs[0]),
                    ref_compact.read_segment(segs[0]))
    assert mine == theirs
    assert len(_spans(mine)) == 40
    assert mine["otherData"]["format"] == "compact"
    ref_bytes = ref_compact.encode_events(_events(), {"n": 1})
    assert trace_compact.decode_segment(ref_bytes) == \
        ref_compact.decode_segment(ref_bytes)


def test_truncated_compact_segment_is_rejected():
    data = trace_compact.encode_events(_events(), {"n": 52})
    for cut in (len(data) // 3, len(data) - 1):
        with pytest.raises(ValueError):
            trace_compact.decode_segment(data[:cut])


def test_sample_iteration_records_no_memory_gauge_on_the_cpu():
    """Device memory gauges read the CUDA caching allocator; a CPU run
    has none, and the tick is a no-op with telemetry off."""
    registry.reset()
    trace.sample_iteration(0)
    assert not any(k.startswith("device/") for k in registry.gauges)
    registry.enable(sampling=True)
    assert trace.record_device_memory() == {}
