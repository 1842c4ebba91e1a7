"""Data & model quality plane: binned drift detection on the serving
path, reference profiles captured at training time, and the drift
scores that gate a refresh loop.

Port of ``lightgbm_tpu/obs/quality.py``. Every row is already quantized
into integer bins at training time (``BinMapper``, io/binning.py) and at
serving time (quantization on the card against the model's own
threshold grid, ops/predict.py). Distribution monitoring is therefore a
small ``[F, B]`` count reduction over arrays the hot path already
computes. The reductions are PyTorch ops on the tensors' device
(``scatter_add_`` of ones over the first ``n_valid`` rows; the JAX
package's are ``jnp`` under ``jax.jit``, not Pallas kernels): no host
read per block or chunk, one read-back at :meth:`ProfileBuilder.finalize`
and at :meth:`QualityMonitor.drain`.

Three pieces:

- :class:`ReferenceProfile` — per-feature bin-count histograms over the
  TRAINING grid (incl. NaN/zero/categorical sentinel mass), a label
  histogram, and (added at checkpoint time) a prediction-score
  histogram. Built by :class:`ProfileBuilder` from binned blocks, one
  device reduction per block, and serialized into the checkpoint dir
  (ft/checkpoint.py) so a resume reloads it.
- :class:`QualityMonitor` — live serving-side accumulation: per-chunk
  windowed per-feature bin counts kept ON DEVICE (one extra scatter-add
  per dispatched chunk, zero per-batch host read-back) plus host-side
  score/label histograms. Replica-safe: one shared state dict, one
  lock.
- drift math — :func:`psi` and :func:`js_divergence` over count
  vectors, computed host-side only at the exporter tick (``drain``),
  published as ``quality/...`` gauges that obs/export.py folds into
  ``{feature=}``-labeled OpenMetrics families and obs/health.py watches
  (``feature_drift`` / ``prediction_drift`` / ``label_drift`` /
  ``retrain_required``).

Grid note: the serving grid (model thresholds) is a *coarsening* of the
training grid — every numeric model threshold is one of the feature's
``bin_upper_bound`` values (serve/forest.py), so the training-grid
reference projects onto the serving grid by sending each training bin's
representative value (its midpoint) through ``searchsorted`` once, on
the host, at monitor-construction time. The monitor's quantizer is
pinned to the model it was built against: drift is always measured on
one fixed grid even while refresh cycles publish new leaf values.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional

import numpy as np

from . import events as obs_events
from .registry import registry as obs_registry

kScoreBins = 32      # fixed-width prediction-score histogram bins
kLabelBins = 32      # fixed-width label histogram bins
kEpsilon = 1e-4      # probability floor for PSI/JS smoothing

__all__ = [
    "psi", "js_divergence", "fixed_histogram", "histogram_edges",
    "ReferenceProfile", "ProfileBuilder", "QualityMonitor",
    "register_monitor", "unregister_monitor", "drain_all",
]


# ---------------------------------------------------------------------------
# drift math (host-side, f64, over small count vectors)
# ---------------------------------------------------------------------------

def _smooth(counts: np.ndarray, eps: float) -> Optional[np.ndarray]:
    """Counts -> probabilities with an ``eps`` floor (so empty bins in
    either distribution cannot blow up the logs). Returns None for an
    all-zero vector — the caller treats that window/profile as absent
    rather than inventing a uniform distribution."""
    c = np.asarray(counts, dtype=np.float64).ravel()
    total = c.sum()
    if not np.isfinite(total) or total <= 0:
        return None
    p = c / total
    p = np.clip(p, eps, None)
    return p / p.sum()


def psi(ref_counts, live_counts, eps: float = kEpsilon) -> float:
    """Population Stability Index between two count vectors over the
    same bin grid: ``sum((q - p) * ln(q / p))`` with ``eps``-floored
    probabilities (f64). 0 = identical; common rules of thumb flag
    ~0.1 as drifting and ~0.25 as shifted. Returns 0.0 when either
    side is empty (no evidence is not drift)."""
    p = _smooth(ref_counts, eps)
    q = _smooth(live_counts, eps)
    if p is None or q is None:
        return 0.0
    return float(np.sum((q - p) * np.log(q / p)))


def js_divergence(ref_counts, live_counts, eps: float = 1e-12) -> float:
    """Jensen-Shannon divergence (base-2 logs, so the result lives in
    [0, 1]) between two count vectors over the same grid. Symmetric and
    bounded, which makes it the cross-feature-comparable companion to
    the unbounded PSI. Returns 0.0 when either side is empty."""
    p = _smooth(ref_counts, eps)
    q = _smooth(live_counts, eps)
    if p is None or q is None:
        return 0.0
    m = 0.5 * (p + q)

    def _kl(a, b):
        mask = a > 0
        return float(np.sum(a[mask] * np.log2(a[mask] / b[mask])))

    return 0.5 * _kl(p, m) + 0.5 * _kl(q, m)


def histogram_edges(values: np.ndarray, bins: int) -> List[float]:
    """``bins - 1`` inner edges spanning the finite values (10% margin
    each side, so near-boundary mass on later windows lands inside
    rather than in the overflow lanes). Degenerate spans widen to +-1."""
    v = np.asarray(values, dtype=np.float64).ravel()
    v = v[np.isfinite(v)]
    if v.size == 0:
        lo, hi = 0.0, 1.0
    else:
        lo, hi = float(v.min()), float(v.max())
    span = hi - lo
    if span <= 0:
        span = max(abs(hi), 1.0)
        lo, hi = lo - span, hi + span
    else:
        lo, hi = lo - 0.1 * span, hi + 0.1 * span
    return [float(x) for x in np.linspace(lo, hi, max(bins - 1, 1))]


def fixed_histogram(values: np.ndarray, edges) -> np.ndarray:
    """Count finite ``values`` into ``len(edges) + 1`` bins (the outer
    two catch under/overflow, so total mass is preserved no matter how
    far a later window wanders off the reference's support)."""
    e = np.asarray(edges, dtype=np.float64)
    v = np.asarray(values, dtype=np.float64).ravel()
    v = v[np.isfinite(v)]
    idx = np.searchsorted(e, v, side="right")
    return np.bincount(idx, minlength=len(e) + 1).astype(np.int64)


# ---------------------------------------------------------------------------
# reference profiles (training grid)
# ---------------------------------------------------------------------------

class ReferenceProfile:
    """Per-feature bin-count histograms over the TRAINING (BinMapper)
    grid, plus label and (optionally) prediction-score histograms.

    Self-contained: it carries the slice of mapper state (bin upper
    bounds, missing type, categorical value map) needed to project each
    training bin onto any model's serving grid, so a profile loaded
    from an old spill manifest or checkpoint needs nothing else."""

    kVersion = 1

    def __init__(self, used: List[int], counts: List[np.ndarray],
                 mappers_meta: List[dict], num_rows: int,
                 label_hist: Optional[dict] = None,
                 score_hist: Optional[dict] = None,
                 feature_names: Optional[List[str]] = None) -> None:
        self.used = [int(f) for f in used]
        self.counts = [np.asarray(c, dtype=np.int64) for c in counts]
        self.mappers_meta = mappers_meta
        self.num_rows = int(num_rows)
        self.label_hist = label_hist
        self.score_hist = score_hist
        self.feature_names = feature_names

    # -- serialization -------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "version": self.kVersion,
            "num_rows": self.num_rows,
            "used": self.used,
            "counts": [[int(v) for v in c] for c in self.counts],
            "mappers": self.mappers_meta,
            "label_hist": self.label_hist,
            "score_hist": self.score_hist,
            "feature_names": self.feature_names,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ReferenceProfile":
        return cls(used=d["used"],
                   counts=[np.asarray(c, dtype=np.int64)
                           for c in d["counts"]],
                   mappers_meta=d["mappers"],
                   num_rows=d["num_rows"],
                   label_hist=d.get("label_hist"),
                   score_hist=d.get("score_hist"),
                   feature_names=d.get("feature_names"))

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    @classmethod
    def load(cls, path: str) -> "ReferenceProfile":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # -- score hist attachment (ft/checkpoint.py, at save time) --------
    def attach_scores(self, scores: np.ndarray, objective=None) -> None:
        """Stamp the prediction-score histogram. Pass the model's
        ``objective`` so the reference lives in SERVING output space
        (``convert_output`` — e.g. sigmoid probabilities for binary):
        the live side histograms what the server hands back, and raw
        margins vs probabilities would read as permanent score
        drift."""
        s = np.asarray(scores, dtype=np.float64)
        if objective is not None:
            s = np.asarray(objective.convert_output(s),
                           dtype=np.float64)
        if s.ndim > 1:
            s = s[:, 0]
        edges = histogram_edges(s, kScoreBins)
        self.score_hist = {
            "edges": edges,
            "counts": [int(v) for v in fixed_histogram(s, edges)],
        }


def _mapper_meta(m) -> dict:
    """The projection-relevant slice of a BinMapper's state."""
    return {
        "num_bin": int(m.num_bin),
        "missing_type": int(m.missing_type),
        "bin_type": int(m.bin_type),
        "bin_upper_bound": [float(v) for v in m.bin_upper_bound],
        "bin_2_categorical": [int(v) for v in m.bin_2_categorical],
        "min_val": float(m.min_val),
        "max_val": float(m.max_val),
        "default_bin": int(m.default_bin),
    }


class ProfileBuilder:
    """Accumulates the training-grid reference profile from binned
    blocks: one scatter-add reduction on ``device`` per block (the
    counts stay there), the label histogram on the host. ``device``
    defaults to ``cuda``; pass ``"cpu"`` to build on the CPU."""

    def __init__(self, mappers, used_feature_map: List[int],
                 feature_names: Optional[List[str]] = None,
                 device="cuda") -> None:
        self._mappers = list(mappers)
        self._used = [int(f) for f in used_feature_map]
        self._names = feature_names
        self._device = device
        self._max_bin = max([int(m.num_bin) for m in self._mappers]
                            or [1])
        self._counts = None           # device [F, max_bin] i32
        self._rows = 0
        self._label_edges = None
        self._label_counts = None

    def add_block(self, bins_block: np.ndarray, n_valid: int) -> None:
        """Accumulate ``bins_block[:n_valid]`` (host uint bins) into the
        device counts: ``counts[f, bins[i, f]] += 1``."""
        if not self._mappers:
            return
        import torch
        f_cnt = bins_block.shape[1]
        if self._counts is None:
            self._counts = torch.zeros((f_cnt, self._max_bin),
                                       dtype=torch.int32,
                                       device=self._device)
        b = torch.from_numpy(np.ascontiguousarray(
            bins_block, dtype=np.int32)).to(self._device)
        _count_bins(self._counts, b, int(n_valid))
        self._rows += int(n_valid)

    def add_labels(self, y: np.ndarray) -> None:
        y = np.asarray(y, dtype=np.float64).ravel()
        if self._label_edges is None:
            self._label_edges = histogram_edges(y, kLabelBins)
            self._label_counts = np.zeros(len(self._label_edges) + 1,
                                          dtype=np.int64)
        self._label_counts += fixed_histogram(y, self._label_edges)

    def finalize(self) -> ReferenceProfile:
        if self._counts is None:
            counts = np.zeros((len(self._mappers), self._max_bin),
                              dtype=np.int64)
        else:
            # the one read-back: the finished [F, B] counts leave the
            # device once, here
            counts = self._counts.cpu().numpy().astype(np.int64)
        label_hist = None
        if self._label_edges is not None:
            label_hist = {
                "edges": self._label_edges,
                "counts": [int(v) for v in self._label_counts],
            }
        return ReferenceProfile(
            used=self._used,
            counts=[counts[j, :int(m.num_bin)]
                    for j, m in enumerate(self._mappers)],
            mappers_meta=[_mapper_meta(m) for m in self._mappers],
            num_rows=self._rows,
            label_hist=label_hist,
            feature_names=self._names)


def _count_bins(counts, b, n_valid: int) -> None:
    """``counts[f, b[i, f]] += 1`` in place for the first ``n_valid``
    rows of the [n, F] int32 bins ``b`` (clamped into the counts'
    width), by one ``scatter_add_`` over the flattened [F * W] counts;
    no host read."""
    import torch
    n, f_cnt = b.shape
    w = counts.shape[1]
    rows = b[:max(min(n_valid, n), 0)].clamp(0, w - 1).long()
    flat = rows + (torch.arange(f_cnt, device=b.device) * w)[None, :]
    counts.view(-1).scatter_add_(
        0, flat.reshape(-1),
        torch.ones(flat.numel(), dtype=counts.dtype, device=b.device))


# ---------------------------------------------------------------------------
# serving-grid projection (host-side, once per monitor)
# ---------------------------------------------------------------------------

def _project_feature(meta: dict, counts: np.ndarray, thr: np.ndarray,
                     is_cat: bool, nan_feat: bool, zero_feat: bool,
                     vmax: int, width: int) -> np.ndarray:
    """One feature's training-grid counts -> serving-grid counts
    ``[width]`` (last two lanes = NaN / zero sentinels).

    Every numeric serving threshold is one of the training grid's
    ``bin_upper_bound`` values (serve/forest.py), so each training bin
    maps WHOLLY into one serving bin; the bin's midpoint is the
    representative value sent through the same ``searchsorted`` the
    device quantizer runs. Categorical bins route through their
    category value exactly like the device LUT clamp."""
    out = np.zeros(width, dtype=np.int64)
    nan_lane, zero_lane = width - 2, width - 1
    num_bin = int(meta["num_bin"])
    counts = np.asarray(counts, dtype=np.int64)

    if is_cat:
        b2c = meta.get("bin_2_categorical") or []
        for b in range(min(num_bin, len(counts))):
            c = int(counts[b])
            if c == 0:
                continue
            v = int(b2c[b]) if b < len(b2c) else -1
            sb = v if 0 <= v <= vmax else vmax + 1
            out[min(sb, width - 3)] += c
        return out

    bub = [float(v) for v in meta.get("bin_upper_bound") or [math.inf]]
    missing_type = int(meta["missing_type"])
    min_val = float(meta.get("min_val", 0.0))
    max_val = float(meta.get("max_val", 0.0))
    # training bin that holds the value 0.0 (the zero sentinel's home);
    # BinMapper records it exactly (default_bin = value_to_bin(0.0))
    zero_bin = int(meta.get("default_bin", 0))
    n_grid = len(bub)
    for b in range(min(num_bin, len(counts))):
        c = int(counts[b])
        if c == 0:
            continue
        # MissingType.NAN (== 2, io/binning.py) puts NaN in the last
        # bin (its appended upper bound is the NaN itself)
        if missing_type == 2 and b == num_bin - 1:
            out[nan_lane] += c
            continue
        if zero_feat and b == zero_bin:
            out[zero_lane] += c
            continue
        upper = bub[b] if b < n_grid else math.inf
        if b == 0:
            lower = min_val if min_val <= upper else upper - 1.0
        else:
            lower = bub[b - 1]
        if math.isinf(upper):
            rep = max_val if max_val > lower else lower + 1.0
        elif math.isinf(lower) or lower > upper:
            rep = upper
        else:
            rep = 0.5 * (lower + upper)
        if nan_feat and not math.isfinite(rep):
            out[nan_lane] += c
            continue
        sb = int(np.searchsorted(thr, np.float32(rep), side="left"))
        out[min(max(sb, 0), width - 3)] += c
    return out


# ---------------------------------------------------------------------------
# live serving-side accumulation
# ---------------------------------------------------------------------------

def _window_accumulate(x, qt, n_valid: int, counts) -> None:
    """Quantize the raw [n, F] f32 chunk ``x`` against the monitor's
    pinned grid and add the first ``n_valid`` rows into the [U, W]
    window counts in place. Sentinels ride in the last two lanes exactly
    like the LUT walk's columns (serve/forest.py: ``W - 2`` NaN,
    ``W - 1`` zero). PyTorch ops on ``x``'s device; no host read."""
    import torch
    from ..ops.predict import _quantize_rows_impl, kNanBin, kZeroBin
    x = x[:max(min(n_valid, x.shape[0]), 0)]
    b = _quantize_rows_impl(x, qt)                  # [U, n]
    w = counts.shape[1]
    b = torch.where(b == kNanBin, w - 2,
                    torch.where(b == kZeroBin, w - 1,
                                b.clamp(0, w - 3)))
    _count_bins(counts, b.t(), x.shape[0])


class QualityMonitor:
    """Windowed serving-input monitor bound to one model's quantizer
    grid and (optionally) a training-time :class:`ReferenceProfile`.

    Dispatch threads call :meth:`accumulate` per chunk — a copy of the
    chunk the dispatch already staged plus one scatter-add on the
    device, nothing read back. All replicas share ONE
    monitor: the device window state is a dict keyed by device, guarded
    by one lock (as the shared bucket dict), so the per-replica
    predictors never race and a drain never tears a window.

    :meth:`drain` (called from the exporter tick, the refresh loop, and
    tests) reads the window back ONCE, resets it, scores PSI/JS per
    feature against the serving-projected reference, and publishes the
    ``quality/...`` gauges obs/export.py and obs/health.py consume."""

    def __init__(self, forest, profile: Optional[ReferenceProfile] = None,
                 name: str = "serve",
                 min_window_rows: int = 0) -> None:
        self.name = name
        self.profile = profile
        # a window with too few rows scores sampling noise as drift (a
        # 64-row window over ~255 bins has expected PSI ~ bins/rows ≈ 4
        # against an identical distribution) — below this floor drain()
        # CARRIES the window forward instead of scoring it
        self.min_window_rows = max(int(min_window_rows), 0)
        self._pending_rows = 0
        # pin the grid: monitoring stays on ONE grid across refresh
        # publishes, so drift numbers are never an artifact of a swap
        # (one-shot host snapshot of the quantizer tables)
        qt = forest._qt._replace(**{
            k: v.cpu() for k, v in forest._qt._asdict().items()
            if hasattr(v, "cpu")})
        self._qt_host = qt
        self._used = qt.used.numpy().astype(np.int64)
        thr = qt.thresholds.numpy().astype(np.float32)
        self._n_thr = np.isfinite(thr).sum(axis=1).astype(np.int64)
        vmax = int(qt.vmax)
        m_pad = thr.shape[1] if thr.size else 1
        # serving-grid width: every regular bin + the two sentinel
        # lanes, the same W the LUT node encoding uses
        self._width = max(m_pad + 1, vmax + 2) + 2
        self._vmax = vmax
        self._thr_rows = [thr[u][np.isfinite(thr[u])]
                          for u in range(thr.shape[0])]
        self._is_cat = (np.zeros(len(self._used), dtype=bool)
                        if qt.is_cat is None else qt.is_cat.numpy())
        self._nan_feat = qt.nan_feat.numpy().astype(bool)
        self._zero_feat = qt.zero_feat.numpy().astype(bool)

        self._ref, self._ref_valid = self._project_profile()

        self._lock = threading.Lock()
        self._state: Dict = {}        # device -> [U, W] i32 window
        # device -> CUDA event after the window's last update: replicas
        # dispatch on streams of their own, and each update (and the
        # drain's read) waits for the one before it
        self._updated: Dict = {}
        self._qt_placed: Dict = {}    # device -> QuantizerTables
        self._score_edges = None
        self._score_ref = None
        self._score_counts = None
        if profile is not None and profile.score_hist:
            self._score_edges = np.asarray(
                profile.score_hist["edges"], dtype=np.float64)
            self._score_ref = np.asarray(
                profile.score_hist["counts"], dtype=np.int64)
            self._score_counts = np.zeros_like(self._score_ref)
        self._label_edges = None
        self._label_ref = None
        self._label_counts = None
        if profile is not None and profile.label_hist:
            self._label_edges = np.asarray(
                profile.label_hist["edges"], dtype=np.float64)
            self._label_ref = np.asarray(
                profile.label_hist["counts"], dtype=np.int64)
            self._label_counts = np.zeros_like(self._label_ref)
        self.last = {}               # most recent drain report

    # -- reference projection ------------------------------------------
    def _project_profile(self):
        u_cnt = len(self._used)
        ref = np.zeros((u_cnt, self._width), dtype=np.int64)
        valid = np.zeros(u_cnt, dtype=bool)
        if self.profile is None:
            return ref, valid
        by_raw = {f: j for j, f in enumerate(self.profile.used)}
        for u in range(u_cnt):
            j = by_raw.get(int(self._used[u]))
            if j is None:
                continue
            ref[u] = _project_feature(
                self.profile.mappers_meta[j], self.profile.counts[j],
                self._thr_rows[u], bool(self._is_cat[u]),
                bool(self._nan_feat[u]), bool(self._zero_feat[u]),
                self._vmax, self._width)
            valid[u] = ref[u].sum() > 0
        return ref, valid

    # -- hot path -------------------------------------------------------
    def _placed_qt(self, device):
        qt = self._qt_placed.get(device)
        if qt is None:
            qt = self._qt_host._replace(**{
                k: v.to(device) for k, v in self._qt_host._asdict().items()
                if hasattr(v, "to")})
            self._qt_placed[device] = qt
        return qt

    def accumulate(self, chunk: np.ndarray, n_valid: int,
                   device="cuda") -> None:
        """One dispatched chunk (host rows, zero-padded to its bucket;
        ``n_valid`` real rows) into the window on ``device``; nothing
        comes back — the read-back happens once per window, in
        :meth:`drain`."""
        import torch
        u_cnt = len(self._used)
        if u_cnt == 0 or n_valid <= 0:
            return
        device = torch.device(device)
        x = torch.from_numpy(np.ascontiguousarray(
            chunk, dtype=np.float32)).to(device)
        with self._lock:
            self._pending_rows += int(n_valid)
            qt = self._placed_qt(device)
            counts = self._state.get(device)
            if counts is None:
                counts = torch.zeros((u_cnt, self._width),
                                     dtype=torch.int32, device=device)
                self._state[device] = counts
            if device.type == "cuda":
                self._wait_updated(device)
            _window_accumulate(x, qt, int(n_valid), counts)
            if device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(device))
                self._updated[device] = ev

    def _wait_updated(self, device) -> None:
        """Make the current stream wait for the window's last update on
        ``device`` (call under the lock)."""
        import torch
        ev = self._updated.get(device)
        if ev is not None:
            torch.cuda.current_stream(device).wait_event(ev)

    def observe_scores(self, y: np.ndarray) -> None:
        """Host-side prediction-score accumulation (the scores are
        already on the host on their way back to the caller)."""
        if self._score_edges is None:
            return
        y = np.asarray(y)
        if y.ndim > 1:
            y = y[:, 0]
        h = fixed_histogram(y, self._score_edges)
        with self._lock:
            self._score_counts += h

    def observe_labels(self, y: np.ndarray) -> None:
        """Label histogram per refresh window (refresh windows carry
        labels; the serving path does not)."""
        if self._label_edges is None:
            return
        h = fixed_histogram(np.asarray(y), self._label_edges)
        with self._lock:
            self._label_counts += h

    # -- window drain + scoring ----------------------------------------
    def drain(self, reg=None) -> dict:
        """Read the window back (one transfer per device), reset it,
        score drift vs the projected reference, publish gauges. Safe to
        call concurrently with accumulation: the swap happens under the
        same lock the accumulators hold, so a window is always a whole
        number of chunks."""
        reg = reg if reg is not None else obs_registry
        with self._lock:
            if 0 < self._pending_rows < self.min_window_rows:
                # under-filled window: leave the device state in place
                # and score it on a later tick, once it holds enough
                # rows that PSI is signal rather than sampling noise
                return {"rows": 0, "carried": True,
                        "pending_rows": self._pending_rows,
                        "psi": {}, "js": {}, "psi_max": 0.0,
                        "js_max": 0.0, "edge_mass": 0.0,
                        "score_psi": None, "label_psi": None,
                        "worst_feature": None}
            self._pending_rows = 0
            states = list(self._state.items())
            self._state = {}
            for device, _ in states:
                if device.type == "cuda":
                    self._wait_updated(device)
            self._updated = {}
            score_counts = self._score_counts
            if score_counts is not None:
                self._score_counts = np.zeros_like(score_counts)
            label_counts = self._label_counts
            if label_counts is not None:
                self._label_counts = np.zeros_like(label_counts)
        live = np.zeros((len(self._used), self._width), dtype=np.int64)
        for _, counts in states:
            # the window boundary: one [U, W] read-back per device
            # per exporter tick
            live += counts.cpu().numpy().astype(np.int64)

        rows = int(live[0].sum()) if len(self._used) else 0
        report = {"rows": rows, "carried": False, "psi": {}, "js": {},
                  "psi_max": 0.0, "js_max": 0.0, "edge_mass": 0.0,
                  "score_psi": None, "label_psi": None,
                  "worst_feature": None}
        if rows > 0:
            for u in range(len(self._used)):
                if not self._ref_valid[u]:
                    continue
                raw = int(self._used[u])
                fp = psi(self._ref[u], live[u])
                fj = js_divergence(self._ref[u], live[u])
                report["psi"][raw] = fp
                report["js"][raw] = fj
                if fp >= report["psi_max"]:
                    report["psi_max"] = fp
                    report["worst_feature"] = raw
                report["js_max"] = max(report["js_max"], fj)
                reg.gauge("quality/psi/feature/%d" % raw, fp)
                reg.gauge("quality/js/feature/%d" % raw, fj)
                if not self._is_cat[u]:
                    report["edge_mass"] = max(
                        report["edge_mass"],
                        self._edge_mass(u, live[u]))
            if score_counts is not None and self._score_ref is not None:
                report["score_psi"] = psi(self._score_ref, score_counts)
                reg.gauge("quality/score_psi", report["score_psi"])
            if label_counts is not None and label_counts.sum() > 0 \
                    and self._label_ref is not None:
                report["label_psi"] = psi(self._label_ref, label_counts)
                reg.gauge("quality/label_psi", report["label_psi"])
            reg.gauge("quality/psi_max", report["psi_max"])
            reg.gauge("quality/js_max", report["js_max"])
            reg.gauge("quality/edge_mass", report["edge_mass"])
            reg.inc("quality/windows")
        reg.gauge("quality/window_rows", rows)
        reg.inc("quality/rows", rows)
        self.last = report
        return report

    def _edge_mass(self, u: int, live_u: np.ndarray) -> float:
        """Excess live mass in the grid's catch-all edge bins (below
        the first / beyond the last threshold) over the reference's —
        the signal that the bin boundaries themselves no longer cover
        the data (frozen-splits invalidation -> retrain_required)."""
        total = live_u.sum()
        if total <= 0:
            return 0.0
        hi = int(self._n_thr[u])           # beyond-last-threshold bin
        lanes = [0, hi] if hi > 0 else [0]
        ref_total = max(self._ref[u].sum(), 1)
        excess = 0.0
        for b in lanes:
            live_frac = live_u[b] / total
            ref_frac = self._ref[u][b] / ref_total
            excess = max(excess, float(live_frac - ref_frac))
        return excess


# ---------------------------------------------------------------------------
# module-level monitor registration (the exporter tick drains these)
# ---------------------------------------------------------------------------

_monitors_lock = threading.Lock()
_monitors: List[QualityMonitor] = []


def register_monitor(m: QualityMonitor) -> QualityMonitor:
    with _monitors_lock:
        if m not in _monitors:
            _monitors.append(m)
    return m


def unregister_monitor(m: QualityMonitor) -> None:
    with _monitors_lock:
        if m in _monitors:
            _monitors.remove(m)


def drain_all(reg=None) -> List[dict]:
    """Drain every registered monitor (SnapshotExporter.dump_now calls
    this right before it snapshots, so each exporter tick is exactly
    one drift window). Monitor failures degrade to a perf_warning — a
    broken drift score must never take the exporter down."""
    with _monitors_lock:
        monitors = list(_monitors)
    reports = []
    for m in monitors:
        try:
            reports.append(m.drain(reg))
        except Exception as e:  # pragma: no cover - defensive
            obs_events.emit("perf_warning", component="obs.quality",
                            message="quality drain failed: %r" % e)
    return reports
