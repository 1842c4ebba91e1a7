"""Closed-loop continuous model refresh: train -> publish -> serve ->
retrain, under live traffic, with the fault plane firing mid-loop.

Port of ``lightgbm_tpu/loop/controller.py``. The controller composes
subsystems the port already has (the streaming spill path,
``io/streaming.py`` -> ``io/shards.py``; checkpointed training,
``engine.py`` + ``ft/checkpoint.py``; the refit on the booster's device,
``boosting/refit.py::refit_model_device`` through ``Booster.refit``; and
the canary-publishing registry + micro-batching server,
``serve/server.py``) into one loop and asserts the composition's
invariants every cycle:

- the serving plane answers throughout (generated traffic never stops;
  a refresh is invisible to callers except as a version bump);
- a poisoned refresh rolls back inside its canary window while the
  previous version keeps serving (fail-closed publish);
- train-side and telemetry-side injected faults are absorbed by the
  retry/degrade machinery without losing the cycle;
- the ``refresh_slo`` watchdog rule (``obs/health.py``) sees zero
  breaches on a healthy loop: serve p99 under the SLO, rollbacks within
  budget, zero stranded futures at drain.

Data flows in per-cycle *windows* (``data_fn(cycle) -> (X, y[, w])``).
Cycle 0 streams window 0 through the spill path, trains the base model
with checkpoints, and publishes it into a live :class:`PredictServer`.
Every later cycle re-opens the same spill directory through
``ShardedBinnedDataset.attach`` (no re-binning), resumes training from
the newest checkpoint for ``extra_rounds`` more iterations, refits the
grown forest's leaf values on the cycle's fresh window on the booster's
device, and canary-publishes the refreshed model under traffic.

The server runs on the device of the params' ``device_type`` (the card
by default, the CPU on request), the learner's own device. On the card
each refresh captures the learner's CUDA graph while the server's
worker and the traffic pumps keep using the card; the learners capture
with ``capture_error_mode="thread_local"``, so another thread's launches,
copies and syncs neither fail the capture nor are captured into it.

See ``docs/REFRESH.md`` for the SLO contract and what is not covered.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..basic import Booster, Dataset
from ..config import Config, resolve_device
from ..engine import train as _train
from ..io.shards import ShardedBinnedDataset
from ..io.streaming import StreamingDataset
from ..obs import events
from ..obs import faults
from ..obs import gateway as obs_gateway
from ..obs import health as obs_health
from ..obs.registry import registry as obs_registry
from ..serve import ModelRegistry, Overloaded, PredictServer, ServeError
from ..utils import log
from . import chaos as chaos_mod


def covariate_shift(block: np.ndarray) -> np.ndarray:
    """Default mid-run covariate-shift transform for
    :class:`TrafficGenerator`: translate every feature by 2.5 of its
    own std (plus a floor for constant columns). The shape and dtype —
    and therefore the serving bucket and trace count — stay identical
    to the unshifted block; only the bin occupancy moves, which is
    exactly what the quality plane's PSI must catch."""
    s = block.std(axis=0, keepdims=True)
    return (block + 2.5 * s + 0.5).astype(block.dtype)


class TrafficGenerator:
    """Sustained synthetic serving load: ``threads`` daemon threads pump
    one block each through ``server.predict`` in a tight loop, counting
    answered rows and TYPED failures (an untyped failure is a bug).

    ``pause()``/``resume()`` quiesce the pumps without stopping the
    server — the poisoned-publish leg needs the NEXT dispatch to be the
    canary's deterministically, which live pumps can't guarantee. Each
    pump is synchronous (``predict`` blocks on its own Future), so once
    every thread reports idle there are zero generator requests in
    flight.

    ``block`` may be a single array or a LIST of equal-shape arrays (a
    pool): the pumps round-robin through the pool, so a drift window
    sees pool_size x block_rows DISTINCT rows instead of one block
    repeated — with a single small block, an identical-distribution
    window still scores PSI ~ bins/distinct_rows of pure sampling
    noise. Equal shapes keep the whole pool in one warmed serve bucket.

    ``shift_after_rows=N`` injects covariate shift mid-run: once the
    pumps have collectively answered N rows, every subsequent request
    uses ``shift_fn(block)`` (default :func:`covariate_shift`) instead
    of the original pool. The shifted blocks keep the original shape
    and dtype, so the swap is invisible to the compile cache — the only
    observable difference is the input distribution, which is the
    quality plane's job to notice."""

    def __init__(self, server: PredictServer, block,
                 threads: int = 2, timeout_s: float = 120.0,
                 shift_after_rows: Optional[int] = None,
                 shift_fn: Optional[Callable] = None) -> None:
        self.server = server
        pool = list(block) if isinstance(block, (list, tuple)) \
            else [block]
        if not pool:
            raise ValueError("need at least one traffic block")
        if any(b.shape != pool[0].shape for b in pool):
            raise ValueError("pool blocks must share one shape (one "
                             "warmed serve bucket)")
        self.pool: List[np.ndarray] = pool
        self.block = pool[0]
        self.timeout_s = float(timeout_s)
        self.n_threads = max(int(threads), 1)
        self.shift_after_rows = (None if shift_after_rows is None
                                 else int(shift_after_rows))
        self._shift_pool: Optional[List[np.ndarray]] = None
        if self.shift_after_rows is not None:
            fn = shift_fn if shift_fn is not None else covariate_shift
            self._shift_pool = []
            for b in pool:
                shifted = np.ascontiguousarray(
                    fn(np.array(b, copy=True)), dtype=b.dtype)
                if shifted.shape != b.shape:
                    raise ValueError(
                        "shift_fn changed the block shape %s -> %s; "
                        "the shifted block must reuse the warmed "
                        "bucket" % (b.shape, shifted.shape))
                self._shift_pool.append(shifted)
        self._shifted = threading.Event()
        self._stop = threading.Event()
        self._pause = threading.Event()
        self._idle = [threading.Event() for _ in range(self.n_threads)]
        self._threads: List[threading.Thread] = []
        # per-thread stats, merged at read time (no locks on the pump)
        self._stats = [{"requests": 0, "rows_ok": 0, "rows_shifted": 0,
                        "shed": 0, "typed": {}, "untyped": []}
                       for _ in range(self.n_threads)]

    def _current_block(self, t: int, seq: int):
        shifted = False
        if self._shift_pool is not None:
            if self._shifted.is_set():
                shifted = True
            else:
                # cross-thread dict reads are GIL-atomic; an
                # off-by-a-block trigger point is fine, a lock on the
                # pump path is not
                total = sum(s["rows_ok"] for s in self._stats)
                if total >= self.shift_after_rows:
                    self._shifted.set()
                    shifted = True
        pool = self._shift_pool if shifted else self.pool
        # stride the threads so N pumps don't walk the pool in lockstep
        return pool[(seq * self.n_threads + t) % len(pool)], shifted

    def _pump(self, t: int) -> None:
        st = self._stats[t]
        while not self._stop.is_set():
            if self._pause.is_set():
                self._idle[t].set()
                time.sleep(0.002)
                continue
            self._idle[t].clear()
            st["requests"] += 1
            blk, shifted = self._current_block(t, st["requests"])
            try:
                self.server.predict(blk, timeout=self.timeout_s)
                st["rows_ok"] += blk.shape[0]
                if shifted:
                    st["rows_shifted"] += blk.shape[0]
            except Overloaded:
                st["shed"] += 1
            except (ServeError, faults.InjectedFault) as e:
                name = type(e).__name__
                st["typed"][name] = st["typed"].get(name, 0) + 1
            except Exception as e:  # noqa: BLE001 — count, never die:
                # a dead pump would silently end "sustained traffic"
                if len(st["untyped"]) < 8:
                    st["untyped"].append("%s: %s" % (type(e).__name__,
                                                     str(e)[:120]))

    def start(self) -> None:
        self._threads = [threading.Thread(target=self._pump, args=(t,),
                                          daemon=True)
                         for t in range(self.n_threads)]
        for th in self._threads:
            th.start()

    def pause(self, timeout_s: float = 30.0) -> bool:
        """Quiesce every pump; True once no generator request is in
        flight (each pump parked in its poll loop)."""
        for ev in self._idle:
            ev.clear()
        self._pause.set()
        deadline = time.time() + timeout_s
        for ev in self._idle:
            if not ev.wait(timeout=max(deadline - time.time(), 0.001)):
                return False
        return True

    def resume(self) -> None:
        self._pause.clear()

    def stats(self) -> Dict:
        out = {"requests": 0, "rows_ok": 0, "rows_shifted": 0,
               "shed": 0, "typed": {}, "untyped": []}
        for st in self._stats:
            out["requests"] += st["requests"]
            out["rows_ok"] += st["rows_ok"]
            out["rows_shifted"] += st["rows_shifted"]
            out["shed"] += st["shed"]
            for k, v in st["typed"].items():
                out["typed"][k] = out["typed"].get(k, 0) + v
            out["untyped"].extend(st["untyped"])
        return out

    def stop(self) -> Dict:
        self._stop.set()
        self._pause.clear()
        for th in self._threads:
            th.join(timeout=max(self.timeout_s, 30.0))
        return self.stats()


class RefreshController:
    """Drive the closed refresh loop; see the module docstring.

    ``data_fn(cycle)`` supplies each cycle's window as ``(X, y)`` or
    ``(X, y, weight)`` host arrays. ``params`` is the ordinary
    ``lgb.train`` params dict (iteration-count aliases must stay out of
    it — the loop owns the round schedule: ``base_rounds`` at
    bootstrap, ``+ extra_rounds`` per refresh cycle, resumed from the
    newest checkpoint)."""

    def __init__(self, params: Dict, data_fn: Callable,
                 num_features: int, work_dir: str,
                 base_rounds: int = 6, extra_rounds: int = 2,
                 canary_batches: int = 2, name: str = "refresh",
                 traffic_threads: int = 2, traffic_rows: int = 64,
                 schedule: Optional[Dict[int, List[chaos_mod.ChaosLeg]]]
                 = None,
                 use_gateway: bool = True, checkpoint_freq: int = 1,
                 shard_rows: Optional[int] = None,
                 drain_timeout_s: float = 30.0,
                 canary_timeout_s: float = 60.0,
                 max_batch: int = 256, max_wait_ms: float = 2.0,
                 refresh_trigger: str = "cadence",
                 drift_max_windows: int = 4,
                 drift_window_s: float = 0.25,
                 drift_min_window_rows: int = 0,
                 traffic_pool: int = 1,
                 shift_after_rows: Optional[int] = None,
                 shift_fn: Optional[Callable] = None) -> None:
        if refresh_trigger not in ("cadence", "drift"):
            raise ValueError("refresh_trigger must be 'cadence' or "
                             "'drift', got %r" % (refresh_trigger,))
        self.params = dict(params)
        self.data_fn = data_fn
        self.num_features = int(num_features)
        self.work_dir = work_dir
        self.spill_dir = os.path.join(work_dir, "spill")
        self.ckpt_dir = os.path.join(work_dir, "ckpt")
        self.base_rounds = int(base_rounds)
        self.extra_rounds = int(extra_rounds)
        self.canary_batches = int(canary_batches)
        self.name = name
        self.traffic_threads = int(traffic_threads)
        self.traffic_rows = int(traffic_rows)
        self.schedule = schedule
        self.use_gateway = bool(use_gateway)
        self.checkpoint_freq = int(checkpoint_freq)
        self.shard_rows = shard_rows
        self.drain_timeout_s = float(drain_timeout_s)
        self.canary_timeout_s = float(canary_timeout_s)
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        # drift-gated refresh (refresh_trigger="drift"): before each
        # refresh cycle the controller drains short drift windows until
        # one breaches LIGHTGBM_TPU_WATCH_PSI, then refreshes early; a
        # clean streak of drift_max_windows falls back to cadence so a
        # refresh is never starved by a calm input stream
        self.refresh_trigger = refresh_trigger
        self.drift_max_windows = max(int(drift_max_windows), 1)
        self.drift_window_s = float(drift_window_s)
        self.drift_min_window_rows = int(drift_min_window_rows)
        # traffic_pool > 1 pumps a rotating pool of traffic_pool
        # equal-shape blocks instead of one block: a drift window then
        # holds pool*rows DISTINCT rows, keeping sampling-noise PSI
        # well under the drift threshold on an unshifted stream
        self.traffic_pool = max(int(traffic_pool), 1)
        self.shift_after_rows = shift_after_rows
        self.shift_fn = shift_fn
        self.quality = None
        self.drift_psi_max = 0.0
        self.drift_windows = 0
        self.drift_triggered = 0
        self.drift_detect_windows: Optional[int] = None
        self._warned_no_quality = False

        # the learner's device serves too (raises without a card unless
        # the params ask for the CPU)
        self.device = resolve_device(Config.from_params(self.params))
        self.registry = ModelRegistry()
        self.server: Optional[PredictServer] = None
        self.traffic: Optional[TrafficGenerator] = None
        self.watchdog: Optional[obs_health.Watchdog] = None
        self._gateway = None
        self._pusher = None
        self._block: Optional[np.ndarray] = None
        self._lat0 = 0

    # ------------------------------------------------------------------
    def _window(self, cycle: int):
        out = self.data_fn(cycle)
        if len(out) == 2:
            X, y = out
            w = None
        else:
            X, y, w = out
        return (np.asarray(X, dtype=np.float64),
                np.asarray(y, dtype=np.float64),
                None if w is None else np.asarray(w, dtype=np.float64))

    def _wrap(self, sharded) -> Dataset:
        # Dataset.construct() early-returns on a bound handle, so the
        # engine's checkpoint/resume machinery drives the sharded
        # dataset without ever re-binning raw data it does not have
        ds = Dataset(None)
        ds._handle = sharded
        ds.params = dict(self.params)
        return ds

    def _await_canary(self, version: int) -> str:
        deadline = time.time() + self.canary_timeout_s
        while (self.registry.canary_active(self.name)
               and time.time() < deadline):
            time.sleep(0.01)
        if self.registry.canary_active(self.name):
            return "stuck"
        return ("promoted"
                if self.registry.get(self.name)[0] == version
                else "rolled_back")

    def _p99(self) -> float:
        """Serving p99 over this run's window (samples since ``run``)."""
        return obs_registry.percentile("serve/latency_ms", 99.0,
                                       since=self._lat0)

    # ------------------------------------------------------------------
    def _bootstrap(self) -> Dict:
        t0 = time.perf_counter()
        X0, y0, w0 = self._window(0)
        sd = StreamingDataset(self.num_features, params=self.params,
                              has_weight=w0 is not None)
        chunk = max(len(y0) // 4, 1)
        for lo in range(0, len(y0), chunk):
            sd.push_rows(X0[lo:lo + chunk], label=y0[lo:lo + chunk],
                         weight=(None if w0 is None
                                 else w0[lo:lo + chunk]))
        sharded = sd.finalize(
            spill_dir=self.spill_dir,
            shard_rows=self.shard_rows or max(len(y0) // 4, 1))
        bst = _train(dict(self.params), self._wrap(sharded),
                     num_boost_round=self.base_rounds,
                     checkpoint_dir=self.ckpt_dir,
                     checkpoint_freq=self.checkpoint_freq)
        version = self.registry.load(self.name, booster=bst)
        profile = getattr(bst.inner, "quality_profile", None)
        if profile is not None:
            from ..obs import quality as obs_quality
            if profile.score_hist is None:
                # checkpointed runs attach scores at save time; a
                # checkpoint-free loop attaches them here instead
                profile.attach_scores(
                    bst.inner.train_score.cpu().numpy().astype(np.float32),
                    objective=getattr(bst.inner, "objective", None))
            _, forest = self.registry.get(self.name)
            # the monitor pins the BASE model's quantizer grid: drift
            # across later refresh publishes is measured on one fixed
            # grid, never an artifact of a model swap
            self.quality = obs_quality.QualityMonitor(
                forest, profile=profile, name=self.name,
                min_window_rows=self.drift_min_window_rows)
        self.server = PredictServer(self.registry, name=self.name,
                                    max_batch=self.max_batch,
                                    max_wait_ms=self.max_wait_ms,
                                    quality=self.quality,
                                    devices=[self.device])
        pool = []
        for i in range(self.traffic_pool):
            blk = X0[i * self.traffic_rows:(i + 1) * self.traffic_rows]
            if blk.shape[0] < self.traffic_rows:
                break
            pool.append(np.ascontiguousarray(blk, dtype=np.float32))
        if not pool:  # window smaller than one block: pump what exists
            pool = [np.ascontiguousarray(X0[:self.traffic_rows],
                                         dtype=np.float32)]
        self._block = pool[0]
        self.server.predict(self._block, timeout=120)  # warm the bucket
        if self.quality is not None:
            self.quality.drain(obs_registry)  # warm rows != window 0
        self.traffic = TrafficGenerator(
            self.server, pool, threads=self.traffic_threads,
            shift_after_rows=self.shift_after_rows,
            shift_fn=self.shift_fn)
        self.traffic.start()
        seconds = time.perf_counter() - t0
        rec = {"cycle": 0, "outcome": "bootstrap", "version": version,
               "stable_version": version, "seconds": round(seconds, 3),
               "rounds": self.base_rounds, "chaos": [], "injected": 0,
               "p99_ms": self._p99()}
        events.emit("refresh_cycle", **rec)
        return rec

    def _poisoned_publish(self, model_str: str, spec: str,
                          problems: List[str]):
        """Publish a canary that is SCHEDULED to die: quiesce the
        generator pumps (so the injected ``serve_dispatch`` fault can
        only land on the canary's first batch), publish, drive one
        request through the window, and let the rollback-and-replay
        machinery answer it on the stable version. Traffic resumes the
        instant the rollback is in the registry — the server itself
        never stopped."""
        if not self.traffic.pause():
            problems.append("could not quiesce traffic for the "
                            "poisoned publish")
        faults.configure(spec)
        version = None
        try:
            version = self.registry.load(
                self.name, model_str=model_str,
                canary_batches=self.canary_batches)
            try:
                # rolls back, then replays THIS batch on stable
                self.server.predict(self._block, timeout=120)
            except (ServeError, faults.InjectedFault) as e:
                problems.append(
                    "poisoned canary did not replay on stable: %s: %s"
                    % (type(e).__name__, str(e)[:120]))
        finally:
            faults.reset()
            self.traffic.resume()
        outcome = self._await_canary(version)
        return outcome, version

    def _refresh_cycle(self, cycle: int,
                       legs: List[chaos_mod.ChaosLeg],
                       problems: List[str]) -> Dict:
        t0 = time.perf_counter()
        inj0 = obs_registry.count("ft/faults_injected")
        train_spec = ";".join(l.spec for l in legs
                              if l.phase == "train")
        pub_legs = [l for l in legs if l.phase == "publish"]
        tele_spec = ";".join(l.spec for l in legs
                             if l.phase == "telemetry")
        poison = any(l.poison for l in pub_legs)

        # --- retrain: reopen the spill (no re-binning) + resume -------
        attached = ShardedBinnedDataset.attach(
            self.spill_dir, config=Config.from_params(self.params))
        rounds = self.base_rounds + self.extra_rounds * cycle
        if train_spec:
            faults.configure(train_spec)
        try:
            bst = _train(dict(self.params), self._wrap(attached),
                         num_boost_round=rounds,
                         checkpoint_dir=self.ckpt_dir,
                         checkpoint_freq=self.checkpoint_freq,
                         resume=True)
        finally:
            if train_spec:
                faults.reset()

        # --- refit on the fresh window (pure device replay) ----------
        Xw, yw, ww = self._window(cycle)
        if self.quality is not None:
            # refresh windows carry labels; serve traffic does not —
            # this is the label-drift signal's only source
            self.quality.observe_labels(yw)
        bst.refit(Xw, yw, weight=ww)
        model_str = bst.model_to_string()

        # --- canary publish into the LIVE server ---------------------
        prev_version = self.registry.get(self.name)[0]
        if poison:
            spec = ";".join(l.spec for l in pub_legs)
            outcome, version = self._poisoned_publish(
                model_str, spec, problems)
        else:
            pub_spec = ";".join(l.spec for l in pub_legs)
            if pub_spec:
                faults.configure(pub_spec)
            try:
                version = self.registry.load(
                    self.name, model_str=model_str,
                    canary_batches=self.canary_batches)
                # live traffic drives the canary window to a verdict
                outcome = self._await_canary(version)
            finally:
                if pub_spec:
                    faults.reset()

        # --- telemetry push (fault-injectable, retried, never fatal) -
        if self._pusher is not None:
            if tele_spec:
                faults.configure(tele_spec)
            try:
                self._pusher.push_now()
            finally:
                if tele_spec:
                    faults.reset()

        # --- per-cycle SLO evaluation ---------------------------------
        stable = self.registry.get(self.name)[0]
        p99 = self._p99()
        obs_registry.gauge("refresh/serve_p99_ms", p99)
        obs_registry.gauge("refresh/stable_version", stable)
        fired = self.watchdog.evaluate()
        injected = obs_registry.count("ft/faults_injected") - inj0

        if poison:
            if outcome != "rolled_back":
                problems.append("cycle %d: poisoned canary %s "
                                "(expected rolled_back)"
                                % (cycle, outcome))
            elif stable != prev_version:
                problems.append("cycle %d: rollback left stable v%s "
                                "(expected v%s to keep serving)"
                                % (cycle, stable, prev_version))
        elif outcome != "promoted":
            problems.append("cycle %d: clean refresh %s (expected "
                            "promoted)" % (cycle, outcome))
        if legs and injected == 0:
            problems.append("cycle %d: scheduled fault(s) %s never "
                            "fired" % (cycle,
                                       [l.spec for l in legs]))

        rec = {"cycle": cycle, "outcome": outcome, "version": version,
               "stable_version": stable,
               "seconds": round(time.perf_counter() - t0, 3),
               "rounds": rounds, "chaos": [l.spec for l in legs],
               "injected": injected, "p99_ms": round(p99, 3),
               "breaches": [f["rule"] for f in fired]}
        events.emit("refresh_cycle", **rec)
        return rec

    # ------------------------------------------------------------------
    def _drift_gate(self, cycle: int, problems: List[str]) -> Dict:
        """Gate one refresh cycle on observed serving-input drift.

        ``refresh_trigger="drift"``: drain up to ``drift_max_windows``
        short windows; the first whose per-feature PSI max breaches
        ``LIGHTGBM_TPU_WATCH_PSI`` starts the cycle early (counted in
        ``drift_triggered_refreshes``); a clean streak proceeds anyway
        (cadence fallback). ``refresh_trigger="cadence"``: one window
        still drains per cycle so the quality gauges — and the drift
        watchdog rules — stay live, but nothing is gated on them."""
        if self.quality is None:
            if (self.refresh_trigger == "drift"
                    and not self._warned_no_quality):
                problems.append(
                    "refresh_trigger='drift' but the spill carried no "
                    "quality profile (written before the quality "
                    "plane?) — cycles fall back to cadence")
                self._warned_no_quality = True
            return {}
        thr = float(os.environ.get("LIGHTGBM_TPU_WATCH_PSI", "0.25"))
        budget = (self.drift_max_windows
                  if self.refresh_trigger == "drift" else 1)
        psi_seen = 0.0
        for w in range(1, budget + 1):
            time.sleep(self.drift_window_s)
            rep = self.quality.drain(obs_registry)
            self.drift_windows += 1
            psi = float(rep.get("psi_max", 0.0))
            psi_seen = max(psi_seen, psi)
            self.drift_psi_max = max(self.drift_psi_max, psi)
            if (self.refresh_trigger == "drift"
                    and rep.get("rows", 0) and psi >= thr):
                self.drift_triggered += 1
                if self.drift_detect_windows is None:
                    self.drift_detect_windows = w
                return {"drift_gate": "triggered", "drift_windows": w,
                        "drift_psi": round(psi, 4)}
        if self.refresh_trigger != "drift":
            return {"drift_psi": round(psi_seen, 4)}
        return {"drift_gate": "cadence_fallback",
                "drift_windows": budget,
                "drift_psi": round(psi_seen, 4)}

    # ------------------------------------------------------------------
    def run(self, cycles: int) -> Dict:
        """Run ``cycles`` total cycles (cycle 0 bootstraps; each later
        cycle is a refresh) and return the loop report. The report's
        ``ok`` is the whole contract: every scheduled outcome happened,
        every scheduled fault fired, zero ``refresh_slo`` breaches,
        zero stranded futures, zero untyped traffic failures."""
        if cycles < 2:
            raise ValueError("a closed loop needs >= 2 cycles "
                             "(bootstrap + at least one refresh)")
        schedule = (self.schedule if self.schedule is not None
                    else chaos_mod.refresh_schedule(cycles))
        chaos_mod.validate_schedule(schedule)
        obs_registry.enable()
        # this run's measurement window: the latencies served from here
        # on, and no drift level that an earlier monitor in the process
        # left for the watchdog's first evaluation
        obs_registry.clear_gauges("quality/")
        self._lat0 = obs_registry.observed("serve/latency_ms")
        rb0 = obs_registry.count("serve/rollbacks")
        drain0 = obs_registry.count("serve/drain_failed")
        slo0 = obs_registry.count("health/refresh_slo")
        inj0 = obs_registry.count("ft/faults_injected")

        if self.use_gateway:
            self._gateway = obs_gateway.MetricsGateway(port=0)
            self._pusher = obs_gateway.SnapshotPusher(
                self._gateway.url, interval=0, role="refresh")

        self.watchdog = obs_health.Watchdog(obs_registry)
        obs_registry.gauge("refresh/active", 1)
        self.watchdog.evaluate()   # arm: baseline the counter deltas

        problems: List[str] = []
        records: List[Dict] = []
        try:
            records.append(self._bootstrap())
            for cycle in range(1, cycles):
                gate = self._drift_gate(cycle, problems)
                rec = self._refresh_cycle(
                    cycle, schedule.get(cycle, []), problems)
                rec.update(gate)
                records.append(rec)
        finally:
            traffic = self.traffic.stop() if self.traffic else {}
            if self.server is not None:
                self.server.stop(self.drain_timeout_s)
            # stranded-future check runs with the loop still "active"
            # (the refresh_slo rule disarms once the gauge clears)
            if self.watchdog is not None:
                self.watchdog.evaluate()
            obs_registry.gauge("refresh/active", 0)
            if self._gateway is not None:
                self._gateway.close()

        if traffic.get("untyped"):
            problems.append("untyped traffic failures: %s"
                            % "; ".join(traffic["untyped"][:4]))
        rollbacks = obs_registry.count("serve/rollbacks") - rb0
        expected_rb = chaos_mod.expected_rollbacks(schedule)
        if rollbacks != expected_rb:
            problems.append("%d rollbacks (schedule expected %d)"
                            % (rollbacks, expected_rb))
        stranded = obs_registry.count("serve/drain_failed") - drain0
        if stranded:
            problems.append("%d futures stranded at drain" % stranded)
        slo_breaches = obs_registry.count("health/refresh_slo") - slo0
        if slo_breaches:
            problems.append("%d refresh_slo breaches" % slo_breaches)
        for p in problems:
            log.warning("refresh loop: %s" % p)

        refresh_secs = [r["seconds"] for r in records if r["cycle"] > 0]
        report = {
            "cycles": records,
            "num_cycles": len(records),
            "refresh_cycle_seconds": round(
                float(np.mean(refresh_secs)) if refresh_secs else 0.0,
                3),
            "serve_p99_during_refresh_ms": round(
                max((r["p99_ms"] for r in records), default=0.0), 3),
            "refresh_slo_breaches": int(slo_breaches),
            "refresh_rollbacks": int(rollbacks),
            "expected_rollbacks": int(expected_rb),
            "stranded_futures": int(stranded),
            "faults_injected": obs_registry.count("ft/faults_injected")
            - inj0,
            "refresh_trigger": self.refresh_trigger,
            "drift_psi_max": round(self.drift_psi_max, 4),
            "drift_windows": int(self.drift_windows),
            "drift_detect_windows": self.drift_detect_windows,
            "drift_triggered_refreshes": int(self.drift_triggered),
            "traffic": traffic,
            "problems": problems,
            "ok": not problems,
        }
        events.emit("refresh_done", ok=report["ok"],
                    num_cycles=report["num_cycles"],
                    rollbacks=rollbacks, slo_breaches=slo_breaches,
                    stranded=stranded)
        return report
