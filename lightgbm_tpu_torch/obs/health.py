"""Backend health events + SLO watchdogs.

Port of ``lightgbm_tpu/obs/health.py``. Backend state is a first-class,
machine-readable event: ``backend`` names the platform that actually
executes (``cuda`` with the card's name, compute capability and the
device count; ``cpu`` when the caller asked for it), emitted once per
process at first training.

The JAX package also has ``record_backend_fallback``: a requested
accelerator that degraded to another platform. The port has no such
path — a run asked for on ``cuda`` runs there or raises, and no ``try``
gives way to the CPU — so the function has no caller here and is left
out. The ``backend_fallback`` watch rule stays, reading a counter that
nothing in the port increments.

:class:`Watchdog` runs threshold rules over the registry snapshot
stream (obs/export.py feeds it one snapshot per exporter tick) and
emits a structured ``health`` event EXACTLY ONCE per breach: a rule
fires on the false→true transition of its condition and re-arms when
the condition clears, so a saturated queue produces one event, not one
per snapshot. Default rules: recapture spike (new kernel builds and
CUDA graph captures per interval, the port's counterpart of the JAX
package's jit retrace spike), backend fallback, serve queue-depth
saturation, and trace drop counters (spool + readiness drainer).
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

from ..utils import log
from . import events
from .registry import registry

_reported = False


def record_backend(platform: Optional[str] = None,
                   source: str = "", device=None) -> Optional[str]:
    """Emit the ``backend`` event. ``platform`` ``cuda`` (or a CUDA
    ``device``) adds the card's name, compute capability and the device
    count; ``cpu`` records a CPU run the caller asked for. With neither,
    ``cuda`` when the process has initialized CUDA, else nothing. Also
    sets the ``backend`` gauge."""
    import sys
    torch = sys.modules.get("torch")
    if device is not None:
        platform = getattr(device, "type", str(device))
    if platform is None:
        if torch is None or not torch.cuda.is_initialized():
            return None
        platform = "cuda"
    fields = {}
    n_devices = 1
    if platform == "cuda" and torch is not None:
        index = getattr(device, "index", None)
        index = torch.cuda.current_device() if index is None else index
        n_devices = torch.cuda.device_count()
        cap = torch.cuda.get_device_capability(index)
        fields = {"device_name": torch.cuda.get_device_name(index),
                  "capability": "%d.%d" % cap}
    global _reported
    _reported = True  # an explicit record IS the process's record
    registry.gauge("backend", platform)
    events.emit("backend", platform=platform, num_devices=n_devices,
                source=source, **fields)
    return platform


def record_backend_once(source: str = "", device=None) -> None:
    """Process-wide once-only backend record (first training emits)."""
    if _reported:
        return
    record_backend(source=source, device=device)


# ----------------------------------------------------------------------
# SLO watchdogs over the snapshot stream
# ----------------------------------------------------------------------

def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class WatchRule:
    """One threshold rule: ``check(snapshot, state)`` returns a detail
    dict while the condition holds, else None. ``state`` is a per-rule
    dict the rule may use for counter deltas across snapshots.
    ``component`` names the subsystem whose signal the rule watches —
    it rides on the emitted ``health`` event so a consumer can route a
    breach without parsing the rule name."""

    def __init__(self, name: str,
                 check: Callable[[dict, dict], Optional[dict]],
                 component: str = "obs.health") -> None:
        self.name = name
        self.check = check
        self.component = component


def _counter_delta(snap: dict, state: dict, match, state_key: str,
                   first_is_baseline: bool) -> float:
    """Delta of the summed counters since the previous snapshot. With
    ``first_is_baseline`` the first observation arms the rule without
    firing (retrace watch: warm-up compiles are normal); without it the
    baseline is 0, so pre-existing occurrences fire on first look
    (fallback / drops: already-degraded is still degraded)."""
    counters = snap.get("counters", {})
    total = float(sum(v for k, v in counters.items()
                      if (k in match if isinstance(match, (set, frozenset))
                          else k.startswith(match))))
    if state_key not in state:
        state[state_key] = total if first_is_baseline else 0.0
    delta = total - state[state_key]
    state[state_key] = total
    return delta


# what the recapture watch counts (obs/compile.py)
_RECAPTURE_PREFIXES = ("graph_capture/", "kernel_build/")


def default_rules() -> List[WatchRule]:
    """The stock SLO rules. Thresholds are env-tunable:

    - ``LIGHTGBM_TPU_WATCH_RETRACE_SPIKE`` (default 8): total new
      kernel builds and CUDA graph captures between two snapshots at or
      above this = a recapture storm (steady state should capture
      ~never);
    - ``LIGHTGBM_TPU_WATCH_QUEUE_DEPTH`` (default 1024): serve queue
      depth at or above this = admission saturation;
    - ``LIGHTGBM_TPU_WATCH_PREFETCH_STALL`` (default 0.25): share of
      the snapshot window the out-of-core shard prefetcher spent
      stalling the consumer (``io/prefetch_stall_ms`` delta over wall
      time between snapshots) at or above this = a starving loader —
      on a day-long out-of-core run the device is idle that fraction
      of the time waiting for shard bytes;
    - ``LIGHTGBM_TPU_WATCH_RETRY_STORM`` (default 16): total new
      I/O retries (``ft/retries``) plus injected faults per snapshot
      window at or above this = ``fault_storm`` — the run is limping
      on its retry layer (a flaky disk/runtime), act before the
      retries start exhausting;
    - ``LIGHTGBM_TPU_WATCH_SHED_RATE`` (default 0.05): share of the
      window's serve submissions shed by admission control
      (``serve/shed_total`` delta over ``serve/requests`` delta) at or
      above this = sustained overload — capacity, not a blip, is the
      problem (a minimum of 8 sheds per window filters noise);
    - ``serve/breaker_state`` at 2 (open) = ``breaker_open`` — the
      serving worker is failing every dispatch and shedding load by
      design; level-based like queue saturation, re-arms when the
      half-open probe closes it;
    - backend fallback, trace drops, and exhausted retries
      (``retry_exhausted`` — some I/O site gave up after its bounded
      attempts, utils/retry.py) fire on ANY new occurrence;
    - ``refresh_slo`` — the continuous-refresh contract
      (the refresh loop, ``loop/controller.py``), armed ONLY while the
      ``refresh/active`` gauge is truthy (the refresh controller sets
      it around its loop and evaluates once at arm time to baseline
      the counters): serving p99 during a refresh
      (``refresh/serve_p99_ms`` gauge) at or above
      ``LIGHTGBM_TPU_WATCH_REFRESH_P99_MS`` (default 250), more
      rollbacks in one refresh window than the
      ``LIGHTGBM_TPU_WATCH_REFRESH_ROLLBACKS`` budget (default 1 —
      the chaos schedule's single poisoned canary is expected, a
      second rollback is not), or ANY stranded future
      (``serve/drain_failed`` delta) is a breach.
    """
    retrace_thr = _env_float("LIGHTGBM_TPU_WATCH_RETRACE_SPIKE", 8)
    queue_thr = _env_float("LIGHTGBM_TPU_WATCH_QUEUE_DEPTH", 1024)
    stall_thr = _env_float("LIGHTGBM_TPU_WATCH_PREFETCH_STALL", 0.25)
    storm_thr = _env_float("LIGHTGBM_TPU_WATCH_RETRY_STORM", 16)
    shed_thr = _env_float("LIGHTGBM_TPU_WATCH_SHED_RATE", 0.05)
    # below this much new stall time the share is noise, not starvation
    kMinStallMs = 50.0
    # below this many sheds per window the rate is noise, not overload
    kMinSheds = 8.0

    def retrace_spike(snap, state):
        delta = _counter_delta(snap, state, _RECAPTURE_PREFIXES, "prev",
                               first_is_baseline=True)
        if delta >= retrace_thr:
            return {"value": delta, "threshold": retrace_thr,
                    "detail": "%d new kernel builds / graph captures in "
                              "one snapshot interval" % delta}
        return None

    def backend_fallback(snap, state):
        delta = _counter_delta(snap, state,
                               frozenset(("backend_fallback",)), "prev",
                               first_is_baseline=False)
        if delta > 0:
            return {"value": delta, "threshold": 1,
                    "detail": "backend fallback recorded"}
        return None

    def queue_saturation(snap, state):
        depth = float(snap.get("gauges", {}).get("serve/queue_depth", 0))
        if depth >= queue_thr:
            return {"value": depth, "threshold": queue_thr,
                    "detail": "serve queue depth saturated"}
        return None

    def trace_drops(snap, state):
        # trace/dropped_events covers both sinks: the streaming
        # spool's backlog-full chunk drops and the bounded single-file
        # buffer's overflow (the per-stream readiness drainer cannot
        # drop — coalescing caps each stream at one in-flight watch)
        delta = _counter_delta(
            snap, state, frozenset(("trace/dropped_events",)),
            "prev", first_is_baseline=False)
        if delta > 0:
            return {"value": delta, "threshold": 1,
                    "detail": "trace events dropped (spool backlog "
                              "full or span buffer overflow)"}
        return None

    def prefetch_stall(snap, state):
        # share of the window the shard consumer sat blocked on
        # staging (the out-of-core shard prefetcher counts blocked ms);
        # the first observation arms the baseline — construction-time
        # staging before the first snapshot is not a breach
        now = time.monotonic()
        delta_ms = _counter_delta(
            snap, state, frozenset(("io/prefetch_stall_ms",)), "prev",
            first_is_baseline=True)
        prev_t = state.get("prev_t")
        state["prev_t"] = now
        if prev_t is None or delta_ms < kMinStallMs:
            return None
        window = max(now - prev_t, 1e-9)
        share = (delta_ms / 1000.0) / window
        if share >= stall_thr:
            return {"value": round(min(share, 1.0), 4),
                    "threshold": stall_thr,
                    "detail": "shard prefetcher stalled the consumer "
                              "%.0f ms over a %.1f s window "
                              "(loader starving the device)"
                              % (delta_ms, window)}
        return None

    def retry_exhausted(snap, state):
        # any I/O site that gave up after its bounded attempts is a
        # breach on its own — whatever failure followed (fatal, dropped
        # segment, skipped dump) already happened
        delta = _counter_delta(
            snap, state, frozenset(("ft/retry_exhausted",)), "prev",
            first_is_baseline=False)
        if delta > 0:
            return {"value": delta, "threshold": 1,
                    "detail": "an I/O retry site gave up after its "
                              "bounded attempts"}
        return None

    def fault_storm(snap, state):
        # rate rule (retries + injected faults per window): the first
        # snapshot arms the baseline like retrace_spike — retries that
        # happened before watching started are history, not a storm
        delta = _counter_delta(
            snap, state,
            frozenset(("ft/retries", "ft/faults_injected")), "prev",
            first_is_baseline=True)
        if delta >= storm_thr:
            return {"value": delta, "threshold": storm_thr,
                    "detail": "%d I/O retries/injected faults in one "
                              "snapshot interval (run is limping on "
                              "the retry layer)" % delta}
        return None

    def shed_rate(snap, state):
        # rate rule over the serving plane's admission control: the
        # first snapshot arms both baselines (sheds before watching
        # started are history), then the windowed shed share of
        # submissions is the signal — absolute shed counts grow
        # forever on a healthy server that survived one spike
        shed = _counter_delta(snap, state,
                              frozenset(("serve/shed_total",)),
                              "prev_shed", first_is_baseline=True)
        subs = _counter_delta(snap, state,
                              frozenset(("serve/requests",)),
                              "prev_req", first_is_baseline=True)
        if shed < kMinSheds:
            return None
        share = shed / max(subs, shed, 1.0)
        if share >= shed_thr:
            return {"value": round(share, 4), "threshold": shed_thr,
                    "detail": "admission control shed %d of %d serve "
                              "submissions in one snapshot window "
                              "(sustained overload)" % (shed, subs)}
        return None

    def breaker_open(snap, state):
        # level-based like queue_saturation: one event per open
        # episode, re-arms when the half-open probe closes the
        # breaker. The gauge is a per-model FAMILY
        # (serve/breaker_state/<model>) — the worst state across
        # every breaker is the signal, so one server closing cannot
        # mask another still open
        worst = 0.0
        for k, v in snap.get("gauges", {}).items():
            if k == "serve/breaker_state" \
                    or k.startswith("serve/breaker_state/"):
                try:
                    worst = max(worst, float(v))
                except (TypeError, ValueError):
                    continue
        if worst >= 2:
            return {"value": worst, "threshold": 2,
                    "detail": "a serve circuit breaker is OPEN — every "
                              "dispatch is failing and submits are "
                              "being rejected fast"}
        return None

    refresh_p99_thr = _env_float("LIGHTGBM_TPU_WATCH_REFRESH_P99_MS",
                                 250)
    refresh_rb_budget = _env_float(
        "LIGHTGBM_TPU_WATCH_REFRESH_ROLLBACKS", 1)

    def refresh_slo(snap, state):
        # the closed-loop refresh contract: armed only while the
        # refresh/active gauge is up. Counter baselines keep tracking
        # while idle, so history before a refresh window can never
        # fire; the per-window rollback accumulator resets when the
        # window closes.
        gauges = snap.get("gauges", {})
        rb = _counter_delta(snap, state,
                            frozenset(("serve/rollbacks",)),
                            "prev_rb", first_is_baseline=True)
        stranded = _counter_delta(snap, state,
                                  frozenset(("serve/drain_failed",)),
                                  "prev_drain", first_is_baseline=True)
        if not gauges.get("refresh/active"):
            state.pop("rb_window", None)
            return None
        state["rb_window"] = state.get("rb_window", 0.0) + rb
        if stranded > 0:
            return {"value": stranded, "threshold": 1,
                    "detail": "%d futures stranded by a server drain "
                              "during a refresh window" % stranded}
        if state["rb_window"] > refresh_rb_budget:
            return {"value": state["rb_window"],
                    "threshold": refresh_rb_budget,
                    "detail": "%d canary rollbacks in one refresh "
                              "window exceed the budget of %d"
                              % (state["rb_window"], refresh_rb_budget)}
        p99 = float(gauges.get("refresh/serve_p99_ms", 0.0))
        if p99 >= refresh_p99_thr:
            return {"value": round(p99, 3),
                    "threshold": refresh_p99_thr,
                    "detail": "serving p99 %.1f ms during a refresh "
                              "window (SLO %.0f ms)"
                              % (p99, refresh_p99_thr)}
        return None

    # ---- data/model quality rules (obs/quality.py gauges) ------------
    psi_thr = _env_float("LIGHTGBM_TPU_WATCH_PSI", 0.25)
    score_psi_thr = _env_float("LIGHTGBM_TPU_WATCH_SCORE_PSI", 0.25)
    label_psi_thr = _env_float("LIGHTGBM_TPU_WATCH_LABEL_PSI", 0.25)
    edge_thr = _env_float("LIGHTGBM_TPU_WATCH_EDGE_MASS", 0.10)
    edge_windows = _env_float("LIGHTGBM_TPU_WATCH_EDGE_WINDOWS", 3)

    def feature_drift(snap, state):
        # level rule over the drained drift window: worst per-feature
        # PSI at or above LIGHTGBM_TPU_WATCH_PSI (default 0.25, the
        # classic "distribution has shifted" PSI rule of thumb); fires
        # once per breach episode, re-arms when a window scores clean
        gauges = snap.get("gauges", {})
        v = float(gauges.get("quality/psi_max", 0.0))
        if v < psi_thr:
            return None
        worst, worst_v = "?", -1.0
        for k, g in gauges.items():
            if k.startswith("quality/psi/feature/"):
                try:
                    g = float(g)
                except (TypeError, ValueError):
                    continue
                if g > worst_v:
                    worst, worst_v = k.rsplit("/", 1)[1], g
        return {"value": round(v, 4), "threshold": psi_thr,
                "feature": worst,
                "detail": "serving-input drift: PSI %.3f on feature %s "
                          "(threshold %.2f)" % (v, worst, psi_thr)}

    def prediction_drift(snap, state):
        v = float(snap.get("gauges", {}).get("quality/score_psi", 0.0))
        if v >= score_psi_thr:
            return {"value": round(v, 4), "threshold": score_psi_thr,
                    "detail": "prediction-score drift: PSI %.3f vs the "
                              "training-score histogram (threshold "
                              "%.2f)" % (v, score_psi_thr)}
        return None

    def label_drift(snap, state):
        v = float(snap.get("gauges", {}).get("quality/label_psi", 0.0))
        if v >= label_psi_thr:
            return {"value": round(v, 4), "threshold": label_psi_thr,
                    "detail": "label drift: PSI %.3f vs the training "
                              "label histogram (threshold %.2f)"
                              % (v, label_psi_thr)}
        return None

    def retrain_required(snap, state):
        # sustained mass in the grid's catch-all edge bins means the
        # frozen bin boundaries no longer cover the data: a refresh
        # (refit/resume on the same mappers) cannot fix that — only a
        # full retrain (new spill, new mappers) can. Counted per
        # DRAINED window (quality/windows delta), needs
        # LIGHTGBM_TPU_WATCH_EDGE_WINDOWS consecutive breaching
        # windows so one weird batch cannot demand a retrain
        counters = snap.get("counters", {})
        wins = float(counters.get("quality/windows", 0.0))
        prev = state.get("prev_windows")
        state["prev_windows"] = wins
        if prev is not None and wins > prev:
            em = float(snap.get("gauges", {})
                       .get("quality/edge_mass", 0.0))
            state["streak"] = state.get("streak", 0) + 1 \
                if em >= edge_thr else 0
            state["last_em"] = em
        if state.get("streak", 0) >= edge_windows:
            return {"value": round(state.get("last_em", 0.0), 4),
                    "threshold": edge_thr,
                    "windows": state["streak"],
                    "detail": "%.0f%% excess mass in overflow/edge "
                              "bins for %d consecutive windows — the "
                              "frozen bin boundaries no longer cover "
                              "the data; refresh cycles cannot fix "
                              "this, schedule a full retrain (new "
                              "spill, new mappers)"
                              % (100 * state.get("last_em", 0.0),
                                 state["streak"])}
        return None

    return [WatchRule("retrace_spike", retrace_spike),
            WatchRule("backend_fallback", backend_fallback),
            WatchRule("queue_saturation", queue_saturation),
            WatchRule("trace_drops", trace_drops),
            WatchRule("prefetch_stall", prefetch_stall),
            WatchRule("retry_exhausted", retry_exhausted),
            WatchRule("fault_storm", fault_storm),
            WatchRule("shed_rate", shed_rate),
            WatchRule("breaker_open", breaker_open),
            WatchRule("refresh_slo", refresh_slo),
            WatchRule("feature_drift", feature_drift,
                      component="obs.quality"),
            WatchRule("prediction_drift", prediction_drift,
                      component="obs.quality"),
            WatchRule("label_drift", label_drift,
                      component="obs.quality"),
            WatchRule("retrain_required", retrain_required,
                      component="obs.quality")]


def fleet_rules() -> List[WatchRule]:
    """Watchdog rules over the GATEWAY's aggregated fleet snapshot
    (``obs.gateway.MetricsGateway.fleet_snapshot``: one entry per
    pushing (rank, process) source with push age + pre-extracted
    aggregates), evaluated at the gateway on every push and every
    ``/healthz`` scrape. Same :class:`Watchdog` once-per-breach +
    re-arm contract as the per-process rules. Thresholds:

    - ``LIGHTGBM_TPU_WATCH_RANK_SKEW`` (default 2.0): slowest/fastest
      rank ratio of summed stage seconds at or above this = one rank
      is dragging the synchronous collective loop (every other rank
      waits at the allreduce — the whole fleet runs at the straggler's
      speed); needs ≥ 2 reporting ranks and ≥ 1 s on the slowest so
      warm-up noise can't fire it;
    - ``LIGHTGBM_TPU_WATCH_PUSH_STALE_S`` (default 30): a source whose
      last push is at least this old = ``dead_rank`` — the process is
      hung, partitioned, or gone; level-based, re-arms when pushes
      resume (a ``/healthz`` scrape is also an evaluation tick, since
      a dead rank by definition stops generating push evaluations);
    - ``LIGHTGBM_TPU_WATCH_SHED_RATE`` (default 0.05, shared with the
      per-process rule): fleet-wide windowed shed share of serve
      submissions summed ACROSS sources at or above this =
      ``fleet_shed_rate`` — the fleet as a whole is overloaded even
      if no single replica's local rate trips its own rule.
    """
    skew_thr = _env_float("LIGHTGBM_TPU_WATCH_RANK_SKEW", 2.0)
    shed_thr = _env_float("LIGHTGBM_TPU_WATCH_SHED_RATE", 0.05)
    # below this much stage time on the SLOWEST rank, ratios are
    # warm-up noise, not skew
    kMinStageSeconds = 1.0
    kMinSheds = 8.0

    def _ranks(snap):
        return (snap.get("fleet") or {}).get("ranks") or {}

    def rank_skew(snap, state):
        # per RANK, not per source: a rank's train + serve processes
        # both push, and stage seconds belong to the rank they ran on
        per_rank: Dict[str, float] = {}
        for e in _ranks(snap).values():
            r = str(e.get("rank", "?"))
            per_rank[r] = per_rank.get(r, 0.0) \
                + float(e.get("stage_seconds", 0.0))
        per_rank = {r: s for r, s in per_rank.items() if s > 0.0}
        if len(per_rank) < 2:
            return None
        slow_r = max(per_rank, key=per_rank.get)
        fast_r = min(per_rank, key=per_rank.get)
        slowest, fastest = per_rank[slow_r], per_rank[fast_r]
        if slowest < kMinStageSeconds:
            return None
        ratio = slowest / max(fastest, 1e-9)
        if ratio >= skew_thr:
            return {"value": round(ratio, 3), "threshold": skew_thr,
                    "detail": "rank %s spent %.1fx the stage seconds "
                              "of rank %s (%.2fs vs %.2fs) — the "
                              "collective loop runs at the "
                              "straggler's speed"
                              % (slow_r, ratio, fast_r,
                                 slowest, fastest)}
        return None

    def dead_rank(snap, state):
        fleet = snap.get("fleet") or {}
        stale_after = float(fleet.get("stale_after_s", 30.0))
        stale = {k: float(e.get("age_s", 0.0))
                 for k, e in _ranks(snap).items()
                 if float(e.get("age_s", 0.0)) >= stale_after}
        if stale:
            worst = max(stale.values())
            return {"value": round(worst, 3), "threshold": stale_after,
                    "detail": "no push from %s for %.1fs (stale after "
                              "%.0fs) — hung, partitioned, or dead"
                              % (", ".join(sorted(stale)), worst,
                                 stale_after)}
        return None

    def fleet_shed_rate(snap, state):
        # windowed like the per-process shed_rate: first observation
        # arms the baselines, then the fleet-summed deltas are the
        # signal (cumulative counters grow forever on a healthy fleet
        # that survived one spike)
        shed = sum(float(e.get("shed_total", 0.0))
                   for e in _ranks(snap).values())
        reqs = sum(float(e.get("requests", 0.0))
                   for e in _ranks(snap).values())
        if "prev_shed" not in state:
            state["prev_shed"], state["prev_req"] = shed, reqs
            return None
        d_shed = shed - state["prev_shed"]
        d_req = reqs - state["prev_req"]
        state["prev_shed"], state["prev_req"] = shed, reqs
        if d_shed < kMinSheds:
            return None
        share = d_shed / max(d_req, d_shed, 1.0)
        if share >= shed_thr:
            return {"value": round(share, 4), "threshold": shed_thr,
                    "detail": "the fleet shed %d of %d serve "
                              "submissions in one push window "
                              "(fleet-wide overload)"
                              % (d_shed, d_req)}
        return None

    return [WatchRule("rank_skew", rank_skew),
            WatchRule("dead_rank", dead_rank),
            WatchRule("fleet_shed_rate", fleet_shed_rate)]


class Watchdog:
    """Evaluate threshold rules over successive registry snapshots,
    emitting one ``health`` event per breach (false→true transition;
    the rule re-arms when its condition clears). Each firing also
    increments the ``health/<rule>`` counter, so breaches are visible
    in the very /metrics stream being watched."""

    def __init__(self, reg=registry,
                 rules: Optional[List[WatchRule]] = None) -> None:
        self.reg = reg
        self.rules = rules if rules is not None else default_rules()
        self._state: Dict[str, dict] = {}
        self._breached: Dict[str, bool] = {}
        self._last_fired: Dict[str, dict] = {}

    def evaluate(self, snapshot: Optional[dict] = None) -> List[dict]:
        """Run every rule against ``snapshot`` (default: a fresh
        ``reg.snapshot()``); returns the list of NEW breaches fired
        this evaluation. Never raises."""
        if snapshot is None:
            snapshot = self.reg.snapshot()
        fired: List[dict] = []
        for rule in self.rules:
            try:
                detail = rule.check(snapshot,
                                    self._state.setdefault(rule.name, {}))
            except Exception:
                continue
            breached = detail is not None
            if breached and not self._breached.get(rule.name, False):
                rec = dict(rule=rule.name, severity="warning",
                           component=getattr(rule, "component",
                                             "obs.health"),
                           **detail)
                self._last_fired[rule.name] = rec
                fired.append(rec)
                self.reg.inc("health/" + rule.name)
                log.warning("health watchdog: %s — %s"
                            % (rule.name, detail.get("detail", "")))
                events.emit("health", **rec)
            self._breached[rule.name] = breached
        if fired:
            events.flush()  # breach evidence must survive a crash
        return fired

    def breached(self) -> List[dict]:
        """Rules currently in breach (for /healthz)."""
        return [self._last_fired[name]
                for name, b in sorted(self._breached.items())
                if b and name in self._last_fired]
