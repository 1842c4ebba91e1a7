"""Unified chaos schedule for the closed refresh loop.

Port of ``lightgbm_tpu/loop/chaos.py``. The fault plane
(``obs/faults.py``) exposes ten injectable sites: seven on the training
side and ``serve_admit`` / ``serve_dispatch`` / ``gateway_push`` on the
serving side. This module is the one place that knows which sites
belong to which phase of a refresh cycle, so the refresh controller
(``loop/controller.py``) and the card's smoke run drive the same
deterministic schedule instead of each hand-rolling spec strings.

A schedule maps cycle index -> a list of :class:`ChaosLeg` entries. Each
leg names the fault spec, the phase it must be armed for (``train``
fires around the attach+resume training step, ``publish`` around the
canary window, ``telemetry`` around the gateway push), and whether the
cycle is expected to end in a rollback (a *poisoned* refresh: the
canary must fail closed while the previous version keeps serving).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

from ..obs import faults

#: the training-side sites
TRAIN_SITES = ("shard_open", "prefetch_device_put", "spill_write",
               "trace_finalize", "metrics_dump", "registry_swap",
               "checkpoint_finalize")
#: the serving-side sites the refresh loop adds to the shared schedule
SERVE_SITES = ("serve_admit", "serve_dispatch", "gateway_push")


class ChaosLeg(NamedTuple):
    spec: str        # faults.configure() spec, e.g. "serve_dispatch:nth:1"
    phase: str       # "train" | "publish" | "telemetry"
    poison: bool     # True -> this cycle's canary must roll back


def refresh_schedule(cycles: int) -> Dict[int, List[ChaosLeg]]:
    """The deterministic per-cycle schedule the refresh loop runs.

    Cycle 0 (bootstrap train + first publish) is always clean: it is
    the baseline every later cycle's model and SLO numbers are compared
    against. Refresh cycles then rotate through three legs:

    1. a poisoned publish (``serve_dispatch`` on the first canary
       batch): the canary window fails closed, the registry rolls back,
       and live traffic keeps being answered by the previous version;
    2. a retryable train-side fault (``prefetch_device_put``): the
       attach+resume training step absorbs it through the bounded-retry
       plane and the cycle promotes normally;
    3. a telemetry fault (``gateway_push``): the snapshot push is
       retried or skipped; a lost push costs staleness, never the loop.

    With fewer than four cycles the rotation truncates; the poisoned leg
    comes first, because rollback under traffic is the property the
    loop exists to prove."""
    legs = [
        ChaosLeg("serve_dispatch:nth:1", "publish", True),
        ChaosLeg("prefetch_device_put:nth:1", "train", False),
        ChaosLeg("gateway_push:nth:1", "telemetry", False),
    ]
    out: Dict[int, List[ChaosLeg]] = {}
    for cycle in range(1, cycles):
        out[cycle] = [legs[(cycle - 1) % len(legs)]]
    return out


def expected_rollbacks(schedule: Dict[int, List[ChaosLeg]]) -> int:
    return sum(1 for legs in schedule.values()
               for leg in legs if leg.poison)


def validate_schedule(schedule: Dict[int, List[ChaosLeg]]) -> None:
    """Every site in the schedule must be a real injectable site: a
    misspelled spec would inject nothing, and the loop would report a
    fault survived that never fired."""
    for legs in schedule.values():
        for leg in legs:
            for part in leg.spec.split(";"):
                site = part.split(":", 1)[0].strip()
                if site not in faults.SITES:
                    raise ValueError("unknown fault site %r in chaos "
                                     "schedule (valid: %s)"
                                     % (site, ", ".join(faults.SITES)))
