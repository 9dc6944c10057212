"""Fault tolerance & elasticity for thousand-node runs (a copy of
``repro.runtime.fault_tolerance``, which imports no JAX: the port keeps
its own so that it imports nothing of the reference).

Four cooperating pieces, all deterministic and unit-testable (no wall-clock
dependence in the decision logic — callers inject timestamps):

- ``HeartbeatMonitor``   : hosts report (host_id, step, t); a host whose last
                           heartbeat is older than ``timeout`` is declared
                           dead.  The runtime's reaction to a death is always
                           the same: stop, checkpoint-restore on the surviving
                           topology (see ``plan_elastic_remesh``).
- ``PreemptionHandler``  : turns a SIGTERM (or cloud preemption notice) into a
                           'save-and-exit-at-next-step-boundary' flag — the
                           train loop polls ``should_exit`` once per step so
                           the final checkpoint is always at a step boundary.
- ``StragglerDetector``  : per-step wall times per host; a host slower than
                           ``threshold`` × the rolling median for ``patience``
                           consecutive steps is flagged.  Mitigation is a
                           *policy* returned to the caller: 'reseat' (swap in
                           a hot spare) or 'exclude' (shrink via elastic
                           remesh) — on TPU pods one cannot drop a single chip
                           from a ring, so mitigation granularity is a pod.
- ``plan_elastic_remesh``: given surviving pod count and the model's sharding
                           needs, produce the largest valid mesh (data-axis
                           shrink first — the model axis is fixed by the
                           checkpointed layout, which restores elastically
                           because checkpoints are resharding-on-read).
- ``ArtifactRecovery``   : restore-or-recompute for serving replicas — a
                           corrupt/missing precomputed artifact (factor
                           store) is rebuilt from source instead of crashing
                           the replica, with every decision recorded for the
                           smoke tests to assert on.
"""
from __future__ import annotations

import dataclasses
import signal
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple


# ---------------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------------

class HeartbeatMonitor:
    def __init__(self, hosts: List[str], timeout: float):
        self.timeout = timeout
        self.last: Dict[str, Tuple[int, float]] = {h: (-1, 0.0) for h in hosts}

    def beat(self, host: str, step: int, t: float):
        self.last[host] = (step, t)

    def dead_hosts(self, now: float) -> List[str]:
        return [h for h, (_, t) in self.last.items()
                if now - t > self.timeout]

    def min_step(self) -> int:
        return min(s for s, _ in self.last.values())


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

class PreemptionHandler:
    """SIGTERM -> graceful save-and-exit at the next step boundary."""

    def __init__(self, install_signal: bool = False):
        self._flag = threading.Event()
        if install_signal:
            signal.signal(signal.SIGTERM, lambda *_: self.notify())

    def notify(self):
        self._flag.set()

    @property
    def should_exit(self) -> bool:
        return self._flag.is_set()


# ---------------------------------------------------------------------------
# stragglers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerReport:
    host: str
    ratio: float
    action: str                      # 'reseat' | 'exclude'


class StragglerDetector:
    def __init__(self, threshold: float = 1.5, patience: int = 5,
                 window: int = 50):
        self.threshold = threshold
        self.patience = patience
        self.times: Dict[str, deque] = {}
        self.strikes: Dict[str, int] = {}
        self.window = window

    def record(self, host: str, step_time: float):
        self.times.setdefault(host, deque(maxlen=self.window)).append(
            step_time)

    def _median_of_medians(self) -> float:
        """Lower median of per-host medians: assumes a majority of hosts is
        healthy, so a straggler can never drag the reference upward."""
        meds = []
        for dq in self.times.values():
            xs = sorted(dq)
            meds.append(xs[(len(xs) - 1) // 2])
        xs = sorted(meds)
        return xs[(len(xs) - 1) // 2] if xs else 0.0

    def check(self) -> List[StragglerReport]:
        """Call once per step after all hosts reported."""
        med = self._median_of_medians()
        out = []
        if med <= 0:
            return out
        for host, dq in self.times.items():
            ratio = dq[-1] / med
            if ratio > self.threshold:
                self.strikes[host] = self.strikes.get(host, 0) + 1
            else:
                self.strikes[host] = 0
            if self.strikes.get(host, 0) >= self.patience:
                action = "reseat" if ratio < 3.0 else "exclude"
                out.append(StragglerReport(host=host, ratio=ratio,
                                           action=action))
        return out


# ---------------------------------------------------------------------------
# recompute-on-corruption (serving warm boot)
# ---------------------------------------------------------------------------

class ArtifactStaleError(RuntimeError):
    """A stored/served artifact is VALID but no longer trustworthy.

    Raised by the incremental-maintenance staleness policy
    (``repro_torch.serve.incremental.StalenessPolicy``) when the tracked
    per-generation error estimate drifts past its threshold: the factor
    store decodes fine, but the model it encodes has fallen behind the
    grown corpus.  ``ArtifactRecovery`` treats it like corruption — rebuild
    from source, persist, keep serving — but records the distinct 'stale'
    event kind so re-sketches are attributable separately from damage.
    """


@dataclasses.dataclass(frozen=True)
class RecoveryEvent:
    kind: str           # 'restored' | 'missing' | 'corrupt' | 'stale' | 'rebuilt'
    detail: str = ""


class ArtifactRecovery:
    """Restore-or-recompute policy for precomputed serving artifacts.

    A replica booting from the factor store must never crash on a damaged
    checkpoint — a truncated manifest or half-deleted step dir is an
    *expected* failure mode (preemption mid-write, concurrent gc) whose
    correct reaction is to recompute the artifact from source and persist a
    fresh copy.  ``run`` encodes that policy; every decision lands in
    ``events`` so tests (and the serve-smoke CI job) can assert whether a
    boot was warm (``restored``) or cold (``missing``/``corrupt``/``stale``
    → ``rebuilt``).  Like the rest of this module the logic is
    deterministic and injectable: what counts as corruption is the
    ``corruption_types`` tuple (``checkpoint.CheckpointCorruptionError`` in
    production), and ``stale_types`` (``ArtifactStaleError``) marks
    drift-triggered full re-sketches — same rebuild path, distinct event.
    """

    def __init__(self, corruption_types: Tuple[type, ...] = (RuntimeError,),
                 stale_types: Tuple[type, ...] = (ArtifactStaleError,)):
        self.corruption_types = corruption_types
        self.stale_types = stale_types
        self.events: List[RecoveryEvent] = []

    @property
    def warm(self) -> bool:
        """True when the last ``run`` served the restored artifact as-is."""
        return bool(self.events) and self.events[-1].kind == "restored"

    def run(self, load: Callable[[], object], rebuild: Callable[[], object],
            save: Optional[Callable[[object], None]] = None):
        """``load()`` (returning None when nothing is stored), falling back
        to ``rebuild()`` on a missing, corrupt, or stale store; ``save``
        persists the rebuilt artifact so the NEXT boot is warm again."""
        try:
            out = load()
        except self.stale_types as e:
            self.events.append(RecoveryEvent(
                "stale", f"{type(e).__name__}: {e}"))
            out = None
        except self.corruption_types as e:
            self.events.append(RecoveryEvent(
                "corrupt", f"{type(e).__name__}: {e}"))
            out = None
        else:
            if out is not None:
                self.events.append(RecoveryEvent("restored"))
                return out
            self.events.append(RecoveryEvent("missing"))
        out = rebuild()
        if save is not None:
            save(out)
        self.events.append(RecoveryEvent("rebuilt"))
        return out


# ---------------------------------------------------------------------------
# elastic re-mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    global_batch: int                # rescaled to keep per-chip batch fixed
    note: str


def plan_elastic_remesh(surviving_pods: int, chips_per_pod: int,
                        model_parallel: int, global_batch: int,
                        original_pods: int) -> ElasticPlan:
    """Largest valid mesh on the survivors.

    The 'model' axis is pinned (the param layout in the checkpoint shards over
    it); the 'data' axis absorbs the shrink; the global batch is rescaled
    proportionally (keeping per-chip batch, i.e. throughput-optimal — the
    loss-scale consequences are the trainer's documented policy).
    """
    if surviving_pods < 1:
        raise ValueError("no survivors")
    data = chips_per_pod // model_parallel
    if data < 1:
        raise ValueError(
            f"model_parallel={model_parallel} exceeds a pod "
            f"({chips_per_pod} chips)")
    batch = max(1, global_batch * surviving_pods // original_pods)
    if surviving_pods == 1:
        return ElasticPlan(mesh_shape=(data, model_parallel),
                           mesh_axes=("data", "model"),
                           global_batch=batch,
                           note="single-pod mesh (pod axis dropped)")
    return ElasticPlan(mesh_shape=(surviving_pods, data, model_parallel),
                       mesh_axes=("pod", "data", "model"),
                       global_batch=batch,
                       note=f"elastic shrink {original_pods}->"
                            f"{surviving_pods} pods")
