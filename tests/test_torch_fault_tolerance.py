"""The port's fault-tolerance module (``repro_torch.runtime``) held to the
reference's (``repro.runtime``): the same heartbeats, preemption notices,
step times, pod counts and recovery calls go through both, and every
answer is equal — the behaviours ``tests/test_substrate.py`` asserts, as
port cases, plus ``ArtifactRecovery``'s event log."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro import runtime as jrt
from repro.runtime import fault_tolerance as jft
from repro_torch import runtime as trt
from repro_torch.runtime import fault_tolerance as tft


def test_exports_match_the_reference():
    names = {n for n in dir(jrt) if not n.startswith("_")} - {
        "fault_tolerance"}
    assert names == {n for n in dir(trt) if not n.startswith("_")} - {
        "fault_tolerance"}


@pytest.mark.parametrize("now", [104.0, 106.0, 110.5])
def test_heartbeat_death_detection(now):
    answers = []
    for mod in (jft, tft):
        hb = mod.HeartbeatMonitor(["a", "b", "c"], timeout=5.0)
        for h in "abc":
            hb.beat(h, 10, 100.0)
        hb.beat("a", 11, 104.0)
        answers.append((hb.dead_hosts(now), hb.min_step()))
    assert answers[0] == answers[1]
    if now == 106.0:
        assert answers[1] == (["b", "c"], 10)


def test_preemption_flag():
    for mod in (jft, tft):
        p = mod.PreemptionHandler()
        assert not p.should_exit
        p.notify()
        assert p.should_exit


def _reports(mod, times, threshold, patience):
    sd = mod.StragglerDetector(threshold=threshold, patience=patience)
    out = []
    for step in times:
        for h, t in enumerate(step):
            sd.record(f"h{h}", float(t))
        out.append([dataclasses.astuple(r) for r in sd.check()])
    return out


def test_straggler_detection_and_policy():
    times = [[4.0 if h == 3 else 1.0 for h in range(4)] for _ in range(4)]
    want = _reports(jft, times, 1.5, 3)
    assert _reports(tft, times, 1.5, 3) == want
    assert want[-1] == [("h3", 4.0, "exclude")]     # ratio 4 >= 3 -> shrink


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_reports_on_noisy_step_times(seed):
    rng = np.random.default_rng(seed)
    times = rng.lognormal(0.0, 0.3, size=(40, 6))
    times[10:, 2] *= 2.0                    # a host slows down: 'reseat'
    times[25:, 4] *= 3.5                    # another falls far behind
    want = _reports(jft, times, 1.5, 5)
    assert _reports(tft, times, 1.5, 5) == want
    assert any(r for r in want)


@pytest.mark.parametrize("args", [(1, 256, 16, 256, 2), (3, 256, 16, 512, 4),
                                  (2, 64, 8, 7, 4), (4, 16, 16, 1, 4)])
def test_elastic_remesh_plan(args):
    assert dataclasses.astuple(tft.plan_elastic_remesh(*args)) == \
        dataclasses.astuple(jft.plan_elastic_remesh(*args))


@pytest.mark.parametrize("args", [(0, 256, 16, 256, 2), (1, 8, 16, 256, 2)])
def test_elastic_remesh_refuses(args):
    for mod in (jft, tft):
        with pytest.raises(ValueError):
            mod.plan_elastic_remesh(*args)


def _recover(mod, which):
    """One warm-boot attempt whose load restores, finds nothing, or raises
    a corruption or a staleness error: the value, the events, ``warm`` and
    what ``save`` was given."""
    rec = mod.ArtifactRecovery(corruption_types=(KeyError,),
                               stale_types=(mod.ArtifactStaleError,))
    saved = []

    def load():
        if which == "corrupt":
            raise KeyError("leaf")
        if which == "stale":
            raise mod.ArtifactStaleError("generation 3: drift 0.9 > 0.5")
        return None if which == "missing" else "restored"

    value = rec.run(load, lambda: "rebuilt", saved.append)
    return value, [(e.kind, e.detail) for e in rec.events], rec.warm, saved


@pytest.mark.parametrize("which", ["restored", "missing", "corrupt", "stale"])
def test_artifact_recovery_classifies_as_the_reference(which):
    got = _recover(tft, which)
    assert got == _recover(jft, which)
    assert got[2] == (which == "restored")
    assert got[3] == ([] if which == "restored" else ["rebuilt"])


def test_artifact_recovery_propagates_other_errors():
    for mod in (jft, tft):
        rec = mod.ArtifactRecovery(corruption_types=(KeyError,))

        def load():
            raise ValueError("not a corruption")

        with pytest.raises(ValueError):
            rec.run(load, lambda: "rebuilt")
        assert rec.events == []
