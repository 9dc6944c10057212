"""The port's incremental maintenance (``repro_torch.serve.incremental``)
held against the JAX reference (CPU).

Sizes are ``tests/test_incremental.py``'s: N, D, C, S = 240, 4, 32, 64,
B = 16 appended rows a batch, RBF σ = 3.  The parity cases start both
packages from the same artifact (the reference's, carried across with
``convert.artifact_from_reference``) and append the same batches: the
launch's G, C, the Gram statistics and the Woodbury workspace M ≤ 1e-5
scale-normalized; U, the KRR head and the spectrum ≤ 1e-4, the KPCA head
through H Λ Hᵀ = U Cᵀ P_k C U (its top-k projector, free of the
eigenvectors' signs and turns) and the feature head through its Gram
≤ 1e-4; the drift to 1e-5; the meters equal.  W⁺ and (αI + CᵀC U)⁻¹ are
held through the products the refresh uses (W⁺W, M = U·inner⁻¹): at this
smooth shape W's condition number is ~5e5, so one f32 rounding of W's
entries (the two packages' exp) moves W⁺ by ~4e-4, U by ~3e-7 and single
KPCA columns by up to ~2e-4.  A delta chain the reference committed
restores in the port bit for bit.  Every behaviour
``tests/test_incremental.py`` asserts has a port case, on the port's own
build (its draws recovered from the reference's key).
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.core import sketch as jsk
from repro.core.instrument import CountingOperator as JCounting
from repro.kernels.pairwise import specs as jspecs
from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.core.instrument import CountingOperator
from repro_torch.kernels.pairwise import specs as pw_specs
from repro_torch.launch.serve_kernel import BatchPolicy, KernelServer
from repro_torch.runtime.fault_tolerance import (ArtifactRecovery,
                                                 ArtifactStaleError)
from repro_torch.serve import (
    GenerationStats,
    IncrementalMaintainer,
    StalenessPolicy,
    append_rows,
    build_artifact,
    compact,
    dense_krr_oracle,
    dense_oracle,
    gc_superseded_deltas,
    init_state,
    is_delta_step,
    load_artifact,
    load_chain,
    load_or_rebuild,
    parity_gap,
    save_artifact,
)

N, D, C, S = 240, 4, 32, 64
B = 16
KEY = jax.random.PRNGKey(0)
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Small intra-op pool for the six workers; one small ``torch.exp``
    first (ROADMAP C: the first multi-threaded exp of a process)."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.exp(torch.zeros(64))
    yield
    torch.set_num_threads(old)


def _problem(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((d,)).astype(np.float32)
    y = np.tanh(X @ w)
    return X, y, w


def _batches(w, rng, count, rows=B, d=D):
    out = []
    for _ in range(count):
        Xb = rng.standard_normal((rows, d)).astype(np.float32)
        out.append((Xb, np.tanh(Xb @ w)))
    return out


def _port_build(X, y, spec_params, key, c=C, s=S, ref=None):
    """The port's build on the reference's draws for ``key`` (its columns
    from the reference build ``ref``, or rebuilt for ``key``)."""
    spec = pw_specs.get_spec("rbf", **spec_params)
    if ref is None:
        ref = jserve.build_artifact(
            jnp.asarray(X), jnp.asarray(y, jnp.float32),
            jspecs.get_spec("rbf", **spec_params), c=c, s=s, alpha=1.0,
            key=key)
    Smat = np.array(jsk.GaussianSketch(jax.random.split(key)[1],
                                       X.shape[0], s)._mat())
    return build_artifact(X, y, spec, c=c, s=s, alpha=1.0,
                          idx=np.array(ref.landmark_indices), S=Smat,
                          device=CPU)


@pytest.fixture(scope="module")
def ref_built():
    X, y, w = _problem()
    spec = jspecs.get_spec("rbf", sigma=3.0)
    art = jserve.build_artifact(jnp.asarray(X), jnp.asarray(y, jnp.float32),
                                spec, c=C, s=S, alpha=1.0, key=KEY)
    return art, X, y, w


@pytest.fixture(scope="module")
def built(ref_built):
    ref, X, y, w = ref_built
    art = _port_build(X, y, {"sigma": 3.0}, KEY, ref=ref)
    return art, X, y, w


def np64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(t, np.float64)


def scaled(port, ref) -> float:
    port, ref = np64(port), np64(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# against the reference: the same artifact, the same batches
# ---------------------------------------------------------------------------

def test_append_rows_matches_reference(ref_built):
    ref, X, y, w = ref_built
    art = convert.artifact_from_reference(
        jax.tree.map(np.asarray, jserve.artifact_to_tree(ref)), device=CPU)
    st, jst = init_state(art, y), jserve.init_state(ref, y)
    for f in ("CtC", "Cty", "inner_inv", "U64", "W"):
        assert scaled(getattr(st, f), getattr(jst, f)) <= 1e-5, f
    assert scaled(st.W_pinv @ st.W, jst.W_pinv @ jst.W) <= 1e-5
    op = CountingOperator(art.landmark_operator())
    jop = JCounting(ref.landmark_operator())
    rng = np.random.default_rng(1)
    for Xb, yb in _batches(w, rng, 3):
        art, st, stats, delta = append_rows(art, st, Xb, yb, op=op)
        ref, jst, jstats, jdelta = jserve.append_rows(ref, jst, Xb, yb,
                                                      op=jop)
        assert scaled(delta.G, jdelta.G) <= 1e-5
        for f in ("CtC", "Cty"):
            assert scaled(getattr(st, f), getattr(jst, f)) <= 1e-5, f
        assert scaled(st.U64, jst.U64) <= 1e-4
        assert stats.generation == jstats.generation
        assert stats.n_after == jstats.n_after
        assert abs(stats.drift - jstats.drift) <= 1e-5 * max(jstats.drift, 1)
        assert abs(stats.error_est - jstats.error_est) <= \
            1e-5 * max(jstats.error_est, 1)
        assert scaled(art.C, ref.C) <= 1e-5
        assert scaled(art.U, ref.U) <= 1e-4
        assert scaled(art.woodbury_M, ref.woodbury_M) <= 1e-5
        assert scaled(art.heads["krr"], ref.heads["krr"]) <= 1e-4
        assert scaled(art.kpca_eigvals, ref.kpca_eigvals) <= 1e-4
        kp, kr = np64(art.heads["kpca"]), np64(ref.heads["kpca"])
        lp, lr = np64(art.kpca_eigvals), np64(ref.kpca_eigvals)
        assert scaled((kp * lp) @ kp.T, (kr * lr) @ kr.T) <= 1e-4
        fp, fr = np64(art.heads["features"]), np64(ref.heads["features"])
        assert scaled(fp @ fp.T, fr @ fr.T) <= 1e-4
    assert op.counts == jop.counts
    assert op.counts["append_sweeps"] == 3
    assert op.counts["entries"] == 3 * B * C


def test_reference_delta_chain_restores_in_the_port_bitwise(ref_built,
                                                            tmp_path):
    ref, X, y, w = ref_built
    d = str(tmp_path)
    jserve.save_artifact(d, ref, step=0)
    m = jserve.IncrementalMaintainer(ref, y, directory=d, X=X)
    rng = np.random.default_rng(5)
    for Xb, yb in _batches(w, rng, 3):
        m.append(Xb, yb)
    restored, chain = load_chain(d, device=CPU)
    assert [c.generation for c in chain] == [1, 2, 3]
    live = m.artifact
    for f in ("C", "U", "woodbury_M", "kpca_eigvals"):
        assert np.array_equal(getattr(restored, f).numpy(),
                              np.asarray(getattr(live, f))), f
    for t in ("krr", "kpca", "features"):
        assert np.array_equal(restored.heads[t].numpy(),
                              np.asarray(live.heads[t])), t
    assert convert.artifact_from_reference(d, device=CPU).C.shape == \
        restored.C.shape


# ---------------------------------------------------------------------------
# the absorb: metering + parity (test_incremental.py's cases)
# ---------------------------------------------------------------------------

def test_append_is_one_thin_metered_launch(built):
    art, X, y, w = built
    state = init_state(art, y)
    op = CountingOperator(art.landmark_operator())
    rng = np.random.default_rng(1)
    for i, (Xb, yb) in enumerate(_batches(w, rng, 3)):
        art, state, stats, _ = append_rows(art, state, Xb, yb, op=op)
        assert stats.generation == i + 1
        assert stats.n_after == N + (i + 1) * B
        assert op.counts["append_sweeps"] == i + 1
    assert op.counts["sweeps"] == 0
    assert op.counts["fulls"] == 0
    assert op.counts["cross_sweeps"] == 0
    assert op.counts["columns"] == 0
    assert op.counts["entries"] == 3 * B * C


def test_grown_corpus_parity_vs_dense_oracles():
    """The reference's well-conditioned shape for this gate (d = 24,
    σ = 1): the refreshed heads against dense f64 oracles on the grown
    corpus."""
    dq = 24
    X, y, w = _problem(seed=11, d=dq)
    art = _port_build(X, y, {"sigma": 1.0}, KEY)
    state = init_state(art, y)
    rng = np.random.default_rng(2)
    ys = [y[:, None]]
    for Xb, yb in _batches(w, rng, 3, d=dq):
        art, state, _, _ = append_rows(art, state, Xb, yb)
        ys.append(yb[:, None])
    y_full = np.concatenate(ys, axis=0)
    assert int(art.C.shape[0]) == y_full.shape[0]

    qop = art.landmark_operator()
    Xq = rng.standard_normal((19, dq)).astype(np.float32)
    expected = dense_krr_oracle(art, Xq, y_full)
    (got,) = qop.cross(torch.from_numpy(Xq), (art.heads["krr"],))
    assert parity_gap(got, expected) <= 1e-5
    for task in ("kpca", "features"):
        expected = dense_oracle(art, Xq, task)
        (got,) = qop.cross(torch.from_numpy(Xq), (art.heads[task],))
        assert parity_gap(got, expected) <= 1e-4


def test_no_build_artifact_rerun_and_c_grows_by_stacking(built):
    art, X, y, w = built
    state = init_state(art, y)
    rng = np.random.default_rng(3)
    (Xb, yb), = _batches(w, rng, 1)
    art2, state2, stats, delta = append_rows(art, state, Xb, yb)
    assert torch.equal(art2.C[:N], art.C)
    assert art2.X_landmarks is art.X_landmarks
    assert torch.equal(art2.C[N:], delta.G)
    assert state2.n == N + B and stats.batch_rows == B


def test_drift_signal_discriminates(built):
    art, X, y, w = built
    state = init_state(art, y)
    rng = np.random.default_rng(4)
    (Xb, yb), = _batches(w, rng, 1)
    _, _, stats_in, _ = append_rows(art, state, Xb, yb)
    assert stats_in.drift < 0.05
    X_ood = 10.0 + rng.standard_normal((B, D)).astype(np.float32)
    _, _, stats_ood, _ = append_rows(art, init_state(art, y), X_ood,
                                     np.zeros(B, np.float32))
    assert stats_ood.drift > 5 * stats_in.drift


def test_staleness_policy_thresholds():
    pol = StalenessPolicy(drift_threshold=0.3, error_budget=0.4,
                          max_generations=5)

    def stats(**kw):
        base = dict(generation=1, n_before=10, batch_rows=2, n_after=12,
                    drift=0.0, error_est=0.0)
        base.update(kw)
        return GenerationStats(**base)

    assert pol.should_resketch(stats()) is None
    assert "drift" in pol.should_resketch(stats(drift=0.31))
    assert "error" in pol.should_resketch(stats(error_est=0.5))
    assert "generation" in pol.should_resketch(stats(generation=5))


# ---------------------------------------------------------------------------
# delta checkpoints: round trip, chain validation, GC, corruption
# ---------------------------------------------------------------------------

def test_delta_chain_roundtrip_is_bitwise(built, tmp_path):
    art, X, y, w = built
    d = str(tmp_path)
    save_artifact(d, art, step=0)
    m = IncrementalMaintainer(art, y, directory=d, X=X)
    rng = np.random.default_rng(5)
    for Xb, yb in _batches(w, rng, 3):
        m.append(Xb, yb)
    steps = ckpt.committed_steps(d)
    assert steps == [0, 1, 2, 3]
    assert [is_delta_step(d, s) for s in steps] == [False, True, True, True]

    restored = load_artifact(d, device=CPU)
    live = m.artifact
    for f in ("C", "U", "woodbury_M", "kpca_eigvals"):
        a, b = getattr(restored, f), getattr(live, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    for t in ("krr", "kpca", "features"):
        assert torch.equal(restored.heads[t], live.heads[t]), t
    Xq = torch.from_numpy(rng.standard_normal((9, D)).astype(np.float32))
    (p1,) = restored.landmark_operator().cross(Xq, (restored.heads["krr"],))
    (p2,) = live.landmark_operator().cross(Xq, (live.heads["krr"],))
    assert torch.equal(p1, p2)


def test_mid_chain_restore_and_generation_gap_is_corruption(built, tmp_path):
    art, X, y, w = built
    d = str(tmp_path)
    save_artifact(d, art, step=0)
    m = IncrementalMaintainer(art, y, directory=d, X=X)
    rng = np.random.default_rng(6)
    for Xb, yb in _batches(w, rng, 3):
        m.append(Xb, yb)
    mid, chain = load_chain(d, 2, device=CPU)
    assert int(mid.C.shape[0]) == N + 2 * B and len(chain) == 2
    ckpt.remove_step(d, 2)
    with pytest.raises(ckpt.CheckpointCorruptionError):
        load_chain(d, 3, device=CPU)


def test_corrupt_delta_is_corruption_and_rebuild_path_recovers(
        built, tmp_path):
    art, X, y, w = built
    d = str(tmp_path)
    save_artifact(d, art, step=0)
    m = IncrementalMaintainer(art, y, directory=d, X=X)
    rng = np.random.default_rng(7)
    (Xb, yb), = _batches(w, rng, 1)
    m.append(Xb, yb)
    with open(os.path.join(d, "step_000000001", "manifest.json"), "w") as f:
        f.write('{"leaf_00000": {"pa')
    with pytest.raises(ckpt.CheckpointCorruptionError):
        load_artifact(d, device=CPU)
    out, recovery = load_or_rebuild(d, lambda: art, device=CPU)
    assert [e.kind for e in recovery.events] == ["corrupt", "rebuilt"]


def test_undecodable_delta_tree_is_corruption(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 0, {"delta_json": "not json {"})
    assert is_delta_step(d, 0)
    with pytest.raises(ckpt.CheckpointCorruptionError):
        load_chain(d, 0, device=CPU)


def test_gc_superseded_deltas_under_junk_hardening(built, tmp_path):
    art, X, y, w = built
    d = str(tmp_path)
    save_artifact(d, art, step=0)
    m = IncrementalMaintainer(art, y, directory=d, X=X)
    rng = np.random.default_rng(8)
    for Xb, yb in _batches(w, rng, 2):
        m.append(Xb, yb)
    open(os.path.join(d, "step_junk"), "w").close()
    os.makedirs(os.path.join(d, "step_000000077.tmp"))
    os.makedirs(os.path.join(d, "step_000000088"))
    os.makedirs(os.path.join(d, "step_000000099"))
    with open(os.path.join(d, "step_000000099", "manifest.json"), "w") as f:
        f.write('{"truncat')

    assert gc_superseded_deltas(d) == 0
    assert is_delta_step(d, 1) and is_delta_step(d, 2)

    step = compact(d, m.artifact)
    steps = ckpt.committed_steps(d)
    assert step in steps and not is_delta_step(d, step)
    assert 1 not in steps and 2 not in steps
    assert os.path.exists(os.path.join(d, "step_junk"))
    restored = load_artifact(d, device=CPU)
    assert torch.equal(restored.C, m.artifact.C)


def test_gc_keeps_deltas_based_on_latest_full(built, tmp_path):
    art, X, y, w = built
    d = str(tmp_path)
    save_artifact(d, art, step=0)
    m = IncrementalMaintainer(art, y, directory=d, X=X)
    rng = np.random.default_rng(9)
    (Xb, yb), = _batches(w, rng, 1)
    m.append(Xb, yb)
    base = compact(d, m.artifact)
    m.base_step = base
    m.state = init_state(m.artifact, m.y_full())
    (Xb, yb), = _batches(w, rng, 1)
    m.append(Xb, yb)
    assert gc_superseded_deltas(d) == 0
    assert is_delta_step(d, base + 1)


# ---------------------------------------------------------------------------
# staleness -> re-sketch through ArtifactRecovery
# ---------------------------------------------------------------------------

def test_stale_error_routes_to_stale_event():
    rec = ArtifactRecovery(stale_types=(ArtifactStaleError,))

    def load():
        raise ArtifactStaleError("generation 3: drift 0.9 > 0.5")

    out = rec.run(load=load, rebuild=lambda: "fresh")
    assert out == "fresh"
    assert [e.kind for e in rec.events] == ["stale", "rebuilt"]


def test_maintainer_resketch_compacts_and_continues(built, tmp_path):
    art, X, y, w = built
    d = str(tmp_path)
    save_artifact(d, art, step=0)
    rebuilds = []
    spec = pw_specs.get_spec("rbf", sigma=3.0)
    g = torch.Generator().manual_seed(1)

    def rebuild_fn(Xf, yf):
        rebuilds.append(int(Xf.shape[0]))
        return build_artifact(Xf, yf, spec, c=C, s=S, alpha=1.0,
                              generator=g, device=CPU)

    op = CountingOperator(art.landmark_operator())
    m = IncrementalMaintainer(
        art, y, directory=d, X=X,
        staleness=StalenessPolicy(drift_threshold=0.3),
        rebuild_fn=rebuild_fn, op=op)
    rng = np.random.default_rng(10)
    (Xb, yb), = _batches(w, rng, 1)
    stats = m.append(Xb, yb)
    assert not stats.resketch

    X_ood = 10.0 + rng.standard_normal((B, D)).astype(np.float32)
    stats = m.append(X_ood, np.zeros(B, np.float32))
    assert stats.resketch and "drift" in stats.resketch_reason
    assert rebuilds == [N + 2 * B]
    assert [e.kind for e in m.recovery.events] == ["stale", "rebuilt"]
    steps = ckpt.committed_steps(d)
    assert not any(is_delta_step(d, s) for s in steps)
    assert int(load_artifact(d, device=CPU).C.shape[0]) == N + 2 * B
    assert torch.equal(op.inner.X, m.artifact.X_landmarks)   # rebound
    (Xb, yb), = _batches(w, rng, 1)
    stats = m.append(Xb, yb)
    assert stats.generation == 1 and not stats.resketch
    assert op.counts["append_sweeps"] == 3
    assert int(load_artifact(d, device=CPU).C.shape[0]) == N + 3 * B


# ---------------------------------------------------------------------------
# server integration: appends through the continuous-batching loop
# ---------------------------------------------------------------------------

def test_server_absorbs_appends_in_order_and_serves_grown(built, tmp_path):
    art, X, y, w = built
    d = str(tmp_path)
    save_artifact(d, art, step=0)
    op = CountingOperator(art.landmark_operator())
    m = IncrementalMaintainer(art, y, directory=d, X=X, op=op)
    server = KernelServer(art, BatchPolicy(max_wait_s=0.005), op=op,
                          maintainer=m)
    rng = np.random.default_rng(11)
    try:
        batches = _batches(w, rng, 3)
        pending = [server.submit_append(Xb, yb) for Xb, yb in batches]
        stats = [p.wait(timeout=60.0) for p in pending]
        assert [s.generation for s in stats] == [1, 2, 3]
        assert server.appends_served == 3
        assert op.counts["append_sweeps"] == 3
        assert int(server.artifact.C.shape[0]) == N + 3 * B
        y_full = np.concatenate([y[:, None]]
                                + [yb[:, None] for _, yb in batches], axis=0)
        Xq = rng.standard_normal((11, D)).astype(np.float32)
        expected = dense_krr_oracle(server.artifact, Xq, y_full)
        res = server.submit(Xq, "krr").wait(timeout=60.0)
        # 1e-4 as in the reference: this smooth σ = 3, d = 4 kernel
        # amplifies the oracle's f32 U to ~1e-5 on the base build already;
        # the 1e-5 gate runs in test_grown_corpus_parity_vs_dense_oracles
        assert parity_gap(res.out, expected) <= 1e-4
    finally:
        server.stop()
    assert int(load_artifact(d, device=CPU).C.shape[0]) == N + 3 * B


def test_server_submit_append_requires_maintainer(built):
    art, *_ = built
    server = KernelServer(art, BatchPolicy(max_wait_s=0.005))
    try:
        with pytest.raises(RuntimeError, match="maintainer"):
            server.submit_append(np.zeros((2, D), np.float32),
                                 np.zeros(2, np.float32))
    finally:
        server.stop()
