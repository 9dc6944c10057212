"""The port's kernel-model serving path (``repro_torch.serve``,
``repro_torch.launch.serve_kernel``) held against the JAX reference (CPU).

Sizes are ``tests/test_serve.py``'s: N, D, C, S = 240, 24, 48, 96, RBF
σ = 1.  The reference's artifact is built with ``PRNGKey(0)`` (its Pallas
sweep in interpret mode); the port's with the draws recovered from that
key, as ``tests/test_torch_spsd.py`` recovers them (the columns from
``landmark_indices``, the Gaussian sketch from
``GaussianSketch(split(key)[1], N, S)``).

Tolerances: C ≤ 1e-5 and U ≤ 1e-4 scale-normalized (two SVD
implementations), the heads ≤ 1e-4 scale-normalized (the KPCA columns up
to sign; the feature head through its Gram, which eigenvector rotations
leave alone); served answers ≤ 1e-5 (``parity_gap``) of the port's dense
oracles and, on the reference's own artifact carried across
(``convert.artifact_from_reference``), of the reference's answers.  Every
behaviour ``tests/test_serve.py`` asserts has a port case here, and the
meters equal the reference's.
"""
from __future__ import annotations

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.core import sketch as jsk
from repro.core.instrument import CountingOperator as JCounting
from repro.kernels.pairwise import specs as jspecs
from repro_torch import convert
from repro_torch.core.instrument import CountingOperator
from repro_torch.kernels.pairwise import specs as pw_specs
from repro_torch.launch import serve_kernel as tsk
from repro_torch.launch.serve_kernel import (
    BatchPolicy,
    KernelServer,
    build_from_params,
    load_trace,
    replay_trace,
    synth_problem,
    write_trace,
)
from repro_torch.serve import (
    QueryRequest,
    answer_batch,
    build_artifact,
    dense_krr_oracle,
    dense_oracle,
    load_artifact,
    load_or_rebuild,
    parity_gap,
    plan_buckets,
    save_artifact,
    serve_kernel_model,
)

N, D, C, S = 240, 24, 48, 96
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


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = rng.standard_normal((N,)).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def ref_artifact(problem):
    X, y = problem
    spec = jspecs.get_spec("rbf", sigma=1.0)
    return jserve.build_artifact(jnp.asarray(X), jnp.asarray(y), spec, c=C,
                                 s=S, alpha=1.0, n_components=8, key=KEY,
                                 use_pallas=True)


@pytest.fixture(scope="module")
def artifact(problem, ref_artifact):
    X, y = problem
    Smat = np.array(jsk.GaussianSketch(jax.random.split(KEY)[1], N, S)._mat())
    return build_artifact(X, y, pw_specs.get_spec("rbf", sigma=1.0), c=C,
                          s=S, alpha=1.0, n_components=8,
                          idx=np.array(ref_artifact.landmark_indices),
                          S=Smat, device=CPU)


@pytest.fixture(scope="module")
def queries():
    rng = np.random.default_rng(7)
    return rng.standard_normal((37, D)).astype(np.float32)


def scaled(port, ref) -> float:
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def signed_like(port: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """``port``'s columns flipped to the signs of ``ref``'s."""
    s = np.sign(np.sum(port * ref, axis=0))
    return port * np.where(s == 0, 1.0, s)[None, :]


def np64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(t, np.float64)


# ---------------------------------------------------------------------------
# the build against the reference's
# ---------------------------------------------------------------------------

def test_build_matches_reference(artifact, ref_artifact):
    a, r = artifact, ref_artifact
    assert np.array_equal(a.X_landmarks.numpy(), np.asarray(r.X_landmarks))
    assert np.array_equal(a.landmark_indices.numpy(),
                          np.asarray(r.landmark_indices))
    assert scaled(a.C, r.C) <= 1e-5
    assert scaled(a.U, r.U) <= 1e-4
    assert scaled(a.woodbury_M, r.woodbury_M) <= 1e-4
    assert scaled(a.heads["krr"], r.heads["krr"]) <= 1e-4
    assert scaled(a.kpca_eigvals, r.kpca_eigvals) <= 1e-5
    kp = np64(a.heads["kpca"])
    assert scaled(signed_like(kp, np64(r.heads["kpca"])),
                  r.heads["kpca"]) <= 1e-4
    fa, fr = np64(a.heads["features"]), np64(r.heads["features"])
    assert fa.shape == fr.shape
    assert scaled(fa @ fa.T, fr @ fr.T) <= 1e-4
    assert a.spec.name == r.spec.name and a.alpha == r.alpha
    assert a.selection == r.selection and a.l1_route is None


def test_reference_artifact_served_by_the_port_matches_its_answers(
        ref_artifact, queries):
    """The reference's artifact carried across: the port's cross launch
    answers every task within 1e-5 of the reference's serving path."""
    tree = jax.tree.map(np.asarray, jserve.artifact_to_tree(ref_artifact))
    art = convert.artifact_from_reference(tree, device=CPU)
    reqs = [(queries, t) for t in ("krr", "kpca", "features")]
    got = serve_kernel_model(art, [QueryRequest(q, t) for q, t in reqs])
    want = jserve.serve_kernel_model(
        ref_artifact, [jserve.QueryRequest(jnp.asarray(q), t)
                       for q, t in reqs])
    for g, w in zip(got, want):
        assert g.task == w.task
        assert parity_gap(g.out, np.asarray(w.out)) <= 1e-5, g.task


def test_port_answers_match_reference_answers(artifact, ref_artifact,
                                              queries):
    """Each side's own build and serving path: KRR within 1e-5, KPCA up to
    column sign, features through their Gram."""
    reqs = [(queries, t) for t in ("krr", "kpca", "features")]
    got = serve_kernel_model(artifact, [QueryRequest(q, t) for q, t in reqs])
    want = jserve.serve_kernel_model(
        ref_artifact, [jserve.QueryRequest(jnp.asarray(q), t)
                       for q, t in reqs])
    assert parity_gap(got[0].out, np.asarray(want[0].out)) <= 1e-5
    kp, kr = np64(got[1].out), np64(want[1].out)
    assert parity_gap(signed_like(kp, kr), kr) <= 1e-5
    fp, fr = np64(got[2].out), np64(want[2].out)
    assert parity_gap(fp @ fp.T, fr @ fr.T) <= 1e-5


def test_meters_equal_the_reference(artifact, ref_artifact):
    """The same requests through both serving paths: cross sweeps, entries
    and route (``pallas_`` dropped) equal."""
    rng = np.random.default_rng(3)
    sizes = [100, 90, 20, 5, 64]
    qs = [(rng.standard_normal((nq, D)).astype(np.float32), t)
          for nq, t in zip(sizes, ("krr", "kpca", "features", "krr",
                                    "kpca"))]
    op = CountingOperator(artifact.landmark_operator())
    jop = JCounting(ref_artifact.landmark_operator())
    serve_kernel_model(artifact, [QueryRequest(q, t) for q, t in qs], op=op)
    jserve.serve_kernel_model(
        ref_artifact, [jserve.QueryRequest(jnp.asarray(q), t)
                       for q, t in qs], op=jop)
    assert op.counts == jop.counts
    assert op.counts["cross_sweeps"] == 4       # [100, 90] [64] [20] [5]
    assert op.last_route == jop.last_route.replace("pallas_", "")


# ---------------------------------------------------------------------------
# parity vs the dense oracles (test_serve.py's cases)
# ---------------------------------------------------------------------------

def test_krr_parity_vs_dense_solve_oracle(artifact, problem, queries):
    _, y = problem
    res = serve_kernel_model(artifact, [QueryRequest(queries, "krr")])
    expected = dense_krr_oracle(artifact, queries, y)
    assert parity_gap(res[0].out, expected) <= 1e-5


def test_kpca_and_feature_parity_vs_dense_route(artifact, queries):
    res = serve_kernel_model(artifact, [QueryRequest(queries, "kpca"),
                                        QueryRequest(queries, "features")])
    assert parity_gap(res[0].out, dense_oracle(artifact, queries,
                                               "kpca")) <= 1e-5
    assert parity_gap(res[1].out, dense_oracle(artifact, queries,
                                               "features")) <= 1e-5


def test_feature_map_gram_matches_fast_model(artifact, queries):
    res = serve_kernel_model(artifact, [QueryRequest(queries, "features")])
    phi = np64(res[0].out)
    G = np64(pw_specs.apply(artifact.spec, torch.from_numpy(queries),
                            artifact.X_landmarks))
    khat = G @ np64(artifact.U) @ G.T
    assert np.max(np.abs(phi @ phi.T - khat)) <= 1e-4


def test_train_points_round_trip(artifact, problem):
    X, _ = problem
    res = serve_kernel_model(artifact, [QueryRequest(X[:50], "krr")])
    fitted = artifact.C[:50] @ artifact.heads["krr"]
    assert parity_gap(res[0].out, fitted) <= 1e-5


def test_krr_head_and_oracle_solve_once(artifact, problem, queries):
    """``dense_krr_oracle(head=)`` reuses one solve: the same numbers as the
    solve per call, and one of y / head is required."""
    _, y = problem
    head = tsk.dense_krr_head(artifact, y)
    assert tuple(head.shape) == (C, 1) and head.dtype == torch.float64
    assert torch.equal(dense_krr_oracle(artifact, queries, head=head),
                       dense_krr_oracle(artifact, queries, y))
    with pytest.raises(ValueError, match="one of y and head"):
        dense_krr_oracle(artifact, queries)


# ---------------------------------------------------------------------------
# bucketed batching: one launch per bucket
# ---------------------------------------------------------------------------

def test_one_cross_sweep_per_bucket(artifact):
    rng = np.random.default_rng(3)
    sizes = [100, 90, 20]
    reqs = [QueryRequest(rng.standard_normal((nq, D)).astype(np.float32),
                         task)
            for nq, task in zip(sizes, ("krr", "kpca", "features"))]
    buckets = plan_buckets(reqs, waste=0.25)
    assert len(buckets) == 2
    op = CountingOperator(artifact.landmark_operator())
    results = serve_kernel_model(artifact, reqs, waste=0.25, op=op)
    assert op.counts["cross_sweeps"] == len(buckets)
    assert op.last_route == "fused_rows"
    for r, req in zip(results, reqs):
        assert r.task == req.task
        assert r.out.shape[0] == req.n_q


def test_heterogeneous_batch_matches_per_request_answers(artifact):
    rng = np.random.default_rng(4)
    reqs = [QueryRequest(rng.standard_normal((nq, D)).astype(np.float32),
                         task)
            for nq, task in [(5, "krr"), (33, "kpca"), (5, "features"),
                             (17, "krr")]]
    batched = serve_kernel_model(artifact, reqs)
    for req, got in zip(reqs, batched):
        solo = answer_batch(artifact, [req])[0]
        assert parity_gap(got.out, solo.out) <= 1e-6


def test_padding_rows_never_leak(artifact):
    rng = np.random.default_rng(5)
    small = QueryRequest(rng.standard_normal((1, D)).astype(np.float32))
    big = QueryRequest(rng.standard_normal((4, D)).astype(np.float32))
    out = answer_batch(artifact, [big, small])
    assert out[1].out.shape[0] == 1
    assert parity_gap(out[1].out,
                      answer_batch(artifact, [small])[0].out) <= 1e-6


def test_unknown_task_rejected():
    with pytest.raises(ValueError, match="unknown task"):
        QueryRequest(np.zeros((3, D), np.float32), task="cluster")


# ---------------------------------------------------------------------------
# refit through the cached Woodbury workspace
# ---------------------------------------------------------------------------

def test_refit_matches_fresh_build(artifact, queries):
    rng = np.random.default_rng(11)
    y_new = rng.standard_normal((N,)).astype(np.float32)
    refitted = artifact.refit(y_new)
    served = serve_kernel_model(refitted, [QueryRequest(queries, "krr")])
    expected = dense_krr_oracle(artifact, queries, y_new)
    assert parity_gap(served[0].out, expected) <= 1e-4   # f32 workspace


# ---------------------------------------------------------------------------
# persistence: checkpoint round trip, recompute on corruption, and the
# reference's store
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_bitwise_predictions(artifact, queries,
                                                  tmp_path):
    save_artifact(str(tmp_path), artifact, step=0)
    restored = load_artifact(str(tmp_path), device=CPU)
    assert restored is not None
    assert restored.spec is artifact.spec and restored.alpha == artifact.alpha
    for f in ("X_landmarks", "C", "U", "woodbury_M", "kpca_eigvals",
              "landmark_indices"):
        assert torch.equal(getattr(restored, f), getattr(artifact, f)), f
    a = serve_kernel_model(artifact, [QueryRequest(queries, "krr")])
    b = serve_kernel_model(restored, [QueryRequest(queries, "krr")])
    assert torch.equal(a[0].out, b[0].out)


def test_load_or_rebuild_warm_then_corrupt_then_rebuilt(artifact, queries,
                                                        tmp_path):
    d = str(tmp_path)
    save_artifact(d, artifact, step=0)
    builds = []

    def build_fn():
        builds.append(1)
        return artifact

    got, rec = load_or_rebuild(d, build_fn, device=CPU)
    assert rec.warm and not builds
    assert [e.kind for e in rec.events] == ["restored"]

    (tmp_path / "step_000000000" / "manifest.json").write_text('{"leaf')
    got, rec = load_or_rebuild(d, build_fn, device=CPU)
    assert [e.kind for e in rec.events] == ["corrupt", "rebuilt"]
    assert len(builds) == 1
    a = serve_kernel_model(got, [QueryRequest(queries, "kpca")])
    assert parity_gap(a[0].out, dense_oracle(got, queries, "kpca")) <= 1e-5

    got, rec = load_or_rebuild(d, build_fn, device=CPU)
    assert rec.warm and len(builds) == 1


def test_load_or_rebuild_missing_store_builds_fresh(artifact, tmp_path):
    builds = []

    def build_fn():
        builds.append(1)
        return artifact

    got, rec = load_or_rebuild(str(tmp_path / "nowhere"), build_fn,
                               device=CPU)
    assert [e.kind for e in rec.events] == ["missing", "rebuilt"]
    assert len(builds) == 1 and got is artifact


def test_reference_store_warm_boots_in_the_port(ref_artifact, queries,
                                                tmp_path):
    """A store the reference committed: the port boots it warm (every array
    bit for bit) and answers within 1e-5 of the reference."""
    d = str(tmp_path)
    jserve.save_artifact(d, ref_artifact, step=0)
    art, rec = load_or_rebuild(
        d, lambda: pytest.fail("rebuild on a warm store"), device=CPU)
    assert rec.warm
    assert convert.artifact_from_reference(d, device=CPU).spec is art.spec
    for f in ("X_landmarks", "C", "U", "woodbury_M", "kpca_eigvals"):
        assert np.array_equal(getattr(art, f).numpy(),
                              np.asarray(getattr(ref_artifact, f))), f
    for t in ("krr", "kpca", "features"):
        got = serve_kernel_model(art, [QueryRequest(queries, t)])[0].out
        want = jserve.serve_kernel_model(
            ref_artifact, [jserve.QueryRequest(jnp.asarray(queries), t)])
        assert parity_gap(got, np.asarray(want[0].out)) <= 1e-5, t


def test_port_store_decodes_in_the_reference(artifact, tmp_path):
    d = str(tmp_path)
    save_artifact(d, artifact, step=0)
    ref = jserve.load_artifact(d)
    assert ref.spec.name == artifact.spec.name
    assert ref.use_pallas == artifact.use_kernel
    for t in ("krr", "kpca", "features"):
        assert np.array_equal(np.asarray(ref.heads[t]),
                              artifact.heads[t].numpy()), t


# ---------------------------------------------------------------------------
# continuous batching and the canned trace
# ---------------------------------------------------------------------------

def test_kernel_server_batches_concurrent_clients(artifact):
    op = CountingOperator(artifact.landmark_operator())
    server = KernelServer(
        artifact, BatchPolicy(max_batch=16, max_wait_s=0.05), op=op)
    rng = np.random.default_rng(13)
    queries = [(rng.standard_normal((nq, D)).astype(np.float32), task)
               for nq, task in [(5, "krr"), (17, "kpca"), (5, "features"),
                                (33, "krr"), (17, "krr"), (5, "kpca")]]
    try:
        results = [None] * len(queries)

        def client(i):
            Xq, task = queries[i]
            results[i] = server.submit(Xq, task).wait(timeout=60.0)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.stop()

    assert server.requests_served == len(queries)
    assert op.counts["cross_sweeps"] == server.buckets_served > 0
    assert len(server.latencies_s) == len(queries)
    assert all(lat > 0 for lat in server.latencies_s)
    for (Xq, task), res in zip(queries, results):
        assert res.task == task
        direct = answer_batch(artifact, [QueryRequest(Xq, task)])[0]
        assert parity_gap(res.out, direct.out) <= 1e-6


def test_kernel_server_submit_after_stop_raises(artifact):
    server = KernelServer(artifact)
    server.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        server.submit(np.zeros((2, D), np.float32))


def test_trace_write_replay_roundtrip(tmp_path):
    params = {"n": 160, "d": 12, "c": 32, "s": 64, "alpha": 1.0,
              "n_components": 6, "kernel": "rbf",
              "spec_params": {"sigma": 1.0}, "seed": 3, "use_pallas": True}
    art = build_from_params(params, device=CPU)
    write_trace(str(tmp_path), art, params, n_queries=6, seed=3)
    trace = load_trace(str(tmp_path))
    assert len(trace) == 6

    op = CountingOperator(art.landmark_operator())
    server = KernelServer(art, BatchPolicy(max_wait_s=0.02), op=op)
    try:
        gap, lats = replay_trace(server, trace)
    finally:
        server.stop()
    assert gap <= 1e-5
    assert len(lats) == 6
    assert op.counts["cross_sweeps"] == server.buckets_served


def test_build_from_params_deterministic():
    params = {"n": 120, "d": 8, "c": 24, "s": 48, "alpha": 1.0,
              "n_components": 4, "kernel": "rbf",
              "spec_params": {"sigma": 1.0}, "seed": 5, "use_pallas": True}
    a = build_from_params(params, device=CPU)
    b = build_from_params(params, device=CPU)
    assert torch.equal(a.heads["krr"], b.heads["krr"])
    X, _ = synth_problem(params["n"], params["d"], params["seed"])
    assert np.array_equal(a.X_landmarks.numpy(),
                          X[a.landmark_indices.numpy()])


def test_synth_problem_is_the_reference_problem():
    from repro.launch import serve_kernel as jsk_launch
    X, y = synth_problem(50, 6, 4)
    Xj, yj = jsk_launch.synth_problem(50, 6, 4)
    assert np.array_equal(X, np.asarray(Xj)) and \
        np.array_equal(y, np.asarray(yj))
    params = {"n": 50, "d": 6, "seed": 4}
    for (a, b), (c, d) in zip(tsk.synth_batches(params, 2, 8),
                              jsk_launch.synth_batches(params, 2, 8)):
        assert np.array_equal(a, c) and np.array_equal(b, d)


def test_cli_build_then_serve_warm_with_appends(tmp_path, capsys):
    """The two CLI legs on the CPU: build, then a warm serve with the
    append leg, which prints ``serve ok``."""
    d = str(tmp_path / "store")
    common = ["--dir", d, "--device", "cpu"]
    assert tsk.main(["--build", *common, "--queries", "6"]) == 0
    assert tsk.main(["--serve", *common, "--require-warm",
                     "--append-batches", "2", "--append-rows", "8"]) == 0
    out = capsys.readouterr().out
    assert "boot: warm" in out and "serve ok" in out
    assert '"append_sweeps": 2' in out


# ---------------------------------------------------------------------------
# mixed-precision serving and the l1 plan
# ---------------------------------------------------------------------------

def test_serve_bf16_cross_launches_within_budget(artifact, queries):
    reqs = [QueryRequest(queries, t) for t in ("krr", "kpca", "features")]
    f32 = serve_kernel_model(artifact, reqs)
    bf16 = serve_kernel_model(artifact, reqs, precision="bf16_f32acc")
    for a, b in zip(bf16, f32):
        assert parity_gap(a.out, b.out) <= 5e-2


def test_serve_bf16_route_and_metering(artifact, queries):
    op = CountingOperator(
        artifact.landmark_operator(precision="bf16_f32acc"))
    serve_kernel_model(artifact, [QueryRequest(queries, "krr")], op=op)
    assert op.counts["cross_sweeps"] == 1
    assert op.last_route == "fused_rows+bf16_f32acc"
    assert op.last_precision == "bf16_f32acc"


def test_artifact_spec_precision_round_trips_through_checkpoint(
        artifact, tmp_path):
    bf_art = dataclasses.replace(
        artifact, spec=artifact.spec.with_precision("bf16_f32acc"))
    save_artifact(str(tmp_path / "ckpt"), bf_art)
    loaded = load_artifact(str(tmp_path / "ckpt"), device=CPU)
    assert loaded.spec is bf_art.spec
    assert loaded.landmark_operator().precision == "bf16_f32acc"


def test_l1_signsplit_plan_cached_on_artifact_and_warm_boot(tmp_path):
    rng = np.random.default_rng(11)
    X = rng.integers(0, 5, size=(120, 6)).astype(np.float32)
    y = rng.standard_normal(120).astype(np.float32)
    spec = pw_specs.get_spec("laplacian", gamma=0.3)
    art = build_artifact(X, y, spec, c=24, s=48, alpha=1.0, n_components=4,
                         generator=torch.Generator().manual_seed(3),
                         device=CPU)
    assert art.l1_route == "mxu_signsplit"
    assert art.l1_edges is not None
    op_a, op_b = art.landmark_operator(), art.landmark_operator()
    assert op_a.l1_edges() is art.l1_edges
    assert op_b.l1_edges() is art.l1_edges

    save_artifact(str(tmp_path), art, step=0)

    def build_fn():
        raise AssertionError("rebuild called on a warm store")

    loaded, rec = load_or_rebuild(str(tmp_path), build_fn, device=CPU)
    assert rec.warm
    assert loaded.l1_route == "mxu_signsplit"
    assert torch.equal(loaded.l1_edges, art.l1_edges)
    assert loaded.landmark_operator().l1_edges() is loaded.l1_edges

    q = rng.integers(0, 5, size=(17, 6)).astype(np.float32)
    a = serve_kernel_model(loaded, [QueryRequest(q, "krr")])
    assert parity_gap(a[0].out, dense_oracle(loaded, q, "krr")) <= 1e-4


def test_rbf_artifact_has_no_l1_plan():
    rng = np.random.default_rng(12)
    X = rng.standard_normal((90, 5)).astype(np.float32)
    y = rng.standard_normal(90).astype(np.float32)
    art = build_artifact(X, y, pw_specs.get_spec("rbf", sigma=1.0),
                         c=18, s=36, alpha=1.0, n_components=4,
                         generator=torch.Generator().manual_seed(4),
                         device=CPU)
    assert art.l1_route is None and art.l1_edges is None


def test_trace_queries_are_the_reference_trace(tmp_path, artifact):
    """The port's trace draws the reference's sizes, tasks and points."""
    from repro.launch import serve_kernel as jsk_launch
    params = {"n": N, "d": D, "seed": 0}
    write_trace(str(tmp_path), artifact, params, n_queries=7, seed=0)
    ours = load_trace(str(tmp_path))
    jdir = tmp_path / "ref"
    jdir.mkdir()
    jsk_launch.write_trace(str(jdir), jserve.build_artifact(
        jnp.asarray(synth_problem(N, D, 0)[0]), jnp.asarray(
            synth_problem(N, D, 0)[1]), jspecs.get_spec("rbf", sigma=1.0),
        c=C, s=S, key=KEY), params, n_queries=7, seed=0)
    theirs = jsk_launch.load_trace(str(jdir))
    for (qa, ta, _), (qb, tb, _) in zip(ours, theirs):
        assert ta == tb and np.array_equal(qa, qb)
