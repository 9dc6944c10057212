"""Continuous-batching kernel-inference server over a KernelModelArtifact
(port of ``repro.launch.serve_kernel``).

Replicas build the factor store once (``--build``); any number of serving
processes then warm-boot from the checkpoint (``--serve``) and answer KRR /
KPCA / feature-map queries with one rectangular cross launch per size
bucket (on the card, one launch of the fused pairwise kernel).

    # build and persist the artifact and a canned query trace
    PYTHONPATH=src python -m repro_torch.launch.serve_kernel --build \\
        --dir /tmp/serve_ckpt --n 240 --c 48 --s 96 --queries 12

    # fresh process: warm boot, replay the trace, check parity and launches
    PYTHONPATH=src python -m repro_torch.launch.serve_kernel --serve \\
        --dir /tmp/serve_ckpt --require-warm --parity-tol 1e-5

Both run on the CUDA device unless ``--device cpu`` is given.

``KernelServer`` runs the batching loop: callers ``submit`` requests from
any thread; a worker thread collects until ``max_batch`` requests are
queued or the oldest has waited ``max_wait_s``, then flushes —
``plan_buckets`` groups the batch by query count and each bucket is one
``op.cross`` launch.  The worker waits for the device before it stamps a
request's latency, so a latency covers the launch and its result.

Corpus growth rides the same loop: ``submit_append`` enqueues a training
batch beside the queries; the worker absorbs it in arrival order through
an ``IncrementalMaintainer`` (one thin launch and a delta checkpoint per
batch) and answers every later query from the refreshed artifact.  The
``--append-batches`` leg of ``--serve`` checks that each absorb was one
``append_sweeps`` launch and nothing else, and ≤ 1e-5 parity against a
dense f64 oracle on the grown corpus.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.core.instrument import CountingOperator
from repro_torch.device import resolve_device
from repro_torch.kernels.pairwise import specs as pw_specs
from repro_torch.serve import (
    GenerationStats,
    IncrementalMaintainer,
    KernelModelArtifact,
    QueryRequest,
    StalenessPolicy,
    answer_batch,
    build_artifact,
    dense_krr_head,
    dense_krr_oracle,
    dense_oracle,
    is_delta_step,
    load_artifact,
    load_or_rebuild,
    parity_gap,
    plan_buckets,
    save_artifact,
)

TRACE_FILE = "trace.npz"
BUILD_FILE = "build.json"


def _wait_for_device(tensors: Sequence[torch.Tensor]) -> None:
    """Block until the device has computed ``tensors``."""
    for dev in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# batching policy + server
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """The collector flushes at ``max_batch`` queued requests, or when the
    oldest has waited ``max_wait_s`` (a lone request waits at most that
    plus one launch).  ``waste`` is ``plan_buckets``' padding bound."""

    max_batch: int = 32
    max_wait_s: float = 0.01
    waste: float = 0.25


class _Pending:
    """Completion handle: ``wait()`` blocks until the loop fills ``result``
    (or re-raises the flush's error)."""

    __slots__ = ("t_enqueue", "result", "latency_s", "error", "_done")

    def __init__(self):
        self.t_enqueue = time.perf_counter()
        self.result = None
        self.latency_s: Optional[float] = None
        self.error: Optional[BaseException] = None
        self._done = threading.Event()

    def wait(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("request not answered within timeout")
        if self.error is not None:
            raise self.error
        return self.result


class PendingQuery(_Pending):
    """``KernelServer.submit``'s handle; ``wait()`` returns the
    ``QueryResult``."""

    __slots__ = ("request",)

    def __init__(self, request: QueryRequest):
        super().__init__()
        self.request = request


class PendingAppend(_Pending):
    """``KernelServer.submit_append``'s handle; ``wait()`` returns the
    batch's ``GenerationStats``.  Appends are absorbed in arrival order
    among themselves and the queries of a flush, so a query submitted after
    an append is answered by the refreshed artifact."""

    __slots__ = ("X_new", "y_new")

    def __init__(self, X_new, y_new):
        super().__init__()
        self.X_new = np.asarray(X_new, np.float32)
        self.y_new = np.asarray(y_new, np.float32)


class KernelServer:
    """Threaded continuous-batching loop over ``answer_batch``.

    One worker thread owns the launch path; ``submit`` is safe from any
    number of client threads.  ``buckets_served``, ``requests_served`` and
    the per-request ``latencies_s`` are what the checks read.
    """

    def __init__(self, artifact: KernelModelArtifact,
                 policy: BatchPolicy = BatchPolicy(), op=None,
                 maintainer: Optional[IncrementalMaintainer] = None):
        self.artifact = artifact
        self.policy = policy
        self.op = artifact.landmark_operator() if op is None else op
        self.maintainer = maintainer
        self._cv = threading.Condition()
        self._queue: List[_Pending] = []
        self._stopping = False
        self.buckets_served = 0
        self.batches_served = 0
        self.requests_served = 0
        self.appends_served = 0
        self.latencies_s: List[float] = []
        self.append_latencies_s: List[float] = []
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # -- client side --------------------------------------------------------

    def submit(self, X, task: str = "krr") -> PendingQuery:
        req = X if isinstance(X, QueryRequest) else QueryRequest(X, task)
        return self._enqueue(PendingQuery(req))

    def submit_append(self, X_new, y_new) -> PendingAppend:
        """Enqueue a training batch for absorption (needs a
        ``maintainer``); ``wait()`` returns its ``GenerationStats``."""
        if self.maintainer is None:
            raise RuntimeError(
                "KernelServer has no IncrementalMaintainer; construct with "
                "maintainer= to accept appends")
        return self._enqueue(PendingAppend(X_new, y_new))

    def _enqueue(self, pending):
        with self._cv:
            if self._stopping:
                raise RuntimeError("server is stopped")
            self._queue.append(pending)
            self._cv.notify_all()
        return pending

    def stop(self):
        """Drain the queue, then join the worker (idempotent)."""
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        self._worker.join()

    # -- worker side --------------------------------------------------------

    def _take_batch(self) -> List[_Pending]:
        """Block until a flush is due; return the batch (empty = shut
        down)."""
        with self._cv:
            while not self._queue and not self._stopping:
                self._cv.wait()
            if not self._queue:
                return []                                 # stopping + drained
            deadline = self._queue[0].t_enqueue + self.policy.max_wait_s
            while (len(self._queue) < self.policy.max_batch
                   and not self._stopping):
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            batch = self._queue[: self.policy.max_batch]
            del self._queue[: len(batch)]
            return batch

    def _loop(self):
        while True:
            batch = self._take_batch()
            if not batch:
                return
            try:
                self._flush(batch)
            except BaseException as e:                    # to the waiters
                for p in batch:
                    if not p._done.is_set():
                        p.error = e
                        p._done.set()

    def _flush(self, batch: List[_Pending]):
        """One collected batch in arrival order: maximal runs of queries are
        bucketed and launched together; each append between them is
        absorbed before the next run."""
        i = 0
        while i < len(batch):
            if isinstance(batch[i], PendingAppend):
                self._absorb(batch[i])
                i += 1
                continue
            j = i
            while j < len(batch) and not isinstance(batch[j], PendingAppend):
                j += 1
            self._answer(batch[i:j])
            i = j
        self.batches_served += 1

    def _answer(self, run: List[PendingQuery]):
        requests = [p.request for p in run]
        results = [None] * len(run)
        for bucket in plan_buckets(requests, waste=self.policy.waste):
            answers = answer_batch(
                self.artifact, [requests[i] for i in bucket], op=self.op,
                bucket=self.buckets_served)
            _wait_for_device([a.out for a in answers])
            self.buckets_served += 1
            for i, res in zip(bucket, answers):
                results[i] = res
        now = time.perf_counter()
        for p, res in zip(run, results):
            p.result = res
            p.latency_s = now - p.t_enqueue
            self.latencies_s.append(p.latency_s)
            self.requests_served += 1
            p._done.set()

    def _absorb(self, p: PendingAppend):
        old = self.artifact
        stats: GenerationStats = self.maintainer.append(p.X_new, p.y_new)
        art = self.maintainer.artifact
        if art is not old:
            # a re-sketch replaces the landmarks; the query operator follows
            # (rebind keeps the meters running across the swap)
            if art.X_landmarks is not old.X_landmarks and \
                    hasattr(self.op, "rebind"):
                self.op.rebind(art.landmark_operator())
            self.artifact = art
        _wait_for_device([art.C])
        p.result = stats
        p.latency_s = time.perf_counter() - p.t_enqueue
        self.append_latencies_s.append(p.latency_s)
        self.appends_served += 1
        p._done.set()


def percentile_ms(latencies_s: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(latencies_s, np.float64), q) * 1e3)


# ---------------------------------------------------------------------------
# canned trace: build-time oracle answers, replayed by serving processes
# ---------------------------------------------------------------------------

def synth_problem(n: int, d: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic synthetic regression problem (X ~ N(0, I_d),
    y = tanh(X w) + 0.1·noise, f32 numpy; the reference's draws), shared by
    --build and the --serve rebuild hook."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((d,)).astype(np.float32)
    y = np.tanh(X @ w) + 0.1 * rng.standard_normal(n).astype(np.float32)
    return X, y.astype(np.float32)


def synth_batches(params: dict, batches: int, rows: int
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Append batches from the same generative process as
    ``synth_problem`` (the same seed stream, continued)."""
    n, d, seed = params["n"], params["d"], params["seed"]
    rng = np.random.default_rng(seed)
    rng.standard_normal((n, d))                      # replay the base X draw
    w = rng.standard_normal((d,)).astype(np.float32)
    rng.standard_normal(n)                           # ... and the base noise
    out = []
    for _ in range(batches):
        Xb = rng.standard_normal((rows, d)).astype(np.float32)
        yb = np.tanh(Xb @ w) + 0.1 * rng.standard_normal(rows).astype(
            np.float32)
        out.append((Xb, yb))
    return out


def build_from_params(params: dict, device=None) -> KernelModelArtifact:
    """The artifact of a ``build.json`` parameter set; its draws come from
    a CPU ``torch.Generator`` seeded with ``params["seed"]``, so a rebuild
    gives the same artifact."""
    X, y = synth_problem(params["n"], params["d"], params["seed"])
    spec = pw_specs.get_spec(params["kernel"], **params["spec_params"])
    return build_artifact(
        X, y, spec, c=params["c"], s=params["s"], alpha=params["alpha"],
        n_components=params["n_components"],
        generator=torch.Generator(device="cpu").manual_seed(params["seed"]),
        use_kernel=params["use_pallas"], device=device)


def trace_queries(n_queries: int, d: int, seed: int
                  ) -> List[Tuple[np.ndarray, str]]:
    """The canned trace's requests: sizes drawn from {5, 17, 33, 64}, tasks
    cycled krr, kpca, features, points ~ N(0, I_d) (the reference's
    draws)."""
    rng = np.random.default_rng(seed + 1)
    sizes = [int(rng.choice([5, 17, 33, 64])) for _ in range(n_queries)]
    tasks = [("krr", "kpca", "features")[i % 3] for i in range(n_queries)]
    return [(rng.standard_normal((nq, d)).astype(np.float32), task)
            for nq, task in zip(sizes, tasks)]


def write_trace(directory: str, artifact: KernelModelArtifact, params: dict,
                n_queries: int, seed: int) -> str:
    """Canned heterogeneous query trace with the oracles' answers.

    KRR answers come from ``dense_krr_oracle`` (an independent dense f64
    solve, done once for the trace), KPCA and feature answers from
    ``dense_oracle``.  A serving process that matches this file to ≤ 1e-5
    has checked the Woodbury identity, the head algebra, the cross launch
    and persistence at once.
    """
    queries = trace_queries(n_queries, params["d"], seed)
    _, y = synth_problem(params["n"], params["d"], params["seed"])
    payload = {"tasks": np.array([t for _, t in queries]),
               "sizes": np.array([len(q) for q, _ in queries])}
    head = dense_krr_head(artifact, y) \
        if any(t == "krr" for _, t in queries) else None
    for i, (Xq, task) in enumerate(queries):
        if task == "krr":
            expected = dense_krr_oracle(artifact, Xq, head=head)
        else:
            expected = dense_oracle(artifact, Xq, task)
        payload[f"q{i}"] = Xq
        payload[f"e{i}"] = expected.to("cpu", torch.float32).numpy()
    path = os.path.join(directory, TRACE_FILE)
    np.savez(path, **payload)
    return path


def load_trace(directory: str) -> List[Tuple[np.ndarray, str, np.ndarray]]:
    with np.load(os.path.join(directory, TRACE_FILE)) as z:
        tasks = [str(t) for t in z["tasks"]]
        return [(z[f"q{i}"], task, z[f"e{i}"])
                for i, task in enumerate(tasks)]


def replay_trace(server: KernelServer,
                 trace: Sequence[Tuple[np.ndarray, str, np.ndarray]]
                 ) -> Tuple[float, List[float]]:
    """Submit the whole trace (as concurrent clients would), wait for every
    answer; returns (worst parity gap, per-request latencies)."""
    pending = [server.submit(Xq, task) for Xq, task, _ in trace]
    gaps, lats = [], []
    for p, (_, _, expected) in zip(pending, trace):
        res = p.wait(timeout=60.0)
        gaps.append(parity_gap(res.out, expected))
        lats.append(p.latency_s)
    return max(gaps), lats


def _peak_gb(device: torch.device) -> str:
    if device.type != "cuda":
        return "not measured (CPU)"
    return f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB"


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _build(args) -> int:
    device = resolve_device(args.device)
    params = {
        "n": args.n, "d": args.d, "c": args.c, "s": args.s,
        "alpha": args.alpha, "n_components": args.n_components,
        "kernel": args.kernel, "spec_params": {"sigma": args.sigma},
        "seed": args.seed, "use_pallas": not args.no_pallas,
    }
    os.makedirs(args.dir, exist_ok=True)
    t0 = time.perf_counter()
    artifact = build_from_params(params, device)
    _wait_for_device([artifact.C])
    build_ms = (time.perf_counter() - t0) * 1e3
    path = save_artifact(args.dir, artifact, step=0)
    with open(os.path.join(args.dir, BUILD_FILE), "w") as f:
        json.dump(params, f, indent=1)
    t0 = time.perf_counter()
    trace_path = write_trace(args.dir, artifact, params,
                             n_queries=args.queries, seed=args.seed)
    trace_ms = (time.perf_counter() - t0) * 1e3
    print(f"artifact (n={args.n}, c={artifact.c}) built in {build_ms:.1f} ms "
          f"on {device}, committed at {path}")
    print(f"trace with {args.queries} queries at {trace_path} "
          f"({trace_ms:.1f} ms with the oracles)")
    print(f"peak device memory {_peak_gb(device)}")
    return 0


def _serve(args) -> int:
    device = resolve_device(args.device)
    with open(os.path.join(args.dir, BUILD_FILE)) as f:
        params = json.load(f)

    artifact, recovery = load_or_rebuild(
        args.dir, lambda: build_from_params(params, device), device=device)
    boot = "warm" if recovery.warm else "cold"
    print(f"boot: {boot} "
          f"(events: {[e.kind for e in recovery.events]})")
    if args.require_warm and not recovery.warm:
        print("FAIL: --require-warm but boot was cold")
        return 1

    if args.append_batches > 0 and int(artifact.C.shape[0]) != params["n"]:
        # a previous append run left a delta chain, and the warm boot
        # restored its grown tip; the trace and the synthetic base describe
        # the base corpus, so restart from the latest full snapshot and drop
        # the earlier run's deltas (reruns are idempotent)
        steps = ckpt.committed_steps(args.dir)
        fulls = [s for s in steps if not is_delta_step(args.dir, s)]
        if fulls:
            artifact = load_artifact(args.dir, step=max(fulls),
                                     device=device)
            for s in steps:
                if s > max(fulls):
                    ckpt.remove_step(args.dir, s)
            print(f"append leg: rebased on full step {max(fulls)} "
                  f"(dropped {len(steps) - len(fulls)} prior delta step(s))")

    op = CountingOperator(artifact.landmark_operator())
    policy = BatchPolicy(max_batch=args.max_batch,
                         max_wait_s=args.max_wait_ms / 1e3)
    maintainer = None
    if args.append_batches > 0:
        X_base, y_base = synth_problem(params["n"], params["d"],
                                       params["seed"])
        maintainer = IncrementalMaintainer(
            artifact, y_base, directory=args.dir, X=X_base,
            staleness=StalenessPolicy(
                drift_threshold=args.drift_threshold,
                error_budget=float("inf"), max_generations=0),
            op=op)
    server = KernelServer(artifact, policy, op=op, maintainer=maintainer)
    trace = load_trace(args.dir)
    try:
        gap_warmup, _ = replay_trace(server, trace)       # warm-up pass
        sweeps0, buckets0 = op.counts["cross_sweeps"], server.buckets_served
        gap, lats = replay_trace(server, trace)
        append_ok = True
        if args.append_batches > 0:
            append_ok = _append_leg(args, params, server, op)
    finally:
        server.stop()

    sweeps = op.counts["cross_sweeps"] - sweeps0
    buckets = server.buckets_served - buckets0
    p50, p99 = percentile_ms(lats, 50), percentile_ms(lats, 99)
    print(f"replayed {len(trace)} queries: parity {gap:.3e} "
          f"(warmup pass {gap_warmup:.3e})")
    print(f"launches: {sweeps} cross sweeps over {buckets} buckets "
          f"(route: {op.last_route})")
    print(f"latency: p50 {p50:.2f} ms  p99 {p99:.2f} ms")
    print(f"peak device memory {_peak_gb(device)}")

    ok = append_ok
    if gap > args.parity_tol or gap_warmup > args.parity_tol:
        print(f"FAIL: parity {max(gap, gap_warmup):.3e} > "
              f"tol {args.parity_tol:.1e}")
        ok = False
    if sweeps != buckets:
        print(f"FAIL: {sweeps} cross sweeps != {buckets} buckets "
              f"(serving must launch exactly once per bucket)")
        ok = False
    if args.max_p50_ms is not None and p50 > args.max_p50_ms:
        print(f"FAIL: p50 {p50:.2f} ms > budget {args.max_p50_ms} ms")
        ok = False
    print("serve ok" if ok else "serve FAILED")
    return 0 if ok else 1


def _append_leg(args, params: dict, server: KernelServer,
                op: CountingOperator) -> bool:
    """Absorb batches through the live server, then hold the absorb to the
    O(b·c) meter contract and the grown-corpus parity contract."""
    batches = synth_batches(params, args.append_batches, args.append_rows)
    before = dict(op.counts)
    n_before = int(server.artifact.C.shape[0])

    pending = [server.submit_append(Xb, yb) for Xb, yb in batches]
    stats = [p.wait(timeout=60.0) for p in pending]
    gens = [s.generation for s in stats]
    app_p50 = percentile_ms([p.latency_s for p in pending], 50)
    print(f"append: absorbed {len(batches)} x {args.append_rows} rows "
          f"(n {n_before} -> {stats[-1].n_after}), p50 {app_p50:.2f} ms, "
          f"drift {stats[-1].drift:.3f}")

    ok = True
    # one thin metered launch per batch, nothing else
    deltas = {k: op.counts[k] - before.get(k, 0)
              for k in ("append_sweeps", "sweeps", "fulls", "cross_sweeps")}
    print(f"append: meter {json.dumps(deltas)}")
    if deltas["append_sweeps"] != len(batches):
        print(f"FAIL: {deltas['append_sweeps']} append sweeps for "
              f"{len(batches)} batches (must be exactly one per batch)")
        ok = False
    if deltas["sweeps"] or deltas["fulls"] or deltas["cross_sweeps"]:
        print(f"FAIL: absorb touched the kernel beyond the thin launch "
              f"(sweeps={deltas['sweeps']} fulls={deltas['fulls']} "
              f"cross={deltas['cross_sweeps']})")
        ok = False
    if gens != list(range(gens[0], gens[0] + len(batches))):
        print(f"FAIL: generations {gens} not consecutive in arrival order")
        ok = False

    # grown-corpus parity: fresh queries against dense f64 oracles over the
    # artifact as it now stands (base + every appended row)
    rng = np.random.default_rng(params["seed"] + 2)
    _, y_base = synth_problem(params["n"], params["d"], params["seed"])
    y_full = np.concatenate([y_base[:, None]]
                            + [yb[:, None] for _, yb in batches], axis=0)
    art = server.artifact
    head = dense_krr_head(art, y_full)
    gaps = []
    for nq in (5, 17, 33):
        Xq = rng.standard_normal((nq, params["d"])).astype(np.float32)
        expected = dense_krr_oracle(art, Xq, head=head)
        res = server.submit(Xq, "krr").wait(timeout=60.0)
        gaps.append(parity_gap(res.out, expected))
        for task in ("kpca", "features"):
            expected = dense_oracle(art, Xq, task)
            res = server.submit(Xq, task).wait(timeout=60.0)
            gaps.append(parity_gap(res.out, expected))
    gap = max(gaps)
    print(f"append: grown-corpus parity {gap:.3e} over {len(gaps)} probes")
    if gap > args.parity_tol:
        print(f"FAIL: grown-corpus parity {gap:.3e} > "
              f"tol {args.parity_tol:.1e}")
        ok = False

    # persistence: every generation is a committed delta step, and a fresh
    # chain restore reproduces the live artifact bit for bit
    steps = ckpt.committed_steps(args.dir)
    if len(steps) < 1 + len(batches):
        print(f"FAIL: expected >= {1 + len(batches)} committed steps "
              f"(base + one delta per batch), found {steps}")
        ok = False
    restored = load_artifact(args.dir, device=art.device)
    same = restored is not None and \
        torch.equal(restored.C, art.C) and \
        all(torch.equal(restored.heads[t], art.heads[t]) for t in art.heads)
    print(f"append: delta-chain restore bitwise {same}")
    if not same:
        print("FAIL: delta-chain restore does not reproduce the live "
              "artifact bitwise")
        ok = False
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="kernel-inference serving: build (--build) and "
                    "warm-boot replay (--serve)")
    p.add_argument("--build", action="store_true")
    p.add_argument("--serve", action="store_true")
    p.add_argument("--dir", required=True,
                   help="checkpoint directory (the factor store)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    # build-side knobs (persisted to build.json for the rebuild hook)
    p.add_argument("--n", type=int, default=240)
    p.add_argument("--d", type=int, default=24)
    p.add_argument("--c", type=int, default=48)
    p.add_argument("--s", type=int, default=96)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--n-components", type=int, default=8)
    p.add_argument("--kernel", default="rbf")
    p.add_argument("--sigma", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--queries", type=int, default=12)
    p.add_argument("--no-pallas", "--no-kernel", dest="no_pallas",
                   action="store_true",
                   help="sweep over explicit blocks, not the fused launch")
    # serve-side knobs
    p.add_argument("--require-warm", action="store_true",
                   help="fail unless the artifact restored from checkpoint")
    p.add_argument("--parity-tol", type=float, default=1e-5)
    p.add_argument("--max-p50-ms", type=float, default=None)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    # incremental-append leg (serve side)
    p.add_argument("--append-batches", type=int, default=0,
                   help="absorb this many appended batches through the live "
                        "server and check the O(b*c) meter and grown-corpus "
                        "parity contracts")
    p.add_argument("--append-rows", type=int, default=16,
                   help="rows per appended batch")
    p.add_argument("--drift-threshold", type=float, default=float("inf"),
                   help="staleness drift threshold for the append leg "
                        "(default: never re-sketch)")
    args = p.parse_args(argv)

    if args.build == args.serve:
        p.error("exactly one of --build / --serve is required")
    return _build(args) if args.build else _serve(args)


if __name__ == "__main__":
    raise SystemExit(main())
