"""The port's dry run (``repro_torch.launch.dryrun``) and the cell half of
its roofline held against the reference and against real runs.

- The pure functions against the reference's: ``model_flops`` (FULL
  configs), ``scan_reps``, ``_reduced_cfg``'s fields and
  ``_parse_override`` on every arch × ``shapes_for(arch)``;
  ``Roofline.finalize`` / ``to_json`` under the reference's profiles
  passed in as values; ``format_table`` on the same rows.
- A trace equals a run: a SMOKE cell on a (1, 1) mesh traced on ``meta``
  and run on the CPU (the kernels' plain versions) gives the same FLOPs,
  op for op, the same recorded bytes, calls and peak live bytes.
- The two-point extrapolation (and xlstm's sequence probe) equals a
  direct count at full depth, family by family; a train step's memory
  trace over two microbatches equals the whole step's.
- Mesh invariants on a fake process group; ``run_cell`` on the
  production meshes; the CLI; the B6 and B5 FLOP formulas against a
  brute-force count.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.launch import roofline as jrl
from repro_torch import configs as tconfigs
from repro_torch.configs import SHAPES, ShapeConfig
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.landmark_attention import kernel as lm_kernel
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module, imported without keeping the
    512-device XLA_FLAGS it sets on import."""
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return mod


# ---------------------------------------------------------------------------
# the pure functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_pure_functions_match_the_reference(arch, jdry):
    for jc, tc in ((jconfigs.get_config(arch), tconfigs.get_config(arch)),
                   (jconfigs.get_smoke(arch), tconfigs.get_smoke(arch))):
        assert D.scan_reps(tc) == jdry.scan_reps(jc)
        for r in (1, 2, 3):
            assert dataclasses.asdict(D._reduced_cfg(tc, r)) == \
                dataclasses.asdict(jdry._reduced_cfg(jc, r)), (arch, r)
    for js, ts in zip(jconfigs.shapes_for(arch), tconfigs.shapes_for(arch)):
        jc = jconfigs.config_for_shape(jconfigs.get_config(arch), js)
        tc = tconfigs.config_for_shape(tconfigs.get_config(arch), ts)
        assert rl.model_flops(tc, ts) == jrl.model_flops(jc, js), \
            (arch, ts.name)


@pytest.mark.parametrize("kv", ["seq_parallel_attn=True", "fsdp=False",
                                "landmark_c=512", "capacity_factor=1.5",
                                "remat=dots", "window=1e3", "a=b=c"])
def test_parse_override_matches_the_reference(kv, jdry):
    assert D._parse_override(kv) == jdry._parse_override(kv)


def _rows():
    return [dict(arch="yi-6b", shape="train_4k", mesh="16x16", chips=256,
                 hlo_gflops=264555.0, hlo_gbytes=6798.8, coll_gbytes=93.3,
                 coll_by_kind={"all-gather": 3.8, "all-reduce": 87.6,
                               "reduce-scatter": 1.9, "all-to-all": 0.0,
                               "collective-permute": 0.0},
                 model_gflops=3.8e7, bytes_per_chip=2.676e9,
                 hbm_gbytes=2339.7),
            dict(arch="qwen2-moe-a2.7b", shape="decode_32k", mesh="2x16x16",
                 chips=512, hlo_gflops=12.5, hlo_gbytes=40.0,
                 coll_gbytes=0.0, coll_by_kind={}, model_gflops=700.0,
                 bytes_per_chip=1.1e10),
            dict(arch="whisper-large-v3", shape="prefill_32k",
                 mesh="16x16", chips=256, hlo_gflops=0.0, hlo_gbytes=1.0,
                 coll_gbytes=5.0, coll_by_kind={"all-to-all": 5.0},
                 model_gflops=1.0, bytes_per_chip=0.0, hbm_gbytes=2.0)]


@pytest.mark.parametrize("profile", ["v5e", "cpu-interpret", None])
def test_roofline_finalize_and_to_json_match_the_reference(profile):
    jprof = {"v5e": jrl.V5E, "cpu-interpret": jrl.CPU_INTERPRET,
             None: jrl.V5E}[profile]
    tprof = rl.HardwareProfile(jprof.name, jprof.peak_flops, jprof.hbm_bw,
                               jprof.link_bw)
    for row in _rows():
        got = rl.Roofline(**row).finalize(tprof).to_json()
        want = jrl.Roofline(**row).finalize(jprof).to_json()
        assert got == want
    # without a profile the port models its own target
    r = rl.Roofline(**_rows()[0]).finalize()
    assert r.profile_name == "h100-sxm"
    assert r.compute_s == r.hlo_gflops * 1e9 / rl.H100_SXM.peak_flops


def test_format_table_matches_the_reference():
    rows = [rl.Roofline(**r).finalize().to_json() for r in _rows()]
    assert rl.format_table(rows) == jrl.format_table(rows)
    assert rl._COLLECTIVES == jrl._COLLECTIVES


# ---------------------------------------------------------------------------
# the B6 and B5 FLOP formulas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (7, 7, True, None), (7, 7, True, 3), (5, 13, True, None),
    (5, 13, True, 4), (1, 40, True, None), (1, 40, True, 16),
    (9, 4, True, None), (9, 4, True, 2), (6, 11, False, None),
    (6, 11, False, 5), (64, 64, True, 1), (33, 65, True, 100)])
def test_flash_flop_formula_counts_the_visible_pairs(Sq, Sk, causal, window):
    row = np.arange(Sq)[:, None] + (Sk - Sq)
    col = np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= col <= row
    if window is not None:
        mask &= (row - col) < window
    assert fa_kernel.visible_pairs(Sq, Sk, causal, window) == mask.sum()
    B, Hq, Hkv, D, Dv = 2, 4, 2, 8, 6
    q = torch.randn(B, Hq, Sq, D)
    k = torch.randn(B, Hkv, Sk, D)
    v = torch.randn(B, Hkv, Sk, Dv)
    with FlopCounterMode(display=False) as fc:
        out = fa_kernel.flash_attention_op(q, k, v, causal, window)
    assert fc.get_total_flops() == B * Hq * mask.sum() * (2 * D + 2 * Dv)
    torch.testing.assert_close(out, fa_ref.attention(q, k, v, causal,
                                                     window), rtol=0, atol=0)


@pytest.mark.parametrize("m,c,d,dv", [(1, 8, 4, 4), (16, 64, 32, 48),
                                      (5, 3, 7, 2)])
def test_landmark_flop_formula_counts_scores_and_read(m, c, d, dv):
    g = torch.Generator().manual_seed(0)
    Q, kl = torch.randn(m, d, generator=g), torch.randn(c, d, generator=g)
    UV, U1 = torch.randn(c, dv, generator=g), torch.randn(c, generator=g)
    off = torch.tensor([0.5])
    with FlopCounterMode(display=False) as plain:
        want = lm_kernel.landmark_read_plain(Q, kl, UV, U1, off)
    with FlopCounterMode(display=False) as fc:
        got = lm_kernel.landmark_read_op(Q, kl, UV, U1, off, 1e-6)
    # the plain version's two matmuls, and P·U1, a matrix-vector product
    # the FLOP counter has no formula for
    assert fc.get_total_flops() == plain.get_total_flops() + 2 * m * c \
        == 2 * m * c * d + 2 * m * c * (dv + 1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# a trace equals a run
# ---------------------------------------------------------------------------

_KEYS = ("flops", "flops_by_op", "hbm", "hlo_bytes", "kernels", "calls",
         "hbm_by_op", "peak_bytes", "args_bytes", "out_bytes", "alias_bytes")

TRACE_CASES = {
    "yi-6b train": ("yi-6b", {}, ShapeConfig("t", 64, 2, "train")),
    "gemma3 prefill": ("gemma3-12b", {}, ShapeConfig("p", 40, 2, "prefill")),
    "deepseek MLA absorbed decode": (
        "deepseek-v3-671b", {"mla_absorb": True},
        ShapeConfig("d", 48, 2, "decode")),
    "whisper decode": ("whisper-large-v3", {},
                       ShapeConfig("d", 24, 2, "decode")),
}


@pytest.mark.parametrize("case", list(TRACE_CASES))
def test_a_meta_trace_equals_the_cpu_run(case):
    arch, kw, shape = TRACE_CASES[case]
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), **kw)
    with D.fake_world("1x1") as mesh:
        cell = steps.build_cell(cfg, shape, mesh, accum=1)
        traced = D.trace_step(cell.step_fn, steps.local_args(cell, mesh))
        cell = steps.build_cell(cfg, shape, mesh, accum=1)
        ran = D.trace_step(cell.step_fn, D.concrete_args(cell, "cpu"))
    assert traced["flops"] > 0 and traced["hbm"] > 0
    if cell.kind != "decode":
        assert traced["kernels"]["repro_torch::flash_attention"] > 0
    for key in _KEYS:
        assert traced[key] == ran[key], key


# ---------------------------------------------------------------------------
# the extrapolation is exact here
# ---------------------------------------------------------------------------

EXTRAP_CASES = {
    "dense": ("yi-6b", {"n_layers": 3}, ShapeConfig("t", 32, 2, "train")),
    "gemma3 pattern": ("gemma3-12b", {"n_layers": 19},
                       ShapeConfig("p", 48, 2, "prefill")),
    "moe first_k_dense": ("deepseek-v3-671b", {"n_layers": 4},
                          ShapeConfig("t", 32, 2, "train")),
    "recurrent": ("recurrentgemma-2b", {"n_layers": 10},
                  ShapeConfig("t", 32, 2, "train")),
    "encoder-decoder": ("whisper-large-v3", {"n_enc_layers": 3,
                                             "n_dec_layers": 3,
                                             "n_layers": 3},
                        ShapeConfig("t", 64, 2, "train")),
    "xlstm sequence probe": ("xlstm-125m", {"n_layers": 6},
                             ShapeConfig("p", 128, 2, "prefill")),
}


@pytest.mark.parametrize("case", list(EXTRAP_CASES))
def test_two_point_extrapolation_equals_the_full_depth_count(
        case, monkeypatch):
    arch, kw, shape = EXTRAP_CASES[case]
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), **kw)
    if arch == "xlstm-125m":           # probe at 32 and 64 tokens, S = 128
        monkeypatch.setattr(D, "PROBE_S", 32)
        monkeypatch.setattr(D, "PROBE_PAST", 64)
    R = D.scan_reps(cfg)
    assert R >= 3
    with D.fake_world("1x1") as mesh:
        got = D.extrapolated_costs(cfg, shape, mesh)
        want = D._costs(D._reduced_cfg(cfg, R), shape, mesh)
    for key in ("flops", "hlo_bytes", "hbm"):
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert got["coll"] == pytest.approx(want["coll"], rel=1e-12)
    assert got["kernels"] == {k: int(v) for k, v in want["kernels"].items()}


def test_a_train_memory_trace_over_two_microbatches_equals_the_step():
    cfg = tconfigs.get_smoke("yi-6b")
    shape = ShapeConfig("t", 32, 8, "train")
    with D.fake_world("1x1") as mesh:
        cell, mem = D.memory_trace(cfg, shape, mesh, accum=4)
        assert cell.accum == 4
        whole = D.trace_step(cell.step_fn, steps.local_args(cell, mesh),
                             count_flops=False)
    assert mem["argument_size_in_bytes"] == whole["args_bytes"]
    # the two microbatches' trace leaves out 2 of the 4 metrics' 0-d
    # tensors a key (loss, and the rest of the model's metrics)
    gap = whole["peak_bytes"] - mem["bytes_per_chip"]
    assert 0 <= gap <= 2 * 8 * 8, gap


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_the_sequence_probed_memory_equals_the_direct_trace(kind,
                                                            monkeypatch):
    # past 128 tokens the SMOKE stack's peak grows by the same bytes a
    # token (below it the peak sits in an op of another size)
    cfg = tconfigs.get_smoke("xlstm-125m")
    shape = ShapeConfig("s", 512, 2, kind)
    with D.fake_world("1x1") as mesh:
        monkeypatch.setattr(D, "PROBE_PAST", 1 << 20)
        _, direct = D.memory_trace(cfg, shape, mesh)
        monkeypatch.setattr(D, "PROBE_S", 128)
        monkeypatch.setattr(D, "PROBE_PAST", 256)
        _, probed = D.memory_trace(cfg, shape, mesh)
    assert probed == direct


# ---------------------------------------------------------------------------
# meshes on a fake process group
# ---------------------------------------------------------------------------

def test_data_parallel_ranks_each_count_a_quarter_of_the_flops():
    cfg = tconfigs.get_smoke("yi-6b")
    shape = ShapeConfig("t", 32, 8, "train")
    flops = {}
    for dims in ("1x1", "4x1"):
        with D.fake_world(dims) as mesh:
            cell = steps.build_cell(cfg, shape, mesh, accum=1)
            flops[dims] = D.trace_step(cell.step_fn,
                                       steps.local_args(cell, mesh))[
                "flops"]
    assert flops["4x1"] * 4 == flops["1x1"]


@pytest.mark.parametrize("arch,kw", [
    ("yi-6b", {"n_layers": 4, "head_dim": 32}), ("whisper-large-v3", {})])
def test_a_data_rank_of_a_prefill_holds_what_one_device_holds(arch, kw):
    """Each of 8 data ranks prefills one of 8 rows: its trace is one
    device's at batch 1 (the whole cache the step lays out its specs by
    is built on ``meta`` alone and held by no device; the widths make
    that cache larger than the rank's peak)."""
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), **kw)
    res = {}
    for spec, B in (("1x1", 1), ("8x1", 8)):
        with D.fake_world(spec) as mesh:
            cell = steps.build_cell(cfg, ShapeConfig("p", 256, B, "prefill"),
                                    mesh)
            res[spec] = D.trace_step(cell.step_fn,
                                     steps.local_args(cell, mesh))
    for key in ("peak_bytes", "args_bytes", "flops", "hbm"):
        assert res["8x1"][key] == res["1x1"][key], key


def _ref_record_keys(jdry) -> set:
    fields = {f.name for f in dataclasses.fields(jrl.Roofline)}
    return fields | {"memory_analysis", "kind", "compile_full_s",
                     "compile_extrap_s", "collective_count_per_superblock",
                     "scan_reps"}


RUN_CELLS = (("yi-6b", "train_4k"), ("gemma3-12b", "long_500k"),
             ("qwen2-moe-a2.7b", "decode_32k"),
             ("deepseek-v3-671b", "decode_32k"),
             ("recurrentgemma-2b", "decode_32k"),
             ("xlstm-125m", "decode_32k"),
             ("whisper-large-v3", "decode_32k"))


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                          "2x16x16"])
def test_run_cell_on_the_production_meshes(multi_pod, tmp_path, jdry,
                                           monkeypatch):
    monkeypatch.setattr(D, "get_config", tconfigs.get_smoke)
    was = dist.is_initialized()
    mesh = "2x16x16" if multi_pod else "16x16"
    for arch, shape in RUN_CELLS:
        rec = D.run_cell(arch, shape, multi_pod, out_dir=str(tmp_path),
                         verbose=False)
        assert _ref_record_keys(jdry) <= set(rec)
        assert rec["chips"] == (512 if multi_pod else 256)
        assert rec["mesh"] == mesh and rec["kind"] == SHAPES[shape].kind
        assert rec["memory_analysis"]["bytes_per_chip"] > 0
        assert rec["hlo_gflops"] > 0 and rec["profile_name"] == "h100-sxm"
        name = tmp_path / f"{arch}__{shape}__{mesh}.json"
        assert json.loads(name.read_text()) == rec
    assert dist.is_initialized() == was


def test_mla_under_sequence_parallel_traces_on_the_production_mesh(
        tmp_path, monkeypatch, capsys):
    """``--set seq_parallel_attn=True`` on deepseek-v3 × train_4k (SMOKE:
    4 heads, which ``model`` = 16 does not divide) traces on (16, 16):
    rank 0's MLA attentions take its 256 of the 4,096 query rows against
    the keys up to its last row, 256 (``attention._mla_sp``)."""
    from repro_torch.models import attention as TA
    monkeypatch.setattr(D, "get_config", tconfigs.get_smoke)
    attend, shapes = TA.mla_attend_full, []

    def spy(params, cfg, q_nope, q_rope, ckv, k_rope):
        shapes.append((int(q_nope.shape[1]), int(ckv.shape[1])))
        return attend(params, cfg, q_nope, q_rope, ckv, k_rope)
    monkeypatch.setattr(TA, "mla_attend_full", spy)
    D.main(["--arch", "deepseek-v3-671b", "--shape", "train_4k", "--set",
            "seq_parallel_attn=True", "--out", str(tmp_path)])
    assert "dry-run complete" in capsys.readouterr().out
    rec = json.loads((tmp_path / "deepseek-v3-671b__train_4k__16x16.json")
                     .read_text())
    assert rec["kind"] == "train" and rec["chips"] == 256
    assert rec["kernels"]["repro_torch::flash_attention"] > 0
    assert shapes and set(shapes) == {(256, 256)}, set(shapes)


def test_the_fake_world_refuses_another_group_and_restores_the_process(
        tmp_path):
    from repro_torch.distributed import collectives as C
    assert not dist.is_initialized()
    with D.fake_world("2x2") as mesh:
        assert dist.get_world_size() == 4 and mesh.size() == 4
        C.group_of(("data", "model"), mesh)
        assert C._GROUPS
    assert not dist.is_initialized() and not C._GROUPS
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="fake process group"):
            with D.fake_world("1x1"):
                pass
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


def test_the_cli_writes_records_the_roofline_table_reads(tmp_path, capsys):
    D.main(["--arch", "yi-6b", "--shape", "decode_32k", "--mesh", "both",
            "--out", str(tmp_path)])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["yi-6b__decode_32k__16x16.json",
                     "yi-6b__decode_32k__2x16x16.json"]
    capsys.readouterr()
    rl.main(["--glob", str(tmp_path / "*.json")])
    table = capsys.readouterr().out
    rows = [json.loads((tmp_path / f).read_text()) for f in files]
    assert table.strip() == rl.format_table(rows)
    assert jrl.format_table(rows) == rl.format_table(rows)


def test_collectives_count_result_bytes_by_the_reference_convention():
    from repro_torch.distributed import collectives as C
    cfg = tconfigs.get_smoke("yi-6b")
    with D.fake_world("2x2") as mesh:
        cell = steps.build_cell(cfg, ShapeConfig("t", 32, 4, "train"), mesh,
                                accum=1)
        C.reset_stats()
        r = D.trace_step(cell.step_fn, steps.local_args(cell, mesh))
        stats = {C.HLO_KIND[k]: v for k, v in C.STATS.items()}
    assert stats and r["n_coll"] == sum(v["count"] for v in stats.values())
    for kind, v in stats.items():
        assert r["coll"][kind] == v["result_bytes"]
        assert r["coll_calls"][kind] == v["count"]
        if kind == "all-gather":            # the gathered output
            assert v["result_bytes"] >= 2 * v["bytes"]
        else:
            assert v["result_bytes"] == v["bytes"]
