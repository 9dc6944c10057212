"""Package rules of the PyTorch/CUDA port.

- nothing under ``src/repro_torch/`` (nor ``chip_smoke.py``) imports ``jax``
  or the reference package ``repro``: checked in a fresh interpreter that
  imports every module, and by a scan of the sources;
- entry points default to the CUDA device and raise without one;
- the CUDA wrappers raise on what their kernels do not take (CPU tensors,
  other dtypes, specs whose entry_fn cannot be lowered to a kernel
  epilogue) instead of falling back;
- ``chip_smoke.py`` fails, printing no result, without a card or outside
  the repository.
"""
from __future__ import annotations

import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import device as tdevice
from repro_torch import kernels as tkernels
from repro_torch.core import spsd as tsp
from repro_torch.core.kernelop import PairwiseKernel, RBFKernel
from repro_torch.configs import gemma3_12b
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.flash_attention import build as fa_build
from repro_torch.kernels.landmark_attention import build as lm_build
from repro_torch.kernels.landmark_attention import kernel as lm_kernel
from repro_torch.kernels.pairwise import build
from repro_torch.kernels.pairwise import kernel as tkernel
from repro_torch.kernels.pairwise import specs as tspecs
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_the_port_loads_no_jax_and_no_reference():
    mods = _all_modules()
    for m in ("repro_torch.kernels.pairwise.kernel",
              "repro_torch.distributed.sharding", "repro_torch.core.cur",
              "repro_torch.core.eig",
              "repro_torch.kernels.flash_attention.kernel",
              "repro_torch.configs.base", "repro_torch.configs.gemma3_12b",
              "repro_torch.models.attention", "repro_torch.models.model",
              "repro_torch.models.transformer", "repro_torch.launch.serve",
              "repro_torch.checkpoint", "repro_torch.checkpoint.checkpoint",
              "repro_torch.runtime", "repro_torch.runtime.fault_tolerance",
              "repro_torch.serve", "repro_torch.serve.artifact",
              "repro_torch.serve.engine", "repro_torch.serve.incremental",
              "repro_torch.launch.serve_kernel", "repro_torch.data",
              "repro_torch.data.pipeline", "repro_torch.optim",
              "repro_torch.optim.optimizers", "repro_torch.optim.schedule",
              "repro_torch.optim.compress", "repro_torch.launch.steps",
              "repro_torch.launch.train",
              "repro_torch.kernels.flash_attention.grad",
              "repro_torch.launch.mesh",
              "repro_torch.distributed.collectives",
              "repro_torch.launch.dryrun"):
        assert m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_imports_no_jax_and_no_reference(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_the_mesh_module_imports_without_jax_or_a_process_group():
    """``repro_torch.launch.mesh`` alone, in a fresh interpreter: no jax,
    no reference, no process group set up by the import."""
    code = ("import sys, torch.distributed as dist\n"
            "import repro_torch.launch.mesh as m\n"
            "assert m.mesh_dims('2x16x16') == ((2, 16, 16), "
            "('pod', 'data', 'model'))\n"
            "assert not dist.is_initialized()\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_the_distributed_package_is_checked_and_reports_trivial_meshes():
    """``repro_torch/distributed/`` is inside the scans above; without a
    process group there is no mesh, and no mesh is width 1."""
    from repro_torch.distributed import sharding
    paths = [str(p.relative_to(REPO)) for p in
             (PKG / "distributed").rglob("*.py")]
    assert "src/repro_torch/distributed/sharding.py" in paths
    if not torch.distributed.is_initialized():
        assert sharding.data_parallel_mesh("cpu") is None
    assert sharding.data_size(None) == 1 and sharding.data_axes(None) == ()
    assert sharding.shard_index(None) == 0


def test_default_device_is_cuda_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.default_device()
    with pytest.raises(RuntimeError):
        RBFKernel(np.zeros((4, 2), np.float32), sigma=1.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tdevice.default_device() == torch.device("cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


def test_model_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = tmodel.build_model(gemma3_12b.SMOKE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", "gemma3-12b", "--smoke"])


def test_cuda_wrappers_refuse_cpu_tensors_and_other_dtypes():
    spec = tspecs.rbf(1.0)
    X = torch.zeros((5, 3))
    V = torch.zeros((5, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.pairwise_block_cuda(spec, X, X)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.pairwise_matmat_multi_cuda(spec, X, X, [V])
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.pairwise_matmat_multi_slab_cuda(spec, X, 1, 3, [V])
    with pytest.raises(ValueError, match="≥ 0"):
        tkernel.pairwise_matmat_multi_slab(spec, X, -1, 3, [V])
    X64 = X.double()
    for fn in (tkernel.pairwise_block, tkernel.pairwise_block_cuda):
        with pytest.raises(TypeError, match="float32"):
            fn(spec, X64, X64)
    with pytest.raises(TypeError, match="float32"):
        tkernel.pairwise_matmat_multi(spec, X, X, [V.double()])
    with pytest.raises(ValueError, match="feature dims"):
        tkernel.pairwise_block(spec, X, torch.zeros((5, 4)))
    with pytest.raises(ValueError, match="does not match"):
        tkernel.pairwise_matmat_multi(spec, X, X, [torch.zeros((4, 2))])
    assert tkernel.launch_counts() == {"pairwise_block": 0,
                                       "pairwise_matmat_multi": 0,
                                       "pairwise_matmat_multi_slab": 0}


def test_user_spec_runs_on_cpu_and_raises_on_the_kernel_path():
    """A spec with only a Python entry_fn: its plain version serves CPU
    tensors.  The CUDA wrappers lower its entry_fn to a kernel epilogue
    and then refuse CPU tensors like any launch (no hidden fallback); an
    entry they cannot lower raises naming the op."""
    cauchy = tspecs.KernelSpec("cauchy", "sqdist",
                               lambda t: 1.0 / (1.0 + t))
    erf = tspecs.KernelSpec("erf", "sqdist", lambda t: torch.erf(-t))
    X = np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32)
    K = PairwiseKernel(X, cauchy, device="cpu")
    ap = tsp.fast_model(K, 8, 16, s_sketch="gaussian")
    assert torch.isfinite(ap.U).all()
    tkernel.reset_launch_counts()
    for call in (lambda s: tkernel.pairwise_block_cuda(s, K.X, K.X),
                 lambda s: tkernel.pairwise_matmat_multi_cuda(s, K.X, K.X,
                                                              [K.X]),
                 lambda s: tkernel.pairwise_matmat_multi_slab_cuda(
                     s, K.X, 0, 4, [K.X])):
        with pytest.raises(ValueError, match="takes CUDA tensors"):
            call(cauchy)
        with pytest.raises(ValueError, match="aten.erf.default"):
            call(erf)
    assert set(tkernel.launch_counts().values()) == {0}


def test_build_flags_and_location():
    cmd = build.LIBRARY.nvcc_command("nvcc", Path("out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-O3" in cmd
    assert not any("fast-math" in c or "fast_math" in c for c in cmd)
    assert kbuild.BUILD_DIR == REPO / "build" / "kernels"
    assert build.LIBRARY.library_path().name.startswith("libpairwise_")
    assert all(src.exists() for src in build.SOURCES)
    if shutil.which("nvcc") is None and \
            not Path("/usr/local/cuda/bin/nvcc").exists() and \
            not os.environ.get("CUDA_HOME"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kbuild.find_nvcc()


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=120)


def test_chip_smoke_fails_without_a_card_and_outside_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: chip_smoke.py runs for real")
    res = _run_smoke(REPO)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0 and '"ok"' not in res.stdout


def test_shared_build_helper_names_one_library_per_source():
    libs = tkernels.libraries()
    assert libs == (build.LIBRARY, lm_build.LIBRARY, fa_build.LIBRARY)
    assert [lib.name for lib in libs] == ["pairwise", "landmark", "flash"]
    for lib in libs:
        path = lib.library_path()
        assert path.parent == kbuild.BUILD_DIR == REPO / "build" / "kernels"
        assert path.name == f"lib{lib.name}_{lib.source_hash()}.so"
        assert all(src.exists() and src.suffix == ".cu"
                   for src in lib.sources)
        cmd = lib.nvcc_command("nvcc", Path("out.so"))
        assert "arch=compute_90a,code=sm_90a" in cmd and "-Xptxas" in cmd
        assert [c for c in cmd if c.endswith(".cu")] == \
            [str(src) for src in lib.sources]
    assert len({lib.source_hash() for lib in libs}) == len(libs)


def test_landmark_wrapper_refuses_what_the_kernel_does_not_take():
    Q, kl, UV = torch.zeros((4, 8)), torch.zeros((3, 8)), torch.zeros((3, 5))
    U1, off = torch.zeros(3), torch.zeros(1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lm_kernel.landmark_read_cuda(Q, kl, UV, U1, off)
    assert lm_kernel.launch_counts() == {"landmark_read": 0,
                                         "landmark_read_tc": 0,
                                         "landmark_read_split": 0}
    out = lm_kernel.landmark_read_plain(Q, kl, UV, U1, off)
    assert tuple(out.shape) == (4, 5) and bool(torch.isfinite(out).all())
