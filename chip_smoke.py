#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions, TF32 off;
2. build: compile the three CUDA libraries (pairwise from
   ``pairwise_wgmma.cu``; landmark from ``landmark_wgmma.cu`` and
   ``landmark_split.cu``; flash from ``flash.cu`` and ``flash_wgmma.cu``)
   from ``src/repro_torch/.../csrc`` side by side, one nvcc each; every
   instantiation of the tensor-core kernels (``flash_wgmma_kernel``,
   ``pairwise_block_tc``, ``pairwise_matmat_tc``, ``landmark_read_tc``)
   must build with 0 bytes of spills and without ptxas's C7512 note, and
   the landmark library's other kernels without spills;
3. parity: every kernel against its plain PyTorch version on the card, for
   every registered spec × precision at a ragged shape (plus laplacian with
   a sign-split edge table, and the softmax-Gram ``exp_affine`` spec of
   sketched attention), and the one-hot gather exact; the slab launch (B4)
   the same way at a head, a middle and a clamped tail slab, its rows bit
   for bit equal to B1's; the landmark read (B5) on both of its routes
   (tensor cores, split across the landmarks) at the reference's test
   shapes in f32 and bf16, two identical calls bit-equal and the U1 sign
   flip exact;
4. main path: the fast SPSD model (paper Algorithm 1) at the documented
   large-n setting (``examples/quickstart.py`` ``large_n_demo``: n = 50,000
   points, d = 16, 32 Gaussian clusters, RBF σ = 3, c = n/250 = 200,
   s = 4c = 800, 64 Hutchinson probes) — ``fast_model_with_error``
   (gaussian, one fused launch), ``fast_model`` (leverage column sketch,
   block kernel) and ``relative_error(method="blocked")`` (75 panels of the
   block kernel) — with launch counts and metered entries, results checked
   against the plain versions and the Hutchinson estimate against the exact
   error; then the entry counts at the n = 3,000 scaling shape;
4b. spsd_sharded: the same configuration as a data-parallel sweep over a
   ("data",) ``DeviceMesh`` of 2 ranks (``torch.multiprocessing`` spawn,
   a gloo group over a ``file://`` store, both ranks on the one card):
   ``fast_model_with_error``, ``relative_error(method="blocked")``,
   ``fast_cur`` (c = r = 200, sc = sr = 800, Gaussian sketches) and
   ``streaming_subspace_eigh`` (k = 16), each rank with the same inputs and
   draws; the route ``fused_sharded`` (slab mode ``prefetch``), one B4 and
   no B1 launch per rank and fused sweep, the meter's 76 panels and
   2,500,400,000 entries per sweep, the fused outputs bit for bit equal to
   the single-device run's, the blocked error, CUR U and eigenpairs within
   their tolerances of it; B4 timed alone at rank 1's slab (25,004 ×
   50,000, M = 1,064) against its plain version, and its rows held to B1's
   bit for bit; the carries' all-reduce timed in the ranks;
5. attention_long: sketched attention at one (batch, kv-head) of a
   gemma3-12b global layer at ``long_500k`` (``src/repro/configs``:
   context n = 524,288, head_dim 256, landmark_c 512, landmark_theta 4,
   strided landmarks, f32) — ``build_landmark_state``, the landmark read
   over all n queries (one B5 launch, tensor-core route) and at a decode
   shape (16 queries; one B5 launch, split route), ``sketched_attention``
   fast and Nyström; errors against exact softmax attention on 1,024
   sampled rows, fast ≤ Nyström + 1e-3; B5 against its plain version at
   the main shape (f32 ≤ 1e-5 and its error against f64 on 4,096 rows,
   bf16 inputs within rtol = atol = 2e-2) and at the decode shape
   (≤ 1e-5), two identical calls bit-equal at both; its bound from the
   route's passes; ``landmark_decode`` over all queries, and both routes
   timed side by side at 16 … 16,384 queries;
6. attention_policy: landmarks chosen by ``uniform_adaptive2`` and
   ``leverage`` over the context's softmax Gram at n = 32,768 through a
   ``CountingOperator`` (sweeps, gathers and entries equal the count model;
   B2 launches counted), then ``sketched_attention`` with them;
7. serve_gemma3: the decoder-only LM served end to end through
   ``launch.serve.generate`` at gemma3-12b's full width with landmark
   decode on the global layers (``config_for_shape(FULL, long_500k)``,
   ``attn_impl="pallas"``: d_model 3,840, 16 heads, 8 kv heads, head_dim
   256, d_ff 15,360, vocab 262,144, window 1,024, landmark_c 512, θ 4, bf16
   compute, f32 params), cut to 12 layers (two superblocks of the 5:1
   pattern), a 32,768-token context (prefill_32k's length), 2 requests and
   16 generated tokens, random weights from a seeded generator: one warm-up
   and one timed run; prefill ms, decode ms per token, tokens per second,
   peak memory; B6 launches (12 per prefill, all of them on the tensor-core
   kernel, 0 in decode); every token in
   [0, vocab) and every logit finite; device time by kernel class of one
   prefill and 4 decode steps (``torch.profiler``, outside the counted
   run) with the idle share over the same call's unprofiled wall time;
   then B6 timed at the global and the local layer's shape and held, row
   by row on 1,024 sampled query rows, to its plain version and to an f64
   computation in bf16 (the tensor-core kernel), and to its plain version
   in f32 (the CUDA-core kernel), and the library yardstick
   ``scaled_dot_product_attention`` timed at the global shape (the smoke
   model's card-against-CPU check lives in ``tests/test_torch_cuda.py``).
7b. serve_moe: the same serving loop for qwen2-moe-a2.7b at full width
   (d_model 2,048, 16 × 128 heads MHA, 60 routed experts top-4 + 4 shared
   of width 1,408, capacity factor 1.25, vocab 151,936, bf16 compute), cut
   to 12 of 24 layers, a 32,768-token context, 2 requests, 16 tokens
   (warm-up: a 512-token prompt, 2 tokens); the same gates (B6 12 times a
   prefill on the tensor cores, none in decode) and device time by class,
   the expert GEMMs (the kernels under ``aten::bmm``) and the dispatch's
   sort / gather / scatter apart; then one MoE layer at T = 4,096 tokens
   with nothing dropped held to an f32 per-token evaluation of the same routing
   (≤ 5e-2) and bit-equal across two calls, and B6 timed at the model's
   prefill shape (D = Dv = 128, group 1), rows against the plain version
   and SDPA beside it;
7c. serve_mla: deepseek-v3-671b at full width (MLA q_lora 1,536, kv_lora
   512, nope 128, rope 64, v 128; 256 experts top-8 + 1 shared; the dense
   prefix at d_ff 18,432; bf16 params; the MTP head initialized), cut to 4
   of 61 layers (the 3 dense prefix layers and 1 MoE layer), an
   8,192-token context, 2 requests, 16 tokens, absorbed decode; the same
   gates (4 B6 launches a prefill at D = 192 / Dv = 128), one MoE layer at
   T = 512, B6 at the MLA shape;
7d. serve_dense_configs: yi-6b, yi-9b, minitron-4b and chameleon-34b (256
   seeded patch embeddings, early fusion) at full width, each cut to 2
   layers, 1 request, a 4,096-token context, 4 tokens: 2 B6 launches a
   prefill, none in decode, tokens in range, logits finite; B6 timed at
   yi's shape (D = 128, group 8).  ``phase_parity_flash`` holds B6 at these
   head shapes on both routes (D = Dv = 128 at groups 8 and 1, D = 192 /
   Dv = 128, also causal with Sq > Sk);
   B6 is also held to its plain version at every shape of the reference's
   flash tests in f32 and bf16, and in bf16 at the tensor-core kernel's
   edge cases (ragged lengths, head dims 32–256, Dv ≠ D, decode, chunked
   prefill, non-causal with and without a window), each bf16 call one
   tensor-core launch and each f32 call none, and with Sq > Sk (causal)
   the rows that see no key exactly 0 on both routes
   (``phase_parity_flash``);
8. serve_kernel: kernel-model serving at the main path's size and model
   on the reference serving CLI's problem (``synth_problem``: X ~ N(0,
   I_16), y = tanh(X w) + 0.1·noise; n = 50,000, RBF σ = 3, c = 200,
   s = 800 Gaussian, uniform selection, α = 1, 8 KPCA components,
   n_features = c, seed 0): ``build_artifact`` (one B1 launch and nothing
   else; its device time by class; C within 1e-5 of the plain version's
   entries, U within 1e-4 of the build on the plain operator with the same
   draws), ``save_artifact`` and a warm
   ``load_or_rebuild`` (every array bit for bit), ``serve_kernel_model``
   on a mixed batch of 32 trace requests in f32 (≤ 1e-5 of
   ``dense_oracle`` in f64, one B1 launch per bucket) and in bf16_f32acc
   (within 5e-2 of f32), a ``KernelServer`` (max_batch 32, max_wait 5 ms)
   with 8 closed-loop client threads over the 192-query trace (p50, p99,
   req/s, rows/s; cross launches = buckets), and 4 appended batches of 64
   rows (one B1 launch each, metered as ``append_sweeps``; ``append_rows``
   and ``save_delta`` timed apart) — the counted path; then B1 timed alone
   at a full bucket (2,048 × 200, M = 209: back to back, a call with a
   synchronize, and its kernels' device time) and at the append shape
   (64 × 200, V = I, bit for bit equal to B2's entries), each against its
   plain version; then the CLI in two fresh processes
   (``python -m repro_torch.launch.serve_kernel --build``, then ``--serve
   --require-warm --append-batches 4 --append-rows 64``, which must print
   ``serve ok``: trace parity against ``dense_krr_oracle`` ≤ 1e-5, cross
   launches = buckets, 4 append sweeps and nothing else, grown-corpus
   parity ≤ 1e-5, the delta chain restored bit for bit);
9. spsd_ragged: ``fast_model_ragged`` at the README's settings (RBF
   σ = 1.5, c = 32, s = 128, Gaussian, waste 0.25) over 8 letters
   datasets of 5,000 to 20,000 points: one B1 launch per item, the padded
   heights ``bucket_by_size``'s, each item's C and U bit for bit those of
   the unbatched ``fast_model`` on the same padded item and draws, C within
   1e-5 of the plain version's entries and U within 1e-4 of ``fast_model``
   on the plain operator;
10. calibrate: ``calibrate_sigma`` on the main path's data (n = 50,000,
   d = 16) for every spec with a calibration rule, 128 anchors from a
   seeded generator: one statistic-only B2 launch of 50,000 × 128 per spec
   under stat[sqdist], stat[l1dist] or stat[dot] (none for linear),
   metered as one ``columns`` gather of exactly 6,400,000 entries and
   nothing else; the statistic panel held to its plain version (f32
   ≤ 1e-5, sqdist and l1dist never negative, the self-pairs included), each
   parameter to the plain panel's ``torch.quantile`` (≤ 1e-5 relative),
   a 512-anchor panel (25.6 M values, above ``torch.quantile``'s limit) to
   numpy's quantile; then ``fast_model_with_error`` on each calibrated
   spec (one B1 launch each), timed, with its Hutchinson error, and
   1,024 sampled rows of that B1 launch's output held to the plain version
   (≤ 5e-5, scale-normalized); B2 timed under each statistic, with
   ``torch.mm`` beside stat[dot] and ``torch.cdist(p=1)`` beside
   stat[l1dist];
11. contracts: ``repro_torch.analysis.trace_check`` at n = 50,000 (every
   entry point under the op recorder: no output of ≥ n²/2 = 1.25e9
   elements, the meters equal each policy's declared budget and the
   pipeline contracts, no bf16 contraction operand among the torch-level
   ops — the scan cannot see inside a CUDA launch), then every
   ``rbf_sketch`` wrapper bit for bit the B2 or B1 launch it binds, and
   counted as that launch;
12. one JSON line ``{"kernels": [...]}``: per kernel its launches on its
   own path and on each of the twelve paths (every count reset just before
   the path and read just after it, and checked), time, plain-version
   time, bound, library-call time, error; each pairwise row (B1 f32 and
   bf16_f32acc, the laplacian l1dist launches, B2, B2's statistic-only
   launches, B4) also carries ``roofline``: the port's
   ``achieved_vs_roofline`` of its work under the H100 profile of its
   precision (``repro_torch.launch.roofline``), beside the route's bound;
13. the card line again, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

It exits non-zero without a CUDA device, and in a directory without the
repository's ``src/``.  It never imports JAX or the reference package.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import cur as tcur  # noqa: E402
from repro_torch.core import eig as teig  # noqa: E402
from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.core import sketched_attention as tsa  # noqa: E402
from repro_torch.core import spsd  # noqa: E402
from repro_torch.core import sweep as sweep_lib  # noqa: E402
from repro_torch.core.instrument import CountingOperator  # noqa: E402
from repro_torch.core.kernelop import PairwiseKernel, RBFKernel  # noqa: E402
from repro_torch.core.selection import get_policy  # noqa: E402
from repro_torch.analysis import trace_check  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.configs import gemma3_12b  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.flash_attention import build as fa_build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.landmark_attention import build as lm_build  # noqa: E402
from repro_torch.kernels.landmark_attention import kernel as lm_kernel  # noqa: E402
from repro_torch.kernels.landmark_attention import ops as lm_ops  # noqa: E402
from repro_torch.kernels.pairwise import build as pw_build  # noqa: E402
from repro_torch.kernels.pairwise import calibrate  # noqa: E402
from repro_torch.kernels.pairwise import kernel, signsplit, specs  # noqa: E402
from repro_torch.kernels.rbf_sketch import kernel as rbf_kernel  # noqa: E402
from repro_torch.kernels.rbf_sketch import ops as rbf_ops  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import serve_kernel as sk_launch  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit),
# from the port's roofline profiles
PEAK_FP32_FLOPS = roofline.H100_SXM_FP32.peak_flops
PEAK_BF16_TC_FLOPS = roofline.H100_SXM.peak_flops
PEAK_TF32_TC_FLOPS = roofline.H100_SXM_TF32.peak_flops
PEAK_HBM_BYTES = roofline.H100_SXM.hbm_bw

TOL_F32 = 1e-5          # f32 kernel vs plain, scale-normalized
TOL_BF16_SAME = 1e-2    # bf16_f32acc kernel vs plain under the same policy
TOL_BF16_F32 = 5e-2     # bf16_f32acc kernel vs the f32 plain version
# At the main shape every fused output sums 50,000 products.  Two f32
# implementations that add them in different orders (the kernel's tile sums,
# cuBLAS's in the plain version) differ by their rounding, which grows like
# sqrt(n)·eps of the partial sums; 1e-5 is the reference's gate at its test
# sizes (n ≤ 600).  So the kernel is held to 1e-5 against the exact (f64)
# contraction of the plain version's f32 entries, and to this stated
# tolerance against the f32 plain version itself.
TOL_F32_MAIN = 5e-5

TOL_READ_BF16 = 2e-2    # landmark read with bf16 inputs: the reference's
                        # _tol(bf16), rtol = atol = 2e-2

DEV = "cuda"

# the main-path configuration (quickstart large_n_demo)
N, D, CLUSTERS, NOISE, SIGMA = 50_000, 16, 32, 0.5, 3.0
C_COLS, S_COLS, PROBES = N // 250, 4 * (N // 250), 64

# the attention configuration: one (batch, kv-head) of a gemma3-12b global
# layer at long_500k (src/repro/configs/gemma3_12b.py, configs/base.py)
ATT_N, ATT_D, ATT_C, ATT_THETA = 524_288, 256, 512, 4
ATT_DECODE_M = 16       # 2 query heads per kv head x batch 8
# B5's two routes timed side by side at these query counts
READ_ROUTE_M = (16, 64, 128, 256, 512, 1024, 4096, 16384)
ATT_ERR_ROWS, ATT_ERR_CHUNK = 1024, 256
POLICY_N = 32_768       # context of the policy phase

# the sharded configuration: the main path over 2 ranks on the one card,
# plus CUR and the subspace eigensolver on the same operator
WORLD = 2
CUR_C, CUR_R, CUR_SC, CUR_SR = 200, 200, 800, 800
EIG_K = 16
TOL_EIG = 1e-5          # eigenvalues, relative
TOL_MISALIGN = 1e-4     # eigenvector subspace (misalignment)
TOL_SHARDED_ERR = 1e-5  # blocked error, relative: the ranks' partial sums
                        # reassociate the single-device sum

# the serving configuration: gemma3-12b at long_500k (landmark decode on the
# global layers) through the flash kernel, at full width; cut to 12 of 48
# layers (the 48-layer f32 params alone are 47 GB), a 32,768-token context
# (prefill_32k's length; at 524,288 one global layer's causal attention is
# 2.3e15 flop), 2 requests and 16 generated tokens
SERVE_LAYERS, SERVE_CONTEXT, SERVE_BATCH, SERVE_GEN = 12, 32_768, 2, 16
FLASH_ROWS = 1024       # sampled query rows of the B6 checks at full shape
TOL_FLASH_BF16 = 2e-2   # B6 with bf16 inputs: the reference's _tol(bf16)
# At the served shapes a sampled row's output is small (|out| ~ sqrt(e/p) at
# key position p), so an elementwise atol of 2e-2 would pass a wrong row.
# There each (b, h, row) is held to its own relative error
# ||got - exact|| / ||exact||: rounding the output to bf16 alone moves an
# element by up to 2^-8 = 3.9e-3 of itself, so 1e-2 in bf16; f32 against
# f32 at 1e-5.
TOL_FLASH_ROW_BF16 = 1e-2
TOL_FLASH_ROW_F32 = 1e-5
# the shapes of the reference's flash tests (tests/test_kernels.py)
FLASH_SHAPES = ((1, 4, 4, 128, 128, 64), (2, 8, 2, 128, 128, 32),
                (1, 4, 1, 256, 256, 64), (2, 4, 2, 100, 100, 32),
                (1, 2, 2, 1, 256, 64), (1, 4, 2, 64, 256, 32))
# the tensor-core kernel's edge cases, bf16: (B, Hq, Hkv, Sq, Sk, D, Dv),
# causal, window -- lengths off its 128-row / 64-key tiles, every head width
# it templates (32 pads to 64), Dv ≠ D, decode, chunked prefill, non-causal
FLASH_TC_EDGES = (
    ((1, 2, 1, 100, 100, 64, 64), True, None),
    ((1, 2, 1, 1000, 1000, 64, 64), True, None),
    ((1, 2, 1, 1000, 1000, 64, 64), True, 200),
    ((1, 2, 1, 300, 300, 32, 32), True, None),
    ((1, 2, 1, 300, 300, 128, 128), True, None),
    ((1, 2, 1, 300, 300, 256, 256), True, None),
    ((1, 2, 1, 300, 300, 64, 128), True, None),
    ((1, 2, 1, 300, 300, 128, 64), True, 100),
    ((2, 4, 2, 1, 1000, 256, 256), True, None),
    ((2, 4, 2, 1, 1000, 256, 256), True, 64),
    ((1, 4, 2, 100, 1000, 128, 128), True, None),
    ((1, 2, 1, 100, 1000, 256, 256), False, None),
    ((1, 2, 1, 100, 1000, 256, 256), False, 100))

# the kernel-model serving configuration: the reference's serving CLI
# problem (synth_problem: X ~ N(0, I_d), y = tanh(X w) + 0.1 noise) at the
# main path's size and model (large_n_demo): n = 50,000, d = 16, RBF σ = 3,
# c = 200, s = 800 (Gaussian), uniform selection, α = 1, 8 KPCA components,
# n_features = c, seed 0; the CLI's batching defaults; 192 trace queries of
# 5-64 rows; appends of 4 batches x 64 rows (bench_serve --append's b)
SK_N, SK_C, SK_S, SK_SIGMA, SK_SEED = N, C_COLS, S_COLS, SIGMA, 0
SK_COMPONENTS, SK_QUERIES, SK_CLIENTS = 8, 192, 8
SK_SERVER_PASSES = 3                # timed passes of the trace (median's)
SK_MAX_BATCH, SK_MAX_WAIT_MS = 32, 5.0
SK_BUCKET_ROWS = 32 * 64          # a full bucket: 32 requests of 64 rows
SK_APPEND_BATCHES, SK_APPEND_ROWS = 4, 64
TOL_SERVE = 1e-5                  # served answers vs the dense oracles
TOL_U = 1e-4                      # U vs the plain operator's, scale-
                                  # normalized: the port's fast-model tests'
# the ragged fast model at the README's settings ("Ragged auto-bucketing")
# over 8 letters datasets of 5,000 to 20,000 points
RAGGED_SIZES = tuple(int(v) for v in np.linspace(5_000, 20_000, 8))
RAGGED_C, RAGGED_S, RAGGED_SIGMA, RAGGED_WASTE = 32, 128, 1.5, 0.25

# calibration on the main path's data: calibrate_sigma's default of 128
# anchors for every spec with a rule, then 512 anchors (a 25.6 M-value
# panel, above torch.quantile's 2^24-element limit)
CAL_ANCHORS, CAL_ANCHORS_WIDE = 128, 512
CAL_B1_ROWS = 1024      # B1 rows held to the plain version per calibrated spec
TOL_CAL = 1e-5          # calibrated parameters vs the plain panel's, relative

# the MoE serving configuration: qwen2-moe-a2.7b at full width
# (src/repro/configs/qwen2_moe_a2_7b.py: d_model 2,048, 16 x 128 heads MHA,
# 60 routed experts top-4 + 4 shared of width 1,408, vocab 151,936, bf16
# compute, f32 params), cut to 12 of 24 layers (the f32 params at init are
# ~30 GB), a 32,768-token context (prefill_32k's length), 2 requests and 16
# generated tokens; one MoE layer checked at T = 4,096 tokens
MOE_LAYERS, MOE_CONTEXT, MOE_BATCH, MOE_GEN = 12, 32_768, 2, 16
MOE_CHECK_T = 4096
# the MLA serving configuration: deepseek-v3-671b at full width
# (src/repro/configs/deepseek_v3_671b.py: d_model 7,168, 128 heads, MLA
# q_lora 1,536, kv_lora 512, nope 128, rope 64, v 128, 256 routed experts
# top-8 + 1 shared of width 2,048, the dense prefix at d_ff 18,432, vocab
# 129,280, bf16 params, MTP), cut to 4 of 61 layers (the 3 dense prefix
# layers and the first MoE layer: ~31 GB of bf16 params), an 8,192-token
# context, 2 requests and 16 tokens, absorbed decode; one MoE layer checked
# at T = 512 tokens (nothing dropped means C = T: (E·T, d) is 1.9 GB)
MLA_LAYERS, MLA_CONTEXT, MLA_BATCH, MLA_GEN = 4, 8_192, 2, 16
MLA_CHECK_T = 512
MLA_FLASH_ROWS = 256    # B6's plain version on 256 rows: a 2.1 GB panel
# the other dense configs at full width, each cut to 2 layers, 1 request,
# a 4,096-token context and 4 tokens; chameleon takes 256 patch embeddings
DENSE_ARCHS = ("yi-6b", "yi-9b", "minitron-4b", "chameleon-34b")
DENSE_LAYERS, DENSE_CONTEXT, DENSE_BATCH, DENSE_GEN = 2, 4096, 1, 4
DENSE_PATCHES = 256
WARM_LEN = 512          # the warm-up prompt of those paths (2 tokens)
TOL_MOE = 5e-2          # a bf16 MoE layer vs its f32 per-token evaluation
# B6 at the new models' head shapes, both routes: (B, Hq, Hkv, Sq, Sk, D,
# Dv) -- yi's GQA group 8 and qwen2-moe's MHA at D = 128, MLA's D = 192 /
# Dv = 128 (the HD = 256 instance), also causal with Sq > Sk
FLASH_MODEL_SHAPES = ((1, 32, 4, 300, 300, 128, 128),
                      (1, 16, 16, 300, 300, 128, 128),
                      (1, 8, 8, 300, 300, 192, 128),
                      (2, 16, 16, 1000, 1000, 192, 128),
                      (1, 8, 8, 300, 100, 192, 128))

# causal with Sq > Sk, both routes: (B, Hq, Hkv, Sq, Sk, D, Dv), window
FLASH_EMPTY_ROWS = (((1, 2, 1, 300, 100, 64, 64), None),
                    ((2, 4, 2, 200, 60, 32, 32), 24))


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int = 1, warmup: int = 0):
    """Mean milliseconds of ``fn`` on the current stream (CUDA events),
    after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps, out


def scaled_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def passes(spec) -> dict:
    """The tensor-core passes a pairwise launch under ``spec`` runs, as the
    built library reports them: the statistic's cross term (0 for l1dist,
    on the CUDA cores) and the sweep's contraction."""
    lib = pw_build.load_library()
    stat = kernel._STAT_IDS[spec.stat]
    bf16 = int(spec.precision == "bf16_f32acc")
    return {"statistic": int(lib.pairwise_passes(stat, bf16, 0)),
            "contraction": int(lib.pairwise_passes(stat, bf16, 1))}


def route_bound(spec, nr: int, nc: int, d: int, M: int, nbytes: int,
                stat_builds: int = 1) -> tuple:
    """(ms, "bytes" or "operations"): the least time of a pairwise launch on
    the route it takes.  Its tensor-core passes (``passes``) at the rate of
    their type (TF32 under f32, bf16 under bf16_f32acc), an l1dist
    statistic's ~3 flops a feature (sub, abs, add) on the FP32 CUDA cores,
    which run beside the tensor cores, so the larger counts, and the bytes
    moved.  ``stat_builds`` > 1 counts the statistic as often as the sweep
    kernel builds it (the design's floor rather than the work's)."""
    p = passes(spec)
    peak = PEAK_BF16_TC_FLOPS if spec.precision == "bf16_f32acc" \
        else PEAK_TF32_TC_FLOPS
    ops = max((p["contraction"] * 2 * nr * nc * M + p["statistic"] * 2 * d
               * nr * nc * stat_builds) / peak,
              3 * d * nr * nc * stat_builds / PEAK_FP32_FLOPS
              if spec.stat == "l1dist" else 0.0)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(ops, t_bytes) * 1e3, "operations" if ops >= t_bytes else "bytes"


def scratch_bytes(spec, nr: int, nc: int, d: int, M: int, same: bool) -> int:
    """The scratch a pairwise launch allocates (operand forms of the points
    and, for a sweep, Vᵀ's parts), from the library's own formula."""
    return int(pw_build.load_library().pairwise_workspace_bytes(
        nr, nc, d, M, kernel._STAT_IDS[spec.stat],
        int(spec.precision == "bf16_f32acc"), int(same)))


def work_roofline(spec, nr: int, nc: int, d: int, M: int, ms: float) -> dict:
    """The port's ``achieved_vs_roofline`` of one pairwise launch: the work
    of its shape and spec, whatever route implements it, over the H100
    profile of its precision (TF32 tensor cores for f32, bf16 for
    bf16_f32acc).  An l1dist statistic counts the direct loop
    ('vpu_loop'): the paths' data is continuous, so no sign-split plan
    covers it (ROADMAP B3)."""
    prof = roofline.H100_SXM if spec.precision == "bf16_f32acc" \
        else roofline.H100_SXM_TF32
    return roofline.achieved_vs_roofline(
        spec, (nr, nc, d), measured_s=ms / 1e3, m_total=M,
        l1_route="vpu_loop" if spec.stat == "l1dist" else None,
        profile=prof)


def clusters(n: int, seed: int) -> torch.Tensor:
    """The large-n demo data: 32 Gaussian clusters in d = 16, noise 0.5."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(CLUSTERS, D)) * 2.0
    labels = rng.integers(0, CLUSTERS, size=n)
    X = centers[labels] + rng.normal(size=(n, D)) * NOISE
    return torch.as_tensor(X, dtype=torch.float32, device=DEV)


def letters(n: int, seed: int) -> torch.Tensor:
    """The scaling bench's data (``benchmarks/common.py`` ``make_dataset``,
    "letters"): 26 clusters in d = 16, noise 0.7, standardized features."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(26, D)) * 2.0
    labels = rng.integers(0, 26, size=n)
    X = centers[labels] + rng.normal(size=(n, D)) * 0.7
    X = (X - X.mean(0)) / (X.std(0) + 1e-9)
    return torch.as_tensor(X, dtype=torch.float32, device=DEV)


def gen(seed: int) -> torch.Generator:
    return torch.Generator(device=DEV).manual_seed(seed)


def reset_counts() -> None:
    """Every kernel's launch count to 0."""
    kernel.reset_launch_counts()
    lm_kernel.reset_launch_counts()
    fa_kernel.reset_launch_counts()


def read_counts() -> dict:
    """Every kernel's launches since the last reset."""
    if DEV == "cuda":
        torch.cuda.synchronize()
    return {**kernel.launch_counts(), **lm_kernel.launch_counts(),
            **fa_kernel.launch_counts()}


def no_launches(**counts) -> dict:
    """The full launch-count dict: 0 for every kernel not named."""
    zero = {"pairwise_block": 0, "pairwise_matmat_multi": 0,
            "pairwise_matmat_multi_slab": 0, "landmark_read": 0,
            "landmark_read_tc": 0, "landmark_read_split": 0,
            "flash_attention": 0, "flash_attention_tc": 0}
    assert set(counts) <= set(zero), counts
    return {**zero, **counts}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card() -> str:
    line = card_line()
    log(f"card: {line}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    return line


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = tkernels.libraries()
    kbuild.build_all(libs)
    log(f"build: {time.perf_counter() - t0:.1f} s for the {len(libs)} "
        f"libraries ({', '.join(lib.name for lib in libs)})")
    for lib in libs:
        log(f"  {lib.name}: nvcc {lib.build_seconds()} s -> "
            f"{lib.library_path()}")
        for ln in lib.build_log().splitlines():
            if any(w in ln for w in ("registers", "spill", "Compiling",
                                     "warning")):
                log(f"  ptxas: {ln.strip()}")
    check_wgmma_report(fa_build.LIBRARY.build_log(), "flash_wgmma_kernel", 3,
                       "head widths 64, 128, 256")
    for name in ("pairwise_block_tc", "pairwise_matmat_tc"):
        check_wgmma_report(pw_build.LIBRARY.build_log(), name, 10,
                           "dot and sqdist x 2 precisions x 2 k-step "
                           "counts, l1dist x 2 precisions")
    lm_log = lm_build.LIBRARY.build_log()
    check_wgmma_report(lm_log, "landmark_read_tc", 3,
                       "f32 -> f32, f32 -> bf16, bf16 -> bf16")
    # B5's other kernels (prep, split partials, reduction): no spills either
    rest = {k: v for k, v in ptxas_spills(lm_log, "").items()
            if "landmark_read_tc" not in k}
    check(len(rest) == 10 and all(b == 0 for b in rest.values()),
          f"landmark library spills: {rest}")
    log(f"  ptxas: landmark prep/split/reduce x{len(rest)}: 0 bytes of "
        f"spills")


def ptxas_spills(report: str, name: str) -> dict:
    """Spill bytes (stores + loads) per entry function of an ``-Xptxas -v``
    report whose mangled name contains ``name``."""
    spills, entry = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1) if name in m.group(1) else None
            if entry:
                spills[entry] = 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and entry:
            spills[entry] += int(m.group(1)) + int(m.group(2))
    return spills


def check_wgmma_report(report: str, name: str, count: int,
                       what: str) -> None:
    """A tensor-core kernel must build without spills and without ptxas's
    C7512 note (wgmma serialized for want of registers): either once cost
    the flash kernel more than half its speed at the served shape."""
    spills = ptxas_spills(report, name)
    check(len(spills) == count, f"ptxas reported {len(spills)} "
          f"instantiations of {name}, expected {count} ({what})")
    check(all(b == 0 for b in spills.values()), f"{name} spills: {spills}")
    c7512 = [ln.strip() for ln in report.splitlines() if "C7512" in ln]
    check(not c7512, f"ptxas serialized wgmma: {c7512}")
    log(f"  ptxas: {name} x{len(spills)}: 0 bytes of spills, no C7512 note")


def _parity_case(spec, Xr, Xc, Vs, edges, label) -> dict:
    """B1 and B2 against their plain versions; returns the errors."""
    f32 = spec.with_precision("f32")
    blk = kernel.pairwise_block_cuda(spec, Xr, Xc, edges)
    blk_plain = kernel.pairwise_block_plain(spec, Xr, Xc, edges)
    outs = kernel.pairwise_matmat_multi_cuda(spec, Xr, Xc, Vs, edges)
    outs_plain = kernel.pairwise_matmat_multi_plain(spec, Xr, Xc, Vs, edges)
    torch.cuda.synchronize()
    errs = {"block": scaled_err(blk, blk_plain),
            "multi": max(scaled_err(o, p) for o, p in zip(outs, outs_plain))}
    if spec.precision == "f32":
        for k, e in errs.items():
            check(e <= TOL_F32, f"{label} {k}: {e:.3g} > {TOL_F32}")
    else:
        for k, e in errs.items():
            check(e <= TOL_BF16_SAME,
                  f"{label} {k}: {e:.3g} > {TOL_BF16_SAME}")
        blk32 = kernel.pairwise_block_plain(f32, Xr, Xc, edges)
        outs32 = kernel.pairwise_matmat_multi_plain(f32, Xr, Xc, Vs, edges)
        e32 = max(scaled_err(blk, blk32),
                  max(scaled_err(o, p) for o, p in zip(outs, outs32)))
        check(e32 <= TOL_BF16_F32, f"{label} vs f32: {e32:.3g}")
        errs["vs_f32"] = e32
    check(all(bool(torch.isfinite(o).all()) for o in (blk, *outs)),
          f"{label}: non-finite output")
    return errs


def phase_parity() -> None:
    rng = np.random.default_rng(1)
    nr, nc = 1000, 1500
    dev = DEV
    Xr = torch.as_tensor(rng.normal(size=(nr, D)), dtype=torch.float32,
                         device=dev)
    Xc = torch.as_tensor(rng.normal(size=(nc, D)), dtype=torch.float32,
                         device=dev)
    gidx = torch.as_tensor(rng.choice(nc, 37, replace=False), device=dev)
    Vs = (sweep_lib.one_hot_columns(gidx, nc, dev),
          torch.as_tensor(rng.normal(size=(nc, 129)), dtype=torch.float32,
                          device=dev),
          torch.as_tensor(rng.normal(size=(nc, 16)), dtype=torch.float32,
                          device=dev))
    for name in specs.registered_kernels():
        for prec in specs.PRECISIONS:
            spec = specs.suggested_spec(name, D).with_precision(prec)
            errs = _parity_case(spec, Xr, Xc, Vs, None, f"{name}/{prec}")
            if prec == "f32":
                # the one-hot gather through B1 is the block entries exactly
                gathered = kernel.pairwise_matmat_multi_cuda(
                    spec, Xr, Xc, Vs[:1])[0]
                direct = kernel.pairwise_block_cuda(spec, Xr, Xc[gidx])
                gap = float((gathered - direct).abs().max())
                check(gap == 0.0, f"{name}: one-hot gather not exact ({gap})")
                errs["gather_gap"] = gap
            log(f"parity {name:10s} {prec:12s} " + " ".join(
                f"{k}={v:.3g}" for k, v in errs.items()))
    # laplacian on integer-valued data, with the sign-split edge table
    Xi = rng.integers(0, 6, size=(nr + nc, D)).astype(np.float32)
    edges = torch.as_tensor(signsplit.build_plan(Xi).edges, device=dev)
    Xir = torch.as_tensor(Xi[:nr], device=dev)
    Xic = torch.as_tensor(Xi[nr:], device=dev)
    for prec in specs.PRECISIONS:
        spec = specs.suggested_spec("laplacian", D).with_precision(prec)
        errs = _parity_case(spec, Xir, Xic, Vs, edges,
                            f"laplacian+edges/{prec}")
        log(f"parity laplacian+edges {prec:12s} " + " ".join(
            f"{k}={v:.3g}" for k, v in errs.items()))
    # the softmax Gram of sketched attention (exp_affine) at head_dim 256
    Xa = torch.as_tensor(rng.normal(size=(nr + nc, ATT_D)) * 0.4,
                         dtype=torch.float32, device=dev)
    soft = tsa.softmax_gram_operator(Xa).spec
    for prec in specs.PRECISIONS:
        errs = _parity_case(soft.with_precision(prec), Xa[:nr].contiguous(),
                            Xa[nr:].contiguous(), Vs, None,
                            f"softmax_gram/{prec}")
        log(f"parity softmax_gram (exp_affine) {prec:12s} " + " ".join(
            f"{k}={v:.3g}" for k, v in errs.items()))


def _slab_case(spec, X, Vs, slabs, label) -> dict:
    """B4 against its plain version at each (start, length) slab, and its
    rows against B1's rows of the same X bit for bit (clamp rows against
    B1's last row).  Returns the largest scale-normalized error."""
    n = X.shape[0]
    full = torch.cat(kernel.pairwise_matmat_multi_cuda(spec, X, X, Vs), dim=1)
    worst = 0.0
    for start, length in slabs:
        outs = kernel.pairwise_matmat_multi_slab_cuda(spec, X, start, length,
                                                      Vs)
        plain = kernel.pairwise_matmat_multi_slab_plain(spec, X, start,
                                                        length, Vs)
        torch.cuda.synchronize()
        out = torch.cat(outs, dim=1)
        check(tuple(out.shape) == (length, full.shape[1])
              and bool(torch.isfinite(out).all()),
              f"{label} slab ({start}, {length}): shape or non-finite")
        e = max(scaled_err(o, q) for o, q in zip(outs, plain))
        tol = TOL_F32 if spec.precision == "f32" else TOL_BF16_SAME
        check(e <= tol, f"{label} slab ({start}, {length}): {e:.3g} > {tol}")
        worst = max(worst, e)
        rows = kernel.slab_rows(n, start, length, X.device)
        check(torch.equal(out, full[rows]),
              f"{label} slab ({start}, {length}): rows differ from B1's")
    return worst


def phase_parity_slab() -> None:
    """B4 at a head, a middle and a clamped tail slab of a ragged shape, for
    every registered spec × precision and the ``exp_affine`` spec: against
    its plain version (f32 ≤ TOL_F32, bf16_f32acc ≤ TOL_BF16_SAME), its
    rows against B1's bit for bit, and the one-hot gather exact."""
    rng = np.random.default_rng(2)
    n = 1500
    X = torch.as_tensor(rng.normal(size=(n, D)), dtype=torch.float32,
                        device=DEV)
    gidx = torch.as_tensor(rng.choice(n, 37, replace=False), device=DEV)
    Vs = (sweep_lib.one_hot_columns(gidx, n, DEV),
          torch.as_tensor(rng.normal(size=(n, 129)), dtype=torch.float32,
                          device=DEV),
          torch.as_tensor(rng.normal(size=(n, 16)), dtype=torch.float32,
                          device=DEV))
    slabs = ((0, 700), (400, 650), (1100, 700))      # the tail runs past n
    for name in specs.registered_kernels():
        errs = {}
        for prec in specs.PRECISIONS:
            spec = specs.suggested_spec(name, D).with_precision(prec)
            errs[prec] = _slab_case(spec, X, Vs, slabs, f"B4 {name}/{prec}")
        spec = specs.suggested_spec(name, D)
        start, length = slabs[2]
        gathered = kernel.pairwise_matmat_multi_slab_cuda(
            spec, X, start, length, Vs[:1])[0]
        direct = kernel.pairwise_block_cuda(
            spec, X[kernel.slab_rows(n, start, length, DEV)], X[gidx])
        gap = float((gathered - direct).abs().max())
        check(gap == 0.0, f"B4 {name}: one-hot gather not exact ({gap})")
        log(f"parity slab {name:10s} " + " ".join(
            f"{k}={v:.3g}" for k, v in errs.items())
            + f" gather_gap={gap}, rows = B1's bit for bit")
    Xa = torch.as_tensor(rng.normal(size=(n, ATT_D)) * 0.4,
                         dtype=torch.float32, device=DEV)
    soft = tsa.softmax_gram_operator(Xa).spec
    errs = {prec: _slab_case(soft.with_precision(prec), Xa, Vs, slabs,
                             f"B4 softmax_gram/{prec}")
            for prec in specs.PRECISIONS}
    log("parity slab softmax_gram (exp_affine) " + " ".join(
        f"{k}={v:.3g}" for k, v in errs.items()) + ", rows = B1's bit for bit")


def _read_case(m, c, d, dv, dtype, route, seed=3):
    """B5 on one route against its plain version at one shape: the route's
    launches, identical bits from two identical calls, the U1 sign flip
    exact; returns the error."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=DEV)

    Q = (t(rng.normal(size=(m, d))) * 0.5).to(dtype)
    kl = (t(rng.normal(size=(c, d))) * 0.5).to(dtype)
    UV = t(rng.normal(size=(c, dv))).to(dtype)
    U1 = t(np.abs(rng.normal(size=(c,))) + 0.5)
    off = t([0.3])
    key = f"landmark_read_{route}"
    before = lm_kernel.launch_counts()[key]
    out = lm_kernel.landmark_read_cuda(Q, kl, UV, U1, off, route=route)
    again = lm_kernel.landmark_read_cuda(Q, kl, UV, U1, off, route=route)
    flipped = lm_kernel.landmark_read_cuda(Q, kl, UV, -U1, off, route=route)
    torch.cuda.synchronize()
    plain = lm_kernel.landmark_read_plain(Q, kl, UV, U1, off)
    label = f"landmark_read {route} ({m}, {c}, {d}, {dv}) {dtype}"
    check(lm_kernel.launch_counts()[key] == before + 3,
          f"{label}: not launched on its route")
    check(out.dtype == dtype and tuple(out.shape) == (m, dv),
          f"{label}: {out.dtype} {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
    check(torch.equal(again, out), f"{label}: two identical calls differ")
    check(torch.equal(flipped, -out), f"{label}: U1 sign flip not exact")
    return _check_read(out, plain, label)


def _check_read(out, plain, label) -> float:
    """B5's gates: f32 ≤ TOL_F32 scale-normalized; bf16 inputs within the
    reference's rtol = atol = TOL_READ_BF16.  Returns the scaled error."""
    o32, p32 = out.float(), plain.float()
    err = scaled_err(o32, p32)
    if out.dtype == torch.float32:
        check(err <= TOL_F32, f"{label}: {err:.3g} > {TOL_F32}")
    else:
        excess = float(((o32 - p32).abs() - TOL_READ_BF16
                        * (1.0 + p32.abs())).max())
        check(excess <= 0.0, f"{label}: outside rtol = atol = "
              f"{TOL_READ_BF16} by {excess:.3g}")
    return err


def phase_parity_read() -> None:
    """B5 on both routes at the reference's test_landmark_read_vs_ref
    shapes, f32 and bf16."""
    for m, c, d, dv in ((128, 16, 64, 64), (200, 32, 32, 16),
                        (64, 8, 128, 128), (1, 16, 64, 64)):
        errs = {f"{route}/{str(dt).split('.')[-1]}":
                _read_case(m, c, d, dv, dt, route)
                for route in lm_kernel.ROUTES
                for dt in (torch.float32, torch.bfloat16)}
        log(f"parity landmark_read (m, c, d, dv) = ({m}, {c}, {d}, {dv}): "
            + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
            + ", repeat calls bit-equal, U1 sign flip exact")


def _main_calls(op, idx, S, Z):
    """The three main-path calls, each timed; returns results and times."""
    times, out = {}, {}
    op.reset()
    times["fast_model_with_error"], (out["apg"], out["err_h"]) = cuda_ms(
        lambda: spsd.fast_model_with_error(
            op, C_COLS, S_COLS, s_sketch="gaussian", probes=PROBES, idx=idx,
            S=S, Z=Z))
    out["counts_fused"] = dict(op.counts)
    out["route_fused"] = op.last_route
    op.reset()
    times["fast_model_leverage"], out["apl"] = cuda_ms(
        lambda: spsd.fast_model(op, C_COLS, S_COLS, s_sketch="leverage",
                                idx=idx, generator=gen(3)))
    out["counts_leverage"] = dict(op.counts)
    op.reset()
    times["relative_error_blocked"], out["err_b"] = cuda_ms(
        lambda: spsd.relative_error(op, out["apg"], method="blocked"))
    out["counts_blocked"] = dict(op.counts)
    out["route_blocked"] = op.last_route
    return times, out


def _main_inputs():
    """The main path's operator and draws: X, the counting RBF operator,
    idx, S, Z (the same on every process that calls it)."""
    X = clusters(N, seed=0)
    op = CountingOperator(RBFKernel(X, sigma=SIGMA, device=DEV))
    g = gen(0)
    idx = get_policy("uniform").select(op, C_COLS, generator=g)
    S = sk.GaussianSketch.draw(N, S_COLS, generator=g, device=DEV)
    Z = sk.rademacher(N, PROBES, generator=g, device=DEV)
    return X, op, idx, S, Z


def _cur_eig_inputs():
    """The draws of ``fast_cur`` (cidx, ridx, Gaussian Sc and Sr) and of
    ``streaming_subspace_eigh`` (Omega)."""
    g = gen(50)
    cidx = torch.randperm(N, generator=g, device=DEV)[:CUR_C]
    ridx = torch.randperm(N, generator=g, device=DEV)[:CUR_R]
    Sc = sk.GaussianSketch.draw(N, CUR_SC, generator=g, device=DEV)
    Sr = sk.GaussianSketch.draw(N, CUR_SR, generator=g, device=DEV)
    Omega = torch.randn((N, EIG_K + 8), generator=gen(60), device=DEV)
    return dict(cidx=cidx, ridx=ridx, Sc=Sc, Sr=Sr), Omega


def _checksum(*tensors) -> list:
    return [float(t.double().sum()) for t in tensors]


def phase_main() -> dict:
    # the reference's count model: a sweep evaluates nblocks · b · n entries
    # (75 panels of 671 rows at n = 50,000: 2,516,250,000)
    block = sweep_lib.resolved_block_size(N, N, None)
    panels = sweep_lib.num_panels(N, N, None)
    fused_entries = panels * block * N
    if N == 50_000:
        check(panels == 75 and block == 671
              and fused_entries == 2_516_250_000,
              f"panel model {panels} x {block}")
    X, op, idx, S, Z = _main_inputs()
    spec = op.inner.spec

    _main_calls(op, idx, S, Z)                      # warm-up
    torch.cuda.synchronize()
    reset_counts()
    times, out = _main_calls(op, idx, S, Z)         # the counted run
    launches = read_counts()
    log(f"main path (n={N}, d={D}, c={C_COLS}, s={S_COLS}, "
        f"probes={PROBES}): times ms {json.dumps(times)}")
    log(f"main path launches {json.dumps(launches)}")
    for k in ("counts_fused", "counts_leverage", "counts_blocked"):
        log(f"main path {k}: {json.dumps(out[k])}")

    cf, cb = out["counts_fused"], out["counts_blocked"]
    check(launches["pairwise_matmat_multi"] > 0 and
          launches["pairwise_block"] > 0, f"a kernel never ran: {launches}")
    check(launches["pairwise_matmat_multi"] == 1,
          f"fast_model_with_error should be one fused launch: {launches}")
    check(cf["sweeps"] == 1 and cf["fused_sweeps"] == 1
          and cf["entries"] == fused_entries and out["route_fused"] == "fused",
          f"fused sweep metering {cf} {out['route_fused']}")
    check(out["counts_leverage"]["columns"] == 1
          and out["counts_leverage"]["blocks"] == 1
          and out["counts_leverage"]["sweeps"] == 0,
          f"leverage path metering {out['counts_leverage']}")
    check(cb["sweeps"] == 1 and cb["panels"] == panels
          and cb["entries"] == fused_entries and out["route_blocked"] == "panel",
          f"blocked error metering {cb} {out['route_blocked']}")
    check(launches["pairwise_block"] == 2 + panels,
          f"block launches {launches['pairwise_block']} != {2 + panels}")
    check(launches["landmark_read"] == 0 and launches["flash_attention"] == 0
          and launches["pairwise_matmat_multi_slab"] == 0,
          f"the SPSD path launched the landmark read, B6 or B4: {launches}")

    apg, apl = out["apg"], out["apl"]
    err_h, err_b = float(out["err_h"]), float(out["err_b"])
    for name, t, shape in (("C", apg.C, (N, C_COLS)), ("U", apg.U,
                           (C_COLS, C_COLS)), ("C_lev", apl.C, (N, C_COLS)),
                           ("U_lev", apl.U, (C_COLS, C_COLS))):
        check(tuple(t.shape) == shape and bool(torch.isfinite(t).all()),
              f"{name}: shape {tuple(t.shape)} or non-finite")
    check(np.isfinite(err_h) and np.isfinite(err_b) and err_b > 0,
          f"errors {err_h} {err_b}")
    check(abs(err_h - err_b) <= 0.5 * err_b,
          f"Hutchinson {err_h:.5f} not within 50% of blocked {err_b:.5f}")
    log(f"main path rel err: hutchinson {err_h:.6f}, blocked {err_b:.6f}")

    # results against the plain versions on 512 sampled rows
    rows = torch.randperm(N, generator=gen(5), device=DEV)[:512]
    K_rows = kernel.pairwise_block_plain(spec, X[rows], X)
    e_c = scaled_err(apg.C[rows], K_rows[:, idx])
    e_cl = scaled_err(apl.C[rows], K_rows[:, idx])
    check(e_c <= TOL_F32 and e_cl <= TOL_F32, f"C rows: {e_c} {e_cl}")
    log(f"main path C rows vs plain: fused {e_c:.3g}, columns {e_cl:.3g}")
    return dict(X=X, spec=spec, idx=idx, S=S, Z=Z, launches=launches,
                times=times, err_h=err_h, err_b=err_b, U=apg.U,
                err_h_tensor=out["err_h"])


def phase_scaling() -> None:
    """Entry counts at the BENCH_pr10 scaling shape (n=3000, c=32, s=128)."""
    X = letters(3000, seed=0)
    op = CountingOperator(RBFKernel(X, sigma=SIGMA, device=DEV))
    ap = spsd.fast_model(op, 32, 128, s_sketch="gaussian", streaming=True,
                         generator=gen(0))
    err = float(spsd.relative_error(op, ap, method="hutchinson", probes=16,
                                    generator=gen(1)))
    separate = op.counts["entries"]
    op.reset()
    _, err_f = spsd.fast_model_with_error(op, 32, 128, s_sketch="gaussian",
                                          probes=16, generator=gen(0))
    fused = op.counts["entries"]
    log(f"scaling n=3000: entries separate {separate:,} fused {fused:,}; "
        f"rel err {err:.5f} / fused {float(err_f):.5f}")
    check(separate == 18_000_000 and fused == 9_000_000,
          f"scaling entries {separate} {fused}")


# ---------------------------------------------------------------------------
# the data-parallel sweep (spsd_sharded)
# ---------------------------------------------------------------------------

def _sync() -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


def _wall_ms(fn):
    """Host milliseconds of ``fn()`` between two synchronizes."""
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return (time.perf_counter() - t0) * 1e3, out


def _sharded_calls(op, idx, S, Z, cur_draws, Omega, mesh):
    """The four sharded calls, each with its own launch and meter counts;
    returns results and per-call records."""
    rec, out = {}, {}

    def run(name, fn):
        op.reset()
        before = read_counts()
        ms, res = _wall_ms(fn)
        rec[name] = {"ms": ms, "launches": {
                         k: v - before[k] for k, v in read_counts().items()},
                     "counts": dict(op.counts), "route": op.last_route,
                     "slab_mode": op.last_slab_mode}
        return res

    out["apg"], out["err_h"] = run(
        "fast_model_with_error", lambda: spsd.fast_model_with_error(
            op, C_COLS, S_COLS, s_sketch="gaussian", probes=PROBES, idx=idx,
            S=S, Z=Z, mesh=mesh))
    out["err_b"] = run("relative_error_blocked", lambda: spsd.relative_error(
        op, out["apg"], method="blocked", mesh=mesh))
    out["cur"] = run("fast_cur", lambda: tcur.fast_cur(
        op, CUR_C, CUR_R, CUR_SC, CUR_SR, sketch_kind="gaussian", mesh=mesh,
        **cur_draws))
    out["eig"] = run("streaming_subspace_eigh",
                     lambda: teig.streaming_subspace_eigh(
                         op, EIG_K, mesh=mesh, Omega=Omega))
    return out, rec


def _sharded_rank(rank: int, world: int, tmpdir: str, cfg: dict) -> None:
    """One rank of ``spsd_sharded``: a gloo group over a ``file://`` store,
    a ("data",) mesh over it, the four calls once to warm up and once
    counted; writes its records, and on rank 0 its results, to ``tmpdir``.
    ``cfg`` carries the parent's configuration (this process imported the
    script afresh)."""
    globals().update(cfg)
    if DEV == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmpdir, 'store')}",
        rank=rank, world_size=world, timeout=datetime.timedelta(minutes=10))
    try:
        mesh = sharding.data_parallel_mesh(DEV)
        X, op, idx, S, Z = _main_inputs()
        cur_draws, Omega = _cur_eig_inputs()
        _sharded_calls(op, idx, S, Z, cur_draws, Omega, mesh)    # warm-up
        dist.barrier()
        reset_counts()
        out, rec = _sharded_calls(op, idx, S, Z, cur_draws, Omega, mesh)
        path_launches = read_counts()
        # the raw fused sweep, outside the counted run
        fused = op.sweep([sweep_lib.ColumnGatherPlan(idx),
                          sweep_lib.MatmulPlan(S.mat),
                          sweep_lib.MatmulPlan(Z)], mesh=mesh)
        # the all-reduce of one rank's carries on its own (n × 1,064 f32)
        buf = torch.randn((N, C_COLS + S_COLS + PROBES), generator=gen(70),
                          device=DEV)
        ar = []
        for _ in range(3):
            dist.barrier()
            ms, _ = _wall_ms(lambda: dist.all_reduce(buf))
            ar.append(ms)
        info = {"rank": rank, "shard": sharding.shard_index(mesh),
                "calls": rec, "path_launches": path_launches,
                "all_reduce_ms": ar, "all_reduce_bytes": buf.numel() * 4,
                "checksums": _checksum(X, idx, S.mat, Z, cur_draws["cidx"],
                                       cur_draws["ridx"], cur_draws["Sc"].mat,
                                       cur_draws["Sr"].mat, Omega)}
        with open(os.path.join(tmpdir, f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
        if rank == 0:
            cpu = {"C": fused[0], "KS": fused[1], "KZ": fused[2],
                   "U": out["apg"].U, "err_h": out["err_h"],
                   "err_b": out["err_b"], "cur_U": out["cur"].U,
                   "eigvals": out["eig"].eigenvalues,
                   "eigvecs": out["eig"].eigenvectors}
            torch.save({k: v.cpu() for k, v in cpu.items()},
                       os.path.join(tmpdir, "rank0.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def phase_spsd_sharded(m: dict) -> dict:
    """The main path as a data-parallel sweep over WORLD ranks on the card,
    checked against the single-device run of ``phase_main``."""
    dp = WORLD
    block = sweep_lib.resolved_block_size(N, N, None, dp)
    panels = sweep_lib.num_panels(N, N, None, dp)
    slab = sweep_lib.local_slab_rows(N, N, None, dp)
    entries = dp * slab * N
    if N == 50_000:
        check(panels == 76 and block == 658 and slab == 25_004
              and entries == 2_500_400_000,
              f"sharded panel model {panels} x {block}, slab {slab}")
    cfg = {k: globals()[k] for k in ("DEV", "N", "C_COLS", "S_COLS",
                                     "PROBES", "CUR_C", "CUR_R", "CUR_SC",
                                     "CUR_SR", "EIG_K")}
    import torch.multiprocessing as mp
    tmpdir = tempfile.mkdtemp(prefix="spsd_sharded_")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # a failed rank raises here (ProcessRaisedException) and ends the script
    mp.spawn(_sharded_rank, args=(dp, tmpdir, cfg), nprocs=dp, join=True)
    spawn_s = time.perf_counter() - t0
    infos = []
    for r in range(dp):
        with open(os.path.join(tmpdir, f"rank{r}.json")) as f:
            infos.append(json.load(f))
    got = torch.load(os.path.join(tmpdir, "rank0.pt"))
    for name in os.listdir(tmpdir):
        os.remove(os.path.join(tmpdir, name))
    os.rmdir(tmpdir)

    X, idx, S, Z = m["X"], m["idx"], m["S"], m["Z"]
    cur_draws, Omega = _cur_eig_inputs()
    mine = _checksum(X, idx, S.mat, Z, cur_draws["cidx"], cur_draws["ridx"],
                     cur_draws["Sc"].mat, cur_draws["Sr"].mat, Omega)
    for info in infos:
        check(info["checksums"] == mine,
              f"rank {info['rank']} drew other inputs than the parent")
    log(f"spsd_sharded: {dp} ranks on one card, spawn + run {spawn_s:.1f} s;"
        f" per sweep {panels} panels of {block} rows, slab {slab} rows")
    shards = sorted(info["shard"] for info in infos)
    check(shards == list(range(dp)), f"shard indices {shards}")
    for info in infos:
        calls = info["calls"]
        log(f"spsd_sharded rank {info['rank']}: " + json.dumps(
            {k: {"ms": round(v["ms"], 3), "launches": v["launches"],
                 "counts": v["counts"], "route": v["route"],
                 "slab_mode": v["slab_mode"]} for k, v in calls.items()}))
        log(f"spsd_sharded rank {info['rank']}: path launches "
            f"{json.dumps(info['path_launches'])}, all-reduce of "
            f"{info['all_reduce_bytes'] / 1e6:.1f} MB: "
            + ", ".join(f"{t:.1f}" for t in info["all_reduce_ms"]) + " ms")
        fm = calls["fast_model_with_error"]
        check(fm["route"] == "fused_sharded" and fm["slab_mode"] == "prefetch",
              f"rank {info['rank']}: route {fm['route']} {fm['slab_mode']}")
        check(fm["launches"] == no_launches(pairwise_matmat_multi_slab=1),
              f"rank {info['rank']}: the fused sweep should be one B4 and no "
              f"B1 launch: {fm['launches']}")
        check(fm["counts"]["sweeps"] == 1 and fm["counts"]["fused_sweeps"] == 1
              and fm["counts"]["panels"] == panels
              and fm["counts"]["entries"] == entries,
              f"rank {info['rank']}: fused meter {fm['counts']}")
        rb = calls["relative_error_blocked"]
        check(rb["route"] == "panel" and rb["counts"]["panels"] == panels
              and rb["counts"]["entries"] == entries
              and rb["launches"] == no_launches(
                  pairwise_block=slab // block),
              f"rank {info['rank']}: blocked error {rb}")
        for name in ("fast_cur", "streaming_subspace_eigh"):
            c = calls[name]
            check(c["route"] == "fused_sharded"
                  and c["launches"]["pairwise_matmat_multi"] == 0
                  and c["launches"]["pairwise_matmat_multi_slab"]
                  == c["counts"]["fused_sweeps"] > 0,
                  f"rank {info['rank']}: {name} {c}")
    # the fused outputs against the single-device fused route, bit for bit
    op1 = RBFKernel(X, sigma=SIGMA, device=DEV)
    single = op1.sweep([sweep_lib.ColumnGatherPlan(idx),
                        sweep_lib.MatmulPlan(S.mat), sweep_lib.MatmulPlan(Z)])
    same = {k: torch.equal(got[k].to(DEV), t)
            for k, t in zip(("C", "KS", "KZ"), single)}
    same["U"] = torch.equal(got["U"].to(DEV), m["U"])
    same["err_h"] = float(got["err_h"]) == m["err_h"]
    log(f"spsd_sharded fused outputs bit for bit equal to the single-device "
        f"run: {json.dumps(same)}")
    check(all(same.values()), f"sharded fused outputs differ: {same}")
    del single
    err_b = float(got["err_b"])
    e_rel = abs(err_b - m["err_b"]) / m["err_b"]
    check(e_rel <= TOL_SHARDED_ERR, f"blocked error {err_b} vs {m['err_b']}")
    # CUR and the eigensolver, unsharded in this process
    cur1 = tcur.fast_cur(op1, CUR_C, CUR_R, CUR_SC, CUR_SR,
                         sketch_kind="gaussian", **cur_draws)
    e_cur = scaled_err(got["cur_U"].to(DEV), cur1.U)
    check(e_cur <= TOL_F32, f"fast_cur U sharded vs unsharded: {e_cur:.3g}")
    eig1 = teig.streaming_subspace_eigh(op1, EIG_K, Omega=Omega)
    lam = got["eigvals"].to(DEV)
    e_lam = float(((lam - eig1.eigenvalues).abs()
                   / eig1.eigenvalues.abs()).max())
    mis = float(teig.misalignment(eig1.eigenvectors,
                                  got["eigvecs"].to(DEV)))
    check(e_lam <= TOL_EIG and mis <= TOL_MISALIGN,
          f"eigenpairs: eigenvalues {e_lam:.3g}, misalignment {mis:.3g}")
    log(f"spsd_sharded: blocked error {err_b:.6f} vs {m['err_b']:.6f} "
        f"(rel {e_rel:.3g}); fast_cur U vs unsharded {e_cur:.3g}; "
        f"eigenvalues rel {e_lam:.3g}, misalignment {mis:.3g}; top "
        f"eigenvalue {float(lam[0]):.3f}")
    return {"infos": infos, "launches": infos[0]["path_launches"],
            "panels": panels, "block": block, "slab": slab,
            "entries": entries, "spawn_s": spawn_s, "err_b": err_b,
            "err_b_rel": e_rel, "cur_U_err": e_cur, "eig_rel": e_lam,
            "misalignment": mis}


def _b4_line(m: dict, sh: dict) -> dict:
    """B4 at rank 1's slab of the sharded main path (its last rows are clamp
    padding), against its plain version (a 5 GB slab panel) and B1's rows."""
    X, spec = m["X"], m["spec"]
    Vs = (sweep_lib.one_hot_columns(m["idx"], N, DEV), m["S"].mat, m["Z"])
    start, length = sh["slab"], sh["slab"]
    ms, outs = cuda_ms(lambda: kernel.pairwise_matmat_multi_slab_cuda(
        spec, X, start, length, Vs), reps=2, warmup=1)
    out = torch.cat(outs, dim=1)
    del outs
    plain_ms, plain = cuda_ms(lambda: torch.cat(
        kernel.pairwise_matmat_multi_slab_plain(spec, X, start, length, Vs),
        dim=1), warmup=1)
    err = float((out - plain).abs().max())
    rel = err / float(plain.abs().max())
    del plain
    check(rel <= TOL_F32_MAIN, f"B4 slab shape vs plain: {rel:.3g}")
    full = torch.cat(kernel.pairwise_matmat_multi_cuda(spec, X, X, Vs), dim=1)
    rows = kernel.slab_rows(N, start, length, DEV)
    same = torch.equal(out, full[rows])
    check(same, "B4 rows differ from B1's rows")
    del full
    M = sum(int(V.shape[1]) for V in Vs)
    flops = 2 * length * N * M + 2 * D * length * N
    nbytes = 4 * (N * D + N * M + length * M)
    bound_fp32 = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    bound, bound_by = route_bound(spec, length, N, D, M, nbytes)
    builds = int(pw_build.load_library().pairwise_statistic_builds(M))
    design_floor, _ = route_bound(spec, length, N, D, M, nbytes, builds)
    p = passes(spec)
    scratch = scratch_bytes(spec, length, N, D, M, False)
    log(f"B4 slab shape ({length} x {N} from row {start}, M = {M}): "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.3f} ms on the "
        f"TF32 tensor cores ({p['contraction']} contraction + "
        f"{p['statistic']} statistic passes; {bound / ms:.1%} of it; "
        f"{builds} statistic builds: design floor {design_floor:.3f} ms; "
        f"FP32 roof {bound_fp32:.3f} ms), scratch {scratch / 1e6:.1f} MB; "
        f"vs plain {rel:.3g} (max abs {err:.3g}); rows = B1's bit for bit: "
        f"{same}")
    return {"name": "pairwise_matmat_multi_slab", "route": "cuda",
            "source": "src/repro_torch/kernels/pairwise/csrc/pairwise_wgmma.cu",
            "replaces": "src/repro/kernels/pairwise/kernel.py:184",
            "launches": sh["launches"]["pairwise_matmat_multi_slab"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "library_call": "none (no single torch call computes it)",
            "shape": {"start_row": start, "slab_len": length, "n": N,
                      "d": D, "M": M, "spec": "rbf", "precision": "f32"},
            "rows_equal_b1": same, "scaled_err_vs_plain": rel,
            "bound_ms_fp32": bound_fp32,
            "contraction_passes": p["contraction"],
            "statistic_passes": p["statistic"], "statistic_builds": builds,
            "design_floor_ms": design_floor, "scratch_bytes": scratch,
            "roofline": work_roofline(spec, length, N, D, M, ms)}


def _b1_line(m: dict) -> dict:
    """B1 at the main shape: kernel, plain version (row slabs), bound."""
    X, spec = m["X"], m["spec"]
    Vs = (sweep_lib.one_hot_columns(m["idx"], N, DEV), m["S"].mat, m["Z"])
    ms, outs = cuda_ms(
        lambda: kernel.pairwise_matmat_multi_cuda(spec, X, X, Vs), reps=2)
    out = torch.cat(outs, dim=1)
    del outs
    slab = 5000
    plain = torch.empty_like(out)

    def run_plain():
        for r0 in range(0, N, slab):
            plain[r0:r0 + slab] = torch.cat(kernel.pairwise_matmat_multi_plain(
                spec, X[r0:r0 + slab], X, Vs), dim=1)
        return plain

    plain_ms, _ = cuda_ms(run_plain, warmup=1)
    err = float((out - plain).abs().max())
    rel = err / float(plain.abs().max())
    # the plain version's f32 entries contracted in f64
    V64 = torch.cat(Vs, dim=1).double()
    err_k = err_p = scale = 0.0
    for r0 in range(0, N, slab):
        exact = kernel.pairwise_block_plain(spec, X[r0:r0 + slab], X).double() \
            @ V64
        err_k = max(err_k, float((out[r0:r0 + slab] - exact).abs().max()))
        err_p = max(err_p, float((plain[r0:r0 + slab] - exact).abs().max()))
        scale = max(scale, float(exact.abs().max()))
    del V64, exact
    log(f"B1 main shape: vs plain {rel:.3g} (max abs {err:.3g}); vs the f64 "
        f"contraction: kernel {err_k / scale:.3g}, plain {err_p / scale:.3g}")
    check(err_k / scale <= TOL_F32, f"B1 vs f64 contraction {err_k / scale}")
    check(rel <= TOL_F32_MAIN, f"B1 main shape vs plain: {rel:.3g}")

    spec16 = spec.with_precision("bf16_f32acc")
    ms16, outs16 = cuda_ms(
        lambda: kernel.pairwise_matmat_multi_cuda(spec16, X, X, Vs), warmup=1)
    rows = torch.arange(0, N, N // 512, device=DEV)[:512]
    plain16 = kernel.pairwise_matmat_multi_plain(spec16, X[rows], X, Vs)
    e16 = max(scaled_err(o[rows], p) for o, p in zip(outs16, plain16))
    check(e16 <= TOL_BF16_SAME, f"B1 bf16_f32acc rows vs plain: {e16:.3g}")
    del outs16, plain16
    # the l1dist statistic inside B1 (laplacian, the same inputs)
    lap = specs.suggested_spec("laplacian", D)
    ms_l1, outs_l1 = cuda_ms(
        lambda: kernel.pairwise_matmat_multi_cuda(lap, X, X, Vs), warmup=1)
    plain_l1 = kernel.pairwise_matmat_multi_plain(lap, X[rows], X, Vs)
    e_l1 = max(scaled_err(o[rows], p) for o, p in zip(outs_l1, plain_l1))
    check(e_l1 <= TOL_F32_MAIN, f"B1 laplacian rows vs plain: {e_l1:.3g}")
    del outs_l1, plain_l1

    def run_plain_l1():
        for r0 in range(0, N, slab):
            plain[r0:r0 + slab] = torch.cat(kernel.pairwise_matmat_multi_plain(
                lap, X[r0:r0 + slab], X, Vs), dim=1)
        return plain

    plain_ms_l1, _ = cuda_ms(run_plain_l1, warmup=1)
    # the softmax Gram of sketched attention (exp_affine) on the same inputs
    soft = tsa.softmax_gram_operator(X).spec
    ms_soft, outs_s = cuda_ms(
        lambda: kernel.pairwise_matmat_multi_cuda(soft, X, X, Vs), warmup=1)
    plain_s = kernel.pairwise_matmat_multi_plain(soft, X[rows], X, Vs)
    e_s = max(scaled_err(o[rows], p) for o, p in zip(outs_s, plain_s))
    check(e_s <= TOL_F32_MAIN, f"B1 exp_affine rows vs plain: {e_s:.3g}")
    del outs_s, plain_s

    M = sum(int(V.shape[1]) for V in Vs)
    flops = 2 * N * N * M + 2 * D * N * N
    nbytes = 4 * (2 * N * D + N * M + N * M)
    bound_fp32 = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    bound, bound_by = route_bound(spec, N, N, D, M, nbytes)
    bound_bf16, _ = route_bound(spec16, N, N, D, M, nbytes)
    bound_l1, _ = route_bound(lap, N, N, D, M, nbytes)
    builds = int(pw_build.load_library().pairwise_statistic_builds(M))
    design_floor, _ = route_bound(spec, N, N, D, M, nbytes, builds)
    p, p16 = passes(spec), passes(spec16)
    scratch = scratch_bytes(spec, N, N, D, M, True)
    scratch16 = scratch_bytes(spec16, N, N, D, M, True)
    log(f"B1 main shape: {p['contraction']} TF32 contraction passes + "
        f"{p['statistic']} statistic passes: bound {bound:.3f} ms; x "
        f"{builds} statistic builds: design floor {design_floor:.3f} ms; "
        f"FP32 roof {bound_fp32:.3f} ms; scratch {scratch / 1e6:.1f} MB "
        f"(bf16_f32acc {scratch16 / 1e6:.1f} MB, {p16['contraction']} + "
        f"{p16['statistic']} bf16 passes)")
    log(f"B1 main shape: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s of useful work, "
        f"{bound / ms:.1%} of the bound); bf16_f32acc {ms16:.3f} ms "
        f"(tensor-core bound {bound_bf16:.3f} ms, rows vs plain {e16:.3g}); "
        f"laplacian (l1dist) {ms_l1:.3f} ms (rows vs plain {e_l1:.3g}, "
        f"plain {plain_ms_l1:.3f} ms, bound {bound_l1:.3f} ms); softmax "
        f"Gram (exp_affine) {ms_soft:.3f} ms (rows vs plain {e_s:.3g})")
    return {"name": "pairwise_matmat_multi", "route": "cuda",
            "source": "src/repro_torch/kernels/pairwise/csrc/pairwise_wgmma.cu",
            "replaces": "src/repro/kernels/pairwise/kernel.py:127",
            "launches": m["launches"]["pairwise_matmat_multi"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None,
            "shape": {"nr": N, "nc": N, "d": D, "M": M, "spec": "rbf",
                      "precision": "f32"},
            "scaled_err_vs_f64_contraction": err_k / scale,
            "ms_bf16_f32acc": ms16, "ms_laplacian_l1dist": ms_l1,
            "plain_ms_laplacian_l1dist": plain_ms_l1,
            "bound_ms_laplacian_l1dist": bound_l1,
            "ms_exp_affine": ms_soft,
            "bound_ms_fp32": bound_fp32,
            "bound_ms_bf16_tensor_cores": bound_bf16,
            "contraction_passes": p["contraction"],
            "statistic_passes": p["statistic"],
            "passes_bf16_f32acc": p16, "statistic_builds": builds,
            "design_floor_ms": design_floor, "scratch_bytes": scratch,
            "scratch_bytes_bf16_f32acc": scratch16,
            "roofline": work_roofline(spec, N, N, D, M, ms),
            "roofline_bf16_f32acc": work_roofline(spec16, N, N, D, M, ms16),
            "roofline_laplacian_l1dist": work_roofline(lap, N, N, D, M,
                                                       ms_l1)}


def _b2_line(m: dict) -> dict:
    """B2 at the panel shape of the blocked error (671 × 50,000).  The
    library yardstick ``torch.mm(Xr, Xc.T)`` computes the linear spec, so
    B2 is also timed under the linear spec at that panel: like for like,
    ``linear_spec_ms`` against ``library_ms``."""
    X, spec = m["X"], m["spec"]
    b = sweep_lib.resolved_block_size(N, N, None)
    Xr = X[:b].contiguous()
    ms, out = cuda_ms(lambda: kernel.pairwise_block_cuda(spec, Xr, X),
                      reps=20, warmup=2)
    plain_ms, plain = cuda_ms(
        lambda: kernel.pairwise_block_plain(spec, Xr, X), reps=5, warmup=1)
    err = float((out - plain).abs().max())
    check(scaled_err(out, plain) <= TOL_F32, f"B2 panel vs plain: {err:.3g}")
    # the main path's other two B2 shapes: C = K[:, idx] and the
    # (s + c)² SᵀKS block of the leverage sketch
    Xs = X[m["idx"]]
    Xb = X[:S_COLS + C_COLS].contiguous()
    for Xa, Xz, what in ((X, Xs, "columns"), (Xb, Xb, "sketch block")):
        e = scaled_err(kernel.pairwise_block_cuda(spec, Xa, Xz),
                       kernel.pairwise_block_plain(spec, Xa, Xz))
        check(e <= TOL_F32, f"B2 {what} vs plain: {e:.3g}")
    lap = specs.suggested_spec("laplacian", D)
    ms_l1, out_l1 = cuda_ms(
        lambda: kernel.pairwise_block_cuda(lap, Xr, X), reps=5, warmup=1)
    plain_ms_l1, plain_l1 = cuda_ms(
        lambda: kernel.pairwise_block_plain(lap, Xr, X), reps=5, warmup=1)
    check(scaled_err(out_l1, plain_l1) <= TOL_F32, "B2 laplacian vs plain")
    bound_l1, _ = route_bound(lap, b, N, D, 0, 4 * (b * D + N * D + b * N))
    # like for like, each timed over 20 back-to-back calls after 2 warm-ups
    # (at ~0.07 ms a call, 5 calls left the two within each other's spread)
    lin = specs.linear()
    lin_ms, lin_out = cuda_ms(
        lambda: kernel.pairwise_block_cuda(lin, Xr, X), reps=20, warmup=2)
    lib_ms, lib_out = cuda_ms(lambda: torch.mm(Xr, X.T), reps=20, warmup=2)
    check(scaled_err(lin_out, lib_out) <= TOL_F32, "B2 linear vs torch.mm")
    # device time alone, kernel by kernel (B2's call is its prep kernel and
    # the block kernel)
    dev_lin = _kernel_device_ms(lambda: kernel.pairwise_block_cuda(lin, Xr, X))
    dev_lib = _kernel_device_ms(lambda: torch.mm(Xr, X.T))
    log(f"B2 linear spec, device ms by kernel: {json.dumps(dev_lin)}; "
        f"torch.mm: {json.dumps(dev_lib)}")
    # the operation-bound case: the softmax Gram (exp_affine) at the
    # attention_policy panel, 1,024 x 32,768, d = 256
    _, Ka, _ = _qkv(POLICY_N, seed=21)
    soft = tsa.softmax_gram_operator(Ka).spec
    bs = sweep_lib.resolved_block_size(POLICY_N, POLICY_N, None)
    Kr = Ka[:bs].contiguous()
    ms_s, out_s = cuda_ms(lambda: kernel.pairwise_block_cuda(soft, Kr, Ka),
                          reps=5, warmup=1)
    plain_ms_s, plain_s = cuda_ms(
        lambda: kernel.pairwise_block_plain(soft, Kr, Ka), reps=5, warmup=1)
    e_s = scaled_err(out_s, plain_s)
    check(e_s <= TOL_F32, f"B2 exp_affine panel vs plain: {e_s:.3g}")
    del out_s, plain_s, Ka, Kr
    flops_s = 2 * ATT_D * bs * POLICY_N
    nbytes_s = 4 * (bs * ATT_D + POLICY_N * ATT_D + bs * POLICY_N)
    bound_s_fp32 = max(flops_s / PEAK_FP32_FLOPS,
                       nbytes_s / PEAK_HBM_BYTES) * 1e3
    bound_s, by_s = route_bound(soft, bs, POLICY_N, ATT_D, 0, nbytes_s)
    log(f"B2 exp_affine panel ({bs} x {POLICY_N}, d = {ATT_D}): {ms_s:.4f} "
        f"ms, plain {plain_ms_s:.4f} ms, bound {bound_s:.4f} ms ({by_s}, "
        f"{passes(soft)['statistic']} TF32 passes; FP32 roof "
        f"{bound_s_fp32:.4f} ms), "
        f"vs plain {e_s:.3g}")
    flops = 2 * D * b * N
    nbytes = 4 * (b * D + N * D + b * N)
    bound_fp32 = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    bound, bound_by = route_bound(spec, b, N, D, 0, nbytes)
    log(f"B2 panel shape ({b} x {N}): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound:.4f} ms ({bound_by}); like for like, the linear spec "
        f"{lin_ms:.4f} "
        f"ms vs torch.mm {lib_ms:.4f} ms ({lin_ms / lib_ms:.2f}x); "
        f"laplacian (l1dist) {ms_l1:.4f} ms (plain "
        f"{plain_ms_l1:.4f} ms, bound {bound_l1:.4f} ms), max abs err "
        f"{err:.3g}")
    return {"name": "pairwise_block", "route": "cuda",
            "source": "src/repro_torch/kernels/pairwise/csrc/pairwise_wgmma.cu",
            "replaces": "src/repro/kernels/pairwise/kernel.py:241",
            "launches": m["launches"]["pairwise_block"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
            "shape": {"nr": b, "nc": N, "d": D, "spec": "rbf",
                      "precision": "f32"},
            "bound_ms_fp32": bound_fp32,
            "library_call": "torch.mm(Xr, Xc.T) (the linear spec: compare "
                            "with linear_spec_ms)",
            "linear_spec_ms": lin_ms,
            "linear_spec_over_library": lin_ms / lib_ms,
            "device_ms_linear": dev_lin, "device_ms_library": dev_lib,
            "ms_laplacian_l1dist": ms_l1,
            "plain_ms_laplacian_l1dist": plain_ms_l1,
            "bound_ms_laplacian_l1dist": bound_l1,
            "ms_exp_affine": ms_s, "plain_ms_exp_affine": plain_ms_s,
            "bound_ms_exp_affine": bound_s,
            "bound_ms_exp_affine_fp32": bound_s_fp32,
            "exp_affine_shape": {"nr": bs, "nc": POLICY_N, "d": ATT_D,
                                 "spec": "softmax_gram (exp_affine)"},
            "statistic_passes": passes(spec)["statistic"],
            "scratch_bytes": scratch_bytes(spec, b, N, D, 0, False),
            "roofline": work_roofline(spec, b, N, D, 0, ms),
            "roofline_laplacian_l1dist": work_roofline(lap, b, N, D, 0,
                                                       ms_l1)}


# ---------------------------------------------------------------------------
# sketched attention
# ---------------------------------------------------------------------------

def _qkv(n: int, seed: int):
    """The workloads bench's law: q, k ~ 0.4·N(0, 1), v ~ N(0, 1)."""
    g = gen(seed)
    Q = torch.randn((n, ATT_D), generator=g, device=DEV) * 0.4
    K = torch.randn((n, ATT_D), generator=g, device=DEV) * 0.4
    V = torch.randn((n, ATT_D), generator=g, device=DEV)
    return Q, K, V


def _exact_rows(Q, K, V, rows):
    """Exact softmax attention of the queries ``rows``, in chunks."""
    out = []
    inv = 1.0 / float(np.sqrt(ATT_D))
    for r0 in range(0, rows.shape[0], ATT_ERR_CHUNK):
        w = torch.softmax((Q[rows[r0:r0 + ATT_ERR_CHUNK]] @ K.T) * inv, dim=-1)
        out.append(w @ V)
    return torch.cat(out)


def rel_err(out, exact) -> float:
    return float((out - exact).norm() / exact.norm())


def _read_f64(Q, kl, UV, U1, off):
    """The landmark read in f64 (same formula as the plain version)."""
    inv = 1.0 / float(np.sqrt(Q.shape[1]))
    cvec = torch.exp((Q.double() @ kl.double().T) * inv - off.double())
    den = cvec @ U1.double()
    den = torch.where(den < 0, -1.0, 1.0).double() * den.abs().clamp_min(1e-6)
    return (cvec @ UV.double()) / den[:, None]


def _attention_calls(Q, K, V, Qd):
    """The five attention_long calls, each timed; returns times, outputs."""
    times, out = {}, {}
    times["build_landmark_state"], st = cuda_ms(
        lambda: tsa.build_landmark_state(K, V, ATT_C, ATT_THETA,
                                         generator=gen(12), device=DEV))
    out["state"] = st
    times["landmark_read"], out["read"] = cuda_ms(
        lambda: lm_ops.landmark_read(Q, st.k_land, st.UV, st.U1, st.scale))
    times["landmark_read_decode"], out["decode"] = cuda_ms(
        lambda: lm_ops.landmark_read(Qd, st.k_land, st.UV, st.U1, st.scale))
    for mode in ("fast", "nystrom"):
        times[f"sketched_attention_{mode}"], out[mode] = cuda_ms(
            lambda: tsa.sketched_attention(Q, K, V, ATT_C, ATT_THETA,
                                           mode=mode, generator=gen(13),
                                           device=DEV))
    return times, out


def phase_attention_long() -> dict:
    n = ATT_N
    Q, K, V = _qkv(n, seed=11)
    Qd = Q[:ATT_DECODE_M].contiguous()
    _attention_calls(Q, K, V, Qd)                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, out = _attention_calls(Q, K, V, Qd)      # the counted run
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"attention_long (n={n}, D={ATT_D}, c={ATT_C}, theta={ATT_THETA}, "
        f"strided, f32): times ms {json.dumps(times)}")
    log(f"attention_long launches {json.dumps(launches)}, peak memory "
        f"{peak_gb:.2f} GB")
    check(launches == no_launches(landmark_read=2, landmark_read_tc=1,
                                  landmark_read_split=1),
          f"the path should launch B5 twice (one read over all n queries on "
          f"the tensor cores, one decode read split across the landmarks) "
          f"and no pairwise kernel: {launches}")
    st = out["state"]
    for name, t, shape in (("read", out["read"], (n, ATT_D)),
                           ("decode", out["decode"], (ATT_DECODE_M, ATT_D)),
                           ("fast", out["fast"], (n, ATT_D)),
                           ("nystrom", out["nystrom"], (n, ATT_D)),
                           ("UV", st.UV, (ATT_C, ATT_D)),
                           ("U1", st.U1, (ATT_C,))):
        check(tuple(t.shape) == shape and bool(torch.isfinite(t).all()),
              f"attention_long {name}: shape {tuple(t.shape)} or non-finite")

    rows = torch.randperm(n, generator=gen(14), device=DEV)[:ATT_ERR_ROWS]
    exact = _exact_rows(Q, K, V, rows)
    errs = {k: rel_err(out[k][rows], exact) for k in ("fast", "nystrom",
                                                      "read")}
    log(f"attention_long rel err vs exact softmax attention ({ATT_ERR_ROWS} "
        f"rows): fast {errs['fast']:.6f}, nystrom {errs['nystrom']:.6f}, "
        f"landmark read {errs['read']:.6f}")
    check(errs["fast"] <= errs["nystrom"] + 1e-3,
          f"fast {errs['fast']:.5f} > nystrom {errs['nystrom']:.5f} + 1e-3")

    # B5 at the main shape against its plain version (the tensor-core
    # route), twice bit for bit
    args = (Q, st.k_land, st.UV, st.U1, st.scale.reshape(1))
    ms, got = cuda_ms(lambda: lm_kernel.landmark_read_cuda(*args), reps=5,
                      warmup=1)
    again = _one_read("tc", lambda: lm_kernel.landmark_read_cuda(*args))
    check(torch.equal(again, got), "B5 main shape: two calls differ")
    del again
    plain_ms, plain = cuda_ms(lambda: lm_kernel.landmark_read_plain(*args),
                              reps=3, warmup=1)
    err = float((got - plain).abs().max())
    rel = scaled_err(got, plain)
    sub = slice(0, 4096)
    exact64 = _read_f64(Q[sub], *args[1:])
    e64_k = scaled_err(got[sub].double(), exact64)
    e64_p = scaled_err(plain[sub].double(), exact64)
    check(rel <= TOL_F32, f"B5 main shape vs plain: {rel:.3g} > {TOL_F32}")
    del plain
    # bf16 inputs at the main shape
    args16 = (Q.bfloat16(), st.k_land.bfloat16(), st.UV.bfloat16(),
              *args[3:])
    ms16, got16 = cuda_ms(lambda: lm_kernel.landmark_read_cuda(*args16),
                          reps=5, warmup=1)
    again16 = _one_read("tc", lambda: lm_kernel.landmark_read_cuda(*args16))
    check(torch.equal(again16, got16), "B5 main shape bf16: two calls differ")
    rel16 = _check_read(got16, lm_kernel.landmark_read_plain(*args16),
                        "B5 main shape bf16")
    del args16, got16, again16
    # the decode shape (the split route: two launches a read): the path's
    # own read and the timed one, twice bit for bit, the sign flip exact
    ms_dec, got_dec = cuda_ms(lambda: lm_kernel.landmark_read_cuda(
        Qd, *args[1:]), reps=50, warmup=5)
    again_dec = _one_read("split", lambda: lm_kernel.landmark_read_cuda(
        Qd, *args[1:]))
    check(torch.equal(again_dec, got_dec), "B5 decode: two calls differ")
    flip_dec = lm_kernel.landmark_read_cuda(Qd, *args[1:3], -args[3],
                                            args[4])
    check(torch.equal(flip_dec, -got_dec), "B5 decode: U1 flip not exact")
    plain_dec = lm_kernel.landmark_read_plain(Qd, *args[1:])
    rel_dec = max(_check_read(got_dec, plain_dec, "B5 decode shape"),
                  _check_read(out["decode"], plain_dec, "B5 decode (path)"))
    ms_dec16, _ = cuda_ms(lambda: lm_kernel.landmark_read_cuda(
        Qd.bfloat16(), args[1].bfloat16(), args[2].bfloat16(), *args[3:]),
        reps=50, warmup=5)
    # landmark_decode over every query: one read through the entry point
    ms_decode_all, _ = cuda_ms(lambda: tsa.landmark_decode(st, Q), reps=3,
                               warmup=1)
    # where the routes cross: both timed at growing query counts
    crossover = {}
    for mq in READ_ROUTE_M:
        crossover[mq] = {r: cuda_ms(lambda: lm_kernel.landmark_read_cuda(
            Q[:mq], *args[1:], route=r), reps=20, warmup=2)[0]
            for r in lm_kernel.ROUTES}
    # device time by kernel (torch.profiler), apart from the host's share
    dev = {"main": _kernel_device_ms(
               lambda: lm_kernel.landmark_read_cuda(*args), reps=3),
           "main_bf16": _kernel_device_ms(
               lambda: lm_kernel.landmark_read_cuda(
                   Q.bfloat16(), args[1].bfloat16(), args[2].bfloat16(),
                   *args[3:]), reps=3),
           "decode": _kernel_device_ms(
               lambda: lm_kernel.landmark_read_cuda(Qd, *args[1:]),
               reps=20)}
    log("B5 device ms by kernel: " + json.dumps(dev))
    m, c, d, dv = n, ATT_C, ATT_D, ATT_D
    b32 = _read_bound(m, c, d, dv, "tc", bf16=False)
    b16 = _read_bound(m, c, d, dv, "tc", bf16=True)
    bdec = _read_bound(ATT_DECODE_M, c, d, dv, "split", bf16=False)
    flops = 2 * m * c * (d + dv + 1)
    log(f"B5 main shape (m={m}, c={c}, d={d}, dv={dv}), tensor cores: "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b32['bound_ms']:.3f}"
        f" ms ({b32['bound_by']}; {b32['passes']}; the design's floor "
        f"{b32['floor_ms']:.3f}, the FP32 roof {b32['bound_ms_fp32']:.3f}), "
        f"{flops / ms / 1e9:.1f} TFLOP/s of the work; vs plain {rel:.3g} "
        f"(max abs {err:.3g}); vs f64 on {sub.stop} rows: kernel "
        f"{e64_k:.3g}, plain {e64_p:.3g}; bf16 inputs {ms16:.3f} ms (bound "
        f"{b16['bound_ms']:.3f}, {b16['bound_by']}; vs plain {rel16:.3g}); "
        f"decode (m={ATT_DECODE_M}, split) {ms_dec:.4f} ms, bf16 "
        f"{ms_dec16:.4f} (bound {bdec['bound_ms']:.5f} ms, "
        f"{bdec['bound_by']}; vs plain {rel_dec:.3g}); landmark_decode over "
        f"all queries {ms_decode_all:.3f} ms; repeat calls bit-equal")
    log("B5 routes by query count (ms, tc / split): " + ", ".join(
        f"m={k}: {v['tc']:.4f} / {v['split']:.4f}"
        for k, v in crossover.items()))
    src = "src/repro_torch/kernels/landmark_attention/csrc/"
    line = {"name": "landmark_read", "route": "cuda",
            "source": src + "landmark_wgmma.cu",
            "split_source": src + "landmark_split.cu",
            "replaces": "src/repro/kernels/landmark_attention/kernel.py:49",
            "launches": launches["landmark_read"],
            "launches_tc": launches["landmark_read_tc"],
            "launches_split": launches["landmark_read_split"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b32["bound_ms"], "bound_by": b32["bound_by"],
            "library_ms": None,
            "library_call": "none (no single PyTorch call computes it)",
            "shape": {"m": m, "c": c, "d": d, "dv": dv, "dtype": "float32"},
            "scaled_err_vs_plain": rel, "scaled_err_vs_f64": e64_k,
            "plain_scaled_err_vs_f64": e64_p,
            "ms_bf16": ms16, "scaled_err_bf16_vs_plain": rel16,
            "ms_decode": ms_dec, "ms_decode_bf16": ms_dec16,
            "kernels_per_decode_read": len(dev["decode"]) or None,
            "bound_ms_decode": bdec["bound_ms"],
            "scaled_err_decode_vs_plain": rel_dec,
            "decode_shape": {"m": ATT_DECODE_M, "c": c, "d": d, "dv": dv},
            "ms_landmark_decode_all_queries": ms_decode_all,
            "by_shape": {
                k: {**b, "ms": t, "device_ms": sum(dev[k].values()) or None,
                    "device_ms_by_kernel": dev[k]}
                for k, b, t in (("main", b32, ms), ("main_bf16", b16, ms16),
                                ("decode", bdec, ms_dec))},
            "route_ms_by_m": crossover}
    return dict(times=times, errs=errs, launches=launches, line=line,
                peak_gb=peak_gb)


def _one_read(route: str, fn) -> torch.Tensor:
    """One call of ``fn``, checked to have launched one read on ``route``."""
    key = f"landmark_read_{route}"
    c0 = lm_kernel.launch_counts()[key]
    out = fn()
    check(lm_kernel.launch_counts()[key] == c0 + 1,
          f"the read did not take the {route} route")
    return out


def _read_bound(m: int, c: int, d: int, dv: int, route: str,
                bf16: bool) -> dict:
    """B5's least time on ``route``: the tensor-core passes the built
    library reports (``landmark_passes``) at the TF32 or bf16 rate, the
    denominator's FMAs on the FP32 cores beside them, or the split route's
    FP32 FMAs; against the bytes (each input read once, the output written
    once).  ``floor_ms`` counts the scores as often as the route builds
    them (once per 128-column chunk of UV on the tensor cores, per 64-column
    slice on the split route); ``bound_ms_fp32`` is the FP32-core roof."""
    es = 2 if bf16 else 4
    nbytes = es * (m * d + c * d + c * dv + m * dv) + 4 * c
    t_bytes = nbytes / PEAK_HBM_BYTES
    fp32 = 2 * m * c * (d + dv + 1) / PEAK_FP32_FLOPS
    if route == "tc":
        ps = lm_kernel.landmark_passes(bf16, "scores")
        pv = lm_kernel.landmark_passes(bf16, "values")
        peak = PEAK_BF16_TC_FLOPS if bf16 else PEAK_TF32_TC_FLOPS
        den = 2 * m * c / PEAK_FP32_FLOPS
        ops = max(2 * m * c * (d * ps + dv * pv) / peak, den)
        builds = -(-dv // lm_kernel.TC_COLS)
        floor = max(2 * m * c * (d * ps * builds + dv * pv) / peak, den)
        passes = {"scores": ps, "values": pv}
    else:
        ops = fp32
        builds = -(-dv // lm_kernel.SPLIT_COLS)
        floor = 2 * m * c * (d * builds + dv + 1) / PEAK_FP32_FLOPS
        passes = {"scores": 0, "values": 0}
    return {"route": route, "passes": passes,
            "bound_ms": max(ops, t_bytes) * 1e3,
            "bound_by": "operations" if ops >= t_bytes else "bytes",
            "floor_ms": max(floor, t_bytes) * 1e3,
            "bound_ms_fp32": max(fp32, t_bytes) * 1e3}


def _policy_model(name: str, n: int, c: int) -> dict:
    """The reference's count model for one select call at (n, c)."""
    pol = get_policy(name)
    b = sweep_lib.resolved_block_size(n, n, None)
    sweep_entries = sweep_lib.num_panels(n, n, None) * b * n
    if name == "uniform_adaptive2":
        extra = c // (pol.adaptive_rounds + 1)
        c0 = c - pol.adaptive_rounds * extra
        gathered = sum(c0 + r * extra for r in range(pol.adaptive_rounds))
        entries = pol.sweep_budget() * sweep_entries + n * gathered
        blocks = pol.gathers + pol.sweep_budget() * sweep_lib.num_panels(
            n, n, None)
    else:                                   # leverage: one n x p pilot
        p = min(n, max(2 * c, c + pol.oversample))
        entries = n * p
        blocks = pol.gathers
    return {"sweeps": pol.sweep_budget(), "columns": pol.gathers,
            "entries": entries, "b2_launches": blocks}


def phase_attention_policy() -> dict:
    n = POLICY_N
    Q, K, V = _qkv(n, seed=21)
    op = CountingOperator(tsa.softmax_gram_operator(K))
    rows = torch.randperm(n, generator=gen(24), device=DEV)[:ATT_ERR_ROWS]
    exact = _exact_rows(Q, K, V, rows)
    res = {}
    reset_counts()
    strided = tsa.sketched_attention(Q, K, V, ATT_C, ATT_THETA,
                                     generator=gen(23), device=DEV)
    res["strided_err"] = rel_err(strided[rows], exact)
    for name in ("uniform_adaptive2", "leverage"):
        op.reset()
        before = read_counts()
        ms, idx = cuda_ms(lambda: get_policy(name).select(
            op, ATT_C, generator=gen(22)))
        launches = {k: v - before[k] for k, v in read_counts().items()}
        want = _policy_model(name, n, ATT_C)
        log(f"attention_policy {name} (n={n}, c={ATT_C}): {ms:.1f} ms, "
            f"counts {json.dumps(op.counts)}, launches {json.dumps(launches)}, "
            f"model {json.dumps(want)}")
        check(len(set(idx.tolist())) == ATT_C, f"{name}: repeated landmarks")
        check(op.counts["sweeps"] == want["sweeps"]
              and op.counts["columns"] == want["columns"]
              and op.counts["entries"] == want["entries"]
              and op.counts["fulls"] == 0,
              f"{name}: metered {op.counts} != model {want}")
        check(launches == no_launches(pairwise_block=want["b2_launches"]),
              f"{name}: launches {launches} != model {want}")
        out = tsa.sketched_attention(Q, K, V, ATT_C, ATT_THETA, p_idx=idx,
                                     generator=gen(23), device=DEV)
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        res[name] = {"ms": ms, "counts": dict(op.counts),
                     "b2_launches": launches["pairwise_block"],
                     "err": rel_err(out[rows], exact)}
    res["launches"] = read_counts()
    b2_want = sum(res[k]["b2_launches"] for k in ("uniform_adaptive2",
                                                   "leverage"))
    log(f"attention_policy launches {json.dumps(res['launches'])}")
    check(res["launches"] == no_launches(pairwise_block=b2_want),
          f"the policy path should launch only the selections' "
          f"{b2_want} B2 panels: {res['launches']}")
    log(f"attention_policy rel err (fast mode, {ATT_ERR_ROWS} rows): "
        f"uniform_adaptive2 {res['uniform_adaptive2']['err']:.6f}, leverage "
        f"{res['leverage']['err']:.6f}, strided {res['strided_err']:.6f}")

    # B2 under exp_affine at this phase's panel shape
    spec = op.inner.spec
    b = sweep_lib.resolved_block_size(n, n, None)
    Kr = K[:b].contiguous()
    ms, blk = cuda_ms(lambda: kernel.pairwise_block_cuda(spec, Kr, K),
                      reps=5, warmup=1)
    plain_ms, plain = cuda_ms(lambda: kernel.pairwise_block_plain(spec, Kr, K),
                              reps=5, warmup=1)
    e = scaled_err(blk, plain)
    check(e <= TOL_F32, f"B2 exp_affine panel vs plain: {e:.3g}")
    nbytes = 4 * (b * ATT_D + n * ATT_D + b * n)
    bound, bound_by = route_bound(spec, b, n, ATT_D, 0, nbytes)
    log(f"B2 exp_affine panel ({b} x {n}, d={ATT_D}): {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}, TF32 tensor "
        f"cores), vs plain {e:.3g}")
    res["b2_panel"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "shape": {"nr": b, "nc": n, "d": ATT_D,
                                 "spec": "softmax_gram (exp_affine)"}}
    return res

# ---------------------------------------------------------------------------
# flash attention (B6) and the served model
# ---------------------------------------------------------------------------

def _flash_inputs(B, Hq, Hkv, Sq, Sk, D, dtype, seed, qk_scale=0.5,
                  Dv=None):
    g = gen(seed)
    q = torch.randn((B, Hq, Sq, D), generator=g, device=DEV) * qk_scale
    k = torch.randn((B, Hkv, Sk, D), generator=g, device=DEV) * qk_scale
    v = torch.randn((B, Hkv, Sk, Dv or D), generator=g, device=DEV)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _check_flash(out, plain, label) -> str:
    """B6's gates: f32 ≤ TOL_F32 scale-normalized; bf16 within the
    reference's rtol = atol = TOL_FLASH_BF16 and every (b, h, row) within
    TOL_FLASH_ROW_BF16 in its own relative error (where the softmax is
    flat the outputs are small and the atol alone would pass a dropped or
    doubled key tile).  Returns the errors as text."""
    check(out.dtype == plain.dtype and out.shape == plain.shape,
          f"{label}: {out.dtype} {tuple(out.shape)} vs {plain.dtype} "
          f"{tuple(plain.shape)}")
    check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
    o32, p32 = out.float(), plain.float()
    err = scaled_err(o32, p32)
    if out.dtype == torch.float32:
        check(err <= TOL_F32, f"{label}: {err:.3g} > {TOL_F32}")
        return f"{err:.3g}"
    excess = float(((o32 - p32).abs() - TOL_FLASH_BF16
                    * (1.0 + p32.abs())).max())
    check(excess <= 0.0, f"{label}: outside rtol = atol = "
          f"{TOL_FLASH_BF16} by {excess:.3g}")
    rows = _check_rows(out, plain, TOL_FLASH_ROW_BF16, f"{label} rows")
    return f"{err:.3g} (rows {rows['max']:.3g})"


def _flash_case(q, k, v, causal, window, label) -> str:
    """One B6 call against its plain version; bf16 must take the
    tensor-core kernel (one launch), f32 the CUDA-core kernel (none)."""
    tc0 = fa_kernel.launch_counts()["flash_attention_tc"]
    out = fa_kernel.flash_attention_cuda(q, k, v, causal=causal,
                                         window=window)
    plain = fa_kernel.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
    torch.cuda.synchronize()
    want = 1 if q.dtype == torch.bfloat16 else 0
    got = fa_kernel.launch_counts()["flash_attention_tc"] - tc0
    check(got == want, f"{label}: {got} tensor-core launches, expected "
          f"{want}")
    return _check_flash(out, plain, label)


def phase_parity_flash() -> None:
    """B6 against its plain version at every shape of the reference's
    flash tests (causal; the sliding windows 16, 64, 200; the block-shape
    sweep's 512-long case), f32 (CUDA-core kernel) and bf16 (tensor-core
    kernel), then the tensor-core kernel's edge cases in bf16."""
    cases = [(shape, None) for shape in FLASH_SHAPES]
    cases += [((1, 2, 2, 256, 256, 32), w) for w in (16, 64, 200)]
    cases += [((1, 2, 2, 512, 512, 64), None)]
    for shape, window in cases:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _flash_inputs(*shape, dtype, seed=41)
            errs[str(dtype).split(".")[-1]] = _flash_case(
                q, k, v, True, window, f"flash {shape} window {window} "
                f"{dtype}")
        log(f"parity flash_attention (B, Hq, Hkv, Sq, Sk, D) = {shape}, "
            f"window {window}: " + " ".join(f"{k}={v}"
                                            for k, v in errs.items()))
    for (B, Hq, Hkv, Sq, Sk, D, Dv), causal, window in FLASH_TC_EDGES:
        q, k, v = _flash_inputs(B, Hq, Hkv, Sq, Sk, D, torch.bfloat16,
                                seed=44, Dv=Dv)
        label = (f"flash bf16 (B, Hq, Hkv, Sq, Sk, D, Dv) = "
                 f"{(B, Hq, Hkv, Sq, Sk, D, Dv)}, causal {causal}, window "
                 f"{window}")
        err = _flash_case(q, k, v, causal, window, label)
        log(f"parity {label}: {err} (tensor cores)")
    # causal with Sq > Sk: the first Sq − Sk rows see no key (the first
    # 128-row block of the tensor-core kernel sees no key tile) and are 0
    for (B, Hq, Hkv, Sq, Sk, D, Dv), window in FLASH_EMPTY_ROWS:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _flash_inputs(B, Hq, Hkv, Sq, Sk, D, dtype, seed=45,
                                    Dv=Dv)
            label = (f"flash {dtype} (B, Hq, Hkv, Sq, Sk, D, Dv) = "
                     f"{(B, Hq, Hkv, Sq, Sk, D, Dv)}, window {window}")
            out = fa_kernel.flash_attention_cuda(q, k, v, causal=True,
                                                 window=window)
            check(bool((out[:, :, :Sq - Sk] == 0).all()),
                  f"{label}: a row that sees no key is not 0")
            errs[str(dtype).split(".")[-1]] = _flash_case(
                q, k, v, True, window, label)
        log(f"parity flash, rows without keys (B, Hq, Hkv, Sq, Sk, D, Dv) = "
            f"{(B, Hq, Hkv, Sq, Sk, D, Dv)}, window {window}: exactly 0; "
            + " ".join(f"{k}={v}" for k, v in errs.items()))
    # the MoE, MLA and dense configs' head shapes on both routes
    for B, Hq, Hkv, Sq, Sk, D, Dv in FLASH_MODEL_SHAPES:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _flash_inputs(B, Hq, Hkv, Sq, Sk, D, dtype, seed=46,
                                    Dv=Dv)
            label = (f"flash {dtype} (B, Hq, Hkv, Sq, Sk, D, Dv) = "
                     f"{(B, Hq, Hkv, Sq, Sk, D, Dv)}")
            if Sq > Sk:
                out = fa_kernel.flash_attention_cuda(q, k, v, causal=True)
                check(bool((out[:, :, :Sq - Sk] == 0).all()),
                      f"{label}: a row that sees no key is not 0")
            errs[str(dtype).split(".")[-1]] = _flash_case(
                q, k, v, True, None, label)
        log(f"parity flash, model head shape (B, Hq, Hkv, Sq, Sk, D, Dv) = "
            f"{(B, Hq, Hkv, Sq, Sk, D, Dv)}: "
            + " ".join(f"{k}={v}" for k, v in errs.items()))


def serve_config():
    """gemma3-12b at long_500k with the flash kernel, at full width, cut in
    depth."""
    cfg = tconfigs.config_for_shape(gemma3_12b.FULL,
                                    tconfigs.SHAPES["long_500k"])
    return dataclasses.replace(cfg, attn_impl="pallas",
                               n_layers=SERVE_LAYERS)


def _instrumented(model):
    """The model with its prefill timed (host clock around a synchronized
    call) and the B6 launches of prefill and of each decode step counted.
    Decode steps are not synchronized, as in a plain ``generate``: their
    logits' finiteness is kept on the device and read after the run."""
    rec = {"prefill_ms": [], "b6_prefill": [], "b6_decode": [], "finite": []}

    def since(c0):
        return {k: n - c0[k] for k, n in fa_kernel.launch_counts().items()}

    def prefill(*args, **kw):
        torch.cuda.synchronize()
        c0 = fa_kernel.launch_counts()
        t0 = time.perf_counter()
        logits, cache = model.prefill(*args, **kw)
        torch.cuda.synchronize()
        rec["prefill_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["b6_prefill"].append(since(c0))
        rec["finite"].append(torch.isfinite(logits).all())
        return logits, cache

    def decode_step(*args, **kw):
        c0 = fa_kernel.launch_counts()
        logits, cache = model.decode_step(*args, **kw)
        rec["b6_decode"].append(since(c0))
        rec["finite"].append(torch.isfinite(logits).all())
        return logits, cache

    return model._replace(prefill=prefill, decode_step=decode_step), rec


def _serve_lm(tag: str, cfg, B: int, S: int, n_gen: int, seed: int, *,
              n_patch: int = 0, warm_len: int = 0, describe: str = "",
              profile: bool = True) -> dict:
    """One model served end to end through ``serve.generate``: init from a
    seeded generator and ``prepare``; a warm-up (the full run, or a
    ``warm_len``-token prompt and 2 tokens); then the counted, timed run
    (every launch count reset just before it and read just after); B6 once
    per layer of its one prefill, all on the tensor-core kernel, none in
    decode; every token in [0, vocab) and every logit finite; then, outside
    the counted run, the device time of one prefill and 4 decode steps by
    kernel class.  ``n_patch`` seeded patch embeddings are fused into the
    leading prompt positions (early fusion)."""
    t0 = time.perf_counter()
    model = tmodel.build_model(cfg)
    params = model.prepare(model.init(gen(seed), DEV))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen(
        seed + 2), device=DEV)
    patches = None
    if n_patch:
        patches = torch.randn((B, n_patch, cfg.d_model),
                              generator=gen(seed + 3), device=DEV).to(
                                  cfg.cdtype)
    log(f"{tag}: {cfg.name} with {cfg.n_layers} layers "
        f"{cfg.layer_pattern}, d_model {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads}x{cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}{describe}, {n_params:,} params held in "
        f"{cfg.dtype} (init + cast {init_s:.1f} s); batch {B}, context {S}, "
        f"gen {n_gen}" + (f", {n_patch} patch embeddings" if n_patch else ""))

    def run(m, p, length, steps):
        return serve.generate(m, params, p[:, :length], steps,
                              generator=torch.Generator().manual_seed(
                                  seed + 1), patches=patches)

    warm, _ = _instrumented(model)
    run(warm, prompts, warm_len or S, 2 if warm_len else n_gen)
    timed, rec = _instrumented(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = run(timed, prompts, S, n_gen)
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # decode: the rest of the generate loop after prefill's synchronized
    # end, one synchronize at the end of the run
    decode_ms = (total_ms - rec["prefill_ms"][0]) / (n_gen - 1)
    res = {"prefill_ms": rec["prefill_ms"][0], "decode_ms_per_token":
           decode_ms, "generate_ms": total_ms,
           "tokens_per_s": B * n_gen / (total_ms / 1e3),
           "decode_tokens_per_s": B / (decode_ms / 1e3),
           "peak_gb": peak_gb, "launches": launches,
           "b6_prefill": rec["b6_prefill"], "b6_decode": rec["b6_decode"],
           "params": n_params, "init_s": init_s}
    log(f"{tag} timed run: prefill {res['prefill_ms']:.1f} ms, decode"
        f" {decode_ms:.2f} ms per token (generate minus prefill over "
        f"{n_gen - 1} steps), generate {total_ms:.1f} ms, "
        f"{res['tokens_per_s']:.2f} tokens/s ({res['decode_tokens_per_s']:.1f}"
        f" in decode), peak memory {peak_gb:.2f} GB")
    log(f"{tag} launches {json.dumps(launches)}; B6 per prefill "
        f"{rec['b6_prefill']}, per decode step {rec['b6_decode']}")
    n = cfg.n_layers
    check(launches == no_launches(flash_attention=n, flash_attention_tc=n),
          f"{tag}: the serving path should launch B6 once per layer of its "
          f"one prefill, each on the tensor-core kernel, and nothing else: "
          f"{launches}")
    none = {"flash_attention": 0, "flash_attention_tc": 0}
    check(rec["b6_prefill"] == [{"flash_attention": n,
                                 "flash_attention_tc": n}]
          and rec["b6_decode"] == [none] * (n_gen - 1),
          f"{tag}: B6 per prefill {rec['b6_prefill']} (all {n} on the "
          f"tensor cores), per decode step {rec['b6_decode']} (none)")
    check(tuple(out.shape) == (B, n_gen) and bool(
        ((out >= 0) & (out < cfg.vocab_size)).all()),
        f"{tag}: tokens {tuple(out.shape)} outside [0, {cfg.vocab_size})")
    check(bool(torch.stack(rec["finite"]).all()),
          f"{tag}: a logit was not finite")
    log(f"{tag} tokens row 0: {out[0].tolist()}")
    if profile:
        res["profile"] = _profile_serve(tag, model, params, prompts, n_gen,
                                        seed + 1, patches)
    res["model"], res["params_tree"] = model, params
    return res


def _drop_model(res: dict) -> None:
    """Free a served model's weights before the next phase."""
    res.pop("model", None)
    res.pop("params_tree", None)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_serve_gemma3() -> dict:
    cfg = serve_config()
    res = _serve_lm("serve_gemma3", cfg, SERVE_BATCH, SERVE_CONTEXT,
                    SERVE_GEN, 30,
                    describe=f", window {cfg.window}, landmark c "
                             f"{cfg.landmark_c} θ {cfg.landmark_theta}")
    _drop_model(res)
    return res


def moe_config():
    """qwen2-moe-a2.7b at full width, cut in depth."""
    return dataclasses.replace(tconfigs.get_config("qwen2-moe-a2.7b"),
                               n_layers=MOE_LAYERS)


def mla_config():
    """deepseek-v3-671b at full width: the 3 dense prefix layers and the
    first MoE layer, absorbed MLA decode."""
    return dataclasses.replace(tconfigs.get_config("deepseek-v3-671b"),
                               n_layers=MLA_LAYERS, mla_absorb=True)


def _moe_describe(cfg) -> str:
    return (f", {cfg.n_experts} experts top-{cfg.moe_top_k} + "
            f"{cfg.n_shared_experts} shared of width {cfg.moe_d_ff}, "
            f"capacity factor {cfg.capacity_factor}"
            + (f", {cfg.first_k_dense} dense prefix layers at d_ff "
               f"{cfg.dense_d_ff}" if cfg.first_k_dense else ""))


def _moe_layer_check(tag: str, cfg, moe_params, T: int) -> dict:
    """One MoE layer at full width on T seeded tokens in bf16, with the
    capacity raised until nothing can drop (cf = E/k, so C = T), against an
    f32 per-token dense evaluation of the same routing on the card (each
    expert's rows through its f32 weights, weighted and summed, plus the
    shared MLP in f32), scale-normalized ≤ TOL_MOE; two calls bit-equal."""
    from repro_torch.models import moe as tmoe
    ccfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                               / cfg.moe_top_k)
    x = torch.randn((1, T, cfg.d_model), generator=gen(61),
                    device=DEV).to(cfg.cdtype)
    xf = x.reshape(T, cfg.d_model)
    w, idx, _ = tmoe._route(moe_params, ccfg, xf)
    _, _, keep = tmoe._assign(ccfg, idx, tmoe.capacity(ccfg, T))
    check(bool(keep.all()), f"{tag} MoE layer: an assignment dropped")
    ms, out = cuda_ms(lambda: tmoe.moe_ffn(moe_params, ccfg, x)[0], reps=3,
                      warmup=1)
    again = tmoe.moe_ffn(moe_params, ccfg, x)[0]
    check(torch.equal(out, again), f"{tag} MoE layer: two calls differ")
    x32 = xf.float()
    ref = torch.zeros((T, cfg.d_model), dtype=torch.float32, device=DEV)
    for e in range(cfg.n_experts):
        rows, j = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x32[rows]
        h = torch.nn.functional.silu(xe @ moe_params["wi_gate"][e].float()) \
            * (xe @ moe_params["wi_up"][e].float())
        ref.index_add_(0, rows, (h @ moe_params["wo"][e].float())
                       * w[rows, j][:, None])
    if cfg.n_shared_experts:
        sh = moe_params["shared"]
        ref += (torch.nn.functional.silu(x32 @ sh["wi_gate"].float())
                * (x32 @ sh["wi_up"].float())) @ sh["wo"].float()
    err = scaled_err(out.reshape(T, -1).float(), ref)
    check(err <= TOL_MOE, f"{tag} MoE layer vs f32 per-token: {err:.3g} > "
          f"{TOL_MOE}")
    log(f"{tag} MoE layer at T = {T} (capacity {tmoe.capacity(ccfg, T)}, "
        f"nothing dropped): {ms:.2f} ms, vs the f32 per-token evaluation "
        f"{err:.3g} (limit {TOL_MOE}), two calls bit-equal")
    return {"T": T, "ms": ms, "err_vs_f32_per_token": err}


def phase_serve_moe() -> dict:
    cfg = moe_config()
    res = _serve_lm("serve_moe", cfg, MOE_BATCH, MOE_CONTEXT, MOE_GEN, 70,
                    warm_len=WARM_LEN, describe=_moe_describe(cfg))
    res["moe_layer"] = _moe_layer_check(
        "serve_moe", cfg, res["params_tree"]["stack"]["scanned"][0][0]["moe"],
        MOE_CHECK_T)
    _drop_model(res)
    res["b6_shape"] = _flash_at_shape(
        "qwen2-moe (MHA, group 1)", MOE_BATCH, cfg.n_heads, cfg.n_kv_heads,
        MOE_CONTEXT, cfg.head_dim, cfg.head_dim, FLASH_ROWS, "serve_moe")
    return res


def phase_serve_mla() -> dict:
    cfg = mla_config()
    res = _serve_lm(
        "serve_mla", cfg, MLA_BATCH, MLA_CONTEXT, MLA_GEN, 80,
        warm_len=WARM_LEN,
        describe=f", MLA q_lora {cfg.q_lora_rank} kv_lora "
                 f"{cfg.kv_lora_rank} nope {cfg.qk_nope_dim} rope "
                 f"{cfg.qk_rope_dim} v {cfg.v_head_dim} (absorbed decode), "
                 + _moe_describe(cfg)[2:] + ", MTP initialized, unused")
    check("mtp" in res["params_tree"], "serve_mla: no MTP parameters")
    res["moe_layer"] = _moe_layer_check(
        "serve_mla", cfg,
        res["params_tree"]["stack"]["scanned"][0][0]["moe"], MLA_CHECK_T)
    _drop_model(res)
    dq = cfg.qk_nope_dim + cfg.qk_rope_dim
    res["b6_shape"] = _flash_at_shape(
        "deepseek-v3 MLA (D 192, Dv 128)", MLA_BATCH, cfg.n_heads,
        cfg.n_heads, MLA_CONTEXT, dq, cfg.v_head_dim, MLA_FLASH_ROWS,
        "serve_mla")
    return res


def phase_serve_dense_configs() -> dict:
    """yi-6b, yi-9b, minitron-4b and chameleon-34b (with seeded patch
    embeddings) at full width, each cut to DENSE_LAYERS layers; the path's
    launch counts are each config's summed (reset just before each counted
    run and read just after)."""
    out = {"configs": {}, "launches": no_launches()}
    for name in DENSE_ARCHS:
        cfg = dataclasses.replace(tconfigs.get_config(name),
                                  n_layers=DENSE_LAYERS)
        n_patch = DENSE_PATCHES if cfg.family == "vlm" else 0
        res = _serve_lm(f"serve_dense {name}", cfg, DENSE_BATCH,
                        DENSE_CONTEXT, DENSE_GEN, 90, n_patch=n_patch,
                        warm_len=WARM_LEN, profile=False,
                        describe=f", mlp {cfg.mlp_variant}"
                                 + (", qk-norm" if cfg.qk_norm else ""))
        _drop_model(res)
        out["configs"][name] = res
        for k, v in res["launches"].items():
            out["launches"][k] += v
    yi = tconfigs.get_config("yi-6b")
    out["b6_shape"] = _flash_at_shape(
        "yi (GQA, group 8)", DENSE_BATCH, yi.n_heads, yi.n_kv_heads,
        DENSE_CONTEXT, yi.head_dim, yi.head_dim, FLASH_ROWS,
        "serve_dense_configs")
    return out


def _kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_kernel" in low or "flash_wgmma_kernel" in low:
        return "B6 flash_attention"
    if any(t in low for t in ("pairwise_", "prep_points", "prep_rhs")):
        return "B1/B2 pairwise (prep + main)"
    if any(t in low for t in ("svd", "geqr", "orgqr", "ormqr", "syevj",
                              "potrf", "lapack", "cusolver")):
        return "SVD and QR (cuSOLVER)"
    if any(t in low for t in ("sort", "searchsorted", "scatter", "gather",
                              "index")):
        return "sort / gather / scatter"
    if any(t in low for t in ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                              "sm90")):
        return "matmul (cuBLAS)"
    return "other (elementwise, reductions, copies)"


def _kernel_device_ms(fn, reps: int = 5) -> dict:
    """Device ms per call of each kernel that ``fn()`` launches
    (``torch.profiler`` over ``reps`` calls after one warm-up); {} where the
    profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            name = re.sub(r"\(anonymous namespace\)::", "", e.key)
            out[name.split("(")[0][:60]] = us / 1e3 / reps
    return out


def _device_profile(fn) -> dict:
    """Device time of ``fn()`` by kernel class: ``fn`` runs once unprofiled
    (wall ms, one synchronize at the end) and once under ``torch.profiler``
    (busy ms: the sum of kernel times, one stream).  The idle share is busy
    over the unprofiled wall, since the profiler's own host work slows a
    host-bound loop.  Returns {"error": ...} where the profiler records no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    by_class, top = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        cls = _kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3
        top.append((us / 1e3, e.count, e.key[:90]))
    busy = sum(by_class.values())
    if busy <= 0.0:
        return {"error": "the profiler recorded no device time"}
    # the kernels launched under aten::bmm, split out of the matmuls: in a
    # prefill only the MoE's expert GEMMs call it (the projections are 2-d
    # matmuls); in decode the attention's einsum reads do too
    bmm = sum(getattr(e, "device_time_total", 0.0) for e in
              prof.key_averages()
              if e.key == "aten::bmm" and e.device_type != DeviceType.CUDA
              ) / 1e3
    if bmm > 0.0:
        mm = "matmul (cuBLAS)"
        by_class[mm] = by_class.get(mm, 0.0) - bmm
        by_class["of which aten::bmm"] = bmm
    top.sort(reverse=True)
    return {"wall_ms": wall_ms, "profiled_wall_ms": profiled_wall_ms,
            "busy_ms": busy, "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "by_class_ms": by_class,
            "top": [{"ms": ms, "count": n, "kernel": k}
                    for ms, n, k in top[:8]]}


def _profile_serve(tag, model, params, prompts, n_gen, seed,
                   patches=None) -> dict:
    """One prefill and 4 decode steps, each run unprofiled and then under
    the profiler (outside the counted run)."""
    state = {}
    S = prompts.shape[1]
    batch = {"tokens": prompts}
    if patches is not None:
        batch["patches"] = patches

    def prefill():
        state["logits"], state["cache"] = model.prefill(
            params, batch, S + n_gen,
            generator=torch.Generator().manual_seed(seed))

    def decode():
        tok = torch.argmax(state["logits"], dim=-1)
        for i in range(4):
            logits, _ = model.decode_step(params, state["cache"],
                                          tok[:, None], S + i)
            tok = torch.argmax(logits, dim=-1)

    prof = {"prefill": _device_profile(prefill),
            "decode_4_steps": _device_profile(decode)}
    state.clear()
    for what, p in prof.items():
        if "error" in p:
            log(f"{tag} {what} profile: not measured ({p['error']})")
            continue
        log(f"{tag} {what} profile: device busy {p['busy_ms']:.1f} ms"
            f" of {p['wall_ms']:.1f} ms unprofiled wall (idle share "
            f"{p['idle_share']:.1%}; {p['profiled_wall_ms']:.1f} ms wall "
            f"under the profiler); by class " + json.dumps(
                {k: round(v, 2) for k, v in p["by_class_ms"].items()}))
        for t in p["top"]:
            log(f"    {t['ms']:9.2f} ms  x{t['count']:<5d} {t['kernel']}")
    return prof


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _attention_rows_f64(q, k, v, rows, window):
    """Causal attention of the query ``rows`` (also their key positions:
    Sq = Sk) in f64, one (batch row, kv head) at a time."""
    B, Hq, _, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    out = torch.empty((B, Hq, rows.shape[0], v.shape[3]),
                      dtype=torch.float64, device=q.device)
    col = torch.arange(Sk, device=q.device)[None, :]
    mask = col <= rows[:, None]
    if window is not None:
        mask &= (rows[:, None] - col) < window
    for b in range(B):
        for h in range(Hkv):
            qs = q[b, h * G:(h + 1) * G, rows].double()
            s = (qs @ k[b, h].double().T) / np.sqrt(D)
            s = torch.where(mask, s, float("-inf"))
            out[b, h * G:(h + 1) * G] = torch.softmax(s, dim=-1) \
                @ v[b, h].double()
    return out


def _flash_flops(B, Hq, S, D, Dv, window=None) -> float:
    """Useful flops of causal (windowed) attention at Sq = Sk = S: 2·(D + Dv)
    per visible (query, key) pair."""
    if window is None:
        pairs = S * (S + 1) // 2
    else:
        w = min(window, S)
        pairs = w * (w + 1) // 2 + (S - w) * w
    return 2.0 * (D + Dv) * pairs * B * Hq


def row_errs(got: torch.Tensor, exact: torch.Tensor) -> torch.Tensor:
    """||got - exact|| / ||exact|| over the feature axis, per (b, h, row)."""
    g, e = got.double(), exact.double()
    return (g - e).norm(dim=-1) / e.norm(dim=-1).clamp_min(1e-300)


def _check_rows(got, ref, tol, label) -> dict:
    """B6's gate at the served shapes: every sampled row within ``tol`` of
    ``ref`` in its own relative error.  Returns the max and median."""
    check(got.shape == ref.shape, f"{label}: {tuple(got.shape)} vs "
          f"{tuple(ref.shape)}")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    e = row_errs(got, ref)
    worst = float(e.max())
    check(worst <= tol, f"{label}: a row's relative error {worst:.3g} > {tol}")
    return {"max": worst, "median": float(e.median())}


def _flash_line(serve_res: dict) -> dict:
    """B6 at the served model's global and local layer shapes: timed in
    bf16 (the tensor-core kernel); held row by row on FLASH_ROWS sampled
    query rows to the plain version and to f64 in bf16, and to the plain
    version in f32 (the CUDA-core kernel) on the same inputs (bf16 values,
    exact in f32)."""
    cfg = serve_config()
    B, S = SERVE_BATCH, SERVE_CONTEXT
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # q, k with the unit variance that qk-norm gives, v ~ N(0, 1)
    q, k, v = _flash_inputs(B, Hq, Hkv, S, S, D, torch.bfloat16, seed=42,
                            qk_scale=1.0)
    rows = torch.sort(torch.randperm(S, generator=gen(43), device=DEV)[
        :FLASH_ROWS]).values
    res = {}
    for name, window, reps in (("global", None, 5), ("local", cfg.window, 10)):
        tc0 = fa_kernel.launch_counts()["flash_attention_tc"]
        ms, out = cuda_ms(lambda: fa_kernel.flash_attention_cuda(
            q, k, v, causal=True, window=window), reps=reps, warmup=1)
        tc = fa_kernel.launch_counts()["flash_attention_tc"] - tc0
        check(tc == reps + 1,
              f"B6 {name}: bf16 calls missed the tensor-core kernel")
        got = out[:, :, rows]
        del out
        plain_ms, plain = cuda_ms(lambda: fa_kernel.flash_attention_plain(
            q[:, :, rows], k, v, causal=True, window=window, q_pos=rows),
            reps=3, warmup=1)
        exact = _attention_rows_f64(q, k, v, rows, window)
        check(got.dtype == plain.dtype == torch.bfloat16,
              f"B6 {name}: {got.dtype}, plain {plain.dtype}")
        vs_plain = _check_rows(got, plain, TOL_FLASH_ROW_BF16,
                               f"B6 {name} shape bf16 rows vs plain")
        vs_f64 = _check_rows(got, exact, TOL_FLASH_ROW_BF16,
                             f"B6 {name} shape bf16 rows vs f64")
        plain_vs_f64 = float(row_errs(plain, exact).max())
        max_abs = float((got.float() - plain.float()).abs().max())
        del got, plain
        q32, k32, v32 = q.float(), k.float(), v.float()
        ms_f32, out = cuda_ms(lambda: fa_kernel.flash_attention_cuda(
            q32, k32, v32, causal=True, window=window))
        got = out[:, :, rows]
        del out
        plain = fa_kernel.flash_attention_plain(
            q32[:, :, rows], k32, v32, causal=True, window=window,
            q_pos=rows)
        f32_vs_plain = _check_rows(got, plain, TOL_FLASH_ROW_F32,
                                   f"B6 {name} shape f32 rows vs plain")
        f32_vs_f64 = float(row_errs(got, exact).max())
        del got, plain, exact, q32, k32, v32
        flops = _flash_flops(B, Hq, S, D, D, window)
        nbytes = 2 * (2 * B * Hq * S * D + 2 * B * Hkv * S * D)
        res[name] = {
            "ms": ms, "ms_f32": ms_f32, "plain_ms_rows": plain_ms,
            "max_abs_err": max_abs,
            "row_err_vs_plain": vs_plain["max"],
            "row_err_vs_f64": vs_f64["max"],
            "row_err_vs_f64_median": vs_f64["median"],
            "plain_row_err_vs_f64": plain_vs_f64,
            "row_err_f32_vs_plain": f32_vs_plain["max"],
            "row_err_f32_vs_f64": f32_vs_f64,
            "flops": flops,
            "bound_ms_bf16": max(flops / PEAK_BF16_TC_FLOPS,
                                 nbytes / PEAK_HBM_BYTES) * 1e3,
            "bound_ms_fp32": max(flops / PEAK_FP32_FLOPS,
                                 nbytes / PEAK_HBM_BYTES) * 1e3}
        r = res[name]
        log(f"B6 {name} shape (B={B}, Hq={Hq}, Hkv={Hkv}, S={S}, D={D}, "
            f"window {window}): bf16 (tensor cores) {ms:.2f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s, {r['bound_ms_bf16'] / ms:.2%} "
            f"of the bf16 tensor-core roof, bound {r['bound_ms_bf16']:.2f} "
            f"ms); f32 (CUDA cores) {ms_f32:.2f} ms "
            f"({r['bound_ms_fp32'] / ms_f32:.1%} of the FP32 roof, bound "
            f"{r['bound_ms_fp32']:.1f} ms); plain on {FLASH_ROWS} rows "
            f"{plain_ms:.2f} ms")
        log(f"B6 {name} shape, per-row relative error on {FLASH_ROWS} rows: "
            f"bf16 vs plain {vs_plain['max']:.3g} (median "
            f"{vs_plain['median']:.3g}), vs f64 {vs_f64['max']:.3g} (median "
            f"{vs_f64['median']:.3g}; plain vs f64 {plain_vs_f64:.3g}), limit "
            f"{TOL_FLASH_ROW_BF16}; f32 vs plain {f32_vs_plain['max']:.3g} "
            f"(median {f32_vs_plain['median']:.3g}), limit "
            f"{TOL_FLASH_ROW_F32}; f32 vs f64 {f32_vs_f64:.3g}")
    # the library yardstick at the global shape (never called by the port)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        lib_ms, lib_out = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), reps=5, warmup=1)
    lib_rows = lib_out[:, :, rows]
    del lib_out
    lib_err = float(row_errs(lib_rows, _attention_rows_f64(
        q, k, v, rows, None)).max())
    g = res["global"]
    loc = res["local"]
    log(f"B6 global shape vs the library: {g['ms']:.2f} ms vs SDPA "
        f"{lib_ms:.3f} ms ({g['ms'] / lib_ms:.2f}x); SDPA per-row relative "
        f"error vs f64 {lib_err:.3g}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_wgmma.cu",
            "source_f32": "src/repro_torch/kernels/flash_attention/csrc/"
                          "flash.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:85",
            "launches": serve_res["launches"]["flash_attention"],
            "launches_tc": serve_res["launches"]["flash_attention_tc"],
            "max_abs_err": g["max_abs_err"], "ms": g["ms"],
            "plain_ms": g["plain_ms_rows"], "bound_ms": g["bound_ms_bf16"],
            "bound_by": "operations", "library_ms": lib_ms,
            "library_call": "F.scaled_dot_product_attention(q, k, v, "
                            "is_causal=True, enable_gqa=True) "
                            "(flash/cuDNN/efficient backends)",
            "shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "S": S, "D": D,
                      "causal": True, "window": None, "dtype": "bfloat16"},
            "plain_ms_on": f"{FLASH_ROWS} sampled query rows (the full-shape "
                           "plain version needs a 137 GB score panel)",
            "bound_ms_fp32": g["bound_ms_fp32"], "ms_f32": g["ms_f32"],
            "row_err_vs_plain": g["row_err_vs_plain"],
            "row_err_vs_f64": g["row_err_vs_f64"],
            "row_err_f32_vs_plain": g["row_err_f32_vs_plain"],
            "row_err_f32_vs_f64": g["row_err_f32_vs_f64"],
            "library_row_err_vs_f64": lib_err,
            "ms_over_library": g["ms"] / lib_ms,
            "bf16_roof_share": g["bound_ms_bf16"] / g["ms"],
            "bf16_roof_share_local": loc["bound_ms_bf16"] / loc["ms"],
            "ms_local": loc["ms"], "ms_f32_local": loc["ms_f32"],
            "plain_ms_local": loc["plain_ms_rows"],
            "bound_ms_local": loc["bound_ms_bf16"],
            "bound_ms_fp32_local": loc["bound_ms_fp32"],
            "row_err_local_vs_plain": loc["row_err_vs_plain"],
            "row_err_local_vs_f64": loc["row_err_vs_f64"],
            "row_err_f32_local_vs_plain": loc["row_err_f32_vs_plain"],
            "local_window": cfg.window}


def _flash_at_shape(label: str, B: int, Hq: int, Hkv: int, S: int, D: int,
                    Dv: int, n_rows: int, path: str) -> dict:
    """B6 at a served model's prefill shape, bf16 (the tensor-core kernel):
    timed (one launch a call), held row by row on ``n_rows`` sampled query
    rows to its plain version (≤ TOL_FLASH_ROW_BF16), its bound (the causal
    half's flops over the bf16 tensor-core peak, or the bytes), and SDPA
    timed where one of its fused backends takes the shape (else None)."""
    q, k, v = _flash_inputs(B, Hq, Hkv, S, S, D, torch.bfloat16, seed=47,
                            qk_scale=1.0, Dv=Dv)
    rows = torch.sort(torch.randperm(S, generator=gen(48), device=DEV)[
        :n_rows]).values
    tc0 = fa_kernel.launch_counts()["flash_attention_tc"]
    ms, out = cuda_ms(lambda: fa_kernel.flash_attention_cuda(
        q, k, v, causal=True), reps=3, warmup=1)
    check(fa_kernel.launch_counts()["flash_attention_tc"] - tc0 == 4,
          f"B6 {label}: bf16 calls missed the tensor-core kernel")
    got = out[:, :, rows]
    del out
    plain_ms, plain = cuda_ms(lambda: fa_kernel.flash_attention_plain(
        q[:, :, rows], k, v, causal=True, q_pos=rows), reps=1, warmup=1)
    errs = _check_rows(got, plain, TOL_FLASH_ROW_BF16,
                       f"B6 {label} rows vs plain")
    max_abs = float((got.float() - plain.float()).abs().max())
    del got, plain
    flops = _flash_flops(B, Hq, S, D, Dv)
    nbytes = 2 * (B * Hq * S * D + B * Hkv * S * (D + Dv) + B * Hq * S * Dv)
    bound_ms = max(flops / PEAK_BF16_TC_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F
    lib_ms = lib_note = None
    try:
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION]):
            lib_ms, _ = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=Hq != Hkv), reps=3,
                warmup=1)
    except RuntimeError as exc:      # no fused backend takes the shape
        lib_note = str(exc).splitlines()[0][:160]
    del q, k, v
    torch.cuda.empty_cache()
    res = {"label": label, "path": path,
           "shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "S": S, "D": D, "Dv": Dv,
                     "causal": True, "dtype": "bfloat16"},
           "ms": ms, "bound_ms": bound_ms,
           "bound_by": "operations" if flops / PEAK_BF16_TC_FLOPS
           >= nbytes / PEAK_HBM_BYTES else "bytes",
           "bf16_roof_share": bound_ms / ms, "plain_ms_rows": plain_ms,
           "plain_rows": n_rows, "row_err_vs_plain": errs["max"],
           "row_err_vs_plain_median": errs["median"],
           "max_abs_err": max_abs, "library_ms": lib_ms}
    if lib_note:
        res["library_note"] = lib_note
    log(f"B6 {label} (B={B}, Hq={Hq}, Hkv={Hkv}, S={S}, D={D}, Dv={Dv}, "
        f"causal, bf16): {ms:.2f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
        f"{bound_ms / ms:.1%} of the bf16 tensor-core roof, bound "
        f"{bound_ms:.2f} ms); SDPA "
        + (f"{lib_ms:.3f} ms ({ms / lib_ms:.2f}x)" if lib_ms else
           f"not measured ({lib_note})")
        + f"; rows vs plain {errs['max']:.3g} (median {errs['median']:.3g})"
        f" on {n_rows} rows, plain {plain_ms:.2f} ms")
    return res


# ---------------------------------------------------------------------------
# kernel-model serving (serve_kernel) and the ragged fast model
# ---------------------------------------------------------------------------

def _sk_params() -> dict:
    """The serving CLI's build parameters for the serve_kernel path."""
    return {"n": SK_N, "d": D, "c": SK_C, "s": SK_S, "alpha": 1.0,
            "n_components": SK_COMPONENTS, "kernel": "rbf",
            "spec_params": {"sigma": SK_SIGMA}, "seed": SK_SEED,
            "use_pallas": True}


def _sk_build(X, y, use_kernel: bool = True):
    """``build_artifact`` on the serving problem, draws from the seed."""
    return tserve.build_artifact(
        X, y, specs.rbf(SK_SIGMA), SK_C, SK_S, alpha=1.0,
        n_components=SK_COMPONENTS,
        generator=torch.Generator().manual_seed(SK_SEED),
        use_kernel=use_kernel, device=DEV)


def _sk_server(art, queries) -> dict:
    """A ``KernelServer`` at the CLI's batching defaults with SK_CLIENTS
    closed-loop client threads over ``queries`` (client k sends requests
    k, k + SK_CLIENTS, ...); one warm-up pass, then SK_SERVER_PASSES timed
    passes.  Each flush is timed from the worker's side, so a request's
    latency splits into its wait before the flush that answers it (the
    collector's window and earlier flushes) and that flush's time."""
    op = CountingOperator(art.landmark_operator())
    server = sk_launch.KernelServer(
        art, sk_launch.BatchPolicy(max_batch=SK_MAX_BATCH,
                                   max_wait_s=SK_MAX_WAIT_MS / 1e3), op=op)
    lats, answers, flushes = [], {}, []
    inner = server._flush

    def timed_flush(batch):
        t = time.perf_counter()
        inner(batch)
        flushes.append((t, time.perf_counter(), [p.t_enqueue for p in batch]))

    server._flush = timed_flush

    def client(k: int) -> None:
        for i in range(k, len(queries), SK_CLIENTS):
            p = server.submit(*queries[i])
            answers[i] = p.wait(timeout=120.0)
            lats.append(p.latency_s)

    def one_pass():
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SK_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
        check(not any(t.is_alive() for t in threads), "a client hung")

    passes = []
    try:
        one_pass()
        for _ in range(SK_SERVER_PASSES):
            b0 = server.buckets_served
            lats.clear()
            flushes.clear()
            t0 = time.perf_counter()
            one_pass()
            wall_s = time.perf_counter() - t0
            check(len(lats) == len(queries), f"served {len(lats)} of "
                  f"{len(queries)} requests")
            waits = [t - e for t, _, es in flushes for e in es]
            spans = [t1 - t for t, t1, _ in flushes]
            passes.append({
                "p50_ms": sk_launch.percentile_ms(lats, 50),
                "p99_ms": sk_launch.percentile_ms(lats, 99),
                "req_per_s": len(queries) / wall_s, "wall_ms": wall_s * 1e3,
                "wait_p50_ms": sk_launch.percentile_ms(waits, 50),
                "wait_p99_ms": sk_launch.percentile_ms(waits, 99),
                "flush_p50_ms": sk_launch.percentile_ms(spans, 50),
                "flush_p99_ms": sk_launch.percentile_ms(spans, 99),
                "flushes": len(flushes),
                "buckets": server.buckets_served - b0})
    finally:
        server.stop()
    check(len(answers) == len(queries), f"served {len(answers)} of "
          f"{len(queries)} requests")
    check(op.counts["cross_sweeps"] == server.buckets_served,
          f"{op.counts['cross_sweeps']} cross launches for "
          f"{server.buckets_served} buckets")
    rows = sum(len(q) for q, _ in queries)
    mid = sorted(passes, key=lambda r: r["p99_ms"])[len(passes) // 2]
    for i, r in enumerate(passes):
        log(f"serve_kernel server pass {i}: p50 {r['p50_ms']:.2f} ms, p99 "
            f"{r['p99_ms']:.2f} ms, {r['req_per_s']:.1f} req/s; wait before "
            f"the flush p50 {r['wait_p50_ms']:.2f} / p99 "
            f"{r['wait_p99_ms']:.2f} ms, flush p50 {r['flush_p50_ms']:.2f} / "
            f"p99 {r['flush_p99_ms']:.2f} ms over {r['flushes']} flushes, "
            f"{r['buckets']} buckets")
    return {"p50_ms": mid["p50_ms"], "p99_ms": mid["p99_ms"],
            "req_per_s": mid["req_per_s"],
            "rows_per_s": rows * mid["req_per_s"] / len(queries),
            "passes": passes, "buckets": mid["buckets"],
            "flushes": mid["flushes"],
            "buckets_all_passes": server.buckets_served,
            "cross_sweeps_all_passes": op.counts["cross_sweeps"],
            "answers": [answers[i] for i in range(len(queries))]}


def _sk_appends(art, y) -> dict:
    """SK_APPEND_BATCHES appended batches in process: ``init_state``, then
    per batch ``append_rows`` (the one thin launch and the f64 refresh)
    and ``save_delta`` (the commit), each timed; the meter reads one
    ``append_sweeps`` tick of b·c entries a batch and nothing else."""
    op = CountingOperator(art.landmark_operator())
    init_ms, state = _wall_ms(lambda: tserve.init_state(art, y))
    append_ms, commit_ms = [], []
    batches = sk_launch.synth_batches(_sk_params(), SK_APPEND_BATCHES,
                                      SK_APPEND_ROWS)
    with tempfile.TemporaryDirectory(prefix="serve_kernel_append_") as d:
        for g, (Xb, yb) in enumerate(batches, 1):
            ms, (art, state, stats, delta) = _wall_ms(
                lambda: tserve.append_rows(art, state, Xb, yb, op=op))
            append_ms.append(ms)
            commit_ms.append(_wall_ms(
                lambda: tserve.save_delta(d, g, delta))[0])
            check(stats.generation == g, f"generation {stats.generation}")
    want = {"append_sweeps": SK_APPEND_BATCHES, "entries":
            SK_APPEND_BATCHES * SK_APPEND_ROWS * SK_C, "sweeps": 0,
            "fulls": 0, "cross_sweeps": 0}
    check({k: op.counts[k] for k in want} == want,
          f"append meter {op.counts}")
    log(f"serve_kernel appends in process ({SK_APPEND_BATCHES} x "
        f"{SK_APPEND_ROWS} rows): init_state {init_ms:.1f} ms; append_rows "
        f"{[round(v, 2) for v in append_ms]} ms; save_delta "
        f"{[round(v, 2) for v in commit_ms]} ms")
    return {"init_state_ms": init_ms, "append_rows_ms": append_ms,
            "save_delta_ms": commit_ms, "grown": art,
            "meter": {k: op.counts[k] for k in want}}


def _run_cli(args: list, what: str) -> tuple:
    """``python -m repro_torch.launch.serve_kernel`` in a fresh process;
    returns (stdout, wall ms).  Fails unless it exits 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_kernel", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    wall_ms = (time.perf_counter() - t0) * 1e3
    for ln in res.stdout.splitlines():
        log(f"  cli {what}: {ln}")
    check(res.returncode == 0, f"serve_kernel --{what} exited "
          f"{res.returncode}: {res.stderr[-3000:]}")
    return res.stdout, wall_ms


def _parse(pattern: str, text: str, what: str):
    m = re.search(pattern, text)
    check(m is not None, f"the CLI printed no {what}")
    return m.groups()


def _sk_cli() -> dict:
    """The two CLI legs in two fresh processes: --build, then a warm
    --serve with the append leg."""
    _sync()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="serve_kernel_cli_") as d:
        common = ["--dir", d, "--device", DEV]
        out_b, build_wall = _run_cli(
            ["--build", *common, "--n", str(SK_N), "--d", str(D), "--c",
             str(SK_C), "--s", str(SK_S), "--sigma", str(SK_SIGMA),
             "--queries", str(SK_QUERIES)], "build")
        out_s, serve_wall = _run_cli(
            ["--serve", *common, "--require-warm", "--append-batches",
             str(SK_APPEND_BATCHES), "--append-rows", str(SK_APPEND_ROWS)],
            "serve")
    check("serve ok" in out_s.splitlines()[-1:], "the CLI did not print "
          "serve ok")
    (gap,) = _parse(r"replayed \d+ queries: parity (\S+)", out_s, "parity")
    sweeps, buckets = _parse(r"launches: (\d+) cross sweeps over (\d+) "
                             r"buckets", out_s, "launches")
    p50, p99 = _parse(r"latency: p50 (\S+) ms  p99 (\S+) ms", out_s,
                      "latency")
    (app_p50,) = _parse(r"append: absorbed .* p50 (\S+) ms", out_s,
                        "append latency")
    (meter,) = _parse(r"append: meter (\{.*\})", out_s, "append meter")
    (grown,) = _parse(r"grown-corpus parity (\S+)", out_s, "grown parity")
    (bitwise,) = _parse(r"delta-chain restore bitwise (\S+)", out_s,
                        "restore")
    (build_ms,) = _parse(r"built in (\S+) ms", out_b, "build time")
    (trace_ms,) = _parse(r"\((\S+) ms with the oracles\)", out_b,
                         "trace time")
    peaks = re.findall(r"peak device memory (\S+) GB", out_b + out_s)
    meter = json.loads(meter)
    res = {"trace_parity": float(gap), "cross_sweeps": int(sweeps),
           "buckets": int(buckets), "p50_ms": float(p50),
           "p99_ms": float(p99), "append_p50_ms": float(app_p50),
           "append_meter": meter, "grown_parity": float(grown),
           "restore_bitwise": bitwise == "True",
           "build_ms": float(build_ms), "trace_with_oracles_ms":
           float(trace_ms),
           "peak_gb_build": float(peaks[0]) if peaks else None,
           "peak_gb_serve": float(peaks[-1]) if peaks else None,
           "build_process_ms": build_wall, "serve_process_ms": serve_wall}
    check(res["trace_parity"] <= TOL_SERVE, f"CLI parity {gap}")
    check(res["cross_sweeps"] == res["buckets"], "CLI launches != buckets")
    check(meter == {"append_sweeps": SK_APPEND_BATCHES, "sweeps": 0,
                    "fulls": 0, "cross_sweeps": 0},
          f"the append leg touched the kernel beyond its launches: {meter}")
    check(res["grown_parity"] <= TOL_SERVE, f"grown parity {grown}")
    check(res["restore_bitwise"], "the delta chain did not restore bitwise")
    log(f"serve_kernel CLI latency: p50 {res['p50_ms']:.2f} ms, p99 "
        f"{res['p99_ms']:.2f} ms over {SK_QUERIES} queries")
    log(f"serve_kernel CLI append p50 {res['append_p50_ms']:.2f} ms "
        f"({SK_APPEND_BATCHES} x {SK_APPEND_ROWS} rows)")
    return res


def _sk_cross(art) -> dict:
    """B1 alone at one full bucket (SK_BUCKET_ROWS query rows against the
    artifact's c landmarks, every head: M = 1 + 8 + c) and at the append
    shape (SK_APPEND_ROWS rows, V = I_c)."""
    spec = art.spec
    XL = art.X_landmarks
    heads = tuple(art.heads[t] for t in tserve.TASKS)
    M = sum(int(h.shape[1]) for h in heads)
    rng = np.random.default_rng(9)
    Xq = torch.as_tensor(rng.standard_normal((SK_BUCKET_ROWS, D)),
                         dtype=torch.float32, device=DEV)

    def cross():
        return kernel.pairwise_matmat_multi_cuda(spec, Xq, XL, heads)

    ms, outs = cuda_ms(cross, reps=50, warmup=5)
    plain_ms, plain = cuda_ms(
        lambda: kernel.pairwise_matmat_multi_plain(spec, Xq, XL, heads),
        reps=50, warmup=5)
    err = max(scaled_err(o, p) for o, p in zip(outs, plain))
    abs_err = max(float((o - p).abs().max()) for o, p in zip(outs, plain))
    check(err <= TOL_F32, f"B1 at the bucket shape vs plain: {err:.3g}")
    # one call's latency (a synchronize after each) against the card's time
    lat = [_wall_ms(cross)[0] for _ in range(50)]
    dev_ms = _kernel_device_ms(cross, reps=20)
    device_ms = sum(dev_ms.values())
    nbytes = 4 * (SK_BUCKET_ROWS * D + SK_C * D + SK_C * M
                  + SK_BUCKET_ROWS * M)
    bound, bound_by = route_bound(spec, SK_BUCKET_ROWS, SK_C, D, M, nbytes)
    scratch = scratch_bytes(spec, SK_BUCKET_ROWS, SK_C, D, M, False)

    # the append launch: B1 with the identity, held to B2's entries bit for
    # bit (ROADMAP C2) and to the plain version
    Xn = torch.as_tensor(sk_launch.synth_batches(_sk_params(), 1,
                                                 SK_APPEND_ROWS)[0][0],
                         device=DEV)
    eye = (torch.eye(SK_C, device=DEV),)
    app_ms, (G,) = cuda_ms(
        lambda: kernel.pairwise_matmat_multi_cuda(spec, Xn, XL, eye),
        reps=50, warmup=5)
    app_plain_ms, (Gp,) = cuda_ms(
        lambda: kernel.pairwise_matmat_multi_plain(spec, Xn, XL, eye),
        reps=50, warmup=5)
    direct = kernel.pairwise_block_cuda(spec, Xn, XL)
    _sync()
    gap_b2 = float((G - direct).abs().max())
    gap_plain = float((G - Gp).abs().max())
    check(float(direct.abs().min()) >= 2.0 ** -104 and gap_b2 == 0.0,
          f"the append launch is not B2's entries bit for bit ({gap_b2})")
    check(scaled_err(G, Gp) <= TOL_F32, f"append vs plain {gap_plain}")
    app_bytes = 4 * (SK_APPEND_ROWS * D + SK_C * D + SK_C * SK_C
                     + SK_APPEND_ROWS * SK_C)
    app_bound, app_by = route_bound(spec, SK_APPEND_ROWS, SK_C, D, SK_C,
                                    app_bytes)
    res = {"cross_ms": ms, "cross_plain_ms": plain_ms,
           "cross_bound_ms": bound, "cross_bound_by": bound_by,
           "cross_err": err, "cross_max_abs_err": abs_err,
           "cross_latency_ms": float(np.median(lat)),
           "cross_device_ms": device_ms, "cross_device_kernels": dev_ms,
           "cross_shape": {"nr": SK_BUCKET_ROWS, "nc": SK_C, "d": D, "M": M},
           "cross_scratch_bytes": scratch,
           "append_ms": app_ms, "append_plain_ms": app_plain_ms,
           "append_bound_ms": app_bound, "append_bound_by": app_by,
           "append_gap_vs_b2": gap_b2, "append_gap_vs_plain": gap_plain,
           "append_shape": {"nr": SK_APPEND_ROWS, "nc": SK_C, "d": D,
                            "M": SK_C}}
    log(f"B1 at the bucket shape ({SK_BUCKET_ROWS} x {SK_C}, d {D}, M {M}):"
        f" {ms:.4f} ms back to back, {res['cross_latency_ms']:.4f} ms a "
        f"call with a synchronize, {device_ms:.4f} ms on the card "
        f"({json.dumps(dev_ms)}); plain {plain_ms:.4f} ms, bound "
        f"{bound:.5f} ms ({bound_by}); vs plain {err:.3g}; scratch "
        f"{scratch} bytes")
    log(f"B1 at the append shape ({SK_APPEND_ROWS} x {SK_C}, V = I): "
        f"{app_ms:.4f} ms, plain {app_plain_ms:.4f} ms, bound "
        f"{app_bound:.5f} ms ({app_by}); vs B2 {gap_b2:.3g} (bit for bit), "
        f"vs plain {gap_plain:.3g} (max abs)")
    return res


def phase_serve_kernel() -> dict:
    """Kernel-model serving: build, warm boot, a mixed batch in f32 and
    bf16, and a KernelServer over the trace (the counted path); B1 timed
    alone at the bucket and append shapes; the CLI in two processes."""
    X, y = sk_launch.synth_problem(SK_N, D, SK_SEED)
    queries = sk_launch.trace_queries(SK_QUERIES, D, SK_SEED)
    # warm-ups of the build, under the profiler: its device time by class
    prof = _device_profile(lambda: _sk_build(X, y))
    _sync()
    reset_counts()
    build_ms, art = _wall_ms(lambda: _sk_build(X, y))
    build_launches = read_counts()

    def cold():
        raise SmokeFailure("the warm boot rebuilt the artifact")

    with tempfile.TemporaryDirectory(prefix="serve_kernel_") as store:
        save_ms, _ = _wall_ms(lambda: tserve.save_artifact(store, art))
        boot_ms, (warm, rec) = _wall_ms(
            lambda: tserve.load_or_rebuild(store, cold, device=DEV))
    mixed = [tserve.QueryRequest(q, t) for q, t in queries[:SK_MAX_BATCH]]
    n_buckets = len(tserve.plan_buckets(mixed))
    qop = CountingOperator(warm.landmark_operator())
    mixed_ms, res32 = _wall_ms(
        lambda: tserve.serve_kernel_model(warm, mixed, op=qop))
    bop = CountingOperator(warm.landmark_operator(precision="bf16_f32acc"))
    res16 = tserve.serve_kernel_model(warm, mixed, op=bop)
    srv = _sk_server(warm, queries)
    app = _sk_appends(warm, y)
    launches = read_counts()

    log(f"serve_kernel (n={SK_N}, d={D}, c={SK_C}, s={SK_S}, rbf σ "
        f"{SK_SIGMA}): build {build_ms:.1f} ms, save {save_ms:.1f} ms, "
        f"warm boot {boot_ms:.1f} ms ({[e.kind for e in rec.events]}); "
        f"build launches {json.dumps(build_launches)}")
    if "error" not in prof:
        log(f"serve_kernel build on the card: busy {prof['busy_ms']:.1f} of "
            f"{prof['wall_ms']:.1f} ms wall, by class "
            f"{json.dumps(prof['by_class_ms'])}")
    log(f"serve_kernel launches {json.dumps(launches)}")
    expect = 1 + 2 * n_buckets + srv["buckets_all_passes"] \
        + SK_APPEND_BATCHES
    check(launches == no_launches(pairwise_matmat_multi=expect),
          f"serve_kernel should launch B1 once per build, bucket, server "
          f"bucket and appended batch ({expect}) and nothing else: "
          f"{launches}")
    check(build_launches == no_launches(pairwise_matmat_multi=1),
          f"build_artifact should be one B1 launch: {build_launches}")
    # the build's launch (50,000 rows, M = c + s with the C gather) held
    # against its plain version: C entry by entry, and U against the build
    # on the plain operator with the same draws
    plain = _sk_build(X, y, use_kernel=False)
    check(torch.equal(plain.landmark_indices, art.landmark_indices),
          "the plain build drew other landmarks")
    build_c_err = scaled_err(art.C, kernel.pairwise_block_plain(
        art.spec, torch.as_tensor(X, device=DEV), art.X_landmarks))
    build_u_err = scaled_err(art.U, plain.U)
    del plain
    check(build_c_err <= TOL_F32, f"build C vs plain {build_c_err:.3g}")
    check(build_u_err <= TOL_U, f"build U vs plain {build_u_err:.3g}")
    log(f"serve_kernel build vs its plain version: C {build_c_err:.3g}, "
        f"U {build_u_err:.3g}")
    check(rec.warm, f"boot events {rec.events}")
    for f in ("X_landmarks", "C", "U", "woodbury_M", "kpca_eigvals",
              "landmark_indices"):
        check(torch.equal(getattr(warm, f), getattr(art, f)),
              f"warm boot changed {f}")
    for t in tserve.TASKS:
        check(torch.equal(warm.heads[t], art.heads[t]),
              f"warm boot changed head {t}")
    check(qop.counts["cross_sweeps"] == n_buckets == bop.counts[
        "cross_sweeps"] and bop.last_route == "fused_rows+bf16_f32acc",
        f"mixed batch: {qop.counts} {bop.counts} {bop.last_route}")
    gaps = {t: 0.0 for t in tserve.TASKS}
    gaps16 = dict(gaps)
    for r, r16, q in zip(res32, res16, mixed):
        want = tserve.dense_oracle(warm, q.X, q.task)
        gaps[q.task] = max(gaps[q.task], tserve.parity_gap(r.out, want))
        gaps16[q.task] = max(gaps16[q.task],
                             tserve.parity_gap(r16.out, r.out))
    for t in tserve.TASKS:
        check(gaps[t] <= TOL_SERVE, f"{t} vs dense_oracle {gaps[t]:.3g}")
        check(gaps16[t] <= TOL_BF16_F32, f"{t} bf16 vs f32 {gaps16[t]:.3g}")
    grown = app.pop("grown")
    Xq = np.random.default_rng(12).standard_normal((17, D))
    app["grown_gaps"] = {t: tserve.parity_gap(
        grown.landmark_operator().cross(Xq, (grown.heads[t],))[0],
        tserve.dense_oracle(grown, Xq, t)) for t in ("kpca", "features")}
    check(max(app["grown_gaps"].values()) <= TOL_SERVE,
          f"grown corpus vs dense_oracle {app['grown_gaps']}")
    del grown
    srv_gap = max(tserve.parity_gap(a.out, r.out) for a, r in zip(
        srv["answers"][:SK_MAX_BATCH], res32))
    check(srv_gap <= 1e-6, f"server answers vs the batch's {srv_gap:.3g}")
    log(f"serve_kernel mixed batch of {len(mixed)} requests, {n_buckets} "
        f"buckets: {mixed_ms:.2f} ms; vs dense_oracle (f64) "
        f"{json.dumps(gaps)}; bf16_f32acc vs f32 {json.dumps(gaps16)}")
    log(f"serve_kernel server ({SK_CLIENTS} clients, {SK_QUERIES} queries, "
        f"max_batch {SK_MAX_BATCH}, max_wait {SK_MAX_WAIT_MS} ms; the "
        f"median of {SK_SERVER_PASSES} passes by p99): p50 "
        f"{srv['p50_ms']:.2f} ms, p99 {srv['p99_ms']:.2f} ms, "
        f"{srv['req_per_s']:.1f} req/s, {srv['rows_per_s']:.0f} rows/s, "
        f"{srv['buckets']} buckets in {srv['flushes']} flushes")
    # the build's host share: the Gaussian sketch drawn from a CPU generator
    draw_ms, _ = _wall_ms(lambda: sk.GaussianSketch.draw(
        SK_N, SK_S, generator=torch.Generator().manual_seed(SK_SEED),
        device=DEV))
    log(f"serve_kernel build's sketch draw ({SK_N} x {SK_S} from a CPU "
        f"generator, moved to the card): {draw_ms:.1f} ms")
    kern = _sk_cross(warm)
    del warm, art, res32, res16
    cli = _sk_cli()
    srv.pop("answers")
    return {"launches": launches, "build_ms": build_ms, "save_ms": save_ms,
            "sketch_draw_ms": draw_ms, "appends": app,
            "warm_boot_ms": boot_ms, "build_launches": build_launches,
            "build_C_err_vs_plain": build_c_err,
            "build_U_err_vs_plain": build_u_err,
            "build_profile": prof, "mixed_batch_ms": mixed_ms,
            "mixed_buckets": n_buckets, "parity_vs_dense_oracle": gaps,
            "bf16_vs_f32": gaps16, "server": srv, **kern, "cli": cli}


def phase_ragged() -> dict:
    """``fast_model_ragged`` at the README's settings over RAGGED_SIZES
    (the letters data): one B1 launch per item; each item's C and U equal
    the unbatched ``fast_model`` on the same padded item and draws bit for
    bit, and are held against the plain version (C entry by entry, U
    against ``fast_model`` on the plain operator); the padded heights
    those of ``bucket_by_size``."""
    sizes = list(RAGGED_SIZES)
    Xs = [letters(n, seed=70 + i) for i, n in enumerate(sizes)]
    buckets = spsd.bucket_by_size(sizes, RAGGED_WASTE)
    n_pad = {i: max(sizes[j] for j in b) for b in buckets for i in b}
    g = gen(71)
    idx = [torch.randperm(n, generator=g, device=DEV)[:RAGGED_C]
           for n in sizes]
    S = [sk.GaussianSketch.draw(n_pad[i], RAGGED_S, generator=g, device=DEV)
         for i in range(len(sizes))]
    heights = []

    def make_op(Xp):
        heights.append(int(Xp.shape[0]))
        return RBFKernel(Xp, sigma=RAGGED_SIGMA, device=DEV)

    _sync()
    reset_counts()
    ms, outs = _wall_ms(lambda: spsd.fast_model_ragged(
        Xs, make_op, RAGGED_C, RAGGED_S, waste=RAGGED_WASTE,
        s_sketch="gaussian", idx=idx, S=S))
    launches = read_counts()
    check(launches == no_launches(pairwise_matmat_multi=len(sizes)),
          f"ragged: one B1 launch per item: {launches}")
    check(heights == [n_pad[i] for b in buckets for i in b],
          f"padded heights {heights} are not bucket_by_size's {buckets}")
    spec = specs.rbf(RAGGED_SIGMA)
    c_err, u_err = [], []

    def one(i, use_kernel):
        return spsd.fast_model(
            RBFKernel(spsd.pad_rows(Xs[i], n_pad[i]), sigma=RAGGED_SIGMA,
                      use_kernel=use_kernel, device=DEV),
            RAGGED_C, RAGGED_S, s_sketch="gaussian", n_valid=sizes[i],
            idx=idx[i], S=S[i])

    for i, (X, o) in enumerate(zip(Xs, outs)):
        fast = one(i, True)
        check(tuple(o.C.shape) == (sizes[i], RAGGED_C)
              and torch.equal(o.C, fast.C[:sizes[i]])
              and torch.equal(o.U, fast.U),
              f"ragged item {i} differs from the unbatched model")
        check(bool(torch.isfinite(o.U).all()), f"ragged item {i}: U")
        c_err.append(scaled_err(o.C, kernel.pairwise_block_plain(
            spec, X, X[idx[i]])))
        u_err.append(scaled_err(o.U, one(i, False).U))
        check(c_err[-1] <= TOL_F32, f"ragged item {i}: C vs plain "
              f"{c_err[-1]:.3g}")
        check(u_err[-1] <= TOL_U, f"ragged item {i}: U vs the plain "
              f"operator's {u_err[-1]:.3g}")
    log(f"ragged: {len(sizes)} items n = {sizes}, buckets {buckets} "
        f"(padded to {sorted(set(n_pad.values()))}), {ms:.1f} ms, "
        f"launches {launches['pairwise_matmat_multi']}; each item equal to "
        f"the unbatched model bit for bit; vs the plain version C "
        f"{max(c_err):.3g}, U {max(u_err):.3g} (worst item)")
    return {"ms": ms, "launches": launches, "buckets": buckets,
            "sizes": sizes, "C_err_vs_plain": c_err, "U_err_vs_plain": u_err}


# ---------------------------------------------------------------------------
# calibration and the contract checks
# ---------------------------------------------------------------------------

def _calibrate_pass(X, idx, S, Z, names, metered: bool) -> dict:
    """``calibrate_sigma`` for every spec in ``names`` (128 anchors from a
    seeded generator), then ``fast_model_with_error`` on each calibrated
    spec that has a scale; with ``metered`` each statistic operator is a
    ``CountingOperator``, else ``calibrate_sigma`` builds its own."""
    out = {}
    for name in names:
        base = specs.suggested_spec(name, D)
        opc = CountingOperator(PairwiseKernel(
            X, base, device=DEV).stat_operator()) if metered else None
        ms, cal = _wall_ms(lambda: calibrate.calibrate_sigma(
            X, base, anchors=CAL_ANCHORS, generator=gen(70), stat_op=opc,
            device=DEV))
        out[name] = {"spec": cal, "ms": ms,
                     "counts": dict(opc.counts) if metered else None}
    for name in names:
        if not calibrate.calibration_rule(name).needs_stat:
            continue
        op = PairwiseKernel(X, out[name]["spec"], device=DEV)
        ms, (_, err) = cuda_ms(lambda: spsd.fast_model_with_error(
            op, C_COLS, S_COLS, s_sketch="gaussian", probes=PROBES, idx=idx,
            S=S, Z=Z))
        out[name].update(fit_ms=ms, err_h=float(err))
    return out


def _close(a: float, b: float, rel: float) -> bool:
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-30)


def phase_calibrate() -> dict:
    """``calibrate_sigma`` on the main path's data for every spec with a
    rule: one statistic-only B2 launch of 50,000 × 128 each (none for
    linear), metered as one n·m ``columns`` gather; the panel held to its
    plain version (sqdist and l1dist never negative, the self-pairs
    included) and each parameter to the plain panel's quantile; the
    512-anchor panel's quantile to numpy's; then ``fast_model_with_error``
    on each calibrated spec (one B1 launch each), and sampled rows of that
    B1 launch held to the plain version."""
    X, _, idx, S, Z = _main_inputs()
    names = calibrate.registered_calibrations()
    with_stat = [n for n in names if calibrate.calibration_rule(n).needs_stat]
    warm = _calibrate_pass(X, idx, S, Z, names, metered=False)
    _sync()
    reset_counts()
    res = _calibrate_pass(X, idx, S, Z, names, metered=True)   # counted
    launches = read_counts()
    check(launches == no_launches(pairwise_block=len(with_stat),
                                  pairwise_matmat_multi=len(with_stat)),
          f"calibrate: one B2 and one B1 launch per spec with a scale: "
          f"{launches}")
    entries = N * CAL_ANCHORS
    for name in names:
        r, c = res[name], res[name]["counts"]
        check(r["spec"] == warm[name]["spec"],
              f"calibrate {name}: the metered and default statistic "
              f"operators disagree")
        want = {"columns": 1, "entries": entries} if name in with_stat \
            else {"columns": 0, "entries": 0}
        check(c["columns"] == want["columns"]
              and c["entries"] == want["entries"] and c["sweeps"] == 0
              and c["fulls"] == 0 and c["blocks"] == 0,
              f"calibrate {name}: meter {c}")

    # B1 under each calibrated spec, as fast_model_with_error launched it:
    # sampled rows of K(X, X)·[C one-hot | S | Z] against the plain version
    Vs = (sweep_lib.one_hot_columns(idx, N, DEV), S.mat, Z)
    rows = torch.randperm(N, generator=gen(72), device=DEV)[:CAL_B1_ROWS]
    for name in with_stat:
        sp = res[name]["spec"]
        outs = kernel.pairwise_matmat_multi_cuda(sp, X, X, Vs)
        plain = kernel.pairwise_matmat_multi_plain(sp, X[rows], X, Vs)
        e = max(scaled_err(o[rows], p) for o, p in zip(outs, plain))
        check(e <= TOL_F32_MAIN, f"B1 {sp.name} rows vs plain: {e:.3g}")
        res[name]["b1_rows_err_vs_plain"] = e
        del outs, plain

    # the statistic-only B2 launch at calibration's shape, per statistic
    anchors = calibrate.anchor_indices(gen(70), N, CAL_ANCHORS)
    Xa = X[anchors].contiguous()
    cols = torch.arange(CAL_ANCHORS, device=DEV)
    nbytes = 4 * (N * D + CAL_ANCHORS * D + N * CAL_ANCHORS)
    stat_lines, plains = {}, {}
    for stat in ("sqdist", "l1dist", "dot"):
        sp = specs.stat_only(stat)
        ms, out = cuda_ms(lambda: kernel.pairwise_block_cuda(sp, X, Xa),
                          reps=20, warmup=2)
        plain_ms, plain = cuda_ms(
            lambda: kernel.pairwise_block_plain(sp, X, Xa), reps=5, warmup=1)
        err = scaled_err(out, plain)
        check(err <= TOL_F32, f"B2 {sp.name} vs plain: {err:.3g}")
        line = {"ms": ms, "plain_ms": plain_ms, "scaled_err": err,
                "max_abs_err": float((out - plain).abs().max())}
        if stat != "dot":
            neg = int((out < 0).sum())
            self_pairs = out[anchors, cols]
            check(neg == 0 and float(self_pairs.min()) >= 0.0,
                  f"B2 {sp.name}: {neg} negative entries, self-pairs "
                  f"min {float(self_pairs.min())}")
            line.update(negative_entries=neg,
                        self_pairs_max=float(self_pairs.max()))
        line["device_ms_by_kernel"] = _kernel_device_ms(
            lambda: kernel.pairwise_block_cuda(sp, X, Xa))
        line["bound_ms"], line["bound_by"] = route_bound(
            sp, N, CAL_ANCHORS, D, 0, nbytes)
        line["roofline"] = work_roofline(sp, N, CAL_ANCHORS, D, 0, ms)
        stat_lines[sp.name] = line
        plains[stat] = plain
        del out
    # one PyTorch call each for the statistics that have one
    library = {"stat[dot]": ("torch.mm(X, Xa.T)", "dot",
                             lambda: torch.mm(X, Xa.T)),
               "stat[l1dist]": ("torch.cdist(X, Xa, p=1)", "l1dist",
                                lambda: torch.cdist(X, Xa, p=1))}
    for key, line in stat_lines.items():
        line["library_ms"] = line["library_call"] = None
        if key not in library:
            continue
        call, stat, fn = library[key]
        lib_ms, lib_out = cuda_ms(fn, reps=20, warmup=2)
        lib_err = scaled_err(lib_out, plains[stat])
        check(lib_err <= TOL_F32, f"{call} vs the {stat} statistic: "
              f"{lib_err:.3g}")
        line.update(library_ms=lib_ms, library_call=call,
                    library_err_vs_plain=lib_err)
        del lib_out

    # each parameter against the plain panel's quantile (torch.quantile)
    for name in with_stat:
        rule = calibrate.calibration_rule(name)
        base = specs.suggested_spec(name, D)
        P = plains[base.stat]
        if rule.transform is not None:
            P = rule.transform(P)
        want = rule.apply(float(torch.quantile(P.reshape(-1), 0.5)), base)
        got = res[name]["spec"]
        check(got.name == want.name and all(
            _close(float(a), float(b), TOL_CAL)
            for (_, a), (_, b) in zip(got.params, want.params)),
            f"calibrate {name}: {got.params} vs the plain panel's "
            f"{want.params}")
    del plains

    # 512 anchors: 25.6 M values, against numpy's quantile of the plain panel
    wide = calibrate.anchor_indices(gen(71), N, CAL_ANCHORS_WIDE)
    opw = CountingOperator(PairwiseKernel(X, specs.stat_only("sqdist"),
                                          device=DEV))
    q_ms, qv = _wall_ms(lambda: float(calibrate.stat_quantile(
        opw, anchor_idx=wide)))
    check(opw.counts["columns"] == 1
          and opw.counts["entries"] == N * CAL_ANCHORS_WIDE,
          f"512-anchor meter {opw.counts}")
    host = kernel.pairwise_block_plain(
        specs.stat_only("sqdist"), X, X[wide]).cpu().numpy().reshape(-1)
    q_np = float(np.quantile(host, np.float64(0.5)))
    check(_close(qv, q_np, TOL_CAL),
          f"512-anchor quantile {qv} vs numpy's {q_np}")
    del host

    for name in names:
        r = res[name]
        log(f"calibrate {name}: {dict(r['spec'].params)} in {r['ms']:.3f} ms"
            + (f"; fast_model_with_error {r['fit_ms']:.3f} ms, Hutchinson "
               f"error {r['err_h']:.6f}, B1 {CAL_B1_ROWS} rows vs plain "
               f"{r['b1_rows_err_vs_plain']:.3g}" if name in with_stat else
               " (no gather)"))
        if name in with_stat:
            check(np.isfinite(r["err_h"]) and r["err_h"] >= 0,
                  f"calibrate {name}: error {r['err_h']}")
    for k, v in stat_lines.items():
        log(f"B2 {k} ({N} x {CAL_ANCHORS}, d = {D}): {v['ms']:.4f} ms, plain "
            f"{v['plain_ms']:.4f} ms, route bound {v['bound_ms']:.4f} ms "
            f"({v['bound_by']}), work roofline "
            f"{v['roofline']['roofline_s'] * 1e3:.5f} ms, vs plain "
            f"{v['scaled_err']:.3g}; device ms by kernel "
            f"{json.dumps(v['device_ms_by_kernel'])}"
            + (f", negative entries {v['negative_entries']}, self-pairs "
               f"max {v['self_pairs_max']:.3g}" if "negative_entries" in v
               else ""))
    for k, v in stat_lines.items():
        if v["library_ms"] is not None:
            log(f"B2 {k} like for like: {v['library_call']} "
                f"{v['library_ms']:.4f} ms (vs plain "
                f"{v['library_err_vs_plain']:.3g})")
    log(f"512-anchor quantile {qv:.6f} (numpy {q_np:.6f}) in {q_ms:.3f} ms")
    log(f"calibrate path launches {json.dumps(launches)}")
    return {"launches": launches,
            "specs": {n: {"params": dict(res[n]["spec"].params),
                          "ms": res[n]["ms"], "counts": res[n]["counts"],
                          **({"fit_ms": res[n]["fit_ms"],
                              "err_h": res[n]["err_h"],
                              "b1_rows_err_vs_plain":
                                  res[n]["b1_rows_err_vs_plain"]}
                             if n in with_stat else {})}
                      for n in names},
            "statistic_only": {
                "shape": {"nr": N, "nc": CAL_ANCHORS, "d": D},
                "by_statistic": stat_lines,
                "wide_anchors": CAL_ANCHORS_WIDE, "wide_quantile": qv,
                "wide_quantile_numpy": q_np, "wide_quantile_ms": q_ms}}


def phase_contracts() -> dict:
    """The port's contract checks (``repro_torch.analysis.trace_check``,
    RPRJ01–RPRJ03) at the main path's size on the card, then every
    ``rbf_sketch`` wrapper held bit for bit to the pairwise launch it binds
    and counted as that launch.  RPRJ03 sees only the torch-level ops
    around a CUDA launch, not the kernel's own accumulation (held instead
    by the parity phase's bf16_f32acc cases): the contractions it scanned
    are logged and returned, and no claim is made for the kernel."""
    size = trace_check.TraceSize(n=N, d=D, c=C_COLS, s=S_COLS, block=None,
                                 device=DEV)
    _sync()
    reset_counts()
    t0 = time.perf_counter()
    findings, reports = trace_check.run_trace_checks(size=size)
    secs = time.perf_counter() - t0
    tc_launches = read_counts()
    for f in findings:
        log(f"contracts: {f.format()}")
    check(not findings, f"contracts: {len(findings)} finding(s)")
    block = sweep_lib.resolved_block_size(N, N, None)
    fused_entries = sweep_lib.num_panels(N, N, None) * block * N
    by = {r["entry"]: r["counts"] for r in reports}
    for entry in ("fast_model[uniform]", "fast_model_with_error[uniform]"):
        check(by[entry]["entries"] == fused_entries,
              f"contracts {entry}: {by[entry]['entries']} entries, the "
              f"count model says {fused_entries}")
    check(tc_launches["pairwise_matmat_multi"] > 0
          and tc_launches["pairwise_block"] > 0
          and tc_launches["pairwise_matmat_multi_slab"] == 0
          and tc_launches["landmark_read"] == 0
          and tc_launches["flash_attention"] == 0,
          f"contracts launches {tc_launches}")
    log(f"contracts (n={N}, d={D}, c={C_COLS}, s={S_COLS}): {len(reports)} "
        f"entry runs, 0 findings, {secs:.1f} s; threshold n²/2 = "
        f"{N * N // 2:,} elements")
    rprj03 = {r["entry"]: {"contractions_scanned": r["contractions_scanned"],
                           "low_precision_ops": r["low_precision_ops"]}
              for r in reports if "bf16_f32acc" in r["entry"]}
    log(f"contracts: RPRJ03 on the card scans the torch-level ops only, "
        f"not inside the kernel; bf16_f32acc entries {json.dumps(rprj03)}")
    for r in reports:
        log(f"  {r['entry']}: sweeps {r['counts']['sweeps']}, columns "
            f"{r['counts']['columns']}, cross {r['counts']['cross_sweeps']}, "
            f"append {r['counts']['append_sweeps']}, entries "
            f"{r['counts']['entries']:,}")

    # the rbf_sketch wrappers: each the launch it binds
    X, _, idx, S, Z = _main_inputs()
    Xr, Xs = X[:block].contiguous(), X[idx].contiguous()
    z = Z[:, :1].contiguous()
    before = read_counts()
    wrapped = {
        "rbf_block": rbf_ops.rbf_block(Xr, X, SIGMA),
        "rbf_block_padded": rbf_kernel.rbf_block_padded(Xr, X, SIGMA),
        "sketched_gram": rbf_ops.sketched_gram(Xs, SIGMA),
        "rbf_matmat": rbf_ops.rbf_matmat(X, Z[:, 0], SIGMA),
        "rbf_matmat_multi": rbf_ops.rbf_matmat_multi(X, (S.mat, Z), SIGMA),
        "rbf_matmat_multi_rows": rbf_ops.rbf_matmat_multi_rows(
            Xr, X, (S.mat, Z), SIGMA),
        "rbf_matmat_padded": rbf_kernel.rbf_matmat_padded(Xr, X, z, SIGMA),
        "rbf_matmat_multi_padded": rbf_kernel.rbf_matmat_multi_padded(
            Xr, X, (S.mat, Z), SIGMA)}
    launches = read_counts()                       # the path's counts
    delta = {k: launches[k] - before[k] for k in launches}
    check(delta == no_launches(pairwise_block=3, pairwise_matmat_multi=5),
          f"rbf_sketch wrappers: 3 B2 and 5 B1 launches: {delta}")
    spec = specs.rbf(SIGMA)
    b1 = kernel.pairwise_matmat_multi_cuda
    direct = {
        "rbf_block": kernel.pairwise_block_cuda(spec, Xr, X),
        "rbf_block_padded": kernel.pairwise_block_cuda(spec, Xr, X),
        "sketched_gram": kernel.pairwise_block_cuda(spec, Xs, Xs),
        "rbf_matmat": b1(spec, X, X, (z,))[0][:, 0],
        "rbf_matmat_multi": b1(spec, X, X, (S.mat, Z)),
        "rbf_matmat_multi_rows": b1(spec, Xr, X, (S.mat, Z)),
        "rbf_matmat_padded": b1(spec, Xr, X, (z,))[0],
        "rbf_matmat_multi_padded": b1(spec, Xr, X, (S.mat, Z))}
    same = {}
    for k, got in wrapped.items():
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = direct[k] if isinstance(direct[k], tuple) else (direct[k],)
        same[k] = len(got) == len(want) and all(
            torch.equal(a, b) for a, b in zip(got, want))
    check(all(same.values()), f"rbf_sketch wrappers vs their launches: "
          f"{same}")
    log(f"contracts: rbf_sketch wrappers bit for bit their launches "
        f"{json.dumps(same)}; launches {json.dumps(delta)}")
    log(f"contracts path launches {json.dumps(launches)}")
    return {"launches": launches, "reports": reports, "seconds": secs,
            "trace_launches": tc_launches, "rbf_sketch_launches": delta,
            "rprj03_torch_level": rprj03}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    phase_card()
    phase_build()
    phase_parity()
    phase_parity_slab()
    phase_parity_read()
    phase_parity_flash()
    m = phase_main()
    phase_scaling()
    b1, b2 = _b1_line(m), _b2_line(m)
    sh = phase_spsd_sharded(m)
    b4 = _b4_line(m, sh)
    att = phase_attention_long()
    pol = phase_attention_policy()
    srv = phase_serve_gemma3()
    b6 = _flash_line(srv)
    moe = phase_serve_moe()
    mla = phase_serve_mla()
    dense = phase_serve_dense_configs()
    skm = phase_serve_kernel()
    rag = phase_ragged()
    cal = phase_calibrate()
    con = phase_contracts()
    # each path's counts were reset just before it and read just after
    paths = {"spsd_main": m["launches"], "spsd_sharded": sh["launches"],
             "attention_long": att["launches"],
             "attention_policy": pol["launches"],
             "serve_gemma3": srv["launches"], "serve_moe": moe["launches"],
             "serve_mla": mla["launches"],
             "serve_dense_configs": dense["launches"],
             "serve_kernel": skm["launches"], "spsd_ragged": rag["launches"],
             "calibrate": cal["launches"], "contracts": con["launches"]}
    for line, key in ((b1, "pairwise_matmat_multi"), (b2, "pairwise_block"),
                      (b4, "pairwise_matmat_multi_slab"),
                      (att["line"], "landmark_read"), (b6, "flash_attention")):
        line["launches_by_path"] = {p: c[key] for p, c in paths.items()}
    b4["spsd_sharded"] = {
        "ranks": WORLD, "panels": sh["panels"], "block": sh["block"],
        "slab_rows": sh["slab"], "entries_per_sweep": sh["entries"],
        "fast_model_with_error_ms": [
            i["calls"]["fast_model_with_error"]["ms"] for i in sh["infos"]],
        "all_reduce_ms": [i["all_reduce_ms"] for i in sh["infos"]],
        "all_reduce_bytes": sh["infos"][0]["all_reduce_bytes"],
        "blocked_err_rel": sh["err_b_rel"], "cur_U_err": sh["cur_U_err"],
        "eig_rel": sh["eig_rel"], "misalignment": sh["misalignment"]}
    b1["serve_kernel"] = {
        **{k: skm[k] for k in (
            "build_ms", "save_ms", "warm_boot_ms", "build_launches",
            "build_C_err_vs_plain", "build_U_err_vs_plain",
            "sketch_draw_ms", "appends",
            "mixed_batch_ms", "mixed_buckets", "parity_vs_dense_oracle",
            "bf16_vs_f32", "server", "cli", "cross_ms", "cross_plain_ms",
            "cross_bound_ms", "cross_bound_by", "cross_err",
            "cross_max_abs_err", "cross_latency_ms", "cross_device_ms",
            "cross_device_kernels", "cross_shape", "cross_scratch_bytes",
            "append_ms", "append_plain_ms", "append_bound_ms",
            "append_bound_by", "append_gap_vs_b2", "append_gap_vs_plain",
            "append_shape")},
        "build_device_ms_by_class": skm["build_profile"].get("by_class_ms"),
        "ragged": {k: rag[k] for k in ("ms", "buckets", "sizes",
                                       "C_err_vs_plain", "U_err_vs_plain")},
        "ragged_launches": rag["launches"]["pairwise_matmat_multi"]}
    served = ("prefill_ms", "decode_ms_per_token", "generate_ms",
              "tokens_per_s", "decode_tokens_per_s", "peak_gb", "b6_prefill")
    b6["serve_gemma3"] = {k: srv[k] for k in served}
    for name, r in (("serve_moe", moe), ("serve_mla", mla)):
        b6[name] = {**{k: r[k] for k in served}, "moe_layer": r["moe_layer"],
                    "prefill_device_ms_by_class": r["profile"]["prefill"].get(
                        "by_class_ms"),
                    "decode_device_ms_by_class": r["profile"][
                        "decode_4_steps"].get("by_class_ms")}
    b6["serve_dense_configs"] = {
        name: {k: r[k] for k in served}
        for name, r in dense["configs"].items()}
    b6["model_shapes"] = [moe["b6_shape"], mla["b6_shape"],
                          dense["b6_shape"]]
    b2.update({"ms_exp_affine_policy_panel": pol["b2_panel"]["ms"],
               "plain_ms_exp_affine_policy_panel": pol["b2_panel"]["plain_ms"],
               "bound_ms_exp_affine_policy_panel": pol["b2_panel"]["bound_ms"],
               "exp_affine_policy_panel_shape": pol["b2_panel"]["shape"]})
    b2["statistic_only"] = cal["statistic_only"]
    b2["calibrate"] = cal["specs"]
    for line in (b1, b2, b4):
        rows = {k: v for k, v in line.items() if k.startswith("roofline")}
        rows.update({f"statistic_only {k}": v["roofline"] for k, v in
                     line.get("statistic_only", {}).get(
                         "by_statistic", {}).items()})
        for k, r in rows.items():
            tflop = (r["mxu_gflops"] + r["vpu_gflops"]) / 1e3
            log(f"{line['name']} {k}: work {tflop:.4g} TFLOP, "
                f"{r['hbm_gbytes']:.4g} GB; roofline "
                f"{r['roofline_s'] * 1e3:.5f} ms on {r['profile']} "
                f"({r['bottleneck']}), measured {r['measured_s'] * 1e3:.4f} "
                f"ms, achieved_frac {r['achieved_frac']:.4f}")
    kernels_line = {"kernels": [b1, b2, b4, att["line"], b6]}
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernels_line), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
