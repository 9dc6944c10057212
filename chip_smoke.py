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
   the landmark library's other kernels without spills; in the same
   ``build_all`` call, the user variants of the pairwise kernels for the
   four ``USER_SPECS`` (specs with only a Python ``entry_fn``, lowered to
   a generated epilogue): B1's and B2's kernels with 0 bytes of spills and
   no C7512 note, as the built-ins (a variant that spills is refused when
   it loads);
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
4c. user_spec: the reference's custom-kernel story on the card
   (``USER_SPECS``: cauchy 1/(1 + γ t) on sqdist at the README's γ = 0.5,
   a rational quadratic on l1dist, a compact ``torch.where`` entry on
   sqdist and exp(t/16) on dot, none registered; a sqdist variant takes
   the built-in tensor-core statistic with its near pairs summed
   directly): B1 and B2 of each
   spec × precision against their plain versions at phase 3's ragged shape
   (f32 ≤ 1e-5, bf16_f32acc ≤ 1e-2 and ≤ 5e-2 of f32), the one-hot gather
   exact, B4 at phase 3's slabs with its rows equal to B1's; then the main
   path's three calls with cauchy at n = 50,000 (route ``fused``, the
   meter's counts and every launch count equal to rbf's run), C against
   the plain version (≤ 1e-5) and against the f64 entries (≤ 1e-6, beside
   the plain version's and the built-in statistic's distance from them),
   U against the plain versions' U at the same draws; the built-in rbf at
   σ = 1 on the main path (C), B2's panel and B4's slab rows against the
   f64 statistic's entries (≤ 2e-6) and the plain version, with the share
   of near pairs; and B1, B2,
   B4 at their main-path shapes timed in turns beside rbf (B1 also for the
   other specs beside rbf or laplacian; B2's panel, which holds each
   point's pair with itself, against the f64 statistic's entries ≤ 1e-5
   and against the plain version ≤ 1e-5 unless the plain version lies
   farther from them), with each user library's nvcc seconds, registers
   and spills;
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
   ``scaled_dot_product_attention`` timed at the global shape, and at the
   local shape with an explicit sliding-window mask on the
   memory-efficient backend (the smoke model's card-against-CPU check
   lives in ``tests/test_torch_cuda.py``).
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
   yi's shape (D = 128, group 8);
7e. serve_recurrent: recurrentgemma-2b at full width and depth (26 layers:
   (rglru, rglru, local) x 8 + 2 rglru; d_model 2,560, lru_width 2,560,
   10 heads MQA x 256, window 2,048, d_ff 7,680 geglu, vocab 256,000), 2
   requests, a 32,768-token context, 16 tokens: 8 B6 launches a prefill
   (the local layers), none in decode; its 3-layer cut (one superblock) at
   long_500k's 524,288-token context, 1 request, 8 tokens, beside its
   32,768-token twin (1 B6 launch a prefill; decode's device time must
   not grow more than 2x with the context); xlstm-125m at full width and
   depth (6 mLSTM + 6 sLSTM layers, d_model 768, 4 x 192 heads, vocab
   50,304), 2 requests, a 4,096-token context, 16 tokens (no B6 launch),
   and one sLSTM layer's per-token loop timed; each with device ms by
   class (the recurrences' kernels classed by their profiler ranges: RG-LRU
   gates + scan and mLSTM chunks, the sLSTM step); then one layer of each
   mixer at full width, S = 512, the full pass's output and final state
   against the per-token decode scan (f32 ≤ 1e-5, bf16 ≤ 5e-2), and B6 at
   recurrentgemma's local shape (B = 2, Hq = 10, Hkv = 1, S = 32,768,
   D = 256, window 2,048) with SDPA under an explicit window mask beside
   it (as at gemma3's local shape).  ``phase_parity_flash`` holds B6 at these
   head shapes on both routes (D = Dv = 128 at groups 8 and 1, D = 192 /
   Dv = 128, also causal with Sq > Sk, and recurrentgemma's MQA group 10
   at D = 256 under a window);
   B6 is also held to its plain version at every shape of the reference's
   flash tests in f32 and bf16, and in bf16 at the tensor-core kernel's
   edge cases (ragged lengths, head dims 32–256, Dv ≠ D, decode, chunked
   prefill, non-causal with and without a window), each bf16 call one
   tensor-core launch and each f32 call none, and with Sq > Sk (causal)
   the rows that see no key exactly 0 on both routes
   (``phase_parity_flash``; also at whisper's head shape: 20 heads of 64,
   non-causal at 1,500 frames, the Sq = 1 cross read, causal);
7f. serve_whisper: whisper-large-v3 at full width and depth (32 encoder +
   32 decoder layers, d_model 1,280, 20 x 64 heads MHA, d_ff 5,120 gelu,
   vocab 51,866, frontend_dim 128; bf16 compute, f32 params, seeded
   weights and frames; the conv frontend stubbed as in the reference), a
   1-token decoder prompt and a 448-position decoder cache, one model
   served at two encoder lengths: (a) 16 requests of 1,500 frames (30 s of
   audio), 32 tokens; (b) decode_32k's encoder length from
   ``shapes_for`` / ``input_specs``, 32,768 frames, 2 requests (cut from
   128), 16 tokens.  Each: B6 96 times a prefill (32 encoder layers
   non-causal, 32 causal decoder self-attentions, 32 non-causal
   cross-attentions) and 32 times a decode step (the cross-attentions),
   all on the tensor cores; tokens in range, logits finite; device time by
   class with the encoder's and the cross-attention's B6 apart (their
   profiler ranges).  Then a 2 + 2-layer cut at full width, B = 2, 1,500
   frames: bf16 against f32 on the card, and decode against ``forward``,
   ≤ 5e-2; and B6 timed alone, non-causal, at the two encoder shapes and
   the Sq = 1 cross read against 32,768 keys, in the model's layout, held
   row by row to its plain version and f64 (bf16 ≤ 1e-2; f32 at 1,500
   frames ≤ 1e-5), with SDPA beside it;
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
   stat[l1dist], and its device time per call with 50 calls queued behind
   a spin kernel (no profiler);
11. contracts: ``repro_torch.analysis.trace_check`` at n = 50,000 (every
   entry point under the op recorder: no output of ≥ n²/2 = 1.25e9
   elements, the meters equal each policy's declared budget and the
   pipeline contracts, no bf16 contraction operand among the torch-level
   ops — the scan cannot see inside a CUDA launch), then every
   ``rbf_sketch`` wrapper bit for bit the B2 or B1 launch it binds, and
   counted as that launch;
11b. training.  train_grad: B6's autograd Function (the kernel's forward,
   ``attention_vjp``'s f32 backward) against torch autograd of the plain
   version at gemma3-12b's global and local train shapes (B 1, Hq 16, Hkv
   8, S 4,096, D 256; window 1,024), MLA's (Hq 16, S 2,048, D 192 / Dv
   128), whisper's encoder (Hq 20, S 1,500, D 64, non-causal) and
   recurrentgemma-2b's local layer (MQA: Hq 10, Hkv 1, S 4,096, D 256,
   window 2,048), bf16
   (≤ 5e-2) and f32 (≤ 1e-4), one forward launch on the dtype's route;
   the forward kernel, ``attention_vjp``, the plain forward + backward
   and SDPA's forward and backward timed.  train_gemma3: gemma3-12b at
   full width cut to one pattern period (5 local + 1 global layers), 4
   steps of ``launch.steps.make_train_step`` (adamw, peak lr 3e-4, 1
   warm-up step) on SyntheticLM(seed=0) batches of 2 × 4,096 tokens at
   accum 2: 24 B6 launches a step (forward and remat's recompute), all
   on the tensor cores, and nothing else; every parameter's gradient
   finite and nonzero on step 1; the losses finite; step ms (median of
   steps 2-4), tokens/s, MFU, peak memory, one more step's device time by
   class (B6, ``attention_vjp`` and the optimizer by their profiler
   ranges); then one step of the same model under each remat policy
   (``full``, ``none``, ``dots``, ``save_io``): step ms, peak
   memory, B6 launches.  train_moe: qwen2-moe-a2.7b at full width, 2
   layers, 3 steps of 1 × 4,096 tokens: ``aux`` in the metrics, the
   router's and experts' gradients finite and nonzero.  train_recurrent:
   recurrentgemma-2b at full width and depth (26 layers), 4 steps of 2 ×
   4,096 tokens at accum 2 (32 tensor-core B6 launches a step: 8 local
   layers, forward and recompute), and xlstm-125m at full width and
   depth, 3 steps of 2 × 2,048 tokens (cut from 4,096: host-bound on the
   sLSTM loop, plain under grad; its profiled step at 256 tokens; no B6),
   with train_gemma3's checks and numbers, the recurrences' device ms by
   their profiler ranges.  train_parity: gemma3-12b's and
   deepseek-v3's SMOKE configs at 64 tokens, recurrentgemma-2b's and
   xlstm-125m's at 128 (2 × ``SLSTM_GRAPH_STEPS``), in f32, the card (B6's
   f32 kernel) against the CPU (the plain version): the loss ≤ 1e-5,
   every gradient ≤ 1e-4, 3 train steps' losses ≤ 1e-4, no sLSTM loop
   replayed from a CUDA graph;
11b. train_mesh: the train step on a device mesh, ranks spawned on the
   card(s) (NCCL with a card a rank, else gloo with every rank on card 0;
   the backend and any collective staged through host memory printed):
   yi-6b at full width, 2 layers, FSDP on (2, 1) with 2 x 4,096 tokens
   and TP on (1, 2) with 1 x 4,096; qwen2-moe-a2.7b at full width, 2
   layers, expert-parallel on (1, 2) with 1 x 2,048 tokens at capacity
   factor 15 (every dispatch checked to drop nothing; one MoE layer's
   output and aux against the gather path and the per-slice formula; the
   assignments both paths drop from the run's batch at cf 1.25 and 4);
   yi-6b with sequence-parallel attention on (1, 3) with 1 x 3,072 (B6
   with 1,024 / 2,048 / 3,072 keys on the three ranks); each in f32
   against rank 0's one-rank run of the same weights and batch (loss ≤
   1e-5, every gradient ≤ 1e-4,
   grad_norm ≤ 1e-5); the dense runs then 2 bf16 steps:
   step ms a rank, tokens/s, peak, each collective's count and bytes a
   step, the ms in ``mesh.collective`` on a profiled step, B6 a step;
   deepseek-v3-671b at full width in the 2-rank spawn: 1 layer (of the
   dense prefix) + the MTP block, fsdp, adafactor on shards (momentum
   off, the stacked layers as one tensor, as the uncut config trains), on
   (2, 1) with 2 x 2,048 tokens and (1, 2) with 1 x 4,096: the f32 check
   on 1 layer + MTP at 2 x 1,024 (the loss, gradients and grad_norm
   gates above; one adafactor update from zeroed params at lr 1 against
   one rank's by the mesh's gathered gradients, r / c / v and rank 0's
   block of the update ≤ 1e-5), then 2 bf16 steps timed the same way;
   yi-6b FSDP on (2, 1) at a batch of one row of 4,096 tokens, whole on
   both data ranks (the reference's ``batch_pspec``), in f32 against one
   rank, then bf16; in the 3-rank spawn deepseek-v3-671b under
   ``seq_parallel_attn`` on (1, 3): 1 dense layer + MTP, each rank's B6
   (D = 192, Dv = 128) with its 1,024 of 3,072 query rows against 1,024,
   2,048 or 3,072 keys of the latent expanded up to its last row, the f32
   check at 1 x 1,536 against one rank, then 2 bf16 steps;
11c. serve_mesh: prefill and decode on a device mesh, run in train_mesh's
   spawns, each rank's cache laid out by the reference's
   ``cache_shardings``: yi-6b at full width, 2 layers, TP on (1, 2) at
   1 x 4,096 + 16 tokens (the cache split by sequence) and data-parallel
   on (2, 1) at 2 x 4,096 + 16 (split by batch); gemma3-12b, 6 layers
   (5 local + 1 global), landmark decode (c 512, theta 4) on (1, 2) at
   1 x 4,096 + 16 (the rings split by slots, the factors whole);
   qwen2-moe-a2.7b, 2 layers, on (1, 2) at 1 x 4,096 + 16;
   deepseek-v3-671b, 4 layers (3 dense + 1 MoE, 128 experts a rank) on
   (1, 2) at 1 x 4,096 + 16 with absorbed MLA decode over its latent
   split by sequence (the ranks draw their weights in turn; the f32 check
   on the 2 dense layers; the MoE layer at T = 512, capacity E/k,
   against each rank's f32 per-token evaluation of its own experts'
   tokens summed over the ranks, ≤ 5e-2); deepseek-v3-671b, 1 dense
   layer, under ``seq_parallel_attn`` on (1, 3) at 1 x 3,072 + 16, in the
   3-rank spawn; each in f32
   against rank 0's one-rank run of the same weights, prompts and draws
   (every step's logits ≤ 1e-4, the greedy tokens equal, the cache
   gathered from the shards ≤ 1e-4: k, v, k_land, offset; the landmark
   factors ≤ 1e-5 of one rank's build from the mesh's own gathered K/V
   and the same draws), then bf16:
   prefill ms and decode ms a token a rank, peak, B6 a prefill (all on
   the tensor cores, none at decode), the collectives of a decode step
   and of a prefill and their ms in ``mesh.collective``;
11d. dryrun: (a) ``launch.dryrun.run_cell`` on the host for gemma3-12b
   x train_4k, gemma3-12b x long_500k and deepseek-v3-671b x decode_32k
   on (16, 16) and qwen2-moe-a2.7b x prefill_32k on (2, 16, 16): each
   ``format_table`` row and the kernels each cell reaches; (b) on a (1, 1)
   mesh, train_gemma3's cell (6 layers, 2 x 4,096, accum 1, remat full),
   a gemma3 landmark decode at serve_gemma3's size (12 layers, 2 x
   32,768) and B5 through ``landmark_decode`` (m = 16 and 4,096), each
   traced on ``meta`` and run on the card under the same recorder: FLOPs
   in all and op by op, the recorder's bytes and op calls equal, the
   custom-op calls equal the launches, the predicted peak above the
   arguments within 10 % of ``max_memory_allocated`` above the base, the
   step ms beside compute and memory ms under ``H100_SXM``; (c)
   train_mesh's yi-6b TP (1, 2) cell dry-run on a fake 2-rank group:
   each collective kind's count and result bytes equal rank 0's a step
   on the card;
12. one JSON line ``{"kernels": [...]}``: per kernel its launches on its
   own path and on each of the twenty-one paths (every count reset just before
   the path and read just after it, and checked), time, plain-version
   time, bound, library-call time, error; each pairwise row (B1 f32 and
   bf16_f32acc, the laplacian l1dist launches, B2, B2's statistic-only
   launches, B4) also carries ``roofline``: the port's
   ``achieved_vs_roofline`` of its work under the H100 profile of its
   precision (``repro_torch.launch.roofline``), beside the route's bound;
   B5's and B6's ``work_roofline``: their FLOP formulas
   (``landmark_flops``, ``flash_flops``) and bytes at the line's shape
   against its ms;
13. the card line again, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

It exits non-zero without a CUDA device, and in a directory without the
repository's ``src/``.  It never imports JAX or the reference package.
"""
from __future__ import annotations

import dataclasses
import datetime
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import types

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
from repro_torch.kernels.flash_attention import grad as fa_grad  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.landmark_attention import build as lm_build  # noqa: E402
from repro_torch.kernels.landmark_attention import kernel as lm_kernel  # noqa: E402
from repro_torch.kernels.landmark_attention import ops as lm_ops  # noqa: E402
from repro_torch.kernels.pairwise import build as pw_build  # noqa: E402
from repro_torch.kernels.pairwise import calibrate  # noqa: E402
from repro_torch.kernels.pairwise import kernel, lower, signsplit, specs  # noqa: E402
from repro_torch.kernels.rbf_sketch import kernel as rbf_kernel  # noqa: E402
from repro_torch.kernels.rbf_sketch import ops as rbf_ops  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import serve_kernel as sk_launch  # noqa: E402
from repro_torch.launch import dryrun as dry  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402

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

# C of the main path against the entries of the f64 statistic, rbf at
# RBF_PROBE_SIGMA: the f32 kernels sum sqdist's near pairs directly
# (kernel.NEAR_TAU), so an entry left on the combine is at most (1/e) 4.5
# 2^-23 / NEAR_TAU = 7.9e-7 off; the combine alone read 1.53e-5 there
TOL_NEAR_F64 = 2e-6
# cauchy at USER_GAMMA against the same: at most (1/4) 4.5 2^-23 / NEAR_TAU
TOL_CAUCHY_F64 = 1e-6

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
# B6 at the served models' head shapes, both routes: (B, Hq, Hkv, Sq, Sk, D,
# Dv, window) -- yi's GQA group 8 and qwen2-moe's MHA at D = 128, MLA's
# D = 192 / Dv = 128 (the HD = 256 instance), also causal with Sq > Sk, and
# recurrentgemma's local layer: MQA (Hkv = 1, group 10) at D = 256, windowed
FLASH_MODEL_SHAPES = ((1, 32, 4, 300, 300, 128, 128, None),
                      (1, 16, 16, 300, 300, 128, 128, None),
                      (1, 8, 8, 300, 300, 192, 128, None),
                      (2, 16, 16, 1000, 1000, 192, 128, None),
                      (1, 8, 8, 300, 100, 192, 128, None),
                      (1, 10, 1, 300, 300, 256, 256, 100),
                      (2, 10, 1, 1000, 1000, 256, 256, 200))
# B6 at whisper's head shape (20 heads of 64, MHA), both routes: (B, Hq,
# Hkv, Sq, Sk, D, Dv), causal -- the encoder's bidirectional self-attention
# at 1,500 frames (not a multiple of the 128-row query block), the cross
# read (Sq = 1, non-causal) and the prompt's cross-attention against a
# ragged encoder length, and the decoder's causal self-attention
FLASH_ENCDEC_SHAPES = (((1, 20, 20, 1500, 1500, 64, 64), False),
                       ((2, 20, 20, 1, 1500, 64, 64), False),
                       ((2, 20, 20, 7, 1000, 64, 64), False),
                       ((2, 20, 20, 300, 300, 64, 64), True))
# the recurrent serving configurations at full width
# (src/repro/configs/recurrentgemma_2b.py: 26 layers, (rglru, rglru, local)
# x 8 + (rglru, rglru), d_model 2,560, lru_width 2,560, conv width 4, 10
# heads MQA x 256, window 2,048, d_ff 7,680 geglu, vocab 256,000;
# xlstm_125m.py: 12 layers, mLSTM and sLSTM alternating, d_model 768,
# 4 x 192 heads, no MLP, mlstm_chunk 256, vocab 50,304), bf16 compute, f32
# params: recurrentgemma-2b at full depth, a 32,768-token context
# (prefill_32k's length), 2 requests, 16 tokens; the same cut to 3 layers
# (one superblock) at long_500k's 524,288-token context, 1 request, 8
# tokens, beside its 32,768-token twin; xlstm-125m at full depth, 2
# requests, a 4,096-token context (cut from 32,768: sLSTM is a per-token
# loop), 16 tokens
RG_CONTEXT, RG_BATCH, RG_GEN = 32_768, 2, 16
RG_LONG_LAYERS, RG_LONG_CONTEXT, RG_LONG_BATCH, RG_LONG_GEN = (3, 524_288,
                                                               1, 8)
XL_CONTEXT, XL_BATCH, XL_GEN = 4096, 2, 16
REC_STATE_S = 512       # the full-width state check: one layer a mixer
TOL_REC_F32 = 1e-5      # full pass vs per-token decode scan, scale-normalized
TOL_REC_BF16 = 5e-2
REC_DECODE_GROWTH = 2.0  # decode's device ms at 524,288 over 32,768, at most

# the encoder-decoder serving configuration: whisper-large-v3 at full width
# and depth (src/repro/configs/whisper_large_v3.py: 32 encoder + 32 decoder
# layers, d_model 1,280, 20 x 64 heads MHA, d_ff 5,120 gelu, vocab 51,866,
# frontend_dim 128; bf16 compute, f32 params), the conv frontend stubbed as
# the reference stubs it (seeded 128-mel frame embeddings), a 1-token
# decoder prompt, whisper's 448-position decoder cache.  Run (a), whisper's
# own serving shape: 16 requests of 1,500 frames (30 s of audio after the
# conv stem; the reference's _encdec_cache enc_len), 32 tokens.  Run (b),
# the repo's decode_32k cell (input_specs: its seq_len is the encoder's):
# 32,768 frames, 2 requests (cut from 128), 16 tokens
WH_DEC_LEN = 448
WH_RUNS = (("30 s", 16, 1500, 32), ("decode_32k", 2, None, 16))
WH_CHECK_LAYERS, WH_CHECK_B, WH_CHECK_S, WH_CHECK_STEPS = 2, 2, 1500, 4
TOL_WH = 5e-2           # bf16 vs f32 logits, decode vs forward, scale-norm.

# causal with Sq > Sk, both routes: (B, Hq, Hkv, Sq, Sk, D, Dv), window
FLASH_EMPTY_ROWS = (((1, 2, 1, 300, 100, 64, 64), None),
                    ((2, 4, 2, 200, 60, 32, 32), 24))

# training.  B6's gradient (the Function: the kernel forward, attention_vjp
# backward) against torch autograd of the plain version at the train
# paths' attention shapes: (label, B, Hq, Hkv, S, D, Dv, causal, window) --
# gemma3-12b's global and local layers at train_4k's length (one
# microbatch row), deepseek's MLA (D 192 / Dv 128) at 2,048 tokens, and
# whisper's encoder (20 x 64 heads, 1,500 frames, non-causal)
TRAIN_GRAD_SHAPES = (("gemma3 global", 1, 16, 8, 4096, 256, 256, True, None),
                     ("gemma3 local", 1, 16, 8, 4096, 256, 256, True, 1024),
                     ("mla", 1, 16, 16, 2048, 192, 128, True, None),
                     ("whisper encoder", 1, 20, 20, 1500, 64, 64, False,
                      None),
                     ("recurrentgemma local", 1, 10, 1, 4096, 256, 256, True,
                      2048))
TOL_GRAD_F32 = 1e-4     # dq, dk, dv vs the plain version's autograd, f32
TOL_GRAD_BF16 = 5e-2    # the same in bf16 (bf16 P in the kernel's PV)
# the train path: gemma3-12b at full width (d_model 3,840, 16/8 heads x
# 256, d_ff 15,360, vocab 262,144 tied, window 1,024; bf16 compute, f32
# params), cut to one pattern period (5 local + 1 global layers), train_4k's
# 4,096 tokens, global batch 2 at accum 2 (cut from train_4k's 256), adamw,
# peak lr 3e-4 after 1 warm-up step, 4 steps of SyntheticLM(seed=0)
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM = 6, 4096, 2, 2
TRAIN_STEPS, TRAIN_PEAK_LR, TRAIN_WARMUP = 4, 3e-4, 1
# qwen2-moe-a2.7b at full width (60 routed experts top-4 + 4 shared, d_ff
# 1,408), 2 layers, 4,096 tokens, batch 1, 3 steps
TRAIN_MOE_LAYERS, TRAIN_MOE_STEPS = 2, 3
# the recurrent families (seeded weights, adamw, peak lr 3e-4 after 1
# warm-up step, SyntheticLM(seed=0)): recurrentgemma-2b at full width and
# depth (26 layers, (rglru, rglru, local) x 8 + 2), 2 x 4,096 tokens at
# accum 2, 4 steps; xlstm-125m at full width, XL_TRAIN_LAYERS of its 12
# layers of mLSTM, sLSTM, 2 x 2,048 tokens (a 12-layer step at 4,096 took
# 63.2 s on the card, host-bound on the sLSTM loop), accum 1, 3 steps, its
# profiled
# step at 256 tokens (the profiler's cost grows with the launches, ~80 a
# token a sLSTM layer: a profiled 4,096-token step took ~23 min)
RG_TRAIN_BATCH, RG_TRAIN_ACCUM, RG_TRAIN_STEPS = 2, 2, 4
XL_TRAIN_BATCH, XL_TRAIN_SEQ, XL_TRAIN_STEPS = 2, 2048, 3
# xlstm-125m's depth in train_recurrent: 4 of its 12 layers (2 mLSTM + 2
# sLSTM), to pay for the recurrent mesh runs (f)-(h) on the clock; a
# 12-layer step took 31.0 s, host-bound on the sLSTM loop
XL_TRAIN_LAYERS = 4
XL_PROFILE_SEQ = 256
# the remat policies timed on train_gemma3's model, one step each after
# one warm-up step
REMAT_POLICIES = ("full", "none", "dots", "save_io")
# card against CPU: the loss and every gradient of a SMOKE-width model
# (the recurrent ones at 2 x SLSTM_GRAPH_STEPS tokens, where serving would
# replay the sLSTM loop from CUDA graphs)
PARITY_ARCHS = (("gemma3-12b", 64), ("deepseek-v3-671b", 64),
                ("recurrentgemma-2b", 128), ("xlstm-125m", 128))
TOL_TRAIN_LOSS = 1e-5   # relative
TOL_TRAIN_GRAD = 1e-4   # scale-normalized, each leaf
TOL_TRAIN_STEPS = 1e-4  # 3 train steps' losses, relative
# train_mesh: ranks spawned on the card(s) (NCCL with a card each where
# as many are visible, else gloo with every rank on card 0).  yi-6b at full
# width cut to 2 of 32 layers, 4,096 tokens a row: mesh (2, 1) FSDP over
# data with 2 rows, mesh (1, 2) TP over model with 1 row; f32 against one
# rank (MESH_F32_STEPS: the loss and gradients), then MESH_STEPS bf16
# steps timed.  qwen2-moe-a2.7b at full width,
# 2 of 24 layers, expert-parallel on (1, 2) with 1 x 2,048 tokens (cut
# from 4,096: the phase's 150 s), its capacity factor raised from 1.25 to
# E/k = 15, where no expert can overflow (a token picks an expert once;
# at 4 the trained-on layers dropped tokens, measured on one H100); every
# dispatch of the run is checked to drop nothing.  yi-6b, 2 layers,
# sequence-parallel attention on (1, 3) with 1 x 3,072 tokens (32 heads
# do not divide 3).
MESH_LAYERS, MESH_SEQ, MESH_SP_SEQ, MESH_STEPS = 2, 4096, 3072, 2
MESH_F32_STEPS = 1
MESH_EP_SEQ = 2048
MESH_DENSE = ((2, 1), (1, 2))
TOL_MESH_GNORM = 1e-5   # grad_norm, relative
TOL_MESH_AUX = 1e-5     # EP aux against its formula on the same slices
# serve_mesh: the serving cells on a mesh, run inside train_mesh's 2-rank
# spawn (no spawn of their own).  Seeded weights at full width; each run in
# f32 against one rank of the same weights, prompts and draws (rank 0,
# after the mesh freed its state): every step's logits, the greedy tokens,
# the cache gathered from the shards; then in bf16, timed.  Prompt +
# SERVE_MESH_GEN tokens (a cache of 4,112 positions, which the
# reference's cache_shardings splits by sequence where the batch is 1):
# (a) yi-6b, 2 of 32 layers, TP (1, 2) at 1 x 4,096 and data-parallel
# (2, 1) at 2 x 4,096 (FSDP's weights gathered on use); (b) gemma3-12b, 6
# of 48 layers (5 local + 1 global), landmark decode (c 512, theta 4) on
# (1, 2) at 1 x 4,096; (c) qwen2-moe-a2.7b, 2 of 24 layers, (1, 2) at
# 1 x 4,096 (the gather path, 30 experts a rank, capacity factor 1.25).
SERVE_MESH = {"serve_yi_1x2": ("yi-6b", (1, 2), 1, 4096, 2),
              "serve_yi_2x1": ("yi-6b", (2, 1), 2, 4096, 2),
              "serve_gemma3_1x2": ("gemma3-12b", (1, 2), 1, 4096, 6),
              "serve_moe_1x2": ("qwen2-moe-a2.7b", (1, 2), 1, 4096, 2),
              "serve_ds_1x2": ("deepseek-v3-671b", (1, 2), 1, 4096, 4)}
# (e) deepseek-v3-671b at 1 x 4,096, 4 of 61 layers (the 3 dense + the
# first MoE: 128 of the 256 experts a rank), absorbed MLA decode, its
# latent cache of 4,112 positions split by sequence (B = 1).  Its f32
# check runs the dense prefix alone (SERVE_MESH_F32_LAYERS); its MoE
# layer is checked apart
# (SERVE_MESH_MOE_T tokens, bf16, capacity E/k, nothing dropped) against
# each rank's f32 per-token evaluation of its own experts' tokens, summed
# over the ranks.  Its ranks draw their weights in turn (the whole draw,
# ~31.6 GB with a 15 GB f32 bank, held by one rank at a time).
SERVE_MESH_F32_LAYERS = {"serve_ds_1x2": 2}
SERVE_MESH_MOE_T = {"serve_ds_1x2": 512}
SERVE_MESH_SERIAL_INIT = {"serve_ds_1x2"}
# (d) train_mesh deepseek-v3-671b at full width: DS_TRAIN_LAYERS layer of
# the dense prefix (first_k_dense cut with it), plus the MTP
# block; fsdp as the config sets it; adafactor (momentum off, the stacked
# layers as one tensor) as default_optimizer gives the uncut > 100B config.
# DS_BF16_STEPS bf16 steps of DS_TRAIN_TOKENS on (2, 1) (2 x 2,048) and
# (1, 2) (1 x 4,096): (2, 1)'s FSDP step moves ~10 GB through gloo, so it
# takes 2.  The f32 check against one rank on DS_F32_LAYERS layer + MTP at
# DS_F32_B x DS_F32_S (one rank's f32 copy with its gradients, ~25 GB,
# beside the mesh's): the loss, every gradient and grad_norm, then one
# adafactor update by those gradients from zeroed params at lr 1 (the
# params become the clipped update, -u), against one rank's update by the
# mesh's gradients gathered: the statistics r / c / v (whole on every
# rank) and rank 0's block of u, each <= TOL_ADA_UPDATE.
DS_TRAIN_LAYERS, DS_TRAIN_TOKENS = 1, 4096
DS_F32_LAYERS, DS_F32_B, DS_F32_S = 1, 2, 1024
DS_BF16_STEPS = {(2, 1): 2, (1, 2): MESH_STEPS}
DS_MESHES = ((2, 1), (1, 2))
# (i) deepseek-v3-671b at full width on (1, 3) with seq_parallel_attn, in
# the 3-rank spawn: 128 heads do not divide 3, so each rank projects its
# 1,024 of 1 x DS_SP_SEQ query rows and launches B6's D = 192 / Dv = 128
# instance against the latent expanded up to its last row (1,024, 2,048
# and 3,072 keys).  Nothing but the MLP splits on (1, 3): attention and
# the vocabulary (129,280) are whole on every rank, ~2.58B params with
# DS_SP_LAYERS layer + MTP, 20.6 GB in f32 with their gradients
# (PERF.md's reckoning).  Train: the f32 check (loss, every gradient,
# grad_norm) against one rank at 1 x DS_SP_F32_SEQ (at 3,072 the three
# ranks' f32 state and activations held 78.5 GiB of the card and the
# backward's next 1.48 GiB did not fit, measured on one H100), then
# DS_SP_BF16_STEPS bf16 adafactor steps at 1 x DS_SP_SEQ (step 2 timed),
# B6's first launch on each rank against its plain version.  Serve
# (``serve_ds_sp_1x3``): a prefill of 1 x DS_SP_SEQ + SERVE_MESH_GEN
# tokens, f32 against one rank, then bf16 timed.
DS_SP_LAYERS, DS_SP_SEQ, DS_SP_F32_SEQ, DS_SP_BF16_STEPS = 1, 3072, 1536, 2
# the 3-rank spawn's allocator: three ranks' f32 state of (i) fill most of
# the card, and the backward's gradient-sized blocks found no room among
# the cached free blocks (3.76 GiB reserved but unallocated on a rank)
MESH3_ALLOC_CONF = "expandable_segments:True"
# (j) yi-6b, MESH_LAYERS layers, fsdp, on (2, 1) at 1 x MESH_SEQ: the row
# is whole on both data ranks (the reference's batch_pspec of a batch that
# data does not divide), whose equal shares FSDP's reduce-scatter sums.
# The f32 check against one rank, then MESH_STEPS bf16 steps timed.
ROWS_WHOLE_RUN = "yi_2x1_b1"
# one adafactor update on the mesh against one rank's by the same (the
# mesh's) gradients, scale-normalized, each leaf: the row and column sums
# are added in another order on the card
TOL_ADA_UPDATE = 1e-5
SERVE_MESH_GEN = 16
TOL_SERVE_MESH = 1e-4   # f32 logits vs one rank, scale-normalized, a step
# the landmark factors the mesh built against one rank's build from the
# mesh's own K/V (gathered, the same draws): a layout or indexing fault of
# the per-head build and its all-gather shows here, K's rounding does not
TOL_SERVE_MESH_WITNESS = 1e-5
# (f)-(h): the recurrent families and the encoder-decoder in the same
# 2-rank spawn, at full width with their depth cut (REC_MESH_LAYERS;
# whisper: its encoder and its decoder each), fsdp off.  Each run in f32
# against one rank of the same weights and batch (the loss and every
# gradient; the serving logits, greedy tokens and cache), then in bf16,
# timed, with B6's first launch on each rank held to its plain version.
# (f) recurrentgemma-2b, 3 layers (rglru, rglru, local): train (1, 2) at
# 1 x 4,096 and (2, 1) at 2 x 2,048; serve (1, 2) at 2 x 8,192 + 16 (the
# local ring split by slots).  (g) xlstm-125m, 2 of 12 layers (an mLSTM
# and an sLSTM): train
# (1, 2) at 1 x 1,024; serve (1, 2) at 2 x 4,096 + 16.  (h)
# whisper-large-v3, 2 + 2 of 32 + 32 layers: train (1, 2) at 2 x 1,500
# frames and 448 decoder
# tokens; serve (1, 2) at 2 x 1,500 frames + 16 (enc_kv split by
# sequence) and (2, 1) (by rows).  The serving runs are SERVE_MESH's;
# their S counts whisper's frames (its decoder prompt is 1 token).
REC_MESH_LAYERS = {"recurrentgemma-2b": 3, "xlstm-125m": 2,
                   "whisper-large-v3": 2}
REC_TRAIN_MESH = {"rg_1x2": ("recurrentgemma-2b", (1, 2), 1, 4096),
                  "rg_2x1": ("recurrentgemma-2b", (2, 1), 2, 2048),
                  "xl_1x2": ("xlstm-125m", (1, 2), 1, 1024),
                  "wh_1x2": ("whisper-large-v3", (1, 2), 2, 1500)}
REC_MESH_STEPS = 2      # bf16 steps a run, the second timed
WH_TRAIN_TOKENS = 448
# whisper's cross-attention gradients (``xattn/...``) against one rank's:
# with seeded weights its attention over 1,500 frames is near uniform, and
# these leaves are ill-conditioned: one rank's own gradients of them move
# by tens of 1e-6 when the frames move by 1e-7 relative (the run measures
# it: ``_mesh_f32_check(perturb="frames")``), and the mesh's
# tensor-parallel sums perturb them more (1.22e-4 at xattn/3/xattn/wk on
# the card, every other leaf within TOL_TRAIN_GRAD)
TOL_WH_XATTN_GRAD = 1e-3
SERVE_MESH.update({
    "serve_rg_1x2": ("recurrentgemma-2b", (1, 2), 2, 8192,
                     REC_MESH_LAYERS["recurrentgemma-2b"]),
    "serve_xl_1x2": ("xlstm-125m", (1, 2), 2, 4096,
                     REC_MESH_LAYERS["xlstm-125m"]),
    "serve_wh_1x2": ("whisper-large-v3", (1, 2), 2, 1500,
                     REC_MESH_LAYERS["whisper-large-v3"]),
    "serve_wh_2x1": ("whisper-large-v3", (2, 1), 2, 1500,
                     REC_MESH_LAYERS["whisper-large-v3"])})
#: the runs of (f)-(h), whose seconds are summed apart
REC_SERVE_MESH = ("serve_rg_1x2", "serve_xl_1x2", "serve_wh_1x2",
                  "serve_wh_2x1")
SERVE_MESH["serve_ds_sp_1x3"] = ("deepseek-v3-671b", (1, 3), 1, DS_SP_SEQ,
                                 DS_SP_LAYERS)
#: config changes of a serving run
SERVE_MESH_KW = {"serve_ds_sp_1x3": {"seq_parallel_attn": True}}


class SmokeFailure(AssertionError):
    pass


# Specs with only a Python entry_fn, as a user registers them (the
# reference's README: register cauchy, then PairwiseKernel + fast_model).
# They are not registered, so phase_parity's registry loop does not see
# them; phase_build builds their user libraries, phase_user_spec runs them.
USER_GAMMA = 0.5                         # the README's example
# the built-in rbf at the same gamma (ROADMAP C14)
RBF_PROBE_SIGMA = 1.0
USER_SPECS = (
    specs.KernelSpec("cauchy", "sqdist",
                     lambda t: 1.0 / (1.0 + USER_GAMMA * t),
                     params=(("gamma", USER_GAMMA),)),
    # (1 + t / (2 α ℓ))^-α of the l1 distance, α = 2, ℓ = 2: a scale
    # mixture of laplacians
    specs.KernelSpec("rational_quadratic", "l1dist",
                     lambda t: (1.0 + t / 8.0) ** -2.0,
                     params=(("alpha", 2.0), ("length_scale", 2.0))),
    specs.KernelSpec("compact", "sqdist",
                     lambda t: torch.where(t < 40.0, (1.0 - t / 40.0) ** 2,
                                           torch.zeros_like(t)),
                     params=(("radius_sq", 40.0),)),
    # on dot: the tensor-core statistic in a user variant
    specs.KernelSpec("exponential_dot", "dot",
                     lambda t: torch.exp(t / 16.0),
                     params=(("scale", 16.0),)))
#: each user library's nvcc seconds, registers and spills (phase_build)
USER_BUILD: dict = {}


def user_library(spec):
    return pw_build.user_library(lower.program_for(spec), spec.stat)


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
    library it launches from (a user spec's variant) reports them: the
    statistic's cross term (0 for l1dist, on the CUDA cores) and the
    sweep's contraction."""
    lib = kernel._epilogue(spec)[0].load()
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
    user_libs = [user_library(spec) for spec in USER_SPECS]
    kbuild.build_all([*libs, *user_libs])
    log(f"build: {time.perf_counter() - t0:.1f} s for the {len(libs)} "
        f"libraries ({', '.join(lib.name for lib in libs)}) and "
        f"{len(user_libs)} user variants of pairwise")
    for lib in (*libs, *user_libs):
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
    for spec, lib in zip(USER_SPECS, user_libs):
        report = lib.build_log()
        # dot and sqdist: 2 precisions x 2 k-step counts; l1dist: 2
        # precisions
        count = 2 if spec.stat == "l1dist" else 4
        for name in ("pairwise_matmat_tc", "pairwise_block_tc"):
            check_wgmma_report(report, name, count,
                               f"{spec.stat} x 2 precisions (user variant)")
        USER_BUILD[spec.name] = {
            "library": lib.library_path().name, "stat": spec.stat,
            "nvcc_s": lib.build_seconds(),
            "registers": {k: max(ptxas_registers(report, k)) for k in (
                "pairwise_block_tc", "pairwise_matmat_tc")},
            "spill_bytes": {k: max(ptxas_spills(report, k).values()) for k in (
                "pairwise_block_tc", "pairwise_matmat_tc")},
            "entry_instructions": len(lower.program_for(spec).instrs)}
        log(f"  user variant {spec.name} ({spec.stat}): nvcc "
            f"{lib.build_seconds()} s, registers "
            f"{json.dumps(USER_BUILD[spec.name]['registers'])}, spills "
            f"{USER_BUILD[spec.name]['spill_bytes']} bytes")
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


def ptxas_registers(report: str, name: str) -> list:
    """Registers of each entry function of an ``-Xptxas -v`` report whose
    mangled name contains ``name``, in the report's order."""
    regs, entry = [], False
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = name in m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            regs.append(int(m.group(1)))
            entry = False
    return regs


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
                err_h_tensor=out["err_h"],
                counts={k: out[k] for k in ("counts_fused",
                                            "counts_leverage",
                                            "counts_blocked")})


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
# user-registered specs
# ---------------------------------------------------------------------------

def _user_parity() -> dict:
    """B1, B2 and B4 of each user spec × precision against their plain
    versions at phase_parity's and phase_parity_slab's ragged shapes."""
    rng = np.random.default_rng(1)
    nr, nc = 1000, 1500
    Xr = torch.as_tensor(rng.normal(size=(nr, D)), dtype=torch.float32,
                         device=DEV)
    Xc = torch.as_tensor(rng.normal(size=(nc, D)), dtype=torch.float32,
                         device=DEV)
    gidx = torch.as_tensor(rng.choice(nc, 37, replace=False), device=DEV)
    Vs = (sweep_lib.one_hot_columns(gidx, nc, DEV),
          torch.as_tensor(rng.normal(size=(nc, 129)), dtype=torch.float32,
                          device=DEV),
          torch.as_tensor(rng.normal(size=(nc, 16)), dtype=torch.float32,
                          device=DEV))
    slabs = ((0, 700), (400, 650), (1100, 700))      # the tail runs past n
    errs = {}
    for base in USER_SPECS:
        for prec in specs.PRECISIONS:
            spec = base.with_precision(prec)
            label = f"user {base.name}/{prec}"
            e = _parity_case(spec, Xr, Xc, Vs, None, label)
            if prec == "f32":
                gathered = kernel.pairwise_matmat_multi_cuda(
                    spec, Xr, Xc, Vs[:1])[0]
                direct = kernel.pairwise_block_cuda(spec, Xr, Xc[gidx])
                gap = float((gathered - direct).abs().max())
                check(gap == 0.0, f"{label}: one-hot gather not exact "
                                  f"({gap})")
                e["gather_gap"] = gap
            e["slab"] = _slab_case(spec, Xc, Vs, slabs, f"B4 {label}")
            errs[f"{base.name}/{prec}"] = e
            log(f"parity {label:34s} " + " ".join(
                f"{k}={v:.3g}" for k, v in e.items()))
    return errs


def _timed_pair(fns: dict, reps: int, warmup: int) -> dict:
    """ms of each call in ``fns``, in turns a, b, b, a (each the mean of
    the two turns)."""
    names = list(fns)
    order = names + names[::-1]
    ms = {k: [] for k in names}
    for k in order:
        ms[k].append(cuda_ms(fns[k], reps=reps, warmup=warmup)[0])
    return {k: sum(v) / len(v) for k, v in ms.items()}


def _near_share(Xr, Xc) -> float:
    """The share of the pairs whose f64 statistic lies below NEAR_TAU times
    the sum of the f32 squared norms: the near pairs the f32 kernels sum
    directly, up to the pairs within the combine's rounding of the
    threshold."""
    nn = (Xr * Xr).sum(1).double()[:, None] + (Xc * Xc).sum(1).double()
    D = torch.cdist(Xr.double(), Xc.double()) ** 2
    return float((D < kernel.NEAR_TAU * nn).double().mean())


def _rbf_steep_probe(X, idx, S, Z, slab) -> dict:
    """ROADMAP C14: the main path's three calls with the built-in rbf at
    RBF_PROBE_SIGMA (gamma 0.5), where the combine's rounding at the points'
    norms weighs most, then B2's panel and B4's slab rows (one-hot columns)
    at the same sigma.  Each against the f64 statistic's entries (within
    TOL_NEAR_F64) and against the plain version (within TOL_F32, unless the
    plain version lies farther from the f64 entries than the kernel)."""
    spec = specs.rbf(RBF_PROBE_SIGMA)
    gamma = 0.5 / RBF_PROBE_SIGMA ** 2
    op = CountingOperator(RBFKernel(X, sigma=RBF_PROBE_SIGMA, device=DEV))
    C = _main_calls(op, idx, S, Z)[1]["apg"].C
    check(bool(torch.isfinite(C).all()), "rbf probe: C not finite")
    C_plain = kernel.pairwise_block_plain(spec, X, X[idx])
    C64 = torch.exp(-gamma * torch.cdist(X.double(), X[idx].double()) ** 2)
    srows = kernel.slab_rows(N, slab, slab, DEV)
    rows = kernel.pairwise_matmat_multi_slab_cuda(
        spec, X, slab, slab, (sweep_lib.one_hot_columns(idx, N, DEV),))[0]
    b = sweep_lib.resolved_block_size(N, N, None)
    Xr = X[:b].contiguous()
    P64 = torch.exp(-gamma * torch.cdist(Xr.double(), X.double()) ** 2)
    cases = {"C": (C, C_plain, C64),
             "b2_panel": (kernel.pairwise_block_cuda(spec, Xr, X),
                          kernel.pairwise_block_plain(spec, Xr, X), P64),
             "b4_rows": (rows, C_plain[srows], C64[srows])}
    out = {"sigma": RBF_PROBE_SIGMA, "near_tau": kernel.NEAR_TAU,
           "near_share": {"C": _near_share(X, X[idx]),
                          "b2_panel": _near_share(Xr, X)},
           "b4_rows_equal_b1": bool(torch.equal(rows, C[srows]))}
    for name, (got, plain, exact) in cases.items():
        e = {"vs_plain": scaled_err(got, plain),
             "vs_f64": scaled_err(got.double(), exact),
             "plain_vs_f64": scaled_err(plain.double(), exact)}
        out[name] = e
        check(e["vs_f64"] <= TOL_NEAR_F64,
              f"rbf probe {name} vs f64 {e['vs_f64']:.3g} > {TOL_NEAR_F64}")
        check(e["vs_plain"] <= TOL_F32 or e["vs_f64"] < e["plain_vs_f64"],
              f"rbf probe {name} vs plain {e['vs_plain']:.3g} with the "
              f"plain version nearer f64 ({e})")
    del P64, C64
    check(out["b4_rows_equal_b1"], "rbf probe: B4's rows differ from B1's C")
    log(f"user_spec rbf probe at sigma {RBF_PROBE_SIGMA} (gamma {gamma}), "
        f"near pairs below {kernel.NEAR_TAU} (xx + yy) summed directly "
        f"(share: C {out['near_share']['C']:.4f}, B2 panel "
        f"{out['near_share']['b2_panel']:.4f}): " + "; ".join(
            f"{k} vs f64 {out[k]['vs_f64']:.3g} (limit {TOL_NEAR_F64}), vs "
            f"plain {out[k]['vs_plain']:.3g}, plain vs f64 "
            f"{out[k]['plain_vs_f64']:.3g}" for k in cases)
        + f"; B4 rows = B1's C {out['b4_rows_equal_b1']}")
    return out


def phase_user_spec(m: dict, sh: dict) -> dict:
    """The reference's custom-kernel story on the card: USER_SPECS through
    B1, B2 and B4 against their plain versions, then cauchy on the main
    path at n = 50,000 and the three kernels timed beside rbf."""
    parity = _user_parity()
    X, idx, S, Z = m["X"], m["idx"], m["S"], m["Z"]
    cauchy = USER_SPECS[0]
    op = CountingOperator(PairwiseKernel(X, cauchy, device=DEV))
    _main_calls(op, idx, S, Z)                      # warm-up
    torch.cuda.synchronize()
    reset_counts()
    times, out = _main_calls(op, idx, S, Z)         # the counted run
    launches = read_counts()
    log(f"user_spec main path (cauchy, gamma {USER_GAMMA}): times ms "
        f"{json.dumps(times)} (rbf {json.dumps(m['times'])})")
    log(f"user_spec launches {json.dumps(launches)}")
    check(launches == m["launches"],
          f"cauchy's launches {launches} != rbf's {m['launches']}")
    counts = {k: out[k] for k in m["counts"]}
    check(counts == m["counts"] and out["route_fused"] == "fused"
          and out["route_blocked"] == "panel",
          f"cauchy's meter {counts} {out['route_fused']} != rbf's "
          f"{m['counts']}")
    apg = out["apg"]
    err_h, err_b = float(out["err_h"]), float(out["err_b"])
    check(tuple(apg.U.shape) == (C_COLS, C_COLS)
          and bool(torch.isfinite(apg.U).all())
          and bool(torch.isfinite(apg.C).all())
          and np.isfinite(err_h) and np.isfinite(err_b) and err_b > 0,
          f"cauchy model: U {tuple(apg.U.shape)}, errors {err_h} {err_b}")
    # U against the plain versions' U at the same draws: C and K S from
    # the plain block in row slabs, then the same fast_U
    slab = 5000
    C_plain = kernel.pairwise_block_plain(cauchy, X, X[idx])
    KS_plain = torch.cat([kernel.pairwise_matmat_multi_plain(
        cauchy, X[r0:r0 + slab], X, (S.mat,))[0]
        for r0 in range(0, N, slab)])
    U_plain = spsd.fast_U(S.left(C_plain), S.left(KS_plain))
    e_c = scaled_err(apg.C, C_plain)
    e_u = scaled_err(apg.U, U_plain)
    del KS_plain
    # C against the entries of the f64 statistic: the kernel's, the plain
    # version's (the reference's combine), and the built-in library's
    # statistic-only B2 under the same entry; the statistic the variant
    # takes, as its library reports it: tensor-core passes of the cross
    # term (0: on the CUDA cores), the near pairs summed directly
    t64 = torch.cdist(X.double(), X[idx].double()) ** 2
    C64 = 1.0 / (1.0 + USER_GAMMA * t64)
    t_tc = kernel.pairwise_block_cuda(specs.stat_only("sqdist"), X, X[idx])
    e64 = {"kernel": scaled_err(apg.C.double(), C64),
           "plain": scaled_err(C_plain.double(), C64),
           "builtin_statistic": scaled_err(
               1.0 / (1.0 + USER_GAMMA * t_tc.double()), C64)}
    del t64, C64, t_tc
    stat_passes = passes(cauchy)["statistic"]
    statistic = (f"tensor cores ({stat_passes} split-TF32 passes), near pairs "
                 f"below {kernel.NEAR_TAU} (xx + yy) summed directly"
                 if stat_passes else "sum (x - y)^2 on the CUDA cores")
    check(e_c <= TOL_F32, f"cauchy C vs plain {e_c:.3g} (vs f64: {e64})")
    check(e64["kernel"] <= TOL_CAUCHY_F64, f"cauchy C vs f64 {e64}")
    check(e_u <= TOL_U, f"cauchy U vs plain {e_u:.3g}")
    probe = _rbf_steep_probe(X, idx, S, Z, sh["slab"])
    log(f"user_spec cauchy (statistic: {statistic}) vs the plain versions: "
        f"C {e_c:.3g}, U {e_u:.3g}; C vs the f64 statistic's entries: kernel "
        f"{e64['kernel']:.3g} (limit {TOL_CAUCHY_F64}), plain "
        f"{e64['plain']:.3g}, the built-in statistic "
        f"{e64['builtin_statistic']:.3g}; rel err hutchinson "
        f"{err_h:.6f}, blocked {err_b:.6f}")

    # the kernels at their main-path shapes, each beside rbf in turns
    rbf, lap = m["spec"], specs.suggested_spec("laplacian", D)
    Vs = (sweep_lib.one_hot_columns(idx, N, DEV), S.mat, Z)
    M = sum(int(V.shape[1]) for V in Vs)
    b1 = _timed_pair({s.name: (lambda s=s: kernel.pairwise_matmat_multi_cuda(
        s, X, X, Vs)) for s in (rbf, cauchy)}, reps=2, warmup=1)
    for spec, beside in ((USER_SPECS[1], lap), (USER_SPECS[2], rbf),
                         (USER_SPECS[3], rbf)):
        pair = _timed_pair({f"{s.name}": (
            lambda s=s: kernel.pairwise_matmat_multi_cuda(s, X, X, Vs))
            for s in (beside, spec)}, reps=1, warmup=1)
        b1[spec.name] = pair[spec.name]
        b1[f"{beside.name} beside {spec.name}"] = pair[beside.name]
    rows = torch.arange(0, N, N // 512, device=DEV)[:512]
    outs = kernel.pairwise_matmat_multi_cuda(cauchy, X, X, Vs)
    plain = kernel.pairwise_matmat_multi_plain(cauchy, X[rows], X, Vs)
    e_b1 = max(scaled_err(o[rows], p) for o, p in zip(outs, plain))
    check(e_b1 <= TOL_F32_MAIN, f"cauchy B1 rows vs plain {e_b1:.3g}")
    b = sweep_lib.resolved_block_size(N, N, None)
    Xr = X[:b].contiguous()
    b2 = _timed_pair({s.name: (lambda s=s: kernel.pairwise_block_cuda(
        s, Xr, X)) for s in (rbf, cauchy)}, reps=20, warmup=2)
    # the panel holds the pairs of a point with itself and its neighbours,
    # where the plain version's ||x||^2 + ||y||^2 - 2 x.y cancels: it is
    # held to the f64 statistic's entries, and to the plain version unless
    # that lies farther from them than the kernel does
    blk = kernel.pairwise_block_cuda(cauchy, Xr, X)
    blk_plain = kernel.pairwise_block_plain(cauchy, Xr, X)
    P64 = 1.0 / (1.0 + USER_GAMMA * torch.cdist(Xr.double(), X.double()) ** 2)
    e_b2 = scaled_err(blk, blk_plain)
    e_b2_64 = {"kernel": scaled_err(blk.double(), P64),
               "plain": scaled_err(blk_plain.double(), P64)}
    del blk, blk_plain, P64
    check(e_b2_64["kernel"] <= TOL_F32, f"cauchy B2 panel vs f64 {e_b2_64}")
    check(e_b2 <= TOL_F32 or e_b2_64["kernel"] < e_b2_64["plain"],
          f"cauchy B2 panel vs plain {e_b2:.3g} (vs f64: {e_b2_64})")
    start = length = sh["slab"]
    b4 = _timed_pair({s.name: (
        lambda s=s: kernel.pairwise_matmat_multi_slab_cuda(
            s, X, start, length, Vs)) for s in (rbf, cauchy)},
        reps=2, warmup=1)
    slab_out = kernel.pairwise_matmat_multi_slab_cuda(cauchy, X, start,
                                                      length, Vs)
    srows = kernel.slab_rows(N, start, length, DEV)
    same = all(torch.equal(o, f[srows]) for o, f in zip(slab_out, outs))
    check(same, "cauchy B4 rows differ from B1's")
    del outs, slab_out
    log(f"user_spec B1 ({N} x {N}, M = {M}) ms: {json.dumps(b1)}; B2 "
        f"({b} x {N}) ms: {json.dumps(b2)}; B4 ({length} x {N} from row "
        f"{start}) ms: {json.dumps(b4)}; cauchy/rbf B1 "
        f"{b1['cauchy'] / b1['rbf']:.3f}, B2 {b2['cauchy'] / b2['rbf']:.3f}, "
        f"B4 {b4['cauchy'] / b4['rbf']:.3f}; cauchy vs plain: B1 rows "
        f"{e_b1:.3g}, B2 {e_b2:.3g} (B2 vs the f64 statistic's entries: "
        f"kernel {e_b2_64['kernel']:.3g}, plain {e_b2_64['plain']:.3g}), B4 "
        f"rows = B1's {same}")
    log(f"user_spec builds: {json.dumps(USER_BUILD)}")
    return {"launches": launches, "times": times, "parity": parity,
            "C_err_vs_plain": e_c, "U_err_vs_plain": e_u,
            "C_err_vs_f64": e64, "statistic": statistic,
            "err_hutchinson": err_h, "err_blocked": err_b,
            "b1_ms": b1, "b2_ms": b2, "b4_ms": b4, "b1_rows_err": e_b1,
            "b2_err": e_b2, "b2_err_vs_f64": e_b2_64,
            "b4_rows_equal_b1": same, "rbf_probe": probe,
            "shapes": {"b1": [N, N, D, M], "b2": [b, N, D],
                       "b4": [start, length, N, D, M]},
            "builds": USER_BUILD}


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
    # the MoE, MLA, dense and recurrent configs' head shapes on both routes
    for B, Hq, Hkv, Sq, Sk, D, Dv, window in FLASH_MODEL_SHAPES:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _flash_inputs(B, Hq, Hkv, Sq, Sk, D, dtype, seed=46,
                                    Dv=Dv)
            label = (f"flash {dtype} (B, Hq, Hkv, Sq, Sk, D, Dv) = "
                     f"{(B, Hq, Hkv, Sq, Sk, D, Dv)}, window {window}")
            if Sq > Sk:
                out = fa_kernel.flash_attention_cuda(q, k, v, causal=True,
                                                     window=window)
                check(bool((out[:, :, :Sq - Sk] == 0).all()),
                      f"{label}: a row that sees no key is not 0")
            errs[str(dtype).split(".")[-1]] = _flash_case(
                q, k, v, True, window, label)
        log(f"parity flash, model head shape (B, Hq, Hkv, Sq, Sk, D, Dv) = "
            f"{(B, Hq, Hkv, Sq, Sk, D, Dv)}, window {window}: "
            + " ".join(f"{k}={v}" for k, v in errs.items()))
    # whisper's head shape, non-causal (encoder, cross) and causal
    for (B, Hq, Hkv, Sq, Sk, D, Dv), causal in FLASH_ENCDEC_SHAPES:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _flash_inputs(B, Hq, Hkv, Sq, Sk, D, dtype, seed=49,
                                    qk_scale=1.0, Dv=Dv)
            label = (f"flash {dtype} (B, Hq, Hkv, Sq, Sk, D, Dv) = "
                     f"{(B, Hq, Hkv, Sq, Sk, D, Dv)}, causal {causal}")
            errs[str(dtype).split(".")[-1]] = _flash_case(
                q, k, v, causal, None, label)
        log(f"parity flash, whisper head shape (B, Hq, Hkv, Sq, Sk, D, Dv) "
            f"= {(B, Hq, Hkv, Sq, Sk, D, Dv)}, causal {causal}: "
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
    """One decoder-only model served end to end (``_serve_run``): init from
    a seeded generator and ``prepare``; B6 once per attention layer of its
    one prefill (none for a recurrent layer), none in decode.  ``n_patch``
    seeded patch embeddings are fused into the leading prompt positions
    (early fusion)."""
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
    n = sum(kind in ttransformer.ATTN_KINDS
            for *_, kind in ttransformer.layer_slots(cfg))
    res = _serve_run(tag, model, params, prompts, n_gen, seed,
                     b6_prefill=n, b6_decode=0, warm_len=warm_len,
                     profile=profile, patches=patches)
    res.update(params=n_params, init_s=init_s)
    return res


def _serve_run(tag: str, model, params, prompts, n_gen: int, seed: int, *,
               b6_prefill: int, b6_decode: int, warm_len: int = 0,
               profile: bool = True, patches=None, frames=None,
               max_len=None) -> dict:
    """``prompts`` served end to end through ``serve.generate``: a warm-up
    (the full run, or a ``warm_len``-token prompt and 2 tokens); then the
    counted, timed run (every launch count reset just before it and read
    just after); B6 ``b6_prefill`` times in its one prefill and
    ``b6_decode`` times a decode step, all on the tensor-core kernel, and
    nothing else; every token in [0, vocab) and every logit finite; then,
    outside the counted run, the device time of one prefill and 4 decode
    steps by kernel class.  ``patches`` (early fusion) and ``frames`` (an
    encoder-decoder's encoder input) go into the prefill batch."""
    cfg = model.cfg
    B, S = prompts.shape

    def run(m, p, length, steps):
        return serve.generate(m, params, p[:, :length], steps,
                              max_len=max_len,
                              generator=torch.Generator().manual_seed(
                                  seed + 1), patches=patches, frames=frames)

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
           "b6_prefill": rec["b6_prefill"], "b6_decode": rec["b6_decode"]}
    log(f"{tag} timed run: prefill {res['prefill_ms']:.1f} ms, decode"
        f" {decode_ms:.2f} ms per token (generate minus prefill over "
        f"{n_gen - 1} steps), generate {total_ms:.1f} ms, "
        f"{res['tokens_per_s']:.2f} tokens/s ({res['decode_tokens_per_s']:.1f}"
        f" in decode), peak memory {peak_gb:.2f} GB")
    log(f"{tag} launches {json.dumps(launches)}; B6 per prefill "
        f"{rec['b6_prefill']}, per decode step {rec['b6_decode']}")
    n = b6_prefill + b6_decode * (n_gen - 1)
    check(launches == no_launches(flash_attention=n, flash_attention_tc=n),
          f"{tag}: the serving path should launch B6 {b6_prefill} times in "
          f"its one prefill and {b6_decode} times a decode step, each on "
          f"the tensor-core kernel, and nothing else: {launches}")
    check(rec["b6_prefill"] == [{"flash_attention": b6_prefill,
                                 "flash_attention_tc": b6_prefill}]
          and rec["b6_decode"] == [{"flash_attention": b6_decode,
                                    "flash_attention_tc": b6_decode}]
          * (n_gen - 1),
          f"{tag}: B6 per prefill {rec['b6_prefill']} (all {b6_prefill} on "
          f"the tensor cores), per decode step {rec['b6_decode']} "
          f"({b6_decode})")
    check(tuple(out.shape) == (B, n_gen) and bool(
        ((out >= 0) & (out < cfg.vocab_size)).all()),
        f"{tag}: tokens {tuple(out.shape)} outside [0, {cfg.vocab_size})")
    check(bool(torch.stack(rec["finite"]).all()),
          f"{tag}: a logit was not finite")
    log(f"{tag} tokens row 0: {out[0].tolist()}")
    if profile:
        extra = {k: v for k, v in (("patches", patches), ("frames", frames))
                 if v is not None}
        res["profile"] = _profile_serve(tag, model, params, prompts, n_gen,
                                        seed + 1, extra, max_len)
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


def _rec_describe(cfg) -> str:
    return (f", lru_width {cfg.lru_width}, conv width "
            f"{cfg.rglru_conv_width}, window {cfg.window}, mlp "
            f"{cfg.mlp_variant}" if "rglru" in cfg.layer_pattern else
            f", mlstm_chunk {cfg.mlstm_chunk}, no MLP")


def _slstm_step_ms(cfg, mixer: dict, B: int, S: int) -> dict:
    """One sLSTM layer's full pass at the served batch and length (the
    model's own bf16 input), timed once after a warm-up, as served (the
    loop replayed from CUDA graphs of ``SLSTM_GRAPH_STEPS`` steps) and as
    the plain per-token loop (the graph's threshold raised past S): ms per
    token step of each, and the two outputs bit-equal."""
    x = torch.randn((B, S, cfg.d_model), generator=gen(101),
                    device=DEV).to(cfg.cdtype)
    ms, y = cuda_ms(lambda: trec.slstm_full(mixer, cfg, x), warmup=1)
    steps = trec.SLSTM_GRAPH_STEPS
    trec.SLSTM_GRAPH_STEPS = S
    try:
        plain_ms, plain = cuda_ms(lambda: trec.slstm_full(mixer, cfg, x),
                                  warmup=1)
    finally:
        trec.SLSTM_GRAPH_STEPS = steps
    check(bool(torch.isfinite(y).all()), "sLSTM layer: non-finite output")
    check(torch.equal(y, plain), "sLSTM layer: the graphed loop differs "
          "from the plain loop")
    res = {"layer_ms": ms, "ms_per_step": ms / S, "plain_layer_ms": plain_ms,
           "plain_ms_per_step": plain_ms / S, "graph_steps": steps, "B": B,
           "S": S}
    log(f"serve_recurrent sLSTM layer at B = {B}, S = {S}: {ms:.1f} ms "
        f"({ms / S * 1e3:.1f} us a token step) replayed from CUDA graphs of "
        f"{steps} steps; the plain loop {plain_ms:.1f} ms "
        f"({plain_ms / S * 1e3:.1f} us a step); outputs bit-equal")
    return res


def _rec_state_check() -> dict:
    """One layer of each mixer at full width (RG-LRU at recurrentgemma-2b's,
    mLSTM and sLSTM at xlstm-125m's), seeded weights, B = 2, S =
    REC_STATE_S: the full pass's output and final state against the
    per-token decode scan on the card (the reference's prefill state), f32
    ≤ TOL_REC_F32 and bf16 ≤ TOL_REC_BF16, scale-normalized."""
    res = {}
    for kind, arch in (("rglru", "recurrentgemma-2b"),
                       ("mlstm", "xlstm-125m"), ("slstm", "xlstm-125m")):
        for dtype, tol in (("float32", TOL_REC_F32),
                           ("bfloat16", TOL_REC_BF16)):
            cfg = dataclasses.replace(tconfigs.get_config(arch), dtype=dtype)
            p = trec.INIT[kind](gen(102), cfg, DEV)
            x = torch.randn((2, REC_STATE_S, cfg.d_model), generator=gen(103),
                            device=DEV).to(cfg.cdtype)
            y, state = trec.PREFILL[kind](p, cfg, x)
            scan = trec.INIT_STATE[kind](cfg, 2, DEV)
            ys = [trec.DECODE[kind](p, cfg, x[:, t:t + 1], scan)[0]
                  for t in range(REC_STATE_S)]
            errs = {"output": scaled_err(y.float(), torch.cat(ys, 1).float())}
            for name in scan:
                check(state[name].dtype == scan[name].dtype
                      and state[name].shape == scan[name].shape,
                      f"{kind} {dtype} state {name}: {state[name].dtype} "
                      f"{tuple(state[name].shape)} vs {scan[name].dtype} "
                      f"{tuple(scan[name].shape)}")
                errs[name] = scaled_err(state[name].float(),
                                        scan[name].float())
            worst = max(errs.values())
            check(worst <= tol, f"{kind} {dtype} full pass vs decode scan: "
                  f"{errs} > {tol}")
            res[f"{kind} {dtype}"] = errs
            log(f"serve_recurrent state check {kind} ({arch} width, {dtype}, "
                f"S = {REC_STATE_S}): full pass vs per-token decode scan "
                + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                + f" (limit {tol})")
            del p, x, y, state, scan, ys
    torch.cuda.empty_cache()
    return res


def phase_serve_recurrent() -> dict:
    """recurrentgemma-2b at full depth, its 3-layer cut at long_500k beside
    its 32,768-token twin, and xlstm-125m at full depth, each served
    through ``serve.generate``; the path's launch counts are the runs'
    summed (reset just before each counted run and read just after).  Then
    the sLSTM loop's ms per step, the full-width state check, and B6 at
    recurrentgemma's local shape."""
    rg = tconfigs.get_config("recurrentgemma-2b")
    xl = tconfigs.get_config("xlstm-125m")
    rg3 = dataclasses.replace(rg, n_layers=RG_LONG_LAYERS)
    runs = (("recurrentgemma-2b", rg, RG_BATCH, RG_CONTEXT, RG_GEN, True),
            ("recurrentgemma-2b 3 layers 32k", rg3, RG_LONG_BATCH,
             RG_CONTEXT, RG_LONG_GEN, True),
            ("recurrentgemma-2b 3 layers long_500k", rg3, RG_LONG_BATCH,
             RG_LONG_CONTEXT, RG_LONG_GEN, True),
            ("xlstm-125m", xl, XL_BATCH, XL_CONTEXT, XL_GEN, True))
    out = {"runs": {}, "launches": no_launches()}
    for name, cfg, B, S, n_gen, profile in runs:
        res = _serve_lm(f"serve_recurrent {name}", cfg, B, S, n_gen, 100,
                        warm_len=WARM_LEN, profile=profile,
                        describe=_rec_describe(cfg))
        if cfg.name == "xlstm-125m":
            mixer = res["params_tree"]["stack"]["scanned"][0][1]["mixer"]
            res["slstm"] = _slstm_step_ms(cfg, mixer, B, S)
        _drop_model(res)
        out["runs"][name] = res
        for k, v in res["launches"].items():
            out["launches"][k] += v
    short = out["runs"]["recurrentgemma-2b 3 layers 32k"]
    long = out["runs"]["recurrentgemma-2b 3 layers long_500k"]
    busy = [r["profile"]["decode_4_steps"].get("busy_ms")
            for r in (long, short)]
    check(None not in busy, "serve_recurrent: no device time in the decode "
          "profiles of the long-context pair")
    growth = {"context_ratio": RG_LONG_CONTEXT / RG_CONTEXT,
              "prefill_ratio": long["prefill_ms"] / short["prefill_ms"],
              "decode_ratio": long["decode_ms_per_token"]
              / short["decode_ms_per_token"],
              "decode_device_ratio": busy[0] / busy[1]}
    log(f"serve_recurrent long_500k vs its 32k twin (3 layers, B = 1): "
        f"context x{growth['context_ratio']:.0f}, prefill "
        f"x{growth['prefill_ratio']:.2f}, decode per token "
        f"x{growth['decode_ratio']:.2f} on the host clock, its device time "
        f"x{growth['decode_device_ratio']:.2f} (at most {REC_DECODE_GROWTH})")
    # the device time, not the host-bound wall time, is what grows if a
    # decode step reads the context
    check(growth["decode_device_ratio"] <= REC_DECODE_GROWTH,
          f"serve_recurrent: decode's device time grew x"
          f"{growth['decode_device_ratio']:.2f} from 32,768 to 524,288 "
          f"tokens of context; a recurrent state and a window do not grow")
    out["long_context"] = growth
    out["state_check"] = _rec_state_check()
    out["b6_shape"] = _flash_at_shape(
        "recurrentgemma local (MQA, group 10, window 2,048)", RG_BATCH,
        rg.n_heads, rg.n_kv_heads, RG_CONTEXT, rg.head_dim, rg.head_dim,
        FLASH_ROWS, "serve_recurrent", window=rg.window)
    return out


def whisper_config():
    """whisper-large-v3 at full width and depth."""
    return tconfigs.get_config("whisper-large-v3")


def _whisper_inputs(cfg, B: int, S: int, seed: int):
    """Seeded frames and a 1-token decoder prompt of the shapes and dtypes
    ``input_specs`` gives a prefill of B requests of S frames."""
    shape = tconfigs.ShapeConfig(f"whisper_{S}", S, B, "prefill")
    spec = tconfigs.input_specs(cfg, shape)
    frames = torch.randn(spec["frames"].shape, generator=gen(seed),
                         device=DEV).to(spec["frames"].dtype)
    tokens = torch.randint(0, cfg.vocab_size, spec["tokens"].shape,
                           generator=gen(seed + 1), device=DEV,
                           dtype=spec["tokens"].dtype)
    return frames, tokens


def _whisper_numerics(seed: int) -> dict:
    """whisper-large-v3 at full width cut to 2 + 2 layers, B = 2, 1,500
    frames, one set of seeded f32 weights: the bf16 model (weights cast by
    ``prepare``) against the f32 one on the card, the prefill logits and 4
    teacher-forced decode steps (≤ TOL_WH scale-normalized); and each
    model's decode-step logits against its ``forward``'s teacher-forced
    logits at the same positions (≤ TOL_WH).  Both models take the same
    bf16 frames."""
    base = dataclasses.replace(whisper_config(), n_layers=WH_CHECK_LAYERS,
                               n_enc_layers=WH_CHECK_LAYERS,
                               n_dec_layers=WH_CHECK_LAYERS)
    cfg32 = dataclasses.replace(base, dtype="float32")
    m16, m32 = tmodel.build_model(base), tmodel.build_model(cfg32)
    p32 = m32.init(gen(seed), DEV)
    p16 = m16.prepare(p32)
    frames, _ = _whisper_inputs(base, WH_CHECK_B, WH_CHECK_S, seed + 1)
    toks = torch.randint(0, base.vocab_size, (WH_CHECK_B,
                                              1 + WH_CHECK_STEPS),
                         generator=gen(seed + 2), device=DEV)
    res = {}
    logits = {}
    for name, m, p, f in (("bf16", m16, p16, frames),
                          ("f32", m32, p32, frames.float())):
        lg, cache = m.prefill(p, {"frames": f, "tokens": toks[:, :1]},
                              WH_DEC_LEN)
        seq = [lg]
        for t in range(1, 1 + WH_CHECK_STEPS):
            lg, cache = m.decode_step(p, cache, toks[:, t:t + 1], t)
            seq.append(lg)
        logits[name] = torch.stack(seq, dim=1).float()
        del cache
        full, _ = m.forward(p, {"frames": f, "tokens": toks})
        check(bool(torch.isfinite(logits[name]).all())
              and bool(torch.isfinite(full).all()),
              f"whisper 2 + 2 layers {name}: a logit is not finite")
        res[f"{name}_decode_vs_forward"] = scaled_err(logits[name],
                                                      full.float())
    res["bf16_vs_f32"] = scaled_err(logits["bf16"], logits["f32"])
    res["bf16_vs_f32_prefill"] = scaled_err(logits["bf16"][:, 0],
                                            logits["f32"][:, 0])
    worst = max(res.values())
    check(worst <= TOL_WH, f"whisper 2 + 2 layers: {res} > {TOL_WH}")
    log(f"serve_whisper numerics (2 + 2 layers at full width, B = "
        f"{WH_CHECK_B}, {WH_CHECK_S} frames, prefill + {WH_CHECK_STEPS} "
        f"decode steps): bf16 vs f32 {res['bf16_vs_f32']:.3g} (prefill "
        f"{res['bf16_vs_f32_prefill']:.3g}); decode vs forward bf16 "
        f"{res['bf16_decode_vs_forward']:.3g}, f32 "
        f"{res['f32_decode_vs_forward']:.3g} (limit {TOL_WH})")
    del m16, m32, p16, p32
    torch.cuda.empty_cache()
    return res


def phase_serve_whisper() -> dict:
    """whisper-large-v3 at full width and depth served through
    ``serve.generate`` at two encoder lengths (``WH_RUNS``), one model for
    both; B6 96 times a prefill (32 encoder layers non-causal, 32 decoder
    self-attentions causal, 32 cross-attentions non-causal) and 32 times a
    decode step (the cross-attentions; the self-attention reads its cache
    directly), all on the tensor cores.  Then the 2 + 2-layer numerics
    check and B6 timed alone at the encoder shapes and the cross read."""
    cfg = whisper_config()
    decode_32k = next(sh for sh in tconfigs.shapes_for(cfg.name)
                      if sh.name == "decode_32k")
    spec = tconfigs.input_specs(cfg, decode_32k)
    check(spec["tokens"].shape == (decode_32k.global_batch, 1),
          f"whisper decode_32k input specs {spec}")
    t0 = time.perf_counter()
    model = tmodel.build_model(cfg)
    params = model.prepare(model.init(gen(110), DEV))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    n_pre = cfg.n_enc_layers + 2 * cfg.n_dec_layers
    out = {"runs": {}, "launches": no_launches(), "params": n_params,
           "init_s": init_s}
    for name, B, S, n_gen in WH_RUNS:
        S = S or decode_32k.seq_len
        tag = f"serve_whisper {name}"
        cuts = ("none but the weights and the stubbed frontend"
                if name == "30 s" else
                f"the weights, the stubbed frontend, batch "
                f"{decode_32k.global_batch} -> {B}, {n_gen} tokens")
        log(f"{tag}: {cfg.name}, {cfg.n_enc_layers} encoder + "
            f"{cfg.n_dec_layers} decoder layers, d_model {cfg.d_model}, "
            f"heads {cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim}, d_ff "
            f"{cfg.d_ff} {cfg.mlp_variant}, vocab {cfg.vocab_size}, "
            f"frontend_dim {cfg.frontend_dim}, {n_params:,} params held in "
            f"{cfg.dtype} (init + cast {init_s:.1f} s); batch {B}, {S} "
            f"frames, a 1-token decoder prompt, a {WH_DEC_LEN}-position "
            f"decoder cache, gen {n_gen}; cuts: {cuts}")
        frames, prompts = _whisper_inputs(cfg, B, S, 111)
        res = _serve_run(tag, model, params, prompts, n_gen, 112,
                         b6_prefill=n_pre, b6_decode=cfg.n_dec_layers,
                         warm_len=1, frames=frames, max_len=WH_DEC_LEN)
        res.update(batch=B, frames=S, gen=n_gen, cuts=cuts)
        del res["model"], res["params_tree"]
        out["runs"][name] = res
        for k, v in res["launches"].items():
            out["launches"][k] += v
        del frames, prompts
    del model, params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["numerics"] = _whisper_numerics(113)
    out["b6_shapes"] = _flash_whisper_shapes(cfg, decode_32k.seq_len)
    return out


def _flash_bshd_inputs(B, H, Sq, Sk, D, dtype, seed):
    """q, k, v as the model hands them to B6: (B, S, H, D) activations
    viewed as (B, H, S, D); q, k with unit variance, v ~ N(0, 1)."""
    g = gen(seed)
    q = torch.randn((B, Sq, H, D), generator=g, device=DEV).to(dtype)
    k = torch.randn((B, Sk, H, D), generator=g, device=DEV).to(dtype)
    v = torch.randn((B, Sk, H, D), generator=g, device=DEV).to(dtype)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _flash_whisper_shapes(cfg, S_long: int) -> list:
    """B6 non-causal at whisper's encoder shapes (run (a)'s and run (b)'s)
    and at run (b)'s decode cross read (Sq = 1 against 32,768 keys), in
    the model's strided layout, bf16 (the tensor-core kernel): timed, held
    on FLASH_ROWS sampled query rows (every row of the cross read) to its
    plain version and to f64 (≤ TOL_FLASH_ROW_BF16), beside
    ``scaled_dot_product_attention`` on the same tensors; the f32 route
    (``flash.cu``) at the 1,500-frame shape held to its plain version
    (≤ TOL_FLASH_ROW_F32).  The bound: 4·B·H·Sq·Sk·D flops over the bf16
    peak, or the bytes of one read of q, k, v and one write of the output
    over the HBM rate, whichever is larger."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F
    H, D = cfg.n_heads, cfg.head_dim
    (_, B_a, S_a, _), (_, B_b, _, _) = WH_RUNS
    shapes = (("whisper encoder 30 s", B_a, S_a, S_a, True),
              ("whisper encoder decode_32k", B_b, S_long, S_long, False),
              ("whisper cross read decode_32k", B_b, 1, S_long, False))
    out = []
    for label, B, Sq, Sk, with_f32 in shapes:
        q, k, v = _flash_bshd_inputs(B, H, Sq, Sk, D, torch.bfloat16, 120)
        n_rows = min(FLASH_ROWS, Sq)
        rows = torch.sort(torch.randperm(Sq, generator=gen(121), device=DEV)[
            :n_rows]).values
        reps = 20 if Sq == 1 else 5
        tc0 = fa_kernel.launch_counts()["flash_attention_tc"]
        ms, o = cuda_ms(lambda: fa_kernel.flash_attention_cuda(
            q, k, v, causal=False), reps=reps, warmup=2)
        check(fa_kernel.launch_counts()["flash_attention_tc"] - tc0
              == reps + 2, f"B6 {label}: bf16 calls missed the tensor-core "
              f"kernel")
        got = o[:, :, rows]
        del o
        plain_ms, plain = cuda_ms(lambda: fa_kernel.flash_attention_plain(
            q[:, :, rows], k, v, causal=False), reps=1, warmup=1)
        exact = _attention_rows_f64(q, k, v, rows, None, causal=False)
        vs_plain = _check_rows(got, plain, TOL_FLASH_ROW_BF16,
                               f"B6 {label} bf16 rows vs plain")
        vs_f64 = _check_rows(got, exact, TOL_FLASH_ROW_BF16,
                             f"B6 {label} bf16 rows vs f64")
        max_abs = float((got.float() - plain.float()).abs().max())
        del got, plain
        res = {"label": label, "path": "serve_whisper",
               "shape": {"B": B, "Hq": H, "Hkv": H, "Sq": Sq, "Sk": Sk,
                         "D": D, "Dv": D, "causal": False, "window": None,
                         "dtype": "bfloat16", "layout": "(B, S, H, D) "
                                                        "viewed"},
               "ms": ms, "plain_ms_rows": plain_ms, "plain_rows": n_rows,
               "row_err_vs_plain": vs_plain["max"],
               "row_err_vs_f64": vs_f64["max"], "max_abs_err": max_abs}
        if with_f32:
            q32, k32, v32 = q.float(), k.float(), v.float()
            res["ms_f32"], o = cuda_ms(lambda: fa_kernel.flash_attention_cuda(
                q32, k32, v32, causal=False), reps=3, warmup=1)
            got = o[:, :, rows]
            del o
            plain = fa_kernel.flash_attention_plain(q32[:, :, rows], k32, v32,
                                                    causal=False)
            res["row_err_f32_vs_plain"] = _check_rows(
                got, plain, TOL_FLASH_ROW_F32,
                f"B6 {label} f32 rows vs plain")["max"]
            res["row_err_f32_vs_f64"] = float(row_errs(got, exact).max())
            del q32, k32, v32, got, plain
        flops = 4.0 * B * H * Sq * Sk * D
        nbytes = 2 * (2 * B * H * Sq * D + 2 * B * H * Sk * D)
        res["flops"], res["bytes"] = flops, nbytes
        t_ops, t_bytes = flops / PEAK_BF16_TC_FLOPS, nbytes / PEAK_HBM_BYTES
        res["bound_ms"] = max(t_ops, t_bytes) * 1e3
        res["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        res["roof_share"] = res["bound_ms"] / ms
        try:
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                              SDPBackend.CUDNN_ATTENTION,
                              SDPBackend.EFFICIENT_ATTENTION]):
                lib_ms, lib_out = cuda_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v),
                    reps=reps, warmup=2)
            res["library_ms"] = lib_ms
            res["library_row_err_vs_f64"] = float(row_errs(
                lib_out[:, :, rows], exact).max())
            del lib_out
        except RuntimeError as exc:      # no fused backend takes the shape
            res["library_ms"] = None
            res["library_note"] = str(exc).splitlines()[0][:160]
        res["library_call"] = ("F.scaled_dot_product_attention(q, k, v) "
                               "(flash/cuDNN/efficient backends)")
        del q, k, v, exact
        torch.cuda.empty_cache()
        log(f"B6 {label} (B={B}, H={H}, Sq={Sq}, Sk={Sk}, D={D}, "
            f"non-causal, bf16): {ms:.4f} ms ({res['roof_share']:.1%} of its "
            f"bound {res['bound_ms']:.4f} ms, {res['bound_by']}); SDPA "
            + (f"{res['library_ms']:.4f} ms "
               f"({ms / res['library_ms']:.2f}x)" if res["library_ms"]
               else f"not measured ({res['library_note']})")
            + f"; rows vs plain {vs_plain['max']:.3g}, vs f64 "
            f"{vs_f64['max']:.3g} on {n_rows} rows, plain {plain_ms:.2f} ms"
            + (f"; f32 (CUDA cores) {res['ms_f32']:.2f} ms, rows vs plain "
               f"{res['row_err_f32_vs_plain']:.3g}" if with_f32 else ""))
        out.append(res)
    return out


#: the classes of the kernels launched inside the recurrent mixers'
#: profiler ranges (their names alone are torch's generic elementwise,
#: reduction and GEMM kernels)
REC_CLASSES = {trec.SCAN_RANGE: "recurrence (RG-LRU gates + scan, mLSTM "
                                "chunks)",
               trec.SLSTM_RANGE: "sLSTM step (per-token loop)"}
#: the classes of the B6 launches inside the encoder-decoder's profiler
#: ranges (the encoder's bidirectional self-attention, every
#: cross-attention); B6 elsewhere is causal self-attention
B6_RANGES = {tmodel.ENCODE_RANGE: "B6 encoder self-attention (non-causal)",
             tmodel.CROSS_RANGE: "B6 cross-attention (non-causal)"}
#: the classes of every kernel a train step launches inside its profiler
#: ranges: B6's backward (``attention_vjp``) and the optimizer's update
TRAIN_CLASSES = {fa_grad.VJP_RANGE: "attention_vjp (B6 backward, f32)",
                 tsteps.OPT_RANGE: "optimizer (adamw update)"}


def _kernel_class(name: str, rng: str = "") -> str:
    """A kernel's class by its name, or by the profiler range ``rng`` it
    was launched in: every kernel of a recurrent mixer's range, a B6
    launch in the encoder-decoder's ranges."""
    if rng in REC_CLASSES:
        return REC_CLASSES[rng]
    if rng in TRAIN_CLASSES:
        return TRAIN_CLASSES[rng]
    low = name.lower()
    if "flash_kernel" in low or "flash_wgmma_kernel" in low:
        return B6_RANGES.get(rng, "B6 flash_attention")
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
    (``torch.profiler`` over ``reps`` calls after one warm-up, host and
    device activities, as ``_device_profile`` traces); {} where the
    profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            name = re.sub(r"\(anonymous namespace\)::", "", e.key)
            out[name.split("(")[0][:60]] = us / 1e3 / reps
    return out


def _queued_device_ms(fn, reps: int = 50,
                      spin_cycles: int = 50_000_000) -> float:
    """Device ms per call of ``fn()`` without the profiler: the ``reps``
    calls are enqueued behind a spin kernel (``torch.cuda._sleep``, ~30 ms
    at the H100's clocks), so the events recorded before and after them
    time the card's work back to back, not the host's per-call work.
    Fails if the spin ended before the host had enqueued every call (the
    time would then include the host's)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    queued = not start.query()
    stop.synchronize()
    check(queued, "the spin kernel ended before the calls were enqueued: "
          "the events would time the host")
    return start.elapsed_time(stop) / reps


def _in_range(e) -> str:
    """The recurrent or train profiler range a CPU event lies in ("" if
    none)."""
    while e is not None:
        if e.name in REC_CLASSES or e.name in TRAIN_CLASSES:
            return e.name
        e = e.cpu_parent
    return ""


def _ranged_kernels(prof) -> list:
    """(range, kernel name, device ms) of every device activity launched
    while a recurrent mixer's, the encoder-decoder's or a train step's
    profiler range was open on the host (the ranges do not nest): each
    device activity carries the id of the runtime call that launched it
    (``cudaLaunchKernel``, ``cudaGraphLaunch``, a copy), and that call
    lies inside the range's host interval.  This also takes the kernels a
    CUDA graph replays, which no operator owns."""
    import bisect
    from torch.autograd import DeviceType
    evts = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in evts if e.device_type == DeviceType.CPU
                   and (e.name in REC_CLASSES or e.name in B6_RANGES
                        or e.name in TRAIN_CLASSES))
    starts = [sp[0] for sp in spans]
    launched = {}
    for e in evts:
        if e.device_type != DeviceType.CPU or not e.name.startswith("cu"):
            continue
        k = bisect.bisect_right(starts, e.time_range.start) - 1
        if k >= 0 and e.time_range.start <= spans[k][1]:
            launched[e.id] = spans[k][2]
    return [(launched[e.id], e.name, e.time_range.elapsed_us() / 1e3)
            for e in evts if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.id in launched]


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
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
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
    # the kernels launched inside a recurrent mixer's profiler range, and
    # B6 inside the encoder-decoder's, moved from their names' classes to
    # the range's
    for rng, name, ms in _ranged_kernels(prof):
        by_class[_kernel_class(name)] -= ms
        cls = _kernel_class(name, rng)
        by_class[cls] = by_class.get(cls, 0.0) + ms
    # the kernels launched under aten::bmm outside those ranges, split out
    # of the matmuls: in a prefill only the MoE's expert GEMMs call it (the
    # projections are 2-d matmuls); in decode the attention's einsum reads
    # do too
    bmm = sum(e.device_time_total for e in prof.events()
              if e.name == "aten::bmm" and e.device_type == DeviceType.CPU
              and not _in_range(e)) / 1e3
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
                   extra=None, max_len=None) -> dict:
    """One prefill and 4 decode steps, each run unprofiled and then under
    the profiler (outside the counted run); ``extra`` joins the prefill
    batch (patches, frames)."""
    state = {}
    S = prompts.shape[1]
    batch = {"tokens": prompts, **(extra or {})}

    def prefill():
        state["logits"], state["cache"] = model.prefill(
            params, batch, max_len or S + n_gen,
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


def _attention_rows_f64(q, k, v, rows, window, causal=True):
    """Attention of the query ``rows`` in f64, one (batch row, kv head) at
    a time: causal (the rows are also their key positions: Sq = Sk), with
    an optional window, or bidirectional."""
    B, Hq, _, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    out = torch.empty((B, Hq, rows.shape[0], v.shape[3]),
                      dtype=torch.float64, device=q.device)
    col = torch.arange(Sk, device=q.device)[None, :]
    mask = (col <= rows[:, None]) if causal else torch.ones(
        (rows.shape[0], Sk), dtype=torch.bool, device=q.device)
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
    lib_local = _sdpa_windowed(q, k, v, cfg.window, rows)
    log(f"B6 local shape vs the library: {loc['ms']:.2f} ms vs SDPA with a "
        f"window mask (memory-efficient backend) "
        + (f"{lib_local['library_ms']:.2f} ms "
           f"({loc['ms'] / lib_local['library_ms']:.3f}x); SDPA per-row "
           f"relative error vs f64 {lib_local['library_row_err_vs_f64']:.3g}"
           if lib_local["library_ms"] else
           f"not measured ({lib_local['library_note']})"))
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
            "local_window": cfg.window,
            "library_ms_local": lib_local["library_ms"],
            "library_local": lib_local}


def _sdpa_windowed(q, k, v, window: int, rows) -> dict:
    """The library yardstick of a windowed causal layer: SDPA with an
    explicit (S, S) sliding-window mask, forced onto the memory-efficient
    backend (the math backend would make the (B, H, S, S) scores; the
    flash backend takes no mask), the kv heads repeated to the query heads;
    one timed call, and its sampled rows against f64.  Returns the time, or
    the backend's refusal as the finding."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F
    G = q.shape[1] // k.shape[1]
    ke, ve = (t.repeat_interleave(G, dim=1) for t in (k, v))
    i = torch.arange(q.shape[2], device=DEV)
    mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    try:
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            ms, out = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, ke, ve, attn_mask=mask))
    except RuntimeError as exc:      # the backend refuses the shape
        return {"library_ms": None,
                "library_note": str(exc).splitlines()[0][:160]}
    got = out[:, :, rows]
    del out, ke, ve, mask
    err = float(row_errs(got, _attention_rows_f64(q, k, v, rows,
                                                  window)).max())
    return {"library_ms": ms, "library_row_err_vs_f64": err,
            "library_call": "F.scaled_dot_product_attention(q, k, v, "
                            "attn_mask=window mask) on "
                            "SDPBackend.EFFICIENT_ATTENTION"}


def _flash_at_shape(label: str, B: int, Hq: int, Hkv: int, S: int, D: int,
                    Dv: int, n_rows: int, path: str,
                    window: int = None) -> dict:
    """B6 at a served model's prefill shape, bf16 (the tensor-core kernel):
    timed (one launch a call), held row by row on ``n_rows`` sampled query
    rows to its plain version (≤ TOL_FLASH_ROW_BF16), its bound (the causal
    half's flops, or the window's, over the bf16 tensor-core peak, or the
    bytes), and SDPA timed where one of its fused backends takes the shape
    (else None; with a window, ``_sdpa_windowed``)."""
    q, k, v = _flash_inputs(B, Hq, Hkv, S, S, D, torch.bfloat16, seed=47,
                            qk_scale=1.0, Dv=Dv)
    rows = torch.sort(torch.randperm(S, generator=gen(48), device=DEV)[
        :n_rows]).values
    tc0 = fa_kernel.launch_counts()["flash_attention_tc"]
    ms, out = cuda_ms(lambda: fa_kernel.flash_attention_cuda(
        q, k, v, causal=True, window=window), reps=3, warmup=1)
    check(fa_kernel.launch_counts()["flash_attention_tc"] - tc0 == 4,
          f"B6 {label}: bf16 calls missed the tensor-core kernel")
    got = out[:, :, rows]
    del out
    plain_ms, plain = cuda_ms(lambda: fa_kernel.flash_attention_plain(
        q[:, :, rows], k, v, causal=True, window=window, q_pos=rows),
        reps=1, warmup=1)
    errs = _check_rows(got, plain, TOL_FLASH_ROW_BF16,
                       f"B6 {label} rows vs plain")
    max_abs = float((got.float() - plain.float()).abs().max())
    del got, plain
    flops = _flash_flops(B, Hq, S, D, Dv, window)
    nbytes = 2 * (B * Hq * S * D + B * Hkv * S * (D + Dv) + B * Hq * S * Dv)
    bound_ms = max(flops / PEAK_BF16_TC_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F
    lib = {"library_ms": None}
    if window is not None:
        lib = _sdpa_windowed(q, k, v, window, rows)
    else:
        try:
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                              SDPBackend.CUDNN_ATTENTION,
                              SDPBackend.EFFICIENT_ATTENTION]):
                lib["library_ms"], _ = cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=Hq != Hkv),
                    reps=3, warmup=1)
        except RuntimeError as exc:      # no fused backend takes the shape
            lib["library_note"] = str(exc).splitlines()[0][:160]
    lib_ms, lib_note = lib["library_ms"], lib.get("library_note")
    del q, k, v
    torch.cuda.empty_cache()
    res = {"label": label, "path": path,
           "shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "S": S, "D": D, "Dv": Dv,
                     "causal": True, "window": window, "dtype": "bfloat16"},
           "ms": ms, "bound_ms": bound_ms,
           "bound_by": "operations" if flops / PEAK_BF16_TC_FLOPS
           >= nbytes / PEAK_HBM_BYTES else "bytes",
           "bf16_roof_share": bound_ms / ms, "plain_ms_rows": plain_ms,
           "plain_rows": n_rows, "row_err_vs_plain": errs["max"],
           "row_err_vs_plain_median": errs["median"],
           "max_abs_err": max_abs, **lib}
    log(f"B6 {label} (B={B}, Hq={Hq}, Hkv={Hkv}, S={S}, D={D}, Dv={Dv}, "
        f"causal, window {window}, bf16): {ms:.2f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
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
            lambda: kernel.pairwise_block_cuda(sp, X, Xa), reps=20)
        line["device_ms"] = _queued_device_ms(
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
        log(f"B2 {k} ({N} x {CAL_ANCHORS}, d = {D}): {v['ms']:.4f} ms a "
            f"call, {v['device_ms']:.4f} ms on the card (calls queued "
            f"behind a spin kernel), plain "
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


# ---------------------------------------------------------------------------
# training: B6's gradient, the train step at full width, card against CPU
# ---------------------------------------------------------------------------

def _visible_pairs(S: int, causal: bool, window) -> int:
    """(query, key) pairs a full-length attention call sees at Sq = Sk."""
    if not causal:
        return S * S if window is None else sum(
            min(S, i + window) - max(0, i - window + 1) for i in range(S))
    if window is None:
        return S * (S + 1) // 2
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def _sdpa_fwd_bwd(q, k, v, do, causal: bool, window) -> dict:
    """The library yardstick of a backward kernel: SDPA's forward and
    forward + backward at the same shape in bf16 (flash / cuDNN / efficient
    backends; a window as an explicit mask on the memory-efficient
    backend, the kv heads repeated), or the backend's refusal."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F
    kw, backends = {"is_causal": causal}, [SDPBackend.FLASH_ATTENTION,
                                           SDPBackend.CUDNN_ATTENTION,
                                           SDPBackend.EFFICIENT_ATTENTION]
    if window is not None:
        G = q.shape[1] // k.shape[1]
        k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
        i = torch.arange(q.shape[2], device=DEV)
        kw = {"attn_mask": (i[None, :] <= i[:, None])
              & (i[:, None] - i[None, :] < window)}
        backends = [SDPBackend.EFFICIENT_ATTENTION]
    elif q.shape[1] != k.shape[1]:
        kw["enable_gqa"] = True

    def fwd(grad: bool):
        leaves = [t.detach().requires_grad_(grad) for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, **kw)
        return torch.autograd.grad(out, leaves, do) if grad else out

    try:
        with sdpa_kernel(backends):
            fwd_ms, _ = cuda_ms(lambda: fwd(False), reps=3, warmup=1)
            fb_ms, _ = cuda_ms(lambda: fwd(True), reps=3, warmup=1)
    except RuntimeError as exc:        # no backend takes the shape
        return {"sdpa_fwd_ms": None, "sdpa_fwd_bwd_ms": None,
                "sdpa_bwd_ms": None,
                "sdpa_note": str(exc).splitlines()[0][:160]}
    return {"sdpa_fwd_ms": fwd_ms, "sdpa_fwd_bwd_ms": fb_ms,
            "sdpa_bwd_ms": fb_ms - fwd_ms}


def _grad_case(label, B, Hq, Hkv, S, D, Dv, causal, window, dtype) -> dict:
    """B6's Function at one shape and dtype: its dq, dk, dv (the kernel's
    forward, ``attention_vjp``'s backward) against torch autograd of the
    plain version on the same inputs and cotangent; one forward launch on
    the dtype's route; then the forward kernel, ``attention_vjp``, the
    plain version's forward + backward and (bf16) SDPA's timed."""
    bf16 = dtype == torch.bfloat16
    q, k, v = _flash_inputs(B, Hq, Hkv, S, S, D, dtype, seed=61,
                            qk_scale=1.0, Dv=Dv)
    do = torch.randn((B, Hq, S, Dv), generator=gen(62), device=DEV).to(dtype)
    tag = f"train_grad {label} {'bf16' if bf16 else 'f32'}"
    c0 = fa_kernel.launch_counts()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa_ops.flash_attention(*leaves, causal=causal, window=window)
    check(out.grad_fn is not None, f"{tag}: no autograd node")
    got = torch.autograd.grad(out, leaves, do)
    del out
    c1 = fa_kernel.launch_counts()
    check(c1["flash_attention"] - c0["flash_attention"] == 1
          and c1["flash_attention_tc"] - c0["flash_attention_tc"]
          == int(bf16), f"{tag}: the forward should be one B6 launch on "
          f"the {'tensor-core' if bf16 else 'CUDA-core'} kernel")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain = fa_kernel.flash_attention_plain(*leaves, causal=causal,
                                            window=window)
    ref = torch.autograd.grad(plain, leaves, do)
    del plain, leaves
    tol = TOL_GRAD_BF16 if bf16 else TOL_GRAD_F32
    errs, max_abs = {}, 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        check(a.dtype == dtype and a.shape == b.shape, f"{tag} {name}: "
              f"{a.dtype} {tuple(a.shape)}")
        check(bool(torch.isfinite(a).all()), f"{tag} {name}: non-finite")
        errs[name] = scaled_err(a.float(), b.float())
        max_abs = max(max_abs, float((a.float() - b.float()).abs().max()))
        check(errs[name] <= tol, f"{tag} {name}: {errs[name]:.3g} > {tol}")
    del got, ref
    fwd_ms, o = cuda_ms(lambda: fa_kernel.flash_attention_cuda(
        q, k, v, causal=causal, window=window), reps=3, warmup=1)
    vjp_ms, _ = cuda_ms(lambda: fa_grad.attention_vjp(
        q, k, v, o, do, causal, window), reps=3, warmup=1)

    def plain_fwd_bwd():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = fa_kernel.flash_attention_plain(*leaves, causal=causal,
                                              window=window)
        return torch.autograd.grad(out, leaves, do)

    plain_ms, _ = cuda_ms(plain_fwd_bwd, reps=1, warmup=1)
    pairs = _visible_pairs(S, causal, window) * B * Hq
    bwd_flops = 2.0 * pairs * (3 * D + 2 * Dv)
    # read q, o, dO and write dQ; read k, v and write dK, dV
    nbytes = q.element_size() * (2 * B * Hq * S * (D + Dv)
                                 + 2 * B * Hkv * S * (D + Dv))
    res = {"label": label, "dtype": "bfloat16" if bf16 else "float32",
           "shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "S": S, "D": D, "Dv": Dv,
                     "causal": causal, "window": window},
           "err": errs, "tol": tol, "max_abs_err": max_abs,
           "fwd_ms": fwd_ms, "vjp_ms": vjp_ms,
           "plain_fwd_bwd_ms": plain_ms, "bwd_flops": bwd_flops,
           "vjp_bound_ms_fp32": max(bwd_flops / PEAK_FP32_FLOPS,
                                    nbytes / PEAK_HBM_BYTES) * 1e3,
           "bwd_bound_ms_bf16": max(bwd_flops / PEAK_BF16_TC_FLOPS,
                                    nbytes / PEAK_HBM_BYTES) * 1e3}
    if bf16:
        res.update(_sdpa_fwd_bwd(q, k, v, do, causal, window))
    del q, k, v, do, o
    torch.cuda.empty_cache()
    sd = res.get("sdpa_bwd_ms")
    log(f"{tag} (B={B}, Hq={Hq}, Hkv={Hkv}, S={S}, D={D}, Dv={Dv}, causal "
        f"{causal}, window {window}): dq {errs['dq']:.3g}, dk "
        f"{errs['dk']:.3g}, dv {errs['dv']:.3g} vs the plain version's "
        f"autograd (limit {tol}); B6 forward {fwd_ms:.3f} ms, attention_vjp"
        f" {vjp_ms:.3f} ms (FP32 bound {res['vjp_bound_ms_fp32']:.3f} ms, "
        f"bf16 tensor-core bound {res['bwd_bound_ms_bf16']:.3f} ms), plain "
        f"forward + backward {plain_ms:.2f} ms"
        + (f"; SDPA forward {res['sdpa_fwd_ms']:.3f} ms, backward "
           f"{sd:.3f} ms (attention_vjp {vjp_ms / sd:.1f}x)" if sd else
           (f"; SDPA not measured ({res['sdpa_note']})" if bf16 else "")))
    return res


def phase_train_grad() -> dict:
    """B6's gradient on the card at the train paths' attention shapes, in
    bf16 and f32 (``TRAIN_GRAD_SHAPES``)."""
    cases = [_grad_case(*shape, dtype) for shape in TRAIN_GRAD_SHAPES
             for dtype in (torch.bfloat16, torch.float32)]
    return {"cases": cases,
            "max_err_bf16": max(max(c["err"].values()) for c in cases
                                if c["dtype"] == "bfloat16"),
            "max_err_f32": max(max(c["err"].values()) for c in cases
                               if c["dtype"] == "float32")}


def train_config():
    """gemma3-12b at full width, one pattern period (5 local + 1 global
    layers)."""
    return dataclasses.replace(gemma3_12b.FULL, n_layers=TRAIN_LAYERS)


def train_moe_config():
    """qwen2-moe-a2.7b at full width, 2 layers."""
    return dataclasses.replace(tconfigs.get_config("qwen2-moe-a2.7b"),
                               n_layers=TRAIN_MOE_LAYERS)


def _grad_check(opt, pick):
    """``opt`` whose first update records, for the gradient leaves
    ``pick(grads)`` selects, how many are finite and how many nonzero (one
    host read, on step 1), then updates as ``opt`` does."""
    seen = {}

    def update(grads, state, params, lr):
        if not seen:
            leaves = topt.optimizers.tree_leaves(pick(grads))
            ok = torch.stack([torch.stack([torch.isfinite(g).all(),
                                           (g != 0).any()])
                              for g in leaves]).sum(0).tolist()
            seen.update(leaves=len(leaves), finite=ok[0], nonzero=ok[1])
        return opt.update(grads, state, params, lr)

    return dataclasses.replace(opt, update=update), seen


def _train_flops(cfg, params, tokens: int, S: int) -> dict:
    """The step's model FLOPs: 6 x the matmul parameters (every leaf of
    two or more dims; the tied embedding counts once, as the unembedding)
    x tokens, plus 12 x tokens x visible keys x heads x head_dim summed
    over the attention layers (of S tokens a row); remat's recompute and
    the recurrences' elementwise work are not counted."""
    mm = sum(t.numel() for t in topt.optimizers.tree_leaves(params)
             if t.ndim >= 2)
    attn = sum(12.0 * tokens * _visible_pairs(S, True, cfg.window if kind
                                              == "local" else None) / S
               * cfg.n_heads * cfg.head_dim
               for *_, kind in ttransformer.layer_slots(cfg)
               if kind in ttransformer.ATTN_KINDS)
    return {"matmul_params": mm, "flops_matmul": 6.0 * mm * tokens,
            "flops_attention": attn, "flops": 6.0 * mm * tokens + attn}


def _train_run(tag: str, cfg, B: int, accum: int, steps: int, seed: int,
               pick, b6_per_step: int, profile: bool, S: int = 0,
               profile_seq: int = 0, after=None) -> dict:
    """``steps`` steps of ``make_train_step`` from a seeded init on the
    card, SyntheticLM(seed=0) batches of S tokens: every count reset just
    before and read just after; each step timed (host clock,
    synchronized); B6 ``b6_per_step`` times a step, all on the tensor-core
    kernel, and nothing else; the picked gradient leaves finite and
    nonzero on step 1; the losses finite.  Then, outside the counted run,
    one more step's device time by class, and ``after(model, params,
    opt_state, pipe)`` (its result as ``res["after"]``) before the
    params go.  S = 0 takes TRAIN_SEQ; the profiled step runs at
    ``profile_seq`` tokens a row (0: S)."""
    S = S or TRAIN_SEQ
    t0 = time.perf_counter()
    model = tmodel.build_model(cfg)
    params = model.init(gen(seed), DEV)
    opt = tsteps.default_optimizer(cfg)
    opt_state = opt.init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in topt.optimizers.tree_leaves(params))
    checked, seen = _grad_check(opt, pick)
    step_fn = tsteps.make_train_step(model, checked, peak_lr=TRAIN_PEAK_LR,
                                     warmup=TRAIN_WARMUP, total=steps,
                                     accum=accum)
    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=S,
                       global_batch=B, seed=0)
    log(f"{tag}: {cfg.name} with {cfg.n_layers} layers {cfg.layer_pattern}, "
        f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}x"
        f"{cfg.head_dim}, d_ff {cfg.d_ff or cfg.moe_d_ff}, vocab "
        f"{cfg.vocab_size}, {n_params:,} params in {cfg.param_dtype} "
        f"(compute {cfg.dtype}; init {init_s:.1f} s), optimizer {opt.name};"
        f" global batch {B} x {S} tokens, accum {accum}, {steps} steps, "
        f"remat {cfg.remat}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_ms, b6, mets = [], [], []
    for s in range(steps):
        c0 = fa_kernel.launch_counts()
        t1 = time.perf_counter()
        params, opt_state, met = step_fn(params, opt_state, pipe.batch_at(s))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        b6.append({k: n - c0[k] for k, n in fa_kernel.launch_counts().items()})
        mets.append(met)
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    metrics = [{k: float(v) for k, v in m.items()} for m in mets]
    n = b6_per_step * steps
    check(launches == no_launches(flash_attention=n, flash_attention_tc=n),
          f"{tag}: the train path should launch B6 {b6_per_step} times a "
          f"step (forward and remat's recompute), each on the tensor-core "
          f"kernel, and nothing else: {launches}")
    check(b6 == [{"flash_attention": b6_per_step,
                  "flash_attention_tc": b6_per_step}] * steps,
          f"{tag}: B6 per step {b6}")
    check(seen["finite"] == seen["leaves"] and seen["nonzero"] ==
          seen["leaves"], f"{tag}: on step 1, of {seen['leaves']} gradient"
          f" leaves {seen['finite']} were finite and {seen['nonzero']} "
          f"nonzero")
    check(all(np.isfinite(list(m.values())).all() for m in metrics),
          f"{tag}: a metric was not finite: {metrics}")
    med = float(np.median(step_ms[1:]))
    tokens = B * S
    res = {"step_ms": step_ms, "step_ms_median_2_on": med,
           "tokens_per_step": tokens, "tokens_per_s": tokens / (med / 1e3),
           "peak_gb": peak_gb, "launches": launches, "b6_per_step": b6[0],
           "params": n_params, "init_s": init_s, "optimizer": opt.name,
           "grad_check": dict(seen), "metrics": metrics,
           "losses": [m["loss"] for m in metrics]}
    log(f"{tag} steps: " + ", ".join(f"{ms:.1f}" for ms in step_ms)
        + f" ms (median of steps 2-{steps} {med:.1f} ms, "
        f"{res['tokens_per_s']:,.0f} tokens/s); peak memory {peak_gb:.2f} "
        f"GB; B6 per step {b6[0]}; step 1 gradients: {seen['finite']} of "
        f"{seen['leaves']} leaves finite, {seen['nonzero']} nonzero")
    log(f"{tag} metrics by step: " + json.dumps(
        [{k: round(v, 5) for k, v in m.items()} for m in metrics]))
    if profile:
        prof_pipe = SyntheticLM(vocab_size=cfg.vocab_size,
                                seq_len=profile_seq or S, global_batch=B,
                                seed=0)
        p = _device_profile(lambda: step_fn(params, opt_state,
                                            prof_pipe.batch_at(steps)))
        p["seq_len"] = profile_seq or S
        res["profile"] = p
        if "error" in p:
            log(f"{tag} step profile: not measured ({p['error']})")
        else:
            log(f"{tag} step profile ({B} x {p['seq_len']} tokens): device "
                f"busy {p['busy_ms']:.1f} ms of "
                f"{p['wall_ms']:.1f} ms unprofiled wall (idle share "
                f"{p['idle_share']:.1%}); by class " + json.dumps(
                    {k: round(v, 2) for k, v in p["by_class_ms"].items()}))
            for t in p["top"]:
                log(f"    {t['ms']:9.2f} ms  x{t['count']:<5d} {t['kernel']}")
    res["flops"] = _train_flops(cfg, params, tokens, S)
    if after is not None:
        res["after"] = after(model, params, opt_state, pipe)
    del params, opt_state, step_fn, checked, mets
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return res


def phase_train_gemma3() -> dict:
    """The slice at full width: gemma3-12b, 6 layers, 4,096 tokens, global
    batch 2 at accum 2, adamw, 4 steps; every parameter's gradient finite
    and nonzero on step 1; step ms (median of steps 2-4), tokens/s, MFU
    (the step's model FLOPs over its time and the bf16 dense peak), peak
    memory, B6 launches a step, one step's device time by class."""
    cfg = train_config()
    per_step = TRAIN_ACCUM * 2 * cfg.n_layers    # forward + recompute
    res = _train_run("train_gemma3", cfg, TRAIN_BATCH, TRAIN_ACCUM,
                     TRAIN_STEPS, 60, lambda g: g, per_step, profile=True,
                     after=_remat_steps)
    res["remat"] = res.pop("after")
    f = res["flops"]
    res["mfu"] = f["flops"] / (res["step_ms_median_2_on"] / 1e3) \
        / PEAK_BF16_TC_FLOPS
    res["reduced"] = {"layers": f"{cfg.n_layers} of 48 (one 5:1 pattern "
                                f"period)",
                      "global_batch": f"{TRAIN_BATCH} of train_4k's 256 "
                                      f"(accum {TRAIN_ACCUM})",
                      "steps": TRAIN_STEPS, "weights": "seeded random"}
    log(f"train_gemma3: MFU {res['mfu']:.2%} ({f['flops'] / 1e12:.2f} TFLOP "
        f"a step: 6 x {f['matmul_params']:,} matmul params x "
        f"{res['tokens_per_step']} tokens + attention "
        f"{f['flops_attention'] / 1e12:.3f}; over the median step and "
        f"{PEAK_BF16_TC_FLOPS / 1e12:.0f} TFLOP/s); reduced "
        + json.dumps(res["reduced"]))
    return res


def _remat_steps(model, params, opt_state, pipe) -> dict:
    """One step of the same model, params and optimizer state under each
    of ``REMAT_POLICIES``, after one warm-up step of the policy: its step
    ms, peak memory, and B6 launches (a layer and microbatch: 1 under
    "none", 2 under the others, whose backward recomputes the forward).
    Every policy must run ("none", which keeps every activation, peaked
    at 72.4 GB on the card)."""
    cfg = model.cfg
    out = {}
    for policy in REMAT_POLICIES:
        m = tmodel.build_model(dataclasses.replace(cfg, remat=policy))
        step = tsteps.make_train_step(m, tsteps.default_optimizer(cfg),
                                      peak_lr=TRAIN_PEAK_LR,
                                      warmup=TRAIN_WARMUP, total=10 ** 6,
                                      accum=TRAIN_ACCUM)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, opt_state, met = step(params, opt_state, pipe.batch_at(100))
        c0 = fa_kernel.launch_counts()
        ms, (params, opt_state, met) = cuda_ms(
            lambda: step(params, opt_state, pipe.batch_at(101)))
        b6 = {k: n - c0[k] for k, n in fa_kernel.launch_counts().items()}
        layers = TRAIN_ACCUM * cfg.n_layers
        want = layers * (1 if policy == "none" else 2)
        check(b6 == {"flash_attention": want, "flash_attention_tc": want},
              f"remat {policy}: B6 launches {b6}, expected {want}")
        loss = float(met["loss"])
        check(np.isfinite(loss), f"remat {policy}: loss {loss}")
        out[policy] = {"step_ms": ms,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "b6_per_step": want, "loss": loss}
        log(f"train_gemma3 remat {policy}: one step {ms:.1f} ms, peak "
            f"{out[policy]['peak_gb']:.2f} GB, B6 {want} a step, loss "
            f"{loss:.5f}")
        del m, step
    torch.cuda.empty_cache()
    return out


def phase_train_moe() -> dict:
    """qwen2-moe-a2.7b at full width, 2 layers, 4,096 tokens, batch 1, 3
    steps: the out-of-place dispatch's backward on the card, ``aux`` in
    the metrics, the router's and the experts' gradients finite and
    nonzero on step 1."""
    cfg = train_moe_config()

    def moe_grads(g):
        return [ttransformer._entry(g["stack"], sec, r, i)["moe"]
                for sec, r, i, _ in ttransformer.layer_slots(cfg)]

    res = _train_run("train_moe", cfg, 1, 1, TRAIN_MOE_STEPS, 64, moe_grads,
                     2 * cfg.n_layers, profile=False)
    aux = [m["aux"] for m in res["metrics"]]
    check(all(a > 0 for a in aux), f"train_moe: aux {aux}")
    res["aux"] = aux
    return res


def phase_train_recurrent() -> dict:
    """The recurrent families train on the card.  recurrentgemma-2b at
    full width and depth (2,894,435,840 f32 params, bf16 compute, the
    tied 256,000 vocab), 2 x 4,096 tokens at accum 2, 4 steps: B6 is the
    forward of its 8 local layers (MQA, window 2,048), twice a layer a
    microbatch (forward and remat's recompute), 32 tensor-core launches
    a step.  xlstm-125m at full width, XL_TRAIN_LAYERS of its 12 layers,
    2 x XL_TRAIN_SEQ tokens,
    3 steps (profiled at XL_PROFILE_SEQ), no B6: the sLSTM loop runs
    plainly under grad (no CUDA graph).  Each: every parameter's gradient
    finite and nonzero on step 1, finite losses, step ms, tokens/s, MFU,
    peak memory, one step's device time by class (the RG-LRU / mLSTM
    recurrences and the sLSTM loop by their profiler ranges: forward and
    recompute)."""
    out = {}
    rg = tconfigs.get_config("recurrentgemma-2b")
    n_local = sum(kind == "local" for *_, kind in
                  ttransformer.layer_slots(rg))
    runs = (("recurrentgemma-2b", rg, RG_TRAIN_BATCH, RG_TRAIN_ACCUM,
             RG_TRAIN_STEPS, TRAIN_SEQ, 0, RG_TRAIN_ACCUM * 2 * n_local),
            ("xlstm-125m", dataclasses.replace(
                tconfigs.get_config("xlstm-125m"), n_layers=XL_TRAIN_LAYERS),
             XL_TRAIN_BATCH, 1, XL_TRAIN_STEPS, XL_TRAIN_SEQ, XL_PROFILE_SEQ,
             0))
    for name, cfg, B, accum, steps, S, prof_S, b6 in runs:
        res = _train_run(f"train_recurrent {name}", cfg, B, accum, steps,
                         80, lambda g: g, b6, profile=True, S=S,
                         profile_seq=prof_S)
        f = res["flops"]
        res["mfu"] = f["flops"] / (res["step_ms_median_2_on"] / 1e3) \
            / PEAK_BF16_TC_FLOPS
        res["reduced"] = {"global_batch": f"{B} of train_4k's 256 (accum "
                                          f"{accum})",
                          "steps": steps, "weights": "seeded random"}
        if S != TRAIN_SEQ:
            res["reduced"]["seq_len"] = (
                f"{S} of train_4k's {TRAIN_SEQ} (a {TRAIN_SEQ}-token step "
                f"took over 60 s, host-bound on the sLSTM loop)")
        if prof_S:
            res["reduced"]["profiled_step"] = f"{B} x {prof_S} tokens"
        if cfg.n_layers != tconfigs.get_config(name).n_layers:
            res["reduced"]["n_layers"] = (
                f"{cfg.n_layers} of {tconfigs.get_config(name).n_layers} "
                f"(the clock: the mesh runs (f)-(h))")
        by_class = res["profile"].get("by_class_ms", {})
        res["recurrence_ms"] = {rng: by_class.get(cls) for rng, cls in
                                REC_CLASSES.items()}
        log(f"train_recurrent {name}: MFU {res['mfu']:.2%} "
            f"({f['flops'] / 1e12:.2f} TFLOP a step: 6 x "
            f"{f['matmul_params']:,} matmul params x "
            f"{res['tokens_per_step']} tokens + attention "
            f"{f['flops_attention'] / 1e12:.3f}); profiler ranges "
            + json.dumps({k: None if v is None else round(v, 2)
                          for k, v in res["recurrence_ms"].items()})
            + "; reduced " + json.dumps(res["reduced"]))
        out[name] = res
    out["launches"] = {k: sum(out[n]["launches"][k] for n, *_ in runs)
                       for k in no_launches()}
    return out


def _loss_and_grads(model, params, batch):
    leaves = topt.optimizers.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), grads


def _parity_one(arch: str, S: int) -> dict:
    """One SMOKE model in f32 from the same weights on the CPU (B6's plain
    version, ``attention_vjp``) and on the card (B6's f32 kernel,
    ``attention_vjp``), S tokens a row: the loss and every gradient leaf,
    then 3 train steps' losses; no sLSTM loop replayed from a CUDA graph
    (a replay records no autograd graph)."""
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype="float32")
    model = tmodel.build_model(cfg)
    init = model.init(torch.Generator().manual_seed(70), "cpu")
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=S,
                        global_batch=2, seed=1).batch_at(0)

    def on(device):
        return topt.optimizers.tree_map(
            lambda t: t.detach().clone().to(device), init)

    graphed, replays = trec._slstm_graphed, []

    def spy(*args, **kwargs):
        replays.append(1)
        return graphed(*args, **kwargs)

    trec._slstm_graphed = spy
    try:
        c0 = fa_kernel.launch_counts()
        card_loss, card_g = _loss_and_grads(model, on(DEV), batch)
        c1 = fa_kernel.launch_counts()
    finally:
        trec._slstm_graphed = graphed
    cpu_loss, cpu_g = _loss_and_grads(model, on("cpu"), batch)
    # twice a stack layer (forward, remat's recompute), once for MTP's block
    n_b6 = 2 * sum(kind in ttransformer.ATTN_KINDS for *_, kind in
                   ttransformer.layer_slots(cfg)) + int(cfg.mtp)
    check(c1["flash_attention"] - c0["flash_attention"] == n_b6
          and c1["flash_attention_tc"] == c0["flash_attention_tc"],
          f"train_parity {arch}: the f32 loss should launch the CUDA-core "
          f"B6 kernel {n_b6} times: {c0} -> {c1}")
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    check(loss_err <= TOL_TRAIN_LOSS, f"train_parity {arch}: loss "
          f"{card_loss} on the card, {cpu_loss} on the CPU")
    grad_err = max(scaled_err(a.cpu(), b) for a, b in zip(card_g, cpu_g))
    check(grad_err <= TOL_TRAIN_GRAD, f"train_parity {arch}: a gradient "
          f"leaf differs by {grad_err:.3g} (limit {TOL_TRAIN_GRAD})")
    losses = {}
    for device in (DEV, "cpu"):
        params = on(device)
        opt = topt.adamw()
        state = opt.init(params)
        step = tsteps.make_train_step(model, opt, peak_lr=1e-2, warmup=1,
                                      total=3)
        pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=S,
                           global_batch=2, seed=2)
        out = []
        for s in range(3):
            params, state, met = step(params, state, pipe.batch_at(s))
            out.append(float(met["loss"]))
        losses[device] = out
    check(not replays, f"train_parity {arch}: the sLSTM loop was replayed "
          f"from a CUDA graph under grad ({len(replays)} times)")
    step_err = max(abs(a - b) / abs(b) for a, b in zip(losses[DEV],
                                                         losses["cpu"]))
    check(step_err <= TOL_TRAIN_STEPS, f"train_parity {arch}: step losses "
          f"{losses[DEV]} on the card, {losses['cpu']} on the CPU")
    log(f"train_parity {arch} (SMOKE, f32, {S} tokens, {len(card_g)} "
        f"leaves): loss "
        f"{card_loss:.6f} vs {cpu_loss:.6f} on the CPU ({loss_err:.3g}, "
        f"limit {TOL_TRAIN_LOSS}); gradients max {grad_err:.3g} (limit "
        f"{TOL_TRAIN_GRAD}); 3 steps' losses {losses[DEV]} vs "
        f"{losses['cpu']} ({step_err:.3g}, limit {TOL_TRAIN_STEPS})")
    return {"loss_err": loss_err, "grad_err": grad_err, "step_err": step_err,
            "leaves": len(card_g), "seq_len": S, "b6": n_b6}


def phase_train_parity() -> dict:
    """Card against CPU: gemma3-12b's SMOKE (6 layers, local + global),
    deepseek-v3's (MLA + MoE + MTP), recurrentgemma-2b's (RG-LRU + local
    attention) and xlstm-125m's (mLSTM + sLSTM)."""
    return {arch: _parity_one(arch, S) for arch, S in PARITY_ARCHS}


# ---------------------------------------------------------------------------
# train_mesh: the train step on a device mesh
# ---------------------------------------------------------------------------

def mesh_dense_config(**kw):
    """yi-6b at full width, MESH_LAYERS layers."""
    return dataclasses.replace(tconfigs.get_config("yi-6b"),
                               n_layers=MESH_LAYERS, **kw)


def mesh_moe_config(**kw):
    """qwen2-moe-a2.7b at full width, MESH_LAYERS layers, expert-parallel,
    capacity factor E/k (no expert can overflow)."""
    cfg = tconfigs.get_config("qwen2-moe-a2.7b")
    return dataclasses.replace(
        cfg, n_layers=MESH_LAYERS, moe_impl="shard_map",
        capacity_factor=float(cfg.n_experts // cfg.moe_top_k), **kw)


def _mesh_backend(world: int) -> str:
    return "nccl" if DEV == "cuda" and torch.cuda.device_count() >= world \
        else "gloo"


def _free() -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _flat_specs(specs):
    return None if specs is None else [s for _, s in
                                       sharding.leaves_with_path(specs)]


@torch.no_grad()
def _update_probe(opt, params, grads: list, gn: float, mesh=None,
                  specs=None) -> tuple:
    """One update of ``opt`` by ``grads`` (clipped by the global norm
    ``gn``) from ``params`` zeroed, at lr 1, so that they become the
    update itself (-u): (its statistics' leaves, whole on every rank, and
    the params' leaves, this rank's blocks).  ``params`` is consumed."""
    leaves = topt.optimizers.tree_leaves(params)
    for p in leaves:
        p.zero_()
    flat = _flat_specs(specs)
    state = opt.init(params, mesh=mesh, specs=flat)
    dev = leaves[0].device
    opt.update(topt.optimizers.tree_unflatten(params, iter(grads)), state,
               params, 1.0, gnorm=torch.tensor(gn, device=dev), mesh=mesh,
               specs=flat)
    return topt.optimizers.tree_leaves(state.inner["stats"]), leaves


def _mesh_steps(model, params, batch, mesh=None, specs=None,
                gather=False, make_opt=topt.adamw, steps=MESH_STEPS,
                probe=False):
    """The loss and gradients at ``params`` (on a mesh with ``gather``,
    gathered whole into rank 0's host memory: an empty list elsewhere),
    then ``steps`` - 1 steps of ``make_opt()`` (adamw by default) after an
    update by those gradients (``make_train_step``'s update, lr from the
    same schedule).  With ``probe`` (and ``steps`` 1), ``_update_probe``
    of ``make_opt()`` by the gradients.  Returns (grads, loss, grad_norm,
    the steps' losses, the probe or None)."""
    grads, met, gn = tsteps.loss_and_grads(model, params, batch, mesh=mesh,
                                           specs=specs)
    tree = topt.optimizers.tree_unflatten(params, iter(grads))
    whole = topt.optimizers.tree_leaves(tsteps.gather_tree(
        tree, specs, mesh, dst=0)) if gather else grads
    if steps == 1:
        gn = float(topt.optimizers.global_norm(grads) if gn is None else gn)
        del tree
        return (whole, float(met["loss"]), gn, [float(met["loss"])],
                _update_probe(make_opt(), params, grads, gn, mesh, specs)
                if probe else None)
    opt = make_opt()
    flat = _flat_specs(specs)
    state = opt.init(params, mesh=mesh, specs=flat)
    lr = topt.warmup_cosine(state.step, peak=1e-2, warmup_steps=1,
                            total_steps=MESH_STEPS)
    extra = {} if gn is None else {"gnorm": gn, "mesh": mesh, "specs": flat}
    params, state, m = opt.update(tree, state, params, lr, **extra)
    del tree, grads
    losses = [float(met["loss"])]
    step = tsteps.make_train_step(model, opt, peak_lr=1e-2, warmup=1,
                                  total=MESH_STEPS, mesh=mesh, specs=specs)
    for s in range(steps - 1):
        params, state, m2 = step(params, state, batch)
        losses.append(float(m2["loss"]))
    return whole, losses[0], float(m["grad_norm"]), losses, None


def _mesh_f32_check(tag: str, cfg, mesh, batch: dict, seed: int, rank: int,
                    loss_fn=None, record=None, make_opt=topt.adamw,
                    steps=MESH_STEPS, probe=False, grad_tol=None,
                    perturb=None) -> dict:
    """The mesh's loss, every gradient (gathered) and grad_norm, then
    ``steps`` steps' losses of ``make_opt()`` (adamw by default), against
    the same on one rank (rank 0, after the other ranks freed their
    state).  ``loss_fn(model)`` gives the loss of both sides (a stand-in
    model carries it to the step); ``record(side)`` wraps each side's
    calls ("mesh", "one").  With ``probe`` (``steps`` 1): one update of
    ``make_opt()`` on the mesh against one rank's by the mesh's gathered
    gradients (``_update_probe``).  ``grad_tol(path)`` gives a leaf's
    gradient gate (TOL_TRAIN_GRAD by default).  With ``perturb`` (a batch
    key), one rank's gradients are taken again with that input moved by
    1e-7 relative: how far rounding alone moves each leaf (its
    conditioning), logged as ``sensitivity``."""
    grad_tol = grad_tol or (lambda path: TOL_TRAIN_GRAD)
    model = tmodel.build_model(cfg)
    if loss_fn:
        model = types.SimpleNamespace(cfg=model.cfg, init=model.init,
                                      loss=loss_fn(model))
    local, specs = tsteps.shard_params(cfg, model.init(gen(seed), DEV), mesh)
    _free()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with record("mesh") if record else _null():
        whole, loss, gn, losses, mprobe = _mesh_steps(
            model, local, batch, mesh, specs, gather=True, make_opt=make_opt,
            steps=steps, probe=probe)
    launches = read_counts()
    parts = {"mesh": time.perf_counter() - t0}
    peak = torch.cuda.max_memory_allocated() / 1e9 if DEV == "cuda" else 0.0
    reserved = torch.cuda.max_memory_reserved() / 1e9 \
        if DEV == "cuda" else 0.0
    del local
    if rank != 0:
        del whole, mprobe
    _free()
    torch.distributed.barrier()
    out = {"loss": loss, "grad_norm": gn, "losses": losses,
           "launches": launches, "parts_s": parts, "peak_gb_mesh": peak,
           "peak_reserved_gb_mesh": reserved}
    if rank == 0:
        t0 = time.perf_counter()
        params = model.init(gen(seed), DEV)
        paths = ["/".join(p) for p, _ in sharding.leaves_with_path(params)]
        with record("one") if record else _null():
            g1, loss1, gn1, losses1, _ = _mesh_steps(
                model, params, batch, make_opt=make_opt, steps=steps)
        parts["one"] = time.perf_counter() - t0
        if perturb:
            moved = dict(batch)
            x = torch.as_tensor(batch[perturb], device=DEV)
            moved[perturb] = x * (1 + 1e-7 * torch.randn(
                x.shape, generator=gen(123), device=DEV))
            g2 = _mesh_steps(model, params, moved, steps=1)[0]
            sens = {p: scaled_err(a, b) for p, a, b in zip(paths, g2, g1)}
            del g2, moved
            top = sorted(sens, key=sens.get)[-4:]
            out["sensitivity"] = {p: sens[p] for p in top}
            log(f"{tag} f32: one rank's gradients with {perturb} moved by "
                f"1e-7 relative move by up to "
                f"{json.dumps(out['sensitivity'])}")
        t0 = time.perf_counter()
        errs, grads = {}, []
        for p, a, b in zip(paths, whole, g1):
            a = a.to(DEV)
            errs[p] = scaled_err(a, b)
            if probe:
                grads.append(a)
        del g1, whole
        if probe:
            # the mesh's gradients, now on the card, step one rank too
            out.update(_probe_errs(tag, make_opt, params, grads, gn, mprobe,
                                   paths, specs, mesh))
        del grads, params, mprobe
        _free()
        parts["compare"] = time.perf_counter() - t0
        worst = max(errs, key=errs.get)
        out.update(
            loss_err=abs(loss - loss1) / abs(loss1), grad_err=errs[worst],
            worst_leaf=worst, leaves=len(errs),
            gnorm_err=abs(gn - gn1) / gn1,
            step_err=max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                             losses1)),
            losses_one_rank=losses1)
        check(out["loss_err"] <= TOL_TRAIN_LOSS, f"{tag}: loss {loss} on "
              f"the mesh, {loss1} on one rank")
        over = {p: e for p, e in errs.items() if e > grad_tol(p)}
        check(not over, f"{tag}: gradients over their gates "
              f"{ {p: (e, grad_tol(p)) for p, e in over.items()} }")
        check(out["gnorm_err"] <= TOL_MESH_GNORM,
              f"{tag}: grad_norm {gn} on the mesh, {gn1} on one rank")
        check(out["step_err"] <= TOL_TRAIN_STEPS, f"{tag}: step losses "
              f"{losses} on the mesh, {losses1} on one rank")
        log(f"{tag} f32 against one rank: loss {loss:.6f} vs {loss1:.6f} "
            f"({out['loss_err']:.3g}, limit {TOL_TRAIN_LOSS}); {len(errs)} "
            f"gradient leaves, max {errs[worst]:.3g} at {worst} (limit "
            f"{grad_tol(worst)}); grad_norm {gn:.6f} vs {gn1:.6f} "
            f"({out['gnorm_err']:.3g}); {steps} steps' losses {losses}"
            f" vs {losses1} ({out['step_err']:.3g}, limit "
            f"{TOL_TRAIN_STEPS})")
    torch.distributed.barrier()
    return out


def _probe_errs(tag: str, make_opt, params, grads: list, gn: float,
                mprobe: tuple, paths: list, specs, mesh) -> dict:
    """One rank's ``_update_probe`` of ``params`` by the mesh's gathered
    gradients ``grads`` against the mesh's ``mprobe``: each statistic
    leaf, and rank 0's block of each update leaf."""
    stats1, u1 = _update_probe(make_opt(), params, grads, gn)
    grads.clear()
    stats, u = mprobe
    stat_err = max(scaled_err(a, b) for a, b in zip(stats, stats1))
    flat = _flat_specs(specs)
    u_errs = {p: scaled_err(a, sharding.local_block(b, s, mesh))
              for p, a, b, s in zip(paths, u, u1, flat)}
    worst = max(u_errs, key=u_errs.get)
    check(len(stats) == len(stats1) and stat_err <= TOL_ADA_UPDATE,
          f"{tag}: adafactor's statistics on the mesh differ from one "
          f"rank's by {stat_err:.3g} (limit {TOL_ADA_UPDATE})")
    check(u_errs[worst] <= TOL_ADA_UPDATE, f"{tag}: adafactor's update "
          f"{worst} on rank 0's block differs by {u_errs[worst]:.3g} "
          f"(limit {TOL_ADA_UPDATE})")
    log(f"{tag} f32 adafactor update against one rank's by the same "
        f"gradients: {len(stats)} statistic leaves, max {stat_err:.3g}; "
        f"{len(u_errs)} update leaves (rank 0's blocks), max "
        f"{u_errs[worst]:.3g} at {worst} (limit {TOL_ADA_UPDATE})")
    return {"ada_stat_err": stat_err, "ada_update_err": u_errs[worst],
            "ada_update_worst_leaf": worst}


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _mesh_bf16_steps(tag: str, cfg, mesh, B: int, S: int, seed: int,
                     b6_per_step: int, make_opt=topt.adamw,
                     n_steps: int = MESH_STEPS, batch_at=None,
                     witness=None, profiled: bool = True) -> dict:
    """``n_steps`` bf16 train steps of ``make_opt()`` (adamw by default) on
    the mesh, each timed on this rank (synchronized); peak memory, the
    collectives' count and bytes a step, B6 launches a step (all on the
    tensor cores); the last step (the first of 2, so that step 2 is timed
    without it) runs under the CPU profiler for the ms inside the
    ``mesh.collective`` range.  ``batch_at(step)`` gives the batches
    (SyntheticLM(seed=0) rows of S tokens by default); with a ``witness``
    list, step 1 keeps its first B6 launch there (``_b6_witness``).
    ``profiled=False`` profiles no step (its collective ms is None)."""
    from repro_torch.distributed import collectives as coll
    model = tmodel.build_model(cfg)
    local, specs = tsteps.shard_params(cfg, model.init(gen(seed), DEV), mesh)
    opt = make_opt()
    state = opt.init(local, mesh=mesh, specs=_flat_specs(specs))
    step = tsteps.make_train_step(model, opt, peak_lr=TRAIN_PEAK_LR,
                                  warmup=TRAIN_WARMUP, total=MESH_STEPS,
                                  mesh=mesh, specs=specs)
    if batch_at is None:
        batch_at = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=S,
                               global_batch=B, seed=0).batch_at
    _free()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    coll.reset_stats()
    from torch.profiler import ProfilerActivity, profile
    ms, b6, losses = [], [], []
    prof = None
    profiled = (n_steps - 1 if n_steps > 2 else 0) if profiled else -1
    for s in range(n_steps):
        c0 = fa_kernel.launch_counts()
        batch = batch_at(s)
        torch.distributed.barrier()
        with profile(activities=[ProfilerActivity.CPU]) if s == profiled \
                else _null() as cm, \
                _b6_witness(witness) if s == 0 and witness is not None \
                else _null():
            t0 = time.perf_counter()
            local, state, m = step(local, state, batch)
            _sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        if s == profiled:
            prof = cm
        b6.append({k: n - c0[k] for k, n in fa_kernel.launch_counts().items()})
        losses.append(float(m["loss"]))
    launches = read_counts()
    stats = {k: {"count": v["count"] / n_steps,
                 "bytes": v["bytes"] / n_steps,
                 "result_bytes": v["result_bytes"] / n_steps}
             for k, v in coll.STATS.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9 if DEV == "cuda" else 0.0
    reserved = torch.cuda.max_memory_reserved() / 1e9 \
        if DEV == "cuda" else 0.0
    check(b6 == [{"flash_attention": b6_per_step,
                  "flash_attention_tc": b6_per_step}] * n_steps,
          f"{tag}: B6 a step on this rank {b6} (want {b6_per_step}, all on "
          f"the tensor cores)")
    check(np.isfinite(losses).all(), f"{tag}: losses {losses}")
    coll_ms = None if prof is None else sum(
        e.cpu_time_total for e in prof.key_averages()
        if e.key == coll.COLLECTIVE_RANGE) / 1e3
    med = float(np.median(ms[1:]))
    del local, state, step
    _free()
    return {"step_ms": ms, "step_ms_median_2_on": med,
            "tokens_per_s": B * S / (med / 1e3), "peak_gb": peak,
            "collectives_per_step": stats, "collective_ms_profiled_step":
            coll_ms, "b6_per_step": b6[0], "launches": launches,
            "losses": losses}


def _mesh_dense_run(rank: int, shape) -> dict:
    """(a): yi-6b on ``shape`` = (data, model), data rows of MESH_SEQ."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, ("data", "model"), DEV)
    tag = f"train_mesh yi-6b {shape[0]}x{shape[1]}"
    B = shape[0]
    cfg = mesh_dense_config(dtype="float32")
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=MESH_SEQ,
                        global_batch=B, seed=1).batch_at(0)
    t0 = time.perf_counter()
    out = {"f32": _mesh_f32_check(tag, cfg, mesh, batch, 91, rank,
                                  steps=MESH_F32_STEPS)}
    out["f32_s"] = time.perf_counter() - t0
    n = 2 * MESH_LAYERS
    check(out["f32"]["launches"] == no_launches(
        flash_attention=n * MESH_F32_STEPS), f"{tag}: the f32 steps should "
          f"launch the CUDA-core B6 {n} times a step on this rank: "
          f"{out['f32']['launches']}")
    out["bf16"] = _mesh_bf16_steps(tag, mesh_dense_config(), mesh, B,
                                   MESH_SEQ, 92, n)
    return out


def _mesh_rows_whole_run(rank: int) -> dict:
    """(j): yi-6b with fsdp on (2, 1) at a batch of one row, whole on both
    data ranks (``tsteps.local_rows``), f32 against one rank, then bf16
    timed."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 1), ("data", "model"), DEV)
    tag = "train_mesh yi-6b 2x1 B = 1"
    cfg = mesh_dense_config(dtype="float32")
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=MESH_SEQ,
                        global_batch=1, seed=1).batch_at(0)
    mine = tsteps.local_rows(batch, mesh)
    check(all(np.array_equal(np.asarray(mine[k]), np.asarray(batch[k]))
              for k in batch), f"{tag}: rank {rank} does not hold the "
          f"whole batch")
    t0 = time.perf_counter()
    out = {"f32": _mesh_f32_check(tag, cfg, mesh, batch, 91, rank,
                                  steps=MESH_F32_STEPS)}
    out["f32_s"] = time.perf_counter() - t0
    n = 2 * MESH_LAYERS
    check(out["f32"]["launches"] == no_launches(
        flash_attention=n * MESH_F32_STEPS), f"{tag}: the f32 step should "
          f"launch the CUDA-core B6 {n} times on this rank: "
          f"{out['f32']['launches']}")
    out["bf16"] = _mesh_bf16_steps(tag, mesh_dense_config(), mesh, 1,
                                   MESH_SEQ, 92, n)
    return out


def _rec_train_batch(cfg, B: int, S: int, step: int) -> dict:
    """(f)-(h)'s batch of ``step``: SyntheticLM(seed=1) rows of S tokens;
    the encoder-decoder's rows of S seeded frames and WH_TRAIN_TOKENS
    decoder tokens."""
    if not cfg.is_encdec:
        return SyntheticLM(vocab_size=cfg.vocab_size, seq_len=S,
                           global_batch=B, seed=1).batch_at(step)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=WH_TRAIN_TOKENS,
                        global_batch=B, seed=1).batch_at(step)
    batch["frames"] = torch.randn((B, S, cfg.frontend_dim),
                                  generator=gen(120 + step), device=DEV)
    return batch


def _b6_train(cfg) -> int:
    """B6 launches of a train step on a rank: each attention layer of a
    stack twice (its forward and the remat's recompute), the
    encoder-decoder's decoder self- and cross-attentions once (the
    reference does not remat them)."""
    if cfg.is_encdec:
        return 2 * cfg.n_enc_layers + 2 * cfg.n_dec_layers
    return 2 * sum(kind in ttransformer.ATTN_KINDS for *_, kind in
                   ttransformer.layer_slots(cfg))


def _mesh_rec_train_run(rank: int, run: str) -> dict:
    """(f)-(h) training: ``REC_TRAIN_MESH[run]`` on its mesh, f32 against
    one rank (the loss and every gradient), then REC_MESH_STEPS bf16 steps
    timed, B6's first launch on this rank against its plain version."""
    from repro_torch.launch.mesh import make_mesh
    arch, shape, B, S = REC_TRAIN_MESH[run]
    mesh = make_mesh(shape, ("data", "model"), DEV)
    tag = f"train_mesh {arch} {shape[0]}x{shape[1]}"
    layers = REC_MESH_LAYERS[arch]
    cfg = serve_mesh_config(arch, layers, dtype="float32")
    n = _b6_train(cfg)
    t0 = time.perf_counter()
    out = {"f32": _mesh_f32_check(
        tag, cfg, mesh, _rec_train_batch(cfg, B, S, 0), 121, rank, steps=1,
        grad_tol=lambda p: TOL_WH_XATTN_GRAD if p.startswith("xattn/")
        else TOL_TRAIN_GRAD, perturb="frames" if cfg.is_encdec else None)}
    out["f32_s"] = time.perf_counter() - t0
    check(out["f32"]["launches"] == no_launches(flash_attention=n),
          f"{tag}: the f32 step should launch the CUDA-core B6 {n} times "
          f"on this rank: {out['f32']['launches']}")
    cfg = serve_mesh_config(arch, layers)
    witness = []
    # the CPU profiler's cost grows with the sLSTM loop's launches (~70 s
    # for a 1,024-token step): xlstm's collective ms is not measured
    out["bf16"] = _mesh_bf16_steps(
        tag, cfg, mesh, B, S, 122, n, n_steps=REC_MESH_STEPS,
        batch_at=lambda s: _rec_train_batch(cfg, B, S, s), witness=witness,
        profiled="slstm" not in cfg.layer_pattern)
    if witness:
        out["b6_witness"] = _b6_check(witness[0], f"{tag} rank {rank} B6")
    return out


def _moe_view(tree):
    return tree["stack"]["scanned"][0][0]["moe"]


def _mesh_ep_run(rank: int) -> dict:
    """(b): qwen2-moe-a2.7b, expert-parallel on (1, 2)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as tmoe
    mesh = make_mesh((1, 2), ("data", "model"), DEV)
    tag = "train_mesh qwen2-moe-a2.7b EP 1x2"
    cfg = mesh_moe_config(dtype="float32")
    gather = dataclasses.replace(cfg, moe_impl="gather")
    tp = 2
    secs = {}
    t0 = time.perf_counter()
    # one MoE layer at T = MESH_EP_SEQ: the output and the aux
    model = tmodel.build_model(cfg)
    full = model.init(gen(93), DEV)
    local, specs = tsteps.shard_params(cfg, full, mesh)
    T = MESH_EP_SEQ
    x = torch.randn((1, T, cfg.d_model), generator=gen(94), device=DEV)
    with torch.no_grad(), sharding.use_mesh(mesh):
        y_ep, aux_ep = tmoe.moe_ffn(_moe_view(sharding.mesh_view(
            local, specs)), cfg, x)
    layer = {}
    if rank == 0:
        mp_ = _moe_view(full)
        with torch.no_grad():
            y_g, _ = tmoe.moe_ffn(mp_, gather, x)
            xs = x[0].chunk(tp)
            aux_ref = float(torch.stack([tmoe._route(mp_, cfg, s)[2]
                                         for s in xs]).mean())
        layer = {"out_err": scaled_err(y_ep, y_g),
                 "aux": float(aux_ep), "aux_formula": aux_ref,
                 "aux_err": abs(float(aux_ep) - aux_ref) / aux_ref}
        check(layer["out_err"] <= TOL_F32, f"{tag}: the EP layer's output "
              f"differs from the gather path's by {layer['out_err']:.3g}")
        check(layer["aux_err"] <= TOL_MESH_AUX, f"{tag}: aux {float(aux_ep)}"
              f" against the per-slice formula's {aux_ref}")
        log(f"{tag} one MoE layer at T = {T} (random input): output vs the "
            f"gather path {layer['out_err']:.3g}; aux {float(aux_ep):.6f} "
            f"vs the formula on the same slices {aux_ref:.6f}")
        del mp_, y_g
    del y_ep
    secs["layer"] = time.perf_counter() - t0
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=T,
                        global_batch=1, seed=1).batch_at(0)

    def ce_only(model):
        def fn(p, b):
            t, m = model.loss(p, b)
            return (t - tmodel.MOE_AUX_WEIGHT * m["aux"],
                    {**m, "loss": m["ce"]})
        return fn

    tally = {}
    assign = tmoe._assign

    def counting(*args, **kwargs):
        tok, slot, keep = assign(*args, **kwargs)
        t = tally.setdefault(counting.side, [0, 0])
        t[0] += int((~keep).sum())
        t[1] += keep.numel()
        return tok, slot, keep

    class record:
        def __init__(self, side):
            counting.side = side

        def __enter__(self):
            tmoe._assign = counting

        def __exit__(self, *exc):
            tmoe._assign = assign

    # the run's own traffic at the config's cf 1.25 and at 4 (the same
    # weights): assignments dropped (dropped, of) in one forward, this
    # rank's EP dispatches and the gather path's on one rank
    t0 = time.perf_counter()
    dev_batch = {k: torch.as_tensor(v, device=DEV) for k, v in batch.items()}
    drops = {}
    for c in (1.25, 4.0):
        model = tmodel.build_model(dataclasses.replace(cfg,
                                                       capacity_factor=c))
        tally.clear()
        with torch.no_grad(), record("mesh"), sharding.use_mesh(mesh):
            model.loss(sharding.mesh_view(local, specs),
                       tsteps.local_rows(dev_batch, mesh))
        if rank == 0:
            with torch.no_grad(), record("one"):
                model.loss(full, dev_batch)
        drops[str(c)] = {side: list(v) for side, v in tally.items()}
    del full, local
    _free()
    torch.distributed.barrier()
    secs["drops"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    tally.clear()
    f32 = _mesh_f32_check(tag, cfg, mesh, batch, 95, rank, loss_fn=ce_only,
                          record=record, steps=MESH_F32_STEPS)
    f32["dropped"] = {side: list(v) for side, v in tally.items()}
    check(tally["mesh"][0] == 0 and (rank or tally["one"][0] == 0),
          f"{tag}: assignments dropped in the run (dropped, of): {tally}")
    if rank == 0:
        log(f"{tag}: assignments dropped in the run's dispatches (dropped, "
            f"of) on rank 0 and on one rank: {f32['dropped']}")
    n = 2 * MESH_LAYERS * MESH_F32_STEPS
    check(f32["launches"] == no_launches(flash_attention=n),
          f"{tag}: B6 launches {f32['launches']} (want {n})")
    secs["f32"] = time.perf_counter() - t0
    return {"layer": layer, "f32": f32, "drops": drops, "parts_s": secs}


def _b6_shapes(shapes: list):
    """A ``_mesh_f32_check`` ``record``: on the mesh's side each B6 launch
    on this rank appends its (query rows, keys) to ``shapes``."""
    route = fa_grad.route

    def spy(q, k, v, causal=True, window=None):
        shapes.append((int(q.shape[2]), int(k.shape[2])))
        return route(q, k, v, causal, window)

    class record:
        def __init__(self, side):
            self.side = side

        def __enter__(self):
            if self.side == "mesh":
                fa_grad.route = spy

        def __exit__(self, *exc):
            fa_grad.route = route
    return record


def _check_sp_shapes(tag: str, rank: int, shapes: list, S: int) -> list:
    """Every B6 launch of a sequence-parallel rank on (1, 3): its S/3 query
    rows against the keys up to its last row."""
    rows = S // 3
    want = (rows, (rank + 1) * rows)
    check(shapes and set(shapes) == {want}, f"{tag}: rank {rank} launched "
          f"B6 at (rows, keys) {sorted(set(shapes))} (want {want})")
    return sorted(set(shapes))


def _mesh_sp_run(rank: int) -> dict:
    """(c): yi-6b with sequence-parallel attention on (1, 3)."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 3), ("data", "model"), DEV)
    tag = "train_mesh yi-6b SP 1x3"
    cfg = mesh_dense_config(dtype="float32", seq_parallel_attn=True)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=MESH_SP_SEQ,
                        global_batch=1, seed=1).batch_at(0)
    shapes = []
    out = _mesh_f32_check(tag, cfg, mesh, batch, 96, rank,
                          record=_b6_shapes(shapes), steps=MESH_F32_STEPS)
    out["b6_keys"] = [k for _, k in _check_sp_shapes(tag, rank, shapes,
                                                      MESH_SP_SEQ)]
    return out


def _mesh_ds_sp_run(rank: int) -> dict:
    """(i): deepseek-v3-671b with sequence-parallel MLA on (1, 3): the f32
    check against one rank, then bf16 adafactor steps timed, B6's first
    launch on this rank against its plain version."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 3), ("data", "model"), DEV)
    tag = "train_mesh deepseek-v3 SP 1x3"
    t0 = time.perf_counter()
    cfg = ds_config(DS_SP_LAYERS, dtype="float32", param_dtype="float32",
                    seq_parallel_attn=True)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=DS_SP_F32_SEQ,
                        global_batch=1, seed=1).batch_at(0)
    shapes = []
    out = {"f32": _mesh_f32_check(tag, cfg, mesh, batch, 99, rank, steps=1,
                                  record=_b6_shapes(shapes))}
    out["f32_s"] = time.perf_counter() - t0
    out["b6_shapes_f32"] = _check_sp_shapes(tag, rank, shapes,
                                            DS_SP_F32_SEQ)
    # B6 a step: the layer's forward and its checkpoint's recompute, the
    # MTP block's forward once
    n = 2 * DS_SP_LAYERS + 1
    check(out["f32"]["launches"] == no_launches(flash_attention=n),
          f"{tag}: the f32 step should launch the CUDA-core B6 {n} times "
          f"on this rank: {out['f32']['launches']}")
    cfg = ds_config(DS_SP_LAYERS, seq_parallel_attn=True)
    witness, shapes = [], []
    with _b6_shapes(shapes)("mesh"):
        out["bf16"] = _mesh_bf16_steps(
            tag, cfg, mesh, 1, DS_SP_SEQ, 100, n,
            make_opt=lambda: ds_optimizer(cfg), n_steps=DS_SP_BF16_STEPS,
            witness=witness)
    out["b6_shapes"] = _check_sp_shapes(tag, rank, shapes, DS_SP_SEQ)
    out["b6_witness"] = _b6_check(witness[0], f"{tag} rank {rank} B6")
    return out


def serve_mesh_config(arch: str, layers: int, **kw):
    """``arch`` at full width cut to ``layers``, its weights whole on every
    data rank (``fsdp`` off: a replica that gathered its blocks' weights
    over ``data`` at every decode step would move them all a token);
    gemma3 with landmark decode on its global layers; deepseek's dense
    prefix cut with the layers, absorbed decode."""
    cfg = tconfigs.get_config(arch)
    if arch == "gemma3-12b":
        kw["use_landmark_decode"] = True
    if cfg.use_mla:
        kw.update(first_k_dense=min(cfg.first_k_dense, layers),
                  mla_absorb=True)
    if cfg.is_encdec:
        kw.update(n_enc_layers=layers, n_dec_layers=layers)
    return dataclasses.replace(cfg, n_layers=layers, fsdp=False, **kw)


def ds_config(layers: int, **kw):
    """deepseek-v3-671b at full width cut to ``layers``, the dense prefix
    first (first_k_dense cut with them); MTP and fsdp as the config sets
    them."""
    cfg = tconfigs.get_config("deepseek-v3-671b")
    return dataclasses.replace(cfg, n_layers=layers, first_k_dense=min(
        cfg.first_k_dense, layers), **kw)


def ds_optimizer(cfg):
    """adafactor as ``default_optimizer`` gives the uncut config: momentum
    off, the layers the reference stacks updated as one tensor."""
    return topt.adafactor(momentum=False, stacks=functools.partial(
        tmodel.stacked_layers, cfg=cfg))


def _mesh_ds_train_run(rank: int, shape) -> dict:
    """(d): deepseek-v3-671b on ``shape`` = (data, model): MLA over heads,
    MTP, fsdp, adafactor on shards."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, ("data", "model"), DEV)
    tag = f"train_mesh deepseek-v3 {shape[0]}x{shape[1]}"
    t0 = time.perf_counter()
    cfg = ds_config(DS_F32_LAYERS, dtype="float32", param_dtype="float32")
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=DS_F32_S,
                        global_batch=DS_F32_B, seed=1).batch_at(0)
    out = {"f32": _mesh_f32_check(tag, cfg, mesh, batch, 97, rank,
                                  make_opt=lambda: ds_optimizer(cfg),
                                  steps=1, probe=True)}
    out["f32_s"] = time.perf_counter() - t0
    # B6 a step: each layer's forward and its checkpoint's recompute, the
    # MTP block's forward once (not checkpointed)
    n = 2 * DS_F32_LAYERS + 1
    check(out["f32"]["launches"] == no_launches(flash_attention=n),
          f"{tag}: the f32 step should launch the CUDA-core B6 {n} times "
          f"on this rank: {out['f32']['launches']}")
    cfg = ds_config(DS_TRAIN_LAYERS)
    B = shape[0]
    out["bf16"] = _mesh_bf16_steps(tag, cfg, mesh, B, DS_TRAIN_TOKENS // B,
                                   98, 2 * DS_TRAIN_LAYERS + 1,
                                   make_opt=lambda: ds_optimizer(cfg),
                                   n_steps=DS_BF16_STEPS[shape])
    return out


def _serve_mesh_draws(cfg, B: int, S: int, seed: int):
    """Explicit landmark draws of every global layer (B, KV, ·), from a
    seeded numpy generator: each head's c landmarks and theta·c sketch
    columns (the landmarks first)."""
    if not cfg.use_landmark_decode:
        return None
    rng = np.random.default_rng(seed)
    c, s = cfg.landmark_c, cfg.landmark_theta * cfg.landmark_c
    out = {}
    for n, (*_, kind) in enumerate(ttransformer.layer_slots(cfg)):
        if kind == "global":
            perm = np.stack([[rng.permutation(S)[:s]
                              for _ in range(cfg.n_kv_heads)]
                             for _ in range(B)])
            out[n] = {"p_idx": torch.as_tensor(perm[..., :c], device=DEV),
                      "skx": torch.as_tensor(perm, device=DEV)}
    return out


@torch.no_grad()
def _serve_steps(model, params, batch: dict, draws, n_gen: int, *,
                 global_batch=None, forced=None):
    """Prefill ``batch`` (its ``tokens`` the prompts; whisper's
    ``frames`` too) to prompt + n_gen, then n_gen - 1 decode steps:
    greedy, or fed ``forced`` (B, n_gen) tokens.  (logits (n_gen, B, V),
    tokens, cache, prefill ms, decode ms a step), host ms between
    synchronizes."""
    S = batch["tokens"].shape[1]
    kw = {} if global_batch is None else {"global_batch": global_batch}
    _sync()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, S + n_gen,
                                  landmark_draws=draws, **kw)
    _sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    steps, toks = [logits], [torch.argmax(logits, -1)]
    t0 = time.perf_counter()
    for i in range(n_gen - 1):
        tok = toks[-1] if forced is None else forced[:, i]
        logits, cache = model.decode_step(params, cache, tok[:, None], S + i)
        steps.append(logits)
        toks.append(torch.argmax(logits, -1))
    _sync()
    decode_ms = (time.perf_counter() - t0) * 1e3 / max(n_gen - 1, 1)
    return (torch.stack(steps), torch.stack(toks, 1), cache, prefill_ms,
            decode_ms)


def _serve_mesh_inputs(cfg, B: int, S: int) -> dict:
    """A serving run's whole batch: B seeded prompts of S tokens; the
    encoder-decoder's S seeded frames a row and a 1-token prompt."""
    if not cfg.is_encdec:
        return {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                        generator=gen(110), device=DEV)}
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, 1),
                                    generator=gen(110), device=DEV),
            "frames": torch.randn((B, S, cfg.frontend_dim),
                                  generator=gen(113), device=DEV)}


def _b6_serving(cfg, mesh, B: int, S: int) -> tuple:
    """(B6 launches of a prefill, of a decode step) on this rank: one an
    attention layer at the prefill (the encoder-decoder's encoder layers,
    decoder layers and cross-attentions), none at decode but the
    encoder-decoder's cross-attention where ``enc_kv`` is not split by
    sequence (its Sq = 1 read is B6; a split one merges partial reads)."""
    if not cfg.is_encdec:
        return sum(kind in ttransformer.ATTN_KINDS for *_, kind in
                   ttransformer.layer_slots(cfg)), 0
    spec = sharding.cache_shardings(tmodel.build_model(cfg).cache_shape(
        B, 1 + SERVE_MESH_GEN, "meta", enc_len=S), mesh)["enc_kv"][0]
    split = sharding.split_axes(spec, 5, mesh)[2]
    return (cfg.n_enc_layers + 2 * cfg.n_dec_layers,
            0 if split else cfg.n_dec_layers)


class _b6_witness:
    """Keeps B6's first launch on this rank inside it (inputs and output,
    copied, in ``out``), to hold against the plain version after."""

    def __init__(self, out: list):
        self.out = out

    def __enter__(self):
        self.route = route = fa_grad.route

        def spy(q, k, v, causal=True, window=None):
            o = route(q, k, v, causal, window)
            if not self.out:
                self.out.append(tuple(t.detach().clone() for t in (q, k, v))
                                + (causal, window, o.detach().clone()))
            return o
        fa_grad.route = spy
        return self

    def __exit__(self, *exc):
        fa_grad.route = self.route
        return False


def _b6_check(rec: tuple, label: str) -> dict:
    """A witnessed launch's last FLASH_ROWS query rows (B6 right-aligns
    queries to keys) against the plain version on the same inputs."""
    q, k, v, causal, window, o = rec
    rows = min(FLASH_ROWS, q.shape[2])
    plain = fa_kernel.flash_attention_plain(q[:, :, -rows:], k, v,
                                            causal=causal, window=window)
    errs = _check_flash(o[:, :, -rows:].contiguous(), plain, label)
    log(f"{label}: {tuple(q.shape)} q, {tuple(k.shape)} k, causal {causal},"
        f" window {window}, last {rows} rows against the plain version: "
        f"{errs}")
    return {"shape_q": list(q.shape), "shape_k": list(k.shape),
            "rows": rows, "err": errs}


def _serve_mesh_run(rank: int, run: str) -> dict:
    """One serving run of ``SERVE_MESH`` on its mesh: f32 against one
    rank (rank 0), then bf16 timed on every rank."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import make_mesh
    from torch.profiler import ProfilerActivity, profile
    arch, shape, B, S, layers = SERVE_MESH[run]
    kw = SERVE_MESH_KW.get(run, {})
    mesh = make_mesh(shape, ("data", "model"), DEV)
    tag = f"serve_mesh {arch} {shape[0]}x{shape[1]}" + (
        " SP" if kw.get("seq_parallel_attn") else "")
    serial = run in SERVE_MESH_SERIAL_INIT
    f32_layers = SERVE_MESH_F32_LAYERS.get(run, layers)
    inputs = _serve_mesh_inputs(tconfigs.get_config(arch), B, S)
    rows = sharding.row_axes(B, mesh)
    first, nrows = sharding.local_range((rows,), 0, B, mesh)
    mine = {k: v[first:first + nrows] for k, v in inputs.items()}
    secs, out = {}, {"rows": [first, nrows]}

    # f32: the mesh, then one rank of the same weights, prompts and draws
    t0 = time.perf_counter()
    cfg = serve_mesh_config(arch, f32_layers, dtype="float32",
                            param_dtype="float32", **kw)
    draws = _serve_mesh_draws(cfg, B, S, 111)
    model = tmodel.build_model(cfg)
    local, specs = _init_shards(cfg, model, 112, mesh, serial)
    reset_counts()
    build, built, shapes = tattention.build_landmark_cache, [], []

    def spy(cfg_, k, v, draws_, generator=None, rows=0, heads=None):
        built.append((k.clone(), v.clone(), rows, heads))
        return build(cfg_, k, v, draws_, generator, rows=rows, heads=heads)
    tattention.build_landmark_cache = spy
    try:
        with sharding.use_mesh(mesh), _b6_shapes(shapes)("mesh"):
            lg, toks, cache, _, _ = _serve_steps(
                model, sharding.mesh_view(local, specs), mine, draws,
                SERVE_MESH_GEN, global_batch=B)
            toks = coll.all_gather(toks, 0, rows, mesh=mesh)
    finally:
        tattention.build_landmark_cache = build
    launches = read_counts()
    if cfg.seq_parallel_attn:
        out["b6_shapes"] = _check_sp_shapes(tag, rank, shapes, S)
    whole = sharding.gather_cache(cache, mesh)
    # each landmark layer's K and V as the mesh built its factors from
    # them: every head (over ``model``) and row (over the row axes)
    kv_built = [tuple(coll.all_gather(coll.all_gather(t, 2, "model",
                                                      mesh=mesh)
                                      if heads is not None else t,
                                      0, rows, mesh=mesh)
                      for t in (k, v))
                for k, v, _, heads in built]
    del local, cache, built
    if rank != 0:
        del whole, lg, kv_built
    _free()
    dist.barrier()
    if rank == 0:
        # the witness: one rank's factors from the mesh's K/V and draws
        global_layers = [n for n, (*_, kind) in enumerate(
            ttransformer.layer_slots(cfg)) if kind == "global"] \
            if cfg.use_landmark_decode else []
        witness = {}
        for n, (k, v) in zip(global_layers, kv_built):
            section, r, i, _ = ttransformer.layer_slots(cfg)[n]
            got = ttransformer._entry(whole, section, r, i)
            for name, t in tattention.build_landmark_cache(
                    cfg, k, v, draws[n]).items():
                witness[name] = max(witness.get(name, 0.0),
                                    scaled_err(got[name].float(), t.float()))
        check(len(witness) == (4 if global_layers else 0)
              and len(kv_built) == len(global_layers), f"{tag}: "
              f"{len(kv_built)} landmark builds on the mesh for "
              f"{len(global_layers)} global layers")
        del kv_built
        _free()
        params = model.init(gen(112), DEV)
        lg1, toks1, cache1, _, _ = _serve_steps(model, params, inputs, draws,
                                                SERVE_MESH_GEN, forced=toks)
        step_err = [scaled_err(a, b[first:first + nrows])
                    for a, b in zip(lg, lg1)]
        # each leaf's worst layer: k and v (and the landmark keys k_land
        # and offset, gathered from K) are checked; uv and u1 pass K's
        # last-bit differences through the pseudo-inverse of each head's
        # sketch, so against one rank's they are held through the decode
        # logits they feed, and against the witness above
        leaf_err = {}
        for (path, a), (_, b) in zip(sharding.leaves_with_path(whole),
                                     sharding.leaves_with_path(cache1)):
            leaf_err[path[-1]] = max(leaf_err.get(path[-1], 0.0),
                                     scaled_err(a.float(), b.float()))
        cache_err = max(e for k, e in leaf_err.items()
                        if k not in ("uv", "u1"))
        same = bool(torch.equal(toks, toks1))
        del params, lg1, cache1, whole, lg
        _free()
        out["f32"] = {"logit_err_max": max(step_err),
                      "logit_err_prefill": step_err[0],
                      "cache_err": cache_err, "cache_err_by_leaf": leaf_err,
                      "witness_err_by_leaf": witness, "tokens_equal": same}
        log(f"{tag} f32 against one rank: logits max {max(step_err):.3g} "
            f"(prefill {step_err[0]:.3g}; limit {TOL_SERVE_MESH}) over "
            f"{SERVE_MESH_GEN} steps, cache gathered from the shards by "
            f"leaf {json.dumps(leaf_err)}, greedy tokens equal: {same}; "
            f"landmark factors against one rank's build from the mesh's "
            f"K/V by leaf {json.dumps(witness)} (limit "
            f"{TOL_SERVE_MESH_WITNESS})")
        check(max(step_err) <= TOL_SERVE_MESH, f"{tag} f32: logits "
              f"differ from one rank's by {max(step_err):.3g} (limit "
              f"{TOL_SERVE_MESH}; per step {step_err})")
        check(cache_err <= TOL_SERVE_MESH, f"{tag} f32: the gathered cache "
              f"differs from one rank's by {cache_err:.3g}")
        check(same, f"{tag} f32: greedy tokens differ from one rank's")
        check(all(e <= TOL_SERVE_MESH_WITNESS for e in witness.values()),
              f"{tag} f32: the mesh's landmark factors differ from one "
              f"rank's build from the same K/V and draws: {witness}")
    dist.barrier()
    pre, dec = _b6_serving(cfg, mesh, B, S)
    n32 = pre + (SERVE_MESH_GEN - 1) * dec
    check(launches == no_launches(flash_attention=n32),
          f"{tag} f32: launches {launches} (want the CUDA-core B6 {pre} "
          f"times at the prefill and {dec} a decode step, {n32})")
    out["f32_launches"] = launches
    secs["f32"] = time.perf_counter() - t0

    # bf16: a warm-up generate, then the timed one
    t0 = time.perf_counter()
    cfg = serve_mesh_config(arch, layers, **kw)
    draws = _serve_mesh_draws(cfg, B, S, 111)
    model = tmodel.build_model(cfg)
    local, specs = _init_shards(cfg, model, 112, mesh, serial, prepare=True)
    view = sharding.mesh_view(local, specs)
    pre, dec = _b6_serving(cfg, mesh, B, S)
    n_b6 = pre + (SERVE_MESH_GEN - 1) * dec
    torch.cuda.reset_peak_memory_stats()
    witness = []
    with sharding.use_mesh(mesh):
        with _b6_witness(witness) if run in REC_SERVE_MESH \
                or kw.get("seq_parallel_attn") else _null():
            _serve_steps(model, view, mine, draws, 2, global_batch=B)
        reset_counts()
        c0 = fa_kernel.launch_counts()
        dist.barrier()
        lg, toks, cache, prefill_ms, decode_ms = _serve_steps(
            model, view, mine, draws, SERVE_MESH_GEN, global_batch=B)
        launches = read_counts()
        b6 = {k: n - c0[k] for k, n in launches.items()
              if k.startswith("flash")}
        # one more decode step and one more prefill, each counted and
        # profiled on the CPU (the host blocks in every gloo collective)
        coll.reset_stats()
        tok = torch.argmax(lg[-1], -1)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            model.decode_step(view, cache, tok[:, None],
                              mine["tokens"].shape[1] + SERVE_MESH_GEN - 1)
            _sync()
        stats = {k: dict(v) for k, v in coll.STATS.items()}
        del cache
        coll.reset_stats()
        with profile(activities=[ProfilerActivity.CPU]) as pprof:
            model.prefill(view, mine, mine["tokens"].shape[1]
                          + SERVE_MESH_GEN, landmark_draws=draws,
                          global_batch=B)
            _sync()
        pstats = {k: dict(v) for k, v in coll.STATS.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    coll_ms = sum(e.cpu_time_total for e in prof.key_averages()
                  if e.key == coll.COLLECTIVE_RANGE) / 1e3
    pcoll_ms = sum(e.cpu_time_total for e in pprof.key_averages()
                   if e.key == coll.COLLECTIVE_RANGE) / 1e3
    check(bool(torch.isfinite(lg.float()).all()), f"{tag} bf16: logits not "
          f"finite")
    check(b6 == {"flash_attention": n_b6, "flash_attention_tc": n_b6},
          f"{tag} bf16: B6 in the timed generate {b6} (want {pre} at the "
          f"prefill and {dec} a decode step, {n_b6}, all on the tensor "
          f"cores)")
    if witness:
        out["b6_witness"] = _b6_check(witness[0], f"{tag} rank {rank} B6")
    if run in SERVE_MESH_MOE_T:
        out["moe_layer"] = _moe_mesh_check(tag, cfg, mesh, view,
                                           SERVE_MESH_MOE_T[run])
    del local, view, lg
    _free()
    secs["bf16"] = time.perf_counter() - t0
    out.update(bf16={"prefill_ms": prefill_ms, "decode_ms_per_token":
                     decode_ms, "peak_gb": peak,
                     "collectives_decode_step": stats,
                     "collective_ms_decode_step": coll_ms,
                     "collectives_prefill": pstats,
                     "collective_ms_prefill": pcoll_ms,
                     "b6_prefill": pre, "b6_decode_step": dec,
                     "launches": launches},
               parts_s=secs, B=B, S=S, mesh=list(shape), layers=layers)
    return out


def _init_shards(cfg, model, seed: int, mesh, serial: bool,
                 prepare: bool = False):
    """(this rank's shards of the seeded params, their specs); with
    ``serial`` the ranks draw the whole tree in turn, so one card holds
    one whole draw at a time."""
    import torch.distributed as dist
    out = None
    for r in range(dist.get_world_size() if serial else 1):
        if not serial or dist.get_rank() == r:
            params = model.init(gen(seed), DEV)
            if prepare:
                params = model.prepare(params)
            out = tsteps.shard_params(cfg, params, mesh)
            del params
            _free()
        if serial:
            dist.barrier()
    return out


@torch.no_grad()
def _moe_mesh_check(tag: str, cfg, mesh, view, T: int) -> dict:
    """The first MoE layer on the mesh in bf16 (its experts split over
    ``model``), the capacity raised until nothing can drop (cf = E/k),
    against an f32 per-token evaluation that each rank makes of the tokens
    routed to its own experts, and of its part of the shared MLP, summed
    over ``model`` (no rank holds the whole bank); two calls bit-equal."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.models import moe as tmoe
    ccfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                               / cfg.moe_top_k)
    mp = view["stack"]["scanned"][0][0]["moe"]
    x = torch.randn((1, T, cfg.d_model), generator=gen(121),
                    device=DEV).to(cfg.cdtype)
    xf = x.reshape(T, cfg.d_model)
    with sharding.use_mesh(mesh):
        w, idx, _ = tmoe._route(mp, ccfg, xf)
        _, _, keep = tmoe._assign(ccfg, idx, tmoe.capacity(ccfg, T))
        check(bool(keep.all()), f"{tag} MoE layer: an assignment dropped")
        ms, out = cuda_ms(lambda: tmoe.moe_ffn(mp, ccfg, x)[0], reps=3,
                          warmup=1)
        again = tmoe.moe_ffn(mp, ccfg, x)[0]
        first = sharding.axis_index("model") * mp["wi_gate"].shape[0]
        shared_split = sharding.split(mp["shared"], "wi_up", 1)
        rank = sharding.axis_index("model")
    check(torch.equal(out, again), f"{tag} MoE layer: two calls differ")
    x32 = xf.float()
    ref = torch.zeros((T, cfg.d_model), dtype=torch.float32, device=DEV)
    for e in range(mp["wi_gate"].shape[0]):
        rows, j = torch.nonzero(idx == first + e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x32[rows]
        h = torch.nn.functional.silu(xe @ mp["wi_gate"][e].float()) \
            * (xe @ mp["wi_up"][e].float())
        ref.index_add_(0, rows, (h @ mp["wo"][e].float())
                       * w[rows, j][:, None])
    if cfg.n_shared_experts and (shared_split or rank == 0):
        sh = mp["shared"]
        ref += (torch.nn.functional.silu(x32 @ sh["wi_gate"].float())
                * (x32 @ sh["wi_up"].float())) @ sh["wo"].float()
    ref = coll.all_reduce(ref, "model", mesh=mesh)
    err = scaled_err(out.reshape(T, -1).float(), ref)
    check(err <= TOL_MOE, f"{tag} MoE layer vs f32 per-token: {err:.3g} > "
          f"{TOL_MOE}")
    log(f"{tag} MoE layer at T = {T} on the mesh ({mp['wi_gate'].shape[0]} "
        f"experts a rank, capacity {tmoe.capacity(ccfg, T)}, nothing "
        f"dropped): {ms:.2f} ms, vs the ranks' f32 per-token evaluations "
        f"summed {err:.3g} (limit {TOL_MOE}), two calls bit-equal")
    return {"T": T, "ms": ms, "err_vs_f32_per_token": err,
            "experts_per_rank": int(mp["wi_gate"].shape[0])}


def _mesh_rank(rank: int, world: int, tmpdir: str, cfg: dict,
               runs: tuple) -> None:
    """One rank of ``train_mesh``: its backend's group over a ``file://``
    store, then each of ``runs``; writes its records to ``tmpdir``."""
    globals().update(cfg)
    import torch.distributed as dist
    from repro_torch.distributed import collectives as coll
    backend = _mesh_backend(world)
    if DEV == "cuda":
        torch.cuda.set_device(rank if backend == "nccl" else 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmpdir, 'store')}",
        rank=rank, world_size=world, timeout=datetime.timedelta(minutes=10))
    try:
        out = {"rank": rank, "backend": backend}
        for run in runs:
            t0 = time.perf_counter()
            if run == "ep":
                out[run] = _mesh_ep_run(rank)
            elif run == "ds_sp_1x3":
                out[run] = _mesh_ds_sp_run(rank)
            elif run.startswith("ds_"):
                out[run] = _mesh_ds_train_run(rank, tuple(
                    int(v) for v in run[3:].split("x")))
            elif run in SERVE_MESH:
                out[run] = _serve_mesh_run(rank, run)
            elif run in REC_TRAIN_MESH:
                out[run] = _mesh_rec_train_run(rank, run)
            elif run == "sp":
                out[run] = _mesh_sp_run(rank)
            elif run == ROWS_WHOLE_RUN:
                out[run] = _mesh_rows_whole_run(rank)
            else:
                out[run] = _mesh_dense_run(rank, tuple(
                    int(v) for v in run.split("x")))
            out[run]["s"] = time.perf_counter() - t0
        out["staged"] = sorted(coll.STAGED)
        with open(os.path.join(tmpdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn_mesh(world: int, runs: tuple, alloc_conf: str = "") -> list:
    """Spawn ``world`` ranks of ``_mesh_rank`` running ``runs``; with
    ``alloc_conf``, their caching allocator's PYTORCH_CUDA_ALLOC_CONF."""
    import torch.multiprocessing as mp
    cfg = {k: globals()[k] for k in (
        "DEV", "MESH_LAYERS", "MESH_SEQ", "MESH_SP_SEQ", "MESH_STEPS",
        "MESH_F32_STEPS", "DS_SP_LAYERS", "DS_SP_SEQ", "DS_SP_F32_SEQ",
        "DS_SP_BF16_STEPS", "SERVE_MESH_KW",
        "MESH_EP_SEQ", "SERVE_MESH", "SERVE_MESH_GEN",
        "SERVE_MESH_F32_LAYERS", "SERVE_MESH_MOE_T",
        "SERVE_MESH_SERIAL_INIT", "DS_TRAIN_LAYERS", "DS_TRAIN_TOKENS",
        "DS_F32_LAYERS", "DS_F32_B", "DS_F32_S", "DS_BF16_STEPS",
        "DS_MESHES", "REC_MESH_LAYERS", "REC_TRAIN_MESH", "REC_MESH_STEPS",
        "REC_SERVE_MESH", "WH_TRAIN_TOKENS", "TOL_WH_XATTN_GRAD")}
    tmpdir = tempfile.mkdtemp(prefix="train_mesh_")
    _free()
    was = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    if alloc_conf:
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    try:
        mp.spawn(_mesh_rank, args=(world, tmpdir, cfg, runs), nprocs=world,
                 join=True)
    finally:
        if was is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = was
    infos = []
    for r in range(world):
        with open(os.path.join(tmpdir, f"rank{r}.json")) as f:
            infos.append(json.load(f))
    for name in os.listdir(tmpdir):
        os.remove(os.path.join(tmpdir, name))
    os.rmdir(tmpdir)
    return infos


def phase_train_mesh() -> dict:
    """The train step on a device mesh: (a) yi-6b FSDP on (2, 1) and TP on
    (1, 2), (b) qwen2-moe-a2.7b expert-parallel on (1, 2), (d) deepseek-v3,
    (f)-(h) the recurrent families and whisper, (j) yi-6b FSDP on (2, 1) at
    a batch of one row, in 2 ranks; (c) yi-6b with sequence-parallel
    attention and (i) deepseek-v3 with sequence-parallel MLA on (1, 3), in
    3 ranks; each in f32 against one rank of the same weights and batch on
    the same card, most also timed in bf16.  The spawns then run
    ``serve_mesh``'s runs (``SERVE_MESH``) on their meshes, which
    ``phase_serve_mesh`` reads from ``res["serve_mesh"]``."""
    t0 = time.perf_counter()
    runs2 = tuple(f"{d}x{m}" for d, m in MESH_DENSE) + ("ep",)
    ds = tuple(f"ds_{d}x{m}" for d, m in DS_MESHES)
    rec = tuple(REC_TRAIN_MESH)
    serve3 = tuple(r for r, c in SERVE_MESH.items() if c[1] == (1, 3))
    serve2 = tuple(r for r in SERVE_MESH if r not in serve3)
    two = _spawn_mesh(2, runs2 + ds + rec + (ROWS_WHOLE_RUN,) + serve2)
    three = _spawn_mesh(3, ("sp", "ds_sp_1x3") + serve3,
                        alloc_conf=MESH3_ALLOC_CONF)
    wall = time.perf_counter() - t0
    backend = {2: two[0]["backend"], 3: three[0]["backend"]}
    staged = sorted(set(sum((i["staged"] for i in two + three), [])))
    log(f"train_mesh: backends {backend} (NCCL needs a card a rank: "
        f"{torch.cuda.device_count()} visible); collectives staged through "
        f"pinned host memory: {staged or 'none'}; {wall:.1f} s with spawns")
    res = {"backend": backend, "staged": staged, "wall_s": wall,
           "reduced": [f"yi-6b and qwen2-moe-a2.7b cut to {MESH_LAYERS} "
                       f"layers", "qwen2-moe capacity_factor 1.25 -> 15 "
                       "(E/k: nothing dropped) for the EP check",
                       f"(b) {MESH_EP_SEQ} of 4,096 tokens (the phase's "
                       f"150 s)",
                       f"(c) {MESH_SP_SEQ} tokens (a multiple of 3)",
                       f"(a)-(c) f32 checks cut to {MESH_F32_STEPS} step "
                       f"(the loss and gradients) and the bf16 runs to "
                       f"{MESH_STEPS} steps",
                       f"(i) deepseek-v3-671b cut to {DS_SP_LAYERS} layer "
                       f"(dense) + the MTP block at 1 x {DS_SP_SEQ} tokens, "
                       f"{DS_SP_BF16_STEPS} bf16 steps; its f32 check at "
                       f"1 x {DS_SP_F32_SEQ} (three ranks' f32 state at "
                       f"3,072 did not fit the card)",
                       f"(j) yi-6b cut to {MESH_LAYERS} layers, one f32 "
                       f"step, {MESH_STEPS} bf16 steps",
                       f"(d) deepseek-v3-671b cut to {DS_TRAIN_LAYERS} "
                       f"layer(s) of the dense prefix, no MoE layer, + "
                       f"the MTP block; its f32 check to {DS_F32_LAYERS} "
                       f"layer + MTP at {DS_F32_B} x {DS_F32_S} tokens (one "
                       f"rank's f32 copy with gradients beside the mesh's), "
                       f"its steps to one adafactor update against one "
                       f"rank's by the same gradients",
                       f"(d) (2, 1) bf16: {DS_BF16_STEPS[(2, 1)]} of "
                       f"{MESH_STEPS} steps (~10 GB of gloo a step; its "
                       f"step ms is step 2's)",
                       f"(f)-(h) recurrentgemma-2b cut to "
                       f"{REC_MESH_LAYERS['recurrentgemma-2b']} of 26 "
                       f"layers, xlstm-125m to "
                       f"{REC_MESH_LAYERS['xlstm-125m']} of 12, "
                       f"whisper-large-v3 to "
                       f"{REC_MESH_LAYERS['whisper-large-v3']} + "
                       f"{REC_MESH_LAYERS['whisper-large-v3']} of 32 + 32; "
                       f"f32 checks one step's loss and gradients; "
                       f"{REC_MESH_STEPS} bf16 steps (step 2 timed)"],
           "dense": {}, "deepseek": {}, "recurrent": {}}
    for run in runs2[:-1]:
        per_rank = [i[run]["bf16"] for i in two]
        f32 = two[0][run]["f32"]
        res["dense"][run] = {
            "f32": {k: f32[k] for k in ("loss_err", "grad_err", "gnorm_err",
                                        "step_err", "worst_leaf", "leaves",
                                        "losses", "losses_one_rank",
                                        "parts_s")},
            "step_ms_median_2_on": [b["step_ms_median_2_on"]
                                    for b in per_rank],
            "tokens_per_s": [b["tokens_per_s"] for b in per_rank],
            "peak_gb": [b["peak_gb"] for b in per_rank],
            "collectives_per_step": [b["collectives_per_step"]
                                     for b in per_rank],
            "collective_ms_profiled_step": [
                b["collective_ms_profiled_step"] for b in per_rank],
            "b6_per_step": [b["b6_per_step"]["flash_attention"]
                            for b in per_rank],
            "losses_bf16": per_rank[0]["losses"], "s": two[0][run]["s"],
            "f32_s": two[0][run]["f32_s"]}
        d = res["dense"][run]
        log(f"train_mesh yi-6b {run} bf16 ({MESH_STEPS} steps, "
            f"{int(run[0]) * MESH_SEQ} tokens a step): step ms per rank "
            f"{[round(v, 1) for v in d['step_ms_median_2_on']]} (median of "
            f"steps 2 on), tokens/s {[round(v) for v in d['tokens_per_s']]}"
            f", peak GB {[round(v, 2) for v in d['peak_gb']]}, B6 a step "
            f"{d['b6_per_step']}, collectives a step (rank 0) "
            f"{json.dumps(d['collectives_per_step'][0])}, ms in "
            f"{'mesh.collective'} on a profiled step "
            f"{[round(v, 1) for v in d['collective_ms_profiled_step']]}")
    for run in ds:
        per_rank = [i[run]["bf16"] for i in two]
        f32 = two[0][run]["f32"]
        res["deepseek"][run] = {
            "f32": {k: f32[k] for k in ("loss_err", "grad_err", "gnorm_err",
                                        "worst_leaf", "leaves",
                                        "ada_stat_err", "ada_update_err",
                                        "ada_update_worst_leaf", "parts_s")},
            "bf16_steps": len(per_rank[0]["step_ms"]),
            **{k: [b[k] for b in per_rank] for k in (
                "step_ms_median_2_on", "tokens_per_s", "peak_gb",
                "collectives_per_step", "collective_ms_profiled_step")},
            "b6_per_step": [b["b6_per_step"]["flash_attention"]
                            for b in per_rank],
            "losses_bf16": per_rank[0]["losses"], "s": two[0][run]["s"],
            "f32_s": two[0][run]["f32_s"]}
        d = res["deepseek"][run]
        log(f"train_mesh deepseek-v3 {run[3:]} bf16 adafactor "
            f"({d['bf16_steps']} steps, {DS_TRAIN_TOKENS} tokens a step, {DS_TRAIN_LAYERS} "
            f"layers + MTP): step ms per rank "
            f"{[round(v, 1) for v in d['step_ms_median_2_on']]}, tokens/s "
            f"{[round(v) for v in d['tokens_per_s']]}, peak GB "
            f"{[round(v, 2) for v in d['peak_gb']]}, B6 a step "
            f"{d['b6_per_step']}, collectives a step (rank 0) "
            f"{json.dumps(d['collectives_per_step'][0])}, ms in "
            f"mesh.collective on a profiled step "
            f"{[round(v, 1) for v in d['collective_ms_profiled_step']]}; "
            f"{d['s']:.1f} s (f32 {d['f32_s']:.1f})")
    for run in rec:
        per_rank = [i[run]["bf16"] for i in two]
        f32 = two[0][run]["f32"]
        arch, shape, B, S = REC_TRAIN_MESH[run]
        res["recurrent"][run] = {
            "arch": arch, "mesh": list(shape), "B": B, "S": S,
            "f32": {k: f32.get(k) for k in (
                "loss_err", "grad_err", "gnorm_err", "worst_leaf", "leaves",
                "sensitivity", "parts_s")},
            **{k: [b[k] for b in per_rank] for k in (
                "step_ms_median_2_on", "tokens_per_s", "peak_gb",
                "collectives_per_step", "collective_ms_profiled_step")},
            "b6_per_step": [b["b6_per_step"]["flash_attention"]
                            for b in per_rank],
            "b6_witness": [i[run].get("b6_witness") for i in two],
            "losses_bf16": per_rank[0]["losses"], "s": two[0][run]["s"],
            "f32_s": two[0][run]["f32_s"]}
        d = res["recurrent"][run]
        coll_ms = [v if v is None else round(v, 1)
                   for v in d["collective_ms_profiled_step"]]
        log(f"train_mesh {arch} {shape[0]}x{shape[1]} ({B} x {S}) bf16: "
            f"step ms per rank "
            f"{[round(v, 1) for v in d['step_ms_median_2_on']]}, tokens/s "
            f"{[round(v) for v in d['tokens_per_s']]}, peak GB "
            f"{[round(v, 2) for v in d['peak_gb']]}, B6 a step "
            f"{d['b6_per_step']}, collectives a step (rank 0) "
            f"{json.dumps(d['collectives_per_step'][0])}, ms in "
            f"mesh.collective on a profiled step "
            f"{coll_ms}; "
            f"{d['s']:.1f} s (f32 {d['f32_s']:.1f})")
    res["recurrent_s"] = sum(two[0][r]["s"] for r in rec)
    ep = two[0]["ep"]
    drops = {}
    for c, one in ep["drops"].items():
        mesh_d = [sum(i["ep"]["drops"][c]["mesh"][j] for i in two)
                  for j in (0, 1)]
        drops[c] = {"ep_dropped_of": mesh_d,
                    "gather_dropped_of": one["one"],
                    "ep_share": mesh_d[0] / mesh_d[1],
                    "gather_share": one["one"][0] / one["one"][1]}
    log(f"train_mesh qwen2-moe-a2.7b EP 1x2: the run's batch "
        f"({MESH_EP_SEQ} tokens) through the model once at each capacity "
        f"factor, assignments dropped (dropped, of; EP summed over both "
        f"ranks): {json.dumps(drops)}")
    res["ep"] = {"layer": ep["layer"], "f32": {
        k: ep["f32"][k] for k in ("loss_err", "grad_err", "gnorm_err",
                                  "step_err", "worst_leaf", "leaves",
                                  "dropped")},
        "drops_run_batch": drops, "tokens": MESH_EP_SEQ, "s": ep["s"],
        "parts_s": ep["parts_s"]}
    sp = three[0]["sp"]
    res["sp"] = {**{k: sp[k] for k in ("loss_err", "grad_err", "gnorm_err",
                                       "step_err", "worst_leaf", "leaves")},
                 "b6_keys_by_rank": [i["sp"]["b6_keys"] for i in three],
                 "s": sp["s"]}
    log(f"train_mesh yi-6b SP 1x3: B6 keys by rank "
        f"{res['sp']['b6_keys_by_rank']}")
    for run, ranks, name in ((ROWS_WHOLE_RUN, two, "rows_whole"),
                             ("ds_sp_1x3", three, "deepseek_sp")):
        per_rank = [i[run]["bf16"] for i in ranks]
        f32 = ranks[0][run]["f32"]
        res[name] = {
            "f32": {k: f32[k] for k in ("loss_err", "grad_err", "gnorm_err",
                                        "worst_leaf", "leaves", "parts_s",
                                        "peak_gb_mesh")},
            "f32_peak_gb_mesh_by_rank": [i[run]["f32"]["peak_gb_mesh"]
                                         for i in ranks],
            **{k: [b[k] for b in per_rank] for k in (
                "step_ms_median_2_on", "tokens_per_s", "peak_gb",
                "collectives_per_step", "collective_ms_profiled_step")},
            "b6_per_step": [b["b6_per_step"]["flash_attention"]
                            for b in per_rank],
            "losses_bf16": per_rank[0]["losses"], "s": ranks[0][run]["s"],
            "f32_s": ranks[0][run]["f32_s"]}
        if run == "ds_sp_1x3":
            res[name].update(
                b6_shapes_by_rank=[i[run]["b6_shapes"] for i in ranks],
                b6_shapes_f32_by_rank=[i[run]["b6_shapes_f32"]
                                       for i in ranks],
                b6_witness=[i[run]["b6_witness"] for i in ranks])
        d = res[name]
        log(f"train_mesh {name} ({run}) bf16: step ms per rank "
            f"{[round(v, 1) for v in d['step_ms_median_2_on']]}, tokens/s "
            f"{[round(v) for v in d['tokens_per_s']]}, peak GB "
            f"{[round(v, 2) for v in d['peak_gb']]} (f32 mesh "
            f"{[round(v, 2) for v in d['f32_peak_gb_mesh_by_rank']]}), B6 "
            f"a step {d['b6_per_step']}, collectives a step (rank 0) "
            f"{json.dumps(d['collectives_per_step'][0])}, ms in "
            f"mesh.collective on a profiled step "
            f"{[round(v, 1) for v in d['collective_ms_profiled_step']]}; "
            f"{d['s']:.1f} s (f32 {d['f32_s']:.1f})"
            + (f"; B6 (rows, keys) by rank {d['b6_shapes_by_rank']}"
               if "b6_shapes_by_rank" in d else ""))
    # the path's launches on rank 0: every count reset before a run's
    # counted part and read after it
    total = no_launches()
    counted = runs2[:-1] + ds + rec + (ROWS_WHOLE_RUN,)
    for part in ([two[0][r]["f32"]["launches"] for r in counted]
                 + [two[0][r]["bf16"]["launches"] for r in counted]
                 + [ep["f32"]["launches"], sp["launches"],
                    three[0]["ds_sp_1x3"]["f32"]["launches"],
                    three[0]["ds_sp_1x3"]["bf16"]["launches"]]):
        total = {k: total[k] + part[k] for k in total}
    res["launches"] = total
    f32_steps = {**{r: MESH_F32_STEPS for r in runs2[:-1]},
                 **{r: 1 for r in ds + rec}, ROWS_WHOLE_RUN: MESH_F32_STEPS}
    res["b6_launches_per_rank_per_step"] = {
        **{f"{r}_f32": [i[r]["f32"]["launches"]["flash_attention"]
                        / f32_steps[r] for i in two] for r in counted},
        **{f"{r}_bf16": [i[r]["bf16"]["b6_per_step"]["flash_attention_tc"]
                         for i in two] for r in counted},
        "ep_f32": [i["ep"]["f32"]["launches"]["flash_attention"]
                   / MESH_F32_STEPS for i in two],
        "sp_f32": [i["sp"]["launches"]["flash_attention"] / MESH_F32_STEPS
                   for i in three],
        "ds_sp_1x3_f32": [i["ds_sp_1x3"]["f32"]["launches"][
            "flash_attention"] for i in three],
        "ds_sp_1x3_bf16": [i["ds_sp_1x3"]["bf16"]["b6_per_step"][
            "flash_attention_tc"] for i in three]}
    res["serve_mesh"] = {run: [i[run] for i in (three if run in serve3
                                                else two)]
                         for run in SERVE_MESH}
    return res


def phase_serve_mesh(tmesh: dict) -> dict:
    """The serving cells on a mesh (``SERVE_MESH``), run by
    ``phase_train_mesh``'s spawns: per run and rank the bf16 prefill
    ms, decode ms a token, the collectives of a decode step, its ms in
    ``mesh.collective``, peak GB and B6 a prefill; the f32 errors against
    one rank.  The path's launches are rank 0's, each run's counts reset
    just before its mesh calls and read just after."""
    ranks = tmesh["serve_mesh"]
    res = {"runs": {}, "launches": no_launches(),
           "s": sum(ranks[run][0]["s"] for run in SERVE_MESH),
           "reduced": [
               "yi-6b and qwen2-moe-a2.7b cut to 2 layers, gemma3-12b to 6 "
               "(5 local + 1 global) of 48, deepseek-v3-671b to 4 (3 dense "
               "+ 1 MoE) of 61, its f32 check to the 2 dense layers",
               f"contexts 4,096 + {SERVE_MESH_GEN} tokens",
               "deepseek's MoE layer checked at T = 512 with its capacity "
               "raised to E/k (nothing dropped)",
               f"(f)-(h) recurrentgemma-2b cut to "
               f"{REC_MESH_LAYERS['recurrentgemma-2b']} of 26 layers, "
               f"xlstm-125m to {REC_MESH_LAYERS['xlstm-125m']} of 12, "
               f"whisper-large-v3 to {REC_MESH_LAYERS['whisper-large-v3']}"
               f" + {REC_MESH_LAYERS['whisper-large-v3']} of 32 + 32; "
               "contexts "
               "8,192 (recurrentgemma), 4,096 (xlstm) and 1,500 frames "
               f"(whisper), each at batch 2 + {SERVE_MESH_GEN} tokens",
               f"(i) deepseek-v3-671b under seq_parallel_attn on (1, 3) "
               f"cut to {DS_SP_LAYERS} (dense) layer, 1 x {DS_SP_SEQ} + "
               f"{SERVE_MESH_GEN} tokens",
               "fsdp off (weights whole on every data rank)",
               "two or three gloo ranks time-share one card (no NCCL: one "
               "card)"]}
    for run in SERVE_MESH:
        per = ranks[run]
        r0 = per[0]
        for part in (r0["f32_launches"], r0["bf16"]["launches"]):
            for k, v in part.items():
                res["launches"][k] += v
        row = {"mesh": r0["mesh"], "B": r0["B"], "S": r0["S"],
               "layers": r0["layers"], "f32": r0["f32"], "s": r0["s"],
               **{k: [p["bf16"][k] for p in per] for k in (
                   "prefill_ms", "decode_ms_per_token", "peak_gb",
                   "collective_ms_decode_step", "collective_ms_prefill",
                   "b6_prefill", "b6_decode_step")},
               **{k: [p["bf16"][k] for p in per] for k in (
                   "collectives_decode_step", "collectives_prefill")},
               "parts_s": r0["parts_s"]}
        if "moe_layer" in r0:
            row["moe_layer"] = [p["moe_layer"] for p in per]
        if "b6_witness" in r0:
            row["b6_witness"] = [p["b6_witness"] for p in per]
        if "b6_shapes" in r0:
            row["b6_shapes_by_rank"] = [p["b6_shapes"] for p in per]
        res["runs"][run] = row
        arch, shape, B, S, layers = SERVE_MESH[run]
        log(f"serve_mesh {arch} {shape[0]}x{shape[1]} ({layers} layers, "
            f"{B} x {S} + {SERVE_MESH_GEN}) bf16 per rank: prefill ms "
            f"{[round(v, 1) for v in row['prefill_ms']]}, decode ms a token "
            f"{[round(v, 2) for v in row['decode_ms_per_token']]}, peak GB "
            f"{[round(v, 2) for v in row['peak_gb']]}, B6 a prefill "
            f"{row['b6_prefill']}, a decode step's collectives (rank 0) "
            f"{json.dumps(row['collectives_decode_step'][0])}, its ms in "
            f"mesh.collective {[round(v, 2) for v in row['collective_ms_decode_step']]}"
            f"; a profiled prefill's collectives (rank 0) "
            f"{json.dumps(row['collectives_prefill'][0])}, its ms in "
            f"mesh.collective {[round(v, 1) for v in row['collective_ms_prefill']]}"
            f"; f32 vs one rank {json.dumps(r0['f32'])}; {r0['s']:.1f} s")
    res["recurrent_s"] = sum(ranks[run][0]["s"] for run in REC_SERVE_MESH)
    log(f"serve_mesh: {res['s']:.1f} s inside train_mesh's spawns; reduced "
        f"{res['reduced']}")
    log(f"the recurrent and encoder-decoder mesh runs (f)-(h): "
        f"{tmesh['recurrent_s'] + res['recurrent_s']:.1f} s (train "
        f"{tmesh['recurrent_s']:.1f}, serve {res['recurrent_s']:.1f})")
    return res


# ---------------------------------------------------------------------------
# dryrun: the dry run on the host, and its counts held against the card
# ---------------------------------------------------------------------------

#: (a) the production cells dry-run on the host: (arch, shape, multi_pod)
DRY_CELLS = (("gemma3-12b", "train_4k", False),
             ("gemma3-12b", "long_500k", False),
             ("deepseek-v3-671b", "decode_32k", False),
             ("qwen2-moe-a2.7b", "prefill_32k", True))
#: (b) the B5 read traced and run through ``landmark_decode``: queries
DRY_READ_M = (ATT_DECODE_M, 4096)
#: (b) the predicted peak above the step's arguments against the card's
TOL_DRY_PEAK = 0.10


def _dry_diff(traced: dict, ran: dict, key: str) -> dict:
    """The entries of ``traced[key]`` and ``ran[key]`` that differ."""
    a, b = traced[key], ran[key]
    return {k: (a.get(k), b.get(k)) for k in sorted(set(a) | set(b))
            if a.get(k) != b.get(k)}


def _dry_card(tag: str, fn, meta_args, card_args, *, memory: bool,
              tokens: int) -> dict:
    """``fn`` traced on ``meta_args`` and run on the card on ``card_args``
    (after a warm-up run): a timed plain run (step ms, the peak above the
    memory allocated before it, the kernels' launches), then a run under
    the recorder and the FLOP counter, whose FLOPs (in all and op by
    op), recorded bytes, calls and custom-op calls must equal the
    trace's; the custom-op calls must equal the launches."""
    traced = dry.trace_step(fn, meta_args)
    fn(*card_args)                                     # warm-up
    _free()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    c0 = read_counts()
    t0 = time.perf_counter()
    fn(*card_args)
    _sync()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    c1 = read_counts()
    ran = dry.trace_step(fn, card_args)
    c2 = read_counts()
    plain = {k: c1[k] - c0[k] for k in c0}
    recorded = {k: c2[k] - c1[k] for k in c0}
    for key in ("flops_by_op", "hbm_by_op", "calls", "kernels", "coll"):
        check(traced[key] == ran[key], f"dryrun {tag}: the trace's {key} "
              f"differ from the card's: {_dry_diff(traced, ran, key)}")
    for key in ("flops", "hbm", "hlo_bytes"):
        check(traced[key] == ran[key], f"dryrun {tag}: {key} traced "
              f"{traced[key]} vs card {ran[key]}")
    calls = {"flash_attention": traced["kernels"].get(
                 "repro_torch::flash_attention", 0),
             "landmark_read": traced["kernels"].get(
                 "repro_torch::landmark_read", 0)}
    for k, n in calls.items():
        check(plain[k] == recorded[k] == n, f"dryrun {tag}: {k} calls in "
              f"the trace {n}, launches on the card {plain[k]} (plain run) "
              f"and {recorded[k]} (recorded run)")
    prof = roofline.H100_SXM
    res = {"flops": traced["flops"], "hbm_bytes": traced["hbm"],
           "hlo_bytes": traced["hlo_bytes"], "kernel_calls": calls,
           "launches": plain, "step_ms": step_ms,
           "compute_ms": traced["flops"] / prof.peak_flops * 1e3,
           "memory_ms": traced["hbm"] / prof.hbm_bw * 1e3,
           "profile": prof.name, "trace_s": traced["seconds"],
           "tokens": tokens}
    if memory:
        pred = traced["peak_bytes"] - traced["args_bytes"]
        res.update(predicted_peak_above_args=pred, card_peak_above_base=peak,
                   args_bytes=traced["args_bytes"],
                   peak_gap=(peak - pred) / peak)
        check(abs(peak - pred) <= TOL_DRY_PEAK * peak,
              f"dryrun {tag}: predicted peak above the arguments "
              f"{pred / 1e9:.4f} GB vs the card's {peak / 1e9:.4f} GB "
              f"(limit {TOL_DRY_PEAK:.0%})")
    log(f"dryrun {tag}: trace = card: {traced['flops'] / 1e12:.4f} TFLOP, "
        f"{traced['hbm'] / 1e9:.3f} GB memory-real ({traced['hlo_bytes'] / 1e9:.3f} "
        f"GB every op), {sum(traced['calls'].values())} ops, kernel calls "
        f"{calls} = launches; step {step_ms:.2f} ms on the card beside "
        f"compute {res['compute_ms']:.2f} ms and memory "
        f"{res['memory_ms']:.2f} ms under {prof.name}"
        + (f"; peak above the arguments predicted "
           f"{res['predicted_peak_above_args'] / 1e9:.4f} GB, card "
           f"{peak / 1e9:.4f} GB ({res['peak_gap']:+.2%})" if memory else ""))
    return res


def phase_dryrun(tmesh: dict) -> dict:
    """(a) ``launch.dryrun.run_cell`` on the host for ``DRY_CELLS``; (b)
    the trace held against the card on a (1, 1) mesh: train_gemma3's cell
    (6 layers, 2 x 4,096 tokens, accum 1) and a gemma3 landmark decode at
    serve_gemma3's size (12 layers, 2 x 32,768), each traced on ``meta``
    and run on the card, and B5 through ``landmark_decode`` (no LM cell
    reaches it: the model's landmark decode reads in einsums, as the
    reference's); (c) train_mesh's yi-6b TP (1, 2) cell dry-run on a fake
    2-rank group against rank 0's collectives a step on the card."""
    from repro_torch.configs import ShapeConfig
    t0 = time.perf_counter()
    check(not torch.distributed.is_initialized(),
          "dryrun: the main process holds a process group")
    rows, cells = [], {}
    for arch, shape, multi in DRY_CELLS:
        rec = dry.run_cell(arch, shape, multi)
        rows.append(rec)
        cells[f"{arch} {shape} {rec['mesh']}"] = {
            k: rec[k] for k in ("kind", "bytes_per_chip", "compute_s",
                                "memory_s", "collective_s", "bottleneck",
                                "useful_flops_frac", "kernels", "accum",
                                "compile_full_s", "compile_extrap_s")}
    log("dryrun (a): the dry run on the host\n" + roofline.format_table(rows)
        + "\n" + "\n".join(f"  {k}: kernels {v['kernels']}"
                            for k, v in cells.items()))
    host_s = time.perf_counter() - t0

    reset_counts()
    card = {}
    with dry.fake_world("1x1") as mesh:
        tcfg = dataclasses.replace(train_config(), remat="full")
        tshape = ShapeConfig("train_gemma3", TRAIN_SEQ, TRAIN_BATCH, "train")
        cell = tsteps.build_cell(tcfg, tshape, mesh, accum=1)
        card["train_gemma3"] = _dry_card(
            "train_gemma3", cell.step_fn, tsteps.local_args(cell, mesh),
            dry.concrete_args(cell, DEV, seed=71), memory=True,
            tokens=TRAIN_SEQ * TRAIN_BATCH)
        check(card["train_gemma3"]["kernel_calls"]["flash_attention"]
              == 2 * TRAIN_LAYERS, f"dryrun: train_gemma3's cell should "
              f"launch B6 {2 * TRAIN_LAYERS} times (forward + recompute)")
        del cell
        _free()
        dshape = ShapeConfig("serve_gemma3", SERVE_CONTEXT, SERVE_BATCH,
                             "decode")
        cell = tsteps.build_cell(serve_config(), dshape, mesh)
        card["decode_gemma3"] = _dry_card(
            "decode_gemma3", cell.step_fn, tsteps.local_args(cell, mesh),
            dry.concrete_args(cell, DEV, seed=72), memory=True,
            tokens=SERVE_BATCH)
        del cell
        _free()
    d, c = ATT_D, ATT_C
    for m in DRY_READ_M:
        g = gen(73 + m)
        st = tsa.LandmarkState(
            k_land=torch.randn(c, d, generator=g, device=DEV) * d ** -0.25,
            UV=torch.randn(c, d, generator=g, device=DEV),
            U1=torch.rand(c, generator=g, device=DEV) + 0.5,
            scale=torch.tensor(1.0, device=DEV))
        q = torch.randn(m, d, generator=g, device=DEV) * d ** -0.25
        meta = (tsa.LandmarkState(*(t.to("meta") for t in st)),
                q.to("meta"))
        card[f"landmark_read m={m}"] = r = _dry_card(
            f"landmark_read m={m}", tsa.landmark_decode, meta, (st, q),
            memory=False, tokens=m)
        check(r["kernel_calls"]["landmark_read"] == 1,
              f"dryrun: landmark_decode at m = {m} should launch B5 once")
    launches = read_counts()

    from repro_torch.distributed import collectives as coll
    want = tmesh["dense"]["1x2"]["collectives_per_step"][0]
    with dry.fake_world("1x2") as mesh:
        cell = tsteps.build_cell(
            mesh_dense_config(),
            ShapeConfig("train_mesh", MESH_SEQ, 1, "train"), mesh, accum=1)
        got = dry.trace_step(cell.step_fn, tsteps.local_args(cell, mesh),
                             count_flops=False)
    mesh_coll = {}
    for kind, hlo in coll.HLO_KIND.items():
        w = want.get(kind, {"count": 0, "result_bytes": 0})
        mesh_coll[hlo] = {"dry_count": got["coll_calls"][hlo],
                          "card_count": w["count"],
                          "dry_result_bytes": got["coll"][hlo],
                          "card_result_bytes": w["result_bytes"]}
        check(got["coll_calls"][hlo] == w["count"]
              and got["coll"][hlo] == w["result_bytes"],
              f"dryrun (c): {hlo} dry run {got['coll_calls'][hlo]} calls, "
              f"{got['coll'][hlo]} result bytes; train_mesh rank 0 a step "
              f"{w['count']}, {w['result_bytes']}")
    log(f"dryrun (c): yi-6b TP (1, 2) on a fake 2-rank group counts rank "
        f"0's collectives a step on the card, kind by kind: "
        f"{json.dumps(mesh_coll)}")
    res = {"cells": cells, "host_s": host_s, "card": card,
           "collectives_tp_1x2": mesh_coll, "launches": launches,
           "s": time.perf_counter() - t0}
    log(f"dryrun: {res['s']:.1f} s ({host_s:.1f} on the host's dry runs)")
    return res


def _work_roofline(flops: float, nbytes: float, ms: float, prof) -> dict:
    """A kernel's work (its flop formula, its operands read once and its
    output written once) against its measured ms under ``prof``."""
    compute = flops / prof.peak_flops * 1e3
    memory = nbytes / prof.hbm_bw * 1e3
    bound = max(compute, memory)
    return {"flops": flops, "bytes": nbytes, "profile": prof.name,
            "compute_ms": compute, "memory_ms": memory, "roofline_ms": bound,
            "bottleneck": "compute" if compute >= memory else "memory",
            "measured_ms": ms, "achieved_frac": bound / ms,
            "tflops_per_s": flops / ms / 1e9}


def _train_line(grad: dict, g3: dict, moe: dict, rec: dict,
                par: dict) -> dict:
    """B6's ``train`` entry: the gradient check, attention_vjp beside
    SDPA's backward, the train paths' numbers, the remat policies."""
    keep = ("step_ms", "step_ms_median_2_on", "tokens_per_s", "peak_gb",
            "b6_per_step", "params", "optimizer", "grad_check", "losses")
    return {
        "grad_check": [{k: c[k] for k in (
            "label", "dtype", "shape", "err", "tol", "max_abs_err", "fwd_ms",
            "vjp_ms", "plain_fwd_bwd_ms", "vjp_bound_ms_fp32",
            "bwd_bound_ms_bf16", "sdpa_fwd_ms", "sdpa_bwd_ms",
            "sdpa_fwd_bwd_ms", "sdpa_note") if k in c}
            for c in grad["cases"]],
        "max_grad_err_bf16": grad["max_err_bf16"],
        "max_grad_err_f32": grad["max_err_f32"],
        "train_gemma3": {**{k: g3[k] for k in keep}, "mfu": g3["mfu"],
                         "flops": g3["flops"], "reduced": g3["reduced"],
                         "device_ms_by_class": g3["profile"].get(
                             "by_class_ms"),
                         "idle_share": g3["profile"].get("idle_share")},
        "remat": g3["remat"],
        "train_moe": {**{k: moe[k] for k in keep}, "aux": moe["aux"]},
        "train_recurrent": {
            name: {**{k: r[k] for k in keep}, "mfu": r["mfu"],
                   "flops": r["flops"], "reduced": r["reduced"],
                   "recurrence_ms": r["recurrence_ms"],
                   "device_ms_by_class": r["profile"].get("by_class_ms"),
                   "idle_share": r["profile"].get("idle_share")}
            for name, r in rec.items() if name != "launches"},
        "train_parity": par}


#: each phase's wall seconds in this run, in the order run
PHASE_S: dict = {}


def timed(phase, *args):
    """``phase(*args)``, its wall time kept in ``PHASE_S``."""
    t0 = time.perf_counter()
    out = phase(*args)
    PHASE_S[phase.__name__.removeprefix("phase_")] = round(
        time.perf_counter() - t0, 1)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    timed(phase_card)
    timed(phase_build)
    timed(phase_parity)
    timed(phase_parity_slab)
    timed(phase_parity_read)
    timed(phase_parity_flash)
    m = timed(phase_main)
    timed(phase_scaling)
    b1, b2 = _b1_line(m), _b2_line(m)
    sh = timed(phase_spsd_sharded, m)
    b4 = _b4_line(m, sh)
    us = timed(phase_user_spec, m, sh)
    att = timed(phase_attention_long)
    pol = timed(phase_attention_policy)
    srv = timed(phase_serve_gemma3)
    b6 = _flash_line(srv)
    moe = timed(phase_serve_moe)
    mla = timed(phase_serve_mla)
    dense = timed(phase_serve_dense_configs)
    rec = timed(phase_serve_recurrent)
    wh = timed(phase_serve_whisper)
    skm = timed(phase_serve_kernel)
    rag = timed(phase_ragged)
    cal = timed(phase_calibrate)
    con = timed(phase_contracts)
    tgrad = timed(phase_train_grad)
    tg3 = timed(phase_train_gemma3)
    tmoe = timed(phase_train_moe)
    trecur = timed(phase_train_recurrent)
    tpar = timed(phase_train_parity)
    tmesh = timed(phase_train_mesh)
    smesh = timed(phase_serve_mesh, tmesh)
    dr = timed(phase_dryrun, tmesh)
    # each path's counts were reset just before it and read just after
    paths = {"spsd_main": m["launches"], "spsd_sharded": sh["launches"],
             "user_spec": us["launches"],
             "attention_long": att["launches"],
             "attention_policy": pol["launches"],
             "serve_gemma3": srv["launches"], "serve_moe": moe["launches"],
             "serve_mla": mla["launches"],
             "serve_dense_configs": dense["launches"],
             "serve_recurrent": rec["launches"],
             "serve_whisper": wh["launches"],
             "serve_kernel": skm["launches"], "spsd_ragged": rag["launches"],
             "calibrate": cal["launches"], "contracts": con["launches"],
             "train_gemma3": tg3["launches"], "train_moe": tmoe["launches"],
             "train_recurrent": trecur["launches"],
             "train_mesh": tmesh["launches"],
             "serve_mesh": smesh["launches"], "dryrun": dr["launches"]}
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
    b6["serve_recurrent"] = {
        **{name: {k: r[k] for k in served}
           for name, r in rec["runs"].items()},
        "prefill_device_ms_by_class": {
            name: r["profile"]["prefill"].get("by_class_ms")
            for name, r in rec["runs"].items() if "profile" in r},
        "decode_device_ms_by_class": {
            name: r["profile"]["decode_4_steps"].get("by_class_ms")
            for name, r in rec["runs"].items() if "profile" in r},
        "slstm": rec["runs"]["xlstm-125m"]["slstm"],
        "long_context": rec["long_context"],
        "state_check": rec["state_check"]}
    b6["serve_whisper"] = {
        **{name: {**{k: r[k] for k in served},
                  "b6_decode_step": r["b6_decode"][0],
                  "batch": r["batch"], "frames": r["frames"],
                  "gen": r["gen"], "cuts": r["cuts"],
                  "prefill_device_ms_by_class": r["profile"]["prefill"].get(
                      "by_class_ms"),
                  "prefill_idle_share": r["profile"]["prefill"].get(
                      "idle_share"),
                  "decode_device_ms_by_class": r["profile"][
                      "decode_4_steps"].get("by_class_ms"),
                  "decode_idle_share": r["profile"]["decode_4_steps"].get(
                      "idle_share")}
           for name, r in wh["runs"].items()},
        "params": wh["params"], "numerics": wh["numerics"]}
    b6["train"] = _train_line(tgrad, tg3, tmoe, trecur, tpar)
    b6["train_mesh"] = {k: tmesh[k] for k in (
        "backend", "staged", "wall_s", "reduced", "dense", "deepseek",
        "recurrent", "recurrent_s", "ep", "sp", "deepseek_sp", "rows_whole",
        "b6_launches_per_rank_per_step")}
    b6["serve_mesh"] = {k: smesh[k] for k in ("runs", "reduced", "s",
                                              "recurrent_s")}
    b6["model_shapes"] = [moe["b6_shape"], mla["b6_shape"],
                          dense["b6_shape"], rec["b6_shape"],
                          *wh["b6_shapes"]]
    b2.update({"ms_exp_affine_policy_panel": pol["b2_panel"]["ms"],
               "plain_ms_exp_affine_policy_panel": pol["b2_panel"]["plain_ms"],
               "bound_ms_exp_affine_policy_panel": pol["b2_panel"]["bound_ms"],
               "exp_affine_policy_panel_shape": pol["b2_panel"]["shape"]})
    b2["statistic_only"] = cal["statistic_only"]
    for line, key in ((b1, "b1_ms"), (b2, "b2_ms"), (b4, "b4_ms")):
        line["user_spec"] = {
            "ms": us[key], "shape": us["shapes"][key[:2]],
            "note": "cauchy (and for B1 the other USER_SPECS) timed in "
                    "turns beside rbf / laplacian in phase_user_spec",
            "launches_main_path": us["launches"][line["name"]],
            "builds": us["builds"]}
    b1["user_spec"].update({k: us[k] for k in (
        "times", "C_err_vs_plain", "U_err_vs_plain", "C_err_vs_f64",
        "statistic", "err_hutchinson", "err_blocked", "b1_rows_err",
        "parity")})
    b2["user_spec"]["err_vs_plain"] = us["b2_err"]
    b2["user_spec"]["err_vs_f64"] = us["b2_err_vs_f64"]
    b4["user_spec"]["rows_equal_b1"] = us["b4_rows_equal_b1"]
    b1["rbf_probe"] = us["rbf_probe"]
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
    b6["dryrun"] = {k: dr[k] for k in ("cells", "card",
                                       "collectives_tp_1x2", "host_s", "s")}
    sh6 = b6["shape"]
    b6["work_roofline"] = _work_roofline(
        fa_kernel.flash_flops((sh6["B"], sh6["Hq"], sh6["S"], sh6["D"]),
                              (sh6["B"], sh6["Hkv"], sh6["S"], sh6["D"]),
                              (sh6["B"], sh6["Hkv"], sh6["S"], sh6["D"]),
                              True, None),
        2 * (2 * sh6["B"] * sh6["Hq"] * sh6["S"] * sh6["D"]
             + 2 * sh6["B"] * sh6["Hkv"] * sh6["S"] * sh6["D"]),
        b6["ms"], roofline.H100_SXM)
    b5 = att["line"]
    sh5 = b5["shape"]
    b5["work_roofline"] = _work_roofline(
        lm_kernel.landmark_flops((sh5["m"], sh5["d"]), (sh5["c"], sh5["d"]),
                                 (sh5["c"], sh5["dv"])),
        4 * (sh5["m"] * sh5["d"] + sh5["c"] * (sh5["d"] + sh5["dv"] + 1)
             + sh5["m"] * sh5["dv"]), b5["ms"], roofline.H100_SXM_TF32)
    for line in (b5, b6):
        r = line["work_roofline"]
        log(f"{line['name']} work roofline: {r['flops'] / 1e12:.4g} TFLOP, "
            f"{r['bytes'] / 1e9:.4g} GB; {r['roofline_ms']:.4f} ms on "
            f"{r['profile']} ({r['bottleneck']}), measured "
            f"{r['measured_ms']:.4f} ms, achieved_frac "
            f"{r['achieved_frac']:.4f}, {r['tflops_per_s']:.1f} TFLOP/s")
    kernels_line = {"kernels": [b1, b2, b4, att["line"], b6]}
    log(f"seconds by phase: {json.dumps(PHASE_S)}")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernels_line), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
