"""Serving launcher: batched prefill + greedy decode, with the paper's landmark
(fast-SPSD) attention available on the global layers (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \
        --smoke --batch 4 --prompt-len 64 --gen 32 --landmark

``--arch`` takes every architecture of the port's registry
(``repro_torch.configs.ARCHS``: gemma3-12b, the yi, minitron and chameleon
dense configs, qwen2-moe-a2.7b, deepseek-v3-671b, the recurrent
xlstm-125m and recurrentgemma-2b, and the encoder-decoder
whisper-large-v3).  For whisper-large-v3 ``--prompt-len`` counts the
encoder's frames: each request is ``--prompt-len`` seeded frame embeddings
(the stubbed 128-mel frontend) and a 1-token decoder prompt, the shapes of
``input_specs``' prefill.

Prefill builds the decode cache (for landmark configs also the fast-model
factors of every global layer: Algorithm 1 on the softmax Gram, O(s²c) per
head; for a recurrent layer its state after the prompt, O(1) in the
context; for the encoder-decoder each decoder layer's encoder K/V); each
decode step reads it and updates it in place.  xlstm-125m's
mLSTM takes a prompt whose length is a multiple of ``mlstm_chunk`` (or
shorter than it).  The model runs on the CUDA device unless ``--device``
names another one.

``--mesh dxm`` (or ``pxdxm``) serves on a device mesh of that shape under
``torchrun`` (``launch.mesh.setup_mesh``, as the trainer sets it up):

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch yi-6b --smoke --mesh 1x2

Each rank draws the same seeded params and keeps its shards; the
prefill and decode steps run on them with the cache laid out by
``sharding.cache_shardings`` (``models.model``), and every rank returns
the same tokens.  Every family runs there: ``--arch deepseek-v3-671b``
(MLA over heads, its latent cache split by sequence at 1,024 positions
or more and read through a log-sum-exp merge), the recurrent
``recurrentgemma-2b`` and ``xlstm-125m`` (each mixer over its width or
heads, its state laid out by ``sharding.state_pspec``) and
``whisper-large-v3`` (the encoder K/V split by sequence at 1,024 frames
or more where the rows are not split).  On the CPU:

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch whisper-large-v3 --smoke --device cpu --mesh 1x2

A config with ``seq_parallel_attn`` runs its MLA prefill over sequence
rows where the heads do not divide ``model`` (``attention._mla_sp``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import describe, setup_mesh
from repro_torch.launch.steps import shard_params
from repro_torch.models.model import Model, build_model


def generate(model: Model, params: dict, prompts: torch.Tensor, gen: int,
             max_len: Optional[int] = None, *,
             landmark_draws: Optional[Dict[int, dict]] = None,
             generator: Optional[torch.Generator] = None,
             patches: Optional[torch.Tensor] = None,
             frames: Optional[torch.Tensor] = None,
             mesh=None, specs=None) -> torch.Tensor:
    """prompts: (B, S) int -> (B, gen) greedy continuations.  ``patches``
    (B, n_patch, d_model) replace the leading prompt positions at prefill
    (early fusion); ``frames`` (B, S_enc, frontend_dim) are an
    encoder-decoder's encoder input, the prompts its decoder's.

    On a ``mesh`` of more than one device ``params`` are this rank's
    shards laid out by ``specs`` (``launch.steps.shard_params``) and every
    rank is handed the whole batch: it serves its rows
    (``sharding.batch_pspec``), and the tokens of every row are gathered
    back, so each rank returns the same (B, gen)."""
    B, S = prompts.shape
    max_len = max_len or (S + gen)
    batch = {"tokens": prompts}
    if patches is not None:
        batch["patches"] = patches
    if frames is not None:
        batch["frames"] = frames
    if shd.is_trivial(mesh):
        return _greedy(model, params, batch, S, gen, max_len,
                       landmark_draws=landmark_draws, generator=generator)
    rows = shd.row_axes(B, mesh)
    first, n = shd.local_range((rows,), 0, B, mesh)
    with shd.use_mesh(mesh):
        toks = _greedy(model, shd.mesh_view(params, specs),
                       {k: v[first:first + n] for k, v in batch.items()},
                       S, gen, max_len, landmark_draws=landmark_draws,
                       generator=generator, global_batch=B)
    return C.all_gather(toks, 0, rows, mesh=mesh)


def _greedy(model: Model, params, batch: dict, S: int, gen: int,
            max_len: int, **prefill_kw) -> torch.Tensor:
    logits, cache = model.prefill(params, batch, max_len, **prefill_kw)
    tok = torch.argmax(logits, dim=-1)
    toks = [tok]
    for i in range(gen - 1):
        logits, cache = model.decode_step(params, cache, tok[:, None], S + i)
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
    return torch.stack(toks, dim=1)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", required=True, choices=ARCHS)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=64,
                   help="prompt tokens (the encoder's frames for an "
                        "encoder-decoder)")
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--landmark", action="store_true",
                   help="use fast-SPSD landmark decode on global layers")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    p.add_argument("--mesh", default="1x1",
                   help="dxm or pxdxm (data x model, pod in front); more "
                        "than one device needs torchrun or an initialized "
                        "process group")
    args = p.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.landmark:
        cfg = dataclasses.replace(cfg, use_landmark_decode=True)
    mesh, device = setup_mesh(args.mesh, resolve_device(args.device))
    rank0 = mesh is None or dist.get_rank() == 0
    model = build_model(cfg)
    params = model.prepare(model.init(
        torch.Generator(device=device).manual_seed(0), device))
    specs = None
    if mesh is not None:
        params, specs = shard_params(cfg, params, mesh)
    frames = None
    if cfg.is_encdec:
        frames = torch.randn(
            (args.batch, args.prompt_len, cfg.frontend_dim),
            generator=torch.Generator(device=device).manual_seed(3),
            device=device).to(cfg.cdtype)
    prompts = torch.randint(
        0, cfg.vocab_size,
        (args.batch, 1 if cfg.is_encdec else args.prompt_len),
        generator=torch.Generator(device=device).manual_seed(1),
        device=device)
    t0 = time.perf_counter()
    out = generate(model, params, prompts, args.gen,
                   generator=torch.Generator().manual_seed(2), frames=frames,
                   mesh=mesh, specs=specs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise RuntimeError(f"a generated token lies outside [0, "
                           f"{cfg.vocab_size})")
    if rank0:
        where = device if mesh is None else describe(mesh)
        print(f"generated {tuple(out.shape)} on {where} in {dt:.2f}s "
              f"({args.batch * args.gen / dt:.1f} tok/s)")
        print("sample row:", out[0][:16].tolist())
        print("serve ok")
    return out


if __name__ == "__main__":
    main()
