"""Serving launcher: batched prefill + greedy decode, with the paper's landmark
(fast-SPSD) attention available on the global layers (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \
        --smoke --batch 4 --prompt-len 64 --gen 32 --landmark

``--arch`` takes every architecture of the port's registry
(``repro_torch.configs.ARCHS``: gemma3-12b, the yi, minitron and chameleon
dense configs, qwen2-moe-a2.7b and deepseek-v3-671b).

Prefill builds the decode cache (for landmark configs also the fast-model
factors of every global layer: Algorithm 1 on the softmax Gram, O(s²c) per
head); each decode step reads it and updates it in place.  The model runs on
the CUDA device unless ``--device`` names another one.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import torch

from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.device import resolve_device
from repro_torch.models.model import Model, build_model


def generate(model: Model, params: dict, prompts: torch.Tensor, gen: int,
             max_len: Optional[int] = None, *,
             landmark_draws: Optional[Dict[int, dict]] = None,
             generator: Optional[torch.Generator] = None,
             patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """prompts: (B, S) int -> (B, gen) greedy continuations.  ``patches``
    (B, n_patch, d_model) replace the leading prompt positions at prefill
    (early fusion)."""
    B, S = prompts.shape
    max_len = max_len or (S + gen)
    batch = {"tokens": prompts}
    if patches is not None:
        batch["patches"] = patches
    logits, cache = model.prefill(params, batch, max_len,
                                  landmark_draws=landmark_draws,
                                  generator=generator)
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
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--landmark", action="store_true",
                   help="use fast-SPSD landmark decode on global layers")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    args = p.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.landmark:
        cfg = dataclasses.replace(cfg, use_landmark_decode=True)
    device = resolve_device(args.device)
    model = build_model(cfg)
    params = model.prepare(model.init(
        torch.Generator(device=device).manual_seed(0), device))
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator(device=device).manual_seed(1),
        device=device)
    t0 = time.perf_counter()
    out = generate(model, params, prompts, args.gen,
                   generator=torch.Generator().manual_seed(2))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"generated {tuple(out.shape)} on {device} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("sample row:", out[0][:16].tolist())
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise RuntimeError(f"a generated token lies outside [0, "
                           f"{cfg.vocab_size})")
    print("serve ok")


if __name__ == "__main__":
    main()
