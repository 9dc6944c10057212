"""Deterministic, restartable data pipeline (port of
``repro.data.pipeline``; the reference's module is pure numpy, and this is
its copy, so the port's batches equal the reference's bit for bit).

Two sources behind one interface:

- ``SyntheticLM``  : a counter-based PRNG token stream (zipfian unigrams mixed
                     with a repeated-ngram process so the loss actually moves)
                     — fully deterministic in (seed, step), so a restore at
                     step k reproduces exactly the batches a non-failed run
                     would have seen (the fault-tolerance contract).
- ``BinCorpus``    : memmapped flat token file (one uint16/uint32 token per
                     entry), sliced into (B, S+1) windows by the same
                     counter-based indexing.

Batches are host-side numpy; the trainer moves a batch to its device once
per step.  Each host materializes only its slice of the global batch
(``host_batch_slice``).  ``DataState`` is just the step counter — it is
stored inside the checkpoint, which is what makes the iterator restartable.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


class DataState(NamedTuple):
    step: torch.Tensor                # () int32 — the only iterator state


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    ngram_period: int = 16

    def batch_at(self, step: int) -> dict:
        """The full global batch for ``step`` (numpy, host-side)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, int(step)]))
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        # zipfian unigrams (clipped into vocab)
        toks = rng.zipf(self.zipf_a, size=(B, S + 1)).astype(np.int64)
        toks = (toks - 1) % V
        # inject learnable structure: every row repeats its first ngram_period
        # tokens with period ngram_period over a random half of positions
        period = self.ngram_period
        idx = np.arange(S + 1) % period
        repeats = toks[:, :period][np.arange(B)[:, None], idx]
        gate = rng.random((B, S + 1)) < 0.5
        toks = np.where(gate, repeats, toks).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass(frozen=True)
class BinCorpus:
    """Flat binary token file; one window per (step, row)."""
    path: str
    vocab_size: int
    seq_len: int
    global_batch: int
    dtype: str = "uint16"

    def __post_init__(self):
        object.__setattr__(self, "_tokens",
                           np.memmap(self.path, dtype=self.dtype, mode="r"))

    @property
    def n_tokens(self) -> int:
        return int(self._tokens.shape[0])

    def batch_at(self, step: int) -> dict:
        B, S = self.global_batch, self.seq_len
        n_windows = max((self.n_tokens - 1) // S, 1)
        base = (step * B) % n_windows
        rows = []
        for b in range(B):
            w = (base + b) % n_windows
            seg = np.asarray(self._tokens[w * S: w * S + S + 1],
                             dtype=np.int64)
            if seg.shape[0] < S + 1:                     # wrap at EOF
                seg = np.concatenate(
                    [seg, np.asarray(self._tokens[: S + 1 - seg.shape[0]],
                                     dtype=np.int64)])
            rows.append(seg % self.vocab_size)
        toks = np.stack(rows).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def host_batch_slice(batch: dict, process_index: int, process_count: int
                     ) -> dict:
    """The rows of the global batch this host is responsible for."""
    def sl(x):
        B = x.shape[0]
        per = B // process_count
        return x[process_index * per:(process_index + 1) * per]
    return {k: sl(v) for k, v in batch.items()}


def make_pipeline(kind: str, *, vocab_size: int, seq_len: int,
                  global_batch: int, seed: int = 0,
                  path: Optional[str] = None):
    if kind == "synthetic":
        return SyntheticLM(vocab_size=vocab_size, seq_len=seq_len,
                           global_batch=global_batch, seed=seed)
    if kind == "bin":
        assert path is not None
        return BinCorpus(path=path, vocab_size=vocab_size, seq_len=seq_len,
                         global_batch=global_batch)
    raise ValueError(f"unknown pipeline kind {kind!r}")
