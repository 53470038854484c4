"""Deterministic, restart-safe synthetic data pipeline (the port's copy of
``repro.data.pipeline``: numpy only, batch for batch the reference's).

Batches are a pure function of (seed, step): after a crash/elastic
re-mesh, the loop resumes at step k and sees exactly the token stream it
would have seen — no stateful shuffle to lose. This is the data-side half
of the fault-tolerance story (checkpoint.py is the model-side half).

The stream is Zipf-distributed token ids over the model vocab with
document boundaries (EOS every ~doc_len tokens) — enough structure for a
~100M-param model's loss to fall measurably in a few hundred steps.
Per-host sharding: each process materializes only its slice of the global
batch (process_index-strided), matching multi-host jax.make_array...
semantics; in one process that is the whole batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticTokens", "batch_for_step"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 1234
    zipf_a: float = 1.3
    doc_len: int = 512
    eos_id: int = 0


class SyntheticTokens:
    def __init__(self, cfg: DataConfig, *, process_index: int = 0,
                 process_count: int = 1):
        self.cfg = cfg
        self.process_index = process_index
        self.process_count = process_count
        assert cfg.global_batch % process_count == 0

    @property
    def local_batch(self) -> int:
        return self.cfg.global_batch // self.process_count

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """(tokens, labels) of shape (local_batch, seq_len), int32."""
        c = self.cfg
        rows = []
        base = np.random.SeedSequence(
            [c.seed, step, self.process_index])
        rng = np.random.default_rng(base)
        n = self.local_batch
        # zipf over vocab, clipped; deterministic given (seed, step, proc)
        raw = rng.zipf(c.zipf_a, size=(n, c.seq_len + 1))
        toks = (raw % (c.vocab - 1)) + 1  # reserve 0 for EOS
        # document boundaries
        doc_phase = rng.integers(0, c.doc_len, size=(n, 1))
        pos = np.arange(c.seq_len + 1)[None, :]
        toks[(pos + doc_phase) % c.doc_len == 0] = c.eos_id
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def batch_for_step(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    return SyntheticTokens(cfg).batch(step)
