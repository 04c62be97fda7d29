"""Synthetic data pipeline with gZ-Scatter batch distribution.

Deterministic synthetic token streams (zipf-ish unigram mix + shift
labels), plus modality-frontend stub embeddings for the VLM/audio archs.
The batch-distribution path demonstrates the paper's gZ-Scatter as the
data-plane collective: the root rank holds the global float features and
scatters compressed blocks down the binomial tree
(examples/data_scatter.py runs it on 8 virtual devices).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.config import ModelConfig

__all__ = ["SyntheticStream", "make_batch"]


@dataclasses.dataclass
class SyntheticStream:
    """Infinite deterministic batch stream for a given model config."""

    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        # zipf-ish unigram distribution — more realistic loss curves than
        # uniform tokens
        v = self.cfg.vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks**1.1
        self._p = p / p.sum()

    def __iter__(self):
        return self

    def __next__(self):
        return make_batch(self.cfg, self.batch, self.seq, self._rng, self._p)


def make_batch(cfg: ModelConfig, batch: int, seq: int, rng, p=None) -> dict:
    s_text = seq - (cfg.n_prefix if cfg.family in ("vlm", "audio") else 0)
    if p is not None:
        toks = rng.choice(cfg.vocab, size=(batch, s_text + 1), p=p).astype(np.int32)
    else:
        toks = rng.integers(0, cfg.vocab, (batch, s_text + 1)).astype(np.int32)
    out = {
        "tokens": toks[:, :-1],
        "labels": toks[:, 1:].copy(),
    }
    if cfg.family in ("vlm", "audio") and cfg.n_prefix:
        out["prefix"] = rng.normal(0, 1.0, (batch, cfg.n_prefix, cfg.d_model)).astype(
            np.float32
        )
    if cfg.family == "encdec":
        out["enc_input"] = rng.normal(
            0, 1.0, (batch, cfg.n_prefix, cfg.d_model)
        ).astype(np.float32)
    return out
