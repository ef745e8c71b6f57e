"""Deterministic synthetic LM data (per-host sharded, resumable).

Port of ``repro/train/data.py``: the same NumPy generator, so a batch is
the reference's for the same (seed, step, shard), token for token; it is
handed over as int32 tensors on the requested device.  Every batch is a
pure function of (seed, step, shard): a restart at step S sees exactly the
batches a fresh run would.  Tokens follow an order-1 Markov chain over a
low-rank transition matrix (learnable, so a smoke run's loss falls).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_temp: float = 1.5


def _transition_logits(cfg: DataConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed ^ 0xDA7A)
    u = rng.normal(size=(cfg.vocab, 16))
    v = rng.normal(size=(16, cfg.vocab))
    return (u @ v) / cfg.markov_temp


class SyntheticLM:
    def __init__(self, cfg: DataConfig,
                 device: "str | torch.device" = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        logits = _transition_logits(cfg)
        z = logits - logits.max(axis=1, keepdims=True)
        p = np.exp(z)
        self.probs = p / p.sum(axis=1, keepdims=True)
        self.cum = np.cumsum(self.probs, axis=1)

    def batch(self, step: int, *, shard: int = 0, n_shards: int = 1) -> dict:
        cfg = self.cfg
        assert cfg.global_batch % n_shards == 0
        b = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            (cfg.seed * 0x9E3779B1 + step) * 65_521 + shard)
        toks = np.empty((b, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, b)
        unif = rng.random((b, cfg.seq_len))
        for t in range(cfg.seq_len):
            row = self.cum[toks[:, t]]
            toks[:, t + 1] = (unif[:, t:t + 1] < row).argmax(axis=1)
        return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(
                    self.device),
                "labels": torch.from_numpy(toks[:, 1:].copy()).to(
                    self.device)}

    def global_batch(self, step: int) -> dict:
        return self.batch(step, shard=0, n_shards=1)


def optimal_loss(cfg: DataConfig, n_samples: int = 4096) -> float:
    """Entropy rate of the Markov source: the floor the LM can reach."""
    ds = SyntheticLM(cfg, device="cpu")
    rng = np.random.default_rng(1)
    rows = rng.integers(0, cfg.vocab, n_samples)
    p = ds.probs[rows]
    return float(-(p * np.log(np.maximum(p, 1e-12))).sum(axis=1).mean())
