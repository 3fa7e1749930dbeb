"""Deterministic synthetic data pipeline (a copy of `repro.training.data`,
which imports no JAX: its batches are the reference's bit for bit).

Generates a learnable "language": each sequence interleaves a small set of
fixed n-gram motifs (predictable — the model's loss drops fast) with uniform
noise tokens.  Sharding is by (host, step): every host derives its shard from
(seed, host_id, step) so restarts resume bit-identically mid-epoch — the data
half of fault-tolerant training.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class SyntheticDataPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_motifs: int = 32
    motif_len: int = 16
    noise_prob: float = 0.1
    host_id: int = 0
    num_hosts: int = 1
    family: str = "dense"
    d_model: int = 0           # for vlm / encdec stub embeddings
    num_patches: int = 0
    src_len: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.motifs = rng.integers(2, self.vocab_size,
                                   (self.num_motifs, self.motif_len)).astype(np.int32)
        assert self.global_batch % self.num_hosts == 0
        self.local_batch = self.global_batch // self.num_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for `step` on this host (pure function of (seed, host, step))."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.host_id, step]))
        b, s = self.local_batch, self.seq_len
        n_mot = s // self.motif_len + 2
        ids = rng.integers(0, self.num_motifs, (b, n_mot))
        seq = self.motifs[ids].reshape(b, -1)[:, :s + 1]
        noise = rng.random((b, s + 1)) < self.noise_prob
        rand = rng.integers(2, self.vocab_size, (b, s + 1)).astype(np.int32)
        seq = np.where(noise, rand, seq)
        batch = {"tokens": seq[:, :-1].astype(np.int32),
                 "targets": seq[:, 1:].astype(np.int32),
                 "loss_mask": np.ones((b, s), np.float32)}
        if self.family == "vlm" and self.num_patches:
            batch["patch_embeds"] = rng.standard_normal(
                (b, self.num_patches, self.d_model)).astype(np.float32)
        if self.family == "encdec" and self.src_len:
            batch["src_embeds"] = rng.standard_normal(
                (b, self.src_len, self.d_model)).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
