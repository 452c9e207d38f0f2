"""Deterministic synthetic token pipeline with checkpointable cursor state.

Copied from ``repro/data/synthetic.py`` (numpy only), so that the port
imports nothing of the JAX package: its batches are the reference's byte
for byte, for every seed and step.

The stream is *stateless in the step index*: ``batch(step)`` is a pure
function of ``(seed, step)``, so the only iterator state a checkpoint must
carry is the integer cursor — restore on any host (or any data-parallel
world size) resumes the exact stream, which is what makes the ad hoc cloud's
restore-on-another-host protocol exact for training jobs.

Sequences follow a seeded affine recurrence ``t_{i+1} = (a*t_i + c) % V``
(a learnable bigram structure) mixed with noise tokens, so example training
runs show a real loss decrease.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.config import ModelConfig, ShapeConfig


@dataclass
class SyntheticDataset:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05

    def batch(self, step: int) -> dict:
        """Return the numpy batch for global step ``step`` (host-sharded
        slicing is the caller's concern)."""
        v = self.cfg.vocab_size
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, 0xAD_0C])
        )
        b, s = self.global_batch, self.seq_len
        if self.cfg.family == "vlm":
            s = s - self.cfg.n_image_tokens
        a = 3 + 2 * rng.integers(0, 8, size=(b, 1))          # odd multipliers
        c = rng.integers(1, v, size=(b, 1))
        t0 = rng.integers(0, v, size=(b, 1))
        idx = np.arange(s + 1)[None, :]
        # iterate the affine map: closed form would need modular inverses;
        # just roll it forward (s is a few thousand).
        toks = np.empty((b, s + 1), np.int64)
        toks[:, 0] = t0[:, 0]
        for i in range(1, s + 1):
            toks[:, i] = (a[:, 0] * toks[:, i - 1] + c[:, 0]) % v
        noise_mask = rng.random((b, s + 1)) < self.noise
        noise_toks = rng.integers(0, v, size=(b, s + 1))
        toks = np.where(noise_mask, noise_toks, toks)
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if self.cfg.family == "vlm":
            batch["embeds"] = rng.standard_normal(
                (b, self.cfg.n_image_tokens, 1024), np.float32
            ).astype(np.float32)
        if self.cfg.family == "encdec":
            enc_s = min(self.seq_len, 1500)
            batch["frames"] = rng.standard_normal(
                (b, enc_s, self.cfg.d_model), np.float32
            ).astype(np.float32)
        return batch

    @staticmethod
    def for_shape(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0
                  ) -> "SyntheticDataset":
        return SyntheticDataset(cfg, shape.seq_len, shape.global_batch, seed)
