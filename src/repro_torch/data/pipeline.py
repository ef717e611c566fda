"""Data pipeline: deterministic synthetic LM stream — port of
``repro.data.pipeline``.

The pipeline is seeded and stateless per step index, so any host can
regenerate any step's batch after a failure (a checkpoint only needs the
step counter).  Batches are built host-side in numpy, the same numbers as
the reference's for the same seed and step, then moved to the device.

Synthetic stream: Zipf-distributed unigrams with a Markov refresh, giving
a non-degenerate learnable distribution (loss decreases).  Under a mesh
every rank takes the whole global batch (the global view,
``distributed.sharding``): the MoE layers' ``shard_map`` bodies give each
rank its share.  The reference's ``batch_specs`` (its ``named_sharding``
of a batch) has one reader, the dry run (ROADMAP A13), and comes with it.
A device group's members take their microbatches as slices of the global
batch (``Trainer._microbatches``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..configs.base import ArchConfig, InputShape


@dataclasses.dataclass
class SyntheticLM:
    cfg: ArchConfig
    seq_len: int
    global_batch: int
    seed: int = 0

    def _tokens(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        v = self.cfg.vocab_size
        b, s = self.global_batch, self.seq_len
        # Zipf unigram base
        ranks = np.arange(1, v + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        base = rng.choice(v, size=(b, s), p=probs)
        # first-order structure: with p=0.5, token t+1 = (token t * 7 + 1) % v
        follow = rng.random((b, s)) < 0.5
        for t in range(1, s):
            base[:, t] = np.where(follow[:, t],
                                  (base[:, t - 1] * 7 + 1) % v, base[:, t])
        return base.astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        toks = self._tokens(step)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = 0
        mask = np.ones_like(toks, np.float32)
        mask[:, -1] = 0.0
        cfg = self.cfg
        if cfg.frontend == "patch_embed":
            npz = cfg.prefix_len
            rng = np.random.default_rng((self.seed, step, 7))
            return {
                "patches": rng.standard_normal(
                    (self.global_batch, npz, cfg.d_model)).astype(np.float32),
                "tokens": toks[:, : self.seq_len - npz],
                "labels": labels[:, : self.seq_len - npz],
                "mask": mask[:, : self.seq_len - npz],
            }
        if cfg.frontend == "frame_embed":
            rng = np.random.default_rng((self.seed, step, 7))
            return {
                "frames": rng.standard_normal(
                    (self.global_batch, self.seq_len, cfg.d_model)
                ).astype(np.float32),
                "labels": labels,
                "mask": mask,
            }
        return {"tokens": toks, "labels": labels, "mask": mask}

    def device_batch(self, step: int, device="cpu") -> Dict[str, torch.Tensor]:
        """:meth:`batch` as tensors on ``device``."""
        return {k: torch.from_numpy(v).to(device) for k, v in self.batch(step).items()}


def make_batch(cfg: ArchConfig, shape: InputShape, step: int = 0,
               seed: int = 0, *, device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch of ``shape``'s size as tensors on ``device``:
    the reference's arrays for the same ``seed``."""
    pipe = SyntheticLM(cfg, shape.seq_len, shape.global_batch, seed)
    return pipe.device_batch(step, device)
