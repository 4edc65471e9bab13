"""Deterministic, checkpointable, sharded synthetic data pipeline (a copy
of ``repro/data/pipeline.py``).

Sequences come from a seeded order-1 Markov chain over an effective
vocab, so models can learn (loss decreases within tens of steps), and
every (seed, step, shard) triple regenerates identical data: the cursor
is ``(seed, step)`` and lives inside the checkpoint. Each process of a
multi-host job generates only its batch shard
(``shard_index / num_shards``). The tokens are made on the host with
numpy's ``RandomState``, as the reference makes them, so both packages
give equal batches; ``next_batch`` puts them on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ArchConfig, ShapeConfig
from repro_torch.models.transformer import prefix_len


@dataclasses.dataclass
class SyntheticLMPipeline:
    arch: ArchConfig
    shape: ShapeConfig
    seed: int = 0
    step: int = 0
    shard_index: int = 0
    num_shards: int = 1
    markov_states: int = 64

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        # sparse-ish row-stochastic transition matrix over markov_states
        logits = rng.randn(self.markov_states, self.markov_states) * 2.0
        self._trans = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        self._proj = rng.randint(
            0, max(self.arch.vocab, 2), size=self.markov_states)

    # -- checkpointable cursor ------------------------------------------------
    def state_dict(self) -> Dict[str, np.ndarray]:
        return dict(seed=np.int64(self.seed), step=np.int64(self.step))

    def load_state_dict(self, st):
        self.seed = int(st["seed"])
        self.step = int(st["step"])

    # -- batch generation -----------------------------------------------------
    def _tokens(self, rng, b, s):
        x = np.zeros((b, s), np.int64)
        state = rng.randint(0, self.markov_states, size=b)
        for t in range(s):
            x[:, t] = state
            u = rng.rand(b, 1)
            cdf = np.cumsum(self._trans[state], axis=1)
            state = (u < cdf).argmax(axis=1)
        return self._proj[x]

    def _batch_numpy(self) -> Dict[str, np.ndarray]:
        """The next batch as numpy arrays (int32 tokens and labels, f32
        frames and patch embeddings); advances the cursor."""
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + self.step * 131 + self.shard_index)
            % (2 ** 31))
        self.step += 1
        b = self.shape.global_batch // self.num_shards
        pl = prefix_len(self.arch)
        s = self.shape.seq_len - pl
        if self.arch.family == "audio":
            frames = rng.randn(b, self.shape.seq_len,
                               self.arch.frame_dim).astype(np.float32)
            labels = rng.randint(0, self.arch.vocab,
                                 size=(b, self.shape.seq_len))
            return dict(frames=frames, labels=labels.astype(np.int32))
        toks = self._tokens(rng, b, s + 1)
        batch = dict(tokens=toks[:, :-1].astype(np.int32),
                     labels=toks[:, 1:].astype(np.int32))
        if self.arch.vit_dim:
            batch["patch_embeds"] = rng.randn(
                b, self.arch.n_patches, self.arch.vit_dim).astype(np.float32)
        return batch

    def next_batch(self, device=None) -> Dict[str, torch.Tensor]:
        """The next batch as tensors on ``device`` (``None``: ``cuda``,
        raising without a card); advances the cursor."""
        device = resolve_device(device)
        return {k: torch.from_numpy(v).to(device)
                for k, v in self._batch_numpy().items()}
