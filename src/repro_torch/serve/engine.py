"""Batched serving engine: prefill once, decode step by step
(``repro/serve/engine.py``).

The KV cache is written in place at each decode position (the
reference's decode donates its cache). Greedy or temperature sampling.

Under a device mesh (``ShardingCtx(mesh=DeviceMesh)``) every parameter
leaf is placed by its decl before prefill and decode (the reference's
``jit(in_shardings=)``): a DTensor on other placements is redistributed,
a plain tensor (the full value on every rank) cut to the rank's shard.
The cache and position keep the layout that prefill produced; each
step's token is gathered whole (every rank then holds the batch's
tokens, as it holds the prompts).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ArchConfig
from repro_torch.models.layers import pad_dim1
from repro_torch.models.transformer import build_model, prefix_len
from repro_torch.parallel.sharding import ShardingCtx, full, place_tree


def grow_cache(cache, total: int, max_len: int):
    """The prefill cache made decode-ready: every attention layer's ``kv``
    entry (its ``k`` and ``v``, [b, total, kvh, hd]) padded with zeros
    to [b, max_len, kvh, hd]; SSM states stay as they are.

    The reference grows every 4-D leaf whose second dim equals ``total``
    (``repro/serve/engine.py:78-79``), which also pads an SSM state
    [b, nh, d_state, head_dim] when ``total == nh`` and then fails in the
    decode step; this grows by what each leaf is."""
    out = {}
    for name, entry in cache.items():
        entry = dict(entry)
        if "kv" in entry:
            grown = {}
            for kn, x in entry["kv"].items():
                assert x.shape[1] == total, (name, kn, x.shape, total)
                grown[kn] = pad_dim1(x, 0, max_len - total)
            entry["kv"] = grown
        out[name] = entry
    return out


class ServeEngine:
    """Serve ``arch`` on ``device`` (``None``: ``cuda``, raising without a
    card; under a device mesh the rank's device) with a KV cache of
    ``max_len`` positions."""

    def __init__(self, arch: ArchConfig, ctx: Optional[ShardingCtx] = None,
                 max_len: int = 256, device=None):
        if arch.is_encoder_only:
            raise ValueError("encoder archs are not served")
        self.arch = arch
        self.ctx = ctx or ShardingCtx()
        self.max_len = max_len
        self.device = self.ctx.device or resolve_device(device)
        self.bundle = build_model(arch, self.ctx)
        self._n_calls = 0   # per-call sampling seed (see generate)

    @torch.no_grad()
    def generate(self, params, prompts, n_new: int,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 timer=None) -> torch.Tensor:
        """prompts: [B, S0] token ids (tensor or array). Returns the [B,
        n_new] generated ids (int32, on the CPU; under a mesh the whole
        batch on every rank): the prefill's greedy token, then one token
        a decode step.

        ``timer`` optionally takes a ``repro_torch.obs.timing.PhaseTimer``:
        the prefill and the whole decode loop are recorded as ``prefill``
        / ``decode`` spans. ``None`` changes nothing.

        Sampling (``temperature > 0``) without a ``generator`` seeds a
        fresh one each call from an engine-local counter, so repeated
        calls draw different samples; pass ``generator`` for reproducible
        draws.
        """
        with self.ctx.scope():
            return self._generate(params, prompts, n_new, temperature,
                                  generator, timer)

    def _generate(self, params, prompts, n_new, temperature, generator,
                  timer):
        dev = self.device
        params = place_tree(params, self.bundle.decls, self.ctx)
        prompts = torch.as_tensor(np.asarray(prompts) if not isinstance(
            prompts, torch.Tensor) else prompts).to(dev, torch.int64)
        b, s0 = prompts.shape
        pl_ = prefix_len(self.arch)
        if s0 + pl_ + n_new > self.max_len:
            raise ValueError(
                f"request overruns the KV cache: prompt {s0} + prefix "
                f"{pl_} + {n_new} new tokens > max_len {self.max_len}")
        batch = dict(tokens=prompts)
        if self.arch.vit_dim:
            batch["patch_embeds"] = torch.zeros(
                (b, self.arch.n_patches, self.arch.vit_dim),
                dtype=torch.float32, device=dev)
        total = s0 + pl_
        state = {}

        def prefill():
            logits, cache = self.bundle.prefill(params, batch)
            state["cache"] = grow_cache(cache, total, self.max_len)
            state["tok"] = full(torch.argmax(logits[:, -1], dim=-1)[:, None])

        if temperature > 0 and generator is None:
            generator = torch.Generator(dev).manual_seed(self._n_calls)
        if temperature > 0:
            self._n_calls += 1
        out = []

        def decode_loop():
            tok, cache = state["tok"], state["cache"]
            for i in range(n_new):
                out.append(tok[:, 0])
                logits, cache = self.bundle.decode_step(params, cache, tok,
                                                        total + i)
                nxt = logits[:, -1].float()
                if temperature > 0:
                    probs = full(torch.softmax(nxt / temperature, dim=-1))
                    tok = torch.multinomial(probs.to(generator.device), 1,
                                            generator=generator).to(dev)
                else:
                    tok = full(torch.argmax(nxt, dim=-1)[:, None])

        for name, fn in (("prefill", prefill), ("decode", decode_loop)):
            if timer is None:
                fn()
            else:
                with timer.span(name):
                    fn()
        return torch.stack(out, dim=1).to(torch.int32).cpu()
