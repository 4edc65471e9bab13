"""Training loop with fault tolerance (``repro/train/trainer.py``).

  * resume from the newest checkpoint (parameters, optimizer state and
    the data cursor), continuing exactly;
  * simulated node failure (``fail_at_step``) for the restart test,
    raised before the step's batch is drawn;
  * optional int8 gradient compression with error feedback;
  * gradient accumulation (micro-batching).

The step updates the parameters and moments in place (the reference
donates them); ``float(metrics["loss"])`` once a step is the loop's one
read to the host.

Under a device mesh (reference ``:84-125``) the state lives on the mesh:
parameters and moments placed by their decls, error feedback like the
parameters. Every rank draws the same global batch (same seed and
cursor) and places it by ``input_shardings``; a checkpoint is re-placed
onto the current mesh on restore, whatever mesh wrote it.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import ArchConfig, ShapeConfig
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.models.transformer import build_model, input_shardings
from repro_torch.parallel import compress as gc
from repro_torch.parallel.sharding import (ShardingCtx, full, init_params,
                                           tree_pspecs)
from repro_torch.train.optimizer import (AdamWConfig, adamw_init_decls,
                                         adamw_update)
from repro_torch.train.steps import accumulate_grads


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests / chaos drills)."""


def _default_ckpt_dir():
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    seed: int = 0
    accum_steps: int = 1
    grad_compress_bits: int = 0      # 0 = off
    fail_at_step: int = -1           # simulate a crash (before ckpt) at step
    log_every: int = 10
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


class Trainer:
    """Train ``arch`` on ``shape``'s synthetic batches on ``device``
    (``None``: ``cuda``, raising without a card; under a device mesh the
    rank's device)."""

    def __init__(self, arch: ArchConfig, shape: ShapeConfig,
                 tcfg: TrainerConfig, ctx: Optional[ShardingCtx] = None,
                 device=None):
        self.arch, self.shape, self.tcfg = arch, shape, tcfg
        self.ctx = ctx or ShardingCtx()
        self.device = self.ctx.device or resolve_device(device)
        self.bundle = build_model(arch, self.ctx)
        self.pipeline = SyntheticLMPipeline(arch, shape, seed=tcfg.seed)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=3)

    # -- step ----------------------------------------------------------------
    def step_fn(self, params, opt_state, err, batch):
        """One step: gradients (accumulated), error feedback when on,
        AdamW in place. Returns (params, opt_state, err, metrics)."""
        tcfg = self.tcfg
        loss, grads = accumulate_grads(self.bundle.loss, params, batch,
                                       tcfg.accum_steps)
        if tcfg.grad_compress_bits:
            grads, err = gc.ef_compress_grads(grads, err,
                                              tcfg.grad_compress_bits)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             tcfg.opt)
        return params, opt_state, err, dict(loss=loss, **om)

    # -- state ----------------------------------------------------------------
    def init_state(self):
        """Parameters drawn from a generator on the device seeded with
        ``tcfg.seed``, zero moments, zero error feedback when on."""
        gen = torch.Generator(self.device).manual_seed(self.tcfg.seed)
        params = init_params(self.bundle.decls, gen, self.device, self.ctx)
        opt = init_params(adamw_init_decls(self.bundle.decls),
                          device=self.device, ctx=self.ctx)
        err = gc.ef_init(params) if self.tcfg.grad_compress_bits else {}
        return dict(params=params, opt=opt, err=err, step=0)

    def shardings(self):
        """Where a restored state's leaves go (``restore_checkpoint``'s
        ``shardings``): parameters and moments by their decls, error
        feedback like the parameters; ``None`` without a device mesh."""
        if not self.ctx.places:
            return None
        psh = tree_pspecs(self.bundle.decls, self.ctx)
        return dict(params=psh, err=psh,
                    opt=tree_pspecs(adamw_init_decls(self.bundle.decls),
                                    self.ctx))

    def next_batch(self):
        """The pipeline's next global batch, placed by ``input_shardings``
        under a device mesh."""
        batch = self.pipeline.next_batch(self.device)
        if not self.ctx.places:
            return batch
        sh = input_shardings(self.arch, self.shape, self.ctx)
        return {k: self.ctx.place(v, sh[k]) for k, v in batch.items()}

    def restore_or_init(self):
        step, state = self.ckpt.restore_latest(shardings=self.shardings(),
                                               device=self.device)
        if state is None:
            return self.init_state()
        self.pipeline.load_state_dict(state.pop("data"))
        state["step"] = int(step)
        state.setdefault("err", {})
        return state

    # -- loop ----------------------------------------------------------------
    def train(self, resume: bool = True) -> Dict[str, Any]:
        st = self.restore_or_init() if resume else self.init_state()
        params, opt, err = st["params"], st["opt"], st["err"]
        history = []
        for step in range(st["step"], self.tcfg.steps):
            if step == self.tcfg.fail_at_step:
                raise SimulatedFailure(f"injected failure at step {step}")
            batch = self.next_batch()
            t0 = time.perf_counter()
            params, opt, err, metrics = self.step_fn(params, opt, err, batch)
            loss = float(full(metrics["loss"]))
            dt = time.perf_counter() - t0
            history.append(dict(step=step, loss=loss, sec=dt))
            if step % self.tcfg.log_every == 0:
                print(f"step {step}: loss {loss:.4f} ({dt*1e3:.0f} ms)",
                      flush=True)
            if (step + 1) % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step + 1, dict(
                    params=params, opt=opt, err=err,
                    data=self.pipeline.state_dict()))
        self.ckpt.wait()
        return dict(params=params, opt=opt, history=history)
