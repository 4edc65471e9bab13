"""Fault-tolerant checkpointing (``repro/checkpoint/ckpt.py``).

* **the reference's format**: one ``step_NNNNNNNN.npz`` a step, the
  state tree flattened to ``|``-joined keys (``params|layer_0|ln1``),
  each leaf a numpy array in its own dtype (int32 ``opt|step``, int64
  ``data|seed`` and ``data|step``), so a checkpoint written by either
  package restores in the other;
* **atomic**: written to ``step_NNNNNNNN.tmp.npz``, then ``os.replace``d,
  so a crash mid-write never corrupts the restore point;
* **async**: ``CheckpointManager(async_save=True)`` hands the host copy
  to a writer thread, so the train loop waits only for the copy from the
  device;
* **complete**: optimizer state and the data cursor are part of the
  checkpoint, so a restart continues exactly;
* **elastic**: a DTensor leaf is saved whole (``full_tensor()``, a
  collective every rank makes in the same order; rank 0 writes, the
  others wait at a barrier), and ``restore_checkpoint(shardings=)``
  places each leaf on the mesh it is given, whatever mesh wrote it.
"""
from __future__ import annotations

import json
import os
import re
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import resolve_device
from repro_torch.parallel.sharding import MeshPlacement, ShardingCtx, full


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and \
            not isinstance(tree, MeshPlacement):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _host(x):
    """A leaf as a numpy array the caller owns: a tensor copied off its
    device (a copy on the CPU too: training updates tensors in place), a
    DTensor gathered whole first."""
    if isinstance(x, torch.Tensor):
        return full(x.detach()).to("cpu", copy=True).numpy()
    return np.asarray(x)


def _host_state(state):
    """``(host tree, sharded, writes)``: the state's leaves gathered to
    numpy in the tree's order (the same collectives on every rank),
    whether a DTensor leaf was among them, and whether this rank writes:
    rank 0 when one was."""
    flat = _flatten(state)
    host = {k: _host(v) for k, v in flat.items()}
    sharded = any(isinstance(v, DTensor) for v in flat.values())
    writes = not sharded or dist.get_rank() == 0
    return _unflatten(host), sharded, writes


def save_checkpoint(ckpt_dir, step: int, state: Dict[str, Any],
                    meta: Optional[dict] = None):
    """state: {'params': tree, 'opt': tree, 'data': tree, ...} with tensor
    (or DTensor: every rank calls) or numpy leaves."""
    host_state, sharded, writes = _host_state(state)
    if writes:
        _write(ckpt_dir, step, host_state, meta)
    if sharded:
        dist.barrier()
    return Path(ckpt_dir) / f"step_{step:08d}.npz"


def _write(ckpt_dir, step: int, host_state, meta):
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    host = _flatten(host_state)
    tmp = ckpt_dir / f"step_{step:08d}.tmp.npz"
    final = ckpt_dir / f"step_{step:08d}.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **{k.replace("/", "|"): v for k, v in host.items()})
    os.replace(tmp, final)
    if meta is not None:
        mp = ckpt_dir / f"step_{step:08d}.meta.json"
        mp.write_text(json.dumps(meta))
    return final


def _steps(ckpt_dir: Path):
    return [int(m.group(1)) for p in ckpt_dir.iterdir()
            if (m := re.fullmatch(r"step_(\d+)\.npz", p.name))]


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir, step: Optional[int] = None,
                       shardings=None, device=None):
    """Load a checkpoint (the newest without ``step``) as ``(step,
    state)``, every leaf a tensor on ``device`` (``None``: ``cuda``,
    raising without a card); ``(None, None)`` when there is none.

    ``shardings``: a tree like part of the state with ``MeshPlacement``
    leaves (``tree_pspecs(decls, ctx)``; ``None`` leaves stay plain).
    Each leaf it names is placed on that mesh by those placements, each
    rank keeping its shard of the whole leaf, whatever mesh wrote it;
    the other leaves go to the mesh's device."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None, None
    sh = _flatten(shardings) if shardings is not None else {}
    placed = [v for v in sh.values() if isinstance(v, MeshPlacement)]
    device = (ShardingCtx(mesh=placed[0].mesh).device if placed
              else resolve_device(device))
    flat = {}
    with np.load(ckpt_dir / f"step_{step:08d}.npz") as data:
        for k in data.files:
            key = k.replace("|", "/")
            x = torch.from_numpy(data[k])
            where = sh.get(key)
            if isinstance(where, MeshPlacement):
                flat[key] = ShardingCtx(mesh=where.mesh).place(
                    x, where.placements)
            else:
                flat[key] = x.to(device)
    return step, _unflatten(flat)


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; optional async writer thread.
    A write that failed in the thread raises from the next ``wait``."""

    def __init__(self, ckpt_dir, keep: int = 3, async_save: bool = False):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._sharded = False      # a save gathered DTensors: ranks meet

    def save(self, step: int, state, meta=None):
        """Every rank calls under a mesh (the gather is a collective);
        only the writing rank writes, in its thread when async."""
        # the device -> host copy happens here (a consistent snapshot)
        host_state, sharded, writes = _host_state(state)
        self._sharded |= sharded
        if writes and self.async_save:
            self._join()
            self._thread = threading.Thread(
                target=self._write_async, args=(step, host_state, meta))
            self._thread.start()
        elif writes:
            self._write(step, host_state, meta)
        if sharded:
            dist.barrier()

    def _write(self, step, host_state, meta):
        _write(self.dir, step, host_state, meta)
        self._gc()

    def _write_async(self, step, host_state, meta):
        try:
            self._write(step, host_state, meta)
        except BaseException as e:   # re-raised by wait() in the caller
            self._error = e

    def wait(self):
        """The last write finished (under a mesh: on every rank, each
        rank calling)."""
        try:
            self._join()
        finally:
            if self._sharded:
                dist.barrier()

    def _join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in sorted(_steps(self.dir))[:-self.keep]:
            for suffix in (".npz", ".meta.json"):
                p = self.dir / f"step_{s:08d}{suffix}"
                if p.exists():
                    p.unlink()

    def restore_latest(self, shardings=None, device=None):
        self.wait()
        return restore_checkpoint(self.dir, shardings=shardings,
                                  device=device)
