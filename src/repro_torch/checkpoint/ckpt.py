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
  checkpoint, so a restart continues exactly.

Re-placing a checkpoint onto a device mesh (``shardings=``) comes with
the mesh (``parallel/sharding.py::MESH_PENDING``).
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

from repro_torch import resolve_device
from repro_torch.parallel.sharding import MESH_PENDING


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
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
    device (a copy on the CPU too: training updates tensors in place)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def save_checkpoint(ckpt_dir, step: int, state: Dict[str, Any],
                    meta: Optional[dict] = None):
    """state: {'params': tree, 'opt': tree, 'data': tree, ...} with tensor
    or numpy leaves."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    host = {k: _host(v) for k, v in _flatten(state).items()}
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
    raising without a card); ``(None, None)`` when there is none."""
    if shardings is not None:
        raise NotImplementedError(MESH_PENDING)
    device = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None, None
    with np.load(ckpt_dir / f"step_{step:08d}.npz") as data:
        flat = {k.replace("|", "/"): torch.from_numpy(data[k]).to(device)
                for k in data.files}
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

    def save(self, step: int, state, meta=None):
        # the device -> host copy happens here (a consistent snapshot)
        host_state = _unflatten({k: _host(v)
                                 for k, v in _flatten(state).items()})
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write_async, args=(step, host_state, meta))
            self._thread.start()
        else:
            self._write(step, host_state, meta)

    def _write(self, step, host_state, meta):
        save_checkpoint(self.dir, step, host_state, meta)
        self._gc()

    def _write_async(self, step, host_state, meta):
        try:
            self._write(step, host_state, meta)
        except BaseException as e:   # re-raised by wait() in the caller
            self._error = e

    def wait(self):
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
