"""Roofline terms of a recorded step (``repro/analysis/roofline.py``).

Three terms, in seconds a step on one NVIDIA H100 (``config.HW``):

  compute    = FLOPs per device / HW.peak_flops_bf16
  memory     = HBM bytes per device / HW.hbm_bw
  collective = collective bytes per device / (HW.link_bw * HW.links)

Where the reference reads ``compiled.cost_analysis()`` and parses the
optimized HLO, the port reads a ``cost.Recorder`` of the step: per-device
counts by construction (``cost.py``). On a fake (16, 16) world a
(16, 16)-sharded matmul counts 2MNK/256 FLOPs
(``tests/test_torch_cost.py``), the reference docstring's own check.
``collectives`` and ``hbm_bytes_estimate`` return the reference's dicts
from the recorder. ``entry_computation`` has no counterpart: an eager
program has no fusions to strip.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.config import HW


def collectives(cost) -> Dict[str, Dict[str, float]]:
    """Per-kind ``{count, bytes}`` (per-device bytes), as the reference's
    ``parse_collectives`` returns them."""
    return {k: dict(v) for k, v in cost.coll.items()}


def hbm_bytes_estimate(cost) -> Dict[str, float]:
    """The entry-level HBM model, as the reference's
    ``hbm_bytes_estimate`` returns it: every op's outputs written once
    and read once (``rw`` = 2 x ``total_write``), the 12 largest kinds."""
    by_kind = dict(sorted(cost.by_kind.items(), key=lambda kv: -kv[1])[:12])
    return dict(total_write=cost.total_write, rw=cost.hbm_rw,
                by_kind=by_kind)


def collective_seconds(colls: Dict[str, Dict[str, float]],
                       link_bw: float = HW.link_bw,
                       links: int = HW.links) -> Dict[str, float]:
    """Simple + ring-effective time models for the collective term."""
    simple_bytes = sum(v["bytes"] for v in colls.values())
    # ring model: AR moves 2x its buffer; AG/RS/A2A 1x; CP 1x — per device,
    # across `links` usable links.
    eff = 0.0
    for kind, v in colls.items():
        factor = 2.0 if kind == "all-reduce" else 1.0
        eff += factor * v["bytes"]
    return dict(
        bytes_simple=simple_bytes,
        bytes_effective=eff,
        sec_simple=simple_bytes / (link_bw * links),
        sec_effective=eff / (link_bw * links),
    )


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    flops_per_dev: float
    bytes_per_dev: float          # recorded bytes (the same model as below)
    hbm_bytes_per_dev: float      # entry-level estimate (used)
    hbm_by_kind: Dict[str, float]
    transcendentals: float
    coll: Dict[str, Dict[str, float]]
    coll_sec: Dict[str, float]
    temp_bytes: int
    arg_bytes: int
    out_bytes: int
    model_flops_global: float
    n_devices: int
    step_kind: str

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / HW.peak_flops_bf16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_dev / HW.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_sec["sec_effective"]

    @property
    def bottleneck(self) -> str:
        terms = dict(compute=self.t_compute, memory=self.t_memory,
                     collective=self.t_collective)
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (global recorded flops) — remat/redundancy waste."""
        hlo_global = self.flops_per_dev * self.n_devices
        return self.model_flops_global / max(hlo_global, 1.0)

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline step time."""
        return (self.model_flops_global
                / (self.n_devices * HW.peak_flops_bf16 * self.step_time))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 step_time=self.step_time,
                 useful_flops_ratio=self.useful_flops_ratio, mfu=self.mfu)
        return d


def model_flops_for(arch, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode: D=batch."""
    n = arch.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def build_report(arch, shape, mesh_name: str, n_devices: int, cost,
                 model_flops_global: float = None,
                 step_kind: str = None) -> RooflineReport:
    """The report of one recorded step (``cost``: a ``cost.Recorder``);
    ``model_flops_global`` defaults to ``model_flops_for(arch, shape)``,
    ``step_kind`` to the shape's."""
    colls = collectives(cost)
    hbm = hbm_bytes_estimate(cost)
    return RooflineReport(
        arch=arch if isinstance(arch, str) else arch.name,
        shape=shape.name, mesh=mesh_name,
        flops_per_dev=float(cost.flops),
        bytes_per_dev=float(cost.hbm_rw),
        hbm_bytes_per_dev=float(hbm["rw"]),
        hbm_by_kind=hbm["by_kind"],
        transcendentals=float(cost.transcendentals),
        coll=colls, coll_sec=collective_seconds(colls),
        temp_bytes=int(cost.temp_bytes),
        arg_bytes=int(cost.arg_bytes),
        out_bytes=int(cost.out_bytes),
        model_flops_global=(model_flops_for(arch, shape)
                            if model_flops_global is None
                            else float(model_flops_global)),
        n_devices=n_devices,
        step_kind=shape.kind if step_kind is None else step_kind,
    )
