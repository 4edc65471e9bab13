"""Declarative fault plans for the emulated silicon (commissioning view).

A copy of the reference's ``repro/faults/model.py`` (numpy only), held
equal to it by ``tests/test_torch_faults.py``. ``FaultPlan`` is the
declarative, host-built description of one defect realisation:

  ===================  ====================================================
  field                silicon defect modeled
  ===================  ====================================================
  dead_rows            synapse drivers that never forward events
  hot_neurons          output drivers stuck firing every dt
  dead_neurons         neurons whose spike output never asserts
  stuck_w_mask/_val    6-bit synapse SRAM cells stuck at a value — applied
                       at the ANALOG read (the crossbar sees the stuck
                       value; the PPU's digital readback is unaffected)
  cadc_stuck_*         CADC columns returning a stuck code
  cadc_code_offset     CADC columns with an additive code error
  store_flip           bit planes XORed into every PPU-VM weight STORE
  store_zero           store cells forced to zero (the blacklist
                       reduction uses this to pin masked-out synapses)
  dead_links           inter-chip bus links carrying nothing
  flaky_links          links dropping a deterministic pseudo-random
                       fraction of their events per window (``seed``)
  ===================  ====================================================

Every field is an optional host numpy array (``None`` = no such fault).
The emulation puts a plan's arrays on its device once, where the core or
the vector unit is built (``repro_torch.faults.inject.on_device``); the
hooks then apply only the fields a plan has, and a ``None`` overlay is
the identity on every hook, so the fault-free program launches exactly
what it launched before the subsystem existed.

Row/neuron/synapse planes follow the core's instance-prefix shapes
(``[.., R]`` / ``[.., C]`` / ``[.., R, C]`` broadcast against the
state); link arrays are indexed by the wafer topology's link order.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional, Sequence, Tuple

import numpy as np

WBITS = 6                      # synapse weight/address width
WMASK = (1 << WBITS) - 1


def _as_bool(x):
    return None if x is None else np.asarray(x, bool)


def _as_int(x, dtype):
    return None if x is None else np.asarray(x, dtype)


@dataclass(frozen=True)
class FaultPlan:
    """One realisation of silicon defects, host-built numpy.

    A plan threads one knob through every layer (``AnnCore``,
    ``VectorUnit``, ``playback.execute``, ``make_experiment`` /
    ``run_training``). ``None`` fields are absent defects and are the
    identity: a run with ``faults=None`` launches what it launched before
    the subsystem existed.

    Args:
      dead_rows: [.., R] bool — drivers that never forward events.
      hot_neurons / dead_neurons: [.., C] bool — output drivers stuck
        firing / never asserting.
      stuck_w_mask / stuck_w_val: [.., R, C] — 6-bit SRAM cells stuck
        at a value, applied at the ANALOG read only (the PPU's digital
        readback is unaffected).
      cadc_stuck_mask / cadc_stuck_code / cadc_code_offset: [.., C] —
        CADC columns returning a stuck code / an additive code error.
      store_flip / store_zero: [.., R, C] — bit planes XORed into every
        PPU weight store / store cells forced to zero.
      dead_links: [L] bool — bus links carrying nothing.
      flaky_links: [L] float32 — per-link deterministic event-drop
        fraction (hash-selected with ``seed``).
      seed: the flaky-drop hash seed.
      is_blacklist: marks a ``Blacklist.as_faults`` reduction overlay
        (telemetry reports it under ``faults_detected``).

    Contract pointers: tests/test_torch_faults.py (``faults=None`` the
    identity; injection bit-identical across backends and synaptic
    routes; blacklist reduction exact).
    """

    dead_rows: Optional[np.ndarray] = None        # [.., R] bool
    hot_neurons: Optional[np.ndarray] = None      # [.., C] bool
    dead_neurons: Optional[np.ndarray] = None     # [.., C] bool
    stuck_w_mask: Optional[np.ndarray] = None     # [.., R, C] bool
    stuck_w_val: Optional[np.ndarray] = None      # [.., R, C] int8 0..63
    cadc_stuck_mask: Optional[np.ndarray] = None  # [.., C] bool
    cadc_stuck_code: Optional[np.ndarray] = None  # [.., C] int32
    cadc_code_offset: Optional[np.ndarray] = None # [.., C] int32
    store_flip: Optional[np.ndarray] = None       # [.., R, C] int32 0..63
    store_zero: Optional[np.ndarray] = None       # [.., R, C] bool
    dead_links: Optional[np.ndarray] = None       # [L] bool
    flaky_links: Optional[np.ndarray] = None      # [L] float32 in [0, 1]
    seed: int = 0                                 # flaky-drop hash seed
    is_blacklist: bool = False                    # reduction overlay?

    def __post_init__(self):
        s = object.__setattr__
        s(self, "dead_rows", _as_bool(self.dead_rows))
        s(self, "hot_neurons", _as_bool(self.hot_neurons))
        s(self, "dead_neurons", _as_bool(self.dead_neurons))
        s(self, "stuck_w_mask", _as_bool(self.stuck_w_mask))
        s(self, "stuck_w_val", _as_int(self.stuck_w_val, np.int8))
        s(self, "cadc_stuck_mask", _as_bool(self.cadc_stuck_mask))
        s(self, "cadc_stuck_code", _as_int(self.cadc_stuck_code, np.int32))
        s(self, "cadc_code_offset", _as_int(self.cadc_code_offset, np.int32))
        s(self, "store_flip", _as_int(self.store_flip, np.int32))
        s(self, "store_zero", _as_bool(self.store_zero))
        s(self, "dead_links", _as_bool(self.dead_links))
        fl = self.flaky_links
        s(self, "flaky_links",
          None if fl is None else np.asarray(fl, np.float32))
        if (self.stuck_w_mask is None) != (self.stuck_w_val is None):
            raise ValueError("stuck_w_mask and stuck_w_val come together")
        if (self.cadc_stuck_mask is None) != (self.cadc_stuck_code is None):
            raise ValueError("cadc_stuck_mask and cadc_stuck_code "
                             "come together")
        if self.stuck_w_val is not None:
            v = self.stuck_w_val
            assert (0 <= v).all() and (v <= WMASK).all(), \
                "stuck weights are 6-bit"
            assert v.shape == self.stuck_w_mask.shape
        if self.cadc_stuck_code is not None:
            assert (self.cadc_stuck_code >= 0).all(), "CADC codes >= 0"
        if self.store_flip is not None:
            f = self.store_flip
            assert (0 <= f).all() and (f <= WMASK).all(), \
                "store flips stay within the 6-bit weight plane"
        if self.flaky_links is not None:
            f = self.flaky_links
            assert (0.0 <= f).all() and (f <= 1.0).all(), \
                "flaky drop fractions are probabilities"

    # -- host-side census ----------------------------------------------------
    @property
    def n_dead_rows(self) -> int:
        return 0 if self.dead_rows is None else int(self.dead_rows.sum())

    @property
    def core_sites(self) -> int:
        """Active fault sites on the chip itself (not the bus)."""
        n = self.n_dead_rows
        for m in (self.hot_neurons, self.dead_neurons, self.stuck_w_mask,
                  self.cadc_stuck_mask, self.store_zero):
            if m is not None:
                n += int(m.sum())
        if self.cadc_code_offset is not None:
            n += int((self.cadc_code_offset != 0).sum())
        if self.store_flip is not None:
            n += int((self.store_flip != 0).sum())
        return n

    @property
    def link_sites(self) -> int:
        n = 0
        if self.dead_links is not None:
            n += int(self.dead_links.sum())
        if self.flaky_links is not None:
            n += int((self.flaky_links > 0).sum())
        return n

    @property
    def total_sites(self) -> int:
        return self.core_sites + self.link_sites

    def summary(self) -> dict:
        d = {"total_sites": self.total_sites,
             "is_blacklist": self.is_blacklist}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                n = int((v != 0).sum())
                if n:
                    d[f.name] = n
        return d


def as_plans(faults) -> Tuple[FaultPlan, ...]:
    """Normalize a ``faults`` argument (None | FaultPlan | sequence of
    either) to the tuple of plans every hook iterates, in application
    order — injection plans first, the blacklist reduction last, so the
    reduction's masks dominate the faults they cover (the exactness
    contract ``tests/test_torch_faults.py`` asserts)."""
    if faults is None:
        return ()
    if isinstance(faults, FaultPlan):
        return (faults,)
    return tuple(p for p in faults if p is not None)


def chain(*overlays):
    """Compose fault overlays into the form the emulation threads:
    ``None`` when nothing is active (the identity program), else the
    flat tuple of plans in application order."""
    plans = tuple(p for o in overlays for p in as_plans(o))
    return plans if plans else None


def sample_fault_plan(n_rows: int, n_cols: int, rng,
                      p_dead_row: float = 0.0, p_dead_neuron: float = 0.0,
                      p_hot_neuron: float = 0.0, p_stuck_w: float = 0.0,
                      p_cadc: float = 0.0, p_store_flip: float = 0.0,
                      n_links: int = 0, p_dead_link: float = 0.0,
                      p_flaky_link: float = 0.0, flaky_drop: float = 0.5,
                      prefix: Sequence[int] = (), cadc_max: int = 255,
                      seed: int = 0) -> FaultPlan:
    """A random defect realisation at the given per-site rates.
    ``rng`` is a ``np.random.Generator``."""
    pr, pc = (*prefix, n_rows), (*prefix, n_cols)
    prc = (*prefix, n_rows, n_cols)

    def mask(shape, p):
        return rng.random(shape) < p if p > 0 else None

    dead_rows = mask(pr, p_dead_row)
    hot = mask(pc, p_hot_neuron)
    dead_n = mask(pc, p_dead_neuron)
    if hot is not None and dead_n is not None:
        dead_n = dead_n & ~hot            # a driver is stuck one way
    sw_mask = mask(prc, p_stuck_w)
    sw_val = (rng.integers(0, WMASK + 1, prc).astype(np.int8)
              if sw_mask is not None else None)
    cm = mask(pc, p_cadc)
    cc = (rng.integers(0, cadc_max + 1, pc).astype(np.int32)
          if cm is not None else None)
    sf_mask = mask(prc, p_store_flip)
    sf = (np.where(sf_mask, 1 << rng.integers(0, WBITS, prc), 0)
          .astype(np.int32) if sf_mask is not None else None)
    dl = mask((n_links,), p_dead_link) if n_links else None
    fl = None
    if n_links and p_flaky_link > 0:
        fl = np.where(rng.random(n_links) < p_flaky_link,
                      np.float32(flaky_drop), np.float32(0.0))
        if dl is not None:
            fl = np.where(dl, np.float32(0.0), fl)
    return FaultPlan(dead_rows=dead_rows, hot_neurons=hot,
                     dead_neurons=dead_n, stuck_w_mask=sw_mask,
                     stuck_w_val=sw_val, cadc_stuck_mask=cm,
                     cadc_stuck_code=cc, cadc_code_offset=None,
                     store_flip=sf, dead_links=dl, flaky_links=fl,
                     seed=seed)


def remap_link_faults(plan: FaultPlan, old_links, new_links) -> FaultPlan:
    """Re-index a plan's link-fault arrays from one topology's link order
    onto another's (pair-identity preserved) — needed when a reroute
    promotes a ring plan to all2all: the dead wire still connects the
    same chip pair, only its link index changed. Pairs absent from the
    new topology drop; new pairs start healthy."""
    if plan.dead_links is None and plan.flaky_links is None:
        return plan
    idx = {sd: l for l, sd in enumerate(old_links)}
    dl = fl = None
    if plan.dead_links is not None:
        dl = np.zeros(len(new_links), bool)
    if plan.flaky_links is not None:
        fl = np.zeros(len(new_links), np.float32)
    for l, sd in enumerate(new_links):
        j = idx.get(sd)
        if j is None:
            continue
        if dl is not None:
            dl[l] = plan.dead_links[j]
        if fl is not None:
            fl[l] = plan.flaky_links[j]
    kw = {f.name: getattr(plan, f.name) for f in fields(plan)}
    kw.update(dead_links=dl, flaky_links=fl)
    return FaultPlan(**kw)


# the chip-plane fields and the rank of one chip's plane
_CHIP_PLANES = (("dead_rows", 1), ("hot_neurons", 1), ("dead_neurons", 1),
                ("stuck_w_mask", 2), ("stuck_w_val", 2),
                ("cadc_stuck_mask", 1), ("cadc_stuck_code", 1),
                ("cadc_code_offset", 1), ("store_flip", 2),
                ("store_zero", 2))


def slice_chips(faults, chips: slice):
    """A fault overlay cut to a block of chips, for the rank of a sharded
    wafer run that holds those chips: every chip plane with a leading
    chip dim ([K, R], [K, C], [K, R, C]) keeps ``[chips]``; a plane of one
    chip's shape applies to every chip and stays; the link faults keep
    every link, indexed absolutely as the router reads them. ``None`` and
    an empty overlay stay as they are."""
    if faults is None:
        return None
    out = []
    for p in as_plans(faults):
        kw = {}
        for name, rank in _CHIP_PLANES:
            v = getattr(p, name)
            if v is None or v.ndim == rank:
                continue
            if v.ndim != rank + 1:
                raise ValueError(f"slice_chips: {name} has shape {v.shape}; "
                                 f"expected a [K, ...] plane of rank "
                                 f"{rank + 1}")
            kw[name] = v[chips]
        out.append(replace(p, **kw) if kw else p)
    return out[0] if isinstance(faults, FaultPlan) else tuple(out)
