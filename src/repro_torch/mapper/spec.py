"""Declarative network descriptions for the automatic chip mapper.
(A copy of ``repro/mapper/spec.py``, held equal to it by
``tests/test_torch_mapper.py``.)


A ``NetworkSpec`` is the host-side, hardware-agnostic statement of WHAT
to emulate: ``n_in`` external input channels and ``n_neurons`` neurons,
connected by signed integer weights in the 6-bit range the synapse
circuit can store (|w| <= 63).  It says nothing about chips, rows,
columns, addresses, or links — that is the mapper's job
(``repro_torch.mapper.mapping.map_network``).

Sources
-------
Rows of the synapse array are driven by *sources*.  The spec numbers
them canonically:

  source s in [0, n_in)                 external input channel s
  source s in [n_in, n_in + n_neurons)  neuron s - n_in (recurrence)

This canonical order is load-bearing: the mapper allocates driver rows
in ascending source order on every chip, which keeps the per-column FMA
chains of the partitioned and monolithic emulations term-for-term
aligned — the root of the bit-exactness contract (see
``docs/exactness.md`` and ``tests/test_torch_mapper.py``).

Sign structure
--------------
The silicon stores unsigned 6-bit weights; sign comes from Dale row
pairing (even driver rows are excitatory, odd rows inhibitory — see
``repro_torch.core.anncore.AnnCore.step``).  A spec therefore admits arbitrary
per-edge signs: a source whose fan-out onto one chip mixes signs simply
costs that chip two driver rows instead of one.  ``dale_signs`` reports
which sources are single-signed (true Dale sources) — networks built
from those map 1 row per (source, chip).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

WMAX = 63  # 6-bit synapse weight magnitude


@dataclass(frozen=True)
class NetworkSpec:
    """An arbitrary-topology network at the spec level.

    Args:
      n_in: external input channels (events enter here).
      n_neurons: neurons; their spikes may feed back through ``w_rec``.
      w_in: ``[n_in, n_neurons]`` int, signed weights in [-63, 63];
        input i -> neuron j.
      w_rec: ``[n_neurons, n_neurons]`` int, signed recurrent weights;
        neuron i -> neuron j.  Defaults to no recurrence.  Recurrent
        edges are delivered over the (emulated) inter-chip event bus and
        therefore arrive ONE WINDOW after the spike that caused them —
        on every chip count, including the single-chip monolithic
        execution, which is what makes partitioning exact (see
        ``docs/mapper.md``).

    Contract test: ``tests/test_torch_mapper.py``.
    """
    n_in: int
    n_neurons: int
    w_in: np.ndarray
    w_rec: Optional[np.ndarray] = None
    name: str = "net"

    def __post_init__(self):
        assert self.n_in >= 0 and self.n_neurons >= 1
        w_in = np.asarray(self.w_in)
        assert w_in.shape == (self.n_in, self.n_neurons), \
            f"w_in shape {w_in.shape} != {(self.n_in, self.n_neurons)}"
        w_rec = (np.zeros((self.n_neurons, self.n_neurons), np.int32)
                 if self.w_rec is None else np.asarray(self.w_rec))
        assert w_rec.shape == (self.n_neurons, self.n_neurons), \
            f"w_rec shape {w_rec.shape} != 2x{self.n_neurons}"
        for nm, w in (("w_in", w_in), ("w_rec", w_rec)):
            assert np.issubdtype(w.dtype, np.integer), \
                f"{nm} must be integer (6-bit synapse weights)"
            assert np.abs(w).max(initial=0) <= WMAX, \
                f"{nm} exceeds the 6-bit magnitude {WMAX}"
        object.__setattr__(self, "w_in", w_in.astype(np.int32))
        object.__setattr__(self, "w_rec", w_rec.astype(np.int32))

    # -- canonical source numbering ---------------------------------------
    @property
    def n_sources(self) -> int:
        return self.n_in + self.n_neurons

    def w_full(self) -> np.ndarray:
        """[n_sources, n_neurons] signed weights in canonical source
        order (inputs first, then neurons)."""
        return np.concatenate([self.w_in, self.w_rec], axis=0)

    def source_is_input(self, s: int) -> bool:
        return s < self.n_in

    # -- structure queries --------------------------------------------------
    def dale_signs(self) -> np.ndarray:
        """[n_sources] int8: +1 purely excitatory, -1 purely inhibitory,
        0 mixed-sign (costs two driver rows per chip it reaches)."""
        w = self.w_full()
        has_p = (w > 0).any(axis=1)
        has_n = (w < 0).any(axis=1)
        return np.where(has_p & ~has_n, 1,
                        np.where(has_n & ~has_p, -1, 0)).astype(np.int8)

    def fan_in(self) -> np.ndarray:
        """[n_neurons] number of nonzero incoming edges per neuron."""
        return (self.w_full() != 0).sum(axis=0)

    def fan_out(self) -> np.ndarray:
        """[n_sources] number of nonzero outgoing edges per source."""
        return (self.w_full() != 0).sum(axis=1)

    @property
    def n_edges(self) -> int:
        return int((self.w_full() != 0).sum())


def random_spec(rng: np.random.Generator, n_in: int, n_neurons: int,
                fan_out: int = 4, rec_fan_out: int = 0,
                p_inh: float = 0.3, dale: bool = True,
                rec_mask: Optional[np.ndarray] = None,
                name: str = "random") -> NetworkSpec:
    """Random bounded-fan-out network for tests and benches.

    Args:
      rng: host RNG (the spec is host data; reproducible by seed).
      fan_out: nonzero targets per external input.
      rec_fan_out: nonzero targets per neuron (0 = feed-forward).
      p_inh: fraction of inhibitory sources (``dale=True``) or of
        inhibitory edges (``dale=False`` — mixed-sign sources appear).
      rec_mask: optional ``[n_neurons, n_neurons]`` bool of ALLOWED
        recurrent edges (e.g. a ring-adjacency block structure so the
        spec maps onto a ring topology — see ``docs/mapper.md``).

    Returns: a validated ``NetworkSpec``.
    """
    def draw(n_src, w, k, allowed=None):
        for i in range(n_src):
            cols = (np.nonzero(allowed[i])[0] if allowed is not None
                    else np.arange(n_neurons))
            if cols.size == 0 or k == 0:
                continue
            pick = rng.choice(cols, size=min(k, cols.size), replace=False)
            mag = rng.integers(1, WMAX + 1, size=pick.size)
            if dale:
                sign = -1 if rng.random() < p_inh else 1
                w[i, pick] = sign * mag
            else:
                sign = np.where(rng.random(pick.size) < p_inh, -1, 1)
                w[i, pick] = sign * mag

    w_in = np.zeros((n_in, n_neurons), np.int32)
    draw(n_in, w_in, fan_out)
    w_rec = np.zeros((n_neurons, n_neurons), np.int32)
    if rec_fan_out:
        draw(n_neurons, w_rec, rec_fan_out, allowed=rec_mask)
    return NetworkSpec(n_in=n_in, n_neurons=n_neurons, w_in=w_in,
                       w_rec=w_rec, name=name)
