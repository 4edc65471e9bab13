"""The mapper proper: compile a ``NetworkSpec`` onto K logical chips.
(A copy of ``repro/mapper/mapping.py``, held equal to it by
``tests/test_torch_mapper.py``.)


``map_network`` turns the declarative graph into physical resources:

  columns   ``partition_columns`` tiles neurons onto chips (defect-aware
            via a ``Blacklist``, balanced over usable capacity);
  rows      every (source, chip, sign) with nonzero local fan-in gets a
            driver row — even rows excitatory, odd rows inhibitory (the
            silicon's Dale pairing, ``AnnCore.step``) — allocated in
            ascending canonical source order so the per-column FMA
            chains of every chip are subsequences of the monolithic
            chain (the bit-exactness argument, ``docs/exactness.md``);
  addresses each allocated row gets a 6-bit address from the per-chip
            schedule (allocation ordinal mod 64) stored across the whole
            row — one address per driver row, which is exactly the
            ``const_addr`` promise the fused synaptic path exploits;
  routes    recurrent sources announce their spikes over the inter-chip
            bus: one ``WaferPlan`` route per (source, destination row).
            A destination the topology does not link directly is reached
            through a RELAY hop — a transit row on an intermediate chip
            plus a ``fwd_*`` forward rule — at the cost of one
            extra window of latency (relayed edges are therefore
            excluded from the cross-K bit-equality contract; the mapper
            reports them in ``n_relayed_edges``).

The result is a validated ``ChipMapping``: per-chip weight/address
planes, the ``WaferPlan``, and the placement tables the runtime
(``repro_torch.mapper.runtime``) uses to place inputs and gather spikes.
``map_network`` finishes by RECONSTRUCTING the signed connectivity from
the physical planes and asserting it equals the spec — mapping bugs are
never silent.

Contract tests: ``tests/test_torch_mapper.py`` (mapping invariants,
round trip vs the monolithic emulation).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.mapper.partition import (CapacityError,
                                          ColumnPartition, partition_columns)
from repro_torch.mapper.spec import NetworkSpec
from repro_torch.wafer.topology import WaferPlan, WaferTopology


@dataclass(frozen=True)
class ChipMapping:
    """A compiled placement of one ``NetworkSpec`` on K chips.

    Attributes:
      spec: the mapped network.
      part: neuron -> (chip, column) assignment.
      row_source: ``[K, R]`` int32 — canonical source id driving each
        row, -1 for unused rows.
      row_sign: ``[K, R]`` int8 — +1 excitatory driver, -1 inhibitory,
        0 unused or pure transit (relay) row.
      row_addr: ``[K, R]`` int8 — the 6-bit address schedule (valid on
        allocated rows).
      weights: ``[K, R, C]`` int8 — unsigned per-chip synapse planes.
      addresses: ``[K, R, C]`` int8 — per-chip stored address planes
        (each allocated row holds its schedule address in every column).
      plan: the validated ``WaferPlan`` (routes + forward rules).
      n_relayed_edges: spec edges delivered through a relay hop (one
        window of EXTRA latency — excluded from cross-K bit-equality).
      n_transit_rows: rows allocated purely to relay traffic.

    Contract test: ``tests/test_torch_mapper.py``.
    """
    spec: NetworkSpec
    part: ColumnPartition
    row_source: np.ndarray
    row_sign: np.ndarray
    row_addr: np.ndarray
    weights: np.ndarray
    addresses: np.ndarray
    plan: WaferPlan
    n_relayed_edges: int = 0
    n_transit_rows: int = 0

    @property
    def n_chips(self) -> int:
        return self.part.n_chips

    @property
    def chip_rows(self) -> int:
        return self.plan.n_rows

    @property
    def chip_cols(self) -> int:
        return self.part.chip_cols

    def input_rows(self):
        """[(chip, row, input_source)] — where external input events are
        placed by ``repro_torch.mapper.runtime.place_inputs``."""
        out = []
        ks, rs = np.nonzero((self.row_source >= 0)
                            & (self.row_source < self.spec.n_in))
        for k, r in zip(ks.tolist(), rs.tolist()):
            out.append((k, r, int(self.row_source[k, r])))
        return out

    def rows_used(self) -> np.ndarray:
        """[K] allocated driver rows per chip (incl. transit rows)."""
        return (self.row_source >= 0).sum(axis=1)

    def reconstruct(self) -> np.ndarray:
        """Signed ``[n_sources, n_neurons]`` connectivity read back from
        the physical planes — must equal ``spec.w_full()`` exactly."""
        w = np.zeros((self.spec.n_sources, self.spec.n_neurons), np.int64)
        for k in range(self.n_chips):
            neurons = self.part.chip_neurons(k)
            slots = self.part.col_slot[neurons]
            for r in np.nonzero(self.row_sign[k] != 0)[0]:
                s = int(self.row_source[k, r])
                w[s, neurons] += (int(self.row_sign[k, r])
                                  * self.weights[k, r, slots].astype(np.int64))
        return w

    def validate(self):
        """Re-assert every mapping invariant (the hypothesis suite calls
        this on random specs). Raises AssertionError on violation."""
        K, R, C = self.n_chips, self.chip_rows, self.chip_cols
        assert self.row_source.shape == (K, R)
        assert self.weights.shape == (K, R, C)
        used = self.row_source >= 0
        # Dale pairing: excitatory drivers on even rows, inhibitory on odd
        rows = np.arange(R)[None, :]
        assert (self.row_sign[~used] == 0).all()
        assert not ((self.row_sign == 1) & (rows % 2 == 1)).any()
        assert not ((self.row_sign == -1) & (rows % 2 == 0)).any()
        # unused rows are silent in every plane
        assert (self.weights[~used] == 0).all()
        assert (self.addresses[~used] == 0).all()
        # allocated rows store their schedule address in every column
        for k, r in zip(*np.nonzero(used)):
            assert (self.addresses[k, r] == self.row_addr[k, r]).all()
        # ascending source order within each parity class (the FMA-order
        # invariant behind the bit-exactness contract); pure transit rows
        # are exempt — their weights are zero, so their FMA terms are
        # exact zeros wherever they sit
        for k in range(K):
            for par in (0, 1):
                src = self.row_source[k, par::2]
                sgn = self.row_sign[k, par::2]
                src = src[(src >= 0) & (sgn != 0)]
                assert (np.diff(src) > 0).all(), \
                    f"chip {k} parity {par}: rows out of source order"
        # routed deliveries carry the destination row's schedule address
        pl = self.plan
        assert (self.row_addr[pl.dst_chip, pl.dst_row]
                == pl.addr.astype(np.int8)).all()
        if pl.n_forwards:
            assert (self.row_addr[pl.fwd_dst_chip, pl.fwd_dst_row]
                    == pl.fwd_addr.astype(np.int8)).all()
        # the physical planes realise exactly the spec connectivity
        np.testing.assert_array_equal(self.reconstruct(),
                                      self.spec.w_full())


def row_demand(spec: NetworkSpec, part: ColumnPartition) -> np.ndarray:
    """[K, 2] driver rows each chip needs per parity class (excitatory,
    inhibitory; before transit rows): one row per (source, sign) with
    nonzero fan-in to the chip's neurons."""
    w = spec.w_full()
    demand = np.zeros((part.n_chips, 2), np.int64)
    for k in range(part.n_chips):
        wloc = w[:, part.chip_neurons(k)]
        demand[k, 0] = (wloc > 0).any(axis=1).sum()
        demand[k, 1] = (wloc < 0).any(axis=1).sum()
    return demand


def map_network(spec: NetworkSpec, n_chips: int, chip_rows: int = 256,
                chip_cols: int = 512, topology: str = "all2all",
                blacklist=None) -> ChipMapping:
    """Compile ``spec`` onto ``n_chips`` chips of ``chip_rows`` x
    ``chip_cols``.

    Args:
      spec: the network (any size; capacity is checked, never truncated).
      n_chips: K logical chips (K == 1 is the monolithic reference the
        exactness contract compares against — same machinery, one chip).
      chip_rows / chip_cols: per-chip synapse-array geometry (the native
        BSS-2 fabric is 256 x 512). ``chip_rows`` must be even (Dale
        row pairing).
      topology: "all2all" (default — any pair linked, every edge direct)
        or "ring" (only k -> k+1 linked; unlinked destinations go
        through a relay hop when an intermediate chip has both links,
        else ``CapacityError``).
      blacklist: optional ``repro_torch.faults.Blacklist`` — screened-out
        rows and neuron columns are avoided by placement (defect-aware
        mapping) and blacklisted links are treated as absent (edges
        re-homed through relays). The mapped network is the IDEAL
        network on the surviving fabric: bit-identical to the clean
        monolithic emulation (``tests/test_torch_mapper.py``).

    Returns: a validated ``ChipMapping``.

    Raises:
      CapacityError: columns, rows, or links do not suffice — with the
        chip and demand/capacity named. Degradation is never silent.
    """
    assert chip_rows % 2 == 0, "Dale pairing needs an even row count"
    K, R, C = n_chips, chip_rows, chip_cols
    bad_rows = np.zeros((K, R), bool)
    bad_neurons = np.zeros((K, C), bool)
    dead_links = set()
    if blacklist is not None:
        if blacklist.rows is not None:
            bad_rows = np.asarray(blacklist.rows, bool)
            assert bad_rows.shape == (K, R), \
                f"blacklist rows shape {bad_rows.shape} != {(K, R)}"
        if blacklist.neurons is not None:
            bad_neurons = np.asarray(blacklist.neurons, bool)
            assert bad_neurons.shape == (K, C), \
                f"blacklist neurons shape {bad_neurons.shape} != {(K, C)}"
        dead_links = {(int(s), int(d)) for s, d in (blacklist.links or ())}

    part = partition_columns(spec.n_neurons, K, C, bad_neurons)
    topo = WaferTopology(K, topology)
    links = set(topo.links()) - dead_links

    w = spec.w_full()
    row_source = np.full((K, R), -1, np.int32)
    row_sign = np.zeros((K, R), np.int8)
    row_addr = np.zeros((K, R), np.int8)
    weights = np.zeros((K, R, C), np.int8)
    addresses = np.zeros((K, R, C), np.int8)

    free_e = [deque(r for r in range(0, R, 2) if not bad_rows[k, r])
              for k in range(K)]
    free_i = [deque(r for r in range(1, R, 2) if not bad_rows[k, r])
              for k in range(K)]
    n_alloc = [0] * K
    # (chip, source) -> {sign: row}; sign 0 holds a pure transit row
    rows_of = [dict() for _ in range(K)]

    def alloc(k, s, sign, free):
        if not free[k]:
            kind = {1: "excitatory", -1: "inhibitory", 0: "transit"}[sign]
            raise CapacityError(
                f"chip {k}: out of {kind} driver rows at source {s} "
                f"(R={R}, {int(bad_rows[k].sum())} blacklisted, "
                f"{n_alloc[k]} allocated)")
        r = free[k].popleft()
        row_source[k, r] = s
        row_sign[k, r] = sign
        a = n_alloc[k] % 64
        row_addr[k, r] = a
        addresses[k, r, :] = a
        n_alloc[k] += 1
        rows_of[k].setdefault(s, {})[sign] = r
        return r

    # -- driver-row allocation: ascending source order per chip ------------
    for k in range(K):
        neurons = part.chip_neurons(k)
        slots = part.col_slot[neurons]
        wloc = w[:, neurons]                               # [S, n_loc]
        need_e = (wloc > 0).any(axis=1)
        need_i = (wloc < 0).any(axis=1)
        for s in np.nonzero(need_e | need_i)[0].tolist():
            if need_e[s]:
                r = alloc(k, s, 1, free_e)
                weights[k, r, slots] = np.maximum(wloc[s], 0)
            if need_i[s]:
                r = alloc(k, s, -1, free_i)
                weights[k, r, slots] = np.maximum(-wloc[s], 0)

    # -- routes: recurrent sources announce spikes over the bus ------------
    routes = []     # (src_chip, src_col, dst_chip, dst_row, addr)
    fwds = []       # (fwd_src_chip, fwd_src_row, dst_chip, dst_row, addr)
    routed = set()  # (src_chip, src_col, dst_chip, dst_row) de-dup
    n_relayed = 0
    n_transit = 0

    def relay_row(s, sc, scol, m):
        """A row on intermediate chip ``m`` that receives source ``s``'s
        spikes (reusing an existing driver row when ``m`` already has
        local fan-in from ``s``, else allocating a transit row)."""
        nonlocal n_transit
        have = rows_of[m].get(s, {})
        for sign in (1, -1, 0):
            if sign in have:
                return have[sign]
        r = alloc(m, s, 0, free_e if free_e[m] else free_i)
        n_transit += 1
        return r

    for j in range(spec.n_neurons):
        s = spec.n_in + j
        sc = int(part.col_chip[j])
        scol = int(part.col_slot[j])
        for d in range(K):
            targets = [(sgn, r) for sgn, r in rows_of[d].get(s, {}).items()
                       if sgn != 0]
            if not targets:
                continue
            if (sc, d) in links:
                for _, r in targets:
                    key = (sc, scol, d, r)
                    if key not in routed:
                        routed.add(key)
                        routes.append((sc, scol, d, r, int(row_addr[d, r])))
                continue
            # relay hop: an intermediate chip with both links alive
            mids = [m for m in range(K)
                    if m != sc and (sc, m) in links and (m, d) in links]
            if not mids:
                raise CapacityError(
                    f"edge neuron {j} (chip {sc}) -> chip {d} has no "
                    f"{topology} link and no relay path"
                    + ("" if topology == "all2all"
                       else "; use topology='all2all'"))
            m = mids[0]
            rt = relay_row(s, sc, scol, m)
            key = (sc, scol, m, rt)
            if key not in routed:
                routed.add(key)
                routes.append((sc, scol, m, rt, int(row_addr[m, rt])))
            for _, r in targets:
                fwds.append((m, rt, d, r, int(row_addr[d, r])))
                n_relayed += 1

    rt = np.asarray(routes, np.int32).reshape(-1, 5)
    fw = np.asarray(fwds, np.int32).reshape(-1, 5)
    plan = WaferPlan(
        topology=topo, n_rows=R, n_cols=C,
        src_chip=rt[:, 0], src_col=rt[:, 1], dst_chip=rt[:, 2],
        dst_row=rt[:, 3], addr=rt[:, 4],
        fwd_src_chip=fw[:, 0], fwd_src_row=fw[:, 1], fwd_dst_chip=fw[:, 2],
        fwd_dst_row=fw[:, 3], fwd_addr=fw[:, 4])

    mapping = ChipMapping(
        spec=spec, part=part, row_source=row_source, row_sign=row_sign,
        row_addr=row_addr, weights=weights, addresses=addresses, plan=plan,
        n_relayed_edges=n_relayed, n_transit_rows=n_transit)
    mapping.validate()
    return mapping


def min_chip_rows(spec: NetworkSpec, n_chips: int, chip_cols: int = 512,
                  blacklist=None) -> int:
    """Smallest even ``chip_rows`` that fits ``spec`` on ``n_chips``
    (before transit rows and row blacklists) — a sizing aid for the
    monolithic reference and the examples."""
    bad_neurons = None
    if blacklist is not None and blacklist.neurons is not None:
        bad_neurons = blacklist.neurons
    part = partition_columns(spec.n_neurons, n_chips, chip_cols, bad_neurons)
    d = int(row_demand(spec, part).max(initial=0))
    return max(2, 2 * d)
