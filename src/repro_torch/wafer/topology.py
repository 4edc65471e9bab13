"""Wafer topologies and multi-chip network plans (a copy of
``repro/wafer/topology.py``, held equal to it by
``tests/test_torch_wafer.py``).

The BrainScaleS line scales the single 512-neuron / 130K-synapse chip to
wafers of interconnected chips; spikes cross chip boundaries as address-
tagged records on the inter-chip event bus. This module is the *static*
side of that picture: which chips exist, which links connect them, and
which (source column -> destination row) routes ride on each link. The
dynamic side — moving the actual event records each window — lives in
``repro_torch.wafer.router``.

Everything here is host-side numpy: plans are built and validated once,
then the router turns them into index tensors on its device.

The correctness anchor is ``monolithic_plan``: any K-chip plan maps to an
equivalent 1-chip plan whose synapse matrix is the block-diagonal
embedding of the per-chip matrices and whose routes are the same routes
in global coordinates. Off-block weights are exactly zero, and a zero
6-bit weight contributes an exact-zero term to the per-column sum
(0.0 + x == x for the nonnegative operands involved), so the split and
monolithic emulations are bit-identical.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class WaferTopology:
    """K chips and the directed inter-chip links between them.

    ``kind``:
      "ring"     chip k -> chip (k+1) % K (the neighbor topology the
                 sharded router exchanges point to point); K == 1
                 degenerates to the single self-link.
      "all2all"  every ordered pair INCLUDING self-links (the wafer bus
                 loops back on-chip), exchanged with an all-gather —
                 arbitrary fan-in.

    Args:
      n_chips: K >= 1 logical chips.
      kind: "ring" | "all2all" (see above).

    Contract pointers: link order and transports in
    tests/test_torch_wafer.py and tests/test_torch_wafer_sharded.py.
    """
    n_chips: int
    kind: str = "ring"

    def __post_init__(self):
        assert self.n_chips >= 1
        if self.kind not in ("ring", "all2all"):
            raise ValueError(f"unknown topology kind {self.kind!r}")

    def links(self) -> Tuple[Tuple[int, int], ...]:
        """Directed (src_chip, dst_chip) links, src-major order — the
        link index order every router table uses."""
        k = self.n_chips
        if self.kind == "ring":
            return tuple((s, (s + 1) % k) for s in range(k))
        return tuple((s, d) for s in range(k) for d in range(k))

    @property
    def n_links(self) -> int:
        return len(self.links())

    @property
    def links_per_chip(self) -> int:
        """Out-links per source chip — uniform for both kinds, which is
        what lets the sharded transport slice its local link block by
        device rank."""
        return self.n_links // self.n_chips


@dataclass(frozen=True)
class WaferPlan:
    """A topology plus the route list riding on it.

    Each route forwards spikes of ``(src_chip, src_col)`` to input row
    ``(dst_chip, dst_row)`` where they arrive as events carrying
    ``addr`` — the ``(t, row, addr, efficacy)`` record of the event bus.
    Routes are arrays (not per-pair tables) so arbitrary fan-out/fan-in
    is just more rows in the list.

    FORWARD rules (``fwd_*``, normally empty) are the failover hop
    ``reroute_plan`` emits around a blacklisted link: chip
    ``fwd_src_chip`` re-transmits the events its OWN relay row
    ``fwd_src_row`` received last window over the link to
    ``fwd_dst_chip``, delivering into ``fwd_dst_row`` with ``fwd_addr``.
    Forwarded traffic therefore arrives two windows after the source
    spike (one normal hop + one relay hop) and is counted by the router
    in the ``link_reroutes`` telemetry counter.

    Args:
      topology: the ``WaferTopology`` the routes ride on.
      n_rows / n_cols: per-chip synapse-row / neuron-column geometry.
      src_chip, src_col, dst_chip, dst_row, addr: parallel int32 route
        arrays — spikes of ``(src_chip, src_col)`` become events on
        ``(dst_chip, dst_row)`` carrying ``addr``.
      fwd_*: parallel forward-rule arrays (see above; normally empty).

    Validation (``__post_init__``) rejects out-of-range indices, routes
    over links the topology does not have, duplicate or conflicting
    addresses on one destination row, and forwards reading rows no
    route delivers into — a plan that constructs is executable.

    Contract pointers: tests/test_torch_wafer.py (split == monolithic),
    tests/test_torch_wafer_faults.py (failover).
    """
    topology: WaferTopology
    n_rows: int                       # synapse rows per chip
    n_cols: int                       # neuron columns per chip
    src_chip: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    src_col: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    dst_chip: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    dst_row: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    addr: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    fwd_src_chip: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    fwd_src_row: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    fwd_dst_chip: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    fwd_dst_row: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    fwd_addr: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))

    def __post_init__(self):
        k, r, c = self.topology.n_chips, self.n_rows, self.n_cols
        arrs = (self.src_chip, self.src_col, self.dst_chip, self.dst_row,
                self.addr)
        n = len(self.src_chip)
        assert all(len(a) == n for a in arrs), "ragged route arrays"
        farrs = (self.fwd_src_chip, self.fwd_src_row, self.fwd_dst_chip,
                 self.fwd_dst_row, self.fwd_addr)
        nf = len(self.fwd_src_chip)
        assert all(len(a) == nf for a in farrs), "ragged forward arrays"
        links = set(self.topology.links())
        if n:
            assert (0 <= self.src_chip).all() and (self.src_chip < k).all()
            assert (0 <= self.dst_chip).all() and (self.dst_chip < k).all()
            assert (0 <= self.src_col).all() and (self.src_col < c).all()
            assert (0 <= self.dst_row).all() and (self.dst_row < r).all()
            assert (0 <= self.addr).all() and (self.addr < 64).all(), \
                "event addresses are 6-bit"
            used = set(zip(self.src_chip.tolist(), self.dst_chip.tolist()))
            assert used <= links, \
                f"routes use non-links: {sorted(used - links)}"
        if nf:
            assert (0 <= self.fwd_src_chip).all() \
                and (self.fwd_src_chip < k).all()
            assert (0 <= self.fwd_dst_chip).all() \
                and (self.fwd_dst_chip < k).all()
            assert (0 <= self.fwd_src_row).all() \
                and (self.fwd_src_row < r).all()
            assert (0 <= self.fwd_dst_row).all() \
                and (self.fwd_dst_row < r).all()
            assert (0 <= self.fwd_addr).all() and (self.fwd_addr < 64).all()
            fused = set(zip(self.fwd_src_chip.tolist(),
                            self.fwd_dst_chip.tolist()))
            assert fused <= links, \
                f"forwards use non-links: {sorted(fused - links)}"
            # forwards re-transmit received traffic: the read row must be
            # a route delivery target on the forwarding chip
            rr = np.zeros((k, r), bool)
            if n:
                rr[self.dst_chip, self.dst_row] = True
            assert rr[self.fwd_src_chip, self.fwd_src_row].all(), \
                "forward reads a row no route delivers into"
        if n + nf == 0:
            return
        # a destination row is one physical driver: every delivery landing
        # on it (route or forward) must carry the same event address
        dst_c = np.concatenate([self.dst_chip, self.fwd_dst_chip])
        dst_r = np.concatenate([self.dst_row, self.fwd_dst_row])
        dst_a = np.concatenate([self.addr, self.fwd_addr])
        key = dst_c.astype(np.int64) * r + dst_r
        for g in np.unique(key):
            a = dst_a[key == g]
            assert (a == a[0]).all(), \
                f"conflicting addresses on dst row {divmod(int(g), r)}"

    @property
    def n_routes(self) -> int:
        return len(self.src_chip)

    @property
    def n_forwards(self) -> int:
        return len(self.fwd_src_chip)

    @property
    def n_deliveries(self) -> int:
        return self.n_routes + self.n_forwards

    def relay_rows(self) -> np.ndarray:
        """[K, R] bool — rows some delivery (route or forward) lands in."""
        m = np.zeros((self.topology.n_chips, self.n_rows), bool)
        m[self.dst_chip, self.dst_row] = True
        m[self.fwd_dst_chip, self.fwd_dst_row] = True
        return m

    def dst_addr_grid(self) -> np.ndarray:
        """[K, R] int8 — the (validated-unique) event address each relay
        row receives; 0 on non-relay rows."""
        g = np.zeros((self.topology.n_chips, self.n_rows), np.int8)
        g[self.dst_chip, self.dst_row] = self.addr.astype(np.int8)
        g[self.fwd_dst_chip, self.fwd_dst_row] = self.fwd_addr.astype(np.int8)
        return g


def make_plan(topology: WaferTopology, n_rows: int, n_cols: int,
              routes: Sequence[Tuple[int, int, int, int, int]]) -> WaferPlan:
    """Plan from a route list of (src_chip, src_col, dst_chip, dst_row,
    addr) tuples."""
    a = np.asarray(list(routes), np.int32).reshape(-1, 5)
    return WaferPlan(topology=topology, n_rows=n_rows, n_cols=n_cols,
                     src_chip=a[:, 0], src_col=a[:, 1], dst_chip=a[:, 2],
                     dst_row=a[:, 3], addr=a[:, 4])


def monolithic_plan(plan: WaferPlan) -> WaferPlan:
    """The K-chip plan as ONE big virtual chip: global row/col coordinates
    (chip-block-contiguous: global row = chip * R + row, global col =
    chip * C + col) and every route on the single self-link. Pair with
    ``monolithic_weights`` to build the block-diagonal synapse matrix."""
    assert plan.n_forwards == 0, \
        "monolithic embedding of forward rules is not defined (forwards " \
        "deliver one window late by construction)"
    k, r, c = plan.topology.n_chips, plan.n_rows, plan.n_cols
    return WaferPlan(
        topology=WaferTopology(1, plan.topology.kind),
        n_rows=k * r, n_cols=k * c,
        src_chip=np.zeros(plan.n_routes, np.int32),
        src_col=plan.src_chip * c + plan.src_col,
        dst_chip=np.zeros(plan.n_routes, np.int32),
        dst_row=plan.dst_chip * r + plan.dst_row,
        addr=plan.addr.copy())


def monolithic_weights(per_chip: np.ndarray) -> np.ndarray:
    """[K, R, C] per-chip synapse planes -> [K*R, K*C] block-diagonal
    monolithic plane (off-block entries zero — exact-zero FMA terms, see
    module docstring). Works for weights and addresses alike."""
    k, r, c = per_chip.shape
    out = np.zeros((k * r, k * c), per_chip.dtype)
    for i in range(k):
        out[i * r:(i + 1) * r, i * c:(i + 1) * c] = per_chip[i]
    return out


def s5_column_plan(n_chips: int, n_inputs: int, n_neurons: int,
                   relay: bool = True, kind: str = "all2all") -> WaferPlan:
    """Wafer partition of the §5 pattern-discrimination network: the
    neuron columns split over ``n_chips`` contiguous blocks (all 2I input
    rows replicated per chip — every chip sees the full stimulus).

    With ``relay=True`` every global neuron column is also announced to
    every chip over the bus: spikes of global column j arrive one window
    later on row j % 2I carrying address 63. Address 63 matches no §5
    synapse (the experiment wires address 0 throughout), so the relayed
    events add zero synaptic current but exercise the full router path —
    STP and correlation-sensor state on the relay rows evolve with the
    routed traffic, identically on every chip count. Requires
    ``kind="all2all"`` (self-links included) so all chips, including the
    spike's own, receive the same broadcast.
    """
    r = 2 * n_inputs
    assert n_neurons % n_chips == 0
    c_loc = n_neurons // n_chips
    routes = []
    if relay:
        assert kind == "all2all", "the §5 relay broadcast needs all2all"
        for j in range(n_neurons):
            for d in range(n_chips):
                routes.append((j // c_loc, j % c_loc, d, j % r, 63))
    return make_plan(WaferTopology(n_chips, kind), r, c_loc, routes)


def reroute_plan(plan: WaferPlan, dead_links,
                 relay_addr: int = 63) -> Tuple[WaferPlan, int]:
    """Host-side failover around blacklisted links: every route riding a
    dead ``(src_chip, dst_chip)`` pair is re-established over an
    intermediate chip ``m`` with alive links, preferring REUSE of bus
    traffic ``m`` already receives — if exactly one alive route delivers
    this very ``(src_chip, src_col)`` spike train into relay row ``rho``
    on ``m``, failover is just the forward rule ``(m, rho) -> (dst_chip,
    dst_row)``; otherwise a fresh relay row is allocated on ``m`` (a row
    no delivery touches — external drive on it is the caller's concern)
    and both hops are added. A ring topology with no usable intermediate
    is PROMOTED to all2all (the physical bus connects any pair; the ring
    is a schedule, not a wire list) — the dead pair itself of course
    stays dead. Forwarded events arrive one window later than the direct
    route would have delivered them.

    Returns ``(new_plan, n_rerouted)`` and raises ``ValueError`` when no
    failover exists (K == 2, saturated relay rows, dead detours) —
    degradation is never silent.
    """
    dead = {(int(s), int(d)) for s, d in dead_links}
    if not dead:
        return plan, 0
    assert plan.n_forwards == 0, "reroute_plan expects an unrerouted plan"
    K, R = plan.topology.n_chips, plan.n_rows
    all_routes = list(zip(plan.src_chip.tolist(), plan.src_col.tolist(),
                          plan.dst_chip.tolist(), plan.dst_row.tolist(),
                          plan.addr.tolist()))
    keep = [x for x in all_routes if (x[0], x[2]) not in dead]
    bad = [x for x in all_routes if (x[0], x[2]) in dead]
    if not bad:
        return plan, 0

    def attempt(kind):
        topo = WaferTopology(K, kind)
        alive = set(topo.links()) - dead
        # delivery census over the surviving routes (dead-pair routes are
        # dropped: they deliver nothing)
        n_deliv = np.zeros((K, R), np.int64)
        src_of = {}
        for (s, c, d, row, a) in keep:
            n_deliv[d, row] += 1
            src_of[(d, row)] = (s, c)
        # rows any delivery will touch: kept targets, the bad routes'
        # targets (they become forward targets), plus fresh allocations
        occupied = n_deliv > 0
        for (_, _, d, row, _) in bad:
            occupied[d, row] = True
        bad_targets = {(d, row) for (_, _, d, row, _) in bad}
        new_routes, fwd = list(keep), []
        for (s, c, d, row, a) in bad:
            hit = None
            for (m, rho), sc in src_of.items():
                if (sc == (s, c) and (m, d) in alive
                        and n_deliv[m, rho] == 1
                        and (m, rho) not in bad_targets):
                    hit = (m, rho)
                    break
            if hit is None:
                for m in range(K):
                    if (m in (s, d) or (s, m) not in alive
                            or (m, d) not in alive):
                        continue
                    free = np.nonzero(~occupied[m])[0]
                    if free.size == 0:
                        continue
                    rho = int(free[0])
                    occupied[m, rho] = True
                    n_deliv[m, rho] += 1
                    src_of[(m, rho)] = (s, c)
                    new_routes.append((s, c, m, rho, relay_addr))
                    hit = (m, rho)
                    break
            if hit is None:
                return None
            fwd.append((*hit, d, row, a))
        rt = np.asarray(new_routes, np.int64).reshape(-1, 5)
        fw = np.asarray(fwd, np.int64).reshape(-1, 5)
        return WaferPlan(
            topology=topo, n_rows=R, n_cols=plan.n_cols,
            src_chip=rt[:, 0].astype(np.int32),
            src_col=rt[:, 1].astype(np.int32),
            dst_chip=rt[:, 2].astype(np.int32),
            dst_row=rt[:, 3].astype(np.int32),
            addr=rt[:, 4].astype(np.int32),
            fwd_src_chip=fw[:, 0].astype(np.int32),
            fwd_src_row=fw[:, 1].astype(np.int32),
            fwd_dst_chip=fw[:, 2].astype(np.int32),
            fwd_dst_row=fw[:, 3].astype(np.int32),
            fwd_addr=fw[:, 4].astype(np.int32))

    out = attempt(plan.topology.kind)
    if out is None and plan.topology.kind == "ring":
        out = attempt("all2all")
    if out is None:
        raise ValueError(
            f"no failover for dead links {sorted(dead)}: "
            f"{len(bad)} routes cannot be re-established")
    return out, len(bad)
