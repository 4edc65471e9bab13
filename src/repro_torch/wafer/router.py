"""The inter-chip event router: one window of bus traffic per call
(``repro/wafer/router.py``).

Spikes produced on one chip in window ``t`` become input row events on
connected chips in window ``t+1``: a one-window routing latency, the
hardware's inter-chip bus delay. Per window the router

  1. projects each chip's output spikes onto its out-links' route tables
     (per-link [T, R] delivery grids; several routes landing on the same
     ``(t, dst_row)`` slot merge by ``max``: one physical event per
     driver slot, order-free and exact, so a scatter-max with atomics
     gives the same bits as any order);
  2. applies the link faults (dead links deliver nothing, flaky ones drop
     a hash-selected fraction);
  3. delivers the grids to the destination chips: ``"dense"`` as they
     are, ``"compact"`` as the reference's fixed-capacity event streams
     would carry them (a record survives when its t-major ordinal is
     below the link budget and its rank in its step below the step
     budget, ``events.stream_keep``; the rest is dropped), ``"auto"`` as
     they are. Auto needs no branch: the reference's auto sends the
     compact stream while every link fits and the grids otherwise, and a
     stream that drops nothing unpacks to the grid bit for bit (every
     value is non-negative and lands back on its own slot).
  4. with telemetry, censuses each link against the budgets
     (``events.census_fits``) into ``count_links``: overflow is counted,
     never silent.

Every table is a tensor on the router's device, made once at
construction, and every budget a Python int of the plan, so a routing
step reads nothing from the host and builds nothing from host data: it
runs inside a captured trial or window graph (``core.graph``).

Transports. With no ``group`` the router is local: one process holds
every chip. With a ``torch.distributed`` process group of ``dp`` ranks
(``dp`` dividing K), rank ``r`` holds chips ``[r K/dp, (r+1) K/dp)`` and
their out-links ``[r L/dp, (r+1) L/dp)`` and runs its own ``AnnCore`` on
its chips: the ring moves the one link that crosses to the next rank
point to point (the reference's ``ppermute``), all2all gathers every
rank's link grids (the reference's masked ``all_gather``), and the
per-link census is summed over the ranks (``psum``). Both are bit-equal
to the local transport (``tests/test_torch_wafer_sharded.py``). Like the
reference's collectives inside its ``shard_map``ped scan, these run
inside the captured trial and window graphs (``core.graph``): NCCL
captures the ring's coalesced send / receive pair, the all-gather and
the all-reduce, and every rank replays them in the same order. A graph
that holds them must be freed before its group is destroyed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import events
from repro_torch.core.graph import assign, clones, leaves
from repro_torch.faults import inject as finject
from repro_torch.obs import trace as obs_trace
from repro_torch.wafer.topology import WaferPlan

_LINK_MODES = ("auto", "compact", "dense")


def _per_link_table(n_links, link_of, src, dst, R):
    """Ragged per-link ``(src, dst)`` lists padded to the longest: [L, M]
    int64 gather sources (padding reads 0) and scatter targets (padding
    lands in the dump slot ``R``)."""
    per = [[] for _ in range(n_links)]
    for l, s, d in zip(link_of, src, dst):
        per[l].append((s, d))
    m = max(1, max((len(v) for v in per), default=0))
    s_t = np.zeros((n_links, m), np.int64)
    d_t = np.full((n_links, m), R, np.int64)
    for l, v in enumerate(per):
        for j, (s, d) in enumerate(v):
            s_t[l, j], d_t[l, j] = s, d
    return s_t, d_t


class InterChipRouter:
    """Route tables on a device and the per-window routing step.

    Args:
      plan: a validated ``WaferPlan``.
      device: where the tables live and the router runs (``None`` means
        ``cuda`` and raises without a card).
      link_budget / link_step_budget: the compact transport's per-link
        stream capacity and per-step bandwidth (defaults: the
        density-derived ``events.default_max_events(T, R, 0.05)`` and the
        no-constraint ``R``).
      link_mode: "auto" (default) | "compact" | "dense" (see the module).
      faults: a ``repro_torch.faults`` overlay; its link faults apply to
        the grids (``faults.inject.links``), put on the device here once.
        ``None`` launches nothing for them.
      group: a ``torch.distributed`` process group for the sharded
        transport (see the module); its world size must divide the chip
        count. ``None``: the local transport.

    ``route(out_spikes_t, telemetry=, routed_in=)`` turns [T, K, C]
    spikes (this rank's chips under a group) into the next window's
    [T, K, R] delivery grid, ``merge(routed_ev, ext_ev, ext_addr)``
    folds a delivery grid into the external inputs. A plan with forward
    rules (``reroute_plan`` failover) needs last window's delivered grid
    as ``routed_in``: each forwarding chip re-transmits what its relay
    row received, one window later, counted in ``link_reroutes``.
    """

    def __init__(self, plan: WaferPlan, device=None,
                 link_budget: Optional[int] = None,
                 link_step_budget: Optional[int] = None,
                 link_mode: str = "auto", faults=None, group=None):
        if link_mode not in _LINK_MODES:
            raise ValueError(f"unknown link_mode {link_mode!r}")
        self.plan = plan
        self.device = resolve_device(device)
        self.link_mode = link_mode
        self.link_budget = link_budget
        self.link_step_budget = link_step_budget
        self.group = group
        topo = plan.topology
        self.K, self.R, self.C = topo.n_chips, plan.n_rows, plan.n_cols
        links = topo.links()
        self.L = len(links)
        self.ring = topo.kind == "ring"

        # this process's chips and links: all of them, or a rank's block
        if group is None:
            self.dp, self.rank = 1, 0
        else:
            import torch.distributed as dist
            self.dp = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            if self.K % self.dp:
                raise ValueError(
                    f"the sharded transport needs a group whose size "
                    f"divides the chip count: {self.dp} ranks, {self.K} "
                    f"chips")
        self.K_loc, self.L_loc = self.K // self.dp, self.L // self.dp
        c0, l0 = self.rank * self.K_loc, self.rank * self.L_loc
        self._chips = slice(c0, c0 + self.K_loc)
        lk = slice(l0, l0 + self.L_loc)

        link_id = {sd: l for l, sd in enumerate(links)}
        r_link = [link_id[sd] for sd in zip(plan.src_chip.tolist(),
                                            plan.dst_chip.tolist())]
        f_link = [link_id[sd] for sd in zip(plan.fwd_src_chip.tolist(),
                                            plan.fwd_dst_chip.tolist())]
        src, dst = _per_link_table(self.L, r_link, plan.src_col.tolist(),
                                   plan.dst_row.tolist(), self.R)
        fsrc, fdst = _per_link_table(self.L, f_link,
                                     plan.fwd_src_row.tolist(),
                                     plan.fwd_dst_row.tolist(), self.R)
        # links are src-major with one uniform out-link block per chip, so
        # a rank's links read its own chips only: the source chip of each
        # of its links, in its local numbering
        frm = np.asarray([s for s, _ in links], np.int64)

        def put(x):
            return torch.as_tensor(np.ascontiguousarray(x),
                                   device=self.device)
        self.link_src, self.link_dst = put(src[lk]), put(dst[lk])
        self.fwd_src, self.fwd_dst = put(fsrc[lk]), put(fdst[lk])
        self.link_from = put(frm[lk] - c0)
        self.link_to = put(np.asarray([d for _, d in links], np.int64))
        self.link_ids = put(np.arange(self.L, dtype=np.int64)[lk])
        # receiver-side address plane for merge(): this process's chips
        self.dst_addr = put(plan.dst_addr_grid()[self._chips])   # int8
        self.faults = finject.on_device(faults, self.device)

    # -- static helpers ------------------------------------------------------
    def _budgets(self, T: int) -> Tuple[int, int]:
        b = self.link_budget
        if b is None:
            b = events.default_max_events(T, self.R, 0.05)
        s = self.link_step_budget
        if s is None:
            s = self.R
        return b, min(s, self.R)

    def init_buffer(self, T: int) -> torch.Tensor:
        """The routed-event carry: the [T, K, R] delivery grid of this
        process's chips (what last window's spikes deposit for this one).
        Starts silent."""
        return torch.zeros((T, self.K_loc, self.R), dtype=torch.float32,
                           device=self.device)

    def _link_grids(self, src_l, idx_src, idx_dst):
        """[T, Lx, S] per-link sources (spike columns, or the rows of a
        delivered grid) -> [T, Lx, R] delivery grids: gather the routes'
        sources, scatter-max them onto their rows (padding into the dump
        slot ``R``, cut off after)."""
        T, Lx = src_l.shape[0], src_l.shape[1]
        M = idx_src.shape[1]
        vals = torch.gather(src_l, 2, idx_src.unsqueeze(0).expand(T, Lx, M))
        out = torch.zeros((T, Lx, self.R + 1), dtype=torch.float32,
                          device=src_l.device)
        out.scatter_reduce_(2, idx_dst.unsqueeze(0).expand(T, Lx, M), vals,
                            "amax")
        return out[..., :self.R]

    @staticmethod
    def _census(grids):
        """[T, Lx, R] -> per-link (event count, worst per-step count),
        int32."""
        per_step = (grids != 0.0).sum(-1, dtype=torch.int32)   # [T, Lx]
        return per_step.sum(0, dtype=torch.int32), per_step.max(0).values

    def _grids(self, out, routed_in):
        """This process's link grids with forwards merged in and the link
        faults applied, and the forwards' grids (``None`` without
        forwards)."""
        grids = self._link_grids(out.index_select(1, self.link_from),
                                 self.link_src, self.link_dst)
        fgrids = None
        if routed_in is not None:
            # failover hops re-transmit what the relay rows received last
            # window; merged before the census, so the bus budget covers
            # the rerouted traffic too
            fgrids = self._link_grids(routed_in.index_select(1,
                                                             self.link_from),
                                      self.fwd_src, self.fwd_dst)
            grids = torch.maximum(grids, fgrids)
        return finject.links(self.faults, grids, self.link_ids), fgrids

    def _all_links(self, x):
        """A per-link vector of this process's links -> the [L] vector of
        every link (zero-padded, summed over the ranks)."""
        if self.group is None:
            return x
        import torch.distributed as dist
        full = torch.zeros((*x.shape[:-1], self.L), dtype=x.dtype,
                           device=x.device)
        full[..., self.link_ids] = x
        dist.all_reduce(full, group=self.group)
        return full

    def _deliver(self, delivered):
        """[T, L_loc, R] delivered link grids -> [T, K_loc, R] grid of this
        process's chips: a scatter-max onto the links' destinations."""
        T = delivered.shape[0]
        if self.group is not None:
            import torch.distributed as dist
            if self.ring and self.dp > 1:
                # ring fan-in is 1: chip j's in-link is link j - 1, and only
                # the first chip's lies on the previous rank
                nxt = dist.get_global_rank(self.group,
                                           (self.rank + 1) % self.dp)
                prv = dist.get_global_rank(self.group,
                                           (self.rank - 1) % self.dp)
                send = delivered[:, -1].contiguous()
                recv = torch.empty_like(send)
                for req in dist.batch_isend_irecv(
                        [dist.P2POp(dist.isend, send, nxt, self.group),
                         dist.P2POp(dist.irecv, recv, prv, self.group)]):
                    req.wait()
                return torch.cat([recv.unsqueeze(1), delivered[:, :-1]], 1)
            if not self.ring:
                parts = torch.empty((self.dp * T, self.L_loc, self.R),
                                    dtype=delivered.dtype,
                                    device=delivered.device)
                dist.all_gather_into_tensor(parts, delivered.contiguous(),
                                            group=self.group)
                delivered = parts.view(self.dp, T, self.L_loc, self.R
                                       ).transpose(0, 1).reshape(
                                           T, self.L, self.R)
        routed = torch.zeros((T, self.K, self.R), dtype=torch.float32,
                             device=delivered.device)
        routed.scatter_reduce_(
            1, self.link_to.view(1, -1, 1).expand(T, self.L, self.R),
            delivered, "amax")
        return routed[:, self._chips] if self.dp > 1 else routed

    # -- public API ----------------------------------------------------------
    def route(self, out_spikes_t, telemetry=None, routed_in=None):
        """[T, K, C] window output spikes -> ([T, K, R] delivery grid for
        the NEXT window, updated telemetry). ``routed_in`` (last window's
        delivered grid) feeds the plan's forward rules: required for
        failover plans, ignored when the plan has none."""
        T = out_spikes_t.shape[0]
        budget, step_budget = self._budgets(T)
        if self.plan.n_forwards == 0:
            routed_in = None
        elif routed_in is None:
            raise ValueError("this plan has forward rules: route() needs "
                             "routed_in (last window's delivered grid)")
        grids, fgrids = self._grids(out_spikes_t, routed_in)
        delivered = grids
        if self.link_mode == "compact":
            keep, _ = events.stream_keep(
                (grids != 0.0).transpose(0, 1), budget, step_budget)
            delivered = grids.masked_fill(~keep.transpose(0, 1), 0.0)
        routed = self._deliver(delivered)
        if telemetry is not None:
            n, k_max = self._all_links(torch.stack(self._census(grids)))
            telemetry = obs_trace.count_links(
                telemetry, n, events.census_fits(n, k_max, budget,
                                                 step_budget))
            if fgrids is not None:
                n_f = self._all_links(self._census(fgrids)[0])
                telemetry = obs_trace.count_reroutes(telemetry, n_f.sum())
            telemetry = obs_trace.count_faults(telemetry, self.faults)
        return routed, telemetry

    def link_census(self, out_spikes_t):
        """[L] delivered-event counts per link for one window of spikes:
        the screening probe's observable. Includes the link faults (what
        the bus delivers), excludes forwards and the budgets."""
        grids, _ = self._grids(out_spikes_t, None)
        return self._all_links(self._census(grids)[0])

    def merge(self, routed_ev, ext_ev, ext_addr):
        """Deliver last window's routed grid into this window's inputs.

        Events merge by ``max`` (a routed and an external event on the
        same (t, row) slot are one driver event); on slots where a routed
        event lands, the row's route address wins over the external one
        (int8, as ``AnnCore.run`` compares addresses): the same on every
        chip count, which split == monolithic needs."""
        if self.plan.n_deliveries == 0:
            return ext_ev, ext_addr
        ev = torch.maximum(ext_ev, routed_ev)
        addr = torch.where(routed_ev > 0.0, self.dst_addr,
                           ext_addr.to(torch.int8))
        return ev, addr


def run_windows(core, router: InterChipRouter, state, ev_w, ad_w,
                telemetry=None):
    """W routed windows: ``ev_w`` / ``ad_w`` are [W, T, K, R] external
    inputs; each window's spikes are routed into the next window's inputs
    (one-window latency). A Python loop of eager windows (``WindowLoop``
    runs the same windows through tensors of its own, which a CUDA graph
    can capture). Returns ``(state, dict(spikes=[W, T, K, C], routed=last
    grid, telemetry=...))``."""
    routed = router.init_buffer(ev_w.shape[1])
    spikes = []
    for w in range(ev_w.shape[0]):
        state, out = core.run_routed(state, routed, ev_w[w], ad_w[w], router,
                                     telemetry=telemetry)
        routed, telemetry = out["routed"], out.get("telemetry")
        spikes.append(out["spikes"])
    return state, dict(spikes=torch.stack(spikes), routed=routed,
                       telemetry=telemetry)


class WindowLoop:
    """``run_windows`` as a loop of one body with no host work in it (the
    reference's ``lax.scan`` over the windows; the window counterpart of
    ``core.hybrid.TrialLoop``).

    ``body()`` runs the window at the loop's step counter, a tensor on the
    device: it reads that window's inputs from the loop's own [W, T, K, R]
    copies of ``ev_w`` / ``ad_w``, runs ``core.run_routed`` on the loop's
    state, routed grid and telemetry counters, writes the window's spikes
    into a [W, T, K, C] buffer at the counter, copies the new state, grid
    and counters into the loop's tensors (``graph.assign``) and advances
    the counter. Nothing in it reads the host or builds a tensor from host
    data, so a CUDA graph can capture it (``graph.LoopGraph``).

    With ``telemetry=None`` and a core built with telemetry on, the loop
    makes fresh counters here (the core's lazy init would allocate inside
    the body); the counters span all W windows. The spike buffer is
    allocated by the first ``body()``."""

    def __init__(self, core, router: InterChipRouter, state, ev_w, ad_w,
                 telemetry=None):
        if ev_w.shape[0] == 0:
            raise ValueError("WindowLoop: no windows to run")
        dev = ev_w.device
        self.core, self.router = core, router
        self.n = ev_w.shape[0]
        self.ev_w = ev_w.clone(memory_format=torch.contiguous_format)
        self.ad_w = ad_w.clone(memory_format=torch.contiguous_format)
        self.initial, self.tele_initial = state, telemetry
        self.state = clones(state)
        self.routed = router.init_buffer(ev_w.shape[1])
        self.tele = None
        if telemetry is not None:
            self.tele = clones(telemetry)
        elif core.telemetry:
            self.tele = obs_trace.init_telemetry(dev)
        self.step = torch.zeros(1, dtype=torch.int64, device=dev)
        self.spikes = None

    def _carry(self):
        return leaves(self.state) + [self.routed] + leaves(self.tele)

    def body(self):
        i = self.step
        new, out = self.core.run_routed(
            self.state, self.routed, self.ev_w.index_select(0, i)[0],
            self.ad_w.index_select(0, i)[0], self.router,
            telemetry=self.tele)
        spk = out["spikes"]
        if self.spikes is None:
            self.spikes = spk.new_empty((self.n, *spk.shape))
        self.spikes.index_copy_(0, i, spk.unsqueeze(0))
        assign(self._carry(), leaves(new) + [out["routed"]]
               + leaves(out.get("telemetry")), "WindowLoop")
        self.step += 1

    def reset(self):
        """The state and counters back to the given ones, the routed grid
        silent, the counter to 0."""
        for d, s in zip(leaves(self.state), leaves(self.initial)):
            d.copy_(s)
        self.routed.zero_()
        if self.tele_initial is None:
            for d in leaves(self.tele):
                d.zero_()
        else:
            for d, s in zip(leaves(self.tele), leaves(self.tele_initial)):
                d.copy_(s)
        self.step.zero_()

    def load(self, state, ev_w, ad_w, telemetry=None):
        """Another run of as many windows through the same tensors:
        ``state`` and ``telemetry`` become the given ones, ``ev_w`` and
        ``ad_w`` (the same shapes) are copied into the loop's, and the
        loop is reset."""
        if len(leaves(state)) != len(leaves(self.state)):
            raise ValueError("WindowLoop.load: the state has other fields")
        if (telemetry is not None or self.core.telemetry) != (
                self.tele is not None):
            raise ValueError("WindowLoop.load: telemetry on where the loop "
                             "has it off, or off where it has it on")
        self.initial, self.tele_initial = state, telemetry
        self.ev_w.copy_(ev_w)
        self.ad_w.copy_(ad_w)
        self.reset()

    def result(self):
        """``(state, dict(spikes=[W, T, K, C], routed=last grid,
        telemetry=...))`` as ``run_windows`` returns them, cloned from the
        loop's tensors."""
        return clones(self.state), dict(
            spikes=self.spikes.clone(), routed=self.routed.clone(),
            telemetry=None if self.tele is None else clones(self.tele))
