"""Run a mapped network: K-invariant instances, input placement, spike
gathering, and the routed windows (``repro/mapper/runtime.py``).

The cross-K bit-exactness contract (mapped K chips ==
``assert_array_equal`` == the K=1 monolithic mapping) needs every
physical quantity that enters the dynamics to be a *pure function of the
spec*, scattered, not resampled, onto whatever chip layout the mapper
chose:

  * ``sample_network_instance`` draws the analog mismatch realisation at
    SPEC shapes (per-neuron ``[n_neurons]`` columns, per-source
    ``[n_sources]`` rows), so the draw is independent of K;
  * ``scatter_instance`` places those draws at each neuron's
    ``(chip, column)`` and each source's driver rows (replicated rows of
    one source share the row parameters: they see the same event train,
    so their STP efficacy trajectories are bit-identical replicas);
    unmapped rows and columns keep the ideal nominal values: they carry
    zero weight and never spike, so they are exact-zero terms;
  * ``place_inputs`` writes each external input's event train onto its
    driver rows on every chip; recurrent traffic rides the router with
    the one-window bus latency ON EVERY CHIP COUNT, including K=1 (the
    self-link), which is what makes the latency K-invariant.

The placement is host numpy, done once when a runtime is built; what
``MappedRuntime.run`` needs of it (the input rows, the address plane,
the neurons' chips and columns, the weight and address planes) lies on
the runtime's device as tensors, so a run moves nothing between the host
and the device.

The W windows of a run are one device dispatch, as the reference's
jitted ``lax.scan`` over them is (``repro/mapper/runtime.py:152-170``):
``run`` loads the placed inputs into a ``wafer.router.WindowLoop`` kept
on the runtime per (W, T, telemetry on or off), and on a CUDA device
replays one captured window (``core.graph.LoopGraph``) once a window; on
the CPU, which has no graphs, the same loop body runs window by window.
Under a ``torch.distributed`` group each rank's loop holds its own chips,
and the sharded transport's collectives (``wafer.router``) are captured
inside the window graph, as the reference's ``shard_map`` collectives lie
inside its scan. A capture that fails raises. ``run(..., eager=True)``
runs the windows eagerly through ``wafer.router.run_windows``, on one
rank and under a group.

Contract test: ``tests/test_torch_mapper.py`` (K in {1, 2, 4}, fused and
blocked backends, ring and all2all, with and without a blacklist).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.bss2 import BSS2, BSS2Config
from repro_torch.core.anncore import AnnCore
from repro_torch.core.graph import LoopGraph
from repro_torch.faults.model import slice_chips
from repro_torch.mapper.mapping import ChipMapping
from repro_torch.mapper.spec import NetworkSpec
from repro_torch.verif.mismatch import ideal_instance, sample_instance
from repro_torch.wafer.router import InterChipRouter, WindowLoop, run_windows


def sample_network_instance(spec: NetworkSpec, generator: torch.Generator,
                            cfg: Optional[BSS2Config] = None,
                            device=None) -> Dict:
    """Mismatch realisation at spec shapes (K-independent).

    Args:
      spec: the network; draws are per-neuron (``[n_neurons]`` leaves)
        and per-source (``[n_sources]`` leaves).
      generator: the identity of the virtual silicon; the same generator
        state always yields the same instance, on any chip count.
      cfg: mismatch magnitudes (default ``BSS2.reduced()``).
      device: where the instance lies (``None``: ``cuda``).

    Returns: the ``sample_instance`` dict with rows = sources and
      columns = neurons.
    """
    cfg = cfg or BSS2.reduced()
    scfg = dataclasses.replace(cfg, n_rows=max(spec.n_sources, 1),
                               n_cols=spec.n_neurons)
    return sample_instance(scfg, generator, (), device=device)


def scatter_instance(mapping: ChipMapping, net_inst: Dict,
                     cfg: BSS2Config, device=None) -> Dict:
    """Spec-shaped draws -> per-chip ``(K,)``-prefix instance planes.

    Neuron j's column parameters land at ``(col_chip[j], col_slot[j])``;
    source s's row parameters land on every driver row allocated for s
    (all replicas share them). Unmapped slots keep ideal values. The
    placement runs on the host; the result moves to ``device`` (``None``:
    the device ``net_inst`` lies on) once.
    """
    if device is None:
        device = net_inst["weight_gain"].device
    K = mapping.n_chips
    chip_cfg = dataclasses.replace(cfg, n_rows=mapping.chip_rows,
                                   n_cols=mapping.chip_cols)
    base = ideal_instance(chip_cfg, (K,), device="cpu")
    part = mapping.part
    ks, rs = np.nonzero(mapping.row_source >= 0)
    srcs = mapping.row_source[ks, rs]

    def host(x):
        return x.detach().cpu().numpy().copy()

    def cols(dst, src):
        dst = host(dst)
        dst[part.col_chip, part.col_slot] = host(src)
        return torch.from_numpy(dst).to(device)

    def rows(dst, src):
        dst = host(dst)
        dst[ks, rs] = host(src)[srcs]
        return torch.from_numpy(dst).to(device)

    return dict(
        neuron_params={k: cols(base["neuron_params"][k], v)
                       for k, v in net_inst["neuron_params"].items()},
        weight_gain=cols(base["weight_gain"], net_inst["weight_gain"]),
        stp_offset=rows(base["stp_offset"], net_inst["stp_offset"]),
        stp_calib=rows(base["stp_calib"], net_inst["stp_calib"]),
        cadc_offset=cols(base["cadc_offset"], net_inst["cadc_offset"]),
        cadc_gain=cols(base["cadc_gain"], net_inst["cadc_gain"]))


@dataclass(frozen=True)
class _Tables:
    """A mapping's placement as tensors on one device: the flat
    ``k * R + r`` slot and the input channel of every input row, the
    [K, R] int8 schedule addresses, and every spec neuron's flat
    ``k * C + slot`` column."""
    in_slot: torch.Tensor
    in_src: torch.Tensor
    row_addr: torch.Tensor
    neuron_col: torch.Tensor

    @staticmethod
    def of(mapping: ChipMapping, device) -> "_Tables":
        R, C = mapping.chip_rows, mapping.chip_cols
        ks, rs = np.nonzero((mapping.row_source >= 0)
                            & (mapping.row_source < mapping.spec.n_in))
        part = mapping.part

        def put(x, dtype=np.int64):
            return torch.as_tensor(np.ascontiguousarray(x, dtype),
                                   device=device)
        return _Tables(in_slot=put(ks * R + rs),
                       in_src=put(mapping.row_source[ks, rs]),
                       row_addr=put(mapping.row_addr, np.int8),
                       neuron_col=put(part.col_chip.astype(np.int64) * C
                                      + part.col_slot))


def place_inputs(mapping: ChipMapping, ev_in, device=None, tables=None):
    """[..., T, n_in] external event trains -> ([..., T, K, R] float32
    events, [..., T, K, R] int8 addresses) for ``run_windows``, on
    ``device`` (``None``: the device of ``ev_in`` when it is a tensor,
    else ``cuda``).

    Every driver row's address plane is its schedule address, constant
    per row, so the merged (external | routed) stream keeps the
    ``const_addr`` promise. ``tables`` (``MappedRuntime`` passes its own)
    saves building the placement's index tensors again.
    """
    if device is None and isinstance(ev_in, torch.Tensor):
        device = ev_in.device
    device = resolve_device(device)
    if tables is None:
        tables = _Tables.of(mapping, device)
    ev_in = torch.as_tensor(ev_in, dtype=torch.float32, device=device)
    K, R = mapping.n_chips, mapping.chip_rows
    lead = ev_in.shape[:-1]
    ev = torch.zeros((*lead, K * R), dtype=torch.float32, device=device)
    ev.index_copy_(-1, tables.in_slot, ev_in.index_select(-1, tables.in_src))
    ad = tables.row_addr.expand(*lead, K, R)
    return ev.view(*lead, K, R), ad.contiguous()


def gather_spikes(mapping: ChipMapping, spikes, tables=None):
    """[..., K, C] per-chip output planes -> [..., n_neurons] spec-order
    spike trains (drops unused columns): one index select on the planes'
    device."""
    if tables is None:
        tables = _Tables.of(mapping, spikes.device)
    return spikes.flatten(-2).index_select(-1, tables.neuron_col)


@dataclass
class MappedRuntime:
    """A ``ChipMapping`` bound to executable machinery.

    ``core`` is the ``AnnCore`` of the chips this process holds (instance
    prefix ``(K,)``, or a rank's ``K / world`` chips under a ``group``),
    ``router`` the plan's ``InterChipRouter``; ``net_inst`` the
    spec-shaped mismatch draw the per-chip ``inst`` was scattered from
    (reuse it to build the monolithic reference of the SAME silicon).
    ``loops`` holds ``run``'s window loops by (W, T, telemetry on), each
    with its captured ``LoopGraph`` (``None`` on the CPU).
    """
    mapping: ChipMapping
    chip_cfg: BSS2Config
    core: AnnCore
    router: InterChipRouter
    net_inst: Dict
    inst: Dict
    device: torch.device
    _tables: _Tables = field(init=False, repr=False)
    _planes: tuple = field(init=False, repr=False)
    _addr: Dict = field(init=False, repr=False, default_factory=dict)
    loops: Dict = field(init=False, repr=False, default_factory=dict)

    def __post_init__(self):
        self._tables = _Tables.of(self.mapping, self.device)
        chips = self._chips
        self._planes = tuple(torch.as_tensor(
            np.ascontiguousarray(x[chips]), device=self.device)
            for x in (self.mapping.weights, self.mapping.addresses))

    @property
    def _chips(self) -> slice:
        return self.router._chips

    def init_state(self):
        """Fleet state with the mapped weight and address planes loaded
        (copies of the runtime's device planes: no host transfer)."""
        st = self.core.init_state((self.router.K_loc,))
        w, a = self._planes
        return st._replace(syn=st.syn._replace(weights=w.clone(),
                                               addresses=a.clone()))

    def place(self, ev_in):
        """``place_inputs`` on this runtime's device and tables, the
        address plane built once per input shape; under a group, this
        rank's chips."""
        ev, _ = place_inputs(self.mapping, ev_in, self.device, self._tables)
        shape = tuple(ev.shape)
        if shape not in self._addr:
            self._addr[shape] = self._tables.row_addr.expand(
                shape).contiguous()
        ad = self._addr[shape]
        if self.router.dp > 1:
            chips = self._chips
            return ev[..., chips, :].contiguous(), ad[..., chips, :]
        return ev, ad

    def gather(self, chip_spikes):
        """[..., K_loc, C] planes of this process's chips -> [...,
        n_neurons] spec-order spikes; under a group, every rank's planes
        are gathered first."""
        if self.router.dp > 1:
            import torch.distributed as dist
            x = chip_spikes.movedim(-2, 0).contiguous()
            full = torch.empty((self.router.K, *x.shape[1:]), dtype=x.dtype,
                               device=x.device)
            dist.all_gather_into_tensor(full, x, group=self.router.group)
            chip_spikes = full.movedim(0, -2)
        return gather_spikes(self.mapping, chip_spikes, self._tables)

    def run(self, ev_in, telemetry=None, state=None, eager=False):
        """Emulate W windows of a [W, T, n_in] external stimulus.

        Returns ``(state, out)`` where ``out["spikes"]`` is the
        [W, T, n_neurons] spec-order spike record (``out["chip_spikes"]``
        keeps the raw [W, T, K, C] planes, this rank's chips under a
        group; routed grid and telemetry as ``run_windows`` returns
        them). With ``telemetry=True`` on the core and no counters given,
        fresh ones start before window 0: the counters span all W windows.

        The windows run through the runtime's ``WindowLoop`` of this
        (W, T, telemetry on): on a CUDA device its window is captured at
        the first run of the shape and replayed once a window, later runs
        of the shape load their inputs and replay the same graph; on the
        CPU its body runs window by window. The results are clones, and
        ``state`` is left as it was. ``eager=True`` runs ``run_windows``
        instead: the same bits.

        Under a group the loop holds this rank's [W, T, K_loc, R] inputs,
        routed grid and spike buffer, and its graph holds the sharded
        transport's collectives; ``gather``'s all-gather runs after the
        replays, outside the graph. Every rank must make the same calls
        in the same order: the loop's key (W, T, telemetry on) is the
        same on every rank, so every rank builds, captures and replays
        the same loops at the same calls, and a rank that ran eagerly
        while another replayed would leave both waiting on the other.
        Drop the runtime (its graphs hold NCCL work) before the group is
        destroyed: NCCL does not tear down a group under a live graph.
        """
        ev, ad = self.place(ev_in)
        if state is None:
            state = self.init_state()
        if eager:
            state, out = run_windows(self.core, self.router, state, ev, ad,
                                     telemetry=telemetry)
        else:
            state, out = self._replay(state, ev, ad, telemetry)
        out["chip_spikes"] = out["spikes"]
        out["spikes"] = self.gather(out["chip_spikes"])
        return state, out

    def _replay(self, state, ev, ad, telemetry):
        key = (ev.shape[0], ev.shape[1],
               telemetry is not None or self.core.telemetry)
        if key in self.loops:
            loop, graph = self.loops[key]
            loop.load(state, ev, ad, telemetry)
        else:
            loop = WindowLoop(self.core, self.router, state, ev, ad,
                              telemetry)
            graph = LoopGraph(loop) if self.device.type == "cuda" else None
            self.loops[key] = loop, graph
        step = loop.body if graph is None else graph.replay
        for _ in range(loop.n):
            step()
        return loop.result()


def build_runtime(mapping: ChipMapping, cfg: Optional[BSS2Config] = None,
                  generator: Optional[torch.Generator] = None,
                  net_inst: Optional[Dict] = None, backend: str = "auto",
                  const_addr: bool = True, sparse_mode: Optional[str] = None,
                  device=None, group=None, link_budget: Optional[int] = None,
                  link_mode: str = "auto", faults=None,
                  telemetry: bool = False) -> MappedRuntime:
    """Bind a ``ChipMapping`` to an ``AnnCore`` fleet and a router.

    Args:
      mapping: the compiled placement (``map_network``).
      cfg: base chip config (default ``BSS2.reduced()``); its row and
        column counts are replaced by the mapping's chip geometry.
      generator: the ``torch.Generator`` of the spec-shaped mismatch draw
        (default: seeded with 7); ignored when ``net_inst`` is given.
      net_inst: a ``sample_network_instance`` result to reuse: pass the
        SAME draw to the K-chip and monolithic runtimes to emulate the
        same virtual silicon on both.
      backend / sparse_mode / telemetry: forwarded to ``AnnCore``
        ("auto": blocked on the card, fused on the CPU).
      const_addr: the mapper's address schedule stores one address per
        driver row, so the synaptic window may resolve the address-match
        mask once per window: on by default.
      device: where the runtime runs (``None``: ``cuda``, raising
        without a card).
      group / link_budget / link_mode / faults: forwarded to
        ``InterChipRouter`` (``faults`` to the core too). Under a
        ``torch.distributed`` group each rank holds ``K / world`` chips:
        its core gets the instance and the fault plan's chip planes of
        those chips (``faults.slice_chips``), the router every link
        fault by its absolute link id.

    Returns: a ``MappedRuntime``.
    """
    device = resolve_device(device)
    cfg = cfg or BSS2.reduced()
    chip_cfg = dataclasses.replace(cfg, n_rows=mapping.chip_rows,
                                   n_cols=mapping.chip_cols)
    if net_inst is None:
        if generator is None:
            generator = torch.Generator().manual_seed(7)
        net_inst = sample_network_instance(mapping.spec, generator, cfg,
                                           device=device)
    router = InterChipRouter(mapping.plan, device=device,
                             link_budget=link_budget, link_mode=link_mode,
                             faults=faults, group=group)
    inst = scatter_instance(mapping, net_inst, cfg, device=device)
    core_faults = faults
    if router.dp > 1:
        chips = router._chips
        inst = {k: ({n: p[chips] for n, p in v.items()}
                    if k == "neuron_params" else v[chips])
                for k, v in inst.items()}
        core_faults = slice_chips(faults, chips)
    kw = {} if sparse_mode is None else {"sparse_mode": sparse_mode}
    core = AnnCore(chip_cfg, inst, backend=backend, const_addr=const_addr,
                   telemetry=telemetry, faults=core_faults, **kw)
    return MappedRuntime(mapping=mapping, chip_cfg=chip_cfg, core=core,
                         router=router, net_inst=net_inst, inst=inst,
                         device=device)
