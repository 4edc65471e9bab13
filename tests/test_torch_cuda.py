"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA card (the kernels have no CPU mode) and
skips where there is none. The file imports no JAX, so it runs on a
machine that has only PyTorch: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_cuda.py``.

Tolerances: ``neuron_scan``, ``corr`` and ``ppu_update`` bit-equal (the
kernels repeat the plain versions' operations in order, built without
multiply-add contraction; ``corr`` also on the edges of its spike-driven
skip: accumulators above sat, -0.0 entries, all-zero and dense windows,
non-binary spikes); ``stp_scan`` bit-equal, the sign of zero included
(resources at 0 and 1, negative scales, strided and broadcast operands),
in both forms, its census form's two Dale-half censuses equal to
``census_ref`` on the halves (densities, capacity edges, odd R, prefixes,
T = 0 and 1, and replayed from a captured graph after the step counts'
buffer grew) and the gated trial launching no ``census``;
``ppuvm_exec`` bit-equal (integer only: weights
and registers), on the PPU-VM fuzz corpus, a prefixed multi-block shape
and the main path's [16, 256, 512], and the vm rule's trial on the card
equal to the CPU's; ``synray`` (both forms) and ``synray_sparse``
within rtol = atol = 1e-4 of their plain versions (they sum rows with
FMAs); ``synray``'s const-address form bit-equal to its general form on
constant addresses, and ``synray_sparse`` equal to ``synray`` bit for bit
on every window that fits its capacities, in either form (the same FMA
chain); ``synray_sparse``'s window form bit-equal to its record form fed
``regroup_window``'s records, overflowing windows included; ``census``
equal to its plain version (integers); the main path on the card
against the CPU: spike counts equal and the signed weights within 1e-4,
and a full-width no-stimulus trial with no read back to the host. The
trial captured as a CUDA graph (``TrialGraph``) and replayed gives the
eager trials' histories, final state and device route counts bit for
bit, for both rule implementations; a trial that reads the host fails to
capture and raises. The verification layer: telemetry on and off
bit-equal on full-width graph replays (faulted too), their counters equal
to eager trials'; a faulted window per synaptic route equal to the CPU's
(spikes up to flips at threshold); the store hook after ``ppuvm_exec``
and ``ppu_update`` with a CADC fault map bit-equal to the CPU; ``screen``
and ``calibrate_stp`` equal to the CPU's; a host fault plan inside a
capture raises; a second scanned run replays its graph. The wafer: the
router's delivered grids and link counters equal the CPU's bit for bit
in every mode (link faults and failover forwards included),
``run_training(wafer=2)``'s graph, eager and host-loop runs bit-equal,
and chip-count parity (K = 1, 2, 4) bit for bit. The mapper:
``MappedRuntime.run``'s replays of one captured window equal its eager
windows bit for bit (state, spikes, routed grid, telemetry, route
counts; a replay launches what an eager window launches) at path F's
geometries and on small relay, link-fault and compact-link runtimes; a
window that reads the host fails to capture; a replay after
``stp_scan``'s step-count buffer grew is unchanged. Under NCCL (a card a
rank, child processes of ``tests/_torch_wafer_sharded.py`` under a time
limit): the sharded transport, the mapped window graphs and
``run_training(wafer=4, group=)``'s trial graph with the collectives
inside equal to the local transport, and path F's K = 4 runtime under 1,
2 and 4 ranks replaying equal to its eager windows, the local runtime
and one chip bit for bit. The spans: a span returns while its work
runs; a captured trial's event-record regions add up to the replay
within 1%; a call's load, replays and clones to the call within 2%; a
second call of a shape captures nothing; spans off bit-equal to on; the
vm rule at the fleet's width: one ``ppuvm_exec`` launch a replay, its
program's region, spans off bit-equal to on.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import _torch_ppuvm as vm_corpus
from _torch_parity import (CORR_EDGE_CASES, assert_spikes_match, close,
                           corr_edge_operands, t)
from repro_torch import kernels
from repro_torch.configs.bss2 import BSS2
from repro_torch.core import adex, events
from repro_torch.core import hybrid as th
from repro_torch.core import synapse
from repro_torch.core.anncore import AnnCore
from repro_torch.core.ppu import VectorUnit
from repro_torch.faults import (Blacklist, FaultPlan, cadc_zero_code, chain,
                                inject, sample_fault_plan, screen)
from repro_torch.kernels.census import ops as census_ops
from repro_torch.kernels.census.ref import census_ref
from repro_torch.kernels.corr import ops as corr_ops
from repro_torch.kernels.corr.ref import correlation_window_ref
from repro_torch.kernels.neuron_scan import ops as neuron_ops
from repro_torch.kernels.neuron_scan.ref import neuron_window_ref
from repro_torch.kernels.ppu_update import ops as ppu_ops
from repro_torch.kernels.ppu_update.ref import rstdp_update_ref
from repro_torch.kernels.ppuvm_exec import ops as vm_ops
from repro_torch.kernels.ppuvm_exec.ref import run_program_ref
from repro_torch.kernels.stp_scan import ops as stp_ops
from repro_torch.kernels.stp_scan.ref import (stp_scan_census_ref,
                                              stp_scan_ref)
from repro_torch.obs import report as obs_report
from repro_torch.obs import trace as obs_trace
from repro_torch.ppuvm import isa, programs
from repro_torch.verif import playback as pb
from repro_torch.kernels.synray_sparse import ops as sparse_ops
from repro_torch.kernels.synray_sparse.ref import sparse_window_ref
from repro_torch.kernels.synray import ops as synray_ops
from repro_torch.kernels.synray.ref import synaptic_current_ref
from repro_torch.verif.calibration import calibrate_stp
from repro_torch.verif.mismatch import sample_instance

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_synray_matches_plain(cuda):
    rng = np.random.default_rng(7)
    T, N, R, C = 37, 3, 256, 300            # ragged T, R and C blocks
    ev = ((rng.random((T, N, R)) < 0.2)
          * rng.uniform(0.2, 1.2, (T, N, R))).astype(np.float32)
    ea = rng.integers(0, 4, (T, N, R)).astype(np.int8)
    w = rng.integers(0, 64, (N, R, C)).astype(np.int8)
    a = rng.integers(0, 4, (N, R, C)).astype(np.int8)
    args = [t(x).to(cuda) for x in (ev, ea, w, a)]
    for h in (0, 1):                         # strided Dale halves
        view = (args[0][..., h::2], args[1][..., h::2], args[2][:, h::2],
                args[3][:, h::2])
        n0 = kernels.LAUNCHES["synray"]
        got = synray_ops.synaptic_current(*view)
        want = synaptic_current_ref(*view)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["synray"] == n0 + 1
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("T,N,R,C", [(37, 3, 90, 300), (128, 2, 256, 512)])
def test_synray_const_addr(cuda, T, N, R, C):
    """The const-address form on ragged shapes (45 rows a Dale half: no
    multiple of the row chunk; 300 columns: a partial column block and no
    16-byte rows) and on the main path's aligned widths: within 1e-4 of
    the plain version and bit-equal to the general form on constant
    addresses."""
    rng = np.random.default_rng(T + C)
    ev = ((rng.random((T, N, R)) < 0.2)
          * rng.uniform(0.2, 1.2, (T, N, R))).astype(np.float32)
    ea = np.broadcast_to(rng.integers(0, 4, (N, R)).astype(np.int8),
                         (T, N, R)).copy()
    w = rng.integers(0, 64, (N, R, C)).astype(np.int8)
    a = rng.integers(0, 4, (N, R, C)).astype(np.int8)
    args = [t(x).to(cuda) for x in (ev, ea, w, a)]
    for h in (0, 1):
        view = (args[0][..., h::2], args[1][..., h::2], args[2][:, h::2],
                args[3][:, h::2])
        n0 = kernels.LAUNCHES["synray"]
        const = synray_ops.synaptic_current(*view, const_addr=True)
        general = synray_ops.synaptic_current(*view, const_addr=False)
        want = synaptic_current_ref(*view)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["synray"] == n0 + 2
        torch.testing.assert_close(const, want, rtol=1e-4, atol=1e-4)
        assert torch.equal(const, general)


@pytest.mark.parametrize("use_adex", [True, False])
def test_neuron_scan_bit_equal(cuda, use_adex):
    cfg = BSS2.reduced()
    inst = sample_instance(cfg, torch.Generator().manual_seed(9), (3,),
                           device=cuda)
    p = inst["neuron_params"]
    rng = np.random.default_rng(9)
    shape = (45, 3, cfg.n_cols)
    ie = t(((rng.random(shape) < 0.15)
            * rng.uniform(0, 600, shape)).astype(np.float32)).to(cuda)
    ii = t(((rng.random(shape) < 0.05)
            * rng.uniform(0, 100, shape)).astype(np.float32)).to(cuda)
    st0 = adex.init_state((3, cfg.n_cols), p)
    st0 = st0._replace(v=t(rng.uniform(-58, -45, shape[1:]).astype(
        np.float32)).to(cuda))
    rc0 = torch.zeros(shape[1:], device=cuda)
    kw = dict(dt=cfg.dt, use_adex=use_adex,
              decays=adex.decay_factors(p, cfg.dt), record_v=True)
    n0 = kernels.LAUNCHES["neuron_scan"]
    g = neuron_ops.neuron_window(st0, rc0, ie, ii, p, **kw)
    r = neuron_window_ref(st0, rc0, ie, ii, p, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["neuron_scan"] == n0 + 1
    assert float(g[2][0].sum()) > 0
    for a, b in zip((*g[0], g[1], *g[2]), (*r[0], r[1], *r[2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("record_v", [True, False])
@pytest.mark.parametrize("use_adex", [True, False])
@pytest.mark.parametrize("T", [0, 1, 7, 45, 129])
def test_neuron_scan_ragged_chained(cuda, T, use_adex, record_v):
    """Window lengths that are no multiple of the kernel's 64-step chunk
    (and T = 0), 70 columns (a partial block of 32), two windows chained
    through the returned state: spikes, the five state fields, the rate
    counters and the v record bit-equal to the plain version."""
    cfg = BSS2.reduced()
    N, C = 3, 70
    inst = sample_instance(dataclasses.replace(cfg, n_cols=C),
                           torch.Generator().manual_seed(T), (N,),
                           device=cuda)
    p = inst["neuron_params"]
    rng = np.random.default_rng(T + 100 * use_adex)
    kw = dict(dt=cfg.dt, use_adex=use_adex,
              decays=adex.decay_factors(p, cfg.dt), record_v=record_v)
    packed = neuron_ops.pack_params(p, kw["decays"], (N, C))
    st_g = st_r = adex.init_state((N, C), p)._replace(v=t(rng.uniform(
        -58, -45, (N, C)).astype(np.float32)).to(cuda))
    rc_g = rc_r = t(rng.integers(0, 4, (N, C)).astype(np.float32)).to(cuda)
    n_spk = 0.0
    for _ in range(2):
        shape = (T, N, C)
        ie = t(((rng.random(shape) < 0.15)
                * rng.uniform(0, 600, shape)).astype(np.float32)).to(cuda)
        ii = t(((rng.random(shape) < 0.05)
                * rng.uniform(0, 100, shape)).astype(np.float32)).to(cuda)
        n0 = kernels.LAUNCHES["neuron_scan"]
        g = neuron_ops.neuron_window(st_g, rc_g, ie, ii, p,
                                     packed_params=packed, **kw)
        r = neuron_window_ref(st_r, rc_r, ie, ii, p, **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["neuron_scan"] == n0 + 1
        assert len(g[2]) == len(r[2]) == (2 if record_v else 1)
        for a, b in zip((*g[0], g[1], *g[2]), (*r[0], r[1], *r[2])):
            assert a.shape == b.shape and torch.equal(a, b)
        n_spk += float(g[2][0].sum())
        st_g, rc_g, st_r, rc_r = g[0], g[1], r[0], r[1]
    assert T < 7 or n_spk > 0


def test_neuron_scan_chain_floor_probe(cuda):
    """The measurement probe runs (no launch counted) and, fed currents
    that are the same at every step, equals the window on them."""
    cfg = BSS2.reduced()
    inst = sample_instance(cfg, torch.Generator().manual_seed(4), (2,),
                           device=cuda)
    p = inst["neuron_params"]
    rng = np.random.default_rng(4)
    C = cfg.n_cols
    step = rng.uniform(0, 300, (2, C)).astype(np.float32)
    ie = t(np.broadcast_to(step, (40, 2, C)).copy()).to(cuda)
    ii = torch.zeros_like(ie)
    kw = dict(dt=cfg.dt, decays=adex.decay_factors(p, cfg.dt))
    st0 = adex.init_state((2, C), p)
    rc0 = torch.zeros((2, C), device=cuda)
    n0 = kernels.LAUNCHES["neuron_scan"]
    got = neuron_ops.chain_floor_probe(st0, rc0, ie, ii, p, **kw)
    want = neuron_window_ref(st0, rc0, ie, ii, p, use_adex=True, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["neuron_scan"] == n0
    for a, b in zip((*got[0], got[1], got[2][0]), (*want[0], want[1],
                                                   want[2][0])):
        assert torch.equal(a, b)


def test_corr_bit_equal(cuda):
    rng = np.random.default_rng(2)
    T, N, R, C = 77, 3, 70, 200
    ops = [(rng.random((T, N, R)) < 0.15).astype(np.float32),
           (rng.random((T, N, C)) < 0.15).astype(np.float32),
           rng.random((N, R)).astype(np.float32),
           rng.random((N, C)).astype(np.float32),
           rng.uniform(0, 1023, (N, R, C)).astype(np.float32),
           rng.uniform(0, 3, (N, R, C)).astype(np.float32)]
    ops = [t(x).to(cuda) for x in ops]
    lam = math.exp(-0.2 / 5.0)
    n0 = kernels.LAUNCHES["corr"]
    got = corr_ops.correlation_window(*ops, lam=lam)
    want = correlation_window_ref(*ops, lam=lam)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["corr"] == n0 + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", CORR_EDGE_CASES)
@pytest.mark.parametrize("T", [77, 33])
def test_corr_edge_cases_bit_equal(cuda, case, T):
    """The edges of the spike-driven skip (``corr.cu``'s header), bit
    for bit against the plain version on the card: accumulators above
    sat, -0.0 entries, all-zero and fully dense windows, non-binary and
    negative spikes, T a multiple of no chunk."""
    ops = [t(x).to(cuda) for x in corr_edge_operands(case, T=T)]
    lam = math.exp(-0.2 / 5.0)
    got = corr_ops.correlation_window(*ops, lam=lam)
    want = correlation_window_ref(*ops, lam=lam)
    torch.cuda.synchronize()
    for name, a, b in zip(("a_causal", "a_acausal", "tp", "tq"), got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name


def test_main_path_on_card_matches_cpu(cuda):
    """A small fleet on the card: two synray, one neuron_scan and one corr
    launch per trial, and the first trial equal to the CPU's."""
    ecfg = th.RSTDPConfig(n_inputs=32, n_neurons=64, pattern_size=6,
                          trial_steps=64)
    kw = dict(ecfg=ecfg, prefix=(2,), backend="blocked",
              sparse_mode="never")
    init, trial, meta = th.make_experiment(
        generator=torch.Generator().manual_seed(5), device=cuda, **kw)
    stims = [1, 2, 0]
    draws = meta["draw"](torch.Generator().manual_seed(6), stims)
    kernels.reset_launches()
    st = init()
    for i, s in enumerate(stims):
        st, m = trial(st, s, draws.events[i], draws.xi[i])
        if i == 0:
            first = (st, m)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"synray": 6, "synray_sparse": 0,
                                "census": 0, "neuron_scan": 3, "corr": 3,
                                "ppu_update": 0, "ppuvm_exec": 0,
                                "stp_scan": 3}
    inst_c = {k: (v.cpu() if torch.is_tensor(v) else
                  {kk: vv.cpu() for kk, vv in v.items()})
              for k, v in meta["inst"].items()}
    init_c, trial_c, _ = th.make_experiment(inst=inst_c, device="cpu", **kw)
    st_c, m_c = trial_c(init_c(), stims[0], draws.events[0].cpu(),
                        draws.xi[0].cpu())
    assert torch.equal(first[1]["rates"].cpu(), m_c["rates"])
    close(first[0].w_signed.cpu(), st_c.w_signed)


def _sparse_operands(T, N, R, C, p, seed, const):
    rng = np.random.default_rng(seed)
    ev = ((rng.random((T, N, R)) < p)
          * rng.uniform(0.2, 1.2, (T, N, R))).astype(np.float32)
    w = rng.integers(0, 64, (N, R, C)).astype(np.int8)
    if const:
        row = rng.integers(0, 4, (N, R)).astype(np.int8)
        ea = np.broadcast_to(row, (T, N, R)).copy()
    else:
        ea = rng.integers(0, 4, (T, N, R)).astype(np.int8)
    a = rng.integers(0, 4, (N, R, C)).astype(np.int8)
    return ev, ea, w, a


@pytest.mark.parametrize("p", [0.005, 0.01, 0.02, 0.05])
@pytest.mark.parametrize("const", [False, True])
def test_synray_sparse_equals_dense_kernel(cuda, p, const):
    """On a window that fits, the sparse route equals the dense kernel
    bit for bit (the same fmaf chain over the fired rows), for both
    Dale halves read in place and with the default capacities."""
    T, N, R, C = 128, 4, 256, 512
    ev, ea, w, a = (t(x).to(cuda) for x in _sparse_operands(
        T, N, R, C, p, seed=int(p * 1000) + const, const=const))
    gain = torch.ones(C, device=cuda)
    for h in (0, 1):
        args = (w[:, h::2], a[:, h::2], ev[..., h::2], ea[..., h::2], gain)
        n0 = dict(kernels.LAUNCHES)
        dense = synapse.synaptic_current_window(*args, const_addr=const,
                                                sparse="never")
        sparse = synapse.synaptic_current_window(
            *args, const_addr=const, sparse="always", max_events=T * R,
            k_cap=R // 2)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["synray"] == n0["synray"] + 1
        assert kernels.LAUNCHES["synray_sparse"] == n0["synray_sparse"] + 1
        assert torch.equal(dense, sparse)
        # the gate's decision from its plain version (on the card the
        # route is "gate": the census decides on the device)
        assert synapse.window_route(args[2], C, const_addr=const,
                                    sparse="auto")[0] == "gate"
        route, me, kc = synapse.window_route(args[2].cpu(), C,
                                             const_addr=const, sparse="auto")
        if route == "sparse":
            assert torch.equal(dense, synapse.synaptic_current_window(
                *args, const_addr=const, sparse="always", max_events=me,
                k_cap=kc))


def test_synray_sparse_matches_plain(cuda):
    T, N, R, C = 77, 3, 96, 300               # ragged T and C blocks
    ev, ea, w, a = _sparse_operands(T, N, R, C, 0.08, seed=3, const=False)
    ev_n = t(ev.transpose(1, 0, 2).copy()).to(cuda)
    ea_n = t(ea.transpose(1, 0, 2).copy()).to(cuda)
    wd, ad = t(w).to(cuda), t(a).to(cuda)
    for h in (0, 1):
        # the records of this Dale half's rows; K = 40 > one staged chunk
        recs = events.regroup_window(ev_n[..., h::2], ea_n[..., h::2],
                                     T * R, 40)
        n0 = kernels.LAUNCHES["synray_sparse"]
        got = sparse_ops.sparse_window(*recs, wd[:, h::2], ad[:, h::2])
        want = sparse_window_ref(*recs, wd[:, h::2], ad[:, h::2])
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["synray_sparse"] == n0 + 1
        assert got.permute(1, 0, 2).is_contiguous()     # time-major buffer
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("prefix", [(), (3,)])
def test_ppu_update_bit_equal(cuda, prefix):
    rng = np.random.default_rng(4)
    R, C = 200, 300
    shape = (*prefix, R, C)
    w = t(rng.integers(0, 64, shape).astype(np.int8)).to(cuda)
    ac, aa = (t(rng.uniform(0, 40, shape).astype(np.float32)).to(cuda)
              for _ in range(2))
    off = t(rng.uniform(-3, 12, (*prefix, C)).astype(np.float32)).to(cuda)
    gain = t(rng.uniform(0.8, 1.2, (*prefix, C)).astype(np.float32)).to(cuda)
    mod = t(rng.uniform(-1, 1, (*prefix, C)).astype(np.float32)).to(cuda)
    xi = t((0.3 * rng.standard_normal(shape)).astype(np.float32)).to(cuda)
    n0 = kernels.LAUNCHES["ppu_update"]
    got = ppu_ops.rstdp_update(w, ac, aa, off, gain, mod, xi, eta=3.0)
    want = rstdp_update_ref(w, ac, aa, off, gain, mod, xi, eta=3.0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ppu_update"] == n0 + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_census_gate_routes_on_card(cuda):
    """Above the floor with the defaults: a no-stimulus trial goes sparse,
    a pattern trial dense, as the device's route counter records (every
    gated window launches both route kernels; the STP scan takes both
    halves' censuses, so no census kernel runs)."""
    ecfg = th.RSTDPConfig(n_inputs=64, n_neurons=256, pattern_size=16,
                          trial_steps=128)
    cfg = dataclasses.replace(BSS2, n_rows=128, n_cols=256)
    init, trial, meta = th.make_experiment(
        cfg=cfg, ecfg=ecfg, prefix=(2,),
        generator=torch.Generator().manual_seed(5), device=cuda)
    draws = meta["draw"](torch.Generator().manual_seed(6), [0, 1])
    st = init()
    routes = synapse.route_counts(cuda)
    synapse.reset_route_counts()
    kernels.reset_launches()
    st, _ = trial(st, 0, draws.events[0], draws.xi[0])
    assert routes.tolist() == [0, 2]
    st, _ = trial(st, 1, draws.events[1], draws.xi[1])
    assert routes.tolist() == [2, 2]
    assert {k: kernels.LAUNCHES[k] for k in ("census", "stp_scan",
                                             "synray_sparse", "synray")} == \
        {"census": 0, "stp_scan": 2, "synray_sparse": 4, "synray": 4}


def test_no_host_read_in_the_trial(cuda):
    """A full-width no-stimulus trial of path A (16 instances of the
    256 x 512 chip, T = 128: every window through the census gate) makes
    no device-to-host read once warmed up."""
    ecfg = th.RSTDPConfig(n_inputs=128, n_neurons=512, pattern_size=24,
                          trial_steps=128)
    init, trial, meta = th.make_experiment(
        cfg=BSS2, ecfg=ecfg, prefix=(16,), backend="blocked",
        generator=torch.Generator().manual_seed(11), device=cuda)
    draws = meta["draw"](torch.Generator().manual_seed(12), [0, 0])
    st, _ = trial(init(), 0, draws.events[0], draws.xi[0])
    torch.cuda.synchronize()
    synapse.reset_route_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, _ = trial(st, 0, draws.events[1], draws.xi[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert synapse.route_counts(cuda).tolist() == [0, 2]


def _halves(ev, ea, w, a, cuda):
    """Both Dale halves of [T, N, 2R] planes and [N, 2R, C] stores, as
    strided views on the card."""
    ev, ea, w, a = (t(x).to(cuda) for x in (ev, ea, w, a))
    return [(ev[..., h::2], ea[..., h::2], w[:, h::2], a[:, h::2])
            for h in (0, 1)]


# (T, N, 2R, C, density, max_events, k_cap, const, -0.0): ragged T and C,
# overflow of each capacity across the window's chunks, -0.0, an empty
# window, every row firing, more rows than one staged tile and more than
# the window form takes
WINDOW_CASES = {
    "main": (128, 16, 256, 512, 0.008, 328, 16, True, False),
    "ragged": (77, 3, 90, 300, 0.05, 10_000, 64, False, False),
    "max_events": (128, 2, 256, 96, 0.05, 500, 64, True, False),
    "k_cap": (100, 2, 180, 70, 0.05, 10_000, 3, False, False),
    "both": (100, 2, 180, 70, 0.05, 380, 6, False, False),
    "neg_zero": (50, 2, 96, 100, 0.1, 10_000, 48, True, True),
    "empty": (20, 2, 64, 64, 0.0, 100, 8, True, False),
    "all_fire": (20, 2, 64, 64, 1.0, 10_000, 32, True, False),
    "all_fire_capped": (20, 2, 64, 64, 1.0, 100, 7, True, False),
    "unstaged": (12, 1, 1700, 70, 0.02, 10_000, 64, True, False),
    "record_rows": (3, 1, 8300, 40, 0.002, 10_000, 64, True, False),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_synray_sparse_window_form(cuda, case):
    """The window form bit-equal to the record form fed
    ``regroup_window``'s records (drops included), within 1e-4 of the
    plain version, and, where the window fits, bit-equal to the dense
    ``synray``; the census equal to its plain version, and census +
    sparse + dense into one buffer equal to the route it picks."""
    T, N, R2, C, p, me, kc, const, neg = WINDOW_CASES[case]
    ev, ea, w, a = _sparse_operands(T, N, R2, C, p, seed=R2 + C, const=const)
    if neg:
        z = ev == 0
        ev[z] = np.where(np.random.default_rng(1).random(int(z.sum())) < 0.5,
                         -0.0, 0.0)
    for v in _halves(ev, ea, w, a, cuda):
        n0 = kernels.LAUNCHES["synray_sparse"]
        got = sparse_ops.sparse_current_window(*v, max_events=me, k_cap=kc)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["synray_sparse"] == n0 + 1
        recs = events.regroup_window(v[0].permute(1, 0, 2),
                                     v[1].permute(1, 0, 2), me, kc)
        rec = sparse_ops.sparse_window(*recs, v[2], v[3]).permute(1, 0, 2)
        plain = sparse_window_ref(*recs, v[2], v[3]).permute(1, 0, 2)
        assert torch.equal(got.view(torch.int32),
                           rec.contiguous().view(torch.int32))
        torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
        flag = census_ops.census(v[0], me, kc)
        assert torch.equal(flag, census_ref(v[0], me, kc))
        fits = bool(flag[0])
        dense = synray_ops.synaptic_current(*v, const_addr=const)
        if fits:
            assert torch.equal(got, dense)
        out = torch.full_like(got, float("nan"))
        sparse_ops.sparse_current_window(*v, max_events=me, k_cap=kc,
                                         flag=flag, out=out)
        synray_ops.synaptic_current(*v, const_addr=const, flag=flag, out=out)
        assert torch.equal(out.view(torch.int32),
                           (got if fits else dense).view(torch.int32))


def _vm_both(words, ops, cuda):
    """ppuvm_exec and its plain version on the same card operands; one
    launch counted."""
    dev = {k: None if v is None else t(v).to(cuda) for k, v in ops.items()}
    args = (dev["weights"], dev["qc"], dev["qa"], dev["rates"],
            dev.get("mod"), dev.get("noise"))
    w_dev = torch.as_tensor(np.asarray(words, np.int32), device=cuda)
    n0 = kernels.LAUNCHES["ppuvm_exec"]
    got = vm_ops.run_program(w_dev, *args)
    want = run_program_ref(w_dev, *args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ppuvm_exec"] == n0 + 1
    return got, want


def _assert_vm_equal(got, want, ctx):
    for name, a, b in zip(("weights", "registers"), got, want):
        assert a.dtype == torch.int32 and a.shape == b.shape, (ctx, name)
        assert torch.equal(a, b), f"ppuvm_exec {name} differ {ctx}"


def test_ppuvm_exec_fuzz_corpus(cuda):
    for seed, words, ops in vm_corpus.corpus():
        _assert_vm_equal(*_vm_both(words, ops, cuda), f"(seed {seed})")
    for seed in range(3):
        ops = vm_corpus.gen_operands(np.random.RandomState(seed), edge=True)
        for name, words in [("edge", vm_corpus.edge_program()),
                            ("unknown", vm_corpus.unknown_opcode_program()),
                            *vm_corpus.shipped_programs().items()]:
            _assert_vm_equal(*_vm_both(words, ops, cuda), f"({name})")


@pytest.mark.parametrize("shape", [(3, 40, 136), (2, 3, 17, 300)])
def test_ppuvm_exec_prefixed_multi_block(cuda, shape):
    """Instance prefixes folded into the lanes, tails that are not a
    multiple of the block, with and without mod / noise."""
    rng = np.random.RandomState(11)
    for _ in range(4):
        words = vm_corpus.pad(vm_corpus.gen_program(rng))
        ops = vm_corpus.prefixed_operands(rng, shape)
        _assert_vm_equal(*_vm_both(words, ops, cuda), str(shape))
        ops = dict(ops, mod=None, noise=None)
        _assert_vm_equal(*_vm_both(words, ops, cuda), f"{shape} bare")


@pytest.mark.parametrize("rule", ["signed_dw", "rstdp"])
def test_ppuvm_exec_main_path_shape(cuda, rule):
    rng = np.random.RandomState(12)
    ops = vm_corpus.prefixed_operands(rng, (16, 256, 512))
    if rule == "rstdp":
        ops["mod"] = ops["mod"][:1]
    _assert_vm_equal(*_vm_both(vm_corpus.shipped_programs()[rule], ops,
                               cuda), rule)


@pytest.mark.parametrize("shape", [(3, 7, 37), (2, 5, 130), (1, 9, 258)])
@pytest.mark.parametrize("w_dtype", [np.int8, np.int32])
def test_ppuvm_exec_ragged_lanes(cuda, shape, w_dtype):
    """Rows whose length is no multiple of the kernel's 4 lanes a thread
    (the scalar form), int8 and int32 weights, with and without mod /
    noise."""
    rng = np.random.RandomState(shape[-1])
    for _ in range(3):
        words = vm_corpus.pad(vm_corpus.gen_program(rng))
        ops = vm_corpus.prefixed_operands(rng, shape)
        ops["weights"] = ops["weights"].astype(w_dtype)
        _assert_vm_equal(*_vm_both(words, ops, cuda), str(shape))
        ops = dict(ops, mod=None, noise=None)
        _assert_vm_equal(*_vm_both(words, ops, cuda), f"{shape} bare")


def test_ppuvm_exec_unaligned_plane(cuda):
    """A qc plane that starts 4 bytes past a 16-byte boundary takes the
    scalar form on an otherwise aligned shape."""
    rng = np.random.RandomState(21)
    ops = vm_corpus.prefixed_operands(rng, (2, 16, 64))
    dev = {k: t(v).to(cuda) for k, v in ops.items()}
    buf = torch.empty(dev["qc"].numel() + 1, dtype=torch.int32, device=cuda)
    qc = buf[1:].view(dev["qc"].shape)
    qc.copy_(dev["qc"])
    assert qc.data_ptr() % 16 != 0
    words = torch.as_tensor(vm_corpus.shipped_programs()["signed_dw"],
                            device=cuda)
    args = (dev["weights"], qc, dev["qa"], dev["rates"], dev["mod"],
            dev["noise"])
    _assert_vm_equal(vm_ops.run_program(words, *args),
                     run_program_ref(words, *args), "unaligned qc")


@pytest.mark.parametrize("op", range(isa.N_OPS + 1))
def test_ppuvm_exec_one_word_programs(cuda, op):
    """A single word of every opcode (and one past the last: a NOP), its
    register fields, shift and immediate drawn at random."""
    rng = np.random.RandomState(op)
    ops = vm_corpus.prefixed_operands(rng, (2, 3, 10))
    for _ in range(8):
        word = (op << 26) | int(rng.randint(0, 1 << 26))
        words = np.array([word], np.uint32).view(np.int32)
        _assert_vm_equal(*_vm_both(words, ops, cuda), f"op {op} {word:#x}")


def test_ppuvm_exec_word_limit(cuda):
    """Programs of MAX_WORDS words (decoded once a block, filling its
    shared memory), one word more and 3 x MAX_WORDS + 5 words (decoded
    and run a chunk at a time on every tile, the register file carried
    across the chunks) are bit-equal to the plain version, on a shape of
    one tile and on a ragged prefixed one of several."""
    base = np.concatenate([vm_corpus.gen_program(np.random.RandomState(s))
                           for s in range(1500)])
    rng = np.random.RandomState(5)
    for n_words in (vm_ops.MAX_WORDS, vm_ops.MAX_WORDS + 1,
                    3 * vm_ops.MAX_WORDS + 5):
        words = np.resize(base, n_words).astype(np.int32)
        for ops in (vm_corpus.gen_operands(rng),
                    vm_corpus.prefixed_operands(rng, (3, 40, 136))):
            _assert_vm_equal(*_vm_both(words, ops, cuda), f"{n_words} words")


@pytest.mark.parametrize("rule", ["signed_dw", "rstdp"])
def test_ppuvm_exec_int8_weights_main_path_shape(cuda, rule):
    """The synapse store's int8 weights read as they are, at the main
    path's [16, 256, 512] (path C and apply_rstdp_program pass int8)."""
    rng = np.random.RandomState(13)
    ops = vm_corpus.prefixed_operands(rng, (16, 256, 512))
    ops["weights"] = ops["weights"].astype(np.int8)
    if rule == "rstdp":
        ops["mod"] = ops["mod"][:1]
    else:
        ops["noise"] = None
    _assert_vm_equal(*_vm_both(vm_corpus.shipped_programs()[rule], ops,
                               cuda), rule)


def test_ppuvm_exec_needs_words_on_the_card(cuda):
    ops = vm_corpus.gen_operands(np.random.RandomState(0))
    args = [t(ops[k]).to(cuda) for k in ("weights", "qc", "qa", "rates")]
    with pytest.raises(ValueError, match="upload the program once"):
        vm_ops.run_program(torch.as_tensor(vm_corpus.edge_program()), *args)


def test_vm_rule_trial_on_card_matches_cpu(cuda):
    """One vm-rule trial at 32 x 16 on the card and on the CPU from the
    same instance and draws: one ppuvm_exec launch, spikes and weight
    codes equal, the signed weights within 1e-4."""
    init, trial, meta = th.make_experiment(
        generator=torch.Generator().manual_seed(2), rule_impl="vm",
        device=cuda)
    draws = meta["draw"](torch.Generator().manual_seed(3), [1])
    init_c, trial_c, _ = th.make_experiment(
        inst={k: (v.cpu() if torch.is_tensor(v)
                  else {a: b.cpu() for a, b in v.items()})
              for k, v in meta["inst"].items()},
        rule_impl="vm", device="cpu")
    kernels.reset_launches()
    s_g, m_g = trial(init(), 1, draws.events[0], draws.xi[0])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ppuvm_exec"] == 1
    s_c, m_c = trial_c(init_c(), 1, draws.events[0].cpu(), draws.xi[0].cpu())
    assert torch.equal(m_g["rates"].cpu(), m_c["rates"])
    assert torch.equal(s_g.core.syn.weights.cpu(), s_c.core.syn.weights)
    close(s_g.w_signed.cpu(), s_c.w_signed)


@pytest.mark.parametrize("rule", sorted(vm_corpus.GOLDEN_RULES))
def test_playback_golden_on_card(cuda, rule):
    golden = vm_corpus.load_trace(rule)
    kernels.reset_launches()
    tr = pb.execute(vm_corpus.canonical_program(rule), "fast",
                    vm_corpus.golden_cfg(), device=cuda)
    assert kernels.LAUNCHES["ppuvm_exec"] == 2
    errs = pb.compare_traces(tr, golden, atol=0.05)
    assert not errs, "\n".join(errs)
    for (tg, kg, vg), (_, _, v) in zip(golden, tr):
        if kg in ("PPU_W", "WEIGHTS"):
            np.testing.assert_array_equal(v.astype(np.int32),
                                          vg.astype(np.int32))


STP_CASES = ("random", "r0_zero", "r0_one", "negative_scale", "dale_half",
             "offset_rows", "shared_scale", "non_binary", "nan")


@pytest.mark.parametrize("case", STP_CASES)
@pytest.mark.parametrize("T,prefix,R", [(128, (16,), 256), (256, (), 32),
                                        (37, (3,), 70), (1, (2, 5), 33),
                                        (0, (2,), 9)])
def test_stp_scan_bit_equal(cuda, T, prefix, R, case):
    """stp_scan against its plain version on the card, bit for bit (the
    sign of zero included): the main path's [T=128, 16, 256], the closed
    loop's [T=256, 32], ragged shapes, resources at 0 and 1, negative
    scales (-0.0 efficacies), a Dale half read in place, contiguous rows
    that start one float past a 16-byte boundary, a scale shared
    by the prefix, non-binary spikes, and NaN resources, scales and
    spikes (the clamps pass a NaN through, with PyTorch's bits)."""
    rng = np.random.default_rng(T + R)
    full = {"dale_half": 2 * R, "offset_rows": R + 1}.get(case, R)
    sp = (rng.random((T, *prefix, full)) < 0.3).astype(np.float32)
    if case == "non_binary":
        sp *= rng.uniform(-0.5, 2.0, sp.shape).astype(np.float32)
    if case == "nan":
        sp[rng.random(sp.shape) < 0.01] = np.nan
    sp = t(sp).to(cuda)
    if case == "dale_half":
        sp = sp[..., 1::2]
    if case == "offset_rows":
        sp = sp[..., 1:]
    r0 = rng.random((*prefix, R)).astype(np.float32)
    if case == "r0_zero":
        r0[:] = 0
    if case == "r0_one":
        r0[:] = 1
    scale = rng.normal(1.0, 0.5, (*prefix, R)).astype(np.float32)
    if case == "negative_scale":
        scale = -np.abs(scale)
        r0[..., ::2] = 0
    if case == "nan":                 # NaN resources, scales and spikes
        r0[..., ::7] = np.nan
        scale[..., 3::11] = np.nan
    r0, scale = t(r0).to(cuda), t(scale).to(cuda)
    if case == "shared_scale":
        scale = scale.reshape(-1)[:R]
    kw = dict(u=0.2, recovery=float(1.0 - math.exp(-0.2 / 20.0)))
    n0 = kernels.LAUNCHES["stp_scan"]
    got = stp_ops.stp_scan(r0, sp, scale, **kw)
    want = stp_scan_ref(r0, sp, scale, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["stp_scan"] == n0 + 1
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))


STP_DENSITIES = ("background", "bursts", "none", "all")


def _stp_census_operands(T, prefix, R, density, seed=3):
    """The CPU tests' census operands (``tests/test_torch_stp_scan.py``):
    the §5 background, pattern bursts, no spike, every row firing; a
    positive scale."""
    rng = np.random.default_rng(seed + T + R + 11 * len(prefix))
    shape = (T, *prefix, R)
    p = {"background": 0.008, "bursts": 0.008, "none": 0.0, "all": 1.0}
    sp = rng.random(shape) < p[density]
    if density == "bursts":
        k = max(1, R // 6)
        sp[::16, ..., :k] |= rng.random(sp[::16, ..., :k].shape) < 0.8
    r0 = rng.random((*prefix, R)).astype(np.float32)
    scale = (np.abs(rng.normal(1.0, 0.25, (*prefix, R))) + 0.05
             ).astype(np.float32)
    return r0, sp.astype(np.float32), scale


def _stp_census_check(cuda, r0, sp, scale, caps):
    """The census form on the card against its plain version on the card
    (eff and r_T bit for bit, both censuses equal), the decisions counted
    on the device, one launch; the form without the census bit-equal too.
    Returns the two censuses."""
    r0, sp, scale = (t(x).to(cuda) for x in (r0, sp, scale))
    kw = dict(u=0.2, recovery=float(1.0 - math.exp(-0.2 / 20.0)))
    routes = torch.zeros(2, dtype=torch.int64, device=cuda)
    n0 = kernels.LAUNCHES["stp_scan"]
    got = stp_ops.stp_scan(r0, sp, scale, caps=caps, routes=routes, **kw)
    plain = stp_ops.stp_scan(r0, sp, scale, **kw)
    want = stp_scan_census_ref(r0, sp, scale, caps=caps, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["stp_scan"] == n0 + 2
    for a, b in zip(got[:2], want[:2]):
        assert a.shape == b.shape
        assert torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))
    for a, b in zip(plain, want[:2]):
        assert torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))
    for h in (0, 1):
        assert torch.equal(got[2 + h], want[2 + h])
        assert torch.equal(want[2 + h],
                           census_ref(want[0][..., h::2], *caps[h]))
    fits = int(want[2][0]) + int(want[3][0])
    assert routes.tolist() == [2 - fits, fits]
    return [c.tolist() for c in want[2:]]


@pytest.mark.parametrize("density", STP_DENSITIES)
@pytest.mark.parametrize("T,prefix,R", [(128, (16,), 256), (256, (), 32),
                                        (128, (2,), 37), (1, (2, 3), 33),
                                        (0, (2,), 9), (200, (2, 3), 45),
                                        (3, (2,), 1100), (128, (2,), 490),
                                        (128, (), 968)])
def test_stp_scan_census_form_bit_equal(cuda, T, prefix, R, density):
    """The census form at the main shape, the closed loop's, odd R
    (uneven halves), the prefixes (), (2,) and (2, 3), T = 0 and 1, a
    window longer than its staged stages (a ring), and instances of more
    rows than a block takes (path F's K = 2 and K = 1 chips: their step
    counts summed across blocks), at the gate's default capacities."""
    caps = tuple(synapse.route_plan(T, len(range(h, R, 2)), 512,
                                    const_addr=True, sparse="always")[1:]
                 for h in (0, 1))
    got = _stp_census_check(cuda, *_stp_census_operands(T, prefix, R,
                                                        density), caps)
    if T == 0 or density == "none":
        assert got == [[1, 0, 0], [1, 0, 0]]


@pytest.mark.parametrize("T,prefix,R", [(25000, (2,), 256),
                                        (30000, (2,), 256),
                                        (30000, (), 968)])
def test_stp_scan_census_long_window(cuda, T, prefix, R):
    """Windows at and past the step count whose counts once had to fit in
    shared memory (about 25k steps at 256 rows), in one block an instance
    and across blocks: eff and r_T bit-equal to the form without the
    census (itself held to the plain version above), both censuses equal
    to census_ref's on each half, twice in a row (the scratch the kernel
    leaves at 0 is reused)."""
    r0, sp, scale = (t(x).to(cuda) for x in _stp_census_operands(
        T, prefix, R, "bursts"))
    kw = dict(u=0.2, recovery=float(1.0 - math.exp(-0.2 / 20.0)))
    caps = tuple(synapse.route_plan(T, len(range(h, R, 2)), 512,
                                    const_addr=True, sparse="always")[1:]
                 for h in (0, 1))
    plain = stp_ops.stp_scan(r0, sp, scale, **kw)
    for _ in range(2):
        got = stp_ops.stp_scan(r0, sp, scale, caps=caps, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got[:2], plain):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        for h in (0, 1):
            assert torch.equal(got[2 + h],
                               census_ref(plain[0][..., h::2], *caps[h]))


def test_stp_scan_census_counts_under_a_captured_graph(cuda):
    """A census-form launch at (1, 968) rows (an instance over four row
    blocks: its step counts summed in the device's global buffer), T =
    128, captured as a CUDA graph; then an eager launch at a larger N * T
    than that buffer holds, which grows it; then sentinels of the old
    buffer's size. The replay sums into the buffer the capture saw: the
    sentinels stay intact, and the replay's censuses equal
    ``stp_scan_census_ref``'s (eff and r_T bit for bit)."""
    kw = dict(u=0.2, recovery=float(1.0 - math.exp(-0.2 / 20.0)))

    def operands(T, prefix, R):
        ops = [t(x).to(cuda) for x in _stp_census_operands(T, prefix, R,
                                                           "bursts")]
        caps = tuple(synapse.route_plan(T, len(range(h, R, 2)), 512,
                                        const_addr=True, sparse="always")[1:]
                     for h in (0, 1))
        return ops, caps

    (r0, sp, scale), caps = operands(128, (1,), 968)
    want = stp_scan_census_ref(r0, sp, scale, caps=caps, **kw)
    stp_ops.stp_scan(r0, sp, scale, caps=caps, **kw)   # ticket and counts
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = stp_ops.stp_scan(r0, sp, scale, caps=caps, **kw)
    held = stp_ops._COUNTS[r0.device].numel()
    big, big_caps = operands(held // 4 + 1, (4,), 968)
    stp_ops.stp_scan(*big, caps=big_caps, **kw)
    torch.cuda.synchronize()
    assert stp_ops._COUNTS[r0.device].numel() > held
    mark = 0x5A5A5A5A
    sentinels = [torch.full((held,), mark, dtype=torch.int32, device=cuda)
                 for _ in range(8)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(bool((s == mark).all()) for s in sentinels)
        for a, b in zip(got[:2], want[:2]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        for h in (0, 1):
            assert torch.equal(got[2 + h], want[2 + h])


@pytest.mark.parametrize("half", [0, 1])
@pytest.mark.parametrize("edge", ["n_events_equal", "n_events_over",
                                  "k_max_equal", "k_max_over"])
def test_stp_scan_census_capacity_edges(cuda, edge, half):
    """Each capacity met exactly (fits) and one over (does not), per half,
    on 64 steps of pattern bursts over two instances of 37 rows; and
    resources at 0 under a negative scale (-0.0 efficacies: no event)."""
    r0, sp, scale = _stp_census_operands(64, (2,), 37, "bursts")
    kw = dict(u=0.2, recovery=float(1.0 - math.exp(-0.2 / 20.0)))
    eff, _ = stp_scan_ref(t(r0), t(sp), t(scale), **kw)
    _, n, k = census_ref(eff[..., half::2], 0, 0).tolist()
    big = 10 ** 6
    caps = [(big, big), (big, big)]
    caps[half] = {"n_events_equal": (n, big), "n_events_over": (n - 1, big),
                  "k_max_equal": (big, k), "k_max_over": (big, k - 1)}[edge]
    got = _stp_census_check(cuda, r0, sp, scale, tuple(caps))
    assert got[half] == [int(edge.endswith("equal")), n, k]
    r0[:] = 0
    got = _stp_census_check(cuda, r0, sp, -scale, tuple(caps))
    assert [c[1:] for c in got] == [[0, 0], [0, 0]]


def _full_width(cuda, rule_impl):
    ecfg = th.RSTDPConfig(n_inputs=128, n_neurons=512, pattern_size=24,
                          trial_steps=128)
    return th.make_experiment(
        cfg=BSS2, ecfg=ecfg, prefix=(16,), backend="blocked",
        generator=torch.Generator().manual_seed(11), rule_impl=rule_impl,
        device=cuda)


@pytest.mark.parametrize("rule_impl", ["python", "vm"])
def test_graph_replay_equals_eager(cuda, rule_impl):
    """Six full-width trials (A, B, none, A, B, none) as graph replays
    from the same state and draws as six eager trials: histories, final
    state and the device route counts equal bit for bit; one replay
    launches what one eager trial launches."""
    init, trial, meta = _full_width(cuda, rule_impl)
    stims = [1, 2, 0, 1, 2, 0]
    draws = meta["draw"](torch.Generator().manual_seed(12), stims)
    state0 = init()
    routes = synapse.route_counts(cuda)
    synapse.reset_route_counts()
    kernels.reset_launches()
    st, hist = state0, []
    for i, s in enumerate(stims):
        st, m = trial(st, s, draws.events[i], draws.xi[i])
        hist.append(m)
    torch.cuda.synchronize()
    eager_routes = routes.tolist()
    per_trial = {k: v // len(stims) for k, v in kernels.LAUNCHES.items()}
    assert eager_routes == [8, 4] and per_trial["stp_scan"] == 1
    graph = th.TrialGraph(th.TrialLoop(trial, state0, stims, draws))
    assert graph.launches == per_trial
    synapse.reset_route_counts()
    for _ in stims:
        graph.replay()
    torch.cuda.synchronize()
    assert routes.tolist() == eager_routes
    g_hist = graph.loop.history()
    for k in hist[0]:
        assert torch.equal(g_hist[k], torch.stack([m[k] for m in hist])), k
    assert g_hist["stim"].tolist() == stims
    for a, b in zip(th._leaves(graph.loop.state), th._leaves(st)):
        assert torch.equal(a, b)


def test_run_training_default_replays_a_graph(cuda):
    """``run_training`` on the card captures the trial and replays it: its
    three modes agree bit for bit, and the graph run's wrappers count only
    the warm-ups and the captures (two of each with the experiment's spans
    on: the second capture holds the last trial's marks)."""
    outs = []
    for mode in (dict(), dict(scan=False), dict(fused=False)):
        kernels.reset_launches()
        out, _, meta = th.run_training(12, seed=1, device=cuda, **mode)
        outs.append((out, dict(kernels.LAUNCHES)))
        if not mode:
            captures = meta["timer"].counters["graph.captures"]
    (o0, n0), rest = outs[0], outs[1:]
    assert captures == 2
    assert n0["stp_scan"] == 2 * captures
    assert n0["neuron_scan"] == 2 * captures
    for o, n in rest:
        assert n["stp_scan"] == 12
        for k in o0:
            np.testing.assert_array_equal(o[k], o0[k], err_msg=k)


def test_capture_runs_under_sync_debug_error(cuda, monkeypatch):
    """The capture runs under ``set_sync_debug_mode("error")`` and puts
    the previous mode back."""
    init, trial, meta = th.make_experiment(
        generator=torch.Generator().manual_seed(2), device=cuda)
    draws = meta["draw"](torch.Generator().manual_seed(3), [1, 2])
    modes = []
    real = meta["core"].run

    def run(*args, **kw):
        modes.append(torch.cuda.get_sync_debug_mode())
        return real(*args, **kw)
    monkeypatch.setattr(meta["core"], "run", run)
    before = torch.cuda.get_sync_debug_mode()
    th.TrialGraph(th.TrialLoop(trial, init(), [1, 2], draws))
    assert modes == [before, 2]               # warm-up, then the capture
    assert torch.cuda.get_sync_debug_mode() == before


def test_capture_of_a_host_read_raises(cuda, monkeypatch):
    """A trial that reads the host fails to capture: ``make_scanned_
    training`` raises and runs no trial eagerly in its place (the trial is
    entered twice, warm-up and capture, not once a trial)."""
    init, trial, meta = th.make_experiment(
        generator=torch.Generator().manual_seed(2), device=cuda)
    stims = th.stimuli(5)
    draws = meta["draw"](torch.Generator().manual_seed(3), stims)
    calls = []
    real = meta["core"].run

    def run(state, events, addr, **kw):
        calls.append(len(calls))
        float(events.sum())                     # a device-to-host read
        return real(state, events, addr, **kw)
    monkeypatch.setattr(meta["core"], "run", run)
    with pytest.raises(RuntimeError):
        th.make_scanned_training(meta)(init(), stims, draws)
    torch.cuda.synchronize()
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# The verification layer on the card: telemetry, fault hooks, screening,
# calibration
# ---------------------------------------------------------------------------

def _inst_on(inst, dev):
    """An instance dict (neuron parameters nested) moved to ``dev``."""
    return {k: (v.to(dev) if torch.is_tensor(v) else
                {n: x.to(dev) for n, x in v.items()})
            for k, v in inst.items()}


def _full_width_plan(prefix=(16,), rows=256, cols=512):
    return sample_fault_plan(rows, cols, np.random.default_rng(3),
                             prefix=prefix, p_dead_row=0.02,
                             p_dead_neuron=0.01, p_hot_neuron=0.01,
                             p_stuck_w=0.001, p_cadc=0.02, seed=1)


def _graph_run(cuda, stims, seed, **kw):
    ecfg = th.RSTDPConfig(n_inputs=128, n_neurons=512, pattern_size=24,
                          trial_steps=128)
    init, trial, meta = th.make_experiment(
        cfg=BSS2, ecfg=ecfg, prefix=(16,), backend="blocked",
        generator=torch.Generator().manual_seed(11), device=cuda, **kw)
    draws = meta["draw"](torch.Generator().manual_seed(seed), stims)
    graph = th.TrialGraph(th.TrialLoop(trial, init(), stims, draws))
    for _ in stims:
        graph.replay()
    torch.cuda.synchronize()
    return graph, trial, init, draws


@pytest.mark.parametrize("faulted", [False, True])
def test_telemetry_on_off_full_width_graph(cuda, faulted):
    """Six full-width trials as graph replays with telemetry on and off
    (and under a fault plan): histories and final state bit-equal, the
    same kernels a replay, and the counters equal to six eager trials'."""
    stims = [1, 2, 0, 1, 2, 0]
    faults = _full_width_plan() if faulted else None
    g_on, trial, init, draws = _graph_run(cuda, stims, 12, telemetry=True,
                                          faults=faults)
    g_off, *_ = _graph_run(cuda, stims, 12, faults=faults)
    assert g_on.launches == g_off.launches
    h_on, h_off = g_on.loop.history(), g_off.loop.history()
    for k in h_off:
        assert torch.equal(h_on[k], h_off[k]), k
    s_on, s_off = g_on.loop.state, g_off.loop.state
    assert s_off.tele is None
    for a, b in zip(th._leaves(s_on.core), th._leaves(s_off.core)):
        assert torch.equal(a, b)
    st = init()
    for i, s in enumerate(stims):
        st, _ = trial(st, s, draws.events[i], draws.xi[i])
    got = obs_trace.summary(s_on.tele)
    assert got == obs_trace.summary(st.tele)
    assert got["trials"] == 6 and got["gated_windows"] == 12
    if faulted:
        assert got["faults_injected"] == faults.total_sites


@pytest.mark.parametrize("route", ["never", "always", "auto"])
def test_faulted_window_on_card_matches_cpu(cuda, route):
    """A faulted window per synaptic route (the auto window above the
    census floor, decided on the device) on the card against the CPU:
    spikes equal up to flips at threshold, rate counters equal in the
    columns without a flip, membranes within 1e-4."""
    rows, cols, T, prefix = 128, 256, 128, (2,)
    cfg = dataclasses.replace(BSS2, n_rows=rows, n_cols=cols)
    inst = sample_instance(cfg, torch.Generator().manual_seed(3), prefix,
                           device="cpu")
    fp = _full_width_plan(prefix, rows, cols)
    rng = np.random.default_rng(4)
    p = 0.004 if route != "never" else 0.05
    ev = t((rng.random((T, *prefix, rows)) < p).astype(np.float32))
    ad = torch.zeros(ev.shape, dtype=torch.int8)
    w = t(rng.integers(20, 64, (*prefix, rows, cols)).astype(np.int8))
    outs = {}
    for dev in ("cpu", cuda):
        core = AnnCore(cfg, _inst_on(inst, dev), backend="blocked",
                       const_addr=True, sparse_mode=route, faults=fp)
        st = core.init_state(prefix)
        st = st._replace(syn=st.syn._replace(weights=w.to(dev)))
        synapse.reset_route_counts()
        s, o = core.run(st, ev.to(dev), ad.to(dev), record_v=True)
        outs[str(dev)] = (s, o, synapse.route_counts(dev).tolist())
    (s_c, o_c, r_c), (s_g, o_g, r_g) = outs["cpu"], outs[str(cuda)]
    assert r_g == r_c
    if route == "auto":
        assert r_g == [0, 2]
    sp_g = o_g["spikes"].cpu()
    assert float(o_c["spikes"].sum()) > 0
    assert_spikes_match(sp_g, o_c["spikes"], o_g["v"].cpu(), o_c["v"],
                        (inst["neuron_params"]["v_thres"]
                         + 2.0 * inst["neuron_params"]["delta_t"]).numpy())
    keep = ~(sp_g != o_c["spikes"]).any(0)
    assert torch.equal(s_g.rate_counters.cpu()[keep],
                       s_c.rate_counters[keep])
    torch.testing.assert_close(o_g["v"].cpu(), o_c["v"], rtol=1e-4,
                               atol=1e-4)


def test_store_hook_on_ppuvm_exec(cuda):
    """``run_program_fixed`` under store faults on the card (``ppuvm_exec``
    then the hook): weights equal to the CPU's bit for bit, the flips and
    zeros where the plan puts them."""
    N, R, C = 2, 64, 96
    cfg = dataclasses.replace(BSS2, n_rows=R, n_cols=C)
    inst = sample_instance(cfg, torch.Generator().manual_seed(2), (N,),
                           device="cpu")
    rng = np.random.default_rng(5)
    flip = np.where(rng.random((N, R, C)) < 0.1,
                    1 << rng.integers(0, 6, (N, R, C)), 0).astype(np.int32)
    fp = FaultPlan(store_flip=flip, store_zero=rng.random((N, R, C)) < 0.05)
    w = t(rng.integers(0, 64, (N, R, C)).astype(np.int8))
    ac = t(rng.uniform(0, 30, (N, R, C)).astype(np.float32))
    outs = []
    for dev in ("cpu", cuda):
        inst_d = _inst_on(inst, dev)
        st = AnnCore(cfg, inst_d).init_state((N,))
        st = st._replace(syn=st.syn._replace(weights=w.to(dev)),
                         corr=st.corr._replace(a_causal=ac.to(dev)))
        words = torch.as_tensor(programs.rstdp_program(eta=0.0), device=dev)
        n0 = kernels.LAUNCHES["ppuvm_exec"]
        st2, _ = VectorUnit(cfg, inst_d, faults=fp).run_program_fixed(
            st, words)
        outs.append((st2.syn.weights.cpu(), kernels.LAUNCHES["ppuvm_exec"]
                     - n0))
    (w_c, _), (w_g, n_g) = outs
    torch.cuda.synchronize()
    assert n_g == 1 and torch.equal(w_g, w_c)
    want = np.where(fp.store_zero, 0, w.numpy() ^ flip)
    np.testing.assert_array_equal(w_g.numpy(), want)


def test_faulted_apply_rstdp_bit_equal(cuda):
    """``apply_rstdp`` under CADC offsets and stuck columns (an injection
    plan and a blacklist's stuck columns) launches ``ppu_update`` with the
    folded CADC map and equals the CPU's (the hooked read followed by the
    rule) bit for bit: weights and eligibility."""
    N, R, C = 3, 200, 300
    cfg = dataclasses.replace(BSS2, n_rows=R, n_cols=C)
    inst = sample_instance(cfg, torch.Generator().manual_seed(9), (N,),
                           device="cpu")
    rng = np.random.default_rng(6)
    fp = FaultPlan(cadc_code_offset=rng.integers(-40, 40, (N, C)),
                   cadc_stuck_mask=rng.random((N, C)) < 0.1,
                   cadc_stuck_code=rng.integers(0, 256, (N, C)).astype(
                       np.int32))
    bl = Blacklist(rows=np.zeros((N, R), bool),
                   neurons=rng.random((N, C)) < 0.05)
    overlay = chain(fp, bl.as_faults(inst))
    w = t(rng.integers(0, 64, (N, R, C)).astype(np.int8))
    ac, aa = (t(rng.uniform(0, 40, (N, R, C)).astype(np.float32))
              for _ in range(2))
    xi = t((0.3 * rng.standard_normal((N, R, C))).astype(np.float32))
    reward = t(rng.integers(0, 2, (N, C)).astype(np.float32))
    outs = []
    for dev in ("cpu", cuda):
        inst_d = _inst_on(inst, dev)
        st = AnnCore(cfg, inst_d).init_state((N,))
        st = st._replace(syn=st.syn._replace(weights=w.to(dev)),
                         corr=st.corr._replace(a_causal=ac.to(dev),
                                               a_acausal=aa.to(dev)))
        rs = dict(mean_reward=torch.full((N, C), 0.25, device=dev))
        n0 = kernels.LAUNCHES["ppu_update"]
        s, _, elig = VectorUnit(cfg, inst_d, faults=overlay).apply_rstdp(
            st, rs, reward=reward.to(dev), eta=4.0, xi=xi.to(dev))
        outs.append((s.syn.weights.cpu(), elig.cpu(),
                     kernels.LAUNCHES["ppu_update"] - n0))
    torch.cuda.synchronize()
    (w_c, e_c, _), (w_g, e_g, n_g) = outs
    assert n_g == 1
    assert torch.equal(w_g, w_c) and torch.equal(e_g, e_c)


def test_screen_on_card_matches_cpu(cuda):
    """``screen`` of a faulted chip (2 instances of 256 x 512) on the card
    equals the CPU's screen of the same instance and plan, and finds the
    planted dead rows, hot and dead neurons and CADC columns."""
    prefix = (2,)
    inst = sample_instance(BSS2, torch.Generator().manual_seed(4), prefix,
                           device="cpu")
    fp = _full_width_plan(prefix)
    bls = []
    for dev in ("cpu", cuda):
        inst_d = _inst_on(inst, dev)
        bls.append(screen(AnnCore(BSS2, inst_d, const_addr=True, faults=fp),
                          VectorUnit(BSS2, inst_d, faults=fp)))
    bl_c, bl_g = bls
    np.testing.assert_array_equal(bl_g.rows, bl_c.rows)
    np.testing.assert_array_equal(bl_g.neurons, bl_c.neurons)
    np.testing.assert_array_equal(bl_g.rows, fp.dead_rows)
    # a column stuck within the margin (2 codes) of its zero baseline
    # reads like a healthy one: no probe can tell it apart
    visible = fp.cadc_stuck_mask & (np.abs(
        fp.cadc_stuck_code - cadc_zero_code(inst)) > 2)
    assert (bl_g.neurons >= (fp.hot_neurons | fp.dead_neurons
                             | visible)).all()


def test_capture_with_a_host_plan_in_the_body_raises(cuda, monkeypatch):
    """The plan really is device-resident: the experiment's core holds
    device plans, and a core made to hold the host ``FaultPlan`` instead
    (each hook then copies it to the card inside the trial) fails to
    capture under the sync-debug mode, after an eager warm-up that
    runs."""
    fp = _full_width_plan((), 32, 16)
    init, trial, meta = th.make_experiment(
        generator=torch.Generator().manual_seed(2), device=cuda, faults=fp)
    assert all(isinstance(p, inject.DevicePlan) for p in meta["core"].faults)
    stims = th.stimuli(3)
    draws = meta["draw"](torch.Generator().manual_seed(3), stims)
    th.make_scanned_training(meta)(init(), stims, draws)     # captures
    init, trial, meta = th.make_experiment(
        generator=torch.Generator().manual_seed(2), device=cuda, faults=fp)
    monkeypatch.setattr(meta["core"], "faults", (fp,))
    trial(init(), 1, draws.events[0], draws.xi[0])           # eager: runs
    with pytest.raises(RuntimeError):
        th.make_scanned_training(meta)(init(), stims, draws)
    torch.cuda.synchronize()


def test_second_scanned_run_replays_the_graph(cuda):
    """After a summary read and a report, a second run of the same shapes
    replays the captured graph (no capture) and equals a fresh
    experiment's run."""
    init, _, meta = th.make_experiment(
        generator=torch.Generator().manual_seed(2), device=cuda,
        telemetry=True)
    scanned = th.make_scanned_training(meta)
    stims = th.stimuli(4)
    d1 = meta["draw"](torch.Generator().manual_seed(1), stims)
    d2 = meta["draw"](torch.Generator().manual_seed(2), stims)
    state, _ = scanned(init(), stims, d1)
    n = meta["timer"].counters["graph.captures"]
    obs_report.build_report("t", telemetry=obs_trace.summary(state.tele))
    state2, hist2 = scanned(init(), stims, d2)
    assert meta["timer"].counters["graph.captures"] == n
    init_f, _, meta_f = th.make_experiment(
        generator=torch.Generator().manual_seed(2), device=cuda,
        telemetry=True)
    state_f, hist_f = th.make_scanned_training(meta_f)(init_f(), stims, d2)
    for k in hist_f:
        assert torch.equal(hist2[k], hist_f[k]), k
    assert obs_trace.summary(state2.tele) == obs_trace.summary(state_f.tele)


def test_run_modes_bit_equal_under_faults_and_telemetry(cuda):
    """``run_training``'s three modes on the card under a fault plan with
    telemetry: histories and counters bit-equal."""
    fp = _full_width_plan((), 32, 16)
    outs = [th.run_training(12, seed=1, device=cuda, faults=fp,
                            telemetry=True, **mode)[0]
            for mode in (dict(), dict(scan=False), dict(fused=False))]
    for o in outs[1:]:
        assert o["telemetry"] == outs[0]["telemetry"]
        for k in outs[0]:
            if k != "telemetry":
                np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)
    assert outs[0]["telemetry"]["faults_injected"] == fp.total_sites


@pytest.mark.parametrize("shape", [(128,), (16, 256)])
def test_calibration_on_card_matches_cpu(cuda, shape):
    off = t((0.25 * np.random.default_rng(1).standard_normal(shape))
            .astype(np.float32))
    c_c, m_c = calibrate_stp(BSS2, off)
    c_g, m_g = calibrate_stp(BSS2, off.to(cuda))
    assert torch.equal(c_g.cpu(), c_c)
    for k in m_c:
        torch.testing.assert_close(m_g[k].cpu(), m_c[k], rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# The wafer: the inter-chip router and run_training(wafer=K) on the card
# ---------------------------------------------------------------------------

def _wafer_plan(K, kind, R=16, C=8, per_link=4, seed=0):
    from repro_torch.wafer import WaferTopology, make_plan
    rng = np.random.default_rng(seed)
    routes = [(s, int(rng.integers(C)), d, int(rng.integers(R)), 7)
              for s in range(K)
              for d in ([(s + 1) % K] if kind == "ring" else range(K))
              for _ in range(per_link)]
    return make_plan(WaferTopology(K, kind), R, C, routes)


@pytest.mark.parametrize("kw", [dict(link_mode="dense"),
                                dict(link_mode="compact"),
                                dict(link_mode="auto"),
                                dict(link_mode="compact", link_budget=4),
                                dict(link_mode="auto", link_step_budget=1)])
@pytest.mark.parametrize("kind", ["ring", "all2all"])
def test_router_on_card_matches_cpu(cuda, kind, kw):
    """``route()`` on the card: the delivered grids of three windows (the
    forwards of a rerouted plan fed back through ``routed_in``, a dead
    and a flaky link) and the link counters equal the CPU's bit for
    bit."""
    from repro_torch.wafer import InterChipRouter, reroute_plan
    plan = _wafer_plan(4, kind)
    if kind == "all2all":
        plan, _ = reroute_plan(plan, [(0, 2)])
    links = plan.topology.links()
    fp = FaultPlan(dead_links=np.array([sd == (0, 2) for sd in links]),
                   flaky_links=np.where([sd == (1, 2) for sd in links],
                                        np.float32(0.5), np.float32(0.0)),
                   seed=3)
    sp = t((np.random.default_rng(1).random((32, 4, 8)) < 0.4)
           .astype(np.float32))
    outs = []
    for dev in ("cpu", cuda):
        r = InterChipRouter(plan, device=dev, faults=fp, **kw)
        tele, g = obs_trace.init_telemetry(dev), r.init_buffer(32)
        grids = []
        for _ in range(3):
            g, tele = r.route(sp.to(dev), tele, routed_in=g)
            grids.append(g.cpu())
        outs.append((grids, obs_trace.summary(tele)))
    (g_c, s_c), (g_g, s_g) = outs
    for a, b in zip(g_g, g_c):
        assert torch.equal(a, b)
    assert s_g == s_c and s_c["routed_events"] > 0


def test_wafer_run_modes_bit_equal_on_card(cuda):
    """``run_training(wafer=2)`` on the card: the captured trial graph
    (the routed slot carried from replay to replay), eager trials and
    the host loop give the same histories and counters."""
    ecfg = th.RSTDPConfig(trial_steps=128)
    outs = [th.run_training(9, ecfg=ecfg, seed=1, device=cuda, wafer=2,
                            telemetry=True, **mode)[0]
            for mode in (dict(), dict(scan=False), dict(fused=False))]
    for o in outs[1:]:
        assert o["telemetry"] == outs[0]["telemetry"]
        for k in outs[0]:
            if k != "telemetry":
                np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)
    assert outs[0]["telemetry"]["routed_events"] > 0


def test_wafer_chip_count_parity_on_card(cuda):
    """tests/test_wafer.py::TestClosedLoop::test_chip_count_parity_with_
    relay on the card: K = 1, 2, 4 give the same global weights and
    rewards bit for bit, and K times the routed events."""
    ecfg = th.RSTDPConfig(trial_steps=128)
    outs = {K: th.run_training(8, ecfg=ecfg, seed=0, device=cuda, wafer=K,
                               telemetry=True)[0] for K in (1, 2, 4)}

    def glob(w):
        return np.asarray(w).transpose(1, 0, 2).reshape(w.shape[1], -1)
    r1 = outs[1]["telemetry"]["routed_events"]
    assert r1 > 0
    for K in (2, 4):
        np.testing.assert_array_equal(glob(outs[1]["w_signed_final"]),
                                      glob(outs[K]["w_signed_final"]))
        np.testing.assert_array_equal(outs[1]["reward"].reshape(8, -1),
                                      outs[K]["reward"].reshape(8, -1))
        assert outs[K]["telemetry"]["routed_events"] == K * r1


# ---------------------------------------------------------------------------
# The network mapper on the card (path F)
# ---------------------------------------------------------------------------

def test_mapped_run_on_card_matches_cpu(cuda):
    """``MappedRuntime.run`` on the card against the CPU: each window of
    the card's run again on the CPU from the card's state and routed
    grid, spikes equal up to flips at threshold and the routed grids bit
    for bit where no spike flipped; the instance drawn once and placed."""
    from repro_torch import mapper
    spec = mapper.random_spec(np.random.default_rng(0), 20, 30, fan_out=4,
                              rec_fan_out=3, dale=False)
    m = mapper.map_network(spec, 2, chip_rows=mapper.min_chip_rows(
        spec, 2, 17) + 8, chip_cols=17)
    ni = mapper.sample_network_instance(
        spec, torch.Generator().manual_seed(3), device="cpu")
    rt_g = mapper.build_runtime(m, net_inst=ni, device=cuda)
    rt_c = mapper.build_runtime(m, net_inst=ni, device="cpu")
    ev_in = t((np.random.default_rng(1).random((3, 24, 20)) < 0.25)
              .astype(np.float32))
    _, free = rt_g.run(ev_in.to(cuda))
    assert free["spikes"].shape == (3, 24, 30) and free["spikes"].sum() > 0
    ev_g, ad_g = rt_g.place(ev_in.to(cuda))
    ev_c, ad_c = rt_c.place(ev_in)
    p = rt_c.inst["neuron_params"]
    thr = (p["v_thres"] + 2.0 * p["delta_t"]).numpy()
    st, routed = rt_g.init_state(), rt_g.router.init_buffer(24)
    for w in range(3):
        st_c, routed_c = _to_cpu(st), routed.cpu()
        st, o_g = rt_g.core.run_routed(st, routed, ev_g[w], ad_g[w],
                                       rt_g.router, record_v=True)
        _, o_c = rt_c.core.run_routed(st_c, routed_c, ev_c[w], ad_c[w],
                                      rt_c.router, record_v=True)
        assert_spikes_match(o_g["spikes"].cpu(), o_c["spikes"],
                            o_g["v"].cpu(), o_c["v"], thr)
        if torch.equal(o_g["spikes"].cpu(), o_c["spikes"]):
            assert torch.equal(o_g["routed"].cpu(), o_c["routed"])
        routed = o_g["routed"]


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return type(tree)(*(_to_cpu(v) for v in tree))


def test_path_f_chip_count_parity_on_card(cuda):
    """``chip_smoke.py``'s path F: the 480 x 2048 spec on four native
    256 x 512 chips, two 490 x 1024 and one 968 x 2048 chip, the same
    instance and stimulus: spec-order spikes bit for bit over 4 windows
    of T = 128, every path kernel launched by the K = 4 run."""
    import _torch_mapper
    from repro_torch import mapper
    spec = _torch_mapper.path_f_spec()
    maps = _torch_mapper.path_f_mappings(spec)
    ni = mapper.sample_network_instance(
        spec, torch.Generator().manual_seed(31), cfg=BSS2, device=cuda)
    ev_in = t((np.random.default_rng(13).random((4, 128, spec.n_in))
               < 0.05).astype(np.float32)).to(cuda)
    spikes = {}
    for K in (4, 2, 1):
        rt = mapper.build_runtime(maps[K], cfg=BSS2, net_inst=ni,
                                  device=cuda)
        kernels.reset_launches()
        spikes[K] = rt.run(ev_in)[1]["spikes"]
        if K == 4:
            for k in ("stp_scan", "synray", "synray_sparse", "neuron_scan",
                      "corr"):
                assert kernels.LAUNCHES[k] > 0, k
            # every window's halves are gated: the scan takes the censuses
            assert kernels.LAUNCHES["census"] == 0
    assert spikes[1].sum() > 0
    assert torch.equal(spikes[4], spikes[1])
    assert torch.equal(spikes[2], spikes[1])


@pytest.mark.parametrize("N,R,C", [(4, 256, 512), (2, 490, 1024),
                                   (1, 968, 2048), (4, 264, 528),
                                   (3, 16, 20), (2, 18, 8), (4, 10, 4)])
def test_path_f_kernels_at_mapped_geometries(cuda, N, R, C):
    """Every kernel of a mapped window against its plain version at the
    mapper's geometries: Dale halves of 128, 245 (odd), 484 and 132 rows,
    C = 512, 1024, 2048 and 528, and the tier-1 tests' narrow widths (C =
    20, 8, 4; halves of 8, 9 and 5 rows): ``stp_scan``, ``census``,
    ``neuron_scan`` and ``corr`` bit for bit; ``synray`` (const-address
    form bit-equal to the general one) and ``synray_sparse`` within
    rtol = atol = 1e-4 of their plain versions, and ``synray_sparse``
    bit-equal to ``synray`` on the windows that fit."""
    from repro_torch.core import stp
    rng = np.random.default_rng(R + C)
    T = 128

    def dev(x):
        return t(np.ascontiguousarray(x)).to(cuda)
    sp = dev((rng.random((T, N, R)) < 0.05).astype(np.float32))
    r0 = dev(rng.random((N, R)).astype(np.float32))
    scale = dev(rng.normal(1.0, 0.25, (N, R)).astype(np.float32))
    skw = dict(u=0.2, recovery=stp.recovery_factor(20.0, 0.2))
    for a, b in zip(stp_ops.stp_scan(r0, sp, scale, **skw),
                    stp_scan_ref(r0, sp, scale, **skw)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    caps = tuple((events.default_max_events(T, len(range(h, R, 2)), 0.02),
                  events.default_k_cap(len(range(h, R, 2)), 0.02))
                 for h in (0, 1))
    for a, b in zip(stp_ops.stp_scan(r0, sp, scale, caps=caps, **skw),
                    stp_scan_census_ref(r0, sp, scale, caps=caps, **skw)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))

    w = dev(rng.integers(0, 64, (N, R, C), dtype=np.int8))
    a = dev(rng.integers(0, 4, (N, R, C), dtype=np.int8))
    ea = dev(np.broadcast_to(rng.integers(0, 4, (N, R), dtype=np.int8),
                             (T, N, R)))
    currents = []
    for p in (0.01, 0.08):                  # fits / overflows the caps
        eff = dev(((rng.random((T, N, R)) < p)
                   * rng.uniform(0.2, 1.2, (T, N, R))).astype(np.float32))
        for h in (0, 1):
            ev, eah = eff[..., h::2], ea[..., h::2]
            wh, ah = w[:, h::2], a[:, h::2]
            Rh = ev.shape[-1]
            me = events.default_max_events(T, Rh, 0.02)
            kc = events.default_k_cap(Rh, 0.02)
            flag = census_ops.census(ev, me, kc)
            assert torch.equal(flag, census_ref(ev, me, kc))
            dense = synray_ops.synaptic_current(ev, eah, wh, ah,
                                                const_addr=True)
            assert torch.equal(dense, synray_ops.synaptic_current(
                ev, eah, wh, ah))
            torch.testing.assert_close(
                dense, synaptic_current_ref(ev, eah, wh, ah), rtol=1e-4,
                atol=1e-4)
            sparse = sparse_ops.sparse_current_window(
                ev, eah, wh, ah, max_events=me, k_cap=kc)
            recs = events.regroup_window(ev.permute(1, 0, 2),
                                         eah.permute(1, 0, 2), me, kc)
            torch.testing.assert_close(
                sparse, sparse_window_ref(*recs, wh, ah).permute(1, 0, 2),
                rtol=1e-4, atol=1e-4)
            if int(flag[0]):
                assert torch.equal(sparse, dense)
            currents.append(dense * 60.0)

    cfg = dataclasses.replace(BSS2, n_rows=R, n_cols=C)
    inst = sample_instance(cfg, torch.Generator().manual_seed(R), (N,),
                           device=cuda)
    prm = inst["neuron_params"]
    st0 = adex.init_state((N, C), prm)
    rc0 = torch.zeros((N, C), device=cuda)
    nkw = dict(dt=cfg.dt, use_adex=True, decays=adex.decay_factors(
        prm, cfg.dt), record_v=True)
    g = neuron_ops.neuron_window(st0, rc0, currents[2], currents[3], prm,
                                 **nkw)
    r = neuron_window_ref(st0, rc0, currents[2], currents[3], prm, **nkw)
    for x, y in zip((*g[0], g[1], *g[2]), (*r[0], r[1], *r[2])):
        assert torch.equal(x, y)

    post = g[2][0]
    ops = (sp, post, dev(rng.random((N, R), dtype=np.float32)),
           dev(rng.random((N, C), dtype=np.float32)),
           dev(rng.uniform(0, 1023, (N, R, C)).astype(np.float32)),
           dev(rng.uniform(0, 1023, (N, R, C)).astype(np.float32)))
    for x, y in zip(corr_ops.correlation_window(*ops, lam=0.96),
                    correlation_window_ref(*ops, lam=0.96)):
        assert torch.equal(x, y)


def _sharded_ranks(tmp_path, world, part, timeout=300):
    """``world`` ranks of ``tests/_torch_wafer_sharded.py`` on NCCL, one
    card a rank, running ``part``, all under one time limit (a rank that
    captures while another runs eagerly hangs: the limit fails it).
    Returns each rank's output; fails on a rank's exit code."""
    import os
    import subprocess
    import sys
    import time
    from pathlib import Path
    here = Path(__file__).resolve().parent
    env = dict(os.environ, OMP_NUM_THREADS="1")
    store = tmp_path / f"store_{part}_{world}"
    # each rank writes to a file: a pipe read one rank after another could
    # fill and stall a rank that the others wait for in a collective
    logs = [tmp_path / f"{part}_{world}_rank{rank}.log"
            for rank in range(world)]
    procs = []
    try:
        for rank, path in enumerate(logs):
            with open(path, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, str(here / "_torch_wafer_sharded.py"),
                     str(rank), str(world), str(store), "nccl", part],
                    stdout=f, stderr=subprocess.STDOUT, env=env))
        t_end = time.time() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, t_end - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [path.read_text(errors="replace") for path in logs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out[-6000:]}"
    return outs


def test_sharded_transport_on_nccl(cuda, tmp_path):
    """``tests/_torch_wafer_sharded.py`` on NCCL, one card a rank (4 ranks
    where four cards are present, else 2): the sharded router and the
    mapped runtime under a group equal to the local ones, its window loop
    replaying one captured window with the transport's collectives inside
    (ring and all2all) equal to its eager windows (part ``transport``);
    the faulted mapped runtime and ``run_training(wafer=4, group=)``, whose
    trials replay captured trial graphs with the collectives inside (the
    second, with the spans' marks, for a call's last trial), equal to the
    local transport's slice (part ``gaps``). NCCL takes no
    two ranks on one card, so this needs two cards or more."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards or more: NCCL takes one card a rank")
    world = 4 if n >= 4 else 2
    for part, cases in (("transport", 18), ("gaps", 6)):
        for rank, out in enumerate(_sharded_ranks(tmp_path, world, part)):
            assert f"WAFER_SHARDED_OK rank={rank} cases={cases}" in out, \
                (part, out)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_mapped_path_f_on_nccl(cuda, tmp_path, world):
    """Path F's K = 4 mapping (480 x 2048 on four 256 x 512 chips) under
    ``world`` NCCL ranks, one card a rank (part ``path_f`` of
    ``tests/_torch_wafer_sharded.py``): each rank's window captured under
    ``set_sync_debug_mode("error")`` with the sharded transport's
    collectives inside, its replays equal to its eager windows bit for bit
    (state, spikes, routed grid, counters, route counts; a replay launching
    what an eager window launches), the gathered spikes equal to the local
    K = 4 runtime's and to one 968 x 2048 chip's. A world of 1 runs on
    one card (the group's all-gather over one rank is captured); 2 and 4
    skip where the cards are too few."""
    import json
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} cards: NCCL takes one card a rank")
    outs = _sharded_ranks(tmp_path, world, "path_f", timeout=600)
    for rank, out in enumerate(outs):
        assert f"WAFER_SHARDED_OK rank={rank} cases=4" in out, out
        rec = json.loads(next(line for line in out.splitlines()
                              if line.startswith("PATH_F_GROUPED "))
                         .split(" ", 1)[1])
        assert (rec["world"], rec["rank"]) == (world, rank)
        assert rec["chips"] == [rank * 4 // world, (rank + 1) * 4 // world]
        for k in ("stp_scan", "neuron_scan", "corr"):
            assert rec["launches_a_replay"][k] == 1, rec["launches_a_replay"]
        print(f"world {world} rank {rank}: " + json.dumps(
            {k: rec[k] for k in ("ms_a_window", "capture_ms", "pool_mib",
                                 "trace")}))


def _replay_equals_eager(rt, ev_in):
    """``_torch_mapper.replay_against_eager``: ``rt.run``'s replays and
    its eager windows, from fresh counters, give the same state, spikes,
    routed grid, counters and route counts bit for bit, and a replay
    launches what an eager window launches. Returns the replayed run's
    output."""
    import _torch_mapper
    graph, differ, out, _, _ = _torch_mapper.replay_against_eager(rt, ev_in)
    assert graph is not None and not differ, differ
    assert out["spikes"].sum() > 0
    return out


@pytest.mark.parametrize("geometry", ["k4", "k2", "k1", "blacklist"])
def test_mapped_run_replay_equals_eager_at_path_f(cuda, geometry):
    """Path F's 480 x 2048 spec on four 256 x 512, two 490 x 1024 and one
    968 x 2048 chip, and on the blacklisted four 264 x 528 chips (its bad
    sites killed by faults), over 4 windows of T = 128: ``run``'s replays
    equal its eager windows bit for bit (``_replay_equals_eager``), and
    every geometry's spec-order spikes equal the K = 1 run's."""
    import _torch_mapper
    from repro_torch import mapper
    spec = _torch_mapper.path_f_spec()
    ni = mapper.sample_network_instance(
        spec, torch.Generator().manual_seed(31), cfg=BSS2, device=cuda)
    ev_in = t((np.random.default_rng(13).random((4, 128, spec.n_in))
               < 0.05).astype(np.float32)).to(cuda)
    if geometry == "blacklist":
        m, _, fp = _torch_mapper.path_f_blacklist(spec)
        rt = mapper.build_runtime(m, cfg=BSS2, net_inst=ni, faults=fp,
                                  device=cuda)
    else:
        m = _torch_mapper.path_f_mappings(spec)[int(geometry[1])]
        rt = mapper.build_runtime(m, cfg=BSS2, net_inst=ni, device=cuda)
    out = _replay_equals_eager(rt, ev_in)
    # every window gated: each half's route counted once a window
    assert sum(synapse.route_counts(cuda).tolist()) == 2 * 4
    m1 = _torch_mapper.path_f_mappings(spec)[1]
    _, o1 = mapper.build_runtime(m1, cfg=BSS2, net_inst=ni,
                                 device=cuda).run(ev_in, eager=True)
    assert torch.equal(out["spikes"], o1["spikes"])


@pytest.mark.parametrize("case", ["ring_relay", "link_faults", "compact",
                                  "k4_blocked"])
def test_mapped_run_replay_equals_eager_small(cuda, case):
    """The small runtimes of ``tests/test_torch_mapper_loop.py`` on the
    card (blocked backend): a ring plan with a relayed edge (the forward
    rule reads last window's routed grid inside the graph), dead and
    flaky links, the compact link mode's stream cumsums; replay equals
    eager bit for bit, the forwards and overflows counted."""
    import _torch_mapper
    rt, ev = _torch_mapper.small_runtime(case, telemetry=False, W=4, T=32,
                                         device=cuda, backend="blocked")
    out = _replay_equals_eager(rt, t(ev).to(cuda))
    summ = obs_trace.summary(out["telemetry"])
    bites = {"ring_relay": "link_reroutes", "compact": "link_overflows",
             "link_faults": "faults_injected"}.get(case)
    if bites:
        assert summ[bites] > 0, bites


def test_mapped_capture_under_sync_debug_error(cuda, monkeypatch):
    """``run``'s capture runs under ``set_sync_debug_mode("error")`` and
    puts the previous mode back: the window body is entered twice (warm-up
    and capture), not once a window. A window that reads the host fails to
    capture: ``run`` raises, keeps no loop and runs no window eagerly in
    its place."""
    import _torch_mapper
    rt, ev = _torch_mapper.small_runtime("k2_fused", telemetry=True,
                                         device=cuda, backend="blocked")
    ev = t(ev).to(cuda)
    modes = []
    real = rt.core.run_routed

    def run_routed(*args, **kw):
        modes.append(torch.cuda.get_sync_debug_mode())
        return real(*args, **kw)
    monkeypatch.setattr(rt.core, "run_routed", run_routed)
    before = torch.cuda.get_sync_debug_mode()
    rt.run(ev)
    rt.run(ev)                                  # a replay: no body
    assert modes == [before, 2]
    assert torch.cuda.get_sync_debug_mode() == before

    rt2, _ = _torch_mapper.small_runtime("k2_fused", telemetry=True,
                                         device=cuda, backend="blocked")
    calls = []
    real2 = rt2.core.run_routed

    def reads_host(state, routed, ev_t, *args, **kw):
        calls.append(float(ev_t.sum()))
        return real2(state, routed, ev_t, *args, **kw)
    monkeypatch.setattr(rt2.core, "run_routed", reads_host)
    with pytest.raises(RuntimeError):
        rt2.run(ev)
    torch.cuda.synchronize()
    assert not rt2.loops and len(calls) == 1    # the warm-up only


def test_mapped_replay_after_a_larger_eager_launch(cuda):
    """The K = 1 path-F window captured, then the K = 4 runtime run eagerly
    and a census-form ``stp_scan`` launch that grows the step-count buffer
    past what the capture saw: the K = 1 replay is unchanged (the graph
    keeps summing into the buffer it captured, ``stp_ops._HELD``)."""
    import _torch_mapper
    from repro_torch import mapper
    spec = _torch_mapper.path_f_spec()
    maps = _torch_mapper.path_f_mappings(spec)
    ni = mapper.sample_network_instance(
        spec, torch.Generator().manual_seed(31), cfg=BSS2, device=cuda)
    ev_in = t((np.random.default_rng(13).random((4, 128, spec.n_in))
               < 0.05).astype(np.float32)).to(cuda)
    rt1, rt4 = (mapper.build_runtime(maps[K], cfg=BSS2, net_inst=ni,
                                     device=cuda) for K in (1, 4))
    _, first = rt1.run(ev_in)
    _, o4 = rt4.run(ev_in, eager=True)
    held = stp_ops._COUNTS[ev_in.device].numel()
    kw = dict(u=0.2, recovery=float(1.0 - math.exp(-0.2 / 20.0)))
    T = held // 4 + 1
    r0, sp, scale = (t(x).to(cuda) for x in _stp_census_operands(
        T, (4,), 968, "bursts"))
    caps = tuple(synapse.route_plan(T, len(range(h, 968, 2)), 512,
                                    const_addr=True, sparse="always")[1:]
                 for h in (0, 1))
    stp_ops.stp_scan(r0, sp, scale, caps=caps, **kw)
    torch.cuda.synchronize()
    assert max(c.numel() for c in stp_ops._COUNTS.values()) > held
    _, again = rt1.run(ev_in)
    for k in ("spikes", "chip_spikes", "routed"):
        assert torch.equal(again[k], first[k]), k
    assert torch.equal(first["spikes"], o4["spikes"])
    _, eager = rt1.run(ev_in, eager=True)
    assert torch.equal(eager["chip_spikes"], first["chip_spikes"])


# ---------------------------------------------------------------------------
# LM serving (path G): the engine on the card against the CPU, reduced archs
# ---------------------------------------------------------------------------

LM_ARCHS = ("smollm-360m", "minitron-4b", "qwen1.5-0.5b", "phi4-mini-3.8b",
            "internvl2-2b", "moonshot-v1-16b-a3b", "llama4-scout-17b-a16e",
            "hymba-1.5b", "mamba2-130m")
# positions a request holds (prompt + prefix): three reduced SSD chunks of
# 16, six reduced sliding windows of 8
LM_POS = 48


def _lm_on(arch, dev, params=None):
    from repro_torch.parallel.sharding import init_params
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(arch, max_len=LM_POS + 8, device=dev)
    if params is None:
        params = init_params(eng.bundle.decls,
                             torch.Generator().manual_seed(0), device=dev)
    return eng, params


def _cpu_greedy_logits(bundle, params, batch, n_new, total):
    """The CPU's greedy run step by step: the logits [b, n_new, V] that
    chose each token."""
    from repro_torch.serve.engine import grow_cache
    with torch.no_grad():
        logits, cache = bundle.prefill(params, batch)
        cache = grow_cache(cache, total, total + n_new)
        out = [logits[:, -1]]
        for i in range(n_new - 1):
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            logits, cache = bundle.decode_step(params, cache, tok, total + i)
            out.append(logits[:, -1])
    return torch.stack(out, 1)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_serve_card_matches_cpu(cuda, name):
    """``ServeEngine.generate`` on the card and on the CPU with the same
    parameters, at ``LM_POS`` positions (the SSD's inter-chunk state pass
    and the sliding window both at work): the prefill logits within rtol
    = atol = 1e-4, and the greedy tokens equal up to a request's first
    flip, which is allowed only where the CPU's top-2 logit gap is under
    1e-4 (a near tie)."""
    from repro_torch.config import get_arch
    from repro_torch.models.transformer import prefix_len
    arch = get_arch(name).reduced()
    eng_c, p_c = _lm_on(arch, "cpu")
    p_g = _to_dev(p_c, cuda)
    eng_g, _ = _lm_on(arch, cuda, p_g)
    s = LM_POS - prefix_len(arch)
    prompts = np.random.default_rng(2).integers(0, arch.vocab, (2, s))
    out_c = eng_c.generate(p_c, prompts, n_new=6)
    out_g = eng_g.generate(p_g, prompts, n_new=6)
    batch = dict(tokens=torch.from_numpy(prompts))
    if arch.vit_dim:
        batch["patch_embeds"] = torch.zeros((2, arch.n_patches,
                                             arch.vit_dim))
    with torch.no_grad():
        lc, _ = eng_c.bundle.prefill(p_c, batch)
        lg, _ = eng_g.bundle.prefill(p_g, _to_dev(batch, cuda))
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-4,
                               atol=1e-4)
    steps = _cpu_greedy_logits(eng_c.bundle, p_c, batch, 6,
                               s + prefix_len(arch))
    assert torch.equal(out_c, steps.argmax(-1).to(torch.int32))
    for r in range(2):
        diff = (out_c[r] != out_g[r]).nonzero()
        if len(diff):
            gap = _top2_gap(steps[r, int(diff[0])])
            assert gap < 1e-4, (name, r, out_c[r], out_g[r], gap)


def _to_dev(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_dev(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _top2_gap(logits):
    t = torch.topk(logits.float(), 2).values
    return float(t[0] - t[1])


def test_serve_encoder_frames_card_matches_cpu(cuda):
    """hubert-xlarge (reduced): the prefill frame logits on the card
    against the CPU, within rtol = atol = 1e-4."""
    from repro_torch.config import get_arch
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel.sharding import ShardingCtx, init_params
    arch = get_arch("hubert-xlarge").reduced()
    bundle = build_model(arch, ShardingCtx())
    p_c = init_params(bundle.decls, torch.Generator().manual_seed(0),
                      device="cpu")
    frames = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, LM_POS, arch.frame_dim)).astype(np.float32))
    with torch.no_grad():
        lc, cc = bundle.prefill(p_c, dict(frames=frames))
        lg, cg = bundle.prefill(_to_dev(p_c, cuda),
                                dict(frames=frames.to(cuda)))
    assert cc == {} and cg == {}
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_serve_launches_no_port_kernel(cuda):
    """Path G runs PyTorch ops only: a generate on the card launches none
    of the port's CUDA kernels."""
    from repro_torch.config import get_arch
    eng, params = _lm_on(get_arch("hymba-1.5b").reduced(), cuda)
    kernels.reset_launches()
    eng.generate(params, np.ones((2, 12), np.int64), n_new=4)
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


# ---------------------------------------------------------------------------
# path H: LM training on the card
# ---------------------------------------------------------------------------

LM_TRAIN_SHAPE_S, LM_TRAIN_B = 16, 2


def _train_batch(arch, dev, seed=0):
    from repro_torch.config import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLMPipeline
    pipe = SyntheticLMPipeline(
        arch, ShapeConfig("t", LM_TRAIN_SHAPE_S + arch.n_meta_tokens
                          + (arch.n_patches if arch.vit_dim else 0),
                          LM_TRAIN_B, "train"), seed=seed)
    return pipe.next_batch(dev)


@pytest.mark.parametrize("name", ["smollm-360m", "qwen1.5-0.5b",
                                  "internvl2-2b", "moonshot-v1-16b-a3b",
                                  "hubert-xlarge", "hymba-1.5b",
                                  "mamba2-130m"])
def test_train_step_card_matches_cpu(cuda, name):
    """The loss and every gradient leaf of the reduced arch on the card
    against the CPU (rtol = atol = 1e-4), then one AdamW step from the
    same state: parameters within 1e-6 + 1e-5 |p|, except elements whose
    CPU gradient is under 1e-5 in size: AdamW's first step moves a
    parameter by lr g / (|g| + eps), so a gradient error dg moves it by
    ~lr eps dg / g^2, and near 0 by up to 2 lr."""
    from repro_torch.config import get_arch
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel.sharding import ShardingCtx, init_params
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init_decls,
                                             adamw_update)
    from repro_torch.train.steps import value_and_grad
    arch = get_arch(name).reduced()
    bundle = build_model(arch, ShardingCtx())
    p_c = init_params(bundle.decls, torch.Generator().manual_seed(0),
                      device="cpu")
    p_g = _to_dev(p_c, cuda)
    b_c = _train_batch(arch, "cpu")
    l_c, g_c = value_and_grad(bundle.loss, p_c, b_c)
    l_g, g_g = value_and_grad(bundle.loss, p_g, _to_dev(b_c, cuda))
    np.testing.assert_allclose(float(l_g), float(l_c), rtol=1e-4, atol=1e-4)
    leaves_c, leaves_g = _flat(g_c), _flat(g_g)
    for k in leaves_c:
        np.testing.assert_allclose(leaves_g[k].cpu().numpy(),
                                   leaves_c[k].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    cfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    o_c = init_params(adamw_init_decls(bundle.decls), device="cpu")
    o_g = init_params(adamw_init_decls(bundle.decls), device=cuda)
    adamw_update(p_c, g_c, o_c, cfg)
    adamw_update(p_g, g_g, o_g, cfg)
    pc, pg = _flat(p_c), _flat(p_g)
    for k in pc:
        a, b = pg[k].cpu().numpy(), pc[k].numpy()
        err = np.abs(a - b)
        bad = err > 1e-6 + 1e-5 * np.abs(b)
        assert (np.abs(leaves_c[k].numpy()[bad]) < 1e-5).all(), k
        assert (err <= 2 * cfg.lr + 1e-6).all(), k


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix: tree}


def test_three_factor_step_on_card(cuda):
    """A three-factor step on the card makes no read to the host (it runs
    under ``set_sync_debug_mode("error")``), and with the CPU's Gumbel
    draws injected it gives the CPU's codes: a code may differ by one only
    where the CPU's ``w_new`` lies within 1e-3 of a .5 boundary."""
    from repro_torch.config import get_arch
    from repro_torch.parallel.sharding import init_params
    from repro_torch.plasticity.three_factor import (HybridReadoutTrainer,
                                                     PlasticState,
                                                     sample_gumbel)
    arch = get_arch("smollm-360m").reduced()
    tr_g = HybridReadoutTrainer(arch, device=cuda)
    tr_c = HybridReadoutTrainer(arch, device="cpu")
    p_c = init_params(tr_c.bundle.decls, torch.Generator().manual_seed(0),
                      device="cpu")
    p_g = _to_dev(p_c, cuda)
    st = tr_g.init_state(torch.Generator(cuda).manual_seed(1))
    b_c = _train_batch(arch, "cpu")
    b_g = _to_dev(b_c, cuda)
    for _ in range(3):
        st, _ = tr_g.step(p_g, st, b_g)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, m = tr_g.step(p_g, st, b_g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert st.w_q.dtype == torch.int8 and int(st.w_q.abs().max()) <= 31
    g = sample_gumbel(torch.Generator().manual_seed(2),
                      (LM_TRAIN_B * LM_TRAIN_SHAPE_S, arch.vocab_padded))
    st_c = PlasticState(st.w_q.cpu(), st.mean_r.cpu(), torch.Generator())
    new_g, m_g = tr_g.step(p_g, st, b_g, gumbel=g.to(cuda))
    new_c, m_c = tr_c.step(p_c, st_c, b_c, gumbel=g)
    diff = (new_g.w_q.cpu().int() - new_c.w_q.int())
    assert int(diff.abs().max()) <= 1
    w_new = tr_c.update(p_c, st_c, b_c, gumbel=g)[0]
    frac = (w_new - torch.floor(w_new) - 0.5).abs()
    assert (frac[diff != 0] < 1e-3).all()
    np.testing.assert_allclose(float(m_g["mean_r"]), float(m_c["mean_r"]),
                               rtol=1e-6)


def _lm_mesh_ranks(tmp_path, world, part):
    import os
    import subprocess
    import sys
    from pathlib import Path
    here = Path(__file__).resolve().parent
    env = dict(os.environ, OMP_NUM_THREADS="1")
    store = tmp_path / f"store_{world}_{part}"
    procs = [subprocess.Popen(
        [sys.executable, str(here / "_torch_lm_mesh.py"), str(rank),
         str(world), str(store), "nccl", part, str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    print(f"rank 0, world {world}, part {part}:\n{outs[0][0][-6000:]}")
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out[-8000:]}{err[-4000:]}"
        assert f"LM_MESH_OK rank={rank} part={part}" in out, out + err


def test_lm_mesh_on_nccl(cuda, tmp_path):
    """``tests/_torch_lm_mesh.py`` parts place, serve, ops, grads, train,
    launch, families, moe, reshard and seq on NCCL, one card a rank (4
    ranks on a (2, 2) mesh where four cards are present, else 2 on (1,
    2); seq on (1, 4) or (1, 2)), each against the port without a mesh;
    with four, the reshard onto a world of 2 and seq on (1, 2) too. NCCL
    takes no two ranks on one card, so this needs two cards or more."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards or more: NCCL takes one card a rank")
    world = 4 if n >= 4 else 2
    _lm_mesh_ranks(tmp_path, world, "all")
    if world == 4:
        _lm_mesh_ranks(tmp_path, 2, "reshard2,seq")


def test_bss2_cell_counts_on_card_equal_cpu(cuda):
    """The BSS-2 fleet cell's recorded trial (``trace_bss2_cell``,
    prefill_32k on 16 x 16: 2 full instances) counts on the card, with the
    kernels, what it counts on the CPU with the plain versions: FLOPs,
    HBM bytes, transcendentals and each kernel's entries."""
    from repro_torch.config import SHAPES, MeshConfig
    kernels.reset_launches()
    rep_g, rec_g, n = th.trace_bss2_cell(SHAPES["prefill_32k"],
                                         MeshConfig(False), "cuda")
    assert n == 2
    assert all(kernels.LAUNCHES[k] for k in ("stp_scan", "synray",
                                             "synray_sparse", "neuron_scan",
                                             "corr"))
    assert kernels.LAUNCHES["census"] == 0
    rep_c, rec_c, _ = th.trace_bss2_cell(SHAPES["prefill_32k"],
                                         MeshConfig(False), "cpu")
    for k in ("flops", "transcendentals", "total_write", "kernels", "coll"):
        assert getattr(rec_g, k) == getattr(rec_c, k), k
    assert dict(rec_g.by_kind) == dict(rec_c.by_kind)
    assert rep_g.step_time == rep_c.step_time


def test_a_span_never_waits(cuda):
    """``PhaseTimer.span`` on the card records its events and returns while
    the work inside still runs (its end event not yet complete); the
    summary then waits and folds it in."""
    from repro_torch.obs.timing import PhaseTimer
    timer = PhaseTimer(cuda)
    torch.cuda.synchronize()
    with timer.span("sleep"):
        torch.cuda._sleep(200_000_000)
    pending = timer._pending
    assert len(pending) == 1 and not pending[0].done()
    s = timer.summary()
    assert s["sleep"]["count"] == 1 and s["sleep"]["best_us"] > 1e3


def _fleet_with_spans(cuda, spans, n_inst=256, rule_impl="python"):
    """The benchmark cells' experiment (256 full chips, the python rule or
    the vm rule) with three trials a call (A, B, none)."""
    ecfg = th.RSTDPConfig(n_inputs=128, n_neurons=512, pattern_size=24,
                          trial_steps=128)
    init, _, meta = th.make_experiment(
        cfg=BSS2, ecfg=ecfg, prefix=(n_inst,), backend="blocked",
        generator=torch.Generator().manual_seed(31), device=cuda,
        spans=spans, rule_impl=rule_impl)
    stims = [1, 2, 0]
    draws = meta["draw"](torch.Generator().manual_seed(32), stims)
    return init, meta, stims, draws


def test_trial_regions_add_up_to_a_replay(cuda):
    """The event-record nodes of a captured ``TrialLoop``: positive region
    times (emulation, rule, carry) whose sum is within 1% of the replay
    timed by stream events around it, for each of a call's trials. A
    sleep on the stream first keeps the host's launch of the graph out of
    the timed interval, as in a call's back-to-back replays."""
    init, meta, stims, draws = _fleet_with_spans(cuda, True)
    scanned = th.make_scanned_training(meta)
    scanned(init(), stims, draws)
    (loop, marks, steps), = scanned.loops.values()
    assert steps[0] == steps[1] and steps[-1] != steps[0]
    loop.reset()
    for _ in stims:                     # the marked capture, each trial
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        a.record()
        steps[-1]()
        b.record()
        b.synchronize()
        regions = dict(marks.read())
        assert set(regions) == set(th.TRIAL_REGIONS)
        assert all(v > 0 for v in regions.values()), regions
        whole = a.elapsed_time(b) * 1e-3
        assert abs(sum(regions.values()) - whole) <= 0.01 * whole, (
            regions, whole)


def test_scanned_spans_on_card(cuda):
    """The first call captures the trial twice (the plain graph and the
    one with the marks, for the call's last trial); a second call of the
    same shape adds no capture (``graph.captures``); its load, replays and clones add up to
    within 2% of the call timed by stream events around it; the last
    trial's regions lie between 85% and 101% of the replays over the
    trials; ``spans=False`` gives the same outputs bit for bit, records
    nothing and replays one graph."""
    init, meta, stims, draws = _fleet_with_spans(cuda, True)
    scanned = th.make_scanned_training(meta)
    timer = meta["timer"]
    st, _ = scanned(init(), stims, draws)
    assert timer.counters["graph.captures"] == 2
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    st2, hist2 = scanned(st, stims, draws)
    b.record()
    b.synchronize()
    s = timer.summary()
    assert s["graph.captures"] == dict(count=2)
    assert s["scan.loop_misses"] == dict(count=1)
    assert s["scan.calls"] == dict(count=2)
    smp = timer.samples
    call = a.elapsed_time(b) * 1e-3
    parts = sum(smp[k][-1] for k in ("scan.load", "scan.replays",
                                     "scan.clones"))
    assert abs(parts - call) <= 0.02 * call, (parts, call)
    last = sum(smp[k][-1] for k in th.TRIAL_REGIONS)
    per_trial = smp["scan.replays"][-1] / len(stims)
    assert 0.85 * per_trial <= last <= 1.01 * per_trial, (last, per_trial)
    init_f, meta_f, _, _ = _fleet_with_spans(cuda, False)
    scanned_f = th.make_scanned_training(meta_f)
    st_f, _ = scanned_f(init_f(), stims, draws)
    st2_f, hist2_f = scanned_f(st_f, stims, draws)
    for k in hist2:
        assert torch.equal(hist2[k], hist2_f[k]), k
    for x, y in zip(th._leaves(st2), th._leaves(st2_f)):
        assert torch.equal(x, y)
    assert meta_f["timer"].summary() == {}
    (_, regions_f, steps_f), = meta_f["scanned_training"].loops.values()
    assert regions_f is None and len({s.__self__ for s in steps_f}) == 1


def test_vm_fleet_trial_on_card(cuda):
    """The vm rule at the benchmark's width (256 full chips, [256, 256,
    512] lanes): both captured trials launch ``ppuvm_exec`` once a replay;
    the marked trial's five marks split it into ``VM_TRIAL_REGIONS``,
    each positive, together within 1% of the replay timed by stream
    events around it; a call adds a program a trial to ``ppu.programs``;
    ``spans=False`` replays one graph and gives the same outputs bit for
    bit over two calls."""
    init, meta, stims, draws = _fleet_with_spans(cuda, True,
                                                 rule_impl="vm")
    scanned = th.make_scanned_training(meta)
    st, _ = scanned(init(), stims, draws)
    (loop, marks, steps), = scanned.loops.values()
    assert [g.launches["ppuvm_exec"] for g in
            (steps[0].__self__, steps[-1].__self__)] == [1, 1]
    assert marks.names == th.VM_TRIAL_REGIONS
    st2, hist2 = scanned(st, stims, draws)
    assert meta["timer"].counters["ppu.programs"] == 2 * len(stims)
    loop.reset()
    for _ in stims:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        a.record()
        steps[-1]()
        b.record()
        b.synchronize()
        regions = dict(marks.read())
        assert all(v > 0 for v in regions.values()), regions
        whole = a.elapsed_time(b) * 1e-3
        assert abs(sum(regions.values()) - whole) <= 0.01 * whole, (
            regions, whole)
    init_f, meta_f, _, _ = _fleet_with_spans(cuda, False, rule_impl="vm")
    scanned_f = th.make_scanned_training(meta_f)
    st_f, _ = scanned_f(init_f(), stims, draws)
    st2_f, hist2_f = scanned_f(st_f, stims, draws)
    for k in hist2:
        assert torch.equal(hist2[k], hist2_f[k]), k
    for x, y in zip(th._leaves(st2), th._leaves(st2_f)):
        assert torch.equal(x, y)
    assert meta_f["timer"].summary() == {}
    (_, regions_f, steps_f), = meta_f["scanned_training"].loops.values()
    assert regions_f is None and len({s.__self__ for s in steps_f}) == 1
