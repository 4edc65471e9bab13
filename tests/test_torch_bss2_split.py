"""The BSS-2 fleet cell's synapse columns split over ``model``
(``core.hybrid.column_part``; the reference shards them in
``lower_bss2_cell``'s ``spec_for``, ``repro/core/hybrid.py:658-670``).

- On 2 and 4 gloo ranks (one ``model`` group; processes of
  ``tests/_torch_bss2_split.py``, joined through a file store under the
  test's own temporary directory, each with a time limit): 256-, 128- and
  32-column parts of a fleet of 2 full 256 x 512 chips, two trials each,
  all-gathered, equal the whole chip's trials bit for bit: spikes,
  metrics, 6-bit weights, ``w_signed``, mean reward, the state's planes
  and route counts.
- A 32-column part plans the whole chip's route: the census gate with
  the whole chip's capacities, taken inside the STP scan, where a chip of
  32 columns alone would run dense with no census.
- Against the reference: with its instance and draws injected
  (``repro_torch.convert``), each of 4 column parts of a 64 x 64 chip
  (dense) and of a 128 x 256 chip (census-gated) runs 6 trials equal to
  the reference's whole-chip run, column-sliced: rates, rewards, stimuli,
  CADC codes and 6-bit weights exact; mean rewards, eligibility and
  signed weights within rtol = atol = 1e-4 (the tolerance of
  ``tests/test_torch_hybrid.py::test_scanned_training_matches_reference``).
- The reference's own partition of the cell, lowered at reduced
  geometries on fake CPU devices, puts no collective on the column split.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_parity import close
from repro.core import hybrid as jh
from repro_torch import convert
from repro_torch.configs.bss2 import BSS2
from repro_torch.core import hybrid as th
from repro_torch.core import synapse
from repro_torch.kernels.stp_scan import ops as stp_ops

HERE = Path(__file__).resolve().parent
TIMEOUT_S = 180


def _run_ranks(tmp_path, world, *args):
    """Start ``world`` ranks of the helper with ``args`` after the store;
    their exit codes and outputs."""
    store = tmp_path / "store"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "_torch_bss2_split.py"), str(rank),
         str(world), str(store), *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


@pytest.mark.parametrize("world,parts", [(2, 2), (4, 4), (4, 16)])
def test_gathered_parts_equal_whole_chip(tmp_path, world, parts):
    """Each rank runs ``parts / world`` column parts of 512 / ``parts``
    columns in turn; the group's parts gathered equal the whole chip."""
    for rank, (rc, out, err) in enumerate(_run_ranks(tmp_path, world,
                                                     "gloo", str(parts))):
        assert rc == 0, f"rank {rank}:\n{out[-2000:]}{err[-4000:]}"
        assert (f"BSS2_SPLIT_OK rank={rank} parts={parts} "
                f"cols={512 // parts} ") in out, out + err
        # stimulus A overflows the gate's capacities, no stimulus fits
        assert "routes=[2, 2]" in out, out


def _cell_ecfg():
    return th.RSTDPConfig(n_inputs=128, n_neurons=512, pattern_size=24,
                          trial_steps=128)


def test_part_plans_the_whole_chips_route(monkeypatch):
    """A 32-column part of the full chip (16 parts, T = 128): each Dale
    half of 128 rows plans the census gate from 512 columns (128 x 128 x
    512 above ``SPARSE_MIN_DENSE_WORK``; from its own 32 columns it would
    be dense), and its STP scan takes both censuses with the whole chip's
    capacities; the route counts equal the whole chip's."""
    T, half = 128, 128
    assert T * half * 32 < synapse.SPARSE_MIN_DENSE_WORK <= T * half * 512
    assert synapse.route_plan(T, half, 32, const_addr=True)[0] == "dense"
    want = synapse.route_plan(T, half, 512, const_addr=True)
    assert want[0] == "gate"
    seen = []
    scan = stp_ops.stp_scan

    def spy(*args, **kwargs):
        seen.append(kwargs.get("caps"))
        return scan(*args, **kwargs)
    monkeypatch.setattr(stp_ops, "stp_scan", spy)
    routes = []
    for parts, part in ((16, 5), (1, 0)):
        init, trial, meta = th.column_part(
            BSS2, _cell_ecfg(), parts, part,
            generator=torch.Generator().manual_seed(2), prefix=(2,),
            backend="blocked", device="cpu")
        assert meta["core"].plan_cols == 512
        assert meta["cfg"].n_cols == 512 // parts
        draws = meta["draw"](torch.Generator().manual_seed(3), [0])
        synapse.reset_route_counts()
        trial(init(), 0, draws.events[0], draws.xi[0])
        routes.append(synapse.route_counts("cpu").tolist())
    assert seen == [(want[1:], want[1:])] * 2
    assert routes[0] == routes[1] and sum(routes[0]) == 2


def test_column_part_needs_even_parts():
    """Each part needs an even column count (the reward's parity), and a
    part index within the parts."""
    ecfg = _cell_ecfg()
    for parts, part in ((3, 0), (512, 0), (16, 16), (16, -1)):
        with pytest.raises(ValueError):
            th.column_part(BSS2, ecfg, parts, part, device="cpu")


def _geometry(name):
    """64 x 64 (T = 256: below the census floor, dense) or 128 x 256 (T =
    128: every window census-gated, and a part of 64 columns alone would
    be dense)."""
    if name == "dense":
        ecfg = th.RSTDPConfig(n_inputs=32, n_neurons=64)
        return dataclasses.replace(BSS2.reduced(), n_rows=64, n_cols=64), ecfg
    ecfg = th.RSTDPConfig(n_inputs=64, n_neurons=256, pattern_size=16,
                          trial_steps=128)
    return dataclasses.replace(BSS2, n_rows=128, n_cols=256), ecfg


@pytest.mark.parametrize("geometry", ["dense", "gated"])
def test_parts_match_reference_whole_chip(geometry):
    cfg, ecfg = _geometry(geometry)
    j_ecfg = jh.RSTDPConfig(**dataclasses.asdict(ecfg))
    j_cfg = None
    if geometry == "gated":
        from repro.configs.bss2 import BSS2 as J_BSS2
        j_cfg = dataclasses.replace(J_BSS2, n_rows=128, n_cols=256)
    init, _, meta = jh.make_experiment(cfg=j_cfg, ecfg=j_ecfg,
                                       instance_key=jax.random.PRNGKey(0))
    inst = jax.tree.map(np.array, meta["inst"])
    stims = th.stimuli(6)
    st0 = init(jax.random.PRNGKey(1))
    draws = convert.replay_reference_draws(
        jax.random, jax.numpy.array(st0.key), stims, ecfg, device="cpu")
    j_state, j_hist = jh.make_scanned_training(meta["scanned_training"])(
        st0, jax.numpy.asarray(stims))
    j_hist = {k: np.asarray(v) for k, v in j_hist.items()}
    j_w = np.asarray(j_state.core.syn.weights)
    j_ws = np.asarray(j_state.w_signed)
    parts, routes = 4, []
    for part in range(parts):
        init_t, _, meta_t = th.column_part(
            cfg, ecfg, parts, part, inst=convert.instance(inst, "cpu"),
            backend="blocked", device="cpu")
        cols = meta_t["cols"]
        synapse.reset_route_counts()
        t_state, t_hist = th.make_scanned_training(meta_t)(
            init_t(), stims, th.column_draws(draws, parts, part))
        routes.append(synapse.route_counts("cpu").tolist())
        np.testing.assert_array_equal(t_hist["stim"].numpy(), j_hist["stim"])
        for k in ("rates", "reward"):
            np.testing.assert_array_equal(t_hist[k].numpy(),
                                          j_hist[k][..., cols], err_msg=k)
        np.testing.assert_array_equal(
            np.rint(t_hist["elig"].numpy() * 255),
            np.rint(j_hist["elig"][..., cols] * 255))
        for k in ("mean_reward", "elig", "w"):
            close(t_hist[k], j_hist[k][..., cols], err_msg=k)
        np.testing.assert_array_equal(t_state.core.syn.weights.numpy(),
                                      j_w[..., cols])
        close(t_state.w_signed, j_ws[..., cols])
    assert all(r == routes[0] for r in routes)
    if geometry == "gated":
        assert routes[0] == [8, 4]         # the no-stimulus windows sparse
    else:
        assert routes[0] == [0, 0]


@pytest.mark.parametrize("geometry,mesh,want", [
    ("32 64 256 4", "1 4", []),
    ("128 256 128 4", "1 4", []),
    ("128 256 128 4", "2 2", [("all-reduce", "(s32[], s32[], s32[], s32[])",
                               "reduce_max")])])
def test_reference_cell_split_needs_no_column_collective(geometry, mesh,
                                                         want):
    """The reference's own partition of the cell (``lower_bss2_cell``'s
    specs; ``tests/_torch_ref_cell_collectives.py`` on fake CPU devices)
    at reduced geometries (rows != columns, dense and census-gated):
    with the columns over 4 ``model`` devices XLA lowers the trial with
    no collective, which is why ``column_part`` needs none; with the
    fleet over 2 ``data`` devices the gated trial all-reduces the four
    int32 census scalars' maxima (its one decision over the whole fleet;
    the port decides over each rank's local fleet, the same bits on the
    card, where both routes give the same currents)."""
    out = subprocess.run(
        [sys.executable, str(HERE / "_torch_ref_cell_collectives.py"),
         *geometry.split(), *mesh.split()], capture_output=True, text=True,
        timeout=TIMEOUT_S, check=True).stdout
    got = [(c["kind"], c["type"], c["op_name"].rsplit("/", 1)[-1])
           for c in json.loads(out.splitlines()[-1])]
    assert got == want
