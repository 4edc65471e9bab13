#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. Device and build: the card's name and power limit (``nvidia-smi``),
   then the CUDA kernels built from ``src/repro_torch/csrc`` (timed), and
   ``-Xptxas -v``'s report held to the redesigned kernels' budgets:
   ``ppuvm_exec`` and ``stp_scan`` with a 0-byte stack frame, none of
   them, ``neuron_scan`` and ``synray_sparse`` spilling.
2. Each kernel against its plain PyTorch version on the card, at the
   main-path shapes (16 instances of the full 256 x 512 chip, T = 128),
   inputs from a numpy seed: ``neuron_scan``, ``corr`` and ``ppu_update``
   bit-equal, ``synray`` and ``synray_sparse`` within rtol = atol = 1e-4
   (they sum rows with FMAs in another order than the plain versions'
   products), ``synray``'s const_addr form (the main path's) equal to its
   general form bit for bit and both timed beside ``torch.bmm`` on the
   resolved mask (the ratio is logged). ``synray_sparse``'s window form
   (the route's: the records kept as ``regroup_window`` keeps them, no
   pack) on a no-stimulus Dale half read in place: equal bit for bit to
   ``synray`` and to its record form fed ``regroup_window``'s records,
   timed behind the census's flag beside the census, the pack it
   replaced, the record form, ``synray`` and ``torch.bmm`` (its library
   yardstick); ``census`` equal to its plain version. ``neuron_scan`` is timed
   as the main path calls it (parameters packed once), also on the host
   clock with its wrapper, beside its chain floor (``chain_floor_ms``: the
   kernel with the currents in registers). ``stp_scan`` bit-equal to its
   plain loop at [T=128, 16, 256] and at the closed loop's [T=256, 32],
   also with resources at 0 and a negative scale (-0.0 efficacies) and at
   1, timed beside the loop. Times are medians of
   CUDA-event timings; ``bound_ms`` is the larger of bytes over 3.35 TB/s
   and operations over 67 TFLOP/s (float32, outside the tensor cores;
   ``config.HW``): the bytes from each kernel's ``work`` function, which
   a cost recorder must count for one call too, the operations counted
   from the data (non-zero events, spikes).
3. Path A, the main path: the §5 experiment at full width (``BSS2``, 128
   inputs x 512 neurons, 16 instances, 128 steps, ``backend="blocked"``,
   ``sparse_mode`` left at its default) for 6 trials, stimuli A, B, none,
   A, B, none. Every window goes through the census gate on the device:
   ``census``, ``synray_sparse`` and ``synray`` launch (12 each, with 6
   ``stp_scan``, 6 ``neuron_scan`` and 6 ``corr``), and the census's flag
   lets the sparse kernel compute the no-stimulus windows and the dense
   one the pattern windows, as the device's route counter must show (read
   after the run). The census of every window is printed; the state must
   be finite with whole-number rate counters; one more no-stimulus trial
   runs under ``set_sync_debug_mode("error")`` (no device-to-host read);
   the first trial and the first no-stimulus trial, rerun on the CPU from
   the same state and draws, must take the same route and agree with the
   card (spikes equal up to flips at threshold, see
   ``check_against_cpu``). The same 6 trials from the same state and
   draws as replays of one captured trial graph (``TrialGraph``): the
   histories, final state and device route counts equal the eager run's
   bit for bit, one replay launches what one eager trial launched; eager
   and graph trials timed in turns. The same 6 trials through the
   composition the census form replaced (the scan without the census,
   then the census kernel on each half), eager and replayed: histories,
   final state, device route counts and every window's census equal to
   the census form's bit for bit; the two graphs' replays timed in turns.
   A standalone window (one Dale half through
   ``synapse.synaptic_current_window``, not out of the scan) launches
   ``census``, ``synray_sparse`` and ``synray`` once each: the kernels
   line's ``census`` launches. ``torch.profiler`` traces (kept in
   ``build/profile/``) of 3 eager trials and of 3 replays, each after 3
   more in the profiler's warm-up step: the device's busy share, kernel
   time by name, kernels a trial and the longest idle gaps (a trace
   without device time says so and splits one trial with CUDA events
   instead). The gate's host-clock cost and the routes interleaved on
   one no-stimulus trial (``route_ab``) are logged. Then
   ``synray`` (both Dale halves) and ``corr`` are checked and timed again
   on the operands of the first pattern trial, at the §5 densities.
4. Path B, the fixed-function R-STDP update: three windows of ``AnnCore
   .run`` at 16 x 256 x 512, each followed by ``VectorUnit.apply_rstdp``
   (3 ``ppu_update`` launches); the first update, rerun on the CPU from
   the same state, must give the same codes (up to .5 ties).
5. The §5 closed loop at the default 32 x 16 geometry on the card: 450
   trials, the port's own generator, seed 0, in ``run_training``'s
   default mode (a captured trial graph, replayed), held to tier 3
   (``tests/test_rstdp.py``): both populations' trailing median reward
   above 0.85, the even columns' A-channel weights above 5 and 10 above
   the odd columns'; equal bit for bit to a ``scan=False`` run (eager
   trials), both timed.
6. The PPU-VM kernel ``ppuvm_exec`` against its plain version on the card,
   weights and registers bit for bit: the 200-program fuzz corpus of
   ``tests/test_ppuvm_fuzz.py`` at 8 x 8 (regenerated with numpy and the
   port's assembler by ``tests/_torch_ppuvm.py``), the edge corpus, the
   unknown-opcode program, a prefixed [3, 40, 136] shape with ragged
   tails, two programs longer than the ``MAX_WORDS`` words the kernel
   decodes at once, and ``signed_dw_program`` / ``rstdp_program`` at
   [16, 256, 512] on int8 weights, as their callers pass them (timed,
   and again on int32 weights; ``bound_ms`` counts each plane read once
   in the type it has, the weights and the 8 registers written once as
   int32). No PyTorch call computes the VM; beside it, ``ppu_update`` on
   the same R-STDP update as a yardstick.
7. Path C, the vm rule at full width: path A's configuration with
   ``rule_impl="vm"``, 3 trials (A, B, none): exactly 3 ``ppuvm_exec``
   launches and no ``census``, the routes dense, dense, sparse; the first
   trial rerun on the CPU (as in phase 3, weight codes
   equal where no spike flipped) and its VM update rerun on the CPU from
   the card's window state (registers, so dw, bit for bit); the same
   trial with the python rule within 0.15 on the signed weights; the 3
   trials as graph replays, bit-equal to the eager ones.
8. ``VectorUnit.apply_rstdp_program`` against ``apply_rstdp`` at 16 x 256
   x 512 with one injected xi: weights within one code; both timed (the
   ratio is recorded, not claimed).
9. A 60-trial vm-rule closed loop at 32 x 16, T = 128, seed 0, as graph
   replays (the default) and as eager trials, bit-equal: the median
   reward of the last 15 trials above that of the first 15.
10. Playback on the card: the three golden programs
   (``tests/golden/playback_*.npz``) through the port's ``FastBackend``
   on ``cuda``: ``compare_traces(atol=0.05)`` empty, ``PPU_W`` and
   ``WEIGHTS`` records bit-equal to the golden ones, 2 ``ppuvm_exec``
   launches each.
11. Path D, the verification layer on path A's full-width chip (16 x 256
   x 512, T = 128): ``calibrate_stp`` of the 16 x 256 STP driver offsets
   on the card (codes equal to the CPU's, std after < 0.4 x before, the
   Fig. 4 bar; timed), then on the calibrated chip with a sampled
   ``FaultPlan`` (dead rows, dead and hot neurons, stuck cells, CADC
   columns) and telemetry on: 6 trials (A, B, none, A, B, none) eager and
   as graph replays, bit-equal; telemetry off bit-equal to on;
   ``faults_injected`` equal to the plan's sites and the route counters
   to ``route_counts``; the counters printed, and replays of the clean,
   the faulted and the faulted-with-telemetry trial timed in turns.
   ``screen`` on the card equal to the CPU's, finding the planted dead
   rows, hot and dead neurons and every CADC column stuck more than its
   margin from the zero baseline. The loop under the screened blacklist
   as graph replays (its gauges checked), and the plan's covered sites
   under the blacklist equal to the clean reduced network bit for bit.
   Last, the off path (no faults, no telemetry): path A's launches,
   eager and a replay, as in phase 3.
   Phase 2 also holds ``ppu_update``'s faulted form (a CADC fault map,
   path D's ``apply_rstdp``) to its plain version bit for bit, timed.
12. Path E, the wafer at full width (``repro_torch.wafer``): first the
   router alone, ``run_windows`` of 4 windows on four 256 x 512 chips
   under a random ring and a random all2all plan (512 routes a link,
   relay rows conducting): dense, compact and auto, auto bit-equal to
   dense, compact at a small budget dropping records and counting
   overflows; every window again on the CPU from the card's state (spikes
   equal up to flips at threshold, the router's grids and link counters
   bit for bit); ``route()`` timed per mode. Then the §5 network of 128
   inputs x 2048 neurons on four full chips (``run_training(wafer=4)``'s
   experiment: all2all, relay broadcast, 8,192 routes on 16 links,
   ``link_mode="auto"``, ``backend="blocked"``): 6 trials eager with the
   launch counts set to 0 before and read after (every kernel of the path
   launched, ``census`` none), trial 0 again on the CPU, the trials as
   graph replays bit-equal to the eager ones and timed in turns with them, a
   ``torch.profiler`` trace of the replays and of the router's own
   kernels, the link counters; chip-count parity (K = 1, one 256 x 2048
   chip, 2 and 4: the same global weights, rewards and per-chip routed
   grids bit for bit); the link half of faults: one dead and one
   flaky link found by ``screen`` with the router, equal to the CPU's;
   the relay plan's ``reroute_plan`` raising (no row is free); a plan
   announcing 32 columns a chip rerouted around the blacklisted links, 6
   trials eager and as replays bit-equal with ``link_reroutes`` counted,
   and the dead link's deliveries arriving one window late.
13. Path F, the network mapper at full width (``repro_torch.mapper``): a
   480 x 2048 ``NetworkSpec`` (``tests/_torch_mapper.py``: locality
   feedforward plus sparse inhibitory recurrence, 4,864 edges) mapped
   onto four native 256 x 512 chips (249 rows a chip, no relay, as the
   reference's mapper places it; ``map_network`` timed on the host),
   the instance drawn at spec shapes from one ``torch.Generator``, 6
   windows of T = 128 (Poisson inputs, p = 0.05) through
   ``build_runtime(...).run`` with the launch counts set to 0 before and
   read after (``run`` replays one captured window a window, so the
   wrappers count the window's warm-up and capture: every kernel of the
   path launched, ``census`` none; ``launches_path_f``);
   one eager window and a replayed run under
   ``set_sync_debug_mode("error")``; the same at K = 2
   (490 x 1024) and K = 1 (968 x 2048), spec-order spikes bit for bit
   (on a failure each K's routes by window and the first divergence are
   printed); window 0 again on the CPU (flips counted, 0 expected); a
   blacklist of rows, neurons and a dead link on four 264 x 528 chips
   (the mapping avoids every bad site; run with them killed by faults,
   equal to K = 1 bit for bit); at each of those geometries window 1's
   operands of every wrapper captured and each kernel held to its plain
   version; at K = 4, 2, 1 and blacklisted, ``run``'s replays against
   its eager windows (``eager=True``) from fresh telemetry counters:
   state, spikes, routed grid, counters and route counts bit for bit, one
   replay launching what one eager window launches, each graph's pool;
   replay against eager ms a window at K = 4 and K = 1 (CUDA events, in
   turns; the replays alone too) and the capture's ms; a
   ``torch.profiler`` trace of 3 replayed windows, of 3 eager windows
   and of the router alone. Then the same K = 4 runtime under a
   ``torch.distributed`` group (``build_runtime(group=)``, each rank
   holding its block of the four chips; ``tests/_torch_wafer_sharded.py::
   path_f``): a world of 1 on NCCL through a file store under ``build/``
   on any card, and where two cards or more are present, ``min(4, n)``
   NCCL ranks as child processes, each under a time limit (a line says
   which forms ran). Each rank's window is captured under
   ``set_sync_debug_mode("error")`` with the sharded transport's
   collectives inside the graph; its replays equal its eager windows bit
   for bit (state, spikes, routed grid, counters, route counts; a replay
   launching what an eager window launches), the gathered spikes equal
   the runtime without a group and one 968 x 2048 chip; ``rt.run``
   replayed and eager under the group and the runtime without a group
   timed in turns (CUDA events), the replays alone, a fresh capture's
   host ms and pool, 3 bare replays traced (device operations a
   replay, NCCL's kernels among them). A rank that fails fails the phase. Its numbers go on a
   ``mapped_path_f_grouped`` JSON line.
14. Path G, LM serving (``repro_torch.serve``): ``ServeEngine`` on
   qwen1.5-0.5b at full width in f32 (24 layers, d 1024, vocab 151,936,
   0.464 B parameters from ``init_params`` with a seeded generator on the
   card), 8 requests of 128 prompt tokens from a numpy seed, 32 greedy
   new tokens: prefill ms and decode ms a token (``PhaseTimer``'s CUDA
   events, median of 3 runs after a warm-up), tokens/s, peak device
   memory, a ``torch.profiler`` trace of 4 decode steps (busy share,
   kernels a step, the top kernels), beside the bounds (decode: parameter
   bytes over 3.35 TB/s a step; prefill: 2 x parameters x tokens over 67
   TFLOP/s). Request 0 of the timed run again on the CPU, teacher-forced
   at its full prompt through all 32 tokens (both sides fed the engine's
   tokens): logits within rtol = atol = 1e-3 at every step, an engine
   token differing from the CPU's greedy one only where the CPU's top-2
   gap is under that (a near tie). ``mamba2-130m`` at 8 x 512 (two SSD
   chunks of 256: the inter-chunk state pass runs) and ``hymba-1.5b`` at
   8 x 1152 (+ 128 meta tokens = 1280 positions: five chunks, and the
   1024-token sliding window cuts beside the three global layers) at full
   width the same way; every reduced arch of ``ASSIGNED_ARCHS`` generated
   on the card at 48 positions (three chunks of 16, past the reduced
   window of 8) and held to the CPU at 1e-4 the same way
   (``hubert-xlarge``: its prefill frame logits). TF32 must be off. The
   path launches none of the port's kernels (counts read); its numbers go
   on a ``serve_path_g`` JSON line.

15. Path H, LM training (``repro_torch.train``): smollm-360m at full
   width in f32 (32 layers, d 960, 15 / 5 heads, d_ff 2560, tied vocab
   49,152; 0.362 B parameters), TF32 off, the reference's full-width
   example (``examples/train_lm.py``: 8 x 512 tokens, AdamW lr 1e-3 with
   20 warm-up steps). One step on a 1 x 512 sub-batch of the pipeline's
   first batch on the card and on the CPU from the same parameters: the
   loss, the gradient norm and every gradient leaf within rtol = atol =
   1e-3 (path G's full-width tolerance), the parameters after AdamW within
   1e-6 + 1e-5 |p| except elements whose CPU gradient is under 1e-5 in
   size (the first step moves each parameter by ~lr sign(g), so a
   gradient near 0 may move it apart: counted, held to 2 lr).
   ``Trainer.train()`` for 20 steps, remat as the arch says (``"dots"``),
   a checkpoint at the end, the launch counts set to 0 before and read
   after (none of the eight kernels runs): step ms (CUDA events around
   each step, median after the first), tokens/s, peak device memory, the
   loss at every step (finite, lower at the end), the bound 6 x
   parameters x tokens over 67 TFLOP/s. One step with remat as the arch
   says and one with ``remat=False`` from copies of the trained state:
   peak memory, loss and gradients (within 1e-5; bit-equal reported),
   then two more of each in turns, timed. A ``torch.profiler`` trace of one step (busy share,
   kernels, the top kernels). ``launch.serve --ckpt-dir`` on the
   trainer's checkpoint; the state (parameters, moments, cursor) saved
   and restored timed under ``build/`` (free space printed first), the
   restored leaves equal bit for bit, and served (8 x 64 prompt tokens, 8
   greedy new ones) giving the in-memory parameters' tokens. Crash and
   restart at reduced smollm width in a child process (``chip_smoke.py
   --crash-restart``) with ``torch.use_deterministic_algorithms`` on and
   ``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts: a straight 8-step
   run against one that fails at step 6 and resumes from the step-4
   checkpoint, parameters and moments bit for bit. The three-factor
   readout trainer on the initial parameters, frozen, at 8 x 512: 10
   steps from zero codes timed; then from random codes and <R> = 0.5
   (every token's modulation nonzero) one step under
   ``set_sync_debug_mode("error")`` saturating at |w_q| = 31 as int8, and
   one step on a 1 x 512 sub-batch against the CPU with the card's
   Gumbel draws injected: the update within 1e-3 of its largest entry, a
   sample differing only where the CPU's top-2 gap in ``logits / T + g``
   is under 1e-3, a code by one only where the CPU's ``w_new`` lies within
   1e-3 of a .5 boundary (both counted).
   ``launch.train --arch smollm-360m --smoke --steps 5`` and ``--trainer
   hybrid`` as child processes on the card. Its numbers go on a
   ``train_path_h`` JSON line.

16. Path I, the LM on a device mesh (``repro_torch.parallel.sharding`` on
   a ``DeviceMesh``: parameters as DTensors placed by the logical-axis
   rules, activations constrained, ``launch.mesh.make_smoke_mesh``): a
   world of 1 on NCCL through a file store under ``build/`` and a 1 x 1
   mesh over (``data``, ``model``). qwen1.5-0.5b at full width served as
   in path G (8 x 128 prompt tokens, 32 greedy new ones) with and
   without the mesh on the same parameters, in turns: tokens equal bit
   for bit (the first divergence printed otherwise), prefill ms and
   decode ms a token of each, a ``torch.profiler`` trace of 4 decode
   steps under the mesh (kernels a step, busy share). smollm-360m at full
   width, 8 x 512, 3 ``Trainer.train()`` steps with and without the mesh
   in turns (twice each): losses equal bit for bit, step ms of each; the
   mesh run's checkpoint (gathered, written by rank 0) restored without a
   mesh and onto the mesh, every parameter and moment bit for bit on its
   placements. Launch counts zeroed before and read after (none of the
   eight kernels runs: ``launches_path_i``); the group destroyed before
   the kernels line. Its numbers go on a ``mesh_path_i`` JSON line.

17. Path J, launch and analysis (``repro_torch.analysis``,
   ``launch.dryrun``): the BSS-2 fleet cell (``core.hybrid
   .trace_bss2_cell``: each rank's part, its local fleet of 256 x 512
   chips, 16 / 2 / 8 / 1 instances for train_4k / prefill_32k /
   decode_32k / long_500k on 16 x 16, 8 / 1 / 4 / 16 on 2 x 16 x 16,
   and 32 of each chip's 512 columns, the 16 ``model`` ranks' split,
   routed as the whole chip plans) for the four shapes on both meshes on
   the card, launch counts zeroed before and read after
   (``launches_path_j``: stp_scan, synray, synray_sparse, neuron_scan
   and corr must launch, census not). Each cell's recorded trial prints
   its per-device FLOPs, HBM bytes and kernel entries; train_4k on 16 x
   16 is traced on the CPU too (the plain versions), and the counts must
   be equal; each kernel entry's bytes a call must equal its ``work`` at
   the cell's own shapes (phase 2 checks each of the eight kernels'
   counted bytes against its bound's on one call each). The 16 column
   parts of train_4k's local fleet run in turn and, concatenated, must
   equal the whole chips' two trials bit for bit (spikes, metrics,
   6-bit weights, ``w_signed``, mean reward, the state's planes, route
   counts). Each cell's part is timed as a ``TrialGraph`` replay and
   eager, and the whole chips' trial as a replay, in turns (medians of
   CUDA-event timings, printed with the card's name and power limit),
   and set beside the roofline's step time and bottleneck. Then
   ``python -m repro_torch.launch.dryrun`` in a child under a time
   limit: qwen1.5-0.5b train_4k and decode_32k and
   moonshot-v1-16b-a3b decode_32k on a fake 256-rank 16 x 16 world, each
   report's terms printed. Last, the roofline of what the card ran: path
   H's training step (smollm-360m, 8 x 512, f32) and path G's decode step
   (qwen1.5-0.5b, batch 8, a 160-position cache, f32) counted on a world
   of one (fake tensors, no mesh), beside phase 15's and phase 14's
   measured times: measured / roofline step time. The card's memory
   (``total_memory``) is printed beside ``HW.hbm_bytes``. Its numbers go
   on a ``roofline_path_j`` JSON line.

Exits non-zero without a card, outside a checkout, or when any phase
fails; the last line is the JSON device record.
"""
from __future__ import annotations

import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
# the card's HBM rate (bytes/s) and float32 peak outside the tensor cores
# (FLOP/s): ``repro_torch.config.HW``'s, set by ``main`` (NVIDIA's data
# sheet, H100 SXM5 80 GB)
MEM_BW = FP32_PEAK = None
SRC = {
    "synray": ("src/repro_torch/csrc/synray.cu",
               "src/repro/kernels/synray/kernel.py:48"),
    "neuron_scan": ("src/repro_torch/csrc/neuron_scan.cu",
                    "src/repro/kernels/neuron_scan/kernel.py:96"),
    "corr": ("src/repro_torch/csrc/corr.cu",
             "src/repro/kernels/corr/kernel.py:56"),
    "synray_sparse": ("src/repro_torch/csrc/synray_sparse.cu",
                      "src/repro/kernels/synray_sparse/kernel.py:51"),
    # no TPU kernel: the device form of the reference's lax.cond predicate
    "census": ("src/repro_torch/csrc/census.cu",
               "src/repro/core/synapse.py:250"),
    "ppu_update": ("src/repro_torch/csrc/ppu_update.cu",
                   "src/repro/kernels/ppu_update/kernel.py:51"),
    "ppuvm_exec": ("src/repro_torch/csrc/ppuvm_exec.cu",
                   "src/repro/kernels/ppuvm_exec/kernel.py:64"),
    # no TPU kernel: the reference's STP lax.scan (stp_body)
    "stp_scan": ("src/repro_torch/csrc/stp_scan.cu",
                 "src/repro/core/anncore.py:333"),
}
# the §5 background rate and the const_addr capacities of one Dale half
# at full width (events.default_max_events / default_k_cap at 0.02)
BG_PROB, MAX_EVENTS, K_CAP = 0.008, 328, 16


def log(msg):
    print(msg, flush=True)


def bound_ms(n_bytes, n_ops):
    t_b, t_o = n_bytes / MEM_BW, n_ops / FP32_PEAK
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def _counted_bytes(name, fn):
    """The bytes one call of ``fn`` counts for kernel ``name`` under a
    cost recorder (``repro_torch.analysis.cost``): its wrapper's declared
    work, the bytes its bound divides."""
    from repro_torch.analysis import cost
    with cost.recording() as rec:
        rec.begin()
        fn()
        rec.end()
    return rec.kernels[name]["bytes"]


def _row(name, work, fn, **row):
    """A kernel's row: its ``work`` bytes (what ``bound_ms`` divides) and
    the bytes a recorder counts for one call of ``fn``, which must be the
    same."""
    counted = _counted_bytes(name, fn)
    if counted != work.bytes:
        raise AssertionError(f"{name}: the recorder counts {counted} bytes, "
                             f"the bound divides {work.bytes}")
    return dict(row, bytes=work.bytes, counted_bytes=counted)


def time_ms(fn, reps):
    """Median of CUDA-event timings of ``fn`` (after one warm-up call).
    Each timing starts behind a ~1 ms device-side sleep, so the host has
    queued ``fn``'s launches before the card reaches them: a kernel's time
    is its device time, not the host's launch overhead (a function with
    more host work than that, or a device-to-host read, still counts it)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def phase_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    log(f"[1] build: {time.perf_counter() - t0:.1f} s -> "
        f"{path.relative_to(REPO)}")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")
    # the redesigned kernels' register budgets: ppuvm_exec keeps the VM's
    # register file in registers (no stack frame), none of them spills
    for name, no_stack in (("neuron_scan.cu", False), ("ppuvm_exec.cu", True),
                           ("synray_sparse.cu", False), ("stp_scan.cu", True)):
        frames = [(fn, *map(int, m)) for fn, *m in re.findall(
            r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, "
            r"(\d+) bytes spill stores, (\d+) bytes spill loads",
            _build.BUILD_LOG.get(name, ""))]
        if not frames:
            raise AssertionError(f"{name}: no -Xptxas -v report in the build "
                                 "log")
        if any(st or sl for _, _, st, sl in frames):
            raise AssertionError(f"{name} spills: {frames}")
        if no_stack and any(f for _, f, _, _ in frames):
            raise AssertionError(f"{name}: stack frame {frames}")
        log(f"[1] {name}: {len(frames)} functions, stack frames "
            f"{sorted({f for _, f, _, _ in frames})} bytes, no spills")
    return smi


def _instance_params(prefix, rows, cols, seed):
    import dataclasses
    import torch
    from repro_torch.configs.bss2 import BSS2
    from repro_torch.core import adex
    from repro_torch.verif.mismatch import sample_instance
    cfg = dataclasses.replace(BSS2, n_rows=rows, n_cols=cols)
    inst = sample_instance(cfg, torch.Generator().manual_seed(seed),
                           prefix, device="cuda")
    params = inst["neuron_params"]
    return params, adex.decay_factors(params, cfg.dt)


def phase_kernels():
    """Each kernel against its plain version at the main-path shapes."""
    import numpy as np
    import torch
    from repro_torch.core import adex

    rng = np.random.default_rng(0)
    N, T, R, C = 16, 128, 256, 512
    cuda = torch.device("cuda")

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(cuda)

    rows = {}

    # synray: one Dale half (every other row of the [N, R, C] store, read
    # in place) against the full event window of that half
    w = dev(rng.integers(0, 64, (N, R, C), dtype=np.int8))
    st = dev(rng.integers(0, 4, (N, R, C), dtype=np.int8))
    ev_full = dev((rng.random((T, N, R)) < 0.05).astype(np.float32)
                  * rng.uniform(0.2, 1.2, (T, N, R)).astype(np.float32))
    ea_row = rng.integers(0, 4, (N, R), dtype=np.int8)
    ea_full = dev(np.broadcast_to(ea_row, (T, N, R)))   # const_addr form
    rows["synray"] = synray_row(ev_full[..., 0::2], ea_full[..., 0::2],
                                w[:, 0::2, :], st[:, 0::2, :], "[2]")

    # neuron_scan: a drive that makes the neurons fire
    params, decays = _instance_params((N,), R, C, seed=1)
    ie = dev((rng.random((T, N, C)) < 0.1).astype(np.float32)
             * rng.uniform(0, 600, (T, N, C)).astype(np.float32))
    ii = dev((rng.random((T, N, C)) < 0.05).astype(np.float32)
             * rng.uniform(0, 100, (T, N, C)).astype(np.float32))
    s0 = adex.init_state((N, C), params)
    rc0 = torch.zeros((N, C), device=cuda)
    rows["neuron_scan"] = neuron_row(s0, rc0, ie, ii, params, decays)

    # corr: accumulators spread over [0, sat] so the clamp is exercised
    pre = dev((rng.random((T, N, R)) < 0.05).astype(np.float32))
    post = dev((rng.random((T, N, C)) < 0.05).astype(np.float32))
    tp0 = dev(rng.random((N, R), dtype=np.float32))
    tq0 = dev(rng.random((N, C), dtype=np.float32))
    ac0 = dev(rng.uniform(0, 1023, (N, R, C)).astype(np.float32))
    aa0 = dev(rng.uniform(0, 1023, (N, R, C)).astype(np.float32))
    lam = float(np.exp(-0.2 / 5.0))
    rows["corr"] = corr_row((pre, post, tp0, tq0, ac0, aa0),
                            dict(lam=lam), "[2]")
    rows["synray_sparse"], rows["census"] = _check_synray_sparse(
        rng, dev, N, T, R, C)
    rows["ppu_update"] = _check_ppu_update(rng, dev, N, R, C)
    rows["stp_scan"] = stp_row(rng, dev, N, T, R)
    for name, r in rows.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"[2] {name}: kernel_ms={r['ms']:.4f} plain_ms="
            f"{r['plain_ms']:.4f} library_ms={lib} bound_ms="
            f"{r['bound_ms']:.4f} ({r['bound_by']}) max_abs_err="
            f"{r['max_abs_err']:.3g}")
    return rows


def neuron_row(s0, rc0, ie, ii, params, decays):
    """neuron_scan bit-equal to its plain version on a drive that fires,
    timed as the main path calls it (``AnnCore._neuron_window``: the
    parameters packed once, the state in six [N, C] planes, so the wrapper
    launches the kernel alone): device time behind the sleep (``ms``), the
    same call on the host clock with the wrapper's own time, and the chain
    floor (``chain_floor_probe``: the kernel with the currents in
    registers, so no load waits). ``bound_ms`` counts bytes and operations
    as the contract defines them; the floor is logged beside it."""
    import torch
    from repro_torch.kernels.neuron_scan import ops as neuron_ops
    from repro_torch.kernels.neuron_scan.ref import neuron_window_ref
    T, N, C = ie.shape
    kw = dict(dt=0.2, use_adex=True, decays=decays)
    packed = neuron_ops.pack_params(params, decays, (N, C))
    g_state, g_rc, g_recs = neuron_ops.neuron_window(
        s0, rc0, ie, ii, params, packed_params=packed, **kw)
    p_state, p_rc, p_recs = neuron_window_ref(s0, rc0, ie, ii, params, **kw)
    torch.cuda.synchronize()
    n_spk = float(g_recs[0].sum())
    if n_spk == 0:
        raise AssertionError("neuron_scan: the test drive elicited no spike")
    for name, a, b in zip(("spikes", "rate_counters", *g_state._fields),
                          (g_recs[0], g_rc, *g_state),
                          (p_recs[0], p_rc, *p_state)):
        if not torch.equal(a, b):
            raise AssertionError(f"neuron_scan: {name} differs from the "
                                 f"plain version (max |diff| "
                                 f"{float((a - b).abs().max())})")

    def call():
        return neuron_ops.neuron_window(s0, rc0, ie, ii, params,
                                        packed_params=packed, **kw)
    ms = time_ms(call, 25)
    host = []
    for _ in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    host.sort()
    floor_ms = time_ms(lambda: neuron_ops.chain_floor_probe(
        s0, rc0, ie, ii, params, dt=kw["dt"], decays=decays,
        packed_params=packed), 25)
    # currents read, state and parameters read, spikes and state written;
    # about 30 flops a step (the wrapper's declared work)
    work = neuron_ops.work(T, N, C)
    b_ms, b_by = bound_ms(work.bytes, work.flops)
    log(f"[2] neuron_scan at [T={T}, N={N}, C={C}], {n_spk:.0f} spikes: "
        f"{ms:.4f} ms device time as the main path calls it; wrapper and "
        f"kernel on the host clock {host[len(host) // 2]:.4f} ms; chain "
        f"floor (currents in registers) {floor_ms:.4f} ms, {ms / floor_ms:.2f}"
        f"x; byte bound {b_ms:.4f} ms ({b_by}); bit-equal to the plain "
        f"version")
    return _row("neuron_scan", work, call,
                max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, ms=ms, chain_floor_ms=floor_ms,
                plain_ms=time_ms(lambda: neuron_window_ref(
                    s0, rc0, ie, ii, params, **kw), 3))


def synray_row(ev, ea, w_h, st_h, tag):
    """synray on one Dale half's window with row-constant addresses (the
    main path's const_addr form): within 1e-4 of the plain version, the
    const-address form bit-equal to the general form; both forms timed
    beside ``torch.bmm`` on the same window with the mask resolved (the
    library yardstick, used nowhere in the port). The bound counts the
    bytes the const form needs (event values, step 0's addresses, the two
    int8 stores, the output) and one FMA per non-zero event and matched
    column."""
    import torch
    from repro_torch.kernels.synray import ops as synray_ops
    from repro_torch.kernels.synray.ref import synaptic_current_ref
    T, N, Rh = ev.shape
    C = w_h.shape[-1]
    got = synray_ops.synaptic_current(ev, ea, w_h, st_h, const_addr=True)
    general = synray_ops.synaptic_current(ev, ea, w_h, st_h)
    want = synaptic_current_ref(ev, ea, w_h, st_h)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    if not torch.equal(got, general):
        raise AssertionError(f"{tag} synray: the const-address form differs "
                             "from the general form on constant addresses")
    err = float((got - want).abs().max())
    match = (st_h == ea[0].unsqueeze(-1)).float()        # [N, Rh, C]
    w_eff = w_h.float() * match
    ev_n = ev.permute(1, 0, 2).contiguous()               # [N, T, Rh]
    lib_ms = time_ms(lambda: torch.bmm(ev_n, w_eff), 25)
    nz = (ev != 0).float()
    n_fma = float(torch.einsum("tnr,nr->", nz, match.sum(-1)))
    work = synray_ops.work(T, N, Rh, C)
    b_ms, b_by = bound_ms(work.bytes, 2 * n_fma)

    def call():
        return synray_ops.synaptic_current(ev, ea, w_h, st_h, const_addr=True)
    ms = time_ms(call, 25)
    general_ms = time_ms(lambda: synray_ops.synaptic_current(ev, ea, w_h,
                                                             st_h), 25)
    log(f"{tag} synray at [T={T}, N={N}, R={Rh}, C={C}], event density "
        f"{float(nz.mean()):.4f}: const_addr form {ms:.4f} ms, general form "
        f"{general_ms:.4f} ms, torch.bmm (mask resolved) {lib_ms:.4f} ms; "
        f"const / bmm = {ms / lib_ms:.2f}; const == general bit for bit")
    return _row("synray", work, call,
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, ms=ms,
                plain_ms=time_ms(lambda: synaptic_current_ref(
                    ev, ea, w_h, st_h), 5))


def corr_row(ops, kw, tag):
    """corr bit-equal to its plain version, both timed; the bound counts
    the operations this data needs (a post spike updates a column of a_c,
    a pre spike a row of a_a: multiply, add and min each) and the bytes
    (spike windows and traces read, accumulators read and written)."""
    import torch
    from repro_torch.kernels.corr import ops as corr_ops
    from repro_torch.kernels.corr.ref import correlation_window_ref
    pre, post = ops[0], ops[1]
    T, N, R = pre.shape
    C = post.shape[-1]
    got = corr_ops.correlation_window(*ops, **kw)
    want = correlation_window_ref(*ops, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("a_causal", "a_acausal", "tp", "tq"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag} corr: {name} differs from the plain "
                                 f"version (max |diff| "
                                 f"{float((a - b).abs().max())})")
    n_pre = float((pre != 0).sum())
    n_post = float((post != 0).sum())
    n_ops = 3 * (n_post * R + n_pre * C)
    work = corr_ops.work(T, N, R, C)
    b_ms, b_by = bound_ms(work.bytes, n_ops)

    def call():
        return corr_ops.correlation_window(*ops, **kw)
    ms = time_ms(call, 25)
    log(f"{tag} corr at [T={T}, N={N}, R={R}, C={C}], spike density pre "
        f"{n_pre / pre.numel():.4f} post {n_post / post.numel():.4f}: "
        f"{ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {ms / b_ms:.2f}x the "
        f"bound; bit-equal to the plain version")
    return _row("corr", work, call,
                max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, ms=ms,
                plain_ms=time_ms(lambda: correlation_window_ref(*ops, **kw),
                                 3))


def _check_synray_sparse(rng, dev, N, T, R, C):
    """synray_sparse on a no-stimulus window of one Dale half (the §5
    background rate, row-constant addresses, the half read in place from
    the full [T, N, R] planes as the main path reads it): the window form
    (the route's: no pack) equal to the dense synray kernel bit for bit,
    to the record form fed ``regroup_window``'s records bit for bit, and
    to its plain version within 1e-4; timed as the gated route launches it
    (behind the census's flag), beside the census, the pack it replaced,
    the record form, the dense kernel and ``torch.bmm`` on the same
    window. Returns the ``synray_sparse`` and ``census`` rows."""
    import torch
    from repro_torch.core import events
    from repro_torch.kernels.census import ops as census_ops
    from repro_torch.kernels.census.ref import census_ref
    from repro_torch.kernels.synray import ops as synray_ops
    from repro_torch.kernels.synray_sparse import ops as sparse_ops
    from repro_torch.kernels.synray_sparse.ref import sparse_window_ref
    import numpy as np

    Rh = R // 2
    w = dev(rng.integers(0, 64, (N, R, C), dtype=np.int8))
    st = dev(rng.integers(0, 4, (N, R, C), dtype=np.int8))
    ev_full = dev((rng.random((T, N, R)) < BG_PROB).astype(np.float32)
                  * rng.uniform(0.2, 1.2, (T, N, R)).astype(np.float32))
    ea_full = dev(np.broadcast_to(rng.integers(0, 4, (N, R), dtype=np.int8),
                                  (T, N, R)))
    ev, ea = ev_full[..., 0::2], ea_full[..., 0::2]
    w_h, st_h = w[:, 0::2, :], st[:, 0::2, :]
    kw = dict(max_events=MAX_EVENTS, k_cap=K_CAP)
    flag = census_ops.census(ev, MAX_EVENTS, K_CAP)
    c_plain = census_ref(ev, MAX_EVENTS, K_CAP)
    torch.cuda.synchronize()
    if not torch.equal(flag, c_plain):
        raise AssertionError(f"census {flag.tolist()} differs from its plain "
                             f"version {c_plain.tolist()}")
    fits, n_ev, k_max = flag.tolist()
    if not fits:
        raise AssertionError(f"synray_sparse: the test window does not fit "
                             f"({n_ev}, {k_max})")
    got = sparse_ops.sparse_current_window(ev, ea, w_h, st_h, flag=flag, **kw)
    ordered = sparse_ops.sparse_current_window(ev, ea, w_h, st_h, **kw)
    dense = synray_ops.synaptic_current(ev, ea, w_h, st_h, const_addr=True)
    ev_n, ea_n = ev.permute(1, 0, 2), ea.permute(1, 0, 2)     # [N, T, Rh]
    recs = events.regroup_window(ev_n, ea_n, MAX_EVENTS, K_CAP)
    rec = sparse_ops.sparse_window(*recs, w_h, st_h)
    want = sparse_window_ref(*recs, w_h, st_h).permute(1, 0, 2)
    torch.cuda.synchronize()
    if not torch.equal(got, dense):
        raise AssertionError("synray_sparse differs from the dense synray "
                             "kernel on a window that fits")
    if not (torch.equal(got, rec.permute(1, 0, 2))
            and torch.equal(got, ordered)):
        raise AssertionError("synray_sparse: the window form (gated or "
                             "ordered) differs from the record form on "
                             "regroup_window's records")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    err = float((got - want).abs().max())
    # what this window needs: the efficacy and address planes as strided
    # reads (every 32-byte sector of the full [T, N, R] planes), the two
    # stores of the half, the output; one FMA per kept record and matched
    # column
    rows_t, addr_t, eff_t = recs
    live = eff_t != 0
    nn = torch.arange(N, device=w.device).reshape(-1, 1, 1)
    match = st_h[nn, rows_t.long()].to(torch.int32) == addr_t.unsqueeze(-1)
    n_fma = float((match & live.unsqueeze(-1)).sum())
    work = sparse_ops.work_window(T, N, Rh, C, MAX_EVENTS, K_CAP,
                                  ev.stride(-1))
    n_bytes = work.bytes
    b_ms, b_by = bound_ms(n_bytes, 2 * n_fma)
    w_eff = w_h.float() * (st_h == ea[0].unsqueeze(-1)).float()
    ev_c = ev_n.contiguous()
    lib_ms = time_ms(lambda: torch.bmm(ev_c, w_eff), 25)
    ms = time_ms(lambda: sparse_ops.sparse_current_window(
        ev, ea, w_h, st_h, flag=flag, **kw), 25)
    row = _row(
        "synray_sparse", work, lambda: sparse_ops.sparse_current_window(
            ev, ea, w_h, st_h, flag=flag, **kw),
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        ms=ms, plain_ms=time_ms(lambda: sparse_window_ref(
            *events.regroup_window(ev_n, ea_n, MAX_EVENTS, K_CAP), w_h,
            st_h), 5))
    # the census: the efficacy plane once (every sector), the census out
    c_work = census_ops.work(T, N, Rh, ev.stride(-1))
    cb_ms, cb_by = bound_ms(c_work.bytes, c_work.flops)
    census_row = _row(
        "census", c_work, lambda: census_ops.census(ev, MAX_EVENTS, K_CAP),
        max_abs_err=0.0, bound_ms=cb_ms, bound_by=cb_by, library_ms=None,
        ms=time_ms(lambda: census_ops.census(ev, MAX_EVENTS, K_CAP), 25),
        plain_ms=time_ms(lambda: census_ref(ev, MAX_EVENTS, K_CAP), 25))
    pack_ms = time_ms(lambda: events.regroup_window(ev_n, ea_n, MAX_EVENTS,
                                                    K_CAP), 25)
    rec_ms = time_ms(lambda: sparse_ops.sparse_window(*recs, w_h, st_h), 25)
    ordered_ms = time_ms(lambda: sparse_ops.sparse_current_window(
        ev, ea, w_h, st_h, **kw), 25)
    dense_ms = time_ms(lambda: synray_ops.synaptic_current(
        ev, ea, w_h, st_h, const_addr=True), 25)
    skip_ms = time_ms(lambda: synray_ops.synaptic_current(
        ev, ea, w_h, st_h, const_addr=True, flag=flag), 25)

    def gated():
        f = census_ops.census(ev, MAX_EVENTS, K_CAP)
        out = sparse_ops.sparse_current_window(ev, ea, w_h, st_h, flag=f,
                                               **kw)
        synray_ops.synaptic_current(ev, ea, w_h, st_h, const_addr=True,
                                    flag=f, out=out)
    gated_ms = time_ms(gated, 25)
    log(f"[2] synray_sparse window at [T={T}, N={N}, R={Rh} (a Dale half "
        f"in place), C={C}]: {n_ev} events (worst instance), k_max={k_max}, "
        f"{n_fma:.0f} FMAs; window form {ms:.4f} ms (behind the census's "
        f"flag; no pack), bound {b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.2f} "
        f"MB), {ms / b_ms:.2f}x the bound; its ordered form (no census, as "
        f"sparse=\"always\" runs it) {ordered_ms:.4f} ms; census "
        f"{census_row['ms']:.4f} ms; the pack it replaced (regroup_window) "
        f"{pack_ms:.4f} ms; record form {rec_ms:.4f} ms; dense synray "
        f"{dense_ms:.4f} ms, behind a "
        f"flag that skips it {skip_ms:.4f} ms; torch.bmm (mask resolved) "
        f"{lib_ms:.4f} ms; census + both route kernels {gated_ms:.4f} ms; "
        f"gated == ordered == dense == record form bit for bit")
    return row, census_row


def stp_row(rng, dev, N, T, R):
    """stp_scan in its census form (the main path's: both Dale halves'
    censuses at the gate's capacities of 512 columns) and without it,
    bit-equal to its plain version (eff and r_T, the sign of zero
    included; both censuses equal, and equal to the census kernel's on
    each half) at the main path's [T=128, 16, 256] and the closed loop's
    [T=256, 32], on spikes at the §5 rates (background and pattern
    bursts), with resources at 0 and 1 and negative scales (-0.0
    efficacies). Timed at the main-path shape: the census form in turns
    with the composition it replaced (the scan without the census, then
    the census kernel on each Dale half), the form without the census and
    the chain floor (``chain_floor_probe``: the recurrence with its spikes
    in registers, at the scan's block and at the earlier kernel's 64
    threads), beside its plain version; at [T=256, 32] the form without
    the census (the closed loop's, below the census floor) and its floor.
    The bound counts the spikes read and the efficacies written (4 bytes
    each), r0, the scale and r_T and the two censuses, and 15 operations a
    step and lane (a test an element for the census)."""
    import numpy as np
    import torch
    from repro_torch.core import stp, synapse
    from repro_torch.kernels.census import ops as census_ops
    from repro_torch.kernels.stp_scan import ops as stp_ops
    from repro_torch.kernels.stp_scan.ref import (stp_scan_census_ref,
                                                  stp_scan_ref)
    kw = dict(u=0.2, recovery=stp.recovery_factor(20.0, 0.2))

    def operands(T_, prefix, R_):
        # background, and pattern bursts on a sixth of the rows
        sp = rng.random((T_, *prefix, R_)) < BG_PROB
        k = R_ // 6
        sp[::16, ..., :k] |= rng.random((len(range(0, T_, 16)), *prefix,
                                         k)) < 0.8
        r0 = rng.random((*prefix, R_)).astype(np.float32)
        scale = rng.normal(1.0, 0.25, (*prefix, R_)).astype(np.float32)
        return dev(r0), dev(sp.astype(np.float32)), dev(scale)

    def caps_of(T_, R_):
        return tuple(synapse.route_plan(T_, len(range(h, R_, 2)), 512,
                                        const_addr=True, sparse="always")[1:]
                     for h in (0, 1))

    def bits(x):
        return x.contiguous().view(torch.int32)

    def check(r0, sp, scale, label):
        caps = caps_of(sp.shape[0], sp.shape[-1])
        got = stp_ops.stp_scan(r0, sp, scale, caps=caps, **kw)
        plain = stp_ops.stp_scan(r0, sp, scale, **kw)
        want = stp_scan_census_ref(r0, sp, scale, caps=caps, **kw)
        comp = [census_ops.census(got[0][..., h::2], *caps[h])
                for h in (0, 1)]
        torch.cuda.synchronize()
        for name, a, b in zip(("eff", "r_T"), got, want):
            if not (torch.equal(bits(a), bits(b))
                    and torch.equal(bits(a), bits(plain[name == "r_T"]))):
                raise AssertionError(f"stp_scan {label}: {name} differs from "
                                     f"the plain version")
        for h in (0, 1):
            if not (torch.equal(got[2 + h], want[2 + h])
                    and torch.equal(got[2 + h], comp[h])):
                raise AssertionError(
                    f"stp_scan {label}: half {h}'s census "
                    f"{got[2 + h].tolist()}, plain {want[2 + h].tolist()}, "
                    f"census kernel {comp[h].tolist()}")
        return [c.tolist() for c in got[2:]]
    main = operands(T, (N,), R)
    cens = check(*main, f"[T={T}, {N}, {R}]")
    small = operands(256, (), 32)
    check(*small, "[T=256, 32]")
    r0, sp, scale = main
    check(torch.zeros_like(r0), sp, -scale.abs(), "r0 = 0, negative scale")
    check(torch.ones_like(r0), sp, scale, "r0 = 1")
    caps = caps_of(T, R)
    work = stp_ops.work(T, N, R, census=True)
    n_bytes = work.bytes
    b_ms, b_by = bound_ms(n_bytes, work.flops)

    def fused():
        return stp_ops.stp_scan(r0, sp, scale, caps=caps, **kw)

    def composed():
        eff, _ = stp_ops.stp_scan(r0, sp, scale, **kw)
        for h in (0, 1):
            census_ops.census(eff[..., h::2], *caps[h])
    turns = {"fused": [], "composed": []}
    for i in range(4):
        for k in (("fused", "composed") if i % 2 == 0
                  else ("composed", "fused")):
            turns[k].append(time_ms(fused if k == "fused" else composed, 25))
    ms = float(np.median(turns["fused"]))
    comp_ms = float(np.median(turns["composed"]))
    plain_form_ms = time_ms(lambda: stp_ops.stp_scan(r0, sp, scale, **kw),
                            25)
    floor_ms = time_ms(lambda: stp_ops.chain_floor_probe(r0, sp, scale,
                                                         **kw), 25)
    floor64_ms = time_ms(lambda: stp_ops.chain_floor_probe(
        r0, sp, scale, threads=64, **kw), 25)
    small_ms = time_ms(lambda: stp_ops.stp_scan(*small, **kw), 25)
    small_floor_ms = time_ms(lambda: stp_ops.chain_floor_probe(*small, **kw),
                             25)
    plain_ms = time_ms(lambda: stp_scan_census_ref(r0, sp, scale, caps=caps,
                                                   **kw), 3)
    log(f"[2] stp_scan at [T={T}, N={N}, R={R}], census form (censuses "
        f"{cens} at capacities {caps}): {ms:.4f} ms "
        f"[{', '.join(f'{t:.4f}' for t in turns['fused'])}], in turns with "
        f"the composition it replaced (the scan without the census + the "
        f"census kernel on each half) {comp_ms:.4f} ms "
        f"[{', '.join(f'{t:.4f}' for t in turns['composed'])}]; without the "
        f"census {plain_form_ms:.4f} ms; chain floor (spikes in registers) "
        f"{floor_ms:.4f} ms at the scan's block, {floor64_ms:.4f} ms at 64 "
        f"threads a block; bound {b_ms:.4f} ms ({b_by}: "
        f"{n_bytes / 1e6:.2f} MB); plain version {plain_ms:.4f} ms. At "
        f"[T=256, 32] without the census {small_ms:.4f} ms, chain floor "
        f"{small_floor_ms:.4f} ms. Both forms bit-equal to the plain "
        f"version there and with r0 = 0 and a negative scale (-0.0 "
        f"efficacies) and r0 = 1, the censuses equal to census_ref's and the "
        f"census kernel's")
    return _row("stp_scan", work, fused, max_abs_err=0.0, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, ms=ms, plain_ms=plain_ms,
                chain_floor_ms=floor_ms, composed_ms=comp_ms)


def _check_ppu_update(rng, dev, N, R, C):
    """ppu_update at 16 x 256 x 512: bit-equal to its plain version."""
    import torch
    from repro_torch.kernels.ppu_update import ops as ppu_ops
    from repro_torch.kernels.ppu_update.ref import rstdp_update_ref
    import numpy as np

    shape = (N, R, C)
    args = (dev(rng.integers(0, 64, shape, dtype=np.int8)),
            dev(rng.uniform(0, 40, shape).astype(np.float32)),
            dev(rng.uniform(0, 40, shape).astype(np.float32)),
            dev(rng.uniform(-3, 12, (N, C)).astype(np.float32)),
            dev(rng.uniform(0.8, 1.2, (N, C)).astype(np.float32)),
            dev(rng.uniform(-1, 1, (N, C)).astype(np.float32)),
            dev((0.3 * rng.standard_normal(shape)).astype(np.float32)))
    got = ppu_ops.rstdp_update(*args, eta=4.0)
    want = rstdp_update_ref(*args, eta=4.0)
    torch.cuda.synchronize()
    for name, a, b in zip(("weights", "eligibility"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"ppu_update: {name} differ from the plain "
                                 f"version")
    work = ppu_ops.work(N, R, C)
    b_ms, b_by = bound_ms(work.bytes, work.flops)
    row = _row(
        "ppu_update", work, lambda: ppu_ops.rstdp_update(*args, eta=4.0),
        max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ms=time_ms(lambda: ppu_ops.rstdp_update(*args, eta=4.0), 25),
        plain_ms=time_ms(lambda: rstdp_update_ref(*args, eta=4.0), 5))
    # the faulted form (path D's): a chain of CADC code offsets and stuck
    # columns folded into one clamp-shift a column, from its own seed
    from repro_torch.faults import FaultPlan, inject
    frng = np.random.default_rng(18)
    plans = [FaultPlan(cadc_code_offset=frng.integers(-40, 40, (N, C)),
                       cadc_stuck_mask=frng.random((N, C)) < 0.05,
                       cadc_stuck_code=frng.integers(0, 256, (N, C)).astype(
                           np.int32)) for _ in range(2)]
    cmap = inject.cadc_map(plans, args[0].device, 255)
    got = ppu_ops.rstdp_update(*args, eta=4.0, cadc_map=cmap)
    want = rstdp_update_ref(*args, eta=4.0, cadc_map=cmap)
    torch.cuda.synchronize()
    for name, a, b in zip(("weights", "eligibility"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"ppu_update with CADC faults: {name} "
                                 f"differ from the plain version")
    f_ms = time_ms(lambda: ppu_ops.rstdp_update(*args, eta=4.0,
                                                cadc_map=cmap), 25)
    log(f"[2] ppu_update with a CADC fault map (two plans of offsets and "
        f"stuck columns, folded): {f_ms:.4f} ms against {row['ms']:.4f} "
        f"without; bit-equal to the plain version")
    return row


def _to(tree, device):
    import torch
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return type(tree)(*(_to(v, device) for v in tree))


def _full_width(**kw):
    """The §5 experiment at full width on the card: 16 instances of the
    256 x 512 chip, 128 inputs x 512 neurons, T = 128."""
    import torch
    from repro_torch.configs.bss2 import BSS2
    from repro_torch.core.hybrid import RSTDPConfig, make_experiment
    ecfg = RSTDPConfig(n_inputs=128, n_neurons=512, pattern_size=24,
                       trial_steps=128)
    kw = dict(cfg=BSS2, ecfg=ecfg, prefix=(16,), backend="blocked", **kw)
    init, trial, meta = make_experiment(
        generator=torch.Generator().manual_seed(11), device="cuda", **kw)
    return init, trial, meta, kw


def _route_spy(log_to):
    """Wrap ``synapse.window_route`` to keep each window's gate input,
    decision and the census it was given (a device copy: the STP scan's
    census of the half; the census is also computed from the input after
    the timed run)."""
    from repro_torch.core import synapse
    real = synapse.window_route

    def spy(row_events_t, C, **kw):
        out = real(row_events_t, C, **kw)
        census = kw.get("census")
        log_to.append((row_events_t, out,
                       None if census is None else census.clone()))
        return out
    synapse.window_route = spy
    return lambda: setattr(synapse, "window_route", real)


def _device_routes(snaps, n_trials):
    """Per trial, the route both of its Dale halves took on the device,
    from clones of ``synapse.route_counts`` taken after each trial (read
    after the run): "sparse", "dense", or the counts when they differ."""
    import torch
    counts = torch.stack(snaps).cpu().tolist()
    out = []
    for i in range(n_trials):
        d = [a - b for a, b in zip(counts[i + 1], counts[i])]
        out.append({(0, 2): "sparse", (2, 0): "dense"}.get(tuple(d), d))
    return out


def phase_main_path():
    """Path A: the full-width §5 slice with the reference's default
    ``sparse_mode``, 6 trials of 16 instances of the chip."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core import events, synapse

    init, trial, meta, kw = _full_width()
    stims = [1, 2, 0, 1, 2, 0]
    draws = meta["draw"](torch.Generator().manual_seed(12), stims)
    state0 = init()

    gate_log = []
    restore = _route_spy(gate_log)
    routes_dev = synapse.route_counts("cuda")
    synapse.reset_route_counts()
    snaps = [routes_dev.clone()]
    kernels.reset_launches()
    times, states, metrics = [], [], []
    state = state0
    try:
        for i, stim in enumerate(stims):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            state, m = trial(state, stim, draws.events[i], draws.xi[i])
            b.record()
            snaps.append(routes_dev.clone())     # a device copy, no read
            b.synchronize()
            times.append(a.elapsed_time(b))
            states.append(state)
            metrics.append(m)
    finally:
        restore()
    counts = dict(kernels.LAUNCHES)
    # every window is gated on the device: the STP scan takes both Dale
    # halves' censuses (no census kernel), both route kernels launch, and
    # the flag lets one of the two compute
    want = {"synray": 12, "synray_sparse": 12, "census": 0,
            "neuron_scan": 6, "corr": 6, "ppu_update": 0, "ppuvm_exec": 0,
            "stp_scan": 6}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    if len(gate_log) != 2 * len(stims):
        raise AssertionError(f"{len(gate_log)} gated windows, expected "
                             f"{2 * len(stims)}")
    routes = _device_routes(snaps, len(stims))
    log(f"[3] routes on the device after the 6 trials (dense, sparse): "
        f"{routes_dev.tolist()}")
    for i, stim in enumerate(stims):
        for h, (ev, (route, me, kc), cen) in enumerate(
                gate_log[2 * i:2 * i + 2]):
            n_ev, k_max = (int(x) for x in events.window_stats(ev))
            log(f"[3] trial {i} (stim {stim}) {('exc', 'inh')[h]} half: "
                f"census n_events={n_ev} k_max={k_max} vs capacities "
                f"({me}, {kc}) -> {route}: {routes[i]} on the device; the "
                f"STP scan's census {cen.tolist()}")
            if route != "gate":
                raise AssertionError(f"trial {i}: the window was routed "
                                     f"{route} on the host")
            fits = int(n_ev <= me and k_max <= kc)
            if cen.tolist() != [fits, n_ev, k_max]:
                raise AssertionError(f"trial {i} half {h}: the scan's "
                                     f"census {cen.tolist()}, the window's "
                                     f"{[fits, n_ev, k_max]}")
        expect = "sparse" if stim == 0 else "dense"
        if routes[i] != expect:
            raise AssertionError(f"trial {i} (stim {stim}) took {routes[i]}")
    no_host_read(trial, states[-1], 0, draws.events[2], draws.xi[2])

    for x in _flatten(state):
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            raise AssertionError("non-finite state after the full-width run")
    for m in metrics:
        if not bool((m["rates"] == torch.round(m["rates"])).all()):
            raise AssertionError("rate counters are not whole numbers")
    total_spikes = float(sum(m["rates"].sum() for m in metrics))
    t_sparse = [t for t, s in zip(times, stims) if s == 0]
    t_dense = [t for t, s in zip(times, stims) if s != 0]
    log(f"[3] full width 16 x 256 x 512, T=128: trial_ms="
        f"{sorted(times)[len(times) // 2]:.3f} (median of {len(stims)}; "
        f"first {times[0]:.3f}) launches={counts} spikes={total_spikes:.0f}")
    log(f"[3] trial ms by route: no-stimulus (synray_sparse) "
        f"{', '.join(f'{t:.3f}' for t in t_sparse)}; pattern (synray) "
        f"{', '.join(f'{t:.3f}' for t in t_dense)}")

    # the first trial (pattern, dense) and the first no-stimulus trial
    # (sparse) again on the CPU, from the same state and draws
    for i in (0, stims.index(0)):
        before = state0 if i == 0 else states[i - 1]
        check_against_cpu(meta, kw, before, stims[i], draws.events[i],
                          draws.xi[i], states[i], metrics[i], routes[i],
                          f"trial {i}")
    graph_a = graph_vs_eager(trial, state0, stims, draws, states[-1],
                             metrics, snaps[-1].tolist(), counts, "[3]")
    old_composition_same(trial, state0, stims, draws, states[-1], metrics,
                         snaps[-1].tolist(), [c for _, _, c in gate_log])
    phase_profile(trial, meta, state0, stims, draws)
    i0 = stims.index(0)
    gate_cost(draws.events[i0])
    route_ab(states[i0 - 1], stims[i0], draws.events[i0], draws.xi[i0])
    kernels_on_trial(trial, state0, stims[0], draws.events[0], draws.xi[0],
                     "trial 0 (stim 1)")
    return (counts, states[-1], draws, meta, sorted(times)[len(times) // 2],
            graph_a)


def _old_composition():
    """Turn the STP scan's census form into the composition it replaced:
    the scan without the census, then the census kernel on each Dale half
    (which counts the routes). Returns the undo."""
    from repro_torch.kernels.census import ops as census_ops
    from repro_torch.kernels.stp_scan import ops as stp_ops
    real = stp_ops.stp_scan

    def composed(r0, spikes_t, scale, *, caps=None, routes=None, **kw):
        eff, r_T = real(r0, spikes_t, scale, **kw)
        if caps is None:
            return eff, r_T
        return (eff, r_T, *(census_ops.census(eff[..., h::2], me, kc,
                                              routes=routes)
                            for h, (me, kc) in enumerate(caps)))
    stp_ops.stp_scan = composed
    return lambda: setattr(stp_ops, "stp_scan", real)


def old_composition_same(trial, state0, stims, draws, state_e, metrics_e,
                         routes_e, census_e):
    """Path A's trials through the composition the census form replaced
    (``_old_composition``), eager and as replays of one captured trial
    graph, from the same state and draws: the histories, the final state,
    the device route counts and every window's census equal the census
    form's eager run bit for bit (12 census launches in place of none).
    Then a graph of each composition, their replays timed in turns."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core import hybrid as th
    from repro_torch.core import synapse

    def same(hist_or_metrics, state, what):
        for k in metrics_e[0]:
            want = torch.stack([m[k] for m in metrics_e])
            got = (hist_or_metrics[k] if isinstance(hist_or_metrics, dict)
                   else torch.stack([m[k] for m in hist_or_metrics]))
            if not torch.equal(got, want):
                raise AssertionError(f"[3] {what}: {k} differs from the "
                                     "census form's")
        for a, b in zip(_flatten(state), _flatten(state_e)):
            if not torch.equal(a, b):
                raise AssertionError(f"[3] {what}: the final state differs "
                                     "from the census form's")
    routes = synapse.route_counts("cuda")
    gate_log = []
    undo = _old_composition()
    try:
        restore = _route_spy(gate_log)
        try:
            synapse.reset_route_counts()
            kernels.reset_launches()
            st, hist = state0, []
            for i, stim in enumerate(stims):
                st, m = trial(st, stim, draws.events[i], draws.xi[i])
                hist.append(m)
            torch.cuda.synchronize()
        finally:
            restore()
        n_old = dict(kernels.LAUNCHES)
        if n_old["census"] != 2 * len(stims) or routes.tolist() != routes_e:
            raise AssertionError(f"[3] the old composition launched "
                                 f"{n_old}, routes {routes.tolist()}")
        same(hist, st, "the old composition, eager")
        census_old = [c for _, _, c in gate_log]
        if [c.tolist() for c in census_old] != [c.tolist()
                                                for c in census_e]:
            raise AssertionError("[3] the old composition's censuses "
                                 f"{[c.tolist() for c in census_old]}, the "
                                 f"scan's {[c.tolist() for c in census_e]}")
        old_graph = th.TrialGraph(th.TrialLoop(trial, state0, stims, draws))
    finally:
        undo()
    synapse.reset_route_counts()
    for _ in stims:
        old_graph.replay()
    torch.cuda.synchronize()
    if routes.tolist() != routes_e:
        raise AssertionError(f"[3] the old composition's replays routed "
                             f"{routes.tolist()}, eager {routes_e}")
    same(old_graph.loop.history(), old_graph.loop.state,
         "the old composition, replayed")
    # each graph replays its trials once more, in turns (a replay reads
    # its trial at the loop's counter: reset, never past the last trial)
    old_graph.loop.reset()
    new_graph = th.TrialGraph(th.TrialLoop(trial, state0, stims, draws))
    times = {"census form": [], "old composition": []}
    graphs = {"census form": new_graph, "old composition": old_graph}
    for i in range(len(stims)):
        order = list(graphs) if i % 2 == 0 else list(graphs)[::-1]
        for k in order:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graphs[k].replay()
            b.record()
            b.synchronize()
            times[k].append(a.elapsed_time(b))
    log(f"[3] the {len(stims)} trials through the old composition (the scan "
        f"without the census, then the census kernel on each half; "
        f"launches {n_old}), eager and replayed: histories, final state, "
        f"device routes {routes_e} and the 12 windows' censuses equal to the "
        f"census form's bit for bit. Replays in turns (kernels a replay: "
        f"census form {sum(new_graph.launches.values())}, old "
        f"{sum(old_graph.launches.values())} of the port's): " + "; ".join(
            f"{k} median {np.median(v):.4f} ms ["
            + ", ".join(f"{t:.4f}" for t in v) + "]"
            for k, v in times.items()))


def standalone_window():
    """A window that did not come out of the STP scan, through the entry
    point a user calls for one (``synapse.synaptic_current_window`` with
    ``sparse="auto"``): one Dale half of a no-stimulus full-width window,
    the launch counts set to 0 before and read after. On the card the gate
    launches the census kernel and both route kernels; the currents equal
    those of the route its census picks. Returns the counts."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core import synapse
    rng = np.random.default_rng(5)
    T, N, R, C = 128, 16, 256, 512
    cuda = torch.device("cuda")

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
    ev = dev((rng.random((T, N, R)) < BG_PROB).astype(np.float32)
             * rng.uniform(0.2, 1.2, (T, N, R)).astype(np.float32))[..., 0::2]
    ea = dev(np.broadcast_to(rng.integers(0, 4, (N, R), dtype=np.int8),
                             (T, N, R)))[..., 0::2]
    w = dev(rng.integers(0, 64, (N, R, C), dtype=np.int8))[:, 0::2]
    a = dev(rng.integers(0, 4, (N, R, C), dtype=np.int8))[:, 0::2]
    gain = dev(rng.uniform(0.8, 1.2, (N, C)).astype(np.float32))
    routes = synapse.route_counts(cuda)
    synapse.reset_route_counts()
    kernels.reset_launches()
    got = synapse.synaptic_current_window(w, a, ev, ea, gain,
                                          const_addr=True)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    if (counts["census"], counts["synray_sparse"], counts["synray"]) != \
            (1, 1, 1) or routes.tolist() != [0, 1]:
        raise AssertionError(f"[3] the standalone window launched {counts}, "
                             f"routes {routes.tolist()}")
    want = synapse.synaptic_current_window(w, a, ev, ea, gain,
                                           const_addr=True, sparse="always")
    if not torch.equal(got, want):
        raise AssertionError("[3] the standalone gated window differs from "
                             "its sparse route")
    log(f"[3] a standalone window (one no-stimulus Dale half through "
        f"synaptic_current_window, sparse=\"auto\"): launches {counts}, "
        f"routed sparse on the census kernel's flag, equal to the sparse "
        f"route bit for bit")
    return counts


def _keep(x):
    """A copy of a wrapper's operand with its strides (tensors inside
    tuples and dicts too)."""
    import torch
    if isinstance(x, torch.Tensor):
        return torch.empty_strided(x.size(), x.stride(), dtype=x.dtype,
                                   device=x.device).copy_(x)
    if isinstance(x, dict):
        return {k: _keep(v) for k, v in x.items()}
    if isinstance(x, tuple):
        vals = [_keep(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def _capture_path(calls):
    """Wrap the six wrappers a window of the emulation launches (``stp_scan``,
    ``census``, ``synray``, ``synray_sparse``, ``neuron_scan``, ``corr``)
    so that each call keeps a copy of its operands (with their strides)
    before it runs; returns the undo."""
    from repro_torch.kernels.census import ops as census_ops
    from repro_torch.kernels.corr import ops as corr_ops
    from repro_torch.kernels.neuron_scan import ops as neuron_ops
    from repro_torch.kernels.stp_scan import ops as stp_ops
    from repro_torch.kernels.synray import ops as synray_ops
    from repro_torch.kernels.synray_sparse import ops as sparse_ops
    real = {}
    for name, mod, fn in (("stp_scan", stp_ops, "stp_scan"),
                          ("census", census_ops, "census"),
                          ("synray", synray_ops, "synaptic_current"),
                          ("synray_sparse", sparse_ops,
                           "sparse_current_window"),
                          ("neuron_scan", neuron_ops, "neuron_window"),
                          ("corr", corr_ops, "correlation_window")):
        f = real[(mod, fn)] = getattr(mod, fn)

        def spy(*args, _f=f, _name=name, **kw):
            calls.append((_name, _keep(args), _keep(kw)))
            return _f(*args, **kw)
        setattr(mod, fn, spy)

    def undo():
        for (mod, fn), f in real.items():
            setattr(mod, fn, f)
    return undo


def kernels_on_trial(trial, state, stim, events_t, xi, label):
    """synray and corr again on the operands of one path-A trial (the §5
    densities, after the timed run): the trial is rerun with its operands
    captured, then each kernel is checked and timed on them as in phase
    2. The dense windows must come in the const_addr form."""
    calls = []
    undo = _capture_path(calls)
    try:
        trial(state, stim, events_t, xi)
    finally:
        undo()
    syn = [c for c in calls if c[0] == "synray"]
    cor = [c for c in calls if c[0] == "corr"]
    if len(syn) != 2 or len(cor) != 1:
        raise AssertionError(f"{label}: {len(syn)} synray and {len(cor)} "
                             "corr calls, expected 2 and 1")
    for half, (_, args, kw) in zip(("exc", "inh"), syn):
        if kw.get("const_addr") is not True:
            raise AssertionError(f"{label}: the dense window did not take "
                                 "the const_addr form")
        synray_row(*args, f"[3] {label} {half} half:")
    _, args, kw = cor[0]
    corr_row(args, kw, f"[3] {label}:")


def route_ab(state, stim, events_t, xi, pairs=6):
    """The first no-stimulus trial run again, alternately with the
    default census gate (on the device: the census, the sparse kernel and
    the skipped dense one) and with ``sparse_mode="never"``
    (dense), on the same instance, state and draws: the end-to-end price
    or gain of the route, within one call (dense, sparse, sparse, dense,
    ...)."""
    import torch
    trials = {"dense": _full_width(sparse_mode="never")[1],
              "sparse": _full_width()[1]}
    out = {k: trials[k](state, stim, events_t, xi)[0] for k in trials}
    if not torch.equal(out["sparse"].core.syn.weights,
                       out["dense"].core.syn.weights):
        raise AssertionError("the sparse and dense routes give different "
                             "weights on a window that fits")
    text = _interleaved(trials, state, stim, events_t, xi, pairs)
    log(f"[3] no-stimulus trial, routes interleaved ({pairs} pairs): sparse "
        f"(census gate on the device) {text['sparse']}, dense "
        f"(sparse_mode=\"never\") {text['dense']}; weights equal")


def _interleaved(trials, state, stim, events_t, xi, pairs):
    """Each of the two ``trials`` on the same state and draws, in turns
    (a, b, b, a, ...), timed with CUDA events; returns each one's median
    and times as text."""
    import numpy as np
    import torch
    a_, b_ = trials
    times = {k: [] for k in trials}
    for i in range(pairs):
        order = (a_, b_) if i % 2 == 0 else (b_, a_)
        for k in order:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            trials[k](state, stim, events_t, xi)
            b.record()
            b.synchronize()
            times[k].append(a.elapsed_time(b))
    return {k: f"median {np.median(v):.3f} ms ["
            + ", ".join(f"{t:.3f}" for t in v) + "]"
            for k, v in times.items()}


def check_against_cpu(meta, kw, state_before, stim, events_t, xi, s_g, m_g,
                      route_g, label, phase=3, inst=None):
    """One trial rerun on the CPU (plain versions) from the card's state
    before it, with the same draws: the same routes, and agreement.
    ``inst``: the instance to give the CPU's experiment (in wafer mode the
    whole network's; default ``meta["inst"]``). Returns the number of
    columns left out for spike flips and the number of weight codes that
    differ."""
    import torch
    from repro_torch.core.hybrid import make_experiment
    cpu = torch.device("cpu")
    init_c, trial_c, meta_c = make_experiment(
        inst=_to(meta["inst"] if inst is None else inst, cpu), device="cpu",
        **kw)
    gate_c = []
    restore = _route_spy(gate_c)
    try:
        s_c, m_c = trial_c(_to(state_before, cpu), stim, events_t.cpu(),
                           xi.cpu())
    finally:
        restore()
    routes_c = [out[0] for _, out, _ in gate_c]
    if routes_c != [route_g, route_g]:
        raise AssertionError(f"{label}: CPU routes {routes_c}, card "
                             f"{route_g}")
    core_g, core_c = meta["core"], meta_c["core"]
    addr = torch.zeros(events_t.shape, dtype=torch.int8)
    _, out_g = core_g.run(state_before.core, events_t, addr.cuda(),
                          record_v=True)
    _, out_c = core_c.run(_to(state_before.core, cpu), events_t.cpu(), addr,
                          record_v=True)
    spk_g, spk_c = out_g["spikes"].cpu(), out_c["spikes"]
    # Spikes must agree, except that one may flip where the membrane of the
    # run that did not spike lies within rtol = atol = 1e-4 of the spike
    # threshold: the CPU's exp and the card's expf differ by an ulp, and
    # the synaptic sums run in another order. A flip changes only its own
    # column (no recurrent synapses): rate counter, reward, correlation
    # column and weights. Those columns are left out below; everything
    # else must be exact (weights within 1e-4 / one code at a .5 tie).
    flips = spk_g != spk_c
    p = meta_c["inst"]["neuron_params"]
    thr = p["v_thres"] + 2.0 * p["delta_t"]
    v_quiet = torch.where(spk_c == 0, out_c["v"], out_g["v"].cpu())
    near = (v_quiet - thr).abs() <= 1e-4 + 1e-4 * thr.abs()
    if bool((flips & ~near).any()):
        raise AssertionError(f"{label}: a spike differs between the card "
                             "and the CPU away from threshold")
    cols = flips.any(0)                                   # [N, C]
    if int(cols.sum()) > max(1, cols.numel() // 1000):
        raise AssertionError(f"{label}: {int(cols.sum())} columns with "
                             "spike flips")
    keep = ~cols
    if not torch.equal(m_g["rates"].cpu()[keep], m_c["rates"][keep]):
        raise AssertionError(f"{label}: rate counters differ")
    dws = (s_g.w_signed.cpu() - s_c.w_signed).abs()
    dw = float(dws.masked_fill(cols.unsqueeze(-2), 0).max())
    if dw > 1e-4:
        raise AssertionError(f"{label}: w_signed differs by {dw}")
    wq_g = s_g.core.syn.weights.cpu().to(torch.int32)
    wq_c = s_c.core.syn.weights.to(torch.int32)
    dq = (wq_g - wq_c).abs().masked_fill(cols.unsqueeze(-2), 0)
    if int(dq.max()) > 1:
        raise AssertionError(f"{label}: int8 weights differ by > 1 code")
    if int(dq.max()) == 1:
        w = s_c.w_signed
        rows = torch.stack([w.clamp(min=0), (-w).clamp(min=0)], dim=-2
                           ).reshape(wq_c.shape)
        frac = (rows - rows.floor() - 0.5).abs()
        if bool((frac[dq == 1] >= 1e-4).any()):
            raise AssertionError(f"{label}: a weight code differs away "
                                 "from a .5 rounding boundary")
    log(f"[{phase}] {label} CPU vs card ({route_g} route on both): "
        f"{int(flips.sum())} of {int(spk_c.sum())} spikes flipped at "
        f"threshold ({int(cols.sum())} columns left out), rates equal "
        f"elsewhere, max |w_signed diff|={dw:.3g}, weight codes differing="
        f"{int((dq > 0).sum())}")
    return int(cols.sum()), int((dq > 0).sum())


def no_host_read(trial, state, stim, events_t, xi):
    """One more no-stimulus trial (the gate's and both routes' kernels
    warmed up by the run) under ``torch.cuda.set_sync_debug_mode
    ("error")``: any device-to-host read in the trial raises."""
    import torch
    from repro_torch.core import synapse
    before = synapse.route_counts("cuda").clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trial(state, stim, events_t, xi)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    d = (synapse.route_counts("cuda") - before).tolist()
    if d != [0, 2]:
        raise AssertionError(f"the no-stimulus trial took routes {d}")
    log("[3] one no-stimulus trial under set_sync_debug_mode('error'): no "
        "device-to-host read; both Dale halves sparse on the device")


def gate_cost(events_t):
    """Host-clock cost of the census gate on one Dale half of a
    no-stimulus window: the census kernel's launch and run (the route is
    decided on the device, nothing is read back), beside the host gate it
    replaced (``window_stats`` + ``census_fits`` + one device-to-host
    read), each from a synchronised start to a synchronised end."""
    import torch
    from repro_torch.core import events
    from repro_torch.kernels.census import ops as census_ops

    def host_ms(fn):
        times = []
        for _ in range(21):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        return times[len(times) // 2], times[0]
    ev = events_t[..., 0::2]
    dev_ms = host_ms(lambda: census_ops.census(ev, MAX_EVENTS, K_CAP))
    old_ms = host_ms(lambda: bool(events.census_fits(
        *events.window_stats(ev), MAX_EVENTS, K_CAP)))
    log(f"[3] census gate, host clock (median, min of 21): on the device "
        f"(census kernel, no read back) {dev_ms[0]:.4f} ms, "
        f"{dev_ms[1]:.4f} ms; the host gate it replaced (window_stats + "
        f"census_fits + one device-to-host read) {old_ms[0]:.4f} ms, "
        f"{old_ms[1]:.4f} ms")


def graph_vs_eager(trial, state0, stims, draws, state_e, metrics_e,
                   routes_e, counts_e, tag):
    """The eager run's trials again as replays of one captured trial graph
    (``TrialGraph``) from the same state and draws: one replay launches
    what one eager trial launched, and the histories, the final state and
    the device's route counts equal the eager run's bit for bit. Then a
    second graph of the same trials, its replays timed with CUDA events in
    turns with eager trials on the same inputs (eager, graph, graph,
    eager, ...). Returns the median eager and graph trial times, and the
    first graph's launches and pool bytes."""
    import numpy as np
    import torch
    from repro_torch.core import hybrid as th
    from repro_torch.core import synapse
    n = len(stims)
    routes = synapse.route_counts("cuda")
    t0 = time.perf_counter()
    graph = th.TrialGraph(th.TrialLoop(trial, state0, stims, draws))
    capture_s = time.perf_counter() - t0
    per_trial = {k: v // n for k, v in counts_e.items()}
    if graph.launches != per_trial:
        raise AssertionError(f"{tag} the captured trial launches "
                             f"{graph.launches}, an eager one {per_trial}")
    synapse.reset_route_counts()
    for _ in range(n):
        graph.replay()
    torch.cuda.synchronize()
    if routes.tolist() != routes_e:
        raise AssertionError(f"{tag} graph routes {routes.tolist()}, eager "
                             f"{routes_e}")
    hist = graph.loop.history()
    for k in metrics_e[0]:
        if not torch.equal(hist[k], torch.stack([m[k] for m in metrics_e])):
            raise AssertionError(f"{tag} graph replay: {k} differs from the "
                                 f"eager trials")
    if hist["stim"].tolist() != list(stims):
        raise AssertionError(f"{tag} graph replay read stimuli "
                             f"{hist['stim'].tolist()}")
    for a, b in zip(_flatten(graph.loop.state), _flatten(state_e)):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag} graph replay: the final state "
                                 "differs from the eager run's")
    log(f"{tag} {n} trials as replays of one captured trial graph: "
        f"histories, final state and device routes {routes.tolist()} equal "
        f"to the eager run bit for bit; one replay launches {per_trial}; "
        f"warm-up and capture {capture_s:.2f} s, graph pool "
        f"{graph.pool_bytes / 2**20:.1f} MiB")
    timed = th.TrialGraph(th.TrialLoop(trial, state0, stims, draws))
    times = {"eager": [], "graph": []}
    st = state0

    def eager(i):
        nonlocal st
        st, _ = trial(st, stims[i], draws.events[i], draws.xi[i])
    for i in range(n):
        runs = (("eager", eager), ("graph", lambda i: timed.replay()))
        for k, fn in (runs if i % 2 == 0 else runs[::-1]):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(i)
            b.record()
            b.synchronize()
            times[k].append(a.elapsed_time(b))
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"{tag} trial ms, eager and graph in turns: eager median "
        f"{med['eager']:.3f} [{', '.join(f'{t:.3f}' for t in times['eager'])}]"
        f"; graph replay median {med['graph']:.3f} ["
        f"{', '.join(f'{t:.3f}' for t in times['graph'])}]")
    return dict(med, launches=graph.launches, pool_bytes=graph.pool_bytes)


def _trace_summary(path, n_trials):
    """From a chrome trace of ``torch.profiler``: the traced window (first
    event start to last event end: the active step), the device's busy time
    (the union of its kernel, copy and set intervals), kernel time by name,
    the number of kernels and the longest gaps between device intervals."""
    # the profiler's own span ("Trace") also covers its warm-up step
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e
              and e.get("cat") != "Trace"]
    if not events:
        return None
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in events)
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e)
                 for e in events if str(e.get("cat", "")).lower()
                 in ("kernel", "gpu_memcpy", "gpu_memset"))
    merged = []
    for a, b, _ in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps = sorted((b2[0] - b1[1] for b1, b2 in zip(merged, merged[1:])),
                  reverse=True)
    by_name = {}
    for a, b, e in dev:
        name = _kernel_name(e["name"])
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + b - a, c + 1)
    n_kernels = sum(1 for *_, e in dev
                    if str(e.get("cat", "")).lower() == "kernel")
    return dict(window_us=end - start, busy_us=busy, by_name=by_name,
                span_us=merged[-1][1] - merged[0][0] if merged else None,
                kernels_per_trial=n_kernels / n_trials,
                lead_us=merged[0][0] - start if merged else None,
                gaps_us=gaps[:5])


def _kernel_name(name):
    """A demangled kernel name without its argument list, at most 90
    characters."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:90]


def phase_profile(trial, meta, state0, stims, draws, n=3):
    """Where a full-width trial's time goes: ``torch.profiler`` traces
    (CPU and CUDA activities) of eager path-A trials and of replays of the
    same trials captured as a graph. Each runs ``2 n`` trials from
    ``state0``: the profiler's warm-up step takes the first ``n`` (the
    graph's first replays, which upload it and set up the tracing), its
    active step the last ``n``, each from a synchronised start to a
    synchronised end. For each: the device's busy share of the traced
    window and of its own span (first kernel start to last kernel end),
    kernel time by name (top 10), kernels per trial and the longest idle
    gaps between device intervals. A trace with no device time is
    reported on a line of its own, and one eager trial is then split with
    CUDA events instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.core import hybrid as th
    out_dir = REPO / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    stims = list(stims[:n]) * 2
    graph = th.TrialGraph(th.TrialLoop(trial, state0, stims, draws))
    st = state0

    def eager(k):
        nonlocal st
        for i in range(k * n, (k + 1) * n):
            st, _ = trial(st, stims[i], draws.events[i], draws.xi[i])

    def replays(k):
        for _ in range(n):
            graph.replay()
    for label, fn in (("eager", eager), ("graph", replays)):
        path = out_dir / f"trace_{label}.json"
        done = {}

        def ready(p, path=path, done=done):
            p.export_chrome_trace(str(path))
            done["averages"] = p.key_averages()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=ready) as prof:
            for k in range(2):
                torch.cuda.synchronize()
                fn(k)
                torch.cuda.synchronize()
                prof.step()
        dev_us = sum(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0)) or 0
                     for e in done.get("averages", ()))
        summ = _trace_summary(path, n)
        if not dev_us or summ is None or not summ["by_name"]:
            log(f"[3] profiler, {label}: NO DEVICE TIME in the trace "
                f"(key_averages self device total {dev_us}); one eager trial "
                f"split with CUDA events instead")
            split_with_events(trial, meta, state0, stims[0], draws)
            continue
        top = sorted(summ["by_name"].items(), key=lambda kv: -kv[1][0])[:10]
        w, b, span = summ["window_us"], summ["busy_us"], summ["span_us"]
        log(f"[3] profiler, {label}, trials {n}-{2 * n - 1} (stim "
            f"{stims[n:]}; trials 0-{n - 1} in the warm-up step): window "
            f"{w / 1e3:.3f} ms, device busy {b / 1e3:.3f} ms = {b / w:.4f} of "
            f"it (idle {1 - b / w:.4f}); device span {span / 1e3:.3f} ms, "
            f"busy {b / span:.4f} of it; {summ['kernels_per_trial']:.1f} "
            f"kernels a trial; key_averages self device total "
            f"{dev_us / 1e3:.3f} ms")
        log(f"[3] profiler, {label}, kernel ms (count) by name: "
            + "; ".join(f"{k} {t / 1e3:.4f} ({c})" for k, (t, c) in top))
        log(f"[3] profiler, {label}: before the first device interval "
            f"{summ['lead_us'] / 1e3:.3f} ms; longest gaps between device "
            f"intervals (ms): "
            + ", ".join(f"{g / 1e3:.4f}" for g in summ["gaps_us"]))


def split_with_events(trial, meta, state, stim, draws):
    """One eager trial with a CUDA event recorded after each phase's call
    (STP scan, the two synaptic windows, neuron window, correlation
    window; the PPU update to the trial's end): device-timeline ms between
    them."""
    import torch
    from repro_torch.core import correlation, synapse
    from repro_torch.kernels.stp_scan import ops as stp_ops
    marks = [("start", torch.cuda.Event(enable_timing=True))]
    core = meta["core"]
    patched = [(stp_ops, "stp_scan"), (synapse, "synaptic_current_window"),
               (correlation, "window"), (core, "_neuron_window")]
    real = {(m, k): getattr(m, k) for m, k in patched}

    def marking(fn, name):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))
            return out
        return wrapped
    for (m, k), fn in real.items():
        setattr(m, k, marking(fn, k))
    try:
        torch.cuda.synchronize()
        marks[0][1].record()
        trial(state, stim, draws.events[0], draws.xi[0])
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        marks.append(("PPU and rest", end))
        end.synchronize()
    finally:
        for (m, k), fn in real.items():
            if m is core:
                del core._neuron_window
            else:
                setattr(m, k, fn)
    log("[3] one eager trial split with CUDA events (ms on the device "
        "timeline, the phase ending at each mark): " + ", ".join(
            f"{name} {a.elapsed_time(b):.4f}"
            for (_, a), (name, b) in zip(marks, marks[1:])))


def phase_path_b(state, draws, meta):
    """Path B: three full-width windows of ``AnnCore.run``, each followed
    by the fixed-function ``VectorUnit.apply_rstdp`` (one ppu_update
    launch each); the first update rerun on the CPU."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.ppu import VectorUnit

    core, inst, cfg = meta["core"], meta["inst"], meta["cfg"]
    ppu = VectorUnit(cfg, inst)
    gen = torch.Generator(device="cuda").manual_seed(13)
    cs = state.core
    rs = dict(mean_reward=torch.zeros_like(cs.rate_counters))
    addr = torch.zeros(draws.events[0].shape, dtype=torch.int8,
                       device="cuda")
    first = None
    kernels.reset_launches()
    times = []
    for i in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        cs, _ = core.run(cs, draws.events[i], addr)
        reward = (cs.rate_counters > 0).to(torch.float32)
        xi = 0.3 * torch.randn(cs.syn.weights.shape, generator=gen,
                               device="cuda")
        before = cs
        cs, rs_new, elig = ppu.apply_rstdp(cs, rs, reward=reward, eta=4.0,
                                           xi=xi)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        if first is None:
            first = (before, dict(rs), reward, xi, cs, rs_new, elig)
        rs = rs_new
    counts = dict(kernels.LAUNCHES)
    if counts["ppu_update"] != 3 or counts["neuron_scan"] != 3:
        raise AssertionError(f"path B launch counts {counts}")
    for x in _flatten(cs):
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            raise AssertionError("non-finite state after path B")

    before, rs0, reward, xi, s_g, rs_g, elig_g = first
    cpu = torch.device("cpu")
    ppu_c = VectorUnit(cfg, _to(inst, cpu))
    s_c, rs_c, elig_c = ppu_c.apply_rstdp(
        _to(before, cpu), _to(rs0, cpu), reward=reward.cpu(), eta=4.0,
        xi=xi.cpu())
    if not torch.equal(elig_g.cpu(), elig_c):
        raise AssertionError("path B: eligibility differs card vs CPU")
    wq_g = s_g.syn.weights.cpu().to(torch.int32)
    wq_c = s_c.syn.weights.to(torch.int32)
    dq = (wq_g - wq_c).abs()
    if int(dq.max()) > 1:
        raise AssertionError("path B: weight codes differ by > 1")
    if int(dq.max()) == 1:
        mod = (reward - rs0["mean_reward"]).cpu().unsqueeze(-2)
        w_f = before.syn.weights.cpu().float() + 4.0 * mod * elig_c + xi.cpu()
        frac = (w_f - w_f.floor() - 0.5).abs()
        if bool((frac[dq == 1] >= 1e-4).any()):
            raise AssertionError("path B: a code differs away from a .5 tie")
    if not torch.equal(rs_g["mean_reward"].cpu(), rs_c["mean_reward"]):
        raise AssertionError("path B: mean rewards differ card vs CPU")
    log(f"[4] path B, 3 x (AnnCore.run + apply_rstdp) at 16 x 256 x 512: "
        f"ms {', '.join(f'{t:.3f}' for t in times)}; launches={counts}; "
        f"first update CPU vs card: codes differing={int((dq > 0).sum())}, "
        f"eligibility equal")
    return counts


def _flatten(tree):
    import torch
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _flatten(v)
    else:
        for v in tree:
            yield from _flatten(v)


def _run_modes(label, **kw):
    """``run_training`` on the card in its default mode (one captured trial
    graph, replayed) and with ``scan=False`` (eager trials), in turns
    (graph, eager): the histories bit-equal, both times on the host clock
    from a synchronised start to the result on the host. Returns the
    default run's ``(out, meta, seconds)`` and the eager run's launch
    counts."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.hybrid import run_training
    runs = {}
    for name, mode in (("graph", {}), ("eager", dict(scan=False))):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _, meta = run_training(device="cuda", **mode, **kw)
        runs[name] = (out, meta, time.perf_counter() - t0,
                      dict(kernels.LAUNCHES))
    (o_g, meta, s_g, n_g), (o_e, _, s_e, n_e) = runs["graph"], runs["eager"]
    for k in o_e:
        if not np.array_equal(o_g[k], o_e[k]):
            raise AssertionError(f"{label}: {k} differs between the graph "
                                 "and the eager run")
    n = kw["n_trials"]
    log(f"{label} run_training, {n} trials: graph (default) {s_g:.2f} s = "
        f"{1e3 * s_g / n:.3f} ms/trial, eager (scan=False) {s_e:.2f} s = "
        f"{1e3 * s_e / n:.3f} ms/trial, {s_e / s_g:.2f}x; histories bit-equal;"
        f" launches counted by the wrappers: graph "
        f"{ {k: v for k, v in n_g.items() if v} } (warm-up and capture), "
        f"eager { {k: v for k, v in n_e.items() if v} }")
    return o_g, meta, s_g, n_e


def phase_closed_loop():
    """The §5 closed loop at 32 x 16 on the card, held to the tier-3
    criteria of ``tests/test_rstdp.py``: both populations' trailing median
    reward above 0.85, and A-channel weight discrimination (the even
    columns' A-channel weights above 5 and 10 above the odd columns'). The
    default mode (the trial graph) and eager trials agree bit for bit."""
    import numpy as np
    out, meta, secs, _ = _run_modes("[5]", n_trials=450, seed=0)
    even = meta["even"].cpu().numpy() > 0
    ma = meta["mask_a"] > 0
    mr = out["mean_reward"]

    def trailing(sel, n=150):
        return float(np.mean(np.median(mr[-n:, sel], axis=1)))
    te, to = trailing(even), trailing(~even)
    w = out["w_signed_final"]
    w_even = float(w[ma][:, even].mean())
    w_odd = float(w[ma][:, ~even].mean())
    log(f"[5] closed loop 32 x 16, 450 trials, seed 0: trailing <R> even="
        f"{te:.4f} odd={to:.4f} (> 0.85 each); A-channel weights even "
        f"columns {w_even:.3f} (> 5), odd columns {w_odd:.3f} (gap "
        f"{w_even - w_odd:.3f} > 10) ({secs:.1f} s, {1e3 * secs / 450:.2f} "
        f"ms/trial)")
    if not (te > 0.85 and to > 0.85):
        raise AssertionError(f"the closed loop did not learn: {te}, {to}")
    if not (w_even > 5.0 and w_even > w_odd + 10.0):
        raise AssertionError(f"no A-channel weight discrimination: even "
                             f"{w_even}, odd {w_odd}")


def _vm_corpus():
    """The jax-free PPU-VM corpus of ``tests/_torch_ppuvm.py``."""
    sys.path.insert(0, str(REPO / "tests"))
    import _torch_ppuvm
    return _torch_ppuvm


def phase_ppuvm_kernel(ppu_update_ms):
    """ppuvm_exec against its plain version on the card, bit for bit, on
    the fuzz corpus, the edge corpus, a prefixed ragged shape and the main
    path's [16, 256, 512]; timed at the last."""
    import numpy as np
    import torch
    from repro_torch.kernels.ppuvm_exec import ops as vm_ops
    from repro_torch.kernels.ppuvm_exec.ref import run_program_ref
    vmc = _vm_corpus()
    cuda = torch.device("cuda")

    def dev(x):
        return (None if x is None
                else torch.from_numpy(np.ascontiguousarray(x)).to(cuda))

    def both(words, ops, label):
        w = dev(np.asarray(words, np.int32))
        args = tuple(dev(ops.get(k)) for k in ("weights", "qc", "qa",
                                                "rates", "mod", "noise"))
        got = vm_ops.run_program(w, *args)
        want = run_program_ref(w, *args)
        torch.cuda.synchronize()
        for name, a, b in zip(("weights", "registers"), got, want):
            if a.dtype != torch.int32 or not torch.equal(a, b):
                raise AssertionError(f"ppuvm_exec: {name} differ from the "
                                     f"plain version ({label})")
        return w, args

    n = 0
    for seed, words, ops in vmc.corpus():
        both(words, ops, f"corpus seed {seed}")
        n += 1
    for seed in range(3):
        ops = vmc.gen_operands(np.random.RandomState(seed), edge=True)
        for name, words in [("edge", vmc.edge_program()),
                            ("unknown opcodes", vmc.unknown_opcode_program()),
                            *vmc.shipped_programs().items()]:
            both(words, ops, f"{name}, edge operands {seed}")
            n += 1
    rng = np.random.RandomState(11)
    for i in range(4):
        words = vmc.pad(vmc.gen_program(rng))
        ops = vmc.prefixed_operands(rng, (3, 40, 136))
        both(words, ops, f"[3, 40, 136] program {i}")
        both(words, dict(ops, mod=None, noise=None),
             f"[3, 40, 136] program {i}, no mod or noise")
        n += 2
    # programs longer than the words the kernel decodes at once: run a
    # chunk of MAX_WORDS words at a time on every tile
    base = np.concatenate([vmc.gen_program(np.random.RandomState(s))
                           for s in range(1500)])
    for n_words in (vm_ops.MAX_WORDS + 1, 3 * vm_ops.MAX_WORDS + 5):
        both(np.resize(base, n_words).astype(np.int32),
             vmc.prefixed_operands(rng, (3, 40, 136)),
             f"{n_words} words at [3, 40, 136]")
        n += 1
    log(f"[6] ppuvm_exec: {n} programs (200-seed fuzz corpus at 8 x 8, edge "
        f"corpus, unknown opcodes, [3, 40, 136] ragged, {vm_ops.MAX_WORDS + 1}"
        f" and {3 * vm_ops.MAX_WORDS + 5} words: longer than the "
        f"{vm_ops.MAX_WORDS} decoded at once) bit-equal to the plain "
        f"version, weights and registers")

    N, R, C = 16, 256, 512
    ops = vmc.prefixed_operands(rng, (N, R, C))
    # the synapse store's weights are int8 on both callers; the kernel
    # reads them as they are
    ops["weights"] = ops["weights"].astype(np.int8)
    lanes = N * R * C
    rows = {}
    # signed_dw as path C runs it (2 modulator slots, no noise plane);
    # rstdp as apply_rstdp_program runs it (1 slot, a noise plane)
    for name, o in (("signed_dw", dict(ops, noise=None)),
                    ("rstdp", dict(ops, mod=ops["mod"][:1]))):
        words = vmc.shipped_programs()[name]
        w, args = both(words, o, f"{name} at [16, 256, 512]")
        n_planes = 2 + (o["noise"] is not None)        # int32 planes in
        n_mod = o["mod"].shape[0]
        work = vm_ops.work(N, R, C, len(words), n_planes, n_mod, 1)
        n_bytes = work.bytes
        b_ms, b_by = bound_ms(n_bytes, work.flops)
        rows[name] = _row(
            "ppuvm_exec", work, lambda: vm_ops.run_program(w, *args),
            max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            ms=time_ms(lambda: vm_ops.run_program(w, *args), 25),
            plain_ms=time_ms(lambda: run_program_ref(w, *args), 5),
            n_bytes=n_bytes, n_words=len(words))
        r = rows[name]
        # the same program on int32 weights, for comparison with int8
        args32 = (args[0].to(torch.int32), *args[1:])
        ms32 = time_ms(lambda: vm_ops.run_program(w, *args32), 25)
        log(f"[6] ppuvm_exec {name}_program ({r['n_words']} words) at "
            f"[16, 256, 512], int8 weights: kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({b_by}, {n_bytes / 1e6:.1f} MB), {r['ms'] / b_ms:.2f}x the "
            f"bound, bit-equal; int32 weights {ms32:.4f} ms; yardstick "
            f"ppu_update (fixed-function R-STDP, phase 2) "
            f"{ppu_update_ms:.4f} ms")
    return rows["signed_dw"]


def phase_path_c(trial_ms_a):
    """Path C: the full-width §5 slice with the vm rule, 3 trials."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core import synapse
    from repro_torch.core.ppu import VectorUnit
    from repro_torch.ppuvm import programs

    init, trial, meta, kw = _full_width(rule_impl="vm")
    stims = [1, 2, 0]
    draws = meta["draw"](torch.Generator().manual_seed(12), stims)
    state0 = init()
    routes_dev = synapse.route_counts("cuda")
    synapse.reset_route_counts()
    snaps = [routes_dev.clone()]
    kernels.reset_launches()
    times, states, metrics = [], [], []
    state = state0
    for i, stim in enumerate(stims):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = trial(state, stim, draws.events[i], draws.xi[i])
        b.record()
        snaps.append(routes_dev.clone())
        b.synchronize()
        times.append(a.elapsed_time(b))
        states.append(state)
        metrics.append(m)
    counts = dict(kernels.LAUNCHES)
    want = {"synray": 6, "synray_sparse": 6, "census": 0, "neuron_scan": 3,
            "corr": 3, "ppu_update": 0, "ppuvm_exec": 3, "stp_scan": 3}
    if counts != want:
        raise AssertionError(f"path C launch counts {counts}, expected "
                             f"{want}")
    routes = _device_routes(snaps, len(stims))
    if routes != ["dense", "dense", "sparse"]:
        raise AssertionError(f"path C routes {routes}")
    graph_vs_eager(trial, state0, stims, draws, states[-1], metrics,
                   snaps[-1].tolist(), counts, "[7]")
    for x in _flatten(state):
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            raise AssertionError("non-finite state after path C")
    log(f"[7] path C (vm rule) full width 16 x 256 x 512, T=128: trial ms "
        f"{', '.join(f'{t:.3f}' for t in times)} (stim 1, 2, 0; path A "
        f"median {trial_ms_a:.3f}) launches={counts}")

    cols, differing = check_against_cpu(
        meta, kw, state0, stims[0], draws.events[0], draws.xi[0], states[0],
        metrics[0], routes[0], "path C trial 0", phase=7)
    if cols == 0 and differing:
        raise AssertionError(f"path C: {differing} weight codes differ "
                             "between the card and the CPU")
    # the trial's VM update again, on the card and on the CPU, from the
    # card's window state: registers (dw = r0 of the exc rows) bit for bit
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    ecfg = meta["ecfg"]
    words = torch.as_tensor(programs.signed_dw_program(
        eta=ecfg.eta, eta_homeo=ecfg.eta_homeo,
        fire_thresh=ecfg.fire_thresh), device=cuda)
    addr = torch.zeros(draws.events[0].shape, dtype=torch.int8, device=cuda)
    cs_g, _ = meta["core"].run(state0.core, draws.events[0], addr)
    r = metrics[0]["reward"]
    mod = torch.stack([r - state0.mean_reward, r])
    _, regs_g = meta["ppu"].run_program(cs_g, words, mod=mod)
    ppu_c = VectorUnit(meta["cfg"], _to(meta["inst"], cpu))
    _, regs_c = ppu_c.run_program(_to(cs_g, cpu), words.cpu(),
                                  mod=mod.cpu())
    if not torch.equal(regs_g.cpu(), regs_c):
        raise AssertionError("path C: the VM registers differ card vs CPU")
    dw = regs_c[0][..., 0::2, :].to(torch.float32) / 256
    # the python rule on the same first trial
    s_py, _ = _full_width()[1](state0, stims[0], draws.events[0],
                               draws.xi[0])
    gap = float((states[0].w_signed - s_py.w_signed).abs().max())
    if not gap < 0.15:
        raise AssertionError(f"path C: vm and python rules differ by {gap}")
    log(f"[7] path C trial 0: VM registers card == CPU bit for bit (dw in "
        f"[{float(dw.min()):.4f}, {float(dw.max()):.4f}], "
        f"{int((dw != 0).sum())} of {dw.numel()} non-zero); vm vs python "
        f"rule max |w_signed diff|={gap:.4f} (< 0.15)")
    text = _interleaved({"vm": trial, "python": _full_width()[1]}, state0,
                        stims[0], draws.events[0], draws.xi[0], 6)
    log(f"[7] trial 0, rules interleaved (6 pairs): vm {text['vm']}, "
        f"python {text['python']}")
    return counts


def phase_rstdp_program(state, draws, meta):
    """apply_rstdp_program (ppuvm_exec) against apply_rstdp (ppu_update)
    on one full-width window's observables, the same injected xi."""
    import torch
    from repro_torch.core.ppu import VectorUnit
    from repro_torch.ppuvm import programs
    cuda = torch.device("cuda")
    ppu = VectorUnit(meta["cfg"], meta["inst"])
    addr = torch.zeros(draws.events[0].shape, dtype=torch.int8, device=cuda)
    cs, _ = meta["core"].run(state.core, draws.events[0], addr)
    reward = (cs.rate_counters > 0).to(torch.float32)
    rs = dict(mean_reward=0.5 * torch.ones_like(cs.rate_counters))
    gen = torch.Generator(device="cuda").manual_seed(14)
    xi = 0.3 * torch.randn(cs.syn.weights.shape, generator=gen, device=cuda)
    words = torch.as_tensor(programs.rstdp_program(eta=0.5), device=cuda)

    def fixed():
        return ppu.apply_rstdp(cs, dict(rs), reward=reward, eta=0.5, xi=xi)

    def vm():
        return ppu.apply_rstdp_program(cs, dict(rs), reward=reward,
                                       program=words, xi=xi)
    s_f, rs_f, _ = fixed()
    s_v, rs_v, _ = vm()
    dq = (s_f.syn.weights.to(torch.int32)
          - s_v.syn.weights.to(torch.int32)).abs()
    if int(dq.max()) > 1:
        raise AssertionError(f"apply_rstdp_program differs from apply_rstdp "
                             f"by {int(dq.max())} codes")
    if not torch.equal(rs_f["mean_reward"], rs_v["mean_reward"]):
        raise AssertionError("apply_rstdp_program: mean rewards differ")
    t_f, t_v = time_ms(fixed, 25), time_ms(vm, 25)
    log(f"[8] apply_rstdp_program vs apply_rstdp at 16 x 256 x 512, one xi: "
        f"{int((dq > 0).sum())} of {dq.numel()} codes differ by one, none "
        f"by more; ms vm {t_v:.4f} fixed {t_f:.4f} (ratio {t_v / t_f:.2f})")


def phase_vm_loop():
    """60 trials of the vm rule at 32 x 16, T = 128, on the card, as graph
    replays (the default) and as eager trials, bit-equal."""
    import numpy as np
    from repro_torch.core.hybrid import RSTDPConfig
    out, _, secs, n_e = _run_modes("[9]", n_trials=60,
                                   ecfg=RSTDPConfig(trial_steps=128), seed=0,
                                   rule_impl="vm")
    n = n_e["ppuvm_exec"]
    mr = np.median(out["mean_reward"], axis=1)
    first, last = float(mr[:15].mean()), float(mr[-15:].mean())
    log(f"[9] vm-rule closed loop 32 x 16, T=128, 60 trials, seed 0: median "
        f"<R> first 15 {first:.4f} -> last 15 {last:.4f}; {n} ppuvm_exec "
        f"launches ({secs:.1f} s)")
    if n != 60 or not np.isfinite(out["w_signed_final"]).all():
        raise AssertionError(f"vm loop: {n} launches or non-finite weights")
    if not last > first:
        raise AssertionError("the vm-rule closed loop did not learn")


def phase_playback():
    """The three golden playback programs through FastBackend on cuda."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.verif import playback as pb
    vmc = _vm_corpus()
    for rule in sorted(vmc.GOLDEN_RULES):
        golden = vmc.load_trace(rule)
        kernels.reset_launches()
        tr = pb.execute(vmc.canonical_program(rule), "fast",
                        vmc.golden_cfg(), device="cuda")
        n = kernels.LAUNCHES["ppuvm_exec"]
        errs = pb.compare_traces(tr, golden, atol=0.05)
        if errs or n != 2:
            raise AssertionError(f"playback {rule}: {n} launches; "
                                 + "; ".join(errs))
        for (tg, kg, vg), (_, _, v) in zip(golden, tr):
            if kg in ("PPU_W", "WEIGHTS") and not np.array_equal(
                    v.astype(np.int32), vg.astype(np.int32)):
                raise AssertionError(f"playback {rule}: {kg}@{tg} differs "
                                     "from the golden trace")
        dmax = max(float(np.abs(np.asarray(v, np.float64)
                                - np.asarray(vg, np.float64)).max())
                   for (_, _, v), (_, _, vg) in zip(tr, golden))
        log(f"[10] playback {rule} on the card: {len(tr)} records match the "
            f"golden trace (max |diff| {dmax:.3g}), PPU_W and WEIGHTS "
            f"bit-equal, {n} ppuvm_exec launches")


def _eager_trials(trial, state0, stims, draws):
    """The trials eagerly from ``state0``: per trial the state and metrics,
    the launches the wrappers counted and the device's route counts after
    the run (read once, at the end)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import synapse
    routes = synapse.route_counts("cuda")
    synapse.reset_route_counts()
    kernels.reset_launches()
    states, metrics, st = [], [], state0
    for i, stim in enumerate(stims):
        st, m = trial(st, stim, draws.events[i], draws.xi[i])
        states.append(st)
        metrics.append(m)
    torch.cuda.synchronize()
    return states, metrics, dict(kernels.LAUNCHES), routes.tolist()


def _replayed(trial, state0, stims, draws):
    """The trials as replays of one captured ``TrialGraph``."""
    import torch
    from repro_torch.core import hybrid as th
    graph = th.TrialGraph(th.TrialLoop(trial, state0, stims, draws))
    for _ in stims:
        graph.replay()
    torch.cuda.synchronize()
    return graph


def _same_run(a, b, what, tag="[11]"):
    """Two graphs' (or a graph's and eager trials') histories and final
    states bit for bit."""
    import torch
    from repro_torch.core import hybrid as th
    (ha, sa), (hb, sb) = a, b
    for k in hb:
        if not torch.equal(ha[k], hb[k]):
            raise AssertionError(f"{tag} {what}: {k} differs")
    la, lb = th._leaves(sa), th._leaves(sb)
    if len(la) != len(lb) or not all(torch.equal(x, y)
                                     for x, y in zip(la, lb)):
        raise AssertionError(f"{tag} {what}: the final states differ")


def _covered(fp, bl):
    """The sites of ``fp`` that the blacklist ``bl`` covers (on a
    blacklisted row or column): what its reduction masks exactly."""
    import dataclasses
    import numpy as np
    from repro_torch.faults import FaultPlan
    cov = bl.rows[..., :, None] | bl.neurons[..., None, :]

    def keep(m, where):
        return None if m is None else m & where
    sw = keep(fp.stuck_w_mask, cov)
    cm = keep(fp.cadc_stuck_mask, bl.neurons)
    return dataclasses.replace(
        fp, dead_rows=keep(fp.dead_rows, bl.rows),
        hot_neurons=keep(fp.hot_neurons, bl.neurons),
        dead_neurons=keep(fp.dead_neurons, bl.neurons),
        stuck_w_mask=sw, stuck_w_val=fp.stuck_w_val if sw is not None
        else None, cadc_stuck_mask=cm,
        cadc_stuck_code=fp.cadc_stuck_code if cm is not None else None,
        store_flip=None if fp.store_flip is None
        else np.where(cov, fp.store_flip, 0))


def phase_path_d(counts_a, graph_a):
    """Path D, the verification layer on path A's full-width chip:
    Monte-Carlo STP calibration, the §5 loop on a faulted chip with
    telemetry (eager and as graph replays), screening, and the loop under
    the screened blacklist; then the off path against phase 3."""
    import numpy as np
    import torch
    from repro_torch.core import hybrid as th
    from repro_torch.faults import (cadc_zero_code, chain,
                                    sample_fault_plan, screen)
    from repro_torch.obs import trace as obs_trace
    from repro_torch.verif.calibration import calibrate_stp
    cpu = torch.device("cpu")
    _, _, meta0, kw = _full_width()
    cfg = meta0["cfg"]
    inst = meta0["inst"]

    # 1. calibration of the 16 x 256 driver offsets
    off = inst["stp_offset"]
    calibrate_stp(cfg, off)                        # warm-up
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    codes, m = calibrate_stp(cfg, off)
    b.record()
    b.synchronize()
    cal_ms = a.elapsed_time(b)
    codes_c, _ = calibrate_stp(cfg, off.cpu())
    if not torch.equal(codes.cpu(), codes_c):
        raise AssertionError("[11] calibration codes differ card vs CPU")
    sb, sa = float(m["std_before"]), float(m["std_after"])
    if not sa < 0.4 * sb:
        raise AssertionError(f"[11] calibration: std {sb} -> {sa}")
    log(f"[11] calibration of {off.shape[0]} x {off.shape[1]} STP drivers: "
        f"offset std {sb:.4f} -> {sa:.4f} ({sa / sb:.3f} of it, < 0.4), "
        f"max |after| {float(m['max_abs_after']):.4f}; {cal_ms:.3f} ms "
        f"(4 rounds of the 5-spike testbench); codes equal to the CPU's")
    inst_cal = dict(inst, stp_calib=codes)

    def experiment(**extra):
        return th.make_experiment(inst=inst_cal, device="cuda", **kw,
                                  **extra)

    # 2. the faulted loop with telemetry, eager and as graph replays
    fp = sample_fault_plan(256, 512, np.random.default_rng(3), prefix=(16,),
                           p_dead_row=0.02, p_dead_neuron=0.01,
                           p_hot_neuron=0.01, p_stuck_w=0.001, p_cadc=0.02,
                           seed=1)
    stims = [1, 2, 0, 1, 2, 0]
    init, trial, meta = experiment(telemetry=True, faults=fp)
    draws = meta["draw"](torch.Generator().manual_seed(12), stims)
    state0 = init()
    states, metrics, n_e, routes_e = _eager_trials(trial, state0, stims,
                                                   draws)
    tele = obs_trace.summary(states[-1].tele)
    g_on = _replayed(trial, state0, stims, draws)
    hist_e = {k: torch.stack([mm[k] for mm in metrics]) for k in metrics[0]}
    _same_run((g_on.loop.history(), g_on.loop.state), (hist_e, states[-1]),
              "faulted loop, graph vs eager")
    if obs_trace.summary(g_on.loop.state.tele) != tele:
        raise AssertionError("[11] graph and eager counters differ")
    init_off, trial_off, _ = experiment(faults=fp)
    g_off = _replayed(trial_off, init_off(), stims, draws)
    _same_run((g_on.loop.history(), g_on.loop.state._replace(tele=None)),
              (g_off.loop.history(), g_off.loop.state),
              "faulted loop, telemetry on vs off")
    if tele["faults_injected"] != fp.total_sites:
        raise AssertionError(f"[11] faults_injected {tele['faults_injected']}"
                             f", plan {fp.total_sites}")
    if [tele["dense_windows"], tele["sparse_windows"]] != routes_e:
        raise AssertionError(f"[11] route counters {tele} vs route_counts "
                             f"{routes_e}")
    if tele["trials"] != 6 or tele["gated_windows"] != 12:
        raise AssertionError(f"[11] counters {tele}")
    init_clean, trial_clean, _ = experiment()
    g_clean = _replayed(trial_clean, init_clean(), stims, draws)
    times = {"clean": [], "faults": [], "faults+telemetry": []}
    graphs = {"clean": g_clean, "faults": g_off, "faults+telemetry": g_on}
    for i in range(12):
        order = list(graphs) if i % 2 == 0 else list(graphs)[::-1]
        for k in order:
            graphs[k].loop.reset()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            graphs[k].replay()
            e1.record()
            e1.synchronize()
            times[k].append(e0.elapsed_time(e1))
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"[11] faulted loop ({fp.total_sites} sites: "
        f"{ {k: v for k, v in fp.summary().items() if k != 'is_blacklist'} }"
        f"), 6 trials eager and as graph replays: bit-equal; telemetry on "
        f"vs off bit-equal; launches eager {n_e}, a replay "
        f"{g_on.launches}; routes {routes_e}")
    log(f"[11] counters: {json.dumps(tele)}")
    log(f"[11] replay ms (trial 0, 12 in turns, median): clean "
        f"{med['clean']:.4f}, faults {med['faults']:.4f}, faults + "
        f"telemetry {med['faults+telemetry']:.4f}; telemetry costs "
        f"{med['faults+telemetry'] - med['faults']:.4f} ms a replay, the "
        f"fault hooks {med['faults'] - med['clean']:.4f}; graph pools "
        f"{g_clean.pool_bytes / 2**20:.1f} / {g_off.pool_bytes / 2**20:.1f} "
        f"/ {g_on.pool_bytes / 2**20:.1f} MiB")

    # 3. screening, on the card and on the CPU
    a.record()
    bl = screen(meta["core"], meta["ppu"])
    b.record()
    b.synchronize()
    screen_ms = a.elapsed_time(b)
    _, _, meta_c = th.make_experiment(inst=_to(inst_cal, cpu), device="cpu",
                                      faults=fp, **kw)
    bl_c = screen(meta_c["core"], meta_c["ppu"])
    if not (np.array_equal(bl.rows, bl_c.rows)
            and np.array_equal(bl.neurons, bl_c.neurons)):
        raise AssertionError("[11] screening differs card vs CPU")
    base = cadc_zero_code(inst)
    visible = fp.cadc_stuck_mask & (np.abs(fp.cadc_stuck_code - base) > 2)
    planted = fp.hot_neurons | fp.dead_neurons | visible
    if not np.array_equal(bl.rows, fp.dead_rows) or (
            planted & ~bl.neurons).any():
        raise AssertionError("[11] screening missed planted sites")
    extra = int((bl.neurons & ~(planted | fp.cadc_stuck_mask)).sum())
    log(f"[11] screen on the card ({screen_ms:.1f} ms, two 64-step probes "
        f"+ CADC reads): {bl.n_rows} rows ({fp.n_dead_rows} planted dead), "
        f"{bl.n_neurons} neurons (hot {int(fp.hot_neurons.sum())}, dead "
        f"{int(fp.dead_neurons.sum())}, CADC columns "
        f"{int(fp.cadc_stuck_mask.sum())} of which "
        f"{int((fp.cadc_stuck_mask & ~visible).sum())} stuck within 2 codes "
        f"of their zero baseline, which no probe tells from a healthy one; "
        f"{extra} flagged beyond the plan); equal to the CPU's screen")

    # 4. the loop under the blacklist, as graph replays
    init_b, trial_b, _ = experiment(telemetry=True, faults=fp,
                                         blacklist=bl)
    g_b = _replayed(trial_b, init_b(), stims, draws)
    tb = obs_trace.summary(g_b.loop.state.tele)
    red = bl.as_faults(inst, cfg.cadc_bits)
    if (tb["faults_detected"], tb["blacklisted_rows"]) != (
            red.total_sites, bl.n_rows) or \
            tb["faults_injected"] != fp.total_sites:
        raise AssertionError(f"[11] blacklist gauges {tb}")
    cov = _covered(fp, bl)
    init_r, trial_r, _ = experiment(faults=chain(cov, red))
    init_x, trial_x, _ = experiment(faults=red)
    g_r = _replayed(trial_r, init_r(), stims, draws)
    g_x = _replayed(trial_x, init_x(), stims, draws)
    # the membranes of blacklisted columns integrate their (stuck-cell)
    # currents unmasked, as on the chip; everything else is exact
    s_r, s_x = g_r.loop.state, g_x.loop.state
    _same_run((g_r.loop.history(), s_r._replace(core=s_r.core._replace(
        neuron=None))), (g_x.loop.history(), s_x._replace(
            core=s_x.core._replace(neuron=None))),
        "covered faults under the blacklist vs the clean reduced network")
    healthy = ~torch.as_tensor(bl.neurons, device="cuda")
    if not all(torch.equal(x[healthy], y[healthy]) for x, y in zip(
            s_r.core.neuron, s_x.core.neuron)):
        raise AssertionError("[11] blacklisted loop: a healthy column's "
                             "membrane differs from the reduced network's")
    log(f"[11] blacklisted loop, 6 graph replays: faults_detected="
        f"{tb['faults_detected']} blacklisted_rows={tb['blacklisted_rows']} "
        f"(the reduction's sites and rows); the plan's {cov.total_sites} "
        f"covered sites under the blacklist == the clean reduced network "
        f"bit for bit (histories, synapses, sensors, STP, healthy columns' "
        f"membranes; {fp.total_sites - cov.total_sites} sites outside it:"
        f" stuck cells and unseen CADC columns, which no probe looks for)")

    # 5. the off path: path A's trial unchanged
    init_0, trial_0, _, _ = _full_width()
    _, _, n_0, _ = _eager_trials(trial_0, init_0(), stims, draws)
    g_0 = _replayed(trial_0, init_0(), stims, draws)
    if n_0 != counts_a or g_0.launches != graph_a["launches"]:
        raise AssertionError(f"[11] off path: launches {n_0} / "
                             f"{g_0.launches}, phase 3 {counts_a} / "
                             f"{graph_a['launches']}")
    log(f"[11] off path (faults=None, telemetry=False): launches of 6 eager "
        f"trials and of a replay equal to phase 3's; graph pool "
        f"{g_0.pool_bytes / 2**20:.1f} MiB (phase 3: "
        f"{graph_a['pool_bytes'] / 2**20:.1f} MiB)")


# path E: the wafer (phase 12)
WAFER_LINK_COUNTERS = ("routed_events", "link_overflows", "link_events_max",
                       "link_reroutes")
# kernels path E launches (the STP scan with both halves' censuses, the
# gate's two route kernels, the neuron and correlation windows); the
# census kernel launches on none of the emulation's windows
PATH_E_KERNELS = ("synray", "synray_sparse", "neuron_scan", "corr",
                  "stp_scan")


def _wafer_experiment(K=4, inst=None, **extra):
    """Path E's experiment: the §5 network of 128 inputs x 2048 neurons on
    K chips of 256 rows x 2048 / K columns (K = 4: four full 256 x 512
    chips), T = 128, all2all with the relay broadcast, the router's
    default budget and ``link_mode="auto"``, ``backend="blocked"``, the
    census gate at its default; the whole network's instance from seed 21
    unless ``inst`` is given. Returns ``(init, trial, meta, kw, inst)``."""
    import dataclasses
    import torch
    from repro_torch.configs.bss2 import BSS2
    from repro_torch.core.hybrid import RSTDPConfig, make_experiment
    from repro_torch.verif.mismatch import sample_instance
    ecfg = RSTDPConfig(n_inputs=128, n_neurons=2048, pattern_size=24,
                       trial_steps=128)
    cfg = dataclasses.replace(BSS2, n_cols=2048)
    if inst is None:
        inst = sample_instance(cfg, torch.Generator().manual_seed(21),
                               device="cuda")
    kw = dict(cfg=cfg, ecfg=ecfg, backend="blocked", wafer=K,
              wafer_topology="all2all", wafer_relay=True, **extra)
    init, trial, meta = make_experiment(inst=inst, device="cuda", **kw)
    return init, trial, meta, kw, inst


def _links(tele):
    from repro_torch.obs import trace as obs_trace
    s = obs_trace.summary(tele)
    return {k: s[k] for k in WAFER_LINK_COUNTERS}


def _traced(fn, name, n_trials):
    """``torch.profiler`` trace (CPU and CUDA) of ``fn`` run twice, the
    first in the warm-up step; the summary of the second
    (``_trace_summary``), the trace kept in ``build/profile/``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    out_dir = REPO / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"trace_{name}.json"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))
                 ) as prof:
        for _ in range(2):
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            prof.step()
    return _trace_summary(path, n_trials)


def _wafer_router_windows():
    """Path E, part 1: the router alone at full width. ``run_windows`` of
    W = 4 windows on four 256 x 512 chips (``backend="blocked"``, the
    general address form: routed slots carry address 7) under a random
    ring and a random all2all plan of 512 routes a link into relay rows
    that conduct (address 7): dense, compact and auto, auto bit-equal to
    dense, compact with a small budget dropping records and counting
    overflows. Each window again on the CPU from the card's state and
    routed input: spikes equal up to flips at threshold, and the CPU's
    router fed the card's spikes gives the card's delivered grid and link
    counters bit for bit. ``route()`` timed per mode."""
    import numpy as np
    import torch
    from repro_torch.configs.bss2 import BSS2
    from repro_torch.core.anncore import AnnCore
    from repro_torch.obs import trace as obs_trace
    from repro_torch.verif.mismatch import sample_instance
    from repro_torch.wafer import (InterChipRouter, WaferTopology, make_plan,
                                   run_windows)
    cpu = torch.device("cpu")
    K, R, C, T, W, PER_LINK = 4, 256, 512, 128, 4, 512
    rng = np.random.default_rng(5)
    inst = sample_instance(BSS2, torch.Generator().manual_seed(22), (K,),
                           device="cuda")
    core_g = AnnCore(BSS2, inst, backend="blocked")
    core_c = AnnCore(BSS2, _to(inst, cpu), backend="fused")
    p = inst["neuron_params"]
    thr = (p["v_thres"] + 2.0 * p["delta_t"]).cpu()
    ev_c = torch.from_numpy((rng.random((W, T, K, R)) < 0.05).astype(
        np.float32))
    ad_c = torch.zeros((W, T, K, R), dtype=torch.int8)
    ev_g, ad_g = ev_c.cuda(), ad_c.cuda()
    timing = {}
    for kind in ("ring", "all2all"):
        # routes land on the upper half of the rows: the lower half keeps
        # conducting the external events (address 0)
        routes = [(s, int(rng.integers(C)), d, int(rng.integers(R // 2, R)),
                   7) for s in range(K)
                  for d in ([(s + 1) % K] if kind == "ring" else range(K))
                  for _ in range(PER_LINK)]
        plan = make_plan(WaferTopology(K, kind), R, C, routes)
        w = torch.from_numpy(rng.integers(20, 60, (K, R, C)).astype(np.int8))
        a = torch.zeros((K, R, C), dtype=torch.int8)
        a[torch.from_numpy(plan.relay_rows())] = 7
        st0 = core_g.init_state((K,))
        st0 = st0._replace(syn=st0.syn._replace(weights=w.cuda(),
                                                addresses=a.cuda()))
        outs = {}
        for label, kw in (("dense", dict(link_mode="dense")),
                          ("compact", dict(link_mode="compact")),
                          ("auto", dict(link_mode="auto")),
                          ("compact, budget 64", dict(link_mode="compact",
                                                      link_budget=64))):
            r = InterChipRouter(plan, device="cuda", **kw)
            _, out = run_windows(core_g, r, st0, ev_g, ad_g,
                                 telemetry=obs_trace.init_telemetry("cuda"))
            outs[label] = (out["spikes"], _links(out["telemetry"]), r)
        spk_d, cnt_d, r_dense = outs["dense"]
        if not torch.equal(outs["auto"][0], spk_d) or outs["auto"][1] != \
                cnt_d:
            raise AssertionError(f"[12] {kind}: auto differs from dense")
        if not float(spk_d.sum()) > 0 or not cnt_d["routed_events"] > 0:
            raise AssertionError(f"[12] {kind}: no spikes or no traffic")
        spk_s, cnt_s, r_small = outs["compact, budget 64"]
        sp = spk_d[-1]
        dropped = float(r_dense.route(sp)[0].sum() - r_small.route(sp)[0]
                        .sum())
        if not (cnt_s["link_overflows"] > 0 and dropped > 0):
            raise AssertionError(f"[12] {kind}: compact over budget dropped "
                                 f"{dropped} events, counters {cnt_s}")
        log(f"[12] router alone, {kind}, {plan.n_routes} routes ({PER_LINK} a "
            f"link), W={W} windows of 4 x 256 x 512, T={T}: "
            + "; ".join(f"{k} spikes {float(v[0].sum()):.0f} {v[1]}"
                        for k, v in outs.items())
            + f"; auto == dense bit for bit; compact at budget 64 drops "
            f"{dropped:.0f} of the last window's deliveries")

        # each window on the CPU from the card's state and routed input
        r_g = InterChipRouter(plan, device="cuda")
        r_c = InterChipRouter(plan, device="cpu")
        st_g, routed_g = st0, r_g.init_buffer(T)
        flips = spikes = 0
        for i in range(W):
            st_c, routed_c = _to(st_g, cpu), routed_g.cpu()
            st_g, out_g = core_g.run_routed(
                st_g, routed_g, ev_g[i], ad_g[i], r_g, record_v=True,
                telemetry=obs_trace.init_telemetry("cuda"))
            _, out_c = core_c.run_routed(st_c, routed_c, ev_c[i], ad_c[i],
                                         r_c, record_v=True)
            spk_g, spk_c = out_g["spikes"].cpu(), out_c["spikes"]
            v_quiet = torch.where(spk_c == 0, out_c["v"], out_g["v"].cpu())
            near = (v_quiet - thr).abs() <= 1e-4 + 1e-4 * thr.abs()
            flip = spk_g != spk_c
            if bool((flip & ~near).any()):
                raise AssertionError(f"[12] {kind} window {i}: a spike "
                                     "differs card vs CPU away from "
                                     "threshold")
            flips += int(flip.sum())
            spikes += int(spk_c.sum())
            g_c, t_c = r_c.route(spk_g, obs_trace.init_telemetry("cpu"),
                                 routed_in=routed_c)
            if not torch.equal(g_c, out_g["routed"].cpu()) or \
                    _links(t_c) != _links(out_g["telemetry"]):
                raise AssertionError(f"[12] {kind} window {i}: the router "
                                     "differs card vs CPU")
            routed_g = out_g["routed"]
        log(f"[12] router alone, {kind}, card vs CPU window by window: "
            f"{flips} of {spikes} spikes flipped at threshold, delivered "
            f"grids and link counters bit for bit")

        # route() alone per mode on the last window's spikes
        row = {}
        for mode in ("dense", "compact", "auto"):
            r = InterChipRouter(plan, device="cuda", link_mode=mode)
            ms = time_ms(lambda: r.route(sp), 25)
            n = _links(r.route(sp, obs_trace.init_telemetry("cuda"))[1]
                       )["routed_events"]
            row[mode] = dict(ms=ms, routed_events=n,
                             events_per_s=n / (ms * 1e-3))
        timing[kind] = row
        log(f"[12] route() alone, {kind}, [128, 4, 512] spikes: "
            + "; ".join(f"{m} {v['ms']:.4f} ms ({v['routed_events']} events,"
                        f" {v['events_per_s'] / 1e6:.1f} M events/s)"
                        for m, v in row.items()))
    return timing


def _wafer_chip_count_parity():
    """``run_training`` of path E's network on K = 1 (one 256 x 2048
    chip), 2 and 4 chips, 6 trials each as graph replays: the global
    signed weights and the rewards bit for bit, and every chip's last
    routed grid equal to K = 1's (the relay broadcast reaches every chip
    alike). The link census (``routed_events``) counts each link's
    (step, row) slots before the receiver merges them: it is K times
    K = 1's only while no two columns of a chip share a relay row (the
    reference's 32 x 16 case); here 2048 / K columns share 256 rows, so
    it is printed, not held to K times."""
    import numpy as np
    import torch
    from repro_torch.core.hybrid import run_training
    outs = {}
    for K in (1, 2, 4):
        _, _, _, kw, _ = _wafer_experiment(K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, state, _ = run_training(n_trials=6, seed=21, device="cuda",
                                     telemetry=True, **kw)
        outs[K] = (out, state.routed.cpu(), time.perf_counter() - t0)

    def glob(w):
        return w.transpose(1, 0, 2).reshape(w.shape[1], -1)
    (o1, routed1, _) = outs[1]
    if not float(routed1.sum()) > 0:
        raise AssertionError("[12] chip-count parity: no routed events")
    for K in (2, 4):
        o, routed, _ = outs[K]
        if not np.array_equal(glob(o1["w_signed_final"]),
                              glob(o["w_signed_final"])):
            raise AssertionError(f"[12] chip-count parity: w_signed K=1 vs "
                                 f"K={K}")
        if not np.array_equal(o1["reward"].reshape(6, -1),
                              o["reward"].reshape(6, -1)):
            raise AssertionError(f"[12] chip-count parity: rewards K=1 vs "
                                 f"K={K}")
        if not all(torch.equal(routed[:, k], routed1[:, 0])
                   for k in range(K)):
            raise AssertionError(f"[12] chip-count parity: routed grids "
                                 f"K=1 vs K={K}")
    log("[12] chip-count parity, run_training of 6 trials as graph replays "
        "(capture included): "
        + ", ".join(f"K={K} {outs[K][2]:.2f} s, routed_events "
                    f"{outs[K][0]['telemetry']['routed_events']}"
                    for K in (1, 2, 4))
        + "; global w_signed, rewards and every chip's routed grid bit for "
        "bit equal to K=1's")


def _wafer_link_faults(inst, stims, draws):
    """Path E, part 3: one dead link (0, 2) and one flaky link (1, 3)
    dropping 0.25 of its events. ``screen`` with the router on the card
    finds exactly those two links, equal to the CPU's verdict. Path E's
    relay plan has no failover (all 256 rows of every chip take relayed
    events, so no row is free for a detour: ``reroute_plan`` raises, as
    the reference's does); the blacklisted run takes a plan that
    announces each chip's first 32 columns to every chip on rows of their
    own, which reroutes over forwards: 6 trials eager and as graph
    replays bit-equal, the forwarded events counted in ``link_reroutes``,
    and a dead link's deliveries arriving over the forwards one window
    late."""
    import numpy as np
    import torch
    from repro_torch.core.hybrid import make_experiment
    from repro_torch.faults import FaultPlan, screen
    from repro_torch.obs import trace as obs_trace
    from repro_torch.wafer import (InterChipRouter, WaferTopology, make_plan,
                                   reroute_plan)
    cpu = torch.device("cpu")
    links = WaferTopology(4, "all2all").links()
    fp = FaultPlan(dead_links=np.array([sd == (0, 2) for sd in links]),
                   flaky_links=np.where([sd == (1, 3) for sd in links],
                                        np.float32(0.25), np.float32(0.0)),
                   seed=5)
    _, _, meta, kw, _ = _wafer_experiment(inst=inst, faults=fp)
    screen(meta["core"], meta["ppu"], meta["router"])          # warm-up
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    bl = screen(meta["core"], meta["ppu"], meta["router"])
    b.record()
    b.synchronize()
    _, _, meta_c = make_experiment(inst=_to(inst, cpu), device="cpu", **kw)
    bl_c = screen(meta_c["core"], meta_c["ppu"], meta_c["router"])
    if bl.links != ((0, 2), (1, 3)) or bl_c.links != bl.links or not (
            np.array_equal(bl.rows, bl_c.rows)
            and np.array_equal(bl.neurons, bl_c.neurons)):
        raise AssertionError(f"[12] screen: links {bl.links}, CPU "
                             f"{bl_c.links}")
    log(f"[12] screen with the router on the card ({a.elapsed_time(b):.1f} "
        f"ms): links {bl.links}, {bl.n_rows} rows, {bl.n_neurons} neurons; "
        f"equal to the CPU's")
    try:
        reroute_plan(meta["router"].plan, bl.links)
    except ValueError as e:
        log(f"[12] path E's relay plan: reroute_plan raises ({e}): every "
            f"row of every chip already takes relayed events")
    else:
        raise AssertionError("[12] path E's relay plan rerouted")

    ann = make_plan(WaferTopology(4, "all2all"), 256, 512,
                    [(s, c, d, 32 * s + c, 63) for s in range(4)
                     for d in range(4) for c in range(32)])
    init, trial, meta_b, _, _ = _wafer_experiment(
        inst=inst, faults=fp, blacklist=bl, telemetry=True, wafer_plan=ann)
    router = meta_b["router"]
    states, metrics, n_e, routes_e = _eager_trials(trial, init(), stims,
                                                   draws)
    g = _replayed(trial, init(), stims, draws)
    hist_e = {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}
    _same_run((g.loop.history(), g.loop.state), (hist_e, states[-1]),
              "blacklisted wafer loop, graph vs eager", "[12]")
    tele = obs_trace.summary(states[-1].tele)
    if not tele["link_reroutes"] > 0 or tele != obs_trace.summary(
            g.loop.state.tele):
        raise AssertionError(f"[12] blacklisted loop counters {tele}")

    # a dead link's deliveries re-arrive over the forwards one window late
    clean = InterChipRouter(ann, device="cuda")
    sp1 = (torch.rand((128, 4, 512), generator=torch.Generator(
        ).manual_seed(6)) < 0.3).to(torch.float32).cuda()
    t = obs_trace.init_telemetry("cuda")
    g1c, _ = clean.route(sp1)
    g1f, t = router.route(sp1, t, routed_in=router.init_buffer(128))
    g2f, t = router.route(torch.zeros_like(sp1), t, routed_in=g1f)
    missing = (g1c[:, 2] - g1f[:, 2]).clamp(min=0)
    if not float(missing.sum()) > 0 or not torch.equal(g2f[:, 2], missing):
        raise AssertionError("[12] the dead link's traffic did not re-arrive "
                             "one window late")
    log(f"[12] blacklisted loop on the announcement plan ({ann.n_routes} "
        f"routes -> {router.plan.n_routes} routes + "
        f"{router.plan.n_forwards} forwards): 6 trials eager and as graph "
        f"replays bit-equal; launches eager {n_e}; link counters "
        f"{ {k: tele[k] for k in WAFER_LINK_COUNTERS} }, faults_injected "
        f"{tele['faults_injected']}; the dead link's "
        f"{int(missing.sum())} deliveries re-arrive one window late, "
        f"link_reroutes {obs_trace.summary(t)['link_reroutes']}")


def phase_path_e():
    """Path E, the wafer at full width: the router alone, the §5 loop of
    128 inputs x 2048 neurons on four full 256 x 512 chips (eager and as
    graph replays, traced, against the CPU, chip-count parity), and the
    link half of faults. Returns the launches of path E's 6 eager trials
    and the router's ``route()`` times."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import hybrid as th
    from repro_torch.core import synapse
    from repro_torch.obs import trace as obs_trace
    timing = _wafer_router_windows()

    init, trial, meta, kw, inst = _wafer_experiment()
    router = meta["router"]
    log(f"[12] path E: {router.K} chips of {router.R} x {router.C}, "
        f"{router.plan.n_routes} relay routes on {router.L} links, link "
        f"budget {router._budgets(128)}")
    stims = [1, 2, 0, 1, 2, 0]
    draws = meta["draw"](torch.Generator().manual_seed(23), stims)
    state0 = init()
    routes_dev = synapse.route_counts("cuda")
    synapse.reset_route_counts()
    snaps = [routes_dev.clone()]
    kernels.reset_launches()
    states, metrics, state = [], [], state0
    for i, stim in enumerate(stims):
        state, m = trial(state, stim, draws.events[i], draws.xi[i])
        snaps.append(routes_dev.clone())
        states.append(state)
        metrics.append(m)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    missing = [k for k in PATH_E_KERNELS if not counts[k]]
    if missing or counts["census"]:
        raise AssertionError(f"[12] path E launched no {missing} or a "
                             f"census kernel: {counts}")
    routes = _device_routes(snaps, len(stims))
    for x in _flatten(state):
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            raise AssertionError("[12] non-finite state after path E")
    log(f"[12] path E, 6 eager trials: launches {counts}; routes by trial "
        f"on the device {routes}; spikes "
        f"{float(sum(m['rates'].sum() for m in metrics)):.0f}")
    check_against_cpu(meta, kw, state0, stims[0], draws.events[0],
                      draws.xi[0], states[0], metrics[0], routes[0],
                      "path E trial 0", phase=12, inst=inst)
    graph = graph_vs_eager(trial, state0, stims, draws, states[-1], metrics,
                           snaps[-1].tolist(), counts, "[12]")

    # where a replay's time goes, and the router's own kernels
    traced = th.TrialGraph(th.TrialLoop(trial, state0, stims, draws))
    summ = _traced(lambda: [traced.replay() for _ in range(3)],
                   "path_e_graph", 3)
    addr = torch.zeros_like(draws.events[0], dtype=torch.int8)
    _, out = meta["core"].run_routed(state0.core, state0.routed,
                                     draws.events[0], addr, router)
    sp, routed = out["spikes"], out["routed"]

    def route_calls():
        for _ in range(3):
            router.merge(routed, draws.events[0], addr)
            router.route(sp, routed_in=routed)
    r_summ = _traced(route_calls, "path_e_router", 3)
    if summ is None or r_summ is None or not summ["by_name"]:
        log("[12] profiler: NO DEVICE TIME in the trace")
    else:
        top = sorted(summ["by_name"].items(), key=lambda kv: -kv[1][0])[:8]
        w, bz = summ["window_us"], summ["busy_us"]
        r_busy = r_summ["busy_us"]
        log(f"[12] profiler, 3 graph replays: window {w / 1e3:.3f} ms, device "
            f"busy {bz / 1e3:.3f} ms = {bz / w:.4f} of it; "
            f"{summ['kernels_per_trial']:.1f} kernels a trial; by name: "
            + "; ".join(f"{k} {t / 1e3:.4f} ({c})" for k, (t, c) in top))
        log(f"[12] profiler, the router alone (merge + route, 3 calls on "
            f"trial 0's spikes): device busy {r_busy / 1e3:.4f} ms, "
            f"{r_summ['kernels_per_trial']:.1f} kernels a call, "
            f"{r_busy / bz:.4f} of the replays' busy time; by name: "
            + "; ".join(f"{k} {t / 1e3:.4f} ({c})" for k, (t, c) in sorted(
                r_summ["by_name"].items(), key=lambda kv: -kv[1][0])))

    # the link counters of the same trials (telemetry on: same histories)
    init_t, trial_t, _, _, _ = _wafer_experiment(inst=inst, telemetry=True)
    g_t = _replayed(trial_t, init_t(), stims, draws)
    for k, v in g_t.loop.history().items():
        if k != "stim" and not torch.equal(
                v, torch.stack([m[k] for m in metrics])):
            raise AssertionError(f"[12] telemetry on: {k} differs")
    tele = obs_trace.summary(g_t.loop.state.tele)
    log(f"[12] path E counters (6 graph replays, telemetry on, histories "
        f"equal to off): "
        f"{ {k: tele[k] for k in WAFER_LINK_COUNTERS + ('dense_windows', 'sparse_windows', 'out_spikes')} }")
    _wafer_chip_count_parity()
    _wafer_link_faults(inst, stims, draws)
    return counts, timing, dict(graph, trace=summ, router_trace=r_summ)


# path F: the network mapper (phase 13)
# (the census kernel launches on none of its windows: the STP scan takes
# both halves' censuses)
PATH_F_KERNELS = ("stp_scan", "synray", "synray_sparse", "neuron_scan",
                  "corr")
PATH_F_W, PATH_F_T = 6, 128


def _path_f_spec():
    """Path F's network (``tests/_torch_mapper.py::path_f_spec``): the
    shape of ``examples/map_network.py`` scaled to fill four native chips,
    480 inputs x 2048 neurons, locality feedforward plus sparse inhibitory
    recurrence, 4,864 edges."""
    sys.path.insert(0, str(REPO / "tests"))
    import _torch_mapper
    spec = _torch_mapper.path_f_spec()
    if spec.n_edges != 4864:
        raise AssertionError(f"[13] path-F spec has {spec.n_edges} edges")
    return spec


def _path_f_mappings(spec):
    """``tests/_torch_mapper.py::path_f_mappings``: K = 4 native 256 x 512
    chips (all2all), K = 2 chips of 490 x 1024 and one 968 x 2048 chip;
    the K = 4 mapping timed alone (best of 3 on the host clock). K = 4
    must place 249 rows a chip with no relay and no transit row, as the
    reference's mapper does."""
    import _torch_mapper
    from repro_torch import mapper
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        mapper.map_network(spec, 4, chip_rows=256, chip_cols=512)
        times.append((time.perf_counter() - t0) * 1e3)
    maps = _torch_mapper.path_f_mappings(spec)
    m4 = maps[4]
    if m4.rows_used().tolist() != [249] * 4 or m4.n_relayed_edges or \
            m4.n_transit_rows:
        raise AssertionError(f"[13] K=4 mapping: rows {m4.rows_used()}, "
                             f"{m4.n_relayed_edges} relayed edges")
    if (maps[2].chip_rows, maps[1].chip_rows) != (490, 968):
        raise AssertionError(f"[13] rows {maps[2].chip_rows}, "
                             f"{maps[1].chip_rows}")
    return maps, min(times)


def _kernel_parity(name, args, kw):
    """One captured call: the kernel again (no flag, no routes) against
    its plain version on the same operands. Returns ``max_abs_err``:
    0 where the check is bit for bit; ``synray`` and ``synray_sparse``
    within rtol = atol = 1e-4, ``synray``'s const-address form bit-equal
    to its general form, and ``synray_sparse`` bit-equal to ``synray``
    where the window fits its capacities."""
    import torch
    from repro_torch.core import events
    from repro_torch.kernels.census import ops as census_ops
    from repro_torch.kernels.census.ref import census_ref
    from repro_torch.kernels.corr import ops as corr_ops
    from repro_torch.kernels.corr.ref import correlation_window_ref
    from repro_torch.kernels.neuron_scan import ops as neuron_ops
    from repro_torch.kernels.neuron_scan.ref import neuron_window_ref
    from repro_torch.kernels.stp_scan import ops as stp_ops
    from repro_torch.kernels.stp_scan.ref import (stp_scan_census_ref,
                                                  stp_scan_ref)
    from repro_torch.kernels.synray import ops as synray_ops
    from repro_torch.kernels.synray.ref import synaptic_current_ref
    from repro_torch.kernels.synray_sparse import ops as sparse_ops
    from repro_torch.kernels.synray_sparse.ref import sparse_window_ref

    def same(pairs, what):
        for a, b in pairs:
            if not torch.equal(a.view(torch.int32) if a.dtype ==
                               torch.float32 else a,
                               b.view(torch.int32) if b.dtype ==
                               torch.float32 else b):
                raise AssertionError(f"[13] {name}: {what} differs from "
                                     "the plain version")
        return 0.0
    if name == "stp_scan":
        kw = {k: v for k, v in kw.items() if k != "routes"}
        if kw.get("caps") is None:
            return same(zip(stp_ops.stp_scan(*args, **kw),
                            stp_scan_ref(*args, **kw)), "eff / r_T")
        return same(zip(stp_ops.stp_scan(*args, **kw),
                        stp_scan_census_ref(*args, **kw)),
                    "eff / r_T / the censuses")
    if name == "census":
        ev, me, kc = args[:3]
        return same([(census_ops.census(ev, me, kc),
                      census_ref(ev, me, kc))], "the census")
    if name == "neuron_scan":
        g_s, g_rc, g_r = neuron_ops.neuron_window(*args, **kw)
        p_s, p_rc, p_r = neuron_window_ref(
            *args, **{k: v for k, v in kw.items() if k != "packed_params"})
        return same([(g_r[0], p_r[0]), (g_rc, p_rc), *zip(g_s, p_s)],
                    "spikes / state")
    if name == "corr":
        return same(zip(corr_ops.correlation_window(*args, **kw),
                        correlation_window_ref(*args, **kw)), "a window")
    ev, ea, w, a = args
    if name == "synray":
        got = synray_ops.synaptic_current(
            ev, ea, w, a, const_addr=kw.get("const_addr", False))
        if kw.get("const_addr") and not torch.equal(
                got, synray_ops.synaptic_current(ev, ea, w, a)):
            raise AssertionError("[13] synray: const form != general form")
        want = synaptic_current_ref(ev, ea, w, a)
    else:
        me, kc = kw["max_events"], kw["k_cap"]
        got = sparse_ops.sparse_current_window(ev, ea, w, a, max_events=me,
                                               k_cap=kc)
        recs = events.regroup_window(ev.permute(1, 0, 2),
                                     ea.permute(1, 0, 2), me, kc)
        want = sparse_window_ref(*recs, w, a).permute(1, 0, 2)
        if int(census_ref(ev, me, kc)[0]) and not torch.equal(
                got, synray_ops.synaptic_current(ev, ea, w, a,
                                                 const_addr=True)):
            raise AssertionError("[13] synray_sparse != synray on a window "
                                 "that fits")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    return float((got - want).abs().max())


def _path_f_kernels(rt, ev_in, label):
    """Window 1 of ``rt`` (routed events in its inhibitory half) with
    every wrapper's operands captured; each kernel held against its plain
    version on them (``_kernel_parity``). Returns ``{name: (calls,
    max_abs_err, shapes)}``."""
    import torch
    ev, ad = rt.place(ev_in[:2])
    st, out = rt.core.run_routed(rt.init_state(), rt.router.init_buffer(
        ev.shape[1]), ev[0], ad[0], rt.router)
    calls = []
    undo = _capture_path(calls)
    try:
        rt.core.run_routed(st, out["routed"], ev[1], ad[1], rt.router)
    finally:
        undo()
    res = {}
    for name, args, kw in calls:
        err = _kernel_parity(name, args, kw)
        n, e, shapes = res.get(name, (0, 0.0, set()))
        t0 = next((x for x in args if isinstance(x, torch.Tensor)), None)
        res[name] = (n + 1, max(e, err), shapes | {tuple(t0.shape)})
    missing = [k for k in PATH_F_KERNELS if k not in res]
    if missing:
        raise AssertionError(f"[13] {label}: no call of {missing}")
    log(f"[13] kernels at {label} (window 1's operands): " + "; ".join(
        f"{k} x{n} {sorted(sh)} max_abs_err {e:.3g}"
        for k, (n, e, sh) in res.items()) + "; every one against its plain "
        "version")
    return res


def _first_spike_divergence(a, b):
    """(window, step, neuron) of the first spike that differs, or None."""
    d = (a != b).nonzero()
    return None if d.numel() == 0 else tuple(d[0].tolist())


def _path_f_parity(rts, ev_g):
    """K = 4, 2 and 1 on the same spec, instance and stimulus: spec-order
    spikes bit for bit. On a failure, each K again window by window with
    the device's route counter read after each window, and the first
    divergence printed, before raising."""
    import torch
    from repro_torch.core import synapse
    routes = synapse.route_counts("cuda")
    outs = {}
    for K, rt in rts.items():
        before = routes.clone()
        outs[K] = rt.run(ev_g)[1]["spikes"]
        outs[K] = (outs[K], (routes - before).tolist())
    spk1 = outs[1][0]
    bad = [K for K in (4, 2) if not torch.equal(outs[K][0], spk1)]
    if bad:
        for K, rt in rts.items():
            ev, ad = rt.place(ev_g)
            st, routed = rt.init_state(), rt.router.init_buffer(ev.shape[1])
            by_win = []
            for w in range(ev.shape[0]):
                before = routes.clone()
                st, o = rt.core.run_routed(st, routed, ev[w], ad[w],
                                           rt.router)
                routed = o["routed"]
                by_win.append((routes - before).tolist())
            log(f"[13] K={K} routes [dense, sparse] by window: {by_win}")
        for K in bad:
            log(f"[13] K={K} vs K=1 first divergence (window, step, "
                f"neuron): {_first_spike_divergence(outs[K][0], spk1)}")
        raise AssertionError(f"[13] chip-count parity fails for K={bad}")
    return outs


def _path_f_blacklist(spec, net_inst, ev_g, spk1):
    """A blacklist with rows, neurons and one dead link
    (``tests/_torch_mapper.py::path_f_blacklist``): four chips of 264 rows
    x 528 columns, 5 even and 3 odd rows and 12 neurons a chip screened
    out, and the link (0, 2) dead. The mapping avoids every bad site; run
    with those sites killed by faults, it equals the clean K = 1 run bit
    for bit."""
    import _torch_mapper
    import torch
    from repro_torch import mapper
    from repro_torch.configs.bss2 import BSS2
    m, bl, fp = _torch_mapper.path_f_blacklist(spec)
    R, C = m.chip_rows, m.chip_cols
    routed_pairs = set(zip(m.plan.src_chip.tolist(),
                           m.plan.dst_chip.tolist()))
    if ((m.row_source >= 0) & bl.rows).any() or \
            m.part.used_mask()[bl.neurons].any() or (0, 2) in routed_pairs \
            or m.n_relayed_edges:
        raise AssertionError("[13] the blacklisted mapping uses a bad site "
                             f"or relays ({m.n_relayed_edges} edges)")
    rt = mapper.build_runtime(m, cfg=BSS2, net_inst=net_inst, faults=fp,
                              device="cuda")
    spk = rt.run(ev_g)[1]["spikes"]
    if not torch.equal(spk, spk1):
        raise AssertionError("[13] the blacklisted K=4 run differs from K=1 "
                             f"at {_first_spike_divergence(spk, spk1)}")
    log(f"[13] blacklist ({bl.n_rows} rows, {bl.n_neurons} neurons, link "
        f"(0, 2)) on four {R} x {C} chips: rows used "
        f"{m.rows_used().tolist()}, no bad site used, no relay; run with "
        f"the sites killed by faults == K=1 bit for bit")
    return rt


def _path_f_replay_vs_eager(rt, ev_g, label):
    """``rt.run`` replayed and eager from fresh telemetry counters
    (``tests/_torch_mapper.py::replay_against_eager``): the final state,
    the spikes, the last routed grid, every counter and the device's
    route counts bit for bit, and one replay launching what one eager
    window launches. Returns the graph."""
    import _torch_mapper
    from repro_torch.obs import trace as obs_trace
    graph, differ, out, routes, per_window = \
        _torch_mapper.replay_against_eager(rt, ev_g)
    if differ:
        raise AssertionError(f"[13] {label}: the replays and the eager "
                             f"windows differ in {differ}")
    tele = obs_trace.summary(out["telemetry"])
    W = ev_g.shape[0]
    log(f"[13] {label}: {W} replays == {W} eager windows bit for bit "
        f"(state, spikes, routed grid, counters, routes {routes}); a replay "
        f"launches {per_window}; pool {graph.pool_bytes / 2**20:.1f} MiB; "
        f"counters steps {tele['steps']} in_events {tele['in_events']} "
        f"out_spikes {tele['out_spikes']} routed_events "
        f"{tele['routed_events']} link_overflows {tele['link_overflows']}")
    return graph


def _path_f_turns(rts, ev_g, turns=4):
    """Replayed against eager ms a window at K = 4 and K = 1 (CUDA events,
    ``turns`` runs of each in turns: replay, eager, eager, replay, ...):
    ``run`` as a user calls it (placement, the load, W replays, gather
    and clones) against ``run(..., eager=True)``, and the W replays
    alone. Returns ``{K: {"replay": ms, "eager": ms, "replay_only":
    ms}}`` (medians)."""
    import numpy as np
    import torch
    W = ev_g.shape[0]

    def timed(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / W
    med = {}
    for K in (4, 1):
        rt = rts[K]
        rt.run(ev_g)
        graph = rt.loops[(W, ev_g.shape[1], False)][1]

        def replays():
            for _ in range(W):
                graph.replay()
        runs = (("replay", lambda: rt.run(ev_g)),
                ("eager", lambda: rt.run(ev_g, eager=True)))
        times = {"replay": [], "eager": [], "replay_only": []}
        for i in range(turns):
            for k, fn in (runs if i % 2 == 0 else runs[::-1]):
                times[k].append(timed(fn))
            graph.loop.reset()
            times["replay_only"].append(timed(replays))
        med[K] = {k: float(np.median(v)) for k, v in times.items()}
        log(f"[13] K={K} ms a window (CUDA events, {W} windows a run, "
            f"{turns} runs each in turns): run replayed median "
            f"{med[K]['replay']:.4f} "
            f"{[round(t, 4) for t in times['replay']]}, eager median "
            f"{med[K]['eager']:.4f} "
            f"{[round(t, 4) for t in times['eager']]}, the replays alone "
            f"median {med[K]['replay_only']:.4f}; eager / replayed "
            f"{med[K]['eager'] / med[K]['replay']:.2f}")
    log(f"[13] K=4 / K=1 a window: replayed "
        f"{med[4]['replay'] / med[1]['replay']:.2f}, eager "
        f"{med[4]['eager'] / med[1]['eager']:.2f}")
    return med


def _path_f_capture_ms(rt, ev_g):
    """Host ms of one capture of ``rt``'s window loop at ``ev_g``'s shape
    (the warm-up window, the reset and the capture; ``LoopGraph``), and
    the graph."""
    import torch
    from repro_torch.core.graph import LoopGraph
    from repro_torch.wafer import WindowLoop
    ev, ad = rt.place(ev_g)
    loop = WindowLoop(rt.core, rt.router, rt.init_state(), ev, ad)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = LoopGraph(loop)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, graph


def _path_f_ranks(world, timeout=420):
    """``world`` NCCL ranks of ``tests/_torch_wafer_sharded.py``'s
    ``path_f`` part as child processes, one card a rank, all under
    ``timeout`` seconds (every child is killed on the way out; each
    rank's output kept in ``build/``). Returns each rank's
    ``PATH_F_GROUPED`` record; a rank that fails raises."""
    build = REPO / "build"
    store = build / f"path_f_store_{world}"
    store.unlink(missing_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    # each rank writes to a file: a pipe read one rank after another could
    # fill and stall a rank that the others wait for in a collective
    logs = [build / f"path_f_rank{rank}_of_{world}.log"
            for rank in range(world)]
    procs = []
    try:
        for rank, path in enumerate(logs):
            with open(path, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable,
                     str(REPO / "tests" / "_torch_wafer_sharded.py"),
                     str(rank), str(world), str(store), "nccl", "path_f"],
                    stdout=f, stderr=subprocess.STDOUT, env=env,
                    cwd=str(REPO)))
        t_end = time.time() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, t_end - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for rank, (p, path) in enumerate(zip(procs, logs)):
        out = path.read_text(errors="replace")
        line = next((x for x in out.splitlines()
                     if x.startswith("PATH_F_GROUPED ")), None)
        if p.returncode != 0 or line is None or \
                f"WAFER_SHARDED_OK rank={rank} cases=4" not in out:
            raise AssertionError(f"[13] grouped path F, world {world}, rank "
                                 f"{rank} failed (rc {p.returncode}):\n"
                                 f"{out[-6000:]}")
        recs.append(json.loads(line.split(" ", 1)[1]))
    return recs


def _path_f_grouped():
    """Path F's K = 4 runtime under a group (see the module docstring,
    phase 13): a world of 1 on NCCL in this process, then ``min(4, n)``
    ranks as children where ``n >= 2`` cards are present. Returns
    ``{world: [record of each rank]}``."""
    import torch
    import torch.distributed as dist
    import _torch_wafer_sharded as sharded
    torch.cuda.set_device(0)
    (REPO / "build").mkdir(exist_ok=True)
    store = REPO / "build" / "path_f_store"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        _, rec = sharded.path_f(dist.group.WORLD, slice(0, 4),
                                torch.device("cuda", 0), W=PATH_F_W)
    finally:
        # path_f's graphs hold NCCL work: they must be gone before the
        # group is destroyed (a live one hangs the teardown)
        gc.collect()
        dist.destroy_process_group()
    recs = {1: [rec]}
    n = torch.cuda.device_count()
    if n >= 2:
        world = min(4, n)
        log(f"[13] grouped path F ran as: a world of 1 in this process, and "
            f"{world} NCCL ranks as child processes ({n} cards)")
        recs[world] = _path_f_ranks(world)
    else:
        log("[13] grouped path F ran as: a world of 1 in this process only "
            "(one card; the multi-rank form needs two or more)")
    for world, rs in recs.items():
        for r in rs:
            t = {k: round(v["median"], 4) for k, v in r["ms_a_window"].items()}
            tr = r["trace"] or {}
            log(f"[13] grouped path F, world {world} rank {r['rank']} (chips "
                f"{r['chips']}): replays == eager windows == the runtime "
                f"without a group == one chip, bit for bit; ms a window "
                f"(medians in turns) {t}; capture {r['capture_ms']:.1f} ms, "
                f"pool {r['pool_mib']:.1f} MiB; a replay launches "
                f"{ {k: v for k, v in r['launches_a_replay'].items() if v} }, "
                f"{tr.get('ops', 'not traced')} device operations "
                f"({tr.get('kernels', '-')} kernels, {tr.get('nccl', '-')} "
                f"NCCL), busy {tr.get('busy_share', '-')} of 3 traced "
                f"replays")
    return recs


def phase_path_f():
    """Path F, the network mapper at full width: the 480 x 2048 spec
    mapped onto four native 256 x 512 chips and run through
    ``build_runtime(...).run`` (6 windows of T = 128 as replays of one
    captured window, with the launch counts set to 0 before and read
    after: the wrappers count the window's warm-up and capture),
    chip-count parity with K = 2 and K = 1, window 0 against the CPU, an
    eager window and a replayed run under ``set_sync_debug_mode
    ("error")``, a blacklisted mapping, every kernel against its plain
    version at each geometry, replays against eager windows bit for bit
    at each geometry, CUDA-event times of replayed and eager windows at
    K = 4 and K = 1, and ``torch.profiler`` traces. Returns the launches
    of the K = 4 run."""
    import numpy as np
    import torch
    from repro_torch import kernels, mapper
    from repro_torch.configs.bss2 import BSS2
    from repro_torch.core import synapse
    dev = torch.device("cuda")
    cpu = torch.device("cpu")
    spec = _path_f_spec()
    maps, map_ms = _path_f_mappings(spec)
    log(f"[13] path F: {spec.n_in} x {spec.n_neurons}, {spec.n_edges} "
        f"edges; map_network onto 4 x 256 x 512 in {map_ms:.1f} ms (host, "
        f"best of 3): rows {maps[4].rows_used().tolist()}, "
        f"{maps[4].plan.n_routes} routes, no relay; K=2 "
        f"{maps[2].chip_rows} x {maps[2].chip_cols} rows "
        f"{maps[2].rows_used().tolist()}, K=1 {maps[1].chip_rows} x "
        f"{maps[1].chip_cols} rows {maps[1].rows_used().tolist()}")
    net_inst = mapper.sample_network_instance(
        spec, torch.Generator().manual_seed(31), cfg=BSS2, device=dev)
    rts = {K: mapper.build_runtime(m, cfg=BSS2, net_inst=net_inst,
                                   device=dev) for K, m in maps.items()}
    rng = np.random.default_rng(13)
    ev_g = torch.from_numpy((rng.random((PATH_F_W, PATH_F_T, spec.n_in))
                             < 0.05).astype(np.float32)).to(dev)
    rt4 = rts[4]
    rt4.run(ev_g[:2])                     # warm-up: builds, a W = 2 graph
    torch.cuda.synchronize()
    routes = synapse.route_counts(dev)
    synapse.reset_route_counts()
    kernels.reset_launches()
    state, out = rt4.run(ev_g)            # captures W = 6, then replays
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    graph4 = rt4.loops[(PATH_F_W, PATH_F_T, False)][1]
    missing = [k for k in PATH_F_KERNELS if not counts[k]]
    if missing or counts["census"]:
        raise AssertionError(f"[13] path F launched no {missing} or a "
                             f"census kernel: {counts}")
    spk = out["spikes"]
    if tuple(spk.shape) != (PATH_F_W, PATH_F_T, spec.n_neurons) or \
            not float(spk.sum()) > 0 or not float(out["routed"].sum()) > 0:
        raise AssertionError(f"[13] path F output {tuple(spk.shape)}, "
                             f"{float(spk.sum())} spikes")
    for x in _flatten(state):
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            raise AssertionError("[13] non-finite state after path F")
    log(f"[13] path F, K=4, {PATH_F_W} windows replayed: launches {counts} "
        f"(the window's warm-up and capture; each replay launches "
        f"{graph4.launches}); routes [dense, sparse] on the device "
        f"{routes.tolist()}; {float(spk.sum()):.0f} spikes, per window "
        f"{spk.sum((1, 2)).tolist()}")

    # an eager window and a replayed run with no device-to-host read
    st0 = rt4.init_state()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rt4.run(ev_g[:1], state=st0, eager=True)
        rt4.run(ev_g, state=st0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("[13] one eager window and a replayed run of rt.run under "
        "set_sync_debug_mode('error'): no device-to-host read")

    # chip-count parity
    outs = _path_f_parity(rts, ev_g)
    log("[13] chip-count parity: " + ", ".join(
        f"K={K} {rts[K].mapping.chip_rows} x {rts[K].mapping.chip_cols} "
        f"routes {outs[K][1]}" for K in (4, 2, 1))
        + f"; spec-order spikes bit for bit ({float(outs[1][0].sum()):.0f})")

    # window 0 on the CPU from the same instance
    rt_c = mapper.build_runtime(maps[4], cfg=BSS2,
                                net_inst=_to(net_inst, cpu), device=cpu)
    ev_c, ad_c = rt_c.place(ev_g[:1].cpu())
    ev_d, ad_d = rt4.place(ev_g[:1])
    _, o_c = rt_c.core.run_routed(rt_c.init_state(),
                                  rt_c.router.init_buffer(PATH_F_T),
                                  ev_c[0], ad_c[0], rt_c.router,
                                  record_v=True)
    _, o_g = rt4.core.run_routed(rt4.init_state(),
                                 rt4.router.init_buffer(PATH_F_T), ev_d[0],
                                 ad_d[0], rt4.router, record_v=True)
    p = rt_c.inst["neuron_params"]
    thr = p["v_thres"] + 2.0 * p["delta_t"]
    s_g, s_c = o_g["spikes"].cpu(), o_c["spikes"]
    v_quiet = torch.where(s_c == 0, o_c["v"], o_g["v"].cpu())
    near = (v_quiet - thr).abs() <= 1e-4 + 1e-4 * thr.abs()
    flip = s_g != s_c
    if bool((flip & ~near).any()):
        raise AssertionError("[13] window 0: a spike differs card vs CPU "
                             "away from threshold")
    if not bool(flip.any()) and not torch.equal(o_g["routed"].cpu(),
                                                o_c["routed"]):
        raise AssertionError("[13] window 0: routed grids differ")
    log(f"[13] window 0 card vs CPU (fused backend): {int(flip.sum())} of "
        f"{int(s_c.sum())} spikes flipped (at threshold); routed grids "
        f"{'equal' if not bool(flip.any()) else 'not compared'}")

    bl_rt = _path_f_blacklist(spec, net_inst, ev_g, outs[1][0])

    # every kernel of the path against its plain version at each geometry
    kparity = {}
    for label, rt in (("K=4 (4 x 256 x 512)", rts[4]),
                      ("K=2 (2 x 490 x 1024, Dale halves of 245)", rts[2]),
                      ("K=1 (968 x 2048)", rts[1]),
                      ("blacklisted (4 x 264 x 528)", bl_rt)):
        kparity[label] = _path_f_kernels(rt, ev_g, label)

    # replays against eager windows at each geometry, with counters
    pools = {}
    for label, rt in (("K=4", rts[4]), ("K=2", rts[2]), ("K=1", rts[1]),
                      ("blacklisted", bl_rt)):
        pools[label] = _path_f_replay_vs_eager(rt, ev_g, label).pool_bytes

    # replayed against eager time a window, K = 4 and K = 1, in turns
    _path_f_turns(rts, ev_g)
    caps = {K: _path_f_capture_ms(rts[K], ev_g) for K in (4, 1)}
    log("[13] capture of the 6-window loop (host ms: warm-up window, "
        "reset, capture): " + ", ".join(
            f"K={K} {ms:.1f} ms, pool {g.pool_bytes / 2**20:.1f} MiB"
            for K, (ms, g) in caps.items()) + "; pools of the parity "
        "graphs with counters: " + ", ".join(
            f"{k} {v / 2**20:.1f} MiB" for k, v in pools.items()))
    del caps

    # where a window's time goes, replayed and eager, and the router's
    # own kernels
    rt4.run(ev_g[:3])                     # the W = 3 graph, captured
    torch.cuda.synchronize()
    g_summ = _traced(lambda: rt4.run(ev_g[:3]), "path_f_replays", 3)
    graph4.loop.reset()                   # 2 x 3 replays of the 6 windows
    o_summ = _traced(lambda: [graph4.replay() for _ in range(3)],
                     "path_f_graph", 3)
    summ = _traced(lambda: rt4.run(ev_g[:3], eager=True), "path_f_windows",
                   3)
    _, o1 = rt4.core.run_routed(rt4.init_state(),
                                rt4.router.init_buffer(PATH_F_T), ev_d[0],
                                ad_d[0], rt4.router)
    sp, routed = o1["spikes"], o1["routed"]

    def route_calls():
        for _ in range(3):
            rt4.router.merge(routed, ev_d[0], ad_d[0])
            rt4.router.route(sp, routed_in=routed)
    r_summ = _traced(route_calls, "path_f_router", 3)
    # a trace that lost device events (seen once: a corr launch and the
    # router's kernels missing) is reported as such, not as numbers
    def n_corr(sm):
        return 0 if sm is None else sum(
            c for k, (_, c) in sm["by_name"].items()
            if k.startswith("corr_kernel"))
    if g_summ is None or not g_summ["by_name"]:
        log("[13] profiler, replays: NO DEVICE TIME in the trace")
    elif n_corr(g_summ) != 3:
        log(f"[13] profiler, replays: the trace lost device events "
            f"(corr_kernel x{n_corr(g_summ)} of 3 windows); its numbers "
            f"are not reported")
    else:
        top = sorted(g_summ["by_name"].items(), key=lambda kv: -kv[1][0])[:8]
        w, bz = g_summ["window_us"], g_summ["busy_us"]
        log(f"[13] profiler, 3 replayed windows of K=4 (rt.run): window "
            f"{w / 1e3:.3f} ms, device busy {bz / 1e3:.3f} ms = "
            f"{bz / w:.4f} of it; {g_summ['kernels_per_trial']:.1f} kernels "
            f"a window; by name: "
            + "; ".join(f"{k} {t / 1e3:.4f} ({c})" for k, (t, c) in top))
    if o_summ is None or not o_summ["by_name"] or n_corr(o_summ) != 3:
        log("[13] profiler, the replays alone: no device time, or the "
            "trace lost device events; not reported")
    else:
        w, bz = o_summ["window_us"], o_summ["busy_us"]
        log(f"[13] profiler, 3 replays alone of K=4 (graph.replay()): "
            f"window {w / 1e3:.3f} ms, device busy {bz / 1e3:.3f} ms = "
            f"{bz / w:.4f} of it; {o_summ['kernels_per_trial']:.1f} "
            f"kernels a replay")
    if summ is None or r_summ is None or not summ["by_name"]:
        log("[13] profiler: NO DEVICE TIME in the trace")
    elif n_corr(summ) != 3 or not r_summ["kernels_per_trial"]:
        log(f"[13] profiler: the traces lost device events (corr_kernel "
            f"x{n_corr(summ)} of 3 windows, "
            f"{r_summ['kernels_per_trial']:.1f} router kernels a call); "
            f"their numbers are not reported")
    else:
        top = sorted(summ["by_name"].items(), key=lambda kv: -kv[1][0])[:8]
        w, bz = summ["window_us"], summ["busy_us"]
        log(f"[13] profiler, 3 eager windows of K=4 (rt.run(..., eager="
            f"True)): window {w / 1e3:.3f} "
            f"ms, device busy {bz / 1e3:.3f} ms = {bz / w:.4f} of it; "
            f"{summ['kernels_per_trial']:.1f} kernels a window; by name: "
            + "; ".join(f"{k} {t / 1e3:.4f} ({c})" for k, (t, c) in top))
        log(f"[13] profiler, the router alone (merge + route, 3 calls on "
            f"window 0's spikes): device busy {r_summ['busy_us'] / 1e3:.4f} "
            f"ms, {r_summ['kernels_per_trial']:.1f} kernels a call, "
            f"{r_summ['busy_us'] / bz:.4f} of the windows' busy time")

    grouped = _path_f_grouped()
    print("mapped_path_f_grouped " + json.dumps(
        {str(w): rs for w, rs in grouped.items()}), flush=True)
    return counts


# path G: LM serving (repro_torch.serve) at full qwen1.5-0.5b width
PATH_G_ARCH, PATH_G_FAMILIES = "qwen1.5-0.5b", ("mamba2-130m", "hymba-1.5b")
# prompt tokens a request at full width: qwen1.5-0.5b's 128; mamba2-130m's
# 512, two SSD chunks of 256; hymba-1.5b's 1152, so that with its 128 meta
# tokens 1280 positions fill five chunks and pass its 1024-token window
PATH_G_PROMPT = {"qwen1.5-0.5b": 128, "mamba2-130m": 512, "hymba-1.5b": 1152}
PATH_G_B, PATH_G_NEW = 8, 32
# the reduced archs: prompt + prefix = 48 positions, three SSD chunks of 16
# and six times the reduced window of 8
PATH_G_REDUCED_POS, PATH_G_REDUCED_NEW = 48, 8
# card against CPU on the logits of one request, |card - cpu| <= tol + tol
# |cpu|: the house 1e-4 on the reduced archs (2-3 layers, d 64); 1e-3 at
# full width, where 24-32 layers of fp32 sums run in cuBLAS's order on the
# card and in the CPU BLAS's on the host
PATH_G_TOL_REDUCED, PATH_G_TOL_FULL = 1e-4, 1e-3


def _lm_params(arch, dev, seed):
    import torch
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel.sharding import (ShardingCtx, init_params,
                                               param_bytes)
    decls = build_model(arch, ShardingCtx()).decls
    params = init_params(decls, torch.Generator(dev).manual_seed(seed), dev)
    return params, param_bytes(decls)


def _lm_batch(arch, tokens, rng, dev, patches="engine"):
    """The model inputs of ``tokens`` [b, s] (numpy): frames for the
    encoder; for a VLM beside the tokens the patch embeddings the engine
    serves (zeros, ``patches="engine"``) or drawn ones (``"drawn"``)."""
    import numpy as np
    import torch
    b, s = tokens.shape
    if arch.family == "audio":
        return dict(frames=torch.from_numpy(rng.standard_normal(
            (b, s, arch.frame_dim)).astype(np.float32)).to(dev))
    batch = dict(tokens=torch.from_numpy(tokens.astype(np.int64)).to(dev))
    if arch.vit_dim:
        shape = (b, arch.n_patches, arch.vit_dim)
        batch["patch_embeds"] = (
            torch.zeros(shape, device=dev) if patches == "engine" else
            torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev))
    return batch


def _logits_agree(lg, lc, tol, what, tok=None):
    """Card logits ``lg`` against CPU logits ``lc`` [b, V] (the same step):
    within ``tol + tol |lc|`` everywhere; the card's token (``tok`` [b],
    the engine's where given, else ``lg``'s greedy one) may differ from
    the CPU's greedy token only where the CPU's top-2 gap is under ``tol``
    (a near tie). Returns (max abs error, flips)."""
    import torch
    a, b = lg.float().cpu(), lc.float()
    err = (a - b).abs()
    bad = err > tol + tol * b.abs()
    if bad.any():
        raise AssertionError(f"{what}: card and CPU logits differ by "
                             f"{err.max().item():.3e} (tol {tol})")
    ta = a.argmax(-1) if tok is None else tok.reshape(-1).cpu()
    tb = b.argmax(-1)
    top2 = torch.topk(b, 2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    flip = ta != tb
    if (flip & (gap >= tol)).any():
        raise AssertionError(f"{what}: the card's token differs where the "
                             f"CPU's top-2 gap {gap[flip].min().item():.3e} "
                             f">= {tol}")
    return err.max().item(), int(flip.sum())


def _engine_against_cpu(arch, params_g, batch_g, out, tol, label):
    """Requests of a ``ServeEngine.generate`` run on the card (their inputs
    ``batch_g`` [b, s], their tokens ``out`` [b, n_new]) held against the
    CPU, teacher-forced: the same parameters (copied) prefill the prompts
    on the card and on the CPU, then decode step i feeds both the engine's
    tokens i - 1 at the engine's position. At every step the logits agree
    and the engine's tokens i are the CPU's greedy ones up to a near tie
    (``_logits_agree``). ``out=None`` (the encoder) holds the prefill
    frame logits only. Returns (max abs error, flips, decode steps)."""
    import torch
    from repro_torch.models.transformer import build_model, prefix_len
    from repro_torch.parallel.sharding import ShardingCtx
    from repro_torch.serve.engine import grow_cache
    cpu = torch.device("cpu")
    bundle = build_model(arch, ShardingCtx())
    params_c = _to(params_g, cpu)
    batch_c = _to(batch_g, cpu)
    with torch.no_grad():
        lg, cg = bundle.prefill(params_g, batch_g)
        lc, cc = bundle.prefill(params_c, batch_c)
        if out is None:
            e, f = _logits_agree(lg.reshape(-1, lg.shape[-1]),
                                 lc.reshape(-1, lc.shape[-1]), tol,
                                 f"{label} frame logits")
            return e, f, 0
        out = out.to(torch.int64)
        worst, flips = _logits_agree(lg[:, -1], lc[:, -1], tol,
                                     f"{label} prefill", tok=out[:, 0])
        total = batch_g["tokens"].shape[1] + prefix_len(arch)
        n = out.shape[1] - 1
        cg = grow_cache(cg, total, total + n)
        cc = grow_cache(cc, total, total + n)
        for i in range(n):
            tok = out[:, i:i + 1]
            lg, cg = bundle.decode_step(params_g, cg, tok.to(lg.device),
                                        total + i)
            lc, cc = bundle.decode_step(params_c, cc, tok, total + i)
            e, f = _logits_agree(lg[:, -1], lc[:, -1], tol,
                                 f"{label} decode step {i}",
                                 tok=out[:, i + 1])
            worst, flips = max(worst, e), flips + f
    return worst, flips, n


def _serve_timed(arch, params, prompts, n_new, reps=3):
    """``ServeEngine.generate`` on the card, ``reps`` timed runs after a
    warm-up: the median prefill and decode spans (CUDA events,
    ``PhaseTimer``), the tokens of the last run, the launches of the
    port's kernels in it and the peak device memory."""
    import torch
    from repro_torch import kernels
    from repro_torch.obs.timing import PhaseTimer
    from repro_torch.serve.engine import ServeEngine
    dev = torch.device("cuda")
    b, s = prompts.shape
    eng = ServeEngine(arch, max_len=s + arch.n_meta_tokens + n_new,
                      device=dev)
    eng.generate(params, prompts[:, :8], n_new=2)           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer = PhaseTimer(dev)
    for _ in range(reps):
        kernels.reset_launches()
        out = eng.generate(params, prompts, n_new=n_new, timer=timer)
        launches = dict(kernels.LAUNCHES)
    med = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in timer.samples.items()}
    return (med["prefill"], med["decode"], out, launches,
            torch.cuda.max_memory_allocated())


def _decode_trace(arch, params, prompts, n_steps=4, ctx=None,
                  name="path_g"):
    """A ``torch.profiler`` trace of ``n_steps`` decode steps at the served
    batch (the cache from one prefill; ``_traced``), under ``ctx``'s mesh
    where given (``params`` placed on it)."""
    import torch
    from repro_torch.models.transformer import build_model, prefix_len
    from repro_torch.parallel.sharding import ShardingCtx
    from repro_torch.serve.engine import grow_cache
    dev = torch.device("cuda")
    bundle = build_model(arch, ctx or ShardingCtx())
    toks = torch.from_numpy(prompts.astype("int64")).to(dev)
    total = toks.shape[1] + prefix_len(arch)
    with torch.no_grad():
        logits, cache = bundle.prefill(params, dict(tokens=toks))
        cache = grow_cache(cache, total, total + 2 * n_steps)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    state = {"t": total}

    def steps():
        with torch.no_grad():
            for _ in range(n_steps):
                # both profiler steps write the same positions
                t = total + (state["t"] - total) % n_steps
                bundle.decode_step(params, cache, tok, t)
                state["t"] += 1
    return _traced(steps, f"{name}_decode_{arch.name}", n_steps)


def _serve_full(name, rng):
    """One arch at full width on the card: 8 requests of its prompt length
    (``PATH_G_PROMPT``), 32 greedy new tokens timed (``_serve_timed``),
    the bounds, and request 0 of the timed run against the CPU
    (``_engine_against_cpu``). Returns its record."""
    import torch
    from repro_torch.config import get_arch
    dev = torch.device("cuda")
    arch = get_arch(name)
    params, n_bytes = _lm_params(arch, dev, seed=0)
    n_params = n_bytes // 4
    S = PATH_G_PROMPT[name]
    prompts = rng.integers(0, arch.vocab, (PATH_G_B, S))
    pre_ms, dec_ms, out, launches, peak = _serve_timed(
        arch, params, prompts, PATH_G_NEW)
    assert tuple(out.shape) == (PATH_G_B, PATH_G_NEW), out.shape
    assert int(out.min()) >= 0 and int(out.max()) < arch.vocab, \
        (name, int(out.min()), int(out.max()))
    assert not any(launches.values()), (name, launches)
    n_tok = PATH_G_B * (S + arch.n_meta_tokens)
    rec = dict(
        arch=name, params=n_params, param_bytes=n_bytes,
        batch=PATH_G_B, prompt=S, prefix=arch.n_meta_tokens,
        new=PATH_G_NEW, prefill_ms=pre_ms,
        decode_ms_per_token=dec_ms / PATH_G_NEW,
        tokens_per_s=PATH_G_B * PATH_G_NEW / ((pre_ms + dec_ms) * 1e-3),
        decode_tokens_per_s=PATH_G_B * PATH_G_NEW / (dec_ms * 1e-3),
        bound_decode_ms=n_bytes / MEM_BW * 1e3,
        bound_prefill_ms=2 * n_params * n_tok / FP32_PEAK * 1e3,
        max_memory_allocated=peak, launches=launches)
    # request 0 alone: the three archs hold no MoE layer, so a request's
    # logits do not depend on the others in its batch
    t0 = time.time()
    err, flips, steps = _engine_against_cpu(
        arch, params, _lm_batch(arch, prompts[:1], rng, dev), out[:1],
        PATH_G_TOL_FULL, name)
    rec.update(cpu_max_abs_err=err, cpu_flips=flips, cpu_steps=steps,
               cpu_tol=PATH_G_TOL_FULL, cpu_check_s=time.time() - t0)
    log(f"[14] {name} full width ({n_params / 1e9:.3f} B params, "
        f"{n_bytes / 1e9:.3f} GB f32): prefill {pre_ms:.3f} ms for "
        f"{PATH_G_B} x {S} (+{arch.n_meta_tokens} meta; bound "
        f"{rec['bound_prefill_ms']:.3f}), decode "
        f"{rec['decode_ms_per_token']:.4f} ms a token (bound "
        f"{rec['bound_decode_ms']:.4f}), {rec['tokens_per_s']:.1f} tokens/s "
        f"end to end, {rec['decode_tokens_per_s']:.1f} decoding; peak "
        f"{peak / 1e9:.3f} GB; request 0 of the timed run vs the CPU over "
        f"the prefill and {steps} teacher-forced steps: max |err| "
        f"{err:.3e}, {flips} near-tie flips ({rec['cpu_check_s']:.1f} s)")
    return rec, params, prompts


def phase_path_g():
    """Path G, LM serving: ``ServeEngine`` at full qwen1.5-0.5b width (8
    requests of 128 prompt tokens, 32 greedy new tokens; prefill and
    decode timed with CUDA events, a profiler trace of 4 decode steps,
    the bounds); ``mamba2-130m`` at 8 x 512 (two SSD chunks of 256, so
    the inter-chunk state pass runs) and ``hymba-1.5b`` at 8 x 1152 (+ 128
    meta = 1280 positions: five chunks, and its 1024-token sliding window
    cuts in prefill and decode) the same way. In each, request 0 of the
    timed run is held against the CPU teacher-forced at its full prompt
    and all 32 tokens. Every served reduced arch is generated on the card
    (2 requests of 48 positions: three chunks of 16, six reduced windows)
    and both requests held against the CPU the same way (``hubert-xlarge``:
    its prefill frame logits; ``internvl2-2b`` also its prefill on drawn
    patch embeddings).
    Path G launches none of the port's kernels (counts read). Returns the
    ``serve_path_g`` record."""
    import numpy as np
    import torch
    from repro_torch.config import ASSIGNED_ARCHS, get_arch
    from repro_torch.models.transformer import build_model, prefix_len
    from repro_torch.parallel.sharding import ShardingCtx
    from repro_torch.serve.engine import ServeEngine
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    rec = {}
    main, params, prompts = _serve_full(PATH_G_ARCH, rng)
    summ = _decode_trace(get_arch(PATH_G_ARCH), params, prompts)
    if summ is None:
        log("[14] profiler: the trace holds no device time")
    else:
        w, bz = summ["window_us"], summ["busy_us"]
        top = sorted(summ["by_name"].items(), key=lambda kv: -kv[1][0])[:6]
        main.update(trace_step_ms=w / 1e3 / 4, trace_busy_share=bz / w,
                    trace_kernels_per_step=summ["kernels_per_trial"],
                    trace_top=[[k, t / 1e3, c] for k, (t, c) in top])
        log(f"[14] profiler, 4 decode steps of {PATH_G_ARCH} at batch "
            f"{PATH_G_B}: {w / 4e3:.4f} ms a step, device busy "
            f"{bz / w:.4f} of it, {summ['kernels_per_trial']:.1f} kernels "
            f"a step; by time: "
            + "; ".join(f"{k} {t / 1e3:.4f} ({c})" for k, (t, c) in top))
    del params
    rec["main"] = main
    for name in PATH_G_FAMILIES:
        r, p, _ = _serve_full(name, rng)
        rec[name] = r
        del p
        torch.cuda.empty_cache()
    reduced = {}
    for name in ASSIGNED_ARCHS:
        arch = get_arch(name).reduced()
        params, _ = _lm_params(arch, dev, seed=1)
        s = PATH_G_REDUCED_POS - prefix_len(arch)
        toks = rng.integers(0, arch.vocab, (2, s))
        out = None
        if not arch.is_encoder_only:
            eng = ServeEngine(arch, max_len=PATH_G_REDUCED_POS
                              + PATH_G_REDUCED_NEW, device=dev)
            out = eng.generate(params, toks, n_new=PATH_G_REDUCED_NEW)
            assert tuple(out.shape) == (2, PATH_G_REDUCED_NEW)
            assert int(out.max()) < arch.vocab, name
        # the whole batch: a MoE layer dispatches it as one group, so
        # capacity drops tie a request to the others
        err, flips, steps = _engine_against_cpu(
            arch, params, _lm_batch(arch, toks, rng, dev), out,
            PATH_G_TOL_REDUCED, name)
        if arch.vit_dim:
            bundle = build_model(arch, ShardingCtx())
            bg = _lm_batch(arch, toks[:1], rng, dev, patches="drawn")
            with torch.no_grad():
                lg = bundle.prefill(params, bg)[0]
                lc = bundle.prefill(_to(params, torch.device("cpu")),
                                    _to(bg, torch.device("cpu")))[0]
            e, _ = _logits_agree(lg.reshape(-1, lg.shape[-1]),
                                 lc.reshape(-1, lc.shape[-1]),
                                 PATH_G_TOL_REDUCED,
                                 f"{name} prefill on drawn patches")
            err = max(err, e)
        reduced[name] = dict(max_abs_err=err, flips=flips, steps=steps)
        log(f"[14] {name} reduced: card vs CPU over "
            f"{'the prefill frame logits' if out is None else f'the engine run of {s} + {prefix_len(arch)} positions, {steps} teacher-forced steps'}"
            f": max |err| {err:.3e}, {flips} near-tie flips")
    rec["reduced"] = reduced
    rec["tol_reduced"], rec["tol_full"] = PATH_G_TOL_REDUCED, PATH_G_TOL_FULL
    print("serve_path_g " + json.dumps(rec), flush=True)
    return rec


# path H: LM training (repro_torch.train) at full smollm-360m width, the
# reference's full-width example (examples/train_lm.py:29-30, 38-40)
PATH_H_ARCH, PATH_H_SHAPE = "smollm-360m", ("train_small", 512, 8, "train")
PATH_H_STEPS, PATH_H_LR, PATH_H_WARMUP = 20, 1e-3, 20
# card against CPU at full width: gradients within rtol = atol = 1e-3
# (path G's full-width tolerance: 32 layers of fp32 sums in cuBLAS's
# order on the card and the CPU BLAS's on the host); the same for the
# three-factor step's top-2 gaps and .5 boundaries
PATH_H_TOL = 1e-3
# remat as the arch says against remat off on the card: the same
# kernels on the same operands, so equal up to 1e-5 (bit-equal expected)
PATH_H_REMAT_TOL = 1e-5
# crash / restart at reduced width (tests/test_runtime.py:135-153)
PATH_H_CRASH = dict(steps=8, ckpt_every=4, fail_at_step=6)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _leaves(tree, prefix=""):
    """``{path: leaf}`` of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _events():
    import torch
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _path_h_against_cpu(bundle, params0, batch, cfg):
    """One step on the card and on the CPU from the same parameters on
    the 1 x 512 sub-batch ``batch`` (on the CPU): loss, grad norm and
    every gradient leaf within ``PATH_H_TOL``; the parameters after AdamW
    within 1e-6 + 1e-5 |p|, except elements whose CPU gradient is under
    1e-5 in size (counted, held to 2 lr). The first step moves a
    parameter by lr g / (|g| + eps), ~lr sign(g): a gradient error dg
    moves it by ~lr eps dg / g^2, past 1e-6 only where |g| is within a
    few 1e-6 of 0."""
    import torch
    from repro_torch.parallel.sharding import init_params
    from repro_torch.train.optimizer import (adamw_init_decls, adamw_update,
                                             global_norm)
    from repro_torch.train.steps import value_and_grad
    cpu, dev = torch.device("cpu"), params0["emb"].device
    t0 = time.time()
    p_g, p_c = _clone(params0), _to(params0, cpu)
    l_g, g_g = value_and_grad(bundle.loss, p_g, _to(batch, dev))
    l_c, g_c = value_and_grad(bundle.loss, p_c, batch)
    n_g, n_c = float(global_norm(g_g)), float(global_norm(g_c))
    assert abs(float(l_g) - float(l_c)) <= PATH_H_TOL * (1 + abs(float(l_c)))
    assert abs(n_g - n_c) <= PATH_H_TOL * (1 + n_c), (n_g, n_c)
    gg, gc_ = _leaves(g_g), _leaves(g_c)
    grad_err = 0.0
    for k in gc_:
        a, b = gg[k].cpu(), gc_[k]
        err = (a - b).abs()
        if (err > PATH_H_TOL + PATH_H_TOL * b.abs()).any():
            raise AssertionError(f"[15] gradient {k}: card and CPU differ "
                                 f"by {err.max().item():.3e}")
        grad_err = max(grad_err, err.max().item())
    lr = float(cfg.lr * min(1.0, 1 / max(cfg.warmup_steps, 1)))
    adamw_update(p_g, g_g, init_params(adamw_init_decls(bundle.decls),
                                       device=dev), cfg)
    adamw_update(p_c, g_c, init_params(adamw_init_decls(bundle.decls),
                                       device=cpu), cfg)
    pg, pc = _leaves(p_g), _leaves(p_c)
    p_err, loose, n = 0.0, 0, 0
    for k in pc:
        a, b = pg[k].cpu(), pc[k]
        err = (a - b).abs()
        bad = err > 1e-6 + 1e-5 * b.abs()
        if (gc_[k][bad].abs() >= 1e-5).any() or err.max() > 2 * lr + 1e-6:
            raise AssertionError(f"[15] parameter {k} after AdamW: card and "
                                 f"CPU differ by {err.max().item():.3e}")
        loose += int(bad.sum())
        n += b.numel()
        p_err = max(p_err, err.max().item())
    rec = dict(loss_card=float(l_g), loss_cpu=float(l_c),
               grad_norm_card=n_g, grad_norm_cpu=n_c, grad_max_abs_err=grad_err,
               param_max_abs_err=p_err, param_loose=loose, param_count=n,
               first_step_lr=lr, tol=PATH_H_TOL, seconds=time.time() - t0)
    log(f"[15] card vs CPU, one step on 1 x {batch['tokens'].shape[1]} "
        f"tokens at full width: loss {float(l_g):.6f} / {float(l_c):.6f}, "
        f"grad norm {n_g:.6f} / {n_c:.6f}, gradient leaves max |err| "
        f"{grad_err:.3e} (tol {PATH_H_TOL}); parameters after AdamW max "
        f"|err| {p_err:.3e}, {loose} of {n} past 1e-6 + 1e-5 |p| (CPU "
        f"gradient under 1e-5; bound 2 lr = {2 * lr:.1e}) "
        f"({rec['seconds']:.1f} s)")
    del p_g, g_g, gg
    return rec


def _path_h_remat(arch, state, batch, cfg):
    """One step (gradients, then AdamW) with remat as the arch says and
    one with ``remat=False``, each from a copy of ``state``: the first
    call of each gives its peak memory over what was resident, the copy
    of the state included (the allocator's cache emptied before it), loss
    and gradients compared;
    then two more of each in turns (arch, off, off, arch), timed with CUDA
    events on a warm cache."""
    import dataclasses
    import torch
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel.sharding import ShardingCtx
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.steps import value_and_grad
    bundles = {arch.remat_policy: build_model(arch, ShardingCtx()),
               "off": build_model(dataclasses.replace(arch, remat=False),
                                  ShardingCtx())}

    def step(label, p, o):
        e0, e1 = _events()
        e0.record()
        loss, g = value_and_grad(bundles[label].loss, p, batch)
        adamw_update(p, g, o, cfg)
        e1.record()
        e1.synchronize()
        return loss, g, e0.elapsed_time(e1)

    def copies():
        p, o = _clone(state["params"]), _clone(state["opt"])
        torch.cuda.synchronize()
        return p, o

    rows, grads = {}, {}
    for label in bundles:
        p, o = copies()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()     # the copies included
        torch.cuda.reset_peak_memory_stats()
        loss, g, _ = step(label, p, o)
        rows[label] = dict(peak_over_resident=torch.cuda.max_memory_allocated()
                           - resident, loss=float(loss), ms_all=[])
        grads[label] = (loss, g)
        del p, o
    labels = list(bundles)
    for label in labels + labels[::-1]:
        rows[label]["ms_all"].append(step(label, *copies())[2])
    for label in labels:
        rows[label]["ms"] = sorted(rows[label]["ms_all"])[0]
    (l0, g0), (l1, g1) = grads.values()
    err, equal = abs(float(l0) - float(l1)), torch.equal(l0, l1)
    for k, x in _leaves(g0).items():
        y = _leaves(g1)[k]
        e = (x - y).abs().max().item()
        if e > PATH_H_REMAT_TOL * (1 + y.abs().max().item()):
            raise AssertionError(f"[15] remat {arch.remat_policy} vs off: "
                                 f"gradient {k} differs by {e:.3e}")
        err, equal = max(err, e), equal and torch.equal(x, y)
    rows.update(max_abs_err=err, bit_equal=equal, tol=PATH_H_REMAT_TOL)
    r, o = rows[arch.remat_policy], rows["off"]
    log(f"[15] one step, remat {arch.remat_policy!r} / off, in turns: "
        f"{', '.join(f'{t:.2f}' for t in r['ms_all'])} / "
        f"{', '.join(f'{t:.2f}' for t in o['ms_all'])} ms; peak over "
        f"resident {r['peak_over_resident'] / 1e9:.3f} / "
        f"{o['peak_over_resident'] / 1e9:.3f} GB; loss and gradients max "
        f"|err| {err:.3e} (tol {PATH_H_REMAT_TOL}), bit-equal {equal}")
    return rows


def _path_h_checkpoint(arch, state, ckpt_dir, cursor):
    """``launch.serve --ckpt-dir`` on the trainer's checkpoint, then the
    state saved and restored, timed, under ``build/``: the restored
    leaves equal bit for bit, and served, the tokens of the in-memory
    parameters."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.serve.engine import ServeEngine
    dev = state["params"]["emb"].device
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         arch.name, "--ckpt-dir", str(ckpt_dir), "--batch", "8",
         "--prompt-len", "64", "--new", "8"],
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")), cwd=REPO,
        capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"[15] launch.serve --ckpt-dir failed: "
                             f"{r.stdout[-2000:]}{r.stderr[-3000:]}")
    serve_s = time.time() - t0
    shutil.rmtree(ckpt_dir)
    free = shutil.disk_usage(REPO / "build").free
    full = dict(params=state["params"], opt=state["opt"], data=cursor)
    n_bytes = sum(v.numel() * v.element_size()
                  for v in _leaves(full).values() if hasattr(v, "numel"))
    log(f"[15] checkpoint: {n_bytes / 1e9:.3f} GB of state, "
        f"{free / 1e9:.1f} GB free under build/")
    step = PATH_H_STEPS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = save_checkpoint(ckpt_dir, step, full)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back_step, back = restore_checkpoint(ckpt_dir, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    file_bytes = path.stat().st_size
    assert back_step == step
    a, b = _leaves(full), _leaves(back)
    assert set(a) == set(b), set(a) ^ set(b)
    for k, v in a.items():
        if not torch.is_tensor(v):                    # the cursor: numpy
            v = torch.as_tensor(np.asarray(v)).to(dev)
        if not (b[k].dtype == v.dtype and torch.equal(b[k], v)):
            raise AssertionError(f"[15] restored {k} differs")
    assert b["opt/step"].dtype == torch.int32
    assert b["data/seed"].dtype == b["data/step"].dtype == torch.int64
    prompts = np.random.default_rng(15).integers(0, arch.vocab, (8, 64))
    eng = ServeEngine(arch, max_len=64 + 8, device=dev)
    t_mem = eng.generate(state["params"], prompts, n_new=8)
    t_back = eng.generate(back["params"], prompts, n_new=8)
    assert torch.equal(t_mem, t_back), (t_mem, t_back)
    del back
    shutil.rmtree(ckpt_dir)
    rec = dict(state_bytes=n_bytes, file_bytes=file_bytes, free_bytes=free,
               save_s=save_s, restore_s=restore_s,
               save_gb_per_s=file_bytes / save_s / 1e9,
               restore_gb_per_s=file_bytes / restore_s / 1e9,
               serve_ckpt_s=serve_s)
    log(f"[15] checkpoint save {save_s:.2f} s, restore to the card "
        f"{restore_s:.2f} s ({file_bytes / 1e9:.3f} GB file); restored "
        f"leaves bit-equal; served 8 x 64 + 8 greedy tokens equal to the "
        f"in-memory parameters'; launch.serve --ckpt-dir on the trainer's "
        f"checkpoint exit 0 ({serve_s:.1f} s)")
    return rec


def crash_restart_child() -> int:
    """``chip_smoke.py --crash-restart``: with deterministic algorithms
    on (``CUBLAS_WORKSPACE_CONFIG`` set by the caller before CUDA starts),
    the reduced smollm trained 8 steps straight against a run that fails
    at step 6 and resumes from the step-4 checkpoint in a fresh trainer;
    prints a ``crash_restart`` JSON line."""
    sys.path.insert(0, str(REPO / "src"))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    from repro_torch.config import ShapeConfig, get_arch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import (SimulatedFailure, Trainer,
                                           TrainerConfig)
    arch = get_arch(PATH_H_ARCH).reduced()
    shape = ShapeConfig("smoke", 32, 4, "train")
    dev = torch.device("cuda")
    (REPO / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="crash_restart_", dir=REPO / "build"))
    try:
        def cfg(d, **kw):
            return TrainerConfig(
                steps=PATH_H_CRASH["steps"],
                ckpt_every=PATH_H_CRASH["ckpt_every"], ckpt_dir=str(d),
                log_every=100, opt=AdamWConfig(lr=1e-3, warmup_steps=2),
                **kw)
        out_a = Trainer(arch, shape, cfg(root / "a"), device=dev).train()
        try:
            Trainer(arch, shape, cfg(
                root / "b", fail_at_step=PATH_H_CRASH["fail_at_step"]),
                device=dev).train()
            raise AssertionError("the injected failure did not happen")
        except SimulatedFailure:
            pass
        out_b = Trainer(arch, shape, cfg(root / "b"), device=dev).train()
    finally:
        shutil.rmtree(root)
    la = _leaves(dict(params=out_a["params"], opt=out_a["opt"]))
    lb = _leaves(dict(params=out_b["params"], opt=out_b["opt"]))
    unequal = [k for k in la if not torch.equal(la[k], lb[k])]
    err = max((la[k].float() - lb[k].float()).abs().max().item()
              for k in la)
    print("crash_restart " + json.dumps(dict(
        resumed_steps=[h["step"] for h in out_b["history"]],
        leaves=len(la), unequal=unequal, max_abs_diff=err,
        loss_a=out_a["history"][-1]["loss"],
        loss_b=out_b["history"][-1]["loss"])), flush=True)
    return 0 if not unequal else 1


def _path_h_crash_restart():
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), "--crash-restart"],
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"), cwd=REPO,
        capture_output=True, text=True, timeout=600)
    lines = [ln for ln in r.stdout.splitlines()
             if ln.startswith("crash_restart ")]
    if r.returncode != 0 or not lines:
        raise AssertionError(f"[15] crash / restart: exit {r.returncode}: "
                             f"{r.stdout[-2000:]}{r.stderr[-3000:]}")
    rec = json.loads(lines[-1][len("crash_restart "):])
    rec["seconds"] = time.time() - t0
    assert rec["resumed_steps"] == [4, 5, 6, 7], rec
    log(f"[15] crash at step {PATH_H_CRASH['fail_at_step']} and resume "
        f"from the step-4 checkpoint (reduced smollm, deterministic "
        f"algorithms): {rec['leaves']} parameter and moment leaves "
        f"bit-equal to the straight run ({rec['seconds']:.1f} s)")
    return rec


def _path_h_three_factor(arch, params0, shape):
    """The three-factor readout trainer on the frozen initial parameters
    at full width: 10 steps timed, one under sync-debug "error", the
    codes' range, one step on a 1 x 512 sub-batch against the CPU with
    the card's Gumbel draws injected."""
    import torch
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.plasticity.three_factor import (HybridReadoutTrainer,
                                                     PlasticState,
                                                     sample_gumbel)
    dev = params0["emb"].device
    cpu = torch.device("cpu")
    tr = HybridReadoutTrainer(arch, device=dev)
    pipe = SyntheticLMPipeline(arch, shape, seed=0)
    batches = [pipe.next_batch(dev) for _ in range(11)]
    st = tr.init_state(torch.Generator(dev).manual_seed(1))
    st, _ = tr.step(params0, st, batches[0])                  # warm-up
    times, rewards = [], []
    for b in batches[1:]:
        e0, e1 = _events()
        e0.record()
        st, m = tr.step(params0, st, b)
        e1.record()
        times.append((e0, e1))
        rewards.append(m["reward"])
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in times)
    rewards = [float(r) for r in rewards]
    m_zero = st.w_q.abs().max()
    # from zero codes the readout samples uniformly over 49,152 tokens and
    # 10 steps move no code: the remaining checks start from random codes
    # and <R> = 0.5, so that every token's modulation is nonzero
    gen = torch.Generator(dev).manual_seed(3)
    st = PlasticState(
        w_q=torch.randint(-tr.wmax, tr.wmax + 1, st.w_q.shape,
                          generator=gen, device=dev).to(torch.int8),
        mean_r=torch.tensor(0.5, device=dev), generator=gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st1, _ = tr.step(params0, st, batches[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert st1.w_q.dtype == torch.int8
    assert int(st1.w_q.abs().max()) == tr.wmax      # saturating writes
    # against the CPU on a 1 x 512 sub-batch, the card's draws injected
    t0 = time.time()
    sub = {k: v[:1] for k, v in batches[1].items()}
    n = sub["labels"].numel()
    g = sample_gumbel(torch.Generator(dev).manual_seed(2),
                      (n, arch.vocab_padded))
    tr_c = HybridReadoutTrainer(arch, device=cpu)
    p_c = _to(params0, cpu)
    st_c = PlasticState(st.w_q.cpu(), st.mean_r.cpu(), torch.Generator())
    w_g, _, m_g = tr.update(params0, st, sub, gumbel=g)
    w_c, _, m_c = tr_c.update(p_c, st_c, _to(sub, cpu), gumbel=g.cpu())

    def samples(trainer, p, s, b, gg):
        with torch.no_grad():
            phi = trainer.bundle.features(p, b, use_remat=False)[0]
            logits = phi.reshape(n, -1) @ (s.w_q.float()
                                           * trainer.pcfg.w_scale)
            logits[:, arch.vocab:] = -1e30
            return logits / trainer.pcfg.temperature + gg
    zg = samples(tr, params0, st, sub, g).cpu()
    zc = samples(tr_c, p_c, st_c, _to(sub, cpu), g.cpu())
    top2 = torch.topk(zc, 2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    flip = zg.argmax(-1) != zc.argmax(-1)
    assert not (flip & (gap >= PATH_H_TOL)).any(), gap[flip]
    # a flipped sample moves dw in its two columns: codes there excluded
    cols = torch.zeros(arch.vocab_padded, dtype=torch.bool)
    cols[zg.argmax(-1)[flip]] = True
    cols[zc.argmax(-1)[flip]] = True
    q = lambda w: torch.clamp(torch.round(w), -tr.wmax, tr.wmax)
    diff = (q(w_g.cpu()) - q(w_c)) * ~cols
    frac = (w_c - torch.floor(w_c) - 0.5).abs()
    assert int(diff.abs().max()) <= 1
    assert (frac[diff != 0] < PATH_H_TOL).all(), frac[diff != 0].max()
    # the update itself (in LSBs) outside the flipped columns
    dw_c = (w_c - st_c.w_q.float())[:, ~cols]
    dw_err = ((w_g.cpu() - w_c)[:, ~cols]).abs().max().item()
    dw_max = dw_c.abs().max().item()
    assert dw_err <= PATH_H_TOL * dw_max, (dw_err, dw_max)
    rec = dict(ms=ms[len(ms) // 2], ms_all=ms, rewards=rewards,
               dw_max_lsb=dw_max, dw_max_abs_err_lsb=dw_err,
               reward_card=float(m_g["reward"]),
               reward_cpu=float(m_c["reward"]), sample_flips=int(flip.sum()),
               code_flips=int((diff != 0).sum()),
               w_q_max_from_zero=int(m_zero),
               cpu_check_s=time.time() - t0, tokens=int(batches[1][
                   "labels"].numel()))
    log(f"[15] three-factor readout at full width, {shape.global_batch} x "
        f"{shape.seq_len} tokens: "
        f"{rec['ms']:.2f} ms a step (median of 10; "
        f"{rec['tokens'] / rec['ms'] * 1e3:.0f} tokens/s), rewards "
        f"{', '.join(f'{r:.4f}' for r in rewards)}, max |w_q| "
        f"{rec['w_q_max_from_zero']} after them; from random codes and <R> "
        f"0.5: one step under sync-debug 'error', saturating at "
        f"{tr.wmax}; vs the CPU on 1 x 512 with the card's draws: update "
        f"max |err| {dw_err:.3e} of {dw_max:.3e} LSB, "
        f"{rec['sample_flips']} sample and {rec['code_flips']} code flips "
        f"at near ties ({rec['cpu_check_s']:.1f} s)")
    return rec


def _path_h_launchers():
    """``launch.train --smoke --steps 5``, adamw and hybrid, as child
    processes on the card at once."""
    t0 = time.time()
    ckpt = Path(tempfile.mkdtemp(prefix="launch_train_", dir=REPO / "build"))
    cmds = {k: [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                PATH_H_ARCH, "--smoke", "--steps", "5", "--ckpt-every", "5",
                "--ckpt-dir", str(ckpt / k), "--trainer", k]
            for k in ("adamw", "hybrid")}
    procs = {k: subprocess.Popen(c, env=dict(os.environ,
                                             PYTHONPATH=str(REPO / "src")),
                                 cwd=REPO, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}
    outs = {}
    try:
        for k, p in procs.items():
            out, err = p.communicate(timeout=600)
            if p.returncode != 0:
                raise AssertionError(f"[15] launch.train --trainer {k} "
                                     f"failed: {out[-2000:]}{err[-3000:]}")
            outs[k] = out.strip().splitlines()[-1]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(ckpt)
    log(f"[15] launch.train --smoke --steps 5 on the card: adamw "
        f"'{outs['adamw']}', hybrid '{outs['hybrid']}' "
        f"({time.time() - t0:.1f} s)")
    return outs


def phase_path_h():
    """Path H, LM training at full smollm-360m width (see the module
    docstring, phase 15). Returns the launch counts of the training run
    (all 0) and the ``train_path_h`` record, which it prints."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.config import ShapeConfig, get_arch
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.parallel.sharding import param_bytes
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    t_phase = time.time()
    dev = torch.device("cuda")
    arch = get_arch(PATH_H_ARCH)
    shape = ShapeConfig(*PATH_H_SHAPE)
    ckpt_dir = REPO / "build" / "ckpt_path_h"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    (REPO / "build").mkdir(exist_ok=True)
    cfg = AdamWConfig(lr=PATH_H_LR, warmup_steps=PATH_H_WARMUP)
    tcfg = TrainerConfig(steps=PATH_H_STEPS, ckpt_every=PATH_H_STEPS,
                         ckpt_dir=str(ckpt_dir), log_every=PATH_H_STEPS,
                         opt=cfg)
    tr = Trainer(arch, shape, tcfg, device=dev)
    n_params = param_bytes(tr.bundle.decls) // 4
    n_tok = shape.global_batch * shape.seq_len
    rec = dict(arch=arch.name, params=n_params, batch=shape.global_batch,
               seq=shape.seq_len, steps=PATH_H_STEPS, lr=PATH_H_LR,
               warmup=PATH_H_WARMUP, remat=arch.remat,
               remat_policy=arch.remat_policy)
    # the initial parameters (the trainer draws the same from its seed):
    # the CPU check and the three-factor trainer start from them
    params0 = tr.init_state()["params"]
    first = SyntheticLMPipeline(arch, shape, seed=0).next_batch(
        torch.device("cpu"))
    rec["cpu"] = _path_h_against_cpu(
        tr.bundle, params0, {k: v[:1] for k, v in first.items()}, cfg)

    # Trainer.train(): each step between CUDA events
    step_fn, ev = tr.step_fn, []

    def timed(*args):
        e0, e1 = _events()
        e0.record()
        out = step_fn(*args)
        e1.record()
        ev.append((e0, e1))
        return out
    tr.step_fn = timed
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.time()
    out = tr.train(resume=False)
    train_s = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    assert not any(launches.values()), launches
    losses = [h["loss"] for h in out["history"]]
    assert all(np.isfinite(losses)) and len(losses) == PATH_H_STEPS, losses
    assert losses[-1] < losses[0], losses
    ms = [a.elapsed_time(b) for a, b in ev]
    step_ms = sorted(ms[1:])[len(ms[1:]) // 2]
    rec.update(losses=losses, step_ms=step_ms, step_ms_all=ms,
               tokens_per_s=n_tok / (step_ms * 1e-3),
               bound_ms=6 * n_params * n_tok / FP32_PEAK * 1e3,
               max_memory_allocated=peak, peak_over_resident=peak - resident,
               train_s=train_s, launches=launches)
    log(f"[15] {arch.name} full width ({n_params / 1e9:.3f} B params), "
        f"Trainer.train() {PATH_H_STEPS} steps of {shape.global_batch} x "
        f"{shape.seq_len}, remat {arch.remat_policy!r}: {step_ms:.2f} ms a "
        f"step (median after the first, {ms[0]:.2f} ms; bound "
        f"{rec['bound_ms']:.2f}), {rec['tokens_per_s']:.0f} tokens/s; peak "
        f"{peak / 1e9:.3f} GB ({(peak - resident) / 1e9:.3f} over the "
        f"resident initial parameters); loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} [{', '.join(f'{x:.3f}' for x in losses)}]; "
        f"none of the eight kernels launched ({train_s:.1f} s)")

    state = dict(params=out["params"], opt=out["opt"])
    batch = SyntheticLMPipeline(arch, shape, seed=0).next_batch(dev)
    rec["remat"] = _path_h_remat(arch, state, batch, cfg)

    def one_step():
        step_fn(state["params"], state["opt"], {}, batch)
    summ = _traced(one_step, "path_h_step", 1)
    if summ is None:
        log("[15] profiler: the trace holds no device time")
    else:
        w, bz = summ["window_us"], summ["busy_us"]
        top = sorted(summ["by_name"].items(), key=lambda kv: -kv[1][0])[:6]
        rec.update(trace_step_ms=w / 1e3, trace_busy_share=bz / w,
                   trace_kernels=summ["kernels_per_trial"],
                   trace_top=[[k, t / 1e3, c] for k, (t, c) in top])
        log(f"[15] profiler, one training step: {w / 1e3:.2f} ms, device "
            f"busy {bz / w:.4f} of it, {summ['kernels_per_trial']:.0f} "
            f"kernels; by time: "
            + "; ".join(f"{k} {t / 1e3:.3f} ({c})" for k, (t, c) in top))

    rec["checkpoint"] = _path_h_checkpoint(arch, state,
                                           ckpt_dir, tr.pipeline.state_dict())
    del state, out, batch
    torch.cuda.empty_cache()
    rec["crash_restart"] = _path_h_crash_restart()
    rec["three_factor"] = _path_h_three_factor(arch, params0, shape)
    rec["launch_train"] = _path_h_launchers()
    rec["phase_s"] = time.time() - t_phase
    log(f"[15] path H wall time {rec['phase_s']:.1f} s")
    print("train_path_h " + json.dumps(rec), flush=True)
    return launches, rec


# path I: the LM on a device mesh (DTensor placement by the logical-axis
# rules). One card: a world of 1 (NCCL takes one card a rank) and a 1 x 1
# mesh, on which every placement is Replicate() and every redistribute a
# no-op, so the mesh must give path G's tokens and path H's losses bit for
# bit; what it adds is DTensor's dispatch on the host
PATH_I_STEPS, PATH_I_REPS = 3, 2


def _path_i_serve(ctx, rec):
    """qwen1.5-0.5b at full width served with and without the mesh on the
    same parameters and path G's prompts (8 x 128, 32 greedy new tokens),
    timed in turns (CUDA events, ``PhaseTimer``): tokens equal, prefill
    ms, decode ms a token; a trace of 4 decode steps under the mesh."""
    import numpy as np
    import torch
    from repro_torch.config import get_arch
    from repro_torch.obs.timing import PhaseTimer
    from repro_torch.parallel.sharding import place_tree
    from repro_torch.serve.engine import ServeEngine
    dev = torch.device("cuda")
    arch = get_arch(PATH_G_ARCH)
    params, n_bytes = _lm_params(arch, dev, seed=0)
    prompts = np.random.default_rng(21).integers(
        0, arch.vocab, (PATH_G_B, PATH_G_PROMPT[PATH_G_ARCH]))
    max_len = prompts.shape[1] + PATH_G_NEW
    engs = dict(plain=ServeEngine(arch, max_len=max_len, device=dev),
                mesh=ServeEngine(arch, ctx, max_len=max_len))
    placed = place_tree(params, engs["mesh"].bundle.decls, ctx)
    held = dict(plain=params, mesh=placed)
    timers = {k: PhaseTimer(dev) for k in engs}
    outs = {}
    for k, e in engs.items():
        e.generate(held[k], prompts[:, :8], n_new=2)          # warm-up
    for _ in range(PATH_I_REPS):
        for k in ("plain", "mesh", "mesh", "plain"):
            outs[k] = engs[k].generate(held[k], prompts, n_new=PATH_G_NEW,
                                       timer=timers[k])
    if not torch.equal(outs["plain"], outs["mesh"]):
        diff = (outs["plain"] != outs["mesh"]).nonzero()
        r, c = (int(v) for v in diff[0])
        raise AssertionError(
            f"[16] qwen tokens under the mesh differ from path G's: first at "
            f"request {r}, new token {c} ({int(outs['mesh'][r, c])} vs "
            f"{int(outs['plain'][r, c])}); {len(diff)} of {outs['mesh'].numel()}")
    med = {k: {n: sorted(v)[len(v) // 2] * 1e3 for n, v in t.samples.items()}
           for k, t in timers.items()}
    for k in engs:
        rec[f"prefill_ms_{k}"] = med[k]["prefill"]
        rec[f"decode_ms_per_token_{k}"] = med[k]["decode"] / PATH_G_NEW
    rec["tokens_equal"] = True
    rec["serve_params_bytes"] = n_bytes
    summ = _decode_trace(arch, placed, prompts, ctx=ctx, name="path_i")
    if summ is not None:
        w, bz = summ["window_us"], summ["busy_us"]
        top = sorted(summ["by_name"].items(), key=lambda kv: -kv[1][0])[:6]
        rec.update(trace_step_ms=w / 1e3 / 4, trace_busy_share=bz / w,
                   trace_kernels_per_step=summ["kernels_per_trial"],
                   trace_top=[[k, t / 1e3, c] for k, (t, c) in top])
    log(f"[16] {PATH_G_ARCH} full width on the 1 x 1 mesh: the {PATH_G_B} x "
        f"{PATH_G_NEW} tokens equal path G's; prefill "
        f"{rec['prefill_ms_mesh']:.3f} ms (no mesh "
        f"{rec['prefill_ms_plain']:.3f}), decode "
        f"{rec['decode_ms_per_token_mesh']:.4f} ms a token (no mesh "
        f"{rec['decode_ms_per_token_plain']:.4f}), in turns"
        + ("" if summ is None else
           f"; a traced mesh decode step {rec['trace_step_ms']:.3f} ms, "
           f"{rec['trace_kernels_per_step']:.1f} kernels, device busy "
           f"{rec['trace_busy_share']:.4f}"))
    del params, placed, held, engs
    torch.cuda.empty_cache()


def _path_i_train(ctx, rec):
    """smollm-360m at full width, 8 x 512: ``PATH_I_STEPS`` steps of
    ``Trainer.train()`` without and with the mesh, in turns (twice each,
    each step between CUDA events): losses equal; step ms. The mesh run
    checkpoints its last step (gathered): restored without a mesh and
    onto the mesh, every leaf equal to the trained state bit for bit."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.config import ShapeConfig, get_arch
    from repro_torch.parallel.sharding import full
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    dev = torch.device("cuda")
    arch = get_arch(PATH_H_ARCH)
    shape = ShapeConfig(*PATH_H_SHAPE)
    ckpt = REPO / "build" / "ckpt_path_i"
    losses, ms = {}, {"plain": [], "mesh": []}
    for k in ("plain", "mesh", "mesh", "plain"):
        shutil.rmtree(ckpt, ignore_errors=True)
        tcfg = TrainerConfig(
            steps=PATH_I_STEPS, ckpt_every=PATH_I_STEPS, ckpt_dir=str(ckpt),
            log_every=PATH_I_STEPS,
            opt=AdamWConfig(lr=PATH_H_LR, warmup_steps=PATH_H_WARMUP))
        tr = (Trainer(arch, shape, tcfg, ctx) if k == "mesh"
              else Trainer(arch, shape, tcfg, device=dev))
        step_fn, ev = tr.step_fn, []

        def timed(*args, step_fn=step_fn, ev=ev):
            e0, e1 = _events()
            e0.record()
            out = step_fn(*args)
            e1.record()
            ev.append((e0, e1))
            return out
        tr.step_fn = timed
        out = tr.train(resume=False)
        torch.cuda.synchronize()
        ms[k] += [a.elapsed_time(b) for a, b in ev[1:]]
        got = [h["loss"] for h in out["history"]]
        assert np.isfinite(got).all(), (k, got)
        assert losses.setdefault(k, got) == got, (k, losses[k], got)
        if k == "mesh" and "restored" not in rec:
            state = dict(params=out["params"], opt=out["opt"])
            _, plain = restore_checkpoint(ckpt, device=dev)
            _, placed = restore_checkpoint(ckpt, shardings=tr.shardings())
            n = 0
            for part in ("params", "opt"):
                for key, x in _leaves(state[part]).items():
                    want = full(x)
                    assert torch.equal(_get(plain[part], key), want), key
                    y = _get(placed[part], key)
                    assert tuple(y.placements) == tuple(x.placements), key
                    assert torch.equal(full(y), want), key
                    n += 1
            rec["restored"] = n
        del tr, out
        torch.cuda.empty_cache()
    if losses["mesh"] != losses["plain"]:
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["mesh"],
                                                      losses["plain"]))
        raise AssertionError(f"[16] smollm losses under the mesh "
                             f"{losses['mesh']} vs {losses['plain']} "
                             f"(max rel {rel:.3e})")
    for k in ms:
        rec[f"step_ms_{k}"] = sorted(ms[k])[len(ms[k]) // 2]
    rec["losses"] = losses["mesh"]
    log(f"[16] {PATH_H_ARCH} full width, {shape.global_batch} x "
        f"{shape.seq_len}, {PATH_I_STEPS} steps on the 1 x 1 mesh: losses "
        f"equal no mesh's bit for bit ({', '.join(f'{x:.4f}' for x in losses['mesh'])}); "
        f"{rec['step_ms_mesh']:.2f} ms a step (no mesh "
        f"{rec['step_ms_plain']:.2f}, in turns); the mesh's checkpoint "
        f"restored without a mesh and onto it, {rec['restored']} leaves bit "
        f"for bit")


def _get(tree, key):
    for k in key.split("/"):
        tree = tree[k]
    return tree


def phase_path_i():
    """Path I, the LM on a device mesh (see the module docstring, phase
    16). Returns the launch counts of the path (all 0) and prints the
    ``mesh_path_i`` record."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.parallel.sharding import ShardingCtx
    assert torch.backends.cuda.matmul.allow_tf32 is False
    t_phase = time.time()
    torch.cuda.set_device(0)
    (REPO / "build").mkdir(exist_ok=True)
    store = REPO / "build" / "path_i_store"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        ctx = ShardingCtx(mesh=make_smoke_mesh((1, 1), device_type="cuda"))
        rec = dict(mesh=[1, 1], torch=torch.__version__)
        kernels.reset_launches()
        _path_i_serve(ctx, rec)
        _path_i_train(ctx, rec)
        launches = dict(kernels.LAUNCHES)
    finally:
        dist.destroy_process_group()
    assert not any(launches.values()), launches
    rec["launches"] = launches
    rec["phase_s"] = time.time() - t_phase
    log(f"[16] path I wall time {rec['phase_s']:.1f} s; none of the eight "
        f"kernels launched")
    print("mesh_path_i " + json.dumps(rec), flush=True)
    return launches


# path J: launch and analysis. The BSS-2 fleet cell for the four shapes on
# both production meshes, on the card; the LM dry run on a fake world in
# a child (these cells on 16 x 16, under the time limit); the
# roofline of what phases 14 and 15 ran
PATH_J_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
PATH_J_KERNELS = ("stp_scan", "synray", "synray_sparse", "neuron_scan",
                  "corr")
PATH_J_DRYRUN = (("qwen1.5-0.5b", "train_4k"), ("qwen1.5-0.5b", "decode_32k"),
                 ("moonshot-v1-16b-a3b", "decode_32k"))
PATH_J_DRYRUN_TIMEOUT, PATH_J_PAIRS = 600, 5


def _report_line(rep):
    return (f"{rep.flops_per_dev / 1e9:.4f} GFLOP, "
            f"{rep.hbm_bytes_per_dev / 1e6:.3f} MB HBM, "
            f"{rep.transcendentals / 1e6:.4f} M transcendentals, "
            f"collectives {json.dumps(rep.coll)}; t_compute "
            f"{rep.t_compute * 1e3:.6f} ms, t_memory "
            f"{rep.t_memory * 1e3:.6f} ms, t_collective "
            f"{rep.t_collective * 1e3:.6f} ms -> {rep.bottleneck}, step "
            f"{rep.step_time * 1e3:.6f} ms; arg {rep.arg_bytes / 1e6:.3f} MB, "
            f"temp {rep.temp_bytes / 1e6:.3f} MB, out "
            f"{rep.out_bytes / 1e6:.3f} MB")


def _same_counts(a, b):
    """The recorded work of two recorders (the card's and the CPU's)."""
    keys = ("flops", "transcendentals", "total_write", "kernels", "coll")
    return {k: getattr(a, k) for k in keys} == {k: getattr(b, k)
                                                for k in keys} \
        and dict(a.by_kind) == dict(b.by_kind)


def _path_j_time(shape, mesh_cfg):
    """The rank's part of the cell (the local fleet x the rank's columns)
    as a ``TrialGraph`` replay and eager, and the whole chips' trial (the
    local fleet's full 512 columns) as a replay, in turns (the order
    rotated each round), CUDA-event timed; returns the medians and the
    times."""
    import numpy as np
    import torch
    from repro_torch.core.hybrid import (TrialGraph, TrialLoop,
                                         bss2_cell_experiment)
    stim = torch.tensor(1, dtype=torch.int32, device="cuda")

    def graph_of(**kw):
        init, trial, _, draws, _ = bss2_cell_experiment(shape, mesh_cfg,
                                                        "cuda", **kw)
        state, _ = trial(init(), stim, draws.events[0], draws.xi[0])
        loop = TrialLoop(trial, state, [1, 1], draws)
        return loop, TrialGraph(loop), trial, state, draws
    part, whole = graph_of(), graph_of(whole=True)
    runs = {"replay": part[1].replay,
            "eager": lambda: part[2](part[3], stim, part[4].events[1],
                                     part[4].xi[1]),
            "whole_replay": whole[1].replay}
    kinds = list(runs)
    times = {k: [] for k in kinds}
    for i in range(PATH_J_PAIRS):
        for kind in kinds[i % 3:] + kinds[:i % 3]:
            part[0].reset()
            whole[0].reset()
            a, b = _events()
            a.record()
            runs[kind]()
            b.record()
            b.synchronize()
            times[kind].append(a.elapsed_time(b))
    del part, whole, runs
    torch.cuda.empty_cache()
    return {k: float(np.median(v)) for k, v in times.items()}, times


def _cell_work(shape, mesh_cfg):
    """Each kernel's bytes a call in the cell's recorded trial, from its
    ``work`` at the cell's own shapes: the local fleet, 256 rows (a Dale
    half of 128, read in place at a stride of 2), the rank's columns, T =
    128; the gated pair as the larger of its two routes
    (``cost.larger``, what ``cost.gate_call`` counts), at the capacities
    the whole chip plans."""
    from repro_torch.analysis import cost
    from repro_torch.configs.bss2 import BSS2
    from repro_torch.core import synapse
    from repro_torch.core.hybrid import bss2_cell_fleet
    from repro_torch.kernels.corr import ops as corr_ops
    from repro_torch.kernels.neuron_scan import ops as neuron_ops
    from repro_torch.kernels.stp_scan import ops as stp_ops
    from repro_torch.kernels.synray import ops as synray_ops
    from repro_torch.kernels.synray_sparse import ops as sparse_ops
    _, n, c = bss2_cell_fleet(shape, mesh_cfg)
    T, R, H = 128, BSS2.n_rows, BSS2.n_rows // 2
    _, me, kc = synapse.route_plan(T, H, BSS2.n_cols, const_addr=True)
    pair = {"synray_sparse": sparse_ops.work_window(T, n, H, c, me, kc, 2),
            "synray": synray_ops.work(T, n, H, c)}
    gated = cost.larger(pair)
    return {"stp_scan": stp_ops.work(T, n, R, census=True).bytes,
            gated: pair[gated].bytes,
            "neuron_scan": neuron_ops.work(T, n, c).bytes,
            "corr": corr_ops.work(T, n, R, c).bytes}


def _path_j_parts(shape, mesh_cfg):
    """The local fleet's column parts (``bss2_cell_experiment(part=p)``)
    run in turn on the card, two trials each, against the whole chips'
    trials (``whole=True``): each output that holds columns (spikes, the
    metrics: reward, mean reward, rates, eligibility, ``w_signed``; the
    state: 6-bit weights, ``w_signed``, the neuron, sensor and counter
    planes) concatenated over the parts in column order, bit for bit;
    each that holds rows (the STP resources, the sensors' pre traces)
    and the route counts equal on every part. Returns ``(parts, outputs
    compared, route counts)``."""
    import torch
    from repro_torch.core import synapse
    from repro_torch.core.hybrid import (_leaves, bss2_cell_experiment,
                                         bss2_cell_fleet)
    _, _, c = bss2_cell_fleet(shape, mesh_cfg)
    stim = torch.tensor(1, dtype=torch.int32, device="cuda")

    def run(**kw):
        init, trial, meta, draws, _ = bss2_cell_experiment(
            shape, mesh_cfg, "cuda", **kw)
        core, core_run = meta["core"], meta["core"].run
        spikes = []

        def spy(*args, **kwargs):
            cs, out = core_run(*args, **kwargs)
            spikes.append(out["spikes"])
            return cs, out
        core.run = spy
        synapse.reset_route_counts()
        state, outs = init(), []
        for i in range(2):
            state, m = trial(state, stim, draws.events[i], draws.xi[i])
            outs += [(f"{k}[{i}]", m[k]) for k in sorted(m)]
        outs += [(f"spikes[{i}]", x) for i, x in enumerate(spikes)]
        outs += [(f"state.{i}", x) for i, x in enumerate(_leaves(state))]
        return outs, synapse.route_counts("cuda").tolist()

    whole, routes = run(whole=True)
    parts = [run(part=p) for p in range(512 // c)]
    torch.cuda.synchronize()
    compared = 0
    for j, (name, w) in enumerate(whole):
        got = [outs[j][1] for outs, _ in parts]
        if got[0].shape == w.shape:
            same = all(torch.equal(x, w) for x in got)
        else:
            same = torch.equal(torch.cat(got, -1), w)
            compared += 1
        if not same:
            raise AssertionError(f"path J: the {len(parts)} column parts' "
                                 f"{name} differ from the whole chips'")
    bad = [r for _, r in parts if r != routes]
    n_spikes = sum(float(x.sum()) for n, x in whole if n.startswith("spikes"))
    if bad or n_spikes == 0:
        raise AssertionError(f"path J: the parts' routes {bad} against the "
                             f"whole chips' {routes}, or no spike")
    return len(parts), compared, routes


def _path_j_dryrun():
    """The LM cells of ``PATH_J_DRYRUN`` through ``python -m
    repro_torch.launch.dryrun`` in a child (a fake process group is the
    process's own), under the time limit. Returns their records."""
    out = REPO / "build" / "path_j_dryrun.json"
    out.unlink(missing_ok=True)
    t0 = time.time()
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    for arch, shape in PATH_J_DRYRUN:
        left = PATH_J_DRYRUN_TIMEOUT - (time.time() - t0)
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out", str(out)],
            cwd=REPO, env=env, capture_output=True, text=True,
            timeout=max(left, 1))
        for line in proc.stdout.splitlines():
            if line.startswith(("[OK]", "[FAIL]", "      memory")):
                log(f"[17] dryrun {line.strip()}")
        if proc.returncode != 0:
            raise AssertionError(f"dryrun {arch}/{shape}: exit "
                                 f"{proc.returncode}\n{proc.stdout[-2000:]}"
                                 f"\n{proc.stderr[-3000:]}")
    recs = json.loads(out.read_text())
    log(f"[17] dryrun of {len(PATH_J_DRYRUN)} cells on a fake 256-rank "
        f"world: {time.time() - t0:.1f} s")
    return recs


def phase_path_j(smi, rec_g, rec_h):
    """Path J, launch and analysis (see the module docstring, phase 17).
    Returns the launch counts of the BSS-2 cells and prints the
    ``roofline_path_j`` record."""
    import torch
    from repro_torch import kernels
    from repro_torch.config import HW, SHAPES, MeshConfig, ShapeConfig
    from repro_torch.core.hybrid import bss2_cell_fleet, trace_bss2_cell
    from repro_torch.launch import dryrun
    t_phase = time.time()
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"[17] the card's memory {total} bytes ({total / 1e9:.3f} GB); "
        f"HW.hbm_bytes {HW.hbm_bytes} (data sheet)")
    rec = dict(total_memory=total, hbm_bytes=HW.hbm_bytes, bss2={})
    kernels.reset_launches()
    traced = {}
    for multi in (False, True):
        for s in PATH_J_SHAPES:
            traced[s, multi] = trace_bss2_cell(SHAPES[s], MeshConfig(multi),
                                               "cuda")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    missing = [k for k in PATH_J_KERNELS if not launches[k]]
    if missing or launches["census"]:
        raise AssertionError(f"path J launched no {missing} or a census "
                             f"kernel: {launches}")
    log(f"[17] the BSS-2 cell on 4 shapes x 2 meshes (a warm-up and a "
        f"recorded trial each): launches {launches}")

    # the card's count against the CPU's (the plain versions), 16 x 16
    rep_g, rec_gpu, n16 = traced["train_4k", False]
    rep_c, rec_cpu, _ = trace_bss2_cell(SHAPES["train_4k"], MeshConfig(False),
                                        "cpu")
    if not _same_counts(rec_gpu, rec_cpu):
        diff = {k: (rec_gpu.by_kind.get(k), rec_cpu.by_kind.get(k))
                for k in set(rec_gpu.by_kind) | set(rec_cpu.by_kind)
                if rec_gpu.by_kind.get(k) != rec_cpu.by_kind.get(k)}
        raise AssertionError(
            f"path J: the card counts {rec_gpu.summary()}, the CPU "
            f"{rec_cpu.summary()}; by kind (card, CPU) {diff}")
    _, _, n_cols = bss2_cell_fleet(SHAPES["train_4k"], MeshConfig(False))
    log(f"[17] bss2/train_4k/16x16, {n16} instances x {n_cols} columns (a "
        f"rank's part): the card's count "
        f"equals the CPU's: {rec_gpu.flops:.0f} FLOP, {rec_gpu.hbm_rw:.0f} "
        f"HBM bytes, {rec_gpu.transcendentals:.0f} transcendentals, "
        f"{len(rec_gpu.kernels)} kernels ({len(rec_gpu.ops)} ops on the card, "
        f"{len(rec_cpu.ops)} on the CPU)")
    # each kernel's bytes a call: its ``work`` at each cell's own shapes
    for (s, multi), (_, r, _) in traced.items():
        want = _cell_work(SHAPES[s], MeshConfig(multi))
        got = {n: k["bytes"] / k["count"] for n, k in r.kernels.items()}
        if got != want:
            raise AssertionError(f"path J {s} (multi-pod {multi}): the "
                                 f"kernels count {got} bytes a call, their "
                                 f"work at the cell's shapes {want}")
    log("[17] counted bytes a call equal to each kernel's work at the "
        "cell's shapes (8 cells); train_4k 16 x 16: "
        + ", ".join(f"{n} {k['bytes'] / k['count']:.0f}"
                    for n, k in rec_gpu.kernels.items()))

    # the local fleet's column parts in turn against the whole chips
    n_parts, compared, routes = _path_j_parts(SHAPES["train_4k"],
                                              MeshConfig(False))
    log(f"[17] bss2/train_4k/16x16: the {n_parts} column parts of {n16} "
        f"instances, run in turn, equal the whole chips' two trials bit "
        f"for bit ({compared} outputs concatenated; routes {routes} on "
        f"every part)")
    rec["parts"] = dict(n_parts=n_parts, compared=compared, routes=routes)

    for (s, multi), (rep, r, n_local) in traced.items():
        mesh_cfg = MeshConfig(multi)
        med, times = _path_j_time(SHAPES[s], mesh_cfg)
        ratio = med["replay"] / (rep.step_time * 1e3)
        key = f"bss2/{s}/{rep.mesh}"
        rec["bss2"][key] = dict(
            n_local=n_local, n_cols=n_cols, report=rep.to_dict(),
            kernels=r.kernels, replay_ms=med["replay"],
            eager_ms=med["eager"], whole_replay_ms=med["whole_replay"],
            times=times, measured_over_roofline=ratio)
        log(f"[17] {key} ({n_local} local instances x {n_cols} columns): "
            f"{_report_line(rep)}; kernels "
            + ", ".join(f"{n} x{k['count']}" for n, k in r.kernels.items())
            + f"; part replay {med['replay']:.4f} ms, part eager "
            f"{med['eager']:.4f} ms, whole-chip replay "
            f"{med['whole_replay']:.4f} ms a trial (in turns; {smi}); "
            f"part replay / roofline = {ratio:.2f} ({rep.bottleneck}-bound)")

    rec["dryrun"] = _path_j_dryrun()
    for key, r in rec["dryrun"].items():
        if r["status"] != "OK":
            raise AssertionError(f"dryrun {key}: {r.get('error')}")
        log(f"[17] dryrun {key}: t_compute {r['t_compute'] * 1e3:.4f} ms, "
            f"t_memory {r['t_memory'] * 1e3:.4f} ms, t_collective "
            f"{r['t_collective'] * 1e3:.4f} ms -> {r['bottleneck']}, "
            f"useful {r['useful_flops_ratio']:.4f}, MFU@roofline "
            f"{r['mfu']:.4%}, fits {HW.hbm_bytes / 1e9:.0f} GB: "
            f"{r['fits_hbm']}")

    # the roofline of what the card ran, on a world of one
    mine = {}
    shape_h = ShapeConfig(*PATH_H_SHAPE)
    shape_g = ShapeConfig("path_g_decode",
                          PATH_G_PROMPT[PATH_G_ARCH] + PATH_G_NEW, PATH_G_B,
                          "decode")
    for label, arch, shape, measured in (
            ("path H step", PATH_H_ARCH, shape_h, rec_h["step_ms"]),
            ("path G decode step", PATH_G_ARCH, shape_g,
             rec_g["main"]["decode_ms_per_token"])):
        rep, _ = dryrun.trace_cell(arch, shape, False,
                                   compute_dtype=torch.float32,
                                   world_of_one=True)
        ratio = measured / (rep.step_time * 1e3)
        mine[label] = dict(report=rep.to_dict(), measured_ms=measured,
                           measured_over_roofline=ratio)
        log(f"[17] {label} ({arch}, {shape.global_batch} x "
            f"{shape.seq_len}, f32, one card): roofline {_report_line(rep)}; "
            f"measured {measured:.4f} ms, {ratio:.2f}x the roofline step")
    rec["one_card"] = mine
    rec["launches"] = launches
    rec["phase_s"] = time.time() - t_phase
    log(f"[17] path J wall time {rec['phase_s']:.1f} s")
    print("roofline_path_j " + json.dumps(rec), flush=True)
    return launches


def main() -> int:
    if sys.argv[1:] == ["--crash-restart"]:
        return crash_restart_child()
    if not (REPO / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.config import HW
    global MEM_BW, FP32_PEAK
    MEM_BW, FP32_PEAK = HW.hbm_bw, HW.peak_flops_fp32

    smi = phase_build()
    rows = phase_kernels()
    counts, state, draws, meta, trial_ms_a, graph_a = phase_main_path()
    counts_w = standalone_window()
    counts_b = phase_path_b(state, draws, meta)
    phase_closed_loop()
    rows["ppuvm_exec"] = phase_ppuvm_kernel(rows["ppu_update"]["ms"])
    counts_c = phase_path_c(trial_ms_a)
    phase_rstdp_program(state, draws, meta)
    phase_vm_loop()
    phase_playback()
    phase_path_d(counts, graph_a)
    counts_e, _, _ = phase_path_e()
    counts_f = phase_path_f()
    rec_g = phase_path_g()
    counts_h, rec_h = phase_path_h()
    counts_i = phase_path_i()
    counts_j = phase_path_j(smi, rec_g, rec_h)

    kernels = []
    for name, (source, replaces) in SRC.items():
        r = rows[name]
        # each kernel's launches from the path that runs it: ppu_update
        # from path B, ppuvm_exec from path C, census from the standalone
        # window (the STP scan takes the emulation's censuses), the others
        # from path A
        n = {"ppu_update": counts_b, "ppuvm_exec": counts_c,
             "census": counts_w}.get(name, counts)[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=n, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            launches_path_a=counts[name],
            launches_path_e=counts_e[name],
            launches_path_f=counts_f[name],
            launches_path_h=counts_h.get(name, 0),
            launches_path_i=counts_i.get(name, 0),
            launches_path_j=counts_j[name],
            **{k: r[k] for k in ("chain_floor_ms", "composed_ms")
               if k in r}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
