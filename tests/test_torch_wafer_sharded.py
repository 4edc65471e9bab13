"""The wafer router's sharded transport on ``torch.distributed``: two gloo
ranks over K = 4 chips, each holding two chips and their out-links, equal
to the local transport bit for bit on the ring (point to point) and on
all2all (all-gather), in every link mode, over and under the link budget,
with link faults and failover forwards; the link screen on a sharded
router equals the local one; a mapped network run through
``mapper.build_runtime(group=)`` (each rank's window loop) equals the
local runtime, its own eager windows and, on a second stimulus, a fresh
runtime, ring and all2all, also with a fault plan;
``run_training(wafer=4, group=)`` equals the local run's slice; a group
that does not divide K raises
(tests/test_wafer.py::test_sharded_transport_matches_local_subprocess and
tests/test_faults.py::test_sharded_link_faults_match_local_subprocess).

The ranks run as two processes of ``tests/_torch_wafer_sharded.py``,
joined through a file store under the test's own temporary directory (no
port, so parallel test workers cannot collide), each with a time limit,
so a hang fails this test instead of stalling the suite.
"""
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
WORLD = 2
TIMEOUT_S = 120


def _run_ranks(tmp_path, *args):
    """Start the two ranks with ``args`` after the store; their exit codes
    and outputs."""
    store = tmp_path / "store"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "_torch_wafer_sharded.py"), str(rank),
         str(WORLD), str(store), *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(WORLD)]
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


def test_sharded_transport_equals_local(tmp_path):
    for rank, (rc, out, err) in enumerate(_run_ranks(tmp_path)):
        assert rc == 0, f"rank {rank}:\n{out[-2000:]}{err[-4000:]}"
        assert f"WAFER_SHARDED_OK rank={rank} cases=18" in out, out + err


def test_sharded_faults_and_training_equal_local(tmp_path):
    """``build_runtime(group=, faults=)`` (dead rows, a hot neuron, a dead
    link; ring and all2all) and ``run_training(wafer=4, group=)`` over 6
    trials (clean and faulted) equal to the local transport's slice:
    spikes, routed grids, link counters, weights and rewards. A group
    without a wafer raises (the reference's ``wafer_ctx`` has no effect
    without one)."""
    for rank, (rc, out, err) in enumerate(_run_ranks(tmp_path, "gloo",
                                                     "gaps")):
        assert rc == 0, f"rank {rank}:\n{out[-2000:]}{err[-4000:]}"
        assert f"WAFER_SHARDED_OK rank={rank} cases=6" in out, out + err
