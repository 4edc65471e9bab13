"""The per-device cost recorder (``repro_torch.analysis.cost``) exactly,
on toys: matrix-product FLOPs, views and writes, collective bytes as the
reference's ``parse_collectives`` counts them, peak temporaries, the
op-log helpers (``analysis.opdebug``), and the kernel entries of a
reduced §5 trial. The fake-world probes (a (16, 16)-sharded matmul, the
functional collectives) run in one subprocess of
``tests/_torch_dryrun.py``: the fake process group is global state."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis.roofline import hbm_bytes_estimate, parse_collectives
from repro_torch.analysis import cost, opdebug
from repro_torch.kernels.corr import ops as corr_ops
from repro_torch.kernels.neuron_scan import ops as neuron_ops
from repro_torch.kernels.stp_scan import ops as stp_ops
from repro_torch.kernels.synray import ops as synray_ops
from test_roofline import FAKE_HLO

HELPER = Path(__file__).resolve().parent / "_torch_dryrun.py"


@pytest.fixture(scope="module")
def fake_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("fake") / "cost.json"
    subprocess.run([sys.executable, str(HELPER), str(out), "matmul",
                    "collectives"], check=True, timeout=300,
                   capture_output=True)
    return json.loads(out.read_text())


def _record(fn, *args):
    with cost.recording() as rec:
        rec.begin(args)
        out = fn(*args)
        rec.end(out)
    return rec, out


@pytest.mark.parametrize("form", ["mm", "bmm", "einsum", "matmul3d"])
def test_matrix_product_flops_are_2mnk(form):
    M, K, N, B = 12, 20, 7, 3
    g = torch.Generator().manual_seed(0)
    a3 = torch.randn(B, M, K, generator=g)
    b3 = torch.randn(B, K, N, generator=g)
    fn, args, n = {
        "mm": (torch.mm, (a3[0], b3[0]), 1),
        "bmm": (torch.bmm, (a3, b3), B),
        "einsum": (lambda a, b: torch.einsum("bmk,bkn->bmn", a, b),
                   (a3, b3), B),
        "matmul3d": (lambda a, b: a @ b, (a3, b3[0]), B),
    }[form]
    rec, _ = _record(fn, *args)
    assert rec.flops == 2 * M * N * K * n
    assert rec.transcendentals == 0


def test_sharded_matmul_counts_its_per_device_share(fake_world):
    """On a fake (16, 16) world a matmul sharded 16 x 16 counts 2MNK/256
    FLOPs per device (the reference docstring's check of
    ``cost_analysis()``, ``repro/analysis/roofline.py:10-11``): one local
    ``mm``, no collective, its [M/16, N/16] output written once and read
    once."""
    from _torch_dryrun import MATMUL
    M, K, N = MATMUL
    r = fake_world["matmul"]
    assert r["flops"] == 2 * M * N * K / 256
    assert r["local"] == [M // 16, N // 16]
    assert r["kinds"] == ["aten.mm"] and r["coll"] == {}
    assert r["hbm_rw"] == 2 * (M // 16) * (N // 16) * 4


def test_views_free_and_outputs_counted_twice():
    x = torch.zeros(64, 32)

    def f(x):
        v = x.view(32, 64).t().unsqueeze(0)[0]      # views: free
        y = x + 1.0                                 # 8 KiB written
        z = y.exp()                                 # a transcendental
        return v, z
    rec, _ = _record(f, x)
    assert rec.total_write == 2 * 64 * 32 * 4
    assert rec.hbm_rw == 4 * 64 * 32 * 4
    assert rec.flops == 64 * 32 and rec.transcendentals == 64 * 32
    assert dict(rec.by_kind) == {"aten.add": 8192.0, "aten.exp": 8192.0}
    assert [r.bytes for r in rec.ops if r.kind != "aten.add"
            and r.kind != "aten.exp"] == [0] * (len(rec.ops) - 2)
    # the reference's model on its own text: entry results once each
    assert hbm_bytes_estimate(FAKE_HLO)["rw"] == 2 * hbm_bytes_estimate(
        FAKE_HLO)["total_write"]


def test_collective_bytes_as_the_reference_parses_them(fake_world):
    """``FAKE_HLO``'s all-gather (bf16[4,2048] -> [64,2048]), all-reduce
    and reduce-scatter (f32[1024,1024] -> [64,1024]) as functional
    collectives on a 16-rank fake group: the same kinds, counts and
    bytes as ``parse_collectives`` reads from the HLO; an all-to-all
    counts its result."""
    ref = parse_collectives(FAKE_HLO)
    got = fake_world["collectives"]["coll"]
    for kind in ("all-gather", "all-reduce", "reduce-scatter"):
        assert got[kind] == ref[kind], kind
    assert got["all-to-all"] == dict(count=1, bytes=64 * 128 * 4)
    assert fake_world["collectives"]["shapes"] == [
        [64, 2048], [1024, 1024], [64, 1024], [64, 128]]


def test_peak_temp_bytes_on_known_lifetimes():
    n = 1024 * 4          # a [1024] float32 tensor

    def f(x):
        a = x * 2.0                     # live: a           (1n)
        b = torch.cat([a, a])           # live: a, b        (3n) <- peak
        del a
        c = b[:1024] + 1.0              # live: b, c        (3n)
        del b
        d = c.view(32, 32)              # a view adds nothing
        return d                        # live: c           (1n)
    x = torch.ones(1024)
    rec, out = _record(f, x)
    assert rec.arg_bytes == n
    assert rec.temp_bytes == 3 * n
    assert rec.out_bytes == n
    # in-place writes to the inputs allocate nothing
    rec, _ = _record(lambda x: x.mul_(2.0).add_(1.0), x)
    assert rec.temp_bytes == 0 and rec.total_write == 2 * n


def test_top_buffers_and_bytes_by_op():
    def f(x):
        big = x.repeat(2, 1)                     # 2 MiB, twice
        big2 = x.repeat(2, 1) + 0.0
        small = x[:8].clone()                    # 16 KiB: under the cut
        return big, big2, small
    x = torch.zeros(512, 512)                    # 1 MiB
    rec, _ = _record(f, x)
    rows = opdebug.top_buffers(rec)
    mib = 1 << 20
    assert rows == [(4 * mib, 2, 2 * mib, "aten.repeat", "f32[1024,512]"),
                    (2 * mib, 1, 2 * mib, "aten.add", "f32[1024,512]")]
    by = dict(opdebug.bytes_by_op(rec))
    assert by["aten.repeat"] == 4 * mib and by["aten.add"] == 2 * mib
    assert by["aten.clone"] == 8 * 512 * 4
    opdebug.print_top_buffers(rec)


def _trial_record(T):
    """One reduced §5 trial (32 x 16, blocked, on the CPU) under the
    recorder, after a warm-up trial."""
    from repro_torch.core import hybrid
    ecfg = hybrid.RSTDPConfig(trial_steps=T)
    init, trial, meta = hybrid.make_experiment(
        ecfg=ecfg, generator=torch.Generator().manual_seed(3),
        backend="blocked", device="cpu")
    d = meta["draw"](torch.Generator().manual_seed(4), [1, 1])
    stim = torch.tensor(1, dtype=torch.int32)
    state, _ = trial(init(), stim, d.events[0], d.xi[0])
    args = (state, stim, d.events[1], d.xi[1])
    rec, _ = _record(trial, *args)
    return rec, meta


def test_reduced_trial_records_each_kernel_once_a_call():
    """Each wrapper call is one entry with the work its ``work`` function
    declares; the plain versions' ops (a loop over the T steps in
    ``stp_scan``, ``neuron_scan`` and ``corr``) are not in the log: the
    trial's other ops are the same at T = 16 and T = 32."""
    rec16, meta = _trial_record(16)
    rec32, _ = _trial_record(32)
    R, C = meta["cfg"].n_rows, meta["cfg"].n_cols
    for T, rec in ((16, rec16), (32, rec32)):
        want = {"stp_scan": (1, stp_ops.work(T, 1, R)),
                "synray": (2, synray_ops.work(T, 1, R // 2, C)),
                "neuron_scan": (1, neuron_ops.work(T, 1, C)),
                "corr": (1, corr_ops.work(T, 1, R, C))}
        assert set(rec.kernels) == set(want)
        for name, (n, w) in want.items():
            assert rec.kernels[name] == dict(
                count=n, flops=n * w.flops, bytes=n * w.bytes,
                transcendentals=n * w.transcendentals), name
        assert sum(r.kind.startswith("repro_torch::") for r in rec.ops) == 5
    ops16 = [r.kind for r in rec16.ops]
    ops32 = [r.kind for r in rec32.ops]
    assert ops16 == ops32
    assert len(ops16) < 200
