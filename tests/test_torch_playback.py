"""Playback co-simulation in the port (paper §2.3, §3.1) against the
reference.

- The port's two backends (the independent NumPy ``RefBackend`` and the
  ``FastBackend`` over ``AnnCore.run`` and ``VectorUnit
  .run_program_fixed``, on the CPU here) reproduce the three golden traces
  ``tests/golden/playback_{rstdp,stdp,homeostasis}.npz``:
  ``compare_traces`` at atol 0.05 (the reference's tolerance for analog
  records), and the ``PPU_W`` / ``WEIGHTS`` records bit for bit.
- Fast against ref, and the port against the reference's own backends, on
  ``tests/test_playback.py``'s programs; a mutated program or weight is
  detected; the trace is timestamped and ordered.
- ``first_divergence`` and the golden programs of ``tests/_torch_ppuvm.py``
  equal the reference's.
"""
import numpy as np
import pytest
import torch

import _torch_ppuvm as corpus
import test_playback as ref_playback
import test_ppuvm_golden as ref_golden
from repro.verif import mismatch as j_mismatch
from repro.verif import playback as j_pb
from repro_torch.ppuvm import isa, programs
from repro_torch.verif import mismatch
from repro_torch.verif import playback as pb

CFG = corpus.golden_cfg()
ATOL = 0.05


def _port_program(ref_program):
    """A reference playback program as the port's instructions (the
    payloads are numpy in both packages)."""
    return [pb.Instr(i.op, i.payload) for i in ref_program]


def _assert_integer_records_equal(trace, golden, ctx):
    for (tg, kg, vg), (_, k, v) in zip(golden, trace):
        if kg in ("PPU_W", "WEIGHTS"):
            np.testing.assert_array_equal(
                v.astype(np.int32), vg.astype(np.int32),
                err_msg=f"{ctx}: {kg}@{tg} not bit-equal to golden")


@pytest.mark.parametrize("backend", ["ref", "fast"])
@pytest.mark.parametrize("rule", sorted(corpus.GOLDEN_RULES))
def test_golden_trace(rule, backend):
    golden = corpus.load_trace(rule)
    tr = pb.execute(corpus.canonical_program(rule), backend, CFG,
                    device="cpu")
    errs = pb.compare_traces(tr, golden, atol=ATOL)
    assert not errs, "\n".join(errs)
    assert [k for _, k, _ in tr].count("PPU_W") == 2
    _assert_integer_records_equal(tr, golden, backend)


@pytest.mark.parametrize("rule", sorted(corpus.GOLDEN_RULES))
def test_golden_program_matches_reference(rule):
    """The jax-free golden program is tests/test_ppuvm_golden.py's, and
    the trace loader reads the same records."""
    ours, theirs = corpus.canonical_program(rule), \
        ref_golden.canonical_program(rule)
    assert [i.op for i in ours] == [i.op for i in theirs]
    for a, b in zip(ours, theirs):
        pa = a.payload if isinstance(a.payload, tuple) else (a.payload,)
        pb_ = b.payload if isinstance(b.payload, tuple) else (b.payload,)
        for x, y in zip(pa, pb_):
            np.testing.assert_array_equal(x, y)
    for (ta, ka, va), (tb, kb, vb) in zip(
            corpus.load_trace(rule),
            ref_golden.load_trace(ref_golden.golden_path(rule))):
        assert (ta, ka) == (tb, kb)
        np.testing.assert_array_equal(va, vb)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fast_matches_ref(seed):
    """tests/test_playback.py's programs: the port's fast backend against
    its NumPy backend and against the reference's fast backend."""
    prog = _port_program(ref_playback._program(seed))
    tr_fast = pb.execute(prog, "fast", CFG, device="cpu")
    tr_ref = pb.execute(prog, "ref", CFG)
    errs = pb.compare_traces(tr_fast, tr_ref, atol=ATOL)
    assert not errs, "\n".join(errs)
    tr_j = j_pb.execute(ref_playback._program(seed), "fast", CFG)
    errs = pb.compare_traces(tr_fast, tr_j, atol=ATOL)
    assert not errs, "\n".join(errs)
    _assert_integer_records_equal(tr_fast, tr_j, "port vs reference")


def test_ref_backend_matches_reference_ref_backend():
    """The copied NumPy backend gives the reference's trace exactly."""
    for prog in (ref_playback._program(0),
                 ref_golden.canonical_program("rstdp")):
        ours = pb.execute(_port_program(prog), "ref", CFG)
        theirs = j_pb.execute(prog, "ref", CFG)
        assert [(t, k) for t, k, _ in ours] == [(t, k) for t, k, _ in theirs]
        for (_, _, a), (_, _, b) in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)


def test_detects_injected_bug():
    prog = _port_program(ref_playback._program(1))
    tr_ref = pb.execute(prog, "ref", CFG)
    bad = list(prog)
    w = prog[0].payload.copy()
    w[3, 4] += 7                      # single-synapse "RTL bug"
    bad[0] = pb.write_weights(w)
    tr_bad = pb.execute(bad, "fast", CFG, device="cpu")
    errs = pb.compare_traces(tr_bad, tr_ref, atol=ATOL)
    assert errs and "WEIGHTS" in errs[0]


def test_detects_program_mutation():
    """A single changed constant in the uploaded program is caught by the
    trace diff, localized to the PPU-VM phase (tests/test_ppuvm.py::
    test_cosim_detects_program_mutation, on its program)."""
    good = programs.rstdp_program(eta=0.5)
    bad = good.copy()
    bad[3] = isa.encode(isa.SPLAT, 2, 0, isa.splat_imm(3.0))  # eta const

    def prog(words):
        p = corpus.canonical_program("rstdp", seed=0)
        p[2] = pb.write_ppu_program(words)
        return p
    tr_good = pb.execute(prog(good), "ref", CFG)
    tr_bad = pb.execute(prog(bad), "fast", CFG, device="cpu")
    errs = pb.compare_traces(tr_good, tr_bad, atol=ATOL)
    assert errs and "phase ppu-vm" in errs[0]
    d = mismatch.first_divergence(tr_good, tr_bad, atol=ATOL)
    assert d.kind == "PPU_W" and d.phase == "ppu-vm"


def test_trace_is_timestamped_and_ordered():
    tr = pb.execute(_port_program(ref_playback._program(2)), "fast", CFG,
                    device="cpu")
    times = [t for t, _, _ in tr]
    assert times == sorted(times)
    assert [k for _, k, _ in tr] == ["WEIGHTS", "SPIKES", "RATES", "V",
                                     "SPIKES", "RATES", "CORR"]


def test_upload_rejects_unknown_opcode_and_run_before_upload():
    with pytest.raises(ValueError, match="unknown opcode"):
        pb.write_ppu_program(corpus.unknown_opcode_program())
    for backend in ("ref", "fast"):
        with pytest.raises(ValueError, match="before WRITE_PPU_PROGRAM"):
            pb.execute([pb.ppu_run()], backend, CFG, device="cpu")


def test_first_divergence_matches_reference():
    """The copied locator reports what the reference's does: a value
    split (time-leading record), a header split and a length split."""
    a = pb.execute(_port_program(ref_playback._program(0)), "ref", CFG)
    cases = []
    b = [(t, k, v.copy()) for t, k, v in a]
    b[1][2][37, 5] = 1.0 - b[1][2][37, 5]                 # SPIKES flip
    cases.append(b)
    cases.append([a[0], (a[1][0], "V", a[1][2])] + a[2:])
    cases.append(a[:-2])
    cases.append(list(a))
    for b in cases:
        got = mismatch.first_divergence(a, b)
        want = j_mismatch.first_divergence(a, b)
        if want is None:
            assert got is None
            continue
        assert dataclasses_equal(got, want)
        assert got.describe() == want.describe()
    assert mismatch.PHASE_OF_KIND == j_mismatch.PHASE_OF_KIND


def dataclasses_equal(a, b):
    return {k: getattr(a, k) for k in a.__dataclass_fields__} == \
        {k: getattr(b, k) for k in b.__dataclass_fields__}


def test_fast_backend_needs_a_device(monkeypatch):
    """With no card and no device given, the fast backend raises instead
    of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pb.FastBackend(CFG)
    with pytest.raises(ValueError, match="backend"):
        pb.execute([], "jax", CFG)
