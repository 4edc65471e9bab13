"""The STP efficacy scan (``repro_torch.kernels.stp_scan``) on the CPU.

- Its plain version equals the step loop of ``stp.efficacy`` and
  ``stp.update`` bit for bit (the loop ``AnnCore`` ran before the kernel),
  over instance prefixes, window lengths, resources at 0 and 1 and
  negative scales (where the efficacy is -0.0).
- It agrees with the reference's STP ``lax.scan``
  (``repro/core/anncore.py:333-341``) on the same numpy inputs within the
  house tolerance rtol = atol = 1e-4.
- The wrapper runs the plain version for CPU tensors and launches nothing;
  ``AnnCore``'s window goes through it.
- The census form (``caps=``): each Dale half's census equals
  ``census_ref`` on ``eff_t[..., 0::2]`` and ``[..., 1::2]`` and the
  reference's ``window_stats`` with ``census_fits`` (exact: integers), at
  the §5 background, pattern bursts, no spike and every row firing, odd
  R (uneven halves), prefixes ``()``, ``(2,)``, ``(2, 3)``, T = 0, 1 and
  128, at each capacity's edge (equal and one over) and with resources at
  0 under a negative scale (-0.0 efficacies, no event); the decisions go
  to ``routes``.

On the card the kernel is held to its plain version bit for bit
(``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, t
from repro.core import events as je
from repro.core import stp as j_stp
from repro_torch import kernels
from repro_torch.core import stp, synapse
from repro_torch.kernels.census.ref import census_ref
from repro_torch.kernels.stp_scan import ops as stp_ops
from repro_torch.kernels.stp_scan.ref import stp_scan_ref

U = 0.2
RECOVERY = stp.recovery_factor(20.0, 0.2)


def _operands(prefix, T, r0_case, negative, seed=0, R=37):
    rng = np.random.default_rng(seed + T + 7 * len(prefix))
    sp = (rng.random((T, *prefix, R)) < 0.3).astype(np.float32)
    r0 = {"random": rng.random((*prefix, R)),
          "zero": np.zeros((*prefix, R)),
          "one": np.ones((*prefix, R))}[r0_case].astype(np.float32)
    scale = rng.normal(1.0, 0.5, (*prefix, R)).astype(np.float32)
    if negative:
        scale = -np.abs(scale)
    return r0, sp, scale


def _step_loop(r0, sp, scale):
    s = stp.STPState(r=r0)
    eff = []
    for k in range(sp.shape[0]):
        eff.append(stp.efficacy(s, sp[k], u=U, scale=scale))
        s = stp.update(s, sp[k], u=U, recovery=RECOVERY)
    return torch.stack(eff), s.r


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("r0_case", ["random", "zero", "one"])
@pytest.mark.parametrize("T", [1, 7, 128])
@pytest.mark.parametrize("prefix", [(), (3,), (2, 5)])
def test_plain_equals_step_loop(prefix, T, r0_case, negative):
    """Bit for bit (the sign of zero included) through the wrapper."""
    r0, sp, scale = map(t, _operands(prefix, T, r0_case, negative))
    eff, r_T = stp_ops.stp_scan(r0, sp, scale, u=U, recovery=RECOVERY)
    want_eff, want_r = _step_loop(r0, sp, scale)
    assert eff.shape == (T, *prefix, r0.shape[-1])
    assert torch.equal(_bits(eff), _bits(want_eff))
    assert torch.equal(_bits(r_T), _bits(want_r))
    if negative and r0_case == "zero":
        assert bool((torch.signbit(eff[0]) & (sp[0] != 0)).any())


@pytest.mark.parametrize("r0_case", ["random", "zero", "one"])
@pytest.mark.parametrize("T", [1, 7, 128])
@pytest.mark.parametrize("prefix", [(), (3,), (2, 5)])
def test_plain_matches_reference_scan(prefix, T, r0_case):
    """Against the reference's STP scan on the same numpy inputs, within
    rtol = atol = 1e-4."""
    r0, sp, scale = _operands(prefix, T, r0_case, negative=False)
    recovery = j_stp.recovery_factor(20.0, 0.2)

    def body(s, x):
        eff = j_stp.efficacy(s, x, u=U, scale=scale)
        return j_stp.update(s, x, u=U, recovery=recovery), eff
    j_s, j_eff = jax.lax.scan(body, j_stp.STPState(jnp.asarray(r0)), sp)
    eff, r_T = stp_scan_ref(t(r0), t(sp), t(scale), u=U, recovery=RECOVERY)
    close(eff, j_eff)
    close(r_T, j_s.r)


def test_strided_and_broadcast_operands():
    """A Dale half of the spikes read in place and a scale shared by the
    prefix give what contiguous copies give."""
    r0, sp, scale = map(t, _operands((4,), 50, "random", False, R=60))
    half = sp[..., 1::2]
    shared = scale[0, 1::2]
    got = stp_ops.stp_scan(r0[..., 1::2], half, shared, u=U,
                           recovery=RECOVERY)
    want = _step_loop(r0[..., 1::2].contiguous(), half.contiguous(),
                      shared.expand(4, -1).contiguous())
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


def test_empty_window():
    r0, sp, scale = map(t, _operands((2,), 1, "random", False))
    eff, r_T = stp_ops.stp_scan(r0, sp[:0], scale, u=U, recovery=RECOVERY)
    assert eff.shape == (0, 2, r0.shape[-1])
    assert torch.equal(r_T, r0)


def test_wrapper_dispatch():
    """CPU tensors run the plain version and count no launch; another
    device raises."""
    r0, sp, scale = map(t, _operands((2,), 9, "random", False))
    before = dict(kernels.LAUNCHES)
    stp_ops.stp_scan(r0, sp, scale, u=U, recovery=RECOVERY)
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported device"):
        stp_ops.stp_scan(r0.to("meta"), sp.to("meta"), scale.to("meta"),
                         u=U, recovery=RECOVERY)


def test_anncore_window_goes_through_stp_scan(monkeypatch):
    """``AnnCore._window_currents`` takes its efficacies from
    ``stp_scan`` (no Python STP loop left in the windowed backends)."""
    from repro_torch.core import hybrid as th
    calls = []
    real = stp_ops.stp_scan

    def spy(*args, **kw):
        calls.append(args[1].shape)
        return real(*args, **kw)
    monkeypatch.setattr(stp_ops, "stp_scan", spy)
    init, trial, meta = th.make_experiment(
        ecfg=th.RSTDPConfig(trial_steps=40), device="cpu")
    draws = meta["draw"](torch.Generator().manual_seed(1), [1])
    trial(init(), 1, draws.events[0], draws.xi[0])
    assert calls == [torch.Size((40, 32))]


# ------------------------------------------------------- the census form

DENSITIES = ("background", "bursts", "none", "all")


def _census_operands(prefix, T, R, density, seed=3):
    """Spikes at the §5 background rate, with pattern bursts on a sixth
    of the rows every 16 steps, none, or on every row at every step; a
    positive scale, so that every spike makes an event."""
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


def _caps(T, R, C=512):
    """Each Dale half's capacities as the gate sizes them (const_addr at
    C columns)."""
    return tuple(synapse.route_plan(T, len(range(h, R, 2)), C,
                                    const_addr=True, sparse="always")[1:]
                 for h in (0, 1))


def _reference_census(eff, me, kc):
    """The reference's census of one half: window_stats + census_fits."""
    n, k = je.window_stats(jnp.asarray(eff.numpy()))
    return [int(je.census_fits(n, k, me, kc)), int(n), int(k)]


def _census_form(r0, sp, scale, caps):
    """The census form through the wrapper, against the step loop and each
    half's census_ref (and the reference's census where T > 0); the
    decisions counted. Returns the two censuses as lists."""
    routes = torch.zeros(2, dtype=torch.int64)
    before = dict(kernels.LAUNCHES)
    eff, r_T, c_exc, c_inh = stp_ops.stp_scan(
        t(r0), t(sp), t(scale), u=U, recovery=RECOVERY, caps=caps,
        routes=routes)
    assert kernels.LAUNCHES == before
    if sp.shape[0] > 0:
        want_eff, want_r = _step_loop(t(r0), t(sp), t(scale))
    else:
        want_eff, want_r = torch.empty((0, *r0.shape)), t(r0)
    assert eff.shape == want_eff.shape
    assert torch.equal(_bits(eff), _bits(want_eff))
    assert torch.equal(_bits(r_T), _bits(want_r))
    got = []
    for h, (c, (me, kc)) in enumerate(zip((c_exc, c_inh), caps)):
        assert c.dtype == torch.int32 and c.shape == (3,)
        assert torch.equal(c, census_ref(want_eff[..., h::2], me, kc))
        if sp.shape[0] > 0:
            assert c.tolist() == _reference_census(want_eff[..., h::2], me,
                                                   kc)
        got.append(c.tolist())
    fits = got[0][0] + got[1][0]
    assert routes.tolist() == [2 - fits, fits]
    return got


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("R", [32, 37])
@pytest.mark.parametrize("T", [0, 1, 128])
@pytest.mark.parametrize("prefix", [(), (2,), (2, 3)])
def test_census_form_matches_census_ref_and_reference(prefix, T, R,
                                                      density):
    """Each half's census from the scan's plain version equals
    ``census_ref`` on its strided half and the reference's
    ``window_stats`` / ``census_fits``; an odd R gives halves of 19 and
    18 rows; T = 0 has the census (0, 0) and fits."""
    r0, sp, scale = _census_operands(prefix, T, R, density)
    got = _census_form(r0, sp, scale, _caps(T, R))
    if T == 0 or density == "none":
        assert got == [[1, 0, 0], [1, 0, 0]]
    if density == "all" and T > 0:
        assert [c[1:] for c in got] == [[T * len(range(h, R, 2)),
                                         len(range(h, R, 2))]
                                        for h in (0, 1)]


@pytest.mark.parametrize("half", [0, 1])
@pytest.mark.parametrize("edge", ["n_events_equal", "n_events_over",
                                  "k_max_equal", "k_max_over"])
def test_census_form_capacity_edges(edge, half):
    """A half whose census meets a capacity exactly fits; one over it does
    not; the other half, with room, fits. 64 steps of pattern bursts on
    two instances of 37 rows."""
    r0, sp, scale = _census_operands((2,), 64, 37, "bursts")
    eff, _ = _step_loop(t(r0), t(sp), t(scale))
    _, n, k = census_ref(eff[..., half::2], 0, 0).tolist()
    big = 10 ** 6
    caps = [(big, big), (big, big)]
    caps[half] = {"n_events_equal": (n, big), "n_events_over": (n - 1, big),
                  "k_max_equal": (big, k), "k_max_over": (big, k - 1)}[edge]
    got = _census_form(r0, sp, scale, tuple(caps))
    assert got[half] == [int(edge.endswith("equal")), n, k]
    assert got[1 - half][0] == 1


def test_census_form_zero_resources_negative_scale():
    """Resources at 0 under a negative scale: every spike's efficacy is
    -0.0, which is no event, in the plain version as in the reference."""
    r0, sp, scale = _census_operands((2,), 40, 37, "bursts")
    r0[:] = 0
    scale = -scale
    eff, _ = _step_loop(t(r0), t(sp), t(scale))
    assert bool((torch.signbit(eff) & (t(sp) != 0)).any())
    assert _census_form(r0, sp, scale, _caps(40, 37)) == [[1, 0, 0],
                                                          [1, 0, 0]]
