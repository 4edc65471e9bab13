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

On the card the kernel is held to its plain version bit for bit
(``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, t
from repro.core import stp as j_stp
from repro_torch import kernels
from repro_torch.core import stp
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
