"""Monte-Carlo STP calibration in the port (``repro_torch.verif
.calibration``) against the reference (``repro.verif.calibration``).

- Trim codes equal to the reference's for the same offsets
  (``sigma_stp_offset * N(0, 1)`` made with numpy: 128 drivers as in Fig.
  4, and the full chip's 16 x 256). A code may differ only where the
  reference's measured offset at the deciding bit lies within 1e-4 of the
  target (the two frameworks' float32 rounding may put it on either
  side).
- Measured offsets before and after within rtol = atol = 1e-4 (tier 2),
  the spreads likewise.
- The four tests of tests/test_calibration.py, on the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, t
from repro.configs.bss2 import BSS2 as J_BSS2
from repro.verif import calibration as jcal
from repro_torch.configs.bss2 import BSS2
from repro_torch.core.stp import CALIB_STEP
from repro_torch.verif.calibration import (binary_search_calibrate,
                                           calibrate_stp, measure_stp_offset)


def _offsets(shape, seed):
    rng = np.random.default_rng(seed)
    return (BSS2.mismatch.sigma_stp_offset
            * rng.standard_normal(shape)).astype(np.float32)


def _at_target(offsets, codes):
    """Elements whose reference measurement at some bit of the search lies
    within 1e-4 of the target: there the decision may go either way."""
    near = np.zeros(offsets.shape, bool)
    code = np.zeros(offsets.shape, np.int32)
    for bit in reversed(range(J_BSS2.calib_bits)):
        trial = code + (1 << bit)
        val = np.asarray(jcal.measure_stp_offset(
            J_BSS2, jnp.asarray(offsets), jnp.asarray(trial)))
        near |= np.abs(val) <= 1e-4
        code = np.where(val > 0, trial, code)
    np.testing.assert_array_equal(code, codes)
    return near


@pytest.mark.parametrize("shape,seed", [((128,), 42), ((128,), 7),
                                        ((16, 256), 3), ((16, 256), 11)])
def test_codes_and_offsets_match_reference(shape, seed):
    off = _offsets(shape, seed)
    j_codes, j_m = jcal.calibrate_stp(J_BSS2, jnp.asarray(off))
    codes, m = calibrate_stp(BSS2, t(off))
    j_codes = np.asarray(j_codes)
    assert codes.dtype == torch.int32 and codes.shape == shape
    differ = codes.numpy() != j_codes
    assert not (differ & ~_at_target(off, j_codes)).any()
    for k in ("before", "after", "std_before", "std_after",
              "max_abs_after"):
        if not differ.any() or k in ("before", "std_before"):
            close(m[k], j_m[k], err_msg=k)


def test_fig4_offset_distribution_narrows():
    """128 virtual driver instances, as in the paper's Fig. 4."""
    codes, metrics = calibrate_stp(BSS2, t(_offsets((128,), 42)))
    assert float(metrics["std_after"]) < 0.4 * float(metrics["std_before"])
    assert (float(metrics["max_abs_after"]) <= 4 * CALIB_STEP + 1e-6
            or float(metrics["after"].abs().mean()) < CALIB_STEP)


def test_calibration_is_deterministic():
    off = t(0.25 * np.random.default_rng(7).standard_normal(32)
            .astype(np.float32))
    c1, _ = calibrate_stp(BSS2, off)
    c2, _ = calibrate_stp(BSS2, off)
    assert torch.equal(c1, c2)


def test_binary_search_hits_known_target():
    """measure = 10 - code, decreasing: the search returns the largest code
    whose measurement stays above target (9); code 10 hits exactly 0 and
    is rejected."""
    def measure(code):
        return 10.0 - code.to(torch.float32)
    code = binary_search_calibrate(measure, bits=4, shape=(3,),
                                   device="cpu", target=0.0,
                                   increasing=False)
    assert code.tolist() == [9, 9, 9]
    assert (measure(code + 1).abs() <= 1.0).all()
    # increasing: the largest code whose measurement stays below target
    code = binary_search_calibrate(lambda c: c.to(torch.float32) - 5.5,
                                   bits=4, shape=(2,), device="cpu",
                                   increasing=True)
    assert code.tolist() == [5, 5]


def test_measure_monotone_in_code():
    offs = torch.zeros(1)
    vals = [float(measure_stp_offset(BSS2, offs,
                                     torch.full((1,), c, dtype=torch.int32)))
            for c in range(16)]
    assert all(a > b for a, b in zip(vals, vals[1:])), vals
    j_vals = [float(jcal.measure_stp_offset(
        J_BSS2, jnp.zeros(1), jnp.full((1,), c, jnp.int32))[0])
        for c in range(16)]
    close(vals, j_vals)
