"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

Not collected by pytest (no ``test_`` prefix). The tolerances the tests
hold the port to:

- integer outputs: exact;
- floats: rtol = atol = 1e-4, the house tolerance (docs/exactness.md),
  since ``exp`` and reduction orders differ between the frameworks;
- spikes: equal, except that a spike may flip where the membrane of the
  run that did not spike lies within that same tolerance of the spike
  threshold (the float difference decided a threshold crossing).
"""
import numpy as np
import torch

RTOL = ATOL = 1e-4


def t(x):
    """numpy (or JAX) array -> CPU tensor (a copy)."""
    return torch.from_numpy(np.array(x, copy=True))


def close(a, b, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol, err_msg=err_msg)


def spike_threshold(params, adex=True):
    """The membrane value a spike must exceed, per column."""
    v_thres = np.asarray(params["v_thres"], np.float32)
    return v_thres + (2.0 * np.asarray(params["delta_t"], np.float32)
                      if adex else 0.0)


def assert_spikes_match(got, ref, got_v, ref_v, spike_v):
    """``got``/``ref``: [T, ..., C] spikes; ``got_v``/``ref_v``: the
    membrane records of both runs (pre-reset where a run did not spike)."""
    got, ref = np.asarray(got), np.asarray(ref)
    flips = got != ref
    if not flips.any():
        return
    v_quiet = np.where(ref == 0, np.asarray(ref_v), np.asarray(got_v))
    thr = np.broadcast_to(spike_v, got.shape)
    near = np.abs(v_quiet - thr) <= ATOL + RTOL * np.abs(thr)
    bad = flips & ~near
    assert not bad.any(), (
        f"{int(bad.sum())} spike(s) differ away from threshold, first at "
        f"{tuple(int(i) for i in np.argwhere(bad)[0])}")
