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


CORR_EDGE_CASES = ("above_sat", "negative_zero", "all_zero", "dense",
                   "non_binary", "signed_zeros_on_negative_zero")


def corr_edge_operands(case, T=77, N=2, R=70, C=200, seed=0):
    """Operands of the corr window (pre [T, N, R], post [T, N, C], tp0,
    tq0, ac0, aa0; float32 numpy) that probe the edges of the kernel's
    spike-driven skip: accumulators above ``sat`` at the start, -0.0 in
    the spikes and the accumulators, a window with no spike, a window
    with a spike at every step, spike values that are neither 0 nor 1
    (negative too), negative start traces, and a T that is a multiple of
    no chunk. "signed_zeros_on_negative_zero": every accumulator starts
    at -0.0 and every spike is +0.0 or -0.0 (-0.0 at step 0), so the
    plain version turns some -0.0 into +0.0 at a silent step."""
    rng = np.random.default_rng(seed)

    def spikes(*shape, p=0.15):
        return (rng.random(shape) < p).astype(np.float32)

    def signed_zeros(x, frac=0.5):
        z = x == 0
        x[z] = np.where(rng.random(int(z.sum())) < frac, -0.0, 0.0)
        return x

    pre, post = spikes(T, N, R), spikes(T, N, C)
    tp0 = rng.random((N, R)).astype(np.float32)
    tq0 = rng.random((N, C)).astype(np.float32)
    ac0 = rng.uniform(0, 2000, (N, R, C)).astype(np.float32)
    aa0 = rng.uniform(0, 2000, (N, R, C)).astype(np.float32)
    if case == "negative_zero":
        pre, post = signed_zeros(pre), signed_zeros(post)
        ac0[0, :5, :7] = -0.0
        aa0[:, 10:12] = -0.0
        tp0 = rng.uniform(-1, 1, (N, R)).astype(np.float32)
        tq0 = rng.uniform(-1, 1, (N, C)).astype(np.float32)
    elif case == "all_zero":
        pre, post = np.zeros_like(pre), np.zeros_like(post)
    elif case == "dense":
        pre, post = np.ones_like(pre), np.ones_like(post)
    elif case == "non_binary":
        pre = (pre * rng.uniform(-2, 3, pre.shape)).astype(np.float32)
        post = (post * rng.uniform(-2, 3, post.shape)).astype(np.float32)
        tp0 = rng.uniform(-1, 1, (N, R)).astype(np.float32)
    elif case == "signed_zeros_on_negative_zero":
        pre = signed_zeros(np.zeros_like(pre))
        post = signed_zeros(np.zeros_like(post))
        pre[0], post[0] = -0.0, -0.0
        ac0 = np.full_like(ac0, -0.0)
        aa0 = np.full_like(aa0, -0.0)
    elif case != "above_sat":
        raise ValueError(case)
    return pre, post, tp0, tq0, ac0, aa0
