"""The port's event records (``repro_torch.core.events``) against the
reference's ``repro.core.events``, record for record.

The port keeps only what the sparse route runs: the window census and its
no-drop predicate, the default capacities, and ``regroup_window``, which
builds the [N, T, K] record grid directly. The grid is held against the
reference's ``pack_events`` followed by ``regroup_events``, vmapped over
the instances.

Everything here is integer records (plus the efficacies, which are only
moved, never computed), so every comparison is exact (tier 1), across a
0-100% density sweep and forced overflow of the total capacity and of
single steps. Mirrors tests/test_sparse.py::TestEventStreamRoundTrip and
TestOverflowContract.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import t
from repro.core import events as je
from repro_torch.core import events as te

DENSITIES = [0.0, 0.001, 0.01, 0.1, 0.5, 1.0]


def _window(T, R, seed, p, prefix=(), n_addr=4):
    """[T, *prefix, R] events with STP-like efficacies (0 = silent) and
    int8 event addresses."""
    rng = np.random.default_rng(seed)
    shape = (T, *prefix, R)
    ev = ((rng.random(shape) < p)
          * rng.uniform(0.1, 1.5, shape)).astype(np.float32)
    ad = rng.integers(0, n_addr, shape).astype(np.int8)
    return ev, ad


def _reference_grid(ev, ad, max_events, k_cap):
    """The reference's pack + regroup of every [T, R] instance window."""
    T = ev.shape[1]

    def one(e, a):
        return je.regroup_events(je.pack_events(e, a, max_events), T, k_cap)
    return [np.asarray(x) for x in jax.vmap(one)(ev, ad)]


class TestCensus:
    @pytest.mark.parametrize("p", DENSITIES)
    def test_window_stats(self, p):
        ev, _ = _window(24, 16, seed=11, p=p, prefix=(3,))
        for got, want in zip(te.window_stats(t(ev)), je.window_stats(ev)):
            assert got.dtype == torch.int32
            assert int(got) == int(want)

    @pytest.mark.parametrize("p", DENSITIES)
    def test_census_plain_matches_reference(self, p):
        """The census kernel's plain version: (fits, n_events, k_max) as
        an int32 tensor, the reference's window_stats and census_fits, at
        capacities that the sweep's windows fit and overflow."""
        from repro_torch.kernels.census.ref import census_ref
        ev, _ = _window(24, 16, seed=11, p=p, prefix=(3,))
        n, k = je.window_stats(ev)
        for me, kc in ((10, 2), (60, 8), (24 * 16, 16)):
            got = census_ref(t(ev), me, kc)
            assert got.dtype == torch.int32
            assert got.tolist() == [int(bool(je.census_fits(n, k, me, kc))),
                                    int(n), int(k)]

    def test_window_stats_hand_counted(self):
        ev = torch.zeros((4, 2, 8))
        ev[0, 0, :3] = 1.0
        ev[2, 1, :5] = 0.7
        ev[3, 1, 0] = 0.2
        n, kmax = te.window_stats(ev)
        assert int(n) == 6 and int(kmax) == 5

    def test_census_fits(self):
        for n, k in [(10, 2), (11, 2), (10, 3), (0, 0)]:
            got = te.census_fits(torch.tensor(n), torch.tensor(k), 10, 2)
            assert bool(got) == bool(je.census_fits(n, k, 10, 2))

    def test_default_capacities(self):
        for T in (1, 13, 64, 128, 256):
            for R in (8, 64, 128, 256):
                for thr in (0.001, 0.02, 0.05, 0.3, 1.0):
                    assert te.default_max_events(T, R, thr) == \
                        je.default_max_events(T, R, thr)
                    assert te.default_k_cap(R, thr) == je.default_k_cap(R, thr)
        assert te.default_max_events(128, 128, 0.02) == 328
        assert te.default_k_cap(128, 0.02) == 16

    def test_silent_regime_flagged(self):
        """A window that fits its total capacity but holds a step over
        k_cap: the census refuses it, and a forced regroup drops exactly
        the step tails the reference's regroup drops."""
        T, R = 64, 64
        ev, ad = _window(T, R, seed=51, p=0.5)
        n, kmax = te.window_stats(t(ev))
        assert int(n) <= T * R
        assert not bool(te.census_fits(n, kmax, T * R, 2))
        got = te.regroup_window(t(ev[None]), t(ad[None]), T * R, 2)
        want = _reference_grid(ev[None], ad[None], T * R, 2)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)
        assert int((got[2] != 0).sum()) == 2 * T


class TestRegroupWindow:
    @pytest.mark.parametrize("p", DENSITIES)
    @pytest.mark.parametrize("max_events,k_cap", [
        (None, None),         # the §5 defaults at threshold 0.02
        (10_000, 64),         # everything fits
        (50, 64),             # total-capacity overflow drops the tail
        (10_000, 3),          # per-step overflow drops step tails
        (37, 2)])             # both
    @pytest.mark.parametrize("N,T,R", [(3, 32, 40), (2, 17, 8)])
    def test_regroup_window_equals_pack_then_regroup(self, p, max_events,
                                                     k_cap, N, T, R):
        """The direct [N, T, K] build equals the reference's vmapped
        pack_events + regroup_events value for value, drops included."""
        if max_events is None:
            max_events = je.default_max_events(T, R, 0.02)
            k_cap = je.default_k_cap(R, 0.02)
        ev, ad = _window(T, R, seed=8, p=p, prefix=(N,))
        ev, ad = ev.transpose(1, 0, 2), ad.transpose(1, 0, 2)   # [N, T, R]
        want = _reference_grid(ev, ad, max_events, k_cap)
        got = te.regroup_window(t(ev), t(ad), max_events, k_cap)
        for a, b, dt in zip(got, want, (torch.int32, torch.int32,
                                        torch.float32)):
            assert a.dtype == dt and tuple(a.shape) == (N, T, k_cap)
            np.testing.assert_array_equal(a.numpy(), b)

    def test_total_overflow_keeps_the_t_major_prefix(self):
        """Hand-made: 3 events at step 0, 2 at step 1, capacity 4 keeps
        the first 4 in (t, row) order; empty slots hold row 0, eff 0."""
        ev = torch.zeros((1, 3, 6))
        ev[0, 0, [1, 3, 4]] = torch.tensor([0.5, 0.25, 1.0])
        ev[0, 1, [0, 5]] = torch.tensor([2.0, 3.0])
        ad = torch.arange(18, dtype=torch.int8).reshape(1, 3, 6)
        rows, addr, eff = te.regroup_window(ev, ad, 4, 3)
        assert rows.tolist() == [[[1, 3, 4], [0, 0, 0], [0, 0, 0]]]
        assert addr.tolist() == [[[1, 3, 4], [6, 0, 0], [0, 0, 0]]]
        assert eff.tolist() == [[[0.5, 0.25, 1.0], [2.0, 0.0, 0.0],
                                 [0.0, 0.0, 0.0]]]
