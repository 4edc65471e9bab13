"""The §5 experiment in the port against the reference.

- A teacher-forced trial: the reference's state after a few trials goes
  into the port, both packages get the same draws (the reference's key
  chain replayed by ``repro_torch.convert``), and one trial is compared.
  The reference runs that trial with its synray and corr kernels in
  interpret mode (``backend="fused"``), whose correlation window is per
  step with the same decay constant as the port's. Spikes equal up to
  flips at threshold; rate counters, CADC codes (eligibility), 6-bit weights and mean rewards exact; the signed float
  weights within 1e-4.
  The same trial with ``rule_impl="vm"`` (the rule's vector part as the
  PPU-VM program ``signed_dw_program``): weight codes and the VM's dw
  readout exact, the signed weights within 1e-4.
- The whole experiment as one dispatch: the port's
  ``make_scanned_training`` with the reference's instance and draws
  against the reference's ``make_scanned_training`` over 7 trials (rates,
  rewards, stimuli, CADC codes and 6-bit weights exact, floats within
  1e-4); ``run_training``'s three modes (``scan=True``, ``scan=False``,
  ``fused=False``) bit-equal to each other, histories, final state and
  route counts, as tests/test_fused.py::TestScannedTraining holds the
  reference's; ``_reward`` on a tensor stimulus equal to the branch form
  and to the reference's ``_reward``.
- The closed loop: 450 trials of the port at 32 x 16 with the reference's
  draws meet the criteria of tests/test_rstdp.py::
  test_fig11_reward_converges_to_one. With the vm rule, 60 trials at
  T = 128 learn (tests/test_ppuvm.py::test_hybrid_vm_rule_trains), and
  the first trial agrees with the python rule's signed weights within
  0.15 (test_hybrid_vm_dw_matches_python_rule_first_trial).
"""
import dataclasses

import numpy as np
import pytest
import jax
import torch

from _torch_parity import assert_spikes_match, close, spike_threshold, t
from repro.core import hybrid as jh
from repro_torch import convert
from repro_torch.configs.bss2 import BSS2
from repro_torch.core import hybrid as th
from repro_torch.core import synapse
from repro_torch.ppuvm import programs

K_TRIALS = 7


def _trailing(mr, sel, n=150):
    return float(np.mean(np.median(mr[-n:, sel], axis=1)))


def _teacher_forced(rule_impl):
    ecfg = jh.RSTDPConfig()
    key0 = jax.random.PRNGKey(0)
    init, _, meta = jh.make_experiment(ecfg=ecfg, instance_key=key0,
                                       rule_impl=rule_impl)
    # copied first: the reference's initial state aliases instance arrays,
    # and its scanned training donates that state
    inst = jax.tree.map(np.array, meta["inst"])
    stims = th.stimuli(K_TRIALS + 1)
    state_k, _ = jh.make_scanned_training(meta["scanned_training"])(
        init(jax.random.PRNGKey(1)), jax.numpy.asarray(stims[:K_TRIALS]))
    stim = int(stims[K_TRIALS])
    _, trial_i, meta_i = jh.make_experiment(
        ecfg=ecfg, instance_key=key0, backend="fused",
        kernel_impl="interpret", rule_impl=rule_impl)
    j_new, j_m = jax.jit(trial_i)(state_k, stim)
    ref = jax.tree.map(np.asarray, state_k)

    _, trial, meta_t = th.make_experiment(
        ecfg=th.RSTDPConfig(), inst=convert.instance(inst, "cpu"),
        backend="blocked", rule_impl=rule_impl, device="cpu")
    draws = convert.replay_reference_draws(
        jax.random, state_k.key, [stim], th.RSTDPConfig(), device="cpu")
    st = convert.experiment_state(ref, "cpu")
    t_new, t_m = trial(st, stim, draws.events[0], draws.xi[0])

    # spikes of the trial's window, with membranes for the flip rule
    ev = draws.events[0]
    addr = torch.zeros(ev.shape, dtype=torch.int8)
    j_cs, j_out = meta_i["core"].run(ref.core, ev.numpy(), addr.numpy(),
                                     record_v=True)
    t_cs, t_out = meta_t["core"].run(st.core, ev, addr, record_v=True)
    assert float(np.asarray(j_out["spikes"]).sum()) > 0
    assert_spikes_match(t_out["spikes"], j_out["spikes"], t_out["v"],
                        j_out["v"], spike_threshold(inst["neuron_params"]))

    np.testing.assert_array_equal(t_m["rates"].numpy(),
                                  np.asarray(j_m["rates"]))
    np.testing.assert_array_equal(t_m["reward"].numpy(),
                                  np.asarray(j_m["reward"]))
    # eligibility = (causal - acausal CADC code) / 255: the codes exactly
    # (XLA divides by a constant as a multiply by its reciprocal, so the
    # float quotients may differ by an ulp)
    np.testing.assert_array_equal(np.rint(t_m["elig"].numpy() * 255),
                                  np.rint(np.asarray(j_m["elig"]) * 255))
    close(t_m["elig"], j_m["elig"])
    np.testing.assert_array_equal(t_new.core.syn.weights.numpy(),
                                  np.asarray(j_new.core.syn.weights))
    np.testing.assert_array_equal(t_new.mean_reward.numpy(),
                                  np.asarray(j_new.mean_reward))
    close(t_new.w_signed, j_new.w_signed)
    assert not t_new.core.corr.a_causal.any()      # read resets sensors
    return dict(j_cs=j_cs, t_cs=t_cs, ref=ref, st=st, j_m=j_m, t_m=t_m,
                meta_i=meta_i, meta_t=meta_t, ecfg=ecfg)


def test_teacher_forced_trial():
    """The python rule: tier 1 on rates, rewards, CADC codes, 6-bit
    weights and mean rewards; the signed weights within 1e-4."""
    _teacher_forced("python")


def test_teacher_forced_trial_vm():
    """The vm rule (``signed_dw_program``): as the python rule, and the
    VM's dw readout (register 0 of the exc rows, / 256) bit for bit, from
    the window's states of both packages."""
    r = _teacher_forced("vm")
    ecfg = r["ecfg"]
    words = programs.signed_dw_program(
        eta=ecfg.eta, eta_homeo=ecfg.eta_homeo, fire_thresh=ecfg.fire_thresh)
    reward = np.asarray(r["j_m"]["reward"])
    mean_r = np.asarray(r["ref"].mean_reward)
    mod = np.stack([reward - mean_r, reward])
    _, j_regs = r["meta_i"]["ppu"].run_program(
        r["j_cs"], jax.numpy.asarray(words), mod=jax.numpy.asarray(mod))
    _, t_regs = r["meta_t"]["ppu"].run_program(
        r["t_cs"], torch.as_tensor(words), mod=torch.as_tensor(mod))
    j_dw = np.asarray(j_regs[0][..., 0::2, :]).astype(np.float32) / 256
    t_dw = t_regs[0][..., 0::2, :].to(torch.float32) / 256
    assert np.abs(j_dw).max() > 0
    np.testing.assert_array_equal(t_dw.numpy(), j_dw)


def test_closed_loop_with_reference_draws():
    """450 trials, seed 0, the reference's instance and draws: the port
    meets test_fig11_reward_converges_to_one's criteria."""
    n, seed = 450, 0
    inst = jax.tree.map(np.asarray, jh.sample_instance(
        jh.dataclasses.replace(jh.BSS2.reduced(), n_rows=32, n_cols=16),
        jax.random.PRNGKey(seed), ()))
    draws = convert.replay_reference_draws(
        jax.random, jax.random.PRNGKey(seed + 1), th.stimuli(n),
        th.RSTDPConfig(), device="cpu")
    out, _, meta = th.run_training(n, seed=seed, device="cpu",
                                   inst=convert.instance(inst, "cpu"),
                                   draws=draws)
    even = meta["even"].numpy() > 0
    te = _trailing(out["mean_reward"], even)
    to = _trailing(out["mean_reward"], ~even)
    assert te > 0.85, f"even population trailing <R> = {te}"
    assert to > 0.85, f"odd population trailing <R> = {to}"
    w = out["w_signed_final"]
    ma = meta["mask_a"] > 0
    assert w[ma][:, even].mean() > 5.0
    assert w[ma][:, even].mean() > w[ma][:, ~even].mean() + 10.0


def test_own_generator_is_deterministic():
    a, _, _ = th.run_training(4, seed=3, device="cpu")
    b, _, _ = th.run_training(4, seed=3, device="cpu")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert a["w"].shape == (4, 16, 16) and a["stim"].tolist() == [1, 2, 0, 1]


def test_run_training_needs_a_device(monkeypatch):
    """With no card and no device given, the entry point raises instead of
    carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th.run_training(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th.make_experiment()


def test_vm_rule_trains():
    """60 trials of the vm rule at T = 128 with the reference's instance
    and draws: the median reward of the last 15 trials is above that of
    the first 15 (tests/test_ppuvm.py::test_hybrid_vm_rule_trains)."""
    n, seed = 60, 0
    ecfg = th.RSTDPConfig(trial_steps=128)
    inst = jax.tree.map(np.asarray, jh.sample_instance(
        jh.dataclasses.replace(jh.BSS2.reduced(), n_rows=32, n_cols=16),
        jax.random.PRNGKey(seed), ()))
    draws = convert.replay_reference_draws(
        jax.random, jax.random.PRNGKey(seed + 1), th.stimuli(n), ecfg,
        device="cpu")
    out, _, _ = th.run_training(n, ecfg=ecfg, seed=seed, rule_impl="vm",
                                device="cpu",
                                inst=convert.instance(inst, "cpu"),
                                draws=draws)
    mr = np.median(out["mean_reward"], axis=1)
    assert np.isfinite(out["w_signed_final"]).all()
    assert mr[-15:].mean() > mr[:15].mean(), (mr[:15].mean(),
                                              mr[-15:].mean())


def test_vm_rule_matches_python_rule_first_trial():
    """One trial from the same state and draws under both rules: the
    signed weights agree within 0.15 (the Q8.8 rounding of dw;
    tests/test_ppuvm.py::test_hybrid_vm_dw_matches_python_rule_first_trial)."""
    ecfg = th.RSTDPConfig(trial_steps=128)
    gen = torch.Generator().manual_seed(4)
    outs = {}
    for impl in ("python", "vm"):
        init, trial, meta = th.make_experiment(
            ecfg=ecfg, generator=torch.Generator().manual_seed(3),
            rule_impl=impl, device="cpu")
        if impl == "python":
            draws = meta["draw"](gen, [1])
        st, _ = trial(init(), 1, draws.events[0], draws.xi[0])
        outs[impl] = st.w_signed.numpy()
    d = np.abs(outs["vm"] - outs["python"])
    assert 0 < d.max() < 0.15, f"max |dw gap| {d.max()}"


def test_unknown_rule_impl_raises():
    with pytest.raises(ValueError, match="rule_impl"):
        th.make_experiment(rule_impl="specialized", device="cpu")


@pytest.mark.parametrize("rule_impl", ["python", "vm"])
def test_scanned_training_matches_reference(rule_impl):
    """The port's ``make_scanned_training`` (on the CPU: the trial body
    trial by trial) against the reference's, 7 trials from the initial
    state with the reference's instance and draws: rates, rewards,
    stimuli, CADC codes and 6-bit weights exact; mean rewards, eligibility
    and signed weights within 1e-4."""
    ecfg = jh.RSTDPConfig()
    init, _, meta = jh.make_experiment(ecfg=ecfg,
                                       instance_key=jax.random.PRNGKey(0),
                                       rule_impl=rule_impl)
    inst = jax.tree.map(np.array, meta["inst"])
    stims = th.stimuli(K_TRIALS)
    st0 = init(jax.random.PRNGKey(1))
    draws = convert.replay_reference_draws(
        jax.random, jax.numpy.array(st0.key), stims, th.RSTDPConfig(),
        device="cpu")
    j_state, j_hist = jh.make_scanned_training(meta["scanned_training"])(
        st0, jax.numpy.asarray(stims))
    init_t, _, meta_t = th.make_experiment(
        ecfg=th.RSTDPConfig(), inst=convert.instance(inst, "cpu"),
        backend="blocked", rule_impl=rule_impl, device="cpu")
    t_state, t_hist = th.make_scanned_training(meta_t)(init_t(), stims,
                                                       draws)
    for k in ("rates", "reward", "stim"):
        np.testing.assert_array_equal(t_hist[k].numpy(),
                                      np.asarray(j_hist[k]), err_msg=k)
    np.testing.assert_array_equal(np.rint(t_hist["elig"].numpy() * 255),
                                  np.rint(np.asarray(j_hist["elig"]) * 255))
    for k in ("mean_reward", "elig", "w"):
        close(t_hist[k], j_hist[k], err_msg=k)
    np.testing.assert_array_equal(t_state.core.syn.weights.numpy(),
                                  np.asarray(j_state.core.syn.weights))
    close(t_state.w_signed, j_state.w_signed)


def _geometry(name):
    """The reduced §5 geometry (below the census floor: dense only), or a
    128 x 256 chip above it, where the census gate routes every window."""
    if name == "reduced":
        return dict(ecfg=th.RSTDPConfig(trial_steps=96))
    return dict(ecfg=th.RSTDPConfig(n_inputs=64, n_neurons=256,
                                    pattern_size=16, trial_steps=128),
                cfg=dataclasses.replace(BSS2, n_rows=128, n_cols=256))


@pytest.mark.parametrize("rule_impl", ["python", "vm"])
@pytest.mark.parametrize("geometry", ["reduced", "gated"])
def test_run_modes_bit_equal(geometry, rule_impl):
    """``scan=True`` (the trial body with the stimulus and draws read on
    the device), ``scan=False`` (eager trials) and ``fused=False`` (the
    host loop) give the same histories, final state and route counts,
    bit for bit (tests/test_fused.py:258-271 for the reference)."""
    runs = []
    for mode in (dict(scan=True), dict(scan=False), dict(fused=False)):
        synapse.reset_route_counts()
        out, state, _ = th.run_training(9, seed=3, device="cpu",
                                        rule_impl=rule_impl, **mode,
                                        **_geometry(geometry))
        runs.append((out, state, synapse.route_counts("cpu").tolist()))
    out0, state0, routes0 = runs[0]
    assert sum(routes0) == (18 if geometry == "gated" else 0)
    if geometry == "gated":
        assert routes0 == [12, 6]            # the no-stimulus trials sparse
    assert out0["reward"].shape == (9, 16 if geometry == "reduced" else 256)
    for out, state, routes in runs[1:]:
        assert routes == routes0
        assert sorted(out) == sorted(out0)
        for k in out0:
            assert out[k].dtype == out0[k].dtype, k
            np.testing.assert_array_equal(out[k], out0[k], err_msg=k)
        for a, b in zip(th._leaves(state), th._leaves(state0)):
            assert torch.equal(a, b)


def _find_closure(fn, name, seen=None):
    """The function called ``name`` among the closures reachable from
    ``fn`` (the reference's ``_reward`` is local to ``make_experiment``)."""
    seen = set() if seen is None else seen
    for cell in fn.__closure__ or ():
        v = cell.cell_contents
        if callable(v) and hasattr(v, "__code__") and id(v) not in seen:
            seen.add(id(v))
            if v.__name__ == name:
                return v
            found = _find_closure(v, name, seen)
            if found is not None:
                return found
    return None


@pytest.mark.parametrize("stim", [0, 1, 2])
def test_reward_where_form(stim):
    """``_reward`` on a 0-d int32 stimulus (the reference's ``where``
    form) equals the branch form the port had on an int, and the
    reference's ``_reward``, on rates around the firing threshold."""
    _, _, meta = th.make_experiment(device="cpu")
    reward = _find_closure(meta["scanned_training"], "_reward")
    rng = np.random.default_rng(stim)
    rates = rng.choice([0.0, 0.5, 1.0, 1.5, 3.0], (5, 16)).astype(np.float32)
    got = reward(t(rates), torch.tensor(stim, dtype=torch.int32))
    fired = (t(rates) >= 1.0).to(torch.float32)
    even = meta["even"]
    if stim == 0:
        branch = 1.0 - fired
    else:
        own = even if stim == 1 else 1.0 - even
        branch = torch.where(own > 0, fired, 1.0 - fired)
    assert torch.equal(got, branch)
    _, j_trial, _ = jh.make_experiment(ecfg=jh.RSTDPConfig(),
                                       instance_key=jax.random.PRNGKey(0))
    j_reward = _find_closure(j_trial, "_reward")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_reward(rates, np.int32(stim))))


def test_trial_takes_int_or_tensor_stim():
    """A trial given the stimulus as an int or as a 0-d int32 tensor gives
    the same state and metrics; a stimulus outside {0, 1, 2} raises."""
    init, trial, meta = th.make_experiment(
        ecfg=th.RSTDPConfig(trial_steps=64), device="cpu")
    draws = meta["draw"](torch.Generator().manual_seed(2), [2])
    a = trial(init(), 2, draws.events[0], draws.xi[0])
    b = trial(init(), torch.tensor(2, dtype=torch.int32), draws.events[0],
              draws.xi[0])
    for x, y in zip(th._leaves(a[0]), th._leaves(b[0])):
        assert torch.equal(x, y)
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k])
    with pytest.raises(ValueError, match="stim"):
        trial(init(), 3, draws.events[0], draws.xi[0])


def test_trial_loop_on_the_cpu():
    """``TrialLoop``: histories stacked in trial order, ``reset`` goes back
    to the given state; no trials, or a graph on the CPU, raise."""
    init, trial, meta = th.make_experiment(
        ecfg=th.RSTDPConfig(trial_steps=32), device="cpu")
    stims = th.stimuli(3)
    draws = meta["draw"](torch.Generator().manual_seed(5), stims)
    st = init()
    loop = th.TrialLoop(trial, st, stims, draws)
    for _ in range(3):
        loop.body()
    hist = loop.history()
    assert hist["stim"].tolist() == [1, 2, 0]
    assert int(loop.step) == 3 and hist["w"].shape == (3, 16, 16)
    s, m = st, None
    for i in range(3):
        s, m = trial(s, int(stims[i]), draws.events[i], draws.xi[i])
        assert torch.equal(hist["w"][i], m["w"])
    loop.reset()
    assert int(loop.step) == 0
    for a, b in zip(th._leaves(loop.state), th._leaves(st)):
        assert torch.equal(a, b) and a is not b
    with pytest.raises(ValueError, match="no trials"):
        th.TrialLoop(trial, st, [], draws)
    with pytest.raises(ValueError, match="CUDA device"):
        th.TrialGraph(loop)


def test_host_loop_trial_returns_host_metrics():
    """``host_loop_trial`` gives what the trial gives, with the metrics on
    the host."""
    init, trial, meta = th.make_experiment(
        ecfg=th.RSTDPConfig(trial_steps=32), device="cpu")
    draws = meta["draw"](torch.Generator().manual_seed(6), [1])
    s_h, m_h = th.host_loop_trial(trial, init(), 1, draws.events[0],
                                  draws.xi[0])
    s_e, m_e = trial(init(), 1, draws.events[0], draws.xi[0])
    assert all(v.device.type == "cpu" for v in m_h.values())
    for k in m_e:
        assert torch.equal(m_h[k], m_e[k])
    assert torch.equal(s_h.w_signed, s_e.w_signed)
