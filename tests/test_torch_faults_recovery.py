"""§5 R-STDP under injected faults, screened and blacklisted, on the port:
the scenario of tests/test_faults.py::TestClosedLoop::
test_recovery_under_faults (200 trials x 3 runs at 32 x 16, seed 1).

The port runs with the reference's instance and draws (the key chain of
``run_training(seed=1)`` replayed), so its numbers sit beside the
reference's. The reference's own test screens a finished run's ``meta``,
whose instance arrays its training donated, and crashes; screened from a
core and vector unit of its own ``make_experiment(faults=)``, the
reference meets all three bars. The port is held to the same three bars.

    PYTHONPATH=src python tests/test_torch_faults_recovery.py

prints both packages' trailing mean rewards (clean, naive, screened).
"""
import jax
import numpy as np

from repro.core import hybrid as jh
from repro_torch import convert
from repro_torch.core import hybrid as th
from repro_torch.faults import sample_fault_plan, screen

N_TRIALS, TAIL, SEED = 200, 60, 1


def _plan(model):
    return model.sample_fault_plan(32, 16, np.random.default_rng(3),
                                   p_dead_row=0.06, p_hot_neuron=0.25,
                                   p_cadc=0.12, seed=1)


def _trailing(mr, cols=slice(None)):
    return float(np.mean(mr[-TAIL:, cols]))


def port_recovery():
    """The port's (clean, naive, screened) trailing mean rewards, the
    plan and the screened blacklist."""
    from repro_torch.faults import model
    fp = _plan(model)
    inst = convert.instance(jax.tree.map(np.asarray, jh.sample_instance(
        jh.dataclasses.replace(jh.BSS2.reduced(), n_rows=32, n_cols=16),
        jax.random.PRNGKey(SEED), ())), "cpu")
    draws = convert.replay_reference_draws(
        jax.random, jax.random.PRNGKey(SEED + 1), th.stimuli(N_TRIALS),
        th.RSTDPConfig(), device="cpu")
    kw = dict(device="cpu", inst=inst, draws=draws)
    out_c, _, _ = th.run_training(N_TRIALS, **kw)
    out_f, _, meta = th.run_training(N_TRIALS, faults=fp, **kw)
    bl = screen(meta["core"], meta["ppu"])
    out_b, _, _ = th.run_training(N_TRIALS, faults=fp, blacklist=bl, **kw)
    return (_trailing(out_c["mean_reward"]), _trailing(out_f["mean_reward"]),
            _trailing(out_b["mean_reward"], ~bl.neurons)), fp, bl


def reference_recovery():
    """The reference's (clean, naive, screened), screened from its own
    ``make_experiment(faults=)``."""
    from repro.faults import model, screen as j_screen
    fp = _plan(model)
    out_c, _, _ = jh.run_training(n_trials=N_TRIALS, seed=SEED)
    out_f, _, _ = jh.run_training(n_trials=N_TRIALS, seed=SEED, faults=fp)
    _, _, meta = jh.make_experiment(instance_key=jax.random.PRNGKey(SEED),
                                    faults=fp)
    bl = j_screen(meta["core"], meta["ppu"])
    out_b, _, _ = jh.run_training(n_trials=N_TRIALS, seed=SEED, faults=fp,
                                  blacklist=bl)
    return (_trailing(out_c["mean_reward"]), _trailing(out_f["mean_reward"]),
            _trailing(out_b["mean_reward"], ~bl.neurons))


def test_recovery_under_faults():
    (clean, naive, screened), fp, bl = port_recovery()
    assert fp.total_sites >= 3
    np.testing.assert_array_equal(bl.rows, fp.dead_rows)
    np.testing.assert_array_equal(bl.neurons, fp.hot_neurons)
    # faults visibly degrade the naive all-column reward; after screening
    # the healthy-column reward recovers to near-clean
    assert naive < clean - 0.03, (naive, clean)
    assert screened > naive + 0.03, (screened, naive)
    assert screened > clean - 0.05, (screened, clean)


if __name__ == "__main__":
    for name, fn in (("reference", reference_recovery),
                     ("port", lambda: port_recovery()[0])):
        clean, naive, screened = fn()
        print(f"{name}: trailing mean reward clean {clean:.4f}, naive "
              f"{naive:.4f}, screened (healthy columns) {screened:.4f}")
