"""The port's ``ServeEngine`` (``repro_torch.serve.engine``) against the
reference's, with the reference's parameters carried over:

* ``generate`` on every reduced served arch: greedy tokens equal to the
  reference's, a token allowed to differ only where the reference's
  top-2 logit gap is under the house tolerance 1e-4 (a near tie), and
  then only from that step on;
* the mirrors of ``tests/test_runtime.py::TestServe``: shapes and
  determinism, the KV-overrun guard, fresh draws per call without a
  generator and reproducible ones with one; encoders refused; the
  ``prefill`` / ``decode`` spans on a ``PhaseTimer``;
* the reference's cache-growth fault: its engine grows every 4-D cache
  leaf whose second dim equals prompt + prefix, so an SSM state [b, nh,
  d_state, head_dim] is padded when prompt + prefix == nh and its decode
  fails; the port grows the ``kv`` entries only and serves that prompt;
* ``python -m repro_torch.launch.serve --device cpu --smoke``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import setup
from repro.config import ASSIGNED_ARCHS
from repro.config import get_arch as ref_arch
from repro.models.transformer import prefix_len
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.config import get_arch as port_arch
from repro_torch.obs.timing import PhaseTimer
from repro_torch.parallel.sharding import init_params
from repro_torch.serve.engine import ServeEngine

REPO = Path(__file__).resolve().parent.parent
SERVED = [a for a in ASSIGNED_ARCHS if not ref_arch(a).is_encoder_only]
GAP_TOL = 1e-4


def _ref_greedy_logits(rb, rp, prompts, n_new, total):
    """The reference's greedy run step by step (its bundle, its cache
    grown as its engine grows it): the logits that chose each token."""
    from _torch_lm import grow_ref
    logits, cache = jax.jit(rb.prefill)(rp, dict(tokens=prompts))
    cache = grow_ref(cache, total, total + n_new)
    out = [np.asarray(logits[:, -1])]
    step = jax.jit(rb.decode_step)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    for i in range(n_new - 1):
        logits, cache = step(rp, cache, tok, jnp.int32(total + i))
        out.append(np.asarray(logits[:, -1]))
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    return np.stack(out, 1)                     # [b, n_new, V]


@pytest.mark.parametrize("name", SERVED)
def test_generate_equals_the_reference(name):
    ra, rb, rp, pa, pb, pp = setup(name)
    prompts = np.random.default_rng(3).integers(0, ra.vocab, (2, 12))
    n_new = 6
    max_len = 12 + prefix_len(ra) + n_new + 2
    ref = RefEngine(ra, max_len=max_len).generate(
        rp, jnp.asarray(prompts, jnp.int32), n_new=n_new)
    out = ServeEngine(pa, max_len=max_len, device="cpu").generate(
        pp, prompts, n_new=n_new)
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, n_new)
    out = out.numpy()
    if np.array_equal(out, ref):
        return
    # a flip is allowed only at a near tie of the reference's logits, and
    # each request is compared up to its first flip
    logits = _ref_greedy_logits(rb, rp, jnp.asarray(prompts, jnp.int32),
                                n_new, 12 + prefix_len(ra))
    for r in range(out.shape[0]):
        diff = np.nonzero(out[r] != ref[r])[0]
        if len(diff):
            top2 = np.sort(logits[r, diff[0]])[-2:]
            assert top2[1] - top2[0] < GAP_TOL, (name, r, diff[0], top2)


ARCH = port_arch("qwen1.5-0.5b").reduced()


def _engine(max_len=64, arch=ARCH):
    eng = ServeEngine(arch, max_len=max_len, device="cpu")
    params = init_params(eng.bundle.decls, torch.Generator().manual_seed(0),
                         device="cpu")
    return eng, params


class TestServe:
    def test_generate_shapes_and_determinism(self):
        eng, params = _engine()
        prompts = torch.ones((2, 8), dtype=torch.int32)
        out1 = eng.generate(params, prompts, n_new=6)
        out2 = eng.generate(params, prompts, n_new=6)
        assert tuple(out1.shape) == (2, 6)
        assert torch.equal(out1, out2)
        assert (out1 < ARCH.vocab_padded).all()

    def test_generate_rejects_kv_cache_overrun(self):
        eng, params = _engine(max_len=16)
        prompts = torch.ones((1, 8), dtype=torch.int32)
        fits = 16 - 8 - prefix_len(ref_arch("qwen1.5-0.5b").reduced())
        out = eng.generate(params, prompts, n_new=fits)
        assert tuple(out.shape) == (1, fits)
        with pytest.raises(ValueError, match="overruns the KV cache"):
            eng.generate(params, prompts, n_new=fits + 1)

    def test_sampling_without_generator_differs_per_call(self):
        eng, params = _engine()
        prompts = torch.ones((4, 8), dtype=torch.int32)
        outs = [eng.generate(params, prompts, n_new=8, temperature=5.0)
                for _ in range(3)]
        assert any(not torch.equal(outs[0], o) for o in outs[1:]), \
            "sampling without a generator repeated its draws across calls"
        a = eng.generate(params, prompts, n_new=8, temperature=5.0,
                         generator=torch.Generator().manual_seed(7))
        b = eng.generate(params, prompts, n_new=8, temperature=5.0,
                         generator=torch.Generator().manual_seed(7))
        assert torch.equal(a, b)
        # sampled tokens stay within the real vocabulary
        assert int(a.max()) < ARCH.vocab

    def test_encoder_is_refused(self):
        with pytest.raises(ValueError, match="encoder"):
            ServeEngine(port_arch("hubert-xlarge").reduced(), device="cpu")

    def test_timer_records_prefill_and_decode(self):
        eng, params = _engine()
        timer = PhaseTimer("cpu")
        out = eng.generate(params, torch.ones((2, 8), dtype=torch.int32),
                           n_new=3, timer=timer)
        assert tuple(out.shape) == (2, 3)
        s = timer.summary()
        assert s["prefill"]["count"] == 1 and s["decode"]["count"] == 1

    def test_no_device_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(ARCH)


class TestReferenceCacheGrowthFault:
    """Reduced mamba2-130m has nh = 8 SSM heads. An 8-token prompt (prompt
    + prefix == nh) makes the reference's engine pad the SSM state as if
    it were a KV cache, and its decode step raises; a 7-token prompt is
    served by both with the same tokens."""

    def _both(self, s0):
        ra, rb, rp, pa, pb, pp = setup("mamba2-130m")
        from repro.models.ssm import ssm_dims
        assert ssm_dims(ra)[1] == 8
        prompts = np.random.default_rng(4).integers(0, ra.vocab, (2, s0))
        port = ServeEngine(pa, max_len=32, device="cpu").generate(
            pp, prompts, n_new=4)
        return ra, rp, prompts, port

    def test_prompt_equal_to_heads_crashes_the_reference_only(self):
        ra, rp, prompts, port = self._both(8)
        assert tuple(port.shape) == (2, 4)
        with pytest.raises(TypeError, match="incompatible shapes"):
            RefEngine(ra, max_len=32).generate(
                rp, jnp.asarray(prompts, jnp.int32), n_new=4)

    def test_other_prompts_agree(self):
        ra, rp, prompts, port = self._both(7)
        ref = RefEngine(ra, max_len=32).generate(
            rp, jnp.asarray(prompts, jnp.int32), n_new=4)
        np.testing.assert_array_equal(port.numpy(), ref)


def test_launch_serve_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "hymba-1.5b", "--smoke", "--device", "cpu", "--batch", "2",
         "--prompt-len", "12", "--new", "4"],
        env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "2x4 tokens in" in r.stdout, r.stdout
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--ckpt-dir", "x"],
        env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode != 0 and "no checkpoint in x" in r.stderr
