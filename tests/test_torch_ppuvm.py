"""The PPU-VM in the port against the reference.

- The copies of ``isa``, ``asm`` and ``programs`` give the reference's
  words, decodes and disassembly; the jax-free corpus generator
  (``tests/_torch_ppuvm.py``) gives ``tests/test_ppuvm_fuzz.py``'s.
- The port's ``run_program`` on the CPU (the plain version of the
  ``ppuvm_exec`` kernel) equals the reference's NumPy interpreter and its
  Pallas tile VM in interpret mode bit for bit (weights and registers),
  over the 200-program fuzz corpus, the edge corpus, an unknown-opcode
  program and the multi-tile prefixed case. The port's copy of
  ``run_program_np`` equals the original.
- ``VectorUnit.run_program`` / ``run_program_fixed`` /
  ``apply_rstdp_program`` equal the reference's on weights and registers,
  with xi replayed through ``convert.replay_rstdp_xi``.

Tolerance: everything here is integer and compared exactly, except the
mean reward of ``apply_rstdp_program`` (rtol = atol = 1e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ppuvm as corpus
import test_ppuvm_fuzz as ref_fuzz
from _torch_parity import close, t
from repro.configs.bss2 import BSS2 as J_BSS2
from repro.core.anncore import AnnCore as JAnnCore
from repro.core.ppu import VectorUnit as JVectorUnit
from repro.kernels.ppuvm_exec import ops as j_exec_ops
from repro.ppuvm import interp as j_interp
from repro.ppuvm import isa as j_isa
from repro.ppuvm import programs as j_programs
from repro.ppuvm.asm import Asm as JAsm
from repro.verif.mismatch import sample_instance
from repro_torch import convert, kernels
from repro_torch.configs.bss2 import BSS2
from repro_torch.core.ppu import VectorUnit, _to_fixed
from repro_torch.kernels.ppuvm_exec import ops as t_exec_ops
from repro_torch.ppuvm import interp, isa, programs
from repro_torch.ppuvm.asm import Asm

CFG = dataclasses.replace(BSS2.reduced(), n_rows=16, n_cols=16)
CFG_J = dataclasses.replace(J_BSS2.reduced(), n_rows=16, n_cols=16)

_jit_pallas = jax.jit(
    lambda words, w, qc, qa, rates, mod, noise: j_exec_ops.run_program_tiled(
        words, w, qc, qa, rates, mod, noise, interpret=True))


def _port(words, ops):
    """The port's run_program on CPU tensors, as numpy."""
    w, r = interp.run_program(
        torch.as_tensor(np.asarray(words, np.int32)),
        *(t(ops[k]) for k in ("weights", "qc", "qa", "rates")),
        None if ops.get("mod") is None else t(ops["mod"]),
        None if ops.get("noise") is None else t(ops["noise"]))
    assert w.dtype == torch.int32 and r.dtype == torch.int32
    return w.numpy(), r.numpy()


def _assert_all_equal(words, ops, ctx, pallas=True):
    """The port's run_program == the reference's run_program_np == the
    reference's Pallas tile VM (interpreted), weights and registers."""
    want = j_interp.run_program_np(words, **ops)
    outs = {"port": _port(words, ops),
            "port run_program_np": interp.run_program_np(words, **ops)}
    if pallas:
        outs["pallas"] = _jit_pallas(jnp.asarray(corpus.pad(words)),
                                     *(jnp.asarray(ops[k]) for k in (
                                         "weights", "qc", "qa", "rates",
                                         "mod", "noise")))
    for name, (w, r) in outs.items():
        np.testing.assert_array_equal(np.asarray(w), want[0],
                                      err_msg=f"{name} weights {ctx}")
        np.testing.assert_array_equal(np.asarray(r), want[1],
                                      err_msg=f"{name} registers {ctx}")


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------

class TestCopies:
    def test_isa_constants(self):
        for name in ("FRAC", "ONE", "I16MIN", "I16MAX", "WMAX", "N_OPS",
                     "N_REGS", "NOP", "SPLAT", "MOV", "ADD", "SUB", "MULF",
                     "SHL", "SHR", "CMPGE", "SEL", "MAXS", "MINS", "LDW",
                     "STW", "LDCAUSAL", "LDACAUSAL", "LDRATE", "LDMOD",
                     "LDNOISE"):
            assert getattr(isa, name) == getattr(j_isa, name), name
        assert isa.MNEMONIC == j_isa.MNEMONIC
        x = np.random.default_rng(0).uniform(-200, 200, 1000)
        np.testing.assert_array_equal(isa.to_fixed(x), j_isa.to_fixed(x))
        np.testing.assert_array_equal(isa.from_fixed(isa.to_fixed(x)),
                                      j_isa.from_fixed(j_isa.to_fixed(x)))
        for v in (*corpus.EDGE_SPLATS, 0.3, -7.77, 500.0):
            assert isa.splat_imm(v) == j_isa.splat_imm(v)

    @pytest.mark.parametrize("params", [
        dict(), dict(eta=0.5), dict(eta=16.0, cadc_max=127)])
    def test_rstdp_program_words(self, params):
        np.testing.assert_array_equal(programs.rstdp_program(**params),
                                      j_programs.rstdp_program(**params))

    @pytest.mark.parametrize("params", [
        dict(), dict(eta_plus=0.8, eta_minus=0.9), dict(cadc_max=63)])
    def test_stdp_program_words(self, params):
        np.testing.assert_array_equal(programs.stdp_program(**params),
                                      j_programs.stdp_program(**params))

    @pytest.mark.parametrize("params", [
        dict(target_rate=4.0), dict(target_rate=10.0, eta=0.2),
        dict(target_rate=130.0, eta=-1.5)])
    def test_homeostasis_program_words(self, params):
        np.testing.assert_array_equal(
            programs.homeostasis_program(**params),
            j_programs.homeostasis_program(**params))

    @pytest.mark.parametrize("params", [
        dict(eta=16.0, eta_homeo=0.4, fire_thresh=1.0),
        dict(eta=4.0, eta_homeo=0.1, fire_thresh=3.0, cadc_max=127)])
    def test_signed_dw_program_words(self, params):
        np.testing.assert_array_equal(programs.signed_dw_program(**params),
                                      j_programs.signed_dw_program(**params))

    def test_asm_every_emitter(self):
        def build(asm_cls):
            a = asm_cls()
            r = [a.reg(f"r{i}") for i in range(8)]
            a.nop().splat(r[0], -3.25).mov(r[1], r[0]).add(r[2], r[0], r[1])
            a.sub(r[3], r[2], r[1]).mulf(r[4], r[2], r[3], 5)
            a.shl(r[5], r[4], 3).shr(r[6], r[5], 9).cmpge(r[7], r[0], r[1])
            a.sel(r[7], r[1], r[2]).vmax(r[0], r[1], r[2])
            a.vmin(r[1], r[2], r[3]).ldw(r[2]).stw(r[3]).ldcausal(r[4])
            a.ldacausal(r[5]).ldrate(r[6]).ldmod(r[7], 3).ldnoise(r[0])
            with pytest.raises(ValueError, match="out of registers"):
                a.reg("ninth")
            return a.build(), a.disassemble()
        got, want = build(Asm), build(JAsm)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]

    def test_decode_and_disassemble_over_corpus(self):
        for seed, words, _ in corpus.corpus():
            for w in words.tolist():
                assert isa.decode(w) == j_isa.decode(w), (seed, w)
            assert isa.disassemble(words) == j_isa.disassemble(words)
        w = corpus.unknown_opcode_program()
        assert isa.disassemble(w) == j_isa.disassemble(w)
        for mod in (isa, j_isa):
            with pytest.raises(ValueError, match="unknown opcode"):
                mod.validate(w)

    def test_corpus_generator_matches_reference(self):
        """The jax-free generator yields tests/test_ppuvm_fuzz.py's
        programs and operands for the same seeds."""
        for seed in range(corpus.N_PROGRAMS):
            rng_a = np.random.RandomState(seed)
            rng_b = np.random.RandomState(seed)
            np.testing.assert_array_equal(corpus.gen_program(rng_a),
                                          ref_fuzz.gen_program(rng_b))
            edge = seed % 5 == 0
            a = corpus.gen_operands(rng_a, edge=edge)
            b = ref_fuzz.gen_operands(rng_b, edge=edge)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(
            corpus.pad(np.arange(1, 45, dtype=np.int32)),
            ref_fuzz._pad(np.arange(1, 45, dtype=np.int32)))

    def test_corpus_reaches_every_opcode(self):
        seen = set()
        for _, words, _ in corpus.corpus():
            seen |= set(((words.astype(np.int64) >> 26) & 0x3F).tolist())
        assert seen == set(range(isa.N_OPS))


# ---------------------------------------------------------------------------
# run_program: the port's plain version against the reference's executors
# ---------------------------------------------------------------------------

class TestRunProgram:
    @pytest.mark.parametrize("chunk", range(10))
    def test_fuzz_corpus(self, chunk):
        """20 seeds per case, 200 in all, bit for bit against the NumPy
        interpreter and the interpreted Pallas tile VM."""
        for seed, words, ops in list(corpus.corpus())[20 * chunk:
                                                      20 * chunk + 20]:
            _assert_all_equal(words, ops, f"(seed {seed})")

    @pytest.mark.parametrize("name", ["edge", "rstdp", "stdp", "homeostasis",
                                      "signed_dw"])
    def test_edge_corpus(self, name):
        words = (corpus.edge_program() if name == "edge"
                 else corpus.shipped_programs()[name])
        for seed in range(3):
            ops = corpus.gen_operands(np.random.RandomState(seed), edge=True)
            _assert_all_equal(words, ops, f"({name}, seed {seed})")
            if name == "edge":
                assert (_port(words, ops)[0] == 63).all()

    def test_unknown_opcode_is_nop(self):
        words = corpus.unknown_opcode_program()
        ops = corpus.gen_operands(np.random.RandomState(7))
        _assert_all_equal(words, ops, "(unknown opcodes)", pallas=False)
        w, r = _port(words, ops)
        assert (w == 5).all() and (r[1] == 0).all()

    @pytest.mark.parametrize("shape", [(16, 16), (2, 16, 16), (3, 40, 136)])
    def test_multi_tile_prefixed(self, shape):
        """test_ppuvm_fuzz.py::test_pallas_multi_tile_and_batched_prefix:
        the tile VM on a 2 x 2 grid of 8 x 8 tiles, with and without an
        instance prefix, against the port (and a ragged prefixed shape
        against the NumPy interpreter)."""
        for seed in range(8 if shape[-1] == 16 else 3):
            rng = np.random.RandomState(1000 + seed)
            words = corpus.pad(corpus.gen_program(rng))
            ops = corpus.prefixed_operands(rng, shape)
            want = j_interp.run_program_np(words, **ops)
            got = _port(words, ops)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            if shape[-1] == 16:
                wp, rp = j_exec_ops.run_program_tiled(
                    jnp.asarray(words), *(jnp.asarray(ops[k]) for k in (
                        "weights", "qc", "qa", "rates", "mod", "noise")),
                    rb=8, cb=8, interpret=True)
                np.testing.assert_array_equal(np.asarray(wp), got[0])
                np.testing.assert_array_equal(np.asarray(rp), got[1])

    def test_optional_operands_and_broadcast(self):
        """No mod / no noise, and qc/qa given as one row that broadcasts
        over the prefix (the reference's prepare_operands)."""
        rng = np.random.RandomState(3)
        ops = corpus.prefixed_operands(rng, (2, 8, 8))
        words = corpus.shipped_programs()["signed_dw"]
        for drop in ("mod", "noise"):
            o = dict(ops, **{drop: None})
            want = j_interp.run_program_np(words, **o)
            for a, b in zip(_port(words, o), want):
                np.testing.assert_array_equal(a, b, err_msg=drop)
        o = dict(ops, qc=ops["qc"][0], qa=ops["qa"][0, :1])
        want = j_interp.run_program_np(words, **o)
        for a, b in zip(_port(words, o), want):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("shape", [(3, 7, 37), (2, 5, 130)])
    def test_int8_weights_ragged_columns(self, shape):
        """The inputs of the card's ragged-lane cases
        (``test_torch_cuda.py::test_ppuvm_exec_ragged_lanes``): rows that
        are no multiple of the kernel's 4 lanes a thread, the weights given
        as int8 (the synapse store's type), against the NumPy interpreter
        on int32 weights."""
        rng = np.random.RandomState(shape[-1])
        for _ in range(3):
            words = corpus.pad(corpus.gen_program(rng))
            ops = corpus.prefixed_operands(rng, shape)
            want = j_interp.run_program_np(words, **ops)
            w8 = dict(ops, weights=ops["weights"].astype(np.int8))
            for a, b in zip(_port(words, w8), want):
                np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("op", range(isa.N_OPS + 1))
    def test_one_word_programs(self, op):
        """A single word of every opcode (and one past the last, a NOP) with
        random fields, as the card's ``test_ppuvm_exec_one_word_programs``
        draws them, against the NumPy interpreter."""
        rng = np.random.RandomState(op)
        ops = corpus.prefixed_operands(rng, (2, 3, 10))
        for _ in range(8):
            word = (op << 26) | int(rng.randint(0, 1 << 26))
            words = np.array([word], np.uint32).view(np.int32)
            want = j_interp.run_program_np(words, **ops)
            for a, b in zip(_port(words, ops), want):
                np.testing.assert_array_equal(a, b, err_msg=f"{word:#x}")

    def test_rates_to_fixed(self):
        r = np.array([0.0, 0.5, 1.5, 2.5, 127.0, 127.9, 128.0, 1000.0,
                      -3.5, -200.0], np.float32)
        np.testing.assert_array_equal(
            interp.rates_to_fixed(t(r)).numpy(),
            np.asarray(j_interp.rates_to_fixed(jnp.asarray(r))))

    def test_wrapper_counts_no_cpu_launch(self):
        """CPU tensors run the plain version: no kernel launch counted."""
        ops = corpus.gen_operands(np.random.RandomState(1))
        n0 = kernels.LAUNCHES["ppuvm_exec"]
        t_exec_ops.run_program(
            torch.as_tensor(corpus.shipped_programs()["rstdp"]),
            *(t(ops[k]) for k in ("weights", "qc", "qa", "rates", "mod",
                                  "noise")))
        assert kernels.LAUNCHES["ppuvm_exec"] == n0


# ---------------------------------------------------------------------------
# VectorUnit: run_program, run_program_fixed, apply_rstdp_program
# ---------------------------------------------------------------------------

def _state(prefix, seed):
    """A reference core state with spread weights, accumulators and rate
    counters (``tests/test_ppuvm.py::_machine_state``'s ranges)."""
    inst = jax.tree.map(np.asarray, sample_instance(
        CFG_J, jax.random.PRNGKey(seed), prefix))
    st = JAnnCore(CFG_J, inst).init_state(prefix)
    rng = np.random.default_rng(seed)
    shape = (*prefix, CFG.n_rows, CFG.n_cols)
    st = st._replace(
        syn=st.syn._replace(weights=rng.integers(5, 60, shape
                                                 ).astype(np.int8)),
        corr=st.corr._replace(
            a_causal=rng.uniform(0, 8, shape).astype(np.float32),
            a_acausal=rng.uniform(0, 8, shape).astype(np.float32)),
        rate_counters=rng.integers(0, 20, (*prefix, CFG.n_cols)
                                   ).astype(np.float32))
    return inst, jax.tree.map(np.asarray, st)


def _assert_state_equal(t_st, j_st):
    np.testing.assert_array_equal(t_st.syn.weights.numpy(),
                                  np.asarray(j_st.syn.weights))
    assert t_st.syn.weights.dtype == torch.int8
    assert not t_st.rate_counters.any()
    assert not t_st.corr.a_causal.any() and not t_st.corr.a_acausal.any()


class TestVectorUnit:
    @pytest.mark.parametrize("prefix", [(), (2,)])
    @pytest.mark.parametrize("rule", ["stdp", "homeostasis", "signed_dw"])
    def test_run_program(self, prefix, rule):
        inst, st = _state(prefix, seed=4)
        words = corpus.shipped_programs()[rule]
        rng = np.random.default_rng(5)
        mod = rng.uniform(-1.5, 1.5, (2, *prefix, CFG.n_cols)
                          ).astype(np.float32)
        noise = (0.3 * rng.standard_normal(
            (*prefix, CFG.n_rows, CFG.n_cols))).astype(np.float32)
        j_st, j_regs = JVectorUnit(CFG_J, inst).run_program(
            st, jnp.asarray(words), mod=jnp.asarray(mod),
            noise=jnp.asarray(noise))
        ppu = VectorUnit(CFG, convert.instance(inst, "cpu"))
        t_st, t_regs = ppu.run_program(
            convert.core_state(st, "cpu"), torch.as_tensor(words),
            mod=t(mod), noise=t(noise))
        np.testing.assert_array_equal(t_regs.numpy(), np.asarray(j_regs))
        _assert_state_equal(t_st, j_st)

    def test_run_program_fixed(self):
        inst, st = _state((3,), seed=6)
        words = corpus.shipped_programs()["rstdp"]
        rng = np.random.default_rng(6)
        mod_fp = isa.to_fixed(rng.uniform(-1, 1, (1, 3, CFG.n_cols)))
        noise_fp = isa.to_fixed(0.3 * rng.standard_normal(
            (3, CFG.n_rows, CFG.n_cols)))
        j_st, j_regs = JVectorUnit(CFG_J, inst).run_program_fixed(
            st, jnp.asarray(words), mod_fp=jnp.asarray(mod_fp),
            noise_fp=jnp.asarray(noise_fp))
        ppu = VectorUnit(CFG, convert.instance(inst, "cpu"))
        t_st, t_regs = ppu.run_program_fixed(
            convert.core_state(st, "cpu"), torch.as_tensor(words),
            mod_fp=t(mod_fp), noise_fp=t(noise_fp))
        np.testing.assert_array_equal(t_regs.numpy(), np.asarray(j_regs))
        _assert_state_equal(t_st, j_st)

    @pytest.mark.parametrize("prefix", [(), (2,)])
    def test_apply_rstdp_program(self, prefix):
        """The reference's own key; the port with the same xi replayed."""
        inst, st = _state(prefix, seed=7)
        rng = np.random.default_rng(7)
        reward = (rng.random((*prefix, CFG.n_cols)) < 0.5).astype(np.float32)
        mean_r = rng.uniform(0, 1, (*prefix, CFG.n_cols)).astype(np.float32)
        key = jax.random.PRNGKey(9)
        words = programs.rstdp_program(eta=0.5)
        j_st, j_rs, j_regs = JVectorUnit(CFG_J, inst).apply_rstdp_program(
            st, dict(mean_reward=mean_r, key=key), reward=reward,
            program=jnp.asarray(words), gamma=0.3, noise=0.3)
        next_key, xi = convert.replay_rstdp_xi(
            jax.random, key, st.syn.weights.shape, 0.3, device="cpu")
        np.testing.assert_array_equal(np.asarray(next_key),
                                      np.asarray(j_rs["key"]))
        ppu = VectorUnit(CFG, convert.instance(inst, "cpu"))
        t_st, t_rs, t_regs = ppu.apply_rstdp_program(
            convert.core_state(st, "cpu"), dict(mean_reward=t(mean_r)),
            reward=t(reward), program=torch.as_tensor(words), gamma=0.3,
            noise=0.3, xi=xi)
        np.testing.assert_array_equal(t_regs.numpy(), np.asarray(j_regs))
        _assert_state_equal(t_st, j_st)
        close(t_rs["mean_reward"], j_rs["mean_reward"])
        assert set(t_rs) == {"mean_reward"}

    def test_apply_rstdp_program_generator(self):
        """Without an injected plane the walk comes from the generator:
        the same seed gives the same update, and no xi at all raises."""
        inst, st = _state((), seed=8)
        ppu = VectorUnit(CFG, convert.instance(inst, "cpu"))
        st_t = convert.core_state(st, "cpu")
        words = torch.as_tensor(programs.rstdp_program())
        kw = dict(reward=torch.ones(CFG.n_cols), program=words)
        outs = [ppu.apply_rstdp_program(
            st_t, dict(mean_reward=torch.zeros(CFG.n_cols)),
            generator=torch.Generator().manual_seed(1), **kw)
            for _ in range(2)]
        assert torch.equal(outs[0][0].syn.weights, outs[1][0].syn.weights)
        with pytest.raises(ValueError, match="xi"):
            ppu.apply_rstdp_program(
                st_t, dict(mean_reward=torch.zeros(CFG.n_cols)), **kw)

    def test_to_fixed(self):
        x = np.concatenate([
            np.random.default_rng(0).uniform(-140, 140, 2000),
            np.arange(-8, 8) / 512.0 + 0.5 / 256]).astype(np.float32)
        from repro.core.ppu import _to_fixed_j
        np.testing.assert_array_equal(_to_fixed(t(x)).numpy(),
                                      np.asarray(_to_fixed_j(x)))
