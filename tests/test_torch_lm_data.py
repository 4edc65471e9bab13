"""The port's synthetic pipeline, 8-bit error feedback and checkpoints
against the reference's, on the CPU.

* ``SyntheticLMPipeline``: tokens, labels, audio frames and patch
  embeddings equal to the reference's for every (seed, step, shard);
* ``compress`` / ``ef_compress_grads``: codes equal, except where the
  quotient lies within rounding of a half-way point (counted);
* checkpoints: the reference's on-disk format both ways (a checkpoint of
  either package restores in the other), ``CheckpointManager``'s keep /
  gc and async writes.

Then mirrors of ``tests/test_runtime.py``'s ``TestPipeline`` and
``TestCompression`` and ``tests/test_properties.py``'s ``TestCompression``
and ``TestCheckpointTree``.
"""
import dataclasses
import shutil
from collections import Counter

import hypothesis.extra.numpy as hnp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.checkpoint import ckpt as RC
from repro.config import ShapeConfig as RefShape
from repro.config import get_arch as ref_arch
from repro.data.pipeline import SyntheticLMPipeline as RefPipe
from repro.parallel import compress as RG
from repro.train.optimizer import AdamWConfig as RefAdamW
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro_torch.checkpoint import ckpt as PC
from repro_torch.config import ShapeConfig, get_arch
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.parallel import compress as gc
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

SHAPE = ShapeConfig("smoke", 32, 4, "train")
REF_SHAPE = RefShape("smoke", 32, 4, "train")
ARCH = get_arch("smollm-360m").reduced()


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["smollm-360m", "internvl2-2b",
                                  "hubert-xlarge", "hymba-1.5b"])
@pytest.mark.parametrize("seed,shard,num_shards", [(0, 0, 1), (3, 1, 2),
                                                   (7, 0, 2)])
def test_pipeline_equals_reference(name, seed, shard, num_shards):
    """Three consecutive batches, every field, equal in value and dtype
    (frames for the encoder, patch embeddings for the VLM, tokens cut by
    the meta prefix for hymba)."""
    rp = RefPipe(ref_arch(name).reduced(), REF_SHAPE, seed=seed,
                 shard_index=shard, num_shards=num_shards)
    pp = SyntheticLMPipeline(get_arch(name).reduced(), SHAPE, seed=seed,
                             shard_index=shard, num_shards=num_shards)
    for _ in range(3):
        rb, pb = rp.next_batch(), pp.next_batch("cpu")
        assert set(rb) == set(pb)
        for k in rb:
            r = np.asarray(rb[k])
            assert pb[k].device.type == "cpu"
            assert pb[k].numpy().dtype == r.dtype, k
            np.testing.assert_array_equal(pb[k].numpy(), r, err_msg=k)
    assert pp.step == rp.step == 3


def test_pipeline_state_dict_roundtrip():
    """The cursor (int64 seed and step) restores the batch sequence, in
    either package, also from 0-d tensors (a restored checkpoint's)."""
    p = SyntheticLMPipeline(ARCH, SHAPE, seed=5)
    p.next_batch("cpu")
    p.next_batch("cpu")
    st_ = p.state_dict()
    assert st_["seed"].dtype == np.int64 and st_["step"].dtype == np.int64
    rp = RefPipe(ref_arch("smollm-360m").reduced(), REF_SHAPE, seed=5)
    rp.load_state_dict(st_)
    q = SyntheticLMPipeline(ARCH, SHAPE, seed=5)
    q.load_state_dict(dict(seed=torch.tensor(5), step=torch.tensor(2)))
    want = p.next_batch("cpu")["tokens"].numpy()
    np.testing.assert_array_equal(q.next_batch("cpu")["tokens"].numpy(),
                                  want)
    np.testing.assert_array_equal(np.asarray(rp.next_batch()["tokens"]),
                                  want)


def test_loaded_seed_keeps_the_constructed_chain():
    """The Markov chain is drawn from the seed at construction; a cursor
    with another seed changes the per-step draws only. The reference does
    the same (``repro/data/pipeline.py:34-49``), and the port keeps it."""
    rp = RefPipe(ref_arch("smollm-360m").reduced(), REF_SHAPE, seed=0)
    q = SyntheticLMPipeline(ARCH, SHAPE, seed=0)
    fresh = SyntheticLMPipeline(ARCH, SHAPE, seed=5)
    for pipe in (rp, q):
        pipe.load_state_dict(dict(seed=np.int64(5), step=np.int64(0)))
    toks = q.next_batch("cpu")["tokens"].numpy()
    np.testing.assert_array_equal(np.asarray(rp.next_batch()["tokens"]),
                                  toks)
    assert not np.array_equal(fresh.next_batch("cpu")["tokens"].numpy(),
                              toks)


class TestPipeline:
    def test_deterministic_and_resumable(self):
        p1 = SyntheticLMPipeline(ARCH, SHAPE, seed=3)
        b1 = [p1.next_batch("cpu") for _ in range(3)]
        p2 = SyntheticLMPipeline(ARCH, SHAPE, seed=3)
        p2.load_state_dict(dict(seed=np.int64(3), step=np.int64(2)))
        b2 = p2.next_batch("cpu")
        assert torch.equal(b1[2]["tokens"], b2["tokens"])

    def test_shards_disjoint_cursor_consistent(self):
        a = SyntheticLMPipeline(ARCH, SHAPE, seed=1, shard_index=0,
                                num_shards=2)
        b = SyntheticLMPipeline(ARCH, SHAPE, seed=1, shard_index=1,
                                num_shards=2)
        ba, bb = a.next_batch("cpu"), b.next_batch("cpu")
        assert ba["tokens"].shape[0] == SHAPE.global_batch // 2
        assert not torch.equal(ba["tokens"], bb["tokens"])

    def test_learnable_structure(self):
        """Markov structure => bigram MI > 0 (a model can learn it)."""
        p = SyntheticLMPipeline(ARCH, SHAPE, seed=0)
        toks = p.next_batch("cpu")["tokens"].numpy().ravel()
        pairs = Counter(zip(toks[:-1], toks[1:]))
        uni = Counter(toks)
        n = len(toks) - 1
        mi = 0.0
        for (x, y), c in pairs.items():
            pxy = c / n
            mi += pxy * np.log(pxy / (uni[x] / n * uni[y] / n) + 1e-12)
        assert mi > 0.1, mi


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def _half_way(g, scale):
    """Elements whose quotient g / scale lies within rounding (1e-5
    relative) of a half-way point, where the two packages may round
    apart."""
    q = np.asarray(g, np.float64) / np.float64(scale)
    return np.abs(np.abs(q - np.floor(q)) - 0.5) < 1e-5 * np.maximum(
        1.0, np.abs(q))


@pytest.mark.parametrize("bits", [8, 4])
def test_compress_matches_reference(bits):
    rng = np.random.default_rng(bits)
    g = (rng.standard_normal(4096) * 3).astype(np.float32)
    # quotients exactly at half-way points: both round half to even
    g[:8] = np.float32(2.5) * np.float32(np.abs(g).max() / (2 ** (bits - 1)
                                                            - 1))
    rq, rs = RG.compress(jnp.asarray(g), bits)
    pq, ps = gc.compress(torch.from_numpy(g), bits)
    assert pq.dtype == torch.int8
    np.testing.assert_allclose(float(ps), float(rs), rtol=1e-7)
    diff = pq.numpy().astype(np.int32) != np.asarray(rq).astype(np.int32)
    assert (np.abs(pq.numpy().astype(np.int32)
                   - np.asarray(rq).astype(np.int32)) <= 1).all()
    assert not (diff & ~_half_way(g, float(rs))).any()
    np.testing.assert_allclose(gc.decompress(pq, ps).numpy(),
                               np.asarray(RG.decompress(rq, rs)),
                               atol=float(rs) * diff.any() + 1e-7)


def test_ef_compress_grads_matches_reference():
    """Ten steps of error feedback on a two-leaf tree: the returned
    gradients and the residuals against the reference's. A code that
    differs by one at a half-way quotient moves one gradient element by
    one step and its residual by the same, so the residuals are held to
    one quantization step there, and such codes are counted."""
    rng = np.random.default_rng(0)
    shapes = dict(a=(64,), b=dict(c=(8, 16)))
    zeros = jax.tree.map(lambda s: np.zeros(s, np.float32), shapes,
                         is_leaf=lambda x: isinstance(x, tuple))
    r_err = jax.tree.map(jnp.asarray, zeros)
    p_err = gc.ef_init(jax.tree.map(torch.from_numpy, zeros))
    flips = 0
    for _ in range(10):
        g = jax.tree.map(lambda s: (rng.standard_normal(s) * 0.01).astype(
            np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))
        r_g, r_err = RG.ef_compress_grads(jax.tree.map(jnp.asarray, g),
                                          r_err)
        p_g, p_err = gc.ef_compress_grads(jax.tree.map(torch.from_numpy, g),
                                          p_err)
        for r, p in zip(jax.tree.leaves(r_g), jax.tree.leaves(p_g)):
            step = np.abs(np.asarray(r)).max() / 127
            d = np.abs(p.numpy() - np.asarray(r))
            assert (d <= step * 1.001 + 1e-12).all()
            flips += int((d > 1e-6 * step).sum())
        for r, p in zip(jax.tree.leaves(r_err), jax.tree.leaves(p_err)):
            step = 0.01 * 5 / 127
            np.testing.assert_allclose(p.numpy(), np.asarray(r),
                                       atol=step if flips else 1e-7)
    assert flips <= 2, flips


class TestCompression:
    def test_error_feedback_recovers_signal(self):
        """EF quantization: the running sum of compressed grads tracks the
        running sum of true grads (the residual stays bounded)."""
        gen = torch.Generator().manual_seed(0)
        err = dict(g=torch.zeros(64))
        total_true = torch.zeros(64)
        total_comp = torch.zeros(64)
        for _ in range(50):
            g = dict(g=torch.randn(64, generator=gen) * 0.01)
            comp, err = gc.ef_compress_grads(g, err, bits=8)
            total_true += g["g"]
            total_comp += comp["g"]
        resid = float((total_true - total_comp).abs().max())
        assert resid < 0.01, resid

    def test_compress_roundtrip_accuracy(self):
        g = torch.randn(1024, generator=torch.Generator().manual_seed(1))
        q, s = gc.compress(g, bits=8)
        back = gc.decompress(q, s)
        rel = float((back - g).abs().max() / g.abs().max())
        assert rel < 1.0 / 120  # half a quantization step

    @given(hnp.arrays(np.float32, st.integers(1, 256).map(lambda n: (n,)),
                      elements=st.floats(-1e3, 1e3, allow_nan=False,
                                         width=32)))
    @settings(max_examples=40, deadline=None)
    def test_roundtrip_error_bounded_by_half_step(self, g):
        q, s = gc.compress(torch.from_numpy(g), bits=8)
        back = gc.decompress(q, s).numpy()
        assert np.abs(back - g).max() <= float(s) * 0.5 + 1e-6


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

_tree_strategy = st.recursive(
    st.dictionaries(st.text(st.characters(min_codepoint=97,
                                          max_codepoint=122),
                            min_size=1, max_size=4),
                    st.just(np.arange(3)), min_size=1, max_size=3),
    lambda children: st.dictionaries(
        st.text(st.characters(min_codepoint=97, max_codepoint=122),
                min_size=1, max_size=4), children, min_size=1, max_size=3),
    max_leaves=8)


class TestCheckpointTree:
    @given(_tree_strategy)
    @settings(max_examples=40, deadline=None)
    def test_flatten_unflatten_roundtrip(self, tree):
        back = PC._unflatten(PC._flatten(tree))
        assert PC._flatten(tree) == RC._flatten(tree)

        def eq(a, b):
            if isinstance(a, dict):
                assert set(a) == set(b)
                for k in a:
                    eq(a[k], b[k])
            else:
                np.testing.assert_array_equal(a, b)
        eq(tree, back)


def _ref_cfg(d, steps):
    return RefTrainerConfig(steps=steps, ckpt_every=4, ckpt_dir=d,
                            log_every=100,
                            opt=RefAdamW(lr=1e-3, warmup_steps=2))


def _port_cfg(d, steps, **kw):
    return TrainerConfig(steps=steps, ckpt_every=4, ckpt_dir=d,
                         log_every=100,
                         opt=AdamWConfig(lr=1e-3, warmup_steps=2), **kw)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's ``Trainer`` trains 8 steps straight, checkpointing
    at 4 and 8. The port's ``Trainer`` resumes from the step-4 checkpoint
    alone (its parameters, moments and data cursor) and finishes the 8
    steps: its parameters match the reference's straight run within
    atol = 1e-3 (the lr: AdamW moves each parameter by ~lr sign(g) a step,
    and a gradient element within rounding of 0 may take the other sign
    in one package), all but a few elements within 1e-5."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    out_r = RefTrainer(ref_arch("smollm-360m").reduced(), REF_SHAPE,
                       _ref_cfg(str(ref_dir), 8)).train()
    assert RC.latest_step(ref_dir) == 8
    port_dir.mkdir()
    shutil.copy(ref_dir / "step_00000004.npz", port_dir)
    tr = Trainer(ARCH, SHAPE, _port_cfg(str(port_dir), 8), device="cpu")
    out_p = tr.train()
    assert [h["step"] for h in out_p["history"]] == [4, 5, 6, 7]
    for h_p, h_r in zip(out_p["history"], out_r["history"][4:]):
        np.testing.assert_allclose(h_p["loss"], h_r["loss"], rtol=1e-4)
    loose = 0
    for r, p in zip(jax.tree.leaves(out_r["params"]),
                    jax.tree.leaves(out_p["params"])):
        err = np.abs(p.numpy() - np.asarray(r))
        assert err.max() <= 1e-3, err.max()
        loose += int((err > 1e-5).sum())
    assert loose <= 16, loose
    assert int(out_p["opt"]["step"]) == 8


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """A port checkpoint (``Trainer`` with error feedback, 4 steps) loads
    under the reference's ``restore_checkpoint`` with the same keys,
    dtypes and values, and the reference's ``Trainer`` resumes from it."""
    tr = Trainer(ARCH, SHAPE, _port_cfg(str(tmp_path), 4,
                                        grad_compress_bits=8), device="cpu")
    out = tr.train()
    step, ref_state = RC.restore_checkpoint(tmp_path)
    pstep, port_state = PC.restore_checkpoint(tmp_path, device="cpu")
    assert step == pstep == 4
    flat_r, flat_p = RC._flatten(ref_state), PC._flatten(port_state)
    assert set(flat_r) == set(flat_p)
    assert flat_r["opt/step"].dtype == np.int32
    assert flat_r["data/seed"].dtype == flat_r["data/step"].dtype == np.int64
    assert int(flat_r["data/step"]) == 4
    assert any(k.startswith("err/") for k in flat_r)
    for k, v in flat_r.items():
        assert flat_p[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(flat_p[k].numpy(), v, err_msg=k)
    for a, b in zip(jax.tree.leaves(out["params"]),
                    jax.tree.leaves(ref_state["params"])):
        np.testing.assert_array_equal(a.numpy(), b)
    ref_out = RefTrainer(ref_arch("smollm-360m").reduced(), REF_SHAPE,
                         dataclasses.replace(_ref_cfg(str(tmp_path), 5),
                                             grad_compress_bits=8)).train()
    assert [h["step"] for h in ref_out["history"]] == [4]


def test_checkpoint_manager_keep_gc_and_async(tmp_path):
    """``keep`` newest checkpoints survive; an async save snapshots its
    state at the call (later in-place updates do not reach the file), and
    ``wait`` joins the writer and re-raises a failed write."""
    mgr = PC.CheckpointManager(tmp_path, keep=2, async_save=True)
    x = torch.zeros(1000)
    for step in range(1, 5):
        x.fill_(step)
        mgr.save(step, dict(params=dict(x=x)), meta=dict(step=step))
        x.fill_(-1.0)                  # after the snapshot
    mgr.wait()
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["step_00000003.meta.json", "step_00000003.npz",
                     "step_00000004.meta.json", "step_00000004.npz"]
    step, state = mgr.restore_latest(device="cpu")
    assert step == 4 and torch.equal(state["params"]["x"],
                                     torch.full((1000,), 4.0))
    _, s3 = PC.restore_checkpoint(tmp_path, step=3, device="cpu")
    assert float(s3["params"]["x"][0]) == 3.0
    assert PC.restore_checkpoint(tmp_path / "none", device="cpu") == (None,
                                                                      None)
    bad = PC.CheckpointManager(tmp_path / "file", async_save=True)
    (tmp_path / "file").write_text("not a directory")
    bad.save(1, dict(x=torch.zeros(2)))
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()                         # the error is raised once


def test_restore_with_shardings_places_on_a_mesh(tmp_path):
    """A checkpoint the reference wrote, restored with ``shardings=``
    onto a (1, 1) mesh of a one-rank gloo world (the many-rank cases are
    in ``tests/test_torch_lm_mesh.py``): the named leaves are DTensors on
    the mesh with their placements, equal to the plain restore; the
    unnamed ones plain tensors; a DTensor state saved again (gathered,
    written by rank 0) equals the first file."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.parallel.sharding import (ParamDecl, ShardingCtx,
                                               tree_pspecs)
    decls = dict(w=ParamDecl((4, 6), ("embed", "ff")),
                 b=dict(c=ParamDecl((6,), (None,))))
    rng = np.random.default_rng(0)
    state = dict(params=dict(w=rng.standard_normal((4, 6)).astype(
        np.float32), b=dict(c=np.arange(6, dtype=np.float32))),
        data=dict(step=np.int64(3)))
    RC.save_checkpoint(tmp_path / "ref", 1, state)
    _, plain = PC.restore_checkpoint(tmp_path / "ref", device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        ctx = ShardingCtx(mesh=make_smoke_mesh((1, 1), device_type="cpu"))
        step, st = PC.restore_checkpoint(
            tmp_path / "ref", shardings=dict(params=tree_pspecs(decls, ctx)))
        assert step == 1
        for got, want, d in ((st["params"]["w"], plain["params"]["w"],
                              decls["w"]),
                             (st["params"]["b"]["c"], plain["params"]["b"][
                                 "c"], decls["b"]["c"])):
            assert isinstance(got, DTensor) and got.device_mesh == ctx.mesh
            assert tuple(got.placements) == ctx.param_sharding(d.axes,
                                                               d.shape)
            assert torch.equal(got.full_tensor(), want)
        assert not isinstance(st["data"]["step"], DTensor)
        assert int(st["data"]["step"]) == 3
        PC.save_checkpoint(tmp_path / "again", 1, st)
    finally:
        dist.destroy_process_group()
    with np.load(tmp_path / "ref" / "step_00000001.npz") as a, \
            np.load(tmp_path / "again" / "step_00000001.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
