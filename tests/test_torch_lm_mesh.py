"""The LM on a device mesh (path I): four gloo ranks on a (2, 2) mesh over
(``data``, ``model``), against the port without a mesh and against the
reference.

The ranks run ``tests/_torch_lm_mesh.py`` (every part, once: DTensor's
sharding propagation is slow on first use of each op, so one run of four
processes serves every case), joined through a file store under the
test's own temporary directory, each with a time limit. The reference's
numbers are made here and handed over as numpy files:

  * the six families' logits and loss: the reference without a mesh
    (``tests/_torch_lm.py::setup``'s parameters), at rtol = atol = 1e-4
    (a mesh changes only the order of sums);
  * the MoE layer: the reference's ``moe_ffn_ep`` and ``moe_ffn`` under a
    fake-device (2, 2) mesh, in a subprocess with
    ``--xla_force_host_platform_device_count=4`` as the reference's own
    mesh tests run (``tests/test_moe_ep.py``): the capacity depends on the
    data-parallel size, so a no-mesh reference is the wrong oracle. ``y``
    and the gradients at 1e-4, ``aux`` at 1e-5;
  * a checkpoint the reference wrote (``repro.checkpoint``), restored
    onto the port's mesh;
  * for the ``seq`` part, the six families and the reduced moonshot at
    ``SEQ_TOTAL`` positions: logits, loss and every parameter's gradient
    of the reference without a mesh, at rtol = atol = 1e-4.

The ``seq`` part (the sequence split over ``model``) runs on a (1, 4)
mesh in the 4-rank run and on (1, 2) beside the reshard in the 2-rank
run.

Counterparts of ``tests/test_moe_ep.py::test_moe_ep_matches_gspmd_
subprocess``, ``tests/test_runtime.py::test_elastic_reshard_subprocess``
and ``::test_serve_engine_applies_decl_shardings_subprocess``.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

import _torch_lm_mesh as H
from _torch_lm import setup

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
TIMEOUT_S = 240

MOE_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro.config import MoEConfig, get_arch
    from repro.launch.mesh import make_smoke_mesh
    from repro.models import moe as M
    from repro.parallel.sharding import ShardingCtx, init_params

    arch = dataclasses.replace(
        get_arch("moonshot-v1-16b-a3b").reduced(), d_model=32,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16,
                      n_shared_experts=1, capacity_factor=8.0))
    mesh = make_smoke_mesh((2, 2), ("data", "model"))
    ctx = ShardingCtx(mesh=mesh)
    p = init_params(M.moe_decls(arch), jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, 32))
    out = dict(x=np.asarray(x))
    for k, v in jax.tree_util.tree_flatten_with_path(p)[0]:
        out["p/" + "/".join(e.key for e in k)] = np.asarray(v)
    for impl, fn in (("ep", M.moe_ffn_ep), ("gspmd", M.moe_ffn)):
        def loss(pp):
            y, aux = fn(x, pp, arch, ctx)
            return jnp.sum(y ** 2) + aux
        with mesh:
            y, aux = jax.jit(lambda xx, pp: fn(xx, pp, arch, ctx))(x, p)
            g = jax.jit(jax.grad(loss))(p)
        out[f"y_{impl}"] = np.asarray(y)
        out[f"aux_{impl}"] = np.asarray(aux)
        for k, v in jax.tree_util.tree_flatten_with_path(g)[0]:
            out[f"g_{impl}/" + "/".join(e.key for e in k)] = np.asarray(v)
    np.savez(sys.argv[1], **out)
    print("MOE_REF_OK")
""")


def _reference_data(data: Path):
    """The reference's numbers, as numpy files in ``data`` (``READY``
    written last)."""
    moe = subprocess.Popen(
        [sys.executable, "-c", MOE_REF, str(data / "moe.npz")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    for name in H.FAMILIES:
        ra, rb, rp, pa, _, _ = setup(name)
        b = H.family_batch(pa)
        rbatch = {k: jax.numpy.asarray(v) for k, v in b.items()}
        out = {f"p/{k}": np.asarray(v) for k, v in
               H.flatten(jax.tree.map(np.asarray, rp)).items()}
        out.update({f"b/{k}": v for k, v in b.items()})
        if pa.family != "audio":
            out["logits"] = np.asarray(jax.jit(rb.forward)(rp, rbatch)[0])
        out["loss"] = np.asarray(jax.jit(rb.loss)(rp, rbatch))
        np.savez(data / f"fam_{name}.npz", **out)
    for name in H.ARCHS:
        ra, rb, rp, pa, _, _ = setup(name)
        b = H.seq_batch(pa)
        rbatch = {k: jax.numpy.asarray(v) for k, v in b.items()}
        out = {f"p/{k}": np.asarray(v) for k, v in
               H.flatten(jax.tree.map(np.asarray, rp)).items()}
        out.update({f"b/{k}": v for k, v in b.items()})
        if pa.family != "audio":
            out["logits"] = np.asarray(jax.jit(rb.forward)(rp, rbatch)[0])
        loss, g = jax.jit(jax.value_and_grad(rb.loss))(rp, rbatch)
        out["loss"] = np.asarray(loss)
        out.update({f"g/{k}": v for k, v in
                    H.flatten(jax.tree.map(np.asarray, g)).items()})
        np.savez(data / f"seq_{name}.npz", **out)
    from repro.checkpoint import save_checkpoint
    save_checkpoint(data / "ref_ckpt", 1, dict(params=setup(
        "smollm-360m")[2]))
    out, err = moe.communicate(timeout=TIMEOUT_S)
    assert "MOE_REF_OK" in out, out[-2000:] + err[-3000:]
    (data / "READY").touch()


def _run_ranks(store, world, part, data, meanwhile=None):
    """Start ``world`` ranks of the helper on ``part``, run ``meanwhile``
    (if given) while they work; their exit codes and outputs."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "_torch_lm_mesh.py"), str(rank),
         str(world), str(store), "gloo", part, str(data)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(world)]
    outs = []
    try:
        if meanwhile is not None:
            meanwhile()
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every part on a world of 4 ranks, then the reshard onto a world of
    2: ``{(world, part): [rank outputs]}``."""
    tmp = tmp_path_factory.mktemp("lm_mesh")
    data = tmp / "data"
    data.mkdir()
    (data / "PENDING").touch()
    out = {4: _run_ranks(tmp / "store4", 4, "all", data,
                         meanwhile=lambda: _reference_data(data))}
    out[2] = _run_ranks(tmp / "store2", 2, "reshard2,seq", data)
    return out


def _part_ok(runs, world, part):
    for rank, (rc, out, err) in enumerate(runs[world]):
        assert f"part {part} checks=" in out, \
            f"rank {rank} (rc {rc}):\n{out[-2000:]}{err[-5000:]}"


def test_placement_follows_the_decls(runs):
    """``init_params`` under the mesh: each leaf of the seven reduced
    archs on its decl's placements, ``full_tensor()`` equal to the
    no-mesh draw bit for bit, a dim the mesh does not divide
    ``Replicate()``."""
    _part_ok(runs, 4, "place")


def test_six_families_match_the_reference(runs):
    """Logits and loss of dense (qwen, smollm), SSM (mamba2), hybrid
    (hymba), vision prefix (internvl2) and audio (hubert, loss only)
    under the mesh: within 1e-4 of the reference and of the port without
    a mesh."""
    _part_ok(runs, 4, "families")


def test_moe_ep_and_gspmd_match_the_reference_mesh(runs):
    """``moe_ffn_ep`` (local_map) and ``moe_ffn`` (``moe_impl="gspmd"``)
    on the (2, 2) mesh against the reference's on a fake-device (2, 2)
    mesh: ``y`` and gradients at 1e-4, ``aux`` at 1e-5."""
    _part_ok(runs, 4, "moe")


def test_serve_engine_applies_decl_placements(runs):
    """Greedy tokens under the mesh equal the no-mesh engine's (reduced
    qwen and smollm); handed all-``Replicate()`` parameters the engine
    runs prefill and every decode step on the decl placements."""
    _part_ok(runs, 4, "serve")


def test_loss_head_gradients_on_the_mesh(runs):
    """``lm_loss_chunked`` (tied and untied) under the mesh: value and
    gradients within 1e-4 of no mesh's."""
    _part_ok(runs, 4, "ops")


def test_trainer_on_the_mesh_matches_no_mesh(runs):
    """The loss's gradients leaf by leaf within 1e-4 of no mesh's; 3
    steps of reduced smollm with 8-bit error feedback: losses within 1e-5
    relative, parameters at the AdamW parity bounds of
    ``tests/test_torch_lm_train.py``; the checkpoint resumed on a (4, 1)
    mesh; remat "dots" / "full" / off give the same loss and gradients
    under the mesh."""
    _part_ok(runs, 4, "grads")
    _part_ok(runs, 4, "train")


def test_elastic_reshard(runs):
    """A checkpoint written under (2, 2) restores under (4, 1) and, in a
    world of 2, under (1, 2), bit for bit on the new mesh's placements;
    one the reference wrote restores onto the port's mesh."""
    _part_ok(runs, 4, "reshard")
    _part_ok(runs, 2, "reshard2")


@pytest.mark.parametrize("world", [2, 4])
def test_sequence_split_over_model(runs, world):
    """The sequence split over ``model`` on (1, 2) and (1, 4): the six
    families and the reduced moonshot, the split crossing the SSD's
    chunks and hymba's window blocks, with hymba's meta tokens and the
    VLM's patches inside the positions. Logits, loss and every
    parameter's gradient within 1e-4 of the reference and of no mesh;
    the prefill's KV cache and SSM state within 1e-4 of no mesh and its
    greedy tokens equal; the block-boundary activation, q, k, v and the
    SSD's chunk tensors ``Shard(1)`` over ``model``."""
    _part_ok(runs, world, "seq")


def test_launch_meshes(runs):
    """``make_production_mesh`` on a world of 4 raises the ``ValueError``
    that names 256 (512 multi-pod); ``launch/train.py --smoke --mesh
    smoke`` trains on the (2, 2) mesh."""
    _part_ok(runs, 4, "launch")
    for rank, (rc, out, err) in enumerate(runs[4]):
        assert rc == 0 and f"LM_MESH_OK rank={rank} part=all" in out, \
            out[-2000:] + err[-3000:]
    for rank, (rc, out, err) in enumerate(runs[2]):
        assert rc == 0 and "part=reshard2,seq" in out, \
            out[-2000:] + err[-3000:]
