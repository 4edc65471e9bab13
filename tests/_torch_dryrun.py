"""Dry-run probes on a fake world, one process (the fake process group is
global state), for ``tests/test_torch_dryrun.py`` and
``tests/test_torch_cost.py``.

    python tests/_torch_dryrun.py OUT.json [PART ...]

writes one JSON object, a key a part (all parts by default): the
per-device counts of a (16, 16)-sharded
matmul, of the four functional collectives on a 16-rank group, the BSS-2
cell at train_4k on 16 x 16 (on the CPU), a reduced dense arch for each
step kind and the reduced MoE's decode on 16 x 16, and each parameter
and AdamW leaf's local bytes on both production meshes. Imports no JAX.
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.analysis import cost  # noqa: E402
from repro_torch.config import SHAPES, get_arch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

MATMUL = (512, 256, 1024)          # M, K, N
LEAF_ARCHS = ("qwen1.5-0.5b", "moonshot-v1-16b-a3b", "hymba-1.5b")


def sharded_matmul():
    from torch.distributed.tensor import Replicate, Shard
    M, K, N = MATMUL
    mesh = dryrun.production_mesh(False)
    with dryrun.dtensor_host_math_outside_fake(), \
            cost.recording(fake=True) as rec:
        a = dryrun.fake_dtensor((M, K), torch.float32, mesh,
                                (Shard(0), Replicate()))
        b = dryrun.fake_dtensor((K, N), torch.float32, mesh,
                                (Replicate(), Shard(1)))
        rec.begin((a, b))
        out = a @ b
        rec.end(out)
        local = list(out.to_local().shape)
    return dict(flops=rec.flops, hbm_rw=rec.hbm_rw, coll=rec.coll,
                local=local, kinds=[r.kind for r in rec.ops])


def collectives():
    """The reference's ``FAKE_HLO`` shapes (``tests/test_roofline.py``) on
    a 16-rank group (the mesh's ``model`` dim), plus an all-to-all."""
    import torch.distributed._functional_collectives as funcol
    group = dryrun.production_mesh(False).get_group("model")
    with cost.recording(fake=True) as rec:
        ag_in = torch.empty((4, 2048), dtype=torch.bfloat16)
        ar_in = torch.empty((1024, 1024), dtype=torch.float32)
        a2a_in = torch.empty((64, 128), dtype=torch.float32)
        rec.begin((ag_in, ar_in, a2a_in))
        outs = [funcol.all_gather_tensor(ag_in, 0, group),
                funcol.all_reduce(ar_in, "sum", group)]
        outs.append(funcol.reduce_scatter_tensor(outs[1], "sum", 0, group))
        outs.append(funcol.all_to_all_single(a2a_in, None, None, group))
        outs = [funcol.wait_tensor(o) for o in outs]
        shapes = [list(o.shape) for o in outs]
        rec.end(outs)
    return dict(coll=rec.coll, shapes=shapes)


def _report(rep, rec):
    d = rep.to_dict()
    d["kernels"] = rec.kernels
    d["n_ops"] = len(rec.ops)
    return d


def bss2():
    rep, rec = dryrun.trace_cell("bss2", "train_4k", False, device="cpu")
    return _report(rep, rec)


def reduced(name, shape_name, n_experts=None, batch=None):
    """The reduced arch on the reduced shape, on 16 x 16. ``n_experts``
    and ``batch`` replace the reduced MoE's 8 experts and the reduced
    batch of 2: expert parallelism over the 16 ``model`` ranks needs a
    multiple of 16 of each, in both packages."""
    import dataclasses
    arch = get_arch(name).reduced()
    shape = SHAPES[shape_name].reduced()
    if n_experts:
        arch = dataclasses.replace(arch, moe=dataclasses.replace(
            arch.moe, n_experts=n_experts))
        shape = dataclasses.replace(shape, global_batch=batch)
    rep, rec = dryrun.trace_cell(name, shape, False, arch_override=arch)
    return _report(rep, rec)


def leaves(name, multi_pod):
    """Each parameter and AdamW leaf's local bytes on rank 0."""
    from repro_torch.config import MeshConfig
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel.sharding import ShardingCtx
    from repro_torch.train.optimizer import adamw_init_decls
    mesh = dryrun.production_mesh(multi_pod)
    ctx = ShardingCtx(mesh=mesh, mesh_cfg=MeshConfig(multi_pod=multi_pod))
    decls = build_model(get_arch(name), ctx).decls
    out = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}")
        else:
            loc = tree.to_local()
            out[prefix] = loc.numel() * loc.element_size()
    with cost.recording(fake=True):
        walk(dryrun.fake_tree(decls, ctx), "params")
        walk(dryrun.fake_tree(adamw_init_decls(decls), ctx), "opt")
    return out


PARTS = dict(
    matmul=sharded_matmul, collectives=collectives, bss2=bss2,
    dense=lambda: {k: reduced("smollm-360m", s) for k, s in (
        ("train", "train_4k"), ("prefill", "prefill_32k"),
        ("decode", "decode_32k"))},
    moe_decode=lambda: reduced("moonshot-v1-16b-a3b", "decode_32k", 16, 16),
    leaves=lambda: {f"{a}/{m}": leaves(a, m == "2x16x16")
                    for m in ("16x16", "2x16x16") for a in LEAF_ARCHS})


def main(path, parts):
    Path(path).write_text(json.dumps({p: PARTS[p]() for p in parts}))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:] or list(PARTS))
