"""The port's dry run (``repro_torch.launch.dryrun``) on a fake world,
in one subprocess of ``tests/_torch_dryrun.py`` (the fake process group
is global state): the BSS-2 cell at train_4k on 16 x 16, a reduced dense
arch for each step kind and the reduced MoE's decode, and every
parameter and AdamW leaf's local bytes on both production meshes against
the bytes the reference's ``tree_pspecs`` specs give on the same mesh
sizes. The fleet and column split of the BSS-2 cell (``bss2_cell_fleet``)
is checked here directly."""
import json
import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from repro import config as rc
from repro.models.transformer import build_model as ref_build
from repro.parallel import sharding as rs
from repro.train.optimizer import adamw_init_decls as ref_adamw_decls
from repro_torch import config as pc
from repro_torch.core import hybrid, synapse
from repro_torch.kernels.corr import ops as corr_ops
from repro_torch.kernels.neuron_scan import ops as neuron_ops
from repro_torch.kernels.stp_scan import ops as stp_ops
from repro_torch.kernels.synray import ops as synray_ops
from repro_torch.kernels.synray_sparse import ops as sparse_ops

HELPER = Path(__file__).resolve().parent / "_torch_dryrun.py"


@pytest.fixture(scope="module")
def probes(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "probes.json"
    subprocess.run([sys.executable, str(HELPER), str(out), "bss2", "dense",
                    "moe_decode", "leaves"], check=True, timeout=600,
                   capture_output=True)
    return json.loads(out.read_text())


@pytest.mark.parametrize("multi_pod,want", [
    (False, {"train_4k": 16, "prefill_32k": 2, "decode_32k": 8,
             "long_500k": 1}),
    (True, {"train_4k": 8, "prefill_32k": 1, "decode_32k": 4,
            "long_500k": 16})])
def test_bss2_fleet_split_by_the_instance_rule(multi_pod, want):
    """n_inst / dp instances a rank on the data axes, the whole fleet
    where they do not divide it (16 on 2 x 16 x 16's 32 data ranks); the
    chip's 512 columns over the 16 ``model`` ranks, 32 a rank, on both
    meshes and every shape."""
    got = {s: hybrid.bss2_cell_fleet(pc.SHAPES[s], pc.MeshConfig(multi_pod))
           for s in want}
    assert {s: n for s, (_, n, _) in got.items()} == want
    assert {s: n for s, (n, _, _) in got.items()} == {
        "train_4k": 256, "prefill_32k": 32, "decode_32k": 128,
        "long_500k": 16}
    assert {s: c for s, (_, _, c) in got.items()} == dict.fromkeys(want, 32)


@pytest.mark.parametrize("model,want", [(1, 512), (2, 256), (16, 32),
                                        (256, 2), (24, 512), (48, 512)])
def test_bss2_columns_split_by_the_instance_rule(model, want):
    """The columns a rank holds on a (16, ``model``) mesh: 512 / model
    where ``model`` divides 512, the whole chip where it does not (the
    rule's demotion, ``ShardingCtx.instance_pspec``); the instances over
    the 16 data ranks either way."""
    mesh = SimpleNamespace(shape=(16, model), axes=("data", "model"),
                           data_axes=("data",), multi_pod=False)
    n_inst, n_local, n_cols = hybrid.bss2_cell_fleet(pc.SHAPES["train_4k"],
                                                     mesh)
    assert (n_inst, n_local, n_cols) == (256, 16, want)


def test_bss2_columns_split_needs_an_even_count():
    """512 columns over 512 ``model`` ranks would leave one a rank: the
    reward's parity needs an even count, so the split raises."""
    mesh = SimpleNamespace(shape=(1, 512), axes=("data", "model"),
                           data_axes=("data",), multi_pod=False)
    with pytest.raises(ValueError, match="even"):
        hybrid.bss2_cell_fleet(pc.SHAPES["train_4k"], mesh)


def test_bss2_train_4k_cell(probes):
    r = probes["bss2"]
    assert (r["arch"], r["shape"], r["mesh"], r["n_devices"],
            r["step_kind"]) == ("bss2", "train_4k", "16x16", 256, "train")
    # the reference's MODEL_FLOPS (repro/core/hybrid.py:688-691)
    assert r["model_flops_global"] == (
        2 * 256 * 512 + 40 * 512 + 4 * 256 * 512) * 128 * 256
    # the rank's part: 16 instances x 32 columns. The column work is a
    # sixteenth of the whole chips' (2.232e9 FLOPs, 5.60e8 HBM bytes
    # before the split), the row work whole: at least the reference's
    # MODEL_FLOPS share, at most 1/8 of the whole chips'
    assert r["model_flops_global"] / 256 <= r["flops_per_dev"] < 2.8e8
    assert r["hbm_bytes_per_dev"] < 5.6e8 / 8
    k = r["kernels"]
    # both Dale halves are gated, planned from the whole chip's 512
    # columns: the STP scan takes their censuses (no census kernel) and
    # carries the census's bytes
    assert set(k) == {"stp_scan", "synray_sparse", "neuron_scan", "corr"}
    assert {n: v["count"] for n, v in k.items()} == dict(
        stp_scan=1, synray_sparse=2, neuron_scan=1, corr=1)
    assert k["stp_scan"]["bytes"] == stp_ops.work(128, 16, 256,
                                                  census=True).bytes
    # the gated pair counts its larger route at the part's shapes (16
    # instances, a Dale half of 128 rows, 32 columns): at 32 columns the
    # sparse window form's strided event reads outweigh synray's work
    _, me, kc = synapse.route_plan(128, 128, 512, const_addr=True)
    sparse = sparse_ops.work_window(128, 16, 128, 32, me, kc, 2)
    assert sparse.bytes > synray_ops.work(128, 16, 128, 32).bytes
    assert k["synray_sparse"]["bytes"] == 2 * sparse.bytes
    assert k["neuron_scan"]["bytes"] == neuron_ops.work(128, 16, 32).bytes
    assert k["corr"]["bytes"] == corr_ops.work(128, 16, 256, 32).bytes
    assert r["coll"] == {} and r["t_collective"] == 0
    assert r["bottleneck"] == "memory"
    assert r["hbm_bytes_per_dev"] > sum(v["bytes"] for v in k.values())
    assert r["arg_bytes"] > 0 and r["temp_bytes"] > 0 and r["out_bytes"] > 0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_reduced_dense_cell_on_16x16(probes, kind):
    r = probes["dense"][kind]
    arch = pc.get_arch("smollm-360m").reduced()
    shape = pc.SHAPES[{"train": "train_4k", "prefill": "prefill_32k",
                       "decode": "decode_32k"}[kind]].reduced()
    from repro_torch.analysis.roofline import model_flops_for
    assert r["step_kind"] == kind and r["n_devices"] == 256
    assert r["model_flops_global"] == model_flops_for(arch, shape)
    assert r["flops_per_dev"] > 0 and r["hbm_bytes_per_dev"] > 0
    assert r["kernels"] == {}
    assert all(math.isfinite(r[t]) for t in ("t_compute", "t_memory",
                                             "t_collective", "mfu"))
    # parameters are sharded over data and model: the weights' local
    # shards are gathered and the gradients reduced
    assert r["coll"]["all-gather"]["count"] > 0
    if kind == "train":
        assert r["coll"]["reduce-scatter"]["count"] > 0
    assert r["arg_bytes"] > 0 and r["temp_bytes"] > 0 and r["out_bytes"] > 0
    # the sequence split over the 16 ``model`` ranks (2 positions a rank):
    # the useful share of a rank's FLOPs (0.052 train, 0.074 prefill) is
    # 3-4x what it was with the sequence whole on every rank (0.0128,
    # 0.0242); one decode token demotes the split
    floor = dict(train=0.04, prefill=0.06, decode=0.0)[kind]
    assert r["useful_flops_ratio"] > floor, r["useful_flops_ratio"]


def test_reduced_moe_decode_on_16x16(probes):
    """Expert parallelism (``moe_ffn_ep``, the default under a mesh) over
    the 16 ``model`` ranks: the partial outputs summed by an all-reduce,
    the reference's psum."""
    r = probes["moe_decode"]
    assert r["step_kind"] == "decode" and r["flops_per_dev"] > 0
    assert r["coll"]["all-reduce"]["count"] > 0


def _ref_local_bytes(name, multi_pod):
    cfg = rc.MeshConfig(multi_pod)
    sizes = dict(zip(cfg.axes, cfg.shape))
    ctx = rs.ShardingCtx(mesh=SimpleNamespace(
        axis_names=cfg.axes, devices=np.empty(cfg.shape)), mesh_cfg=cfg)
    decls = ref_build(rc.get_arch(name), ctx).decls
    out = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}")
            return
        spec = tuple(ctx.param_pspec(tree.axes, tree.shape))
        n = 1
        for i, d in enumerate(tree.shape):
            e = spec[i] if i < len(spec) else None
            e = () if e is None else ((e,) if isinstance(e, str) else e)
            n *= d // math.prod(sizes[a] for a in e)
        out[prefix] = n * np.dtype(tree.dtype).itemsize
    walk(decls, "params")
    walk(ref_adamw_decls(decls), "opt")
    return out


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "moonshot-v1-16b-a3b",
                                  "hymba-1.5b"])
def test_leaf_local_bytes_equal_reference_specs(probes, name, mesh):
    got = probes["leaves"][f"{name}/{mesh}"]
    want = _ref_local_bytes(name, mesh == "2x16x16")
    assert got == want
