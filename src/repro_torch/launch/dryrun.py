"""Multi-pod dry run (``repro/launch/dryrun.py``): count every (arch x
shape x mesh) cell on a fake world of 256 or 512 ranks.

For every runnable cell this driver:
  1. starts a fake process group (``torch.testing._internal.distributed
     .fake_pg``) of 256 or 512 ranks, once per world size, and builds the
     production mesh on it (16 x 16, or 2 x 16 x 16 with ``pod``);
  2. makes the step's inputs (parameters, AdamW state, decode cache,
     batch) as fake local shards wrapped into DTensors with the rules'
     placements: shapes and dtypes, no allocation;
  3. runs the step (``make_train_step`` with ``accum`` from
     ``--override``, ``prefill`` or ``decode_step``) under the fake-mode
     cost recorder (``analysis/cost.py``), which sees every local op and
     every collective of rank 0: per-device FLOPs, HBM bytes, collective
     bytes and memory, as the reference's ``cost_analysis()`` /
     ``memory_analysis()`` give them. Remat runs as the arch says, so the
     recompute is counted;
  4. appends the cell record to a JSON results file (incremental, so an
     interrupted sweep resumes where it stopped).

The reference's depth probes (``_probe_arch``, ``lower_cell_probed``)
are not ported: they work around XLA's compile time and a scan body
costed once, and the port loops over its layers, so a full-depth count
is direct. The BSS-2 cell (``--include-bss2``) runs for real on
``--device`` (``core.hybrid.trace_bss2_cell``); it is the only part that
needs a device, and it runs on ``cuda`` unless ``--device cpu`` is given.
A cell whose ``arg_bytes + temp_bytes`` exceed ``HW.hbm_bytes`` is
reported as not fitting (``fits_hbm``), which is a finding, not a
failure.

On a ``cpu`` device mesh DTensor turns a shard-to-shard redistribute
(an all-to-all) into an all-gather and a local chunk, so such a
redistribute counts as an all-gather here; the expert-parallel MoE's own
``all_to_all_single`` counts as an all-to-all.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --include-bss2 --device cpu
"""
import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

_MESHES = {}


def _fake_world(n: int):
    """A fake process group of ``n`` ranks (this process is rank 0); a
    fake group of another size is replaced, a real one refused."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a fake world; this process "
                               "already runs a real process group")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
        _MESHES.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def production_mesh(multi_pod: bool):
    """The production mesh on a fake world of 256 or 512 ranks."""
    from repro_torch.launch.mesh import make_production_mesh
    _fake_world(512 if multi_pod else 256)
    if multi_pod not in _MESHES:
        _MESHES[multi_pod] = make_production_mesh(multi_pod,
                                                  device_type="cpu")
    return _MESHES[multi_pod]


@contextlib.contextmanager
def dtensor_host_math_outside_fake():
    """``_StridedShard``'s shard sizes and offsets (DTensor's view of a
    flattened dim sharded on two mesh dims) computed outside the
    recording fake mode while the dry run traces: DTensor computes them
    with ``tolist`` on index tensors it builds, which needs real ones.
    Patched where the installed torch has the method."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types
    cls = getattr(placement_types, "_StridedShard", None)
    name = "local_shard_size_and_offset"
    orig = None if cls is None else cls.__dict__.get(name)
    if not callable(orig):
        yield
        return

    def outside(*args, **kwargs):
        with unset_fake_temporarily():
            return orig(*args, **kwargs)
    setattr(cls, name, outside)
    try:
        yield
    finally:
        setattr(cls, name, orig)


def fake_dtensor(shape, dtype, mesh, placements):
    """A DTensor of global ``shape`` whose local shard is a fake tensor
    (call inside the fake mode); even splits only, as the rules place.
    With ``placements`` ``None`` (no mesh) a plain fake tensor."""
    import torch
    from torch.distributed.tensor import DTensor, Shard
    if placements is None:
        return torch.empty(tuple(shape), dtype=dtype)
    local = list(shape)
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            local[pl.dim] //= mesh.size(i)
    stride, acc = [], 1
    for d in reversed(shape):
        stride.insert(0, acc)
        acc *= d
    return DTensor.from_local(torch.empty(local, dtype=dtype), mesh,
                              tuple(placements), run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def fake_tree(decls, ctx):
    """A ``ParamDecl`` tree as fake DTensors on the decls' placements
    (plain fake tensors without a mesh)."""
    from repro_torch.parallel.sharding import ParamDecl, tree_map
    return tree_map(lambda d: fake_dtensor(
        d.shape, d.dtype, ctx.mesh, ctx.param_sharding(d.axes, d.shape)),
        decls, lambda x: isinstance(x, ParamDecl))


def trace_cell(arch_name: str, shape_name, multi_pod: bool,
               overrides: dict = None, arch_override=None, device=None,
               compute_dtype=None, world_of_one: bool = False):
    """Count one cell. Returns ``(report, recorder)``.

    ``shape_name`` is a name of ``SHAPES`` or a ``ShapeConfig`` (a decode
    shape's ``seq_len`` is its cache's length). ``compute_dtype`` is the
    models' (default bf16, as the reference lowers). ``world_of_one``
    counts the step of one card with no mesh (plain fake tensors, mesh
    name ``"1"``), as a card runs it without ``torch.distributed``."""
    import torch
    from torch.distributed.tensor import Replicate
    from repro_torch.analysis import cost
    from repro_torch.analysis.roofline import build_report
    from repro_torch.config import SHAPES, MeshConfig, get_arch
    from repro_torch.parallel.sharding import ShardingCtx

    arch = arch_override or get_arch(arch_name)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    mesh_cfg = MeshConfig(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if arch.family == "neuromorphic":
        from repro_torch.core.hybrid import trace_bss2_cell
        rep, rec, _ = trace_bss2_cell(shape, mesh_cfg, device)
        return rep, rec

    from repro_torch.models.transformer import (build_model, input_shardings,
                                                input_specs)
    from repro_torch.train.optimizer import adamw_init_decls
    from repro_torch.train.steps import make_train_step
    overrides = dict(overrides or {})
    if world_of_one:
        mesh, mesh_name, n_devices = None, "1", 1
    else:
        mesh, n_devices = production_mesh(multi_pod), mesh_cfg.n_devices
    ctx = ShardingCtx(mesh=mesh, mesh_cfg=mesh_cfg,
                      compute_dtype=compute_dtype or torch.bfloat16,
                      overrides=overrides)
    bundle = build_model(arch, ctx)
    with dtensor_host_math_outside_fake(), \
            cost.recording(fake=True) as rec:
        params = fake_tree(bundle.decls, ctx)
        ins = input_specs(arch, shape, ctx)
        in_sh = input_shardings(arch, shape, ctx)
        batch = {k: fake_dtensor(tuple(v.shape), v.dtype, mesh, in_sh[k])
                 for k, v in ins.items()}
        if shape.kind == "train":
            opt = fake_tree(adamw_init_decls(bundle.decls), ctx)
            step = make_train_step(bundle, accum_steps=int(
                overrides.get("accum", 1)))
            args = (params, opt, batch)
            rec.begin(args)
            out = step(*args)
        elif shape.kind == "prefill":
            args = (params, batch)
            rec.begin(args)
            out = bundle.prefill(*args)
        else:
            cache = fake_tree(bundle.make_cache_decls(shape.global_batch,
                                                      shape.seq_len), ctx)
            t = fake_dtensor((), torch.int32, mesh, None if mesh is None
                             else (Replicate(),) * mesh.ndim)
            args = (params, cache, batch["token"], t)
            rec.begin(args)
            out = bundle.decode_step(*args)
        rec.end(out)
        del out, args
    return build_report(arch, shape, mesh_name, n_devices, rec), rec


def run_cell(arch_name, shape_name, multi_pod, out_records, verbose=True,
             overrides=None, device=None):
    from repro_torch.analysis.roofline import model_flops_for
    from repro_torch.config import HW, SHAPES, cell_applicable, get_arch
    arch = get_arch(arch_name)
    shape = SHAPES[shape_name]
    ok, reason = cell_applicable(arch, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    key = f"{arch_name}/{shape_name}/{mesh_name}"
    if not ok:
        rec = dict(arch=arch_name, shape=shape_name, mesh=mesh_name,
                   status="SKIP", reason=reason,
                   model_flops_global=model_flops_for(arch, shape))
        out_records[key] = rec
        if verbose:
            print(f"[SKIP] {key}: {reason}", flush=True)
        return rec
    t0 = time.time()
    try:
        report, _ = trace_cell(arch_name, shape_name, multi_pod,
                               overrides=overrides, device=device)
        need = report.arg_bytes + report.temp_bytes
        rec = dict(status="OK", trace_s=round(time.time() - t0, 1),
                   fits_hbm=bool(need <= HW.hbm_bytes), **report.to_dict())
        if verbose:
            print(f"[OK]  {key}: trace {rec['trace_s']}s "
                  f"flops/dev {report.flops_per_dev/1e9:.1f}G "
                  f"hbm/dev {report.hbm_bytes_per_dev/1e9:.2f}G "
                  f"coll {report.coll_sec['bytes_simple']/1e6:.1f}MB "
                  f"temp {report.temp_bytes/2**30:.2f}GiB "
                  f"bottleneck={report.bottleneck} "
                  f"MFU@roofline={report.mfu:.2%}", flush=True)
            print(f"      memory: arg={report.arg_bytes/2**30:.2f}GiB "
                  f"out={report.out_bytes/2**30:.2f}GiB "
                  f"temp={report.temp_bytes/2**30:.2f}GiB"
                  + ("" if rec["fits_hbm"] else
                     f" -- does not fit {HW.hbm_bytes/1e9:.0f} GB"),
                  flush=True)
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug to record
        rec = dict(arch=arch_name, shape=shape_name, mesh=mesh_name,
                   status="FAIL", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[FAIL] {key}: {rec['error']}", flush=True)
    out_records[key] = rec
    return rec


def main(argv=None):
    from repro_torch.config import ASSIGNED_ARCHS, SHAPES
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/torch_dryrun.json")
    ap.add_argument("--include-bss2", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the bss2 cells run (default cuda)")
    ap.add_argument("--override", action="append", default=[],
                    help="knobs, e.g. --override moe_impl=gspmd")
    args = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in args.override)

    archs = list(ASSIGNED_ARCHS) if (args.all or not args.arch) \
        else [args.arch]
    if args.include_bss2 and "bss2" not in archs:
        archs.append("bss2")
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    pods = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    records = {}
    if out_path.exists():
        records = json.loads(out_path.read_text())

    t0 = time.time()
    for multi_pod in pods:
        for a in archs:
            for s in shapes:
                mesh_name = "2x16x16" if multi_pod else "16x16"
                key = f"{a}/{s}/{mesh_name}"
                if args.skip_existing and records.get(key, {}).get("status") == "OK":
                    print(f"[CACHED] {key}", flush=True)
                    continue
                run_cell(a, s, multi_pod, records, overrides=overrides,
                         device=args.device)
                out_path.write_text(json.dumps(records, indent=1))

    n_ok = sum(1 for r in records.values() if r["status"] == "OK")
    n_skip = sum(1 for r in records.values() if r["status"] == "SKIP")
    n_fail = sum(1 for r in records.values() if r["status"] == "FAIL")
    print(f"\ndry-run complete: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL "
          f"in {time.time() - t0:.1f} s -> {out_path}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
