"""Training driver (``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --smoke --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --smoke --trainer hybrid --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch bss2 --steps 300

Runs on ``cuda`` unless ``--device cpu`` is given (no fallback: without a
card and without ``--device`` it raises). ``--smoke`` trains the arch's
reduced form on the reduced shape.

``--mesh single|multi`` trains on the production mesh (16 x 16, or
2 x 16 x 16 with ``pod``) under ``torchrun``: one process a card
(``cuda:LOCAL_RANK``), the process group from the environment; a world
of another size raises a ``ValueError`` naming the size it needs.
``--mesh smoke`` builds a small (``data``, ``model``) mesh over the
world instead, (WORLD / 2, 2), or (1, 1) for a world of one (with
``--device cpu``: gloo ranks)::

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch smollm-360m --smoke --mesh smoke
"""
import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny shape")
    ap.add_argument("--trainer", choices=["adamw", "hybrid"], default="adamw")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-bits", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", choices=["none", "single", "multi", "smoke"],
                    default="none")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without one)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.config import SHAPES, MeshConfig, get_arch
    from repro_torch.parallel.sharding import ShardingCtx

    arch = get_arch(args.arch)
    if args.arch == "bss2":
        device = resolve_device(args.device)
        from repro_torch.core.hybrid import run_training
        out, _, _ = run_training(n_trials=args.steps, seed=args.seed,
                                 device=device)
        print(f"final median <R> = {np.median(out['mean_reward'][-1]):.3f}")
        return out

    shape = SHAPES[args.shape]
    if args.smoke:
        arch = arch.reduced()
        shape = shape.reduced()

    ctx = ShardingCtx()
    if args.mesh != "none":
        from repro_torch.launch import mesh as lm
        dtype = "cpu" if args.device == "cpu" else "cuda"
        multi = args.mesh == "multi"
        if args.mesh == "smoke":
            world = lm.world_size()
            m = lm.make_smoke_mesh((world // 2, 2) if world > 1 else (1, 1),
                                   device_type=dtype)
        else:
            m = lm.make_production_mesh(multi_pod=multi, device_type=dtype)
        ctx = ShardingCtx(mesh=m, mesh_cfg=MeshConfig(multi_pod=multi))
    device = ctx.device or resolve_device(args.device)

    if args.trainer == "hybrid":
        from repro_torch.data.pipeline import SyntheticLMPipeline
        from repro_torch.parallel.sharding import init_params
        from repro_torch.plasticity.three_factor import HybridReadoutTrainer
        tr = HybridReadoutTrainer(arch, ctx, device=device)
        params = init_params(tr.bundle.decls,
                             torch.Generator(device).manual_seed(args.seed),
                             device, ctx)
        pipe = SyntheticLMPipeline(arch, shape, seed=args.seed)
        st = tr.init_state(torch.Generator(device).manual_seed(args.seed + 1))
        for i in range(args.steps):
            st, m = tr.step(params, st, pipe.next_batch(device))
            if i % 10 == 0:
                print(f"step {i}: reward {float(m['reward']):.4f} "
                      f"<R> {float(m['mean_r']):.4f} "
                      f"acc {float(m['acc_greedy']):.4f}", flush=True)
        return st

    from repro_torch.train.trainer import Trainer, TrainerConfig
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, seed=args.seed,
                         accum_steps=args.accum,
                         grad_compress_bits=args.compress_bits)
    out = Trainer(arch, shape, tcfg, ctx, device=device).train()
    print(f"done: final loss {out['history'][-1]['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
