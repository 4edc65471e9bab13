"""Training driver (``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --smoke --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --smoke --trainer hybrid --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch bss2 --steps 300

Runs on ``cuda`` unless ``--device cpu`` is given (no fallback: without a
card and without ``--device`` it raises). ``--smoke`` trains the arch's
reduced form on the reduced shape. ``--mesh single|multi`` raises until
the mesh is ported (``parallel/sharding.py::MESH_PENDING``).
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
    ap.add_argument("--mesh", choices=["none", "single", "multi"],
                    default="none")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without one)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.config import SHAPES, get_arch
    from repro_torch.parallel.sharding import MESH_PENDING

    if args.mesh != "none":
        raise NotImplementedError(MESH_PENDING)
    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    if args.arch == "bss2":
        from repro_torch.core.hybrid import run_training
        out, _, _ = run_training(n_trials=args.steps, seed=args.seed,
                                 device=device)
        print(f"final median <R> = {np.median(out['mean_reward'][-1]):.3f}")
        return out

    shape = SHAPES[args.shape]
    if args.smoke:
        arch = arch.reduced()
        shape = shape.reduced()

    if args.trainer == "hybrid":
        from repro_torch.data.pipeline import SyntheticLMPipeline
        from repro_torch.parallel.sharding import init_params
        from repro_torch.plasticity.three_factor import HybridReadoutTrainer
        tr = HybridReadoutTrainer(arch, device=device)
        params = init_params(tr.bundle.decls,
                             torch.Generator(device).manual_seed(args.seed),
                             device)
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
    out = Trainer(arch, shape, tcfg, device=device).train()
    print(f"done: final loss {out['history'][-1]['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
