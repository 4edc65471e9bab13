"""Serving driver: batched generation against a randomly initialised or
checkpointed model (``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --batch 4 --new 16

Runs on ``cuda`` unless ``--device cpu`` is given (no fallback: without a
card and without ``--device`` it raises). ``--smoke`` serves the arch's
reduced form. Parameters come from the newest checkpoint in ``--ckpt-dir``
(``launch/train.py``'s or the reference's), else from ``init_params`` with
a generator seeded with 0 on the device; prompts from a numpy generator
seeded with 1.
"""
import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without one)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.config import get_arch
    from repro_torch.parallel.sharding import init_params
    from repro_torch.serve.engine import ServeEngine

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    if args.smoke:
        arch = arch.reduced()
    eng = ServeEngine(arch, max_len=args.prompt_len + args.new + 8
                      + arch.n_meta_tokens
                      + (arch.n_patches if arch.vit_dim else 0),
                      device=device)
    if args.ckpt_dir:
        from repro_torch.checkpoint import restore_checkpoint
        _, state = restore_checkpoint(args.ckpt_dir, device=device)
        if state is None:
            raise FileNotFoundError(f"no checkpoint in {args.ckpt_dir}")
        params = state["params"]
    else:
        params = init_params(eng.bundle.decls,
                             torch.Generator(device).manual_seed(0), device)
    prompts = np.random.default_rng(1).integers(
        0, max(arch.vocab, 2), (args.batch, args.prompt_len))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = eng.generate(params, prompts, n_new=args.new,
                       temperature=args.temperature)
    dt = time.perf_counter() - t0
    print(out.numpy())
    print(f"{args.batch}x{args.new} tokens in {dt:.2f}s "
          f"({args.batch * args.new / dt:.1f} tok/s)")
    return out


if __name__ == "__main__":
    main()
