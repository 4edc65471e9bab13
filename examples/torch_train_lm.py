"""End-to-end LM training on the port (``examples/train_lm.py``).

Default: a short run of the reduced smollm (60 steps) showing the whole
loop: data pipeline, AdamW, checkpoints, the loss falling.

``--full`` trains the real smollm-360m config (0.362 B parameters) at
8 x 512 tokens a step, the shape ``chip_smoke.py`` phase 15 runs on the
card (``PERF.md`` gives its step time beside the card's name and power
limit).

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--full]
          [--steps N] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given (and raises
without one).
"""
import argparse
import tempfile

from repro_torch import resolve_device
from repro_torch.config import ShapeConfig, get_arch
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    arch = get_arch(args.arch)
    if args.full:
        shape = ShapeConfig("train_small", 512, 8, "train")
        steps = args.steps or 300
    else:
        arch = arch.reduced()
        shape = ShapeConfig("smoke", 64, 8, "train")
        steps = args.steps or 60

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_lm_")
    tcfg = TrainerConfig(steps=steps, ckpt_every=max(steps // 4, 10),
                         ckpt_dir=ckpt_dir, log_every=max(steps // 15, 1),
                         opt=AdamWConfig(lr=1e-3, warmup_steps=20))
    print(f"training {arch.name} ({arch.param_count()/1e6:.1f}M params) "
          f"for {steps} steps, batch {shape.global_batch} x "
          f"{shape.seq_len} on {device}")
    out = Trainer(arch, shape, tcfg, device=device).train()
    losses = [h["loss"] for h in out["history"]]
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({(1 - losses[-1]/losses[0]):.0%} reduction)")
    print(f"checkpoints in {ckpt_dir}")


if __name__ == "__main__":
    main()
