"""The port's launchers and the train -> checkpoint -> serve chain, on the
CPU: ``tests/test_system.py::test_train_checkpoint_serve_roundtrip``
mirrored, ``repro_torch.launch.train`` (adamw, hybrid, bss2) and
``repro_torch.launch.serve --ckpt-dir`` on a checkpoint it wrote, and
``--mesh single|multi`` refusing a world of the wrong size."""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_checkpoint
from repro_torch.config import ShapeConfig, get_arch
from repro_torch.launch import serve as serve_main
from repro_torch.launch import train as train_main
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

REPO = Path(__file__).resolve().parent.parent


def test_train_checkpoint_serve_roundtrip():
    """train (AdamW, checkpoints) -> restore -> serve (generate)."""
    arch = get_arch("qwen1.5-0.5b").reduced()
    shape = ShapeConfig("smoke", 32, 4, "train")
    with tempfile.TemporaryDirectory() as d:
        tcfg = TrainerConfig(steps=12, ckpt_every=6, ckpt_dir=d,
                             log_every=100,
                             opt=AdamWConfig(lr=1e-3, warmup_steps=2))
        out = Trainer(arch, shape, tcfg, device="cpu").train()
        assert out["history"][-1]["loss"] < out["history"][0]["loss"]

        step, state = restore_checkpoint(d, device="cpu")
        assert step == 12
        for a, b in zip(sorted(_leaves(out["params"])),
                        sorted(_leaves(state["params"]))):
            assert a[0] == b[0] and torch.equal(a[1], b[1])
        eng = ServeEngine(arch, max_len=64, device="cpu")
        gen = eng.generate(state["params"], torch.ones((2, 8),
                                                       dtype=torch.int32),
                           n_new=5)
        assert tuple(gen.shape) == (2, 5)
        assert (gen >= 0).all() and (gen < arch.vocab_padded).all()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, f"{prefix}{k}/")]
    return [(prefix, tree)]


def test_launch_train_adamw_then_serve_the_checkpoint(tmp_path, capsys):
    """``launch.train --smoke`` trains and checkpoints; ``launch.serve
    --ckpt-dir`` (a subprocess, as a user runs it) serves the newest
    checkpoint's parameters, giving what the restored parameters give in
    process."""
    out = train_main.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device",
                           "cpu", "--steps", "4", "--ckpt-every", "2",
                           "--ckpt-dir", str(tmp_path), "--accum", "2",
                           "--compress-bits", "8"])
    assert "done: final loss" in capsys.readouterr().out
    assert len(out["history"]) == 4
    step, state = restore_checkpoint(tmp_path, device="cpu")
    assert step == 4 and "err" in state
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--batch", "2",
         "--prompt-len", "8", "--new", "4", "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "2x4 tokens in" in r.stdout, r.stdout
    served = serve_main.main(["--arch", "qwen1.5-0.5b", "--smoke",
                              "--device", "cpu", "--batch", "2",
                              "--prompt-len", "8", "--new", "4",
                              "--ckpt-dir", str(tmp_path)])
    eng = ServeEngine(get_arch("qwen1.5-0.5b").reduced(), max_len=28,
                      device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, get_arch("qwen1.5-0.5b").reduced().vocab, (2, 8))
    assert torch.equal(served, eng.generate(state["params"], prompts, 4))
    assert str(served.numpy()) in r.stdout


def test_launch_train_hybrid_and_bss2(capsys):
    st = train_main.main(["--arch", "mamba2-130m", "--smoke", "--device",
                          "cpu", "--trainer", "hybrid", "--steps", "3"])
    assert st.w_q.dtype == torch.int8 and int(st.w_q.abs().max()) <= 31
    assert "step 0: reward" in capsys.readouterr().out
    out = train_main.main(["--arch", "bss2", "--device", "cpu", "--steps",
                           "3"])
    assert out["mean_reward"].shape[0] == 3
    assert "final median <R>" in capsys.readouterr().out


@pytest.mark.parametrize("mesh,need", [("single", 256), ("multi", 512)])
def test_launch_train_mesh_names_the_world_it_needs(mesh, need):
    """``--mesh single|multi`` on a world of one (no ``torchrun``): the
    production mesh's ``ValueError`` naming the ranks it needs, before
    any process group starts (training on a smoke mesh is in
    ``tests/test_torch_lm_mesh.py``)."""
    import torch.distributed as dist
    with pytest.raises(ValueError, match=f"world of {need} ranks"):
        train_main.main(["--arch", "smollm-360m", "--smoke", "--device",
                         "cpu", "--mesh", mesh])
    assert not dist.is_initialized()
