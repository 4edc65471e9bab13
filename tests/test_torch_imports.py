"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``repro``, importing it
(``launch.mesh`` too) starts no process group, and ``chip_smoke.py``
refuses to run without a card or outside a checkout."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)          # defines main(); runs nothing
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
assert "repro_torch.wafer.router" in names, names
for m in ("train.optimizer", "train.steps", "train.trainer", "data.pipeline",
          "parallel.compress", "checkpoint.ckpt", "plasticity.three_factor",
          "launch.train", "launch.mesh"):
    assert "repro_torch." + m in names, m
# importing launch.mesh starts no process group and no CUDA state
import torch
import torch.distributed as dist
assert not dist.is_initialized()
assert not torch.cuda.is_initialized()
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def test_port_imports_no_jax():
    r = subprocess.run([sys.executable, "-c", _PROBE,
                        str(REPO / "chip_smoke.py")], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 20


def test_chip_smoke_fails_without_card(tmp_path):
    """No card here: non-zero exit and no result line. Alone in a
    directory (no checkout beside it) it fails too."""
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    r = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                       env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
