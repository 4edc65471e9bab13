"""Quickstart on the port: the machine model in a few lines.

  1. the BSS-2 machine model (paper's C1): emulate a spiking network,
  2. the PPU hybrid-plasticity step (R-STDP, Eqs. 2-3),
  3. an assigned LM architecture through the same stack: its initial
     loss on a synthetic batch (``examples/quickstart.py``).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given (and raises
without one).
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.bss2 import BSS2
from repro_torch.core.anncore import AnnCore
from repro_torch.core.hybrid import run_training
from repro_torch.verif.mismatch import sample_instance


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    # --- 1. emulate the analog core ---------------------------------------
    cfg = dataclasses.replace(BSS2.reduced(), n_rows=16, n_cols=16)
    inst = sample_instance(cfg, torch.Generator().manual_seed(0),
                           device=device)                  # a virtual chip
    core = AnnCore(cfg, inst)
    state = core.init_state()
    state = state._replace(syn=state.syn._replace(
        weights=torch.full((16, 16), 45, dtype=torch.int8, device=device)))
    T = 400
    events = (torch.rand((T, 16), generator=torch.Generator().manual_seed(
        1)) < 0.02).to(torch.float32).to(device)
    addrs = torch.zeros((T, 16), dtype=torch.int8, device=device)
    state, out = core.run(state, events, addrs)
    print(f"[1] anncore ({core.backend} backend on {device}): "
          f"{int(out['spikes'].sum())} output spikes from "
          f"{int(events.sum())} input events over {T * cfg.dt:.0f} us model "
          f"time")

    # --- 2. hybrid plasticity (paper §5) ----------------------------------
    res, _, _ = run_training(n_trials=300, seed=0, device=device)
    mr = res["mean_reward"]
    print(f"[2] R-STDP: median <R> after {mr.shape[0]} trials = "
          f"{float(np.median(mr[-1])):.2f} (paper Fig. 11: -> ~1)")

    # --- 3. an assigned LM arch through the same stack --------------------
    from repro_torch.config import ShapeConfig, get_arch
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel.sharding import ShardingCtx, init_params

    arch = get_arch("smollm-360m").reduced()
    bundle = build_model(arch, ShardingCtx())
    params = init_params(bundle.decls, torch.Generator().manual_seed(0),
                         device)
    pipe = SyntheticLMPipeline(arch, ShapeConfig("s", 32, 2, "train"))
    with torch.no_grad():
        loss = bundle.loss(params, pipe.next_batch(device))
    print(f"[3] {arch.name} (reduced): initial LM loss {float(loss):.3f} "
          f"(ln V = {np.log(arch.vocab):.3f})")
    print("quickstart OK")


if __name__ == "__main__":
    main()
