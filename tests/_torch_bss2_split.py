"""One rank of the column-split check (``tests/test_torch_bss2_split.py``
starts WORLD of them): ``python _torch_bss2_split.py RANK WORLD STORE_FILE
[gloo|nccl] [PARTS]``.

The ranks are one ``model`` group of the BSS-2 fleet cell: each joins a
process group through a file store (gloo on the CPU, the default; nccl on
card ``RANK``, one card a rank) and runs, in turn, its PARTS / WORLD
column parts (``core.hybrid.column_part``; PARTS defaults to WORLD) of a
fleet of 2 full 256 x 512 chips with the cell's ``RSTDPConfig(128, 512,
pattern_size=24, trial_steps=128)``, over two trials (stimulus A, then
none). The parts' spikes, metrics (reward, mean reward, rates,
eligibility, signed weights) and final state (6-bit weights,
``w_signed``, the neuron, sensor and counter planes), all-gathered over
the group and put side by side in column order, must equal the whole
chip's trial bit for bit; the leaves that hold rows (the STP resources,
the sensors' pre traces) equal the whole chip's on every part, and so do
each part's route counts. Prints ``BSS2_SPLIT_OK rank=R parts=P
cols=C``. Not collected by pytest (no ``test_`` prefix).
"""
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs.bss2 import BSS2  # noqa: E402
from repro_torch.core import hybrid as th  # noqa: E402
from repro_torch.core import synapse  # noqa: E402

ECFG = th.RSTDPConfig(n_inputs=128, n_neurons=512, pattern_size=24,
                      trial_steps=128)
PREFIX, STIMS, SEED = (2,), [1, 0], 5


def run_part(parts, part, dev):
    """Two trials of one column part (``parts = 1``: the whole chip):
    ``(spikes, metrics, state, route counts)``, the spikes and metrics a
    list a trial."""
    init, trial, meta = th.column_part(
        BSS2, ECFG, parts, part, generator=torch.Generator().manual_seed(SEED),
        prefix=PREFIX, backend="blocked", device=dev)
    draws = meta["draw"](torch.Generator().manual_seed(SEED + 1), STIMS)
    core, run = meta["core"], meta["core"].run
    spikes = []

    def spy(*args, **kwargs):
        cs, out = run(*args, **kwargs)
        spikes.append(out["spikes"])
        return cs, out
    core.run = spy
    synapse.reset_route_counts()
    state, metrics = init(), []
    for i, stim in enumerate(STIMS):
        state, m = trial(state, stim, draws.events[i], draws.xi[i])
        metrics.append(m)
    return spikes, metrics, state, synapse.route_counts(dev).clone()


def flatten(spikes, metrics, state):
    """Every output of a run as ``(name, tensor)``, in a fixed order."""
    out = [(f"spikes[{i}]", s) for i, s in enumerate(spikes)]
    out += [(f"{k}[{i}]", m[k]) for i, m in enumerate(metrics)
            for k in sorted(m)]
    out += [(f"state.{i}", x) for i, x in enumerate(th._leaves(state))]
    return out


def main(rank, world, store_file, backend="gloo", parts=None):
    parts = world if parts is None else int(parts)
    if parts % world:
        raise ValueError(f"{parts} parts on {world} ranks")
    dev = (torch.device("cuda", rank) if backend == "nccl"
           else torch.device("cpu"))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store_file}",
                            rank=rank, world_size=world)
    try:
        per = parts // world
        mine = [run_part(parts, p, dev)
                for p in range(rank * per, (rank + 1) * per)]
        whole = run_part(1, 0, dev)
        want = flatten(*whole[:3])
        outs = [flatten(*m[:3]) for m in mine]
        c = BSS2.n_cols // parts
        checked = 0
        for j, (name, w) in enumerate(want):
            local = [o[j][1] for o in outs]
            if local[0].shape == w.shape:
                # a leaf of rows: every part holds it whole
                for x in local:
                    assert torch.equal(x, w), f"{name}: a part differs"
                continue
            assert local[0].shape[-1] == c, (name, local[0].shape)
            mine_cat = torch.cat(local, -1).contiguous()
            got = [torch.empty_like(mine_cat) for _ in range(world)]
            dist.all_gather(got, mine_cat)
            got = torch.cat(got, -1)
            assert got.dtype == w.dtype and got.shape == w.shape, name
            assert torch.equal(got, w), f"{name}: gathered parts differ"
            checked += 1
        for m in mine:
            assert torch.equal(m[3], whole[3]), (m[3], whole[3])
        assert checked >= 2 * 6 + 5, checked
        assert float(whole[0][0].sum()) > 0
        print(f"BSS2_SPLIT_OK rank={rank} parts={parts} cols={c} "
              f"leaves={checked} routes={whole[3].tolist()}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], *sys.argv[4:])
