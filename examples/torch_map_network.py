"""Map an arbitrary 300x700 network onto 4 chips and train it, on the
port (the counterpart of ``examples/map_network.py``).

The network is bigger than one native 256x512 chip in both directions,
so it cannot run monolithically on real hardware at all: the mapper
(``repro_torch.mapper``) partitions the 700 neurons over 4 chips,
allocates driver rows per chip, assigns the 6-bit address schedule and
emits a validated ``WaferPlan``. Training is the paper's
hardware-in-the-loop shape: emulate on the mapped chips, read spikes
back, update the *network description* on the host, re-map, repeat; the
placement is fixed after the first epoch, so re-mapping is a cheap
host-side re-emission of the weight blocks.

Run:  PYTHONPATH=src python examples/torch_map_network.py [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given (and raises
without one).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import mapper, resolve_device

N_IN, N_NEURONS, K = 300, 700, 4
EPOCHS, W, T = 6, 2, 48


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # --- an arbitrary signed network beyond the native fabric ------------
    # locality-structured feedforward (each input drives a neighborhood)
    # plus sparse inhibitory recurrence: the shape the mapper is for
    w_in = np.zeros((N_IN, N_NEURONS), np.int32)
    for i in range(N_IN):
        w_in[i, (2 * i) % N_NEURONS] = 30
        w_in[i, (2 * i + 1) % N_NEURONS] = 20
    w_rec = np.zeros((N_NEURONS, N_NEURONS), np.int32)
    for j in range(0, N_NEURONS, 2):
        w_rec[j, (j + 1) % N_NEURONS] = -15

    # two input patterns; training goal: pattern A drives the low half of
    # the neurons harder than pattern B does (a linear-separation toy)
    pat_a = rng.permutation(N_IN)[:60]
    pat_b = rng.permutation(N_IN)[:60]
    low = torch.from_numpy(np.arange(N_NEURONS) < N_NEURONS // 2).to(device)

    def events_for(pattern):
        ev = np.zeros((W, T, N_IN), np.float32)
        ev[:, ::3][:, :, pattern] = 1.0          # drive the pattern rows
        noise = rng.random((W, T, N_IN)) < 0.01  # background
        return torch.from_numpy(np.maximum(ev, noise.astype(np.float32))
                                ).to(device)

    def separation(rt):
        """<low-half spikes | A> - <low-half spikes | B> on the mapped
        run."""
        _, out_a = rt.run(events_for(pat_a))
        _, out_b = rt.run(events_for(pat_b))
        ra = out_a["spikes"][..., low].sum()
        rb = out_b["spikes"][..., low].sum()
        return float(ra - rb)

    spec = mapper.NetworkSpec(n_in=N_IN, n_neurons=N_NEURONS, w_in=w_in,
                              w_rec=w_rec, name="demo-300x700")
    t0 = time.perf_counter()
    m = mapper.map_network(spec, n_chips=K)      # native 256x512 chips
    map_ms = (time.perf_counter() - t0) * 1e3
    print(f"mapped {spec.n_sources} sources x {N_NEURONS} neurons onto "
          f"{K} chips in {map_ms:.0f} ms (host): "
          f"{int((m.row_source >= 0).sum())} driver rows, "
          f"{m.n_relayed_edges} relayed edges, {m.n_transit_rows} transit "
          f"rows; running on {device}")

    net_inst = None
    history = []
    t0 = time.perf_counter()
    for epoch in range(EPOCHS):
        rt = mapper.build_runtime(m, net_inst=net_inst, device=device)
        net_inst = rt.net_inst                   # sample mismatch once
        history.append(separation(rt))
        # host update: reward-modulated Hebb: strengthen A-pattern inputs
        # into the low half, weaken B-pattern ones (6-bit saturating, Dale
        # sign preserving), then re-emit the weight blocks for the SAME
        # placement
        lo = np.arange(N_NEURONS) < N_NEURONS // 2
        dw = np.zeros_like(w_in)
        dw[np.ix_(pat_a, lo)] += 4
        dw[np.ix_(pat_b, lo)] -= 4
        w_in = np.clip(w_in + dw, 0, mapper.WMAX)  # input rows excitatory
        spec = mapper.NetworkSpec(n_in=N_IN, n_neurons=N_NEURONS,
                                  w_in=w_in, w_rec=w_rec, name=spec.name)
        m = mapper.map_network(spec, n_chips=K)
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"{EPOCHS} epochs (map, build, 2 x {W} windows of T={T}) in "
          f"{time.perf_counter() - t0:.2f} s (host clock)")
    print("separation per epoch:", [f"{s:.0f}" for s in history])
    assert history[-1] > history[0], \
        "training must improve the separation objective (a silent run " \
        "proves nothing)"
    print("map_network OK")


if __name__ == "__main__":
    main()
