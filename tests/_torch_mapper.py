"""The full-width mapper network of the port's card checks (not collected
by pytest: no ``test_`` prefix; imports no JAX). ``chip_smoke.py``'s path
F, ``tests/test_torch_cuda.py`` and ``benchmarks/torch_mapper_bench.py``
map and run it."""
import numpy as np

from repro_torch import mapper

N_IN, N_NEURONS = 480, 2048


def path_f_spec() -> mapper.NetworkSpec:
    """The shape of ``examples/map_network.py`` scaled to fill four native
    256 x 512 chips: input i drives neurons floor(i * 2048 / 480) + d
    (d < 8, mod 2048) with weight 30 - 3d, and every 8th neuron j
    inhibits j + 1, 5, 9 and 515 (mod 2048; the last lands on the next
    chip) with weight -15: 4,864 edges."""
    w_in = np.zeros((N_IN, N_NEURONS), np.int32)
    for i in range(N_IN):
        for d in range(8):
            w_in[i, ((i * N_NEURONS) // N_IN + d) % N_NEURONS] = 30 - 3 * d
    w_rec = np.zeros((N_NEURONS, N_NEURONS), np.int32)
    for j in range(0, N_NEURONS, 8):
        for o in (1, 5, 9, 515):
            w_rec[j, (j + o) % N_NEURONS] = -15
    return mapper.NetworkSpec(N_IN, N_NEURONS, w_in, w_rec, name="path-f")


def path_f_mappings(spec):
    """K = 4 native 256 x 512 chips (all2all), K = 2 chips of
    ``min_chip_rows`` + 8 rows x 1024 columns (490: Dale halves of 245
    rows), K = 1 chip of ``min_chip_rows`` + 8 rows x 2048 (968)."""
    maps = {4: mapper.map_network(spec, 4, chip_rows=256, chip_cols=512)}
    for K, cols in ((2, 1024), (1, 2048)):
        maps[K] = mapper.map_network(
            spec, K, chip_rows=mapper.min_chip_rows(spec, K, cols) + 8,
            chip_cols=cols)
    return maps
