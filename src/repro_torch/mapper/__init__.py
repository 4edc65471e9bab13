"""Automatic network partitioner / chip mapper (``repro/mapper``).

Compile an arbitrary-topology ``NetworkSpec`` (sizes beyond the native
256x512 fabric, arbitrary sparse connectivity, arbitrary Dale sign
structure) onto K logical BSS-2 chips, bit-exactly: the partitioned and
routed emulation equals the single-virtual-chip emulation of the same
network with ``assert_array_equal``. ``spec``, ``partition`` and
``mapping`` are host numpy, copies of the reference's; ``runtime`` runs
the mapping on a device.

    spec    = mapper.NetworkSpec(n_in=300, n_neurons=700, w_in=...)
    m       = mapper.map_network(spec, n_chips=4)
    rt      = mapper.build_runtime(m)     # on the card; device="cpu" here
    _, out  = rt.run(ev_in)               # out["spikes"]: [W, T, 700]
"""
from repro_torch.mapper.mapping import (ChipMapping, map_network,
                                        min_chip_rows, row_demand)
from repro_torch.mapper.partition import (CapacityError, ColumnPartition,
                                          partition_columns)
from repro_torch.mapper.runtime import (MappedRuntime, build_runtime,
                                        gather_spikes, place_inputs,
                                        sample_network_instance,
                                        scatter_instance)
from repro_torch.mapper.spec import WMAX, NetworkSpec, random_spec

__all__ = [
    "CapacityError", "ChipMapping", "ColumnPartition", "MappedRuntime",
    "NetworkSpec", "WMAX", "build_runtime", "gather_spikes", "map_network",
    "min_chip_rows", "partition_columns", "place_inputs", "random_spec",
    "row_demand", "sample_network_instance", "scatter_instance",
]
