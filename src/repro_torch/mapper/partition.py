"""Column partitioning: tile a NetworkSpec's neurons onto K chips.
(A copy of ``repro/mapper/partition.py``, held equal to it by
``tests/test_torch_mapper.py``.)


The neuron (column) side of the mapping problem.  Each logical chip has
``chip_cols`` neuron circuits; a ``Blacklist`` (from
``repro_torch.faults.screen``) may mark some of them unusable.  The
partitioner assigns every spec neuron a ``(chip, column-slot)`` in
ascending neuron order, contiguous blocks per chip, balanced over the
chips' *usable* capacity — so a defect-heavy chip automatically takes a
smaller share (the paper's commissioning story made automatic).

Row capacity is NOT decided here: how many driver rows a chip needs
depends on which sources fan into the neurons placed on it, which is
resolved by ``repro_torch.mapper.mapping.map_network`` after the column split.

Contract tests: ``tests/test_torch_mapper.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


class CapacityError(ValueError):
    """The network does not fit the requested chips (columns or rows).

    Raised — never silently truncated — in the house never-silent style.
    The message names the chip and the demand/capacity pair.
    """


@dataclass(frozen=True)
class ColumnPartition:
    """Result of ``partition_columns``.

    Attributes:
      col_chip: ``[n_neurons]`` int32, owning chip per spec neuron.
      col_slot: ``[n_neurons]`` int32, physical column on that chip.
      n_chips: K.
      chip_cols: physical columns per chip (C).
    """
    col_chip: np.ndarray
    col_slot: np.ndarray
    n_chips: int
    chip_cols: int

    def chip_neurons(self, k: int) -> np.ndarray:
        """Spec-neuron ids placed on chip ``k`` (ascending)."""
        return np.nonzero(self.col_chip == k)[0]

    def used_mask(self) -> np.ndarray:
        """[K, C] bool — columns that carry a spec neuron."""
        m = np.zeros((self.n_chips, self.chip_cols), bool)
        m[self.col_chip, self.col_slot] = True
        return m


def partition_columns(n_neurons: int, n_chips: int, chip_cols: int,
                      bad_neurons: Optional[np.ndarray] = None,
                      ) -> ColumnPartition:
    """Balanced contiguous split of ``n_neurons`` over ``n_chips``.

    Args:
      n_neurons: spec neurons to place.
      n_chips: K logical chips.
      chip_cols: physical neuron columns per chip.
      bad_neurons: optional ``[n_chips, chip_cols]`` bool — screened-out
        neuron circuits (``Blacklist.neurons``); those slots are skipped.

    Returns: a ``ColumnPartition`` (neurons in ascending order, chip 0
      first; slots are the lowest usable column indices on each chip).

    Raises:
      CapacityError: total usable columns < ``n_neurons``.

    Balancing: chip ``k`` receives ``ceil(remaining / chips_left)``
    neurons, clamped to its usable capacity, so defect-free chips share
    the load evenly and defective chips shed theirs to later chips.
    """
    if bad_neurons is None:
        bad = np.zeros((n_chips, chip_cols), bool)
    else:
        bad = np.asarray(bad_neurons, bool)
        assert bad.shape == (n_chips, chip_cols), \
            f"bad_neurons shape {bad.shape} != {(n_chips, chip_cols)}"
    usable = [np.nonzero(~bad[k])[0] for k in range(n_chips)]
    total = sum(u.size for u in usable)
    if total < n_neurons:
        raise CapacityError(
            f"{n_neurons} neurons > {total} usable columns on "
            f"{n_chips} chip(s) x {chip_cols} cols "
            f"({int(bad.sum())} blacklisted)")

    col_chip = np.empty(n_neurons, np.int32)
    col_slot = np.empty(n_neurons, np.int32)
    nxt = 0
    for k in range(n_chips):
        remaining = n_neurons - nxt
        chips_left = n_chips - k
        want = -(-remaining // chips_left)  # ceil
        take = min(want, usable[k].size)
        if take:
            col_chip[nxt:nxt + take] = k
            col_slot[nxt:nxt + take] = usable[k][:take]
            nxt += take
    if nxt < n_neurons:
        # Balanced quotas under-filled early chips while later ones were
        # defect-starved; greedily top up in a second pass.
        filled = np.zeros((n_chips, chip_cols), bool)
        filled[col_chip[:nxt], col_slot[:nxt]] = True
        for k in range(n_chips):
            free = np.nonzero(~bad[k] & ~filled[k])[0]
            take = min(n_neurons - nxt, free.size)
            if take:
                col_chip[nxt:nxt + take] = k
                col_slot[nxt:nxt + take] = free[:take]
                nxt += take
            if nxt == n_neurons:
                break
    assert nxt == n_neurons
    # Re-sort so ascending neuron id keeps ascending (chip, slot): the
    # top-up pass can interleave chips out of order.
    order = np.lexsort((col_slot, col_chip))
    return ColumnPartition(col_chip=col_chip[order].copy(),
                           col_slot=col_slot[order].copy(),
                           n_chips=n_chips, chip_cols=chip_cols)
