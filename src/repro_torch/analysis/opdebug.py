"""Op-log inspection helpers (``repro/analysis/hlodebug.py``).

``top_buffers`` ranks the result tensors of a recorded step by size (the
recorder's op log, ``cost.Recorder.ops``, where the reference reads the
optimized HLO): the fastest way to find what is actually materialized
when the memory term looks wrong. Every op counts here, views included,
as every HLO line does in the reference's helpers.
"""
from __future__ import annotations

import re
from collections import Counter, defaultdict

_SHAPE_RE = re.compile(r"(f64|f32|f16|bf16|s64|u64|s32|u32|s16|u16|s8|u8|"
                       r"pred|c64|c128)\[([0-9,]*)\]")
_DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "s64": 8, "u64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1, "c64": 8, "c128": 16}


def _bytes_of(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _size(rec) -> int:
    """An op's result bytes (a kernel entry: its declared bytes)."""
    return rec.bytes if rec.type == "kernel" else _bytes_of(rec.type)


def top_buffers(cost, n: int = 30):
    """Largest result tensors: (total bytes, count, bytes each, op kind,
    type), results under 1 MiB left out."""
    agg = defaultdict(lambda: [0, 0])  # (op_kind, type) -> [count, bytes]
    for rec in cost.ops:
        b = _size(rec)
        if b < (1 << 20):
            continue
        key = (rec.kind, rec.type[:120])
        agg[key][0] += 1
        agg[key][1] = b
    rows = sorted(((cnt * b, cnt, b, kind, t)
                   for (kind, t), (cnt, b) in agg.items()), reverse=True)
    return rows[:n]


def print_top_buffers(cost, n: int = 30):
    for total, cnt, b, kind, t in top_buffers(cost, n):
        print(f"{total/2**30:8.2f} GiB total | {cnt:5d} x {b/2**20:9.1f} MiB | "
              f"{kind:24s} | {t}")


def bytes_by_op(cost, n: int = 20):
    agg = Counter()
    for rec in cost.ops:
        agg[rec.kind] += _size(rec)
    return agg.most_common(n)
