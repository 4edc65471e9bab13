"""Per-device cost of a step: the port's counterpart of XLA's
``compiled.cost_analysis()`` and ``memory_analysis()`` and of the
reference's HLO parsers (``repro/analysis/roofline.py:41-131``).

A ``Recorder`` keeps one record per op a step dispatches. It records in
one of two ways, through the same ``Recorder._record``:

  * ``recording(rec)``: a ``TorchDispatchMode`` over real tensors, on
    either device (the BSS-2 cell, ``core.hybrid.trace_bss2_cell``);
  * ``recording(rec, fake=True)``: a ``FakeTensorMode`` that records, for
    the LM cells on a fake world (``launch/dryrun.py``). The step's inputs
    are made inside it as fake local shards wrapped into DTensors, so the
    mode sees every local op with its local shapes and each collective
    DTensor issues: per-device counts, as ``cost_analysis()`` gives them
    for a partitioned executable. A plain dispatch mode under DTensor sees
    only the global ops.

What a record counts:

  * FLOPs per device: ``torch.utils.flop_counter``'s formulas for the
    matrix products, one per output element for ops tagged
    ``torch.Tag.pointwise`` (XLA's convention for elementwise ops), and
    ``transcendentals`` apart (exp, log, tanh, sigmoid, rsqrt, erf, a
    power with a tensor or fractional exponent, softmax), which XLA
    counts instead of FLOPs.
  * HBM bytes by the reference's entry-level model
    (``roofline.py:78-103``): each op's outputs count once written and
    once read (``rw`` = 2 x ``total_write``); views and metadata ops are
    free, and so is an allocation (``empty``), which writes nothing. In
    eager PyTorch every aten op is an entry op, so this is the port's own
    traffic, not an estimate of what a compiler would fuse.
  * Collectives by the reference's kinds with per-device bytes, as
    ``parse_collectives`` counts them (``roofline.py:106-131``): an
    all-reduce's and an all-to-all's result, an all-gather's (gathered)
    result, a reduce-scatter's operand. Each is counted once;
    ``wait_tensor`` is not a collective.
  * Memory: ``arg_bytes`` (the step's inputs, local bytes), ``out_bytes``
    (its outputs) and ``temp_bytes``, the peak of live bytes the step
    itself allocated, tracked by storage (a view adds nothing) and
    released when the storage's last reference goes.
  * Kernel calls: each hand-written kernel's wrapper, where ``ACTIVE``
    is set, calls itself again through ``kernel_call``, which records one
    entry ``repro_torch::<name>`` with the work the kernel's ``work``
    function declares and pauses the recorder inside (``ACTIVE`` unset),
    so the CPU's plain version is not counted op by op and the card and
    the CPU count the same. A gated pair of routes (``gate_call``)
    records the larger of the two.

``ACTIVE`` is the recorder only while it counts and outside a kernel
call: with none, a wrapper reads that one module attribute and goes on.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import NamedTuple, Optional

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# the recorder kernel wrappers report to: set from ``Recorder.begin`` to
# ``end``, unset inside a kernel call; ``None`` when nothing records
ACTIVE: Optional["Recorder"] = None

_DTYPE_NAMES = {
    torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
}

# ops that move no data: metadata, aliases, allocations
_FREE = {
    "aten.detach", "aten.alias", "aten.lift_fresh", "aten._unsafe_view",
    "aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
    "aten.new_empty_strided", "prim.device", "aten.sym_size",
    "aten.sym_stride", "aten.sym_numel", "aten.sym_storage_offset",
    "aten._local_scalar_dense", "_c10d_functional.wait_tensor",
    "_c10d_functional._wrap_tensor_autograd",
}

_TRANSCENDENTAL = {
    "aten.exp", "aten.exp_", "aten.exp2", "aten.expm1", "aten.log",
    "aten.log_", "aten.log1p", "aten.log2", "aten.log10", "aten.tanh",
    "aten.tanh_", "aten.sigmoid", "aten.sigmoid_", "aten.rsqrt",
    "aten.sqrt", "aten.erf", "aten.erfc", "aten.erfinv", "aten.sin",
    "aten.cos", "aten.tan", "aten.atan2", "aten.pow", "aten.pow_",
    "aten._softmax", "aten._log_softmax", "aten.logsumexp",
    "aten.softplus", "aten.silu", "aten.gelu",
}

# functional collectives -> (the reference's kind, which side's bytes)
_COLLECTIVES = {
    "_c10d_functional.all_reduce": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", "out"),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "out"),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", "out"),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather",
                                                          "out"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "in"),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                                         "in"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "out"),
    "_c10d_functional.broadcast": ("broadcast", "out"),
}


class Work(NamedTuple):
    """What one kernel call does: FLOPs, HBM bytes moved (each input read
    once, each output written once) and transcendentals."""
    flops: float
    bytes: float
    transcendentals: float = 0.0


class OpRecord(NamedTuple):
    """One op of the log: its name, the type of its outputs as HLO prints
    them (``f32[16,1024]``, a tuple in parentheses), the bytes it writes
    (0 for a free op), its FLOPs and transcendentals."""
    kind: str
    type: str
    bytes: int
    flops: float
    transcendentals: float


def _tensors(tree):
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _local(t):
    """A DTensor's local shard, a plain tensor as it is."""
    return getattr(t, "_local_tensor", t)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _type_str(ts) -> str:
    parts = [f"{_DTYPE_NAMES.get(t.dtype, str(t.dtype))}"
             f"[{','.join(str(int(d)) for d in t.shape)}]" for t in ts]
    return parts[0] if len(parts) == 1 else "(" + ", ".join(parts) + ")"


def _power_is_product(args) -> bool:
    """``x ** k`` with a small whole exponent is products (XLA's
    ``integer_pow``), not a transcendental."""
    e = args[1] if len(args) > 1 else None
    return isinstance(e, (int, float)) and float(e).is_integer() \
        and abs(e) <= 4


class Recorder:
    """The counts of one step (see the module docstring). ``begin(args)``
    starts counting with the step's inputs, ``end(outputs)`` stops it;
    ops outside are not counted."""

    def __init__(self):
        self.ops = []
        self.flops = 0.0
        self.transcendentals = 0.0
        self.total_write = 0.0
        self.by_kind = defaultdict(float)
        self.coll = {}
        self.kernels = {}
        self.arg_bytes = 0
        self.out_bytes = 0
        self.temp_bytes = 0
        self.paused = 0
        self.counting = False
        self._live = 0
        self._owned = set()
        self._args = set()

    # -- step bounds ---------------------------------------------------------
    @staticmethod
    def _storages(tree):
        out = {}
        for t in _tensors(tree):
            st = _local(t).untyped_storage()
            out[st._cdata] = st
        return out

    def begin(self, args=()):
        """Count from here; ``args`` (any tree of tensors or DTensors) are
        the step's inputs: their local bytes are ``arg_bytes`` and they
        never count as temporaries."""
        global ACTIVE
        sts = self._storages(args)
        self._args = set(sts)
        self.arg_bytes = sum(st.nbytes() for st in sts.values())
        self.counting = True
        ACTIVE = self

    def end(self, outputs=()):
        """Stop counting; ``outputs`` are the step's results."""
        global ACTIVE
        self.counting = False
        ACTIVE = None
        self.out_bytes = sum(st.nbytes()
                             for st in self._storages(outputs).values())

    # -- memory --------------------------------------------------------------
    def _release(self, key, n):
        self._live -= n
        self._owned.discard(key)

    def _track(self, outs, ins):
        """Storages first seen among ``outs`` and not among ``ins`` (an
        in-place op writes its input's) are the step's own allocations."""
        held = {_local(t).untyped_storage()._cdata for t in ins}
        for t in outs:
            st = _local(t).untyped_storage()
            key = st._cdata
            if key in held or key in self._owned or key in self._args:
                continue
            n = st.nbytes()
            if n == 0:
                continue
            self._owned.add(key)
            self._live += n
            weakref.finalize(st, self._release, key, n)
            self.temp_bytes = max(self.temp_bytes, self._live)

    # -- ops -----------------------------------------------------------------
    def _record(self, func, args, kwargs, out):
        if not self.counting or self.paused:
            return
        kind = str(func.overloadpacket)
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        self._track(outs, ins)
        if not outs:
            return
        free = kind in _FREE or func.is_view
        b = 0 if free else sum(_nbytes(t) for t in outs)
        flops = trans = 0.0
        packet = func.overloadpacket
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **(kwargs or {}),
                                                out_val=out))
        elif kind in _TRANSCENDENTAL and not (
                kind.startswith("aten.pow") and _power_is_product(args)):
            trans = float(outs[0].numel())
        elif torch.Tag.pointwise in func.tags:
            flops = float(outs[0].numel())
        if kind in _COLLECTIVES:
            ck, side = _COLLECTIVES[kind]
            src = outs if side == "out" else _tensors(args[:1])
            c = self.coll.setdefault(ck, dict(count=0, bytes=0.0))
            c["count"] += 1
            c["bytes"] += float(sum(_nbytes(t) for t in src))
        self.flops += flops
        self.transcendentals += trans
        if b:
            self.total_write += b
            self.by_kind[kind] += b
        self.ops.append(OpRecord(kind, _type_str(outs), b, flops, trans))

    def _kernel(self, name, work: Work):
        kind = f"repro_torch::{name}"
        k = self.kernels.setdefault(name, dict(count=0, flops=0.0,
                                               bytes=0.0,
                                               transcendentals=0.0))
        k["count"] += 1
        k["flops"] += work.flops
        k["bytes"] += work.bytes
        k["transcendentals"] += work.transcendentals
        self.flops += work.flops
        self.transcendentals += work.transcendentals
        # declared bytes are reads and writes: they enter ``rw`` as they
        # are, so half of them stands in ``total_write``
        self.total_write += work.bytes / 2
        self.by_kind[kind] += work.bytes / 2
        self.ops.append(OpRecord(kind, "kernel", int(work.bytes), work.flops,
                                 work.transcendentals))

    # -- the reference's dicts -------------------------------------------------
    @property
    def hbm_rw(self) -> float:
        return 2.0 * self.total_write

    def summary(self) -> dict:
        return dict(flops=self.flops, transcendentals=self.transcendentals,
                    hbm_rw=self.hbm_rw, coll={k: dict(v) for k, v in
                                              self.coll.items()},
                    kernels={k: dict(v) for k, v in self.kernels.items()},
                    arg_bytes=self.arg_bytes, out_bytes=self.out_bytes,
                    temp_bytes=self.temp_bytes, n_ops=len(self.ops))


class CostMode(TorchDispatchMode):
    """Records every op on real tensors into ``rec``."""

    def __init__(self, rec: Recorder):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.rec._record(func, args, kwargs, out)
        return out


_FAKE_CLASS = None


def _fake_mode(rec: Recorder):
    """A ``FakeTensorMode`` that records into ``rec`` (the class is made
    at first use)."""
    global _FAKE_CLASS
    if _FAKE_CLASS is None:
        from torch._subclasses.fake_tensor import FakeTensorMode

        class FakeCostMode(FakeTensorMode):
            # Not the program's ops, so not recorded: an op without a meta
            # kernel runs its decomposition through this mode again
            # (``depth``), and DTensor's sharding propagation runs each op
            # on global-shape fakes in the active fake mode, which it
            # enters a second time (``entered``).
            depth = 0
            entered = 0

            def __enter__(self):
                self.entered += 1
                return super().__enter__()

            def __exit__(self, *exc):
                try:
                    return super().__exit__(*exc)
                finally:
                    self.entered -= 1

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                self.depth += 1
                try:
                    out = super().__torch_dispatch__(func, types, args,
                                                     kwargs)
                finally:
                    self.depth -= 1
                if self.depth == 0 and self.entered == 1:
                    self.rec._record(func, args, kwargs, out)
                return out
        _FAKE_CLASS = FakeCostMode
    mode = _FAKE_CLASS(allow_non_fake_inputs=True)
    mode.rec = rec
    return mode


@contextlib.contextmanager
def recording(rec: Optional[Recorder] = None, *, fake: bool = False):
    """Record into ``rec`` (a new ``Recorder`` if ``None``), which is
    yielded; counting runs from ``rec.begin(args)`` to ``rec.end(out)``.
    With ``fake`` the mode is a ``FakeTensorMode``: tensors made inside
    are fake, nothing is allocated or computed."""
    global ACTIVE
    rec = Recorder() if rec is None else rec
    mode = _fake_mode(rec) if fake else CostMode(rec)
    try:
        with mode:
            yield rec
    finally:
        rec.counting = False
        ACTIVE = None


@contextlib.contextmanager
def paused():
    """Nothing inside is recorded."""
    global ACTIVE
    rec = ACTIVE
    if rec is None:
        yield
        return
    rec.paused += 1
    ACTIVE = None
    try:
        yield
    finally:
        rec.paused -= 1
        ACTIVE = rec


def kernel_call(name: str, work: Work, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` as one call of kernel ``name`` doing
    ``work``: one entry, nothing inside counted (``ACTIVE`` is unset
    inside, so a wrapper that calls itself through here runs its body).
    With no recorder counting, just the call."""
    rec = ACTIVE
    if rec is None:
        return fn(*args, **kwargs)
    rec._kernel(name, work)
    with paused():
        out = fn(*args, **kwargs)
    rec._track(_tensors(out), _tensors((args, kwargs)))
    return out


def larger(works: dict) -> str:
    """The name of the larger of ``works`` (name -> ``Work``): the one
    with the longer roofline time on ``config.HW`` (bytes over the HBM
    rate against FLOPs over the float32 peak)."""
    from repro_torch.config import HW

    def t(w):
        return max(w.bytes / HW.hbm_bw, w.flops / HW.peak_flops_fp32)
    return max(sorted(works), key=lambda k: t(works[k]))


def gate_call(works: dict, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` as a gated pair of routes (name -> ``Work``
    in ``works``): one entry, the larger route's, whichever route runs, so
    the count depends on shapes only and the host never reads the flag."""
    name = larger(works)
    return kernel_call(name, works[name], fn, *args, **kwargs)
