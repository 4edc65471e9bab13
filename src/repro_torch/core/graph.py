"""A loop with no host work in its body, captured once as a CUDA graph.

The reference compiles its scanned paths (``jax.lax.scan`` under ``jit``)
into one device program. The port's counterpart is a loop object whose
``body()`` runs one step of the scan through the loop's own tensors: it
reads its inputs at a step counter on the device, copies the new carry
into the loop's carry tensors (``assign``) and advances the counter.
``LoopGraph`` captures that body once and replays it once a step.

Two loops use it: ``core.hybrid.TrialLoop`` (the §5 experiment's trials)
and ``wafer.router.WindowLoop`` (a mapped network's routed windows). Under
a ``torch.distributed`` group their bodies hold the router's NCCL
collectives, and the graph holds them too: the warm-up body issues them
eagerly first (so a communicator NCCL sets up lazily is made there, not
under the capture), and every rank of the group captures and replays the
same loop at the same call.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core import synapse


def leaves(tree):
    """The tensors of a tree of NamedTuples, in order (an empty slot,
    ``None``, has none)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for v in tree for x in leaves(v)]


def rebuild(tree, new_leaves):
    """``tree`` with its tensors replaced by ``new_leaves`` (in order)."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, torch.Tensor):
            return next(it)
        return type(t)(*(build(v) for v in t))
    return build(tree)


def clones(tree):
    """``tree`` with each of its tensors cloned."""
    return rebuild(tree, [x.clone() for x in leaves(tree)])


def assign(dst, src, what: str):
    """Copy the tensors ``src`` into the loop's carry tensors ``dst``. A
    tensor the body passed through unchanged is the carry tensor itself;
    one that shares memory with another carry tensor is copied out first,
    so no copy reads what an earlier one wrote."""
    held = {x.untyped_storage().data_ptr() for x in dst}
    src = [s if s is d or s.untyped_storage().data_ptr() not in held
           else s.clone() for s, d in zip(src, dst)]
    for s, d in zip(src, dst):
        if s.shape != d.shape or s.dtype != d.dtype:
            raise ValueError(f"{what}: a carried tensor changed from "
                             f"{d.dtype}{tuple(d.shape)} to "
                             f"{s.dtype}{tuple(s.shape)}")
        if s is not d:
            d.copy_(s)


class LoopGraph:
    """``loop.body()`` captured once as a CUDA graph; ``replay()`` runs the
    loop's next step. ``loop`` has ``body()``, ``reset()`` and its step
    counter ``step`` on a CUDA device.

    Before the capture one body runs on a side stream, on the loop's own
    tensors: it builds the kernels, fills the lazy caches on the path
    (``AnnCore``'s packed neuron parameters, the census's ticket, the
    device's route counter) and allocates the loop's output buffers. Then
    the loop is reset and the route counter is set back to its value
    before that step. The capture runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a body that reads the
    host, or copies host data to the device, raises instead of being
    captured. Nothing falls back to eager steps.

    ``launches`` holds the kernel launches the wrappers counted while the
    body was captured: what each replay launches (the wrappers' own
    counts do not move under replay). ``pool_bytes`` is what the capture
    added to the allocator's reserved memory: the graph's private pool,
    which holds the body's intermediate tensors."""

    captures = 0        # graphs captured in this process

    def __init__(self, loop):
        dev = loop.step.device
        if dev.type != "cuda":
            raise ValueError(f"{type(loop).__name__}: CUDA graphs need a "
                             f"CUDA device, not {dev}")
        self.loop = loop
        routes = synapse.route_counts(dev)
        before = routes.clone()
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            loop.body()
            loop.reset()
            routes.copy_(before)
        cur.wait_stream(side)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        counted = dict(kernels.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                loop.body()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        self.launches = {k: v - counted[k]
                         for k, v in kernels.LAUNCHES.items()}
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        LoopGraph.captures += 1

    def replay(self):
        self.graph.replay()
