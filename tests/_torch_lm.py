"""Shared set-up of the LM parity tests (``tests/test_torch_lm_*.py``):
the reference's model and parameters (``init_params(PRNGKey(0))``) for a
reduced arch, carried into the port by ``convert.params``, and seeded
numpy inputs. Imports JAX (the reference is the oracle); not collected by
pytest (no ``test_`` prefix)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config import get_arch as ref_arch
from repro.models import transformer as RT
from repro.parallel.sharding import ShardingCtx as RefCtx
from repro.parallel.sharding import init_params as ref_init
from repro_torch import convert
from repro_torch.config import get_arch as port_arch
from repro_torch.models import transformer as PT
from repro_torch.parallel.sharding import ShardingCtx

TOL = dict(rtol=1e-4, atol=1e-4)     # the house tolerance, docs/exactness.md


@functools.lru_cache(maxsize=None)
def setup(name):
    """(ref arch, ref bundle, ref params, port arch, port bundle, port
    params on the CPU) of the reduced ``name``."""
    ra = ref_arch(name).reduced()
    rb = RT.build_model(ra, RefCtx())
    rp = ref_init(rb.decls, jax.random.PRNGKey(0))
    pa = port_arch(name).reduced()
    pb = PT.build_model(pa, ShardingCtx())
    pp = convert.params(jax.tree.map(np.asarray, rp), "cpu")
    return ra, rb, rp, pa, pb, pp


def batch(arch, s, seed=1, b=2):
    """Numpy model inputs of ``s`` tokens (frames for the encoder, patch
    embeddings beside the tokens for the VLM)."""
    rng = np.random.default_rng(seed)
    if arch.family == "audio":
        return dict(frames=rng.standard_normal(
            (b, s, arch.frame_dim)).astype(np.float32))
    out = dict(tokens=rng.integers(0, arch.vocab, (b, s)).astype(np.int32))
    if arch.vit_dim:
        out["patch_embeds"] = rng.standard_normal(
            (b, arch.n_patches, arch.vit_dim)).astype(np.float32)
    return out


def ref_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def port_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_tree_close(ref, port, what, **tol):
    """Every leaf of two trees of equal structure within ``tol``."""
    tol = tol or TOL
    if isinstance(ref, dict):
        assert set(ref) == set(port), (what, set(ref), set(port))
        for k in ref:
            assert_tree_close(ref[k], port[k], f"{what}/{k}", **tol)
        return
    r, p = to_np(ref), to_np(port)
    assert r.shape == p.shape, (what, r.shape, p.shape)
    np.testing.assert_allclose(p, r, err_msg=what, **tol)


def grow_ref(cache, total, max_len):
    """The reference's decode cache grown to ``max_len`` the way its
    engine grows it (``repro/serve/engine.py:78-79``), valid where no SSM
    state has ``total`` heads."""
    def grow(x):
        if x.ndim == 4 and x.shape[1] == total:
            return jnp.pad(x, ((0, 0), (0, max_len - total), (0, 0), (0, 0)))
        return x
    return jax.tree.map(grow, cache)
