"""Shared pieces of the port's parity tests (tests/test_torch_*.py).

The reference's ``quantizer.auto_scale`` computes its power-of-two scale
with ``jnp.exp2``, which XLA's CPU backend lowers to exp(f · ln 2) and
misses 2^f for most f (2^27 comes out as 134217672).  The port builds
2^f exactly.  :func:`exact_pow2_reference` patches the reference's
``auto_scale`` to the exact power for the duration of a test, so the
parity tests can hold the algorithms bit for bit; callers of the
reference's jitted functions must call their ``__wrapped__`` bodies under
the patch, so no cached trace of the unpatched scale is reused.

Importing this module (most port test modules do, and every worker of a
run imports them all while it collects) also sets two things for the
worker process:

* JAX's persistent compilation cache, in one directory under the system
  temp dir shared by the workers of a run (and by later runs): much of the
  test time is the reference compiling the same small jits again in every
  file and worker.  Entries are keyed by the computation, the JAX version
  and the backend, so a hit runs the executable the compiler would have
  built; a torn read (another worker writing the entry) is a cache miss,
  not an error.
* one intra-op thread for torch: the suite runs 6 workers on 8 cores, and
  torch's thread pool thrashes under that load (the TINY Trainer test of
  tests/test_torch_optim.py took 17 s alone and 300 s with six copies at
  once at torch's default threads, 29 s at one thread).
"""

import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import quantizer
from repro.models import transformer as _tfm

JAX_CACHE_DIR = os.path.join(tempfile.gettempdir(),
                             "repro_torch_tests_jax_cache")
jax.config.update("jax_compilation_cache_dir", JAX_CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
torch.set_num_threads(1)


def _auto_scale_exact(x, bits: int = 32, margin_bits: int = 2):
    absmax = jnp.maximum(jnp.max(jnp.abs(x), axis=0), 1e-30)
    f = jnp.floor((bits - 1 - margin_bits) - jnp.log2(absmax))
    f = jnp.minimum(f, 126.0).astype(jnp.int32)
    return jax.lax.bitcast_convert_type((f + 127) << 23, jnp.float32)


@pytest.fixture
def exact_pow2_reference(monkeypatch):
    monkeypatch.setattr(quantizer, "auto_scale", _auto_scale_exact)
    yield


@functools.lru_cache(maxsize=None)
def _init_params_jit(cfg):
    return jax.jit(functools.partial(_tfm.init_params, cfg=cfg))


def ref_init_params(cfg, seed: int = 0):
    """The reference's ``init_params(PRNGKey(seed), cfg)`` through one
    jit a config (bit-identical to the eager call, which dispatches every
    draw on its own and takes seconds on a reduced MoE model; the jit's
    executable comes from the shared compilation cache after its first
    compile in a run)."""
    return _init_params_jit(cfg)(jax.random.PRNGKey(seed))
