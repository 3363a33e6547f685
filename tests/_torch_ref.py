"""Shared pieces of the port's parity tests (tests/test_torch_*.py).

The reference's ``quantizer.auto_scale`` computes its power-of-two scale
with ``jnp.exp2``, which XLA's CPU backend lowers to exp(f · ln 2) and
misses 2^f for most f (2^27 comes out as 134217672).  The port builds
2^f exactly.  :func:`exact_pow2_reference` patches the reference's
``auto_scale`` to the exact power for the duration of a test, so the
parity tests can hold the algorithms bit for bit; callers of the
reference's jitted functions must call their ``__wrapped__`` bodies under
the patch, so no cached trace of the unpatched scale is reused.
"""

import jax
import jax.numpy as jnp
import pytest

from repro.core import quantizer


def _auto_scale_exact(x, bits: int = 32, margin_bits: int = 2):
    absmax = jnp.maximum(jnp.max(jnp.abs(x), axis=0), 1e-30)
    f = jnp.floor((bits - 1 - margin_bits) - jnp.log2(absmax))
    f = jnp.minimum(f, 126.0).astype(jnp.int32)
    return jax.lax.bitcast_convert_type((f + 127) << 23, jnp.float32)


@pytest.fixture
def exact_pow2_reference(monkeypatch):
    monkeypatch.setattr(quantizer, "auto_scale", _auto_scale_exact)
    yield
