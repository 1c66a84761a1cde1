"""Small batched 3-vector helpers used across the numerics core.

Vectors are stored as ``(..., 3)`` float32 arrays (struct-of-arrays at
the call sites; the trailing axis keeps the math readable and XLA fuses
it anyway).
"""
from __future__ import annotations

import jax.numpy as jnp


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def norm(a):
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def normalize(a, eps: float = 0.0):
    """a / |a|, gradient-safe at |a| -> 0.

    Forward is bit-identical to the reference's nalgebra normalize for
    any |a|^2 > 1e-30 (the working range); below that the norm is
    clamped so reverse-mode sqrt does not emit NaN through masked-out
    lanes (0 * NaN = NaN would otherwise poison every gradient). Pass
    eps to additionally clamp the divisor (degenerate-frame guards)."""
    n2 = jnp.sum(a * a, axis=-1)
    tiny = max(eps * eps, 1e-30)
    n = jnp.sqrt(jnp.where(n2 > tiny, n2, tiny))
    if eps:
        n = jnp.maximum(n, eps)
    return a / n[..., None]


def reflect(d, n):
    """Mirror reflection d - 2(d.n)n (reference interaction.rs:7,
    trace.wgsl reflect builtin)."""
    return d - n * (2.0 * dot(d, n))[..., None]
