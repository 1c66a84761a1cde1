"""Scalar-SoA 3-vectors: a Vec3 is a NamedTuple of three same-shaped
f32 arrays.

Why: with one array per component, every op runs on ``(N,)`` (or
``(C, N)``) arrays whose minor dimension is the ray axis, instead of a
padded minor dimension of 3. This is the layout the whole production integrator
uses; the ``(..., 3)`` helpers in ops.geom remain for tests and host
code.

Vec3 is a pytree (NamedTuple), so it passes through jit/scan/while
transparently.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp


class Vec3(NamedTuple):
    x: Any
    y: Any
    z: Any

    # -- construction ------------------------------------------------
    @staticmethod
    def from_array(a):
        """(..., 3) -> Vec3 of (...,) components."""
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def full_like(ref, vx, vy, vz):
        one = jnp.ones_like(ref)
        return Vec3(one * vx, one * vy, one * vz)

    @staticmethod
    def zeros_like(ref):
        z = jnp.zeros_like(ref)
        return Vec3(z, z, z)

    def to_array(self):
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    # -- arithmetic --------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, s):
        if isinstance(s, Vec3):  # Hadamard
            return Vec3(self.x * s.x, self.y * s.y, self.z * s.z)
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __truediv__(self, s):
        if isinstance(s, Vec3):
            return Vec3(self.x / s.x, self.y / s.y, self.z / s.z)
        return Vec3(self.x / s, self.y / s, self.z / s)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


def dot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def norm2(a: Vec3):
    return dot(a, a)


def normalize(a: Vec3, eps: float = 0.0) -> Vec3:
    """Gradient-safe normalize, same clamping policy as geom.normalize."""
    n2 = norm2(a)
    tiny = max(eps * eps, 1e-30)
    n = jnp.sqrt(jnp.where(n2 > tiny, n2, tiny))
    if eps:
        n = jnp.maximum(n, eps)
    inv = 1.0 / n
    return Vec3(a.x * inv, a.y * inv, a.z * inv)


def reflect(d: Vec3, n: Vec3) -> Vec3:
    k = 2.0 * dot(d, n)
    return Vec3(d.x - n.x * k, d.y - n.y * k, d.z - n.z * k)


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        jnp.where(mask, a.x, b.x),
        jnp.where(mask, a.y, b.y),
        jnp.where(mask, a.z, b.z),
    )


def take(table, idx) -> Vec3:
    """Gather rows of an (M, 3) array into a Vec3 of (N,) components
    (three 1-D gathers)."""
    return Vec3(
        jnp.take(table[:, 0], idx),
        jnp.take(table[:, 1], idx),
        jnp.take(table[:, 2], idx),
    )
