"""Ray-primitive intersection, vectorized over (rays × primitives).

Semantics parity notes (citations into the reference's sources):

* Sphere: quadratic solve as in reference elements/sphere.rs:83-105 and
  trace.wgsl:589-615. The two backends of the reference DISAGREE about
  rays starting inside a sphere: the CPU takes the minimum positive
  root, while the WGSL branch structure (`a > 0 && a < b` with a>=b
  always) only ever accepts the *near* root, so an inside ray misses.
  Both behaviors are provided via ``mode`` ('gpu' is the default and is
  what the reference's published renders used).

* Triangle: Möller–Trumbore with the same guards as reference
  triangle/generic.rs:102-137 == trace.wgsl:620-646: reject
  |det| < EPS, u<0 or u>1, v<0 or u+v>1, t < EPS.

* Masked lanes: padded/invalid primitives are passed with valid=False
  and return t=inf.

MISS is represented by t == +inf (the reference WGSL uses MAXF).
"""
from __future__ import annotations

import jax.numpy as jnp

from .geom import dot, cross

EPS = 1e-4  # reference lib.rs:20 / trace.wgsl MIN_INTERSECT
INF = jnp.float32(jnp.inf)


def intersect_spheres(ro, rd, centers, radii, valid=None, mode: str = "gpu"):
    """Batched ray-sphere intersection.

    ro, rd: (..., 3) ray origins/directions.
    centers: (M, 3); radii: (M,); valid: optional (M,) bool.
    Returns t: (..., M) with inf for misses.
    """
    oc = ro[..., None, :] - centers  # (..., M, 3)
    dirv = jnp.sum(rd[..., None, :] * oc, axis=-1)  # (..., M)
    consts = jnp.sum(oc * oc, axis=-1) - radii * radii
    disc = dirv * dirv - consts
    # double-where keeps reverse-mode sqrt finite on miss lanes
    # (sqrt'(0) = inf would otherwise turn 0*inf into NaN gradients)
    sq = jnp.sqrt(jnp.where(disc > 0.0, disc, 1.0))
    near = -dirv - sq
    far = -dirv + sq
    if mode == "gpu":
        # trace.wgsl:597-608: only `b > 0 && b < a` can accept (a>=b always)
        t = jnp.where((disc > 0.0) & (near > 0.0) & (near < far), near, INF)
    else:
        # sphere.rs:93-99: min positive root
        t = jnp.where(
            disc > 0.0,
            jnp.where(near > 0.0, near, jnp.where(far > 0.0, far, INF)),
            INF,
        )
    if valid is not None:
        t = jnp.where(valid, t, INF)
    return t


def intersect_triangles(ro, rd, v0, e1, e2, valid=None):
    """Batched Möller–Trumbore.

    ro, rd: (..., 3). v0: (M, 3) first vertex; e1 = v1-v0, e2 = v2-v0
    precomputed at scene build. Returns (t, u, v): each (..., M).
    """
    pvec = cross(rd[..., None, :], jnp.broadcast_to(e2, rd.shape[:-1] + e2.shape))
    det = jnp.sum(e1 * pvec, axis=-1)
    ok = jnp.abs(det) >= EPS
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    rhs = ro[..., None, :] - v0
    u = inv_det * jnp.sum(rhs * pvec, axis=-1)
    qvec = cross(rhs, jnp.broadcast_to(e1, rhs.shape))
    v = inv_det * jnp.sum(rd[..., None, :] * qvec, axis=-1)
    t = inv_det * jnp.sum(e2 * qvec, axis=-1)
    ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= EPS)
    if valid is not None:
        ok = ok & valid
    t = jnp.where(ok, t, INF)
    return t, u, v


def slab_test(ro, rd, lo, hi):
    """AABB slab entry/exit (reference accel/aabb.rs:25-63).

    ro, rd: (..., 3); lo, hi: (M, 3). Direction components with
    |d| < EPS are clamped to ±EPS like the reference (aabb.rs:33-35).
    Returns (entry_t, exit_t, hit); hit iff NOT (exit < 0 or
    entry > exit), matching aabb.rs:57-61 exactly.
    """
    d = rd[..., None, :]
    d = jnp.where(jnp.abs(d) < EPS, jnp.where(d < 0.0, -EPS, EPS), d)
    inv = 1.0 / d
    t0 = (lo - ro[..., None, :]) * inv
    t1 = (hi - ro[..., None, :]) * inv
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    entry = jnp.max(tmin, axis=-1)
    exit_ = jnp.min(tmax, axis=-1)
    return entry, exit_, (entry <= exit_) & (exit_ >= 0.0)
