"""Mesh nearest-hit kernel over the cluster tables, compiled through
Triton for the GPU.

Each program takes BLOCK rays and walks every cluster of the scene's
cluster tables (models/scene.py: cl_lo/cl_hi AABBs, cl_v0/cl_e1/cl_e2
triangles, cl_idx global ids, -1 padded) in table order:

  * a slab test of every ray of the block against the cluster AABB
    (aabb.rs:25-63); when no ray reaches the cluster ahead of its
    current best hit, the whole cluster is skipped;
  * otherwise Möller–Trumbore (generic.rs:102-137 == trace.wgsl:620-646)
    against the cluster's W triangles, keeping a running minimum
    (t, id, u, v) in registers.

The XLA formulation of the same walk (integrator._mesh_hit_clusters) is
a fori_loop over clusters with a lax.cond per cluster per ray tile —
thousands of tiny dispatches per bounce at 10^5 triangles; here the
skip is a branch inside one kernel.

Semantics match _mesh_hit_clusters: same cluster order and a strict
`<` update, so ties resolve to the earliest triangle in cluster-table
order; rays come seeded with the sphere/free-triangle best `t_seed`
(dead lanes with -INF, which no cluster can beat, so they only pay the
slab tests). Returns (t, id, u, v) with id == -1 where no mesh
triangle beat the seed.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..intersect import EPS

# rays and warps per program: a small block skips more clusters (one
# cull decision per block); 32/1 measured ahead of 64/2, 128/4 and
# 256/8 on an H100 (PERF.md)
BLOCK = 32
NUM_WARPS = 1


def _kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, seed_ref,
            lo_ref, hi_ref, v0_ref, e1_ref, e2_ref, idx_ref,
            t_out, i_out, u_out, v_out,
            *, n_clusters: int, width: int, t_min: float):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]

    # slab direction clamp (aabb.rs:33-35), as in _mesh_hit_clusters
    def inv(d):
        return 1.0 / jnp.where(jnp.abs(d) < EPS, jnp.where(d < 0.0, -EPS, EPS), d)

    fx, fy, fz = inv(dx), inv(dy), inv(dz)

    def cluster_body(c, best):
        bt = best[0]
        t0x, t1x = (lo_ref[c, 0] - ox) * fx, (hi_ref[c, 0] - ox) * fx
        t0y, t1y = (lo_ref[c, 1] - oy) * fy, (hi_ref[c, 1] - oy) * fy
        t0z, t1z = (lo_ref[c, 2] - oz) * fz, (hi_ref[c, 2] - oz) * fz
        entry = jnp.maximum(
            jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
            jnp.minimum(t0z, t1z),
        )
        exit_ = jnp.minimum(
            jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
            jnp.maximum(t0z, t1z),
        )
        reach = (entry <= exit_) & (exit_ >= 0.0) & (entry < bt)

        def tri_body(w, best):
            bt, bi, bu, bv = best
            e1x, e1y, e1z = e1_ref[c, w, 0], e1_ref[c, w, 1], e1_ref[c, w, 2]
            e2x, e2y, e2z = e2_ref[c, w, 0], e2_ref[c, w, 1], e2_ref[c, w, 2]
            # Möller–Trumbore in integrator._triangle_t's operation order
            pvx = dy * e2z - dz * e2y
            pvy = dz * e2x - dx * e2z
            pvz = dx * e2y - dy * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            ok = jnp.abs(det) >= EPS
            inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
            hx = ox - v0_ref[c, w, 0]
            hy = oy - v0_ref[c, w, 1]
            hz = oz - v0_ref[c, w, 2]
            u = inv_det * (hx * pvx + hy * pvy + hz * pvz)
            qx = hy * e1z - hz * e1y
            qy = hz * e1x - hx * e1z
            qz = hx * e1y - hy * e1x
            v = inv_det * (dx * qx + dy * qy + dz * qz)
            t = inv_det * (e2x * qx + e2y * qy + e2z * qz)
            gid = idx_ref[c, w]
            ok = (ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
                  & (t >= t_min) & (gid >= 0))
            better = ok & (t < bt)
            return (
                jnp.where(better, t, bt),
                jnp.where(better, gid, bi),
                jnp.where(better, u, bu),
                jnp.where(better, v, bv),
            )

        return jax.lax.cond(
            jnp.max(reach.astype(jnp.int32)) > 0,
            lambda b: jax.lax.fori_loop(0, width, tri_body, b),
            lambda b: b,
            best,
        )

    init = (
        seed_ref[...],
        jnp.full(ox.shape, -1, jnp.int32),
        jnp.zeros_like(ox),
        jnp.zeros_like(ox),
    )
    bt, bi, bu, bv = jax.lax.fori_loop(0, n_clusters, cluster_body, init)
    t_out[...] = bt
    i_out[...] = bi
    u_out[...] = bu
    v_out[...] = bv


@functools.partial(jax.jit, static_argnames=("t_min", "interpret"))
def mesh_hit(ox, oy, oz, dx, dy, dz, t_seed, cl_lo, cl_hi, cl_v0, cl_e1,
             cl_e2, cl_idx, t_min: float = EPS, interpret: bool = False):
    """Nearest mesh hit for (N,) rays against the (C, ...) cluster
    tables. t_min: smallest accepted t (EPS, or the cpu-semantics
    20*EPS guard). Rays are padded to a multiple of BLOCK with -INF
    seeds. Returns (t, id, u, v), each (N,)."""
    n = ox.shape[0]
    n_pad = -(-n // BLOCK) * BLOCK
    rays = [ox, oy, oz, dx, dy, dz]
    seed = t_seed
    if n_pad != n:
        pad = lambda a, fill: jnp.concatenate([a, jnp.full((n_pad - n,), fill, a.dtype)])
        rays = [pad(a, 1.0) for a in rays]
        seed = pad(t_seed, -jnp.inf)
    n_clusters, width = cl_idx.shape
    lane = pl.BlockSpec((BLOCK,), lambda i: (i,))
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)
    tables = [cl_lo, cl_hi, cl_v0, cl_e1, cl_e2, cl_idx]
    out = pl.pallas_call(
        functools.partial(_kernel, n_clusters=n_clusters, width=width, t_min=t_min),
        grid=(n_pad // BLOCK,),
        in_specs=[lane] * 7 + [whole(a) for a in tables],
        out_specs=[lane] * 4,
        out_shape=[
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
            jax.ShapeDtypeStruct((n_pad,), jnp.int32),
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="mesh_hit",
    )(*rays, seed, *tables)
    return tuple(o[:n] for o in out)
