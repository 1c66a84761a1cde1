"""Monte-Carlo path integrator: vectorized iterative bounce loop.

This is the vectorized formulation of the reference's radiance
computation. The loop shape follows the reference GPU kernel
(trace.wgsl:282-315): every ray lane carries throughput
(`colour_intensity`), a dielectric weight (`intensity`), an RNG stream
and an active mask; each iteration does closest-hit over ALL primitives
(brute force, exactly like the reference GPU backend), shades by
material kind with masked selects, and applies Russian roulette.

Layout: everything is scalar-SoA (ops.vec.Vec3 = three (N,) arrays,
primitive chunks broadcast as (C, N) with the RAY axis minor), so
every elementwise op runs over the ray axis instead of a padded
minor dimension of 3.

Two semantics modes, because the reference's CPU and GPU backends
genuinely diverge (documented in SURVEY.md §7.3):

* mode='gpu' (default; what the reference's published renders used):
  - emissive hits add E*T*I and multiply throughput by colour twice
    (trace.wgsl:294-303);
  - RR: after assured_depth, terminate when u > max_thres; on
    termination throughput/max_thres is ADDED to the radiance
    (trace.wgsl:306-310);
  - sphere intersection only accepts the near root (inside rays miss);
  - dielectric weight: 1 on reflect, (1-re) on transmit, folded into
    `intensity` (and the Schlick cos term makes entering rays always
    reflect — see tests/test_ops.py::test_refract_entry_semantics);
  - free-triangle emissive honored; no direct-light sampling.

* mode='cpu' (reference CPU backend, radiance.rs:20-120):
  - L += T*emissive at every hit; skybox terminates; triangle emissive
    zeroed (generic.rs:85-86);
  - RR: after assured_depth, survive w.p. 0.4 (hardcoded,
    radiance.rs:77) and divide the bounce rgb by 0.4;
  - sphere takes min positive root; closest-hit guard t >= 20*EPS
    (closest_hit.rs:16);
  - dielectric reflect weight re folded into rgb.

Per-bounce the integrator draws a fixed budget of 8 uniforms per lane
(u0 lobe-choice, u1/u2 diffuse, u3 fresnel, u4-u6 PBR scatter, u7 RR) —
stream parity with the reference is impossible anyway (draw consumption
is data-dependent per thread there), so draws are lane-uniform for
vectorization and reproducibility.
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import rng
from ..ops import vec as v3
from ..ops.vec import Vec3
from ..ops.intersect import EPS, INF
from ..utils.pytree import pytree_dataclass, static_field

KIND_NONE, KIND_SPHERE, KIND_FREETRI, KIND_MESHTRI = 0, 1, 2, 3

CPU_RR_THRES = 0.4  # radiance.rs:77 hardcoded
DLS_NORMZE = 1.0 / (30.0 * jnp.pi)  # radiance.rs:90


MESH_HITS = ("clusters", "brute", "triton")


@pytree_dataclass
class IntegratorParams:
    max_thres: Any = 0.5
    assured_depth: int = static_field(5)
    max_bounces: int = static_field(24)
    mode: str = static_field("gpu")
    debug_single_ray: bool = static_field(False)
    dir_light_samp: bool = static_field(False)
    mesh_chunk: int = static_field(2048)
    differentiable: bool = static_field(False)
    # mesh nearest-hit implementation (render/policy.py picks it):
    #   "clusters" — XLA cluster cull: tiles of `ray_tile` rays skip
    #                whole clusters whose AABB no ray of the tile
    #                reaches (_mesh_hit_clusters);
    #   "brute"    — XLA chunked scan over every triangle;
    #   "triton"   — the cluster walk as one GPU kernel
    #                (ops/pallas/hit_kernel.py; forward only).
    mesh_hit: str = static_field("clusters")
    ray_tile: int = static_field(8192)
    # run Pallas kernels in interpret mode (CPU tests only)
    interpret: bool = static_field(False)


# ---------------------------------------------------------------------------
# closest hit — primitives broadcast (C, 1) against rays (N,) -> (C, N)


def _cols(table):
    """(M, 3) host array -> Vec3 of (M, 1) column vectors for
    broadcasting against (N,) ray components."""
    return Vec3(table[:, 0:1], table[:, 1:2], table[:, 2:3])


def _sphere_t(ro: Vec3, rd: Vec3, c: Vec3, r, valid, mode: str):
    """Quadratic solve (sphere.rs:83-105 == trace.wgsl:589-615) over
    (C, N). c components are (C, 1); r/valid are (C, 1)."""
    oc = Vec3(ro.x - c.x, ro.y - c.y, ro.z - c.z)
    dirv = v3.dot(rd, oc)
    consts = v3.norm2(oc) - r * r
    disc = dirv * dirv - consts
    sq = jnp.sqrt(jnp.where(disc > 0.0, disc, 1.0))  # grad-safe
    near = -dirv - sq
    far = -dirv + sq
    if mode == "gpu":
        # trace.wgsl:597-608: only the near root can ever be accepted
        t = jnp.where((disc > 0.0) & (near > 0.0) & (near < far), near, INF)
    else:
        # sphere.rs:93-99: min positive root
        t = jnp.where(
            disc > 0.0,
            jnp.where(near > 0.0, near, jnp.where(far > 0.0, far, INF)),
            INF,
        )
    return jnp.where(valid, t, INF)


def _triangle_t(ro: Vec3, rd: Vec3, p0: Vec3, e1: Vec3, e2: Vec3, valid):
    """Möller–Trumbore (generic.rs:102-137 == trace.wgsl:620-646) over
    (C, N). Triangle components are (C, 1)."""
    pvec = v3.cross(rd, e2)
    det = v3.dot(e1, pvec)
    ok = jnp.abs(det) >= EPS
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    rhs = Vec3(ro.x - p0.x, ro.y - p0.y, ro.z - p0.z)
    u = inv_det * v3.dot(rhs, pvec)
    qvec = v3.cross(rhs, e1)
    w = inv_det * v3.dot(rd, qvec)
    t = inv_det * v3.dot(e2, qvec)
    ok = ok & (u >= 0.0) & (u <= 1.0) & (w >= 0.0) & (u + w <= 1.0) & (t >= EPS)
    ok = ok & valid
    return jnp.where(ok, t, INF), u, w


def _mesh_hit_clusters(scene, params, ro: Vec3, rd: Vec3, t_seed):
    """Cluster-culled mesh intersection (the XLA replacement for the
    KD traversal the reference left stubbed on GPU, trace.wgsl:664-667):
    rays are processed in coherent tiles; for each cluster, a cheap
    slab test against the cluster AABB decides (lax.cond) whether the
    tile runs the (W, T) Möller–Trumbore block at all, and the entry-t
    is pruned against the tile's current best. t_seed carries the
    sphere/free-tri best so occluded clusters prune too.

    Returns (t, idx, u, v) with idx == -1 where no mesh triangle beat
    t_seed."""
    n = ro.x.shape[0]
    T = params.ray_tile if n % params.ray_tile == 0 else n
    n_tiles = n // T
    C = scene.n_clusters
    guard = 20.0 * EPS if params.mode == "cpu" else None

    def one_tile(args):
        ro_t, rd_t, seed_t = args

        def cluster_body(c, best):
            bt, bi, bu_, bv_ = best
            lo = jax.lax.dynamic_index_in_dim(scene.cl_lo, c, 0, keepdims=False)
            hi = jax.lax.dynamic_index_in_dim(scene.cl_hi, c, 0, keepdims=False)
            # slab entry/exit (aabb.rs:25-63)
            entry = jnp.full_like(bt, -INF)
            exit_ = jnp.full_like(bt, INF)
            for axis, (o_a, d_a) in enumerate(
                [(ro_t.x, rd_t.x), (ro_t.y, rd_t.y), (ro_t.z, rd_t.z)]
            ):
                d_c = jnp.where(jnp.abs(d_a) < EPS, jnp.where(d_a < 0.0, -EPS, EPS), d_a)
                f = 1.0 / d_c
                t0 = (lo[axis] - o_a) * f
                t1 = (hi[axis] - o_a) * f
                entry = jnp.maximum(entry, jnp.minimum(t0, t1))
                exit_ = jnp.minimum(exit_, jnp.maximum(t0, t1))
            reach = (entry <= exit_) & (exit_ >= 0.0) & (entry < bt)
            any_reach = jnp.any(reach)

            def test(best):
                bt, bi, bu_, bv_ = best
                v0c = jax.lax.dynamic_index_in_dim(scene.cl_v0, c, 0, keepdims=False)
                e1c = jax.lax.dynamic_index_in_dim(scene.cl_e1, c, 0, keepdims=False)
                e2c = jax.lax.dynamic_index_in_dim(scene.cl_e2, c, 0, keepdims=False)
                ids = jax.lax.dynamic_index_in_dim(scene.cl_idx, c, 0, keepdims=False)
                ts, us, ws = _triangle_t(
                    ro_t, rd_t, _cols(v0c), _cols(e1c), _cols(e2c), (ids >= 0)[:, None]
                )
                if guard is not None:
                    ts = jnp.where(ts >= guard, ts, INF)
                tmin = jnp.min(ts, axis=0)
                aw = jnp.argmin(ts, axis=0).astype(jnp.int32)
                g = lambda a: jnp.take_along_axis(a, aw[None, :], axis=0)[0]
                better = tmin < bt
                return (
                    jnp.where(better, tmin, bt),
                    jnp.where(better, jnp.take(ids, aw), bi),
                    jnp.where(better, g(us), bu_),
                    jnp.where(better, g(ws), bv_),
                )

            return jax.lax.cond(any_reach, test, lambda b: b, (bt, bi, bu_, bv_))

        init = (
            seed_t,
            jnp.full((T,), -1, jnp.int32),
            jnp.zeros((T,)),
            jnp.zeros((T,)),
        )
        return jax.lax.fori_loop(0, C, cluster_body, init)

    if n_tiles == 1:
        return one_tile((ro, rd, t_seed))

    resh = lambda a: a.reshape(n_tiles, T)
    ros = Vec3(resh(ro.x), resh(ro.y), resh(ro.z))
    rds = Vec3(resh(rd.x), resh(rd.y), resh(rd.z))

    def scan_body(_, tile_args):
        return None, one_tile(tile_args)

    _, (tt, ti, tu, tv) = jax.lax.scan(scan_body, None, (ros, rds, resh(t_seed)))
    return tt.reshape(n), ti.reshape(n), tu.reshape(n), tv.reshape(n)


def closest_hit(scene, params, ro: Vec3, rd: Vec3, active=None):
    """Brute-force nearest hit over spheres, free triangles, mesh
    triangles, in the reference GPU's evaluation order
    (trace.wgsl:389-444). All returns are (N,). `active` (optional
    bool mask): dead lanes are seeded with -INF so the culled mesh
    paths skip their (stale) rays entirely — the bounce loop iterates
    until ALL lanes die, and without this the dead majority keeps
    re-testing the mesh every iteration."""
    n = ro.x.shape[0]
    t_best = jnp.full((n,), INF)
    kind = jnp.zeros((n,), jnp.int32)
    idx = jnp.zeros((n,), jnp.int32)
    bu = jnp.zeros((n,))
    bv = jnp.zeros((n,))

    guard = 20.0 * EPS if params.mode == "cpu" else None

    def apply_guard(t):
        # CPU-backend immediate-collision filter (closest_hit.rs:16)
        return t if guard is None else jnp.where(t >= guard, t, INF)

    if scene.n_spheres:
        ts = _sphere_t(
            ro, rd,
            _cols(scene.sph_c), scene.sph_r[:, None],
            scene.sph_valid[:, None], params.mode,
        )
        ts = apply_guard(ts)
        tmin = jnp.min(ts, axis=0)
        amin = jnp.argmin(ts, axis=0).astype(jnp.int32)
        better = tmin < t_best
        t_best = jnp.where(better, tmin, t_best)
        kind = jnp.where(better, KIND_SPHERE, kind)
        idx = jnp.where(better, amin, idx)

    if scene.n_free_tris:
        ts, us, ws = _triangle_t(
            ro, rd,
            _cols(scene.ft_v0), _cols(scene.ft_e1), _cols(scene.ft_e2),
            scene.ft_valid[:, None],
        )
        ts = apply_guard(ts)
        tmin = jnp.min(ts, axis=0)
        amin = jnp.argmin(ts, axis=0).astype(jnp.int32)
        g = lambda a: jnp.take_along_axis(a, amin[None, :], axis=0)[0]
        better = tmin < t_best
        t_best = jnp.where(better, tmin, t_best)
        kind = jnp.where(better, KIND_FREETRI, kind)
        idx = jnp.where(better, amin, idx)
        bu = jnp.where(better, g(us), bu)
        bv = jnp.where(better, g(ws), bv)

    m = scene.mt_v0.shape[0]
    if m and scene.n_clusters and params.mesh_hit != "brute":
        t_seed = t_best if active is None else jnp.where(active, t_best, -INF)
        if params.mesh_hit == "triton":
            from ..ops.pallas.hit_kernel import mesh_hit

            mt_t, mt_i, mt_u, mt_v = mesh_hit(
                ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, t_seed,
                scene.cl_lo, scene.cl_hi, scene.cl_v0, scene.cl_e1,
                scene.cl_e2, scene.cl_idx,
                t_min=EPS if guard is None else guard,
                interpret=params.interpret,
            )
        else:
            mt_t, mt_i, mt_u, mt_v = _mesh_hit_clusters(scene, params, ro, rd, t_seed)
        mesh_won = mt_i >= 0
        t_best = jnp.where(mesh_won, mt_t, t_best)
        kind = jnp.where(mesh_won, KIND_MESHTRI, kind)
        idx = jnp.where(mesh_won, mt_i, idx)
        bu = jnp.where(mesh_won, mt_u, bu)
        bv = jnp.where(mesh_won, mt_v, bv)
        return t_best, kind, idx, bu, bv

    if m:
        chunk = min(params.mesh_chunk, m)
        if m % chunk:
            raise ValueError(f"mesh tris {m} not a multiple of chunk {chunk}")
        n_chunks = m // chunk

        def one_chunk(v0c, e1c, e2c, valc):
            ts, us, ws = _triangle_t(
                ro, rd, _cols(v0c), _cols(e1c), _cols(e2c), valc[:, None]
            )
            ts = apply_guard(ts)
            tmin = jnp.min(ts, axis=0)
            amin = jnp.argmin(ts, axis=0).astype(jnp.int32)
            g = lambda a: jnp.take_along_axis(a, amin[None, :], axis=0)[0]
            return tmin, amin, g(us), g(ws)

        if n_chunks == 1:
            mt_t, mt_i, mt_u, mt_v = one_chunk(
                scene.mt_v0, scene.mt_e1, scene.mt_e2, scene.mt_valid
            )
        else:
            cv0 = scene.mt_v0.reshape(n_chunks, chunk, 3)
            ce1 = scene.mt_e1.reshape(n_chunks, chunk, 3)
            ce2 = scene.mt_e2.reshape(n_chunks, chunk, 3)
            cval = scene.mt_valid.reshape(n_chunks, chunk)
            bases = jnp.arange(n_chunks, dtype=jnp.int32) * chunk

            def body(carry, chunk_data):
                tb, mi, mu, mv = carry
                v0c, e1c, e2c, valc, base = chunk_data
                tmin, amin, uu, ww = one_chunk(v0c, e1c, e2c, valc)
                better = tmin < tb
                return (
                    jnp.where(better, tmin, tb),
                    jnp.where(better, base + amin, mi),
                    jnp.where(better, uu, mu),
                    jnp.where(better, ww, mv),
                ), None

            init = (jnp.full((n,), INF), jnp.zeros((n,), jnp.int32), bu * 0, bv * 0)
            (mt_t, mt_i, mt_u, mt_v), _ = jax.lax.scan(
                body, init, (cv0, ce1, ce2, cval, bases)
            )
        better = mt_t < t_best
        t_best = jnp.where(better, mt_t, t_best)
        kind = jnp.where(better, KIND_MESHTRI, kind)
        idx = jnp.where(better, mt_i, idx)
        bu = jnp.where(better, mt_u, bu)
        bv = jnp.where(better, mt_v, bv)

    return t_best, kind, idx, bu, bv


# ---------------------------------------------------------------------------
# shading (scalar-SoA BSDF math; formulas cited in ops.bsdf)


def _tk(table, idx):
    return jnp.take(table, idx)


def _diff_dir(d: Vec3, n: Vec3, u, w) -> Vec3:
    """Cosine-weighted hemisphere from two uniforms
    (interaction.rs:11-27 == trace.wgsl:524-540).

    The reference renormalizes yd and the final combination; with unit
    d/n those are unit by construction (yd = n x xd of orthonormal
    vectors; |comb|^2 = r^2 cos^2 + r^2 sin^2 + (1-u) = 1), so the two
    normalizes are algebraically redundant and dropped — identical
    distribution, ~20 fewer vector ops/bounce. Kept bit-identical with the
    Pallas kernels (uniform_bsdf)."""
    xd = v3.normalize(d - n * v3.dot(d, n), eps=1e-20)
    yd = v3.cross(n, xd)
    r = jnp.sqrt(u)
    thet = (2.0 * jnp.pi) * w
    z = jnp.sqrt(jnp.maximum(1.0 - u, 0.0))
    return xd * (r * jnp.cos(thet)) + yd * (r * jnp.sin(thet)) + n * z


def _refract_dir(d: Vec3, n: Vec3, n_out, n_in, u, mode: str):
    """Dielectric (interaction.rs:29-60 == trace.wgsl:543-579); see
    ops.bsdf.sample_refract for the mode-dependent Schlick parity
    notes. Returns (new_d, weight)."""
    c = v3.dot(n, d)
    into = c < 0.0
    n1 = jnp.where(into, n_out, n_in)
    n2 = jnp.where(into, n_in, n_out)
    c1 = jnp.abs(c)
    nr = v3.where(into, n, -n)
    n_over = n1 / n2
    c22 = 1.0 - n_over * n_over * (1.0 - c1 * c1)
    tir = c22 < 0.0
    # reflect(unit, unit) and the Snell transmission (|t|^2 =
    # n_over^2 (1-c1^2) + c22 = 1; TIR arm is d) are unit by
    # construction — renormalizes dropped (mirrored in the kernels)
    refl_d = v3.reflect(d, nr)
    sq_c22 = jnp.sqrt(jnp.where(c22 > 0.0, c22, 1.0))  # grad-safe at TIR
    trns = d * n_over + nr * (n_over * c1 - sq_c22)
    trns = v3.where(tir, d, trns)
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    if mode == "gpu":
        cos_term = 1.0 - v3.dot(trns, n)
    else:
        cos_term = 1.0 - jnp.where(into, c1, v3.dot(trns, n))
    re = r0 + (1.0 + r0) * cos_term**5
    do_refl = tir | (u < re)
    new_d = v3.where(do_refl, refl_d, trns)
    w_refl = jnp.float32(1.0) if mode == "gpu" else jnp.where(tir, 1.0, re)
    return new_d, jnp.where(do_refl, w_refl, 1.0 - re)


def _interp_uv_soa(uv012, mi, bu, bv):
    """Barycentric UV interpolation (mesh/triangle.rs:228-237):
    uv012 (M, 3, 2) gathered at mi with weights (1-bu-bv, bu, bv)."""
    b0 = 1.0 - bu - bv
    u = b0 * _tk(uv012[:, 0, 0], mi) + bu * _tk(uv012[:, 1, 0], mi) + bv * _tk(uv012[:, 2, 0], mi)
    w = b0 * _tk(uv012[:, 0, 1], mi) + bu * _tk(uv012[:, 1, 1], mi) + bv * _tk(uv012[:, 2, 1], mi)
    return u, w


def _sample_tex_soa(tex_pool, tex_desc, mi, u, w) -> Vec3:
    """Nearest-neighbor fetch (uv_image.rs:10-23): tex_desc (M, 3) =
    [offset, width, height] gathered per lane."""
    off = _tk(tex_desc[:, 0], mi)
    wid = _tk(tex_desc[:, 1], mi)
    hei = _tk(tex_desc[:, 2], mi)
    wf = wid.astype(jnp.float32)
    hf = hei.astype(jnp.float32)
    px = jnp.clip(u * wf, 0.0, jnp.maximum(wf - 1.0, 0.0)).astype(jnp.int32)
    py = jnp.clip(w * hf, 0.0, jnp.maximum(hf - 1.0, 0.0)).astype(jnp.int32)
    ok = wid > 0
    base3 = jnp.where(ok, off + 3 * (px + py * wid), 0)
    rgb = _fetch_rgb(tex_pool, base3)
    zero = jnp.float32(0.0)
    return Vec3(
        jnp.where(ok, rgb.x, zero), jnp.where(ok, rgb.y, zero), jnp.where(ok, rgb.z, zero)
    )


def _sel6(table, face):
    """table[face] for a 6-row scene-constant table via a 5-select
    chain of broadcast selects instead of a per-lane gather."""
    out = jnp.broadcast_to(table[0], face.shape)
    for i in range(1, 6):
        out = jnp.where(face == i, table[i], out)
    return out


def _fetch_rgb(tex_pool, base3) -> Vec3:
    """ONE gather of a 3-texel slice per lane instead of three element
    gathers. The operand stays FLAT 1-D and the slice rides
    lax.gather's slice_sizes. base3: flat offset of the R texel.
    Integer (u8/u16) pools convert to f32 AFTER the gather —
    bit-identical values, 4x/2x fewer HBM bytes per random fetch
    (models/scene.pool_texels_to_f32)."""
    from ..models.scene import pool_texels_to_f32

    if tex_pool.dtype == jnp.uint32:
        # packed pool (all-8-bit sources): ONE u32 word per texel
        # (R | G<<8 | B<<16): one random fetch per texel. base3 is
        # always off + 3k with off a pool byte-offset divisible by 3,
        # so the texel index is exactly base3 // 3; the byte unpack +
        # /255 matches the u8 path bitwise.
        w = jnp.take(tex_pool, base3 // 3, mode="clip")
        r = (w & jnp.uint32(0xFF)).astype(jnp.float32) / np.float32(255.0)
        g = ((w >> jnp.uint32(8)) & jnp.uint32(0xFF)).astype(jnp.float32) / np.float32(255.0)
        b = ((w >> jnp.uint32(16)) & jnp.uint32(0xFF)).astype(jnp.float32) / np.float32(255.0)
        return Vec3(r, g, b)

    rgb = jax.lax.gather(
        tex_pool,
        base3[..., None],
        jax.lax.GatherDimensionNumbers(
            offset_dims=(base3.ndim,),
            collapsed_slice_dims=(),
            start_index_map=(0,),
        ),
        slice_sizes=(3,),
        mode=jax.lax.GatherScatterMode.CLIP,
    )
    rgb = pool_texels_to_f32(rgb)
    return Vec3(rgb[..., 0], rgb[..., 1], rgb[..., 2])


def sample_cubemap(scene, rd: Vec3) -> Vec3:
    """Distant cube map (distant_cube_map.rs:28-76 ==
    trace.wgsl:1199-1249): dominant-axis face select (WGSL >= tie
    order), uv scale/remap, nearest fetch from the texel pool."""
    d = v3.normalize(rd)
    ax, ay, az = jnp.abs(d.x), jnp.abs(d.y), jnp.abs(d.z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = ~is_x & (ay >= ax) & (ay >= az)
    face = jnp.where(
        is_x,
        jnp.where(d.x < 0.0, 2, 3),
        jnp.where(is_y, jnp.where(d.y < 0.0, 4, 5), jnp.where(d.z < 0.0, 0, 1)),
    )
    u = jnp.where(is_x, d.z, d.x)
    w = jnp.where(is_x, d.y, jnp.where(is_y, d.z, d.y))
    fact = jnp.where(is_x, d.x, jnp.where(is_y, d.y, d.z))
    us = _sel6(scene.cm_uv_scales[:, 0], face)
    vs = _sel6(scene.cm_uv_scales[:, 1], face)
    su = 0.5 * (u * us / fact) + 0.5
    sv = 0.5 * (w * vs / fact) + 0.5
    off = _sel6(scene.cm_offsets, face)
    wid = _sel6(scene.cm_dims[:, 0], face)
    hei = _sel6(scene.cm_dims[:, 1], face)
    wf = wid.astype(jnp.float32)
    hf = hei.astype(jnp.float32)
    px = jnp.clip(su * wf, 0.0, jnp.maximum(wf - 1.0, 0.0)).astype(jnp.int32)
    py = jnp.clip(sv * hf, 0.0, jnp.maximum(hf - 1.0, 0.0)).astype(jnp.int32)
    ok = wid > 0
    base3 = jnp.where(ok, off + 3 * (px + py * wid), 0)
    rgb = _fetch_rgb(scene.sky_pool, base3)
    z = jnp.float32(0.0)
    return Vec3(
        jnp.where(ok, rgb.x, z), jnp.where(ok, rgb.y, z), jnp.where(ok, rgb.z, z)
    )


def mesh_attrs_dense(scene, mi, bu, bv):
    """Mesh-triangle shading attributes for every lane: shading normal
    (normal-mapped when present), surface rgb (factor x base texel),
    metal, rough. mi: (T,) clipped triangle ids; bu/bv barycentrics.
    Formula parity: mesh/triangle.rs:136-207 == trace.wgsl:906-1123.
    Returns an 8-tuple of (T,) arrays (nx, ny, nz, rr, rg, rb, metal,
    rough)."""
    attr = jnp.take(scene.mt_attr, mi, axis=0)  # (T, 48)
    a = lambda j: attr[:, j]
    mt_const_norm = Vec3(a(0), a(1), a(2))
    if scene.any_textured:
        # descriptors ride bitcast in attr cols 38:47 (see
        # models/scene.py) — saves the second row gather
        desc = jax.lax.bitcast_convert_type(attr[:, 38:47], jnp.int32)
        b0 = 1.0 - bu - bv

        def interp(base):
            # barycentric uv (mesh/triangle.rs:228-237)
            uu = b0 * a(base) + bu * a(base + 2) + bv * a(base + 4)
            vv = b0 * a(base + 1) + bu * a(base + 3) + bv * a(base + 5)
            return uu, vv

        def fetch(d0, uu, vv):
            # nearest-neighbor texel fetch (uv_image.rs:10-23) from
            # the FLAT pool
            off, wid, hei = desc[:, d0], desc[:, d0 + 1], desc[:, d0 + 2]
            wf = wid.astype(jnp.float32)
            hf = hei.astype(jnp.float32)
            px = jnp.clip(uu * wf, 0.0, jnp.maximum(wf - 1.0, 0.0)).astype(jnp.int32)
            py = jnp.clip(vv * hf, 0.0, jnp.maximum(hf - 1.0, 0.0)).astype(jnp.int32)
            ok = wid > 0
            base3 = jnp.where(ok, off + 3 * (px + py * wid), 0)
            z = jnp.float32(0.0)
            rgb = _fetch_rgb(scene.tex_pool, base3)
            return ok, Vec3(
                jnp.where(ok, rgb.x, z),
                jnp.where(ok, rgb.y, z),
                jnp.where(ok, rgb.z, z),
            )

        # per-kind static gates: a fetch site whose texture kind
        # exists NOWHERE in the scene would still pay its gather
        # dense, masked to zero afterwards
        if scene.has_norm_tex:
            # raw [0,1] texel used as the tangent-space vector —
            # parity with mesh/triangle.rs:149-151 (no 2x-1 remap)
            uvn_u, uvn_v = interp(25)
            _, ntexel = fetch(3, uvn_u, uvn_v)
            mx = a(3) * ntexel.x + a(4) * ntexel.y + a(5) * ntexel.z
            my = a(6) * ntexel.x + a(7) * ntexel.y + a(8) * ntexel.z
            mz = a(9) * ntexel.x + a(10) * ntexel.y + a(11) * ntexel.z
            mapped = v3.normalize(Vec3(mx, my, mz) * a(12), eps=1e-20)
            mt_norm = v3.where(a(18) > 0.5, mapped, mt_const_norm)
        else:
            mt_norm = mt_const_norm

        if scene.has_rgb_tex:
            uvr_u, uvr_v = interp(19)
            has_rt, rtexel = fetch(0, uvr_u, uvr_v)
            one_t = jnp.ones_like(bu)
            texmul = v3.where(has_rt, rtexel, Vec3(one_t, one_t, one_t))
            mt_rgb = Vec3(a(13), a(14), a(15)) * texmul
        else:
            mt_rgb = Vec3(a(13), a(14), a(15))

        if scene.has_mr_tex:
            uvm_u, uvm_v = interp(31)
            has_mt_, mtexel = fetch(6, uvm_u, uvm_v)
            # metal scales the BLUE channel, rough the GREEN
            # (mesh/triangle.rs:195-197 == trace.wgsl:1120-1123)
            mt_metal = a(16) * jnp.where(has_mt_, mtexel.z, 1.0)
            mt_rough = a(17) * jnp.where(has_mt_, mtexel.y, 1.0)
        else:
            mt_metal = a(16)
            mt_rough = a(17)
    else:
        mt_norm = mt_const_norm
        mt_rgb = Vec3(a(13), a(14), a(15))
        mt_metal = a(16)
        mt_rough = a(17)
    return (mt_norm.x, mt_norm.y, mt_norm.z,
            mt_rgb.x, mt_rgb.y, mt_rgb.z, mt_metal, mt_rough)


def mesh_attrs_compacted(scene, is_mt, mi_all, bu, bv, compact_div: int = 4):
    """mesh_attrs_dense evaluated only on the (typically sparse)
    mesh-hit lanes: scatter their ids into a 1/compact_div-width
    compact buffer (prefix-sum ranks), run the gather-heavy
    attribute/texture path there, gather results back. If more than
    1/compact_div of the lanes hit the mesh, a lax.cond falls back to
    the dense evaluation — correctness never depends on the estimate.
    compact_div <= 1
    forces the dense evaluation with no cond at all — used by tests
    that need bitwise-identical evaluation across drivers (the compact
    and dense branches agree only to fusion-dependent ulps: XLA may
    contract the uv-interp mul+adds differently per fusion shape, and
    a one-ulp uv flip at a texel boundary picks a different texel)."""
    n_lanes = mi_all.shape[0]
    if compact_div <= 1:
        return mesh_attrs_dense(scene, mi_all, bu, bv)
    ranks = jnp.cumsum(is_mt.astype(jnp.int32))
    count = ranks[-1]
    lane_ids = jnp.arange(n_lanes, dtype=jnp.int32)

    def _compact_at(K):
        dest = jnp.where(is_mt, ranks - 1, K)
        id_buf = (
            jnp.zeros((K + 1,), jnp.int32).at[dest].set(lane_ids)[:K]
        )
        # ONE (n_lanes, 3) row gather for the three compact inputs
        # instead of three element gathers. mi rides as a float VALUE
        # (ids < 2^24 are exact in f32), NOT a bitcast: int32 bitcasts
        # land in the f32 denormal range, which a gather lowered
        # through arithmetic may flush to zero.
        ins = jnp.take(
            jnp.stack([mi_all.astype(jnp.float32), bu, bv], axis=-1),
            id_buf, axis=0,
        )
        outs_c = mesh_attrs_dense(
            scene,
            ins[:, 0].astype(jnp.int32),
            ins[:, 1],
            ins[:, 2],
        )
        src = jnp.clip(ranks - 1, 0, K - 1)
        # gather the 8 results back as ONE row gather of a (K, 8)
        # matrix instead of eight element gathers
        mat = jnp.take(jnp.stack(outs_c, axis=-1), src, axis=0)
        return tuple(
            jnp.where(is_mt, mat[:, k], 0.0) for k in range(8)
        )

    K = n_lanes // compact_div
    return jax.lax.cond(
        count <= K,
        lambda: _compact_at(K),
        lambda: mesh_attrs_dense(scene, mi_all, bu, bv),
    )


def _shade_hit(scene, params, ro: Vec3, rd: Vec3, t, kind, idx, bu, bv, draws):
    """Per-lane masked combine over primitive kinds: shading normal,
    surface rgb, emissive + flag, new ray, material weight."""
    u0, u1, u2, u3, u4, u5, u6 = draws
    is_sph = kind == KIND_SPHERE
    is_ft = kind == KIND_FREETRI
    is_mt = kind == KIND_MESHTRI

    t_safe = jnp.where(jnp.isfinite(t), t, 0.0)
    perfect = ro + rd * t_safe

    n = t.shape[0]
    zero = jnp.zeros((n,))
    one = jnp.ones((n,))
    norm = Vec3(zero, zero, zero)
    rgb = Vec3(zero, zero, zero)
    emissive = Vec3(zero, zero, zero)
    has_em = jnp.zeros((n,), bool)
    mkind = jnp.zeros((n,), jnp.int32)
    diffp = zero
    n_out = one
    n_in = one
    metal = zero
    rough = zero

    # --- sphere fields (elements/sphere.rs:65-80) ---
    if scene.n_spheres:
        si = jnp.clip(idx, 0, scene.sph_c.shape[0] - 1)
        sph_norm = v3.normalize(perfect - v3.take(scene.sph_c, si), eps=1e-20)
        norm = v3.where(is_sph, sph_norm, norm)
        rgb = v3.where(is_sph, v3.take(scene.sph_rgb, si), rgb)
        emissive = v3.where(is_sph, v3.take(scene.sph_emissive, si), emissive)
        has_em = jnp.where(is_sph, _tk(scene.sph_has_em, si), has_em)
        mkind = jnp.where(is_sph, _tk(scene.sph_kind, si), mkind)
        diffp = jnp.where(is_sph, _tk(scene.sph_diffp, si), diffp)
        n_out = jnp.where(is_sph, _tk(scene.sph_n_out, si), n_out)
        n_in = jnp.where(is_sph, _tk(scene.sph_n_in, si), n_in)

    # --- free-triangle fields ---
    if scene.n_free_tris:
        fi = jnp.clip(idx, 0, scene.ft_v0.shape[0] - 1)
        norm = v3.where(is_ft, v3.take(scene.ft_norm, fi), norm)
        rgb = v3.where(is_ft, v3.take(scene.ft_rgb, fi), rgb)
        if params.mode != "cpu":
            # CPU zeroes ALL triangle emissive (generic.rs:85-86)
            emissive = v3.where(is_ft, v3.take(scene.ft_emissive, fi), emissive)
            has_em = jnp.where(is_ft, _tk(scene.ft_has_em, fi), has_em)
        mkind = jnp.where(is_ft, _tk(scene.ft_kind, fi), mkind)
        diffp = jnp.where(is_ft, _tk(scene.ft_diffp, fi), diffp)
        n_out = jnp.where(is_ft, _tk(scene.ft_n_out, fi), n_out)
        n_in = jnp.where(is_ft, _tk(scene.ft_n_in, fi), n_in)

    # --- mesh-triangle fields ---
    # ONE row-gather of the packed attribute matrix (layout below) and
    # one of the texture descriptors replace ~40 scalar gathers.
    # _MT_ATTR columns: 0:3 const_norm | 3:12 nrm_mat row-major |
    # 12 norm_scale | 13:16 rgb_factor | 16 metal | 17 rough |
    # 18 has_norm_map | 19:25 uv_rgb | 25:31 uv_norm | 31:37 uv_mr
    if scene.n_mesh_tris:
        def mesh_attrs(mi, bu, bv):
            return mesh_attrs_dense(scene, mi, bu, bv)

        # mesh lanes only pay for the lanes that ARE one: the gathers
        # above (48-col attr row + texture fetches) dominate mesh-scene
        # iteration time, while typically only ~10-25% of lanes hit the
        # mesh on any bounce (sky lanes, sphere lanes, drained
        # wavefront lanes). Wavefront compaction: scatter the mesh-hit
        # lane ids into a quarter-width compact buffer (prefix-sum
        # ranks), run the gather-heavy attribute/texture path there,
        # and gather results back. If more than a quarter of the lanes
        # hit the mesh, a lax.cond falls back to the dense evaluation —
        # correctness never depends on the estimate.
        mi_all = jnp.where(is_mt, jnp.clip(idx, 0, scene.mt_v0.shape[0] - 1), 0)
        n_lanes = t.shape[0]
        TS = 8192

        if (not params.differentiable) and n_lanes >= 4 * TS and n_lanes % 8 == 0:
            (mnx, mny, mnz, mrr, mrg, mrb, mmet, mrgh) = mesh_attrs_compacted(
                scene, is_mt, mi_all, bu, bv
            )
        elif (not params.differentiable) and n_lanes > TS and n_lanes % TS == 0:
            # mid-size: per-tile skip of mesh-free tiles
            n_t = n_lanes // TS
            resh = lambda x: x.reshape(n_t, TS)

            def tile_body(_, args):
                mi_t, bu_t, bv_t, any_t = args
                out = jax.lax.cond(
                    any_t,
                    lambda: mesh_attrs(mi_t, bu_t, bv_t),
                    lambda: tuple(jnp.zeros((TS,), jnp.float32) for _ in range(8)),
                )
                return None, out

            any_mt = jnp.any(resh(is_mt), axis=1)
            _, outs = jax.lax.scan(
                tile_body, None, (resh(mi_all), resh(bu), resh(bv), any_mt)
            )
            (mnx, mny, mnz, mrr, mrg, mrb, mmet, mrgh) = tuple(
                o.reshape(n_lanes) for o in outs
            )
        else:
            (mnx, mny, mnz, mrr, mrg, mrb, mmet, mrgh) = mesh_attrs(mi_all, bu, bv)
        norm = v3.where(is_mt, Vec3(mnx, mny, mnz), norm)
        rgb = v3.where(is_mt, Vec3(mrr, mrg, mrb), rgb)
        metal = jnp.where(is_mt, mmet, metal)
        rough = jnp.where(is_mt, mrgh, rough)

    pos = perfect + norm * EPS  # offset to avoid self-hit (sphere.rs:70 etc.)

    # --- material sampling (all lobes evaluated, masked select) ---
    spec_d = v3.normalize(v3.reflect(rd, norm))
    diff_d = _diff_dir(rd, norm, u1, u2)
    refr_d, refr_w = _refract_dir(rd, norm, n_out, n_in, u3, params.mode)
    ds_diff = u0 < diffp  # DiffSpec lobe choice (uniform_diff_spec.rs:27-37)

    uni_d = v3.where(
        mkind == 0,
        spec_d,
        v3.where(
            mkind == 1,
            diff_d,
            v3.where(mkind == 2, v3.where(ds_diff, diff_d, spec_d), refr_d),
        ),
    )
    uni_w = jnp.where(mkind == 3, refr_w, 1.0)

    # mesh PBR divert (mesh/triangle.rs:190-226): r0 = 0.04+0.96*metal,
    # reflectance = r0 + (1-r0)*(1 - |d.n|^5), CUSTOM_ATTEN = 1
    r0 = 0.04 + (1.0 - 0.04) * metal
    refl = r0 + (1.0 - r0) * (1.0 - jnp.abs(v3.dot(rd, norm)) ** 5)
    pbr_diff = u0 < (1.0 - refl)
    pbr_base = v3.where(pbr_diff, diff_d, spec_d)
    scatter = v3.normalize(Vec3(u4, u5, u6), eps=1e-20) * rough
    pbr_d = v3.normalize(pbr_base + scatter)

    new_d = v3.where(is_mt, pbr_d, uni_d)
    weight = jnp.where(is_mt, 1.0, uni_w)

    return dict(
        norm=norm,
        pos=pos,
        rgb=rgb,
        emissive=emissive,
        has_em=has_em,
        new_d=new_d,
        weight=weight,
        should_dls=(mkind == 1) | ((mkind == 2) & ds_diff),
    )


# ---------------------------------------------------------------------------
# bounce loop


def _bounce_step(scene, params, st):
    """One bounce for all lanes. st is the lane-state dict of (N,)
    arrays / Vec3s."""
    ro, rd = st["ro"], st["rd"]
    t, kind, idx, bu, bv = closest_hit(scene, params, ro, rd, active=st["active"])
    if scene.n_mesh_tris:
        state, draws = rng.next_f32_n(st["rng"], 8)
        u7 = draws[7]
    else:
        # meshless scenes skip the 3 PBR scatter draws (u4-u6); the
        # pallas kernel draws the identical 5-uniform budget
        state, (u0, u1, u2, u3, u7) = rng.next_f32_n(st["rng"], 5)
        draws = (u0, u1, u2, u3, u1, u2, u3, u7)

    hit = kind != KIND_NONE
    miss = ~hit
    active = st["active"]

    shade = _shade_hit(scene, params, ro, rd, t, kind, idx, bu, bv, draws[:7])

    L, ci, inten = st["L"], st["ci"], st["inten"]

    if params.mode == "gpu":
        # -- miss: record for the post-loop cubemap resolve (a lane
        # misses at most once; sampling the cubemap in-loop would
        # gather for every lane every bounce) --
        add_sky = active & miss
        if scene.has_cubemap:
            st["miss_d"] = v3.where(add_sky, rd, st["miss_d"])
            st["miss_w"] = v3.where(add_sky, ci * inten, st["miss_w"])
        # -- emissive hit: add + extra colour multiply (wgsl:294-301) --
        add_em = active & hit & shade["has_em"]
        L = L + v3.where(add_em, shade["emissive"] * ci * inten, Vec3.zeros_like(t))
        ci = v3.where(add_em, ci * shade["rgb"], ci)
        # -- throughput *= colour (wgsl:303) --
        ci = v3.where(active & hit, ci * shade["rgb"], ci)
        # -- russian roulette (wgsl:306-310) --
        rr_due = st["bounce"] >= params.assured_depth
        rr_kill = rr_due & (u7 > params.max_thres)
        term = active & hit & rr_kill
        ci_rr = ci * (1.0 / params.max_thres)
        L = L + v3.where(term, ci_rr * inten, Vec3.zeros_like(t))
        ci = v3.where(term, ci_rr, ci)
        survive = active & hit & ~rr_kill
        inten = jnp.where(survive, inten * shade["weight"], inten)
        new_active = survive
    else:
        # -- CPU semantics (radiance.rs:20-72) --
        if scene.has_cubemap:
            # skybox is the CPU's l=inf "unconditional" element: reached
            # when nothing finite hits; emissive added, path ends
            # (recorded here, resolved once after the loop)
            st["miss_d"] = v3.where(active & miss, rd, st["miss_d"])
            st["miss_w"] = v3.where(active & miss, ci, st["miss_w"])
        L = L + v3.where(active & hit, shade["emissive"] * ci, Vec3.zeros_like(t))
        rr_due = st["bounce"] > params.assured_depth
        rr_pass = jnp.where(rr_due, u7 < CPU_RR_THRES, True)
        atten = jnp.where(rr_due, CPU_RR_THRES, 1.0)
        survive = active & hit & rr_pass
        bounce_rgb = shade["rgb"] * (shade["weight"] / atten)
        ci = v3.where(survive, ci * bounce_rgb, ci)
        new_active = survive

    use_dls = params.dir_light_samp and params.mode == "cpu" and scene.n_spheres
    if use_dls:
        # direct light sampling (radiance.rs:89-120; CPU backend only):
        # at the PREVIOUS bounce's diffuse hit, sum over emissive-sphere
        # emitters (the only DLSEmitter impl, sphere.rs:55-62): shadow
        # ray toward the center; contribution light_dot * emissive /
        # (30*pi) when the nearest hit IS that emitter; emitters equal
        # to the previous element or this bounce's element are omitted
        # (radiance.rs:46-52). One bounce of lookahead gives us the
        # "incoming" element the recursion knew.
        emitters = [
            e for e in range(scene.n_spheres) if bool(np.asarray(scene.sph_has_em)[e])
        ]
        pd = st["dls"]
        pend = pd["active"]
        for e in emitters:
            ec = Vec3(
                jnp.float32(scene.sph_c[e, 0]),
                jnp.float32(scene.sph_c[e, 1]),
                jnp.float32(scene.sph_c[e, 2]),
            )
            d_l = v3.normalize(ec - pd["pos"], eps=1e-20)
            light_dot = v3.dot(d_l, pd["norm"])
            omit = (pd["self_idx"] == e) | ((kind == KIND_SPHERE) & (idx == e))
            cand = pend & (light_dot > 0.0) & ~omit
            ts, ks, is_, _, _ = closest_hit(scene, params, pd["pos"], d_l)
            vis = (ks == KIND_SPHERE) & (is_ == e)
            em_e = Vec3(
                jnp.float32(scene.sph_emissive[e, 0]),
                jnp.float32(scene.sph_emissive[e, 1]),
                jnp.float32(scene.sph_emissive[e, 2]),
            )
            contrib = em_e * (light_dot * DLS_NORMZE)
            L = L + v3.where(cand & vis, pd["ci"] * contrib, Vec3.zeros_like(t))

    if params.debug_single_ray:
        # first-hit emissive only (radiance.rs:31-33); skybox shows sky
        sky = sample_cubemap(scene, rd) if scene.has_cubemap else Vec3.zeros_like(t)
        L = v3.where(active & hit, shade["emissive"], L)
        L = v3.where(active & miss, sky, L)
        new_active = jnp.zeros_like(new_active)

    out = dict(
        ro=v3.where(new_active, shade["pos"], ro),
        rd=v3.where(new_active, shade["new_d"], rd),
        L=L,
        ci=ci,
        inten=inten,
        rng=state,
        active=new_active,
        bounce=st["bounce"] + new_active.astype(jnp.int32),
    )
    if scene.has_cubemap and not params.debug_single_ray:
        out["miss_d"] = st["miss_d"]
        out["miss_w"] = st["miss_w"]
    if use_dls:
        out["dls"] = dict(
            active=new_active & shade["should_dls"],
            pos=shade["pos"],
            norm=shade["norm"],
            ci=ci,
            self_idx=jnp.where(kind == KIND_SPHERE, idx, -1),
        )
    return out


def trace_paths(scene, params: IntegratorParams, ro: Vec3, rd: Vec3, rng_state):
    """Trace a batch of rays to completion. Returns (L: Vec3, rng).

    Forward rendering uses a while_loop that exits when every lane is
    dead; the differentiable path uses a fixed-length scan (reverse-mode
    through while_loop is not supported)."""
    n = ro.x.shape[0]
    zero = jnp.zeros((n,))
    one = jnp.ones((n,))
    st = dict(
        ro=ro,
        rd=rd,
        L=Vec3(zero, zero, zero),
        ci=Vec3(one, one, one),
        inten=one,
        rng=rng_state,
        active=jnp.ones((n,), bool),
        bounce=jnp.zeros((n,), jnp.int32),
    )
    if scene.has_cubemap and not params.debug_single_ray:
        st["miss_d"] = Vec3(zero, zero, zero)
        st["miss_w"] = Vec3(zero, zero, zero)
    if params.dir_light_samp and params.mode == "cpu" and scene.n_spheres:
        st["dls"] = dict(
            active=jnp.zeros((n,), bool),
            pos=Vec3(zero, zero, zero),
            norm=Vec3(zero, zero, zero),
            ci=Vec3(one, one, one),
            self_idx=jnp.full((n,), -1, jnp.int32),
        )
    max_b = 1 if params.debug_single_ray else params.max_bounces

    if params.differentiable:
        def body(st, _):
            return _bounce_step(scene, params, st), None

        st, _ = jax.lax.scan(body, st, None, length=max_b)
    else:
        def cond(carry):
            i, st = carry
            return (i < max_b) & jnp.any(st["active"])

        def body(carry):
            i, st = carry
            return i + 1, _bounce_step(scene, params, st)

        _, st = jax.lax.while_loop(cond, body, (0, st))
    L = st["L"]
    if scene.has_cubemap and not params.debug_single_ray:
        # one cubemap resolve for the whole path (miss happens once)
        mw = st["miss_w"]
        missed = (mw.x > 0.0) | (mw.y > 0.0) | (mw.z > 0.0)
        md = st["miss_d"]
        sky = sample_cubemap(scene, v3.where(missed, md, Vec3.full_like(md.x, 1.0, 0.0, 0.0)))
        L = L + v3.where(missed, mw * sky, Vec3.zeros_like(mw.x))
    return L, st["rng"]
