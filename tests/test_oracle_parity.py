"""Oracle <-> production parity (VERDICT round-2 weak item 5 / ask 6).

The closed-form unit tests in tests/test_ops.py validate the ops.*
oracle modules; production re-implements the same formulas in
scalar-SoA / in-kernel form (render/integrator.py, ops/pallas/*).
These tests pin the two together, so the oracles guard the code that
actually ships:

  * integrator._diff_dir / _refract_dir  vs  ops.bsdf
  * integrator.sample_cubemap            vs  ops.cubemap.sample
  * trace_kernel.closest_sph_ft (sphere path, interpret mode)
                                         vs  ops.intersect.intersect_spheres

Chain closure: tests/test_pallas.py ties the fused kernels bitwise to
the XLA integrator, so oracle == integrator (here) + integrator ==
kernel (there) covers every production copy of the formulas.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytrace.ops import bsdf, cubemap, intersect, rng
from raytrace.ops.vec import Vec3
from raytrace.render.integrator import _diff_dir, _refract_dir, sample_cubemap

N = 4096


def _rand_units(key, n):
    v = np.random.default_rng(key).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _vec(a):
    a = jnp.asarray(a)
    return Vec3(a[:, 0], a[:, 1], a[:, 2])


def test_diff_dir_matches_bsdf_oracle():
    d = _rand_units(1, N)
    n = _rand_units(2, N)
    # same stream: the oracle draws (u, v) from state; production takes
    # them as arguments
    state0 = rng.init_state(
        jnp.arange(N, dtype=jnp.int32) % 64,
        jnp.arange(N, dtype=jnp.int32) // 64,
        64, 64, jnp.int32(7),
    )
    _, oracle_d = bsdf.sample_diff(state0, jnp.asarray(d), jnp.asarray(n))
    st, u = rng.next_f32(state0)
    st, w = rng.next_f32(st)
    prod = _diff_dir(_vec(d), _vec(n), u, w)
    got = np.stack([np.asarray(prod.x), np.asarray(prod.y), np.asarray(prod.z)], -1)
    # production drops the algebraically-redundant renormalizes, so
    # agreement is to f32 rounding, not bitwise
    np.testing.assert_allclose(got, np.asarray(oracle_d), atol=2e-6)


@pytest.mark.parametrize("mode", ["gpu", "cpu"])
def test_refract_dir_matches_bsdf_oracle(mode):
    d = _rand_units(3, N)
    n = _rand_units(4, N)
    # mix entering/exiting and TIR-prone ratios
    n_out = jnp.full((N,), 1.0, jnp.float32)
    n_in = jnp.asarray(
        np.random.default_rng(5).uniform(1.05, 2.4, N).astype(np.float32)
    )
    state0 = rng.init_state(
        jnp.arange(N, dtype=jnp.int32) % 64,
        jnp.arange(N, dtype=jnp.int32) // 64,
        64, 64, jnp.int32(11),
    )
    _, oracle_d, oracle_w = bsdf.sample_refract(
        state0, jnp.asarray(d), jnp.asarray(n), n_out, n_in, mode=mode
    )
    _, u = rng.next_f32(state0)
    prod_d, prod_w = _refract_dir(_vec(d), _vec(n), n_out, n_in, u, mode)
    got = np.stack([np.asarray(prod_d.x), np.asarray(prod_d.y), np.asarray(prod_d.z)], -1)
    np.testing.assert_allclose(got, np.asarray(oracle_d), atol=2e-6)
    np.testing.assert_allclose(np.asarray(prod_w), np.asarray(oracle_w), atol=2e-6)


def test_sample_cubemap_matches_cubemap_oracle():
    # six 4x3 faces with distinct texels, non-uniform uv scales
    rg = np.random.default_rng(6)
    dims = np.array([[4, 3]] * 6, np.int32)
    offsets = np.arange(6, dtype=np.int32) * (4 * 3 * 3)
    pool = rg.uniform(0, 1, 6 * 4 * 3 * 3).astype(np.float32)
    scales = rg.uniform(0.5, 1.5, (6, 2)).astype(np.float32)

    class _S:  # the 4 attrs sample_cubemap reads
        sky_pool = jnp.asarray(pool)
        tex_pool = jnp.asarray(pool)
        cm_offsets = jnp.asarray(offsets)
        cm_dims = jnp.asarray(dims)
        cm_uv_scales = jnp.asarray(scales)

    rd = _rand_units(7, N)
    oracle = cubemap.sample(
        _S.tex_pool, _S.cm_offsets, _S.cm_dims, _S.cm_uv_scales, jnp.asarray(rd)
    )
    prod = sample_cubemap(_S, _vec(rd))
    got = np.stack([np.asarray(prod.x), np.asarray(prod.y), np.asarray(prod.z)], -1)
    np.testing.assert_array_equal(got, np.asarray(oracle))


def test_kernel_sphere_path_matches_intersect_oracle():
    """closest_sph_ft's unrolled sphere loop (Triton-route Pallas kernel,
    interpret mode on CPU) vs ops.intersect.intersect_spheres(mode='gpu')
    min-reduced."""
    from jax.experimental import pallas as pl
    from raytrace.ops.pallas import trace_kernel as tk

    rg = np.random.default_rng(8)
    n_sph = 5
    centers = rg.uniform(-4, 4, (n_sph, 3)).astype(np.float32)
    centers[:, 2] -= 8.0
    radii = rg.uniform(0.5, 2.5, n_sph).astype(np.float32)

    # minimal sph table rows in pack_scene_tables layout (S', 16):
    # [c(3), r, rgb(3), em(3), has_em, kind, diffp, n_out, n_in, pad]
    sph_t = np.zeros((8, 16), np.float32)
    sph_t[:n_sph, 0:3] = centers
    sph_t[:n_sph, 3] = radii
    ft_t = np.zeros((1, 32), np.float32)

    n = 1024
    ro = np.zeros((n, 3), np.float32)
    rd = _rand_units(9, n)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.2  # bias toward the spheres
    rd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)

    def kernel(ox, oy, oz, dx, dy, dz, sph_ref, ft_ref, t_o):
        s_ = tk.closest_sph_ft(
            sph_ref, ft_ref, ox[...], oy[...], oz[...], dx[...], dy[...], dz[...],
            n_sph=n_sph, n_ft=0, hints=tk._PERMISSIVE,
        )
        t_o[...] = s_["t_best"]

    lane = pl.BlockSpec((tk.BLOCK,), lambda i: (i,))
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0, 0))
    t_kern = pl.pallas_call(
        kernel,
        grid=(n // tk.BLOCK,),
        in_specs=[lane] * 6 + [whole(sph_t), whole(ft_t)],
        out_specs=lane,
        out_shape=jax.ShapeDtypeStruct((n,), jnp.float32),
        backend="triton",
        interpret=True,
    )(
        *[jnp.asarray(ro[:, k]) for k in range(3)],
        *[jnp.asarray(rd[:, k]) for k in range(3)],
        jnp.asarray(sph_t), jnp.asarray(ft_t),
    )
    t_oracle = intersect.intersect_spheres(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(centers),
        jnp.asarray(radii), mode="gpu",
    ).min(axis=-1)
    got = np.asarray(t_kern)
    want = np.asarray(t_oracle)
    hits = np.isfinite(want) & (want < tk.INF)  # kernel miss = MAXF-like
    got = np.where(got >= tk.INF, np.inf, got)
    assert hits.any() and (~hits).any()  # both classes exercised
    assert (np.isfinite(got) == hits).all()
    # the kernel evaluates b = d.oc then disc = b*b - (|oc|^2 - r^2)
    # with a different contraction order than the (..., M, 3) oracle
    # einsum — f32 rounding only
    np.testing.assert_allclose(got[hits], want[hits], rtol=1e-5)
