"""Unit tests for the numerics core against closed forms — the
reference's 13 unit tests (target.rs / hit.rs / aabb.rs) are the floor;
we also verify distributions and formula identities."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytrace.ops import bsdf, rng
from raytrace.ops.geom import dot, normalize, reflect
from raytrace.ops.intersect import (
    intersect_spheres,
    intersect_triangles,
    slab_test,
)


def _v(*xs):
    return jnp.asarray(xs, dtype=jnp.float32)


class TestRng:
    def test_deterministic(self):
        s = rng.init_state(jnp.arange(4), jnp.arange(4), 64, 64, 3)
        s2 = rng.init_state(jnp.arange(4), jnp.arange(4), 64, 64, 3)
        assert (s == s2).all()

    def test_uniform_range_and_mean(self):
        s = rng.init_state(jnp.arange(10000), jnp.zeros(10000, jnp.int32), 100, 100, 0)
        _, u = rng.next_f32(s)
        u = np.asarray(u)
        assert u.min() >= 0.0 and u.max() <= 1.0
        assert abs(u.mean() - 0.5) < 0.02
        assert abs(np.var(u) - 1 / 12) < 0.01

    def test_streams_decorrelated_across_samples(self):
        xs = jnp.arange(4096)
        ys = jnp.zeros(4096, jnp.int32)
        _, u0 = rng.next_f32(rng.init_state(xs, ys, 64, 64, 0))
        _, u1 = rng.next_f32(rng.init_state(xs, ys, 64, 64, 1))
        corr = np.corrcoef(np.asarray(u0), np.asarray(u1))[0, 1]
        assert abs(corr) < 0.05

    def test_successive_draws_decorrelated(self):
        """Lag-1..4 serial correlation within one stream stays at the
        sqrt(N) noise level — the risky axis for a one-multiply-
        finalizer Weyl generator (consecutive states differ by a
        constant), gating the GENERATOR family choice."""
        s = rng.init_state(jnp.arange(8192), jnp.zeros(8192, jnp.int32), 128, 64, 7)
        draws = []
        for _ in range(6):
            s, u = rng.next_f32(s)
            draws.append(np.asarray(u))
        d = np.stack(draws)  # (6, 8192)
        for lag in (1, 2, 3, 4):
            c = [np.corrcoef(d[i], d[i + lag])[0, 1] for i in range(6 - lag)]
            assert max(abs(x) for x in c) < 0.05, (lag, c)

    def test_neighbor_pixel_streams_decorrelated(self):
        """(x, y) vs (x+1, y) streams — jenkins-seeded lanes must not
        inherit neighbor structure through the per-draw update."""
        xs = jnp.arange(8192)
        ys = (xs * 7) % 512
        s_a = rng.init_state(xs, ys, 8192, 512, 3)
        s_b = rng.init_state(xs + 1, ys, 8192, 512, 3)
        for _ in range(3):
            s_a, ua = rng.next_f32(s_a)
            s_b, ub = rng.next_f32(s_b)
            corr = np.corrcoef(np.asarray(ua), np.asarray(ub))[0, 1]
            assert abs(corr) < 0.05

    def test_2d_stratification_chi2(self):
        """(u, v) pairs from one stream fill the unit square uniformly:
        chi-square over a 16x16 grid within 4 sigma — catches planes /
        lattice structure a mean/variance test misses."""
        s = rng.init_state(
            jnp.arange(65536), jnp.full(65536, 9, jnp.int32), 65536, 16, 11
        )
        s, u = rng.next_f32(s)
        _, v = rng.next_f32(s)
        iu = np.minimum((np.asarray(u) * 16).astype(int), 15)
        iv = np.minimum((np.asarray(v) * 16).astype(int), 15)
        counts = np.bincount(iu * 16 + iv, minlength=256)
        expected = 65536 / 256
        chi2 = ((counts - expected) ** 2 / expected).sum()
        # dof = 255: mean 255, sd = sqrt(2*255) ~ 22.6; 4 sigma ~ 345
        assert chi2 < 255 + 4 * np.sqrt(2 * 255), chi2


class TestSphere:
    def test_head_on(self):
        ro = _v(0, 0, 0)[None]
        rd = _v(0, 0, -1)[None]
        c = _v(0, 0, -10)[None]
        r = jnp.asarray([2.0])
        t = intersect_spheres(ro, rd, c, r)
        assert np.allclose(np.asarray(t)[0, 0], 8.0, atol=1e-5)

    def test_miss(self):
        t = intersect_spheres(
            _v(0, 0, 0)[None], _v(0, 1, 0)[None], _v(0, 0, -10)[None], jnp.asarray([2.0])
        )
        assert np.isinf(np.asarray(t)).all()

    def test_inside_gpu_vs_cpu(self):
        """A ray starting inside: CPU takes the exit root, GPU misses
        (trace.wgsl:597-608 branch structure vs sphere.rs:93-99)."""
        ro = _v(0, 0, -10)[None]
        rd = _v(0, 0, -1)[None]
        c = _v(0, 0, -10)[None]
        r = jnp.asarray([2.0])
        t_gpu = np.asarray(intersect_spheres(ro, rd, c, r, mode="gpu"))
        t_cpu = np.asarray(intersect_spheres(ro, rd, c, r, mode="cpu"))
        assert np.isinf(t_gpu[0, 0])
        assert np.allclose(t_cpu[0, 0], 2.0, atol=1e-5)

    def test_behind(self):
        t = intersect_spheres(
            _v(0, 0, 0)[None], _v(0, 0, 1)[None], _v(0, 0, -10)[None], jnp.asarray([2.0])
        )
        assert np.isinf(np.asarray(t)).all()


class TestTriangle:
    def _tri(self):
        v0 = _v(-1, -1, -5)[None]
        v1 = _v(1, -1, -5)[None]
        v2 = _v(0, 1, -5)[None]
        return v0, v1 - v0, v2 - v0

    def test_center_hit_and_bary(self):
        v0, e1, e2 = self._tri()
        t, u, v = intersect_triangles(_v(0, -0.2, 0)[None], _v(0, 0, -1)[None], v0, e1, e2)
        assert np.allclose(np.asarray(t)[0, 0], 5.0, atol=1e-5)
        # p = v0 + u e1 + v e2
        p = np.asarray(v0[0] + u[0, 0] * e1[0] + v[0, 0] * e2[0])
        assert np.allclose(p, [0, -0.2, -5], atol=1e-5)

    def test_outside(self):
        v0, e1, e2 = self._tri()
        t, _, _ = intersect_triangles(_v(2, 2, 0)[None], _v(0, 0, -1)[None], v0, e1, e2)
        assert np.isinf(np.asarray(t)).all()

    def test_parallel(self):
        v0, e1, e2 = self._tri()
        t, _, _ = intersect_triangles(_v(0, 0, 0)[None], _v(1, 0, 0)[None], v0, e1, e2)
        assert np.isinf(np.asarray(t)).all()

    def test_edge_boundaries_inclusive(self):
        """u == 0 and u+v == 1 pass the reference's guards
        (generic.rs:117-127 rejects only u<0, u>1, v<0, u+v>1)."""
        v0, e1, e2 = self._tri()
        t, u, v = intersect_triangles(_v(-1, -1, 0)[None], _v(0, 0, -1)[None], v0, e1, e2)
        assert np.isfinite(np.asarray(t)[0, 0])


class TestSlab:
    """Ports of the reference AABB tests (accel/aabb.rs:66-122)."""

    def test_axis_aligned_entry_exit(self):
        lo = _v(-1, -1, -1)[None]
        hi = _v(1, 1, 1)[None]
        entry, exit_, hit = slab_test(_v(0, 0, 5)[None], _v(0, 0, -1)[None], lo, hi)
        assert bool(np.asarray(hit)[0, 0])
        assert np.allclose(np.asarray(entry)[0, 0], 4.0, atol=1e-4)
        assert np.allclose(np.asarray(exit_)[0, 0], 6.0, atol=1e-4)

    def test_parallel_miss(self):
        lo = _v(-1, -1, -1)[None]
        hi = _v(1, 1, 1)[None]
        _, _, hit = slab_test(_v(5, 0, 5)[None], _v(0, 0, -1)[None], lo, hi)
        assert not bool(np.asarray(hit)[0, 0])

    def test_inside_origin(self):
        lo = _v(-1, -1, -1)[None]
        hi = _v(1, 1, 1)[None]
        entry, exit_, hit = slab_test(_v(0, 0, 0)[None], _v(0, 0, -1)[None], lo, hi)
        assert bool(np.asarray(hit)[0, 0])
        assert np.asarray(entry)[0, 0] < 0 < np.asarray(exit_)[0, 0]


class TestBsdf:
    def test_spec_mirror(self):
        d = normalize(_v(1, -1, 0))[None]
        n = _v(0, 1, 0)[None]
        out = np.asarray(bsdf.sample_spec(d, n))
        assert np.allclose(out[0], np.asarray(normalize(_v(1, 1, 0))), atol=1e-6)

    def test_diff_cosine_distribution(self):
        n_lanes = 20000
        # oblique incidence: head-on (d == -n) degenerates the tangent
        # frame in the reference too (interaction.rs:13 normalizes a
        # zero vector); jittered camera rays make it measure-zero there.
        d = jnp.tile(normalize(_v(0.3, -1, 0.2))[None], (n_lanes, 1))
        n = jnp.tile(_v(0, 1, 0)[None], (n_lanes, 1))
        state = rng.init_state(jnp.arange(n_lanes), jnp.zeros(n_lanes, jnp.int32), 997, 991, 7)
        _, out = bsdf.sample_diff(state, d, n)
        out = np.asarray(out)
        cos = out[:, 1]
        assert (cos >= -1e-6).all()
        # cosine-weighted: E[cos] = 2/3
        assert abs(cos.mean() - 2 / 3) < 0.01
        # E[cos^2] = 1/2
        assert abs((cos**2).mean() - 0.5) < 0.01

    def test_refract_entry_semantics(self):
        """Normal incidence, n1 == n2. CPU mode transmits straight
        (cos_term = 1-c1 = 0 -> re = r0 = 0). GPU mode: the reference's
        Schlick cos term 1 - dot(trns, n) equals 1 + sqrt(c22) >= 1 for
        ENTERING rays, so re >= 1 and the GPU dielectric always
        mirror-reflects on entry (trace.wgsl:570-576) — a real
        reference quirk its published renders include; both behaviors
        are locked in here."""
        n_lanes = 16
        d = jnp.tile(_v(0, 0, -1)[None], (n_lanes, 1))
        n = jnp.tile(_v(0, 0, 1)[None], (n_lanes, 1))
        state = rng.init_state(jnp.arange(n_lanes), jnp.zeros(n_lanes, jnp.int32), 31, 17, 1)
        _, out_c, w_c = bsdf.sample_refract(
            state, d, n, jnp.float32(1.0), jnp.float32(1.0), mode="cpu"
        )
        assert np.allclose(np.asarray(out_c), np.tile([0, 0, -1.0], (n_lanes, 1)), atol=1e-5)
        assert np.allclose(np.asarray(w_c), 1.0, atol=1e-5)
        _, out_g, w_g = bsdf.sample_refract(
            state, d, n, jnp.float32(1.0), jnp.float32(1.5), mode="gpu"
        )
        assert np.allclose(np.asarray(out_g), np.tile([0, 0, 1.0], (n_lanes, 1)), atol=1e-5)
        assert np.allclose(np.asarray(w_g), 1.0, atol=1e-5)

    def test_total_internal_reflection(self):
        d = normalize(_v(1, -0.1, 0))[None]  # grazing from inside dense medium
        n = _v(0, 1, 0)[None]
        state = jnp.zeros((1,), jnp.uint32)
        # leaving dense medium (d.n > 0 -> n1 = n_in)
        d_in = normalize(_v(1, 0.1, 0))[None]
        _, out, w = bsdf.sample_refract(state, d_in, n, jnp.float32(1.0), jnp.float32(1.5))
        out = np.asarray(out)
        # sin(theta) ~ 0.995 > 1/1.5 -> TIR: reflect, weight 1
        expected = np.array(reflect(d_in, -n))[0]
        expected = expected / np.linalg.norm(expected)
        assert np.allclose(out[0], expected, atol=1e-5)
        assert np.allclose(np.asarray(w)[0], 1.0)

    def test_pbr_reflectance_formula(self):
        d = _v(0, 0, -1)[None]
        n = _v(0, 0, 1)[None]
        r = np.asarray(bsdf.pbr_reflectance(jnp.asarray([0.0]), d, n))
        # |d.n| = 1 -> reflectance = r0 + (1-r0)*(1-1) = r0 = 0.04
        assert np.allclose(r[0], 0.04, atol=1e-6)
        r = np.asarray(bsdf.pbr_reflectance(jnp.asarray([1.0]), d, n))
        assert np.allclose(r[0], 1.0, atol=1e-6)
