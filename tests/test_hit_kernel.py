"""Mesh nearest-hit kernel (Pallas, Triton route, interpret mode) vs
the XLA cluster walk integrator._mesh_hit_clusters — the plain
reference it replaces on the GPU — over synthetic meshes, and the
wavefront driver with the kernel vs the plain integrator."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytrace.models import config as cfg
from raytrace.models import procedural
from raytrace.models.camera import build_camera
from raytrace.models.gltf import LoadedMesh, Primitive
from raytrace.models.scene import build_scene
from raytrace.ops.pallas.hit_kernel import mesh_hit
from raytrace.ops.vec import Vec3
from raytrace.render.integrator import EPS, IntegratorParams, _mesh_hit_clusters
from raytrace.render.renderer import camera_to_arrays, sample_batch
from raytrace.render.wavefront import wavefront_batch

N_RAYS = 1000  # not a block multiple: exercises the kernel's padding


def _mesh(v0, e1, e2):
    n = v0.shape[0]
    poses = np.concatenate([v0, v0 + e1, v0 + e2], 0).astype(np.float32)
    idx = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], 1)
    nrm = np.cross(e1, e2)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-9)
    prim = Primitive(poses=poses, norms=np.concatenate([nrm] * 3, 0).astype(np.float32),
                     indices=idx.astype(np.int32),
                     rgb_factor=np.array([0.7, 0.6, 0.5], np.float32))
    return LoadedMesh(primitives=[prim], trans_mat=np.eye(4, dtype=np.float32))


def _fan(rng):
    th = np.linspace(0, 2 * np.pi, 48, endpoint=False)
    v0 = np.zeros((48, 3)) + [0.0, 0.0, -6.0]
    e1 = np.stack([np.cos(th), np.sin(th), 0.2 * np.sin(3 * th)], -1) * 2.0
    e2 = np.stack([np.cos(th + 0.13), np.sin(th + 0.13), 0.2 * np.sin(3 * th + 0.4)], -1) * 2.0
    return v0, e1, e2


def _soup(rng):
    c = rng.uniform([-3, -3, -9], [3, 3, -4], (2000, 3))
    return c, rng.normal(0, 0.4, (2000, 3)), rng.normal(0, 0.4, (2000, 3))


def _coplanar(rng):
    """A flat 16x16 quad grid at z=-6: every interior edge is shared by
    two coplanar triangles, so rays through edges tie exactly."""
    g = np.linspace(-3, 3, 17)
    x0, y0 = np.meshgrid(g[:-1], g[:-1], indexing="ij")
    d = g[1] - g[0]
    base = np.stack([x0.ravel(), y0.ravel(), np.full(x0.size, -6.0)], -1)
    ex = np.array([d, 0, 0]) + 0 * base
    ey = np.array([0, d, 0]) + 0 * base
    v0 = np.concatenate([base, base + ex + ey])
    e1 = np.concatenate([ex, -ex])
    e2 = np.concatenate([ey, -ey])
    return v0, e1, e2


def _scene(v0, e1, e2):
    raw = {
        "render_info": {
            "width": 32, "height": 32, "samps_per_pix": 1,
            "rad_info": {"russ_roull_info": {"assured_depth": 2, "max_thres": 0.5}},
        },
        "cam": {"d": [0, 0, -4.0], "o": [0, 0, 0], "up": [0, 1, 0],
                "screen_width": 6.0, "screen_height": 6.0},
        "scene_members": [],
    }
    scheme = cfg.parse_scheme(raw)
    return build_scene(scheme, meshes=[_mesh(v0, e1, e2)])


def _rays(rng, n, grid_edges=False):
    o = np.zeros((n, 3)) + rng.normal(0, 0.05, (n, 3))
    if grid_edges:
        # aim at quad-grid vertices and edges of _coplanar
        g = np.linspace(-3, 3, 17)
        tgt = np.stack([rng.choice(g, n), rng.uniform(-3, 3, n), np.full(n, -6.0)], -1)
        o[:] = 0.0
    else:
        tgt = rng.uniform([-4, -4, -8], [4, 4, -5], (n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _compare(scene, o, d, seed, t_min=EPS, mode="gpu", interpret=True):
    cols = lambda a: [jnp.asarray(a[:, k]) for k in range(3)]
    got = mesh_hit(*cols(o), *cols(d), jnp.asarray(seed), scene.cl_lo,
                   scene.cl_hi, scene.cl_v0, scene.cl_e1, scene.cl_e2,
                   scene.cl_idx, t_min=t_min, interpret=interpret)
    ref = _mesh_hit_clusters(scene, IntegratorParams(mode=mode, ray_tile=256),
                             Vec3(*cols(o)), Vec3(*cols(d)), jnp.asarray(seed))
    gt, gi, gu, gv = (np.asarray(a) for a in got)
    rt, ri, ru, rv = (np.asarray(a) for a in ref)
    hit = ri >= 0
    np.testing.assert_array_equal(gi >= 0, hit)
    np.testing.assert_allclose(gt[hit], rt[hit], rtol=1e-5)
    # ids agree except at exact ties (two triangles, one distance)
    differ = hit & (gi != ri)
    assert (gt[differ] == rt[differ]).all()
    same = hit & (gi == ri)
    # barycentrics: f32 rounding of the same formulas, evaluated in a
    # different operation order by the two compilers
    np.testing.assert_allclose(gu[same], ru[same], atol=1e-4)
    np.testing.assert_allclose(gv[same], rv[same], atol=1e-4)
    np.testing.assert_array_equal(gt[~hit], np.asarray(seed)[~hit])
    return hit


@pytest.mark.parametrize("make", [_fan, _soup, _coplanar], ids=["fan", "soup2k", "coplanar"])
def test_hit_kernel_matches_cluster_walk(make):
    rng = np.random.default_rng(5)
    scene = _scene(*make(rng))
    o, d = _rays(rng, N_RAYS, grid_edges=make is _coplanar)
    hit = _compare(scene, o, d, np.full((N_RAYS,), np.inf, np.float32))
    assert hit.any() and (~hit).any()


def test_hit_kernel_dead_lanes_and_misses():
    """-INF seeds (dead lanes) never take a hit; rays pointing away
    miss every cluster; finite seeds from nearer primitives win."""
    rng = np.random.default_rng(6)
    scene = _scene(*_soup(rng))
    o, d = _rays(rng, N_RAYS)
    d[::3] *= -1.0  # away from the soup: miss every cluster
    seed = np.full((N_RAYS,), np.inf, np.float32)
    seed[::5] = -np.inf
    seed[2::10] = 4.5  # a nearer sphere/free-triangle hit (live lanes)
    hit = _compare(scene, o, d, seed)
    assert not hit[::5].any() and not hit[::3].any()


def _compare_compiled():
    """The soup case with the kernel compiled for the card
    (tests/test_gpu.py)."""
    rng = np.random.default_rng(5)
    scene = _scene(*_soup(rng))
    o, d = _rays(rng, N_RAYS)
    hit = _compare(scene, o, d, np.full((N_RAYS,), np.inf, np.float32),
                   interpret=False)
    assert hit.any() and (~hit).any()


def test_hit_kernel_cpu_guard():
    """cpu semantics: the 20*EPS closest-hit guard as t_min."""
    rng = np.random.default_rng(7)
    scene = _scene(*_soup(rng))
    o, d = _rays(rng, N_RAYS)
    _compare(scene, o, d, np.full((N_RAYS,), np.inf, np.float32),
             t_min=20.0 * EPS, mode="cpu")


def test_wavefront_with_hit_kernel_matches_integrator():
    """The mesh wavefront driver on the hit kernel reproduces the plain
    integrator (XLA cluster cull) on the textured procedural scene."""
    w, h = 32, 16
    scheme, meshes = procedural.textured_scene(w, h, 2, tex_size=64, sky_size=16)
    scene = build_scene(scheme, meshes=meshes)
    cam = camera_to_arrays(build_camera(scheme.cam, w, h))
    params = IntegratorParams(assured_depth=3, max_bounces=6)
    flat = np.arange(w * h, dtype=np.int32)
    xs, ys = jnp.asarray(flat % w), jnp.asarray(flat // w)
    ref = np.asarray(sample_batch(scene, cam, params, w, h, xs, ys,
                                  jnp.int32(0), jnp.int32(2)))
    out = np.asarray(wavefront_batch(
        scene, cam, params.replace(mesh_hit="triton", interpret=True), xs, ys,
        jnp.int32(0), jnp.int32(2), width=w, height=h, pool=256))
    assert ref.mean() > 0.01
    bad = ~np.isclose(out, ref, rtol=1e-3, atol=1e-3)
    assert bad.mean() < 0.01, f"mismatch frac {bad.mean()}"
    np.testing.assert_allclose(out.mean(0), ref.mean(0), rtol=1e-3)
