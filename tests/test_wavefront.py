"""Wavefront regeneration driver vs the classic bounce loop: same
per-(pixel, sample) RNG streams -> same radiance sums up to f32
reassociation (accumulation order differs)."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytrace.models import config as cfg
from raytrace.models import procedural
from raytrace.models.camera import build_camera
from raytrace.models.scene import build_scene
from raytrace.render.integrator import IntegratorParams
from raytrace.render.renderer import camera_to_arrays, sample_batch
from raytrace.render.wavefront import wavefront_batch

W, H = 48, 24


def _sphere(c, r, rgb, mat):
    return cfg.Tagged("Sphere", {"c": c, "r": r, "coloring": cfg.Tagged("Solid", rgb), "mat": mat})


def _sphere_scheme():
    raw = {
        "render_info": {
            "width": W, "height": H, "samps_per_pix": 2, "kd_tree_depth": 0,
            "rad_info": {
                "debug_single_ray": False, "dir_light_samp": False,
                "russ_roull_info": {"assured_depth": 2, "max_thres": 0.5},
            },
            "use_gpu": True,
        },
        "cam": {
            "d": [0, 0, -5], "o": [0, 0, 0], "up": [0, 1, 0],
            "view_eulers": [0, 0, 0], "screen_width": 8.0, "screen_height": 4.0,
        },
        "scene_members": [
            _sphere([0, -1.2, -10], 2.0, [0.7, 0.7, 0.7], {"divert_ray": "Diff"}),
            _sphere([1.5, 0.5, -8], 1.0, [0.9, 0.9, 0.9], {"divert_ray": "Spec"}),
            _sphere([-1.5, 0.5, -8], 1.0, [0.9, 0.9, 0.9],
                    {"divert_ray": cfg.Tagged("Dielectric", {"n_out": 1.0, "n_in": 1.5})}),
            _sphere([0, 2.2, -10], 1.5, [0, 0, 0], {"divert_ray": "Diff", "emissive": [6, 6, 6]}),
            _sphere([0, 0, -30], 15.0, [0.5, 0.5, 0.5], {"divert_ray": "Diff"}),
        ],
    }
    return cfg.parse_scheme(raw)


def _compare(scheme, params, n_samples=4, pool=256, wh=(W, H), meshes=None):
    w, h = wh
    scene = build_scene(scheme, meshes=meshes)
    cam = camera_to_arrays(build_camera(scheme.cam, w, h))
    flat = np.arange(w * h, dtype=np.int32)
    xs = jnp.asarray(flat % w)
    ys = jnp.asarray(flat // w)
    ref = np.asarray(
        sample_batch(scene, cam, params, w, h, xs, ys, jnp.int32(0), jnp.int32(n_samples))
    )
    out = np.asarray(
        wavefront_batch(
            scene, cam, params, xs, ys, jnp.int32(0), jnp.int32(n_samples),
            width=w, height=h, pool=pool,
        )
    )
    return ref, out


def test_wavefront_spheres_gpu_mode():
    params = IntegratorParams(assured_depth=2, max_bounces=8, mode="gpu")
    ref, out = _compare(_sphere_scheme(), params)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_wavefront_pool_smaller_and_larger_than_work():
    params = IntegratorParams(assured_depth=2, max_bounces=8, mode="gpu")
    scheme = _sphere_scheme()
    ref, small = _compare(scheme, params, n_samples=2, pool=128)
    _, large = _compare(scheme, params, n_samples=2, pool=8192)
    ref2, _ = _compare(scheme, params, n_samples=2, pool=128)
    np.testing.assert_allclose(small, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(large, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ref2, ref)  # determinism


def test_wavefront_cpu_mode():
    params = IntegratorParams(assured_depth=2, max_bounces=8, mode="cpu")
    ref, out = _compare(_sphere_scheme(), params)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def _textured(w, h):
    """Procedural biplane-class scene: textured mesh under a cubemap."""
    return procedural.textured_scene(w, h, 2, tex_size=64, sky_size=16)


def test_wavefront_mesh_scene_with_cubemap():
    w, h = 64, 32
    scheme, meshes = _textured(w, h)
    params = IntegratorParams(assured_depth=3, max_bounces=6, mode="gpu")
    ref, out = _compare(scheme, params, n_samples=2, meshes=meshes, pool=512, wh=(w, h))
    bad = ~np.isclose(out, ref, rtol=1e-3, atol=1e-3)
    assert bad.mean() < 0.002, f"mismatch frac {bad.mean()}, max {np.abs(out - ref).max()}"
    assert np.isfinite(out).all()


def test_wavefront_debug_single_ray():
    params = IntegratorParams(assured_depth=2, max_bounces=8, mode="gpu",
                              debug_single_ray=True)
    ref, out = _compare(_sphere_scheme(), params)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_wavefront_large_pool_tiled_paths():
    """pool > 8192 exercises the tile-cond mesh-attr and cubemap-resolve
    branches; results must still match the classic loop."""
    w, h = 64, 32
    scheme, meshes = _textured(w, h)
    params = IntegratorParams(assured_depth=3, max_bounces=6, mode="gpu")
    ref, out = _compare(scheme, params, n_samples=2, meshes=meshes, pool=16384, wh=(w, h))
    # different fusion shapes perturb interpolated uvs by ~1 ulp, which
    # flips a handful of nearest-neighbor texel picks — allow a few
    # discrete per-pixel jumps but require distribution-level agreement
    bad = ~np.isclose(out, ref, rtol=1e-3, atol=1e-3)
    assert bad.mean() < 0.01, f"mismatch frac {bad.mean()}, max {np.abs(out - ref).max()}"
    np.testing.assert_allclose(out.mean(0), ref.mean(0), rtol=1e-3)


def test_wavefront_compaction_path():
    """pool >= 32768 exercises the mesh-shading compaction branch."""
    w, h = 64, 32
    scheme, meshes = _textured(w, h)
    params = IntegratorParams(assured_depth=3, max_bounces=6, mode="gpu")
    ref, out = _compare(scheme, params, n_samples=2, meshes=meshes, pool=32768, wh=(w, h))
    bad = ~np.isclose(out, ref, rtol=1e-3, atol=1e-3)
    assert bad.mean() < 0.01, f"mismatch frac {bad.mean()}, max {np.abs(out - ref).max()}"
    np.testing.assert_allclose(out.mean(0), ref.mean(0), rtol=1e-3)
