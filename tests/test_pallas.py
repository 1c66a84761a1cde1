"""Fused trace kernel (Pallas, Triton route) vs the XLA integrator:
identical RNG streams and draw budget mean the two paths must agree up
to float reassociation. Runs in Pallas interpret mode on CPU."""
import jax.numpy as jnp
import numpy as np
import pytest

import sys, os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from __graft_entry__ import _inline_walled_scheme
from raytrace.models.camera import build_camera
from raytrace.models.scene import build_scene
from raytrace.ops.pallas import trace_kernel as tk
from raytrace.render.integrator import IntegratorParams
from raytrace.render.policy import fused_supported
from raytrace.render.renderer import (
    camera_to_arrays,
    sample_batch,
    sample_batch_fused,
)

W, H = 128, 64  # 8192 pixels = 64 kernel blocks


@pytest.fixture(scope="module")
def setup():
    scheme = _inline_walled_scheme(W, H, assured=3)
    scene = build_scene(scheme)
    cam = build_camera(scheme.cam, W, H)
    cam_arrays = camera_to_arrays(cam)
    params = IntegratorParams(assured_depth=3, max_bounces=12)
    return scheme, scene, cam, cam_arrays, params


def test_supports(setup):
    _, scene, _, _, params = setup
    assert fused_supported(scene, params)
    assert not fused_supported(scene, params.replace(mode="cpu"))
    assert not fused_supported(scene, params.replace(differentiable=True))


def test_fused_matches_xla(setup):
    _, scene, cam, cam_arrays, params = setup
    n_pix = W * H
    flat = np.arange(n_pix, dtype=np.int32)
    x_idx = jnp.asarray(flat % W)
    y_idx = jnp.asarray(flat // W)

    ref = np.asarray(
        sample_batch(scene, cam_arrays, params, W, H, x_idx, y_idx, jnp.int32(0), jnp.int32(2))
    )

    sph_t, ft_t = tk.pack_scene_tables(scene)
    cam_vec = jnp.asarray(tk.make_cam_vec(cam))
    xs2d, ys2d = x_idx, y_idx
    rep2d = jnp.zeros((n_pix,), jnp.int32)

    out = sample_batch_fused(
        (jnp.asarray(sph_t), jnp.asarray(ft_t)), cam_vec, scene, params,
        W, H, xs2d, ys2d, rep2d, jnp.int32(0), jnp.int32(2),
        samples_per_dispatch=1, interpret=True,
    )
    out = np.asarray(out)

    assert np.isfinite(out).all()
    # identical streams -> near-identical radiance
    mismatch = np.abs(out - ref) / (np.abs(ref) + 1e-3)
    frac_bad = (mismatch > 1e-3).mean()
    assert frac_bad < 0.01, f"{frac_bad:.4f} of lanes differ; max rel {mismatch.max()}"


def test_fused_spd_replicas(setup):
    """samples_per_dispatch packs replicas; total must equal the sum of
    the individual samples."""
    _, scene, cam, cam_arrays, params = setup
    n_pix = (W * H) // 2  # 4096 pixels x 2 reps = one tile
    flat = np.arange(n_pix, dtype=np.int32)
    x_idx = jnp.asarray(flat % W)
    y_idx = jnp.asarray(flat // W)

    r0 = np.asarray(sample_batch(scene, cam_arrays, params, W, H, x_idx, y_idx, jnp.int32(0), jnp.int32(1)))
    r1 = np.asarray(sample_batch(scene, cam_arrays, params, W, H, x_idx, y_idx, jnp.int32(1), jnp.int32(1)))
    ref = r0 + r1

    sph_t, ft_t = tk.pack_scene_tables(scene)
    cam_vec = jnp.asarray(tk.make_cam_vec(cam))
    lane = np.arange(n_pix * 2)
    lane_pix = lane % n_pix
    rep = lane // n_pix
    xs2d = jnp.asarray((lane_pix % W).astype(np.int32))
    ys2d = jnp.asarray((lane_pix // W).astype(np.int32))
    rep2d = jnp.asarray(rep.astype(np.int32))

    out = sample_batch_fused(
        (jnp.asarray(sph_t), jnp.asarray(ft_t)), cam_vec, scene, params,
        W, H, xs2d, ys2d, rep2d, jnp.int32(0), jnp.int32(2),
        samples_per_dispatch=2, interpret=True,
    )
    out = np.asarray(out)
    mismatch = np.abs(out - ref) / (np.abs(ref) + 1e-3)
    assert (mismatch > 1e-3).mean() < 0.01


def test_fused_samples_per_lane(setup):
    """In-kernel sample regeneration (samples_per_lane > 1) must equal
    the sum of the individual single-sample launches."""
    _, scene, cam, cam_arrays, params = setup
    n_pix = W * H
    flat = np.arange(n_pix, dtype=np.int32)
    x_idx = jnp.asarray(flat % W)
    y_idx = jnp.asarray(flat // W)
    xs2d, ys2d = x_idx, y_idx
    rep2d = jnp.zeros((n_pix,), jnp.int32)

    sph_t, ft_t = tk.pack_scene_tables(scene)
    tables = (jnp.asarray(sph_t), jnp.asarray(ft_t))
    cam_vec = jnp.asarray(tk.make_cam_vec(cam))

    ref = sum(
        np.asarray(
            sample_batch_fused(
                tables, cam_vec, scene, params, W, H,
                xs2d, ys2d, rep2d, jnp.int32(k), jnp.int32(1),
                samples_per_dispatch=1, interpret=True,
            )
        )
        for k in range(4)
    )
    out = np.asarray(
        sample_batch_fused(
            tables, cam_vec, scene, params, W, H,
            xs2d, ys2d, rep2d, jnp.int32(0), jnp.int32(4),
            samples_per_dispatch=4, samples_per_lane=4, interpret=True,
        )
    )
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_hints_specialization_matches_permissive(setup):
    """SceneHints must be a pure op-count optimization: the specialized
    kernel's radiance equals the unspecialized kernel's bitwise (the
    select chains it deletes are identities; walled exercises emissive,
    DiffSpec, and uniform-dielectric paths)."""
    _, scene, cam, cam_arrays, params = setup
    n_pix = W * H
    flat = np.arange(n_pix, dtype=np.int32)
    xs2d = jnp.asarray(flat % W)
    ys2d = jnp.asarray(flat // W)
    rep2d = jnp.zeros((n_pix,), jnp.int32)

    sph_t, ft_t = tk.pack_scene_tables(scene)
    hints = tk.scene_static_hints(sph_t, ft_t, scene.n_spheres, scene.n_free_tris)
    # walled: one DiffSpec value, one dielectric (n_out, n_in), emissives
    assert hints.uni_diffp is not None
    assert hints.uni_n not in (None, (1.0, 1.0))
    assert hints.any_em and hints.any_refr and hints.any_ds
    assert hints.sph_fd[1] > 0  # emissive prims sorted late

    tables = (jnp.asarray(sph_t), jnp.asarray(ft_t))
    cam_vec = jnp.asarray(tk.make_cam_vec(cam))
    base = np.asarray(
        sample_batch_fused(
            tables, cam_vec, scene, params, W, H,
            xs2d, ys2d, rep2d, jnp.int32(0), jnp.int32(2),
            samples_per_dispatch=1, interpret=True,
        )
    )
    spec = np.asarray(
        sample_batch_fused(
            tables, cam_vec, scene, params, W, H,
            xs2d, ys2d, rep2d, jnp.int32(0), jnp.int32(2),
            samples_per_dispatch=1, hints=hints, interpret=True,
        )
    )
    np.testing.assert_array_equal(spec, base)


def test_hints_mixed_sphere_freetri():
    """Hint machinery on a scene with BOTH kinds (track_kind path),
    non-uniform diffp and dielectric constants (select chains stay
    live), and emissive triangles: specialized == permissive bitwise,
    and both match the XLA integrator."""
    from raytrace.models import config as cfg

    def sphere(c, r, rgb, mat):
        return cfg.Tagged("Sphere", {"c": c, "r": r, "coloring": cfg.Tagged("Solid", rgb), "mat": mat})

    def tri(verts, norm, rgb, mat):
        return cfg.Tagged("FreeTriangle", {"verts": verts, "norm": norm, "rgb": rgb, "mat": mat})

    members = [
        # two dielectrics with DIFFERENT n -> uni_n is None
        sphere([0.0, 0.0, -6.0], 1.0, [0.9, 0.9, 0.9],
               {"divert_ray": cfg.Tagged("Dielectric", {"n_out": 1.0, "n_in": 1.5})}),
        sphere([2.5, 0.0, -7.0], 1.0, [0.9, 0.6, 0.6],
               {"divert_ray": cfg.Tagged("Dielectric", {"n_out": 1.0, "n_in": 1.2})}),
        sphere([0.0, 6.0, -8.0], 2.0, [0, 0, 0], {"divert_ray": "Diff", "emissive": [8, 8, 8]}),
        # two DiffSpecs with DIFFERENT diffp -> uni_diffp is None
        tri([[-4, -2, -9], [4, -2, -9], [0, -2, -1]], [0, 1, 0], [0.7, 0.7, 0.3],
            {"divert_ray": cfg.Tagged("DiffSpec", {"diffp": 0.4})}),
        tri([[-4, 2, -9], [4, 2, -9], [0, 3, -4]], [0, -1, 0], [0.3, 0.7, 0.7],
            {"divert_ray": cfg.Tagged("DiffSpec", {"diffp": 0.8})}),
        # emissive triangle (gpu semantics honor it, trace.wgsl:489-490)
        tri([[-1, -1, -3], [1, -1, -3], [0, 1, -3]], [0, 0, 1], [1, 1, 1],
            {"divert_ray": "Spec", "emissive": [2, 2, 2]}),
    ]
    raw_scheme = _inline_walled_scheme(64, 32, assured=2)
    raw_scheme.scene_members = [cfg._parse_member(m) for m in members]
    scene = build_scene(raw_scheme)
    cam = build_camera(raw_scheme.cam, 64, 32)
    params = IntegratorParams(assured_depth=2, max_bounces=8)
    assert fused_supported(scene, params)

    sph_t, ft_t = tk.pack_scene_tables(scene)
    hints = tk.scene_static_hints(sph_t, ft_t, scene.n_spheres, scene.n_free_tris)
    assert hints.uni_diffp is None and hints.uni_n is None
    assert hints.any_em and hints.any_refr and hints.any_ds

    n_pix = 64 * 32
    flat = np.arange(n_pix, dtype=np.int32)
    xs2d = jnp.asarray(flat % 64)
    ys2d = jnp.asarray(flat // 64)
    rep2d = jnp.zeros((n_pix,), jnp.int32)
    tables = (jnp.asarray(sph_t), jnp.asarray(ft_t))
    cam_vec = jnp.asarray(tk.make_cam_vec(cam))

    base = np.asarray(sample_batch_fused(
        tables, cam_vec, scene, params, 64, 32,
        xs2d, ys2d, rep2d, jnp.int32(0), jnp.int32(2), samples_per_dispatch=1, interpret=True))
    spec = np.asarray(sample_batch_fused(
        tables, cam_vec, scene, params, 64, 32,
        xs2d, ys2d, rep2d, jnp.int32(0), jnp.int32(2), samples_per_dispatch=1, interpret=True,
        hints=hints))
    np.testing.assert_array_equal(spec, base)

    cam_arrays = camera_to_arrays(cam)
    ref = np.asarray(sample_batch(
        scene, cam_arrays, params, 64, 32,
        jnp.asarray(flat % 64), jnp.asarray(flat // 64), jnp.int32(0), jnp.int32(2)))
    mismatch = np.abs(spec - ref) / (np.abs(ref) + 1e-3)
    assert (mismatch > 1e-3).mean() < 0.01
