"""Differentiable-rendering checks (the north star's grad harness).

With our deterministic counter-based RNG, a fixed-sample render is an
exact deterministic function of the scene parameters, so:
* appearance parameters (emissive, rgb) enter (multi)linearly —
  finite differences must match autodiff tightly;
* geometry parameters carry pointwise gradients only through
  angle-dependent weights (dielectric fresnel re, PBR reflectance):
  a Dielectric sphere must produce nonzero center/radius grads
  (visibility/silhouette terms need edge sampling — documented
  limitation, SURVEY.md §7.3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import os, sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytrace.models import config as cfg
from raytrace.models.camera import build_camera
from raytrace.models.scene import build_scene
from raytrace.render.integrator import IntegratorParams
from raytrace.render.renderer import camera_to_arrays, sample_batch

W, H = 48, 24


def _scheme():
    raw = {
        "render_info": {
            "width": W, "height": H, "samps_per_pix": 2,
            "kd_tree_depth": 0,
            "rad_info": {
                "debug_single_ray": False, "dir_light_samp": False,
                "russ_roull_info": {"assured_depth": 2, "max_thres": 0.5},
            },
            "use_gpu": True,
        },
        "cam": {
            "d": [0, 0, -5], "o": [0, 0, 0], "up": [0, 1, 0],
            "view_eulers": [0, 0, 0],
            "screen_width": 8.0, "screen_height": 4.0,
        },
        "scene_members": [
            cfg.Tagged("Sphere", {
                "c": [0, 0, -10], "r": 2.5,
                "coloring": cfg.Tagged("Solid", [1.0, 1.0, 1.0]),
                "mat": {"divert_ray": cfg.Tagged("Dielectric", {"n_out": 1.0, "n_in": 1.3})},
            }),
            cfg.Tagged("Sphere", {
                "c": [-4, 1, -9], "r": 1.0,
                "coloring": cfg.Tagged("Solid", [0.8, 0.4, 0.4]),
                "mat": {"divert_ray": "Diff"},
            }),
            cfg.Tagged("Sphere", {
                "c": [0, 7, -10], "r": 3.0,
                "coloring": cfg.Tagged("Solid", [0, 0, 0]),
                "mat": {"divert_ray": "Diff", "emissive": [4.0, 4.0, 4.0]},
            }),
        ],
    }
    return cfg.parse_scheme(raw)


@pytest.fixture(scope="module")
def setup():
    scheme = _scheme()
    scene = build_scene(scheme)
    cam = camera_to_arrays(build_camera(scheme.cam, W, H))
    params = IntegratorParams(assured_depth=2, max_bounces=6, differentiable=True)
    flat = np.arange(W * H, dtype=np.int32)
    xs = jnp.asarray(flat % W)
    ys = jnp.asarray(flat // W)

    def render(scene_):
        return sample_batch(scene_, cam, params, W, H, xs, ys, jnp.int32(0), 2)

    return scheme, scene, render


def test_emissive_grad_matches_fd(setup):
    _, scene, render = setup

    def loss(em):
        return jnp.sum(render(scene.replace(sph_emissive=em)))

    g = np.asarray(jax.grad(loss)(scene.sph_emissive))
    # radiance is LINEAR in emissive -> central FD is exact
    eps = 1e-2
    em = np.asarray(scene.sph_emissive).copy()
    for comp in range(3):
        ep = em.copy(); ep[2, comp] += eps
        en = em.copy(); en[2, comp] -= eps
        fd = (float(loss(jnp.asarray(ep))) - float(loss(jnp.asarray(en)))) / (2 * eps)
        np.testing.assert_allclose(g[2, comp], fd, rtol=5e-3, atol=1e-2)


def test_rgb_grad_matches_fd(setup):
    _, scene, render = setup

    def loss(rgb):
        return jnp.sum(render(scene.replace(sph_rgb=rgb)))

    g = np.asarray(jax.grad(loss)(scene.sph_rgb))
    eps = 1e-3
    rgb = np.asarray(scene.sph_rgb).copy()
    ep = rgb.copy(); ep[1, 0] += eps
    en = rgb.copy(); en[1, 0] -= eps
    fd = (float(loss(jnp.asarray(ep))) - float(loss(jnp.asarray(en)))) / (2 * eps)
    np.testing.assert_allclose(g[1, 0], fd, rtol=2e-2, atol=5e-2)


def test_dielectric_geometry_grad_nonzero(setup):
    """The fresnel weight depends on the incidence angle, which depends
    on the sphere center/radius -> pointwise geometry grads. Uses CPU
    semantics: in gpu mode the reference dielectric always reflects
    with weight 1 on entry (trace.wgsl:570-576), which kills even this
    pointwise dependence; cpu mode's reflect weight is `re`
    (interaction.rs:55) — angle-dependent."""
    scheme, scene, _ = setup
    cam = camera_to_arrays(build_camera(scheme.cam, W, H))
    params = IntegratorParams(
        assured_depth=2, max_bounces=6, differentiable=True, mode="cpu"
    )
    flat = np.arange(W * H, dtype=np.int32)
    xs = jnp.asarray(flat % W)
    ys = jnp.asarray(flat // W)

    def render(scene_):
        return sample_batch(scene_, cam, params, W, H, xs, ys, jnp.int32(0), 2)

    def loss_c(c):
        return jnp.sum(render(scene.replace(sph_c=c)))

    gc = np.asarray(jax.grad(loss_c)(scene.sph_c))
    assert np.isfinite(gc).all()
    assert np.abs(gc[0]).max() > 0  # the dielectric sphere

    def loss_r(r):
        return jnp.sum(render(scene.replace(sph_r=r)))

    gr = np.asarray(jax.grad(loss_r)(scene.sph_r))
    assert np.isfinite(gr).all()
    assert abs(gr[0]) > 0


def test_camera_grad_finite(setup):
    scheme, scene, _ = setup
    cam = camera_to_arrays(build_camera(scheme.cam, W, H))
    params = IntegratorParams(assured_depth=2, max_bounces=6, differentiable=True)
    flat = np.arange(W * H, dtype=np.int32)
    xs = jnp.asarray(flat % W)
    ys = jnp.asarray(flat // W)

    def loss(cam_):
        return jnp.sum(sample_batch(scene, cam_, params, W, H, xs, ys, jnp.int32(0), 1))

    g = jax.grad(loss)(cam)
    assert np.isfinite(np.asarray(g.o)).all()
    assert np.isfinite(np.asarray(g.d)).all()
