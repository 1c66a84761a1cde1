"""Golden statistical regressions: the counter-based RNG makes a
fixed-sample render DETERMINISTIC, so channel means of reference
schemes are exact regression anchors (recorded from verified renders
that match the reference's committed images — see README Performance
and the walled-vs-reference comparison).

Re-blessed (round 2) for the weyl GENERATOR family + the redundant-
normalize removals: gated by tests/test_reference_images.py passing
unchanged against the reference's committed PNGs before re-recording.
(These anchors are change-detectors for OUR history; reference-drift
detection lives in test_reference_images.py.)"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytrace.models.config import load_scheme
from raytrace.models.camera import build_camera
from raytrace.models.scene import build_scene
from raytrace.render.integrator import IntegratorParams
from raytrace.render.renderer import camera_to_arrays, sample_batch

REFERENCE = os.environ.get(  # a checkout of the reference renderer
    "RAYTRACE_REFERENCE",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "reference"),
)
SCHEMES = os.path.join(REFERENCE, "schemes")


def _render_mean(scheme_name, scale, spp, **params_kw):
    path = os.path.join(SCHEMES, scheme_name)
    if not os.path.exists(path):
        pytest.skip("reference schemes unavailable")
    scheme = load_scheme(path)
    W = scheme.render_info.width // scale
    H = scheme.render_info.height // scale
    scene = build_scene(scheme)
    cam = camera_to_arrays(build_camera(scheme.cam, W, H))
    rr = scheme.render_info.rad_info.russ_roull_info
    params = IntegratorParams(
        assured_depth=rr.assured_depth, max_thres=jnp.float32(rr.max_thres), **params_kw
    )
    flat = np.arange(W * H, dtype=np.int32)
    xs = jnp.asarray(flat % W)
    ys = jnp.asarray(flat // W)
    out = sample_batch(scene, cam, params, W, H, xs, ys, jnp.int32(0), jnp.int32(spp))
    return np.asarray(out).mean(axis=0) / spp


def test_walled_golden():
    mean = _render_mean("walled.yml", 6, 16)
    # recorded from the verified build whose full-res render matches
    # the reference's committed 20000-spp PNG to <0.01/255 per channel
    np.testing.assert_allclose(
        mean, [0.461905, 0.339789, 0.480856], rtol=1e-4, atol=1e-4
    )


def test_spaceship_golden():
    mean = _render_mean("spaceship_r1.yml", 6, 4)
    np.testing.assert_allclose(
        mean, [0.137068, 0.140051, 0.146816], rtol=1e-4, atol=1e-4
    )


def test_biplane_golden():
    # full textured-mesh path: base-color + normal-map + metal-rough
    # sampling, per-triangle tangent-space transforms (pr/model.rs /
    # mesh/triangle.rs semantics)
    mean = _render_mean("biplane.yml", 12, 2)
    np.testing.assert_allclose(
        mean, [0.503101, 0.576065, 0.639112], rtol=1e-4, atol=1e-4
    )


def test_outside_spheres_golden():
    # cubemap (skybox) miss path: recorded from the verified render
    # whose full-scheme smoke matched the reference's look
    mean = _render_mean("outside_spheres.yml", 8, 8)
    np.testing.assert_allclose(
        mean, [0.47284, 0.513581, 0.554102], rtol=1e-4, atol=1e-4
    )
