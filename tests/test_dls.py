"""Direct-light-sampling semantics vs hand-computed closed forms
(radiance.rs:89-120): the 1/(30*pi) magnitude, the self-emitter and
bounce-element omission rules, and shadow-ray occlusion — driven
through _bounce_step with crafted lane state so every term is exact.
Also: the wavefront driver now supports DLS (one-bounce-lookahead
state rides the lane pool) and must match trace_paths."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytrace.models import config as cfg
from raytrace.models.camera import build_camera
from raytrace.models.scene import build_scene
from raytrace.ops.vec import Vec3
from raytrace.render.integrator import (
    DLS_NORMZE, IntegratorParams, _bounce_step,
)
from raytrace.render.renderer import camera_to_arrays, sample_batch

W, H = 32, 16


def _scheme(with_occluder=False):
    members = [
        # 0: the diffuse target sphere
        cfg.Tagged("Sphere", {
            "c": [0.0, 0.0, -10.0], "r": 2.0,
            "coloring": cfg.Tagged("Solid", [0.5, 0.5, 0.5]),
            "mat": {"divert_ray": "Diff"},
        }),
        # 1: the emitter (the only DLSEmitter kind, sphere.rs:55-62)
        cfg.Tagged("Sphere", {
            "c": [0.0, 20.0, -10.0], "r": 1.0,
            "coloring": cfg.Tagged("Solid", [0.0, 0.0, 0.0]),
            "mat": {"divert_ray": "Diff", "emissive": [3.0, 4.0, 5.0]},
        }),
    ]
    if with_occluder:
        members.append(cfg.Tagged("Sphere", {
            "c": [0.0, 10.0, -10.0], "r": 1.0,
            "coloring": cfg.Tagged("Solid", [0.1, 0.1, 0.1]),
            "mat": {"divert_ray": "Diff"},
        }))
    raw = {
        "render_info": {
            "width": W, "height": H, "samps_per_pix": 1, "kd_tree_depth": 0,
            "rad_info": {
                "debug_single_ray": False, "dir_light_samp": True,
                "russ_roull_info": {"assured_depth": 2, "max_thres": 0.5},
            },
            "use_gpu": False,
        },
        "cam": {
            "d": [0, 0, -5], "o": [0, 0, 0], "up": [0, 1, 0],
            "view_eulers": [0, 0, 0],
            "screen_width": 8.0, "screen_height": 4.0,
        },
        "scene_members": members,
    }
    return cfg.parse_scheme(raw)


def _crafted_state(n, dls_pos, dls_norm, dls_ci, self_idx, rd):
    zeros = jnp.zeros((n,))
    ones = jnp.ones((n,))
    c3 = lambda v: Vec3(ones * v[0], ones * v[1], ones * v[2])
    return dict(
        ro=c3([0.0, 0.0, 0.0]),
        rd=c3(rd),
        L=Vec3(zeros, zeros, zeros),
        ci=Vec3(ones, ones, ones),
        inten=ones,
        rng=jnp.full((n,), 12345, jnp.uint32),
        active=jnp.zeros((n,), bool),  # only the pending DLS resolves
        bounce=jnp.ones((n,), jnp.int32),
        dls=dict(
            active=jnp.ones((n,), bool),
            pos=c3(dls_pos),
            norm=c3(dls_norm),
            ci=c3(dls_ci),
            self_idx=jnp.full((n,), self_idx, jnp.int32),
        ),
    )


def _run(scheme, st):
    scene = build_scene(scheme)
    params = IntegratorParams(
        mode="cpu", dir_light_samp=True, assured_depth=2, max_bounces=8
    )
    out = _bounce_step(scene, params, st)
    return np.asarray(out["L"].to_array())


# the crafted pending hit: top of the target sphere, normal +y,
# emitter straight up -> light_dot = 1, unobstructed
POS = [0.0, 2.0 + 1e-4, -10.0]
NRM = [0.0, 1.0, 0.0]
CI = [0.25, 0.5, 1.0]
AWAY = [1.0, 0.0, 0.0]  # this bounce's ray hits nothing


def test_dls_magnitude_closed_form():
    """contribution = ci * emissive * light_dot / (30*pi) exactly
    (radiance.rs:90: light_dot * emissive / (30*pi), weighted by the
    path throughput at the diffuse hit)."""
    st = _crafted_state(4, POS, NRM, CI, self_idx=0, rd=AWAY)
    L = _run(_scheme(), st)
    expected = np.array(CI) * np.array([3.0, 4.0, 5.0]) * (1.0 * DLS_NORMZE)
    np.testing.assert_allclose(L, np.tile(expected, (4, 1)), rtol=1e-5)


def test_dls_self_emitter_omitted():
    """An emitter never lights itself (radiance.rs:46-48: skip when the
    emitter IS the element that produced the pending hit)."""
    st = _crafted_state(4, POS, NRM, CI, self_idx=1, rd=AWAY)
    L = _run(_scheme(), st)
    np.testing.assert_allclose(L, 0.0, atol=0)


def test_dls_bounce_element_omitted():
    """The element hit by the CONTINUED ray is omitted from the emitter
    sum (radiance.rs:49-52) — its emissive already arrives through the
    bounce itself."""
    toward_emitter = [0.0, 1.0, -0.5]
    d = np.array(toward_emitter) / np.linalg.norm(toward_emitter)
    # aim the current bounce ray from the pending position at the
    # emitter so closest_hit resolves to it
    st = _crafted_state(4, POS, NRM, CI, self_idx=0, rd=AWAY)
    st["ro"] = st["dls"]["pos"]
    ones = jnp.ones((4,))
    # direction from POS to the emitter center
    to_e = np.array([0.0, 20.0, -10.0]) - np.array(POS)
    to_e /= np.linalg.norm(to_e)
    st["rd"] = Vec3(ones * to_e[0], ones * to_e[1], ones * to_e[2])
    L = _run(_scheme(), st)
    np.testing.assert_allclose(L, 0.0, atol=0)


def test_dls_shadow_ray_occluded():
    """An occluder between the hit and the emitter kills the term
    (the shadow ray's nearest hit must BE the emitter,
    radiance.rs:103-113)."""
    st = _crafted_state(4, POS, NRM, CI, self_idx=0, rd=AWAY)
    L = _run(_scheme(with_occluder=True), st)
    np.testing.assert_allclose(L, 0.0, atol=0)


def test_dls_light_dot_scaling():
    """Tilted normal scales the term by d_l . n exactly."""
    tilt = np.array([3.0, 4.0, 0.0]) / 5.0  # unit
    st = _crafted_state(4, POS, list(tilt), CI, self_idx=0, rd=AWAY)
    L = _run(_scheme(), st)
    light_dot = tilt[1]  # d_l = +y
    expected = np.array(CI) * np.array([3.0, 4.0, 5.0]) * (light_dot * DLS_NORMZE)
    np.testing.assert_allclose(L, np.tile(expected, (4, 1)), rtol=1e-5)


def test_wavefront_dls_matches_trace_paths():
    """The wavefront driver's DLS (lookahead state in the lane pool)
    reproduces the classic driver's radiance on a cpu-mode DLS scene."""
    from functools import partial
    from raytrace.render import wavefront as wf

    scheme = _scheme()
    scene = build_scene(scheme)
    cam = camera_to_arrays(build_camera(scheme.cam, W, H))
    params = IntegratorParams(
        mode="cpu", dir_light_samp=True, assured_depth=2, max_bounces=8
    )
    from raytrace.render.policy import choose

    assert choose("cpu", scene, params).driver == "wavefront"
    flat = np.arange(W * H, dtype=np.int32)
    xs = jnp.asarray(flat % W)
    ys = jnp.asarray(flat // W)
    ref = np.asarray(
        sample_batch(scene, cam, params, W, H, xs, ys, jnp.int32(0), jnp.int32(2))
    )
    out = np.asarray(
        wf.wavefront_batch(
            scene, cam, params, xs, ys, jnp.int32(0), jnp.int32(2),
            width=W, height=H, pool=512,
        )
    )
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
