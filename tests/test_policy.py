"""The platform policy (render/policy.py): which forward driver and
which mesh nearest-hit implementation a render gets, per platform and
scene, and the Renderer's exposure of that choice."""
import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from __graft_entry__ import _inline_walled_scheme
from raytrace.models import procedural
from raytrace.models.scene import build_scene
from raytrace.render import policy
from raytrace.render.integrator import IntegratorParams
from raytrace.render.renderer import Renderer


@pytest.fixture(scope="module")
def scenes():
    walled = build_scene(_inline_walled_scheme(32, 16))
    scheme, meshes = procedural.textured_scene(32, 16, 1, tex_size=16, sky_size=8)
    return walled, build_scene(scheme, meshes=meshes)


@pytest.mark.parametrize("platform, mesh, want", [
    ("cpu", False, ("wavefront", "none")),
    ("cpu", True, ("wavefront", "clusters")),
    ("gpu", False, ("fused", "none")),
    ("gpu", True, ("wavefront", "triton")),
])
def test_policy_by_platform(scenes, platform, mesh, want):
    scene = scenes[1] if mesh else scenes[0]
    assert tuple(policy.choose(platform, scene, IntegratorParams())) == want


def test_policy_semantics_and_gradients(scenes):
    walled, textured = scenes
    # cpu semantics: no fused kernel, but the hit kernel applies
    cpu_mode = IntegratorParams(mode="cpu")
    assert policy.choose("gpu", walled, cpu_mode).driver == "wavefront"
    assert policy.choose("gpu", textured, cpu_mode).hit == "triton"
    # differentiable renders: the plain integrator with the XLA walk
    diff = IntegratorParams(differentiable=True)
    assert tuple(policy.choose("gpu", walled, diff)) == ("plain", "none")
    assert tuple(policy.choose("gpu", textured, diff)) == ("plain", "clusters")


def test_renderer_exposes_choice_cpu(scenes):
    r = Renderer(_inline_walled_scheme(32, 16), devices=jax.devices()[:1])
    assert (r.driver, r.hit) == ("wavefront", "none")
    scheme, meshes = procedural.textured_scene(32, 16, 1, tex_size=16, sky_size=8)
    r = Renderer(scheme, scene=scenes[1], devices=jax.devices()[:1])
    assert (r.driver, r.hit) == ("wavefront", "clusters")
    assert r.params.mesh_hit == "clusters" and not r.params.interpret


def test_renderer_gpu_stub_device(scenes):
    """A device whose platform reads "gpu" gets the kernels — and the
    policy never turns on interpret mode."""
    stub = SimpleNamespace(platform="gpu", device_kind="stub")
    r = Renderer(_inline_walled_scheme(32, 16), devices=[stub])
    assert (r.driver, r.hit) == ("fused", "none") and not r.interpret
    scheme, _ = procedural.textured_scene(32, 16, 1, tex_size=16, sky_size=8)
    r = Renderer(scheme, scene=scenes[1], devices=[stub])
    assert (r.driver, r.hit) == ("wavefront", "triton")
    assert r.params.mesh_hit == "triton" and not r.params.interpret


def test_renderer_rejects_uncovered_fused(scenes):
    scheme, _ = procedural.textured_scene(32, 16, 1, tex_size=16, sky_size=8)
    with pytest.raises(ValueError):
        Renderer(scheme, scene=scenes[1], devices=jax.devices()[:1], driver="fused")


def test_fused_renderer_padding():
    """The fused driver pads the pixel lanes to the kernel block and
    packs one replica per sample on cubemap-free scenes."""
    from raytrace.ops.pallas import trace_kernel as tk

    stub = SimpleNamespace(platform="gpu", device_kind="stub")
    r = Renderer(_inline_walled_scheme(30, 10), devices=[stub], samples_per_dispatch=8)
    n = r._fxs.shape[0]
    assert n % tk.BLOCK == 0 and n >= 300 and r._fspl == 8
    assert np.asarray(r._frep).max() == 0
    sph, ft = r._tables
    assert sph.shape == (16, 16) and ft.shape == (1, 32)  # 13 spheres -> 16 rows
