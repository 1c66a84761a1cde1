"""Cluster-culled mesh traversal == brute force, on the procedural
biplane-class scene (7,316 triangles, textured, cubemap sky):
identical RNG streams mean the culled and brute-force paths must
produce identical radiance."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytrace.models import procedural
from raytrace.models.camera import build_camera
from raytrace.models.scene import build_scene
from raytrace.render.integrator import IntegratorParams
from raytrace.render.renderer import camera_to_arrays, sample_batch

W, H = 64, 32


@pytest.fixture(scope="module")
def setup():
    scheme, meshes = procedural.textured_scene(W, H, 2, tex_size=64, sky_size=16)
    scene = build_scene(scheme, meshes=meshes)
    cam = camera_to_arrays(build_camera(scheme.cam, W, H))
    flat = np.arange(W * H, dtype=np.int32)
    xs = jnp.asarray(flat % W)
    ys = jnp.asarray(flat // W)
    return scene, cam, xs, ys


def test_scene_has_clusters(setup):
    scene, *_ = setup
    assert scene.n_clusters > 10
    # every original triangle id appears in some cluster
    ids = np.asarray(scene.cl_idx)
    ids = ids[ids >= 0]
    assert np.unique(ids).size == scene.n_mesh_tris


def test_culled_matches_brute(setup):
    scene, cam, xs, ys = setup
    base = IntegratorParams(assured_depth=3, max_bounces=8)
    p_cull = base.replace(mesh_hit="clusters", ray_tile=1024)
    p_brute = base.replace(mesh_hit="brute")
    out_c = np.asarray(sample_batch(scene, cam, p_cull, W, H, xs, ys, jnp.int32(0), jnp.int32(2)))
    out_b = np.asarray(sample_batch(scene, cam, p_brute, W, H, xs, ys, jnp.int32(0), jnp.int32(2)))
    assert np.isfinite(out_c).all()
    # same streams, same nearest hits -> identical radiance
    mismatch = np.abs(out_c - out_b) / (np.abs(out_b) + 1e-3)
    assert (mismatch > 1e-3).mean() < 0.005, f"max rel {mismatch.max()}"


def test_culled_matches_brute_cpu_mode(setup):
    scene, cam, xs, ys = setup
    base = IntegratorParams(assured_depth=3, max_bounces=8, mode="cpu")
    p_cull = base.replace(mesh_hit="clusters", ray_tile=1024)
    p_brute = base.replace(mesh_hit="brute")
    out_c = np.asarray(sample_batch(scene, cam, p_cull, W, H, xs, ys, jnp.int32(0), jnp.int32(1)))
    out_b = np.asarray(sample_batch(scene, cam, p_brute, W, H, xs, ys, jnp.int32(0), jnp.int32(1)))
    mismatch = np.abs(out_c - out_b) / (np.abs(out_b) + 1e-3)
    assert (mismatch > 1e-3).mean() < 0.005
