"""Seeded procedural scenes (models/procedural.py): the reference
scene classes at their published triangle counts, built in memory."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytrace.models import procedural
from raytrace.models.scene import build_scene


def test_surface_scene_counts():
    scheme, meshes = procedural.surface_scene(32, 16, 1, n_textures=4, tex_size=16)
    scene = build_scene(scheme, meshes=meshes)
    assert scene.n_mesh_tris == procedural.A380_TRIS == 127_749
    assert len(meshes[0].primitives) == 4
    assert scene.has_rgb_tex and not scene.has_norm_tex and not scene.has_mr_tex
    # every triangle lands in exactly one cluster
    ids = np.asarray(scene.cl_idx)
    assert np.array_equal(np.sort(ids[ids >= 0]), np.arange(scene.n_mesh_tris))
    assert np.asarray(scene.tex_pool).dtype == np.uint32  # packed u8 texels
    assert np.asarray(scene.tex_pool).size == 4 * 16 * 16
    assert scene.n_spheres == 1 and not scene.has_cubemap


def test_textured_scene_counts_and_sky():
    scheme, meshes = procedural.textured_scene(32, 16, 1, tex_size=32, sky_size=8)
    scene = build_scene(scheme, meshes=meshes)
    assert scene.n_mesh_tris == procedural.BIPLANE_TRIS == 7_316
    assert scene.has_rgb_tex and scene.has_norm_tex and scene.has_mr_tex
    # the four side faces are one in-memory array, pooled once
    assert scene.has_cubemap and np.asarray(scene.sky_pool).size == 3 * 8 * 8
    np.testing.assert_array_equal(np.asarray(scene.cm_dims), np.full((6, 2), 8))
    # the same seed builds the same scene
    scheme2, meshes2 = procedural.textured_scene(32, 16, 1, tex_size=32, sky_size=8)
    again = build_scene(scheme2, meshes=meshes2)
    np.testing.assert_array_equal(np.asarray(again.tex_pool), np.asarray(scene.tex_pool))
