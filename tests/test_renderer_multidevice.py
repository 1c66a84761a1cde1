"""Multi-device execution of the kernel renderer branches: the
spp-sharded wrappers the Renderer builds around the fused (trace
kernel) driver and the wavefront driver with the mesh hit kernel —
renderer.py's `_multi_step` construction and call sites. Here they
execute on the virtual 8-CPU mesh with interpret-mode kernels at tiny
shapes and must agree with the single-device render (same sample-id
partition -> same streams, so images agree to f32 sum reassociation).
This includes a MESH scene through make_spp_sharded_step — cluster
tables, texel pools, and the wavefront queue machinery under shard_map
replication."""
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytrace.models import config as cfg
from raytrace.models import scene as scene_mod
from raytrace.models.gltf import LoadedMesh, Primitive
from raytrace.render.renderer import Renderer

W, H = 32, 32  # 1024 pixels -> the minimum 1024-lane pool


def _tiny_mesh(n_tris=24):
    """A little triangle fan in front of the camera."""
    rng = np.random.default_rng(3)
    th = np.linspace(0, 2 * np.pi, n_tris, endpoint=False)
    v0 = np.stack([np.cos(th), np.sin(th), -6.0 + 0.1 * np.sin(3 * th)], -1)
    e1 = np.stack([-0.4 * np.sin(th), 0.4 * np.cos(th), np.zeros_like(th)], -1)
    e2 = rng.normal(0, 0.2, (n_tris, 3)) + np.array([0, 0, 0.3])
    poses = np.concatenate([v0, v0 + e1, v0 + e2], 0).astype(np.float32)
    idx = np.stack([np.arange(n_tris), np.arange(n_tris) + n_tris,
                    np.arange(n_tris) + 2 * n_tris], 1).astype(np.int32)
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-9)
    norms = np.concatenate([n] * 3, 0).astype(np.float32)
    prim = Primitive(poses=poses, norms=norms, indices=idx,
                     rgb_factor=np.array([0.7, 0.5, 0.4], np.float32),
                     metal_factor=0.3, rough_factor=0.5)
    return LoadedMesh(primitives=[prim],
                      trans_mat=np.eye(4, dtype=np.float32))


def _mesh_scheme():
    raw = {
        "render_info": {
            "width": W, "height": H, "samps_per_pix": 8,
            "kd_tree_depth": 17,
            "rad_info": {
                "debug_single_ray": False, "dir_light_samp": False,
                "russ_roull_info": {"assured_depth": 2, "max_thres": 0.5},
            },
            "use_gpu": True,
        },
        "cam": {"d": [0, 0, -4.0], "o": [0, 0, 0], "up": [0, 1, 0],
                "view_eulers": [0, 0, 0],
                "screen_width": 6.0, "screen_height": 6.0},
        "scene_members": [
            cfg.Tagged("Sphere", {
                "c": [1.8, 1.8, -6.0], "r": 1.5,
                "coloring": cfg.Tagged("Solid", [0, 0, 0]),
                "mat": {"divert_ray": "Diff", "emissive": [4, 4, 4]},
            }),
        ],
    }
    return cfg.parse_scheme(raw)


def _build_mesh_scene(scheme):
    return scene_mod.build_scene(scheme, meshes=[_tiny_mesh()])


def _render(scheme, scene, devices, **kw):
    r = Renderer(scheme, scene=scene, devices=devices, interpret=True, **kw)
    return r, r.render(samples=8, batch=8, progress=False)


@pytest.mark.parametrize("hit", ["triton", "clusters"])
def test_mesh_multidevice_matches_single(hit):
    """The wavefront `_multi_step` branch (renderer.py) on a mesh scene,
    8-CPU mesh vs single device — with the hit kernel (interpret mode)
    and with the XLA cluster cull."""
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must force 8 CPU devices"
    scheme = _mesh_scheme()
    scene = _build_mesh_scene(scheme)
    r1, img1 = _render(scheme, scene, [devs[0]], hit=hit)
    assert r1.driver == "wavefront" and r1.hit == hit and r1.n_devices == 1
    r8, img8 = _render(scheme, scene, devs[:8], hit=hit)
    assert r8.driver == "wavefront" and r8.n_devices == 8
    assert r8._mesh1d is not None and r8._multi_step is not None
    assert img1.mean() > 0.01  # actually rendered something
    np.testing.assert_allclose(img8, img1, rtol=2e-4, atol=2e-5)


def test_fused_multidevice_matches_single():
    """The meshless fused `_multi_step` branch (trace kernel driver)
    on the 8-CPU mesh vs single-device."""
    from __graft_entry__ import _inline_walled_scheme

    devs = jax.devices()
    scheme = _inline_walled_scheme(W, H, assured=2)
    r1 = Renderer(scheme, devices=[devs[0]], driver="fused", interpret=True,
                  samples_per_dispatch=1)
    assert r1.driver == "fused"
    img1 = r1.render(samples=8, batch=8, progress=False)
    r8 = Renderer(scheme, devices=devs[:8], driver="fused", interpret=True,
                  samples_per_dispatch=1)
    assert r8.driver == "fused" and r8._mesh1d is not None
    img8 = r8.render(samples=8, batch=8, progress=False)
    assert img1.mean() > 0.01
    np.testing.assert_allclose(img8, img1, rtol=2e-4, atol=2e-5)
