"""Seeded procedural scenes: mesh scenes of the reference's scene
classes built in memory — no asset files, no downloads.

* `surface_scene` — the a380 class: a displaced-sphere surface
  triangulation with exactly 127,749 triangles (the a380 element count,
  reference README.md:173) split into 20 primitives, each with its own
  procedural 1024^2 u8 base-colour texture, lit by the a380 scheme's
  sun sphere under the a380 scheme's camera.
* `textured_scene` — the biplane class: a 7,316-triangle body (the
  biplane asset's count) with base-colour, normal and metal-roughness
  maps, under an in-memory cubemap sky, covering about a fifth of the
  frame.

Each returns (scheme, meshes); `models.scene.build_scene(scheme,
meshes=meshes)` packs them like glTF-loaded geometry.
"""
from __future__ import annotations

import numpy as np

from . import config as cfg
from .gltf import LoadedMesh, Primitive, TextureData

A380_TRIS = 127_749
BIPLANE_TRIS = 7_316


def _render_info(width, height, spp, assured=5):
    return {
        "width": width, "height": height, "samps_per_pix": spp,
        "kd_tree_depth": 17,
        "rad_info": {
            "debug_single_ray": False, "dir_light_samp": False,
            "russ_roull_info": {"assured_depth": assured, "max_thres": 0.5},
        },
        "use_gpu": True,
    }


def _grid_surface(nu: int, nv: int, radius):
    """Closed-in-u parametric surface: (nu*nv, 3) vertices from
    radius(U, V) -> xyz, (nu*nv, 2) uvs, and the 2*nu*(nv-1) triangles
    as (T, 3) vertex indices (quad-split, u wrapping around)."""
    uu = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    vv = np.linspace(0.05, np.pi - 0.05, nv)
    U, V = np.meshgrid(uu, vv, indexing="ij")  # (nu, nv)
    xyz = radius(U, V).reshape(nu * nv, 3)
    uv = np.stack([U / (2 * np.pi), V / np.pi], -1).reshape(nu * nv, 2)
    i = np.arange(nu)[:, None]
    j = np.arange(nv - 1)[None, :]
    a = i * nv + j
    b = ((i + 1) % nu) * nv + j
    quads_a = np.stack([a, b, a + 1], -1).reshape(-1, 3)
    quads_b = np.stack([b, b + 1, a + 1], -1).reshape(-1, 3)
    return xyz, uv, np.concatenate([quads_a, quads_b], 0)


def _texture(rng, size: int, base, amp) -> TextureData:
    """(size, size, 3) u8 texture: a few seeded sinusoid bands plus
    noise around `base` (per-channel). coords are filled by the
    caller."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.empty((size, size, 3), np.float32)
    for c in range(3):
        fx, fy = rng.uniform(2.0, 12.0, 2)
        ph = rng.uniform(0, 2 * np.pi)
        img[:, :, c] = base[c] + amp * np.sin(2 * np.pi * (fx * x + fy * y) + ph)
    img += rng.uniform(-0.05, 0.05, img.shape).astype(np.float32)
    raw = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    return TextureData(pixels=raw.astype(np.float32) / 255.0,
                       coords=np.zeros((0, 2), np.float32), pixels_raw=raw)


def _with_coords(tex: TextureData, coords) -> TextureData:
    return TextureData(pixels=tex.pixels, coords=coords.astype(np.float32),
                       pixels_raw=tex.pixels_raw)


def _primitive(xyz, uv, tris, **kw) -> Primitive:
    """Unshared-vertex primitive (three vertices per triangle) with
    face normals as vertex normals."""
    corners = xyz[tris]  # (T, 3, 3)
    n = np.cross(corners[:, 1] - corners[:, 0], corners[:, 2] - corners[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-9)
    t = tris.shape[0]
    poses = corners.transpose(1, 0, 2).reshape(3 * t, 3)
    idx = np.stack([np.arange(t), np.arange(t) + t, np.arange(t) + 2 * t], 1)
    coords = uv[tris].transpose(1, 0, 2).reshape(3 * t, 2)
    for key in ("rgb_tex", "norm_tex", "mr_tex"):
        if kw.get(key) is not None:
            kw[key] = _with_coords(kw[key], coords)
    return Primitive(poses=poses.astype(np.float32),
                     norms=np.concatenate([n] * 3, 0).astype(np.float32),
                     indices=idx.astype(np.int32), **kw)


def surface_mesh(n_tris: int = A380_TRIS, n_textures: int = 20,
                 tex_size: int = 1024, seed: int = 0) -> LoadedMesh:
    """a380-class surface: a flattened displaced sphere (an aircraft
    is a coherent surface mesh, which is what cluster AABBs need to
    stay tight) with exactly n_tris triangles in n_textures textured
    primitives."""
    rng = np.random.default_rng(seed)
    nu = 360
    nv = -(-n_tris // (2 * nu)) + 2

    def radius(U, V):
        r = 24.0 * (1.0 + 0.18 * np.sin(3 * U) * np.cos(2 * V)
                    + 0.08 * np.sin(7 * U + 1.3) * np.sin(5 * V))
        return np.stack([r * np.sin(V) * np.cos(U), 0.3 * r * np.cos(V),
                         r * np.sin(V) * np.sin(U)], -1)

    xyz, uv, tris = _grid_surface(nu, nv, radius)
    tris = tris[:n_tris]
    bounds = np.linspace(0, n_tris, max(1, n_textures) + 1).astype(np.int64)
    prims = []
    for p in range(len(bounds) - 1):
        part = tris[bounds[p]:bounds[p + 1]]
        tex = (_texture(rng, tex_size, rng.uniform(0.4, 0.7, 3), 0.25)
               if n_textures else None)
        prims.append(_primitive(
            xyz, uv, part, rgb_factor=np.array([0.7, 0.72, 0.75], np.float32),
            rgb_tex=tex, metal_factor=0.6, rough_factor=0.35,
        ))
    return LoadedMesh(primitives=prims, trans_mat=np.eye(4, dtype=np.float32))


def surface_scene(width: int = 1200, height: int = 600, spp: int = 8,
                  n_tris: int = A380_TRIS, n_textures: int = 20,
                  tex_size: int = 1024, seed: int = 0):
    """The a380 scheme's camera and sun over `surface_mesh`."""
    raw = {
        "render_info": _render_info(width, height, spp),
        "cam": {
            "d": [0, 0, 6], "up": [0, 1, 0], "view_eulers": [-0.6, 0.1, 0],
            "o": [0, -15, -30], "screen_width": 10.0, "screen_height": 5.0,
        },
        "scene_members": [
            cfg.Tagged("Sphere", {
                "c": [2500, 2200, -200], "r": 1200,
                "coloring": cfg.Tagged("Solid", [0, 0, 0]),
                "mat": {"divert_ray": "Diff", "emissive": [1.0, 1.0, 1.0]},
            }),
        ],
    }
    return cfg.parse_scheme(raw), [surface_mesh(n_tris, n_textures, tex_size, seed)]


def sky_faces(size: int = 256):
    """Six (size, size, 3) u8 cubemap faces in config face order
    (neg_z, pos_z, neg_x, pos_x, neg_y, pos_y): a bright zenith, sides
    graded from horizon to zenith, a dark ground."""
    t = np.linspace(0.0, 1.0, size, dtype=np.float32)[:, None, None]
    horizon = np.array([0.85, 0.80, 0.70], np.float32)
    zenith = np.array([0.45, 0.62, 0.95], np.float32)
    side = np.broadcast_to(horizon + (zenith - horizon) * t, (size, size, 3))
    flat = lambda rgb: np.broadcast_to(np.asarray(rgb, np.float32), (size, size, 3))
    to_u8 = lambda a: np.ascontiguousarray(np.round(a * 255.0).astype(np.uint8))
    side_u8 = to_u8(side)
    return [side_u8, side_u8, side_u8, side_u8,
            to_u8(flat([0.22, 0.2, 0.18])), to_u8(flat(zenith))]


def textured_mesh(tex_size: int = 1024, seed: int = 1) -> LoadedMesh:
    """Biplane-class body: an elongated displaced ellipsoid of
    2 * 62 * 59 = 7,316 triangles with base-colour, normal and
    metal-roughness maps (normal mapping through the base-colour
    uv frame, models/scene.py)."""
    rng = np.random.default_rng(seed)

    def radius(U, V):
        bump = 1.0 + 0.12 * np.sin(5 * U) * np.sin(3 * V)
        return np.stack([6.0 * bump * np.sin(V) * np.cos(U),
                         2.2 * bump * np.cos(V),
                         2.5 * bump * np.sin(V) * np.sin(U)], -1)

    xyz, uv, tris = _grid_surface(62, 60, radius)
    prim = _primitive(
        xyz, uv, tris,
        rgb_factor=np.array([0.9, 0.85, 0.8], np.float32),
        rgb_tex=_texture(rng, tex_size, (0.6, 0.4, 0.3), 0.25),
        norm_tex=_texture(rng, tex_size, (0.5, 0.5, 0.9), 0.08),
        norm_scale=1.0,
        mr_tex=_texture(rng, tex_size // 2, (0.5, 0.5, 0.5), 0.3),
        metal_factor=0.8, rough_factor=0.6,
    )
    return LoadedMesh(primitives=[prim], trans_mat=np.eye(4, dtype=np.float32))


def textured_scene(width: int = 1200, height: int = 600, spp: int = 8,
                   tex_size: int = 1024, sky_size: int = 256, seed: int = 1):
    """`textured_mesh` under an in-memory cubemap sky; the camera frames
    it at roughly a fifth of the image."""
    raw = {
        "render_info": _render_info(width, height, spp),
        "cam": {
            "d": [0, 0, 6], "o": [0, 0.5, -14], "up": [0, 1, 0],
            "view_eulers": [0, 0, 0],
            "screen_width": 10.0, "screen_height": 5.0,
        },
        "scene_members": [],
    }
    scheme = cfg.parse_scheme(raw)
    faces = sky_faces(sky_size)
    scheme.scene_members.append(cfg.CubeMapMember(*[
        cfg.CubeMapFace(path=f, u_scale=1.0, v_scale=1.0) for f in faces
    ]))
    return scheme, [textured_mesh(tex_size, seed)]
