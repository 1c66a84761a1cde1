"""SoA scene packing: YAML members -> flat device arrays.

This is the analogue of the reference's GPU scene
serialization (render/gpu_structs.rs): one struct-of-arrays layout for
spheres / free triangles / mesh triangles / cubemap / texture pool,
with no 1-GiB chunking (HBM + sharding replace the reference's 4-buffer
binding-limit scheme, gpu_utils.rs:87-156). Mesh triangles are fully
materialized (vertices gathered through the index buffer at build time,
per-triangle normal transforms precomputed exactly as the reference
does per-triangle at decompose time, mesh/triangle.rs:45-122).

All packing is host-side numpy; `SceneArrays` is a pytree dataclass of
jnp-convertible arrays plus static metadata, ready for jit.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..utils.pytree import pytree_dataclass, static_field
from . import gltf as gltf_mod
from .config import (
    CubeMapMember,
    FreeTriangleMember,
    Material,
    ModelMember,
    Scheme,
    SphereMember,
    resolve_asset_path,
)

# WGSL face-id packing order (trace.wgsl:1206)
_FACE_ATTRS = ("neg_z", "pos_z", "neg_x", "pos_x", "neg_y", "pos_y")


@pytree_dataclass
class SceneArrays:
    # --- spheres ---
    sph_c: Any  # (S, 3)
    sph_r: Any  # (S,)
    sph_rgb: Any  # (S, 3)
    sph_emissive: Any  # (S, 3)
    sph_has_em: Any  # (S,) bool
    sph_kind: Any  # (S,) i32: 0 Spec / 1 Diff / 2 DiffSpec / 3 Dielectric
    sph_diffp: Any  # (S,)
    sph_n_out: Any  # (S,)
    sph_n_in: Any  # (S,)
    sph_valid: Any  # (S,) bool
    # --- free triangles ---
    ft_v0: Any
    ft_e1: Any
    ft_e2: Any
    ft_norm: Any
    ft_rgb: Any
    ft_emissive: Any
    ft_has_em: Any
    ft_kind: Any
    ft_diffp: Any
    ft_n_out: Any
    ft_n_in: Any
    ft_valid: Any
    # --- mesh triangles ---
    mt_v0: Any
    mt_e1: Any
    mt_e2: Any
    mt_const_norm: Any  # (M, 3) shading normal when no normal map
    mt_nrm_mat: Any  # (M, 3, 3) tangent->world transform (normal maps)
    mt_norm_scale: Any  # (M,)
    mt_has_norm_map: Any  # (M,) bool
    mt_rgb_factor: Any  # (M, 3)
    mt_uv_rgb: Any  # (M, 3, 2)
    mt_uv_norm: Any
    mt_uv_mr: Any
    mt_rgb_tex: Any  # (M, 3) i32 [offset, w, h]; w=0 -> no texture
    mt_norm_tex: Any
    mt_mr_tex: Any
    mt_metal: Any  # (M,)
    mt_rough: Any  # (M,)
    mt_valid: Any  # (M,) bool
    # --- packed per-triangle attribute matrix: ONE row-gather per
    # bounce instead of ~40 scalar gathers (column layout in
    # integrator._MT_ATTR) ---
    mt_attr: Any  # (M, 48) f32
    mt_desc: Any  # (M, 9) i32: rgb/norm/mr texture [off, w, h]
    # --- mesh clusters (accel): cluster-major dense views ---
    cl_v0: Any  # (C, W, 3)
    cl_e1: Any
    cl_e2: Any
    cl_idx: Any  # (C, W) i32 global mesh-tri id, -1 pad
    cl_lo: Any  # (C, 3) cluster AABB
    cl_hi: Any
    # --- cubemap ---
    cm_offsets: Any  # (6,) i32
    cm_dims: Any  # (6, 2) i32 (w, h)
    cm_uv_scales: Any  # (6, 2) f32
    # --- texel pools: mesh textures and cubemap faces are SEPARATE
    # pools, so the sky resolve gathers from a small one. dtype
    # u32-packed/u16/f32 by source (see _TexPool). ---
    tex_pool: Any  # (T,) packed u32 (all-8-bit sources) | u16 | f32
    sky_pool: Any  # (S,) same dtype policy — the 6 cubemap faces
    # --- static metadata (not traced) ---
    n_spheres: int = static_field(0)
    n_free_tris: int = static_field(0)
    n_mesh_tris: int = static_field(0)
    has_cubemap: bool = static_field(False)
    any_textured: bool = static_field(False)
    # per-kind texture statics: gate each fetch site at trace time so
    # a texture kind absent from the WHOLE scene costs nothing
    has_rgb_tex: bool = static_field(False)
    has_norm_tex: bool = static_field(False)
    has_mr_tex: bool = static_field(False)
    n_clusters: int = static_field(0)

def _pad_to(n: int, mult: int) -> int:
    if n == 0:
        return 0
    return ((n + mult - 1) // mult) * mult


def _pad(arr: np.ndarray, n: int, fill=0.0) -> np.ndarray:
    if arr.shape[0] == n:
        return arr
    pad_shape = (n - arr.shape[0],) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)], axis=0)


def _mat_cols(mats: list):
    """Material list -> column arrays."""
    n = len(mats)
    em = np.zeros((n, 3), np.float32)
    has = np.zeros((n,), bool)
    kind = np.zeros((n,), np.int32)
    diffp = np.zeros((n,), np.float32)
    n_out = np.ones((n,), np.float32)
    n_in = np.ones((n,), np.float32)
    for i, m in enumerate(mats):
        if m.emissive is not None:
            em[i] = m.emissive
            has[i] = True
        kind[i] = m.kind
        diffp[i] = m.diffp
        n_out[i] = m.n_out
        n_in[i] = m.n_in
    return em, has, kind, diffp, n_out, n_in


class _TexPool:
    """Packs images into one flat RGB texel array, deduping by object
    identity (the loader caches per (gltf file, image index) so model
    instances share decodes).

    Pool dtype (finalize): when EVERY image came with integer source
    texels (pixels_raw from the loader), the pool stays integer — one
    PACKED u32 word per texel (R | G<<8 | B<<16) when all sources are
    8-bit, else u16 (8-bit sources upscale by x*257, bit-exact:
    (x*257)f32/65535.0 == (x)f32/255.0 for all x, verified in tests).
    Consumers unpack/divide after the gather, so results are
    bit-identical to an f32 pool; the integer forms move fewer bytes
    per random texel fetch, and the packed form needs one gather per
    texel instead of three.
    Any float-typed source forces f32."""

    def __init__(self):
        self.chunks: list = []  # (f32 flat, raw flat | None, raw dtype)
        self.offsets: dict = {}
        self.cursor = 0

    def add(self, pixels: np.ndarray, raw: Optional[np.ndarray] = None):
        key = id(pixels)
        if key in self.offsets:
            return self.offsets[key]
        h, w = pixels.shape[:2]
        flat = np.ascontiguousarray(pixels[:, :, :3], dtype=np.float32).reshape(-1)
        flat_raw = None
        if raw is not None and raw.dtype in (np.uint8, np.uint16):
            flat_raw = np.ascontiguousarray(raw[:, :, :3]).reshape(-1)
            assert flat_raw.size == flat.size, (flat_raw.size, flat.size)
        entry = (self.cursor, w, h)
        self.offsets[key] = entry
        self.chunks.append((flat, flat_raw))
        self.cursor += flat.size
        return entry

    def finalize(self) -> np.ndarray:
        if not self.chunks:
            return np.zeros((1,), np.uint32)
        if all(r is not None for _, r in self.chunks):
            if all(r.dtype == np.uint8 for _, r in self.chunks):
                # all-8-bit sources: ONE u32 word per texel
                # (R | G<<8 | B<<16), one random gather per fetch.
                # Byte values are untouched, so the unpack + /255 in
                # the consumers stays bit-identical to the f32 build.
                flat = np.concatenate([r for _, r in self.chunks])
                return (
                    flat[0::3].astype(np.uint32)
                    | (flat[1::3].astype(np.uint32) << np.uint32(8))
                    | (flat[2::3].astype(np.uint32) << np.uint32(16))
                )
            return np.concatenate([
                r.astype(np.uint16) * np.uint16(257) if r.dtype == np.uint8
                else r
                for _, r in self.chunks
            ])
        return np.concatenate([f for f, _ in self.chunks])


def pool_texels_to_f32(vals):
    """Gathered pool texels -> f32 in [0,1]. Integer pools divide by
    their full-scale constant AFTER the gather — bit-identical to the
    all-f32 build (the loader's own u8->f32 conversion is the same
    x/255.0 in f32; (x*257)/65535.0 == x/255.0 bitwise for u16-upcast
    u8 sources). Works on jnp and np arrays. Packed-u32 pools never
    reach here — their fetch sites unpack the word themselves
    (integrator._fetch_rgb / ops.texture.sample_nearest)."""
    import jax.numpy as jnp

    assert vals.dtype != jnp.uint32, "packed pools unpack at the fetch site"
    if vals.dtype == jnp.uint8:
        return vals.astype(jnp.float32) / np.float32(255.0)
    if vals.dtype == jnp.uint16:
        return vals.astype(jnp.float32) / np.float32(65535.0)
    return vals


def pool_to_f32_flat(pool):
    """FULL texel pool -> flat (3N,) f32 RGB values in [0,1] — the
    shape/values an all-f32 build would store, bitwise. Used by the
    diff tier (parallel.distributed.split_diff_scene) so texture
    gradients flow through a float pool, and by pool bit-identity
    tests. Works on np arrays AND under jit tracing (the train step
    calls it on a traced scene), so packed u32 pools unpack with the
    operand's own array namespace."""
    import jax.numpy as jnp

    xp = np if isinstance(pool, np.ndarray) else jnp
    if pool.dtype == np.uint32:
        r = (pool & xp.uint32(0xFF)).astype(xp.float32)
        g = ((pool >> xp.uint32(8)) & xp.uint32(0xFF)).astype(xp.float32)
        b = ((pool >> xp.uint32(16)) & xp.uint32(0xFF)).astype(xp.float32)
        # stack+reshape interleaves to the f32 build's RGBRGB... order
        return xp.stack([r, g, b], axis=-1).reshape(-1) / xp.float32(255.0)
    if pool.dtype in (np.uint8, np.uint16):
        return pool_texels_to_f32(pool)
    return pool.astype(xp.float32)


def _normalize_rows(a: np.ndarray, eps: float = 1e-20) -> np.ndarray:
    n = np.linalg.norm(a, axis=-1, keepdims=True)
    return a / np.maximum(n, eps)


def _mesh_triangle_arrays(meshes: list, pool: _TexPool):
    """Flatten LoadedMesh primitives to per-triangle SoA, reproducing
    NormFromMesh::generate_norm_type (mesh/triangle.rs:45-122):

    * trans_mat3 = (world^-1)^T upper 3x3 — the normal transform;
    * with a normal map + explicit tangents: tangent frame
      [normalize-cols(trans_mat3 @ [sum-tangents, tan x face_norm, 0])
       with column 2 replaced by the world-space face normal];
    * with a normal map + no tangents: UV-derived frame from the
      *base-color* texcoords (triangle.rs:85-122), falling back to
      trans_mat3 when UVs are singular or absent;
    * no normal map: trans_mat3, and the shading normal
      normalize(trans_mat3 @ (n0+n1+n2)) is a per-triangle constant
      (the reference sums the three vertex normals WITHOUT barycentric
      weights, triangle.rs:149-153 == trace.wgsl:956-957) so it is
      precomputed here.
    """
    cols = {
        "v0": [], "v1": [], "v2": [], "const_norm": [], "nrm_mat": [],
        "norm_scale": [], "has_norm_map": [], "rgb_factor": [],
        "uv_rgb": [], "uv_norm": [], "uv_mr": [],
        "rgb_tex": [], "norm_tex": [], "mr_tex": [],
        "metal": [], "rough": [],
    }

    for lm in meshes:
        trans_mat3 = np.linalg.inv(lm.trans_mat.astype(np.float64)).T[:3, :3].astype(np.float32)
        for prim in lm.primitives:
            idx = prim.indices  # (T, 3)
            T = idx.shape[0]
            if T == 0:
                continue
            v = prim.poses[idx]  # (T, 3, 3)
            v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
            face_norm = _normalize_rows(np.cross(v1 - v0, v2 - v0))

            nsum = prim.norms[idx].sum(axis=1)  # (T, 3) local vertex-normal sum

            has_nm = prim.norm_tex is not None
            if not has_nm:
                nmat = np.broadcast_to(trans_mat3, (T, 3, 3)).copy()
                const_norm = _normalize_rows(nsum @ trans_mat3.T)
            else:
                const_norm = face_norm.copy()
                if prim.tangents is not None:
                    tan = _normalize_rows(prim.tangents[idx].sum(axis=1))
                    bitan = np.cross(tan, face_norm)
                    m = np.zeros((T, 3, 3), np.float32)
                    m[:, :, 0] = tan
                    m[:, :, 1] = bitan
                    m = np.einsum("ab,tbc->tac", trans_mat3, m)
                    m[:, :, 2] = face_norm
                    nmat = m / np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-20)
                elif prim.rgb_tex is not None:
                    uv = prim.rgb_tex.coords[idx]  # (T, 3, 2)
                    t1 = uv[:, 1] - uv[:, 0]
                    t2 = uv[:, 2] - uv[:, 0]
                    det = t1[:, 0] * t2[:, 1] - t1[:, 1] * t2[:, 0]
                    ok = np.abs(det) > 1e-12
                    inv_det = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
                    e1 = v1 - v0
                    e2 = v2 - v0
                    # [T B] = [e1 e2] @ inv([[t1u, t2u],[t1v, t2v]])
                    tcol = (e1 * t2[:, 1:2] - e2 * t1[:, 1:2]) * inv_det[:, None]
                    bcol = (e2 * t1[:, 0:1] - e1 * t2[:, 0:1]) * inv_det[:, None]
                    m = np.zeros((T, 3, 3), np.float32)
                    m[:, :, 0] = _normalize_rows(tcol)
                    m[:, :, 1] = _normalize_rows(bcol)
                    m = np.einsum("ab,tbc->tac", trans_mat3, m)
                    m[:, :, 2] = face_norm
                    m = m / np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-20)
                    nmat = np.where(ok[:, None, None], m, trans_mat3[None])
                else:
                    nmat = np.broadcast_to(trans_mat3, (T, 3, 3)).copy()

            def tex_entry(tex):
                if tex is None:
                    return (0, 0, 0), np.zeros((T, 3, 2), np.float32)
                off, w, h = pool.add(tex.pixels, raw=tex.pixels_raw)
                return (off, w, h), tex.coords[idx].astype(np.float32)

            rgb_entry, uv_rgb = tex_entry(prim.rgb_tex)
            norm_entry, uv_norm = tex_entry(prim.norm_tex)
            mr_entry, uv_mr = tex_entry(prim.mr_tex)

            cols["v0"].append(v0)
            cols["v1"].append(v1)
            cols["v2"].append(v2)
            cols["const_norm"].append(const_norm)
            cols["nrm_mat"].append(nmat.astype(np.float32))
            cols["norm_scale"].append(np.full((T,), prim.norm_scale, np.float32))
            cols["has_norm_map"].append(np.full((T,), has_nm, bool))
            cols["rgb_factor"].append(np.broadcast_to(prim.rgb_factor, (T, 3)).copy())
            cols["uv_rgb"].append(uv_rgb)
            cols["uv_norm"].append(uv_norm)
            cols["uv_mr"].append(uv_mr)
            cols["rgb_tex"].append(np.broadcast_to(np.array(rgb_entry, np.int32), (T, 3)).copy())
            cols["norm_tex"].append(np.broadcast_to(np.array(norm_entry, np.int32), (T, 3)).copy())
            cols["mr_tex"].append(np.broadcast_to(np.array(mr_entry, np.int32), (T, 3)).copy())
            cols["metal"].append(np.full((T,), prim.metal_factor, np.float32))
            cols["rough"].append(np.full((T,), prim.rough_factor, np.float32))

    if not cols["v0"]:
        return None
    return {k: np.concatenate(vs, axis=0) for k, vs in cols.items()}


def build_scene(scheme: Scheme, pad_mult: int = 2048, pad_small: int = 8,
                meshes: Optional[list] = None) -> SceneArrays:
    """Members -> SceneArrays (the extract_concrete_types analogue,
    builder/inner.rs:68-110). pad_mult sizes the mesh-triangle arrays
    (must match the integrator's chunk size); pad_small sizes the
    sphere/free-triangle arrays (kept tight — every padded row is a
    wasted intersection test each bounce). meshes: already-built
    gltf.LoadedMesh objects (procedural geometry) packed after the
    scheme's Model members."""
    spheres: list = []
    free_tris: list = []
    model_meshes: list = []
    cubemap: Optional[CubeMapMember] = None

    for m in scheme.scene_members:
        if isinstance(m, SphereMember):
            spheres.append(m)
        elif isinstance(m, FreeTriangleMember):
            free_tris.append(m)
        elif isinstance(m, CubeMapMember):
            cubemap = m  # reference keeps a vec but only ever has one
        elif isinstance(m, ModelMember):
            path = resolve_asset_path(m.path, scheme.scheme_dir)
            model_meshes.extend(
                gltf_mod.load_model(path, m.translation, m.uniform_scale, m.euler_angles)
            )
        else:
            raise TypeError(f"unknown member {m!r}")

    pool = _TexPool()
    sky = _TexPool()  # cubemap faces get their own (small) pool

    cm_offsets = np.zeros((6,), np.int32)
    cm_dims = np.zeros((6, 2), np.int32)
    cm_uv_scales = np.ones((6, 2), np.float32)
    if cubemap is not None:
        face_cache: dict = {}  # repeated faces share one decode
        for i, attr in enumerate(_FACE_ATTRS):
            face = getattr(cubemap, attr)
            if isinstance(face.path, np.ndarray):
                # in-memory (H, W, 3) u8 face
                key = id(face.path)
                if key not in face_cache:
                    raw = np.ascontiguousarray(face.path[:, :, :3], dtype=np.uint8)
                    face_cache[key] = (raw.astype(np.float32) / 255.0, raw)
            else:
                key = resolve_asset_path(face.path, scheme.scheme_dir)
                if key not in face_cache:
                    from PIL import Image

                    raw = np.asarray(Image.open(key).convert("RGB"), dtype=np.uint8)
                    face_cache[key] = (raw.astype(np.float32) / 255.0, raw)
            img, raw = face_cache[key]
            off, w, h = sky.add(img, raw=raw)
            cm_offsets[i] = off
            cm_dims[i] = (w, h)
            cm_uv_scales[i] = (face.u_scale, face.v_scale)

    # --- spheres ---
    S = len(spheres)
    sph_c = np.stack([s.c for s in spheres]) if S else np.zeros((0, 3), np.float32)
    sph_r = np.array([s.r for s in spheres], np.float32)
    sph_rgb = np.stack([s.rgb for s in spheres]) if S else np.zeros((0, 3), np.float32)
    sph_mat = _mat_cols([s.mat for s in spheres])

    # --- free triangles (norm normalized at build, inner.rs:48) ---
    F = len(free_tris)
    if F:
        ft_verts = np.stack([t.verts for t in free_tris])  # (F, 3, 3)
        ft_norm = _normalize_rows(np.stack([t.norm for t in free_tris]))
        ft_rgb = np.stack([t.rgb for t in free_tris])
    else:
        ft_verts = np.zeros((0, 3, 3), np.float32)
        ft_norm = np.zeros((0, 3), np.float32)
        ft_rgb = np.zeros((0, 3), np.float32)
    ft_mat = _mat_cols([t.mat for t in free_tris])

    # --- mesh triangles ---
    mt = _mesh_triangle_arrays(model_meshes + list(meshes or []), pool)

    tex_pool = pool.finalize()
    sky_pool = sky.finalize()

    Sp = _pad_to(S, pad_small)
    Fp = _pad_to(F, pad_small)

    def padm(cols, n):
        em, has, kind, diffp, n_out, n_in = cols
        return (
            _pad(em, n), _pad(has, n), _pad(kind, n),
            _pad(diffp, n), _pad(n_out, n, 1.0), _pad(n_in, n, 1.0),
        )

    sph_mat = padm(sph_mat, Sp)
    ft_mat = padm(ft_mat, Fp)

    M = mt["v0"].shape[0] if mt else 0
    Mp = _pad_to(M, pad_mult)

    kw = dict(
        sph_c=_pad(sph_c.astype(np.float32), Sp),
        sph_r=_pad(sph_r, Sp),
        sph_rgb=_pad(sph_rgb.astype(np.float32), Sp),
        sph_emissive=sph_mat[0], sph_has_em=sph_mat[1], sph_kind=sph_mat[2],
        sph_diffp=sph_mat[3], sph_n_out=sph_mat[4], sph_n_in=sph_mat[5],
        sph_valid=_pad(np.ones((S,), bool), Sp),
        ft_v0=_pad(ft_verts[:, 0].astype(np.float32), Fp),
        ft_e1=_pad((ft_verts[:, 1] - ft_verts[:, 0]).astype(np.float32), Fp),
        ft_e2=_pad((ft_verts[:, 2] - ft_verts[:, 0]).astype(np.float32), Fp),
        ft_norm=_pad(ft_norm.astype(np.float32), Fp),
        ft_rgb=_pad(ft_rgb.astype(np.float32), Fp),
        ft_emissive=ft_mat[0], ft_has_em=ft_mat[1], ft_kind=ft_mat[2],
        ft_diffp=ft_mat[3], ft_n_out=ft_mat[4], ft_n_in=ft_mat[5],
        ft_valid=_pad(np.ones((F,), bool), Fp),
        cm_offsets=cm_offsets,
        cm_dims=cm_dims,
        cm_uv_scales=cm_uv_scales,
        tex_pool=tex_pool,
        sky_pool=sky_pool,
        n_spheres=S,
        n_free_tris=F,
        n_mesh_tris=M,
        has_cubemap=cubemap is not None,
    )

    if mt:
        # acceleration clusters over the ORIGINAL (unpadded) triangles:
        # cluster-major dense copies so the culled nearest-hit paths
        # need no per-lane gathers (the replacement for the KD
        # traversal the reference never finished on GPU,
        # trace.wgsl:664-667 stub / README.md:151-154)
        from ..accel.builder import build_clusters_bvh

        v0, v1, v2 = mt["v0"], mt["v1"], mt["v2"]
        lo3 = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
        hi3 = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
        cp, cl_lo, cl_hi = build_clusters_bvh(lo3, hi3, leaf_target=64)
        safe = np.maximum(cp, 0)
        kw.update(
            cl_v0=v0[safe].astype(np.float32),
            cl_e1=(v1 - v0)[safe].astype(np.float32),
            cl_e2=(v2 - v0)[safe].astype(np.float32),
            cl_idx=cp.astype(np.int32),
            cl_lo=cl_lo,
            cl_hi=cl_hi,
            n_clusters=int(cp.shape[0]),
        )

        has_rgb = bool((mt["rgb_tex"][:, 1] > 0).any())
        has_norm = bool((mt["norm_tex"][:, 1] > 0).any())
        has_mr = bool((mt["mr_tex"][:, 1] > 0).any())
        any_tex = has_rgb or has_norm or has_mr
        kw.update(has_rgb_tex=has_rgb, has_norm_tex=has_norm,
                  has_mr_tex=has_mr)
        # packed attribute matrix (see integrator._MT_ATTR for layout)
        attr = np.zeros((M, 48), np.float32)
        attr[:, 0:3] = mt["const_norm"]
        attr[:, 3:12] = mt["nrm_mat"].reshape(M, 9)
        attr[:, 12] = mt["norm_scale"]
        attr[:, 13:16] = mt["rgb_factor"]
        attr[:, 16] = mt["metal"]
        attr[:, 17] = mt["rough"]
        attr[:, 18] = mt["has_norm_map"].astype(np.float32)
        attr[:, 19:25] = mt["uv_rgb"].reshape(M, 6)
        attr[:, 25:31] = mt["uv_norm"].reshape(M, 6)
        attr[:, 31:37] = mt["uv_mr"].reshape(M, 6)
        desc = np.concatenate(
            [mt["rgb_tex"], mt["norm_tex"], mt["mr_tex"]], axis=1
        ).astype(np.int32)
        # texture descriptors also ride bitcast in cols 38:47 — one row
        # gather instead of two in the shading hot path (bit-exact:
        # offsets exceed f32's 2^24 integer range so a numeric cast
        # would corrupt them, a bitcast cannot)
        attr[:, 38:47] = desc.view(np.float32)
        kw.update(
            mt_attr=_pad(attr, Mp),
            mt_desc=_pad(desc, Mp),
        )
        kw.update(
            mt_v0=_pad(mt["v0"].astype(np.float32), Mp),
            mt_e1=_pad((mt["v1"] - mt["v0"]).astype(np.float32), Mp),
            mt_e2=_pad((mt["v2"] - mt["v0"]).astype(np.float32), Mp),
            mt_const_norm=_pad(mt["const_norm"].astype(np.float32), Mp),
            mt_nrm_mat=_pad(mt["nrm_mat"], Mp),
            mt_norm_scale=_pad(mt["norm_scale"], Mp),
            mt_has_norm_map=_pad(mt["has_norm_map"], Mp),
            mt_rgb_factor=_pad(mt["rgb_factor"].astype(np.float32), Mp),
            mt_uv_rgb=_pad(mt["uv_rgb"], Mp),
            mt_uv_norm=_pad(mt["uv_norm"], Mp),
            mt_uv_mr=_pad(mt["uv_mr"], Mp),
            mt_rgb_tex=_pad(mt["rgb_tex"], Mp),
            mt_norm_tex=_pad(mt["norm_tex"], Mp),
            mt_mr_tex=_pad(mt["mr_tex"], Mp),
            mt_metal=_pad(mt["metal"], Mp),
            mt_rough=_pad(mt["rough"], Mp),
            mt_valid=_pad(np.ones((M,), bool), Mp),
            any_textured=any_tex,
        )
    else:
        z3 = np.zeros((0, 3), np.float32)
        kw.update(
            mt_attr=np.zeros((0, 48), np.float32),
            mt_desc=np.zeros((0, 9), np.int32),
            cl_v0=np.zeros((0, 8, 3), np.float32),
            cl_e1=np.zeros((0, 8, 3), np.float32),
            cl_e2=np.zeros((0, 8, 3), np.float32),
            cl_idx=np.zeros((0, 8), np.int32),
            cl_lo=z3, cl_hi=z3,
            mt_v0=z3, mt_e1=z3, mt_e2=z3, mt_const_norm=z3,
            mt_nrm_mat=np.zeros((0, 3, 3), np.float32),
            mt_norm_scale=np.zeros((0,), np.float32),
            mt_has_norm_map=np.zeros((0,), bool),
            mt_rgb_factor=z3,
            mt_uv_rgb=np.zeros((0, 3, 2), np.float32),
            mt_uv_norm=np.zeros((0, 3, 2), np.float32),
            mt_uv_mr=np.zeros((0, 3, 2), np.float32),
            mt_rgb_tex=np.zeros((0, 3), np.int32),
            mt_norm_tex=np.zeros((0, 3), np.int32),
            mt_mr_tex=np.zeros((0, 3), np.int32),
            mt_metal=np.zeros((0,), np.float32),
            mt_rough=np.zeros((0,), np.float32),
            mt_valid=np.zeros((0,), bool),
            any_textured=False,
        )

    return SceneArrays(**kw)
