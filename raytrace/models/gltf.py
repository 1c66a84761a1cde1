"""Minimal-but-complete glTF 2.0 loader reproducing what the reference
extracts (builder/pr/model.rs:19-134): recursive node walk with
accumulated transforms, per-primitive world-space positions, local
normals/tangents, triangle indices, base-color factor+texture,
normal map+scale, metallic-roughness factors+map — each texture decoded
to float32 RGB in [0,1] ("Rgb32F", model.rs:151-207).

No external glTF dependency is available in this image, so this parses
the JSON + binary buffers directly (covers .gltf with external/URI-data
buffers and .glb containers; accessor types SCALAR/VEC2/VEC3/VEC4 with
all component types used by real exporters).
"""
from __future__ import annotations

import base64
import json
import os
import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


@dataclass
class TextureData:
    pixels: np.ndarray  # (H, W, 3) float32 in [0,1]
    coords: np.ndarray  # (V, 2) float32 per-vertex uv
    # undivided integer texels ((H, W, 3) u8/u16) when the source image
    # is integer-typed — lets the scene packer build a compact pool
    pixels_raw: Optional[np.ndarray] = None


@dataclass
class Primitive:
    """One glTF primitive == one entry of the reference Mesh SoA
    (elements/mesh/mesh.rs:10-25)."""

    poses: np.ndarray  # (V, 3) WORLD-space positions (model.rs:85-90)
    norms: np.ndarray  # (V, 3) LOCAL-space normals
    indices: np.ndarray  # (T, 3) int32
    rgb_factor: np.ndarray  # (3,)
    rgb_tex: Optional[TextureData] = None
    norm_scale: float = 1.0
    norm_tex: Optional[TextureData] = None
    tangents: Optional[np.ndarray] = None  # (V, 3) local
    metal_factor: float = 1.0
    rough_factor: float = 1.0
    mr_tex: Optional[TextureData] = None


@dataclass
class LoadedMesh:
    """One glTF mesh node instance: primitives + its world matrix."""

    primitives: list
    trans_mat: np.ndarray  # (4, 4) full accumulated world transform


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], dtype=np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "translation" in node:
        t = np.eye(4)
        t[:3, 3] = node["translation"]
        m = m @ t
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.eye(4)
        r[:3, :3] = _quat_to_mat(x, y, z, w)
        m = m @ r
    if "scale" in node:
        s = np.eye(4)
        s[0, 0], s[1, 1], s[2, 2] = node["scale"]
        m = m @ s
    return m


def _quat_to_mat(x, y, z, w):
    n = np.sqrt(x * x + y * y + z * z + w * w)
    if n > 0:
        x, y, z, w = x / n, y / n, z / n, w / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


_IMAGE_CACHE: dict = {}  # (abs gltf path, image idx) -> (f32, raw|None)


class GltfFile:
    def __init__(self, path: str):
        self.dir = os.path.dirname(os.path.abspath(path))
        # decoded-image cache key; file-backed models share decodes
        # process-wide so N instances of one asset pool each texture once
        self.cache_key = os.path.abspath(path) if os.path.exists(path) else None
        with open(path, "rb") as f:
            head = f.read(4)
            f.seek(0)
            if head == b"glTF":  # .glb container
                data = f.read()
                self.doc, self.glb_bin = self._parse_glb(data)
            else:
                self.doc = json.load(f)
                self.glb_bin = None
        self.buffers = [self._load_buffer(b) for b in self.doc.get("buffers", [])]
        self._image_cache: dict = {}

    @staticmethod
    def _parse_glb(data: bytes):
        magic, version, _length = struct.unpack_from("<4sII", data, 0)
        assert magic == b"glTF" and version == 2, "bad glb"
        off = 12
        doc, binchunk = None, None
        while off < len(data):
            clen, ctype = struct.unpack_from("<II", data, off)
            chunk = data[off + 8 : off + 8 + clen]
            if ctype == 0x4E4F534A:  # JSON
                doc = json.loads(chunk.decode("utf-8"))
            elif ctype == 0x004E4942:  # BIN
                binchunk = chunk
            off += 8 + clen
        return doc, binchunk

    def _load_buffer(self, buf: dict) -> bytes:
        uri = buf.get("uri")
        if uri is None:
            assert self.glb_bin is not None, "glTF buffer with no uri outside glb"
            return self.glb_bin
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        p = os.path.join(self.dir, uri)
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"glTF buffer {uri!r} missing next to {self.dir} (asset snapshot incomplete?)"
            )
        with open(p, "rb") as f:
            return f.read()

    def accessor(self, idx: int) -> np.ndarray:
        acc = self.doc["accessors"][idx]
        count = acc["count"]
        ncomp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        itemsize = np.dtype(dtype).itemsize * ncomp
        if "bufferView" not in acc:
            out = np.zeros((count, ncomp), dtype=dtype)
        else:
            bv = self.doc["bufferViews"][acc["bufferView"]]
            data = self.buffers[bv["buffer"]]
            start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride") or itemsize
            if stride == itemsize:
                out = np.frombuffer(data, dtype=dtype, count=count * ncomp, offset=start)
                out = out.reshape(count, ncomp).copy()
            else:
                raw = np.frombuffer(data, dtype=np.uint8)
                rows = np.stack(
                    [raw[start + i * stride : start + i * stride + itemsize] for i in range(count)]
                )
                out = rows.view(dtype).reshape(count, ncomp).copy()
        # sparse accessors (rare) — apply substitutions
        sp = acc.get("sparse")
        if sp:
            sidx = self._sparse_indices(sp)
            svals = self._sparse_values(sp, ncomp, dtype)
            out[sidx] = svals
        if acc["type"] == "SCALAR":
            return out[:, 0]
        return out

    def _sparse_indices(self, sp):
        si = sp["indices"]
        bv = self.doc["bufferViews"][si["bufferView"]]
        dtype = _COMPONENT_DTYPES[si["componentType"]]
        data = self.buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0) + si.get("byteOffset", 0)
        return np.frombuffer(data, dtype=dtype, count=sp["count"], offset=start).astype(np.int64)

    def _sparse_values(self, sp, ncomp, dtype):
        sv = sp["values"]
        bv = self.doc["bufferViews"][sv["bufferView"]]
        data = self.buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0) + sv.get("byteOffset", 0)
        return (
            np.frombuffer(data, dtype=dtype, count=sp["count"] * ncomp, offset=start)
            .reshape(sp["count"], ncomp)
        )

    def image_rgb32f(self, image_idx: int) -> np.ndarray:
        """Decode image to (H, W, 3) float32 in [0,1] — the reference's
        to_rgb32f conversion (model.rs:203-205 via the image crate:
        u8 -> f32/255, u16 -> f32/65535, luma replicated)."""
        return self._image_pair(image_idx)[0]

    def image_raw(self, image_idx: int):
        """The undivided integer texels ((H, W, 3) u8 or u16) when the
        source image is integer-typed, else None. Lets the scene packer
        store a 4x/2x smaller texel pool whose gather-time x/255
        (x/65535) conversion is bit-exact with the f32 build (random
        texel fetches move fewer bytes)."""
        return self._image_pair(image_idx)[1]

    def _image_pair(self, image_idx: int):
        # cache is module-global keyed by (file, index): composite
        # scenes instancing one model N times decode AND pool each
        # texture once (the pool dedups by array identity)
        key = (self.cache_key, image_idx)
        if key in _IMAGE_CACHE:
            return _IMAGE_CACHE[key]
        if image_idx in self._image_cache:
            return self._image_cache[image_idx]
        from PIL import Image  # only glTF texture decoding needs Pillow

        img = self.doc["images"][image_idx]
        if "uri" in img and not img["uri"].startswith("data:"):
            pil = Image.open(os.path.join(self.dir, img["uri"]))
        else:
            if "uri" in img:
                raw = base64.b64decode(img["uri"].split(",", 1)[1])
            else:
                bv = self.doc["bufferViews"][img["bufferView"]]
                data = self.buffers[bv["buffer"]]
                s = bv.get("byteOffset", 0)
                raw = data[s : s + bv["byteLength"]]
            import io

            pil = Image.open(io.BytesIO(raw))
        arr0 = np.asarray(pil)
        if arr0.ndim == 2:
            arr0 = np.repeat(arr0[:, :, None], 3, axis=2)
        arr0 = arr0[:, :, :3]
        raw3 = None
        if arr0.dtype == np.uint8:
            raw3 = np.ascontiguousarray(arr0)
            arr = arr0.astype(np.float32) / 255.0
        elif arr0.dtype == np.uint16:
            raw3 = np.ascontiguousarray(arr0)
            arr = arr0.astype(np.float32) / 65535.0
        else:
            arr = arr0.astype(np.float32)
        pair = (arr, raw3)
        if self.cache_key is not None:
            _IMAGE_CACHE[key] = pair
        else:
            self._image_cache[image_idx] = pair
        return pair

    def _tex_image_idx(self, texture_idx: int) -> int:
        return self.doc["textures"][texture_idx]["source"]


def load_model(path: str, translation, uniform_scale: float, euler_angles) -> list:
    """Load a glTF model the way the reference does (model.rs:19-53):
    root transform = T(translation) @ S(uniform_scale) @ R(eulers),
    composed with each node's transform down the tree; one LoadedMesh
    per node that carries a mesh. Euler convention = nalgebra
    from_euler_angles = Rz(y) @ Ry(p) @ Rx(r)."""
    from .camera import euler_matrix

    g = GltfFile(path)
    r, p, y = [float(v) for v in euler_angles]
    root = np.eye(4)
    root[:3, 3] = translation
    scale = np.eye(4)
    scale[0, 0] = scale[1, 1] = scale[2, 2] = uniform_scale
    rot = np.eye(4)
    rot[:3, :3] = euler_matrix(r, p, y)
    root = root @ scale @ rot

    meshes: list = []
    doc = g.doc
    scene_idx = doc.get("scene", 0)
    scenes = doc.get("scenes", [{"nodes": list(range(len(doc.get("nodes", []))))}])
    scene = scenes[scene_idx] if scenes else {"nodes": []}

    def walk(node_idx: int, parent: np.ndarray):
        node = doc["nodes"][node_idx]
        mat = parent @ _node_matrix(node)
        if "mesh" in node:
            meshes.append(_build_mesh(g, doc["meshes"][node["mesh"]], mat))
        for c in node.get("children", []):
            walk(c, mat)

    for n in scene.get("nodes", []):
        walk(n, root)
    return meshes


def _read_tex(g: GltfFile, tex_info: Optional[dict], reader_attrs: dict) -> Optional[TextureData]:
    if tex_info is None:
        return None
    tex_idx = tex_info["index"]
    coord_set = tex_info.get("texCoord", 0)
    attr = f"TEXCOORD_{coord_set}"
    if attr not in reader_attrs:
        return None
    coords = g.accessor(reader_attrs[attr]).astype(np.float32)
    # normalized int UVs
    if coords.dtype != np.float32:
        coords = coords.astype(np.float32)
    try:
        pixels = g.image_rgb32f(g._tex_image_idx(tex_idx))
    except FileNotFoundError as e:
        # asset snapshots can lack texture files (e.g. the reference's
        # spaceship_r1 metallicRoughness map); fall back to factors-only
        import warnings

        warnings.warn(f"texture missing, using factors only: {e}")
        return None
    return TextureData(
        pixels=pixels, coords=coords[:, :2],
        pixels_raw=g.image_raw(g._tex_image_idx(tex_idx)),
    )


def _build_mesh(g: GltfFile, mesh: dict, trans_mat: np.ndarray) -> LoadedMesh:
    prims = []
    for prim in mesh.get("primitives", []):
        if prim.get("mode", 4) != 4:  # triangles only, like the reference
            continue
        attrs = prim["attributes"]
        poses_local = g.accessor(attrs["POSITION"]).astype(np.float64)
        ones = np.ones((poses_local.shape[0], 1))
        world = (np.concatenate([poses_local, ones], axis=1) @ trans_mat.T)[:, :3]
        norms = g.accessor(attrs["NORMAL"]).astype(np.float32) if "NORMAL" in attrs else None
        if "indices" in prim:
            idx = g.accessor(prim["indices"]).astype(np.int64)
        else:
            idx = np.arange(poses_local.shape[0], dtype=np.int64)
        tris = idx.reshape(-1, 3)
        if norms is None:
            norms = np.zeros_like(world, dtype=np.float32)
            norms[:, 2] = 1.0

        mat = (g.doc.get("materials") or [{}])[prim["material"]] if "material" in prim else {}
        pbr = mat.get("pbrMetallicRoughness", {})
        base_factor = np.asarray(pbr.get("baseColorFactor", [1, 1, 1, 1]), dtype=np.float32)[:3]
        rgb_tex = _read_tex(g, pbr.get("baseColorTexture"), attrs)
        mr_tex = _read_tex(g, pbr.get("metallicRoughnessTexture"), attrs)
        nrm = mat.get("normalTexture")
        norm_tex = _read_tex(g, nrm, attrs) if nrm else None
        tangents = None
        if "TANGENT" in attrs:
            tangents = g.accessor(attrs["TANGENT"]).astype(np.float32)[:, :3]

        prims.append(
            Primitive(
                poses=world.astype(np.float32),
                norms=norms,
                indices=tris.astype(np.int32),
                rgb_factor=base_factor,
                rgb_tex=rgb_tex,
                norm_scale=float(nrm.get("scale", 1.0)) if nrm else 1.0,
                norm_tex=norm_tex,
                tangents=tangents,
                metal_factor=float(pbr.get("metallicFactor", 1.0)),
                rough_factor=float(pbr.get("roughnessFactor", 1.0)),
                mr_tex=mr_tex,
            )
        )
    return LoadedMesh(primitives=prims, trans_mat=trans_mat.astype(np.float32))
