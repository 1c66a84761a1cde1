"""YAML scheme schema — parses the reference's scheme files unchanged.

Schema parity with reference builder/mod.rs:14-60, builder/inner.rs:263-270,
material/uniform_diff_spec.rs:7-19, render/cpu_utils.rs:3-15,
render/radiance.rs:8-18 and the schema documented in the reference
README. YAML enum tags (!Sphere, !Model, !FreeTriangle, !DistantCubeMap,
!Solid, !DiffSpec, !Dielectric) are handled by a multi-constructor that
wraps the node in a Tagged value.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np


class Tagged:
    """A YAML node that carried a local tag like !Sphere."""

    __slots__ = ("tag", "value")

    def __init__(self, tag, value):
        self.tag = tag
        self.value = value

    def __repr__(self):
        return f"Tagged(!{self.tag}, {self.value!r})"


def _scheme_loader():
    """yaml.SafeLoader subclass wrapping every local tag in Tagged
    (PyYAML is needed only to read scheme files)."""
    import yaml

    class _SchemeLoader(yaml.SafeLoader):
        pass

    def _multi_constructor(loader, tag_suffix, node):
        if isinstance(node, yaml.MappingNode):
            value = loader.construct_mapping(node, deep=True)
        elif isinstance(node, yaml.SequenceNode):
            value = loader.construct_sequence(node, deep=True)
        else:
            value = loader.construct_scalar(node)
        return Tagged(tag_suffix, value)

    _SchemeLoader.add_multi_constructor("!", _multi_constructor)
    return _SchemeLoader


# ---------------------------------------------------------------------------
# config dataclasses


@dataclass
class RussRoullInfo:
    assured_depth: int = 5
    max_thres: float = 0.5


@dataclass
class RadianceInfo:
    debug_single_ray: bool = False
    dir_light_samp: bool = False
    russ_roull_info: RussRoullInfo = field(default_factory=RussRoullInfo)


@dataclass
class RenderInfo:
    width: int
    height: int
    samps_per_pix: int
    rad_info: RadianceInfo
    kd_tree_depth: int = 17
    # spp chunk per device dispatch; reference calls it gpu_render_batch
    # (renderer.rs:56) where it dodged GPU watchdog timeouts — here it is
    # the preview/progress cadence.
    render_batch: Optional[int] = None
    use_gpu: bool = True
    animation: bool = False
    framerate: Optional[float] = None
    anim_pipeline_depth: Optional[int] = None


DIVERT_KINDS = {"Spec": 0, "Diff": 1, "DiffSpec": 2, "Dielectric": 3}


@dataclass
class Material:
    """UniformDiffuseSpec (uniform_diff_spec.rs:7-19) flattened to the
    GPU table layout (gpu_structs.rs:90-97): kind + params."""

    kind: int = 0  # Spec
    diffp: float = 0.0
    n_out: float = 1.0
    n_in: float = 1.0
    emissive: Optional[np.ndarray] = None


@dataclass
class Keyframe:
    translation: np.ndarray
    time: float
    euler_angles: Optional[np.ndarray] = None
    ease_type: str = "EaseInOut"  # builder/mod.rs:39 default


@dataclass
class Anim:
    keyframes: list


@dataclass
class SphereMember:
    c: np.ndarray
    r: float
    rgb: np.ndarray  # coloring: !Solid
    mat: Material
    animation: Optional[Anim] = None


@dataclass
class FreeTriangleMember:
    verts: np.ndarray  # (3, 3)
    norm: np.ndarray  # normalized at build (inner.rs:48)
    rgb: np.ndarray
    mat: Material


@dataclass
class CubeMapFace:
    path: Any  # file path, or an in-memory (H, W, 3) u8 face
    u_scale: float
    v_scale: float


@dataclass
class CubeMapMember:
    # face attribute order matches WGSL face ids 0..5
    neg_z: CubeMapFace
    pos_z: CubeMapFace
    neg_x: CubeMapFace
    pos_x: CubeMapFace
    neg_y: CubeMapFace
    pos_y: CubeMapFace


@dataclass
class ModelMember:
    path: str
    uniform_scale: float
    translation: np.ndarray
    euler_angles: np.ndarray
    animation: Optional[Anim] = None


@dataclass
class CamConfig:
    d: np.ndarray
    o: np.ndarray
    up: np.ndarray
    screen_width: float
    screen_height: float
    view_eulers: np.ndarray
    lens_r: Optional[float] = None


@dataclass
class Scheme:
    render_info: RenderInfo
    cam: CamConfig
    scene_members: list
    scheme_dir: str = "."


# ---------------------------------------------------------------------------
# parsing


def _vec(x):
    return np.asarray(x, dtype=np.float32)


def _parse_material(m) -> Material:
    mat = Material()
    if m is None:
        return mat
    em = m.get("emissive")
    if em is not None:
        mat.emissive = _vec(em)
    dr = m.get("divert_ray")
    if isinstance(dr, str):
        mat.kind = DIVERT_KINDS[dr]
    elif isinstance(dr, Tagged):
        mat.kind = DIVERT_KINDS[dr.tag]
        if dr.tag == "DiffSpec":
            mat.diffp = float(dr.value["diffp"])
        elif dr.tag == "Dielectric":
            mat.n_out = float(dr.value["n_out"])
            mat.n_in = float(dr.value["n_in"])
    elif dr is not None:
        raise ValueError(f"bad divert_ray: {dr!r}")
    return mat


def _parse_anim(a) -> Optional[Anim]:
    if a is None:
        return None
    kfs = []
    for k in a["keyframes"]:
        kfs.append(
            Keyframe(
                translation=_vec(k["translation"]),
                time=float(k["time"]),
                euler_angles=(_vec(k["euler_angles"]) if k.get("euler_angles") is not None else None),
                ease_type=k.get("ease_type") or "EaseInOut",
            )
        )
    return Anim(keyframes=kfs)


def _parse_coloring(c) -> np.ndarray:
    if isinstance(c, Tagged) and c.tag == "Solid":
        return _vec(c.value)
    raise ValueError(f"unsupported coloring {c!r}")


def _parse_member(m):
    if not isinstance(m, Tagged):
        raise ValueError(f"scene member must be tagged: {m!r}")
    v = m.value
    if m.tag == "Sphere":
        return SphereMember(
            c=_vec(v["c"]),
            r=float(v["r"]),
            rgb=_parse_coloring(v["coloring"]),
            mat=_parse_material(v.get("mat")),
            animation=_parse_anim(v.get("animation")),
        )
    if m.tag == "FreeTriangle":
        return FreeTriangleMember(
            verts=_vec(v["verts"]).reshape(3, 3),
            norm=_vec(v["norm"]),
            rgb=_vec(v["rgb"]),
            mat=_parse_material(v.get("mat")),
        )
    if m.tag == "DistantCubeMap":
        faces = {}
        for f in ("neg_z", "pos_z", "neg_x", "pos_x", "neg_y", "pos_y"):
            p, us, vs = v[f]
            faces[f] = CubeMapFace(path=p, u_scale=float(us), v_scale=float(vs))
        return CubeMapMember(**faces)
    if m.tag == "Model":
        return ModelMember(
            path=v["path"],
            uniform_scale=float(v["uniform_scale"]),
            translation=_vec(v["translation"]),
            euler_angles=_vec(v["euler_angles"]),
            animation=_parse_anim(v.get("animation")),
        )
    raise ValueError(f"unknown member tag !{m.tag}")


def load_scheme(path: str) -> Scheme:
    import yaml

    with open(path) as f:
        raw = yaml.load(f, Loader=_scheme_loader())
    return parse_scheme(raw, scheme_dir=os.path.dirname(os.path.abspath(path)))


def parse_scheme(raw: dict, scheme_dir: str = ".") -> Scheme:
    ri = raw["render_info"]
    rad = ri.get("rad_info") or {}
    rr = rad.get("russ_roull_info") or {}
    render_info = RenderInfo(
        width=int(ri["width"]),
        height=int(ri["height"]),
        samps_per_pix=int(ri["samps_per_pix"]),
        render_batch=(int(ri["gpu_render_batch"]) if ri.get("gpu_render_batch") is not None else None),
        kd_tree_depth=int(ri.get("kd_tree_depth", 17)),
        rad_info=RadianceInfo(
            debug_single_ray=bool(rad.get("debug_single_ray", False)),
            dir_light_samp=bool(rad.get("dir_light_samp", False)),
            russ_roull_info=RussRoullInfo(
                assured_depth=int(rr.get("assured_depth", 5)),
                max_thres=float(rr.get("max_thres", 0.5)),
            ),
        ),
        use_gpu=bool(ri.get("use_gpu", True)),
        animation=bool(ri.get("animation", False)),
        framerate=(float(ri["framerate"]) if ri.get("framerate") is not None else None),
        anim_pipeline_depth=(int(ri["anim_pipeline_depth"]) if ri.get("anim_pipeline_depth") is not None else None),
    )
    c = raw["cam"]
    # cam.up is normalized at parse (Scheme::apply_corrections, builder/mod.rs:69-72)
    up = _vec(c["up"])
    up = up / np.linalg.norm(up)
    cam = CamConfig(
        d=_vec(c["d"]),
        o=_vec(c["o"]),
        up=up,
        screen_width=float(c["screen_width"]),
        screen_height=float(c["screen_height"]),
        view_eulers=_vec(c.get("view_eulers", [0.0, 0.0, 0.0])),
        lens_r=(float(c["lens_r"]) if c.get("lens_r") is not None else None),
    )
    members = [_parse_member(m) for m in raw["scene_members"]]
    return Scheme(render_info=render_info, cam=cam, scene_members=members, scheme_dir=scheme_dir)


def resolve_asset_path(path: str, scheme_dir: str) -> str:
    """Resolve an asset path from a scheme. The reference resolves
    relative to the process CWD (it was run two directories deep, hence
    the '../../assets/...' forms); we accept those schemes from
    anywhere by also trying scheme-relative and
    <scheme_dir>/../assets/<suffix>."""
    candidates = [path, os.path.join(scheme_dir, path)]
    if "assets/" in path:
        suffix = path.split("assets/", 1)[1]
        candidates.append(os.path.join(scheme_dir, "..", "assets", suffix))
        candidates.append(os.path.join(scheme_dir, "assets", suffix))
    for cand in candidates:
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"asset {path!r} not found (searched {candidates})")
