"""Which forward driver and which mesh nearest-hit implementation a
render uses — decided in one place from the device platform and what
the scene and integrator parameters show.

Drivers:
  "fused"     — the whole bounce loop as one GPU kernel
                (ops/pallas/trace_kernel.py): sphere/free-triangle
                scenes in gpu semantics;
  "wavefront" — lane-regenerating XLA driver (render/wavefront.py):
                every other forward render;
  "plain"     — the integrator's tile loop (render/integrator.py):
                differentiable renders.
Mesh nearest hit (IntegratorParams.mesh_hit): "triton"
(ops/pallas/hit_kernel.py) on a GPU for forward renders, else the XLA
cluster cull "clusters"; "none" for scenes without mesh triangles.

The kernels run only where the platform is "gpu"; every other platform
gets the XLA formulations. Interpret mode is never chosen here (tests
pass it explicitly).
"""
from __future__ import annotations

from typing import NamedTuple


class Plan(NamedTuple):
    driver: str
    hit: str


def fused_supported(scene, params) -> bool:
    """The fused kernel's coverage: gpu semantics, spheres + free
    triangles only, each <= 64 (unrolled in the kernel)."""
    return (
        params.mode == "gpu"
        and not params.debug_single_ray
        and not params.differentiable
        and scene.n_mesh_tris == 0
        and scene.n_spheres <= 64
        and scene.n_free_tris <= 64
    )


def choose(platform: str, scene, params) -> Plan:
    gpu = platform == "gpu"
    if gpu and fused_supported(scene, params):
        driver = "fused"
    elif not params.differentiable:
        driver = "wavefront"
    else:
        driver = "plain"
    if not scene.n_mesh_tris:
        hit = "none"
    elif gpu and not params.differentiable and scene.n_clusters:
        hit = "triton"
    else:
        hit = "clusters" if scene.n_clusters else "brute"
    return Plan(driver, hit)
