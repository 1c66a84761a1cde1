"""Acceleration-structure builder: dense primitive clusters for the
slab-culled traversal kernels.

BVH-style clustering by recursive EXACT median partition of primitive
centroids along the widest axis — each primitive lands in exactly one
cluster (cluster AABBs may overlap, which culling handles naturally);
leaves hold ~leaf_target primitives and are emitted in DFS order
(spatially local).

This replaces the reference's KD-tree build
(reference src/accel/kdtree.rs:26-56, flattened GPU variant
gpu_structs.rs:628-715) as the structure feeding traversal: the
traversal is a slab cull over dense equal-width clusters, and KD
spatial-median splits duplicate straddlers —
measured ~16x primitive duplication on the reference's biplane asset.

The build itself is native C++ (native/cluster_builder.cpp, compiled
on demand with g++, plain C ABI + ctypes — no pybind11 in this image)
with a pure-numpy fallback implementing the identical algorithm; the
two are cross-checked in tests/test_accel.py.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "cluster_builder.cpp",
)
_NATIVE_SO = os.path.join(os.path.dirname(_NATIVE_SRC), "_cluster_native.so")

_lib = None


def _load_native():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_NATIVE_SO) or os.path.getmtime(_NATIVE_SO) < os.path.getmtime(_NATIVE_SRC):
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _NATIVE_SRC, "-o", _NATIVE_SO]
        subprocess.run(cmd, check=True, capture_output=True)
    lib = ctypes.CDLL(_NATIVE_SO)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.cluster_build.restype = None
    lib.cluster_build.argtypes = [
        f32p, f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, f32p, f32p, i32p,
    ]
    _lib = lib
    return lib


def _n_leaves(n: int, leaf_target: int) -> int:
    """Leaf count of the median-split recursion (deterministic:
    n -> n//2 | n - n//2 until <= leaf_target)."""
    total = 0
    stack = [max(n, 0)]
    while stack:
        k = stack.pop()
        if k <= leaf_target:
            total += 1
        else:
            stack.append(k // 2)
            stack.append(k - k // 2)
    return total


def build_clusters_bvh(
    aabb_lo: np.ndarray, aabb_hi: np.ndarray, leaf_target: int = 64,
    native: bool = True,
):
    """aabb_lo/hi: (M, 3) f32 per-primitive bounds. Returns
    (cluster_prims (C, W) i32 -1-padded, cluster_lo (C, 3),
    cluster_hi (C, 3)); W = leaf_target rounded up to a multiple of 8.
    Balanced: every cluster full except tail leaves."""
    lo = np.ascontiguousarray(aabb_lo, np.float32)
    hi = np.ascontiguousarray(aabb_hi, np.float32)
    m = lo.shape[0]
    width = ((leaf_target + 7) // 8) * 8

    if native:
        try:
            lib = _load_native()
        except Exception:
            lib = None
        if lib is not None:
            C = _n_leaves(m, leaf_target)
            cp = np.full((C, width), -1, np.int32)
            cl = np.zeros((C, 3), np.float32)
            ch = np.zeros((C, 3), np.float32)
            n_out = np.zeros(1, np.int32)
            i32p = ctypes.POINTER(ctypes.c_int32)
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.cluster_build(
                lo.ctypes.data_as(f32p), hi.ctypes.data_as(f32p),
                np.int32(m), np.int32(leaf_target), np.int32(width),
                cp.ctypes.data_as(i32p), cl.ctypes.data_as(f32p),
                ch.ctypes.data_as(f32p), n_out.ctypes.data_as(i32p),
            )
            assert int(n_out[0]) == C, (int(n_out[0]), C)
            return cp, cl, ch

    # numpy fallback: identical algorithm
    cent = 0.5 * (lo + hi)
    leaves = []

    def rec(ids: np.ndarray):
        if ids.size <= leaf_target:
            leaves.append(ids)
            return
        c = cent[ids]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        mid = ids.size // 2
        part = np.argpartition(c[:, axis], mid)
        rec(ids[part[:mid]])
        rec(ids[part[mid:]])

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(10000)
    try:
        rec(np.arange(m, dtype=np.int32))
    finally:
        sys.setrecursionlimit(old)

    cp = np.full((len(leaves), width), -1, np.int32)
    cl = np.zeros((len(leaves), 3), np.float32)
    ch = np.zeros((len(leaves), 3), np.float32)
    for i, ids in enumerate(leaves):
        cp[i, : ids.size] = ids
        if ids.size:
            cl[i] = lo[ids].min(0)
            ch[i] = hi[ids].max(0)
    return cp, cl, ch
