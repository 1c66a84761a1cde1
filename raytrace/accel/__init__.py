"""Acceleration structures: native cluster builder (C++) consumed by
the slab-culled traversals. Replaces reference src/accel/
(kdtree.rs, aabb.rs) with the dense cluster layout the mesh hit kernel
(ops/pallas/hit_kernel.py) and the XLA cluster walk traverse."""

from .builder import build_clusters_bvh  # noqa: F401
