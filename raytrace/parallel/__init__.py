"""Distribution layer: device mesh, shard_map render/train steps.

The reference is single-node single-GPU (SURVEY.md §2.5); its
parallelism (rayon pixel loops, 8x8 workgroups, spp batches) maps here
onto a jax.sharding.Mesh with named axes:

  "tile" — pixel data-parallelism (the rayon/workgroup axis)
  "spp"  — samples-per-pixel sharding (the batch axis); partial
           accumulators are psum'd

Scene/BVH arrays are replicated (reference scenes are far below
per-chip HBM; primitive sharding is the scale-out path for bigger
scenes). Host<->device plumbing that the reference hand-rolls through
wgpu (gpu_utils.rs:52-254, 613-724) is the JAX runtime here.
"""
