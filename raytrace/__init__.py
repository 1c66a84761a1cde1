"""raytrace — a differentiable Monte-Carlo path tracer in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
joonhosung/GPU-Ray_Trace-Rust (the reference):
YAML scene schemes, glTF mesh loading, sphere / free-triangle /
mesh-triangle / distant-cube-map primitives, uniform + PBR
metal-roughness materials, iterative Monte-Carlo path integration with
Russian roulette, keyframe animation with video export — implemented as
one SoA scene representation consumed by vectorized JAX compute
(brute-force closest-hit exactly like the reference GPU backend,
the reference's `src/render/trace.wgsl`), jit-compiled sample-batch
steps, shard_map distribution over a device mesh, and an analytic backward
pass for pixel gradients w.r.t. scene parameters.

Layout (mirrors SURVEY.md §2's component inventory):
  models/    scene model: YAML scheme schema, camera, glTF loader,
             SoA scene packing, keyframe animation
  ops/       numerics: RNG, intersection, BSDFs, cubemap, textures,
             accel structure; ops/pallas: GPU kernels (Pallas, Triton)
  render/    integrator (bounce loop), renderer driver, render target
  parallel/  device mesh, shard_map render step, collectives
  utils/     image IO, video encode, progress, checkpointing
"""

__version__ = "0.1.0"

EPS = 1e-4  # global epsilon, same role as reference src/lib.rs:20
