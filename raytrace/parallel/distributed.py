"""shard_map render and train steps over the (tile, spp) mesh.

Pixel rows shard over "tile" (the reference's rayon/workgroup pixel
parallelism), sample indices shard over "spp" (the reference's batch
axis); per-device partial radiance sums are psum'd over "spp" (the ONLY
collective in the forward path). The differentiable
train step additionally psums scene/camera gradients over both axes,
which is the standard data-parallel gradient all-reduce.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..render.integrator import IntegratorParams, trace_paths
from ..render.renderer import sample_batch


def make_render_step(mesh: Mesh, width: int, height: int):
    """Returns render_step(scene, cam, params, x_idx, y_idx,
    sample_base, n_samples_per_spp_shard) -> (P, 3) radiance sums,
    where x_idx/y_idx are (P,) pixel coords (P divisible by the tile
    axis) and the TOTAL samples accumulated = spp_axis *
    n_samples_per_spp_shard."""
    spp_size = mesh.shape["spp"]

    def step(scene, cam, params, x_idx, y_idx, sample_base, n_samples):
        spp_i = jax.lax.axis_index("spp")
        base = sample_base + spp_i * n_samples
        acc = sample_batch(scene, cam, params, width, height, x_idx, y_idx, base, n_samples)
        return jax.lax.psum(acc, "spp")

    sharded = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P(), P(), P("tile"), P("tile"), P(), P()),
        out_specs=P("tile"),
        check_vma=False,
    )
    return jax.jit(sharded), spp_size


def make_wavefront_render_step(mesh: Mesh, width: int, height: int, pool: int):
    """Distributed wavefront rendering: every device runs the
    lane-regeneration driver (render/wavefront.py) over the full pixel
    set with a disjoint contiguous slice of the sample range, and the
    per-device images are psum'd over ALL mesh axes (one image-sized
    all-reduce per dispatch). Sample-axis sharding keeps
    each device's lane pool full — pixel sharding would shrink the
    per-device work list and lengthen the drain tail.

    Returns step(scene, cam, params, xs, ys, sample_base,
    n_samples_per_device) -> (n_pix, 3) radiance sums over
    n_devices * n_samples_per_device samples."""
    from ..render.wavefront import wavefront_batch

    axes = tuple(mesh.axis_names)
    sizes = [mesh.shape[a] for a in axes]

    def step(scene, cam, params, xs, ys, sample_base, n_samples):
        idx = jnp.int32(0)
        for a, s in zip(axes, sizes):
            idx = idx * s + jax.lax.axis_index(a)
        base = sample_base + idx * n_samples
        img = wavefront_batch(
            scene, cam, params, xs, ys, base, n_samples,
            width=width, height=height, pool=pool,
        )
        return jax.lax.psum(img, axes)

    sharded = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    n_devices = 1
    for s in sizes:
        n_devices *= s
    return jax.jit(sharded), n_devices


def make_spp_sharded_step(mesh: Mesh, inner, static_kw: dict):
    """Wrap ANY sample-batch driver `inner(*args, sample_base,
    n_samples, **static_kw) -> (P, 3) sums` into an spp-sharded
    multi-device step over a 1-D mesh: every device runs the driver
    with the full (replicated) inputs and a DISJOINT contiguous sample
    slice [sample_base + i*n, ...), and the per-device partial images
    are psum'd — the product multi-device render path (renderer.py
    uses this for every driver when >1 device is attached).

    The returned step(*args, sample_base, n_samples_per_device)
    accumulates n_devices * n_samples_per_device total samples; every
    (pixel, sample) stream is identical to the single-device render of
    the same total range (the partition is by sample id), so images
    agree with single-device up to f32 sum reassociation."""
    axis = mesh.axis_names[0]
    n_devices = mesh.shape[axis]

    def step(*args):
        *inner_args, sample_base, n_samples = args
        i = jax.lax.axis_index(axis)
        base = sample_base + i * n_samples
        out = inner(*inner_args, sample_base=base, n_samples=n_samples, **static_kw)
        return jax.lax.psum(out, axis)

    def wrapped(*args):
        # in_specs built per arity: everything replicated (P()); the
        # sample partition happens via axis_index inside
        sharded = shard_map(
            step, mesh=mesh, in_specs=tuple(P() for _ in args),
            out_specs=P(), check_vma=False,
        )
        return sharded(*args)

    return jax.jit(wrapped), n_devices


# scene leaves that carry geometry/appearance gradients; int/bool
# tables (kinds, masks, texture descriptors) are non-differentiable.
DIFF_SCENE_FIELDS = (
    "sph_c", "sph_r", "sph_rgb", "sph_emissive",
    "ft_v0", "ft_e1", "ft_e2", "ft_norm", "ft_rgb", "ft_emissive",
    "mt_v0", "mt_e1", "mt_e2", "mt_const_norm", "mt_rgb_factor",
    "tex_pool", "sky_pool",
)


def split_diff_scene(scene):
    """scene -> (diff dict of float leaves, merge fn). Integer texel
    pools (the compact u8/u16 build) are converted to pre-divided f32
    pools here so texture gradients flow — the consumers key the
    divide on pool dtype, so an f32 pool must hold the [0,1] values."""
    from ..models.scene import pool_to_f32_flat

    diff = {f: getattr(scene, f) for f in DIFF_SCENE_FIELDS}
    for f in ("tex_pool", "sky_pool"):
        # packed-u32 / u8 / u16 pools expand to the flat f32 RGB pool
        # an all-float build would store (bit-identical values); the
        # consumers key the fetch path on pool dtype, so the float
        # pool reverts them to the slice-3 gather with gradients
        diff[f] = jnp.asarray(pool_to_f32_flat(getattr(scene, f)))
    return diff, (lambda d: scene.replace(**d))


def make_train_step(
    mesh: Mesh, width: int, height: int, n_samples: int = 1, loss_scale: float = 1.0
):
    """Differentiable distributed step: render a sample batch, compare
    to a target image shard, and return (loss, (scene_grads, cam_grads))
    where scene_grads is a dict over DIFF_SCENE_FIELDS — grads
    all-reduced over the whole mesh. This is the 'full training step'
    shape: data-parallel pixels (tile) + sample parallelism (spp) +
    replicated parameters with psum'd grads."""

    def step(scene, cam, params, x_idx, y_idx, sample_base, target):
        diff, _ = split_diff_scene(scene)

        # differentiate ONLY the local sample batch (no collectives
        # inside the vjp — shard_map's conservative psum transpose with
        # check_vma=False would inflate replicated cotangents by the
        # axis size); the MSE loss pieces around it are linear/explicit.
        def local_render(diff, cam):
            sc = scene.replace(**diff)
            spp_i = jax.lax.axis_index("spp")
            base = sample_base + spp_i * n_samples
            return sample_batch(
                sc, cam, params, width, height, x_idx, y_idx, base, n_samples
            )

        acc, vjp = jax.vjp(local_render, diff, cam)
        total_spp = n_samples * jax.lax.psum(1, "spp")
        img = jax.lax.psum(acc, "spp") / total_spp
        err = img - target
        local_sum = jnp.sum(err * err)
        n_total = err.size * jax.lax.psum(1, "tile")
        loss = jax.lax.psum(local_sum, "tile") / n_total * loss_scale

        # analytic cotangent of loss wrt THIS device's acc:
        # d(loss)/d(acc_d) = 2*err / (n_total * total_spp) * loss_scale
        cot = (2.0 * loss_scale / n_total / total_spp) * err
        grads = vjp(cot)
        # explicit data-parallel gradient all-reduce over the mesh
        grads = jax.tree.map(lambda g: jax.lax.psum(g, ("tile", "spp")), grads)
        return loss, grads

    sharded = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P(), P(), P("tile"), P("tile"), P(), P("tile")),
        out_specs=(P(), (P(), P())),
        check_vma=False,
    )
    return jax.jit(sharded)
