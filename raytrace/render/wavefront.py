"""Wavefront path tracing with lane regeneration.

The plain bounce loop (render/integrator.trace_paths) iterates all
lanes until every path dies: by bounce ~7 of 24 only ~10-15% of lanes
are alive, yet every iteration still pays full-width mesh-attribute /
texture gathers and BSDF math for the dead majority — the measured
cost on mesh scenes. GPU path tracers solve this with wavefront
scheduling / path regeneration (persistent threads); the XLA
formulation here keeps a fixed pool of lanes
(a static shape XLA can compile) at ~full occupancy:

  every iteration
    1. one bounce for the whole pool (reuses integrator._bounce_step —
       same formulas, same per-(pixel,sample) RNG streams);
    2. lanes whose path terminated (miss -> sky, russian roulette,
       bounce cap) resolve their deferred cubemap term and scatter-add
       their radiance into the (n_pix+1,) accumulator rows;
    3. dead lanes immediately pull the next (pixel, sample) work unit
       off a queue counter (rank = prefix sum over the pool), seed the
       stream from (x, y, sample) exactly like renderer.sample_batch,
       and raygen in place.

The loop ends when the queue is drained and the last paths die — total
iterations ~ sum of path lengths / pool, instead of
n_dispatches * max_bounces. Radiance per work unit is IDENTICAL to
trace_paths (same draws in the same order); only the accumulation
order differs, so images agree to f32 reassociation tolerance
(tests/test_wavefront.py).

Work units are handed out sample-major over the tile-ordered pixel
permutation (renderer lane order), so lanes regenerated together are
spatially coherent — which is what lets the cluster-culled mesh
kernels skip whole blocks.

Reference behavior covered: the gpu-semantics radiance loop
(trace.wgsl:282-315) and the cpu-semantics one (radiance.rs:20-86)
including direct-light sampling: the one-bounce-lookahead DLS state
(integrator._bounce_step's `dls` dict — the diffuse hit whose emitter
sum resolves on the NEXT bounce, radiance.rs:89-120) rides in the lane
state; regenerated lanes clear it, and a pending term is always
resolved before its lane can retire (the resolving _bounce_step is the
one that kills the lane).
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ..ops import raygen, rng
from ..ops import vec as v3
from ..ops.vec import Vec3
from .integrator import IntegratorParams, _bounce_step, sample_cubemap


def wavefront_batch(
    scene,
    cam,
    params: IntegratorParams,
    xs_tab,
    ys_tab,
    sample_base,
    n_samples,
    width: int,
    height: int,
    pool: int,
):
    """Radiance SUM over n_samples for every pixel.

    xs_tab/ys_tab: (n_pix,) i32 pixel coords in dispatch (tile) order.
    Returns (n_pix, 3) f32 sums indexed by flat y*width+x (natural
    image order — no unscramble needed). sample_base/n_samples may be
    traced; pool is the static lane-pool size.
    """
    n_pix = xs_tab.shape[0]
    n_work = n_pix * n_samples
    track_miss = scene.has_cubemap and not params.debug_single_ray
    use_dls = bool(
        params.dir_light_samp and params.mode == "cpu" and scene.n_spheres
    )
    max_b = 1 if params.debug_single_ray else params.max_bounces

    zeros = jnp.zeros((pool,), jnp.float32)
    ones = jnp.ones((pool,), jnp.float32)

    def assign(st, q, ranks=None):
        """Hand the next work units to every dead lane; advance q.
        ranks: each lane's 1-based rank among the dead lanes (computed
        here by a prefix sum when not given)."""
        need = ~st["active"]
        if ranks is None:
            ranks = jnp.cumsum(need.astype(jnp.int32))
        ids = q + ranks - 1
        valid = need & (ids < n_work)
        new_q = jnp.minimum(q + ranks[-1], n_work)
        ids_c = jnp.clip(ids, 0, jnp.maximum(n_work - 1, 0))
        pix_pos = ids_c % n_pix
        samp = sample_base + ids_c // n_pix
        x = jnp.take(xs_tab, pix_pos)
        y = jnp.take(ys_tab, pix_pos)
        state0 = rng.init_state(x, y, width, height, samp)
        state0, ro0, rd0 = raygen.generate(state0, x, y, cam)
        out = dict(
            ro=v3.where(valid, ro0, st["ro"]),
            rd=v3.where(valid, rd0, st["rd"]),
            L=v3.where(valid, Vec3(zeros, zeros, zeros), st["L"]),
            ci=v3.where(valid, Vec3(ones, ones, ones), st["ci"]),
            inten=jnp.where(valid, 1.0, st["inten"]),
            rng=jnp.where(valid, state0, st["rng"]),
            active=st["active"] | valid,
            bounce=jnp.where(valid, 0, st["bounce"]),
            pix=jnp.where(valid, y * width + x, st["pix"]),
        )
        if track_miss:
            out["miss_d"] = v3.where(valid, Vec3(zeros, zeros, zeros), st["miss_d"])
            out["miss_w"] = v3.where(valid, Vec3(zeros, zeros, zeros), st["miss_w"])
        if use_dls:
            # fresh work units must not inherit a pending DLS term
            d = st["dls"]
            out["dls"] = dict(
                active=jnp.where(valid, False, d["active"]),
                pos=d["pos"],
                norm=d["norm"],
                ci=d["ci"],
                self_idx=d["self_idx"],
            )
        return out, new_q

    st0 = dict(
        ro=Vec3(zeros, zeros, zeros),
        rd=Vec3(zeros, zeros, ones),
        L=Vec3(zeros, zeros, zeros),
        ci=Vec3(ones, ones, ones),
        inten=ones,
        rng=jnp.zeros((pool,), jnp.uint32),
        active=jnp.zeros((pool,), bool),
        bounce=jnp.zeros((pool,), jnp.int32),
        pix=jnp.zeros((pool,), jnp.int32),
    )
    if track_miss:
        st0["miss_d"] = Vec3(zeros, zeros, zeros)
        st0["miss_w"] = Vec3(zeros, zeros, zeros)
    if use_dls:
        st0["dls"] = dict(
            active=jnp.zeros((pool,), bool),
            pos=Vec3(zeros, zeros, zeros),
            norm=Vec3(zeros, zeros, zeros),
            ci=Vec3(ones, ones, ones),
            self_idx=jnp.full((pool,), -1, jnp.int32),
        )
    # every lane starts dead, so lane i's rank is i + 1. Passing it in
    # keeps XLA from constant-folding a pool-wide prefix sum over the
    # constant initial state (a reduce-window its folder evaluates in
    # quadratic time, which stalled compiling the four-card render).
    st0, q0 = assign(st0, jnp.int32(0), ranks=jnp.arange(1, pool + 1, dtype=jnp.int32))

    acc0 = tuple(jnp.zeros((n_pix + 1,), jnp.float32) for _ in range(3))

    def cond(carry):
        _, _, st = carry
        return jnp.any(st["active"])

    def body(carry):
        q, acc, st = carry
        was_active = st["active"]
        # _bounce_step pops the wavefront-only 'pix' key from its input
        # view; carry it around explicitly
        pix = st.pop("pix")
        st = _bounce_step(scene, params, st)
        # per-lane bounce cap (trace_paths caps via the loop bound)
        st["active"] = st["active"] & (st["bounce"] < max_b)
        if use_dls:
            # a cap-killed lane's just-set pending DLS must die with it
            # (trace_paths drops pendings at loop exit); lanes killed
            # inside _bounce_step already cleared theirs
            st["dls"]["active"] = st["dls"]["active"] & st["active"]
        term = was_active & ~st["active"]

        # resolve the deferred cubemap term at retirement (a path
        # misses at most once; see trace_paths' post-loop resolve).
        # Only tiles containing a retiring missed lane pay the gather.
        Lf = st["L"]
        if track_miss:
            mw = st["miss_w"]
            md = st["miss_d"]
            missed = term & ((mw.x > 0.0) | (mw.y > 0.0) | (mw.z > 0.0))

            def resolve(m_t, md_t, mw_t):
                sky = sample_cubemap(
                    scene, v3.where(m_t, md_t, Vec3.full_like(md_t.x, 1.0, 0.0, 0.0))
                )
                add = v3.where(m_t, mw_t * sky, Vec3.zeros_like(mw_t.x))
                return add.x, add.y, add.z

            TS = 8192
            if pool > TS and pool % TS == 0:
                n_t = pool // TS
                resh = lambda x: x.reshape(n_t, TS)

                def tile_body(_, args):
                    m_t, mdx, mdy, mdz, mwx, mwy, mwz, any_t = args
                    out = jax.lax.cond(
                        any_t,
                        lambda: resolve(m_t, Vec3(mdx, mdy, mdz), Vec3(mwx, mwy, mwz)),
                        lambda: tuple(jnp.zeros((TS,), jnp.float32) for _ in range(3)),
                    )
                    return None, out

                _, (ax, ay, az) = jax.lax.scan(
                    tile_body, None,
                    (resh(missed), resh(md.x), resh(md.y), resh(md.z),
                     resh(mw.x), resh(mw.y), resh(mw.z),
                     jnp.any(resh(missed), axis=1)),
                )
                Lf = Lf + Vec3(ax.reshape(pool), ay.reshape(pool), az.reshape(pool))
            else:
                ax, ay, az = resolve(missed, md, mw)
                Lf = Lf + Vec3(ax, ay, az)

        idx = jnp.where(term, pix, n_pix)  # row n_pix = discard
        acc = (
            acc[0].at[idx].add(jnp.where(term, Lf.x, 0.0)),
            acc[1].at[idx].add(jnp.where(term, Lf.y, 0.0)),
            acc[2].at[idx].add(jnp.where(term, Lf.z, 0.0)),
        )

        st["pix"] = pix
        st, q = assign(st, q)
        return q, acc, st

    _, acc, _ = jax.lax.while_loop(cond, body, (q0, acc0, st0))
    return jnp.stack([acc[0][:n_pix], acc[1][:n_pix], acc[2][:n_pix]], axis=-1)
