"""Counter/stream RNG for the path tracer, in pure uint32 jnp ops.

The reference GPU kernel uses a per-thread PCG-style stream seeded by a
jenkins hash of the pixel coordinates and the dispatch counter
(reference trace.wgsl:1252-1279, credited there to boksajak/referencePT).
We reproduce the same generator family — jenkins hash seeding + the
``state*747796405+2891336453`` PCG output permutation — but carry one
u32 state *per ray lane* through the bounce loop, which vectorizes
perfectly and makes every draw reproducible from
(pixel, sample) alone. Bitwise image equality with the reference is
impossible anyway (per-thread stream consumption is data-dependent), so
validation is statistical; what matters is that the streams are
well-distributed and decorrelated across (pixel, sample, bounce, draw).

All functions are shape-polymorphic: ``state`` may be any uint32 array
and draws are elementwise.

Generator families (``RTPU_RNG`` env, read at import):

- ``pcg`` — the reference's PCG output permutation over an LCG state
  (2 u32 multiplies + a per-lane variable shift per draw).
- ``weyl`` (default) — Weyl-sequence state (+golden-ratio constant) with
  a two-multiply xorshift finalizer (Weyl hashing): no LCG multiply and
  no variable shift. Statistically gated by the same tests as pcg
  (moments, stream decorrelation, closed-form DLS, golden means vs the
  reference's committed images).

Both keys of the switch produce unbiased, decorrelated streams — which
one is active changes images only at the Monte-Carlo-noise level. The
Pallas kernels call these SAME functions (plain jnp lowers inside a
kernel unchanged), so kernel/XLA stream parity holds under either
family.
"""
from __future__ import annotations

import os

import jax.numpy as jnp

_U32 = jnp.uint32

GENERATOR = os.environ.get("RTPU_RNG", "weyl")


def jenkins_hash(x):
    """Jenkins one-at-a-time style avalanche (reference trace.wgsl:1271-1279)."""
    x = x.astype(_U32)
    x = x + (x << _U32(10))
    x = x ^ (x >> _U32(6))
    x = x + (x << _U32(3))
    x = x ^ (x >> _U32(11))
    x = x + (x << _U32(15))
    return x


def init_state(x_idx, y_idx, width, height, sample_idx):
    """Per-(pixel, sample) stream seed.

    The reference seeds with ``jenkins(dot((x,y),(W,H)) ^
    jenkins(counter))`` (trace.wgsl:1257-1260); that dot-product
    collides for neighboring pixels ((x+1,y) vs (x,y+W/H ratios)) and
    produces visibly structured noise at low spp. We keep the same
    generator family but mix the pixel injectively: x ^ (y<<16) is
    unique for any canvas < 65536 wide/tall, double-jenkins'd with the
    sample index. width/height stay in the signature for provenance.
    """
    del width, height
    x_idx = jnp.asarray(x_idx).astype(_U32)
    y_idx = jnp.asarray(y_idx).astype(_U32)
    pix = x_idx ^ (y_idx << _U32(16))
    seed = jenkins_hash(pix) ^ jenkins_hash(jnp.asarray(sample_idx, dtype=_U32) ^ _U32(0x9E3779B9))
    return jenkins_hash(seed)


def next_u32(state):
    """One generator step: returns (new_state, random u32 word).

    ``pcg``: identical update/permutation to reference get_random_f32
    (trace.wgsl:1262-1269). ``weyl``: golden-ratio Weyl increment with
    an xorshift-multiply finalizer — no LCG multiply and no per-lane
    variable shift, and Monte-Carlo-grade streams (same statistical
    gates as pcg).
    """
    state = state.astype(_U32)
    if GENERATOR == "weyl":
        # lowbias32 finalizer (public-domain avalanche constants): a
        # one-multiply finalizer leaves measurable 16x16 lattice
        # structure in (u, v) pairs (caught by the chi-square gate in
        # tests/test_ops.py), so two multiplies it is — still no LCG
        # multiply and no variable shift.
        new_state = state + _U32(0x9E3779B9)
        w = new_state ^ (new_state >> _U32(16))
        w = w * _U32(0x21F0AAAD)
        w = w ^ (w >> _U32(15))
        w = w * _U32(0x735A2D97)
        return new_state, w ^ (w >> _U32(15))
    new_state = state * _U32(747796405) + _U32(2891336453)
    word = ((new_state >> ((new_state >> _U32(28)) + _U32(4))) ^ new_state) * _U32(277803737)
    return new_state, (word >> _U32(22)) ^ word


def next_f32(state):
    """One uniform f32 in [0, 1] from the top 24 bits.

    The reference converts f32(u32)/f32(0xffffffff) (trace.wgsl:1268);
    we use (word >> 8) / 0xffffff instead — identical distribution at
    f32 precision (a float32 cannot hold 32 significant bits anyway),
    converted through int32, bit-identical in the kernels and in XLA."""
    state, word = next_u32(state)
    bits24 = (word >> _U32(8)).astype(jnp.int32)
    return state, bits24.astype(jnp.float32) * jnp.float32(1.0 / 16777215.0)


def next_f32_n(state, n: int):
    """Draw ``n`` sequential uniforms; returns (state, tuple of draws)."""
    out = []
    for _ in range(n):
        state, u = next_f32(state)
        out.append(u)
    return state, tuple(out)
