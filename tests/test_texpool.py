"""Integer texel-pool storage.

The pools store UNDIVIDED integer source texels and consumers divide
after the gather — results must be BIT-IDENTICAL to the all-f32 build
(models/scene._TexPool docstring's claim, pinned here)."""
import os
import sys

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytrace.models.scene import (
    _TexPool,
    pool_texels_to_f32,
    pool_to_f32_flat,
)
from raytrace.ops.texture import sample_nearest


def test_u8_u16_division_bit_exact():
    """(x*257)f32/65535.0 == (x)f32/255.0 bitwise for ALL u8 x — the
    identity that lets u8 sources ride a u16 pool unchanged."""
    x = np.arange(256, dtype=np.uint16)
    a = (x * np.uint16(257)).astype(np.float32) / np.float32(65535.0)
    b = x.astype(np.float32) / np.float32(255.0)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def _img(rng, h, w, dtype):
    if dtype == np.uint8:
        raw = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        return raw.astype(np.float32) / 255.0, raw
    if dtype == np.uint16:
        raw = rng.integers(0, 65536, (h, w, 3), dtype=np.uint16)
        return raw.astype(np.float32) / 65535.0, raw
    return rng.random((h, w, 3), dtype=np.float32), None


def test_pool_dtype_policy_and_bit_equality():
    rng = np.random.default_rng(0)

    # all-u8 sources -> PACKED u32 pool (one word per texel);
    # unpacked values == f32 build bitwise
    p8, pf = _TexPool(), _TexPool()
    for _ in range(3):
        px, raw = _img(rng, 8, 16, np.uint8)
        p8.add(px, raw=raw)
        pf.add(px, raw=None)
    pool8, poolf = p8.finalize(), pf.finalize()
    assert pool8.dtype == np.uint32 and poolf.dtype == np.float32
    assert pool8.size * 3 == poolf.size
    np.testing.assert_array_equal(pool_to_f32_flat(pool8), poolf)

    # mixed u8 + u16 -> u16 pool with the exact x*257 upscale
    pm, pmf = _TexPool(), _TexPool()
    for dt in (np.uint8, np.uint16):
        px, raw = _img(rng, 4, 8, dt)
        pm.add(px, raw=raw)
        pmf.add(px, raw=None)
    poolm = pm.finalize()
    assert poolm.dtype == np.uint16
    np.testing.assert_array_equal(
        np.asarray(pool_texels_to_f32(jnp.asarray(poolm))), pmf.finalize()
    )

    # any float-typed source forces f32
    pfl = _TexPool()
    px, raw = _img(rng, 4, 8, np.uint8)
    pfl.add(px, raw=raw)
    pfl.add(*(_img(rng, 4, 8, np.float32)))
    assert pfl.finalize().dtype == np.float32


def test_sample_nearest_integer_pool_bit_equal():
    rng = np.random.default_rng(1)
    px, raw = _img(rng, 16, 32, np.uint8)
    p8, pf = _TexPool(), _TexPool()
    off8 = p8.add(px, raw=raw)
    offf = pf.add(px, raw=None)
    assert off8 == offf
    n = 256
    u = jnp.asarray(rng.random(n, dtype=np.float32) * 1.4 - 0.2)  # incl. clamp
    v = jnp.asarray(rng.random(n, dtype=np.float32) * 1.4 - 0.2)
    off = jnp.full((n,), off8[0], jnp.int32)
    w = jnp.full((n,), off8[1], jnp.int32)
    h = jnp.full((n,), off8[2], jnp.int32)
    out8 = np.asarray(sample_nearest(jnp.asarray(p8.finalize()), off, w, h, u, v))
    outf = np.asarray(sample_nearest(jnp.asarray(pf.finalize()), off, w, h, u, v))
    np.testing.assert_array_equal(out8.view(np.uint32), outf.view(np.uint32))
