"""Parity against the REFERENCE'S committed render outputs.

The reference's own quality benchmark is its committed images
(info/images_gpu/*.png, README.md:177-194, rendered by its GPU backend
at full spp). These tests render the same schemes at reduced size with
the counter-RNG integrator, clamp to [0,1] exactly like the reference's
u8 conversion (draw_scene.rs:104-109), box-downsample the reference PNG
to our size, and assert per-channel means and a 4x2 per-tile mean grid
agree. Unlike tests/test_golden.py (deterministic change-detectors
anchored on our own history), a semantics drift from the REFERENCE
fails here.

Tolerances cover Monte-Carlo noise at our spp plus the clamp bias of
averaging noisy estimates near the [0,1] boundary (walled has emissive
radiance far above 1, so low-spp clamped means sit slightly above the
converged ones — the per-tile tolerance absorbs it)."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytrace.models.config import load_scheme
from raytrace.models.camera import build_camera
from raytrace.models.scene import build_scene
from raytrace.render.integrator import IntegratorParams
from raytrace.render.renderer import camera_to_arrays, sample_batch

REFERENCE = os.environ.get(  # a checkout of the reference renderer
    "RAYTRACE_REFERENCE",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "reference"),
)
SCHEMES = os.path.join(REFERENCE, "schemes")
IMAGES = os.path.join(REFERENCE, "info", "images_gpu")


def _render_clamped(scheme_name, scale, spp):
    path = os.path.join(SCHEMES, scheme_name)
    if not os.path.exists(path):
        pytest.skip("reference schemes unavailable")
    scheme = load_scheme(path)
    W = scheme.render_info.width // scale
    H = scheme.render_info.height // scale
    scene = build_scene(scheme)
    cam = camera_to_arrays(build_camera(scheme.cam, W, H))
    rr = scheme.render_info.rad_info.russ_roull_info
    params = IntegratorParams(
        assured_depth=rr.assured_depth, max_thres=jnp.float32(rr.max_thres)
    )
    flat = np.arange(W * H, dtype=np.int32)
    xs = jnp.asarray(flat % W)
    ys = jnp.asarray(flat // W)
    out = np.asarray(
        sample_batch(scene, cam, params, W, H, xs, ys, jnp.int32(0), jnp.int32(spp))
    ) / spp
    img = np.clip(out.reshape(H, W, 3), 0.0, 1.0)
    return np.flipud(img)  # row 0 = top, PNG orientation


def _reference_downsampled(name, scale):
    from PIL import Image

    p = os.path.join(IMAGES, f"{name}.png")
    if not os.path.exists(p):
        pytest.skip("reference images unavailable")
    ref = np.asarray(Image.open(p).convert("RGB"), dtype=np.float32) / 255.0
    H, W = ref.shape[0] // scale, ref.shape[1] // scale
    return ref.reshape(H, scale, W, scale, 3).mean(axis=(1, 3))


def _tile_means(img, ty=2, tx=4):
    H, W = img.shape[:2]
    return img[: H - H % ty, : W - W % tx].reshape(
        ty, H // ty, tx, W // tx, 3
    ).mean(axis=(1, 3))


def _assert_image_match(ours, ref, mean_tol, tile_tol, name):
    dm = np.abs(ours.reshape(-1, 3).mean(0) - ref.reshape(-1, 3).mean(0))
    assert dm.max() < mean_tol, f"{name} channel means off by {dm}"
    dt = np.abs(_tile_means(ours) - _tile_means(ref))
    assert dt.max() < tile_tol, f"{name} tile means off by {dt.max()} ({dt})"


def test_walled_matches_reference_image():
    # reference: 20000 spp GPU render (README.md:170). 48 spp is enough
    # for per-tile agreement; the emissive clamp bias is ~0.01.
    ours = _render_clamped("walled.yml", 4, 48)
    ref = _reference_downsampled("walled", 4)
    _assert_image_match(ours, ref, 0.015, 0.04, "walled")


def test_spaceship_matches_reference_image():
    # the snapshot's spaceship asset is missing
    # Material_metallicRoughness.png (gltf loader warns and falls back
    # to factors) while the reference's committed image was rendered
    # WITH it — ship-body tiles legitimately deviate up to ~0.05;
    # sky tiles agree to ~1e-4, channel means to <0.015
    ours = _render_clamped("spaceship_r1.yml", 6, 8)
    ref = _reference_downsampled("spaceship_r1", 6)
    _assert_image_match(ours, ref, 0.015, 0.08, "spaceship_r1")


def test_biplane_matches_reference_image():
    ours = _render_clamped("biplane.yml", 8, 4)
    ref = _reference_downsampled("biplane", 8)
    _assert_image_match(ours, ref, 0.015, 0.04, "biplane")
