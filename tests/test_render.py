"""Renderer-level behaviors: debug_single_ray, DLS, CPU/GPU mode
divergences, render target conversion, checkpoint resume, easing,
video container."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytrace.models import config as cfg
from raytrace.models.animation import EASING, ease, extract_frames, sample_sequence
from raytrace.models.camera import build_camera
from raytrace.models.scene import build_scene
from raytrace.render.integrator import IntegratorParams
from raytrace.render.renderer import camera_to_arrays, sample_batch
from raytrace.render.target import RenderTarget

W, H = 48, 24


def _sphere(c, r, rgb, mat):
    return cfg.Tagged("Sphere", {"c": c, "r": r, "coloring": cfg.Tagged("Solid", rgb), "mat": mat})


def _scheme(dls=False):
    raw = {
        "render_info": {
            "width": W, "height": H, "samps_per_pix": 2, "kd_tree_depth": 0,
            "rad_info": {
                "debug_single_ray": False, "dir_light_samp": dls,
                "russ_roull_info": {"assured_depth": 2, "max_thres": 0.5},
            },
            "use_gpu": False,
        },
        "cam": {
            "d": [0, 0, -5], "o": [0, 0, 0], "up": [0, 1, 0],
            "view_eulers": [0, 0, 0], "screen_width": 8.0, "screen_height": 4.0,
        },
        "scene_members": [
            _sphere([0, -1.2, -10], 2.0, [0.7, 0.7, 0.7], {"divert_ray": "Diff"}),
            _sphere([0, 2.2, -10], 1.5, [0, 0, 0], {"divert_ray": "Diff", "emissive": [6, 6, 6]}),
            _sphere([0, 0, -30], 15.0, [0.5, 0.5, 0.5], {"divert_ray": "Diff"}),
        ],
    }
    return cfg.parse_scheme(raw)


def _render(scheme, params):
    scene = build_scene(scheme)
    cam = camera_to_arrays(build_camera(scheme.cam, W, H))
    flat = np.arange(W * H, dtype=np.int32)
    xs = jnp.asarray(flat % W)
    ys = jnp.asarray(flat // W)
    out = sample_batch(scene, cam, params, W, H, xs, ys, jnp.int32(0), jnp.int32(4))
    return np.asarray(out) / 4.0


def test_debug_single_ray():
    scheme = _scheme()
    params = IntegratorParams(assured_depth=2, max_bounces=8, mode="cpu", debug_single_ray=True)
    img = _render(scheme, params)
    # only the emissive sphere shows; everything else black. Per sample
    # a pixel is 0 or 6, so 4-sample means are multiples of 1.5 (edge
    # pixels mix via the jitter).
    assert img.max() == pytest.approx(6.0, rel=1e-5)
    vals = np.unique(np.round(img, 4))
    assert set(vals.tolist()) <= {0.0, 1.5, 3.0, 4.5, 6.0}


def test_dls_adds_light():
    params_off = IntegratorParams(assured_depth=2, max_bounces=8, mode="cpu")
    params_on = params_off.replace(dir_light_samp=True)
    img_off = _render(_scheme(), params_off)
    img_on = _render(_scheme(dls=True), params_on)
    # identical RNG streams -> the difference IS the DLS term: a
    # non-negative add (light_dot * emissive / 30pi, radiance.rs:89-120)
    diff = img_on - img_off
    assert (diff >= -1e-5).all()
    assert diff.max() > 1e-3
    assert img_on.mean() > img_off.mean()
    assert np.isfinite(img_on).all()


def test_mode_divergence_inside_sphere():
    """Camera inside a big sphere: CPU mode sees it (exit root), GPU
    mode misses (near-root-only quirk)."""
    raw_scheme = _scheme()
    raw_scheme.scene_members.append(
        cfg._parse_member(
            _sphere([0, 0, 0], 100.0, [0, 0, 0], {"divert_ray": "Diff", "emissive": [1, 1, 1]})
        )
    )
    p_cpu = IntegratorParams(assured_depth=2, max_bounces=4, mode="cpu", debug_single_ray=True)
    p_gpu = p_cpu.replace(mode="gpu")
    img_cpu = _render(raw_scheme, p_cpu)
    img_gpu = _render(raw_scheme, p_gpu)
    # CPU: background rays hit the enclosing emissive sphere (exit
    # root) -> lit; GPU: the enclosing sphere is invisible from inside,
    # so background stays black. (Foreground diffuse sphere shows
    # emissive 0 in debug mode for both.)
    bg_cpu = img_cpu.sum(-1) == 0
    bg_gpu = img_gpu.sum(-1) == 0
    assert bg_gpu.sum() > bg_cpu.sum() + 100
    assert (img_cpu.sum(-1) == 3.0).any()  # enclosing sphere visible on CPU


class TestTarget:
    def test_u8_conversion(self):
        t = RenderTarget(2, 2)
        t.add(np.array([[0.5, 2.0, -1.0]] * 4, np.float32), 1)
        rgba = t.to_u8_rgba()
        # (clamp(c,0,1)*255 + 0.5) truncated (draw_scene.rs:104-109)
        assert rgba[0, 0, 0] == int(0.5 * 255 + 0.5)
        assert rgba[0, 0, 1] == 255
        assert rgba[0, 0, 2] == 0
        assert rgba[0, 0, 3] == 255

    def test_chunk_to_pix(self):
        # ports of target.rs:17-46 corner cases
        t = RenderTarget(10, 5)
        assert t.chunk_to_pix(0) == (0, 0)
        assert t.chunk_to_pix(9) == (9, 0)
        assert t.chunk_to_pix(10) == (0, 1)
        assert t.chunk_to_pix(49) == (9, 4)

    def test_checkpoint_roundtrip(self, tmp_path):
        from raytrace.utils import checkpoint

        t = RenderTarget(4, 2)
        t.add(np.random.default_rng(0).random((8, 3)).astype(np.float32), 3)
        p = str(tmp_path / "ck.npz")
        checkpoint.save(p, t)
        t2 = checkpoint.load(p)
        assert t2.count == 3
        np.testing.assert_array_equal(t.acc, t2.acc)


class TestEasing:
    def test_endpoints(self):
        for name in EASING:
            assert ease(name, 0.0) == pytest.approx(0.0, abs=1e-6) or name == "Step"
            if name not in ("Hold",):
                assert ease(name, 1.0) == pytest.approx(1.0, abs=1e-6)

    def test_linear_and_quad(self):
        assert ease("Linear", 0.25) == 0.25
        assert ease("EaseInQuad", 0.5) == 0.25
        assert ease("EaseOutQuad", 0.5) == 0.75
        assert ease("EaseInOutQuad", 0.5) == pytest.approx(0.5)

    def test_css_bezier_midpoint(self):
        # EaseInOut(0.5) = 0.5 by symmetry
        assert ease("EaseInOut", 0.5) == pytest.approx(0.5, abs=1e-3)

    def test_sequence(self):
        kfs = [
            cfg.Keyframe(translation=np.array([0.0, 0, 0]), time=0.0, ease_type="Linear"),
            cfg.Keyframe(translation=np.array([10.0, 0, 0]), time=1.0, ease_type="Linear"),
        ]
        v = sample_sequence(kfs, np.stack([k.translation for k in kfs]), 0.25)
        assert v[0] == pytest.approx(2.5)
        # clamped outside
        assert sample_sequence(kfs, np.stack([k.translation for k in kfs]), 2.0)[0] == 10.0


def test_extract_frames():
    scheme = _scheme()
    scheme.scene_members[0].animation = cfg.Anim(
        keyframes=[
            cfg.Keyframe(translation=np.array([0.0, 0, -10]), time=0.0, ease_type="Linear"),
            cfg.Keyframe(translation=np.array([5.0, 0, -10]), time=1.0, ease_type="Linear"),
        ]
    )
    frames = extract_frames(scheme, framerate=10.0)
    assert len(frames) == 10  # floor(1.0 * 10) (inner.rs:116-119)
    assert frames[0].scene_members[0].c[0] == pytest.approx(0.0)
    assert frames[5].scene_members[0].c[0] == pytest.approx(2.5)
    # non-animated members are shared verbatim
    assert frames[3].scene_members[1] is scheme.scene_members[1]


def test_mjpeg_avi(tmp_path):
    from raytrace.utils.video import write_mjpeg_avi

    frames = [np.full((32, 48, 3), c, np.uint8) for c in (0, 128, 255)]
    p = str(tmp_path / "out.avi")
    write_mjpeg_avi(p, frames, fps=10)
    data = open(p, "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert b"MJPG" in data and b"movi" in data and b"idx1" in data


def test_live_preview_server():
    """LivePreview serves the pushed frame over HTTP (the reference's
    live-window equivalent, ui_util.rs:56-168)."""
    import urllib.request

    from raytrace.utils.preview import LivePreview

    pv = LivePreview(port=0)
    pv.start()
    try:
        url = f"http://127.0.0.1:{pv.port}"
        page = urllib.request.urlopen(f"{url}/", timeout=5).read()
        assert b"raytrace" in page
        # no frame yet -> 404
        try:
            urllib.request.urlopen(f"{url}/frame", timeout=5)
            assert False, "expected 404 before first frame"
        except urllib.error.HTTPError as e:
            assert e.code == 404
        target = RenderTarget(8, 4)
        target.add(np.full((32, 3), 0.5, np.float32), 1)
        pv.update(target)
        png = urllib.request.urlopen(f"{url}/frame", timeout=5).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        from raytrace.utils.image import _decode
        assert _decode(png).shape == (4, 8, 4)
    finally:
        pv.stop()


def test_checkpoint_resume_exact(tmp_path):
    """A render interrupted at k spp, checkpointed, loaded, and
    continued must produce the SAME accumulator as an uninterrupted
    render: sample ids continue at target.count (renderer.render), and
    per-(pixel, sample) RNG streams make the continuation bit-exact
    (SURVEY.md §5 — the reference cannot resume at all)."""
    from raytrace.render.renderer import Renderer
    from raytrace.utils import checkpoint as ckpt

    scheme = _scheme()
    # pin to one device: with all (8 virtual) devices the renderer
    # spp-shards and rounds the per-call sample count up to a device
    # multiple (multi-device resume is covered in test_parallel.py)
    import jax

    dev = jax.devices()[:1]

    full = Renderer(scheme, devices=dev)
    full.render(samples=4, batch=2, progress=False)

    first = Renderer(scheme, devices=dev)
    first.render(samples=2, batch=2, progress=False)
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, first.target)

    resumed = Renderer(scheme, devices=dev)
    resumed.target = ckpt.load(path)
    assert resumed.target.count == 2
    resumed.render(samples=2, batch=2, progress=False)

    assert resumed.target.count == full.target.count == 4
    np.testing.assert_allclose(resumed.target.acc, full.target.acc, rtol=0, atol=0)


def test_async_update_hook():
    """The update hook runs on a writer thread against snapshots
    (latest-wins), never blocking the render loop; the FINAL state is
    always delivered, and hook exceptions surface at the end of
    render() instead of being swallowed (renderer.rs:44's mpsc
    decoupling, made checkable)."""
    import time

    from raytrace.render.renderer import Renderer

    scheme = _scheme()
    seen = []

    def slow_hook(target):
        time.sleep(0.05)  # slower than a batch: forces coalescing
        seen.append((target.count, target.acc.copy()))

    r = Renderer(scheme)
    img = r.render(samples=4, batch=1, update_hook=slow_hook, progress=False)
    # the final snapshot must always arrive, with the full accumulator
    assert seen[-1][0] == 4
    np.testing.assert_array_equal(seen[-1][1], r.target.acc)
    # counts only move forward (snapshots are consistent copies)
    counts = [c for c, _ in seen]
    assert counts == sorted(counts)

    def bad_hook(target):
        raise RuntimeError("boom")

    r2 = Renderer(scheme)
    with pytest.raises(RuntimeError, match="boom"):
        r2.render(samples=2, batch=1, update_hook=bad_hook, progress=False)


def test_encode_mp4_or_fallback(tmp_path):
    """encode_mp4 produces a playable container on BOTH encoder-present
    and encoder-absent machines: mp4 (ftyp box) when an imageio ffmpeg
    backend exists, else the self-contained MJPEG-AVI (RIFF) next to
    the requested path (reference: main.rs:58-97 encodes H.264/mp4)."""
    from raytrace.utils.video import encode_mp4

    frames = [
        (np.full((32, 48, 3), 40 * i, np.uint8)) for i in range(1, 4)
    ]
    want = str(tmp_path / "anim.mp4")
    got = encode_mp4(want, frames, fps=10)
    assert os.path.exists(got) and os.path.getsize(got) > 0
    head = open(got, "rb").read(12)
    if got.endswith(".mp4"):
        assert head[4:8] == b"ftyp", head
    else:
        assert got.endswith(".avi")
        assert head[:4] == b"RIFF" and head[8:12] == b"AVI ", head
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        # with OpenCV present (this image), real mp4 output is REQUIRED
        # (cv2's bundled MPEG-4 encoder needs no ffmpeg) and
        # must round-trip through a decoder
        assert got.endswith(".mp4"), got
        cap = cv2.VideoCapture(got)
        n = 0
        while cap.read()[0]:
            n += 1
        assert n == len(frames), n


def test_render_exact_sample_count_all_drivers():
    """render(samples=k) adds EXACTLY k samples on every driver —
    including the fused path's k < samples_per_dispatch tail, which
    once silently rounded up to spd."""
    from raytrace.render.renderer import Renderer

    scheme = _scheme()
    for kwargs in ({"driver": "plain"}, {"driver": "wavefront"}):
        r = Renderer(scheme, devices=jax.devices()[:1], **kwargs)
        r.render(samples=3, progress=False)
        assert r.target.count == 3, kwargs
        r.render(samples=2, progress=False)
        assert r.target.count == 5, kwargs

    # fused-path branch logic: k < spd must route through the plain
    # integrator tile loop, never touching the packed fused step
    r = Renderer(scheme, devices=jax.devices()[:1], driver="plain")
    r.driver, r.spd = "fused", 4

    def _boom(*a, **k):
        raise AssertionError("fused step must not run for k < spd")

    r._fstep = _boom
    r.render(samples=2, progress=False)
    assert r.target.count == 2
    # ... and a k >= spd chunk leaves the tail to the plain path too:
    # assert the contract arithmetic never rounds up
    r2 = Renderer(scheme, devices=jax.devices()[:1], driver="plain")
    r2.driver, r2.spd = "fused", 4
    seen = []

    def _fake_fstep(*a, **k):
        n = int(k["n_samples"])
        seen.append(n)
        xs = k["xs"]
        return jnp.zeros((xs.size, 3), jnp.float32)

    r2._fstep = _fake_fstep
    # flat stand-ins for the fused lanes/tables the plain Renderer
    # never built (the driver was switched after init)
    r2._fxs = jnp.zeros((W * H,), jnp.int32)
    r2._fys = r2._fxs
    r2._frep = r2._fxs
    r2._tables = r2._cam_vec = None
    r2.render(samples=6, progress=False)
    assert seen == [4]          # one packed dispatch of spd
    assert r2.target.count == 6  # 4 fused + 2 exact-tail plain


def test_adapt_dispatch_spp_policy():
    """Mesh dispatch sizing: double while dispatches are fast, halve
    when they run long, never exceed the ceiling or drop below 1."""
    from raytrace.render.renderer import adapt_dispatch_spp

    # fast dispatch -> double, up to the ceiling
    assert adapt_dispatch_spp(16, 3.0, 256) == 32
    assert adapt_dispatch_spp(128, 3.0, 256) == 256
    assert adapt_dispatch_spp(200, 3.0, 256) == 200   # 2x would exceed
    assert adapt_dispatch_spp(256, 3.0, 256) == 256
    # comfortable middle ground -> hold
    assert adapt_dispatch_spp(64, 20.0, 256) == 64
    # slow dispatch -> halve, floor at 1
    assert adapt_dispatch_spp(64, 40.0, 256) == 32
    assert adapt_dispatch_spp(1, 40.0, 256) == 1
    # growth threshold bounds the next dispatch: after a grow, the
    # worst-case next time is ~2x the 15 s threshold
    assert adapt_dispatch_spp(16, 14.9, 256) == 32
    assert adapt_dispatch_spp(16, 15.0, 256) == 16
