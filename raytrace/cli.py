"""CLI entry — the main.rs analogue.

    python -m raytrace.cli <scheme.yml> [no_ui] [options]

Static schemes render to render_out.png with a progress bar and a PNG
update after every sample batch (the reference's no-ui output loop,
ui_util.rs:37-54). Animation schemes (`animation: true`) render
per-frame PNGs to ./anim_frames/N.png with the scene build of frame
k+1 overlapped with the render of frame k (renderer.rs:114-167's
producer/consumer, depth `anim_pipeline_depth`), then encode a video
(mp4 when an encoder exists, MJPEG-AVI fallback — utils/video.py).
There is no interactive window in this build; `no_ui` is accepted for
scheme-compatibility and is the only behavior.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def main(argv=None):
    ap = argparse.ArgumentParser(description="differentiable Monte-Carlo path tracer")
    ap.add_argument("scheme", help="scheme YAML path")
    ap.add_argument("no_ui", nargs="?", default=None, help="compat positional (no window in this build)")
    ap.add_argument("--mode", choices=["gpu", "cpu"], default=None,
                    help="reference-semantics mode (default: from use_gpu)")
    ap.add_argument("--out", default="render_out.png")
    ap.add_argument("--samples", type=int, default=None, help="override samps_per_pix")
    ap.add_argument("--scale", type=int, default=1, help="divide width/height by this (smoke runs)")
    ap.add_argument("--checkpoint", default=None, help="save resume state here after each batch")
    ap.add_argument("--resume", default=None, help="resume from a checkpoint file")
    ap.add_argument("--platform", default=None, help="jax platform override (cpu/gpu)")
    ap.add_argument("--preview", type=int, default=None, metavar="PORT",
                    help="serve a live browser preview on this port (the "
                    "reference's live window, ui_util.rs:56-168)")
    args = ap.parse_args(argv)

    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
    from .utils.cache import enable_compile_cache

    enable_compile_cache()

    from .models.config import load_scheme
    from .render.renderer import Renderer
    from .utils import checkpoint as ckpt
    from .utils.image import save_png

    scheme = load_scheme(args.scheme)
    info = scheme.render_info
    if args.scale > 1:
        info.width //= args.scale
        info.height //= args.scale

    if info.animation:
        return _render_animation(scheme, args)

    renderer = Renderer(scheme, mode=args.mode)
    if args.resume:
        loaded = ckpt.load(args.resume)
        if (loaded.width, loaded.height) != (renderer.width, renderer.height):
            raise SystemExit(
                f"checkpoint is {loaded.width}x{loaded.height}, "
                f"scheme renders {renderer.width}x{renderer.height}"
            )
        renderer.target = loaded
        print(f"resumed at {renderer.target.count} spp "
              "(sample streams continue where they left off)", flush=True)

    preview = None
    if args.preview is not None:
        from .utils.preview import LivePreview

        preview = LivePreview(port=args.preview)
        preview.start()
        print(f"live preview: http://127.0.0.1:{preview.port}/", flush=True)

    def hook(target):
        save_png(args.out, target.to_u8_rgba())
        if args.checkpoint:
            ckpt.save(args.checkpoint, target)
        if preview is not None:
            preview.update(target)

    t0 = time.time()
    renderer.render(samples=args.samples, update_hook=hook)
    save_png(args.out, renderer.target.to_u8_rgba())
    print(f"saved {args.out} ({renderer.target.count} spp, {time.time()-t0:.1f}s)", flush=True)


def _render_animation(scheme, args):
    import numpy as np

    from .models.animation import extract_frames
    from .models.scene import build_scene
    from .render.renderer import Renderer
    from .utils.image import load_png, save_png
    from .utils.video import encode_mp4

    info = scheme.render_info
    framerate = info.framerate
    if framerate is None:
        raise SystemExit("animation: true requires framerate")

    frames = extract_frames(scheme, framerate)
    print(f"Extracting frames:\n\t Number of frames: {len(frames)}"
          f"\n\t Time per frame {1.0/framerate:.4f}s", flush=True)

    if os.path.isdir("./anim_frames"):
        shutil.rmtree("./anim_frames")  # main.rs:51
    os.makedirs("./anim_frames", exist_ok=True)

    depth = info.anim_pipeline_depth or 2
    pool = ThreadPoolExecutor(max_workers=1)

    def build(frame_scheme):
        return build_scene(frame_scheme)

    pending = []
    for k in range(min(depth, len(frames))):
        pending.append(pool.submit(build, frames[k]))

    t_all = time.time()
    for i, frame_scheme in enumerate(frames):
        scene = pending.pop(0).result()
        nxt = i + len(pending) + 1
        if nxt < len(frames):
            pending.append(pool.submit(build, frames[nxt]))
        t0 = time.time()
        r = Renderer(frame_scheme, mode=args.mode, scene=scene)
        r.render(samples=args.samples, progress=False)
        save_png(f"./anim_frames/{i}.png", r.target.to_u8_rgba())
        print(f"frame {i+1}/{len(frames)} in {time.time()-t0:.1f}s", flush=True)

    # numeric-sorted frame encode (main.rs:69-84)
    names = sorted(os.listdir("./anim_frames"), key=lambda p: int(p.split(".")[0]))
    # video frames are top-row-first; load_png returns bottom-first
    imgs = [load_png(os.path.join("./anim_frames", p))[::-1, :, :3] for p in names]
    out = encode_mp4("animation.mp4", imgs, framerate)
    print(f"encoded {out} ({len(imgs)} frames @ {framerate} fps, "
          f"total {time.time()-t_all:.1f}s)", flush=True)


if __name__ == "__main__":
    main()
