"""Quick end-to-end smoke: render a scene at reduced size.

    python scripts/smoke_render.py [scene] [scale] [spp] [out.png]

scene: a scheme YAML path, or one of the procedural scenes "textured"
(default; biplane class), "surface" (a380 class) or "walled". Runs on
the CPU unless SMOKE_PLATFORM names another JAX platform (e.g. gpu).
"""
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = os.environ.get("SMOKE_PLATFORM", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from raytrace.models import procedural
from raytrace.models.scene import build_scene
from raytrace.render.renderer import Renderer
from raytrace.utils.image import save_png

name = sys.argv[1] if len(sys.argv) > 1 else "textured"
scale = int(sys.argv[2]) if len(sys.argv) > 2 else 4
spp = int(sys.argv[3]) if len(sys.argv) > 3 else 8
out = sys.argv[4] if len(sys.argv) > 4 else os.path.join(os.getcwd(), "smoke.png")

w, h = 1200 // scale, 600 // scale
t0 = time.time()
if name == "walled":
    from __graft_entry__ import _inline_walled_scheme

    scheme, scene = _inline_walled_scheme(w, h, assured=5), None
elif name in ("textured", "surface"):
    make = procedural.textured_scene if name == "textured" else procedural.surface_scene
    scheme, meshes = make(w, h, spp)
    scene = build_scene(scheme, meshes=meshes)
else:
    from raytrace.models.config import load_scheme

    scheme, scene = load_scheme(name), None
    scheme.render_info.width //= scale
    scheme.render_info.height //= scale

r = Renderer(scheme, scene=scene)
print(f"scene: {r.scene.n_spheres} spheres, {r.scene.n_free_tris} free tris, "
      f"{r.scene.n_mesh_tris} mesh tris, cubemap={r.scene.has_cubemap}; "
      f"driver={r.driver} hit={r.hit}", flush=True)
print(f"build: {time.time()-t0:.1f}s", flush=True)

t0 = time.time()
img = r.render(samples=spp, batch=spp, progress=False)
dt = time.time() - t0
n_paths = r.width * r.height * spp
print(f"rendered {r.width}x{r.height} @ {spp}spp in {dt:.1f}s "
      f"({n_paths/dt/1e6:.2f} Mpaths/s, compile included)", flush=True)
print("image stats: min", img.min(axis=(0, 1)), "max", img.max(axis=(0, 1)),
      "mean", img.mean(axis=(0, 1)), flush=True)
assert np.isfinite(img).all(), "NaN/inf in image!"

save_png(out, r.target.to_u8_rgba())
print("saved", out, flush=True)
