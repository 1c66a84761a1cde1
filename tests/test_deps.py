"""What the main path needs: no flax, PyYAML or Pillow between
parse_scheme, Renderer.render and save_png; the zlib PNG writer; the
compile-cache directory."""
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", **(env_extra or {}))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_main_path_without_flax_yaml_pil(tmp_path):
    code = f"""
import sys
for m in ("flax", "yaml", "PIL"):
    sys.modules[m] = None  # import of a blocked module raises
from __graft_entry__ import _inline_walled_scheme
from raytrace.models import procedural
from raytrace.models.scene import build_scene
from raytrace.render.renderer import Renderer
from raytrace.utils.image import save_png
r = Renderer(_inline_walled_scheme(16, 8), samples_per_dispatch=1)
r.render(samples=1, progress=False)
save_png({str(tmp_path / 'w.png')!r}, r.target.to_u8_rgba())
scheme, meshes = procedural.textured_scene(16, 8, 1, tex_size=8, sky_size=4)
Renderer(scheme, scene=build_scene(scheme, meshes=meshes)).render(samples=1, progress=False)
print("ok", sorted(m for m in ("flax", "yaml", "PIL") if sys.modules.get(m)))
"""
    assert _run(code).strip().endswith("ok []")
    assert (tmp_path / "w.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_png_round_trip(tmp_path):
    from raytrace.utils.image import _decode, encode_png, load_png, save_png

    rng = np.random.default_rng(0)
    for shape in ((5, 7, 3), (4, 9, 4)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        path = str(tmp_path / f"i{shape[2]}.png")
        save_png(path, img)
        np.testing.assert_array_equal(load_png(path), img)  # flip undone
        np.testing.assert_array_equal(_decode(encode_png(img)), img[::-1])


def test_png_decodes_filtered_rows():
    """Rows written with the Sub/Up/Average/Paeth filters (as other
    encoders do) decode to the same pixels."""
    import struct
    import zlib

    from raytrace.utils.image import _chunk, _decode, _SIG

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    h, w, c = img.shape
    rows, prev = [], np.zeros(w * c, np.int32)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int32)
        f = y % 5
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        rows.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    data = (_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(b"".join(rows))) + _chunk(b"IEND", b""))
    np.testing.assert_array_equal(_decode(data), img)


def test_compile_cache_dir_default():
    code = """
import jax
from raytrace.utils.cache import CHECKOUT, enable_compile_cache
import os
path = enable_compile_cache()
assert path == os.path.join(CHECKOUT, ".jax_cache"), path
assert jax.config.jax_compilation_cache_dir == path
print("ok")
"""
    assert _run(code).strip() == "ok"


def test_compile_cache_dir_from_env(tmp_path):
    code = """
import jax, os
from raytrace.utils.cache import enable_compile_cache
path = enable_compile_cache()
assert path == os.environ["JAX_COMPILATION_CACHE_DIR"], path
assert jax.config.jax_compilation_cache_dir == path
print("ok")
"""
    out = _run(code, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cc")})
    assert out.strip() == "ok"
