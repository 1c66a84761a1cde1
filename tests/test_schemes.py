"""Every reference scheme whose assets exist in this snapshot must
load through the scheme-compat YAML parser and build a packed scene
(the reference treats schemes/*.yml as its end-to-end fixtures,
README.md:287-347); the cheap ones also tiny-render on both drivers.

Schemes whose glTF assets are absent from the snapshot (the reference
itself cannot load them either) are skipped by the asset probe.
"""
import os
import re
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytrace.models.config import load_scheme
from raytrace.models.scene import build_scene

REFERENCE = os.environ.get(  # a checkout of the reference renderer
    "RAYTRACE_REFERENCE",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "reference"),
)
SCHEMES = os.path.join(REFERENCE, "schemes")


def _loadable(name):
    """True when every asset path the scheme mentions exists (resolved
    the way the loader resolves them: '../../assets/<suffix>' is
    accepted as <scheme_dir>/../assets/<suffix>)."""
    path = os.path.join(SCHEMES, name)
    if not os.path.exists(path):
        return False
    text = open(path).read()
    for rel in re.findall(r'"(\.\.[^"]+)"', text):
        suffix = rel.split("assets/", 1)[-1]
        asset = os.path.normpath(os.path.join(SCHEMES, "..", "assets", suffix))
        if not os.path.exists(asset):
            return False
        if asset.endswith(".gltf"):
            # a380's scene.gltf survives but its scene.bin buffer does
            # not — probe the buffer uris too
            gdir = os.path.dirname(asset)
            for uri in re.findall(r'"uri"\s*:\s*"([^"]+)"', open(asset).read()):
                if not uri.startswith("data:") and not os.path.exists(
                    os.path.join(gdir, uri)
                ):
                    return False
    return True


ALL = [
    "walled.yml", "triangles.yml", "outside_spheres.yml", "bounce_anim.yml",
    "biplane.yml", "biplane_anim.yml", "spaceship_r1.yml", "a380.yml",
    "shuttle_stack.yml", "voyager.yml", "discovery_shuttle.yml",
    "james_webb.yml",
]
LOADABLE = [n for n in ALL if _loadable(n)]


@pytest.mark.parametrize("name", ALL)
def test_scheme_builds(name):
    if name not in LOADABLE:
        pytest.skip("assets absent from this reference snapshot")
    scheme = load_scheme(os.path.join(SCHEMES, name))
    scene = build_scene(scheme)
    total = (
        int(scene.n_spheres) + int(scene.n_free_tris) + int(scene.n_mesh_tris)
    )
    assert total > 0 or scene.has_cubemap
    assert scheme.render_info.width > 0 and scheme.render_info.height > 0
    if scheme.render_info.animation and any(
        getattr(m, "animation", None) is not None for m in scheme.scene_members
    ):
        from raytrace.models.animation import last_timestamp

        assert last_timestamp(scheme) > 0.0


@pytest.mark.parametrize("name", ["triangles.yml", "bounce_anim.yml"])
def test_cheap_scheme_tiny_render(name):
    """Meshless schemes render a small frame on both drivers and the
    drivers agree (same RNG streams; accumulation order differs)."""
    if name not in LOADABLE:
        pytest.skip("assets absent from this reference snapshot")
    from raytrace.render.renderer import Renderer

    scheme = load_scheme(os.path.join(SCHEMES, name))
    scheme.render_info.width = 48
    scheme.render_info.height = 32
    imgs = []
    for driver in ("plain", "wavefront"):
        r = Renderer(scheme, driver=driver)
        imgs.append(np.asarray(r.render(samples=2, batch=2, progress=False)))
    assert np.isfinite(imgs[0]).all()
    assert imgs[0].mean() > 0.0
    np.testing.assert_allclose(imgs[0], imgs[1], rtol=2e-4, atol=2e-4)
