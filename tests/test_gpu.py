"""The kernels as compiled for the card (no interpret mode) vs their
XLA references, at small sizes. Marked `gpu`: they skip without an
NVIDIA GPU and run on the card as a phase of chip_smoke.py."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (compiled Triton kernels)")
    return dev


def test_trace_kernel_compiled_matches_integrator(gpu):
    from __graft_entry__ import _inline_walled_scheme
    from raytrace.render.renderer import Renderer, sample_batch

    w, h = 64, 32
    r = Renderer(_inline_walled_scheme(w, h, assured=3), devices=[gpu],
                 samples_per_dispatch=2)
    assert r.driver == "fused" and not r.interpret
    img = r.render(samples=2, progress=False).reshape(-1, 3)
    flat = np.arange(w * h, dtype=np.int32)
    ref = sample_batch(r.scene, r.cam_arrays, r.params, w, h,
                       jnp.asarray(flat % w), jnp.asarray(flat // w),
                       jnp.int32(0), jnp.int32(2))
    ref = np.asarray(ref) / 2.0
    rel = np.abs(img - ref) / (np.abs(ref) + 1e-3)
    assert (rel > 1e-3).mean() < 0.01


def test_hit_kernel_compiled_matches_cluster_walk(gpu):
    from test_hit_kernel import _compare_compiled

    _compare_compiled()
