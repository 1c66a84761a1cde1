"""Distribution tests on the virtual 8-device CPU mesh: the sharded
render step must agree with the single-device renderer, and the train
step must produce finite replicated grads."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytrace.models import config as cfg
from raytrace.models.camera import build_camera
from raytrace.models.scene import build_scene
from raytrace.parallel.distributed import make_render_step, make_train_step
from raytrace.parallel.mesh import make_mesh
from raytrace.render.integrator import IntegratorParams
from raytrace.render.renderer import camera_to_arrays, sample_batch

W, H = 64, 32


def _tiny_scheme():
    raw = {
        "render_info": {
            "width": W, "height": H, "samps_per_pix": 4,
            "kd_tree_depth": 0,
            "rad_info": {
                "debug_single_ray": False, "dir_light_samp": False,
                "russ_roull_info": {"assured_depth": 2, "max_thres": 0.5},
            },
            "use_gpu": True,
        },
        "cam": {
            "d": [0, 0, -5], "o": [0, 0, 0], "up": [0, 1, 0],
            "view_eulers": [0, 0, 0],
            "screen_width": 10.0, "screen_height": 5.0,
        },
        "scene_members": [
            cfg.Tagged("Sphere", {
                "c": [0, 0, -12], "r": 3.0,
                "coloring": cfg.Tagged("Solid", [0.6, 0.2, 0.8]),
                "mat": {"divert_ray": "Diff"},
            }),
            cfg.Tagged("Sphere", {
                "c": [0, 8, -12], "r": 4.0,
                "coloring": cfg.Tagged("Solid", [0, 0, 0]),
                "mat": {"divert_ray": "Diff", "emissive": [5.0, 5.0, 5.0]},
            }),
            cfg.Tagged("FreeTriangle", {
                "verts": [[-8, -3, -16], [8, -3, -16], [0, 9, -16]],
                "norm": [0, 0, 1], "rgb": [0.9, 0.9, 0.5],
                "mat": {"divert_ray": cfg.Tagged("DiffSpec", {"diffp": 0.5})},
            }),
        ],
    }
    return cfg.parse_scheme(raw)


@pytest.fixture(scope="module")
def setup():
    scheme = _tiny_scheme()
    scene = build_scene(scheme)
    cam = camera_to_arrays(build_camera(scheme.cam, W, H))
    params = IntegratorParams(assured_depth=2, max_bounces=12)
    flat = np.arange(W * H, dtype=np.int32)
    x_idx = jnp.asarray(flat % W)
    y_idx = jnp.asarray(flat // W)
    return scene, cam, params, x_idx, y_idx


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_matches_single_device(setup):
    scene, cam, params, x_idx, y_idx = setup
    mesh = make_mesh(tile=4, spp=2)
    step, spp_size = make_render_step(mesh, W, H)
    out = step(scene, cam, params, x_idx, y_idx, jnp.int32(0), jnp.int32(2))
    out = np.asarray(out)
    assert out.shape == (W * H, 3)
    assert np.isfinite(out).all()

    # single-device equivalent: same per-(pixel, sample-index) streams
    ref0 = sample_batch(scene, cam, params, W, H, x_idx, y_idx, jnp.int32(0), jnp.int32(2))
    ref1 = sample_batch(scene, cam, params, W, H, x_idx, y_idx, jnp.int32(2), jnp.int32(2))
    ref = np.asarray(ref0 + ref1)
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def test_train_step_grads(setup):
    scene, cam, params, x_idx, y_idx = setup
    params = params.replace(differentiable=True, max_bounces=4)
    mesh = make_mesh(tile=4, spp=2)
    train = make_train_step(mesh, W, H, n_samples=1)
    target = jnp.zeros((W * H, 3))
    loss, (gscene, gcam) = train(
        scene, cam, params, x_idx, y_idx, jnp.int32(0), target
    )
    assert np.isfinite(float(loss))
    # geometry grads are finite; for Diff/Spec-only scenes the radiance
    # is a product of gathered constants, so POINTWISE sph_c grads are
    # legitimately ~0 (visibility gradients need edge sampling; nonzero
    # pointwise geometry grads come from angle-dependent weights like
    # dielectric fresnel / PBR reflectance — covered in test_diff.py)
    assert np.isfinite(np.asarray(gscene["sph_c"])).all()
    assert np.isfinite(np.asarray(gcam.o)).all()
    # appearance grads must be nonzero
    assert np.abs(np.asarray(gscene["sph_emissive"])).max() > 0
    assert np.abs(np.asarray(gscene["sph_rgb"])).max() > 0

    # cross-check against the single-device gradient of the SAME loss
    # (2 spp shards -> samples {0, 1})
    def ref_loss(em, rgb):
        sc = scene.replace(sph_emissive=em, sph_rgb=rgb)
        acc0 = sample_batch(sc, cam, params, W, H, x_idx, y_idx, jnp.int32(0), 1)
        acc1 = sample_batch(sc, cam, params, W, H, x_idx, y_idx, jnp.int32(1), 1)
        img = (acc0 + acc1) / 2.0
        return jnp.mean((img - target) ** 2)

    ref_l, ref_g = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        scene.sph_emissive, scene.sph_rgb
    )
    np.testing.assert_allclose(float(loss), float(ref_l), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(gscene["sph_emissive"]), np.asarray(ref_g[0]), rtol=1e-3, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(gscene["sph_rgb"]), np.asarray(ref_g[1]), rtol=1e-3, atol=1e-6
    )


def test_wavefront_render_step_matches_single(setup):
    """8-device spp-sharded wavefront == one wavefront over the full
    sample range (disjoint contiguous sample slices, same streams)."""
    from raytrace.parallel.distributed import make_wavefront_render_step
    from raytrace.render.wavefront import wavefront_batch

    scene, cam, params, x_idx, y_idx = setup
    mesh = make_mesh()
    step, n_dev = make_wavefront_render_step(mesh, W, H, pool=1024)
    out = np.asarray(step(scene, cam, params, x_idx, y_idx, jnp.int32(0), jnp.int32(2)))
    ref = np.asarray(
        wavefront_batch(scene, cam, params, x_idx, y_idx, jnp.int32(0),
                        jnp.int32(2 * n_dev), width=W, height=H, pool=1024)
    )
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_renderer_multi_device_matches_single():
    """The PRODUCT multi-device path: Renderer(devices=all 8) spp-shards
    every dispatch via parallel.make_spp_sharded_step and must agree
    with the single-device Renderer over the same total sample range
    (identical per-(pixel, sample) streams; psum order is the only
    difference)."""
    from raytrace.render.renderer import Renderer

    scheme = _tiny_scheme()
    r1 = Renderer(scheme, devices=jax.devices()[:1])
    assert r1.n_devices == 1 and r1._mesh1d is None
    img1 = r1.render(samples=8, batch=8, progress=False)

    r8 = Renderer(scheme, devices=jax.devices())
    assert r8.n_devices == 8 and r8._mesh1d is not None
    img8 = r8.render(samples=8, batch=8, progress=False)

    np.testing.assert_allclose(img8, img1, rtol=2e-5, atol=2e-5)


def test_spp_sharded_step_generic():
    """make_spp_sharded_step with the plain sample-batch driver: the
    8-device psum equals the sequential sum of the 8 sample slices."""
    from raytrace.parallel.distributed import make_spp_sharded_step
    from jax.sharding import Mesh

    scheme = _tiny_scheme()
    scene = build_scene(scheme)
    cam = camera_to_arrays(build_camera(scheme.cam, W, H))
    params = IntegratorParams(assured_depth=2, max_bounces=6)
    flat = np.arange(W * H, dtype=np.int32)
    x_idx = jnp.asarray(flat % W)
    y_idx = jnp.asarray(flat // W)

    def inner(scene, cam, params, x_idx, y_idx, sample_base, n_samples):
        return sample_batch(scene, cam, params, W, H, x_idx, y_idx, sample_base, n_samples)

    mesh = Mesh(np.asarray(jax.devices()), ("spp",))
    step, n_dev = make_spp_sharded_step(mesh, inner, {})
    assert n_dev == 8
    out = np.asarray(step(scene, cam, params, x_idx, y_idx, jnp.int32(0), jnp.int32(1)))

    ref = np.zeros((W * H, 3), np.float32)
    for d in range(8):
        ref = ref + np.asarray(
            sample_batch(scene, cam, params, W, H, x_idx, y_idx, jnp.int32(d), jnp.int32(1))
        )
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
