"""On-card smoke test: the renderer's main paths at full size on one
NVIDIA GPU, each compared with the plain XLA integrator.

    python chip_smoke.py            # one card: walled, two mesh scenes,
                                    # gradients, the `gpu`-marked tests
    python chip_smoke.py --multi    # four cards: spp-sharded render + train step

Every phase runs through `Renderer` (or the distributed train step) on
explicitly passed devices. A phase that fails raises; nothing is caught.
The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}},
N the number of cards the phases ran on (1, or 4 with --multi).
Without a GPU the script exits nonzero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

FULL_W, FULL_H = 1200, 600


def log(*a):
    print(*a, flush=True)


def gpu_info() -> str:
    """`nvidia-smi` name and power limit of the visible cards."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# comparisons (section 3 of the bring-up: tolerances with their reasons)


def compare_radiance(out, ref, what: str):
    """Per-pixel relative error above 1e-3 on under 1% of pixels: the
    kernel and the integrator run the same counter-RNG streams, so
    only reassociation and FMA contraction differ."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape and np.isfinite(out).all(), what
    rel = np.abs(out - ref) / (np.abs(ref) + 1e-3)
    frac = float((rel > 1e-3).mean())
    log(f"  {what}: {frac:.5f} of pixel channels off by > 1e-3 relative "
        f"(limit 0.01); max rel {float(rel.max()):.3e}")
    assert frac < 0.01, what


def compare_means(img, ref, what: str):
    """Per-channel image means within 1e-3 relative: same sample ids,
    so only the accumulation order differs (scatter-add atomics)."""
    m, r = np.asarray(img).reshape(-1, 3).mean(0), np.asarray(ref).reshape(-1, 3).mean(0)
    rel = np.abs(m - r) / np.maximum(np.abs(r), 1e-12)
    log(f"  {what}: means {m.tolist()} vs {r.tolist()}, rel {rel.tolist()} (limit 1e-3)")
    assert np.isfinite(np.asarray(img)).all() and (rel < 1e-3).all(), what


def compare_hits(got, ref, what: str):
    """Kernel vs _mesh_hit_clusters: where both hit, relative t error
    <= 1e-5; ids equal except at ties, where the two triangles are hit
    at the same distance (bitwise, or within 1e-6 relative when FMA
    contraction rounds the two candidates apart)."""
    gt, gi = np.asarray(got[0]), np.asarray(got[1])
    rt, ri = np.asarray(ref[0]), np.asarray(ref[1])
    assert ((gi >= 0) == (ri >= 0)).all(), f"{what}: hit/miss sets differ"
    hit = ri >= 0
    dt = np.zeros_like(rt)
    dt[hit] = np.abs(gt[hit] - rt[hit])
    t_rel = dt[hit] / np.abs(rt[hit])
    diff = hit & (gi != ri)
    bitwise = diff & (gt == rt)
    near = diff & (dt <= 1e-6 * np.abs(rt))
    log(f"  {what}: {int(hit.sum())} hits of {hit.size} rays; max rel t err "
        f"{float(t_rel.max()):.3e} (limit 1e-5); id mismatches {int(diff.sum())} "
        f"({int(bitwise.sum())} bitwise ties, {int((near & ~bitwise).sum())} within 1e-6)")
    assert float(t_rel.max()) <= 1e-5, what
    assert not (diff & ~near).any(), what


def compare_train_step(loss, grads, loss_ref, grads_ref, what: str):
    """Sharded train step vs one card over the same samples: the loss
    within 1e-5 relative, each gradient leaf within 1e-4 of its largest
    reference magnitude. Only the order of the psums differs."""
    rel = abs(loss - loss_ref) / abs(loss_ref)
    worst = 0.0
    for k in grads_ref:
        g, r = np.asarray(grads[k]), np.asarray(grads_ref[k])
        assert g.shape == r.shape and np.isfinite(g).all(), (what, k)
        scale = float(np.abs(r).max()) if r.size else 0.0
        if scale > 0:
            worst = max(worst, float(np.abs(g - r).max()) / scale)
    log(f"  {what}: loss {loss:.7f} vs {loss_ref:.7f}, rel {rel:.3e} (limit 1e-5); "
        f"worst gradient leaf off by {worst:.3e} of its scale (limit 1e-4)")
    assert rel <= 1e-5 and worst <= 1e-4, what


# ---------------------------------------------------------------------------
# phases


def _timed_render(r, spp):
    t0 = time.time()
    img = r.render(samples=spp, batch=spp, progress=False)
    dt = time.time() - t0
    return img, dt


def phase_walled(dev, width=FULL_W, height=FULL_H, spp=64, interpret=False):
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _inline_walled_scheme
    from raytrace.ops.pallas import trace_kernel as tk
    from raytrace.render.renderer import Renderer, sample_batch, sample_batch_fused

    log(f"[walled] {width}x{height}, {spp} spp")
    scheme = _inline_walled_scheme(width, height, assured=5)
    kw = dict(driver="fused", interpret=True) if interpret else {}
    r = Renderer(scheme, devices=[dev], **kw)
    log(f"  driver={r.driver} hit={r.hit} spd={r.spd}")
    assert r.driver == "fused" and r.hit == "none"
    _, dt = _timed_render(r, r.spd)
    log(f"  compile + first dispatch ({r.spd} spp): {dt:.2f} s")
    img, dt = _timed_render(r, spp)
    assert np.isfinite(img).all() and img.mean() > 0
    log(f"  {spp} spp in {dt:.3f} s: {width * height * spp / dt / 1e6:.1f} Mpaths/s "
        f"(information only); image mean {img.reshape(-1, 3).mean(0).tolist()}")

    # kernel vs sample_batch: 2 spp, same streams, natural pixel order,
    # in-kernel regeneration of the second sample
    n = width * height
    flat = np.arange(n, dtype=np.int32)
    xs, ys = jnp.asarray(flat % width), jnp.asarray(flat // width)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda sc: sample_batch(
            sc, r.cam_arrays, r.params, width, height, xs, ys,
            jnp.int32(0), jnp.int32(2)))(r.scene)
        n_pad = -(-n // tk.BLOCK) * tk.BLOCK
        pad = lambda a: jnp.concatenate([a, jnp.zeros((n_pad - n,), jnp.int32)])
        out = jax.jit(lambda sc: sample_batch_fused(
            r._tables, r._cam_vec, sc, r.params, width, height,
            pad(xs), pad(ys), jnp.zeros((n_pad,), jnp.int32),
            jnp.int32(0), jnp.int32(2), samples_per_dispatch=2,
            samples_per_lane=2, hints=r._hints, interpret=interpret))(r.scene)
    compare_radiance(np.asarray(out)[:n], ref, "trace kernel vs sample_batch (2 spp)")


def _mesh_case(name, scheme, meshes, dev, spp, interpret):
    from raytrace.models.scene import build_scene
    from raytrace.render.renderer import Renderer

    t0 = time.time()
    scene = build_scene(scheme, meshes=meshes)
    pool_bytes = int(np.asarray(scene.tex_pool).nbytes + np.asarray(scene.sky_pool).nbytes)
    log(f"[{name}] {scheme.render_info.width}x{scheme.render_info.height}, {spp} spp: "
        f"{scene.n_mesh_tris} triangles, {scene.n_clusters} clusters, "
        f"texel pools {pool_bytes} bytes, built in {time.time() - t0:.1f} s")
    kw = dict(hit="triton", interpret=True) if interpret else {}
    r = Renderer(scheme, scene=scene, devices=[dev], **kw)
    log(f"  driver={r.driver} hit={r.hit}")
    assert r.driver == "wavefront" and r.hit == "triton"
    _, dt = _timed_render(r, 1)
    log(f"  compile + first dispatch (1 spp): {dt:.2f} s")
    img, dt = _timed_render(r, spp)
    w, h = scheme.render_info.width, scheme.render_info.height
    assert np.isfinite(img).all() and img.mean() > 0
    log(f"  {spp} spp in {dt:.3f} s: {w * h * spp / dt / 1e6:.3f} Mpaths/s "
        f"(information only); image mean {img.reshape(-1, 3).mean(0).tolist()}")
    return scene


def _quarter_render_check(name, make, dev, spp, interpret):
    """The kernel path vs the plain integrator (XLA cluster cull) on
    the same scene at a quarter of the size, same sample ids."""
    from raytrace.models.scene import build_scene
    from raytrace.render.renderer import Renderer

    scheme, meshes = make()
    scene = build_scene(scheme, meshes=meshes)
    kw = dict(interpret=True) if interpret else {}
    fast = Renderer(scheme, scene=scene, devices=[dev], hit="triton", **kw)
    plain = Renderer(scheme, scene=scene, devices=[dev], driver="plain", hit="clusters")
    assert fast.driver == "wavefront"
    img = fast.render(samples=spp, batch=spp, progress=False)
    ref = plain.render(samples=spp, batch=spp, progress=False)
    compare_means(img, ref, f"{name} at {scheme.render_info.width}x"
                  f"{scheme.render_info.height}, {spp} spp: wavefront+kernel vs plain integrator")


def _hit_rays(scene, scheme, n_rays, seed=0):
    """n_rays rays: half primary camera rays (spread over the image),
    half secondary rays leaving the primary hit points into random
    directions of the outer hemisphere (primary misses re-enter from
    the camera); every 16th lane dead (-INF seed)."""
    import jax.numpy as jnp

    from raytrace.models.camera import build_camera
    from raytrace.ops import raygen, rng
    from raytrace.render.integrator import IntegratorParams, _mesh_hit_clusters
    from raytrace.render.renderer import camera_to_arrays

    w, h = scheme.render_info.width, scheme.render_info.height
    cam = camera_to_arrays(build_camera(scheme.cam, w, h))
    half = n_rays // 2
    pix = np.arange(half, dtype=np.int64) * (w * h) // half
    xs, ys = jnp.asarray((pix % w).astype(np.int32)), jnp.asarray((pix // w).astype(np.int32))
    _, ro_v, rd_v = raygen.generate(rng.init_state(xs, ys, w, h, jnp.int32(seed)), xs, ys, cam)
    t, i, _, _ = _mesh_hit_clusters(scene, IntegratorParams(), ro_v, rd_v,
                                    jnp.full((half,), jnp.inf))
    ro = np.stack([np.asarray(a) for a in ro_v], 1)
    rd = np.stack([np.asarray(a) for a in rd_v], 1)
    t, i = np.asarray(t), np.asarray(i)
    hit = i >= 0
    tri = np.maximum(i, 0)
    nrm = np.cross(np.asarray(scene.mt_e1)[tri], np.asarray(scene.mt_e2)[tri])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    nrm *= np.where((nrm * rd).sum(1) > 0, -1.0, 1.0)[:, None]
    d2 = np.random.default_rng(seed).normal(size=(half, 3))
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    d2 *= np.where((d2 * nrm).sum(1) < 0, -1.0, 1.0)[:, None]
    o2 = np.where(hit[:, None], ro + rd * np.where(hit, t, 0.0)[:, None] + nrm * 1e-4, ro)
    o = np.concatenate([ro, o2]).astype(np.float32)
    d = np.concatenate([rd, d2]).astype(np.float32)
    seed_t = np.full((n_rays,), np.inf, np.float32)
    seed_t[::16] = -np.inf
    return o, d, seed_t


def phase_hit_compare(scene, scheme, n_rays=131_072, interpret=False):
    """Hit kernel vs _mesh_hit_clusters on primary + secondary rays."""
    import jax
    import jax.numpy as jnp

    from raytrace.ops.pallas.hit_kernel import mesh_hit
    from raytrace.ops.vec import Vec3
    from raytrace.render.integrator import IntegratorParams, _mesh_hit_clusters

    o, d, seed_t = _hit_rays(scene, scheme, n_rays)
    cols = lambda a: [jnp.asarray(a[:, k]) for k in range(3)]
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda sc: _mesh_hit_clusters(
            sc, IntegratorParams(), Vec3(*cols(o)), Vec3(*cols(d)),
            jnp.asarray(seed_t)))(scene)
        got = mesh_hit(*cols(o), *cols(d), jnp.asarray(seed_t), scene.cl_lo,
                       scene.cl_hi, scene.cl_v0, scene.cl_e1, scene.cl_e2,
                       scene.cl_idx, interpret=interpret)
    compare_hits(got, ref, f"hit kernel vs _mesh_hit_clusters, {n_rays} rays")


def phase_mesh(dev, width=FULL_W, height=FULL_H, spp=8, interpret=False, small=False):
    import jax

    from raytrace.models import procedural as pr

    surf_kw = dict(n_textures=2, tex_size=32, n_tris=20_000) if small else {}
    tex_kw = dict(tex_size=64, sky_size=16) if small else {}
    scheme, meshes = pr.surface_scene(width, height, spp, **surf_kw)
    scene = _mesh_case("a380 surface", scheme, meshes, dev, spp, interpret)
    phase_hit_compare(jax.device_put(scene, dev), scheme,
                      n_rays=4096 if small else 131_072, interpret=interpret)
    del scene
    scheme, meshes = pr.textured_scene(width, height, spp, **tex_kw)
    _mesh_case("textured", scheme, meshes, dev, spp, interpret)

    qw, qh = width // 4, height // 4
    _quarter_render_check(
        "a380 surface", lambda: pr.surface_scene(qw, qh, spp, **surf_kw), dev, 4, interpret)
    _quarter_render_check(
        "textured", lambda: pr.textured_scene(qw, qh, spp, **tex_kw), dev, 4, interpret)


def phase_gradients(devices, width=128, height=64, n_samples=2):
    """One distributed train step on walled (n_samples per spp shard):
    finite loss and gradients. Returns what fd_check needs."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _inline_walled_scheme
    from raytrace.models.camera import build_camera
    from raytrace.models.scene import build_scene
    from raytrace.parallel.distributed import make_train_step
    from raytrace.parallel.mesh import make_mesh
    from raytrace.render.integrator import IntegratorParams
    from raytrace.render.renderer import camera_to_arrays

    mesh = make_mesh(devices)
    log(f"[gradients] walled {width}x{height}, mesh {dict(mesh.shape)}, "
        f"{n_samples} samples per spp shard")
    scheme = _inline_walled_scheme(width, height, assured=3)
    scene = build_scene(scheme)
    cam = camera_to_arrays(build_camera(scheme.cam, width, height))
    # the reference's cpu semantics: there the dielectric Fresnel
    # weight depends smoothly on geometry; gpu-semantics radiance is
    # piecewise constant in sphere positions (zero gradient almost
    # everywhere), which leaves nothing for a difference to check
    params = IntegratorParams(assured_depth=3, max_bounces=4, mode="cpu",
                              differentiable=True)
    step = make_train_step(mesh, width, height, n_samples=n_samples)
    flat = np.arange(width * height, dtype=np.int32)
    xs, ys = jnp.asarray(flat % width), jnp.asarray(flat // width)
    target = jnp.zeros((width * height, 3))
    t0 = time.time()
    loss, (gscene, gcam) = step(scene, cam, params, xs, ys, jnp.int32(0), target)
    loss = float(loss)
    log(f"  compile + step: {time.time() - t0:.2f} s; loss {loss:.6f}")
    leaves = jax.tree.leaves((gscene, gcam))
    assert np.isfinite(loss) and all(np.isfinite(np.asarray(g)).all() for g in leaves)
    return step, scene, cam, params, xs, ys, target, gscene, loss


def fd_check(step, scene, cam, params, xs, ys, target, gscene, si=5, comp=0,
             h=1e-4, rtol=0.1):
    """Central difference of the loss along the x centre of one of
    walled's small dielectric spheres vs its gradient. rtol covers the
    f32 rounding of the loss (about 2% of the difference at this h)
    and the visibility changes (silhouette and shadow edges) the
    difference can cross and the gradient does not model."""
    import jax.numpy as jnp

    c0 = np.asarray(scene.sph_c)
    loss_at = []
    for sgn in (1.0, -1.0):
        c = c0.copy()
        c[si, comp] += sgn * h
        loss_at.append(float(step(scene.replace(sph_c=jnp.asarray(c)), cam, params,
                                  xs, ys, jnp.int32(0), target)[0]))
    fd = (loss_at[0] - loss_at[1]) / (2 * h)
    g = float(np.asarray(gscene["sph_c"])[si, comp])
    log(f"  d loss / d c[{si},{comp}]: gradient {g:.6e}, central difference "
        f"(h={h}) {fd:.6e}, rel {abs(g - fd) / abs(fd):.3e} (limit {rtol})")
    assert abs(g - fd) <= rtol * abs(fd)


def phase_gpu_tests():
    """The test suite's `gpu`-marked tests (compiled kernels), run in
    this process so the card keeps one JAX process."""
    import pytest

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1

    root = os.path.dirname(os.path.abspath(__file__))
    count = Count()
    log("[gpu tests] pytest -m gpu tests/test_gpu.py")
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(root, "tests", "test_gpu.py")], plugins=[count])
    log(f"  pytest exit {rc}, {count.passed} passed")
    assert rc == 0 and count.passed == 2


def _one_vs_many(name, make_renderer, devices, spp, warm):
    """Renderer on one card vs spp-sharded over all `devices`, same
    sample range, both warmed up first; prints both rates."""
    from raytrace.render.target import RenderTarget

    n = len(devices)
    one, many = make_renderer(devices[:1]), make_renderer(devices)
    for r in (one, many):
        r.render(samples=warm, batch=warm, progress=False)
        r.target = RenderTarget(r.width, r.height)
    img1, dt1 = _timed_render(one, spp)
    imgn, dtn = _timed_render(many, spp)
    paths = one.width * one.height * spp
    log(f"[multi {name}] driver={many.driver} hit={many.hit}, {spp} spp: 1 card "
        f"{paths / dt1 / 1e6:.1f} Mpaths/s in {dt1:.3f} s, {n} cards "
        f"{paths / dtn / 1e6:.1f} Mpaths/s in {dtn:.3f} s "
        f"(scaling efficiency {dt1 / dtn / n:.3f})")
    compare_means(imgn, img1, f"{name} {n} cards vs 1 card")
    return imgn, img1


def phase_multi(devices, width=FULL_W, height=FULL_H, interpret=False, small=False):
    """Four cards: spp-sharded Renderer vs one card over the same
    sample range, on walled and on the textured scene; then the train
    step on a (tile, spp) mesh of all four. The timed windows last
    several seconds on four cards (walled 65,536 spp, textured 128 spp),
    so launch and readback do not dominate the scaling efficiency."""
    from __graft_entry__ import _inline_walled_scheme
    from raytrace.models import procedural as pr
    from raytrace.models.scene import build_scene
    from raytrace.render.renderer import Renderer

    n = len(devices)
    kw = dict(driver="fused", interpret=True) if interpret else {}
    scheme = _inline_walled_scheme(width, height, assured=5)
    imgn, img1 = _one_vs_many(
        "walled", lambda d: Renderer(scheme, devices=d, **kw), devices,
        spp=16 * n if small else 65536, warm=16 * n)
    np.testing.assert_allclose(imgn, img1, rtol=2e-4, atol=2e-5)

    tex_kw = dict(tex_size=64, sky_size=16) if small else {}
    scheme_t, meshes = pr.textured_scene(width, height, 8, **tex_kw)
    scene = build_scene(scheme_t, meshes=meshes)
    mkw = dict(hit="triton", interpret=True) if interpret else {}
    _one_vs_many(
        "textured", lambda d: Renderer(scheme_t, scene=scene, devices=d, **mkw),
        devices, spp=n if small else 128, warm=n)

    # the sharded train step vs the same step on one card over the same
    # sample ids (its one spp shard takes all of them)
    from raytrace.parallel.mesh import make_mesh

    gw, gh = (32, 16) if small else (128, 64)
    *_, g_n, loss_n = phase_gradients(devices, gw, gh)
    n_spp = make_mesh(devices).shape["spp"]
    *_, g_1, loss_1 = phase_gradients(devices[:1], gw, gh, n_samples=2 * n_spp)
    compare_train_step(loss_n, g_n, loss_1, g_1, f"train step {n} cards vs 1 card")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)

    import jax

    from raytrace.utils.cache import enable_compile_cache

    enable_compile_cache()
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})", file=sys.stderr)
        return 2
    log(gpu_info())
    log(f"device_kind={devices[0].device_kind} count={len(devices)} "
        f"jax={jax.__version__} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    t_all = time.time()
    if args.multi:
        assert len(devices) >= 4, f"--multi needs 4 cards, have {len(devices)}"
        phase_multi(devices[:4])
        count = 4
    else:
        dev = devices[0]
        phase_walled(dev)
        phase_mesh(dev)
        fd_check(*phase_gradients([dev])[:-1])
        phase_gpu_tests()
        count = 1
    log(f"all phases passed in {time.time() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
