"""Renderer driver: jit-compiled sample-batch steps over pixel tiles.

The replacement for the reference's render orchestration
(renderer.rs:27-63 + draw_scene.rs): instead of per-batch dispatch +
blocking readback (the reference's known bottleneck, README.md:156-160),
the accumulator lives on device, each batch is one jit call, and the
host only pulls pixels for previews / the final image.

spp batching (`render_batch`) keeps the reference's scheme-file meaning
(progress/preview cadence).
"""
from __future__ import annotations

import os
import time
from functools import partial
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.camera import Camera, build_camera
from ..models.config import Scheme
from ..models.scene import SceneArrays, build_scene
from ..ops import raygen, rng
from ..utils.pytree import pytree_dataclass
from . import policy
from . import wavefront as _wf
from .integrator import MESH_HITS, IntegratorParams, trace_paths
from .target import RenderTarget


@pytree_dataclass
class CameraArrays:
    """Traced camera bundle consumed by ops.raygen (and a
    differentiable leaf set for camera gradients)."""

    o: Any
    d: Any
    up: Any
    right: Any
    x_cf: Any
    y_cf: Any
    x_off: Any
    y_off: Any
    lens_r: Any = None  # None => pinhole (static structure)


def camera_to_arrays(cam: Camera) -> CameraArrays:
    return CameraArrays(
        o=jnp.asarray(cam.o),
        d=jnp.asarray(cam.d),
        up=jnp.asarray(cam.up),
        right=jnp.asarray(cam.right),
        x_cf=jnp.float32(cam.x_cf),
        y_cf=jnp.float32(cam.y_cf),
        x_off=jnp.float32(cam.x_off),
        y_off=jnp.float32(cam.y_off),
        lens_r=(jnp.float32(cam.lens_r) if cam.lens_r is not None else None),
    )


def sample_batch(
    scene, cam, params, width, height, x_idx, y_idx, sample_base, n_samples,
    samples_per_dispatch: int = 1,
):
    """Radiance SUM over n_samples for the given pixels. Pure function
    (jit under the driver): per sample s, seed the per-pixel stream from
    (x, y, sample_base + s), generate the jittered camera ray, trace.

    samples_per_dispatch (static) packs that many sample replicas of
    every pixel into one giant lane batch per bounce-loop dispatch —
    the bounce loop's cost is dominated by per-iteration overheads, so
    more lanes per iteration is nearly free throughput. n_samples must
    be divisible by it.
    """

    from ..ops.vec import Vec3

    spd = samples_per_dispatch
    n = x_idx.shape[0]
    if spd > 1:
        xs = jnp.tile(x_idx, spd)
        ys = jnp.tile(y_idx, spd)
        rep = jnp.repeat(jnp.arange(spd, dtype=jnp.int32), n)
    else:
        xs, ys, rep = x_idx, y_idx, None

    def body(s, acc):
        if spd > 1:
            samp = sample_base + s * spd + rep
        else:
            samp = sample_base + s
        state = rng.init_state(xs, ys, width, height, samp)
        state, ro, rd = raygen.generate(state, xs, ys, cam)
        radiance, _ = trace_paths(scene, params, ro, rd, state)
        if spd > 1:
            radiance = Vec3(
                radiance.x.reshape(spd, n).sum(0),
                radiance.y.reshape(spd, n).sum(0),
                radiance.z.reshape(spd, n).sum(0),
            )
        return acc + radiance

    z = jnp.zeros((n,), jnp.float32)
    acc0 = Vec3(z, z, z)
    if params.differentiable:
        # reverse-mode needs static trip counts: scan over a static
        # number of samples (n_samples must be a python int here)
        if not isinstance(n_samples, int):
            raise TypeError("differentiable sample_batch needs static int n_samples")
        assert n_samples % spd == 0, "n_samples must divide by samples_per_dispatch"

        def scan_body(acc, s):
            return body(s, acc), None

        acc, _ = jax.lax.scan(scan_body, acc0, jnp.arange(n_samples // spd))
    else:
        # traced n_samples: driver guarantees divisibility
        acc = jax.lax.fori_loop(0, n_samples // spd, body, acc0)
    return acc.to_array()


def sample_batch_fused(
    tables, cam_vec, scene, params, width, height, xs, ys, rep,
    sample_base, n_samples, samples_per_dispatch: int = 1,
    samples_per_lane: int = 1, has_lens: bool = False, hints=None,
    interpret: bool = False,
):
    """Fused-kernel equivalent of sample_batch for supported scenes
    (ops/pallas/trace_kernel.py): per sample round, one pallas_call
    runs the whole bounce loop; cubemap misses are resolved with an
    XLA gather afterwards. xs/ys/rep are (L,) lanes holding
    samples_per_dispatch // samples_per_lane pixel replicas, L a
    multiple of the kernel block; the kernel covers samples_per_lane
    consecutive sample ids per lane by in-kernel regeneration
    (cubemap-free scenes only — their lanes would need one miss record
    per sample). Returns (n_pix, 3) radiance sums."""
    from ..ops.pallas import trace_kernel as tk
    from ..ops.vec import Vec3

    del width, height  # pixel coords come in via the lanes
    sph_table, ft_table = tables
    spd = samples_per_dispatch
    spl = samples_per_lane
    assert spd % spl == 0
    reps = spd // spl
    n_pix = xs.size // reps  # padded pixel count (caller slices)

    def body(s, acc):
        samp = sample_base + s * spd + rep * spl
        lr, lg, lb, mdx, mdy, mdz, mwr, mwg, mwb = tk.trace_lanes(
            xs, ys, samp, sph_table, ft_table, cam_vec,
            n_sph=scene.n_spheres, n_ft=scene.n_free_tris,
            has_lens=has_lens,
            assured=params.assured_depth,
            max_bounces=params.max_bounces,
            samples_per_lane=spl,
            hints=hints if hints is not None else tk._PERMISSIVE,
            interpret=interpret,
        )
        if scene.has_cubemap:
            from .integrator import sample_cubemap

            md = Vec3(mdx, mdy, mdz)
            missed = (md.x != 0.0) | (md.y != 0.0) | (md.z != 0.0)
            sky = sample_cubemap(scene, Vec3(
                jnp.where(missed, md.x, 1.0), md.y, md.z))
            lr = lr + jnp.where(missed, mwr * sky.x, 0.0)
            lg = lg + jnp.where(missed, mwg * sky.y, 0.0)
            lb = lb + jnp.where(missed, mwb * sky.z, 0.0)
        if reps > 1:
            rad = Vec3(
                lr.reshape(reps, n_pix).sum(0),
                lg.reshape(reps, n_pix).sum(0),
                lb.reshape(reps, n_pix).sum(0),
            )
        else:
            rad = Vec3(lr, lg, lb)
        return acc + rad

    z = jnp.zeros((n_pix,), jnp.float32)
    acc = jax.lax.fori_loop(0, n_samples // spd, body, Vec3(z, z, z))
    return acc.to_array()


# module-level shared jits: every Renderer instance (and every animation
# frame, which builds one Renderer per frame — renderer.rs:169-204's
# shape) reuses the SAME traced/compiled executable for a given
# (shapes, statics) key instead of re-jitting through a fresh
# functools.partial each time.
_jit_step = jax.jit(
    sample_batch,
    static_argnames=("width", "height", "samples_per_dispatch"),
)
_jit_fused_step = jax.jit(
    sample_batch_fused,
    static_argnames=(
        "width", "height", "samples_per_dispatch", "samples_per_lane", "has_lens",
        "hints", "interpret",
    ),
)
_jit_wavefront_step = jax.jit(
    _wf.wavefront_batch,
    static_argnames=("width", "height", "pool"),
)


def adapt_dispatch_spp(b: int, dt: float, ceiling: int,
                       grow_below: float = 15.0,
                       shrink_above: float = 35.0) -> int:
    """Dispatch sizing for mesh scenes.

    The per-dispatch fixed costs — the wavefront drain tail (the
    max-path-length iterations the pool pays at collapsing occupancy
    once per dispatch) and the host sync + (n_pix, 3) readback — favor
    LARGE dispatches, while a dispatch that runs for minutes leaves no
    progress or preview in between (and a device runtime watchdog, on
    cards that drive a display, kills it — the reference's constraint
    on consumer GPUs, README.md:280-285). n_samples is a TRACED scalar
    in every driver, so resizing the dispatch does not recompile:
    after each dispatch the renderer doubles `b` while the measured
    wall time stays under `grow_below` seconds and halves it above
    `shrink_above`."""
    if dt < grow_below and b * 2 <= ceiling:
        return b * 2
    if dt > shrink_above and b > 1:
        return max(1, b // 2)
    return b


def _params_from_scheme(scheme: Scheme, mode: str, differentiable: bool, mesh_chunk: int):
    ri = scheme.render_info.rad_info
    return IntegratorParams(
        max_thres=jnp.float32(ri.russ_roull_info.max_thres),
        assured_depth=ri.russ_roull_info.assured_depth,
        mode=mode,
        debug_single_ray=ri.debug_single_ray,
        dir_light_samp=ri.dir_light_samp,
        mesh_chunk=mesh_chunk,
        differentiable=differentiable,
    )


class Renderer:
    """Static-scene renderer (the consume_and_do analogue,
    renderer.rs:41-63)."""

    def __init__(
        self,
        scheme: Scheme,
        mode: Optional[str] = None,
        tile_size: int = 1 << 17,
        mesh_chunk: int = 2048,
        scene: Optional[SceneArrays] = None,
        samples_per_dispatch: Optional[int] = None,
        driver: Optional[str] = None,
        hit: Optional[str] = None,
        devices: Optional[Any] = None,
        interpret: bool = False,
    ):
        """devices: devices to render on (default: ALL attached
        devices). With more than one, every dispatch spp-shards over a
        1-D jax.sharding.Mesh — each device renders the full pixel set
        for a disjoint contiguous sample-id slice and the partial
        images psum (parallel/distributed.py). Sample ids are
        partitioned exactly, so incremental/resumed renders stay
        stream-exact.

        driver / hit override render/policy.py's choice ("fused",
        "wavefront", "plain" / "triton", "clusters", "brute").
        interpret=True runs the Pallas kernels in interpret mode, so a
        kernel driver can execute on the CPU (tests only)."""
        self.scheme = scheme
        self.interpret = interpret
        info = scheme.render_info
        self.width, self.height = info.width, info.height
        self.devices = list(devices) if devices is not None else list(jax.devices())
        self.n_devices = len(self.devices)
        self._mesh1d = None
        if self.n_devices > 1:
            from jax.sharding import Mesh

            self._mesh1d = Mesh(np.asarray(self.devices), ("spp",))
        # use_gpu in the scheme selects the reference backend; for us it
        # selects which reference SEMANTICS to reproduce (gpu default).
        self.mode = mode or ("gpu" if info.use_gpu else "cpu")
        self.scene = scene if scene is not None else build_scene(scheme, pad_mult=mesh_chunk)
        m = self.scene.mt_v0.shape[0]
        if m:
            mesh_chunk = min(mesh_chunk, m)
        self.params = _params_from_scheme(scheme, self.mode, False, mesh_chunk)

        plan = policy.choose(self.devices[0].platform, self.scene, self.params)
        self.driver = driver or plan.driver
        self.hit = hit or plan.hit
        if self.driver == "fused" and not policy.fused_supported(self.scene, self.params):
            raise ValueError("the fused driver does not cover this scene")
        if self.hit in MESH_HITS:
            self.params = self.params.replace(mesh_hit=self.hit, interpret=interpret)

        self.camera = build_camera(scheme.cam, self.width, self.height)
        self.cam_arrays = camera_to_arrays(self.camera)
        self.target = RenderTarget(self.width, self.height)
        self.tile_size = min(tile_size, self.width * self.height)
        self._scene_dev = None  # lazy one-time device upload (render())
        self.spd = samples_per_dispatch or (16 if self.driver == "fused" else 1)

        n_pix = self.width * self.height
        # lane order: 32x32 pixel tiles, NOT scanlines — consecutive
        # lane blocks are spatially square so cluster culling's
        # per-block slab tests actually skip (a scanline block crosses
        # the whole image and skips nothing). Results are unscrambled
        # on accumulation via _perm.
        ys_all, xs_all = np.divmod(np.arange(n_pix, dtype=np.int64), self.width)
        tiles_x = -(-self.width // 32)
        tile_id = (ys_all // 32) * tiles_x + (xs_all // 32)
        within = (ys_all % 32) * 32 + (xs_all % 32)
        self._perm = np.lexsort((within, tile_id)).astype(np.int64)

        n_tiles = -(-n_pix // self.tile_size)
        pad = n_tiles * self.tile_size - n_pix
        flat = np.concatenate(
            [self._perm, np.full(pad, self._perm[-1], np.int64)]
        ).astype(np.int32)
        self._pad = pad
        self._x_idx = (flat % self.width).reshape(n_tiles, self.tile_size)
        self._y_idx = (flat // self.width).reshape(n_tiles, self.tile_size)
        self.n_tiles = n_tiles

        if self.driver == "fused":
            from ..ops.pallas import trace_kernel as tk

            # one lane array covering ALL pixels x `reps` replicas,
            # rep-major so the (reps, padded_npix) reshape sums
            # replicas; pixel count padded to the kernel block.
            # Cubemap-free scenes run ONE replica and instead let the
            # kernel regenerate spd samples per lane in place (no
            # idle-lane tail per round).
            reps = self.spd if self.scene.has_cubemap else 1
            self._fspl = self.spd // reps
            padded_npix = -(-n_pix // tk.BLOCK) * tk.BLOCK
            lane = np.arange(padded_npix * reps)
            pix_order = np.concatenate(
                [self._perm, np.full(padded_npix - n_pix, self._perm[-1], np.int64)]
            )
            lane_pix = pix_order[lane % padded_npix]
            self._fxs = jnp.asarray((lane_pix % self.width).astype(np.int32))
            self._fys = jnp.asarray((lane_pix // self.width).astype(np.int32))
            self._frep = jnp.asarray((lane // padded_npix).astype(np.int32))
            sph_t, ft_t = tk.pack_scene_tables(self.scene)
            self._tables = (jnp.asarray(sph_t), jnp.asarray(ft_t))
            self._hints = tk.scene_static_hints(
                sph_t, ft_t, self.scene.n_spheres, self.scene.n_free_tris
            )
            self._cam_vec = jnp.asarray(
                tk.make_cam_vec(self.camera, float(scheme.render_info.rad_info.russ_roull_info.max_thres))
            )
            self._fstep = partial(
                _jit_fused_step,
                width=self.width, height=self.height,
                samples_per_dispatch=self.spd,
                samples_per_lane=self._fspl,
                has_lens=self.camera.lens_r is not None,
                hints=self._hints,
                interpret=self.interpret,
            )

        self._step = partial(
            _jit_step, width=self.width, height=self.height,
            samples_per_dispatch=1,
        )

        # wavefront lane-regeneration driver (render/wavefront.py): the
        # masked bounce loop wastes most of its width on dead lanes
        if self.driver == "wavefront":
            self.wf_pool = min(1 << 17, -(-n_pix // 1024) * 1024)
            self._wxs = jnp.asarray((self._perm % self.width).astype(np.int32))
            self._wys = jnp.asarray((self._perm // self.width).astype(np.int32))
            self._wstep = partial(
                _jit_wavefront_step,
                width=self.width, height=self.height, pool=self.wf_pool,
            )

        # --- multi-device: spp-sharded wrapper around whichever driver
        # is engaged (each device renders a disjoint sample slice of
        # the full pixel set; one image psum per dispatch) ---
        if self._mesh1d is not None:
            from ..parallel.distributed import make_spp_sharded_step

            _w, _h = self.width, self.height
            _interp = self.interpret
            if self.driver == "fused":
                _spd, _spl = self.spd, self._fspl
                _hl, _hints = self.camera.lens_r is not None, self._hints

                def _fin(tables, cam_vec, scene, params, xs, ys, rep,
                         sample_base, n_samples):
                    return sample_batch_fused(
                        tables, cam_vec, scene, params, _w, _h,
                        xs, ys, rep, sample_base, n_samples,
                        samples_per_dispatch=_spd, samples_per_lane=_spl,
                        has_lens=_hl, hints=_hints, interpret=_interp,
                    )

                self._multi_step, _ = make_spp_sharded_step(self._mesh1d, _fin, {})
            elif self.driver == "wavefront":
                _pool = self.wf_pool

                def _win(scene, cam, params, xs_tab, ys_tab, sample_base, n_samples):
                    return _wf.wavefront_batch(
                        scene, cam, params, xs_tab, ys_tab,
                        sample_base, n_samples, width=_w, height=_h, pool=_pool,
                    )

                self._multi_step, _ = make_spp_sharded_step(self._mesh1d, _win, {})

            # the plain integrator multi-device step is always built:
            # it backs the plain driver AND the exact-tail path of
            # _render_plain for the fused driver
            def _pin(scene, cam, params, x_idx, y_idx, sample_base, n_samples):
                return sample_batch(
                    scene, cam, params, _w, _h, x_idx, y_idx,
                    sample_base, n_samples,
                )

            self._multi_plain_step, _ = make_spp_sharded_step(self._mesh1d, _pin, {})
            if self.driver == "plain":
                self._multi_step = self._multi_plain_step

    def _render_plain(self, scene_dev, base: int, n: int) -> int:
        """Run n samples (exactly, unless the multi-device step
        truncates to a device multiple — the remainder re-enters via
        the render() loop and lands here single-device) through the
        plain integrator tile loop; accumulate into the target and
        return the number of samples actually rendered."""
        nd = self.n_devices
        n_pix = self.width * self.height
        use_multi = self._mesh1d is not None and n >= nd
        n_w = (n // nd) * nd if use_multi else n
        tile_sums = []
        for ti in range(self.n_tiles):
            if use_multi:
                out = self._multi_plain_step(
                    scene_dev, self.cam_arrays, self.params,
                    jnp.asarray(self._x_idx[ti]), jnp.asarray(self._y_idx[ti]),
                    jnp.int32(base), jnp.int32(n_w // nd),
                )
            else:
                out = self._step(
                    scene_dev,
                    self.cam_arrays,
                    self.params,
                    x_idx=jnp.asarray(self._x_idx[ti]),
                    y_idx=jnp.asarray(self._y_idx[ti]),
                    sample_base=jnp.int32(base),
                    n_samples=jnp.int32(n_w),
                )
            tile_sums.append(np.asarray(out))
        flat = np.concatenate(tile_sums, axis=0)
        if self._pad:
            flat = flat[:n_pix]
        res = np.empty((n_pix, 3), np.float32)
        res[self._perm] = flat
        self.target.add(res, n_w)
        return n_w

    def render(
        self,
        samples: Optional[int] = None,
        batch: Optional[int] = None,
        update_hook: Optional[Callable[[RenderTarget], None]] = None,
        progress: bool = True,
        async_hook: bool = True,
    ) -> np.ndarray:
        """Run `samples` MORE samples (sample ids continue at
        target.count, so in counter-RNG mode a checkpoint-resumed or
        incremental render is bit-exact — no RNG stream is ever reused);
        returns (H, W, 3)
        f32 mean image (row 0 = bottom). update_hook fires after every
        batch with the live target (the reference's per-sample preview
        push, draw_scene.rs:97-99); with async_hook (default) it runs
        on a writer thread against a snapshot, latest-wins, so PNG /
        checkpoint / preview IO never blocks the device between
        batches (the reference's mpsc decoupling, renderer.rs:44)."""
        info = self.scheme.render_info
        total = samples if samples is not None else info.samps_per_pix
        # the scheme's render_batch (gpu_render_batch) is PREVIEW
        # CADENCE: the reference dispatches per batch so the UI can
        # show the accumulating image (and to dodge its GPU watchdog —
        # the mesh dispatch cap below handles that independently). With
        # no update_hook attached there is nothing to show between
        # batches, and every extra dispatch pays the wavefront drain
        # tail, so batching is only honored when a hook wants the
        # intermediate images.
        b = batch or (info.render_batch if update_hook is not None else total)
        b = max(1, min(b or total, total))
        adapt_cap = 0  # 0 = fixed dispatch size (non-mesh, env cap, hook)
        if self.scene.n_mesh_tris:
            # mesh scenes start from a bounded dispatch size and adapt
            # (adapt_dispatch_spp); the wavefront driver gets a bigger
            # start: its drain tail is paid once per dispatch, so more
            # spp per dispatch is the occupancy lever.
            default_cap = "64" if self.driver == "wavefront" else "2"
            cap = int(os.environ.get("RTPU_MAX_DISPATCH_SPP", default_cap))
            b = min(b, cap)
            # an explicit RTPU_MAX_DISPATCH_SPP (bench reproducibility),
            # an explicit batch argument, or a preview hook's batch
            # cadence disables the adaptation
            if ("RTPU_MAX_DISPATCH_SPP" not in os.environ
                    and update_hook is None and batch is None):
                adapt_cap = min(256, total)

        bar = None
        if progress:
            try:
                from tqdm import tqdm

                bar = tqdm(total=total, desc="samples", unit="spp")
            except Exception:
                bar = None
        from ..utils.profiling import Throughput

        meter = Throughput()

        hook = update_hook
        closer = None
        if update_hook is not None and async_hook:
            from ..utils.hooks import AsyncHook

            hook = AsyncHook(update_hook)
            closer = hook.close

        # upload the scene ONCE per Renderer: texel pools can be
        # hundreds of MB
        if self._scene_dev is None:
            self._scene_dev = jax.device_put(self.scene)
        scene_dev = self._scene_dev
        n_pix = self.width * self.height
        rendered = 0
        while rendered < total:
            n = min(b, total - rendered)
            t_disp = time.time()
            base = self.target.count  # sample ids continue across calls
            nd = self.n_devices
            # Each driver prefers the spp-sharded multi-device step, but
            # only when the chunk covers all devices; a remainder
            # smaller than the mesh (or the fused per-device unit) runs
            # the single-device step so render(samples=k) does exactly
            # k samples — never rounded up to a device multiple.
            if self.driver == "fused":
                unit = self.spd * nd
                if self._mesh1d is not None and n >= unit:
                    n_f = (n // unit) * unit
                    out = self._multi_step(
                        self._tables, self._cam_vec, scene_dev, self.params,
                        self._fxs, self._fys, self._frep,
                        jnp.int32(base), jnp.int32(n_f // nd),
                    )
                elif n >= self.spd:
                    n_f = (n // self.spd) * self.spd
                    out = self._fstep(
                        self._tables,
                        self._cam_vec,
                        scene_dev,
                        self.params,
                        xs=self._fxs,
                        ys=self._fys,
                        rep=self._frep,
                        sample_base=jnp.int32(base),
                        n_samples=jnp.int32(n_f),
                    )
                else:
                    # tail smaller than one packed dispatch: run EXACTLY
                    # n samples through the plain integrator tile loop
                    # (same per-(pixel, sample) counter streams) so
                    # render(samples=k) adds exactly k — never rounded
                    # up to samples_per_dispatch
                    out = None
                    n_f = self._render_plain(scene_dev, base, n)
                if out is not None:
                    res = np.empty((n_pix, 3), np.float32)
                    res[self._perm] = np.asarray(out)[:n_pix]
                    self.target.add(res, n_f)
                n = n_f
            elif self.driver == "wavefront":
                n_w = (n // nd) * nd if (self._mesh1d is not None and n >= nd) else n
                if self._mesh1d is not None and n >= nd:
                    out = self._multi_step(
                        scene_dev, self.cam_arrays, self.params,
                        self._wxs, self._wys,
                        jnp.int32(base), jnp.int32(n_w // nd),
                    )
                else:
                    out = self._wstep(
                        scene_dev,
                        self.cam_arrays,
                        self.params,
                        self._wxs,
                        self._wys,
                        sample_base=jnp.int32(base),
                        n_samples=jnp.int32(n_w),
                    )
                # wavefront accumulates by natural flat pixel id
                self.target.add(np.asarray(out), n_w)
                n = n_w
            else:
                n = self._render_plain(scene_dev, base, n)
            rendered += n
            if adapt_cap and n == b and rendered < total:
                # full-size dispatches inform the sizing (each driver
                # syncs through np.asarray above, so the wall time is
                # the dispatch time; the first dispatch's jit compile
                # only inflates it, which at worst delays one growth
                # step — conservative in the safe direction)
                b = adapt_dispatch_spp(b, time.time() - t_disp, adapt_cap)
            meter.add(n * n_pix)
            if bar is not None:
                bar.update(n)
                bar.set_postfix_str(f"{meter.mpaths_per_s:.1f} Mpaths/s")
            if hook is not None:
                hook(self.target)
        if bar is not None:
            bar.close()
        if closer is not None:
            closer()  # flush the final snapshot; re-raise hook errors
        return self.target.mean_image()
