"""Benchmark on the attached GPU.

    python bench.py         # walled 1200x600 primary paths/s, one JSON line
    python bench.py --ab    # each kernel vs the XLA formulation it replaces

The default mode measures the reference's headline scene (walled.yml,
1200x600, the scene behind its "1650x speedup, 8 s / 20000 spp" number
-> 1.8e9 paths/s on an RX 6800 XT, BASELINE.md) through `Renderer`:
median of BENCH_REPS renders of BENCH_SPP samples after a warm-up
render, counter-RNG streams. `--ab` times, end to end through
`Renderer` on one card, the fused trace kernel against the XLA
wavefront driver on walled, and the mesh hit kernel against the XLA
cluster cull and the XLA brute-force scan on the two procedural mesh
scenes; its last line is the JSON of all timings. Both modes refuse
to run without a GPU.
"""
import argparse
import functools
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BASELINE_PATHS_PER_S = 1.8e9  # walled GPU: 1200*600*20000 / 8 s (BASELINE.md)
W, H = 1200, 600


def _gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU (JAX platform {dev.platform!r})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return dev, {"platform": dev.platform, "kind": dev.device_kind,
                 "count": len(jax.devices()), "nvidia_smi": smi}


def _mpaths(r, spp, reps=1):
    """Median Mpaths/s of `reps` renders of `spp` samples (after the
    caller's warm-up) and the individual runs."""
    runs = []
    for _ in range(reps):
        t0 = time.time()
        r.render(samples=spp, batch=spp, progress=False)
        runs.append(r.width * r.height * spp / (time.time() - t0) / 1e6)
    return float(np.median(runs)), runs


def walled():
    from __graft_entry__ import _inline_walled_scheme
    from raytrace.render.renderer import Renderer

    dev, device = _gpu()
    spd = int(os.environ.get("BENCH_SPD", "256"))
    spp = int(os.environ.get("BENCH_SPP", "4096"))
    spp = max(spd, (spp // spd) * spd)
    r = Renderer(_inline_walled_scheme(W, H, assured=5), devices=[dev],
                 samples_per_dispatch=spd)
    t0 = time.time()
    r.render(samples=spd, batch=spd, progress=False)
    compile_s = time.time() - t0
    med, runs = _mpaths(r, spp, int(os.environ.get("BENCH_REPS", "3")))
    print(json.dumps({
        "metric": "walled_primary_paths_per_sec",
        "value": med * 1e6, "unit": "paths/s",
        "vs_baseline": med * 1e6 / BASELINE_PATHS_PER_S,
        "driver": r.driver, "spp": spp, "samples_per_dispatch": spd,
        "runs_mpaths": runs, "compile_and_first_dispatch_s": compile_s,
        "rng": "counter", "device": device,
    }))


def _time_call(fn, reps=3):
    fn()  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.time()
        fn()
        ts.append(time.time() - t0)
    return float(np.median(ts))


def ab():
    from __graft_entry__ import _inline_walled_scheme
    from raytrace.models import procedural as pr
    from raytrace.models.scene import build_scene
    from raytrace.ops.pallas import trace_kernel as tk
    from raytrace.render.renderer import Renderer

    dev, device = _gpu()
    out = {"device": device, "walled": {}, "mesh": {}}

    def note(section, key, value):
        out[section][key] = value
        print(f"{section} {key}: {value}", flush=True)

    # --- walled: fused trace kernel vs XLA wavefront ------------------
    scheme = _inline_walled_scheme(W, H, assured=5)
    variants = {
        "fused spd=16": Renderer(scheme, devices=[dev], driver="fused", samples_per_dispatch=16),
        "fused spd=64": Renderer(scheme, devices=[dev], driver="fused", samples_per_dispatch=64),
        "fused spd=64 no hints": Renderer(scheme, devices=[dev], driver="fused",
                                          samples_per_dispatch=64),
        "wavefront (XLA)": Renderer(scheme, devices=[dev], driver="wavefront"),
    }
    r = variants["fused spd=64 no hints"]
    r._fstep = functools.partial(r._fstep.func, **{**r._fstep.keywords, "hints": tk._PERMISSIVE})
    runs = {k: [] for k in variants}
    for name, r in variants.items():
        warm = r.spd if r.driver == "fused" else 1
        t0 = time.time()
        r.render(samples=warm, batch=warm, progress=False)
        note("walled", name + " compile_and_first_s", time.time() - t0)
    for _ in range(3):  # interleaved, so drift hits every variant alike
        for name, r in variants.items():
            runs[name].append(_mpaths(r, 256 if r.driver == "fused" else 8)[0])
    for name, rs in runs.items():
        note("walled", name, {"mpaths_per_s": float(np.median(rs)), "runs": rs})
    del variants, r

    # --- mesh scenes: hit kernel vs XLA cluster cull vs XLA brute -----
    for scene_name, make in (("textured", pr.textured_scene),
                             ("a380 surface", pr.surface_scene)):
        scheme, meshes = make(W, H, 1)
        scene = build_scene(scheme, meshes=meshes)
        for hit in ("triton", "clusters", "brute"):
            try:
                r = Renderer(scheme, scene=scene, devices=[dev], hit=hit)
                t0 = time.time()
                r.render(samples=1, batch=1, progress=False)
                first = time.time() - t0
                med, runs = _mpaths(r, 1, 2)
                note("mesh", f"{scene_name} {hit}", {
                    "mpaths_per_s": med, "runs": runs, "spp": 1,
                    "compile_and_first_s": first, "driver": r.driver})
            except Exception as e:  # a formulation may not fit the card
                note("mesh", f"{scene_name} {hit}", {"failed": repr(e)[:300]})
        del scene

    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", action="store_true", help="kernels vs XLA formulations")
    args = ap.parse_args()
    from raytrace.utils.cache import enable_compile_cache

    enable_compile_cache()
    ab() if args.ab else walled()


if __name__ == "__main__":
    main()
