"""End-to-end smoke test of the path tracer on one NVIDIA GPU.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the MeshRenderer phase only

Run from the root of a checkout.  Everything runs in this one process,
so one process holds the card.  Phases (one card):

  setup      card, power limit, XLA_FLAGS, BVH builder, CUDA kernel build
  cli        `render` CLI on the generated cornell-class GLB, 1920x1080,
             depth 10: PNG + radiance .npz, finite, not black or white
  rays       CUDA traversal kernel vs the XLA walk on primary and
             first-bounce rays at 1920x1080, cornell- and outside-class
  image      megakernel radiance, kernel vs walk, one sample per pixel,
             plus warm samples/s and Mrays/s timed in turns
             (walk, kernel, kernel, walk)
  oracle     64 fixed pixels of the kernel image vs tests/oracle.py
  wavefront  the pooled wavefront renderer on both scenes
  profile    device time of the traverse and shade scopes in a short
             jax.profiler window (cornell, kernel, one sample)

Any failed phase fails the script.  The last stdout line is the JSON
result; earlier lines carry every number beside the card's name and
power limit.  The rendered PNG and report.json go to smoke_out/
(ignored by git); the GLB, radiance .npz and trace live in a
temporary directory.  Without a GPU the script exits 1 and prints no
result line.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from logipathtracer_tpu.config import RenderConfig  # noqa: E402
from logipathtracer_tpu.utils.device import (  # noqa: E402
    device_record, gpu_name_and_power_limit)

OUT = os.path.join(ROOT, "smoke_out")
W, H, DEPTH = 1920, 1080, 10
HOST_SEED = 7

# Kernel vs walk, per pixel (the bound tests/test_wavefront.py puts on
# two renderers that share every stage): a pixel diverges when any
# channel differs by more than rtol 1e-4 / atol 1e-6; at most 0.5% may
# diverge.  Divergence comes from hits that float rounding decides
# (edges, grazing rays), after which the two paths draw different
# random numbers.
PIX_RTOL, PIX_ATOL, PIX_MAX_DIVERGENT = 1e-4, 1e-6, 0.005
# Kernel vs walk, per ray: t agrees to 1e-5 of the magnitudes rounding
# works at (|t| plus the largest origin coordinate: a bounce ray 30
# units from the world origin carries ~2e-6 of absolute error into its
# object-space ray whatever its t), and a different (obj, tri) only at
# such a t tie.  At most 5e-4 of the rays may break either rule:
# rounding decides whether a bounce ray re-hits the surface it leaves
# at t ~ eps, and which of two triangles sharing an edge a ray hits.
RAY_RTOL, RAY_MAX_MISMATCH = 1e-5, 5e-4
# Card vs the scalar oracle at 64 pixels: tests/test_render_parity.py's
# tolerance.  Up to 2 pixels may flip a branch: XLA and nvcc contract
# multiply-adds into FMAs where numpy does not, so a value next to a
# Russian-roulette, lobe-choice or Fresnel threshold can fall on the
# other side, and that path then follows other random draws.
ORACLE_RTOL, ORACLE_ATOL, ORACLE_MAX_FLIPS = 2e-4, 2e-5, 2


class Smoke:
    def __init__(self):
        self.failed: list[str] = []
        self.report: dict = {}
        self.gpu = None

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        print(f"== {name}", flush=True)
        try:
            yield
        except Exception:  # a failed phase fails the run, not the script
            traceback.print_exc()
            self.failed.append(name)
            print(f"!! {name} FAILED", flush=True)
        dt = time.perf_counter() - t0
        self.report.setdefault("phase_s", {})[name] = round(dt, 2)
        print(f"-- {name}: {dt:.1f} s", flush=True)

    def note(self, key, value):
        """Print one number beside the card it was measured on."""
        self.report[key] = value
        print(f"{key}: {value}  [{self.gpu}]", flush=True)

    def check(self, ok, what):
        if not ok:
            raise AssertionError(what)


def _scenes():
    from logipathtracer_tpu.scene.compile import compile_scene
    from logipathtracer_tpu.scene.procedural import (make_cornell_scene,
                                                     make_outside_scene)
    out = {}
    for name, make in (("cornell", make_cornell_scene),
                       ("outside", make_outside_scene)):
        t0 = time.perf_counter()
        out[name] = compile_scene(make(), RenderConfig(width=W, height=H))
        out[name + "_compile_s"] = time.perf_counter() - t0
    return out


def _primary_rays(scene, seed=(48271, 16807)):
    import jax.numpy as jnp

    from logipathtracer_tpu.ops.camera import generate_ray
    from logipathtracer_tpu.ops.rng import seed_from_pixel
    cam = scene.cameras[0]
    ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                          jnp.arange(W, dtype=jnp.float32), indexing="ij")
    pix = jnp.stack([xs, ys], -1).reshape(-1, 2)
    s = seed_from_pixel(jnp.asarray(seed, jnp.uint32), pix)
    return generate_ray(jnp.asarray(cam.world_matrix),
                        jnp.float32(cam.yfov), pix, (W, H), s)


def _compare_rays(sm, tag, origin, walk, kern):
    tw, ow, rw = (np.asarray(x) for x in walk)
    tk, ok, rk = (np.asarray(x) for x in kern)
    n = tw.shape[0]
    scale = np.abs(tw) + np.abs(np.asarray(origin)).max(axis=-1)
    close = np.abs(tk - tw) <= RAY_RTOL * scale
    bad = ~close | (((ok != ow) | (rk != rw)) & ~close)
    frac = float(bad.mean())
    sm.note(f"rays_{tag}_mismatch_frac", frac)
    sm.note(f"rays_{tag}_hit_frac", float((rw >= 0).mean()))
    sm.check(frac <= RAY_MAX_MISMATCH,
             f"{tag}: {int(bad.sum())} of {n} rays disagree")


def phase_rays(sm, scenes):
    import jax
    import jax.numpy as jnp

    from logipathtracer_tpu.ops.traverse import (intersect_scene,
                                                 select_traversal)
    from logipathtracer_tpu.render.megakernel import shade_step
    cfg = RenderConfig(width=W, height=H, max_depth=DEPTH)
    kernel = select_traversal("cuda")
    for name in ("cornell", "outside"):
        scene = jax.device_put(scenes[name])
        walk_f = jax.jit(lambda s, o, d: intersect_scene(s, o, d))
        kern_f = jax.jit(lambda s, o, d: kernel(s, o, d))
        o, d, seed = _primary_rays(scene)
        w = walk_f(scene, o, d)
        k = kern_f(scene, o, d)
        _compare_rays(sm, f"{name}_primary", o, w, k)

        # First-bounce rays from the walk's hits (shared input); dead
        # lanes keep their camera rays.
        @jax.jit
        def bounce(scene, o, d, seed, t, obj, tri):
            r = o.shape[0]
            out = shade_step(scene, cfg, o, d, jnp.zeros((r, 3)),
                             jnp.ones((r, 3)), jnp.ones((r,), bool), seed,
                             0, t, obj, tri)
            return out[0], out[1]
        o2, d2 = bounce(scene, o, d, seed, *w)
        _compare_rays(sm, f"{name}_bounce", o2, walk_f(scene, o2, d2),
                      kern_f(scene, o2, d2))


def _timed_steps(r, n):
    rays0 = r.total_rays
    t0 = time.perf_counter()
    r.step(n)
    wall = time.perf_counter() - t0
    return n / wall, (r.total_rays - rays0) / wall / 1e6


def phase_image(sm, scenes, images):
    import jax

    from logipathtracer_tpu.render.progressive import ProgressiveRenderer
    for name in ("cornell", "outside"):
        r = {}
        for mode in ("bvh", "auto"):
            # renderer "auto" is the megakernel; with intersect "auto"
            # this is the CLI's configuration, so it shares its compile.
            cfg = RenderConfig(width=W, height=H, max_depth=DEPTH,
                               intersect=mode)
            r[mode] = ProgressiveRenderer(scenes[name], cfg,
                                          host_seed=HOST_SEED)
            t0 = time.perf_counter()
            r[mode].step(1)
            jax.block_until_ready(r[mode].accum)
            sm.note(f"{name}_{mode}_first_sample_s (set-up, compile "
                    "included)", round(time.perf_counter() - t0, 2))
        walk = r["bvh"].radiance()
        kern = r["auto"].radiance()
        images[name] = kern
        sm.check(np.isfinite(kern).all() and np.isfinite(walk).all(),
                 f"{name}: non-finite radiance")
        close = np.isclose(kern, walk, rtol=PIX_RTOL,
                           atol=PIX_ATOL).all(axis=-1)
        div = float(1.0 - close.mean())
        sm.note(f"{name}_kernel_vs_walk_divergent_pixel_frac", div)
        sm.note(f"{name}_mean_radiance_kernel", float(kern.mean()))
        sm.note(f"{name}_mean_radiance_walk", float(walk.mean()))
        sm.check(div <= PIX_MAX_DIVERGENT,
                 f"{name}: {div:.4%} divergent pixels")

        # Warm end-to-end rates in turns: walk, kernel, kernel, walk.
        n = {"bvh": 1, "auto": 4}
        rates = {"bvh": [], "auto": []}
        for mode in ("bvh", "auto", "auto", "bvh"):
            rates[mode].append(_timed_steps(r[mode], n[mode]))
        for mode, label in (("bvh", "walk"), ("auto", "kernel")):
            sps = [x[0] for x in rates[mode]]
            mr = [x[1] for x in rates[mode]]
            sm.note(f"{name}_{label}_samples_per_s", sps)
            sm.note(f"{name}_{label}_mrays_per_s", mr)
        sm.note(f"{name}_kernel_over_walk_samples_per_s",
                float(np.mean([x[0] for x in rates["auto"]])
                      / np.mean([x[0] for x in rates["bvh"]])))
        del r


def _load_oracle():
    """tests/oracle.py by path (a ``tests`` package elsewhere on
    sys.path must not shadow it)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "lpt_oracle", os.path.join(ROOT, "tests", "oracle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_oracle(sm, scenes, images):
    oracle = _load_oracle()
    scene = scenes["cornell"]
    cfg = RenderConfig(width=W, height=H, max_depth=DEPTH)
    img = images["cornell"]
    ubo = np.random.default_rng(HOST_SEED).integers(
        1, 2 ** 31, 2, dtype=np.int64).astype(np.uint32)
    cam = scene.cameras[0]
    xs = np.linspace(40, W - 41, 8).astype(int)
    ys = np.linspace(30, H - 31, 8).astype(int)
    flips = []
    worst = 0.0
    for y in ys:
        for x in xs:
            want = oracle.trace_pixel(scene, cfg, cam.world_matrix,
                                      cam.yfov, ubo,
                                      np.asarray([x, y], np.float32))
            got = img[y, x]
            if not np.allclose(got, want, rtol=ORACLE_RTOL,
                               atol=ORACLE_ATOL):
                flips.append((int(x), int(y), got.tolist(), want.tolist()))
            else:
                worst = max(worst, float(np.max(
                    np.abs(got - want) / (np.abs(want) + 1e-6))))
    sm.note("oracle_pixels", 64)
    sm.note("oracle_branch_flips", len(flips))
    sm.note("oracle_worst_rel_err_of_matches", worst)
    for f in flips:
        print("   flip", f)
    sm.check(len(flips) <= ORACLE_MAX_FLIPS,
             f"{len(flips)} of 64 pixels off the oracle")


def phase_wavefront(sm, scenes):
    from logipathtracer_tpu.render.progressive import ProgressiveRenderer
    for name in ("cornell", "outside"):
        cfg = RenderConfig(width=W, height=H, max_depth=DEPTH,
                           renderer="wavefront")
        r = ProgressiveRenderer(scenes[name], cfg, host_seed=HOST_SEED)
        t0 = time.perf_counter()
        r.step(1)
        sm.note(f"{name}_wavefront_first_sample_s (set-up, compile "
                "included)", round(time.perf_counter() - t0, 2))
        sps, mr = _timed_steps(r, 1)
        sm.note(f"{name}_wavefront_samples_per_s", sps)
        sm.note(f"{name}_wavefront_mrays_per_s", mr)
        rad = r.radiance()
        sm.check(np.isfinite(rad).all() and rad.max() > 0,
                 f"{name}: wavefront radiance not finite or black")
        sm.note(f"{name}_wavefront_mean_radiance", float(rad.mean()))
        del r


def _scope_of_ops(hlo_text):
    """Kernel name -> "traverse" / "shade" / "other", from the named
    scopes XLA keeps in each HLO instruction's op_name metadata.  GPU
    kernels carry their instruction's name with '.' and '-' as '_'."""
    import re
    out = {}
    for m in re.finditer(r'^\s*(?:ROOT\s+)?%?([\w.\-]+) = .*?op_name="'
                         r'([^"]*)"', hlo_text, re.M):
        name, op = m.groups()
        out[re.sub(r"[.\-]", "_", name)] = (
            "traverse" if "/traverse" in op
            else "shade" if "/shade" in op else "other")
    return out


def _reduce_trace(path, scope_of):
    """Device time per named scope from an .xplane.pb: the busy time of
    the GPU plane (union of event intervals), the window, and each
    kernel's duration credited to the scope of the HLO instruction it
    runs; other kernels (the CUDA traversal among them) by name."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(path)
    scopes = {"traverse": 0, "shade": 0, "other": 0}
    spans = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                key = scope_of.get(ev.name)
                if key is None:
                    key = "traverse" if "traverse" in ev.name else "other"
                scopes[key] += ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy = 0
    end = None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (max(b for _, b in spans) - min(a for a, _ in spans)
              if spans else 0)
    return scopes, busy, window


def phase_profile(sm, scenes):
    import tempfile

    import jax
    import jax.numpy as jnp

    from logipathtracer_tpu.render.megakernel import accumulate_sample
    from logipathtracer_tpu.render.progressive import ProgressiveRenderer
    cfg = RenderConfig(width=W, height=H, max_depth=DEPTH)
    r = ProgressiveRenderer(scenes["cornell"], cfg, host_seed=HOST_SEED)
    r.step(1)  # warm (same executable as the image phase)
    hlo = accumulate_sample.lower(
        r.scene, cfg, jnp.asarray(r.camera_world), jnp.float32(r.fov_y),
        jnp.asarray([1, 2], jnp.uint32), r.accum,
        jnp.asarray(False)).compile().as_text()
    with tempfile.TemporaryDirectory() as trace_dir:
        jax.profiler.start_trace(trace_dir)
        r.step(1)
        jax.block_until_ready(r.accum)
        jax.profiler.stop_trace()
        files = sorted(glob.glob(os.path.join(trace_dir, "**",
                                              "*.xplane.pb"),
                                 recursive=True))
        sm.check(files, "no trace written")
        scopes, busy, window = _reduce_trace(files[-1],
                                             _scope_of_ops(hlo))
    sm.note("profile_window_ms", window / 1e6)
    sm.note("profile_device_busy_ms", busy / 1e6)
    sm.note("profile_device_idle_share", 1.0 - busy / max(window, 1))
    sm.note("profile_traverse_kernel_ms", scopes["traverse"] / 1e6)
    sm.note("profile_shade_kernel_ms", scopes["shade"] / 1e6)
    sm.note("profile_other_kernel_ms", scopes["other"] / 1e6)
    sm.check(busy > 0, "no device work in the trace")
    sm.check(scopes["shade"] > 0, "no kernel attributed to the shade scope")


def phase_cli(sm):
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        _cli(sm, tmp)


def _cli(sm, tmp):
    from logipathtracer_tpu.cli.main import main as cli_main
    from logipathtracer_tpu.film.png import decode_png
    from logipathtracer_tpu.scene.gltf import write_glb
    from logipathtracer_tpu.scene.procedural import make_cornell_scene
    glb = write_glb(make_cornell_scene(), os.path.join(tmp, "cornell.glb"))
    png = os.path.join(OUT, "cornell_1080p.png")
    npz = os.path.join(tmp, "cornell_1080p_radiance.npz")
    t0 = time.perf_counter()
    rc = cli_main(["render", glb, "--width", str(W), "--height", str(H),
                   "--spp", "4", "--max-depth", str(DEPTH), "-o", png,
                   "--radiance", npz])
    sm.note("cli_render_4spp_s (set-up, compile included)",
            round(time.perf_counter() - t0, 2))
    sm.check(rc == 0, f"CLI render exited {rc}")
    with open(png, "rb") as f:
        img = decode_png(f.read())
    rad = np.load(npz)["radiance"]
    sm.check(img.shape[:2] == (H, W) and rad.shape == (H, W, 3),
             f"shapes {img.shape} {rad.shape}")
    sm.check(np.isfinite(rad).all(), "non-finite radiance")
    lum = img[..., :3].astype(np.float64).mean()
    sm.note("cli_png_mean_u8", lum)
    sm.check(5.0 < lum < 250.0 and img[..., :3].std() > 1.0,
             "image is black, white or flat")


def phase_four(sm):
    """MeshRenderer on four cards, meshes (4, 1) and (2, 2), against
    single-card renders of the same seeds."""
    import jax
    import jax.numpy as jnp

    from logipathtracer_tpu.parallel.mesh import MeshRenderer, make_mesh
    from logipathtracer_tpu.render.megakernel import render_sample
    from logipathtracer_tpu.scene.compile import compile_scene
    from logipathtracer_tpu.scene.procedural import make_cornell_scene
    devs = jax.devices()[:4]
    sm.check(len(devs) == 4, f"need 4 devices, have {len(jax.devices())}")
    cfg = RenderConfig(width=W, height=H, max_depth=DEPTH)
    scene = compile_scene(make_cornell_scene(), cfg)
    cam = scene.cameras[0]
    one = jax.device_put(scene, devs[0])
    for samples, tiles in ((4, 1), (2, 2)):
        mesh = make_mesh(devs, samples=samples, tiles=tiles)
        r = MeshRenderer(scene, cfg, mesh, host_seed=HOST_SEED)
        t0 = time.perf_counter()
        r.step()
        sm.note(f"mesh_{samples}x{tiles}_first_step_s (set-up, compile "
                "included)", round(time.perf_counter() - t0, 2))
        accum = np.asarray(r.accum)  # [S, H, W, 3], one slice per seed
        t0 = time.perf_counter()
        r.step()
        wall = time.perf_counter() - t0
        sm.note(f"mesh_{samples}x{tiles}_warm_samples_per_s",
                samples / wall)
        # The first step's seeds, each rendered on one card.
        seeds = np.random.default_rng(HOST_SEED).integers(
            1, 2 ** 31, (samples, 2), dtype=np.int64)
        worst = 0.0
        for i, s in enumerate(seeds):
            with jax.default_device(devs[0]):
                img = np.asarray(render_sample(
                    one, cfg, jnp.asarray(cam.world_matrix),
                    jnp.float32(cam.yfov), jnp.asarray(s, jnp.uint32)))
            close = np.isclose(accum[i], img, rtol=PIX_RTOL,
                               atol=PIX_ATOL).all(axis=-1)
            worst = max(worst, float(1.0 - close.mean()))
        sm.note(f"mesh_{samples}x{tiles}_divergent_pixel_frac_worst_sample",
                worst)
        sm.check(worst <= PIX_MAX_DIVERGENT,
                 f"mesh {samples}x{tiles}: {worst:.4%} divergent pixels")
        del r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card MeshRenderer phase")
    args = ap.parse_args(argv)

    import jax
    rec = device_record(jax)
    if rec["platform"] != "gpu":
        print(f"chip_smoke: no GPU (JAX's default device is "
              f"{rec['platform']}); nothing run", file=sys.stderr)
        return 1
    from logipathtracer_tpu.utils.cache import configure_compile_cache
    os.makedirs(OUT, exist_ok=True)
    sm = Smoke()
    sm.gpu = gpu_name_and_power_limit()
    print(f"gpu: {sm.gpu}", flush=True)
    print(f"jax {jax.__version__}, devices {rec}, XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r}, compile cache "
          f"{configure_compile_cache(jax)}", flush=True)

    if args.four:
        with sm.phase("four"):
            phase_four(sm)
    else:
        images: dict = {}
        scenes: dict = {}
        with sm.phase("setup"):
            from logipathtracer_tpu.ops import traverse_cuda
            from logipathtracer_tpu.scene.bvh_native import native_available
            sm.note("bvh_builder", "native SBVH (native/bvh_builder.cpp)"
                    if native_available() else "numpy binned SAH")
            t0 = time.perf_counter()
            traverse_cuda.ensure_registered()
            sm.note("cuda_kernel_build_s (set-up)",
                    round(time.perf_counter() - t0, 2))
            scenes.update(_scenes())
            for name in ("cornell", "outside"):
                s = scenes[name]
                sm.note(f"{name}_scene", f"{s.num_objects} objects, "
                        f"{s.num_triangles} triangles, "
                        f"{s.fused_min.shape[0]} nodes, stack "
                        f"{s.max_stack}, compiled in "
                        f"{scenes[name + '_compile_s']:.2f} s (set-up)")
        if not sm.failed:
            for name, fn in (("cli", lambda: phase_cli(sm)),
                             ("rays", lambda: phase_rays(sm, scenes)),
                             ("image", lambda: phase_image(sm, scenes,
                                                           images)),
                             ("oracle", lambda: phase_oracle(sm, scenes,
                                                             images)),
                             ("wavefront", lambda: phase_wavefront(
                                 sm, scenes)),
                             ("profile", lambda: phase_profile(sm, scenes))):
                with sm.phase(name):
                    fn()
    stats = jax.devices()[0].memory_stats() or {}
    sm.note("peak_bytes_in_use", stats.get("peak_bytes_in_use"))
    sm.report["failed"] = sm.failed
    sm.report["gpu"] = sm.gpu
    with open(os.path.join(OUT, "report.json"), "w") as f:
        json.dump(sm.report, f, indent=1, default=str)
    if sm.failed:
        print(f"chip_smoke: FAILED phases {sm.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
