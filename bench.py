"""Benchmark harness.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Headline metric: Mrays/sec/chip on the generated cornell-class scene
(scene/procedural.py make_cornell_scene), end to end through
ProgressiveRenderer.  ``vs_baseline`` is null: the only target on
record (BASELINE.json) was set for another accelerator.  Also reports
samples/sec at the benchmark resolution in the extras field (the only
quantity the reference itself measures, src/RendererPT.cpp:599-605).

Every stage reports the device it ran on (platform, device_kind,
count), the card's name and power limit from nvidia-smi, and
XLA_FLAGS.  Without --cpu a stage whose default device is not a GPU
fails (exit code 2, value null); --cpu is a smoke run whose numbers
are not device metrics.

Process structure: the top-level invocation is a thin orchestrator
that never imports jax; each measurement stage (headline cornell,
outside-class, nee+textured) runs in its OWN subprocess, one after
another, so one process at a time holds the card.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

# Wall-clock budget (seconds): the orchestrator must emit its ONE JSON
# line before any external timeout lands.  Default leaves ~3 min of
# margin under a 20-min kill; override with LPT_BENCH_BUDGET_S.
DEFAULT_BUDGET_S = float(os.environ.get("LPT_BENCH_BUDGET_S", "1020"))

# Exit code of a stage (and of the orchestrator) that found no GPU.
NO_GPU_EXIT = 2

# Mutable orchestrator state shared with the signal handler: the best
# currently-known result line and the live stage subprocess (killed on
# abort so no orphan keeps holding the card).
_PARTIAL: dict = {}
_CURRENT_PROC: list = []
_EMITTED = [False]


def _emit(result: dict) -> None:
    """Print the one JSON line exactly once.  The flag is set only
    after the line is out, so a signal arriving mid-write still lets
    the handler print it."""
    if _EMITTED[0]:
        return
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    _EMITTED[0] = True


_PROGRESS_PATH = [None]


def _read_progress_file():
    if not _PROGRESS_PATH[0]:
        return None
    try:
        with open(_PROGRESS_PATH[0]) as f:
            return json.loads(f.read())
    except (OSError, ValueError):
        return None


def _abort_handler(signum, frame):
    """SIGTERM/SIGINT/SIGALRM: kill the live stage, flush the
    best-known result as the one JSON line, exit 0 (the contract is
    the line, not the exit code).  If the headline never finished but
    dropped a progress file, its last completed chunk is the value."""
    for proc in _CURRENT_PROC:
        try:
            proc.kill()
        except Exception:
            pass
    result = _PARTIAL or _null_result(
        f"aborted by signal {signum} before headline completed")
    if result.get("value") is None:
        frag = _read_progress_file()
        if frag is not None:
            result = _assemble(
                dict(frag), f"killed by signal {signum} mid-headline; "
                            "value is the last completed chunk")
    _emit(result)
    os._exit(0)


def _null_result(note: str) -> dict:
    return {"metric": "mrays_per_sec_chip_cornell", "value": None,
            "unit": "Mrays/s", "vs_baseline": None,
            "extras": {"note": note}}


def _assemble(head: dict, note: str | None = None) -> dict:
    """Build the one-line result dict from a headline fragment (a
    completed stage's JSON or a partial-progress drop)."""
    mrays = head.pop("mrays")
    extras = {
        "ray_query_mrays_per_sec": head.pop("ray_query_mrays_per_sec",
                                            None),
        "outside_class_mrays_per_sec": None,
        "nee_textured_mrays_per_sec": None,
        "vs_baseline_note": "no baseline measured on this device yet",
        **head,
    }
    if note:
        extras["note"] = note
    return {
        "metric": "mrays_per_sec_chip_cornell",
        "value": mrays,
        "unit": "Mrays/s",
        "vs_baseline": None,
        "extras": extras,
    }


def _ray_query_mrays(scene, cfg) -> float:
    """Intersect-only throughput on primary rays (config 4)."""
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from logipathtracer_tpu.ops.camera import generate_ray
    from logipathtracer_tpu.ops.rng import seed_from_pixel
    from logipathtracer_tpu.ops.traverse import select_traversal

    h, w = cfg.render_height, cfg.render_width
    ys, xs = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    pix = jnp.stack([xs, ys], -1).reshape(-1, 2)
    seed = seed_from_pixel(jnp.asarray([48271, 16807], jnp.uint32), pix)
    o, d, _ = generate_ray(jnp.asarray(scene.cameras[0].world_matrix),
                           jnp.float32(scene.cameras[0].yfov), pix,
                           (w, h), seed)
    isect = select_traversal(cfg.intersect)
    f = jax.jit(lambda oo, dd: isect(scene, oo, dd,
                                     eps=cfg.eps)[0].sum()[None])
    float(np.asarray(f(o, d))[0])  # compile
    # K dispatches, ONE sync: JAX's async dispatch pipelines the queue,
    # so blocking once measures the device rate, not K host syncs.
    n = 10
    t0 = time.perf_counter()
    outs = [f(o, d) for _ in range(n)]
    jax.block_until_ready(outs)
    return n * h * w / (time.perf_counter() - t0) / 1e6


def _scene_mrays(gltf, cfg, samples: int = 4, host_seed: int = 0,
                 reps: int = 3):
    """End-to-end Mrays/s of one progressive config: best of ``reps``
    timed chunks after one warmup chunk of the same shape (the best
    rep is the least load-contaminated estimate of the same
    deterministic computation)."""
    import time

    from logipathtracer_tpu.render.progressive import ProgressiveRenderer
    from logipathtracer_tpu.scene.compile import compile_scene

    scene = compile_scene(gltf, cfg)
    r = ProgressiveRenderer(scene, cfg, host_seed=host_seed)
    r.step(samples)  # warmup (compile; fills the carryover pool)
    best = 0.0
    for _ in range(reps):
        rays0 = r.total_rays
        t0 = time.perf_counter()
        r.step(samples)
        wall = time.perf_counter() - t0
        best = max(best, (r.total_rays - rays0) / wall / 1e6)
    return best


def _init_jax(cpu: bool):
    """Import jax on the requested platform, wire the compile cache,
    and return (jax, run context).  Without ``cpu`` the default device
    must be a GPU: the stage exits with NO_GPU_EXIT otherwise."""
    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")
    from logipathtracer_tpu.utils.cache import configure_compile_cache
    from logipathtracer_tpu.utils.device import require_gpu, run_context
    if not cpu:
        try:
            require_gpu(jax)
        except RuntimeError as e:
            print(f"bench: {e}", file=sys.stderr)
            sys.exit(NO_GPU_EXIT)
    configure_compile_cache(jax)
    return jax, run_context(jax)


def _load_scene(path):
    """The scene file at ``path``, or the generated cornell-class scene
    when none is given."""
    if path:
        from logipathtracer_tpu.scene.gltf import load_gltf
        return load_gltf(path)
    from logipathtracer_tpu.scene.procedural import make_cornell_scene
    return make_cornell_scene()


def stage_headline(args) -> dict:
    """Cornell end-to-end + the intersect-only ray-query workload."""
    _, context = _init_jax(args.cpu)

    width = args.width or (128 if args.quick else 1024)
    height = args.height or (128 if args.quick else 1024)
    samples = args.samples or (2 if args.quick else 32)

    from logipathtracer_tpu.config import RenderConfig
    from logipathtracer_tpu.render.progressive import ProgressiveRenderer
    from logipathtracer_tpu.scene.compile import compile_scene

    cfg = RenderConfig(width=width, height=height, max_depth=10)
    t0 = time.perf_counter()
    scene = compile_scene(_load_scene(args.scene), cfg)
    compile_s = time.perf_counter() - t0

    def progress(frag: dict) -> None:
        """Best-effort partial-result drop for the orchestrator: if
        this stage is killed mid-measurement (driver timeout), the
        orchestrator reads the last completed chunk's numbers from
        here instead of reporting nothing (BENCH_r04 rc=124 lesson)."""
        if not args.progress_file:
            return
        try:
            tmp = args.progress_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(json.dumps(frag))
            os.replace(tmp, args.progress_file)
        except OSError:
            pass

    r = ProgressiveRenderer(scene, cfg, host_seed=0)
    # Warmup chunk = timed chunk, so every timed step reuses the warm
    # executables.
    chunk = max(1, min(16, samples))
    t0 = time.perf_counter()
    r.step(chunk)
    warmup_s = time.perf_counter() - t0

    timed = max(chunk, (samples // chunk) * chunk)
    t0 = time.perf_counter()
    done = 0
    for _ in range(timed // chunk):
        r.step(chunk)
        done += chunk
        wall_so_far = time.perf_counter() - t0
        rps = r.total_rays / r.sample_count
        progress({"mrays": round(rps * done / wall_so_far / 1e6, 3),
                  "partial": "killed mid-headline",
                  **context,
                  "resolution": f"{width}x{height}", "spp_timed": done,
                  "samples_per_sec": round(done / wall_so_far, 4),
                  "rays_per_sample": round(rps, 1),
                  "scene_compile_s": round(compile_s, 2),
                  "xla_warmup_s": round(warmup_s, 2)})
    wall = time.perf_counter() - t0
    samples = timed
    rays_per_sample = r.total_rays / r.sample_count
    mrays = rays_per_sample * samples / wall / 1e6
    spp_per_sec = samples / wall

    mean_radiance = round(float(r.radiance().mean()), 5)

    # Ray-query workload (BASELINE config 4): closest-hit only on a
    # full-frame primary wavefront — the RTX-backend-parity number, no
    # shading attached.
    rq_mrays = _ray_query_mrays(scene, cfg)

    return {
        "mrays": round(mrays, 3),
        "ray_query_mrays_per_sec": round(rq_mrays, 1),
        **context,
        "resolution": f"{width}x{height}",
        "spp_timed": samples,
        "samples_per_sec": round(spp_per_sec, 4),
        "rays_per_sample": round(rays_per_sample, 1),
        "scene_compile_s": round(compile_s, 2),
        "xla_warmup_s": round(warmup_s, 2),
        "mean_radiance": mean_radiance,
    }


def stage_outside(args) -> dict:
    """Outside-class multi-object scene (BASELINE config 3 stand-in:
    51 meshes / 49 materials / ~394k tris)."""
    _, context = _init_jax(args.cpu)
    from logipathtracer_tpu.config import RenderConfig
    from logipathtracer_tpu.scene.procedural import make_outside_scene

    # 16-sample timed chunks: at 512^2 a 4-sample chunk equals the
    # 1M-lane pool, so the whole measurement is pool fill + drain
    # tail; 16 samples measures the steady state the progressive
    # accumulation actually runs at.
    return {"outside_class_mrays_per_sec": round(_scene_mrays(
        make_outside_scene(),
        RenderConfig(width=512, height=512, max_depth=10),
        samples=16), 3), "outside_context": context}


def stage_nee_tex(args) -> dict:
    """Textured + NEE box (BASELINE config 5 stand-in)."""
    _, context = _init_jax(args.cpu)
    from logipathtracer_tpu.config import RenderConfig
    from logipathtracer_tpu.scene.procedural import make_box_scene

    return {"nee_textured_mrays_per_sec": round(_scene_mrays(
        make_box_scene(spheres=6, subdiv=3, textured=True),
        RenderConfig(width=512, height=512, max_depth=10, nee=True),
        samples=16), 3), "nee_textured_context": context}


STAGES = {
    "headline": stage_headline,
    "outside": stage_outside,
    "nee_tex": stage_nee_tex,
}


def _run_stage_subprocess(stage: str, argv: list, timeout_s: float):
    """Run one measurement stage in a fresh python process; return its
    parsed JSON fragment (the last stdout line starting with '{').

    The Popen handle is registered in _CURRENT_PROC so the SIGTERM
    abort handler can kill it — an orphaned stage would keep holding
    the card and sink the NEXT invocation too."""
    cmd = [sys.executable, os.path.abspath(__file__), "--stage", stage,
           *argv]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    _CURRENT_PROC.append(proc)
    try:
        stdout, stderr = proc.communicate(timeout=max(timeout_s, 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    finally:
        _CURRENT_PROC.remove(proc)
    sys.stderr.write(stderr)
    if proc.returncode == NO_GPU_EXIT:
        raise NoGpuError(stderr.strip().splitlines()[-1] if stderr.strip()
                         else "no GPU")
    for line in reversed(stdout.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(
        f"stage {stage} produced no JSON (exit {proc.returncode}); "
        f"stdout tail: {stdout.strip()[-300:]!r}")


class NoGpuError(RuntimeError):
    """A stage found no GPU and --cpu was not given."""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small config for smoke testing")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--samples", type=int, default=None,
                    help="timed samples")
    ap.add_argument("--scene", default=None,
                    help=".gltf/.glb file for the headline stage "
                         "(default: the generated cornell-class scene)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--stage", choices=sorted(STAGES), default=None,
                    help="internal: run ONE measurement stage inline "
                         "and print its JSON fragment")
    ap.add_argument("--inline", action="store_true",
                    help="run everything in this process (no "
                         "subprocesses; extras will read low — see "
                         "module docstring)")
    ap.add_argument("--budget", type=float, default=DEFAULT_BUDGET_S,
                    help="total wall-clock budget (s); extras are "
                         "skipped when the headline eats it, and the "
                         "JSON line always lands")
    ap.add_argument("--progress-file", default=None,
                    help="internal: headline stage drops partial "
                         "numbers here after each timed chunk")
    args = ap.parse_args(argv)

    if args.stage:
        print(json.dumps(STAGES[args.stage](args)))
        return 0

    # Orchestrator: this process never imports jax, so each sequential
    # stage subprocess has the card to itself and a fresh runtime.
    # The one-JSON-line contract is guaranteed three ways: a
    # SIGTERM/SIGINT handler that flushes the best-known result, a
    # wall-clock budget that skips extras and caps the headline, and a
    # headline progress file for best-effort numbers when even the
    # headline is killed mid-measurement.
    t_start = time.monotonic()

    def remaining() -> float:
        return args.budget - (time.monotonic() - t_start)

    signal.signal(signal.SIGTERM, _abort_handler)
    signal.signal(signal.SIGINT, _abort_handler)
    # Belt-and-braces self-deadline: even if every subprocess wait is
    # already budget-bounded, fire the abort path shortly before the
    # budget so the line is printed before any external SIGKILL grace
    # window closes.
    signal.signal(signal.SIGALRM, _abort_handler)
    signal.alarm(max(int(args.budget) - 15, 10))
    _PARTIAL.update(_null_result("headline stage did not complete"))

    progress_path = os.path.join(
        tempfile.gettempdir(), f"lpt_bench_progress_{os.getpid()}.json")
    _PROGRESS_PATH[0] = progress_path

    passthrough = []
    if args.quick:
        passthrough.append("--quick")
    if args.cpu:
        passthrough.append("--cpu")
    for flag in ("width", "height", "samples"):
        v = getattr(args, flag)
        if v is not None:
            passthrough += [f"--{flag}", str(v)]
    if args.scene:
        passthrough += ["--scene", args.scene]
    passthrough += ["--progress-file", progress_path]

    try:
        if args.inline:
            head = stage_headline(args)
        else:
            head = _run_stage_subprocess(
                "headline", passthrough, remaining() - 45.0)
    except NoGpuError as e:
        _PARTIAL["extras"]["note"] = str(e)[:300]
        _emit(_PARTIAL)
        return NO_GPU_EXIT
    except Exception as e:
        frag = _read_progress_file()
        if frag is not None:
            _PARTIAL.clear()
            _PARTIAL.update(_assemble(
                dict(frag), f"headline killed mid-run ({type(e).__name__});"
                            " value is the last completed chunk"))
        else:
            _PARTIAL["extras"]["note"] = (
                f"headline stage failed before any timed chunk: "
                f"{e}"[:300])
        _emit(_PARTIAL)
        return 0

    _PARTIAL.clear()
    _PARTIAL.update(_assemble(dict(head)))
    try:
        os.unlink(progress_path)
    except OSError:
        pass

    # Idle-host guard: the dispatch-heavy extras are host-load-
    # sensitive.  Record the 1-minute loadavg and flag contaminated
    # runs so a low extras number is never mistaken for a regression.
    loadavg_1m = round(os.getloadavg()[0], 2)
    host_contended = loadavg_1m > 4.0
    if host_contended:
        print(f"WARNING: loadavg {loadavg_1m} > 4 — dispatch-heavy "
              "extras (outside_class, nee_textured) are unreliable on "
              "a contended host; re-run idle for official numbers.",
              file=sys.stderr)
    _PARTIAL["extras"]["loadavg_1m"] = loadavg_1m
    _PARTIAL["extras"]["host_contended"] = host_contended

    # Cold-cache estimate per extras stage: one fresh backend init +
    # one or two compiles.  Skip (recording why) rather than blow the
    # budget — a missing extra is recoverable, a missing JSON line is
    # not.
    EXTRAS_EST_S = 120.0 if args.cpu else 480.0
    if not args.quick:
        for stage, key in (("outside", "outside_class_mrays_per_sec"),
                           ("nee_tex", "nee_textured_mrays_per_sec")):
            if remaining() < EXTRAS_EST_S + 60.0:
                _PARTIAL["extras"][key] = "skipped: budget exhausted"
                continue
            try:
                if args.inline:
                    frag = STAGES[stage](args)
                else:
                    frag = _run_stage_subprocess(
                        stage, passthrough, remaining() - 45.0)
                _PARTIAL["extras"].update(frag)
            except Exception as e:  # record, don't sink the headline
                _PARTIAL["extras"][key] = f"error: {e}"[:200]

    signal.alarm(0)
    _emit(_PARTIAL)
    return 0


if __name__ == "__main__":
    sys.exit(main())
