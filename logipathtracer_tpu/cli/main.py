"""Command-line entry points.

Replaces the reference's hardcoded main() (src/Main.cpp: compile-time
backend switch, hardcoded scene path and window size — SURVEY.md §5.6)
with a real flag surface:

  render  — headless progressive render to PNG (+ radiance .npz)
  view    — interactive progressive viewer in the terminal (ANSI
            half-blocks) with the reference's key bindings
            (src/Main.cpp:57-93): WASD/QE translate, IJKL/UO rotate;
            camera motion resets accumulation.
  web     — the same progressive session served to a browser tab over
            a stdlib HTTP server (cli/webview.py) — the headless-host
            analog of the reference's swapchain window
            (src/RendererCore.cpp:373-412), same key bindings.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

from logipathtracer_tpu.config import RenderConfig
from logipathtracer_tpu.film.image import to_uint8
from logipathtracer_tpu.film.png import write_png
from logipathtracer_tpu.scene.compile import compile_scene
from logipathtracer_tpu.scene.gltf import load_gltf
from logipathtracer_tpu.utils.log import get_logger

log = get_logger("cli")


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("scene", help="path to .gltf/.glb scene")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--render-scale", type=int, default=1)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--max-depth", type=int, default=10)
    p.add_argument("--basic", action="store_true",
                   help="basic single-scatter BSDFs instead of Heitz")
    p.add_argument("--nee", action="store_true",
                   help="next-event estimation with MIS (beyond the "
                        "reference; breaks reference RNG parity)")
    p.add_argument("--mips", type=int, default=1, metavar="N",
                   help="mip levels for texture sampling (1 = LOD 0 "
                        "only, the reference behavior)")
    p.add_argument("--seed", type=int, default=0, help="host RNG seed")
    p.add_argument("--camera", type=int, default=0, help="camera index")
    p.add_argument("--leaf-size", type=int, default=4)
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    p.add_argument("--renderer", default="auto",
                   choices=["auto", "wavefront", "megakernel"],
                   help="frame loop: lockstep megakernel (the "
                        "reference's RendererPT shape; auto) or pooled "
                        "wavefront")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax.profiler trace to DIR "
                        "(SURVEY.md §5.1 instrumentation)")


def _make_cfg(args, width: int, height: int) -> RenderConfig:
    return RenderConfig(width=width, height=height,
                        render_scale=args.render_scale,
                        max_depth=args.max_depth,
                        use_microfacet=not args.basic,
                        nee=args.nee,
                        mip_levels=args.mips,
                        renderer=args.renderer,
                        bvh_leaf_size=args.leaf_size)


def _compile_and_renderer(args, gltf, cfg):
    t0 = time.perf_counter()
    scene = compile_scene(gltf, cfg)
    log.info("scene compiled in %.2fs: %d objects, %d fused BVH nodes, "
             "stack %d", time.perf_counter() - t0, scene.num_objects,
             scene.fused_min.shape[0], scene.max_stack)
    from logipathtracer_tpu.render.progressive import ProgressiveRenderer
    cam = scene.cameras[args.camera] if scene.cameras else None
    return scene, ProgressiveRenderer(scene, cfg, camera=cam,
                                      host_seed=args.seed)


def _build(args):
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from logipathtracer_tpu.utils.cache import configure_compile_cache
    configure_compile_cache(jax)
    cfg = _make_cfg(args, args.width, args.height)
    log.info("loading %s", args.scene)
    gltf = load_gltf(args.scene)
    log.info("compiling scene: %d nodes, %d triangles",
             len(gltf.mesh_nodes), gltf.triangle_count)
    scene, renderer = _compile_and_renderer(args, gltf, cfg)
    return cfg, scene, renderer


def _build_web(args):
    """Web-viewer builder: the full-res progressive renderer plus (at
    --preview-scale > 1) a reduced-resolution PREVIEW renderer over the
    same glTF, used for display-rate frames while the camera moves
    (webview.py module docstring)."""
    cfg, scene, renderer = _build(args)
    scale = getattr(args, "preview_scale", 1)
    if scale <= 1:
        return cfg, scene, renderer
    pw = max(64, args.width // scale)
    ph = max(64, args.height // scale)
    gltf = load_gltf(args.scene)
    log.info("compiling %dx%d navigation preview scene", pw, ph)
    cfg_p = _make_cfg(args, pw, ph)
    # Navigation preview trades fidelity for display rate in TWO ways:
    # resolution (above) and path depth — a depth-limited preview cuts
    # the per-frame bounce count ~depth-proportionally.  Converge
    # frames are always full-depth/full-res.
    pd = getattr(args, "preview_depth", 0)
    if pd and pd < cfg_p.max_depth:
        cfg_p = dataclasses.replace(cfg_p, max_depth=pd)
    _, preview = _compile_and_renderer(args, gltf, cfg_p)
    return cfg, scene, renderer, preview


def cmd_render(args) -> int:
    cfg, scene, r = _build(args)
    if args.resume and os.path.exists(r.checkpoint_path(args.resume)):
        r.restore(args.resume)
        log.info("resumed from %s at %d samples", args.resume,
                 r.sample_count)
    profiler = None
    if args.profile:
        import jax
        jax.profiler.start_trace(args.profile)
        profiler = args.profile
    t0 = time.perf_counter()
    while r.sample_count < args.spp:
        batch = min(args.checkpoint_every or args.spp,
                    args.spp - r.sample_count)
        r.step(batch)
        if args.resume:
            r.checkpoint(args.resume)
        log.info("%d/%d samples  %.2f samples/s  %.2f Mrays/s",
                 r.sample_count, args.spp, r.samples_per_sec(),
                 r.mrays_per_sec())
    wall = time.perf_counter() - t0
    if profiler:
        import jax
        jax.profiler.stop_trace()
        log.info("profiler trace in %s", profiler)
    img = to_uint8(np.asarray(r.image()))
    write_png(args.output, img)
    log.info("wrote %s", args.output)
    if args.exr:
        from logipathtracer_tpu.film.exr import write_exr
        write_exr(args.exr, r.radiance())
        log.info("wrote %s", args.exr)
    if args.radiance:
        np.savez(args.radiance, radiance=r.radiance(),
                 sample_count=r.sample_count)
        log.info("wrote %s", args.radiance)
    report = {
        "scene": scene.name, "width": cfg.render_width,
        "height": cfg.render_height, "spp": r.sample_count,
        "wall_s": round(wall, 3),
        "samples_per_sec": round(r.samples_per_sec(), 4),
        "mrays_per_sec": round(r.mrays_per_sec(), 3),
        "total_rays": r.total_rays,
    }
    print(json.dumps(report))
    return 0


def _ansi_frame(img: np.ndarray) -> str:
    """Render [H, W, 3] float image as ANSI 24-bit half-blocks."""
    u8 = to_uint8(img)
    h = u8.shape[0] // 2 * 2
    rows = []
    for y in range(0, h, 2):
        row = []
        for x in range(u8.shape[1]):
            t = u8[y, x]
            b = u8[y + 1, x]
            row.append(f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m"
                       f"\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀")
        rows.append("".join(row) + "\x1b[0m")
    return "\n".join(rows)


def cmd_view(args) -> int:
    if args.frames:
        # Non-interactive demo/smoke mode: render N progressive frames,
        # print the last one as ANSI, exit (no tty needed).
        cfg, scene, r = _build(args)
        for i in range(args.frames):
            r.step(1)
            if args.orbit:
                r.rotate(1, args.orbit)
        sys.stdout.write(_ansi_frame(np.asarray(r.image())) + "\x1b[0m\n")
        print(f"spp {r.sample_count}  {r.samples_per_sec():.2f} samples/s  "
              f"{r.mrays_per_sec():.2f} Mrays/s")
        return 0

    import select
    import termios
    import threading
    import tty

    # Async scene load (reference parity: Main.cpp:45 compiles the PT
    # scene on a background thread while the window loop runs, gated at
    # RendererPT.cpp:608-612): the terminal session is live — and
    # responsive to 'x' — immediately; rendering starts when the
    # compile lands.
    box = {}

    def _load():
        try:
            box["built"] = _build(args)
        except Exception as exc:  # surfaced in the main loop
            box["error"] = exc

    loader = threading.Thread(target=_load, daemon=True)
    loader.start()

    move = 0.05
    turn = 0.02
    keymap_t = {"w": (2, -move), "s": (2, move), "a": (0, -move),
                "d": (0, move), "q": (1, move), "e": (1, -move)}
    keymap_r = {"i": (0, turn), "k": (0, -turn), "j": (1, turn),
                "l": (1, -turn), "u": (2, turn), "o": (2, -turn)}

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        sys.stdout.write("\x1b[2J")
        t0 = time.perf_counter()
        while "built" not in box:
            if "error" in box:
                raise box["error"]
            sys.stdout.write(
                f"\x1b[Hcompiling {os.path.basename(args.scene)} ... "
                f"{time.perf_counter() - t0:5.1f}s  [x quit]\n")
            sys.stdout.flush()
            if select.select([sys.stdin], [], [], 0.2)[0]:
                if sys.stdin.read(1) == "x":
                    return 0
        cfg, scene, r = box["built"]
        while True:
            r.step(1)
            frame = _ansi_frame(np.asarray(r.image()))
            sys.stdout.write("\x1b[H" + frame
                             + f"\n\x1b[0mspp {r.sample_count}  "
                             f"{r.samples_per_sec():.2f} samples/s  "
                             f"{r.mrays_per_sec():.1f} Mrays/s  "
                             "[wasdqe move, ijkl/uo rotate, x quit]\n")
            sys.stdout.flush()
            while select.select([sys.stdin], [], [], 0)[0]:
                key = sys.stdin.read(1)
                if key == "x":
                    return 0
                if key in keymap_t:
                    r.translate(*keymap_t[key])
                if key in keymap_r:
                    r.rotate(*keymap_r[key])
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[0m\n")


def cmd_web(args) -> int:
    from logipathtracer_tpu.cli.webview import serve
    return serve(args, _build_web)


def cmd_compare(args) -> int:
    from logipathtracer_tpu.film.image import rmse
    a = np.load(args.a)["radiance"]
    b = np.load(args.b)["radiance"]
    if a.shape != b.shape:
        print(json.dumps({"error": f"shape mismatch {a.shape} vs {b.shape}"}))
        return 1
    err = rmse(a, b)
    print(json.dumps({"rmse": err, "shape": list(a.shape),
                      "mean_a": float(np.mean(a)),
                      "mean_b": float(np.mean(b))}))
    if args.threshold is not None and err > args.threshold:
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="logipathtracer",
        description="Progressive Monte Carlo path tracer for glTF scenes")
    sub = ap.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("render", help="headless render to PNG")
    _add_common(pr)
    pr.add_argument("-o", "--output", default="render.png")
    pr.add_argument("--exr", default=None,
                    help="also write linear-radiance OpenEXR")
    pr.add_argument("--radiance", default=None,
                    help="also write mean radiance .npz (RMSE metric input)")
    pr.add_argument("--resume", default=None,
                    help="checkpoint file to resume from / save to")
    pr.add_argument("--checkpoint-every", type=int, default=None,
                    help="samples between checkpoints")
    pr.set_defaults(fn=cmd_render)

    pv = sub.add_parser("view", help="interactive terminal viewer")
    _add_common(pv)
    pv.add_argument("--frames", type=int, default=0,
                    help="non-interactive: render N frames and exit")
    pv.add_argument("--orbit", type=float, default=0.0,
                    help="with --frames: rotate camera per frame (rad)")
    pv.set_defaults(fn=cmd_view)

    pw = sub.add_parser("web", help="browser-based progressive viewer "
                                    "(stdlib HTTP server; the headless-"
                                    "host analog of the reference's "
                                    "swapchain window)")
    _add_common(pw)
    pw.add_argument("--host", default="127.0.0.1")
    pw.add_argument("--port", type=int, default=8642,
                    help="TCP port (0 = ephemeral, see --port-file)")
    pw.add_argument("--port-file", default=None,
                    help="write the bound port here once listening")
    pw.add_argument("--frames", type=int, default=0,
                    help="render N frames then exit (0 = until 'x')")
    pw.add_argument("--preview-scale", type=int, default=4,
                    help="resolution divisor for frames rendered while "
                         "the camera is moving (1 disables the preview "
                         "renderer; 4 = 16x fewer rays per navigation "
                         "frame, upscaled client-side)")
    pw.add_argument("--preview-depth", type=int, default=4,
                    help="max path depth for navigation-preview frames "
                         "(0 = full depth; converge frames always use "
                         "the full configured depth)")
    pw.add_argument("--settle-s", type=float, default=0.35,
                    help="seconds of camera stillness before switching "
                         "back from the navigation preview to full-res "
                         "accumulation")
    pw.add_argument("--spp-per-frame", type=int, default=1,
                    help="samples accumulated per converge present "
                         "(each present pays a full pool drain; "
                         "batching amortizes it — higher converge "
                         "throughput, lower present rate; navigation "
                         "frames always render 1 spp)")
    pw.add_argument("--linger", type=float, default=0.0,
                    help="with --frames: keep serving this many seconds "
                         "after the last frame (screenshot window)")
    pw.set_defaults(fn=cmd_web)

    pc = sub.add_parser("compare",
                        help="per-pixel RMSE between two radiance .npz "
                             "files (the BASELINE.json parity metric)")
    pc.add_argument("a")
    pc.add_argument("b")
    pc.add_argument("--threshold", type=float, default=None,
                    help="exit 1 if RMSE exceeds this")
    pc.set_defaults(fn=cmd_compare)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
