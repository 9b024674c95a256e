"""Pooled wavefront renderer vs megakernel (SURVEY.md §7 step 3:
verify equivalence at equal seeds)."""

import jax.numpy as jnp
import numpy as np
import pytest

from logipathtracer_tpu.config import RenderConfig
from logipathtracer_tpu.render.megakernel import render_sample
from logipathtracer_tpu.render.progressive import ProgressiveRenderer
from logipathtracer_tpu.render.wavefront import render_wavefront

SEEDS = [[48271, 16807], [11, 22], [777, 999]]


def _mk_sum(scene, cfg, seeds):
    cam = scene.cameras[0]
    out = None
    for s in seeds:
        img = np.asarray(render_sample(
            scene, cfg, jnp.asarray(cam.world_matrix),
            jnp.float32(cam.yfov), jnp.asarray(s, jnp.uint32)))
        out = img if out is None else out + img
    return out


@pytest.mark.parametrize("pool", [256, 1024, 4096])
def test_wavefront_matches_megakernel(cornell_scene, pool):
    cfg = RenderConfig(width=32, height=32, max_depth=6, intersect="bvh")
    cam = cornell_scene.cameras[0]
    wf, rays, _ = render_wavefront(
        cornell_scene, cfg, jnp.asarray(cam.world_matrix),
        jnp.float32(cam.yfov), jnp.asarray(SEEDS, jnp.uint32), pool=pool)
    wf = np.asarray(wf)
    mk = _mk_sum(cornell_scene, cfg, SEEDS)
    close = np.isclose(wf, mk, rtol=1e-4, atol=1e-6).all(axis=-1)
    assert close.mean() > 0.995, f"{(~close).sum()} divergent pixels"
    assert float(rays) > 0


def test_wavefront_unsorted(cornell_scene):
    cfg = RenderConfig(width=32, height=32, max_depth=4, intersect="bvh",
                       sort_rays=False)
    cam = cornell_scene.cameras[0]
    wf, _, _ = render_wavefront(
        cornell_scene, cfg, jnp.asarray(cam.world_matrix),
        jnp.float32(cam.yfov), jnp.asarray(SEEDS[:1], jnp.uint32), pool=512)
    mk = _mk_sum(cornell_scene, cfg, SEEDS[:1])
    close = np.isclose(np.asarray(wf), mk, rtol=1e-4, atol=1e-6).all(axis=-1)
    assert close.mean() > 0.995


def test_wavefront_ray_count(cornell_scene):
    """Pool compaction must trace exactly the rays the megakernel counts
    as alive (same paths, same lengths)."""
    from logipathtracer_tpu.render.megakernel import trace_rays
    from logipathtracer_tpu.ops.camera import generate_ray
    from logipathtracer_tpu.ops.rng import seed_from_pixel
    cfg = RenderConfig(width=16, height=16, max_depth=6, intersect="bvh",
                       sort_rays=False)
    cam = cornell_scene.cameras[0]
    h = w = 16
    ys, xs = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    pix = jnp.stack([xs, ys], -1).reshape(-1, 2)
    seed = seed_from_pixel(jnp.asarray(SEEDS[0], jnp.uint32), pix)
    o, d, seed = generate_ray(jnp.asarray(cam.world_matrix),
                              jnp.float32(cam.yfov), pix, (w, h), seed)
    _, _, rays_mk = trace_rays(cornell_scene, cfg, o, d, seed)
    _, rays_wf, _ = render_wavefront(
        cornell_scene, cfg, jnp.asarray(cam.world_matrix),
        jnp.float32(cam.yfov), jnp.asarray(SEEDS[:1], jnp.uint32), pool=128)
    assert float(rays_mk) == float(rays_wf)


def test_progressive_wavefront_mode(cornell_scene):
    cfg = RenderConfig(width=32, height=32, max_depth=4,
                       renderer="wavefront", intersect="bvh")
    r = ProgressiveRenderer(cornell_scene, cfg, host_seed=5)
    r.step(2)
    assert r.sample_count == 2
    a = r.radiance()
    r.step(2)
    assert r.sample_count == 4
    assert np.isfinite(r.radiance()).all()
    # vs megakernel renderer with the same host seed
    cfg2 = cfg.replace(renderer="megakernel")
    r2 = ProgressiveRenderer(cornell_scene, cfg2, host_seed=5)
    r2.step(2)
    close = np.isclose(a, r2.radiance(), rtol=1e-4, atol=1e-6).all(axis=-1)
    assert close.mean() > 0.995


@pytest.mark.parametrize("knobs", [dict(sort_every=2),
                                   dict(lazy_regen=4),
                                   dict(sort_every=3, lazy_regen=8)])
def test_wavefront_scheduling_knobs_preserve_image(cornell_scene, knobs):
    """sort_every / lazy_regen change only WHEN maintenance passes run;
    per-work-item radiance (and traced-ray counts) must be unchanged."""
    base = RenderConfig(width=32, height=32, max_depth=5, intersect="bvh")
    cam = cornell_scene.cameras[0]
    args = (jnp.asarray(cam.world_matrix), jnp.float32(cam.yfov),
            jnp.asarray(SEEDS[:2], jnp.uint32))
    ref, rays_ref, _ = render_wavefront(cornell_scene, base, *args, pool=512)
    out, rays_out, _ = render_wavefront(cornell_scene,
                                     base.replace(**knobs), *args,
                                     pool=512)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    assert float(rays_ref) == float(rays_out)


def test_sliced_regen_ladder_preserves_image(cornell_scene, monkeypatch):
    """The sliced-regen cond ladder (p//8 and p//4 windows over the
    contiguous free region) must be radiance- and ray-count-preserving.
    Production pools engage it via REGEN_FLOOR; here the floor shrinks
    so CPU-sized pools exercise both rungs."""
    import logipathtracer_tpu.render.wavefront as wf
    cfg = RenderConfig(width=32, height=32, max_depth=5, intersect="bvh")
    cam = cornell_scene.cameras[0]
    args = (jnp.asarray(cam.world_matrix), jnp.float32(cam.yfov),
            jnp.asarray(SEEDS[:2], jnp.uint32))
    ref, rays_ref, _ = render_wavefront(cornell_scene, cfg, *args,
                                        pool=2048)
    ref = np.asarray(ref)
    monkeypatch.setattr(wf, "REGEN_FLOOR", 64)
    render_wavefront.clear_cache()  # the floor is not in the jit key
    try:
        out, rays_out, _ = render_wavefront(cornell_scene, cfg, *args,
                                            pool=2048)
        np.testing.assert_allclose(np.asarray(out), ref,
                                   rtol=1e-5, atol=1e-6)
        assert float(rays_ref) == float(rays_out)
    finally:
        render_wavefront.clear_cache()


def test_occupancy_ladder_preserves_image(cornell_scene, monkeypatch):
    """The trace+shade occupancy ladder (p//4 / p//2 alive-prefix
    windows) must be radiance- and ray-count-preserving: live lanes see
    identical tile compositions (prefix windows start at lane 0), and
    dead tail lanes are regen-overwritten before reuse either way.
    Production pools engage it via TRACE_FLOOR; here the floor shrinks
    so CPU-sized pools exercise both rungs (drain iterations drop the
    alive count through every window size)."""
    import logipathtracer_tpu.render.wavefront as wf
    cfg = RenderConfig(width=32, height=32, max_depth=5, intersect="bvh")
    cam = cornell_scene.cameras[0]
    args = (jnp.asarray(cam.world_matrix), jnp.float32(cam.yfov),
            jnp.asarray(SEEDS[:2], jnp.uint32))
    ref, rays_ref, _ = render_wavefront(cornell_scene, cfg, *args,
                                        pool=2048)
    ref = np.asarray(ref)
    monkeypatch.setattr(wf, "TRACE_FLOOR", 64)
    render_wavefront.clear_cache()  # the floor is not in the jit key
    try:
        out, rays_out, _ = render_wavefront(cornell_scene, cfg, *args,
                                            pool=2048)
        np.testing.assert_allclose(np.asarray(out), ref,
                                   rtol=1e-6, atol=1e-7)
        assert float(rays_ref) == float(rays_out)
    finally:
        render_wavefront.clear_cache()


def test_wavefront_row_slab(cornell_scene):
    """y0/rows slab renders must tile back into the full-frame render
    (absolute-pixel RNG keying — what tile-parallel meshes rely on)."""
    cfg = RenderConfig(width=32, height=32, max_depth=4, intersect="bvh")
    cam = cornell_scene.cameras[0]
    args = (jnp.asarray(cam.world_matrix), jnp.float32(cam.yfov),
            jnp.asarray(SEEDS[:2], jnp.uint32))
    full, rays_full, _ = render_wavefront(cornell_scene, cfg, *args, pool=512)
    top, rays_t, _ = render_wavefront(cornell_scene, cfg, *args, pool=512,
                                   y0=0, rows=16)
    bot, rays_b, _ = render_wavefront(cornell_scene, cfg, *args, pool=512,
                                   y0=16, rows=16)
    tiled = np.concatenate([np.asarray(top), np.asarray(bot)], axis=0)
    np.testing.assert_allclose(tiled, np.asarray(full),
                               rtol=1e-5, atol=1e-6)
    assert float(rays_t) + float(rays_b) == float(rays_full)
