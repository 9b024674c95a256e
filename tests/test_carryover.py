"""Pool carryover across progressive chunks (render/wavefront.py
wavefront_chunk/wavefront_drain vs the single-shot render_wavefront).

The carryover form moves WHEN a path's contribution is flushed (drain
deferred to read time) but not its value: per-(pixel, sample) radiance
and traced-ray totals must match the single-shot wavefront exactly up
to accumulation order (ULPs) and intersect tie-breaks."""

import jax.numpy as jnp
import numpy as np
import pytest

from logipathtracer_tpu.config import RenderConfig
from logipathtracer_tpu.render.progressive import ProgressiveRenderer
from logipathtracer_tpu.render.wavefront import (render_wavefront,
                                                 wavefront_chunk,
                                                 wavefront_drain,
                                                 wavefront_pool_state)

SEEDS = [[48271, 16807], [11, 22], [777, 999], [31337, 271828]]


def _cam_args(scene):
    cam = scene.cameras[0]
    return jnp.asarray(cam.world_matrix), jnp.float32(cam.yfov)


@pytest.mark.parametrize("pool", [256, 2048])
def test_chunked_equals_single_shot(cornell_scene, pool):
    cfg = RenderConfig(width=32, height=32, max_depth=5, intersect="bvh")
    cam, fov = _cam_args(cornell_scene)
    seeds = jnp.asarray(SEEDS, jnp.uint32)
    ref, rays_ref, _ = render_wavefront(cornell_scene, cfg, cam, fov,
                                        seeds, pool=pool)
    npix = 32 * 32
    st = wavefront_pool_state(min(pool, npix), npix)
    st = wavefront_chunk(cornell_scene, cfg, cam, fov, seeds[:2], st)
    st = wavefront_chunk(cornell_scene, cfg, cam, fov, seeds[2:], st)
    st = wavefront_drain(cornell_scene, cfg, st)
    assert not bool(np.asarray(st["pending"]).any())
    out = np.asarray(st["accum"]).reshape(32, 32, 3)
    close = np.isclose(out, np.asarray(ref), rtol=1e-4, atol=1e-6) \
        .all(axis=-1)
    assert close.mean() > 0.995, f"{(~close).sum()} divergent pixels"
    assert float(st["rays"]) == pytest.approx(float(rays_ref), rel=5e-3)


def test_progressive_carryover_reads_are_exact(cornell_scene):
    """radiance()/image() must include every step()ed sample even with
    paths in flight at the read (drain-on-read), and match the
    non-carryover session bit-for-bit in expectation."""
    cfg = RenderConfig(width=32, height=32, max_depth=5,
                       renderer="wavefront", intersect="bvh",
                       pool_size=512)
    r = ProgressiveRenderer(cornell_scene, cfg, host_seed=5)
    r.step(2)
    a2 = r.radiance()          # forces a drain mid-session
    r.step(2)
    a4 = r.radiance()
    assert r.sample_count == 4
    assert np.isfinite(a4).all() and a4.mean() > 0

    ref = ProgressiveRenderer(
        cornell_scene, cfg.replace(pool_carryover=False),
        cornell_scene.cameras[0], host_seed=5)
    ref.step(2)
    b2 = ref.radiance()
    ref.step(2)
    b4 = ref.radiance()
    for got, want in ((a2, b2), (a4, b4)):
        close = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(axis=-1)
        assert close.mean() > 0.995
    assert r.total_rays == pytest.approx(ref.total_rays, rel=5e-3)


def test_carryover_checkpoint_roundtrip(tmp_path, cornell_scene):
    """checkpoint() drains first, so resume reproduces the exact session
    state (the invariant tests/test_progressive.py pins for the
    non-carryover path)."""
    cfg = RenderConfig(width=16, height=16, max_depth=4,
                       renderer="wavefront", intersect="bvh",
                       pool_size=128)
    r = ProgressiveRenderer(cornell_scene, cfg, host_seed=9)
    r.step(2)
    ckpt = str(tmp_path / "sess")
    r.checkpoint(ckpt)          # drains in-flight paths first
    r.step(2)
    want = r.radiance()

    r2 = ProgressiveRenderer(cornell_scene, cfg, host_seed=9)
    r2.restore(ckpt)
    r2.step(2)
    np.testing.assert_allclose(r2.radiance(), want, rtol=1e-5, atol=1e-7)
    assert r2.sample_count == r.sample_count


def test_carryover_camera_reset(cornell_scene):
    """A camera move (dirty) discards the in-flight pool along with the
    accumulator — no stale-camera paths leak into the new session."""
    cfg = RenderConfig(width=16, height=16, max_depth=4,
                       renderer="wavefront", intersect="bvh",
                       pool_size=128)
    r = ProgressiveRenderer(cornell_scene, cfg, host_seed=3)
    r.step(2)
    r.translate(0, 0.25)
    r.step(2)
    a = r.radiance()
    assert r.sample_count == 2

    r2 = ProgressiveRenderer(cornell_scene, cfg, host_seed=3)
    r2.step(2)                  # burn the same first two host seeds
    r2.translate(0, 0.25)
    r2.step(2)
    np.testing.assert_allclose(a, r2.radiance(), rtol=1e-5, atol=1e-7)
