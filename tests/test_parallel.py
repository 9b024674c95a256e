"""Multi-chip sharding tests on the 8-virtual-CPU-device mesh
(SURVEY.md §4: the sharded render must reproduce the single-device
pixels for the same sample set).  The ``mesh_devices`` fixture skips
them where fewer than eight devices exist."""

import jax.numpy as jnp
import numpy as np
import pytest

from logipathtracer_tpu.config import RenderConfig
from logipathtracer_tpu.parallel.mesh import MeshRenderer, make_mesh
from logipathtracer_tpu.render.megakernel import render_sample

def _single_device_sum(scene, cfg, seeds):
    cam = scene.cameras[0]
    total = np.zeros((cfg.render_height, cfg.render_width, 3), np.float32)
    per_sample = []
    for s in seeds:
        img = np.asarray(render_sample(
            scene, cfg, jnp.asarray(cam.world_matrix),
            jnp.float32(cam.yfov), jnp.asarray(s, jnp.uint32)))
        per_sample.append(img)
        total += img
    return total, per_sample


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_mesh_matches_single_device(mesh_devices, cornell_scene, shape):
    samples, tiles = shape
    cfg = RenderConfig(width=16, height=16, max_depth=4)
    mesh = make_mesh(mesh_devices, samples=samples, tiles=tiles)
    r = MeshRenderer(cornell_scene, cfg, mesh, host_seed=42)
    r.step()
    # Reproduce the same host seed draws.
    rng = np.random.default_rng(42)
    seeds = rng.integers(1, 2 ** 31, (samples, 2), dtype=np.int64)
    _, per_sample = _single_device_sum(cornell_scene, cfg, seeds)
    # Per-(sample, tile)-shard bit-identity against the single-device
    # render of the same seed.
    accum = np.asarray(r.accum)  # [S, H, W, 3]
    for i in range(samples):
        np.testing.assert_array_equal(accum[i], per_sample[i])
    # Mean radiance consistent (summation order may differ by ULPs).
    mean = r.radiance()
    want = np.mean(per_sample, axis=0)
    np.testing.assert_allclose(mean, want, rtol=1e-5, atol=1e-7)


def test_mesh_placement_independent(mesh_devices, cornell_scene):
    """Multi-host readiness: radiance must not depend on device ORDER in
    the mesh (on a real DCN deployment the samples axis spans hosts, so
    the device array interleaves processes — a permuted single-host
    mesh exercises the same placement freedom)."""
    cfg = RenderConfig(width=16, height=16, max_depth=3)
    devs = list(mesh_devices)
    fwd = make_mesh(devs, samples=4, tiles=2)
    perm = devs[::-1]
    rev = make_mesh(perm, samples=4, tiles=2)
    a = MeshRenderer(cornell_scene, cfg, fwd, host_seed=7)
    b = MeshRenderer(cornell_scene, cfg, rev, host_seed=7)
    a.step()
    b.step()
    np.testing.assert_array_equal(np.asarray(a.accum), np.asarray(b.accum))


def test_mesh_progressive_accumulation(mesh_devices, cornell_scene):
    cfg = RenderConfig(width=16, height=16, max_depth=3)
    mesh = make_mesh(mesh_devices, samples=4, tiles=2)
    r = MeshRenderer(cornell_scene, cfg, mesh, host_seed=1)
    r.step()
    assert r.sample_count == 4
    first = r.radiance()
    r.step()
    assert r.sample_count == 8
    second = r.radiance()
    assert (first != second).any()
    assert np.isfinite(second).all()


def test_mesh_reset(mesh_devices, cornell_scene):
    cfg = RenderConfig(width=16, height=16, max_depth=3)
    mesh = make_mesh(mesh_devices, samples=2, tiles=4)
    r = MeshRenderer(cornell_scene, cfg, mesh, host_seed=1)
    r.step()
    r.step()
    assert r.sample_count == 4
    r.reset()
    r.step()
    assert r.sample_count == 2
    assert np.isfinite(r.radiance()).all()


def test_mesh_renderer_session_parity(mesh_devices, cornell_scene, tmp_path):
    """MeshRenderer carries the full ProgressiveRenderer session
    protocol: camera dirty/reset, throughput metrics, and mesh-shape-
    independent checkpoint/resume (VERDICT r1 weak item 8)."""
    cfg = RenderConfig(width=16, height=16, max_depth=3)
    mesh = make_mesh(mesh_devices, samples=4, tiles=2)
    r = MeshRenderer(cornell_scene, cfg, mesh, host_seed=3)
    r.step()
    r.step()
    assert r.sample_count == 8
    assert r.samples_per_sec() > 0 and r.mrays_per_sec() > 0
    assert np.isfinite(np.asarray(r.image())).all()

    ck = str(tmp_path / "mesh_ck")
    r.checkpoint(ck)
    before = r.radiance()

    # Resume on a DIFFERENT mesh shape: radiance must match bit-for-sum.
    mesh2 = make_mesh(mesh_devices, samples=2, tiles=4)
    r2 = MeshRenderer(cornell_scene, cfg, mesh2, host_seed=99)
    r2.restore(ck)
    assert r2.sample_count == 8
    np.testing.assert_allclose(r2.radiance(), before, rtol=1e-6)

    # Continued sampling uses the checkpointed host-RNG stream: equal to
    # continuing the original session.
    r.step()
    r2.step()
    # Different mesh shapes draw different seed batch shapes, so exact
    # equality is not required — but both must accumulate consistently.
    assert r.sample_count == 12 and r2.sample_count == 10

    # Camera motion resets accumulation.
    r.translate(2, -0.1)
    r.step()
    assert r.sample_count == 4
    assert np.isfinite(r.radiance()).all()


@pytest.mark.parametrize("shape", [(4, 2), (1, 8)])
def test_mesh_wavefront_tile_parallel(mesh_devices, cornell_scene, shape):
    """Tile-parallel meshes must run the wavefront renderer when the
    config selects it and reproduce the megakernel-mesh radiance."""
    samples, tiles = shape
    cfg = RenderConfig(width=16, height=16, max_depth=4,
                       renderer="wavefront", intersect="bvh")
    mesh = make_mesh(mesh_devices, samples=samples, tiles=tiles)
    r = MeshRenderer(cornell_scene, cfg, mesh, host_seed=21)
    r.step()
    assert r.sample_count == samples
    a = r.radiance()
    cfg2 = cfg.replace(renderer="megakernel")
    r2 = MeshRenderer(cornell_scene, cfg2, mesh, host_seed=21)
    r2.step()
    close = np.isclose(a, r2.radiance(), rtol=1e-4, atol=1e-6).all(axis=-1)
    assert close.mean() > 0.995, f"{(~close).sum()} divergent pixels"
