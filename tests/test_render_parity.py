"""Vectorized renderer vs scalar oracle.

The production renderer runs every pixel in lockstep with lane masks;
the oracle replays the reference's scalar control flow one pixel at a
time.  Agreement on radiance (small f32 tolerance for transcendental
ULP differences between numpy and XLA) demonstrates both correct
masking and reference-ordered RNG consumption (SURVEY.md §7 hard
parts 2-3)."""

import jax.numpy as jnp
import numpy as np
import pytest

from logipathtracer_tpu.config import RenderConfig
from logipathtracer_tpu.render.megakernel import render_sample
import oracle

UBO_SEED = (48271, 16807)


def _render_block(scene, cfg):
    cam = scene.cameras[0]
    img = render_sample(scene, cfg, jnp.asarray(cam.world_matrix),
                        jnp.float32(cam.yfov),
                        jnp.asarray(UBO_SEED, jnp.uint32))
    return np.asarray(img)


def _oracle_pixel(scene, cfg, x, y):
    cam = scene.cameras[0]
    return oracle.trace_pixel(scene, cfg, cam.world_matrix, cam.yfov,
                              np.asarray(UBO_SEED, np.uint32),
                              np.asarray([x, y], np.float32))


# A spread of pixels: walls, light region, bunny/spheres area, corners.
PIXELS = [(4, 4), (8, 3), (3, 9), (10, 10), (6, 12), (12, 6), (1, 1),
          (14, 14), (7, 7), (2, 13)]


@pytest.mark.parametrize("use_microfacet", [True, False],
                         ids=["heitz", "basic"])
def test_pixel_parity(cornell_scene, use_microfacet):
    cfg = RenderConfig(width=16, height=16, max_depth=10,
                       use_microfacet=use_microfacet)
    img = _render_block(cornell_scene, cfg)
    mismatches = []
    for (x, y) in PIXELS:
        want = _oracle_pixel(cornell_scene, cfg, x, y)
        got = img[y, x]
        if not np.allclose(got, want, rtol=2e-4, atol=2e-5):
            mismatches.append((x, y, got, want))
    assert not mismatches, f"pixels diverge: {mismatches}"


def test_deterministic(cornell_scene):
    cfg = RenderConfig(width=16, height=16, max_depth=6)
    a = _render_block(cornell_scene, cfg)
    b = _render_block(cornell_scene, cfg)
    np.testing.assert_array_equal(a, b)


def test_seed_changes_image(cornell_scene):
    cfg = RenderConfig(width=16, height=16, max_depth=6)
    cam = cornell_scene.cameras[0]
    a = np.asarray(render_sample(
        cornell_scene, cfg, jnp.asarray(cam.world_matrix),
        jnp.float32(cam.yfov), jnp.asarray([1, 2], jnp.uint32)))
    b = np.asarray(render_sample(
        cornell_scene, cfg, jnp.asarray(cam.world_matrix),
        jnp.float32(cam.yfov), jnp.asarray([3, 4], jnp.uint32)))
    assert (a != b).any()
