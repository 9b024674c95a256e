"""Native C++ BVH builder: same schema + invariants as the numpy
builder (they are interchangeable by design, scene/bvh.py docstring)."""

import numpy as np
import pytest

from logipathtracer_tpu.scene.bvh import validate_bvh
from logipathtracer_tpu.scene.bvh_native import (build_bvh_native,
                                                 build_triangle_bvh_native,
                                                 native_available)

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="g++ toolchain unavailable")


@pytest.mark.parametrize("n", [1, 2, 5, 100, 5000])
def test_native_invariants(rng, n):
    mn = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    mx = mn + rng.uniform(0.01, 2.0, (n, 3)).astype(np.float32)
    bvh = build_bvh_native(mn, mx, leaf_size=4)
    validate_bvh(bvh, mn, mx)
    meta = bvh.nodes_meta
    leaves = meta[meta[:, 0] == 1]
    assert (leaves[:, 2] - leaves[:, 1] <= 4).all()


def test_native_triangles(rng):
    tris = rng.uniform(-5, 5, (3000, 3, 3)).astype(np.float32)
    bvh = build_triangle_bvh_native(tris, leaf_size=4)
    validate_bvh(bvh, tris.min(axis=1), tris.max(axis=1))


def test_native_degenerate(rng):
    z = np.zeros((50, 3, 3), np.float32)
    bvh = build_triangle_bvh_native(z, leaf_size=4)
    validate_bvh(bvh, z.min(axis=1), z.max(axis=1))


def test_native_dfs_contiguity(rng):
    """Subtree triangle ranges must be contiguous (DFS leaf order)."""
    tris = rng.uniform(-5, 5, (777, 3, 3)).astype(np.float32)
    bvh = build_triangle_bvh_native(tris, leaf_size=4)
    meta = bvh.nodes_meta

    def span(node):
        is_leaf, a, b = meta[node]
        if is_leaf:
            return a, b
        la, lb = span(a)
        ra, rb = span(b)
        # DFS left-to-right: left range must end where right begins.
        assert lb == ra, f"non-contiguous subtree at {node}"
        return la, rb

    a, b = span(0)
    assert a == 0 and b == 777


def test_native_render_matches_numpy_build(cornell_gltf):
    """Scene compiled with the native builder renders within noise of
    the numpy-built scene (trees differ; min-t semantics identical)."""
    import jax.numpy as jnp

    from logipathtracer_tpu.config import RenderConfig
    from logipathtracer_tpu.render.megakernel import render_sample
    from logipathtracer_tpu.scene.compile import compile_scene

    cfg = RenderConfig(width=16, height=16, max_depth=3)
    s_np = compile_scene(cornell_gltf, cfg, use_native=False)
    s_nat = compile_scene(cornell_gltf, cfg, use_native=True)
    cam = s_np.cameras[0]
    args = (jnp.asarray(cam.world_matrix), jnp.float32(cam.yfov),
            jnp.asarray([7, 9], jnp.uint32))
    a = np.asarray(render_sample(s_np, cfg, *args))
    b = np.asarray(render_sample(s_nat, cfg, *args))
    close = np.isclose(a, b, rtol=1e-4, atol=1e-6).all(axis=-1)
    assert close.mean() > 0.98  # tie-break pixels may diverge
