"""SBVH (spatial splits) builder: structure, duplication semantics, and
intersection equivalence (reference: lsg::bvh::SplitBVHBuilder quality,
src/PTSceneConverter.cpp:97-98)."""

import numpy as np
import pytest

pytest.importorskip("ctypes")

from logipathtracer_tpu.scene.bvh_native import (build_triangle_sbvh_native,
                                                 native_available)

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="native toolchain missing")


def _thin_diagonal_soup(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    w = rng.normal(size=(n, 3)).astype(np.float32) * 0.01
    return np.stack([a, a + d * 1.5, a + d * 1.5 + w], axis=1)


def test_sbvh_structure():
    tri = _thin_diagonal_soup()
    n = tri.shape[0]
    bvh = build_triangle_sbvh_native(tri)
    meta = bvh.nodes_meta
    # Every original triangle referenced at least once; duplicates allowed.
    assert set(bvh.prim_order.tolist()) == set(range(n))
    assert bvh.prim_order.shape[0] >= n
    # Leaves partition [0, num_refs) contiguously in DFS order.
    leaves = meta[meta[:, 0] == 1]
    spans = sorted((int(a), int(b)) for a, b in leaves[:, 1:3])
    cur = 0
    for lo, hi in spans:
        assert lo == cur
        cur = hi
    assert cur == bvh.prim_order.shape[0]
    # Child AABBs contained in parents.
    inner = np.nonzero(meta[:, 0] == 0)[0]
    for i in inner:
        for c in meta[i, 1:3]:
            assert (bvh.nodes_min[c] >= bvh.nodes_min[i] - 1e-4).all()
            assert (bvh.nodes_max[c] <= bvh.nodes_max[i] + 1e-4).all()


def test_sbvh_leaf_boxes_cover_fragments():
    """Each leaf's box must contain the part of each referenced triangle
    that lies inside it — conservatively checked: the union of leaf
    boxes referencing a triangle covers the whole triangle's AABB."""
    tri = _thin_diagonal_soup(500, seed=1)
    bvh = build_triangle_sbvh_native(tri)
    meta = bvh.nodes_meta
    lo_cover = np.full((tri.shape[0], 3), np.inf, np.float32)
    hi_cover = np.full((tri.shape[0], 3), -np.inf, np.float32)
    for node in np.nonzero(meta[:, 0] == 1)[0]:
        a, b = meta[node, 1], meta[node, 2]
        for r in range(a, b):
            tid = bvh.prim_order[r]
            lo_cover[tid] = np.minimum(lo_cover[tid], bvh.nodes_min[node])
            hi_cover[tid] = np.maximum(hi_cover[tid], bvh.nodes_max[node])
    tmin = tri.min(axis=1)
    tmax = tri.max(axis=1)
    assert (lo_cover <= tmin + 1e-4).all()
    assert (hi_cover >= tmax - 1e-4).all()


def test_sbvh_scene_matches_plain_sah(cornell_gltf):
    """Compiling with spatial splits must not change intersection
    results (t values) — only the tree shape and duplicated soup."""
    import jax
    import jax.numpy as jnp

    from logipathtracer_tpu.config import RenderConfig
    from logipathtracer_tpu.ops.traverse import intersect_scene
    from logipathtracer_tpu.scene.compile import compile_scene

    s_plain = compile_scene(cornell_gltf,
                            RenderConfig(bvh_spatial_splits=False))
    s_sbvh = compile_scene(cornell_gltf,
                           RenderConfig(bvh_spatial_splits=True))
    assert s_sbvh.vtx_pos.shape[0] >= s_plain.vtx_pos.shape[0]

    rng = np.random.default_rng(2)
    n = 256
    o = jnp.asarray(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = jnp.asarray(d)
    t0, o0, _ = jax.jit(intersect_scene)(s_plain, o, d)
    t1, o1, _ = jax.jit(intersect_scene)(s_sbvh, o, d)
    np.testing.assert_allclose(np.asarray(t0), np.asarray(t1), rtol=2e-6)
    same = np.asarray(o0) == np.asarray(o1)
    tie = np.abs(np.asarray(t0) - np.asarray(t1)) <= 2e-6 * np.abs(
        np.asarray(t0))
    assert (same | tie).all()


def test_sbvh_light_table_not_duplicated():
    """SBVH spatial splits duplicate straddling triangles into vtx_pos;
    the NEE light table must still hold each emissive source triangle
    exactly once (else its selection mass and total area are inflated
    and the estimator is biased over-bright)."""
    from logipathtracer_tpu.config import RenderConfig
    from logipathtracer_tpu.scene.compile import compile_scene
    from logipathtracer_tpu.scene.gltf import (Gltf, Material, MeshNode,
                                               Primitive)

    tri = _thin_diagonal_soup(400, seed=3)
    nrm = np.zeros_like(tri)
    nrm[:, :, 2] = 1.0
    mat = Material(name="glow",
                   emissive_factor=np.array([5.0, 4.0, 3.0], np.float32))
    gltf = Gltf(
        mesh_nodes=[MeshNode(name="soup", world_matrix=np.eye(4, dtype=np.float32),
                             primitives=[Primitive(positions=tri, normals=nrm,
                                                   uvs=None, material=0)])],
        cameras=[], materials=[mat], textures=[], name="glow-soup")

    s_plain = compile_scene(gltf, RenderConfig(bvh_spatial_splits=False))
    s_sbvh = compile_scene(gltf, RenderConfig(bvh_spatial_splits=True))
    # The splits must actually have duplicated geometry for this test to
    # exercise anything.
    assert s_sbvh.vtx_pos.shape[0] > s_plain.vtx_pos.shape[0]

    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    n_emissive = int((area > 0).sum())
    true_area = float(area[area > 0].sum())

    for s in (s_plain, s_sbvh):
        assert s.num_lights == n_emissive
        np.testing.assert_allclose(s.total_light_area, true_area, rtol=1e-5)
    np.testing.assert_allclose(np.sort(s_sbvh.light_tris[:, 12]),
                               np.sort(s_plain.light_tris[:, 12]), rtol=1e-6)
