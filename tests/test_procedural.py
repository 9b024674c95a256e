"""Procedural scenes compile and render (the cornell- and
outside-class stand-ins for the reference assets, SURVEY.md §6)."""

import jax.numpy as jnp
import numpy as np
import pytest

from logipathtracer_tpu.config import RenderConfig
from logipathtracer_tpu.render.megakernel import render_sample
from logipathtracer_tpu.scene.compile import compile_scene
from logipathtracer_tpu.scene.procedural import (make_box_scene,
                                                 make_triangle_soup)


def test_box_scene_renders():
    gltf = make_box_scene(spheres=3, subdiv=1, seed=1)
    cfg = RenderConfig(width=24, height=24, max_depth=3, intersect="bvh")
    scene = compile_scene(gltf, cfg)
    cam = scene.cameras[0]
    img = np.asarray(render_sample(
        scene, cfg, jnp.asarray(cam.world_matrix), jnp.float32(cam.yfov),
        jnp.asarray([17, 29], jnp.uint32)))
    assert np.isfinite(img).all()
    assert img.max() > 0  # emissive lamp visible somewhere


def test_soup_scale_build():
    gltf = make_triangle_soup(n_tris=50_000, seed=2)
    cfg = RenderConfig(width=8, height=8, max_depth=1, intersect="bvh")
    scene = compile_scene(gltf, cfg)
    # SBVH duplicates straddling triangles into the emitted soup
    # (bounded by the builder's 2x cap; typically a few percent).
    assert 50_000 <= scene.num_triangles <= 60_000
    cam = scene.cameras[0]
    img = np.asarray(render_sample(
        scene, cfg, jnp.asarray(cam.world_matrix), jnp.float32(cam.yfov),
        jnp.asarray([5, 7], jnp.uint32)))
    assert np.isfinite(img).all()


def test_outside_scene_profile_and_render():
    """Outside-class stand-in matches the reference asset's profile
    (51 meshes / 49 materials / ~400k tris / 2 cameras, SURVEY.md §6)
    and a scaled-down build renders finite with lights present."""
    from logipathtracer_tpu.scene.procedural import make_outside_scene

    full = make_outside_scene()
    assert len(full.mesh_nodes) == 51
    assert len(full.materials) == 49
    assert len(full.cameras) == 2
    assert abs(full.triangle_count - 400_000) < 20_000

    gltf = make_outside_scene(objects=12, n_materials=9, seed=3,
                              tri_budget=26_000)
    cfg = RenderConfig(width=16, height=16, max_depth=2, intersect="bvh")
    scene = compile_scene(gltf, cfg)
    assert scene.num_objects == 12
    assert scene.num_lights > 0  # emissive material mix present
    cam = scene.cameras[0]
    img = np.asarray(render_sample(
        scene, cfg, jnp.asarray(cam.world_matrix), jnp.float32(cam.yfov),
        jnp.asarray([3, 11], jnp.uint32)))
    assert np.isfinite(img).all()
    assert img.max() > 0


@pytest.mark.parametrize("seed", [0, 3])
def test_cornell_scene_profile(seed):
    """The cornell-class generator has the reference cornell_box's
    shape for every seed (BASELINE.md: 11 meshes, 12,956 triangles,
    6 materials with 2 transmissive and emissive panels, 1 camera with
    yfov ~0.4), and is a pure function of its seed."""
    from logipathtracer_tpu.scene.procedural import make_cornell_scene

    g = make_cornell_scene(seed=seed)
    assert len(g.mesh_nodes) == 11
    assert g.triangle_count == 12_956
    assert len(g.materials) == 6
    assert sum(m.transmission_factor > 0 for m in g.materials) == 2
    emissive = {i for i, m in enumerate(g.materials)
                if m.emissive_factor.max() > 0}
    panels = [n for n in g.mesh_nodes
              if n.primitives[0].material in emissive]
    assert len(panels) == 2
    assert len(g.cameras) == 1 and abs(g.cameras[0].yfov - 0.4) < 1e-3
    again = make_cornell_scene(seed=seed)
    other = make_cornell_scene(seed=seed + 1)
    blob = lambda s: [n for n in s.mesh_nodes if n.name == "Blob"][0]
    pos = lambda s: blob(s).primitives[0].positions
    np.testing.assert_array_equal(pos(g), pos(again))
    assert not np.array_equal(pos(g), pos(other))
