"""Golden-image regression (SURVEY.md §4: tiny deterministic scenes with
fixed seeds, per-pixel RMSE thresholds at equal spp)."""

import os

import numpy as np

from logipathtracer_tpu.config import RenderConfig
from logipathtracer_tpu.film.image import rmse
from logipathtracer_tpu.render.progressive import ProgressiveRenderer
from logipathtracer_tpu.scene.compile import compile_scene

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "cornell_64x64_4spp.npz")


def test_cornell_golden(cornell_gltf):
    cfg = RenderConfig(width=64, height=64, max_depth=10, intersect="bvh",
                       renderer="megakernel")
    scene = compile_scene(cornell_gltf, cfg, use_native=False)
    data = np.load(GOLDEN)
    r = ProgressiveRenderer(scene, cfg, host_seed=int(data["host_seed"]))
    r.step(int(data["sample_count"]))
    got = r.radiance()
    want = data["radiance"]
    err = rmse(got, want)
    # Same seeds, same tree: only cross-version transcendental ULP
    # drift is tolerable. MC noise at 4 spp is ~0.1; this is far below.
    assert err < 1e-3, f"golden RMSE {err}"


def test_golden_is_sane():
    data = np.load(GOLDEN)
    rad = data["radiance"]
    assert rad.shape == (64, 64, 3)
    assert np.isfinite(rad).all()
    assert 0.05 < rad.mean() < 0.5
    assert rad.max() > 1.0  # emissive panel


# -- wavefront-path goldens --------------------------------------------
# Generated by scripts/make_goldens.py; specs shared via golden_specs.py.
# These pin the pooled wavefront + carryover, NEE, textures, and the
# outside-class procedural scene end to end — the cross-implementation
# identity tests alone would miss a correlated regression in a shared
# stage (e.g. shade_step).

import pytest  # noqa: E402

from golden_specs import HOST_SEED, golden_specs  # noqa: E402


@pytest.mark.parametrize("name", sorted(
    # build lazily: golden_specs() imports scene loaders
    ["wavefront_cornell_64x64_4spp", "cornell_nee_64x64_4spp",
     "box_textured_64x64_2spp", "outside_64x64_2spp"]))
def test_production_golden(name):
    from logipathtracer_tpu.scene.compile import compile_scene as _cs
    spec = golden_specs()[name]
    data = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                name + ".npz"))
    assert int(data["sample_count"]) == sum(spec["chunks"])
    scene = _cs(spec["scene"](), spec["cfg"])
    r = ProgressiveRenderer(scene, spec["cfg"], host_seed=HOST_SEED)
    for c in spec["chunks"]:
        r.step(c)
    err = rmse(r.radiance(), data["radiance"])
    assert err < 1e-3, f"{name} golden RMSE {err}"
