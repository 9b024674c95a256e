"""Generate the golden images that tests/test_golden.py checks.

Each spec (tests/golden_specs.py) renders on the CPU backend through
the XLA BVH walk with fixed seeds:

  cornell_64x64_4spp            — lockstep megakernel, numpy-built BVH
  wavefront_cornell_64x64_4spp  — pooled wavefront + carryover across
                                  two chunks
  cornell_nee_64x64_4spp        — NEE+MIS megakernel/wavefront shared
                                  shade path
  box_textured_64x64_2spp       — textured materials (atlas sampler)
  outside_64x64_2spp            — the outside-class procedural scene

Run on CPU: python scripts/make_goldens.py [--only name]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(_ROOT, "tests", "goldens")
sys.path.insert(0, os.path.join(_ROOT, "tests"))

from golden_specs import HOST_SEED, golden_specs as specs  # noqa: E402


def main():
    from logipathtracer_tpu.render.progressive import ProgressiveRenderer
    from logipathtracer_tpu.scene.compile import compile_scene

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    args = ap.parse_args()

    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, spec in specs().items():
        if args.only and args.only != name:
            continue
        t0 = time.time()
        scene = compile_scene(spec["scene"](), spec["cfg"],
                              use_native=spec.get("use_native", True))
        r = ProgressiveRenderer(scene, spec["cfg"], host_seed=HOST_SEED)
        for c in spec["chunks"]:
            r.step(c)
        rad = np.asarray(r.radiance())
        assert np.isfinite(rad).all(), name
        path = os.path.join(GOLDEN_DIR, name + ".npz")
        np.savez_compressed(path, radiance=rad, host_seed=HOST_SEED,
                            sample_count=sum(spec["chunks"]))
        print(f"{name}: mean {rad.mean():.4f} max {rad.max():.2f} "
              f"({time.time()-t0:.0f}s) -> {path}")


if __name__ == "__main__":
    main()
