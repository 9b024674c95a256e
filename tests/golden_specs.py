"""Shared spec table for the goldens: used by scripts/make_goldens.py
to generate and by tests/test_golden.py to verify.  Each spec
re-renders on the CPU backend with fixed seeds through the XLA BVH
walk."""

HOST_SEED = 7


def golden_specs():
    from logipathtracer_tpu.config import RenderConfig
    from logipathtracer_tpu.scene.procedural import (make_box_scene,
                                                     make_cornell_scene,
                                                     make_outside_scene)

    return {
        # Lockstep megakernel on the numpy-built BVH (no native build).
        "cornell_64x64_4spp": dict(
            scene=make_cornell_scene,
            cfg=RenderConfig(width=64, height=64, max_depth=10,
                             intersect="bvh", renderer="megakernel"),
            chunks=(4,), use_native=False),
        # Pooled wavefront: regen/sort/flush, carryover across two
        # 2-spp chunks.
        "wavefront_cornell_64x64_4spp": dict(
            scene=make_cornell_scene,
            cfg=RenderConfig(width=64, height=64, max_depth=10,
                             renderer="wavefront", intersect="bvh",
                             pool_size=4096),
            chunks=(2, 2)),
        "cornell_nee_64x64_4spp": dict(
            scene=make_cornell_scene,
            cfg=RenderConfig(width=64, height=64, max_depth=10,
                             renderer="wavefront", nee=True,
                             pool_size=4096),
            chunks=(4,)),
        "box_textured_64x64_2spp": dict(
            scene=lambda: make_box_scene(spheres=6, subdiv=3,
                                         textured=True),
            cfg=RenderConfig(width=64, height=64, max_depth=10,
                             renderer="wavefront", pool_size=4096),
            chunks=(2,)),
        "outside_64x64_2spp": dict(
            scene=make_outside_scene,
            cfg=RenderConfig(width=64, height=64, max_depth=10,
                             renderer="wavefront", pool_size=4096),
            chunks=(2,)),
    }
