"""Render configuration.

Unifies the reference's three config layers into one runtime dataclass
(reference: compile-time C++ consts in src/Main.cpp:13-34, the
RendererConfiguration struct in include/RendererCore.hpp:13-27, and the
GLSL #defines in shaders/path_tracing.comp:16-22 /
shaders/heitz/BSDF.glsl:8 / shaders/tex_to_quad.frag:21-22).

All fields become static arguments of the jitted render step, so a
config change triggers a recompile exactly like rebuilding a shader
variant would in the reference.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # Image (reference: src/Main.cpp:30, RendererConfiguration.renderScale
    # applied at src/RendererPT.cpp:254-255,532-533).
    width: int = 1920
    height: int = 1080
    render_scale: int = 1

    # Path tracing (reference: shaders/path_tracing.comp:19-22).
    max_depth: int = 10
    rr_bounces: int = 2           # RUSSIAN_ROULETTE_BOUNCES
    rr_threshold: float = 0.5     # q < 0.5 gate (path_tracing.comp:318)
    use_microfacet: bool = True   # USE_MICROFACET: Heitz vs basic BSDFs
    heitz_max_order: int = 16     # shaders/heitz/BSDF.glsl:8

    # Environment: constant grey on miss
    # (path_tracing.comp:221, rtx/miss.rmiss:11).
    env_color: float = 0.2

    # Display transform (shaders/tex_to_quad.frag:21-22).
    exposure: float = 1.5
    gamma: float = 2.2

    # Intersection epsilon (shaders/common/constants.glsl:4).
    eps: float = 1e-4

    # Next-event estimation (BEYOND the reference — it has no light
    # sampling, path_tracing.comp:269; breaks RNG parity when on).
    nee: bool = False
    nee_mis: bool = True          # balance-heuristic MIS combining the
                                  # light sample with BSDF-sampled
                                  # emission; False = classic NEE
                                  # (BSDF-found emission suppressed on
                                  # light-sampled diffuse chains)

    # Mipmapped texture sampling (BEYOND the reference — it samples
    # implicit LOD 0 from compute, shaders/path_tracing.comp:244-261).
    # mip_levels > 1 builds a 2x2 box mip chain at scene compile and
    # selects trilinear LODs with a ray-cone footprint approximation
    # (constant per-segment spread; see render/megakernel.py tap()).
    mip_levels: int = 1           # 1 = LOD 0 only (reference parity)
    mip_spread: float = 0.001     # cone spread (radians-ish per unit t)
    tex_quad: bool = True         # pack each texel's 2x2 bilinear
                                  # neighborhood as ONE 4-col u32 atlas
                                  # row (scene compile) so a tap is one
                                  # wide row gather instead of four
                                  # narrow ones.  Auto-disabled for
                                  # MIRROR wraps, f32 atlases, and
                                  # atlases > 16M texels (quad = 16
                                  # B/texel of device memory).
                                  # Sampler output is bit-identical
                                  # (tests/test_textures.py); inside a
                                  # jit graph XLA forms FMAs
                                  # differently around the two
                                  # fetch shapes, so full renders can
                                  # differ by ~1 ulp of radiance.

    # BVH build knobs (ours; the reference delegates to lsg's SBVH).
    bvh_leaf_size: int = 4        # max triangles per mesh-BVH leaf
    bvh_bins: int = 16            # SAH bins
    bvh_spatial_splits: bool = True  # mesh-level SBVH (native builder;
                                  # matches lsg::bvh::SplitBVHBuilder,
                                  # src/PTSceneConverter.cpp:97-98);
                                  # numpy fallback has no splits

    # Execution.
    renderer: str = "auto"        # auto | megakernel | wavefront
                                  # (auto: the lockstep megakernel)
    pool_size: int = 1 << 20      # wavefront ray-pool lanes
    intersect: str = "auto"       # auto | bvh | cuda.  bvh: the
                                  # lax.while_loop BVH walk (the CPU
                                  # path and the plain reference);
                                  # cuda: the per-ray stack walk
                                  # compiled from native/bvh_traverse.cu
                                  # (CUDA devices only; an error
                                  # elsewhere); auto: cuda when the
                                  # program is compiled for a CUDA
                                  # device, bvh otherwise
                                  # (ops/traverse.py select_traversal).
    sort_rays: bool = True        # wavefront: octant+Morton sort of the
                                  # pool before each intersect
    sort_variadic: bool = True    # wavefront sort carries the state
                                  # columns as lax.sort payload
                                  # operands (one variadic sort) vs
                                  # sort_key_val + one wide row gather.
                                  # Same stable permutation either way.
    pool_carryover: bool = True   # progressive wavefront keeps the ray
                                  # pool alive ACROSS step() chunks:
                                  # each chunk stops as soon as its
                                  # work items are all injected,
                                  # leaving in-flight paths for the
                                  # next chunk instead of draining the
                                  # pool at collapsing occupancy every
                                  # chunk (the drain tail is ~10 full-
                                  # maintenance iterations per chunk).
                                  # Reads (radiance/image/checkpoint)
                                  # drain first, so results are exact.
    sort_every: int = 1           # wavefront: sort/flush every k-th
                                  # iteration (alive coherence decays
                                  # slowly; >1 trades stale order for
                                  # skipped sort passes)
    lazy_regen: int = 0           # wavefront: 0 = refill free lanes
                                  # every iteration; k>0 = refill only
                                  # when free*k >= pool (regen cost is
                                  # pool-proportional, not free-count-
                                  # proportional, so batching it saves
                                  # whole passes; parked lanes are
                                  # near-free in intersect/shade)
    parity_rng: bool = True       # True: bit-faithful LCG-hash RNG
                                  # (shaders/common/random.glsl:9-15,
                                  # incl. its degenerate zero streams);
                                  # False: Threefry-2x32 counter RNG
                                  # (ops/rng.py — quality path, breaks
                                  # reference parity)

    @property
    def render_width(self) -> int:
        return self.width * self.render_scale

    @property
    def render_height(self) -> int:
        return self.height * self.render_scale

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
