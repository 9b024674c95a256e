"""Scene SoA: the device-resident flattened scene.

Replacement for the four SSBOs + texture array the reference
uploads (src/PTSceneConverter.cpp:146-153; GLSL bindings 2-6 in
shaders/path_tracing.comp:89-105).  Everything is a struct-of-arrays
jnp pytree so kernels do contiguous vectorized gathers instead of the
GLSL struct loads.

Two views of the BVH coexist:

  * the *reference layout* (object BVH + concatenated per-mesh BVHs with
    per-object ``bvh_offset`` bias and local leaf ranges) — kept for
    schema parity and debugging;
  * the *fused* single-array layout used by the traversal kernels: all
    nodes in one array, child indices pre-biased to global, object-level
    leaves replaced by the owning object's mesh root, and every node
    tagged with the object whose local space its AABB lives in
    (-1 = world space).  Traversal then needs exactly one stack and one
    code path, in the lockstep XLA walk and in the CUDA kernel alike —
    a flattening of the reference's nested two-level walk
    (shaders/path_tracing.comp:130-209).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import numpy as np


@dataclasses.dataclass(frozen=True, eq=False)
class CameraState:
    """Host-side camera (reference: PathTracerUBO camera fill,
    src/RendererPT.cpp:41-47).

    ``eq``/``hash`` are value-based over the matrix BYTES: cameras ride
    in SceneSoA's pytree aux_data (static metadata), and jit cache
    lookups compare aux tuples across entries — the dataclass-default
    ``__eq__`` would compare the numpy matrix elementwise and raise the
    ambiguous-truth-value error the moment two different compiled
    scenes coexist in one process (round-4 goldens generator)."""

    world_matrix: np.ndarray  # [4, 4] float32, column-vector convention
    yfov: float
    name: str = ""

    def _key(self):
        return (np.asarray(self.world_matrix, np.float32).tobytes(),
                float(self.yfov), self.name)

    def __eq__(self, other):
        return (isinstance(other, CameraState)
                and self._key() == other._key())

    def __hash__(self):
        return hash(self._key())


@dataclasses.dataclass
class SceneSoA:
    # Per-object data (reference GPUObjectData,
    # include/PTSceneConverter.hpp:15-42), permuted into object-BVH leaf
    # order (src/PTSceneConverter.cpp:140-142).
    obj_world: Any        # [O, 4, 4] f32
    obj_world_inv: Any    # [O, 4, 4] f32
    obj_base_color: Any   # [O, 4] f32
    obj_emission: Any     # [O, 3] f32
    obj_mrti: Any         # [O, 4] f32: metallic, roughness, transmission, ior
    obj_tex: Any          # [O, 5] i32: color/emission/mr/transmission/normal
    obj_bvh_offset: Any   # [O] i32 into mesh BVH arrays
    obj_vtx_offset: Any   # [O] i32 into vertex arrays (counts vertices)

    # Reference-layout BVHs (meta = is_leaf, a, b; local indices).
    object_bvh_min: Any   # [No, 3] f32 (world space)
    object_bvh_max: Any
    object_bvh_meta: Any  # [No, 3] i32
    mesh_bvh_min: Any     # [Nm, 3] f32 (object space)
    mesh_bvh_max: Any
    mesh_bvh_meta: Any    # [Nm, 3] i32

    # Triangle soup in BVH leaf order, 3 vertices per triangle
    # (reference GPUVertex stream, src/PTSceneConverter.cpp:105-120).
    vtx_pos: Any          # [V, 3] f32
    vtx_nrm: Any          # [V, 3] f32
    vtx_uv: Any           # [V, 2] f32

    # Fused traversal arrays (derived; see module docstring).
    fused_min: Any        # [M, 3] f32
    fused_max: Any        # [M, 3] f32
    fused_meta: Any       # [M, 4] i32: kind(0=inner,1=leaf), a, b, obj
    # kind=inner: a, b = global child node ids
    # kind=leaf:  [a, b) = global triangle range (tri t -> vertices 3t..3t+2)

    # Texture atlas (512-slot bindless array equivalent,
    # shaders/path_tracing.comp:105).
    tex_atlas: Any        # [AH, AW, 4] f32 linear [0,1], or [AH, AW]
                          # u32 packed RGBA8 (LOD-0-only u8 scenes —
                          # see scene/compile.py:_pack_textures)
    tex_table: Any        # [NE, 6] i32: x, y, w, h, wrap_s, wrap_t
                          # (one entry per texture per mip level)
    tex_mip_base: Any     # [NT] i32 first table entry of texture t
    tex_mip_count: Any    # [NT] i32 mip levels of texture t (>= 1)

    # Packed shade tables: ONE wide-row gather per hit instead of many
    # narrow ones.
    tri_shade: Any        # [T, 64] f32: n0 n1 n2 (9), uv0..2 (6),
                          #              v0 v1 v2 (9), texel density (1),
                          #              pad (7), owning object's
                          #              obj_shade row (32) — one gather
                          #              keyed by tri covers both tables
    obj_shade: Any        # [O, 32] f32: world mat3 (9), inv rows 3x4 (12),
                          #              base_color (4), emission (3),
                          #              metallic roughness transmission ior

    world_aabb: Any       # [2, 3] f32 scene bounds (ray sort-key range)

    # Emissive-triangle table for next-event estimation (a capability
    # BEYOND the reference, which only collects emission on BSDF-sampled
    # hits — path_tracing.comp:269; gated by RenderConfig.nee).
    light_tris: Any       # [L, 16] f32: v0w(3) e1w(3) e2w(3) Le(3)
                          #              area(1) pad(3); world space
    light_cdf: Any        # [L] f32 cumulative area / total_area

    tex_quad: Any = None  # [AH, AW, 4] u32 quad atlas (each texel's
                          # 2x2 bilinear neighborhood, wrap applied at
                          # pack time) — ONE wide row gather per tap
                          # instead of four narrow ones; None = use
                          # the 4-gather path (f32 atlas, MIRROR
                          # wraps, or over the texel cap).  See
                          # scene/compile.py::_build_quad_atlas.

    # Static metadata (aux_data, not traced).
    num_objects: int = 0
    num_triangles: int = 0
    max_stack: int = 16
    leaf_width: int = 4   # max triangles per leaf (static unroll width)
    has_textures: bool = False
    tex_slots: tuple = (True, True, True, True, True)
                          # static per-scene slot usage (base, emissive,
                          # metallic-roughness, transmission, normal):
                          # False = NO object textures that slot, so
                          # shading skips its 4-gather tap entirely
                          # (the analog of the reference's per-feature
                          # GLSL #define specialization, SURVEY §5.6)
    has_nearest: bool = False  # any texture sampler uses NEAREST
                               # filtering (glTF magFilter/minFilter
                               # 9728/998x; the reference honors these
                               # via Vulkan sampler state,
                               # src/PTSceneConverter.cpp:335-386)
    mip_levels: int = 1   # mip chain depth the atlas was BUILT with —
                          # shading keys on this (not cfg), so a
                          # scene/cfg mismatch cannot mis-index the
                          # mip-expanded tex_table
    num_lights: int = 0
    total_light_area: float = 0.0
    cameras: tuple = ()
    name: str = ""

    _ARRAY_FIELDS = (
        "obj_world", "obj_world_inv", "obj_base_color", "obj_emission",
        "obj_mrti", "obj_tex", "obj_bvh_offset", "obj_vtx_offset",
        "object_bvh_min", "object_bvh_max", "object_bvh_meta",
        "mesh_bvh_min", "mesh_bvh_max", "mesh_bvh_meta",
        "vtx_pos", "vtx_nrm", "vtx_uv",
        "fused_min", "fused_max", "fused_meta",
        "tex_atlas", "tex_table", "tex_mip_base", "tex_mip_count",
        "tri_shade", "obj_shade", "world_aabb",
        "light_tris", "light_cdf", "tex_quad",
    )
    _STATIC_FIELDS = ("num_objects", "num_triangles", "max_stack",
                      "leaf_width", "has_textures", "tex_slots",
                      "has_nearest",
                      "mip_levels",
                      "num_lights",
                      "total_light_area",
                      "cameras", "name")


def _soa_flatten(s: SceneSoA):
    children = tuple(getattr(s, f) for f in SceneSoA._ARRAY_FIELDS)
    aux = tuple(getattr(s, f) for f in SceneSoA._STATIC_FIELDS)
    return children, aux


def _soa_unflatten(aux, children):
    kw = dict(zip(SceneSoA._ARRAY_FIELDS, children))
    kw.update(zip(SceneSoA._STATIC_FIELDS, aux))
    return SceneSoA(**kw)


jax.tree_util.register_pytree_node(SceneSoA, _soa_flatten, _soa_unflatten)
