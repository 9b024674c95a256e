"""Ray-primitive intersection math (vectorized jnp).

Reimplements shaders/common/ray.glsl with float32 semantics:
  * slab AABB test with current-best-distance pruning
    (rayAABBIntersectTest, ray.glsl:39-61),
  * Möller-Trumbore triangle intersection with no backface cull and no
    determinant-epsilon guard (rayTriangleIntersect, ray.glsl:63-82) —
    degenerate triangles produce inf/NaN t which the (t > EPS) &
    (t < best) acceptance gate rejects, so padded/degenerate leaf slots
    are harmless.

All functions broadcast over leading batch dims; vectors are [..., 3].
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# numpy scalar, NOT jnp: a module-level jnp scalar initializes the
# default backend at import time (tests/test_import_no_backend.py).
INF = np.float32(3.4e38)  # shaders/common/constants.glsl:9


def ray_aabb_test(origin, inv_dir, box_min, box_max, best_t):
    """Boolean slab test pruned by the current best hit distance."""
    near = (box_min - origin) * inv_dir
    far = (box_max - origin) * inv_dir
    tmin = jnp.minimum(near, far)
    tmax = jnp.maximum(near, far)
    t0 = jnp.max(tmin, axis=-1)
    t1 = jnp.min(tmax, axis=-1)
    # GLSL: t0 > t1 -> false; t0 > 0 -> t0 < distance; else t1 > 0.
    return jnp.where(
        t0 > t1, False,
        jnp.where(t0 > 0.0, t0 < best_t, t1 > 0.0))


def ray_triangle(origin, direction, v0, v1, v2):
    """Möller-Trumbore; returns t (INF on miss, reference semantics).

    No backface culling, no epsilon on the determinant: det=0 yields
    inf/NaN which callers' acceptance gates reject.
    """
    edge1 = v1 - v0
    edge2 = v2 - v0
    pvec = jnp.cross(direction, edge2)
    det = 1.0 / jnp.sum(edge1 * pvec, axis=-1)
    tvec = origin - v0
    u = jnp.sum(tvec * pvec, axis=-1) * det
    qvec = jnp.cross(tvec, edge1)
    v = jnp.sum(direction * qvec, axis=-1) * det
    t = jnp.sum(edge2 * qvec, axis=-1) * det
    miss = (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
    return jnp.where(miss, INF, t)


def barycentric(point, v0, v1, v2):
    """Geometric barycentric recovery (shaders/common/util.glsl:23-41);
    the PT backend recomputes barycentrics from the hit point."""
    ab = v1 - v0
    ac = v2 - v0
    ah = point - v0
    ab_ab = jnp.sum(ab * ab, axis=-1)
    ab_ac = jnp.sum(ab * ac, axis=-1)
    ac_ac = jnp.sum(ac * ac, axis=-1)
    ab_ah = jnp.sum(ab * ah, axis=-1)
    ac_ah = jnp.sum(ac * ah, axis=-1)
    inv_denom = 1.0 / (ab_ab * ac_ac - ab_ac * ab_ac)
    v = (ac_ac * ab_ah - ab_ac * ac_ah) * inv_denom
    w = (ab_ab * ac_ah - ab_ac * ab_ah) * inv_denom
    u = 1.0 - v - w
    return jnp.stack([u, v, w], axis=-1)


def matvec3(m, v):
    """mat3 @ vec3, written elementwise so it stays exact float32 on
    every backend (an einsum/dot may run at reduced default matmul
    precision, e.g. TF32). m [..., 3, 3], v [..., 3]."""
    return jnp.stack([
        m[..., 0, 0] * v[..., 0] + m[..., 0, 1] * v[..., 1]
        + m[..., 0, 2] * v[..., 2],
        m[..., 1, 0] * v[..., 0] + m[..., 1, 1] * v[..., 1]
        + m[..., 1, 2] * v[..., 2],
        m[..., 2, 0] * v[..., 0] + m[..., 2, 1] * v[..., 1]
        + m[..., 2, 2] * v[..., 2],
    ], axis=-1)


def transform_point(m, p):
    """p' = (M @ [p, 1]).xyz with m [..., 4, 4] or [..., 3, 4], p [..., 3]."""
    return matvec3(m[..., :3, :3], p) + m[..., :3, 3]


def transform_dir(m, d):
    """d' = mat3(M) @ d (not normalized — reference keeps world-scale t,
    path_tracing.comp:137)."""
    return matvec3(m[..., :3, :3], d)
