"""Two-level BVH traversal: the lockstep XLA walk, and the choice
between it and the CUDA kernel.

The reference walks an object BVH whose leaves recursively walk
per-mesh BVHs with the ray transformed to object space
(shaders/path_tracing.comp:130-209, explicit per-thread stacks).  Here
both levels are fused into ONE node array (scene/types.py), and two
walks read it:

  * ``intersect_scene`` — a ``lax.while_loop`` that carries every ray
    in lockstep with an [R, S] stack of global node ids (S =
    scene.max_stack, a static bound computed from the tree depth at
    compile time — the analog of INTERSECTION_STACK_SIZE 20).  Each
    node carries the object whose local space its AABB lives in; the
    lane's local ray comes from gathering that object's inverse world
    matrix (identity row for world-space nodes).  Leaves hold at most
    ``leaf_width`` triangles, so the triangle test is a statically
    unrolled masked loop.  It runs everywhere and is the plain
    reference the kernel is tested against.
  * ``ops/traverse_cuda.py`` — one CUDA thread per ray with a private
    stack over the same arrays, in the same visiting order with the
    same arithmetic.

``select_traversal`` is the one place that chooses between them.

Traversal order differs from the reference (order never affects the
min-t result; ties broken by strict < are measure-zero).  AABB tests
for spliced mesh roots use the object-space box — tighter than the
reference's world-space object AABB, so strictly fewer false entries.

Intersection semantics (acceptance gate t > EPS, strict min) match
path_tracing.comp:152 exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from logipathtracer_tpu.ops.intersect import (INF, matvec3, ray_aabb_test,
                                              ray_triangle)


def _local_ray(inv_rows, origin, direction):
    """Transform world ray by gathered inverse matrices.

    inv_rows: [..., 3, 4] (rows of the object's worldMatrixInverse;
    row 0..2 of the 4x4). Returns (o_local, d_local); direction is NOT
    normalized (reference keeps world-parameterized t,
    path_tracing.comp:136-137).
    """
    rot = inv_rows[..., :3, :3]
    trans = inv_rows[..., :3, 3]
    o = matvec3(rot, origin) + trans
    d = matvec3(rot, direction)
    return o, d


def intersect_scene(scene, origin, direction, eps: float = 1e-4,
                    t_max=None, any_hit: bool = False):
    """Closest-hit query for a batch of world-space rays.

    origin, direction: [R, 3] float32.  t_max (optional [R]): ignore
    hits at or beyond it — shadow rays pass the light distance so the
    walk prunes everything behind the light (any-hit analog).
    Returns (t [R] f32 — INF on miss, obj [R] i32, tri [R] i32 global
    triangle index; -1 where missed).

    ``any_hit``: callers only need the occlusion predicate t < t_max.
    This walk ignores the flag (its closest-hit answer yields the
    identical predicate); the CUDA kernel stops at the first blocker.
    """
    r = origin.shape[0]
    s = scene.max_stack
    leaf_size = scene.leaf_width

    fused_min = scene.fused_min
    fused_max = scene.fused_max
    fused_meta = scene.fused_meta
    # [O+1, 3, 4] inverse-matrix rows; slot 0 = identity (world space).
    inv_all = _padded_inverses(scene)
    vtx = scene.vtx_pos

    stack = jnp.zeros((r, s), jnp.int32)
    sp = jnp.ones((r,), jnp.int32)  # root (node 0) pre-pushed
    best_t = jnp.full((r,), INF) if t_max is None else t_max
    best_obj = jnp.full((r,), -1, jnp.int32)
    best_tri = jnp.full((r,), -1, jnp.int32)

    lanes = jnp.arange(r)

    def cond(state):
        _, sp, *_ = state
        return jnp.any(sp > 0)

    def body(state):
        stack, sp, best_t, best_obj, best_tri = state
        live = sp > 0
        top = jnp.maximum(sp - 1, 0)
        idx = stack[lanes, top]
        sp = jnp.where(live, sp - 1, sp)

        meta = jnp.take(fused_meta, idx, axis=0)  # [R, 4]
        kind, a, b = meta[..., 0], meta[..., 1], meta[..., 2]
        is_inner = live & (kind == 0)
        is_leaf = live & (kind == 1)

        # ---- inner: test both children, push survivors ---------------
        def test_child(child):
            cobj = jnp.take(fused_meta[:, 3], child, axis=0)
            inv = jnp.take(inv_all, cobj + 1, axis=0)
            o_loc, d_loc = _local_ray(inv, origin, direction)
            cmin = jnp.take(fused_min, child, axis=0)
            cmax = jnp.take(fused_max, child, axis=0)
            return ray_aabb_test(o_loc, 1.0 / d_loc, cmin, cmax, best_t)

        for child in (a, b):
            push = is_inner & test_child(child)
            slot = jnp.minimum(sp, s - 1)
            cur = stack[lanes, slot]
            stack = stack.at[lanes, slot].set(jnp.where(push, child, cur))
            sp = sp + push.astype(jnp.int32)

        # ---- leaf: masked fixed-width triangle tests ------------------
        lobj = meta[..., 3]
        inv = jnp.take(inv_all, jnp.where(is_leaf, lobj + 1, 0), axis=0)
        o_loc, d_loc = _local_ray(inv, origin, direction)
        for k in range(leaf_size):
            tri = a + k
            valid = is_leaf & (tri < b)
            vbase = 3 * jnp.where(valid, tri, 0)
            v0 = jnp.take(vtx, vbase, axis=0)
            v1 = jnp.take(vtx, vbase + 1, axis=0)
            v2 = jnp.take(vtx, vbase + 2, axis=0)
            t = ray_triangle(o_loc, d_loc, v0, v1, v2)
            accept = valid & (t > eps) & (t < best_t)
            best_t = jnp.where(accept, t, best_t)
            best_obj = jnp.where(accept, lobj, best_obj)
            best_tri = jnp.where(accept, tri, best_tri)

        return stack, sp, best_t, best_obj, best_tri

    state = (stack, sp, best_t, best_obj, best_tri)
    state = jax.lax.while_loop(cond, body, state)
    _, _, best_t, best_obj, best_tri = state
    if t_max is not None:
        best_t = jnp.where(best_tri >= 0, best_t, INF)
    return best_t, best_obj, best_tri


def _padded_inverses(scene):
    """[O+1, 3, 4] f32: identity row 0, then each object's inverse."""
    inv = scene.obj_world_inv[:, :3, :4]
    ident = jnp.eye(3, 4, dtype=inv.dtype)[None]
    return jnp.concatenate([ident, inv], axis=0)


TRAVERSALS = ("auto", "bvh", "cuda")


def select_traversal(mode: str):
    """The traversal for ``RenderConfig.intersect``: an
    ``intersect_scene``-compatible function.

    ``bvh`` is the XLA walk.  ``cuda`` is the CUDA kernel, and raises
    when JAX has no CUDA device.  ``auto`` lets
    ``lax.platform_dependent`` pick at lowering time: the kernel in a
    program compiled for a CUDA device, the walk in any other.  The
    kernel never falls back to the walk: on a CUDA machine a kernel
    library that fails to build or load raises."""
    if mode == "bvh":
        return intersect_scene
    from logipathtracer_tpu.ops import traverse_cuda
    if mode == "cuda":
        return traverse_cuda.intersect_scene_cuda
    if mode == "auto":
        return _intersect_auto
    raise ValueError(f"unknown intersect mode {mode!r}; "
                     f"expected one of {TRAVERSALS}")


def _intersect_auto(scene, origin, direction, eps: float = 1e-4,
                    t_max=None, any_hit: bool = False):
    from logipathtracer_tpu.ops import traverse_cuda
    if traverse_cuda.cuda_available():
        traverse_cuda.ensure_registered()

    def kernel(o, d):
        return traverse_cuda.call_kernel(scene, o, d, eps=eps, t_max=t_max,
                                         any_hit=any_hit)

    def walk(o, d):
        return intersect_scene(scene, o, d, eps=eps, t_max=t_max,
                               any_hit=any_hit)

    return jax.lax.platform_dependent(origin, direction, cuda=kernel,
                                      default=walk)


def intersect_bruteforce(scene, origin, direction, eps: float = 1e-4,
                         chunk: int = 4096):
    """Oracle: test every triangle of every object (no BVH).

    Used by tests to validate the traversal (SURVEY.md §4 golden plan).
    origin/direction [R, 3]. O(R x T) — tiny scenes only.
    """
    import numpy as np
    meta = np.asarray(scene.fused_meta)
    # Owning object of every triangle, from leaf metadata.
    t_total = int(np.asarray(scene.vtx_pos).shape[0] // 3)
    tri_obj = np.zeros(t_total, np.int32)
    leaves = meta[meta[:, 0] == 1]
    for a, b, obj in zip(leaves[:, 1], leaves[:, 2], leaves[:, 3]):
        tri_obj[a:b] = obj
    tri_obj = jnp.asarray(tri_obj)

    inv_all = _padded_inverses(scene)
    vtx = scene.vtx_pos.reshape(-1, 3, 3)

    r = origin.shape[0]
    best_t = jnp.full((r,), INF)
    best_obj = jnp.full((r,), -1, jnp.int32)
    best_tri = jnp.full((r,), -1, jnp.int32)
    for start in range(0, t_total, chunk):
        end = min(start + chunk, t_total)
        objs = tri_obj[start:end]
        inv = inv_all[objs + 1]  # [C, 3, 4]
        o_loc = (matvec3(inv[None, :, :, :3], origin[:, None, :])
                 + inv[None, :, :, 3])
        d_loc = matvec3(inv[None, :, :, :3], direction[:, None, :])
        tri = vtx[start:end]
        t = ray_triangle(o_loc, d_loc, tri[None, :, 0], tri[None, :, 1],
                         tri[None, :, 2])  # [R, C]
        t = jnp.where(t > eps, t, INF)
        k = jnp.argmin(t, axis=1)
        tk = jnp.take_along_axis(t, k[:, None], axis=1)[:, 0]
        accept = tk < best_t
        best_t = jnp.where(accept, tk, best_t)
        best_obj = jnp.where(accept, objs[k], best_obj)
        best_tri = jnp.where(accept, (start + k).astype(jnp.int32), best_tri)
    return best_t, best_obj, best_tri
