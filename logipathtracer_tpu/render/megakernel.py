"""Megakernel-style render step: one fused jitted function per sample.

The vectorized re-expression of shaders/path_tracing.comp main() +
traceRay() (:211-352): every pixel's full path is carried in lockstep
through a static ``max_depth`` bounce loop with lane masks standing in
for the reference's branches.  This is both the production render step
and the CI oracle (it runs identically on CPU and GPU).

Faithfulness ledger items implemented here (SURVEY.md §7):
  * miss OVERWRITES accColor with mask*0.2 (path_tracing.comp:220-223 —
    an assignment, not +=, so earlier collected emission is discarded;
    reproduced for parity),
  * emission added pre-BSDF with the pre-bounce mask (:269),
  * sRGB→linear on base color after factor x texture (:263),
  * roughness floor 0.001 (:238),
  * front-face normal flip and the 0.1-threshold tangent-axis pick
    (:273-275), normals transformed by mat3(world) without
    inverse-transpose (:272 — reference quirk, kept),
  * RR: q = max channel, threshold 0.5, active for bounce > 2, 1/q
    boost (:317-323),
  * per-pixel RNG stream seed = ubo.seed * pixel.xy (:341).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from logipathtracer_tpu.config import RenderConfig
from logipathtracer_tpu.film.image import srgb_to_linear
from logipathtracer_tpu.ops import bsdf
from logipathtracer_tpu.ops.camera import generate_ray
from logipathtracer_tpu.ops.intersect import (INF, barycentric,
                                              transform_dir, transform_point)
from logipathtracer_tpu.ops.rng import get_rand, seed_from_pixel
from logipathtracer_tpu.ops.texture import sample_atlas
from logipathtracer_tpu.ops.traverse import select_traversal


def ray_sort_key(scene, origin, direction):
    """Spatial sort key: direction octant (major) + 5-bit-per-axis
    Morton code of the origin within the scene bounds.

    Scattered bounce rays are incoherent; the wavefront sorts its pool
    by this key so neighbouring lanes trace similar rays (SURVEY.md
    §5.7: lobe/ray sorting between bounces)."""
    lo = scene.world_aabb[0]
    span = jnp.maximum(scene.world_aabb[1] - lo, 1e-9)

    def spread3(x):
        out = jnp.zeros_like(x)
        for b in range(5):
            out = out | (((x >> b) & 1) << (3 * b))
        return out

    def quant(i):
        q = (origin[:, i] - lo[i]) / span[i] * 31.0
        return spread3(jnp.clip(q.astype(jnp.int32), 0, 31))

    morton = quant(0) | (quant(1) << 1) | (quant(2) << 2)
    octant = ((direction[:, 0] > 0).astype(jnp.int32) * 4
              + (direction[:, 1] > 0).astype(jnp.int32) * 2
              + (direction[:, 2] > 0).astype(jnp.int32))
    return (octant << 15) | morton


def shade_step(scene, cfg: RenderConfig, origin, direction, acc, mask,
               alive, seed, bounce, t, obj, tri, prev_pdf=None,
               isect=None, rand=None):
    """One shading iteration of the traceRay loop
    (path_tracing.comp:219-323), given the intersection results.

    ``bounce`` may be a scalar (megakernel loop index) or a per-ray i32
    vector (wavefront pool) — the Russian-roulette gate broadcasts.
    ``prev_pdf``/``isect`` serve next-event estimation (cfg.nee) with
    multiple importance sampling: prev_pdf [R] f32 carries the BSDF
    sampling pdf (solid angle) of the ray's direction when the previous
    vertex also light-sampled (0 elsewhere) — emission found by the
    BSDF ray is then weighted by the balance heuristic
    prev_pdf / (prev_pdf + p_light) instead of being discarded, and the
    light sample carries the complementary weight.  ``isect`` casts the
    shadow rays (with t_max, the any-hit analog).

    Returns (origin, direction, acc, mask, alive, seed, prev_pdf').
    """
    if rand is None:
        rand = get_rand(cfg.parity_rng)
    if prev_pdf is None:
        prev_pdf = jnp.zeros(alive.shape, jnp.float32)

    miss = alive & (t >= INF)
    # Reference assigns (not adds) mask*env on miss (:220-223).
    acc = jnp.where(miss[:, None], mask * cfg.env_color, acc)
    alive = alive & ~miss

    safe_obj = jnp.maximum(obj, 0)
    safe_tri = jnp.maximum(tri, 0)

    # ONE wide-row gather covers all shading inputs (scene/types.py
    # tri_shade layout: cols 32:64 are the owning object's obj_shade).
    ts64 = jnp.take(scene.tri_shade, safe_tri, axis=0)    # [R, 64]
    tshade = ts64[:, 0:32]
    oshade = ts64[:, 32:64]
    world3 = oshade[:, 0:9].reshape(-1, 3, 3)
    inv34 = oshade[:, 9:21].reshape(-1, 3, 4)
    base_color = oshade[:, 21:25]
    emission = oshade[:, 25:28]
    mrti = oshade[:, 28:32]

    # Hit position (world + object space) and barycentrics
    # (:228-234).
    o_loc = transform_point(inv34, origin)
    d_loc = transform_dir(inv34, direction)
    pos_w = origin + t[:, None] * direction
    pos_loc = o_loc + t[:, None] * d_loc
    v0 = tshade[:, 15:18]
    v1 = tshade[:, 18:21]
    v2 = tshade[:, 21:24]
    bary = barycentric(pos_loc, v0, v1, v2)
    uv = (bary[:, 0:1] * tshade[:, 9:11]
          + bary[:, 1:2] * tshade[:, 11:13]
          + bary[:, 2:3] * tshade[:, 13:15])

    roughness = jnp.maximum(mrti[:, 1], 0.001)
    metallic = mrti[:, 0]
    transmission = mrti[:, 2]
    ior = mrti[:, 3]

    # Texture taps (:244-261); statically elided for untextured
    # scenes (cornell/outside).
    if scene.has_textures:
        tex = jnp.take(scene.obj_tex, safe_obj, axis=0)
        # Mip path keys on the SCENE's chain depth (what the atlas was
        # built with); cfg.mip_levels only steers the scene compile.
        if scene.mip_levels > 1:
            # Ray-cone mip LOD (beyond the reference, which samples
            # implicit LOD 0): footprint ~ cfg.mip_spread * t world
            # units, converted to texels via the per-triangle texel
            # density (tri_shade row 24, object units) divided by the
            # object's uniform-scale estimate (|world3 col 0|).
            from logipathtracer_tpu.ops.texture import sample_atlas_lod
            scale = jnp.sqrt(jnp.maximum(
                jnp.sum(world3[:, :, 0] ** 2, axis=-1), 1e-20))
            density_w = tshade[:, 24] / scale

        def tap(slot):
            tid = tex[:, slot]
            if scene.mip_levels > 1:
                base = jnp.take(scene.tex_mip_base,
                                jnp.maximum(tid, 0), axis=0)
                e0 = jnp.take(scene.tex_table, base, axis=0)
                dim = jnp.maximum(e0[:, 2], e0[:, 3]).astype(jnp.float32)
                footprint = cfg.mip_spread * t * density_w * dim
                lod = jnp.log2(jnp.maximum(footprint, 1.0))
                s = sample_atlas_lod(
                    scene.tex_atlas, scene.tex_table, scene.tex_mip_base,
                    scene.tex_mip_count, tid, uv, lod,
                    nearest_aware=scene.has_nearest,
                    quad=scene.tex_quad)
            else:
                s = sample_atlas(scene.tex_atlas, scene.tex_table, tid,
                                 uv, nearest_aware=scene.has_nearest,
                                 quad=scene.tex_quad)
            return (tid >= 0), s
        # Statically skip slots NO object textures (scene.tex_slots).
        used = scene.tex_slots
        if used[0]:
            has_c, c = tap(0)
            base_color = jnp.where(has_c[:, None], base_color * c,
                                   base_color)
        if used[1]:
            has_e, e = tap(1)
            emission = jnp.where(has_e[:, None], emission * e[:, :3],
                                 emission)
        if used[2]:
            has_mr, mr = tap(2)
            metallic = jnp.where(has_mr, metallic * mr[:, 2], metallic)
            roughness = jnp.where(has_mr, roughness * mr[:, 1],
                                  roughness)
        if used[3]:
            has_t, tt = tap(3)
            transmission = jnp.where(has_t, transmission * tt[:, 0],
                                     transmission)

    base_color = srgb_to_linear(base_color)

    lobe, seed = bsdf.determine_interaction(metallic, transmission,
                                            seed, alive, rand=rand)

    # Shading normal: mat3(world) @ interpolated normal, normalized
    # (:272; no inverse-transpose — reference behavior).
    n_loc = (bary[:, 0:1] * tshade[:, 0:3]
             + bary[:, 1:2] * tshade[:, 3:6]
             + bary[:, 2:3] * tshade[:, 6:9])
    n = transform_dir(world3, n_loc)
    n = n / jnp.sqrt(jnp.maximum(
        jnp.sum(n * n, axis=-1, keepdims=True), 1e-38))
    ndotd = jnp.sum(n * direction, axis=-1)
    ff = jnp.where((ndotd < 0.0)[:, None], n, -n)

    def tangent_basis(ffn):
        pick_y = jnp.abs(ffn[:, 0]) > 0.1
        axis = jnp.where(pick_y[:, None],
                         jnp.array([0.0, 1.0, 0.0]),
                         jnp.array([1.0, 0.0, 0.0]))
        u = jnp.cross(axis, ffn)
        u = u / jnp.sqrt(jnp.maximum(
            jnp.sum(u * u, axis=-1, keepdims=True), 1e-38))
        v = jnp.cross(ffn, u)
        return u, v

    u, v = tangent_basis(ff)

    # Emission added pre-BSDF with the pre-bounce mask (:269).  With
    # NEE+MIS active, emission reached by a BSDF ray from a light-
    # sampled diffuse vertex carries the balance-heuristic weight
    # prev_pdf / (prev_pdf + p_light); everywhere else weight 1.
    if cfg.nee and scene.num_lights > 0:
        cos_l_hit = jnp.abs(ndotd)
        p_light_hit = t * t / (jnp.maximum(cos_l_hit, 1e-9)
                               * scene.total_light_area)
        is_emitter = jnp.max(emission, axis=-1) > 0.0
        mis_w = (prev_pdf / (prev_pdf + p_light_hit) if cfg.nee_mis
                 else jnp.zeros_like(prev_pdf))
        w_emit = jnp.where((prev_pdf > 0.0) & is_emitter, mis_w, 1.0)
        acc = acc + jnp.where(alive[:, None],
                              mask * emission * w_emit[:, None], 0.0)
    else:
        acc = acc + jnp.where(alive[:, None], mask * emission, 0.0)

    if scene.has_textures and scene.tex_slots[4]:
        tex = jnp.take(scene.obj_tex, safe_obj, axis=0)
        has_n, nmap = tap(4)
        tn = nmap[:, :3] * 2.0 - 1.0
        tn = tn / jnp.sqrt(jnp.maximum(
            jnp.sum(tn * tn, axis=-1, keepdims=True), 1e-38))
        ff_mapped = (tn[:, 0:1] * u + tn[:, 1:2] * v + tn[:, 2:3] * ff)
        ff_mapped = ff_mapped / jnp.sqrt(jnp.maximum(
            jnp.sum(ff_mapped * ff_mapped, axis=-1, keepdims=True), 1e-38))
        ff = jnp.where(has_n[:, None], ff_mapped, ff)
        u2, v2 = tangent_basis(ff)
        u = jnp.where(has_n[:, None], u2, u)
        v = jnp.where(has_n[:, None], v2, v)

    view = jnp.stack([
        jnp.sum(-direction * u, axis=-1),
        jnp.sum(-direction * v, axis=-1),
        jnp.sum(-direction * ff, axis=-1)], -1)
    outside = jnp.sum(n * -direction, axis=-1) > 0.0

    # --- next-event estimation + MIS (cfg.nee; beyond reference) ------
    # Balance-heuristic MIS between area light sampling and the BSDF
    # sample on diffuse vertices.  The diffuse lobe's MIS pdf proxy is
    # cos/pi: EXACT for the basic BSDF (cosine sampling,
    # basic/BSDF.glsl:3-11, whose weight F0*cos implies f = F0*cos/pi);
    # for the Heitz multiple-scattering diffuse it is only the MIS
    # weighting heuristic (any w_light + w_emit = 1 stays unbiased).
    # The Heitz light-sample f itself is estimated UNBIASEDLY along the
    # sampling walk (bsdf.heitz_sample eval_dir — phase toward the
    # light x escape probability at every microsurface vertex).
    new_pdf = jnp.zeros_like(prev_pdf)
    nee_on = cfg.nee and scene.num_lights > 0 and isect is not None
    if nee_on:
        nee_mask = alive & (lobe == bsdf.LOBE_DIFFUSE)
        r1, seed = rand(seed, nee_mask)
        r2, seed = rand(seed, nee_mask)
        r3, seed = rand(seed, nee_mask)
        li = jnp.clip(jnp.searchsorted(scene.light_cdf, r1), 0,
                      scene.num_lights - 1)
        row = jnp.take(scene.light_tris, li, axis=0)
        lv0, le1, le2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        le = row[:, 9:12]
        su = jnp.sqrt(r2)
        bu = (1.0 - su)[:, None]
        bv = (r3 * su)[:, None]
        lp = lv0 + bu * le1 + bv * le2
        pos_hit = origin + t[:, None] * direction
        # Park non-NEE lanes before ANY of the shadow-query math: missed
        # or dead lanes carry t = INF, so pos_hit is ~±3.4e38 (and wl
        # becomes NaN).  The 1e30 park makes every slab test fail
        # cleanly, same as the main-path dead-lane parking.
        pos_hit = jnp.where(nee_mask[:, None], pos_hit, 1e30)
        ldir = lp - jnp.where(nee_mask[:, None], pos_hit, 0.0)
        dist2 = jnp.maximum(jnp.sum(ldir * ldir, axis=-1), 1e-12)
        dist = jnp.sqrt(dist2)
        wl = ldir / dist[:, None]
        ln = jnp.cross(le1, le2)
        ln = ln / jnp.maximum(jnp.sqrt(
            jnp.sum(ln * ln, axis=-1, keepdims=True)), 1e-20)
        cos_l = jnp.abs(jnp.sum(ln * -wl, axis=-1))  # two-sided emitter
        cos_s = jnp.sum(ff * wl, axis=-1)
        # Light direction in tangent space (for the walk's eval hook).
        wl_t = jnp.stack([jnp.sum(wl * u, axis=-1),
                          jnp.sum(wl * v, axis=-1), cos_s], -1)
        # Shadow query with t_max: everything behind the light is
        # pruned, and the CUDA traversal stops at the first blocker.
        t_lim = jnp.where(nee_mask, dist * (1.0 - 1e-3), 1.0)
        t_s, _, _ = isect(scene, pos_hit, wl, eps=cfg.eps, t_max=t_lim,
                          any_hit=True)
        visible = t_s >= t_lim
        p_light = dist2 / (jnp.maximum(cos_l, 1e-9)
                           * scene.total_light_area)
        p_bsdf_l = jnp.maximum(cos_s, 0.0) / jnp.pi
        w_light = (p_light / (p_light + p_bsdf_l) if cfg.nee_mis
                   else jnp.ones_like(p_light))

    if cfg.use_microfacet:
        if nee_on:
            weight, ldir_t, seed, f_eval = bsdf.heitz_sample(
                base_color[:, :3], view, roughness, transmission, ior,
                outside, lobe, seed, alive, max_order=cfg.heitz_max_order,
                rand=rand, eval_dir=wl_t, eval_mask=nee_mask)
        else:
            weight, ldir_t, seed = bsdf.heitz_sample(
                base_color[:, :3], view, roughness, transmission, ior,
                outside, lobe, seed, alive, max_order=cfg.heitz_max_order,
                rand=rand)
    else:
        weight, ldir_t, seed = bsdf.basic_sample(
            base_color[:, :3], view, transmission, ior,
            outside, lobe, seed, alive, rand=rand)

    if nee_on:
        if cfg.use_microfacet:
            # f_eval already carries the surface cosine (it estimates
            # f * cos_s); only the light-side geometry remains.
            contrib = mask * le * f_eval * (
                cos_l * scene.total_light_area / dist2 * w_light)[:, None]
        else:
            f_d = base_color[:, :3] * jnp.maximum(cos_s, 0.0)[:, None] \
                / jnp.pi
            geom = cos_s * cos_l * scene.total_light_area / dist2
            contrib = mask * le * f_d * (geom * w_light)[:, None]
        use = nee_mask & visible & (cos_s > 0.0)
        acc = acc + jnp.where(use[:, None], contrib, 0.0)

    mask = jnp.where(alive[:, None], mask * weight, mask)
    if nee_on:
        # pdf (solid angle, cos/pi) of the direction the diffuse lobe
        # just sampled — consumed by the NEXT vertex's emission weight.
        new_pdf = jnp.where(nee_mask,
                            jnp.maximum(ldir_t[:, 2], 0.0) / jnp.pi, 0.0)
    ldir_w = (ldir_t[:, 0:1] * u + ldir_t[:, 1:2] * v
              + ldir_t[:, 2:3] * ff)
    origin = jnp.where(alive[:, None], pos_w, origin)
    direction = jnp.where(alive[:, None], ldir_w, direction)

    # Russian roulette (:317-323).
    q = jnp.max(mask, axis=-1)
    rr = alive & (q < cfg.rr_threshold) & (bounce > cfg.rr_bounces)
    r_rr, seed = rand(seed, rr)
    kill = rr & (r_rr > q)
    alive = alive & ~kill
    boost = rr & ~kill
    mask = jnp.where(boost[:, None], mask / q[:, None], mask)

    prev_pdf = jnp.where(alive, new_pdf, prev_pdf)
    return origin, direction, acc, mask, alive, seed, prev_pdf


def trace_rays(scene, cfg: RenderConfig, origin, direction, seed,
               intersect_fn=None):
    """Path-trace a batch of rays: the traceRay loop
    (path_tracing.comp:211-327) vectorized over [R] lanes.

    Returns (radiance [R, 3], seed', rays_traced).
    """
    isect = intersect_fn or select_traversal(cfg.intersect)
    r = origin.shape[0]
    acc = jnp.zeros((r, 3), jnp.float32)
    mask = jnp.ones((r, 3), jnp.float32)
    alive = jnp.ones((r,), bool)

    rays_traced = jnp.zeros((), jnp.float32)

    prev_pdf = jnp.zeros((r,), jnp.float32)

    def bounce_body(bounce, state):
        (origin, direction, acc, mask, alive, seed, prev_pdf,
         rays_traced) = state
        rays_traced = rays_traced + jnp.sum(alive.astype(jnp.float32))
        # Park dead lanes far outside the scene (non-destructive copies):
        # their root slab test fails, so they leave the walk at once.
        o_i = jnp.where(alive[:, None], origin, 1e30)
        d_i = jnp.where(alive[:, None], direction, 1.0)
        # Named scopes label the device ops in profiler traces
        # (chip_smoke.py reads the shade stage's device time by them).
        with jax.named_scope("traverse"):
            t, obj, tri = isect(scene, o_i, d_i, eps=cfg.eps)
        with jax.named_scope("shade"):
            origin, direction, acc, mask, alive, seed, prev_pdf = \
                shade_step(scene, cfg, origin, direction, acc, mask,
                           alive, seed, bounce, t, obj, tri,
                           prev_pdf=prev_pdf, isect=isect)
        return (origin, direction, acc, mask, alive, seed, prev_pdf,
                rays_traced)

    state = (origin, direction, acc, mask, alive, seed, prev_pdf,
             rays_traced)
    state = jax.lax.fori_loop(0, cfg.max_depth, bounce_body, state)
    acc = state[2]
    seed = state[5]
    rays_traced = state[7]
    return acc, seed, rays_traced


def render_rows(scene, cfg: RenderConfig, cam_world, fov_y, ubo_seed,
                y0, rows: int):
    """Render a horizontal slab of ``rows`` image rows starting at
    absolute row ``y0`` (traced).  Pixel RNG streams are keyed by
    absolute coordinates, so any tiling of the image produces exactly
    the full-frame pixels — the invariant the tile-parallel sharding
    relies on.

    Returns (radiance [rows, W, 3], rays_traced scalar).
    """
    w = cfg.render_width
    h = cfg.render_height
    ys, xs = jnp.meshgrid(jnp.arange(rows, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    ys = ys + y0.astype(jnp.float32)
    pixel_xy = jnp.stack([xs, ys], -1).reshape(-1, 2)

    seed = seed_from_pixel(ubo_seed, pixel_xy, parity=cfg.parity_rng)
    origin, direction, seed = generate_ray(
        cam_world, fov_y, pixel_xy, (w, h), seed,
        rand=get_rand(cfg.parity_rng))
    radiance, _, rays = trace_rays(scene, cfg, origin, direction, seed)
    return radiance.reshape(rows, w, 3), rays


@partial(jax.jit, static_argnames=("cfg",))
def render_sample(scene, cfg: RenderConfig, cam_world, fov_y, ubo_seed):
    """One full-frame sample: [H, W, 3] radiance (pre-accumulation).

    cam_world: [4, 4]; ubo_seed: [2] uint32 (host-drawn per sample,
    src/RendererPT.cpp:584-585).
    """
    img, _ = render_rows(scene, cfg, cam_world, fov_y, ubo_seed,
                         jnp.int32(0), cfg.render_height)
    return img


@partial(jax.jit, static_argnames=("cfg",), donate_argnums=(5,))
def accumulate_sample(scene, cfg: RenderConfig, cam_world, fov_y, ubo_seed,
                      accum, reset):
    """Progressive step: render one sample and accumulate-or-reset
    (path_tracing.comp:346-351; the accumulation buffer is donated, the
    analog of the persistent RGBA32F image).

    Returns (accum', rays_traced) — exact ray count for Mrays/sec.
    """
    h, w = cfg.render_height, cfg.render_width
    ys, xs = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    pixel_xy = jnp.stack([xs, ys], -1).reshape(-1, 2)
    seed = seed_from_pixel(ubo_seed, pixel_xy, parity=cfg.parity_rng)
    origin, direction, seed = generate_ray(
        cam_world, fov_y, pixel_xy, (w, h), seed,
        rand=get_rand(cfg.parity_rng))
    radiance, _, rays = trace_rays(scene, cfg, origin, direction, seed)
    sample = radiance.reshape(h, w, 3)
    return jnp.where(reset, sample, accum + sample), rays
