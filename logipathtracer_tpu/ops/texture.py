"""Texture atlas sampling.

The reference binds up to 512 separate combined image samplers
(shaders/path_tracing.comp:105) and lets fixed-function hardware do
bilinear filtering.  Here all images live in one padded
atlas (scene/compile.py:_pack_textures) and filtering is four gathers +
a lerp.  No mipmapping — the reference samples at implicit LOD 0 from a
compute shader, so this matches.
"""

from __future__ import annotations

import jax.numpy as jnp

WRAP_REPEAT = 10497
WRAP_CLAMP = 33071
WRAP_MIRROR = 33648


def _fetch_rows(atlas, flat):
    """Gather texel rows by flat index -> [..., 4] f32 linear [0, 1].

    f32 atlas ([AH, AW, 4]): one 4-col row gather.  Packed RGBA8 atlas
    ([AH, AW] u32, scene/compile.py:_pack_textures): ONE u32 row per
    texel — 4x fewer gathered elements (the gather cost is per element)
    — then an in-register unpack; the /255.0 divisions match the f32
    packer's exactly (bitwise, both IEEE f32 divides of integers
    0..255), so both layouts produce identical sample values.
    """
    if atlas.ndim == 2:  # packed u32
        v = jnp.take(atlas.reshape(-1), flat, axis=0)
        return jnp.stack(
            [((v >> (8 * i)) & 0xFF).astype(jnp.float32) / 255.0
             for i in range(4)], axis=-1)
    return jnp.take(atlas.reshape(-1, 4), flat, axis=0)


def _wrap(coord, size, mode):
    """Apply wrap mode to unnormalized texel coordinates [..,] int32."""
    sizef = size.astype(jnp.float32)
    c = coord
    repeat = jnp.mod(c, size)
    clamp = jnp.clip(c, 0, size - 1)
    period = 2 * size
    m = jnp.mod(jnp.mod(c, period) + period, period)
    mirror = jnp.where(m < size, m, period - 1 - m)
    return jnp.where(mode == WRAP_CLAMP, clamp,
                     jnp.where(mode == WRAP_MIRROR, mirror, repeat))


def _bilinear(atlas, entry, uv, quad=None):
    """Bilinear fetch of one atlas entry [..., 6] at uv [..., 2].

    ``quad`` ([AH, AW, 4] u32, scene/compile.py:_build_quad_atlas):
    each texel's row carries its full 2x2 bilinear neighborhood with
    the texture's OWN wrap already applied at pack time, so a tap is
    ONE 4-col row gather instead of four 1-col gathers.  Exact for
    REPEAT/CLAMP wraps (MIRROR reverses direction under reflection,
    which a per-texel neighbor cannot encode — such scenes get
    quad=None at compile).  CLAMP needs one index/weight remap to stay
    bit-identical at the low edge: for sample points left of texel 0
    both true corners are texel 0, but quad row 0's neighbor is texel
    1 — remapping (ix < 0) -> (ix=0, ax=0) reproduces the corner pair
    exactly; the high edge needs nothing (texel w-1's packed neighbor
    IS w-1 under clamp).  The override replaces the fetched CORNERS
    (c10 := c00), not the lerp weights, so the blend arithmetic is
    bit-identical to the 4-gather path (which computes
    c00*(1-ax) + c00*ax there — not exactly c00 in f32).
    """
    x0, y0 = entry[..., 0], entry[..., 1]
    w, h = entry[..., 2], entry[..., 3]
    ws, wt = entry[..., 4], entry[..., 5]

    # GL linear filtering: sample point at uv*size - 0.5.
    fx = uv[..., 0] * w.astype(jnp.float32) - 0.5
    fy = uv[..., 1] * h.astype(jnp.float32) - 0.5
    ix = jnp.floor(fx)
    iy = jnp.floor(fy)
    ax = (fx - ix)[..., None]
    ay = (fy - iy)[..., None]
    ix = ix.astype(jnp.int32)
    iy = iy.astype(jnp.int32)

    aw = atlas.shape[1]

    if quad is not None:
        lo_s = ((ws == WRAP_CLAMP) & (ix < 0))[..., None]
        lo_t = ((wt == WRAP_CLAMP) & (iy < 0))[..., None]
        px = _wrap(ix, w, ws) + x0
        py = _wrap(iy, h, wt) + y0
        v = jnp.take(quad.reshape(-1, 4), py * aw + px, axis=0)

        def unpack(u):
            return jnp.stack(
                [((u >> (8 * i)) & 0xFF).astype(jnp.float32) / 255.0
                 for i in range(4)], axis=-1)

        c00 = unpack(v[..., 0])
        c10 = jnp.where(lo_s, c00, unpack(v[..., 1]))
        c01 = jnp.where(lo_t, c00, unpack(v[..., 2]))
        c11 = jnp.where(lo_s, c01, jnp.where(lo_t, c10, unpack(v[..., 3])))
    else:
        def fetch(px, py):
            px = _wrap(px, w, ws) + x0
            py = _wrap(py, h, wt) + y0
            return _fetch_rows(atlas, py * aw + px)

        c00 = fetch(ix, iy)
        c10 = fetch(ix + 1, iy)
        c01 = fetch(ix, iy + 1)
        c11 = fetch(ix + 1, iy + 1)
    top = c00 * (1 - ax) + c10 * ax
    bot = c01 * (1 - ax) + c11 * ax
    return top * (1 - ay) + bot * ay


def _nearest(atlas, entry, uv):
    """GL NEAREST fetch: texel at floor(uv * size), wrapped."""
    x0, y0 = entry[..., 0], entry[..., 1]
    w, h = entry[..., 2], entry[..., 3]
    ws, wt = entry[..., 4], entry[..., 5]
    ix = jnp.floor(uv[..., 0] * w.astype(jnp.float32)).astype(jnp.int32)
    iy = jnp.floor(uv[..., 1] * h.astype(jnp.float32)).astype(jnp.int32)
    px = _wrap(ix, w, ws) + x0
    py = _wrap(iy, h, wt) + y0
    aw = atlas.shape[1]
    return _fetch_rows(atlas, py * aw + px)


def _filtered(atlas, entry, uv, flag_col: int, nearest_aware: bool,
              quad=None):
    if not nearest_aware:
        return _bilinear(atlas, entry, uv, quad=quad)
    nf = entry[..., flag_col] == 1
    return jnp.where(nf[..., None], _nearest(atlas, entry, uv),
                     _bilinear(atlas, entry, uv, quad=quad))


def sample_atlas(atlas, table, tex_id, uv, nearest_aware: bool = False,
                 quad=None):
    """LOD-0 texture fetch (reference behavior — it samples at implicit
    LOD 0 from compute, path_tracing.comp:244-261): bilinear, or GL
    NEAREST for samplers with magFilter NEAREST when ``nearest_aware``
    (static; scene.has_nearest — keeps all-linear scenes on the
    4-gather path).

    atlas:  [AH, AW, 4] f32.
    table:  [NE, 8] i32 (x, y, w, h, wrap_s, wrap_t, mag_nearest,
            min_nearest).
    tex_id: [...] int32 table-entry index (callers mask out id < 0
            themselves; with mips, pass the texture's mip_base).
    uv:     [..., 2] f32.
    Returns [..., 4] f32.
    """
    safe_id = jnp.maximum(tex_id, 0)
    entry = jnp.take(table, safe_id, axis=0)  # [..., 8]
    return _filtered(atlas, entry, uv, 6, nearest_aware, quad=quad)


def sample_atlas_lod(atlas, table, mip_base, mip_count, tex_id, uv, lod,
                     nearest_aware: bool = False, quad=None):
    """Trilinear fetch (beyond the reference; cfg.mip_levels > 1).

    mip_base/mip_count: [NT] i32 per-texture chain location in table.
    lod: [...] f32 mip level (0 = full res); clamped per texture.
    nearest_aware honors sampler filters: level-0 taps use the
    magFilter flag, higher levels the minFilter within-level flag.
    """
    safe_id = jnp.maximum(tex_id, 0)
    base = jnp.take(mip_base, safe_id, axis=0)
    cnt = jnp.take(mip_count, safe_id, axis=0)
    l = jnp.clip(lod, 0.0, (cnt - 1).astype(jnp.float32))
    l0 = jnp.floor(l)
    frac = (l - l0)[..., None]
    l0 = l0.astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, cnt - 1)
    e0 = jnp.take(table, base + l0, axis=0)
    e1 = jnp.take(table, base + l1, axis=0)
    if nearest_aware:
        n0 = jnp.where(l0 == 0, e0[..., 6], e0[..., 7]) == 1
        c0 = jnp.where(n0[..., None], _nearest(atlas, e0, uv),
                       _bilinear(atlas, e0, uv, quad=quad))
        n1 = e1[..., 7] == 1
        c1 = jnp.where(n1[..., None], _nearest(atlas, e1, uv),
                       _bilinear(atlas, e1, uv, quad=quad))
    else:
        c0 = _bilinear(atlas, e0, uv, quad=quad)
        c1 = _bilinear(atlas, e1, uv, quad=quad)
    return c0 * (1.0 - frac) + c1 * frac
