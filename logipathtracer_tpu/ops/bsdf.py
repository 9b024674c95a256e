"""BSDF sampling: Heitz multiple-scattering microfacet walks + basic lobes.

Reimplements shaders/heitz/BSDF.glsl (Heitz 2016 "Multiple-Scattering
Microfacet BSDFs with the Smith Model": stochastic random walks on the
microsurface, sampled with the GGX visible-normal distribution of
Heitz 2018 JCGT) and shaders/basic/BSDF.glsl as vectorized fixed-trip
masked loops — a lockstep restructuring of the reference's
variable-length while loops.

The three walks (diffuse / conductor / dielectric,
heitz/BSDF.glsl:108-275) are FUSED into one ``heitz_max_order``-iteration
loop: every iteration draws the height sample (1 rand) and the VNDF
micro-normal (2 rands) shared by all lobes, then the lobe-specific
tail draws (diffuse: 2 concentric-disk rands; dielectric: 1 Fresnel
rand; conductor: none).  Masked draws advance each lane's RNG stream
exactly as the scalar reference would, so per-pixel rand() sequences
are bit-identical to the GLSL megakernel (parity requirement,
SURVEY.md §7 hard part 2).

Conventions: tangent space {u, v, ffNormal}; view_dir.z > 0 on entry;
all directions [..., 3]; lobe ∈ {0: diffuse, 1: metallic, 2: transmission}
(the reference's kDiff/kMetallic/kTrans, heitz/interaction_type.glsl:6-8).
"""

from __future__ import annotations

import jax.numpy as jnp

from logipathtracer_tpu.ops.rng import rand_parity_masked

PI = 3.141592653589  # shaders/common/constants.glsl:5 (f32)

LOBE_DIFFUSE = 0
LOBE_METALLIC = 1
LOBE_TRANSMISSION = 2


def determine_interaction(metallic, transmission, seed, active,
                          rand=rand_parity_masked):
    """One-sample lobe selection (heitz/interaction_type.glsl:10-29).

    Returns (lobe [...], seed'). Consumes 1 rand on active lanes.
    """
    metallic_w = metallic
    transmission_w = (1.0 - metallic) * transmission
    dielectric_w = (1.0 - transmission) * (1.0 - metallic)
    norm = 1.0 / (metallic_w + transmission_w + dielectric_w)
    metallic_w = metallic_w * norm
    transmission_w = transmission_w * norm
    r, seed = rand(seed, active)
    lobe = jnp.where(
        r < metallic_w, LOBE_METALLIC,
        jnp.where(r < metallic_w + transmission_w, LOBE_TRANSMISSION,
                  LOBE_DIFFUSE))
    return lobe.astype(jnp.int32), seed


def fresnel_dielectric(vdoth, eta):
    """Exact unpolarized dielectric Fresnel (heitz/BSDF.glsl:10-24);
    returns 1 on total internal reflection."""
    cos_t2 = 1.0 - (1.0 - vdoth * vdoth) / (eta * eta)
    cos_t = jnp.sqrt(jnp.maximum(cos_t2, 0.0))
    rs = (vdoth - eta * cos_t) / (vdoth + eta * cos_t)
    rp = (eta * vdoth - cos_t) / (eta * vdoth + cos_t)
    f = 0.5 * (rs * rs + rp * rp)
    return jnp.where(cos_t2 <= 0.0, 1.0, f)


def refract_eta(wi, wm, eta):
    """Refraction about micro-normal (heitz/BSDF.glsl:26-32), unnormalized."""
    eta = eta[..., None]
    cos_i = jnp.sum(wi * wm, axis=-1, keepdims=True)
    cos_t2 = 1.0 - (1.0 - cos_i * cos_i) / (eta * eta)
    cos_t = -jnp.sqrt(jnp.maximum(cos_t2, 0.0))
    return wm * (cos_i / eta + cos_t) - wi / eta


def _normalize(v, eps=0.0):
    return v / jnp.sqrt(jnp.maximum(
        jnp.sum(v * v, axis=-1, keepdims=True), 1e-38))


def sample_vndf(ve, alpha, r1, r2):
    """GGX visible-normal sampling (heitz/BSDF.glsl:41-67, from Heitz
    2018 JCGT 'Sampling the GGX Distribution of Visible Normals')."""
    a = alpha[..., None]
    vh = _normalize(jnp.stack(
        [a[..., 0] * ve[..., 0], a[..., 0] * ve[..., 1], ve[..., 2]], -1))
    # Orthonormal basis about vh.
    z = jnp.zeros_like(vh)
    up = z.at[..., 2].set(1.0)
    t1_raw = jnp.cross(up, vh)
    t1 = jnp.where((vh[..., 2] < 1.0)[..., None], _normalize(t1_raw),
                   z.at[..., 0].set(1.0))
    t2 = jnp.cross(vh, t1)
    r = jnp.sqrt(r1)
    phi = (2.0 * PI) * r2
    t1c = r * jnp.cos(phi)
    t2c = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    t2c = (1.0 - s) * jnp.sqrt(jnp.maximum(1.0 - t1c * t1c, 0.0)) + s * t2c
    nz = jnp.sqrt(jnp.maximum(0.0, 1.0 - t1c * t1c - t2c * t2c))
    nh = (t1c[..., None] * t1 + t2c[..., None] * t2 + nz[..., None] * vh)
    ne = _normalize(jnp.stack(
        [a[..., 0] * nh[..., 0], a[..., 0] * nh[..., 1],
         jnp.maximum(nh[..., 2], 0.0)], -1))
    return ne


def sample_ggx_height(direction, height, alpha, r):
    """Free-path height sampling on the Smith microsurface
    (heitz/BSDF.glsl:72-84)."""
    scaled = direction * jnp.stack(
        [alpha, alpha, jnp.ones_like(alpha)], -1)
    length = jnp.sqrt(jnp.sum(scaled * scaled, axis=-1))
    projected = jnp.maximum(0.5 * (length - direction[..., 2]), 1e-7)
    delta = -jnp.log(1.0 - r) * direction[..., 2] / projected
    return height + delta


def _concentric_disk(r1, r2):
    """Concentric disk mapping (heitz/BSDF.glsl:218-231) with the
    reference's exact branch structure; safe against 0/0."""
    r1s = jnp.where(r1 == 0.0, 1.0, r1)  # guarded denominators
    r2s = jnp.where(r2 == 0.0, 1.0, r2)
    use_r1 = r1 * r1 > r2 * r2
    radius = jnp.where(use_r1, r1, r2)
    phi = jnp.where(use_r1, (PI / 4.0) * (r2 / r1s),
                    (PI / 2.0) - (r1 / r2s) * (PI / 4.0))
    both_zero = (r1 == 0.0) & (r2 == 0.0)
    radius = jnp.where(both_zero, 0.0, radius)
    phi = jnp.where(both_zero, 0.0, phi)
    return radius, phi


def heitz_sample(base_color, view_dir, roughness, transmission, ior,
                 outside, lobe, seed, active, max_order: int = 16,
                 rand=rand_parity_masked, eval_dir=None, eval_mask=None):
    """Fused Heitz random walk for all three lobes.

    Args:
      base_color: [..., 3] linear F0 (the walks' per-bounce weight).
      view_dir:   [..., 3] tangent-space direction toward the viewer.
      roughness:  [...] (alpha = roughness^2, heitz/BSDF.glsl:109).
      transmission, ior: [...] dielectric parameters.
      outside:    [...] bool — geometric side at the macro surface
                  (path_tracing.comp:304).
      lobe:       [...] int32 in {0,1,2}.
      seed:       [..., 2] uint32 parity-RNG state.
      active:     [...] bool — lanes that shade at all.
      eval_dir:   optional [..., 3] tangent-space direction toward a
                  light sample.  When given, the walk ALSO estimates the
                  diffuse-lobe BSDF-times-cosine toward it (stochastic
                  evaluation along the sampling walk, Heitz 2016 §5.1:
                  at every scattering vertex add
                  energy * phase(-> eval_dir) * P_escape(eval_dir, h),
                  where P_escape is the same exponential free-path model
                  the walk's own height sampler uses).  Consumes NO
                  extra rands; exact in expectation for this
                  microsurface model — the unbiased NEE hook.
      eval_mask:  [...] bool — lanes whose eval estimate is wanted.

    Returns (weight [..., 3], light_dir [..., 3] tangent space, seed')
    or, when eval_dir is given, (weight, light_dir, seed',
    f_eval [..., 3] — estimate of f_diffuse(view, eval_dir) * cos).
    """
    alpha = roughness * roughness
    is_diff = active & (lobe == LOBE_DIFFUSE)
    is_metal = active & (lobe == LOBE_METALLIC)
    is_trans = active & (lobe == LOBE_TRANSMISSION)

    light_dir = -view_dir
    height = jnp.zeros_like(roughness)
    energy = jnp.ones_like(base_color)

    # Dielectric ior bookkeeping (heitz/BSDF.glsl:168-179): the walk's
    # own `outside` starts true; eta toggles between iorIn/iorOut.
    ior_out = jnp.where(outside, 1.0, ior)
    ior_in = jnp.where(outside, ior, 1.0)
    walk_outside = jnp.ones_like(outside)

    walking = active

    if eval_dir is not None:
        f_eval = jnp.zeros_like(base_color)
        # Escape probability toward the light: the walk's free-path
        # model (sample_ggx_height) draws delta ~ Exp(mean w.z/proj(w));
        # from height h < 0 the segment leaves the surface with
        # P(h + delta > 0) = exp(h * proj / w.z).
        scaled_l = eval_dir * jnp.stack(
            [alpha, alpha, jnp.ones_like(alpha)], -1)
        proj_l = jnp.maximum(
            0.5 * (jnp.sqrt(jnp.sum(scaled_l * scaled_l, axis=-1))
                   - eval_dir[..., 2]), 1e-7)
        esc_rate = proj_l / jnp.maximum(eval_dir[..., 2], 1e-7)

    for _ in range(max_order):
        # --- height sample: 1 rand on walking lanes -------------------
        below = is_trans & ~walk_outside
        h_dir = jnp.where(below[..., None], -light_dir, light_dir)
        h_in = jnp.where(below, -height, height)
        r_h, seed = rand(seed, walking)
        h_raw = sample_ggx_height(h_dir, h_in, alpha, r_h)
        h_new = jnp.where(below, -h_raw, h_raw)
        left = jnp.where(below, h_new < 0.0, h_new > 0.0)
        height = jnp.where(walking, h_new, height)

        cont = walking & ~left

        # --- shared VNDF micro-normal: 2 rands on continuing lanes ----
        wo = -light_dir
        r1, seed = rand(seed, cont)
        r2, seed = rand(seed, cont)
        micro = sample_vndf(wo, alpha, r1, r2)
        vdoth = jnp.sum(wo * micro, axis=-1)

        # Conductor phase (heitz/BSDF.glsl:88-104): clamped vdoth mirror.
        vdoth_c = jnp.clip(vdoth, 0.0, 1.0)
        refl_c = 2.0 * micro * vdoth_c[..., None] - wo

        # Diffuse phase (heitz/BSDF.glsl:211-239): 2 extra rands.
        d_mask = cont & is_diff
        z = jnp.zeros_like(micro)
        up = z.at[..., 2].set(1.0)
        du_raw = jnp.cross(up, micro)
        du = jnp.where((micro[..., 2] < 1.0)[..., None], _normalize(du_raw),
                       z.at[..., 0].set(1.0))
        dv = jnp.cross(micro, du)
        rd1, seed = rand(seed, d_mask)
        rd2, seed = rand(seed, d_mask)
        radius, phi = _concentric_disk(2.0 * rd1 - 1.0, 2.0 * rd2 - 1.0)
        dx = radius * jnp.cos(phi)
        dy = radius * jnp.sin(phi)
        dz = jnp.sqrt(jnp.maximum(0.0, 1.0 - dx * dx - dy * dy))
        diff_dir = dx[..., None] * du + dy[..., None] * dv + dz[..., None] * micro

        # Dielectric phase (heitz/BSDF.glsl:140-158): 1 extra rand.
        t_mask = cont & is_trans
        eta = jnp.where(walk_outside, ior_in / ior_out, ior_out / ior_in)
        fres = fresnel_dielectric(vdoth, eta)
        r_f, seed = rand(seed, t_mask)
        reflect_choice = r_f < fres
        refl_t = 2.0 * micro * vdoth[..., None] - wo
        refr_t = _normalize(refract_eta(wo, micro, eta))
        trans_dir = jnp.where(reflect_choice[..., None], refl_t, refr_t)
        walk_outside = jnp.where(t_mask & ~reflect_choice,
                                 ~walk_outside, walk_outside)

        # --- NEE stochastic eval (diffuse lobe only) -------------------
        if eval_dir is not None:
            # Diffuse phase value toward the light through THIS vertex's
            # sampled micro-normal (one-sample estimator), attenuated by
            # the escape probability from the vertex height.
            phase_l = jnp.maximum(
                jnp.sum(eval_dir * micro, axis=-1), 0.0) / PI
            esc = jnp.exp(jnp.minimum(height * esc_rate, 0.0))
            em = cont & is_diff & eval_mask & (eval_dir[..., 2] > 0.0)
            f_eval = f_eval + jnp.where(
                em, phase_l * esc, 0.0)[..., None] * (energy * base_color)

        # --- merge ----------------------------------------------------
        new_dir = jnp.where(
            is_diff[..., None], diff_dir,
            jnp.where(is_trans[..., None], trans_dir, refl_c))
        light_dir = jnp.where(cont[..., None], new_dir, light_dir)
        # Per-bounce energy: diffuse and conductor multiply by F0
        # (heitz/BSDF.glsl:101,264); dielectric leaves energy alone.
        mul = cont & (is_diff | is_metal)
        energy = jnp.where(mul[..., None], energy * base_color, energy)

        walking = cont

    exhausted = walking  # never left the microsurface after max_order
    # Diffuse exhaustion: zero energy, light (0,0,1)
    # (heitz/BSDF.glsl:269-272).
    d_ex = is_diff & exhausted
    energy = jnp.where(d_ex[..., None], 0.0, energy)
    up_dir = jnp.zeros_like(light_dir).at[..., 2].set(1.0)
    light_dir = jnp.where(d_ex[..., None], up_dir, light_dir)
    # Dielectric always returns F0 (heitz/BSDF.glsl:208).
    weight = jnp.where(is_trans[..., None], base_color, energy)
    if eval_dir is not None:
        return weight, light_dir, seed, f_eval
    return weight, light_dir, seed


# ---------------------------------------------------------------------------
# Basic single-scatter BSDFs (shaders/basic/BSDF.glsl) — the non-
# USE_MICROFACET fallback; cheap smoke-test mode (BASELINE.json config 1).
# ---------------------------------------------------------------------------


def _reflect(i, n):
    return i - 2.0 * jnp.sum(n * i, axis=-1, keepdims=True) * n


def _glsl_refract(i, n, eta):
    """GLSL refract(): zero vector on total internal reflection."""
    ndoti = jnp.sum(n * i, axis=-1)
    k = 1.0 - eta * eta * (1.0 - ndoti * ndoti)
    refr = (eta[..., None] * i
            - (eta * ndoti + jnp.sqrt(jnp.maximum(k, 0.0)))[..., None] * n)
    return jnp.where((k < 0.0)[..., None], 0.0, refr)


def basic_sample(base_color, view_dir, transmission, ior, outside,
                 lobe, seed, active, rand=rand_parity_masked):
    """Fused basic lobes (basic/BSDF.glsl:3-49).

    diffuse: cosine hemisphere (2 rands); specular: mirror about +z
    (0 rands); transmission: Fresnel-weighted reflect/refract (1 rand,
    hardcoded nc=1, nt=1.5 inside the Fresnel — a reference quirk kept
    as-is via its parameters nc=1.0, nt=ior at the call site).
    """
    is_diff = active & (lobe == LOBE_DIFFUSE)
    is_metal = active & (lobe == LOBE_METALLIC)
    is_trans = active & (lobe == LOBE_TRANSMISSION)

    z_axis = jnp.zeros_like(view_dir).at[..., 2].set(1.0)

    # Diffuse (2 rands).
    r1, seed = rand(seed, is_diff)
    r2, seed = rand(seed, is_diff)
    phi = 2.0 * PI * r1
    r2s = jnp.sqrt(r2)
    diff_dir = jnp.stack([jnp.cos(phi) * r2s, jnp.sin(phi) * r2s,
                          jnp.sqrt(1.0 - r2)], -1)
    diff_w = base_color * diff_dir[..., 2:3]

    # Specular mirror (0 rands).
    spec_dir = _reflect(-view_dir, z_axis)
    spec_w = base_color

    # Transmission (1 rand). basicFresnelReflectance(n=±z, nl=+z,
    # rayDirection=-viewDir, nc=1, nt=ior) — basic/BSDF.glsl:19-49.
    normal = jnp.where(outside[..., None], z_axis, -z_axis)
    ray_dir = -view_dir
    nc = jnp.ones_like(ior)
    nt = ior
    nnt = jnp.where(jnp.sum(ray_dir * normal, axis=-1) < 0.0,
                    nc / nt, nt / nc)
    tdir = _glsl_refract(ray_dir, z_axis, nnt)
    cos_inc = jnp.sum(z_axis * ray_dir, axis=-1)
    cos_tra = jnp.sum(z_axis * tdir, axis=-1)
    coef_para = (nt * cos_inc - nc * cos_tra) / (nt * cos_inc + nc * cos_tra)
    coef_perp = (nc * cos_inc - nt * cos_tra) / (nc * cos_inc + nt * cos_tra)
    re = (coef_para * coef_para + coef_perp * coef_perp) * 0.5
    r_t, seed = rand(seed, is_trans)
    reflect_choice = r_t < re
    trans_dir = jnp.where(reflect_choice[..., None],
                          _reflect(-view_dir, normal), tdir)
    trans_w = jnp.where(reflect_choice[..., None], 1.0,
                        base_color * transmission[..., None])

    light_dir = jnp.where(
        is_diff[..., None], diff_dir,
        jnp.where(is_trans[..., None], trans_dir, spec_dir))
    weight = jnp.where(
        is_diff[..., None], diff_w,
        jnp.where(is_trans[..., None], trans_w, spec_w))
    return weight, light_dir, seed
