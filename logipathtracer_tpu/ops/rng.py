"""Counter-style RNG streams.

Two generators:

* ``rand_parity`` — bit-faithful reimplementation of the reference's
  GLSL hash (shaders/common/random.glsl:9-15): a per-pixel uvec2 state
  advanced by (1,1) per draw, hashed through two LCG-style multiplies.
  Needed for equal-seed comparisons against the reference renderer,
  including its quirks (pixel rows/columns whose seed component is 0
  produce degenerate streams — SURVEY.md §2.2 RNG row).

* ``rand_threefry`` — the high-quality path (config.parity_rng=False):
  a counter-mode Threefry-2x32 (20 rounds, the Salmon et al. SC11
  parameters, same function family jax.random uses) over the identical
  [..., 2] uint32 state layout, so it is a drop-in for the parity hash.
  It has none of the parity hash's degenerate streams (pixel rows or
  columns whose seed component is 0 repeat the same values forever).

State layout for both: uint32 array [..., 2] (the GLSL uvec2). Every
draw returns (value_f32, new_state). Masked draws advance only the
lanes where mask is True — the vectorized equivalent of the scalar
control flow deciding whether rand() is called at all.

Kernels take the draw function as a ``rand`` parameter; ``get_rand``
maps config.parity_rng to the right one.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Module-level constants must be NUMPY scalars: a jnp scalar here would
# initialize the default backend at import time
# (tests/test_import_no_backend.py).  numpy scalars promote identically
# inside traced code.
_MUL = np.uint32(1103515245)
# float(0xffffffffu) rounds to 4.2949673e9 in f32; the reference divides
# by it (random.glsl:14).
_INV = np.float32(1.0) / np.float32(4294967295.0)


def seed_from_pixel(ubo_seed: jnp.ndarray, pixel_xy: jnp.ndarray,
                    parity: bool = True) -> jnp.ndarray:
    """Per-pixel stream seed.

    parity=True: ubo.seed * pixel.xy with u32 wraparound
    (path_tracing.comp:341, rtx/raygen.rgen:35) — including the
    reference's degenerate zero-product streams.
    parity=False: odd-constant mix (a bijection per axis, so streams
    stay distinct per pixel) with no zero-product degeneracy; the
    threefry draw does the heavy mixing.
    """
    ubo = ubo_seed.astype(jnp.uint32)
    pix = pixel_xy.astype(jnp.uint32)
    if parity:
        return ubo * pix
    return jnp.stack([ubo[..., 0] + pix[..., 0] * jnp.uint32(0x9E3779B9),
                      ubo[..., 1] + pix[..., 1] * jnp.uint32(0x85EBCA6B)],
                     axis=-1)


def rand_parity(state: jnp.ndarray):
    """One draw: state [..., 2] u32 → (value [...] f32 in [0,1], state')."""
    state = state + jnp.uint32(1)
    sx, sy = state[..., 0], state[..., 1]
    qx = _MUL * ((sx >> jnp.uint32(1)) ^ sy)
    qy = _MUL * ((sy >> jnp.uint32(1)) ^ sx)
    n = _MUL * (qx ^ (qy >> jnp.uint32(3)))
    return n.astype(jnp.float32) * _INV, state


def rand_parity_masked(state: jnp.ndarray, mask: jnp.ndarray):
    """Draw for all lanes but advance state only where mask is True."""
    value, new_state = rand_parity(state)
    keep = mask[..., None]
    return value, jnp.where(keep, new_state, state)


# ---- Threefry-2x32 (quality path) -----------------------------------

# Fixed generator key; per-stream variation lives in the counter words.
_TF_K0 = np.uint32(0x1BD11BDA ^ 0xCAFEF00D ^ 0xBAADF00D)
_TF_KS = (np.uint32(0xCAFEF00D), np.uint32(0xBAADF00D))
_TF_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
# 2^-24 scale on the top 24 bits: uniform in [0, 1), never 1.0.
_INV24 = np.float32(1.0 / 16777216.0)


def _threefry2x32(c0: jnp.ndarray, c1: jnp.ndarray):
    """Standard 20-round Threefry-2x32 with the fixed key above."""
    ks0, ks1 = _TF_KS
    ks2 = _TF_K0
    x0 = c0 + ks0
    x1 = c1 + ks1
    key_sched = ((ks1, ks2), (ks2, ks0), (ks0, ks1), (ks1, ks2),
                 (ks2, ks0))
    for block in range(5):
        for r in _TF_ROT[4 * (block % 2): 4 * (block % 2) + 4]:
            x0 = x0 + x1
            x1 = (x1 << jnp.uint32(r)) | (x1 >> jnp.uint32(32 - r))
            x1 = x1 ^ x0
        ka, kb = key_sched[block]
        x0 = x0 + ka
        x1 = x1 + kb + jnp.uint32(block + 1)
    return x0, x1


def rand_threefry(state: jnp.ndarray):
    """One draw: state [..., 2] u32 → (value [...] f32 in [0,1), state').

    Counter mode: the state advances by (1,1) per draw exactly like the
    parity hash (so masked-draw bookkeeping is identical); the output is
    Threefry-2x32 of the counter words.
    """
    state = state + jnp.uint32(1)
    n, _ = _threefry2x32(state[..., 0], state[..., 1])
    return (n >> jnp.uint32(8)).astype(jnp.float32) * _INV24, state


def rand_threefry_masked(state: jnp.ndarray, mask: jnp.ndarray):
    """Threefry draw advancing only masked lanes (drop-in for
    rand_parity_masked)."""
    value, new_state = rand_threefry(state)
    keep = mask[..., None]
    return value, jnp.where(keep, new_state, state)


def get_rand(parity: bool):
    """Masked-draw function for config.parity_rng."""
    return rand_parity_masked if parity else rand_threefry_masked
