"""RNG bit-exactness: the jnp parity RNG and the scalar oracle RNG must
both match a C implementation of the GLSL hash compiled with g++
(uint32 semantics identical to GLSL), including the degenerate streams
where a seed component is 0 (SURVEY.md §2.2 RNG row)."""

import os
import struct
import subprocess
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest

from logipathtracer_tpu.ops.rng import (rand_parity, rand_parity_masked,
                                        seed_from_pixel)
from oracle import Rng

_C_SRC = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
int main(int argc, char** argv) {
    uint32_t sx = strtoul(argv[1], nullptr, 10);
    uint32_t sy = strtoul(argv[2], nullptr, 10);
    int n = atoi(argv[3]);
    for (int i = 0; i < n; i++) {
        sx += 1u; sy += 1u;
        uint32_t qx = 1103515245u * ((sx >> 1u) ^ sy);
        uint32_t qy = 1103515245u * ((sy >> 1u) ^ sx);
        uint32_t v = 1103515245u * (qx ^ (qy >> 3u));
        float f = (float)v * (1.0f / (float)0xffffffffu);
        printf("%08x %a\n", v, f);
    }
    return 0;
}
"""


@pytest.fixture(scope="module")
def c_rng():
    tmp = tempfile.mkdtemp()
    src = os.path.join(tmp, "rng.cpp")
    exe = os.path.join(tmp, "rng")
    with open(src, "w") as f:
        f.write(_C_SRC)
    subprocess.run(["g++", "-O2", "-o", exe, src], check=True)

    def run(sx, sy, n):
        out = subprocess.run([exe, str(sx), str(sy), str(n)],
                             capture_output=True, text=True, check=True)
        rows = [l.split() for l in out.stdout.strip().splitlines()]
        bits = np.array([int(r[0], 16) for r in rows], np.uint32)
        vals = np.array([float.fromhex(r[1]) for r in rows], np.float32)
        return bits, vals
    return run


@pytest.mark.parametrize("seed", [(12345, 67890), (0, 0), (0, 7), (7, 0),
                                  (0xFFFFFFFF, 0xFFFFFFFE), (1, 1)])
def test_parity_vs_c(c_rng, seed):
    n = 64
    _, golden = c_rng(seed[0], seed[1], n)

    # jnp vectorized
    state = jnp.array([seed], jnp.uint32)
    got = []
    for _ in range(n):
        v, state = rand_parity(state)
        got.append(float(v[0]))
    assert np.array_equal(np.array(got, np.float32), golden)

    # scalar oracle
    r = Rng(np.array(seed, np.uint32))
    got_s = np.array([r.rand() for _ in range(n)], np.float32)
    assert np.array_equal(got_s, golden)


def test_masked_advance():
    state = jnp.array([[5, 9], [5, 9]], jnp.uint32)
    mask = jnp.array([True, False])
    v, s2 = rand_parity_masked(state, mask)
    assert (np.asarray(s2)[0] == [6, 10]).all()
    assert (np.asarray(s2)[1] == [5, 9]).all()
    # Masked lane keeps producing the same next value.
    v2, _ = rand_parity_masked(s2, jnp.array([True, True]))
    assert float(v[1]) == float(v2[1])


def test_seed_from_pixel_wraps():
    s = seed_from_pixel(jnp.array([0xFFFFFFFF, 3], jnp.uint32),
                        jnp.array([[2.0, 5.0]]).astype(jnp.uint32))
    got = np.asarray(s)[0]
    assert got[0] == (0xFFFFFFFF * 2) % (1 << 32)
    assert got[1] == 15


def test_degenerate_stream():
    # Pixel column 0: seed.x = 0 — the reference's known quirk; the
    # stream still advances deterministically.
    state = jnp.array([[0, 12345]], jnp.uint32)
    v1, state = rand_parity(state)
    v2, state = rand_parity(state)
    assert float(v1[0]) != float(v2[0])


# ---- Threefry quality path (config.parity_rng=False) -----------------


def test_threefry_matches_jax_threefry2x32():
    """Our 20-round Threefry-2x32 is the same function JAX's PRNG uses
    (fixed key, counter words = the [., 2] state)."""
    from jax._src.prng import threefry_2x32

    from logipathtracer_tpu.ops.rng import _TF_KS, _threefry2x32

    key = jnp.array([_TF_KS[0], _TF_KS[1]], jnp.uint32)
    c = jnp.arange(64, dtype=jnp.uint32)
    ctr = jnp.stack([c * 7 + 3, c * 13 + 1])
    o0, o1 = _threefry2x32(ctr[0], ctr[1])
    ref = threefry_2x32(key, ctr.reshape(-1)).reshape(2, -1)
    np.testing.assert_array_equal(np.asarray(o0), np.asarray(ref[0]))
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(ref[1]))


def test_threefry_masked_advance_and_range():
    from logipathtracer_tpu.ops.rng import rand_threefry_masked

    st = jnp.stack([jnp.arange(8, dtype=jnp.uint32),
                    jnp.arange(8, dtype=jnp.uint32) * 3], -1)
    mask = jnp.array([True, False] * 4)
    v, st2 = rand_threefry_masked(st, mask)
    v = np.asarray(v)
    assert ((v >= 0) & (v < 1)).all()
    st, st2 = np.asarray(st), np.asarray(st2)
    np.testing.assert_array_equal(st2[1::2], st[1::2])      # held
    np.testing.assert_array_equal(st2[0::2], st[0::2] + 1)  # advanced


def test_threefry_no_degenerate_zero_streams():
    """The parity hash repeats one value forever when a seed word is 0
    (reference quirk); the quality path must not."""
    from logipathtracer_tpu.ops.rng import rand_threefry, seed_from_pixel

    ubo = jnp.asarray([48271, 16807], jnp.uint32)
    # pixel (0, y): parity seed x-word is 0 -> degenerate there.
    pix = jnp.asarray([[0.0, 5.0]], jnp.float32)
    st = seed_from_pixel(ubo, pix, parity=False)
    vals = []
    for _ in range(6):
        v, st = rand_threefry(st)
        vals.append(float(v[0]))
    assert len(set(vals)) == 6


def test_render_quality_rng_smoke(cornell_scene):
    """parity_rng=False renders a finite image statistically consistent
    with the parity path (same scene, same mean radiance ballpark)."""
    from logipathtracer_tpu.config import RenderConfig
    from logipathtracer_tpu.render.megakernel import render_sample

    base = RenderConfig(width=32, height=32, max_depth=4)
    seed = jnp.asarray([48271, 16807], jnp.uint32)
    cam = cornell_scene.cameras[0]
    imgs = {}
    for parity in (True, False):
        cfg = base.replace(parity_rng=parity)
        imgs[parity] = np.asarray(render_sample(
            cornell_scene, cfg, jnp.asarray(cam.world_matrix),
            jnp.float32(cam.yfov), seed))
    for img in imgs.values():
        assert np.isfinite(img).all() and img.min() >= 0
    assert not np.array_equal(imgs[True], imgs[False])
    assert abs(imgs[True].mean() - imgs[False].mean()) < 0.1 * (
        imgs[True].mean() + 1e-6) + 0.05
