"""The traversal choice and the CUDA kernel's wrapper.

The kernel itself (native/bvh_traverse.cu) has no CPU form, so the CPU
tests pin everything around it: the XLA walk it is compared with (its
t_max / any_hit contract against brute force), the operands and result
shapes the FFI call is staged with, which walk each platform lowers,
and the errors raised instead of a fallback.  The ``gpu`` tests compare
the kernel with the walk on a card (LPT_GPU_TESTS=1 pytest -m gpu);
chip_smoke.py runs the same comparison at 1920x1080.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from logipathtracer_tpu.config import RenderConfig
from logipathtracer_tpu.ops import traverse_cuda
from logipathtracer_tpu.ops.camera import generate_ray
from logipathtracer_tpu.ops.intersect import INF
from logipathtracer_tpu.ops.rng import seed_from_pixel
from logipathtracer_tpu.ops.traverse import (TRAVERSALS,
                                             intersect_bruteforce,
                                             intersect_scene,
                                             select_traversal)


def _random_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform([-1, 0, -1], [1, 2, 1], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _camera_rays(scene, w, h, seed=(12345, 67890)):
    cam = scene.cameras[0]
    ys, xs = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    pix = jnp.stack([xs, ys], -1).reshape(-1, 2)
    s = seed_from_pixel(jnp.asarray(seed, jnp.uint32), pix)
    o, d, _ = generate_ray(jnp.asarray(cam.world_matrix), cam.yfov, pix,
                           (w, h), s)
    return o, d


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_tmax_matches_bruteforce(cornell_scene, any_hit):
    """Shadow-query form of the walk: with t_max, the walk reports a hit
    exactly where brute force finds one closer than t_max (the only
    thing NEE reads), and that hit is the closest one."""
    o, d = _random_rays(256, seed=5)
    tb, ob, rb = intersect_bruteforce(cornell_scene, o, d)
    t_max = jnp.asarray(np.random.default_rng(6).uniform(
        0.05, 2.0, 256).astype(np.float32))
    tw, ow, rw = jax.jit(
        lambda s, o, d, tm: intersect_scene(s, o, d, t_max=tm,
                                            any_hit=any_hit))(
        cornell_scene, o, d, t_max)
    tb, tw = np.asarray(tb), np.asarray(tw)
    blocked_b = tb < np.asarray(t_max)
    blocked_w = tw < np.asarray(t_max)
    # Rays whose closest hit sits within float noise of t_max may
    # resolve either way.
    edge = np.abs(tb - np.asarray(t_max)) <= 1e-5 * np.abs(tb)
    assert (blocked_b == blocked_w)[~edge].all()
    hit = blocked_w & ~edge
    np.testing.assert_allclose(tw[hit], tb[hit], rtol=1e-5)
    assert (tw[~blocked_w] == np.float32(INF)).all()
    assert (np.asarray(rw)[~blocked_w] == -1).all()
    assert (np.asarray(ow)[~blocked_w] == -1).all()


def test_kernel_operands_shapes_and_dtypes(cornell_scene):
    """The eight FFI operands: contiguous [R, 3] rays, an INF-filled
    t_max when none is given, the fused nodes, the object inverses
    padded with an identity slot 0, and the triangle vertices."""
    o, d = _random_rays(37, seed=1)
    ops = traverse_cuda.kernel_operands(cornell_scene, o, d)
    shapes = [x.shape for x in ops]
    m = cornell_scene.fused_min.shape[0]
    nobj = cornell_scene.num_objects
    assert shapes == [(37, 3), (37, 3), (37,), (m, 3), (m, 3), (m, 4),
                      (nobj + 1, 12), cornell_scene.vtx_pos.shape]
    assert [x.dtype for x in ops] == [jnp.float32] * 5 + [jnp.int32] + \
        [jnp.float32] * 2
    assert (np.asarray(ops[2]) == np.float32(INF)).all()
    inv = np.asarray(ops[6]).reshape(-1, 3, 4)
    np.testing.assert_array_equal(inv[0], np.eye(3, 4))
    np.testing.assert_array_equal(
        inv[1:], np.asarray(cornell_scene.obj_world_inv)[:, :3, :4])
    tm = traverse_cuda.kernel_operands(cornell_scene, o, d,
                                       t_max=jnp.float32(2.5))[2]
    assert tm.shape == (37,) and (np.asarray(tm) == 2.5).all()


@pytest.mark.parametrize("rays", [1, 1000])
def test_kernel_call_result_shapes(cornell_scene, rays):
    o, d = _random_rays(rays, seed=2)
    out = jax.eval_shape(
        lambda o, d: traverse_cuda.call_kernel(cornell_scene, o, d,
                                               t_max=jnp.ones(rays),
                                               any_hit=True), o, d)
    assert [(x.shape, x.dtype) for x in out] == [
        ((rays,), jnp.float32), ((rays,), jnp.int32), ((rays,), jnp.int32)]


def test_kernel_call_rejects_deep_scene(cornell_scene):
    deep = jax.tree_util.tree_map(lambda x: x, cornell_scene)
    deep.max_stack = traverse_cuda.MAX_STACK + 1
    o, d = _random_rays(4, seed=3)
    with pytest.raises(ValueError, match="stack"):
        traverse_cuda.call_kernel(deep, o, d)


@pytest.mark.parametrize("platform,kernel", [("cuda", True),
                                             ("cpu", False)])
def test_auto_lowers_kernel_only_for_cuda(cornell_scene, platform,
                                          kernel):
    """intersect="auto" is decided at lowering: a program lowered for a
    CUDA device calls the kernel and carries no while-loop walk; one
    lowered for the CPU runs the walk and never names the kernel."""
    o, d = _random_rays(8, seed=4)
    isect = select_traversal("auto")
    lowered = jax.jit(lambda o, d: isect(cornell_scene, o, d)).trace(
        o, d).lower(lowering_platforms=(platform,))
    text = lowered.as_text()
    assert (traverse_cuda.TARGET in text) == kernel
    assert ("stablehlo.while" in text) == (not kernel)


def test_auto_runs_walk_on_cpu(no_cuda_device, cornell_scene):
    o, d = _camera_rays(cornell_scene, 8, 8)
    auto = jax.jit(lambda o, d: select_traversal("auto")(cornell_scene,
                                                         o, d))(o, d)
    walk = jax.jit(lambda o, d: intersect_scene(cornell_scene, o, d))(o, d)
    for a, b in zip(auto, walk):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_select_traversal_modes():
    assert select_traversal("bvh") is intersect_scene
    assert select_traversal("cuda") is traverse_cuda.intersect_scene_cuda
    assert set(TRAVERSALS) == {"auto", "bvh", "cuda"}
    with pytest.raises(ValueError, match="unknown intersect mode"):
        select_traversal("compact")


def test_cuda_mode_raises_without_device(no_cuda_device, cornell_scene):
    """Asking for the kernel where JAX has no CUDA device is an error,
    never a quiet walk."""
    from logipathtracer_tpu.render.megakernel import render_sample
    o, d = _random_rays(4, seed=7)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        traverse_cuda.intersect_scene_cuda(cornell_scene, o, d)
    cfg = RenderConfig(width=8, height=8, max_depth=2, intersect="cuda")
    cam = cornell_scene.cameras[0]
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        render_sample(cornell_scene, cfg, jnp.asarray(cam.world_matrix),
                      jnp.float32(cam.yfov), jnp.asarray([1, 2],
                                                         jnp.uint32))


def test_build_failure_raises(monkeypatch, tmp_path):
    """A library that cannot be built raises; nothing falls back."""
    monkeypatch.setattr(traverse_cuda, "_SO", str(tmp_path / "lib.so"))
    monkeypatch.setattr(traverse_cuda, "_nvcc",
                        lambda: str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        traverse_cuda.build()
    assert not (tmp_path / "lib.so").exists()


def test_build_command_targets_hopper():
    cmd = traverse_cuda.build_command("out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert jax.ffi.include_dir() in cmd
    assert cmd[-1].endswith("native/bvh_traverse.cu")


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_matches_walk_on_card(cuda_device, cornell_scene, any_hit):
    """Kernel against the walk on primary and random rays, on the card:
    t within float noise, and any (obj, tri) difference a t tie."""
    with jax.default_device(cuda_device):
        o, d = _camera_rays(cornell_scene, 96, 64)
        ro, rd = _random_rays(4096, seed=8)
        o, d = jnp.concatenate([o, ro]), jnp.concatenate([d, rd])
        tm = jnp.full((o.shape[0],), 1.5) if any_hit else None
        k = jax.jit(lambda o, d: traverse_cuda.intersect_scene_cuda(
            cornell_scene, o, d, t_max=tm, any_hit=any_hit))(o, d)
        w = jax.jit(lambda o, d: intersect_scene(
            cornell_scene, o, d, t_max=tm))(o, d)
    tk, ok, rk = (np.asarray(x) for x in k)
    tw, ow, rw = (np.asarray(x) for x in w)
    if any_hit:
        np.testing.assert_array_equal(tk < 1.5, tw < 1.5)
        return
    np.testing.assert_allclose(tk, tw, rtol=1e-5, atol=1e-7)
    diff = (ok != ow) | (rk != rw)
    assert (np.abs(tk - tw) <= 1e-5 * np.abs(tw))[diff].all()
