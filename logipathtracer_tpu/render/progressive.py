"""Progressive render session.

The host-side runtime that replaces RendererPT/RendererRTX +
RendererCore's frame loop (src/RendererPT.cpp:574-612,
src/RendererCore.cpp:373-412): it owns the accumulation state, the
camera-dirty/reset protocol (src/RendererPT.cpp:575-581), per-sample
host seeds (:584-585), sample counting and throughput logging
(:594-607), and adds what the reference lacks (SURVEY.md §5.4):
checkpoint/resume of the accumulator to disk.

Camera motion helpers mirror the reference's key bindings
(src/Main.cpp:57-93): WASD/QE translate, IJKL/UO rotate, applied to the
camera node's local transform.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from logipathtracer_tpu.config import RenderConfig
from logipathtracer_tpu.film.image import tonemap
from logipathtracer_tpu.render.megakernel import accumulate_sample
from logipathtracer_tpu.scene.types import CameraState, SceneSoA
from logipathtracer_tpu.utils.log import get_logger

log = get_logger("progressive")


def _rot(axis: int, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[i, i] = c
    m[j, j] = c
    if axis == 1:
        m[i, j] = s
        m[j, i] = -s
    else:
        m[i, j] = -s
        m[j, i] = s
    return m


class ProgressiveRenderer:
    """Accumulating progressive renderer with the reference's
    accumulate/reset protocol."""

    def __init__(self, scene: SceneSoA, config: RenderConfig,
                 camera: CameraState | None = None, host_seed: int = 0,
                 accumulate_fn=None):
        if camera is None:
            if not scene.cameras:
                raise ValueError(
                    "scene has no camera; pass camera= explicitly "
                    "(reference errors the same way, "
                    "src/RendererRTX.cpp:53-55)")
            camera = scene.cameras[0]
        # Device-commit the scene ONCE.  compile_scene returns numpy
        # arrays; passing those to the jitted render entry points would
        # re-upload the whole SoA (~150 MB for the outside class) on
        # EVERY call.
        self.scene = jax.device_put(scene)
        self.config = config
        self.camera_world = np.asarray(camera.world_matrix, np.float32).copy()
        self.fov_y = float(camera.yfov)
        self._accumulate = accumulate_fn or accumulate_sample
        self._host_rng = np.random.default_rng(host_seed)
        h, w = config.render_height, config.render_width
        self.accum = jnp.zeros((h, w, 3), jnp.float32)
        self.sample_count = 0
        self.total_rays = 0.0
        self.last_iterations = 0
        self._dirty = True
        self._session_samples = 0   # rendered since last reset/restore
        self._session_rays = 0.0
        self._elapsed = 0.0
        # Persistent wavefront pool (cfg.pool_carryover): in-flight
        # paths survive across step() chunks; reads drain first.
        self._wf_state = None
        self._wf_rays_base = 0.0    # total_rays at pool creation
        # Deferred-stats mode (step_nosync): the per-step device scalar
        # fetches (rays counter, iteration count) each wait for the
        # device; interactive presents defer them and settle on the
        # next stats access instead.
        self._stats_dirty = False

    # -- lazy ray-counter bookkeeping ----------------------------------

    @property
    def total_rays(self) -> float:
        self._settle_rays()
        return self._total_rays

    @total_rays.setter
    def total_rays(self, v: float):
        self._total_rays = v

    @property
    def last_iterations(self) -> int:
        self._settle_rays()
        return self._last_iterations

    @last_iterations.setter
    def last_iterations(self, v: int):
        self._last_iterations = v

    def _settle_rays(self):
        """Fold the pending wavefront state's device counters into the
        host bookkeeping (one fetch, only when something is pending)."""
        if not getattr(self, "_stats_dirty", False):
            return
        self._stats_dirty = False
        st = self._wf_state
        if st is None:
            return
        rays_now = self._wf_rays_base + float(st["rays"])
        self._session_rays += rays_now - self._total_rays
        self._total_rays = rays_now
        self._last_iterations = int(st["it"])

    # -- camera (src/Main.cpp:57-93 semantics) -------------------------

    def reset(self):
        """Restart accumulation on the next step (the reference's
        camera-dirty path without moving the camera)."""
        self._dirty = True

    def set_camera(self, world_matrix, fov_y: float | None = None):
        self.camera_world = np.asarray(world_matrix, np.float32).copy()
        if fov_y is not None:
            self.fov_y = float(fov_y)
        self._dirty = True

    def translate(self, axis: int, amount: float):
        """Translate along a local camera axis (lsg translateX/Y/Z)."""
        delta = np.zeros(3, np.float32)
        delta[axis] = amount
        self.camera_world[:3, 3] += self.camera_world[:3, :3] @ delta
        self._dirty = True

    def rotate(self, axis: int, angle: float):
        """Rotate about a local camera axis (lsg rotateX/Y/Z)."""
        self.camera_world = (self.camera_world @ _rot(axis, angle)).astype(
            np.float32)
        self._dirty = True

    # -- progressive stepping ------------------------------------------

    def _use_wavefront(self) -> bool:
        # "auto" is the lockstep megakernel; the wavefront is opt-in.
        return self.config.renderer == "wavefront"

    def step(self, samples: int = 1):
        """Render ``samples`` more samples into the accumulator."""
        return self._step(samples, sync=True)

    def step_nosync(self, samples: int = 1):
        """step(), but defer the device ray/iteration counter fetches
        (each a host-device round trip) to the next stats access — the
        interactive present path dispatches the frame and fetches only
        pixels, letting the viewer pipeline frame N+1's compute against
        frame N's transfer.  Identical rendering; only WHEN the
        bookkeeping fetches happen changes."""
        return self._step(samples, sync=False)

    def _step(self, samples: int, sync: bool):
        cam = jnp.asarray(self.camera_world)
        fov = jnp.float32(self.fov_y)
        if self._use_wavefront():
            return self._step_wavefront(samples, cam, fov, sync=sync)
        for _ in range(samples):
            if self._dirty:
                # Reset protocol (src/RendererPT.cpp:575-581).
                self.sample_count = 0
                self.total_rays = 0.0
                self._session_samples = 0
                self._session_rays = 0.0
                self._elapsed = 0.0
            seed = jnp.asarray(
                self._host_rng.integers(1, 2 ** 31, 2, dtype=np.int64),
                jnp.uint32)
            t0 = time.perf_counter()
            self.accum, rays = self._accumulate(
                self.scene, self.config, cam, fov, seed, self.accum,
                jnp.asarray(self._dirty))
            jax.block_until_ready(self.accum)
            self._elapsed += time.perf_counter() - t0
            self.sample_count += 1
            self._session_samples += 1
            self.total_rays += float(rays)
            self._session_rays += float(rays)
            self._dirty = False
            if self.sample_count % 10 == 0:
                log.info("samples: %d", self.sample_count)
            if self.sample_count % 100 == 0:
                log.info("samples/s: %.3f  Mrays/s: %.2f",
                         self.samples_per_sec(), self.mrays_per_sec())
        return self

    def _step_wavefront(self, samples: int, cam, fov, sync: bool = True):
        """Batch step through the pooled wavefront renderer
        (render/wavefront.py): all ``samples`` samples share one ray
        pool, so dead lanes are recycled across sample boundaries.

        With cfg.pool_carryover (default) the pool also persists ACROSS
        step() calls: a chunk returns as soon as its work items are all
        injected, and the collapsing-occupancy drain tail is deferred to
        the first read (radiance/image/checkpoint) instead of being paid
        every chunk."""
        if self._dirty:
            self._settle_rays()  # discard cleanly: clear pending state
            self._stats_dirty = False
            self.sample_count = 0
            self.total_rays = 0.0
            self._session_samples = 0
            self._session_rays = 0.0
            self._elapsed = 0.0
            self.accum = jnp.zeros_like(self.accum)
            self._wf_state = None
        seeds = jnp.asarray(
            self._host_rng.integers(1, 2 ** 31, (samples, 2),
                                    dtype=np.int64), jnp.uint32)
        pool = min(self.config.pool_size,
                   self.config.render_width * self.config.render_height)
        t0 = time.perf_counter()
        if self.config.pool_carryover:
            from logipathtracer_tpu.render.wavefront import (
                wavefront_chunk, wavefront_pool_state)
            if self._wf_state is None:
                npix = self.config.render_width * self.config.render_height
                self._wf_state = wavefront_pool_state(min(pool, npix), npix)
                self._wf_rays_base = self.total_rays
            self._settle_rays()  # fold the previous chunk first
            self._wf_state = wavefront_chunk(
                self.scene, self.config, cam, fov, seeds, self._wf_state)
            self._stats_dirty = True
            if sync:
                self._settle_rays()
                jax.block_until_ready(self._wf_state["accum"])
            self._elapsed += time.perf_counter() - t0
        else:
            from logipathtracer_tpu.render.wavefront import render_wavefront
            batch, rays, iters = render_wavefront(
                self.scene, self.config, cam, fov, seeds, pool=pool)
            self.accum = self.accum + batch
            jax.block_until_ready(self.accum)
            self._elapsed += time.perf_counter() - t0
            self.total_rays += float(rays)
            self._session_rays += float(rays)
            self.last_iterations = int(iters)
        self.sample_count += samples
        self._session_samples += samples
        self._dirty = False
        if self.sample_count % 10 < samples:
            log.info("samples: %d  samples/s: %.3f  Mrays/s: %.2f",
                     self.sample_count, self.samples_per_sec(),
                     self.mrays_per_sec())
        return self

    def _drain_pool(self):
        """Complete all in-flight wavefront paths and fold the pool's
        accumulator into ``self.accum`` (exactness on read:
        every step()ed sample is fully accumulated afterwards)."""
        if self._wf_state is None:
            return
        from logipathtracer_tpu.render.wavefront import wavefront_drain
        t0 = time.perf_counter()
        st = wavefront_drain(self.scene, self.config, self._wf_state)
        h, w = self.config.render_height, self.config.render_width
        self.accum = self.accum + st["accum"].reshape(h, w, 3)
        jax.block_until_ready(self.accum)
        st = dict(st, accum=jnp.zeros_like(st["accum"]))
        self._wf_state = st
        # Counter bookkeeping rides the lazy settle path (the drained
        # state's cumulative rays counter), so the interactive present
        # never pays a scalar round trip here.
        self._stats_dirty = True
        self._elapsed += time.perf_counter() - t0

    def samples_per_sec(self) -> float:
        return self._session_samples / max(self._elapsed, 1e-9)

    def mrays_per_sec(self) -> float:
        self._settle_rays()
        return self._session_rays / max(self._elapsed, 1e-9) / 1e6

    # -- output ---------------------------------------------------------

    def image(self) -> jnp.ndarray:
        """Tonemapped display image (tex_to_quad.frag transform).

        With render_scale > 1 the supersampled accumulation buffer is
        box-filtered down to the window size before tonemapping (the
        reference minifies via the sampler's bilinear filter,
        src/RendererPT.cpp:254-255)."""
        self._drain_pool()
        accum = self.accum
        s = self.config.render_scale
        if s > 1:
            h, w = self.config.height, self.config.width
            accum = accum.reshape(h, s, w, s, 3).mean(axis=(1, 3))
        return tonemap(accum, max(self.sample_count, 1),
                       exposure=self.config.exposure,
                       gamma=self.config.gamma)

    def image_u8(self) -> jnp.ndarray:
        """Display frame as device-side uint8 RGBA [H, W, 4].

        The viewer present path: quantizing on device fetches 4 bytes/
        pixel instead of image()'s 12 (f32 RGB) and skips the host-side
        numpy clip/cast entirely."""
        img = self.image()
        u8 = jnp.clip(img * 255.0 + 0.5, 0, 255).astype(jnp.uint8)
        return jnp.concatenate(
            [u8, jnp.full(u8.shape[:2] + (1,), 255, jnp.uint8)], axis=-1)

    def radiance(self) -> np.ndarray:
        """Mean radiance (pre-tonemap; the RMSE-metric quantity)."""
        self._drain_pool()
        return np.asarray(self.accum) / max(self.sample_count, 1)

    # -- checkpoint / resume (SURVEY.md §5.4) ----------------------------

    @staticmethod
    def checkpoint_path(path: str) -> str:
        """np.savez appends '.npz' to extension-less paths; normalize so
        checkpoint/restore/exists all name the same file."""
        return path if path.endswith(".npz") else path + ".npz"

    def checkpoint(self, path: str):
        path = self.checkpoint_path(path)
        self._drain_pool()
        st = self._host_rng.bit_generator.state["state"]
        np.savez(path, accum=np.asarray(self.accum),
                 sample_count=self.sample_count,
                 total_rays=self.total_rays,
                 camera_world=self.camera_world, fov_y=self.fov_y,
                 # PCG64 state words are 128-bit ints: store as strings.
                 rng_state=np.str_(str(st["state"])),
                 rng_inc=np.str_(str(st["inc"])))

    def restore(self, path: str):
        data = np.load(self.checkpoint_path(path))
        self.accum = jnp.asarray(data["accum"])
        self.sample_count = int(data["sample_count"])
        self.total_rays = float(data["total_rays"])
        self.camera_world = data["camera_world"].astype(np.float32)
        self.fov_y = float(data["fov_y"])
        st = self._host_rng.bit_generator.state
        st["state"]["state"] = int(str(data["rng_state"]))
        st["state"]["inc"] = int(str(data["rng_inc"]))
        self._host_rng.bit_generator.state = st
        self._wf_state = None
        self._dirty = False
        self._session_samples = 0
        self._session_rays = 0.0
        self._elapsed = 0.0
        return self
