"""Multi-chip parallel rendering over a jax.sharding.Mesh.

The reference is strictly single-GPU (SURVEY.md §2.4: no multi-device
code of any kind); distribution is introduced fresh here:

  * 2-D device mesh ``(samples, tiles)``:
      - the ``samples`` axis is sample-parallel (each slice renders the
        same pixels with different per-sample host seeds — the
        progressive loop unrolled across chips; zero communication
        during rendering, one reduction when the image is fetched);
      - the ``tiles`` axis is tile-parallel (disjoint row slabs of the
        frame; zero communication, concatenation at fetch).
  * the scene SoA is replicated (cornell ~1.6 MB ≪ device memory);
  * collectives: a single sum over ``samples`` inside the image fetch,
    which XLA lowers to a cross-device reduce.  No custom comm layer is
    warranted for an embarrassingly parallel renderer (SURVEY.md §5.8).

Pixel RNG streams are keyed by absolute pixel coordinates and the
per-sample ubo seed, so every (sample, tile) shard computes exactly the
pixels a single-device progressive run would — sharding changes wall
clock, not radiance.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from logipathtracer_tpu.config import RenderConfig
from logipathtracer_tpu.render.megakernel import render_rows
from logipathtracer_tpu.render.progressive import ProgressiveRenderer
from logipathtracer_tpu.utils.log import get_logger

log = get_logger("mesh")


def make_mesh(devices=None, samples: int | None = None,
              tiles: int | None = None) -> Mesh:
    """Build a (samples, tiles) mesh from the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if samples is None and tiles is None:
        tiles = 1
        samples = n
    elif samples is None:
        samples = n // tiles
    elif tiles is None:
        tiles = n // samples
    assert samples * tiles == n, (samples, tiles, n)
    arr = np.array(devices).reshape(samples, tiles)
    return Mesh(arr, ("samples", "tiles"))


class MeshRenderer(ProgressiveRenderer):
    """Progressive accumulation sharded over a 2-D mesh — the same
    session protocol as ProgressiveRenderer (camera dirty/reset,
    throughput metrics, checkpoint/resume), scaled across chips.

    State: accum [S, H, W, 3] with the S axis sharded over ``samples``
    and H over ``tiles``.  Every mesh round renders S more samples (one
    per sample-slice)."""

    def __init__(self, scene, config: RenderConfig, mesh: Mesh,
                 camera=None, host_seed: int = 0):
        self.mesh = mesh
        s = mesh.shape["samples"]
        t = mesh.shape["tiles"]
        h, w = config.render_height, config.render_width
        assert h % t == 0, f"height {h} not divisible by tile axis {t}"
        super().__init__(scene, config, camera=camera, host_seed=host_seed)
        self._sharding = NamedSharding(mesh, P("samples", "tiles"))
        # Replicate the SoA across the mesh ONCE (it arrives on the
        # default device from ProgressiveRenderer's device_put);
        # otherwise every _mesh_step call reshards it from one device.
        self.scene = jax.device_put(self.scene, NamedSharding(mesh, P()))
        self.accum = jax.device_put(jnp.zeros((s, h, w, 3), jnp.float32),
                                    self._sharding)
        self._mesh_step = _build_step(mesh, config, scene)

    def _reset_session(self):
        self.sample_count = 0
        self.total_rays = 0.0
        self._session_samples = 0
        self._session_rays = 0.0
        self._elapsed = 0.0

    def step(self, samples: int | None = None):
        """Render at least ``samples`` more samples (default: one mesh
        round = S samples, the sample-axis width)."""
        import time

        s = self.mesh.shape["samples"]
        rounds = 1 if samples is None else -(-samples // s)
        for _ in range(rounds):
            if self._dirty:
                # Reset protocol (src/RendererPT.cpp:575-581).
                self._reset_session()
            seeds = jnp.asarray(
                self._host_rng.integers(1, 2 ** 31, (s, 2),
                                        dtype=np.int64), jnp.uint32)
            t0 = time.perf_counter()
            self.accum, rays = self._mesh_step(
                self.scene, jnp.asarray(self.camera_world),
                jnp.float32(self.fov_y), seeds, self.accum,
                jnp.asarray(self._dirty or self.sample_count == 0))
            jax.block_until_ready(self.accum)
            self._elapsed += time.perf_counter() - t0
            r = float(np.asarray(rays).sum())
            self.sample_count += s
            self._session_samples += s
            self.total_rays += r
            self._session_rays += r
            self._dirty = False
            if self.sample_count % (10 * s) < s:
                log.info("samples: %d  samples/s: %.3f  Mrays/s: %.2f",
                         self.sample_count, self.samples_per_sec(),
                         self.mrays_per_sec())
        return self

    def radiance(self) -> np.ndarray:
        """Mean radiance [H, W, 3]: psum over the samples axis."""
        total = jnp.sum(self.accum, axis=0)  # GSPMD inserts the reduce
        return np.asarray(total) / max(self.sample_count, 1)

    def image(self):
        """Tonemapped display image (see ProgressiveRenderer.image)."""
        from logipathtracer_tpu.film.image import tonemap

        accum = jnp.sum(self.accum, axis=0)
        sc = self.config.render_scale
        if sc > 1:
            h, w = self.config.height, self.config.width
            accum = accum.reshape(h, sc, w, sc, 3).mean(axis=(1, 3))
        return tonemap(accum, max(self.sample_count, 1),
                       exposure=self.config.exposure,
                       gamma=self.config.gamma)

    # -- checkpoint / resume: mesh-shape independent --------------------
    # The accumulator is additive, so the checkpoint stores the sample-
    # axis SUM [H, W, 3]; restore places it in sample-slice 0 (zeros
    # elsewhere), valid for any mesh shape — a checkpoint taken on an
    # 8-chip mesh resumes on 4 chips and vice versa.

    def checkpoint(self, path: str):
        path = self.checkpoint_path(path)
        st = self._host_rng.bit_generator.state["state"]
        np.savez(path, accum=np.asarray(jnp.sum(self.accum, axis=0)),
                 sample_count=self.sample_count,
                 total_rays=self.total_rays,
                 camera_world=self.camera_world, fov_y=self.fov_y,
                 rng_state=np.str_(str(st["state"])),
                 rng_inc=np.str_(str(st["inc"])))

    def restore(self, path: str):
        data = np.load(self.checkpoint_path(path))
        host = np.zeros(self.accum.shape, np.float32)
        host[0] = data["accum"]
        self.accum = jax.device_put(host, self._sharding)
        self.sample_count = int(data["sample_count"])
        self.total_rays = float(data["total_rays"])
        self.camera_world = data["camera_world"].astype(np.float32)
        self.fov_y = float(data["fov_y"])
        st = self._host_rng.bit_generator.state
        st["state"]["state"] = int(str(data["rng_state"]))
        st["state"]["inc"] = int(str(data["rng_inc"]))
        self._host_rng.bit_generator.state = st
        self._dirty = False
        self._session_samples = 0
        self._session_rays = 0.0
        self._elapsed = 0.0
        return self


def _build_step(mesh: Mesh, cfg: RenderConfig, scene):
    """Jitted sharded step: (scene, cam, fov, seeds[S,2],
    accum[S,H,W,3], reset) -> (accum', rays).

    Each (sample, tile) shard renders its row slab — through the pooled
    wavefront when the config selects it (render_wavefront's y0/rows
    slab support keys RNG streams on absolute pixel coordinates), else
    through the lockstep megakernel."""
    t = mesh.shape["tiles"]
    rows_local = cfg.render_height // t
    use_wavefront = cfg.renderer == "wavefront"

    scene_specs = jax.tree.map(lambda _: P(), scene)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(scene_specs, P(), P(), P("samples"),
                       P("samples", "tiles"), P()),
             out_specs=(P("samples", "tiles"), P("samples")),
             check_vma=False)
    def sharded(scene, cam, fov, seeds, accum, reset):
        tile = jax.lax.axis_index("tiles")
        y0 = (tile * rows_local).astype(jnp.int32)
        if use_wavefront:
            from logipathtracer_tpu.render.wavefront import render_wavefront
            img, rays, _ = render_wavefront.__wrapped__(
                scene, cfg, cam, fov, seeds,
                pool=min(cfg.pool_size,
                         seeds.shape[0] * rows_local * cfg.render_width),
                y0=y0, rows=rows_local)
        else:
            img, rays = render_rows(scene, cfg, cam, fov, seeds[0], y0,
                                    rows_local)
        new = jnp.where(reset, img[None], accum + img[None])
        return new, rays[None]

    return jax.jit(sharded, donate_argnums=(4,))
