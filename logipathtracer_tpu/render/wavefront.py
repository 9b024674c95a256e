"""Pooled wavefront renderer.

A restructuring of the reference's megakernel (SURVEY.md §7 step 3,
BASELINE.json config 4): a persistent pool of rays where

  * every iteration REGENERATES dead lanes with fresh (pixel, sample)
    work items — the stream-compaction equivalent that keeps all lanes
    busy instead of carrying dead lanes to the end of the frame like
    the lockstep megakernel does,
  * live rays are SORTED each iteration by direction octant + origin
    Morton code, so neighbouring lanes trace coherent rays even for
    deep bounce rays,
  * terminated paths scatter-add their radiance into the accumulation
    buffer keyed by pixel id.  On a GPU the scatter-add is atomic and
    its order changes from run to run, so accumulation there is not
    bit-reproducible.

Scheduling knobs (both preserve per-work-item radiance exactly — they
only change WHEN maintenance passes run):
  * cfg.sort_every = k: sort/flush on every k-th iteration only,
  * cfg.lazy_regen = k: refill free lanes only when free*k >= pool (or
    when the remaining work fits) — regen cost is pool-proportional,
    not free-count-proportional, so batching it saves whole passes
    while parked dead lanes stay near-free in intersect/shade.

Two driving modes share one loop body:

  * ``render_wavefront`` — single shot: fill, trace, and fully drain
    the pool for S samples (the form the image-invariance tests and
    the mesh shards use).
  * ``wavefront_chunk`` / ``wavefront_drain`` — the progressive
    session's carryover form: a chunk stops as soon as all its work
    items are injected, leaving in-flight paths in the pool for the
    next chunk.  Draining at collapsing occupancy (~max_depth
    iterations of full O(pool) maintenance for a trickle of rays) is
    then paid once per READ of the accumulator instead of once per
    chunk.  Per-(pixel, sample) radiance is unchanged — only WHEN a
    path's contribution is flushed moves.

Per-(pixel, sample) RNG streams are identical to the megakernel's
(seed = ubo_seed[sample] * pixel, drawn in the same order along each
path), so each work item's radiance matches the sequential renderer up
to intersect tie-breaks; only the accumulation order differs (ULPs).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from logipathtracer_tpu.config import RenderConfig
from logipathtracer_tpu.ops.camera import generate_ray
from logipathtracer_tpu.ops.rng import get_rand, seed_from_pixel
from logipathtracer_tpu.ops.traverse import select_traversal
from logipathtracer_tpu.render.megakernel import ray_sort_key, shade_step

_I32_MAX = jnp.iinfo(jnp.int32).max

# Smallest sliced-regen window (perf knob only — any window covering
# the free region is exact; tests shrink it to exercise the ladder on
# CPU-sized pools).
REGEN_FLOOR = 1 << 15

# Smallest sliced trace+shade window (the occupancy ladder): windows
# below this aren't worth the extra compiled shapes, and CPU test
# pools (<= this) skip the ladder entirely unless a test shrinks it.
TRACE_FLOOR = 1 << 17


def _bitcast_f(x):
    return jax.lax.bitcast_convert_type(x, jnp.float32)


def _bitcast_i(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _make_pix_coords(w: int, y0):
    def pix_coords(pixi):
        px = pixi % w
        py = pixi // w
        return px.astype(jnp.float32), (py + y0).astype(jnp.float32)
    return pix_coords


def wavefront_pool_state(p: int, npix: int):
    """Fresh pool state: every lane free, zero accumulation."""
    return dict(
        origin=jnp.zeros((p, 3)),
        direction=jnp.zeros((p, 3)).at[:, 2].set(1.0),
        mask=jnp.ones((p, 3)),
        acc=jnp.zeros((p, 3)),
        seed=jnp.zeros((p, 2), jnp.uint32),
        alive=jnp.zeros((p,), bool),
        pending=jnp.zeros((p,), bool),
        prev_pdf=jnp.zeros((p,), jnp.float32),
        bounce=jnp.zeros((p,), jnp.int32),
        pixid=jnp.zeros((p,), jnp.int32),
        next_work=jnp.zeros((), jnp.int32),
        accum=jnp.zeros((npix, 3)),
        rays=jnp.zeros((), jnp.float32),
        it=jnp.zeros((), jnp.int32),
    )


def _make_body(scene, cfg: RenderConfig, cam_world, fov_y, ubo_seeds,
               p: int, npix: int, total, flush_cap: int, pix_coords,
               drain: bool = False):
    """One wavefront iteration: sort/flush -> regen -> park -> intersect
    -> shade.  ``drain=True`` statically removes the regen stage (no new
    work is injected while the pool empties)."""
    h, w = cfg.render_height, cfg.render_width
    isect = select_traversal(cfg.intersect)

    def body(st):
        origin, direction = st["origin"], st["direction"]
        mask, acc, seed = st["mask"], st["acc"], st["seed"]
        alive, pending = st["alive"], st["pending"]
        prev_pdf = st["prev_pdf"]
        bounce, pixid = st["bounce"], st["pixid"]
        next_work, accum = st["next_work"], st["accum"]

        # ---- sort: alive rays by coherence key; free lanes next;
        # retired lanes last — then flush the retired tail slice -------
        def sort_and_flush(args):
            (origin, direction, mask, acc, seed, alive, pending,
             prev_pdf, bounce, pixid, accum) = args
            retired = pending & ~alive
            # Alive keys are 18-bit (octant<<15 | morton); free lanes
            # sort just above them, and retired lanes sort last KEYED
            # BY PIXID — the flush tail then has ascending scatter
            # indices (indices_are_sorted below).
            key = jnp.where(
                alive, ray_sort_key(scene, origin, direction),
                jnp.where(retired, (1 << 18) + 1 + pixid, 1 << 18))
            # bounce, alive, pending share one int row — the permuted
            # payload is the cost, so pack tight; prev_pdf rides only
            # when NEE needs it (static).  When pixid also fits (24
            # bits; frames up to 16M pixels) it joins the same row:
            # each payload operand of the variadic sort is a full
            # gather pass, so one fewer column is a direct saving.
            pack_pix = npix < (1 << 24) and cfg.max_depth < 64
            if pack_pix:
                flags = (pixid | (bounce << 24)
                         | (alive.astype(jnp.int32) << 30)
                         | (pending.astype(jnp.int32) << 31))
            else:
                flags = (bounce | (alive.astype(jnp.int32) << 16)
                         | (pending.astype(jnp.int32) << 17))
            if cfg.sort_variadic:
                # ONE variadic lax.sort carries every state column as
                # a payload operand; it skips the [P, 17] packed concat
                # materialization of the gather form below.  lax.sort
                # is stable, so the permutation is bit-identical to
                # the gather form's.
                # Int payloads ride as f32 bitcasts (sort never
                # compares payloads, so arbitrary bit patterns are
                # safe).
                seedf = _bitcast_f(seed.astype(jnp.int32))
                ops = [key,
                       origin[:, 0], origin[:, 1], origin[:, 2],
                       direction[:, 0], direction[:, 1],
                       direction[:, 2],
                       mask[:, 0], mask[:, 1], mask[:, 2],
                       acc[:, 0], acc[:, 1], acc[:, 2],
                       seedf[:, 0], seedf[:, 1],
                       _bitcast_f(flags)]
                if not pack_pix:
                    ops.append(_bitcast_f(pixid))
                if cfg.nee:
                    ops.append(prev_pdf)
                out = jax.lax.sort(tuple(ops), num_keys=1)
                origin = jnp.stack(out[1:4], axis=1)
                direction = jnp.stack(out[4:7], axis=1)
                mask = jnp.stack(out[7:10], axis=1)
                acc = jnp.stack(out[10:13], axis=1)
                seed = _bitcast_i(jnp.stack(out[13:15], axis=1)).astype(jnp.uint32)
                flags = _bitcast_i(out[15])
                pixid = (flags & 0xFFFFFF if pack_pix
                         else _bitcast_i(out[16]))
                prev_pdf = (out[-1] if cfg.nee
                            else jnp.zeros((p,), jnp.float32))
            else:
                # pack_pix: pixid lives in flags bits 0:24 — no
                # separate payload column (same saving as the variadic
                # path; ADVICE r3 flagged the redundant copy).
                cols = [origin, direction, mask, acc,
                        _bitcast_f(seed.astype(jnp.int32)),
                        _bitcast_f(flags)[:, None]]
                if not pack_pix:
                    cols.append(_bitcast_f(pixid)[:, None])
                if cfg.nee:
                    cols.append(prev_pdf[:, None])
                packed = jnp.concatenate(cols, axis=1)  # [P, 15..17]
                _, perm = jax.lax.sort_key_val(
                    key, jnp.arange(p, dtype=jnp.int32))
                packed = jnp.take(packed, perm, axis=0)  # one wide gather
                origin = packed[:, 0:3]
                direction = packed[:, 3:6]
                mask = packed[:, 6:9]
                acc = packed[:, 9:12]
                seed = _bitcast_i(packed[:, 12:14]).astype(jnp.uint32)
                flags = _bitcast_i(packed[:, 14])
                pixid = (flags & 0xFFFFFF if pack_pix
                         else _bitcast_i(packed[:, 15]))
                prev_pdf = (packed[:, -1] if cfg.nee
                            else jnp.zeros((p,), jnp.float32))
            if pack_pix:
                bounce = (flags >> 24) & 0x3F
                alive = (flags >> 30) & 1 != 0
                pending = (flags >> 31) & 1 != 0
            else:
                bounce = flags & 0xFFFF
                alive = (flags >> 16) & 1 != 0
                pending = (flags >> 17) & 1 != 0

            # ---- flush finished paths (a contiguous tail post-sort) --
            # The retired lanes are exactly the LAST n_flush rows
            # (pixid-keyed, so the tail's scatter indices ascend).
            flush = pending & ~alive
            n_flush = jnp.sum(flush.astype(jnp.int32))

            def flush_tail(cap_k):
                def f(accum):
                    sl = slice(p - cap_k, p)
                    # Non-retired rows are a PREFIX of the slice (their
                    # keys sort below every retired key); pointing them
                    # at row 0 with a zero addend keeps the index array
                    # ascending, so the sorted-scatter promise holds.
                    idx = jnp.where(flush[sl], pixid[sl], 0)
                    vals = jnp.where(flush[sl, None], acc[sl], 0.0)
                    return accum.at[idx].add(vals, indices_are_sorted=True)
                return f

            def flush_full(accum):
                vals = jnp.where(flush[:, None], acc, 0.0)
                return accum.at[pixid].add(vals)

            # Cond ladder: smallest power-of-two tail slice covering
            # the retired rows (scatter cost is per-row).
            caps = [c for c in
                    (flush_cap // 4, flush_cap // 2, flush_cap)
                    if 0 < c < p]
            accum_fn = flush_full
            for c in reversed(caps):
                accum_fn = (
                    lambda accum, c=c, nxt=accum_fn: jax.lax.cond(
                        n_flush <= c, flush_tail(c), nxt, accum))
            accum = accum_fn(accum)
            # Every branch (incl. the full fallback) covers all retired
            # rows, so the pending clear is unconditional.
            pending = pending & ~flush
            return (origin, direction, mask, acc, seed, alive, pending,
                    prev_pdf, bounce, pixid, accum)

        args = (origin, direction, mask, acc, seed, alive, pending,
                prev_pdf, bounce, pixid, accum)
        if cfg.sort_rays:
            if cfg.sort_every > 1:
                args = jax.lax.cond(st["it"] % cfg.sort_every == 0,
                                    sort_and_flush, lambda a: a, args)
            else:
                args = sort_and_flush(args)
            (origin, direction, mask, acc, seed, alive, pending,
             prev_pdf, bounce, pixid, accum) = args
        else:
            flush = pending & ~alive
            vals = jnp.where(flush[:, None], acc, 0.0)
            accum = accum.at[pixid].add(vals)
            pending = pending & ~flush

        # ---- regenerate free lanes with new work items -----------------
        def regen_rows(sub, next_work):
            """Regen math on any contiguous row package; ``sub`` is a
            dict of state slices (full pool or the free-region slice)."""
            free = ~sub["alive"] & ~sub["pending"]
            rank = jnp.cumsum(free.astype(jnp.int32)) - 1
            item = next_work + rank
            valid = free & (item < total)
            sampi = jnp.where(valid, item // npix, 0)
            pixi = jnp.where(valid, item % npix, 0)
            px, py = pix_coords(pixi)
            useed = jnp.take(ubo_seeds, sampi, axis=0)
            nseed = seed_from_pixel(useed, jnp.stack([px, py], -1),
                                    parity=cfg.parity_rng)
            o_new, d_new, nseed = generate_ray(
                cam_world, fov_y, jnp.stack([px, py], -1), (w, h), nseed,
                active=valid, rand=get_rand(cfg.parity_rng))
            vx = valid[:, None]
            out = dict(
                origin=jnp.where(vx, o_new, sub["origin"]),
                direction=jnp.where(vx, d_new, sub["direction"]),
                mask=jnp.where(vx, 1.0, sub["mask"]),
                acc=jnp.where(vx, 0.0, sub["acc"]),
                seed=jnp.where(vx, nseed, sub["seed"]),
                bounce=jnp.where(valid, 0, sub["bounce"]),
                pixid=jnp.where(valid, pixi, sub["pixid"]),
                alive=sub["alive"] | valid,
                pending=sub["pending"] | valid,
                prev_pdf=jnp.where(valid, 0.0, sub["prev_pdf"]))
            next_work = jnp.minimum(
                next_work + jnp.sum(free.astype(jnp.int32)), total)
            return out, next_work

        _KEYS = ("origin", "direction", "mask", "acc", "seed", "alive",
                 "pending", "prev_pdf", "bounce", "pixid")

        def regen(args):
            st = dict(zip(_KEYS, args[:10]))
            next_work = args[10]
            out, next_work = regen_rows(st, next_work)
            return tuple(out[k] for k in _KEYS) + (next_work,)

        # Post-sort, ALL free lanes are one contiguous region
        # [n_alive, P): the sort orders alive < free < retired and the
        # flush just freed the retired tail.  Steady-state regen then
        # only needs a CAP-row window there instead of full-pool
        # cumsum + selects; a cond ladder picks the smallest window
        # covering the free region; frame-warmup iterations take the
        # full-pool path.
        regen_caps = sorted({min(p, max(c, REGEN_FLOOR))
                             for c in (p // 16, p // 8, p // 4, p // 2)})

        def regen_sliced(cap_k):
            def f(args):
                st = dict(zip(_KEYS, args[:10]))
                next_work = args[10]
                n_alive = jnp.sum(st["alive"].astype(jnp.int32))
                start = jnp.minimum(n_alive, p - cap_k)
                sub = {k: jax.lax.dynamic_slice_in_dim(
                    st[k], start, cap_k, axis=0) for k in _KEYS}
                out, next_work = regen_rows(sub, next_work)
                st = {k: jax.lax.dynamic_update_slice_in_dim(
                    st[k], out[k], start, axis=0) for k in _KEYS}
                return tuple(st[k] for k in _KEYS) + (next_work,)
            return f

        if not drain:
            args = (origin, direction, mask, acc, seed, alive, pending,
                    prev_pdf, bounce, pixid, next_work)
            free = ~alive & ~pending
            n_free = jnp.sum(free.astype(jnp.int32))
            # The contiguity argument above needs a sort+flush THIS
            # iteration, so the sliced path is wired only for the
            # every-iteration maintenance schedule (the default).
            if cfg.sort_rays and cfg.sort_every <= 1 and regen_caps[0] < p:
                regen_fn = regen
                for cap_k in reversed([c for c in regen_caps if c < p]):
                    regen_fn = (
                        lambda a, c=cap_k, nxt=regen_fn: jax.lax.cond(
                            n_free <= c, regen_sliced(c), nxt, a))
                if cfg.lazy_regen > 0:
                    remaining = total - next_work
                    do_regen = ((n_free * cfg.lazy_regen >= p)
                                | ((remaining > 0) & (remaining <= n_free)))
                    args = jax.lax.cond(do_regen, regen_fn,
                                        lambda a: a, args)
                else:
                    args = regen_fn(args)
            elif cfg.lazy_regen > 0:
                remaining = total - next_work
                do_regen = ((n_free * cfg.lazy_regen >= p)
                            | ((remaining > 0) & (remaining <= n_free)))
                args = jax.lax.cond(do_regen, regen, lambda a: a, args)
            else:
                args = regen(args)
            (origin, direction, mask, acc, seed, alive, pending, prev_pdf,
             bounce, pixid, next_work) = args

        # ---- park dead lanes ------------------------------------------
        # Lanes that are retired-but-unflushed or out of work still ride
        # through traversal; parking them at a far origin makes their
        # root slab test fail, so they leave the walk at once.
        # Destructive: regen re-fills origin/direction before reuse.
        dead = ~alive
        origin = jnp.where(dead[:, None], 1e30, origin)
        direction = jnp.where(dead[:, None], 1.0, direction)

        # ---- intersect + shade ----------------------------------------
        rays = st["rays"] + jnp.sum(alive.astype(jnp.float32))

        def trace_shade_rows(sub):
            """Trace + shade any contiguous lane package (full pool or
            the alive-prefix window); ``sub`` holds the state slices."""
            t, obj, tri = isect(scene, sub["origin"], sub["direction"],
                                eps=cfg.eps)
            shaded_alive = sub["alive"]
            origin, direction, acc, mask, alive2, seed, prev_pdf = \
                shade_step(scene, cfg, sub["origin"], sub["direction"],
                           sub["acc"], sub["mask"], sub["alive"],
                           sub["seed"], sub["bounce"], t, obj, tri,
                           prev_pdf=sub["prev_pdf"], isect=isect)
            bounce = jnp.where(shaded_alive, sub["bounce"] + 1,
                               sub["bounce"])
            return dict(origin=origin, direction=direction, acc=acc,
                        mask=mask, seed=seed, prev_pdf=prev_pdf,
                        alive=alive2 & (bounce < cfg.max_depth),
                        bounce=bounce)

        _TKEYS = ("origin", "direction", "mask", "acc", "seed", "alive",
                  "prev_pdf", "bounce")

        def trace_full(args):
            out = trace_shade_rows(dict(zip(_TKEYS, args)))
            return tuple(out[k] for k in _TKEYS)

        # Occupancy ladder: post-sort the alive lanes are a contiguous
        # PREFIX [0, n_alive) (alive keys < free < retired; regen fills
        # free lanes starting at n_alive, and its `valid` mask is a
        # rank-prefix of the free region, so refills extend the prefix
        # contiguously).  Tracing + shading only the smallest window
        # covering the alive lanes skips the per-lane cost of parked
        # tail lanes entirely — intersect already parks them cheaply,
        # but shade's table gathers are O(window).  Bit-identical for
        # live lanes: every lane is traced and shaded independently,
        # and dead tail state is untouched either way (regen
        # overwrites it).
        def trace_sliced(cap_k):
            def f(args):
                stt = dict(zip(_TKEYS, args))
                sub = {k: jax.lax.slice_in_dim(stt[k], 0, cap_k, axis=0)
                       for k in _TKEYS}
                out = trace_shade_rows(sub)
                stt = {k: jnp.concatenate(
                    [out[k], jax.lax.slice_in_dim(
                        stt[k], cap_k, p, axis=0)], axis=0)
                    for k in _TKEYS}
                return tuple(stt[k] for k in _TKEYS)
            return f

        trace_caps = [c for c in (p // 4, p // 2)
                      if TRACE_FLOOR <= c < p]
        args = (origin, direction, mask, acc, seed, alive, prev_pdf,
                bounce)
        if cfg.sort_rays and cfg.sort_every <= 1 and trace_caps:
            # The prefix-contiguity argument needs a sort THIS
            # iteration (same gate as the sliced regen ladder).
            n_alive = jnp.sum(alive.astype(jnp.int32))
            trace_fn = trace_full
            for cap_k in reversed(trace_caps):
                trace_fn = (
                    lambda a, c=cap_k, nxt=trace_fn: jax.lax.cond(
                        n_alive <= c, trace_sliced(c), nxt, a))
            args = trace_fn(args)
        else:
            args = trace_full(args)
        (origin, direction, mask, acc, seed, alive, prev_pdf,
         bounce) = args

        return dict(origin=origin, direction=direction, mask=mask, acc=acc,
                    seed=seed, alive=alive, pending=pending,
                    prev_pdf=prev_pdf, bounce=bounce,
                    pixid=pixid, next_work=next_work, accum=accum,
                    rays=rays, it=st["it"] + 1)

    return body


@partial(jax.jit, static_argnames=("cfg", "pool", "flush_cap", "rows"))
def render_wavefront(scene, cfg: RenderConfig, cam_world, fov_y, ubo_seeds,
                     pool: int = 1 << 20, flush_cap: int = 1 << 18,
                     y0=0, rows: int | None = None):
    """Render ``S = ubo_seeds.shape[0]`` samples of a row slab.

    ``rows``/``y0`` select a horizontal slab [y0, y0+rows) of the frame
    (default: the full frame).  Pixel RNG streams are keyed by absolute
    coordinates, so any row tiling reproduces the full-frame pixels —
    the invariant the tile-parallel mesh sharding relies on
    (parallel/mesh.py).

    Returns (accum [rows, W, 3] radiance SUM over the S samples,
    rays_traced scalar, iterations scalar).  The iteration count is the
    frame's pool-pass total — drain-tail iterations (few alive lanes,
    full O(pool) maintenance) are the wavefront's main amortization
    loss, so callers batching samples should watch it (the progressive
    session avoids them entirely via wavefront_chunk/wavefront_drain).
    """
    h, w = cfg.render_height, cfg.render_width
    rows = h if rows is None else rows
    y0 = jnp.asarray(y0, jnp.int32)
    npix = rows * w
    s = ubo_seeds.shape[0]
    total = s * npix
    p = min(pool, total)
    pix_coords = _make_pix_coords(w, y0)

    state = wavefront_pool_state(p, npix)

    # Lazy maintenance stretches frames over more iterations; keep
    # generous slack for both knobs.
    max_iters = (((total // p + 3) * cfg.max_depth + 4)
                 * max(cfg.sort_every, 1) + 4 * max(cfg.lazy_regen, 1))

    def cond(st):
        return ((st["next_work"] < total) | jnp.any(st["pending"])) \
            & (st["it"] < max_iters)

    # Retired (dead-but-unflushed) lanes are sorted to the pool tail so
    # the flush scatter usually covers only this slice.  A lax.cond
    # falls back to the full scatter on the rare iterations where more
    # lanes retire than the slice holds.
    body = _make_body(scene, cfg, cam_world, fov_y, ubo_seeds, p, npix,
                      total, min(p, flush_cap), pix_coords)

    state = jax.lax.while_loop(cond, body, state)
    accum = state["accum"]
    # A final full flush drains paths the while-exit left unflushed
    # (with sort_every > 1 the loop can exit between maintenance
    # passes; harmless no-op otherwise).
    final_flush = state["pending"] & ~state["alive"]
    vals = jnp.where(final_flush[:, None], state["acc"], 0.0)
    accum = accum.at[state["pixid"]].add(vals)
    return accum.reshape(rows, w, 3), state["rays"], state["it"]


@partial(jax.jit, static_argnames=("cfg", "flush_cap", "rows"),
         donate_argnames=("state",))
def wavefront_chunk(scene, cfg: RenderConfig, cam_world, fov_y, ubo_seeds,
                    state, flush_cap: int = 1 << 18,
                    y0=0, rows: int | None = None):
    """Advance a persistent pool by one chunk of ``S`` samples.

    Runs the wavefront loop until every (pixel, sample) work item of
    this chunk has been INJECTED (``next_work == total``) — in-flight
    paths stay in the returned state for the next chunk (or for
    ``wavefront_drain``), so steady-state occupancy never collapses at
    chunk boundaries.  ``state`` comes from ``wavefront_pool_state`` or
    a previous chunk/drain call; its buffers are donated.
    """
    h, w = cfg.render_height, cfg.render_width
    rows = h if rows is None else rows
    y0 = jnp.asarray(y0, jnp.int32)
    npix = rows * w
    p = state["pixid"].shape[0]  # lane count, layout-independent
    assert state["accum"].shape[0] == npix, \
        f"pool state npix {state['accum'].shape[0]} != frame {npix}"
    s = ubo_seeds.shape[0]
    total = s * npix
    pix_coords = _make_pix_coords(w, y0)

    body = _make_body(scene, cfg, cam_world, fov_y, ubo_seeds, p, npix,
                      total, min(p, flush_cap), pix_coords)

    # Injection needs at most ~total/p full pool turnovers; each lane
    # turns over at least once per max_depth iterations.
    max_iters = (((total // p + 3) * (cfg.max_depth + 2))
                 * max(cfg.sort_every, 1) + 4 * max(cfg.lazy_regen, 1))

    def cond(st):
        return (st["next_work"] < total) & (st["it"] < max_iters)

    state = dict(state, next_work=jnp.zeros((), jnp.int32),
                 it=jnp.zeros((), jnp.int32))
    return jax.lax.while_loop(cond, body, state)


@partial(jax.jit, static_argnames=("cfg", "flush_cap", "rows"),
         donate_argnames=("state",))
def wavefront_drain(scene, cfg: RenderConfig, state,
                    flush_cap: int = 1 << 18,
                    y0=0, rows: int | None = None):
    """Trace a persistent pool to completion without injecting work.

    After this, every previously injected path's radiance is flushed
    into ``state['accum']`` — the read-side counterpart of
    ``wavefront_chunk``."""
    h, w = cfg.render_height, cfg.render_width
    rows = h if rows is None else rows
    y0 = jnp.asarray(y0, jnp.int32)
    npix = rows * w
    p = state["pixid"].shape[0]  # lane count, layout-independent
    assert state["accum"].shape[0] == npix
    pix_coords = _make_pix_coords(w, y0)

    body = _make_body(scene, cfg, None, None,
                      jnp.ones((1, 2), jnp.uint32), p, npix,
                      jnp.zeros((), jnp.int32), min(p, flush_cap),
                      pix_coords, drain=True)

    # Every alive path dies within max_depth bounces; retired lanes
    # flush on the next sort pass.
    max_iters = (cfg.max_depth + 2) * max(cfg.sort_every, 1) + 8

    def cond(st):
        return jnp.any(st["pending"]) & (st["it"] < max_iters)

    state = dict(state, it=jnp.zeros((), jnp.int32))
    state = jax.lax.while_loop(cond, body, state)
    # Paranoia flush (mirrors render_wavefront's final flush; a no-op
    # unless max_iters cut the loop short).
    final_flush = state["pending"] & ~state["alive"]
    vals = jnp.where(final_flush[:, None], state["acc"], 0.0)
    accum = state["accum"].at[state["pixid"]].add(vals)
    return dict(state, accum=accum, pending=state["pending"] & ~final_flush)
