"""Device-mesh sharding of the wavefront render.

Parallelism model (SURVEY.md section 2.12): the reference's only
parallel axis is pixel-samples over a pthread pool
(reference src/scene.c:906-1028) plus frame-sharding over a shared
filesystem for animations.  The device-mesh equivalent is **data
parallelism over the ray/sample batch** on a 1-D mesh axis `rays`:

  * the production device-resident drain (integrator._drain) runs as the
    per-device body of a `shard_map` — each device owns a contiguous
    block of camera samples, builds its primary rays on device, and
    drains its OWN local queue (children stay on the parent's device, so
    there is no cross-device traffic in the hot loop at all; the one
    collective is the `pmax` loop condition keeping the SPMD trip counts
    agreed),
  * the per-sample accumulator is sharded the same way (sample ids are
    local to the shard), so the image assembles by construction —
    no psum needed, matching the reference's disjoint-slot accumulation
    (src/scene.c:1017-1028 workers write disjoint lum slots),
  * scene tables are closed-over constants, replicated by SPMD.

Scaling is therefore bounded by *load imbalance* between sample blocks
(some pixels spawn deeper specular trees), reported by
`ShardedIntegrator.last_balance`: sum(per-shard trips)/(n*max trips).

Frame-level sharding for animations (the reference's file-claiming
protocol, src_acn/diamond_video.acn:202-227) remains available through
the .acn front-end's file builtins, and hosts can also simply split
frames statically.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from actinon_tpu.render.integrator import Integrator


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D `rays` mesh over the GLOBAL device list — in a multi-process
    (multi-host) run jax.devices() spans all hosts, so the same mesh
    shards samples across hosts and across a host's devices (SURVEY.md
    section 2.12).  A 1-D mesh suits devices joined all to all, as the
    cards of one NVLink host are."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    return Mesh(np.array(devs[:n]), ("rays",))


class ShardedIntegrator(Integrator):
    """Integrator whose production drain is sharded over a `rays` mesh.

    run_samples() executes the whole pass as ONE jitted shard_map: per
    device raygen -> local wavefront drain -> local accumulation.  The
    host-drain fallback (path tracing) shards the per-batch step via
    jit in_shardings instead."""

    def __init__(self, tracer, mesh: Mesh, batch: int = 1 << 16):
        self.mesh = mesh
        n = mesh.devices.size
        # batch must stay divisible by the device count after bucketing
        batch = max(batch, n * 64)
        super().__init__(tracer, batch=batch)
        row = NamedSharding(mesh, P("rays"))

        def in_shardings():
            return {k: row for k in ("p", "d", "intensity", "tint",
                                     "depth", "sample_id")}

        self._step_normal = jax.jit(
            lambda q: self._step(q, path_ray=False),
            in_shardings=(in_shardings(),))
        self._step_path = jax.jit(
            lambda q: self._step(q, path_ray=True),
            in_shardings=(in_shardings(),))
        self._n_dev = n
        self._sdrain_jit = {}
        self.last_balance = None

    # ------------------------------------------------------------------

    def run_samples(self, pos_xy: np.ndarray) -> np.ndarray:
        # path configs run the mixed-kind drain (parents expand in place
        # on their own device), so every workload shards the same way
        return self._run_sharded(np.asarray(pos_xy))

    def run_device(self, primary, n_samples, pos_xy=None):
        if pos_xy is not None:
            return self._run_sharded(np.asarray(pos_xy))
        # arbitrary primary queues (not camera samples): host drain with
        # sharded steps
        saved = getattr(self, "device_drain", True)
        self.device_drain = False
        try:
            from actinon_tpu.render.integrator import RayQueue
            if not isinstance(primary, RayQueue):
                raise TypeError("primary queue required")
            return self.run(primary, n_samples)
        finally:
            self.device_drain = saved

    def _run_sharded(self, pos: np.ndarray) -> np.ndarray:
        n = self._n_dev
        N = len(pos)
        Nl = -(-N // n)                     # samples per device
        # pow2 bucket: adaptive passes vary N; avoid per-N recompiles
        Nl = 1 << int(np.ceil(np.log2(max(Nl, 64))))
        Npad = Nl * n
        if Npad > N:
            pos = np.concatenate([pos, np.zeros((Npad - N, 2))])
        # round-robin sample interleaving: device k takes samples
        # k, k+n, k+2n, ... — neighbouring pixels cost alike, so striding
        # them across devices balances the specular-depth load that
        # contiguous row blocks concentrate on a few shards
        idx = np.arange(Npad).reshape(Nl, n).T.reshape(-1)
        pos_sh = pos[idx]
        valid = (idx < N)
        B = max(64, self.batch // n)        # per-device lanes per trip
        nb = self._n_child_blocks
        cap_fac = 4 if self.path_cap == 0 else 8
        C = 1 << int(np.ceil(np.log2(max(cap_fac * Nl, 4 * B))))
        key = (C, Nl, B)
        if key not in self._sdrain_jit:
            dt = self.dtype

            def local(pos_l, val_l):        # [Nl, .] local sample block
                p, d = self._camera_rays_dev(pos_l)
                valid = val_l
                pad = C + nb * B - Nl
                q = dict(
                    p=jnp.concatenate([p, jnp.zeros((pad, 3), dt)]),
                    d=jnp.concatenate(
                        [d, jnp.tile(jnp.asarray([[0, 0, 1]], dt),
                                     (pad, 1))]),
                    intensity=jnp.concatenate(
                        [valid.astype(dt), jnp.zeros((pad,), dt)]),
                    tint=jnp.concatenate(
                        [jnp.broadcast_to(valid.astype(dt)[:, None],
                                          (Nl, 3)),
                         jnp.zeros((pad, 3), dt)]),
                    depth=jnp.concatenate(
                        [jnp.full((Nl,), self.cfg.trace_depth, jnp.int32),
                         jnp.zeros((pad,), jnp.int32)]),
                    sample_id=jnp.concatenate(
                        [jnp.arange(Nl, dtype=jnp.int32),
                         jnp.zeros((pad,), jnp.int32)]))
                if self.path_cap:
                    q.update(self._mixed_pad_fields(C + nb * B))
                # valid lanes form a PREFIX of each local block (sample j
                # of shard k is global k + j*n, valid iff j < ceil((N-k)/n)),
                # so the initial count can exclude the dead pad tail
                nvalid = jnp.sum(valid, dtype=jnp.int32)
                acc, dropped, queries, trips = self._drain(
                    q, nvalid, Nl, C, axis="rays", batch=B)
                # trips is replicated (pmax loop cond -> all shards run
                # the same trip count); per-shard `queries` (useful lanes
                # processed) is the load-balance signal
                return (acc,
                        jax.lax.psum(dropped, "rays"),
                        jnp.reshape(queries, (1,)),
                        trips)

            fn = jax.shard_map(local, mesh=self.mesh,
                               in_specs=(P("rays"), P("rays")),
                               out_specs=(P("rays"), P(), P("rays"),
                                          P()))
            self._sdrain_jit[key] = jax.jit(fn)

        if jax.process_count() > 1:
            # multi-host: every process owns the sample rows of ITS mesh
            # devices; assemble global sharded inputs from the local
            # slices, and allgather the sharded outputs back to every
            # host (the reference's analog is frame-level sharding over a
            # shared filesystem, src_acn/diamond_video.acn:202-227)
            from jax.experimental import multihost_utils
            # every process computed the same global pos_sh; hand the
            # assembler only the rows of THIS process's mesh devices
            pc, pid = jax.process_count(), jax.process_index()
            lo, hi = pid * Npad // pc, (pid + 1) * Npad // pc
            pos_g = multihost_utils.host_local_array_to_global_array(
                np.asarray(pos_sh[lo:hi], self.dtype), self.mesh,
                P("rays"))
            val_g = multihost_utils.host_local_array_to_global_array(
                np.asarray(valid[lo:hi]), self.mesh, P("rays"))
            acc_g, dropped, queries_g, trips = \
                self._sdrain_jit[key](pos_g, val_g)
            acc_sh = multihost_utils.process_allgather(acc_g, tiled=True)
            queries = multihost_utils.process_allgather(queries_g,
                                                        tiled=True)
            dropped, trips = jax.device_get((dropped, trips))
        else:
            acc_sh, dropped, queries, trips = jax.device_get(
                self._sdrain_jit[key](jnp.asarray(pos_sh, self.dtype),
                                      jnp.asarray(valid)))
        acc = np.empty_like(acc_sh)
        acc[idx] = acc_sh                   # undo the interleave
        queries = np.asarray(queries, np.int64)
        self.rays_traced += int(queries.sum()) * self.per_lane_queries
        self.last_trips = int(trips)
        self.last_balance = float(queries.sum()) / max(
            1, n * int(queries.max()))
        if int(dropped):
            print(f"warning: ray queue overflow, {int(dropped)} rays "
                  f"dropped", flush=True)
        from actinon_tpu.render.integrator import DRAIN_TRIP_CAP
        if int(trips) >= DRAIN_TRIP_CAP:
            print(f"warning: drain trip cap ({DRAIN_TRIP_CAP}) reached — "
                  f"wavefront terminated early, image under-rendered",
                  flush=True)
        return acc[:N].astype(np.float64)


class ShardedDiffRenderer:
    """Differentiable forward+backward sharded over the `rays` mesh.

    The primary sample batch is sharded on the mesh's `rays` axis and the
    parameter pytree is replicated; `render_loss` is a mean over samples,
    so XLA's SPMD partitioner inserts the cross-device gradient psum
    (the canonical data-parallel gradient reduction, SURVEY.md section
    2.12 "psum for gradient/image reduction") — no hand-written
    collectives needed.  Returns replicated (loss, grads) identical on
    every device, equal to the single-device result up to f32 reduction
    order.
    """

    def __init__(self, diff_renderer, mesh: Mesh):
        from actinon_tpu.render.diff import DiffRenderer
        assert isinstance(diff_renderer, DiffRenderer)
        self.dr = diff_renderer
        self.mesh = mesh
        self._vg_jit = None

    def value_and_grad(self, q0, weight=None):
        row = NamedSharding(self.mesh, P("rays"))
        rep = NamedSharding(self.mesh, P())
        q0 = {k: jax.device_put(jnp.asarray(v), row)
              for k, v in q0.items()}
        params = jax.device_put(self.dr.params(), rep)
        if self._vg_jit is None:
            self._vg_jit = jax.jit(jax.value_and_grad(
                lambda ps, q, w: self.dr.render_loss(ps, q, w)))
        if weight is not None:
            weight = jax.device_put(jnp.asarray(weight), row)
        else:
            weight = jax.device_put(
                jnp.ones((next(iter(q0.values())).shape[0], 1),
                         self.dr.dtype), row)
        return self._vg_jit(params, q0, weight)
