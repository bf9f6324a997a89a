"""One query-accounting definition across every drain (round-3 verdict
weak #8): `rays_traced` must mean the same thing through the host drain,
the device drain, and the sharded drain, or the bench headline silently
changes meaning between code paths (this happened between rounds 1 and
2: the r1 pin was measured through the host drain, which counts the
same lanes but overlaps host/device work differently).

A query = one live non-parent lane * (2 + n_lights * direct_samples)
(Integrator.per_lane_queries; reference counterpart: the recursive calls
into compound_s_ray_hit / ray_trans_hit per scene_s_lum invocation,
reference src/scene.c:420-667).
"""

import numpy as np
import pytest

from actinon_tpu import scenes
from actinon_tpu.render.integrator import Integrator, RayQueue
from actinon_tpu.render.tracer import Tracer
from actinon_tpu.scene import ir as sir


def _scene(path_samples):
    sc = scenes.load("wine_glass")
    sc.cfg.image_width, sc.cfg.image_height = 16, 12
    sc.cfg.direct_samples = 3
    sc.cfg.path_samples = path_samples
    sc.cfg.trace_depth = 12
    return sir.compile_scene(sc)


def _samples(ir):
    cfg = ir.cfg
    ys, xs = np.mgrid[0:cfg.image_height, 0:cfg.image_width]
    return np.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5],
                    -1).astype(np.float64)


def _primary(ir, integ, pos):
    # device-precision raygen: the host-side camera_rays computes in f64
    # and its f32-rounded rays differ in the last ulp, which shifts the
    # position-seeded RNG streams and hence the (RNG-gated) path-spawn
    # lane counts — the accounting comparison needs identical streams
    import jax
    p, d = jax.device_get(jax.jit(integ._camera_rays_dev)(
        np.asarray(pos, integ.dtype)))
    n = len(pos)
    return RayQueue(np.asarray(p), np.asarray(d),
                    np.ones(n, integ.dtype),
                    np.ones((n, 3), integ.dtype),
                    np.full(n, ir.cfg.trace_depth, np.int32),
                    np.arange(n, dtype=np.int32))


@pytest.mark.parametrize("path_samples", [0, 4])
def test_host_vs_device_drain_accounting(path_samples):
    ir = _scene(path_samples)
    pos = _samples(ir)

    dev = Integrator(Tracer(ir), batch=256)
    dev.rays_traced = 0
    acc_dev = dev.run_samples(pos)

    host = Integrator(Tracer(ir), batch=256)
    host.device_drain = False
    host.rays_traced = 0
    acc_host = host.run(_primary(ir, host, pos), len(pos))

    assert dev.per_lane_queries == host.per_lane_queries
    assert dev.rays_traced == host.rays_traced, (
        dev.rays_traced, host.rays_traced)
    # the two paths generate camera rays in different precisions (host
    # f64 numpy vs on-device f32), so position-seeded RNG streams — and
    # individual pixels — legitimately differ; the drains must still
    # agree statistically
    assert abs(acc_dev.mean() - acc_host.mean()) < 3e-2 * max(
        acc_dev.mean(), 1e-6)


def test_sharded_drain_accounting():
    import jax
    from actinon_tpu.parallel.mesh import make_mesh, ShardedIntegrator

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    ir = _scene(0)
    pos = _samples(ir)

    dev = Integrator(Tracer(ir), batch=256)
    dev.rays_traced = 0
    dev.run_samples(pos)

    sh = ShardedIntegrator(Tracer(ir), make_mesh(), batch=1024)
    sh.rays_traced = 0
    sh.run_samples(pos)

    assert sh.rays_traced == dev.rays_traced, (
        sh.rays_traced, dev.rays_traced)
