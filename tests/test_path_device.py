"""Device-resident path tracing: the mixed-kind drain vs the host-drain
oracle.

The reference's costliest recursion is the splitting path branch
(reference src/scene.c:584-621).  The host drain realizes it with a
separate path queue + host-side spawn (integrator.run); the production
device drain runs a MIXED queue where path-spawn parents are lanes that
expand in place under a queue-headroom budget (integrator._expand_parents).
Identical RNG counters and estimator factors mean the two must agree to
f32 accumulation-order noise."""

import numpy as np
import pytest

from actinon_tpu import scenes
from actinon_tpu.render.driver import camera_rays
from actinon_tpu.render.integrator import Integrator, RayQueue
from actinon_tpu.render.tracer import Tracer
from actinon_tpu.scene import ir as sir


def _scene(path_samples, depth, w=16, h=12, direct=4):
    sc = scenes.load("wine_glass")
    sc.cfg.image_width, sc.cfg.image_height = w, h
    sc.cfg.direct_samples = direct
    sc.cfg.path_samples = path_samples
    sc.cfg.trace_depth = depth
    return sir.compile_scene(sc)


def _primaries(ir, dt):
    cfg = ir.cfg
    ys, xs = np.mgrid[0:cfg.image_height, 0:cfg.image_width]
    pos = np.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5],
                   -1).astype(np.float64)
    p, d = camera_rays(ir, pos, dt)
    n = len(pos)
    return RayQueue(p, d, np.ones(n, dt), np.ones((n, 3), dt),
                    np.full(n, cfg.trace_depth, np.int32),
                    np.arange(n, dtype=np.int32)), n


@pytest.mark.parametrize("path_samples,depth", [(20, 12), (8, 22)])
def test_mixed_drain_matches_host(path_samples, depth):
    """depth 12: one path-split level; depth 22: two levels (path
    children at depth 12 > 10 re-split, reference src/scene.c:584).

    Both drains draw their random streams from (sample id, depth): with
    the default position-hashed seeds a last-bit difference of a hit
    point (XLA:CPU vectorizes the two drains' batch shapes differently)
    draws other light and path samples, and the compare would measure
    Monte-Carlo noise instead of the drains' logic."""
    ir = _scene(path_samples, depth)
    dt = np.dtype(np.float32)

    integ_h = Integrator(Tracer(ir, dtype=np.float32), batch=1 << 9)
    integ_h.device_drain = False
    integ_h.seed_mode = "counter"
    q, n = _primaries(ir, dt)
    acc_host = integ_h.run(q, n)

    integ_d = Integrator(Tracer(ir, dtype=np.float32), batch=1 << 9)
    integ_d.seed_mode = "counter"
    q2, _ = _primaries(ir, dt)
    acc_dev = integ_d.run_device(q2, n)

    assert np.isfinite(acc_dev).all()
    assert abs(acc_host.mean() - acc_dev.mean()) < 1e-5
    assert np.abs(acc_host - acc_dev).max() < 1e-2


def test_mixed_drain_sharded():
    """The sharded drain handles path configs (mixed queue per device)
    and agrees with the single-device mixed drain."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device (virtual CPU) mesh")
    from actinon_tpu.parallel.mesh import make_mesh, ShardedIntegrator

    ir = _scene(10, 12)
    cfg = ir.cfg
    ys, xs = np.mgrid[0:cfg.image_height, 0:cfg.image_width]
    pos = np.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5],
                   -1).astype(np.float64)

    mesh = make_mesh(4)
    sh = ShardedIntegrator(Tracer(ir, dtype=np.float32), mesh,
                           batch=4 * 256)
    acc_sh = sh._run_sharded(pos)

    integ_d = Integrator(Tracer(ir, dtype=np.float32), batch=1 << 9)
    acc_dev = integ_d.run_device(None, len(pos), pos_xy=pos)

    assert np.isfinite(acc_sh).all()
    assert abs(acc_sh.mean() - acc_dev.mean()) < 1e-5
    assert np.abs(acc_sh - acc_dev).max() < 1e-2
