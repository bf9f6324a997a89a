"""Sharded production drain vs the single-device drain (8-device virtual
CPU mesh via conftest).  The shard_map drain must reproduce the
single-device render exactly (disjoint per-sample accumulation; only the
pmax loop condition crosses devices)."""

import numpy as np
import pytest

from actinon_tpu import scenes
from actinon_tpu.parallel.mesh import make_mesh, ShardedIntegrator
from actinon_tpu.render.integrator import Integrator
from actinon_tpu.render.tracer import Tracer
from actinon_tpu.scene import ir as sir


def _scene(width=20, height=16, direct=3, depth=6):
    sc = scenes.load("wine_glass")
    sc.cfg.image_width, sc.cfg.image_height = width, height
    sc.cfg.direct_samples = direct
    sc.cfg.path_samples = 0
    sc.cfg.trace_depth = depth
    return sir.compile_scene(sc)


def test_sharded_drain_matches_single_device():
    import jax
    ir = _scene()
    n = min(8, len(jax.devices()))
    mesh = make_mesh(n)
    sh = ShardedIntegrator(Tracer(ir, dtype=np.float32), mesh,
                           batch=n * 256)

    cfg = ir.cfg
    ys, xs = np.mgrid[0:cfg.image_height, 0:cfg.image_width]
    pos = np.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5],
                   -1).astype(np.float64)
    acc_sh = sh.run_samples(pos)

    single = Integrator(Tracer(ir, dtype=np.float32), batch=1 << 10)
    acc_1 = single.run_device(None, len(pos), pos_xy=pos)

    assert np.abs(acc_sh - acc_1).max() < 2e-5
    assert sh.last_balance is not None and 0 < sh.last_balance <= 1.0
    # the queue math must never drop rays on this workload
    assert np.isfinite(acc_sh).all()


def test_sharded_drain_nondivisible_n():
    """Sample counts not divisible by the device count pad with dead
    samples that must contribute exactly zero."""
    import jax
    ir = _scene(width=7, height=5)
    n = min(8, len(jax.devices()))
    mesh = make_mesh(n)
    sh = ShardedIntegrator(Tracer(ir, dtype=np.float32), mesh,
                           batch=n * 64)
    cfg = ir.cfg
    ys, xs = np.mgrid[0:cfg.image_height, 0:cfg.image_width]
    pos = np.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5],
                   -1).astype(np.float64)
    assert len(pos) % n != 0
    acc_sh = sh.run_samples(pos)
    single = Integrator(Tracer(ir, dtype=np.float32), batch=1 << 9)
    acc_1 = single.run_device(None, len(pos), pos_xy=pos)
    assert np.abs(acc_sh - acc_1).max() < 2e-5


def test_sharded_backward_matches_single_device():
    """ShardedDiffRenderer: batch sharded over `rays`, params replicated;
    the SPMD partitioner inserts the gradient psum.  Loss and every
    gradient leaf must match the single-device backward."""
    import jax
    from actinon_tpu.parallel.mesh import ShardedDiffRenderer
    from actinon_tpu.render.diff import DiffRenderer

    ir = _scene(width=16, height=8, depth=5)
    integ = Integrator(Tracer(ir, dtype=np.float32), batch=128)
    dr = DiffRenderer(integ, n_steps=4)

    rng = np.random.default_rng(5)
    B = 128
    pos = np.stack([rng.uniform(0, ir.cfg.image_width, B),
                    rng.uniform(0, ir.cfg.image_height, B)], -1)
    q0 = dr.primary(pos)

    val_1, g_1 = jax.jit(jax.value_and_grad(
        lambda ps: dr.render_loss(ps, q0)))(dr.params())

    n = min(8, len(jax.devices()))
    sdr = ShardedDiffRenderer(dr, make_mesh(n))
    val_s, g_s = sdr.value_and_grad(q0)

    assert abs(float(val_1) - float(val_s)) < 1e-5
    flat_1 = jax.tree_util.tree_leaves(g_1)
    flat_s = jax.tree_util.tree_leaves(g_s)
    assert len(flat_1) == len(flat_s)
    for a, b in zip(flat_1, flat_s):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-5)
