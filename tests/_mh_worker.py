"""Worker process for tests/test_multihost.py: joins a 2-process
jax.distributed CPU cluster, renders a sharded pass over the global
mesh, and writes its (all-gathered) image to disk."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

addr, nproc, pid, out = sys.argv[1:5]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.distributed.initialize(coordinator_address=addr,
                           num_processes=int(nproc),
                           process_id=int(pid))

import numpy as np  # noqa: E402

from actinon_tpu import scenes  # noqa: E402
from actinon_tpu.parallel.mesh import make_mesh, ShardedIntegrator  # noqa: E402
from actinon_tpu.render.tracer import Tracer  # noqa: E402
from actinon_tpu.scene import ir as sir  # noqa: E402

sc = scenes.load("wine_glass")
sc.cfg.image_width, sc.cfg.image_height = 16, 12
sc.cfg.direct_samples = 3
sc.cfg.path_samples = 0
sc.cfg.trace_depth = 6
ir = sir.compile_scene(sc)

assert jax.process_count() == int(nproc)
assert len(jax.devices()) == 2 * int(nproc)   # global device view

mesh = make_mesh()                            # all global devices
integ = ShardedIntegrator(Tracer(ir, dtype=np.float32), mesh,
                          batch=len(jax.devices()) * 64)

cfg = ir.cfg
ys, xs = np.mgrid[0:cfg.image_height, 0:cfg.image_width]
pos = np.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5],
               -1).astype(np.float64)
acc = integ.run_samples(pos)
np.save(out, acc)
print(f"worker {pid}: mean {acc.mean():.6f}", flush=True)
