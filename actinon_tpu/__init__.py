"""actinon_tpu: a differentiable CSG path tracer in JAX.

A from-scratch re-design of the capabilities of johsteffens/actinon, a
C scene-scripting language and multi-threaded CPU ray/path tracer:

  * the Actinon scene-scripting language (`.acn`) is interpreted by a pure
    Python front-end (`actinon_tpu.acn`) that builds scenes,
  * scenes compile to a flat array IR (`actinon_tpu.scene`),
  * rendering runs as a jit-compiled, device-resident wavefront drain
    over ray batches (`actinon_tpu.render`), sharded over a
    `jax.sharding.Mesh` for multi-device scale-out (`actinon_tpu.parallel`),
  * the pipeline is differentiable w.r.t. material and geometry
    parameters (`actinon_tpu.render.diff`).

Reference parity map: see SURVEY.md section 2 and the docstrings of each
module (they cite reference file:line).
"""

import jax as _jax

# All dot/einsum contractions in this framework are tiny 3-vector /
# material-table reductions whose accuracy is load-bearing (shadow and
# hit decisions are discontinuous in the operands).  On NVIDIA GPUs
# XLA may run float32 contractions in TF32 (about three decimal
# digits) unless asked for full precision; "highest" keeps every f32
# product in f32.
_jax.config.update("jax_default_matmul_precision", "highest")

from actinon_tpu.config import RenderConfig, FType, default_ftype

__version__ = "0.1.0"
