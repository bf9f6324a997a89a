"""CLI: `python -m actinon_tpu <script.acn> [-f] [-r] [args...]`.

Mirrors the reference shell (reference src/main.c:76-122): `-f` overwrites
outputs without prompting, `-r` auto-recovers from checkpoints; remaining
arguments are forwarded to the script as `program_args`.  (Quirk parity:
like the reference, `-f` is also forwarded to the script,
reference src/main.c:100-105.)

Framework extensions (not in the reference):
  --dtype f32|f64     compute dtype (default f32)
  --batch N           wavefront batch size
  --platform cpu|...  force a JAX platform
"""

from __future__ import annotations

import sys

import numpy as np


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 1

    script = None
    force = recover = False
    dtype = np.float32
    batch = 1 << 14
    fwd = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--dtype":
            i += 1
            if argv[i] in ("f64", "float64"):
                dtype = np.float64
                import jax
                jax.config.update("jax_enable_x64", True)
            else:
                dtype = np.float32
        elif a == "--batch":
            i += 1
            batch = int(argv[i])
        elif a == "--platform":
            i += 1
            import jax
            jax.config.update("jax_platforms", argv[i])
        else:
            if a == "-f":
                force = True
                fwd.append(a)   # quirk parity: -f is forwarded too
            elif a == "-r":
                recover = True
            elif script is None:
                script = a
            else:
                fwd.append(a)
        i += 1

    if script is None:
        print("usage: python -m actinon_tpu <script.acn> [-f] [-r]")
        return 1

    from actinon_tpu import compile_cache
    from actinon_tpu.acn.interp import run_file
    from actinon_tpu.render.driver import render_scene

    compile_cache.enable()

    def render_fn(scene, fname):
        render_scene(scene, fname, force=force, recover=recover,
                     dtype=dtype, batch=batch)

    run_file(script, render_fn=render_fn, args=fwd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
