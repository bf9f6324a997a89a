"""Regenerate tests/golden_hashes.json: tiny deterministic renders of the
benchmark scenes in scenes/ (the reference's own regression oracle is the
per-pass image fold-hash, reference src/scene.c:141-146).

Run on CPU:  python tests/golden_gen.py [scene ...]
Each entry records the fold-hash of the packed 8-bit image plus the mean
radiance (a tolerance-friendly secondary signal)."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
jax.config.update("jax_platforms", "cpu")
from actinon_tpu import compile_cache
compile_cache.enable()
jax.config.update("jax_enable_x64", True)

import numpy as np

from actinon_tpu.scenes import load

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "golden_hashes.json")

# scene -> (width, height, direct, path, depth)
# tiny configs: the oracle checks *regression*, not convergence
CORPUS = {
    "primitives": (24, 18, 4, 0, 11),
    "wine_glass": (24, 18, 4, 0, 12),
    "diamond": (24, 18, 4, 0, 12),
    "many_spheres": (24, 18, 2, 0, 6),
    "hanging_lamp": (24, 18, 2, 0, 12),
}


def render_one(name):
    """Returns (hash, mean) of the scene's first create_image call at
    its tiny corpus config."""
    from actinon_tpu.render import image as aimg
    from actinon_tpu.render.integrator import Integrator
    from actinon_tpu.render.tracer import Tracer
    from actinon_tpu.scene import ir as sir

    w, h, direct, path, depth = CORPUS[name]
    sc = load(name)
    sc.cfg.image_width, sc.cfg.image_height = w, h
    sc.cfg.direct_samples = direct
    sc.cfg.path_samples = path
    sc.cfg.trace_depth = depth
    ir = sir.compile_scene(sc)
    integ = Integrator(Tracer(ir, dtype=np.float32), batch=1 << 12)
    ys, xs = np.mgrid[0:h, 0:w]
    pos = np.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5],
                   -1).astype(np.float64)
    acc = integ.run_samples(pos)
    sat = np.clip(np.power(np.maximum(acc, 0.0), sc.cfg.gamma), 0.0, 1.0)
    img = sat.reshape(h, w, 3)
    return {"hash": int(aimg.image_hash(aimg.pack_cps(img))),
            "mean": float(img.mean())}


def main():
    import time
    only = sys.argv[1:] or list(CORPUS)
    if os.path.exists(OUT):
        with open(OUT) as f:
            golden = json.load(f)
    else:
        golden = {}
    for name in only:
        print(f"{name}...", flush=True)
        t0 = time.time()
        try:
            golden[name] = render_one(name)
            golden[name]["seconds"] = round(time.time() - t0, 1)
            golden.pop(f"{name}__skipped", None)
        except Exception as e:
            # record WHY a scene is absent
            golden[f"{name}__skipped"] = \
                f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
        # write incrementally: a timeout keeps the finished scenes
        with open(OUT, "w") as f:
            json.dump(golden, f, indent=1, sort_keys=True)
        print(f"  {golden.get(name, golden.get(name + '__skipped'))}",
              flush=True)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
