#!/usr/bin/env python3
"""Smoke run of the render path on NVIDIA GPUs.

    python chip_smoke.py                  # one GPU: every default phase
    python chip_smoke.py --devices 4      # four GPUs: the sharded paths only

Run it from the root of a checkout.  One process drives the card(s); the
float64 references run in a child process pinned to the CPU
(JAX_PLATFORMS=cpu), never on the card.  A phase that fails raises, and
the script then exits non-zero without printing a result; without a GPU
it exits with code 2.  Rendered images and the CPU reference go to --out
(default smoke_out/).  Every timing line names the card and its
power limit.  The last line of standard output is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Default phases:
  1. device: JAX's view of the card, XLA_FLAGS, the compile-cache
     directory, nvidia-smi's name and power limit;
  2. precision: a float32 matrix product on the card against float64
     numpy, which shows that f32 products do not run in TF32;
  3. scenes: every scene in scenes/ at its bench.py config, f32: cold
     compile seconds, the drain program's memory analysis, one warm pass
     timed to its end (ray queries/s), and the drain chunks of that pass;
  4. main path: scenes/wine_glass.acn through the `python -m actinon_tpu`
     entry point (pass 0 and one adaptive pass), then one pass with path
     samples, which runs the mixed-kind drain;
  5. correctness: f32 renders on the card against the float64 CPU render
     of the same code;
  6. differentiable path: value_and_grad steps on wine_glass.

With --devices N only the sharded paths run, each beside what it is
compared with: ShardedIntegrator against the one-card drain (normal and
mixed path drain) and ShardedDiffRenderer against DiffRenderer.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# -- correctness (phase 5) ---------------------------------------------------
# f32 on the card against f64 on the CPU, same code, small size.  Both
# renders seed their random streams from (sample id, depth)
# (Integrator.seed_mode = "counter"): the default seeds hash the hit
# position, so any last-bit difference of a hit point draws a different
# set of light samples and a per-pixel compare at 4 samples would measure
# Monte-Carlo noise instead of the arithmetic.  What remains is f32
# against f64 rounding, the dtype's surface-shell eps (1e-4 against
# 1e-6), eps-shell decisions that flip, and XLA:GPU's summation order.
CHECK_SCENES = ("wine_glass", "primitives", "hanging_lamp")
CHECK_CFG = (64, 48, 4, 25)          # width, height, direct samples, depth
PIXEL_TOL = 2e-2                     # about five 8-bit steps
# Bounds: measured f32-vs-f64 on the CPU with counter seeds (mean
# difference <= 1.9e-3, >= 99.3% of pixels within PIXEL_TOL) and on the
# H100 (see CHANGES.md); hanging_lamp's SDF marches stop at
# |dist| <= 1.5 eps, so its f32 surfaces sit up to 1.5e-4 from the f64
# ones and set the mean bound.
MEAN_REL_BOUND = 3e-3
PIXEL_SHARE_BOUND = 0.99

# -- main path (phase 4) -----------------------------------------------------
MAIN_PATH_SAMPLES = 4    # the extra pass that runs the mixed-kind drain

# -- differentiable path (phase 6) -------------------------------------------
DIFF_BATCH = 8192
DIFF_STEPS = 3
DIFF_CHECK_BATCH = 256
# f32 against f64 at DIFF_CHECK_BATCH samples; measured on the CPU:
# value 8e-5, gradient (relative L2 over all parameters) 1.8e-4
DIFF_VALUE_BOUND = 1e-3
DIFF_GRAD_BOUND = 1e-2

# -- sharded paths (--devices N) ---------------------------------------------
# per sample |sharded - one card| / max(1, |one card|): the dry run's
# equality bound (__graft_entry__.py), relative where a sample exceeds 1.
# The two drains add a sample's contributions in different orders (other
# trip groupings; atomics on the GPU), so bright samples (a glass's
# reflection of the lamp reaches ~6.5) differ by f32 rounding of the sum.
SHARD_BOUND = 2e-5


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# helpers shared by the phases (each also runs on the CPU at tiny sizes)


def card_lines():
    """nvidia-smi's name and power limit, one line per card."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [ln.strip() for ln in r.stdout.strip().splitlines()]


def precision_probe(n=1024, seed=0):
    """Max relative error of a float32 jnp.dot on the default device
    against float64 numpy.  Full f32 gives ~1e-6; TF32 ~1e-3."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    got = np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(b)), np.float64)
    want = a.astype(np.float64) @ b.astype(np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def scene_with(name, width, height, direct, path, depth):
    from actinon_tpu import scenes

    sc = scenes.load(name)
    sc.cfg.image_width, sc.cfg.image_height = width, height
    sc.cfg.direct_samples = direct
    sc.cfg.path_samples = path
    sc.cfg.trace_depth = depth
    return sc


def integrator(sc, dtype=np.float32, batch=1 << 15):
    from actinon_tpu.render.integrator import Integrator
    from actinon_tpu.render.tracer import Tracer
    from actinon_tpu.scene import ir as sir

    return Integrator(Tracer(sir.compile_scene(sc), dtype=dtype),
                      batch=batch)


def pixel_centers(width, height):
    ys, xs = np.mgrid[0:height, 0:width]
    return np.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5],
                    -1).astype(np.float64)


def drain_memory(integ, n_samples):
    """memory_analysis() of the compiled drain program (camera raygen +
    first chunk) for a pass of n_samples."""
    import jax
    import jax.numpy as jnp

    (key, (first_fn, _)), = [(k, v) for k, v in integ._drain_jit.items()
                             if k[0] == "pos"]
    Np = key[2]
    assert Np >= n_samples
    i32 = jax.ShapeDtypeStruct((), jnp.int32)
    ma = first_fn.lower(jax.ShapeDtypeStruct((Np, 2), integ.dtype), i32,
                        i32).compile().memory_analysis()
    if ma is None:
        return {}
    return {f: int(getattr(ma, f)) for f in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(ma, f)}


_BACKEND_COMPILE = "/jax/core/compile/backend_compile_duration"
_compile_s = {}                  # thread id -> XLA compile seconds
_watching = False


def _count_compiles(event, secs, **_):
    if event == _BACKEND_COMPILE:
        tid = threading.get_ident()
        _compile_s[tid] = _compile_s.get(tid, 0.0) + secs


def _watch_compiles():
    global _watching
    import jax

    if not _watching:
        jax.monitoring.register_event_duration_secs_listener(
            _count_compiles)
        _watching = True


def first_pass(name, cfg5, batch=1 << 15):
    """Build scene `name` at cfg5 and run its first f32 pass over every
    pixel center (trace, compile and run).  Returns (integrator, pixel
    positions, first-pass seconds, XLA compile seconds of this thread;
    a persistent-cache hit compiles nothing)."""
    _watch_compiles()
    tid = threading.get_ident()
    c0 = _compile_s.get(tid, 0.0)
    sc = scene_with(name, *cfg5)
    integ = integrator(sc, np.float32, batch)
    pos = pixel_centers(sc.cfg.image_width, sc.cfg.image_height)
    t0 = time.perf_counter()
    integ.run_samples(pos)
    return (integ, pos, time.perf_counter() - t0,
            _compile_s.get(tid, 0.0) - c0)


def warm_pass(name, integ, pos):
    """One warm pass of a compiled drain, timed to the host having the
    image; the figures of phase 3 beside the drain's memory analysis."""
    integ.rays_traced = 0
    t0 = time.perf_counter()
    acc = integ.run_samples(pos)          # returns host data: pass ended
    warm = time.perf_counter() - t0
    if not np.isfinite(acc).all():
        raise AssertionError(f"{name}: non-finite radiance")
    out = {"warm_pass_s": warm, "queries": integ.rays_traced,
           "queries_per_s": integ.rays_traced / warm,
           "trips": integ.last_trips, "chunks": integ.last_chunks,
           "mean": float(acc.mean())}
    out.update(drain_memory(integ, len(pos)))
    return out


def time_scenes(scenes_cfg, batch=1 << 15):
    """Phase 3: the first passes of all scenes run in concurrent threads,
    so that their XLA compiles overlap, then each scene's warm pass runs
    alone.  Returns {name: figures};
    first_pass_s is wall time under that concurrency, compile_s the
    scene's own XLA compile seconds."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(scenes_cfg)) as ex:
        futs = {n: ex.submit(first_pass, n, c, batch)
                for n, c in scenes_cfg.items()}
        firsts = {n: f.result() for n, f in futs.items()}
    out = {}
    for name, (integ, pos, first, comp) in firsts.items():
        out[name] = {"first_pass_s": first, "compile_s": comp,
                     **warm_pass(name, integ, pos)}
    return out


def peak_bytes(device):
    stats = device.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


def main_path(out_dir, script, path_samples=MAIN_PATH_SAMPLES):
    """`python -m actinon_tpu <script> -f` in out_dir (it writes its own
    PNM there and logs every pass's hash), then one pass of the same
    scene with path samples through render_scene.  Returns seconds."""
    from actinon_tpu import __main__ as cli
    from actinon_tpu.acn.interp import run_file
    from actinon_tpu.render.driver import render_scene

    cwd = os.getcwd()
    os.chdir(out_dir)
    t0 = time.perf_counter()
    try:
        rc = cli.main([os.path.abspath(os.path.join(cwd, script)), "-f"])
    finally:
        os.chdir(cwd)
    t_cli = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"CLI exited {rc}")
    captured = []
    run_file(script, render_fn=lambda sc, f: captured.append(sc.clone()),
             args=["-f"])
    sc = captured[0]
    sc.cfg.path_samples = path_samples
    sc.cfg.gradient_cycles = 0
    stem = os.path.splitext(os.path.basename(script))[0]
    t0 = time.perf_counter()
    img = render_scene(sc, os.path.join(out_dir, f"{stem}_path.pnm"),
                       force=True)
    t_path = time.perf_counter() - t0
    if not np.isfinite(img).all():
        raise AssertionError("path pass: non-finite image")
    return t_cli, t_path


def check_render(name, dtype, width, height, direct, depth):
    """Counter-seeded render of every pixel center (see CHECK_*)."""
    sc = scene_with(name, width, height, direct, 0, depth)
    # one cascade stage (batch <= 1024) keeps the compile short
    integ = integrator(sc, dtype, 1 << 10)
    integ.seed_mode = "counter"
    return integ.run_samples(pixel_centers(width, height)), sc.cfg.gamma


def compare_renders(acc, ref, gamma):
    """Relative difference of the mean radiance, and the share of pixels
    whose gamma-saturated value is within PIXEL_TOL in every channel."""
    sat = lambda x: np.clip(np.power(np.maximum(x, 0.0), gamma), 0.0, 1.0)
    px = np.abs(sat(acc) - sat(ref)).max(-1)
    return {"mean_rel": float(abs(acc.mean() - ref.mean())
                              / abs(ref.mean())),
            "share": float((px <= PIXEL_TOL).mean()),
            "max_abs": float(px.max())}


def diff_setup(batch, dtype, seed=3):
    """(DiffRenderer, jitted value_and_grad of the mean radiance, params,
    primary rays) on wine_glass for `batch` random subpixel positions."""
    import jax
    from actinon_tpu import scenes
    from actinon_tpu.render.diff import DiffRenderer

    sc = scenes.load("wine_glass")
    dr = DiffRenderer(integrator(sc, dtype, 1 << 12))
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(0, sc.cfg.image_width, batch),
                    rng.uniform(0, sc.cfg.image_height, batch)], -1)
    q0 = dr.primary(pos)
    f = jax.jit(jax.value_and_grad(lambda ps: dr.render_loss(ps, q0)))
    return dr, f, dr.params(), q0


def flat_grads(grads):
    import jax
    return np.concatenate([np.asarray(g, np.float64).ravel()
                           for g in jax.tree_util.tree_leaves(grads)])


def diff_steps(batch, steps, lr=1e-3):
    """`steps` gradient steps on the mean radiance; every value and
    gradient must be finite.  Returns (values, seconds per step)."""
    import jax

    _, f, params, _ = diff_setup(batch, np.float32)
    values, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        val, grads = jax.block_until_ready(f(params))
        secs.append(time.perf_counter() - t0)
        g = flat_grads(grads)
        if not (np.isfinite(float(val)) and np.isfinite(g).all()):
            raise AssertionError("non-finite value or gradient")
        values.append(float(val))
        params = jax.tree_util.tree_map(lambda p, d: p - lr * d,
                                        params, grads)
    return values, secs


def diff_value_grad(batch, dtype):
    _, f, params, _ = diff_setup(batch, dtype)
    val, grads = f(params)
    return float(val), flat_grads(grads)


def compare_diff(val, grad, ref_val, ref_grad):
    return {"value_rel": abs(val - ref_val) / abs(ref_val),
            "grad_rel_l2": float(np.linalg.norm(grad - ref_grad)
                                 / np.linalg.norm(ref_grad))}


def cpu_reference(path):
    """The float64 references of phases 5 and 6 (run in a child process
    pinned to the CPU)."""
    import jax

    from actinon_tpu import compile_cache

    jax.config.update("jax_enable_x64", True)
    if jax.default_backend() != "cpu":
        raise RuntimeError("the CPU reference must run on the CPU")
    compile_cache.enable()      # off on the CPU, whatever the environment
    out = {}
    for name in CHECK_SCENES:
        out[name], _ = check_render(name, np.float64, *CHECK_CFG)
    out["diff_value"], out["diff_grad"] = diff_value_grad(
        DIFF_CHECK_BATCH, np.float64)
    np.savez(path, **out)


def sharded_check(n, normal_cfg, path_cfg, normal_batch=1 << 15,
                  path_batch=1 << 14, diff_batch=DIFF_BATCH,
                  batch_per_device=1024):
    """ShardedIntegrator over n devices against the one-device drain on
    device 0 (normal and mixed path drain), and ShardedDiffRenderer
    against DiffRenderer.  The one-device programs are those of the
    default phases (same scene, config and batch), so a warm compile
    cache serves them.  Returns the figures; raises past the bounds."""
    from concurrent.futures import ThreadPoolExecutor

    from actinon_tpu.parallel.mesh import (ShardedDiffRenderer,
                                           ShardedIntegrator, make_mesh)
    from actinon_tpu.render.tracer import Tracer
    from actinon_tpu.scene import ir as sir

    mesh = make_mesh(n)
    devs = list(mesh.devices.flat)

    def drain(label, cfg5, batch):
        sc = scene_with("wine_glass", *cfg5)
        sh = ShardedIntegrator(Tracer(sir.compile_scene(sc),
                                      dtype=np.float32), mesh,
                               batch=n * batch_per_device)
        pos = pixel_centers(sc.cfg.image_width, sc.cfg.image_height)
        acc = sh.run_samples(pos)
        acc1 = integrator(sc, np.float32, batch).run_samples(pos)
        err = float((np.abs(acc - acc1)
                     / np.maximum(1.0, np.abs(acc1))).max())
        if not err < SHARD_BOUND:
            raise AssertionError(f"{label} drain: sharded vs one device "
                                 f"max err {err} >= {SHARD_BOUND}")
        return {"max_err": err,
                "max_abs_err": float(np.abs(acc - acc1).max()),
                "balance": sh.last_balance}

    def diff():
        # data-parallel gradient against one device
        dr, f, params, q0 = diff_setup(diff_batch, np.float32)
        v1, g1 = f(params)
        vs, gs = ShardedDiffRenderer(dr, mesh).value_and_grad(q0)
        g1, gs = flat_grads(g1), flat_grads(gs)
        if not abs(float(v1) - float(vs)) < 1e-5:
            raise AssertionError(f"sharded diff value {vs} != {v1}")
        np.testing.assert_allclose(gs, g1, rtol=2e-4, atol=2e-5)
        return {"value_err": abs(float(v1) - float(vs)),
                "grad_max_err": float(np.abs(g1 - gs).max())}

    # the three checks run in concurrent threads so that their XLA
    # compiles overlap; no time is taken here
    with ThreadPoolExecutor(3) as ex:
        futs = {"normal": ex.submit(drain, "normal", normal_cfg,
                                    normal_batch),
                "path": ex.submit(drain, "path", path_cfg, path_batch),
                "diff": ex.submit(diff)}
        out = {k: f.result() for k, f in futs.items()}
    out["peak_bytes_per_device"] = peaks = [peak_bytes(d) for d in devs]
    if any(peaks) and not all(peaks):      # the CPU reports no stats
        raise AssertionError(f"a device held no buffers: {peaks}")
    return out


# ---------------------------------------------------------------------------


def _main_default(out_dir, card):
    import jax

    from bench import SCENES

    # 2. precision
    err = precision_probe()
    log(f"precision: f32 dot vs f64 max rel err {err:.3e} [{card}]")
    if not err < 1e-5:
        raise AssertionError(f"f32 matmul error {err}: reduced precision")

    # 3. per-scene compile / memory / throughput at the bench configs
    for name, r in time_scenes(SCENES).items():
        cfg5 = SCENES[name]
        log(f"scene {name} {cfg5[0]}x{cfg5[1]} direct={cfg5[2]} "
            f"depth={cfg5[4]}: " + json.dumps(r) + f" [{card}]")
    log(f"scenes: peak device bytes {peak_bytes(jax.devices()[0])} "
        f"[{card}]")

    # the CPU reference of phases 5 and 6 runs beside phases 4 and 6
    ref_path = os.path.join(out_dir, "cpu_reference.npz")
    child = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--cpu-reference", ref_path],
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, cwd=ROOT)
    try:
        # 4. main path end to end
        t_cli, t_path = main_path(out_dir,
                                  os.path.join("scenes", "wine_glass.acn"))
        log(f"main path: wine_glass via python -m actinon_tpu "
            f"{t_cli:.3f} s (compile included), path-sample pass "
            f"{t_path:.3f} s [{card}]")

        # 6a. differentiable path: steps at full batch
        vals, secs = diff_steps(DIFF_BATCH, DIFF_STEPS)
        log(f"diff: {DIFF_STEPS} value_and_grad steps at batch "
            f"{DIFF_BATCH}: values {vals}, seconds {secs} [{card}]")
        dval, dgrad = diff_value_grad(DIFF_CHECK_BATCH, np.float32)

        # 5. correctness against the f64 CPU render
        gpu = {n: check_render(n, np.float32, *CHECK_CFG)
               for n in CHECK_SCENES}
        rc = child.wait(timeout=1800)
        if rc != 0:
            raise AssertionError(f"CPU reference exited {rc}")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    ref = np.load(ref_path)
    for name in CHECK_SCENES:
        acc, gamma = gpu[name]
        c = compare_renders(acc, ref[name], gamma)
        log(f"correctness {name} {CHECK_CFG[0]}x{CHECK_CFG[1]} "
            f"direct={CHECK_CFG[2]} depth={CHECK_CFG[3]}: gpu f32 vs cpu "
            f"f64 mean rel diff {c['mean_rel']:.3e} (bound "
            f"{MEAN_REL_BOUND}), pixels within {PIXEL_TOL}: "
            f"{c['share']:.4f} (bound {PIXEL_SHARE_BOUND}), max "
            f"{c['max_abs']:.3f}")
        if not (c["mean_rel"] <= MEAN_REL_BOUND
                and c["share"] >= PIXEL_SHARE_BOUND):
            raise AssertionError(f"{name}: outside the bounds")
    d = compare_diff(dval, dgrad, float(ref["diff_value"]),
                     ref["diff_grad"])
    log(f"diff check batch {DIFF_CHECK_BATCH}: gpu f32 vs cpu f64 value "
        f"rel {d['value_rel']:.3e} (bound {DIFF_VALUE_BOUND}), gradient "
        f"rel L2 {d['grad_rel_l2']:.3e} (bound {DIFF_GRAD_BOUND})")
    if not (d["value_rel"] <= DIFF_VALUE_BOUND
            and d["grad_rel_l2"] <= DIFF_GRAD_BOUND):
        raise AssertionError("differentiable path outside the bounds")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="run only the sharded paths over this many GPUs")
    ap.add_argument("--out", default=os.path.join(ROOT, "smoke_out"))
    ap.add_argument("--cpu-reference", metavar="NPZ",
                    help=argparse.SUPPRESS)   # the child process's entry
    args = ap.parse_args(argv)

    if args.cpu_reference:
        cpu_reference(args.cpu_reference)
        return 0

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform})",
              file=sys.stderr)
        return 2
    if len(devs) < args.devices:
        print(f"chip_smoke: {args.devices} GPUs asked, {len(devs)} found",
              file=sys.stderr)
        return 2

    from actinon_tpu import compile_cache

    compile_cache.enable()
    os.makedirs(args.out, exist_ok=True)

    # 1. device
    cards = card_lines()
    card = cards[0]
    log(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)} jax={jax.__version__} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} compile cache="
        f"{jax.config.jax_compilation_cache_dir}")
    for c in cards:
        log(f"nvidia-smi: {c}")

    t0 = time.perf_counter()
    if args.devices > 1:
        from bench import SCENES
        from actinon_tpu import scenes

        # the configs, batches and rays of phases 3, 4 and 6
        c = scenes.load("wine_glass").cfg
        r = sharded_check(args.devices, SCENES["wine_glass"],
                          (c.image_width, c.image_height, c.direct_samples,
                           MAIN_PATH_SAMPLES, c.trace_depth))
        log(f"sharded over {args.devices} devices: " + json.dumps(r)
            + f" [{card}]")
    else:
        _main_default(args.out, card)
    log(f"total {time.perf_counter() - t0:.1f} s [{card}]")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
