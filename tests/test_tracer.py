"""Device tracer vs. the scalar host oracle: nearest hits over randomized
rays on synthetic objects and the benchmark scenes."""

import numpy as np
import pytest

from actinon_tpu.scene import ir as sir
from actinon_tpu.scene.objects import (
    INF, Neg, PairInside, PairOutside, Plane, ScaleWrap, Scene, Sphere,
    Squaroid, make_torus, rot_y, v3,
)
from actinon_tpu.render.tracer import Tracer
from actinon_tpu import scenes


def ray_batch(n=300, seed=0, spread=6.0):
    r = np.random.default_rng(seed)
    p = r.uniform(-spread, spread, size=(n, 3))
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return p, d


def build_scene(objs, lights=()):
    sc = Scene()
    for o in lights:
        o.prp.radiance = 25.0
        sc.push(o)
    for o in objs:
        sc.push(o)
    return sc


def check_vs_oracle(sc: Scene, n=300, seed=0, spread=6.0, atol=1e-6,
                    miss_tol=0.005):
    """Compare tracer.nearest (matter+light) against host compound scan."""
    ir = sir.compile_scene(sc)
    tr = Tracer(ir, dtype=np.float64)
    p, d = ray_batch(n, seed, spread)
    t, nor, oid, sign = tr.nearest_jit(p, d)
    t = np.asarray(t)
    nor = np.asarray(nor)

    mismatch = 0
    for i in range(n):
        best = (INF, None)
        for comp in (sc.light, sc.matter):
            a, nr, h = comp.ray_hit(p[i], d[i])
            if a < best[0]:
                best = (a, nr)
        a_ref, n_ref = best
        if a_ref == INF and not np.isfinite(t[i]):
            continue
        if (a_ref == INF) != (not np.isfinite(t[i])):
            mismatch += 1
            continue
        if abs(t[i] - a_ref) > atol * (1 + abs(a_ref)):
            mismatch += 1
            continue
        if n_ref is not None and not np.allclose(nor[i], n_ref, atol=1e-5):
            mismatch += 1
    # tiny mismatch budget for rays grazing eps-shells
    assert mismatch <= miss_tol * n, f"{mismatch}/{n} rays disagree"


def test_spheres_planes():
    s1 = Sphere(1.3); s1.move(v3(0.5, 0, 1))
    pl = Plane(); pl.rotate(rot_y(0.3)); pl.move(v3(0, 0, -2))
    check_vs_oracle(build_scene([s1, pl]))


def test_quadrics():
    e = Squaroid.ellipsoid(2.0, 1.0, 1.5)
    c = Squaroid.cylinder(1.0, 0.8); c.move(v3(3, 0, 0))
    h = Squaroid.hyperboloid1(1.0, 1.0, 1.5); h.move(v3(-3, 0, 0))
    check_vs_oracle(build_scene([e, c, h]))


def test_torus_sdf():
    t = make_torus(2.0, 0.5)
    # SDF marching: hits agree to march resolution, not analytically
    check_vs_oracle(build_scene([t]), atol=1e-4, miss_tol=0.02)


def test_csg_shell_and_union():
    shell = PairInside(Sphere(1.5), Neg(Sphere(1.2)))
    uni = PairOutside(Sphere(1.0), _m(Sphere(1.0), v3(1, 0, 0)))
    uni.move(v3(4, 0, 0))
    check_vs_oracle(build_scene([shell, uni]))


def test_csg_deep_intersection():
    """Diamond-style many-plane intersection."""
    import math
    planes = []
    for k in range(8):
        pl = Plane()
        pl.rotate(rot_y(2 * math.pi * k / 8))
        pl.move(v3(0, 0, 0))
        # tilt each plane outward
        planes.append(pl)
    cut = Sphere(2.0)
    obj = cut
    for k, pl in enumerate(planes):
        q = pl.clone()
        q.move(v3(0, 0, 1.0))
        obj = PairInside(obj, q)
    check_vs_oracle(build_scene([obj]), miss_tol=0.01)


def test_scalewrap_csg():
    lens = PairInside(Sphere(1.5), _m(Sphere(1.5), v3(1, 0, 0)))
    squashed = ScaleWrap(lens, v3(1.0, 2.0, 0.5))
    check_vs_oracle(build_scene([squashed]), miss_tol=0.01)


def _m(o, vec):
    o.move(vec)
    return o


# --- corpus scenes ---------------------------------------------------------

@pytest.mark.parametrize("scene_name", scenes.NAMES)
def test_corpus_tracer_vs_oracle(scene_name):
    sc = scenes.load(scene_name)
    ir = sir.compile_scene(sc)
    tr = Tracer(ir, dtype=np.float64)

    # rays from the camera toward the scene
    rng = np.random.default_rng(7)
    n = 150
    p = np.tile(ir.cam_pos, (n, 1))
    d = rng.normal(size=(n, 3))
    d[:, 1] = np.abs(d[:, 1])  # roughly toward the scene (view dir ~ +y-ish)
    d = (ir.cam_rot @ np.stack([d[:, 0] * 0.3, np.abs(d[:, 1]) + 1.0,
                                d[:, 2] * 0.3], -1).T).T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    t, nor, oid, sign = tr.nearest_jit(p, d)
    t = np.asarray(t)

    mismatch = 0
    for i in range(n):
        best = INF
        for comp in (sc.light, sc.matter):
            a, _, _ = comp.ray_hit(p[i], d[i])
            best = min(best, a)
        if best == INF and not np.isfinite(t[i]):
            continue
        if (best == INF) != (not np.isfinite(t[i])) or \
                abs(t[i] - best) > 1e-4 * (1 + abs(best)):
            mismatch += 1
    assert mismatch <= max(2, 0.02 * n), f"{mismatch}/{n} disagree"


def test_sphere_light_hit_from_far_away_f32():
    """An f32 ray from ~5500 units away hits a unit sphere light on its
    surface (the NEE light intersection divides by the squared distance
    from the hit to the light's center)."""
    import jax.numpy as jnp
    from actinon_tpu.render.tracer import _sphere_first_hit

    c = np.float32([-4, -5, 10])
    p = np.float32([1079.8157, 5435.8257, 0.0])
    rng = np.random.default_rng(0)
    d = (c - p)[None] + rng.normal(0, 0.3, (200, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    pb = np.broadcast_to(p, d.shape).astype(np.float32)
    a = np.asarray(_sphere_first_hit(jnp.asarray(c), jnp.float32(1.0),
                                     jnp.asarray(pb), jnp.asarray(d), 0.0))
    hit = np.isfinite(a)
    assert hit.sum() > 100
    h = pb[hit].astype(np.float64) + d[hit] * a[hit, None]
    assert np.abs(np.linalg.norm(h - c, axis=-1) - 1.0).max() < 1e-2
