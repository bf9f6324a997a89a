"""Vectorized ray-scene intersection over the compiled Scene IR.

Array-programming replacement for the reference hit stack
(compound_s_ray_hit / compound_s_ray_trans_hit -> obj_ray_hit -> per-type
vtable hits, reference src/compound.c:215-299, src/objects.c:245-310).

Design (round 2): every analytic leaf surface — half-space, sphere,
quadric — is ONE ROW of a unified *generalized quadric* table

    side(x) = sum_i c2_i y_i^2 + sum_i c1_i y_i + r,   y = M x + m0

(plane: c2=0, c1=n, r=k; sphere: M=I, m0=-c, c2=1, r=-R^2; quadric as
compiled by the IR).  A scene traversal is then

  * two small affine maps  pl = p @ M^T + m0, dl = d @ M^T,
  * one fused elementwise block producing both roots of
    A t^2 + B t + C = 0 for ALL leaves at once ([R, L] arrays),
  * per-family root policies applied as static masks
    (entry/exit choice for spheres, first-nonnegative for quadrics,
    forward crossing for planes — reference src/gmath.h:38-97,
    src/objects.c:791-801),
  * CSG composites evaluated by a *bit-packed crossing-parity walk*:
    per-leaf inside-ness parities along the ray are packed into uint32
    lanes, the composite's tree program is evaluated before/after every
    crossing, and the first flip is the boundary (replaces the
    reference's recursive pair-marching, src/objects.c:1052-1094, with
    straight-line, divergence-free XLA),
  * ONE global top-2 merge over candidate columns, after which normals
    are reconstructed only for the two winners from the leaf table
    (grad side = (2 c2 y + c1) M) — no per-group gather chains.

The table is processed in chunks with a running top-2 so scenes like
many_spheres.acn (~1.4k leaves) never materialize [R, L] for huge L.

Every scene traversal computes the nearest AND second-nearest hit in the
same pass, so the media-transition query (coincident-surface resolution,
reference src/compound.c:246-299) costs one traversal.  Shadow queries
use a cheap any-hit reduction (no top-2, no normals).

Differentiable path: geometry tables are read through `self._t(...)`,
which substitutes traced arrays from `self.ovr` when present — gradients
w.r.t. sphere centers/radii, plane/quadric parameters flow through the
closed-form hit math.  `self.diff = True` switches the SDF march to a
fixed-trip scan.

All functions take/return jnp arrays shaped [R] / [R,3] and are meant to
be called inside a jitted integrator.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from actinon_tpu.math3d import safe_sqrt
from actinon_tpu.scene import ir as sir

INF = jnp.inf
CHUNK = 1024           # single-leaf candidate chunk (running top-2)
SDF_CROSSINGS = 4      # bounded crossing count for SDF leaves inside CSG
MARCH_ACCEPT = 1.5     # march acceptance = MARCH_ACCEPT * eps: a step of
                       # dist+eps overshoots the zero by <= eps for a
                       # 1-Lipschitz SDF, plus f32 evaluation noise — a
                       # bare |dist| <= eps drops real crossings whose
                       # overshoot lands at eps + ulp (observed: grazing
                       # torus rays losing their first crossing).  The
                       # reference's f64/1e-6 march never sees this
                       # (noise ~1e-15); the f32 port needs the margin.
PAIR_K = 4             # live (ray, member) pair capacity factor: compacted
                       # cluster evaluation holds PAIR_K * R pairs


def _env_clip_marches():
    """Envelope-clipped SDF marches apply off-CPU only: a march started
    at the envelope entry converges to a crossing offset that differs
    from the origin-started march at O(eps), and the CPU golden corpus
    pins the origin-started behavior bit-exactly.  (The clip is the
    accelerator path's analog of the reference's envelope early-outs,
    obj_ray_hit src/objects.c:261-284.)"""
    import jax as _jax
    return _jax.default_backend() != "cpu"


def _pair_compact_on():
    """Gate-compacted (ray, member) solo-cluster evaluation applies
    off-CPU by default (same policy as _env_clip_marches: the CPU golden
    corpus pins the member-scan evaluation order bit-exactly).  Override
    with ACTINON_PAIR_COMPACT=1/0 (tests force it on under CPU for the
    A/B equivalence check)."""
    v = os.environ.get("ACTINON_PAIR_COMPACT")
    if v is not None:
        return v != "0"
    import jax as _jax
    return _jax.default_backend() != "cpu"


def _norm3(v):
    # zero-input and sqrt(0) cotangents are masked so reverse-mode AD
    # never produces 0*inf = NaN (see diff.py)
    ln2 = jnp.sum(v * v, axis=-1, keepdims=True)
    pos = ln2 > 0
    ln = jnp.sqrt(jnp.where(pos, ln2, 1.0))
    return jnp.where(pos, v / ln, v)


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def safe_acos(x):
    """arccos with clamped input and finite gradient at |x| >= 1."""
    inside = jnp.abs(x) < 1.0
    xin = jnp.where(inside, x, 0.0)
    return jnp.where(inside, jnp.arccos(xin),
                     jnp.where(x >= 1.0, 0.0, np.pi))


def safe_asin(x):
    """arcsin with clamped input and finite gradient at |x| >= 1."""
    inside = jnp.abs(x) < 1.0
    xin = jnp.where(inside, x, 0.0)
    return jnp.where(inside, jnp.arcsin(xin),
                     jnp.where(x >= 1.0, np.pi / 2, -np.pi / 2))


def _sphere_first_hit(c, r, p, d, eps):
    """Reference sphere_ray_hit semantics (src/gmath.h:64-85): entry root
    when outside+approaching, exit root when inside or behind-center.
    Used by the integrator's NEE light intersection.

    The discriminant s^2 - q is formed as r^2 - |pp - s d|^2 (unit d):
    for a light far from the shading point, s^2 and q agree in every f32
    digit, and the cancelling form put the hit at the light's CENTER
    (observed at distance ~5000 with fused multiply-adds), where the
    radiance falloff divides by zero."""
    pp = p - c
    s = _dot(pp, d)
    q = _dot(pp, pp) - r * r
    perp = pp - s[..., None] * d
    disc = r * r - _dot(perp, perp)
    ok = disc >= 0
    root = safe_sqrt(jnp.where(ok, disc, 0.0))
    entering = (s < 0) & (q > 0)
    exiting = (s < 0) | (q < 0)
    a = jnp.where(entering, -s - root, jnp.where(exiting, -s + root, INF))
    return jnp.where(ok, a - eps, INF)


def _sdf_eval(kind, param, pos):
    """Vectorized SDF (reference src/distance.c); pos [...,3]."""
    if kind == sir.SDF_SPHERE:
        return jnp.sqrt(jnp.sum(pos * pos, -1)) - 1.0
    if kind == sir.SDF_TORUS:
        x, y = pos[..., 0], pos[..., 1]
        f = jnp.sqrt(x * x + y * y)
        f_inv = jnp.where(f > 0, 1.0 / jnp.where(f > 0, f, 1.0), 1.0)
        xu, yu = x * f_inv, y * f_inv
        return jnp.sqrt((xu - x) ** 2 + (yu - y) ** 2 + pos[..., 2] ** 2) \
            - param
    raise ValueError(kind)


def _take_cols(a, idx):
    """a[r, idx[r, k]] — unrolled compare+select for small static K
    (K selects fuse into the surrounding elementwise code); one
    take_along_axis for wide K (composite-heavy scenes), where the
    unroll would bloat the HLO module and XLA compile time."""
    K = a.shape[1]
    if K > 32:
        return jnp.take_along_axis(a, idx, axis=1)
    out = jnp.zeros(idx.shape, a.dtype)
    for k in range(K):
        out = jnp.where(idx == k, a[:, k:k + 1], out)
    return out


def _top2_cols(a):
    """Smallest and second-smallest over the last axis of a [R, K] array
    (K >= 1 static).  Returns (vals [R,2], idx [R,2]); missing columns are
    (INF, 0).  Two argmin passes — two fused reductions instead of a
    lax.top_k sort."""
    R, K = a.shape
    i1 = jnp.argmin(a, axis=1).astype(jnp.int32)
    t1 = jnp.min(a, axis=1)
    cols = jnp.arange(K, dtype=jnp.int32)
    a2 = jnp.where(cols[None, :] == i1[:, None], INF, a)
    i2 = jnp.argmin(a2, axis=1).astype(jnp.int32)
    t2 = jnp.min(a2, axis=1)
    return jnp.stack([t1, t2], axis=1), jnp.stack([i1, i2], axis=1)


# ---------------------------------------------------------------------------
# unified leaf table


class _Unified:
    """SoA table of all analytic leaves (static numpy; traced overrides
    assembled on demand)."""

    def __init__(self, dtype):
        self.dtype = dtype
        self.M = []        # [L,3,3]
        self.m0 = []       # [L,3]
        self.c2 = []       # [L,3]
        self.c1 = []       # [L,3]
        self.rr = []       # [L]
        self.kind = []     # [L] sir.PLANE/SPHERE/QUADRIC
        self.neg = []      # [L] normal flip
        self.oid = []      # [L] owning object id
        self.is_light = []
        self.single = []   # candidate column (owning object single-leaf)
        self.env_c = []    # [L,3] owning object envelope (singles only)
        self.env_r = []    # [L]
        # override bookkeeping
        self.sph_rows, self.sph_c, self.sph_r = [], [], []
        self.pla_rows, self.pla_n, self.pla_k = [], [], []
        self.qua_rows = []
        self.qua_m, self.qua_m0, self.qua_coef, self.qua_r = [], [], [], []
        self.comp_keys = []  # (row, key_prefix, family)

    def add(self, lf: sir.Leaf, oid: int, is_light: bool, single: bool,
            env_c, env_r, key: Optional[str]) -> int:
        row = len(self.rr)
        eye = np.eye(3)
        if lf.family == sir.PLANE:
            M, m0 = eye, np.zeros(3)
            c2, c1, r = np.zeros(3), np.asarray(lf.n, float), float(lf.k)
            self.pla_rows.append(row)
            self.pla_n.append(np.asarray(lf.n, float))
            self.pla_k.append(float(lf.k))
        elif lf.family == sir.SPHERE:
            M, m0 = eye, -np.asarray(lf.c, float)
            c2, c1, r = np.ones(3), np.zeros(3), -float(lf.r) ** 2
            self.sph_rows.append(row)
            self.sph_c.append(np.asarray(lf.c, float))
            self.sph_r.append(float(lf.r))
        elif lf.family == sir.QUADRIC:
            M, m0 = np.asarray(lf.m, float), np.asarray(lf.m0, float)
            c2, c1, r = np.asarray(lf.coef, float), np.zeros(3), float(lf.r)
            self.qua_rows.append(row)
            self.qua_m.append(M); self.qua_m0.append(m0)
            self.qua_coef.append(c2); self.qua_r.append(r)
        else:
            raise ValueError(lf.family)
        self.M.append(M); self.m0.append(m0)
        self.c2.append(c2); self.c1.append(c1); self.rr.append(r)
        self.kind.append(lf.family); self.neg.append(lf.neg)
        self.oid.append(oid); self.is_light.append(is_light)
        self.single.append(single)
        self.env_c.append(env_c if env_c is not None else np.zeros(3))
        self.env_r.append(env_r if env_c is not None else -1.0)
        if key is not None:
            self.comp_keys.append((row, key, lf.family))
        return row

    def finalize(self):
        dt = self.dtype
        z = lambda a, shp: (np.asarray(a, dt) if len(a)
                            else np.zeros(shp, dt))
        self.M = z(self.M, (0, 3, 3)); self.m0 = z(self.m0, (0, 3))
        self.c2 = z(self.c2, (0, 3)); self.c1 = z(self.c1, (0, 3))
        self.rr = z(self.rr, (0,))
        self.kind = np.asarray(self.kind, np.int32)
        self.neg = np.asarray(self.neg, bool)
        self.oid = np.asarray(self.oid, np.int32)
        self.is_light = np.asarray(self.is_light, bool)
        self.single = np.asarray(self.single, bool)
        self.env_c = z(self.env_c, (0, 3)); self.env_r = z(self.env_r, (0,))
        self.sph_c = z(self.sph_c, (0, 3)); self.sph_r = z(self.sph_r, (0,))
        self.pla_n = z(self.pla_n, (0, 3)); self.pla_k = z(self.pla_k, (0,))
        self.qua_m = z(self.qua_m, (0, 3, 3))
        self.qua_m0 = z(self.qua_m0, (0, 3))
        self.qua_coef = z(self.qua_coef, (0, 3))
        self.qua_r = z(self.qua_r, (0,))
        for n in ("sph_rows", "pla_rows", "qua_rows"):
            setattr(self, n, np.asarray(getattr(self, n), np.int32))

    def __len__(self):
        return len(self.rr)


class _LeafP:
    """Duck-typed stand-in for an SDF `sir.Leaf` inside a scanned
    solo-cluster body: same attribute names the SDF helpers read, but
    m/m0/sdf_param are traced per-member arrays (sdf_kind/cycles/neg stay
    static — uniform within a cluster by the clustering key)."""

    __slots__ = ("sdf_kind", "cycles", "neg", "m", "m0", "sdf_param")

    def __init__(self, proto, m, m0, param):
        self.sdf_kind = proto.sdf_kind
        self.cycles = proto.cycles
        self.neg = proto.neg
        self.m = m
        self.m0 = m0
        self.sdf_param = param


class _Composite:
    """One CSG object: tree program over unified rows + SDF leaves."""

    def __init__(self, oid, tree, rows, sdf_leaves, env_c, env_r, is_light):
        self.oid = oid
        self.tree = tree          # local leaf indices
        self.rows = rows          # local analytic leaf -> global row (or -1)
        self.sdf_leaves = sdf_leaves  # local leaf -> sir.Leaf (or None)
        self.env_c = env_c
        self.env_r = env_r
        self.is_light = is_light


# -- or-decomposition of analytic composites --------------------------------
#
# A union of spatially DISJOINT solids hits like independent objects: the
# first boundary of A|B is min(first(A), first(B)) whenever A and B cannot
# overlap.  Reference scenes build large assemblies exactly this way
# (hanging_lamp: ~12-leaf lamp trees that are unions of small disjoint
# parts, reference src_acn/hanging_lamp/tools.acn), so splitting or-nodes
# whose operand bounds are disjoint turns a handful of huge trees into
# many TINY same-shape trees — which the grouped walk batches into a few
# small HLO blocks (compile size) and gives each part a TIGHT envelope
# gate (the reference's author-defined bounding-sphere hierarchy,
# src/compound.c:215-244).


def _sdf_leaf_bound(lf):
    """Conservative bounding sphere of one positive SDF leaf from its
    local frame: the unit shape (sphere r=1 / torus ring 1 + tube prm)
    mapped through the inverse affine transform."""
    if lf.neg:
        return None
    m = np.asarray(lf.m, np.float64)
    try:
        minv = np.linalg.inv(m)
    except np.linalg.LinAlgError:
        return None
    if lf.sdf_kind == sir.SDF_SPHERE:
        r_local = 1.0
    elif lf.sdf_kind == sir.SDF_TORUS:
        r_local = 1.0 + float(lf.sdf_param)
    else:
        return None
    c = minv @ (-np.asarray(lf.m0, np.float64))
    smax = float(np.linalg.svd(minv, compute_uv=False)[0])
    return (c, r_local * smax)


def _leaf_bound(tab, row):
    """Conservative bounding sphere of one positive analytic leaf, or
    None when unbounded (planes, negations, open quadrics)."""
    if tab.neg[row]:
        return None
    if tab.kind[row] == sir.SPHERE:
        return (-np.asarray(tab.m0[row], np.float64),
                float(np.sqrt(-tab.rr[row])))
    if tab.kind[row] == sir.QUADRIC:
        M = np.asarray(tab.M[row], np.float64)
        m0 = np.asarray(tab.m0[row], np.float64)
        c2 = np.asarray(tab.c2[row], np.float64)
        rr = float(tab.rr[row])
        if np.all(c2 > 0) and rr < 0:        # ellipsoid
            try:
                Minv = np.linalg.inv(M)
            except np.linalg.LinAlgError:
                return None
            r_local = float(np.sqrt(-rr / np.min(c2)))
            smax = float(np.linalg.svd(Minv, compute_uv=False)[0])
            return (Minv @ (-m0), r_local * smax)
    return None


def _tree_bound(tree, rows, tab, sdf_leaves=None):
    """Bounding sphere of a subtree (None = unbounded).  An intersection
    is bounded by ANY bounded operand; a union needs both."""
    if tree[0] == "leaf":
        row = rows[tree[1]]
        if row >= 0:
            return _leaf_bound(tab, row)
        if sdf_leaves is not None and sdf_leaves[tree[1]] is not None:
            return _sdf_leaf_bound(sdf_leaves[tree[1]])
        return None
    if tree[0] == "not":
        return None
    b1 = _tree_bound(tree[1], rows, tab, sdf_leaves)
    b2 = _tree_bound(tree[2], rows, tab, sdf_leaves)
    if tree[0] == "and":
        if b1 is None:
            return b2
        if b2 is None:
            return b1
        return b1 if b1[1] <= b2[1] else b2
    if b1 is None or b2 is None:
        return None
    c1, r1 = b1
    c2_, r2 = b2
    d = float(np.linalg.norm(c2_ - c1))
    if d + r2 <= r1:
        return b1
    if d + r1 <= r2:
        return b2
    r = 0.5 * (d + r1 + r2)
    c = c1 + (c2_ - c1) * ((r - r1) / d if d > 0 else 0.0)
    return (c, r)


def _or_parts(tree):
    if tree[0] == "or":
        return _or_parts(tree[1]) + _or_parts(tree[2])
    return [tree]


def _tree_leaves(tree):
    if tree[0] == "leaf":
        return [tree[1]]
    if tree[0] == "not":
        return _tree_leaves(tree[1])
    return _tree_leaves(tree[1]) + _tree_leaves(tree[2])


def _reindex_tree(tree, mapping):
    if tree[0] == "leaf":
        return ("leaf", mapping[tree[1]])
    if tree[0] == "not":
        return ("not", _reindex_tree(tree[1], mapping))
    return (tree[0], _reindex_tree(tree[1], mapping),
            _reindex_tree(tree[2], mapping))


def _decompose_composite(comp, tab, eps):
    """Split a composite's top-level union into mini-composites for its
    spatially disjoint components (analytic AND SDF leaves — SDF parts
    bound through their local frames, _sdf_leaf_bound).  Components
    keep the parent's oid/material identity; bounded components get
    their own tight envelope.  Returns [comp] unchanged when nothing
    splits."""
    parts = _or_parts(comp.tree)
    if len(parts) < 2:
        return [comp]
    bounds = [_tree_bound(p, comp.rows, tab, comp.sdf_leaves)
              for p in parts]
    # connected components under "bounds may overlap" (None = everywhere)
    n = len(parts)
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def union(i, j):
        parent[find(i)] = find(j)

    # an unbounded part (contains planes/negations) may overlap anything:
    # it glues the whole union back together (conservative)
    margin = 8.0 * eps
    for i in range(n):
        for j in range(i + 1, n):
            if bounds[i] is None or bounds[j] is None:
                union(i, j)
                continue
            ci, ri = bounds[i]
            cj, rj = bounds[j]
            if np.linalg.norm(cj - ci) <= ri + rj + margin:
                union(i, j)
    comps: Dict[int, list] = {}
    for i in range(n):
        comps.setdefault(find(i), []).append(i)
    if len(comps) < 2:
        return [comp]
    def merge(b1, b2):
        if b1 is None or b2 is None:
            return None
        c1, r1 = b1
        c2_, r2 = b2
        d = float(np.linalg.norm(c2_ - c1))
        if d + r2 <= r1:
            return b1
        if d + r1 <= r2:
            return b2
        r = 0.5 * (d + r1 + r2)
        c = c1 + (c2_ - c1) * ((r - r1) / d if d > 0 else 0.0)
        return (c, r)

    out = []
    for idxs in comps.values():
        tree = parts[idxs[0]]
        bound = bounds[idxs[0]]
        for i in idxs[1:]:
            tree = ("or", tree, parts[i])
            bound = merge(bound, bounds[i])
        locs = sorted(set(_tree_leaves(tree)))
        mapping = {l: k for k, l in enumerate(locs)}
        new_tree = _reindex_tree(tree, mapping)
        new_rows = [comp.rows[l] for l in locs]
        new_sdfs = [comp.sdf_leaves[l] for l in locs]
        if bound is not None:
            env_c, env_r = bound[0], bound[1] * 1.001 + 4.0 * eps
        else:
            env_c, env_r = comp.env_c, comp.env_r
        sub = _Composite(comp.oid, new_tree, new_rows, new_sdfs,
                         env_c, env_r, comp.is_light)
        out.append(sub)
    return out


# ---------------------------------------------------------------------------


class Tracer:
    """Per-scene tracer over the unified leaf table: vectorized nearest /
    transition / shadow queries."""

    def __init__(self, ir: sir.SceneIR, dtype=jnp.float32, eps=None):
        self.ir = ir
        self.dtype = np.dtype(dtype)
        self.eps = eps if eps is not None else \
            (1e-6 if self.dtype == np.float64 else 1e-4)
        # differentiable-path hooks: `ovr` maps table names to traced
        # arrays replacing the baked constants; `diff` switches the SDF
        # `lax.while_loop` march to a fixed-trip scan (reverse-mode
        # differentiable).
        self.ovr = {}
        self.diff = False

        self.n_obj = len(ir.objects)
        self.is_light = np.array([o.is_light for o in ir.objects], bool)
        self.roughness = np.array([o.roughness for o in ir.objects],
                                  self.dtype)

        tab = _Unified(self.dtype)
        composites: List[_Composite] = []
        sdf_singles = []   # (leaf, oid, env_c, env_r, is_light)
        for oid, obj in enumerate(ir.objects):
            env_c = obj.env_c if obj.env_c is not None else None
            env_r = obj.env_r
            if obj.single_leaf:
                lf = obj.leaves[0]
                if lf.family == sir.SDF:
                    sdf_singles.append((lf, oid, lf.env_c if lf.env_c
                                        is not None else env_c,
                                        lf.env_r if lf.env_c is not None
                                        else (env_r if env_c is not None
                                              else -1.0), obj.is_light))
                else:
                    tab.add(lf, oid, obj.is_light, True, env_c,
                            env_r if env_c is not None else -1.0, None)
            else:
                ci = len(composites)
                rows, sdfs = [], []
                for li, lf in enumerate(obj.leaves):
                    if lf.family == sir.SDF:
                        rows.append(-1)
                        sdfs.append(lf)
                    else:
                        rows.append(tab.add(lf, oid, obj.is_light, False,
                                            None, -1.0, f"c{ci}_l{li}_"))
                        sdfs.append(None)
                composites.append(_Composite(
                    oid, obj.tree, rows, sdfs, env_c,
                    env_r if env_c is not None else -1.0, obj.is_light))
        tab.finalize()
        self.tab = tab
        self.composites = composites
        self.sdf_singles = sdf_singles
        self.n_sdf = len(sdf_singles)

        # group all-analytic composites by tree shape: members of a group
        # (e.g. the 10 identical lamps of hanging_lamps_in_row, reference
        # src_acn/hanging_lamps_in_row) evaluate as ONE batched
        # crossing-parity walk over a [R, G, NC] tensor instead of G
        # sequential per-composite blocks — compile size and launch count
        # drop by the group factor (hanging_lamp: 117 composites -> ~15
        # groups).  SDF-containing composites stay on the solo path.
        groups: Dict = {}
        self.comp_solo = []
        for comp in composites:
            if any(lf is not None for lf in comp.sdf_leaves):
                # SDF composites or-decompose too (round 5): the lamp
                # assemblies are unions of small disjoint parts, and
                # splitting them cuts the crossing-walk candidate count
                # quadratically while giving each part a tight envelope
                # (march clip + pair-compaction gates)
                self.comp_solo.extend(
                    _decompose_composite(comp, tab, self.eps))
                continue
            # or-decomposition first: disjoint union components evaluate
            # independently with tight envelopes, and their small trees
            # batch into few groups
            for sub in _decompose_composite(comp, tab, self.eps):
                groups.setdefault(repr(sub.tree), []).append(sub)
        self.comp_groups = list(groups.values())

        # static chunk partition of the single-leaf candidate rows
        self.single_rows = np.flatnonzero(tab.single).astype(np.int32)

        # jitted entry points for direct (non-integrator) use; the
        # integrator calls the raw methods inside its own jit instead
        self.nearest_jit = jax.jit(
            lambda p, d: self.nearest(p, d, matter_only=False))
        self.nearest_matter_jit = jax.jit(
            lambda p, d: self.nearest(p, d, matter_only=True))
        self.trans_hit_jit = jax.jit(self.trans_hit)
        self.shadow_t_jit = jax.jit(self.shadow_t)

    # -- differentiable table access -----------------------------------------

    def _t(self, name, value):
        """Table read with optional traced override."""
        o = self.ovr.get(name)
        return jnp.asarray(o if o is not None else value)

    def geom_params(self):
        """Export the differentiable geometry tables as a dict pytree whose
        keys match the `ovr` names (family arrays for single leaves,
        per-leaf keys for CSG composite leaves).  Standalone SDF objects
        export their frame/param under `sdfs{i}_*`: the march itself is
        a detached root-finder, but the converged offset is reattached
        through the implicit-function tangent dt*/dθ = -(∂f/∂θ)/(∂f/∂t)
        (see _hit_sdf_leaf).  SDF leaves inside CSG composites remain
        detached (their crossings feed a discrete parity walk)."""
        t = self.tab
        p = {}
        for si, (lf, _oid, _ec, _er, _light) in \
                enumerate(self.sdf_singles):
            p[f"sdfs{si}_m"] = lf.m
            p[f"sdfs{si}_m0"] = lf.m0
            p[f"sdfs{si}_prm"] = np.asarray(lf.sdf_param)
        if len(t.sph_rows):
            p["sph_c"] = t.sph_c
            p["sph_r"] = t.sph_r
        if len(t.pla_rows):
            p["pla_n"] = t.pla_n
            p["pla_k"] = t.pla_k
        if len(t.qua_rows):
            p["qua_m"] = t.qua_m
            p["qua_m0"] = t.qua_m0
            p["qua_coef"] = t.qua_coef
            p["qua_r"] = t.qua_r
        for row, key, fam in t.comp_keys:
            if fam == sir.PLANE:
                p[key + "n"] = t.c1[row]
                p[key + "k"] = t.rr[row]
            elif fam == sir.SPHERE:
                p[key + "c"] = -t.m0[row]
                p[key + "r"] = np.sqrt(-t.rr[row])
            elif fam == sir.QUADRIC:
                p[key + "m"] = t.M[row]
                p[key + "m0"] = t.m0[row]
                p[key + "coef"] = t.c2[row]
                p[key + "r"] = t.rr[row]
        return {k: jnp.asarray(np.asarray(v, self.dtype))
                for k, v in p.items()}

    def _assemble(self):
        """The traced (M, m0, c2, c1, rr) tables: static constants on the
        fast path; rebuilt from `ovr` reads in diff mode so geometry
        gradients flow into the unified rows."""
        t = self.tab
        if not self.ovr:
            return (jnp.asarray(t.M), jnp.asarray(t.m0), jnp.asarray(t.c2),
                    jnp.asarray(t.c1), jnp.asarray(t.rr))
        M = jnp.asarray(t.M); m0 = jnp.asarray(t.m0)
        c2 = jnp.asarray(t.c2); c1 = jnp.asarray(t.c1)
        rr = jnp.asarray(t.rr)
        if len(t.sph_rows):
            sc = self._t("sph_c", t.sph_c)
            sr = self._t("sph_r", t.sph_r)
            m0 = m0.at[t.sph_rows].set(-sc)
            rr = rr.at[t.sph_rows].set(-sr * sr)
        if len(t.pla_rows):
            pn = self._t("pla_n", t.pla_n)
            pk = self._t("pla_k", t.pla_k)
            c1 = c1.at[t.pla_rows].set(pn)
            rr = rr.at[t.pla_rows].set(pk)
        if len(t.qua_rows):
            qm = self._t("qua_m", t.qua_m)
            qm0 = self._t("qua_m0", t.qua_m0)
            qc = self._t("qua_coef", t.qua_coef)
            qr = self._t("qua_r", t.qua_r)
            M = M.at[t.qua_rows].set(qm)
            m0 = m0.at[t.qua_rows].set(qm0)
            c2 = c2.at[t.qua_rows].set(qc)
            rr = rr.at[t.qua_rows].set(qr)
        for row, key, fam in t.comp_keys:
            if fam == sir.PLANE:
                c1 = c1.at[row].set(self._t(key + "n", t.c1[row]))
                rr = rr.at[row].set(self._t(key + "k", t.rr[row]))
            elif fam == sir.SPHERE:
                c = self._t(key + "c", -t.m0[row])
                r = self._t(key + "r", np.sqrt(-t.rr[row]))
                m0 = m0.at[row].set(-c)
                rr = rr.at[row].set(-r * r)
            elif fam == sir.QUADRIC:
                M = M.at[row].set(self._t(key + "m", t.M[row]))
                m0 = m0.at[row].set(self._t(key + "m0", t.m0[row]))
                c2 = c2.at[row].set(self._t(key + "coef", t.c2[row]))
                rr = rr.at[row].set(self._t(key + "r", t.rr[row]))
        return M, m0, c2, c1, rr

    # -- unified root math ---------------------------------------------------

    def _quads(self, tabs, rows, p, d):
        """A t^2 + B t + C coefficients of all `rows` leaves along p+td.
        Returns (A, B, C, pl, dl) with pl/dl [R, c, 3]; the C coefficient
        equals side(p), giving origin inside-ness for free.

        precision=HIGHEST: a reduced-precision contraction corrupts the
        eps-shell root math (rays re-hit the surface they just left and
        the wavefront explodes with bogus children)."""
        M, m0, c2, c1, rr = tabs
        Mr = M[rows]                                # [c,3,3]
        import jax as _jax
        if self.dtype == np.float64 or _jax.default_backend() == "cpu":
            # CPU = the golden-corpus path (f32 AND f64 hashes are
            # committed against einsum contraction order): keep the
            # einsum so hit math stays bit-identical to the golden
            # hashes; CPU XLA fuses dot+elementwise fine anyway
            hi = jax.lax.Precision.HIGHEST
            pl = jnp.einsum("rj,lij->rli", p, Mr,
                            precision=hi) + m0[rows][None]
            dl = jnp.einsum("rj,lij->rli", d, Mr, precision=hi)
        else:
            # f32 accelerator path: pl/dl as UNROLLED elementwise
            # broadcasts, not einsum.  Three broadcast multiply-adds
            # fuse straight into the A/B/C reductions, so the [R,c,3]
            # frames need not exist in memory, and plain elementwise
            # arithmetic is exact f32 by construction (the einsum needs
            # precision=HIGHEST for that).
            pl = (p[:, None, None, 0] * Mr[None, :, :, 0]
                  + p[:, None, None, 1] * Mr[None, :, :, 1]
                  + p[:, None, None, 2] * Mr[None, :, :, 2]) \
                + m0[rows][None]
            dl = (d[:, None, None, 0] * Mr[None, :, :, 0]
                  + d[:, None, None, 1] * Mr[None, :, :, 1]
                  + d[:, None, None, 2] * Mr[None, :, :, 2])
        c2r = c2[rows][None]; c1r = c1[rows][None]
        A = jnp.sum(c2r * dl * dl, -1)
        Bq = 2.0 * jnp.sum(c2r * dl * pl, -1) + jnp.sum(c1r * dl, -1)
        Cq = jnp.sum(c2r * pl * pl, -1) + jnp.sum(c1r * pl, -1) + rr[rows][None]
        return A, Bq, Cq, pl, dl

    @staticmethod
    def _roots(A, Bq, Cq):
        """Both real roots (t0 <= t1, INF where none) of A t^2+B t+C=0 in a
        cancellation-stable form, plus the normalized (s, q) used by the
        sphere entry/exit policy and the linear root for A == 0."""
        is_quad = A != 0
        safe_A = jnp.where(is_quad, A, 1.0)
        s = (Bq * 0.5) / safe_A
        q = Cq / safe_A
        disc = s * s - q
        ok = is_quad & (disc >= 0)
        root = safe_sqrt(jnp.where(ok, disc, 0.0))
        ta = -s - root
        tb = -s + root
        tb_nz = jnp.abs(tb) > 0
        ta_nz = jnp.abs(ta) > 0
        t0 = jnp.where(s < 0, jnp.where(tb_nz, q / jnp.where(tb_nz, tb, 1.0),
                                        ta), ta)
        t1 = jnp.where(s > 0, jnp.where(ta_nz, q / jnp.where(ta_nz, ta, 1.0),
                                        tb), tb)
        lin_nz = Bq != 0
        t_lin = jnp.where(lin_nz, -Cq / jnp.where(lin_nz, Bq, 1.0), INF)
        t0u = jnp.where(is_quad, jnp.where(ok, t0, INF), t_lin)
        t1u = jnp.where(is_quad, jnp.where(ok, t1, INF), INF)
        return t0u, t1u, s, q, ok, is_quad

    def _policy(self, kind_rows, t0u, t1u, s, q, ok):
        """First-hit offset per leaf column under its family's root policy
        (eps-backed).  kind_rows is static numpy [c]."""
        is_pl = (kind_rows == sir.PLANE)[None, :]
        is_sp = (kind_rows == sir.SPHERE)[None, :]
        # plane: forward crossing (reference src/gmath.h:38-49)
        a_pl = jnp.where(t0u > 0, t0u - self.eps, INF)
        # sphere: entry when outside+approaching, exit when inside
        # (reference src/gmath.h:64-85)
        entering = (s < 0) & (q > 0)
        exiting = (s < 0) | (q < 0)
        a_sp = jnp.where(entering, t0u, jnp.where(exiting, t1u, INF))
        a_sp = jnp.where(ok, a_sp - self.eps, INF)
        # quadric: smaller non-negative root (reference src/objects.c:791-801)
        a_qu = jnp.where(t0u >= 0, t0u, jnp.where(t1u >= 0, t1u, INF))
        a_qu = jnp.where(jnp.isfinite(a_qu), a_qu - self.eps, INF)
        return jnp.where(is_pl, a_pl, jnp.where(is_sp, a_sp, a_qu))

    def _env_gate_rows(self, rows, p, d):
        """Envelope culling mask per candidate column (envelope_s_ray_hits,
        reference src/objects.c:90-96): True = keep.  Static numpy env."""
        t = self.tab
        ec = jnp.asarray(t.env_c[rows])[None]        # [1,c,3]
        er = jnp.asarray(t.env_r[rows])[None]        # [1,c]
        pp = p[:, None, :] - ec
        s = _dot(pp, d[:, None, :])
        q = _dot(pp, pp) - er * er
        disc = s * s - q
        exists = (disc >= 0) & ((s < 0) | (q < 0))
        return (er <= 0) | exists

    def _env_gate_one(self, env_c, env_r, p, d):
        ec = jnp.asarray(np.asarray(env_c, self.dtype))
        pp = p - ec
        s = _dot(pp, d)
        q = _dot(pp, pp) - self.dtype.type(env_r) ** 2
        disc = s * s - q
        return (disc >= 0) & ((s < 0) | (q < 0))

    # -- SDF leaves ----------------------------------------------------------

    def _sdf_local(self, lf: sir.Leaf, p, d):
        """Ray into the SDF leaf's local unit frame; returns (pl, dl_unit,
        dn) with dn the direction's local norm (offset rescale factor)."""
        dt = self.dtype
        hi = jax.lax.Precision.HIGHEST
        m = jnp.asarray(lf.m.astype(dt)); m0 = jnp.asarray(lf.m0.astype(dt))
        pl = jnp.einsum("ij,rj->ri", m, p, precision=hi) + m0
        dl0 = jnp.einsum("ij,rj->ri", m, d, precision=hi)
        dn = jnp.sqrt(jnp.sum(dl0 * dl0, -1))
        dl = dl0 / jnp.where(dn > 0, dn, 1.0)[:, None]
        return pl, dl, dn

    def _sdf_march(self, lf: sir.Leaf, pl, dl, offs0, dead):
        """Bounded bidirectional sphere march from local offset offs0
        (reference src/objects.c:903-959).  Returns (offs_local, dist)."""
        dt = self.dtype
        eps = self.eps
        R = pl.shape[0]
        p0 = pl + dl * offs0[:, None]
        dist0 = _sdf_eval(lf.sdf_kind, lf.sdf_param, p0)
        forward = dist0 > 0

        def body(carry):
            i, offs1, dist, active = carry
            step = jnp.where(forward, dist + eps, -(dist - eps))
            offs1 = jnp.where(active, offs1 + step, offs1)
            dnew = _sdf_eval(lf.sdf_kind, lf.sdf_param,
                             p0 + dl * offs1[:, None])
            dist = jnp.where(active, dnew, dist)
            crossed = jnp.where(forward, (dist < 0) | (dist > 1e30),
                                (dist > 0) | (dist < -1e30))
            return i + 1, offs1, dist, active & ~crossed

        init = (jnp.int32(0), jnp.zeros((R,), dt), dist0, ~dead)
        if self.diff:
            def sbody(carry, _):
                return body(carry), None
            (_, offs1, dist, _), _ = jax.lax.scan(sbody, init, None,
                                                  length=lf.cycles)
        else:
            def cond(carry):
                i, _, _, active = carry
                return (i < lf.cycles) & jnp.any(active)
            _, offs1, dist, _ = jax.lax.while_loop(cond, body, init)
        return offs0 + offs1, dist

    def _sdf_normal(self, lf: sir.Leaf, q_local):
        """Forward-difference gradient normal in world space (reference
        src/objects.c:940-952), with the Neg flip baked in."""
        dt = self.dtype
        eps = self.eps
        m = jnp.asarray(lf.m.astype(dt))
        d0 = _sdf_eval(lf.sdf_kind, lf.sdf_param, q_local)
        ex = jnp.asarray(np.eye(3, dtype=dt))
        grad = jnp.stack([
            (_sdf_eval(lf.sdf_kind, lf.sdf_param, q_local + ex[i] * eps)
             - d0) / eps for i in range(3)], axis=-1)
        nor = _norm3(jnp.einsum("ri,ij->rj", grad, m))
        return -nor if lf.neg else nor

    def _hit_sdf_leaf(self, lf: sir.Leaf, env_c, env_r, p, d, si=None):
        """First hit of a standalone SDF object: envelope-clipped entry,
        bounded march, gradient normal.

        Differentiation (diff mode, si = sdf_singles index): the march
        is a detached root-finder for the converged world offset t*, but
        the hit condition f(t*; θ, p, d) = sdf(M(p + t*d) + m0; prm) = 0
        defines t* implicitly, so the tangent is closed-form:
        dt*/dθ = -(∂f/∂θ)/(∂f/∂t) (round-4 verdict next #6).  The
        offset is reattached as the Newton step t* - f/sg(∂f/∂t): the
        primal moves by at most the march's acceptance shell (|f| <=
        1.5 eps — in diff mode only), and the tangent is the
        implicit-function derivative, so central differences of the
        SAME function equal the AD gradient — gradients flow into the
        SDF frame/param (via geom_params overrides sdfs{i}_*) AND into
        the ray (p, d) for upstream transform terms."""
        dt = self.dtype
        p_t, d_t = p, d
        if self.diff:
            p = jax.lax.stop_gradient(p)
            d = jax.lax.stop_gradient(d)
        R = p.shape[0]
        if env_c is not None and env_r > 0:
            ec = jnp.asarray(np.asarray(env_c, dt))
            outside = _dot(p - ec, p - ec) > env_r * env_r
            t_env = _sphere_first_hit(ec, jnp.asarray(dt.type(env_r)),
                                      p, d, 0.0)
            dead = outside & ~jnp.isfinite(t_env)
            offs0w = jnp.where(outside & jnp.isfinite(t_env), t_env, 0.0)
        else:
            dead = jnp.zeros((R,), bool)
            offs0w = jnp.zeros((R,), dt)
        pl, dl, dn = self._sdf_local(lf, p + d * offs0w[:, None], d)
        offs_l, dist = self._sdf_march(lf, pl, dl, jnp.zeros((R,), dt), dead)
        hit = (~dead) & (jnp.abs(dist) <= MARCH_ACCEPT * self.eps)
        t_star = offs0w + offs_l / jnp.where(dn > 0, dn, 1.0)
        if self.diff and si is not None:
            sg = jax.lax.stop_gradient
            hi = jax.lax.Precision.HIGHEST
            m_t = jnp.asarray(self._t(f"sdfs{si}_m",
                                      lf.m.astype(dt)), dt)
            m0_t = jnp.asarray(self._t(f"sdfs{si}_m0",
                                       lf.m0.astype(dt)), dt)
            prm_t = jnp.asarray(self._t(f"sdfs{si}_prm",
                                        np.asarray(lf.sdf_param, dt)), dt)
            q_w = p_t + d_t * t_star[:, None]
            ql_t = jnp.einsum("ij,rj->ri", m_t, q_w, precision=hi) + m0_t
            f = _sdf_eval(lf.sdf_kind, prm_t, ql_t)
            # detached slope df/dt along the ray: local SDF gradient
            # (forward differences, objects.c:940-952 form) dotted with
            # the local direction per world unit
            ql_d = sg(ql_t)
            d0 = _sdf_eval(lf.sdf_kind, sg(prm_t), ql_d)
            ex = jnp.asarray(np.eye(3, dtype=dt))
            grad_l = jnp.stack(
                [(_sdf_eval(lf.sdf_kind, sg(prm_t),
                            ql_d + ex[i] * self.eps) - d0) / self.eps
                 for i in range(3)], axis=-1)
            dl_w = jnp.einsum("ij,rj->ri", sg(m_t), d, precision=hi)
            fp = sg(_dot(grad_l, dl_w))
            # silhouette-grazing rays have ∂f/∂t -> 0: their implicit
            # derivative is unbounded (the correct treatment is an edge
            # term, _nee_edge_terms); gate the reattach to
            # well-conditioned rays so neither the primal correction
            # f/fp nor the tangent blows up (|f| <= 1.5 eps at the
            # converged point, so the gated correction stays <= 150 eps
            # per local-direction unit)
            fp_ok = jnp.abs(fp) > 0.01 * sg(dn)
            fp_safe = jnp.where(fp_ok, fp, 1.0)
            t_star = t_star - jnp.where(fp_ok, f / fp_safe, 0.0)
            lf_t = _LeafP(lf, m_t, m0_t, prm_t)
            nor = self._sdf_normal(lf_t, ql_t)
        else:
            q_local = pl + dl * offs_l[:, None]
            nor = self._sdf_normal(lf, q_local)
        a = jnp.where(hit, t_star - self.eps, INF)
        return a, nor

    def _sdf_crossings(self, lf: sir.Leaf, p, d, k: int, t_start=None,
                       t_stop=None, alive=None):
        """Up to k forward surface crossings of an SDF leaf along p+td
        (world offsets, INF-padded) — the crossing supply for SDF leaves
        inside CSG composites (reference pair-marching accepts any child
        object, src/objects.c:1052-1094).  Each crossing is found by a
        bounded march; the next march restarts just past the surface
        shell.

        t_start/t_stop/alive (world offsets / mask) clip the march to
        the owning composite's envelope interval, mirroring the
        reference's envelope early-outs (obj_ray_hit, src/objects.c:
        261-284): rays that miss the envelope never march, and marches
        start at the envelope entry instead of the ray origin — on
        hanging_lamp the unclipped form marched 75 scanned lamp members
        x 4 crossings x up-to-200 cycles for every ray in the batch."""
        dt = self.dtype
        if self.diff:
            p = jax.lax.stop_gradient(p)
            d = jax.lax.stop_gradient(d)
        R = p.shape[0]
        pl, dl, dn = self._sdf_local(lf, p, d)
        dn_safe = jnp.where(dn > 0, dn, 1.0)
        out = []
        if t_start is None:
            offs = jnp.zeros((R,), dt)
        else:
            offs = jnp.maximum(t_start, 0.0) * dn
        dead = jnp.zeros((R,), bool) if alive is None else ~alive
        stop_l = None if t_stop is None else t_stop * dn
        for _ in range(k):
            offs_l, dist = self._sdf_march(lf, pl, dl, offs, dead)
            hit = (~dead) & (jnp.abs(dist) <= MARCH_ACCEPT * self.eps)
            if stop_l is not None:
                hit = hit & (offs_l <= stop_l)
            t_world = jnp.where(hit & (offs_l > 0), offs_l / dn_safe, INF)
            out.append(t_world)
            dead = dead | ~hit
            offs = offs_l + 4.0 * self.eps   # step through the eps shell
        return jnp.stack(out, axis=-1)       # [R, k]

    def _env_interval(self, env_c, env_r, p, d):
        """(gate, t_in, t_out) of the envelope sphere along p+td; t_in
        clamped to 0 when starting inside."""
        pp = p - env_c
        s = _dot(pp, d)
        q = _dot(pp, pp) - env_r * env_r
        disc = s * s - q
        gate = (disc >= 0) & ((s < 0) | (q < 0))
        root = safe_sqrt(jnp.maximum(disc, 0.0))
        t_in = jnp.maximum(-s - root, 0.0)
        t_out = -s + root
        return gate, t_in, t_out

    # -- composite objects -----------------------------------------------

    @staticmethod
    def _tree_eval_mask(tree, leaf_vals):
        """Static unroll of the CSG tree program; leaf_vals(li) yields the
        bool inside-mask of local leaf li."""
        if tree[0] == "leaf":
            return leaf_vals(tree[1])
        if tree[0] == "and":
            return Tracer._tree_eval_mask(tree[1], leaf_vals) \
                & Tracer._tree_eval_mask(tree[2], leaf_vals)
        if tree[0] == "or":
            return Tracer._tree_eval_mask(tree[1], leaf_vals) \
                | Tracer._tree_eval_mask(tree[2], leaf_vals)
        if tree[0] == "not":
            return ~Tracer._tree_eval_mask(tree[1], leaf_vals)
        raise ValueError(tree)

    def _composite_crossings(self, comp: _Composite, tabs, p, d):
        """Forward crossings [R, NC] + per-column local leaf ids + origin
        inside bits [R, Lc] for one composite."""
        arows = np.asarray([r for r in comp.rows if r >= 0], np.int32)
        cross_cols = []
        leaf_of_col = []
        inside = [None] * len(comp.rows)
        if len(arows):
            A, Bq, Cq, _, _ = self._quads(tabs, arows, p, d)
            t0u, t1u, _, _, _, _ = self._roots(A, Bq, Cq)
            ai = 0
            for li, row in enumerate(comp.rows):
                if row < 0:
                    continue
                cross_cols.append(t0u[:, ai]); leaf_of_col.append(li)
                cross_cols.append(t1u[:, ai]); leaf_of_col.append(li)
                inside[li] = Cq[:, ai] <= 0   # side(p) = C
                ai += 1
        gate = t_in = t_out = None
        if comp.env_c is not None and comp.env_r > 0 \
                and any(lf is not None for lf in comp.sdf_leaves) \
                and _env_clip_marches():
            ec = jnp.asarray(np.asarray(comp.env_c, self.dtype))
            gate, t_in, t_out = self._env_interval(
                ec, self.dtype.type(comp.env_r), p, d)
            slack = 8.0 * self.eps
            t_in = jnp.maximum(t_in - slack, 0.0)
            t_out = t_out + slack
        for li, lf in enumerate(comp.sdf_leaves):
            if lf is None:
                continue
            ts = self._sdf_crossings(lf, p, d, SDF_CROSSINGS,
                                     t_start=t_in, t_stop=t_out,
                                     alive=gate)
            for kk in range(SDF_CROSSINGS):
                cross_cols.append(ts[:, kk]); leaf_of_col.append(li)
            plq = jnp.einsum("ij,rj->ri", jnp.asarray(lf.m.astype(self.dtype)),
                             p) + jnp.asarray(lf.m0.astype(self.dtype))
            inside[li] = _sdf_eval(lf.sdf_kind, lf.sdf_param, plq) <= 0
        cross = jnp.stack(cross_cols, axis=-1)          # [R, NC]
        cross = jnp.where(cross > 0, cross, INF)
        return cross, np.asarray(leaf_of_col, np.int32), inside

    def _walk(self, comp: _Composite, cross, leaf_of_col, inside):
        """Crossing-parity walk of ONE composite: the G=1 case of
        _group_walk.  Returns (t_boundary [R] raw, local leaf id [R])."""
        inside0 = jnp.stack([inside[li] for li in range(len(comp.rows))],
                            axis=-1)
        hit_t, leaf_loc = self._group_walk(
            comp.tree, cross[:, None, :], leaf_of_col,
            inside0[:, None, :])
        return hit_t[:, 0], leaf_loc[:, 0]

    def _hit_composite(self, comp: _Composite, tabs, p, d):
        """Boundary hit of one composite.  Returns (t [R] eps-backed,
        local leaf [R], global row [R] (-1 for SDF leaves),
        sdf index map)."""
        cross, leaf_of_col, inside = self._composite_crossings(
            comp, tabs, p, d)
        hit_t, leaf_loc = self._walk(comp, cross, leaf_of_col, inside)
        if comp.env_c is not None and comp.env_r > 0:
            gate = self._env_gate_one(comp.env_c, comp.env_r, p, d)
            hit_t = jnp.where(gate, hit_t, INF)
        rows_map = jnp.asarray(np.asarray(comp.rows, np.int32))
        row = rows_map[leaf_loc]
        a = jnp.where(jnp.isfinite(hit_t), hit_t - self.eps, INF)
        return a, leaf_loc, row

    def _shadow_composite(self, comp: _Composite, tabs, p, d, limit):
        """Any boundary flip within (0, limit]: the shadow-side equivalent
        of _hit_composite without argmin/normals."""
        cross, leaf_of_col, inside = self._composite_crossings(
            comp, tabs, p, d)
        hit_t, _ = self._walk(comp, cross, leaf_of_col, inside)
        blocked = jnp.isfinite(hit_t) & (hit_t - self.eps <= limit)
        if comp.env_c is not None and comp.env_r > 0:
            blocked = blocked & self._env_gate_one(comp.env_c, comp.env_r,
                                                   p, d)
        return blocked

    # -- scanned solo-composite clusters -----------------------------------

    def _solo_clusters(self):
        """Partition of comp_solo into shape-identical clusters: same CSG
        tree, same analytic/SDF slot pattern, same static SDF kinds, same
        envelope presence.  Members of a cluster differ only in numeric
        parameters (rows/transforms/envelopes), so they evaluate as ONE
        lax.scan over stacked member parameters — the module embeds the
        per-composite body once per *shape* instead of once per
        *composite* (hanging_lamps_in_row: 760 solo blocks -> 3 scanned
        bodies; an unrolled trace of that scene exceeded 8e5 jaxpr eqns
        and hours of XLA compile)."""
        if not hasattr(self, "_solo_cl"):
            clusters: Dict = {}
            for comp in self.comp_solo:
                key = (repr(comp.tree),
                       tuple(r >= 0 for r in comp.rows),
                       tuple(None if lf is None else
                             (lf.sdf_kind, int(lf.cycles), bool(lf.neg))
                             for lf in comp.sdf_leaves),
                       comp.env_c is not None and comp.env_r > 0,
                       comp.is_light)
                clusters.setdefault(key, []).append(comp)
            self._solo_cl = list(clusters.values())
        return self._solo_cl

    def _cluster_stacks(self, cluster):
        """Stacked per-member parameter arrays (leading axis = member)
        for one shape cluster."""
        dt = self.dtype
        proto = cluster[0]
        pattern = [r >= 0 for r in proto.rows]
        sdf_slots = [li for li, lf in enumerate(proto.sdf_leaves)
                     if lf is not None]
        xs = {}
        if any(pattern):
            xs["arows"] = jnp.asarray(np.asarray(
                [[r for r in c.rows if r >= 0] for c in cluster],
                np.int32))
        for li in sdf_slots:
            xs[f"m{li}"] = jnp.asarray(np.stack(
                [np.asarray(c.sdf_leaves[li].m, dt) for c in cluster]))
            xs[f"m0{li}"] = jnp.asarray(np.stack(
                [np.asarray(c.sdf_leaves[li].m0, dt) for c in cluster]))
            xs[f"prm{li}"] = jnp.asarray(np.asarray(
                [c.sdf_leaves[li].sdf_param for c in cluster], dt))
        if proto.env_c is not None and proto.env_r > 0:
            xs["env_c"] = jnp.asarray(np.stack(
                [np.asarray(c.env_c, dt) for c in cluster]))
            xs["env_r"] = jnp.asarray(np.asarray(
                [c.env_r for c in cluster], dt))
        xs["rows_map"] = jnp.asarray(np.asarray(
            [c.rows for c in cluster], np.int32))
        return proto, pattern, sdf_slots, xs

    def _solo_body_core(self, proto, pattern, sdf_slots, x, tabs, p, d,
                        alive=None):
        """One member's crossings + parity walk (the exact op sequence of
        _composite_crossings/_walk with traced per-member parameters).
        `alive` (optional [R] bool) ANDs into the envelope gate — the
        pair-compacted path uses it to keep capacity-fill lanes out of
        the SDF march loops.  Returns (hit_t raw, leaf_loc, env gate or
        None)."""
        Lc = len(proto.rows)
        cross_cols = []
        leaf_of_col = []
        inside = [None] * Lc
        gate = t_in = t_out = None
        if "env_c" in x:
            gate, t_in, t_out = self._env_interval(x["env_c"], x["env_r"],
                                                   p, d)
            if alive is not None:
                gate = gate & alive
            if _env_clip_marches():
                slack = 8.0 * self.eps
                t_in = jnp.maximum(t_in - slack, 0.0)
                t_out = t_out + slack
            else:
                t_in = t_out = None
        if "arows" in x:
            A, Bq, Cq, _, _ = self._quads(tabs, x["arows"], p, d)
            t0u, t1u, _, _, _, _ = self._roots(A, Bq, Cq)
            ai = 0
            for li, has in enumerate(pattern):
                if not has:
                    continue
                cross_cols.append(t0u[:, ai]); leaf_of_col.append(li)
                cross_cols.append(t1u[:, ai]); leaf_of_col.append(li)
                inside[li] = Cq[:, ai] <= 0
                ai += 1
        for li in sdf_slots:
            lf = _LeafP(proto.sdf_leaves[li], x[f"m{li}"], x[f"m0{li}"],
                        x[f"prm{li}"])
            # march only within the composite's envelope interval
            ts = self._sdf_crossings(lf, p, d, SDF_CROSSINGS,
                                     t_start=t_in, t_stop=t_out,
                                     alive=gate)
            for kk in range(SDF_CROSSINGS):
                cross_cols.append(ts[:, kk]); leaf_of_col.append(li)
            plq = jnp.einsum("ij,rj->ri",
                             jnp.asarray(lf.m.astype(self.dtype)),
                             p) + jnp.asarray(lf.m0.astype(self.dtype))
            inside[li] = _sdf_eval(lf.sdf_kind, lf.sdf_param, plq) <= 0
        cross = jnp.stack(cross_cols, axis=-1)
        cross = jnp.where(cross > 0, cross, INF)
        inside0 = jnp.stack([inside[li] for li in range(Lc)], axis=-1)
        hit_t, leaf_loc = self._group_walk(
            proto.tree, cross[:, None, :],
            np.asarray(leaf_of_col, np.int32), inside0[:, None, :])
        hit_t, leaf_loc = hit_t[:, 0], leaf_loc[:, 0]
        return hit_t, leaf_loc, gate

    def _solo_scan_hit(self, cluster, tabs, p, d):
        """Boundary hits + winner rows + winner SDF normals for a whole
        shape cluster, one scanned body.  Returns (a [G,R] eps-backed
        env-gated, row [G,R], nor [G,R,3])."""
        dt = self.dtype
        proto, pattern, sdf_slots, xs = self._cluster_stacks(cluster)

        def body(_, x):
            hit_t, leaf_loc, gate = self._solo_body_core(
                proto, pattern, sdf_slots, x, tabs, p, d)
            if gate is not None:
                hit_t = jnp.where(gate, hit_t, INF)
            row = x["rows_map"][leaf_loc]
            a = jnp.where(jnp.isfinite(hit_t), hit_t - self.eps, INF)
            t_safe = jnp.where(jnp.isfinite(a), a, 0.0)
            hx = p + d * t_safe[:, None]
            nor = jnp.zeros(p.shape, dt)
            for li in sdf_slots:
                lf = _LeafP(proto.sdf_leaves[li], x[f"m{li}"],
                            x[f"m0{li}"], x[f"prm{li}"])
                m = jnp.asarray(lf.m.astype(dt))
                m0l = jnp.asarray(lf.m0.astype(dt))
                ql = jnp.einsum("ij,rj->ri", m, hx) + m0l
                nl = self._sdf_normal(lf, ql)
                nor = jnp.where((leaf_loc == li)[:, None], nl, nor)
            return None, (a, row, nor)

        _, (a_g, row_g, nor_g) = jax.lax.scan(body, None, xs)
        return a_g, row_g, nor_g

    def _solo_scan_shadow(self, cluster, tabs, p, d, limit):
        """Any-hit shadow over a whole shape cluster (the scanned form of
        _shadow_composite); returns blocked [R]."""
        proto, pattern, sdf_slots, xs = self._cluster_stacks(cluster)
        R = p.shape[0]

        def body(blocked, x):
            hit_t, _, gate = self._solo_body_core(
                proto, pattern, sdf_slots, x, tabs, p, d)
            b = jnp.isfinite(hit_t) & (hit_t - self.eps <= limit)
            if gate is not None:
                b = b & gate
            return blocked | b, None

        blocked, _ = jax.lax.scan(body, jnp.zeros((R,), bool), xs)
        return blocked

    # -- gate-compacted pair evaluation --------------------------------------

    def _pairs_ok(self, cluster):
        """The compacted path needs per-member envelopes (the gates ARE
        the compaction signal) and only pays off for multi-member
        clusters."""
        proto = cluster[0]
        return (_pair_compact_on() and len(cluster) >= 2
                and not self.diff
                and proto.env_c is not None and proto.env_r > 0)

    def _pair_select(self, xs, p, d, extra=()):
        """Live (ray, member) pairs of one cluster: envelope gates [M, R]
        compacted to the first P = min(M, PAIR_K) * R live pair slots.
        Returns (xp, pp, dd, r_idx, ok, num, P, m_idx, *extra-gathers) —
        per-pair member params / ray origin / direction (fill lanes get
        far-away origins and d = 0 so their envelope gate is False),
        target ray index, validity mask, true live count, capacity,
        member index.  Measured
        sparsity (hanging_lamp camera rays, 8k-ray batch): mean 0.25
        live members per ray out of 76 — the member-scan evaluates the
        other 99.7% as envelope-dead march lanes."""
        R = p.shape[0]
        M = xs["env_c"].shape[0]
        gate, _, _ = jax.vmap(
            lambda c, r: self._env_interval(c, r, p, d))(
                xs["env_c"], xs["env_r"])                    # [M, R]
        P = min(M, PAIR_K) * R
        flat = gate.reshape(-1)
        num = jnp.sum(flat.astype(jnp.int32))
        idx = jnp.nonzero(flat, size=P, fill_value=0)[0]
        ok = jnp.arange(P) < num
        m_idx = (idx // R).astype(jnp.int32)
        r_idx = (idx - m_idx * R).astype(jnp.int32)
        xp = {k: v[m_idx] for k, v in xs.items()}
        pp = p[r_idx]
        # fill lanes: origin pushed far outside every envelope and d = 0
        # -> env gate False -> the march while_loops never iterate them
        pp = jnp.where(ok[:, None], pp, pp + jnp.asarray(1e8, self.dtype))
        dd = jnp.where(ok[:, None], d[r_idx], 0.0)
        ex = tuple(a[r_idx] for a in extra)
        return (xp, pp, dd, r_idx, ok, num, P, m_idx) + ex

    def _solo_pairs_shadow(self, cluster, tabs, p, d, limit):
        """Any-hit shadow of a whole shape cluster evaluated only on live
        (ray, member) envelope pairs: the member axis of the scanned form
        compacts away, so SDF march work scales with rays-that-can-hit
        instead of members x rays.  Falls back to the dense scan (ONE
        lax.cond branch) iff the live pair count overflows the static
        capacity — the compacted result is exact whenever it is taken."""
        proto, pattern, sdf_slots, xs = self._cluster_stacks(cluster)
        R = p.shape[0]
        M = len(cluster)
        xp, pp, dd, r_idx, ok, num, P, _m, lim_p = self._pair_select(
            xs, p, d, extra=(limit,))

        def compact(_):
            def one(xm, p1, d1, ok1):
                hit_t, _, g = self._solo_body_core(
                    proto, pattern, sdf_slots, xm, tabs,
                    p1[None], d1[None], alive=ok1[None])
                return hit_t[0], g[0]

            a_p, g_p = jax.vmap(one)(xp, pp, dd, ok)
            b = ok & g_p & jnp.isfinite(a_p) & (a_p - self.eps <= lim_p)
            return jnp.zeros((R,), jnp.int32).at[r_idx].max(
                b.astype(jnp.int32)) > 0

        if P == 0:               # degenerate capacity: dense only
            return self._solo_scan_shadow(cluster, tabs, p, d, limit)
        if M <= PAIR_K:          # capacity covers all pairs: no fallback
            return compact(None)
        return jax.lax.cond(
            num <= P, compact,
            lambda _: self._solo_scan_shadow(cluster, tabs, p, d, limit),
            operand=None)

    def _solo_cluster_shadow(self, cluster, tabs, p, d, limit):
        """Dispatch: pair-compacted off-CPU, member-scanned otherwise."""
        if self._pairs_ok(cluster):
            return self._solo_pairs_shadow(cluster, tabs, p, d, limit)
        return self._solo_scan_shadow(cluster, tabs, p, d, limit)

    def _solo_pairs_hit(self, cluster, tabs, p, d):
        """Cluster-level TOP-2 boundary hits from live (ray, member)
        pairs: (a1, row1, oid1, nor1, a2, row2, oid2, nor2), each [R]
        ([R,3] normals).  Feeding a cluster's top-2 into the global
        column merge is exact (top-2 of a union = top-2 over per-part
        top-2s) and replaces M member columns with 2 — oids ride either
        the winner's table row (analytic winner) or the per-ray member
        oid (SDF winner, row == -1).  Tie policy matches the scanned
        form: lowest member index wins (pair ids are member-major).
        Overflow of the pair capacity falls back to the dense scan
        reduced the same way (ONE lax.cond)."""
        proto, pattern, sdf_slots, xs = self._cluster_stacks(cluster)
        dt = self.dtype
        R = p.shape[0]
        M = len(cluster)
        oid_arr = jnp.asarray(np.asarray([c.oid for c in cluster],
                                         np.int32))
        xp, pp, dd, r_idx, ok, num, P, m_idx = self._pair_select(xs, p, d)

        def compact(_):
            def one(xm, p1, d1, ok1):
                hit_t, leaf_loc, g = self._solo_body_core(
                    proto, pattern, sdf_slots, xm, tabs,
                    p1[None], d1[None], alive=ok1[None])
                if g is not None:
                    hit_t = jnp.where(g, hit_t, INF)
                row = xm["rows_map"][leaf_loc]
                a = jnp.where(jnp.isfinite(hit_t), hit_t - self.eps, INF)
                t_safe = jnp.where(jnp.isfinite(a), a, 0.0)
                hx = p1[None] + d1[None] * t_safe[:, None]
                nor = jnp.zeros((1, 3), dt)
                for li in sdf_slots:
                    lf = _LeafP(proto.sdf_leaves[li], xm[f"m{li}"],
                                xm[f"m0{li}"], xm[f"prm{li}"])
                    m = jnp.asarray(lf.m.astype(dt))
                    m0l = jnp.asarray(lf.m0.astype(dt))
                    ql = jnp.einsum("ij,rj->ri", m, hx) + m0l
                    nl = self._sdf_normal(lf, ql)
                    nor = jnp.where((leaf_loc == li)[:, None], nl, nor)
                return a[0], row[0], nor[0]

            a_p, row_p, nor_p = jax.vmap(one)(xp, pp, dd, ok)
            a_p = jnp.where(ok, a_p, INF)
            oid_p = oid_arr[m_idx]
            pid = jnp.arange(P, dtype=jnp.int32)
            BIGI = jnp.int32(P)
            big = jnp.full((R,), INF, dt)

            def winner(av):
                amin = big.at[r_idx].min(av)
                isw = jnp.isfinite(av) & (av == amin[r_idx])
                w = jnp.full((R,), BIGI, jnp.int32).at[r_idx].min(
                    jnp.where(isw, pid, BIGI))
                okw = w < BIGI
                wi = jnp.minimum(w, max(P - 1, 0))
                row = jnp.where(okw, row_p[wi], -1)
                oid = jnp.where(okw, oid_p[wi], -1)
                nor = jnp.where(okw[:, None], nor_p[wi], 0.0)
                return amin, row, oid, nor, w

            a1, row1, oid1, nor1, w1 = winner(a_p)
            a_p2 = jnp.where(pid == w1[r_idx], INF, a_p)
            a2, row2, oid2, nor2, _ = winner(a_p2)
            return a1, row1, oid1, nor1, a2, row2, oid2, nor2

        def dense(_):
            a_g, row_g, nor_g = self._solo_scan_hit(cluster, tabs, p, d)
            aT = jnp.swapaxes(a_g, 0, 1)                  # [R, M]
            t12, sel = _top2_cols(aT)
            rowT = jnp.swapaxes(row_g, 0, 1)
            row12 = jnp.take_along_axis(rowT, sel, axis=1)
            norT = jnp.swapaxes(nor_g, 0, 1)              # [R, M, 3]
            nor12 = jnp.take_along_axis(
                norT, sel[..., None], axis=1)             # [R, 2, 3]
            oid12 = oid_arr[sel]
            fin = jnp.isfinite(t12)
            row12 = jnp.where(fin, row12, -1)
            oid12 = jnp.where(fin, oid12, -1)
            # miss columns carry junk normals (computed at t=0); zero
            # them like the compacted form so both branches agree
            nor12 = jnp.where(fin[..., None], nor12, 0.0)
            return (t12[:, 0], row12[:, 0], oid12[:, 0], nor12[:, 0],
                    t12[:, 1], row12[:, 1], oid12[:, 1], nor12[:, 1])

        if P == 0:               # degenerate capacity: dense only
            return dense(None)
        if M <= PAIR_K:
            return compact(None)
        return jax.lax.cond(num <= P, compact, dense, operand=None)

    # -- batched composite groups ------------------------------------------

    def _group_walk_poly(self, tree, cross, leaf_of_col, root_of_col,
                         Aq, Bq, Cq):
        """Polynomial-sign crossing walk, batched over a composite group
        axis: each leaf's inside-ness at a candidate offset t is the SIGN
        of its own quadratic side(t) = A t^2 + B t + C — evaluated
        directly, no crossing-parity bookkeeping at all.  Just-before /
        just-after at the candidate use the derivative s' = 2At + B
        (near-zero s resolves by crossing direction), and the candidate's
        OWN leaf column uses the exact analytic rule (root 0 of a convex
        leaf enters, root 1 exits; A<0 swaps; linear leaves follow
        sign(B)) so fp noise at the root cannot misclassify it.

        cross [R, G, NC] forward crossings (INF-padded), leaf_of_col /
        root_of_col static [NC], Aq/Bq/Cq [R, G, Lc] the leaves' root
        polynomials along each ray.  Returns (hit_t [R, G] raw,
        leaf_loc [R, G])."""
        R, G, NC = cross.shape
        Lc = Aq.shape[-1]
        dt = self.dtype
        valid = jnp.isfinite(cross)
        lcol = np.asarray(leaf_of_col, np.int32)
        own = np.zeros((NC, Lc), bool)
        own[np.arange(NC), lcol] = True
        own_j = jnp.asarray(own)
        root_is0 = jnp.asarray(np.asarray(root_of_col) == 0)   # [NC]
        # chunk rays so the [Rt, G, NC, Lc] sign tensors stay bounded
        Rt = int(max(128, min(R, (1 << 26) // max(G * NC * Lc, 1))))
        flips = []
        for st in range(0, R, Rt):
            vl = valid[st:st + Rt]
            T = jnp.where(vl, cross[st:st + Rt], 0.0)[..., None]
            A = Aq[st:st + Rt][:, :, None, :]                  # [Rt,G,1,L]
            B = Bq[st:st + Rt][:, :, None, :]
            C = Cq[st:st + Rt][:, :, None, :]
            s = (A * T + B) * T + C                            # [Rt,G,NC,L]
            sp = 2.0 * A * T + B
            # relative zero-shell: coincident surfaces land near s = 0
            # with fp noise; resolve their side by crossing direction
            mag = jnp.abs(A) * T * T + jnp.abs(B * T) + jnp.abs(C)
            near0 = jnp.abs(s) <= dt.type(1e-5) * mag
            neg = (s < 0) & ~near0
            before = neg | (near0 & (sp > 0))
            after = neg | (near0 & (sp < 0))
            # exact rule for the candidate's own leaf
            A_col = jnp.take_along_axis(
                Aq[st:st + Rt], jnp.asarray(lcol)[None, None, :], axis=2)
            B_col = jnp.take_along_axis(
                Bq[st:st + Rt], jnp.asarray(lcol)[None, None, :], axis=2)
            after_own = jnp.where(
                A_col > 0, root_is0[None, None, :],
                jnp.where(A_col < 0, ~root_is0[None, None, :], B_col < 0))
            before = jnp.where(own_j[None, None], ~after_own[..., None],
                               before)
            after = jnp.where(own_j[None, None], after_own[..., None],
                              after)
            w2 = jnp.stack([before, after], axis=1)        # [Rt,2,G,NC,L]
            v2 = self._tree_eval_mask(tree, lambda li: w2[..., li])
            flips.append((v2[:, 0] != v2[:, 1]) & vl)
        flip = flips[0] if len(flips) == 1 \
            else jnp.concatenate(flips, axis=0)            # [R, G, NC]
        tcand = jnp.where(flip, cross, INF)
        j = jnp.argmin(tcand, axis=-1)
        hit_t = jnp.min(tcand, axis=-1)
        leaf_loc = jnp.asarray(lcol)[j]
        return hit_t, leaf_loc

    def _group_walk(self, tree, cross, leaf_of_col, inside0):
        """Pairwise-order crossing-parity walk, batched over a composite
        group axis (the general form: accepts crossings from ANY leaf
        supply, including marched SDF leaves — used by the solo composite
        path; all-analytic groups use _group_walk_poly).  cross [R, G,
        NC] forward crossings (INF-padded), leaf_of_col static [NC],
        inside0 [R, G, Lc] origin inside-ness.

        Per-leaf parities at every candidate t_j come from ONE
        pairwise-order contraction count[r,g,j,l] = sum_c
        [t_c {<=,<} t_j] . onehot[c,l] (matmul-shaped: ~15 HLO ops
        per ray chunk regardless of leaf count, which keeps
        XLA compile time flat where per-column emission was O(NC^2) and
        cumsum/sort formulations were gather-heavy).  Ties of equal t
        flip jointly via the <=/< pair.  Returns (hit_t [R, G] raw,
        leaf_loc [R, G])."""
        R, G, NC = cross.shape
        Lc = inside0.shape[-1]
        dt = self.dtype
        oh_np = np.zeros((NC, Lc), np.float64)
        oh_np[np.arange(NC), np.asarray(leaf_of_col)] = 1.0
        oh = jnp.asarray(oh_np, dt)
        valid = jnp.isfinite(cross)
        hi = jax.lax.Precision.HIGHEST
        # chunk rays so the [Rt, G, NC, NC] order tensors stay bounded
        Rt = int(max(128, min(R, (1 << 24) // max(G * NC * NC, 1))))
        flips = []
        for s in range(0, R, Rt):
            tc = cross[s:s + Rt]
            vl = valid[s:s + Rt]
            ba = ((tc[..., None, :] <= tc[..., :, None])
                  & vl[..., None, :]).astype(dt)        # [Rt, G, j, c]
            bb = ((tc[..., None, :] < tc[..., :, None])
                  & vl[..., None, :]).astype(dt)
            # stack the <= / < variants on one axis: the tree program
            # evaluates once over both (halves the emitted op count —
            # XLA compile time on many-composite scenes is op-bound)
            b2 = jnp.stack([ba, bb], axis=1)            # [Rt, 2, G, j, c]
            c2 = jnp.einsum("rvgjc,cl->rvgjl", b2, oh, precision=hi)
            p2 = (c2.astype(jnp.int32) & 1) != 0        # [Rt,2,G,NC,Lc]
            ins = inside0[s:s + Rt][:, None, :, None, :]
            w2 = ins ^ p2
            v2 = self._tree_eval_mask(tree, lambda li: w2[..., li])
            flips.append((v2[:, 0] != v2[:, 1]) & vl)
        flip = flips[0] if len(flips) == 1 \
            else jnp.concatenate(flips, axis=0)         # [R, G, NC]
        tcand = jnp.where(flip, cross, INF)
        j = jnp.argmin(tcand, axis=-1)
        hit_t = jnp.min(tcand, axis=-1)
        leaf_loc = jnp.asarray(leaf_of_col, jnp.int32)[j]
        return hit_t, leaf_loc

    def _group_hit(self, members, tabs, p, d):
        """Boundary hits of one same-tree composite group.  Returns
        (a [R, G] eps-backed env-gated, row [R, G] global unified rows)."""
        dt = self.dtype
        R = p.shape[0]
        G = len(members)
        comp0 = members[0]
        Lc = len(comp0.rows)
        arows = np.asarray([c.rows for c in members], np.int32)   # [G, L]
        A, Bq, Cq, _, _ = self._quads(tabs, arows.reshape(-1), p, d)
        t0u, t1u, _, _, _, _ = self._roots(A, Bq, Cq)
        t0 = t0u.reshape(R, G, Lc)
        t1 = t1u.reshape(R, G, Lc)
        cross = jnp.concatenate([t0, t1], axis=-1)     # [R, G, 2L]
        cross = jnp.where(cross > 0, cross, INF)
        leaf_of_col = np.concatenate([np.arange(Lc), np.arange(Lc)])
        root_of_col = np.concatenate([np.zeros(Lc, np.int32),
                                      np.ones(Lc, np.int32)])
        hit_t, leaf_loc = self._group_walk_poly(
            comp0.tree, cross, leaf_of_col, root_of_col,
            A.reshape(R, G, Lc), Bq.reshape(R, G, Lc),
            Cq.reshape(R, G, Lc))
        # envelope gates [R, G] (envelope_s_ray_hits, reference
        # src/objects.c:90-96)
        env_c = np.stack([c.env_c if c.env_c is not None else np.zeros(3)
                          for c in members])
        env_r = np.asarray([c.env_r if c.env_c is not None else -1.0
                            for c in members])
        ec = jnp.asarray(np.asarray(env_c, dt))[None]  # [1, G, 3]
        er = jnp.asarray(np.asarray(env_r, dt))[None]
        pp = p[:, None, :] - ec
        s = jnp.sum(pp * d[:, None, :], -1)
        q = jnp.sum(pp * pp, -1) - er * er
        disc = s * s - q
        gate = (er <= 0) | ((disc >= 0) & ((s < 0) | (q < 0)))
        hit_t = jnp.where(gate, hit_t, INF)
        a = jnp.where(jnp.isfinite(hit_t), hit_t - self.eps, INF)
        rows_b = jnp.broadcast_to(jnp.asarray(arows)[None], (R, G, Lc))
        row = jnp.take_along_axis(rows_b, leaf_loc[..., None],
                                  axis=2)[..., 0]
        return a, row

    # -- core query --------------------------------------------------------

    def _single_chunks(self, matter_only, R=None):
        """Static chunk partition of candidate rows (single-leaf objects).

        With R (the ray-batch width, static under jit) the chunk length is
        shrunk so the [R, c, 3] local-frame intermediates of _quads stay
        bounded (~32M elements) for ANY rays x leaves product — scenes like
        many_spheres (~32k leaves) hit the tracer with R up to B*S NEE
        shadow rays and would otherwise materialize GB-scale temps
        (RESOURCE_EXHAUSTED on the device)."""
        rows = self.single_rows
        if matter_only and len(rows):
            rows = rows[~self.tab.is_light[rows]]
        c = CHUNK
        if R:
            c = int(min(CHUNK, max(64, (1 << 23) // max(R, 1))))
        return [rows[i:i + c] for i in range(0, len(rows), c)]

    def _chunk_candidates(self, tabs, rows, p, d):
        """Policy-root candidates [R, c] for one chunk of single rows."""
        A, Bq, Cq, _, _ = self._quads(tabs, rows, p, d)
        t0u, t1u, s, q, ok, _ = self._roots(A, Bq, Cq)
        a = self._policy(self.tab.kind[rows], t0u, t1u, s, q, ok)
        return jnp.where(self._env_gate_rows(rows, p, d), a, INF)

    def _query(self, p, d, matter_only, want2, rng_rough,
               lane_matter=None):
        """Top-1/2 hit over the whole scene, single pass.  Returns
        (t [R,2], nor [R,2,3], oid [R,2], sign [R,2]) (second column
        dummy when want2=False).

        lane_matter: optional [R] bool — lanes marked True ignore light
        candidates (per-lane matter-only, the mixed normal/path wavefront
        of the device drain; reference path rays trace the matter compound
        only, src/scene.c:607)."""
        dt = self.dtype
        p = jnp.asarray(p, dt)
        d = jnp.asarray(d, dt)
        R = p.shape[0]
        tabs = self._assemble()
        kw = 2 if want2 else 1

        # 1. single-leaf objects: chunked running top-k merge
        best_t = jnp.full((R, kw), INF, dt)
        best_row = jnp.zeros((R, kw), jnp.int32)
        for rows in self._single_chunks(matter_only, R):
            a = self._chunk_candidates(tabs, rows, p, d)
            if lane_matter is not None \
                    and self.tab.is_light[rows].any():
                lmask = jnp.asarray(self.tab.is_light[rows])
                a = jnp.where(lane_matter[:, None] & lmask[None, :],
                              INF, a)
            if want2:
                tkc, ikc = _top2_cols(a)
            else:
                ikc = jnp.argmin(a, axis=1).astype(jnp.int32)[:, None]
                tkc = jnp.min(a, axis=1)[:, None]
            if len(rows) <= 64:
                rows_f = jnp.asarray(rows, dt)
                oh = ikc[..., None] == jnp.arange(len(rows),
                                                  dtype=jnp.int32)
                rkc = jnp.sum(jnp.where(oh, rows_f, 0),
                              -1).astype(jnp.int32)
            else:
                rkc = jnp.asarray(rows)[ikc]
            cand_t = jnp.concatenate([best_t, tkc], axis=1)
            cand_r = jnp.concatenate([best_row, rkc], axis=1)
            if want2:
                best_t, sel = _top2_cols(cand_t)
            else:
                sel = jnp.argmin(cand_t, axis=1)[:, None]
                best_t = jnp.min(cand_t, axis=1)[:, None]
            best_row = _take_cols(cand_r, sel)

        # 2. final candidate columns: the kw single winners + one
        # column per composite + one per standalone SDF object
        cols_t = [best_t[:, i] for i in range(kw)]
        cols_row = [best_row[:, i] for i in range(kw)]
        oid_special = []  # (col, const oid) for SDF-surface winners
        nor_ovr = []      # (col, [R,3]) explicit normals (SDF surfaces)

        for members in self.comp_groups:
            mf = [c for c in members if not (matter_only and c.is_light)]
            if not mf:
                continue
            a_g, row_g = self._group_hit(mf, tabs, p, d)
            for gi, comp in enumerate(mf):
                a = a_g[:, gi]
                if lane_matter is not None and comp.is_light:
                    a = jnp.where(lane_matter, INF, a)
                cols_t.append(a)
                cols_row.append(row_g[:, gi])

        # clusters of >=2 shape-identical solo composites evaluate as one
        # scanned body; results are keyed back to each member so the
        # column order below stays exactly the comp_solo order (argmin
        # tie-breaking between coincident surfaces is order-dependent)
        solo_out = {}
        pair_out = {}          # first member id -> cluster top-2 columns
        pair_skip = set()      # other members of pair-compacted clusters
        for cluster in self._solo_clusters():
            if len(cluster) < 2 or (matter_only and cluster[0].is_light):
                continue
            if self._pairs_ok(cluster):
                pair_out[id(cluster[0])] = self._solo_pairs_hit(
                    cluster, tabs, p, d)
                pair_skip.update(id(c) for c in cluster[1:])
                continue
            a_g, row_g, nor_g = self._solo_scan_hit(cluster, tabs, p, d)
            for gi, comp in enumerate(cluster):
                solo_out[id(comp)] = (a_g[gi], row_g[gi], nor_g[gi])

        for comp in self.comp_solo:
            if matter_only and comp.is_light:
                continue
            p8 = pair_out.pop(id(comp), None)
            if p8 is not None:
                # 2 columns carry the whole cluster's top-2; oid is a
                # per-ray array (winner member varies by ray).  NOTE:
                # collapsing a cluster's M columns to 2 at the first
                # member's position changes the global argmin COLUMN
                # ORDER, so an exact tie between a cluster member and a
                # later non-cluster column can pick a different winner
                # than the member-scanned form.  Accepted: pair
                # compaction is off on the CPU golden path
                # (_pair_compact_on), whose hashes pin the scanned order.
                for a_c, row_c, oid_c, nor_c in (p8[0:4], p8[4:8]):
                    if lane_matter is not None and comp.is_light:
                        a_c = jnp.where(lane_matter, INF, a_c)
                    k = len(cols_t)
                    cols_t.append(a_c)
                    cols_row.append(row_c)
                    oid_special.append((k, oid_c))
                    nor_ovr.append((k, nor_c))
                continue
            if id(comp) in pair_skip:
                continue
            got = solo_out.get(id(comp))
            if got is not None:
                a, row, nor = got
                if lane_matter is not None and comp.is_light:
                    a = jnp.where(lane_matter, INF, a)
                k = len(cols_t)
                cols_t.append(a)
                cols_row.append(row)
                oid_special.append((k, comp.oid))
                nor_ovr.append((k, nor))
                continue
            a, leaf_loc, row = self._hit_composite(comp, tabs, p, d)
            if lane_matter is not None and comp.is_light:
                a = jnp.where(lane_matter, INF, a)
            k = len(cols_t)
            cols_t.append(a)
            cols_row.append(row)
            sdfs = [(li, lf) for li, lf in enumerate(comp.sdf_leaves)
                    if lf is not None]
            if sdfs:
                oid_special.append((k, comp.oid))
                t_safe = jnp.where(jnp.isfinite(a), a, 0.0)
                hx = p + d * t_safe[:, None]
                nor = jnp.zeros((R, 3), dt)
                for li, lf in sdfs:
                    m = jnp.asarray(lf.m.astype(dt))
                    m0l = jnp.asarray(lf.m0.astype(dt))
                    ql = jnp.einsum("ij,rj->ri", m, hx) + m0l
                    nl = self._sdf_normal(lf, ql)
                    nor = jnp.where((leaf_loc == li)[:, None], nl, nor)
                nor_ovr.append((k, nor))

        for si, (lf, oid, env_c, env_r, light) in \
                enumerate(self.sdf_singles):
            if matter_only and light:
                continue
            a, nor = self._hit_sdf_leaf(lf, env_c, env_r, p, d, si=si)
            if lane_matter is not None and light:
                a = jnp.where(lane_matter, INF, a)
            k = len(cols_t)
            cols_t.append(a)
            cols_row.append(jnp.full((R,), -1, jnp.int32))
            oid_special.append((k, oid))
            nor_ovr.append((k, nor))

        T = jnp.stack(cols_t, axis=1)                      # [R, K]
        ROWS = jnp.stack(cols_row, axis=1)

        if want2:
            t12, sel = _top2_cols(T)
        else:
            sel = jnp.argmin(T, axis=1).astype(jnp.int32)[:, None]
            t12 = jnp.min(T, axis=1)[:, None]
        row12 = _take_cols(ROWS, sel)                      # [R, kw]

        # 3. winner normals + oid from the unified table: ONE packed
        # parameter-matrix lookup for the kw winners (one-hot contraction
        # for small tables, a gather for large ones), then the analytic
        # gradient (2 c2 y + c1) M.
        M, m0, c2, c1, rr = tabs
        L = len(self.tab)
        t_safe = jnp.where(jnp.isfinite(t12), t12, 0.0)
        x = p[:, None, :] + d[:, None, :] * t_safe[..., None]  # [R,kw,3]
        if L:
            hi = jax.lax.Precision.HIGHEST
            row_s = jnp.maximum(row12, 0)
            P = jnp.concatenate([
                M.reshape(L, 9), m0, c2, c1,
                jnp.asarray(self.tab.neg, dt)[:, None],
                jnp.asarray(self.tab.oid, dt)[:, None]], axis=1)   # [L,20]
            if L <= 64:
                oh = (row_s[..., None]
                      == jnp.arange(L, dtype=jnp.int32)).astype(dt)
                Pw = jnp.einsum("rkl,lf->rkf", oh, P, precision=hi)
            else:
                Pw = P[row_s]
            Mw = Pw[..., 0:9].reshape(row_s.shape + (3, 3))
            m0w, c2w, c1w = Pw[..., 9:12], Pw[..., 12:15], Pw[..., 15:18]
            negw = Pw[..., 18] > 0.5
            oid12 = jnp.round(Pw[..., 19]).astype(jnp.int32)
            y = jnp.einsum("rkij,rkj->rki", Mw, x, precision=hi) + m0w
            grad = jnp.einsum("rki,rkij->rkj", 2.0 * c2w * y + c1w, Mw,
                              precision=hi)
            nor = _norm3(grad)
            nor = jnp.where(negw[..., None], -nor, nor)
        else:
            nor = jnp.zeros((R, kw, 3), dt)
            oid12 = jnp.zeros((R, kw), jnp.int32)
        for k, oc in oid_special:
            # oc: static int, or a per-ray [R] array (pair-compacted
            # cluster columns, whose winner member varies by ray)
            ocb = oc if np.isscalar(oc) else oc[:, None]
            oid12 = jnp.where((sel == k) & (row12 == -1), ocb, oid12)
        for k, n_ovr in nor_ovr:
            use = (sel == k)[..., None] & (row12 == -1)[..., None]
            nor = jnp.where(use, n_ovr[:, None, :], nor)

        sign = jnp.where(_dot(nor, d[:, None, :]) > 0, 1.0, -1.0).astype(dt)

        fin = jnp.isfinite(t12)
        nor = jnp.where(fin[..., None], nor, 0.0)
        oid12 = jnp.where(fin, oid12, -1)
        sign = jnp.where(fin, sign, 0.0)

        if rng_rough and np.any(self.roughness > 0):
            n1 = self._perturb(nor[:, 0, :], p, d, t12[:, 0], oid12[:, 0])
            nor = nor.at[:, 0, :].set(n1)
        return t12, nor, oid12, sign

    # -- public queries ----------------------------------------------------

    def nearest2(self, p, d, matter_only=False, rng_rough=True):
        """Nearest AND second-nearest hit over the whole scene, one pass.
        Returns (t1, nor1, oid1, sign1, t2, nor2, oid2, sign2); oid=-1 and
        nor=0 where miss.  The second hit is the coincident-surface
        candidate for media-transition resolution (reference
        src/compound.c:246-299)."""
        t12, nor, oid, sign = self._query(p, d, matter_only, True, rng_rough)
        return (t12[:, 0], nor[:, 0, :], oid[:, 0], sign[:, 0],
                t12[:, 1], nor[:, 1, :], oid[:, 1], sign[:, 1])

    def nearest(self, p, d, matter_only=False, rng_rough=True):
        """Nearest hit over the whole scene.
        Returns (t[R], nor[R,3], oid[R], sign[R]); oid=-1 where miss."""
        t12, nor, oid, sign = self._query(p, d, matter_only, False,
                                          rng_rough)
        return t12[:, 0], nor[:, 0, :], oid[:, 0], sign[:, 0]

    def _perturb(self, nor, p, d, t, oid):
        """Surface-roughness normal perturbation (reference
        src/objects.c:261-284): per-component log-shaped bump seeded from
        the hit position."""
        from actinon_tpu import rng as argn
        rough = jnp.asarray(self.roughness)[jnp.maximum(oid, 0)]
        t_safe = jnp.where(jnp.isfinite(t), t, 0.0)
        hp = p + d * t_safe[:, None]
        seed = argn.seed_from_v3(hp, 1246)
        f = jnp.stack([argn.uniform_signed(seed, k, self.dtype) * 0.99
                       for k in range(3)], axis=-1)
        bump = jnp.log((1.0 - f) / (1.0 + f))
        new = _norm3(nor + rough[:, None] * bump)
        use = (rough > 0)[:, None] & jnp.isfinite(t)[:, None]
        return jnp.where(use, new, nor)

    # -- transition query (media boundaries) -------------------------------

    def _trans_from_pair(self, hits):
        """Assemble transition data from a nearest2 result: a second object
        whose hit lies within eps of the minimum fills the other role (the
        glass/wine media-transition case, reference src/compound.c:284-297)."""
        t, nor, oid, sign, t2, nor2, oid2, sign2 = hits
        exiting = sign > 0
        exit_nor = jnp.where(exiting[:, None], nor, -nor)
        enter = jnp.where(~exiting & (oid >= 0), oid, -1)
        exit_ = jnp.where(exiting & (oid >= 0), oid, -1)
        close = jnp.isfinite(t) & jnp.isfinite(t2) & (jnp.abs(t2 - t)
                                                      < 2 * self.eps)
        exiting2 = sign2 > 0
        enter = jnp.where(close & ~exiting2 & (enter < 0), oid2, enter)
        exit_ = jnp.where(close & exiting2 & (exit_ < 0), oid2, exit_)
        return t, exit_nor, enter, exit_

    def trans_hit(self, p, d):
        """scene_s_trans_hit + compound_s_ray_trans_hit semantics
        (reference src/scene.c:362-382, src/compound.c:246-299):
        nearest hit over light+matter with coincident-surface resolution,
        computed in a single scene traversal.
        Returns (t, exit_nor [anti-ray], enter_oid, exit_oid)."""
        return self._trans_from_pair(self.nearest2(p, d, matter_only=False))

    def trans_hit_matter(self, p, d):
        """Transition hit over the matter compound only — the path-ray
        trace (reference src/scene.c:607 uses
        compound_s_ray_trans_hit(scene->matter, ...))."""
        return self._trans_from_pair(self.nearest2(p, d, matter_only=True))

    def trans_hit_mixed(self, p, d, path_mask):
        """Per-lane transition hit: lanes with path_mask=True trace matter
        only (reference src/scene.c:607), the rest trace light+matter
        (src/scene.c:362-382) — ONE traversal for a mixed normal/path
        wavefront batch (light candidates are lane-masked before the
        top-2 merge, so the expensive root math is shared)."""
        t12, nor, oid, sign = self._query(p, d, False, True, True,
                                          lane_matter=path_mask)
        return self._trans_from_pair(
            (t12[:, 0], nor[:, 0, :], oid[:, 0], sign[:, 0],
             t12[:, 1], nor[:, 1, :], oid[:, 1], sign[:, 1]))

    # -- shadow queries ------------------------------------------------------

    def shadow_blocked(self, p, d, limit):
        """True where ANY matter hit lies within (.., limit] — the NEE
        shadow test `compound_s_ray_hit(matter) > a` (reference
        src/scene.c:571) as a cheap any-hit reduction: no top-2 merge, no
        normals, no winner reconstruction."""
        dt = self.dtype
        p = jnp.asarray(p, dt)
        d = jnp.asarray(d, dt)
        R = p.shape[0]
        limit = jnp.asarray(limit, dt)
        tabs = self._assemble()
        blocked = jnp.zeros((R,), bool)
        for rows in self._single_chunks(True, R):
            a = self._chunk_candidates(tabs, rows, p, d)
            blocked = blocked | jnp.any(a <= limit[:, None], axis=1)
        for members in self.comp_groups:
            mf = [c for c in members if not c.is_light]
            if not mf:
                continue
            a_g, _ = self._group_hit(mf, tabs, p, d)
            blocked = blocked | jnp.any(a_g <= limit[:, None], axis=1)
        scanned = set()
        for cluster in self._solo_clusters():
            if len(cluster) < 2 or cluster[0].is_light:
                continue
            blocked = blocked | self._solo_cluster_shadow(cluster, tabs,
                                                          p, d, limit)
            scanned.update(id(c) for c in cluster)
        for comp in self.comp_solo:
            if comp.is_light or id(comp) in scanned:
                continue
            blocked = blocked | self._shadow_composite(comp, tabs, p, d,
                                                       limit)
        for lf, oid, env_c, env_r, light in self.sdf_singles:
            if light:
                continue
            a, _ = self._hit_sdf_leaf(lf, env_c, env_r, p, d)
            blocked = blocked | (a <= limit)
        return blocked

    def object_hit_t(self, oid: int, p, d):
        """First-hit distance of ONE object (eps-backed, INF on miss) —
        the true-geometry light intersection for NEE
        (obj_ray_hit(light_src, ...), reference src/scene.c:564).  `oid`
        is a static python int; dispatches on the object's form."""
        dt = self.dtype
        p = jnp.asarray(p, dt)
        d = jnp.asarray(d, dt)
        tabs = self._assemble()
        rows = np.flatnonzero((self.tab.oid == oid) & self.tab.single)
        if len(rows):
            rows = rows.astype(np.int32)
            a = self._chunk_candidates(tabs, rows, p, d)
            return a[:, 0]
        for comp in self.composites:
            if comp.oid == oid:
                a, _, _ = self._hit_composite(comp, tabs, p, d)
                return a
        for si, (lf, o, env_c, env_r, _light) in \
                enumerate(self.sdf_singles):
            if o == oid:
                a, _ = self._hit_sdf_leaf(lf, env_c, env_r, p, d, si=si)
                return a
        raise ValueError(f"object {oid} not found")

    def shadow_nearest_t(self, p, d):
        """Nearest matter hit distance (normals irrelevant, roughness
        skipped).  Kept for direct use/tests; the integrator uses
        shadow_blocked."""
        t, _, _, _ = self.nearest(p, d, matter_only=True, rng_rough=False)
        return t

    def shadow_t(self, p, d):
        return self.shadow_nearest_t(p, d)
