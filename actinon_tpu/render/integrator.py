"""Wavefront light-transport integrator.

The reference integrator scene_s_lum (reference src/scene.c:420-667) is a
recursive function: at each hit it may recurse into a Fresnel-reflection
branch, a chromatic (metallic) branch, per-light next-event-estimation
sampling, hemisphere path samples (cost: 10 depth units), and a refraction
branch, threading a scalar `intensity` down and multiplying RGB tints on
the way up.  Recursion does not vectorize; here it is flattened into a
**wavefront**: rays are queue entries carrying

    (p, d, intensity, tint_rgb, depth, sample_id)

and one jitted *step* processes a whole batch: trace -> classify ->
accumulate local contributions (emitter / background / NEE direct light)
-> emit child rays for the specular branches and path samples.  The host
drains two queues (normal rays trace light+matter; path rays trace matter
only and clamp at max_path_length, reference src/scene.c:596-617) until
empty.  All reference semantics are reproduced exactly:

  * depth budget: specular/refraction cost 1, path costs 10 and is gated
    on depth > 10 (reference src/scene.c:584)
  * intensity-scaled sample counts: direct/path sample counts are
    floor(samples * intensity * diffuse) min 1 per ray, realized as a
    static-size loop with per-ray masks (reference src/scene.c:553-554)
  * the estimator factors 2*cap_height/n and 2/n
  * exit-transition override (fresnel=1, diffuse=chromatic=0 when leaving
    a medium, reference src/scene.c:464-470), Beer-Lambert absorption
    transparency^distance (reference src/scene.c:656-664)
  * Oren-Nayar weighting (reference src/scene.c:394-416)
  * per-surface-point deterministic RNG (position-hashed streams,
    reference src/scene.c:537; counter-based here, see rng.py)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

from actinon_tpu import rng as argn
from actinon_tpu.scene import ir as sir
from actinon_tpu.render.tracer import (Tracer, _norm3, _dot, safe_sqrt,
                                       safe_acos, _sphere_first_hit)

INF = jnp.inf
F3_MAG = 1e30
# runaway-wavefront backstop: a pathological scene that keeps spawning
# children exits the drain loop here — run_device warns when it fires
DRAIN_TRIP_CAP = 100000
# wall-seconds target per drain chunk: the host re-invokes the drain in
# trip-budget-bounded chunks adapted toward this target, so no single
# device program runs unbounded (see Integrator._drain_chunked)
DRAIN_CHUNK_TARGET_S = 15.0
# path children emitted per parent lane per drain trip: a parent
# descriptor with ns samples re-enqueues itself ns/PATH_EXPAND times, so
# the parent-lane overhead (a parent occupies one traced lane per trip)
# is ~1/PATH_EXPAND of the path work it generates
PATH_EXPAND = 16


def _on_cpu():
    import jax as _jax
    return _jax.default_backend() == "cpu"


def _frame_apply(frame, vecs):
    """frame [..., 3, 3] applied to vecs [..., K, 3]:
    out[..., k, i] = sum_j frame[..., i, j] * vecs[..., k, j].

    CPU keeps the einsum (the golden corpus pins its contraction
    order); accelerators unroll to three broadcast multiply-adds, exact
    f32 elementwise code that fuses with its neighbours instead of a
    K=3 contraction."""
    if _on_cpu():
        return jnp.einsum("...ij,...kj->...ki", frame, vecs,
                          precision=jax.lax.Precision.HIGHEST)
    f = frame[..., None, :, :]        # [..., 1, 3, 3]
    return jnp.stack(
        [f[..., i, 0] * vecs[..., 0] + f[..., i, 1] * vecs[..., 1]
         + f[..., i, 2] * vecs[..., 2] for i in range(3)], axis=-1)


def _dotk(vecs, v):
    """vecs [..., K, 3] . v [..., 3] -> [..., K] (v broadcast over K)."""
    if _on_cpu():
        return jnp.einsum("...ki,...i->...k", vecs, v,
                          precision=jax.lax.Precision.HIGHEST)
    return (vecs * v[..., None, :]).sum(-1)


@dataclasses.dataclass
class RayQueue:
    """Host-side struct-of-arrays ray queue."""

    p: np.ndarray
    d: np.ndarray
    intensity: np.ndarray
    tint: np.ndarray
    depth: np.ndarray
    sample_id: np.ndarray

    @staticmethod
    def empty(dtype):
        return RayQueue(np.zeros((0, 3), dtype), np.zeros((0, 3), dtype),
                        np.zeros((0,), dtype), np.zeros((0, 3), dtype),
                        np.zeros((0,), np.int32), np.zeros((0,), np.int32))

    def __len__(self):
        return len(self.intensity)

    def append(self, other: "RayQueue"):
        for f in dataclasses.fields(self):
            k = f.name
            setattr(self, k, np.concatenate([getattr(self, k),
                                             getattr(other, k)]))

    def pop(self, n: int) -> "RayQueue":
        out = RayQueue(*[getattr(self, f.name)[:n]
                         for f in dataclasses.fields(self)])
        for f in dataclasses.fields(self):
            k = f.name
            setattr(self, k, getattr(self, k)[n:])
        return out

    def padded(self, n: int, dtype) -> "RayQueue":
        """Pad to length n with dead rays (intensity 0, depth 0)."""
        m = len(self)
        if m == n:
            return self
        pad = n - m
        return RayQueue(
            np.concatenate([self.p, np.zeros((pad, 3), dtype)]),
            np.concatenate([self.d, np.tile(np.array([[0, 0, 1]], dtype),
                                            (pad, 1))]),
            np.concatenate([self.intensity, np.zeros(pad, dtype)]),
            np.concatenate([self.tint, np.zeros((pad, 3), dtype)]),
            np.concatenate([self.depth, np.zeros(pad, np.int32)]),
            np.concatenate([self.sample_id, np.zeros(pad, np.int32)]))


class Integrator:
    def __init__(self, tracer: Tracer, batch: int = 1 << 14):
        self.tr = tracer
        self.ir = tracer.ir
        self.cfg = tracer.ir.cfg
        self.dtype = tracer.dtype
        self.batch = batch
        # differentiable-path hooks (see diff.py): `ovr` substitutes traced
        # material tables; seed_mode="counter" derives RNG streams from
        # (sample_id, depth) instead of the hit position so that finite
        # differences see frozen randomness (the reference's
        # position-seeding, src/scene.c:537, makes the sample set a
        # discontinuous function of the scene parameters).
        self.ovr = {}
        self.seed_mode = "position"

        ir = self.ir
        dt = self.dtype

        # object material tables [O]
        O = len(ir.objects)
        g = lambda f: np.array([getattr(o, f) for o in ir.objects], dt)
        g3 = lambda f: np.stack([np.asarray(getattr(o, f), dt)
                                 for o in ir.objects])
        self.m_color = g3("color")
        self.m_radiance = g("radiance")
        self.m_rix = g("refractive_index")
        self.m_fresnel = g("fresnel")
        self.m_chromatic = g("chromatic")
        self.m_diffuse = g("diffuse")
        self.m_sigma = g("sigma")
        self.m_transp = g3("transparency")
        self.m_pos = g3("pos")
        self.m_texk = np.array([o.tex_kind for o in ir.objects], np.int32)
        self.m_tex1 = np.stack([
            np.asarray(o.tex_c1, dt) if o.tex_c1 is not None
            else np.zeros(3, dt) for o in ir.objects])
        self.m_tex2 = np.stack([
            np.asarray(o.tex_c2, dt) if o.tex_c2 is not None
            else np.zeros(3, dt) for o in ir.objects])
        self.m_texs = g("tex_scale")
        self.m_projk = np.array([o.proj_kind for o in ir.objects], np.int32)
        self.m_projp = np.stack([
            np.asarray(o.proj_pos, dt) if o.proj_pos is not None
            else np.zeros(3, dt) for o in ir.objects])
        self.m_projr = np.stack([
            np.asarray(o.proj_rax, dt) if o.proj_rax is not None
            else np.eye(3, dtype=dt) for o in ir.objects])

        # light tables [L]
        L = len(ir.lights)
        self.n_lights = L
        lo = [ir.objects[i] for i in ir.lights]
        self.l_pos = np.stack([np.asarray(o.pos, dt) for o in lo]) \
            if L else np.zeros((0, 3), dt)
        self.l_rad = np.array([o.radiance for o in lo], dt)
        self.l_radius = np.array([o.light_radius for o in lo], dt)
        # light color at its own center (obj_color(light, prp.pos),
        # reference src/scene.c:552)
        self.l_color = np.stack([
            np.asarray(o.tex_c1 if o.tex_kind == sir.TEX_PLAIN else o.color,
                       dt) for o in lo]) if L else np.zeros((0, 3), dt)
        # static per-light sampling/hit dispatch: fov cone kind
        # (obj_fov, reference src/objects.c:520,619,1037) and whether the
        # NEE intersection can use the exact differentiable sphere formula
        # or must hit the true object geometry (obj_ray_hit(light_src),
        # reference src/scene.c:564)
        self.l_fov = [o.light_fov for o in lo]
        self.l_plane_n = [None if o.light_plane_n is None
                          else np.asarray(o.light_plane_n, dt) for o in lo]
        self.l_cone_pos = np.stack([
            np.asarray(o.light_cone_pos if o.light_cone_pos is not None
                       else o.pos, dt) for o in lo]) \
            if L else np.zeros((0, 3), dt)
        self.l_sphere_exact = [
            o.single_leaf and o.leaves[0].family == sir.SPHERE for o in lo]
        self.l_oid = list(ir.lights)

        self.rays_traced = 0
        self.direct_cap = max(int(self.cfg.direct_samples), 1)
        # THE query accounting definition, shared by every drain (host,
        # device, sharded) and the bench (round-3 verdict weak #8: the
        # headline metric must not change meaning between code paths):
        # one live non-parent lane costs 1 transition trace + 1
        # coincident-surface pass + n_lights*direct_cap NEE traversals
        self.per_lane_queries = 2 + len(ir.lights) * self.direct_cap
        self.path_cap = max(int(self.cfg.path_samples), 0)
        self.tmi = dt.type(self.cfg.trace_min_intensity)
        self.background = np.asarray(ir.background, dt)
        self.max_path_length = dt.type(self.cfg.max_path_length)

        self._step_normal = jax.jit(lambda q: self._step(q, path_ray=False))
        self._step_path = jax.jit(lambda q: self._step(q, path_ray=True))

    # ------------------------------------------------------------------

    def _mt(self, name):
        """Material table read with optional traced override."""
        o = self.ovr.get(name)
        return jnp.asarray(o if o is not None else getattr(self, name))

    def mat_params(self):
        """Export the differentiable material/light tables as a dict pytree
        whose keys match the `ovr` names."""
        names = ["m_color", "m_radiance", "m_rix", "m_fresnel",
                 "m_chromatic", "m_diffuse", "m_sigma", "m_transp", "m_pos",
                 "m_tex1", "m_tex2", "l_pos", "l_rad", "l_radius", "l_color",
                 "background"]
        out = {}
        for n in names:
            v = getattr(self, n)
            if v is not None and np.size(v) > 0:
                out[n] = jnp.asarray(v)
        return out

    def _mat_lookup(self, oid_s):
        """ALL per-object material fields for a lane batch through ONE
        packed-matrix one-hot contraction [R,O] @ [O,F] — a single op
        instead of ~18 separate table gathers."""
        dt = self.dtype
        O = len(self.ir.objects)
        P = jnp.concatenate([
            self._mt("m_color"),                       # 0:3
            self._mt("m_radiance")[:, None],           # 3
            self._mt("m_rix")[:, None],                # 4
            self._mt("m_fresnel")[:, None],            # 5
            self._mt("m_chromatic")[:, None],          # 6
            self._mt("m_diffuse")[:, None],            # 7
            self._mt("m_sigma")[:, None],              # 8
            self._mt("m_transp"),                      # 9:12
            self._mt("m_pos"),                         # 12:15
            self._mt("m_tex1"),                        # 15:18
            self._mt("m_tex2"),                        # 18:21
            jnp.asarray(self.m_texs)[:, None],         # 21
            jnp.asarray(self.m_texk, dt)[:, None],     # 22
            jnp.asarray(self.m_projk, dt)[:, None],    # 23
            jnp.asarray(self.m_projp),                 # 24:27
            jnp.asarray(self.m_projr).reshape(O, 9),   # 27:36
        ], axis=1).astype(dt)
        oh = (oid_s[:, None]
              == jnp.arange(O, dtype=jnp.int32)).astype(dt)
        Pw = jnp.einsum("ro,of->rf", oh, P,
                        precision=jax.lax.Precision.HIGHEST)
        return dict(
            color=Pw[:, 0:3], radiance=Pw[:, 3], rix=Pw[:, 4],
            fresnel=Pw[:, 5], chromatic=Pw[:, 6], diffuse=Pw[:, 7],
            sigma=Pw[:, 8], transp=Pw[:, 9:12], pos=Pw[:, 12:15],
            tex1=Pw[:, 15:18], tex2=Pw[:, 18:21], texs=Pw[:, 21],
            texk=jnp.round(Pw[:, 22]).astype(jnp.int32),
            projk=jnp.round(Pw[:, 23]).astype(jnp.int32),
            projp=Pw[:, 24:27],
            projr=Pw[:, 27:36].reshape(-1, 3, 3))

    def _albedo(self, oid, pos, mat=None):
        """obj_color with texture dispatch (reference src/objects.c:411-422,
        src/textures.c)."""
        if mat is None:
            mat = self._mat_lookup(jnp.maximum(oid, 0))
        base = mat["color"]
        texk = mat["texk"]
        tex1 = mat["tex1"]
        tex2 = mat["tex2"]
        texs = mat["texs"]
        projk = mat["projk"]
        projp = mat["projp"]
        projr = mat["projr"]

        # plane projection (reference src/objects.c:514-518)
        rel = pos - projp
        u_pl = _dot(rel, projr[:, 0, :])
        v_pl = _dot(rel, projr[:, 1, :])
        # sphere projection (azimuth/elevation, reference
        # src/objects.c:602-617)
        r = _norm3(rel)
        sx = _dot(r, projr[:, 0, :])
        sy = _dot(r, jnp.cross(projr[:, 2, :], projr[:, 0, :]))
        sz = _dot(r, projr[:, 2, :])
        u_sp = jnp.arctan2(sx, sy)
        v_sp = safe_acos(sz) * (-1.0) + jnp.pi / 2   # asin with safe grads

        u = jnp.where(projk == sir.PROJ_SPHERE, u_sp, u_pl)
        v = jnp.where(projk == sir.PROJ_SPHERE, v_sp, v_pl)
        xi = jnp.round(u * texs).astype(jnp.int32)
        yi = jnp.round(v * texs).astype(jnp.int32)
        chess = jnp.where((((xi ^ yi) & 1) == 1)[:, None], tex1, tex2)

        out = jnp.where((texk == sir.TEX_PLAIN)[:, None], tex1, base)
        out = jnp.where((texk == sir.TEX_CHESS)[:, None], chess, out)
        return out

    def _fresnel_reflectance(self, d, exit_nor, trix):
        """fresnel_reflection (reference src/gmath.c:68-91).  exit_nor
        points along the ray (into the surface), so c > 0 and f = 1/trix."""
        c = _dot(d, exit_nor)
        f = jnp.where(c < 0, trix, 1.0 / jnp.where(trix != 0, trix, 1.0))
        cos_ai = jnp.minimum(jnp.abs(c), 1.0)
        sin_ai = safe_sqrt(1.0 - cos_ai * cos_ai)
        sin_at = sin_ai * f
        total = sin_at >= 1.0
        cos_at = safe_sqrt(1.0 - sin_at * sin_at)
        # total-internal-reflection lanes have cos_ai = cos_at = 0: the
        # 0/0 would be where()-masked in the output but still poisons the
        # reverse pass (0 * nan = nan), so keep the denominators nonzero
        den_s = f * cos_ai + cos_at
        den_p = f * cos_at + cos_ai
        rs = ((f * cos_ai - cos_at) / jnp.where(den_s != 0, den_s, 1.0)) ** 2
        rp = ((f * cos_at - cos_ai) / jnp.where(den_p != 0, den_p, 1.0)) ** 2
        return jnp.where(total, 1.0, (rs + rp) * 0.5)

    def _refract_dir(self, d, exit_nor, trix):
        """fresnel_refraction (reference src/gmath.c:94-113)."""
        c = _dot(d, exit_nor)
        f = jnp.where(c < 0, trix, 1.0 / jnp.where(trix != 0, trix, 1.0))
        q = f * f * (1.0 - c * c)
        sq = safe_sqrt(1.0 - q)
        b = -f * c + jnp.where(c > 0, sq, -sq)
        out = d * f[:, None] + exit_nor * b[:, None]
        return jnp.where((q < 1.0)[:, None], out, d)

    # ------------------------------------------------------------------

    def _step(self, q: Dict, path_ray: bool, mixed: bool = False):
        """One wavefront step over a padded batch.  Returns
        (sample_id, contrib[B,3], children dict, path_parent).

        mixed=True: q carries a per-lane `kind` (0 normal ray, 1 path
        ray, 2 path-parent descriptor) plus the parent aux fields; the
        trace is ONE traversal with per-lane light masking, parent lanes
        are expanded into path children in place, and the path spawn is
        returned as child blocks instead of a host-side descriptor — the
        device-resident form of the splitting path recursion (reference
        src/scene.c:584-621)."""
        dt = self.dtype
        p, d = q["p"], q["d"]
        intensity, tint = q["intensity"], q["tint"]
        depth, sid = q["depth"], q["sample_id"]
        B = p.shape[0]
        alive = intensity > 0

        bg = self._mt("background")

        if mixed:
            is_path = q["kind"] == 1
            is_parent = q["kind"] == 2
            alive = alive & ~is_parent
            t, exit_nor, enter, exit_ = self.tr.trans_hit_mixed(
                p, d, is_path)
            hit_ok = jnp.isfinite(t) & (~is_path
                                        | (t < self.max_path_length))
        elif path_ray:
            t, exit_nor, enter, exit_ = self.tr.trans_hit_matter(p, d)
            # miss OR beyond max_path_length -> background
            # (reference src/scene.c:608-616)
            hit_ok = jnp.isfinite(t) & (t < self.max_path_length)
        else:
            t, exit_nor, enter, exit_ = self.tr.trans_hit(p, d)
            hit_ok = jnp.isfinite(t)

        contrib = jnp.zeros((B, 3), dt)
        miss = alive & ~hit_ok
        contrib += jnp.where(miss[:, None],
                             bg[None, :] * intensity[:, None] * tint, 0.0)

        # shading gate: reference returns black at depth==0 or
        # intensity < tmi (reference src/scene.c:428)
        shade = alive & hit_ok & (depth > 0) & (intensity >= self.tmi)

        t_safe = jnp.where(jnp.isfinite(t), t, 0.0)
        pos = p + d * t_safe[:, None]

        enter_s = jnp.maximum(enter, 0)
        exit_s = jnp.maximum(exit_, 0)
        has_enter = enter >= 0
        has_exit = exit_ >= 0

        mat_in = self._mat_lookup(enter_s)
        mat_out = self._mat_lookup(exit_s)

        # emitter hit (reference src/scene.c:432-437)
        e_rad = mat_in["radiance"] * has_enter
        is_emit = shade & (e_rad > 0)
        e_pos = mat_in["pos"]
        diff_sqr = _dot(pos - e_pos, pos - e_pos)
        e_int = jnp.where(diff_sqr > 0, e_rad / jnp.where(diff_sqr > 0,
                                                          diff_sqr, 1.0),
                          F3_MAG)
        e_col = self._albedo(enter_s, pos, mat=mat_in)
        contrib += jnp.where(is_emit[:, None],
                             e_col * (e_int * intensity)[:, None] * tint, 0.0)

        shade = shade & ~is_emit

        # surface parameters with exit-transition override
        # (reference src/scene.c:441-470)
        trix = jnp.where(has_enter, mat_in["rix"], 1.0)
        # C && semantics: fresnel collapses to 0/1
        # (reference src/scene.c:459)
        fresnel = jnp.where(has_enter,
                            ((mat_in["fresnel"] != 0)
                             & (mat_in["rix"] != 1.0)).astype(dt),
                            0.0)
        chromatic = jnp.where(has_enter, mat_in["chromatic"], 0.0)
        diffuse = jnp.where(has_enter, mat_in["diffuse"], 0.0)
        transparent = jnp.where(
            has_enter,
            _dot(mat_in["transp"], mat_in["transp"]) > 0, False)
        sigma = jnp.where(has_enter, mat_in["sigma"], 0.0)
        sig2 = sigma * sigma
        on_a = jnp.where(sigma > 0, 1.0 - 0.5 * sig2 / (sig2 + 0.33), 1.0)
        on_b = jnp.where(sigma > 0, 0.45 * sig2 / (sig2 + 0.09), 0.0)

        exit_rix = mat_out["rix"]
        trix = jnp.where(has_exit,
                         trix / jnp.where(exit_rix != 0, exit_rix, 1.0),
                         trix)
        fresnel = jnp.where(has_exit, 1.0, fresnel)
        chromatic = jnp.where(has_exit, 0.0, chromatic)
        diffuse = jnp.where(has_exit, 0.0, diffuse)
        transparent = jnp.where(has_exit, True, transparent)

        # Beer-Lambert absorption of this segment
        # (reference src/scene.c:656-664)
        transp = mat_out["transp"]
        # pow(0, t) has an infinite base-derivative: mask the base so the
        # opaque (transp=0) lanes keep a clean zero gradient
        tpos = transp > 0
        powed = jnp.where(tpos,
                          jnp.power(jnp.where(tpos, transp, 1.0),
                                    t_safe[:, None]), 0.0)
        absorb = jnp.where((has_exit & (t_safe > 0))[:, None], powed, 1.0)
        tint_l = tint * absorb

        albedo = e_col

        children = {}

        # --- fresnel branch (reference src/scene.c:473-495)
        fr_gate = shade & (fresnel > 0) & (intensity >= self.tmi)
        R = self._fresnel_reflectance(d, exit_nor, trix) * fresnel
        from actinon_tpu import math3d as m3
        refl_d = m3.reflect(d, exit_nor)
        children["fresnel"] = dict(
            mask=fr_gate, p=pos, d=refl_d, intensity=R * intensity,
            tint=tint_l, depth=depth - 1, sample_id=sid)
        intensity = jnp.where(fr_gate, intensity * (1.0 - R), intensity)

        # --- chromatic branch (reference src/scene.c:498-523)
        ch_gate = shade & (chromatic > 0) & (intensity >= self.tmi)
        children["chromatic"] = dict(
            mask=ch_gate, p=pos, d=refl_d,
            intensity=chromatic * intensity,
            tint=tint_l * albedo, depth=depth - 1, sample_id=sid)
        intensity = jnp.where(ch_gate, intensity * (1.0 - chromatic),
                              intensity)

        # --- diffuse: NEE direct lighting (reference src/scene.c:526-581)
        di = intensity * diffuse
        di_gate = shade & (di >= self.tmi) & (diffuse > 0)
        surf_d = -exit_nor   # outward shading normal
        theta_i = safe_acos(-_dot(d, surf_d))
        ray_prj = _norm3(d - surf_d * _dot(d, surf_d)[:, None])
        if self.seed_mode == "counter":
            # frozen-randomness streams for the differentiable path: the
            # stream id must not depend on scene parameters
            rv = argn.fold(argn.mix(sid.astype(jnp.uint32), 2654435769),
                           depth.astype(jnp.uint32))
        else:
            rv = argn.fold(argn.seed_from_v3(pos, 3294479285),
                           argn.seed_from_v3(surf_d, 3247146734))

        lum_nee = jnp.zeros((B, 3), dt)
        if self.n_lights:
            # skip the whole NEE block at runtime when no lane in the
            # batch shades diffusely (pure-specular wavefront generations
            # — most of a glass scene's deep trips)
            # the zero branch derives from `pos` so both branches carry
            # the same varying-axes type under shard_map (VMA check)
            lum_nee = jax.lax.cond(
                jnp.any(di_gate),
                lambda: self._nee(pos, surf_d, di, di_gate, theta_i, on_a,
                                  on_b, ray_prj, rv),
                lambda: pos * 0.0)
        path_parent = None
        if self.path_cap > 0:
            # spawn descriptors; expansion happens in _spawn_paths
            ns_p = jnp.floor(self.path_cap * di).astype(jnp.int32)
            ns_p = jnp.maximum(ns_p, 1)
            path_gate = di_gate & (depth > 10)
            path_parent = dict(
                mask=path_gate, pos=pos, surf_d=surf_d, di=di,
                ns=ns_p, theta_i=theta_i, on_a=on_a, on_b=on_b,
                ray_prj=ray_prj, rv=rv,
                tint=tint_l * albedo, depth=depth - 10, sample_id=sid)

        contrib += jnp.where(di_gate[:, None], lum_nee * albedo * tint_l,
                             0.0)
        intensity = jnp.where(di_gate, intensity * (1.0 - diffuse),
                              intensity)

        # --- refraction branch (reference src/scene.c:633-653)
        re_gate = shade & transparent & (intensity >= self.tmi)
        refr_d = self._refract_dir(d, exit_nor, trix)
        refr_p = p + d * (t_safe + 2 * self.tr.eps)[:, None]
        children["refract"] = dict(
            mask=re_gate, p=refr_p, d=refr_d, intensity=intensity,
            tint=tint_l, depth=depth - 1, sample_id=sid)

        if mixed:
            # widen the specular blocks to the mixed field set, turn the
            # path-spawn descriptor into a queue-resident parent block,
            # and expand THIS batch's parent lanes into path children
            zero3 = jnp.zeros((B, 3), dt)
            z1 = jnp.zeros((B,), dt)
            zi = jnp.zeros((B,), jnp.int32)
            zu = jnp.zeros((B,), jnp.uint32)
            for name in ("fresnel", "chromatic", "refract"):
                children[name].update(
                    kind=zi, aux_prj=zero3, aux_t=z1, aux_a=z1, aux_b=z1,
                    rv=zu, j0=zi, ns=zi)
            if path_parent is not None:
                pp = path_parent
                children["parent"] = dict(
                    mask=pp["mask"], p=pp["pos"], d=pp["surf_d"],
                    intensity=pp["di"], tint=pp["tint"],
                    depth=pp["depth"], sample_id=pp["sample_id"],
                    kind=jnp.full((B,), 2, jnp.int32),
                    aux_prj=pp["ray_prj"], aux_t=pp["theta_i"],
                    aux_a=pp["on_a"], aux_b=pp["on_b"], rv=pp["rv"],
                    j0=zi, ns=pp["ns"])
                # parent-lane EXPANSION happens in the drain body
                # (_expand_parents), which knows the queue headroom
                path_parent = None

        return sid, contrib, children, path_parent

    # ------------------------------------------------------------------

    def _nee(self, pos, surf_d, di, gate, theta_i, on_a, on_b, ray_prj, rv):
        """Per-light cone-restricted direct light sampling with the
        2*cap_height/n estimator (reference src/scene.c:542-578)."""
        dt = self.dtype
        B = pos.shape[0]
        ns = jnp.floor(jnp.asarray(self.cfg.direct_samples, dt) * di)
        ns = jnp.maximum(ns.astype(jnp.int32), 1)
        ns = jnp.minimum(ns, self.direct_cap)

        lum = jnp.zeros((B, 3), dt)

        # single-sphere lights batch into ONE vectorized block whose
        # shadow traversals run as one flattened call per sample chunk —
        # per-light python emission would copy the whole scene-traversal
        # HLO n_lights times into the module (hanging_lamps_in_row: 10
        # bulbs) and blow up both XLA compile time and launch count
        exact = [li for li in range(self.n_lights)
                 if self.l_sphere_exact[li]]
        legacy = [li for li in range(self.n_lights)
                  if not self.l_sphere_exact[li]]
        if exact:
            lum = lum + self._nee_exact_batch(exact, pos, surf_d, di,
                                              gate, theta_i, on_a, on_b,
                                              ray_prj, rv, ns)

        for li in legacy:
            lpos = self._mt("l_pos")[li]
            lrad = self._mt("l_rad")[li]
            lr = self._mt("l_radius")[li]
            lcol = self._mt("l_color")[li]

            if self.l_fov[li] == "plane":
                # half-space cone (obj_plane_s_fov, reference
                # src/objects.c:520-526): toward -normal; degenerate
                # (cos_rs=1, zero coverage) when the surface is behind
                nrm = jnp.asarray(self.l_plane_n[li])
                fov_d = jnp.broadcast_to(-nrm, pos.shape)
                cos_rs = jnp.where(_dot(lpos - pos, fov_d) > 0, 0.0, 1.0)
            else:
                # sphere / envelope cone toward the light (reference
                # src/objects.c:619-637, envelope_s_fov src/objects.c:70-88)
                cpos = lpos if self.l_sphere_exact[li] \
                    else jnp.asarray(self.l_cone_pos[li])
                diff = cpos - pos
                dist2 = _dot(diff, diff)
                fov_d = _norm3(diff)
                r2 = lr * lr
                cos_rs = jnp.where(
                    dist2 > r2,
                    safe_sqrt(1.0 - r2 /
                              jnp.where(dist2 > 0, dist2, 1.0)),
                    -1.0)
            cyl_hgt = 1.0 - cos_rs
            # frame: transposed(con_z(fov_d)) maps cap samples (around +z)
            # into world (reference src/scene.c:550)
            frame = self._conz_t(fov_d)

            # all samples for this light as one flattened batch: the shadow
            # traces run as [B*S_chunk] rays in few big device calls instead
            # of direct_cap sequential [B] calls (loop latency + small-batch
            # underutilization both vanish).  The flat-ray budget shrinks
            # with the scene's leaf count so B*S x leaves intermediates in
            # the shadow traversal stay bounded (many_spheres: ~1.4k leaves)
            from actinon_tpu.render.tracer import CHUNK as _LCHUNK
            W = max(1, min(len(self.tr.tab), _LCHUNK))
            budget = min(1 << 20, (1 << 26) // W)
            s_chunk = max(1, min(self.direct_cap, budget // max(B, 1)))
            cl_sum = jnp.zeros((B, 3), dt)
            for j0 in range(0, self.direct_cap, s_chunk):
                js = jnp.arange(j0, min(j0 + s_chunk, self.direct_cap))
                S = js.shape[0]
                ctr = 4 * (li * self.direct_cap + js)[None, :]
                u1 = argn.uniform(rv[:, None], ctr, dt)
                u2 = argn.uniform(rv[:, None], ctr + 1, dt)
                # cap sample around +z (math3d.sphere_cap_sample,
                # reference src/vectors.h:197-206)
                from actinon_tpu import math3d as m3
                local = m3.sphere_cap_sample(u1, u2,
                                             cyl_hgt[:, None])  # [B,S,3]
                out_d = _frame_apply(frame, local)
                w = _dotk(out_d, surf_d)
                ok = (js[None, :] < ns[:, None]) & gate[:, None] & (w > 0)

                # true light-geometry hit (obj_ray_hit(light_src, ...),
                # reference src/scene.c:564): exact differentiable sphere
                # formula for single-sphere lights, full object traversal
                # otherwise (plane / quadric / CSG / SDF emitters)
                if self.l_sphere_exact[li]:
                    a = self._sphere_hit(lpos, lr, pos[:, None, :], out_d)
                else:
                    flat_p = jnp.broadcast_to(pos[:, None, :],
                                              (B, S, 3)).reshape(B * S, 3)
                    a = self.tr.object_hit_t(
                        self.l_oid[li], flat_p,
                        out_d.reshape(B * S, 3)).reshape(B, S)
                ok = ok & jnp.isfinite(a)

                w = jnp.where((on_b > 0)[:, None],
                              self._oren_nayar_b(w, theta_i, on_a, on_b,
                                                 out_d, surf_d, ray_prj), w)

                # shadow: no matter hit at or before the light (any-hit
                # query — cheaper than a nearest trace, reference
                # src/scene.c:571 `compound_s_ray_hit(matter) > a`)
                flat_p = jnp.broadcast_to(pos[:, None, :],
                                          (B, S, 3)).reshape(B * S, 3)
                a_lim = jnp.where(jnp.isfinite(a), a, 0.0).reshape(B * S)
                blocked = self.tr.shadow_blocked(
                    flat_p, out_d.reshape(B * S, 3), a_lim).reshape(B, S)
                ok = ok & ~blocked

                a_safe = jnp.where(jnp.isfinite(a), a, 0.0)
                hit_pos = pos[:, None, :] + out_d * a_safe[..., None]
                dsq = jnp.sum((hit_pos - lpos) ** 2, -1)
                loc = jnp.where(dsq > 0, lrad / jnp.where(dsq > 0, dsq, 1.0),
                                F3_MAG)
                contrib = lcol[None, None, :] * (loc * w)[..., None] \
                    * di[:, None, None]
                cl_sum = cl_sum + jnp.sum(
                    jnp.where(ok[..., None], contrib, 0.0), axis=1)
            lum += cl_sum * (2.0 * cyl_hgt / ns.astype(dt))[:, None]
        if getattr(self, "edge_aware", False):
            lum = lum + self._nee_edge_terms(pos, surf_d, di, gate,
                                             theta_i, on_a, on_b, ray_prj)
        return lum

    def _nee_exact_batch(self, idx, pos, surf_d, di, gate, theta_i, on_a,
                         on_b, ray_prj, rv, ns):
        """Vectorized NEE over all single-sphere lights at once
        (reference src/scene.c:542-578 per-light loop, fused):
        cone/frame/cap-sample/light-hit math batches on a light axis, and
        each sample chunk issues ONE flattened shadow traversal for ALL
        lights.  RNG counters match the per-light form exactly
        (ctr = 4*(li*direct_cap + j))."""
        dt = self.dtype
        from actinon_tpu import math3d as m3
        B = pos.shape[0]
        Le = len(idx)
        li = jnp.asarray(np.asarray(idx, np.int32))
        lp = self._mt("l_pos")[li]                     # [Le,3]
        lrad = self._mt("l_rad")[li]
        lr = self._mt("l_radius")[li]
        lcol = self._mt("l_color")[li]

        diff = lp[None] - pos[:, None]                 # [B,Le,3]
        dist2 = _dot(diff, diff)
        fov_d = _norm3(diff)
        r2 = (lr * lr)[None]
        cos_rs = jnp.where(
            dist2 > r2,
            safe_sqrt(1.0 - r2 / jnp.where(dist2 > 0, dist2, 1.0)),
            -1.0)
        cyl = 1.0 - cos_rs                             # [B,Le]
        frame = m3.transposed(m3.con_z(fov_d))         # [B,Le,3,3]

        from actinon_tpu.render.tracer import CHUNK as _LCHUNK
        W = max(1, min(len(self.tr.tab), _LCHUNK))
        budget = min(1 << 20, (1 << 26) // W)
        s_chunk = max(1, min(self.direct_cap,
                             budget // max(B * Le, 1)))
        n_chunks = -(-self.direct_cap // s_chunk)

        def chunk(j0):
            js = j0 + jnp.arange(s_chunk)              # [S]
            ctr = 4 * (li[:, None] * self.direct_cap + js[None, :])
            u1 = argn.uniform(rv[:, None, None], ctr[None], dt)
            u2 = argn.uniform(rv[:, None, None], ctr[None] + 1, dt)
            local = m3.sphere_cap_sample(u1, u2, cyl[..., None])
            out_d = _frame_apply(frame, local)
            w = _dotk(out_d, surf_d[:, None, :])
            ok = (js[None, None] < ns[:, None, None]) \
                & gate[:, None, None] & (w > 0)
            a = _sphere_first_hit(lp[None, :, None], lr[None, :, None],
                                  pos[:, None, None], out_d, self.tr.eps)
            ok = ok & jnp.isfinite(a)
            S = s_chunk
            won = jnp.where(
                (on_b > 0)[:, None, None],
                self._oren_nayar_b(
                    w.reshape(B, Le * S), theta_i, on_a, on_b,
                    out_d.reshape(B, Le * S, 3), surf_d,
                    ray_prj).reshape(B, Le, S), w)
            flat_p = jnp.broadcast_to(pos[:, None, None, :],
                                      (B, Le, S, 3)).reshape(-1, 3)
            a_lim = jnp.where(jnp.isfinite(a), a, 0.0).reshape(-1)
            blocked = self.tr.shadow_blocked(
                flat_p, out_d.reshape(-1, 3), a_lim).reshape(B, Le, S)
            ok = ok & ~blocked
            a_safe = jnp.where(jnp.isfinite(a), a, 0.0)
            hitp = pos[:, None, None, :] + out_d * a_safe[..., None]
            dsq = jnp.sum((hitp - lp[None, :, None]) ** 2, -1)
            loc = jnp.where(dsq > 0,
                            lrad[None, :, None]
                            / jnp.where(dsq > 0, dsq, 1.0), F3_MAG)
            contrib = lcol[None, :, None, :] \
                * (loc * won)[..., None] * di[:, None, None, None]
            return jnp.sum(jnp.where(ok[..., None], contrib, 0.0),
                           axis=2)                     # [B,Le,3]

        if n_chunks == 1:
            cl = chunk(jnp.int32(0))
        else:
            # lax.map: ONE chunk body in the module however many chunks
            # run (each contains a full scene traversal)
            starts = jnp.arange(n_chunks, dtype=jnp.int32) * s_chunk
            cl = jnp.sum(jax.lax.map(chunk, starts), axis=0)
        fac = (2.0 * cyl / ns.astype(dt)[:, None])[..., None]
        return jnp.sum(cl * fac, axis=1)

    def _nee_edge_terms(self, pos, surf_d, di, gate, theta_i, on_a, on_b,
                        ray_prj, K=32):
        """Silhouette boundary term of the NEE visibility integral
        (edge-aware gradients; no reference counterpart — the north-star
        differentiable-path requirement).

        The NEE estimator approximates I = (1/pi) * int_cap V(w) g(w) dw
        with g = cos * OrenNayar * radiance/d^2 * di.  V's discontinuity
        set — the silhouette circle of each sphere occluder as seen from
        the shading point — moves with the scene parameters, so dI/dtheta
        carries a boundary term (Reynolds transport):

            -(1/pi) * oint_C g(w) (nhat . dw/dtheta) sin(alpha) dphi

        over the in-cap, light-blocking arcs of each silhouette.  The
        circle w(phi) = cos(a) u + sin(a)(cos(phi) e1 + sin(phi) e2) is a
        closed form of (occluder center/radius, shading point), so AD
        supplies dw/dtheta: each quadrature node contributes the scalar
        g_detached * sin(a)_detached * (nhat_detached . w_traced), whose
        VALUE is exactly zero (nhat is tangent to the direction sphere at
        w) while its gradient is the boundary integrand.  Light-edge
        motion needs no term: cap sampling z = 1 - u*cyl(theta) already
        reparameterizes samples to move with the cap.

        Covered occluders:
          * single-leaf spheres — silhouette circle (analytic frame),
          * single-leaf planes (half-spaces) — the discontinuity curve is
            the plane∩light-sphere rim circle (the grazing great circle
            carries no jump: at it the plane hit runs past the light);
            sphere-exact lights only,
          * sphere leaves inside CSG composites — the leaf silhouette
            circle, nodes masked to where the COMPOSITE's blocking
            actually jumps (predicate test on both sides),
          * quadric occluders, single-leaf AND as CSG leaves
            (_quadric_sil_nodes): ellipsoids via the affine map that
            unit-izes them (silhouette = mapped sphere circle),
            cylinders via their two tangent generator lines.
        Covered lights: sphere-exact lights (analytic light hit) and
        non-sphere emitters (plane / quadric / CSG lights — detached
        true-geometry light intersection, object_hit_t).
        Remaining interior-only (documented limitations): cone /
        hyperboloid occluders (mixed-sign c2), SDF occluder silhouettes,
        and overlapping-occluder edges, which use the single-occluder
        approximation (a node's jump is evaluated against its own
        occluder only)."""
        dt = self.dtype
        tr = self.tr
        tab = tr.tab
        sg = jax.lax.stop_gradient
        B = pos.shape[0]
        out = jnp.zeros((B, 3), dt)

        # occluder inventory: ("sphere", c, r, comp|None) with traced
        # params, or ("plane", n, k, None)
        occs = []
        sph_c = tr._t("sph_c", tab.sph_c).astype(dt) \
            if len(tab.sph_rows) else None
        sph_r = tr._t("sph_r", tab.sph_r).astype(dt) \
            if len(tab.sph_rows) else None
        for i, row in enumerate(np.asarray(tab.sph_rows)):
            if tab.single[row] and not tab.is_light[row]:
                occs.append(("sphere", sph_c[i], sph_r[i], None))
        for row, key, fam in tab.comp_keys:
            if fam != sir.SPHERE or tab.is_light[row]:
                continue
            comp = next(cp for cp in tr.composites
                        if cp.oid == tab.oid[row])
            c = jnp.asarray(tr._t(key + "c", -tab.m0[row])).astype(dt)
            r = jnp.asarray(tr._t(key + "r",
                                  np.sqrt(-tab.rr[row]))).astype(dt)
            occs.append(("sphere", c, r, comp))
        pla_n = tr._t("pla_n", tab.pla_n).astype(dt) \
            if len(tab.pla_rows) else None
        pla_k = tr._t("pla_k", tab.pla_k).astype(dt) \
            if len(tab.pla_rows) else None
        for i, row in enumerate(np.asarray(tab.pla_rows)):
            if tab.single[row] and not tab.is_light[row]:
                occs.append(("plane", pla_n[i], pla_k[i], None))

        # quadric occluders: silhouette conic per shading point is
        # closed-form (quadric ∩ polar plane).  Ellipsoids map to the
        # sphere case through the affine scaling that unit-izes them;
        # cylinders contribute their two tangent generator lines.
        # Cones/hyperboloids (mixed-sign c2) remain interior-only.
        def _quad_sig(c2s, rrs):
            c2s = np.asarray(c2s, float)
            if (c2s > 0).all() and rrs < 0:
                return ("ellipsoid", -1)
            z = np.isclose(c2s, 0.0)
            if z.sum() == 1 and (c2s[~z] > 0).all() and rrs < 0:
                return ("cylinder", int(np.flatnonzero(z)[0]))
            return (None, -1)

        qua_m = tr._t("qua_m", tab.qua_m).astype(dt) \
            if len(tab.qua_rows) else None
        qua_m0 = tr._t("qua_m0", tab.qua_m0).astype(dt) \
            if len(tab.qua_rows) else None
        qua_c = tr._t("qua_coef", tab.qua_coef).astype(dt) \
            if len(tab.qua_rows) else None
        qua_r = tr._t("qua_r", tab.qua_r).astype(dt) \
            if len(tab.qua_rows) else None
        for i, row in enumerate(np.asarray(tab.qua_rows)):
            if not tab.single[row] or tab.is_light[row]:
                continue
            sig, free = _quad_sig(tab.c2[row], tab.rr[row])
            if sig is None:
                continue
            occs.append(("quadric", dict(
                M=qua_m[i], m0=qua_m0[i], c2=qua_c[i], rr=qua_r[i],
                sig=sig, free=free), None, None))
        for row, key, fam in tab.comp_keys:
            if fam != sir.QUADRIC or tab.is_light[row]:
                continue
            sig, free = _quad_sig(tab.c2[row], tab.rr[row])
            if sig is None:
                continue
            comp = next(cp for cp in tr.composites
                        if cp.oid == tab.oid[row])
            occs.append(("quadric", dict(
                M=jnp.asarray(tr._t(key + "m", tab.M[row])).astype(dt),
                m0=jnp.asarray(tr._t(key + "m0",
                                     tab.m0[row])).astype(dt),
                c2=jnp.asarray(tr._t(key + "coef",
                                     tab.c2[row])).astype(dt),
                rr=jnp.asarray(tr._t(key + "r", tab.rr[row])).astype(dt),
                sig=sig, free=free), None, comp))
        if not occs:
            return out

        phis = (np.arange(K) + 0.5) * (2.0 * np.pi / K)
        cphi = jnp.asarray(np.cos(phis), dt)
        sphi = jnp.asarray(np.sin(phis), dt)
        s_sd, s_ti = sg(surf_d), sg(theta_i)
        s_pos = sg(pos)
        tilt = dt.type(1e-3)    # predicate probe angle off the curve

        def detached_obj_hit(oid, wd):
            """True-geometry first-hit of one object along detached dirs
            [B,K,3] (non-sphere lights): plain forward tracer query."""
            saved_ovr, saved_diff = tr.ovr, tr.diff
            tr.ovr, tr.diff = {}, False
            try:
                flat = sg(wd).reshape(B * K, 3)
                fp = jnp.broadcast_to(s_pos[:, None, :],
                                      (B, K, 3)).reshape(B * K, 3)
                a = tr.object_hit_t(oid, fp, flat)
            finally:
                tr.ovr, tr.diff = saved_ovr, saved_diff
            return a.reshape(B, K)

        for li in range(self.n_lights):
            sphere_exact = self.l_sphere_exact[li]
            lpos = self._mt("l_pos")[li]
            lrad = self._mt("l_rad")[li]
            lr = self._mt("l_radius")[li]
            lcol = self._mt("l_color")[li]
            if self.l_fov[li] == "plane":
                # half-space emitter: fov toward -normal, degenerate
                # cone when the shading point is behind
                nrm = jnp.asarray(self.l_plane_n[li], dt)
                fov_d = jnp.broadcast_to(-nrm, s_pos.shape)
                cos_rs = jnp.where(_dot(sg(lpos) - s_pos, fov_d) > 0,
                                   0.0, 1.0)
            else:
                cpos = lpos if sphere_exact \
                    else jnp.asarray(self.l_cone_pos[li], dt)
                ldiff = sg(cpos) - s_pos
                ldist2 = _dot(ldiff, ldiff)
                fov_d = _norm3(ldiff)
                r2 = sg(lr) * sg(lr)
                cos_rs = jnp.where(
                    ldist2 > r2,
                    safe_sqrt(1.0 - r2
                              / jnp.where(ldist2 > 0, ldist2, 1.0)),
                    -1.0)

            def light_a(wd, _exact=sphere_exact, _lpos=lpos, _lr=lr,
                        _oid=self.l_oid[li]):
                """Light first-hit along detached dirs [B,K,3]: exact
                sphere formula, or the true-geometry traversal for
                non-sphere emitters."""
                if _exact:
                    return self._sphere_hit(sg(_lpos), sg(_lr),
                                            s_pos[:, None, :], wd)
                return detached_obj_hit(_oid, wd)

            for okind, oa, ob, comp in occs:
                if okind == "sphere":
                    c, r = oa, ob
                    rel = c - pos                       # traced
                    d2 = _dot(rel, rel)
                    dist = safe_sqrt(d2)
                    ok0 = (dist > r) & (r > 0) & gate
                    sin_a = jnp.clip(r / jnp.where(dist > 0, dist, 1.0),
                                     0.0, 1.0)
                    cos_a = safe_sqrt(1.0 - sin_a * sin_a)
                    u = _norm3(rel)
                    fr = self._conz_t(u)                # cols e1, e2, u
                    e1, e2 = fr[:, :, 0], fr[:, :, 1]
                    circ = (cphi[None, :, None] * e1[:, None, :]
                            + sphi[None, :, None] * e2[:, None, :])
                    w_dir = (cos_a[:, None, None] * u[:, None, :]
                             + sin_a[:, None, None] * circ)  # traced
                elif okind == "quadric":
                    qd = oa
                    w_dir, ok0 = self._quadric_sil_nodes(
                        qd, pos, gate, cphi, sphi)
                else:
                    if not sphere_exact:
                        # the half-space discontinuity curve is the
                        # plane∩light-sphere rim: sphere lights only
                        continue
                    nvec, koff = oa, ob
                    nn = safe_sqrt(_dot(nvec[None, :], nvec[None, :]))[0]
                    nh = nvec / jnp.where(nn > 0, nn, 1.0)
                    s_l = (jnp.sum(nh * lpos) + koff
                           / jnp.where(nn > 0, nn, 1.0))
                    rc2 = lr * lr - s_l * s_l
                    ok0 = (rc2 > 0) & gate              # plane cuts light
                    rc = safe_sqrt(jnp.maximum(rc2, 0.0))
                    q0 = lpos - s_l * nh                # rim center (3)
                    frp = self._conz_t(nh[None, :])[0]  # cols e1,e2,nh
                    e1p, e2p = frp[:, 0], frp[:, 1]
                    xk = (q0[None, :] + rc * (cphi[:, None] * e1p[None, :]
                                              + sphi[:, None]
                                              * e2p[None, :]))   # [K,3]
                    w_dir = _norm3(xk[None, :, :] - pos[:, None, :])

                wd = sg(w_dir)                          # [B,K,3]
                # curve tangent / speed / in-sphere normal from the node
                # ring (central differences; exact enough at K>=16)
                wp = jnp.roll(wd, -1, axis=1)
                wm = jnp.roll(wd, 1, axis=1)
                dwd = 0.5 * (wp - wm)                   # ~ dw/dphi * dphi
                speed = jnp.sqrt(jnp.sum(dwd * dwd, -1)) \
                    * (K / (2.0 * np.pi))
                th = _norm3(dwd)
                mh = _norm3(jnp.cross(wd, th))

                def blocked(w):
                    """This occluder blocks the light along detached dirs
                    w [B,K,3] (single-occluder predicate)."""
                    a = light_a(w)
                    a_inf = jnp.where(jnp.isfinite(a), a, INF)
                    if okind == "plane":
                        sp = (jnp.sum(sg(nvec)[None, :] * s_pos, -1)
                              + sg(koff))[:, None]
                        den = jnp.einsum("bki,i->bk", w, sg(nvec))
                        t_pl = -sp / jnp.where(den != 0, den, 1.0)
                        return (den != 0) & (t_pl > 0) & (t_pl < a_inf)
                    if okind == "quadric" and comp is None:
                        t_oc = self._quadric_first_hit(oa, s_pos, w)
                        return jnp.isfinite(t_oc) & (t_oc < a_inf)
                    if comp is None:
                        t_oc = self._sphere_hit(sg(c), sg(r),
                                                s_pos[:, None, :], w)
                        return jnp.isfinite(t_oc) & (t_oc < a_inf)
                    # composite: full detached boundary query
                    saved_ovr, saved_diff = tr.ovr, tr.diff
                    tr.ovr, tr.diff = {}, False
                    try:
                        flat = w.reshape(B * K, 3)
                        fp = jnp.broadcast_to(s_pos[:, None, :],
                                              (B, K, 3)).reshape(B * K, 3)
                        blk = tr._shadow_composite(
                            comp, tr._assemble(), fp, flat,
                            a_inf.reshape(B * K))
                    finally:
                        tr.ovr, tr.diff = saved_ovr, saved_diff
                    return blk.reshape(B, K)

                # orient mh toward the UNBLOCKED side, then demand a
                # genuine jump across the node (blocked inside, clear
                # outside)
                w_hi = _norm3(wd + tilt * mh)
                w_lo = _norm3(wd - tilt * mh)
                b_hi = blocked(w_hi)
                b_lo = blocked(w_lo)
                flip = b_hi & ~b_lo
                mh = jnp.where(flip[..., None], -mh, mh)
                jump = b_hi ^ b_lo

                w_cos = jnp.einsum("bki,bi->bk", wd, s_sd)
                g_on = jnp.where(
                    (on_b > 0)[:, None],
                    self._oren_nayar_b(w_cos, s_ti, sg(on_a), sg(on_b),
                                       wd, s_sd, sg(ray_prj)), w_cos)
                a = light_a(wd)
                fin = jnp.isfinite(a)
                in_cap = jnp.einsum("bki,bi->bk", wd, sg(fov_d)) \
                    >= sg(cos_rs)[:, None]
                a_safe = jnp.where(fin, a, 0.0)
                hitp = s_pos[:, None, :] + wd * a_safe[..., None]
                dsq = jnp.sum((hitp - sg(lpos)) ** 2, -1)
                loc = jnp.where(dsq > 0,
                                sg(lrad) / jnp.where(dsq > 0, dsq, 1.0),
                                F3_MAG)
                g = jnp.where(ok0[:, None] & fin & in_cap & jump
                              & (w_cos > 0),
                              loc * g_on * sg(di)[:, None], 0.0)
                g = sg(g)
                # Reynolds boundary term: each node contributes
                # -(2/K) g * speed * (mh . w_traced); the VALUE is zero
                # (mh is tangent to the direction sphere at w) while the
                # gradient is the edge integrand
                x = -(2.0 / K) * jnp.sum(
                    g * sg(speed)
                    * jnp.einsum("bki,bki->bk", sg(mh), w_dir), axis=1)
                xr = sg(lcol)[None, :] * x[:, None]
                out = out + (xr - sg(xr))
        return out

    def _quadric_sil_nodes(self, qd, pos, gate, cphi, sphi):
        """Silhouette quadrature nodes of a quadric occluder as seen
        from `pos` [B,3]: directions w(phi) [B,K,3] (traced) + validity.

        The silhouette of {y: sum c2_i y_i^2 + rr = 0} (y = M x + m0)
        from a point is the quadric ∩ its polar plane — a conic that is
        closed-form after the affine map z_i = y_i sqrt(c2_i/-rr)
        unit-izes the surface:
          * ellipsoid (all c2 > 0): |z| = 1, silhouette = the sphere
            silhouette circle of the mapped viewpoint, mapped back,
          * cylinder (one c2 = 0): the 2-D cross-section circle's two
            tangent points from the projected viewpoint, extended along
            the free axis — two generator lines, parameterized by the
            view angle tan(theta) so nodes concentrate near the
            shading point.
        """
        dt = self.dtype
        B = pos.shape[0]
        K = cphi.shape[0]
        M, m0, c2, rr = qd["M"], qd["m0"], qd["c2"], qd["rr"]
        Minv = jnp.linalg.inv(M)
        yp = pos @ M.T + m0[None, :]                   # [B,3] local
        side = jnp.sum(c2[None, :] * yp * yp, -1) + rr
        if qd["sig"] == "ellipsoid":
            scale = safe_sqrt(c2 / jnp.maximum(-rr, 1e-30))   # [3]
            zp = yp * scale[None, :]
            zl = safe_sqrt(_dot(zp, zp))
            ok0 = (zl > 1.0) & (side > 0) & gate
            zl_s = jnp.where(zl > 0, zl, 1.0)
            cos_a = jnp.clip(1.0 / zl_s, 0.0, 1.0)
            sin_a = safe_sqrt(1.0 - cos_a * cos_a)
            u = zp / zl_s[:, None]
            fr = self._conz_t(u)
            e1, e2 = fr[:, :, 0], fr[:, :, 1]
            circ = (cphi[None, :, None] * e1[:, None, :]
                    + sphi[None, :, None] * e2[:, None, :])
            zphi = (cos_a[:, None, None] * u[:, None, :]
                    + sin_a[:, None, None] * circ)     # [B,K,3]
            yphi = zphi / scale[None, None, :]
            xphi = (yphi - m0[None, None, :]) @ Minv.T
            return _norm3(xphi - pos[:, None, :]), ok0
        # cylinder: 2 tangent generator lines, K/2 nodes each
        free = qd["free"]
        ij = [k for k in range(3) if k != free]
        s2 = safe_sqrt(c2[jnp.asarray(ij)]
                       / jnp.maximum(-rr, 1e-30))      # [2]
        q2 = yp[:, jnp.asarray(ij)] * s2[None, :]      # [B,2]
        ql = safe_sqrt(_dot(q2, q2))
        ok0 = (ql > 1.0) & (side > 0) & gate
        ql_s = jnp.where(ql > 0, ql, 1.0)
        cos_a = jnp.clip(1.0 / ql_s, 0.0, 1.0)
        sin_a = safe_sqrt(1.0 - cos_a * cos_a)
        qhat = q2 / ql_s[:, None]
        qperp = jnp.stack([-qhat[:, 1], qhat[:, 0]], -1)
        Kh = K // 2
        # node angles as seen from the viewpoint along each line
        th = (jnp.arange(Kh, dtype=dt) + 0.5) / Kh * np.pi - np.pi / 2
        tanth = jnp.tan(th)                            # [Kh]
        axis_x = _norm3(Minv[:, free])                 # free axis in x
        ws = []
        for sgn in (1.0, -1.0):
            T2 = cos_a[:, None] * qhat + sgn * sin_a[:, None] * qperp
            y_t = jnp.zeros((B, 3), dt)
            y_t = y_t.at[:, ij[0]].set(T2[:, 0] / s2[0])
            y_t = y_t.at[:, ij[1]].set(T2[:, 1] / s2[1])
            y_t = y_t.at[:, free].set(yp[:, free])
            x0 = (y_t - m0[None, :]) @ Minv.T          # line base [B,3]
            base = x0 - pos
            dist = safe_sqrt(_dot(base, base))
            xk = (x0[:, None, :] + (dist[:, None] * tanth[None, :])
                  [..., None] * axis_x[None, None, :])  # [B,Kh,3]
            ws.append(_norm3(xk - pos[:, None, :]))
        return jnp.concatenate(ws, axis=1), ok0

    def _quadric_first_hit(self, qd, p, w):
        """Detached first-hit of one quadric along dirs w [B,K,3]
        (quadric family root policy, tracer._policy)."""
        sg = jax.lax.stop_gradient
        M, m0, c2, rr = map(sg, (qd["M"], qd["m0"], qd["c2"], qd["rr"]))
        pl = (p @ M.T + m0[None, :])[:, None, :]       # [B,1,3]
        dl = jnp.einsum("bki,ji->bkj", w, M)           # [B,K,3]
        A = jnp.sum(c2[None, None, :] * dl * dl, -1)
        Bq = 2.0 * jnp.sum(c2[None, None, :] * dl * pl, -1)
        Cq = jnp.sum(c2[None, None, :] * pl * pl, -1) + rr
        is_q = A != 0
        sA = jnp.where(is_q, A, 1.0)
        s = (Bq * 0.5) / sA
        q = Cq / sA
        disc = s * s - q
        ok = is_q & (disc >= 0)
        root = safe_sqrt(jnp.where(ok, disc, 0.0))
        t0 = -s - root
        t1 = -s + root
        lin_nz = Bq != 0
        t_lin = jnp.where(lin_nz, -Cq / jnp.where(lin_nz, Bq, 1.0), INF)
        t0 = jnp.where(is_q, jnp.where(ok, t0, INF), t_lin)
        t1 = jnp.where(is_q, jnp.where(ok, t1, INF), INF)
        a = jnp.where(t0 >= 0, t0, jnp.where(t1 >= 0, t1, INF))
        return jnp.where(jnp.isfinite(a), a - self.tr.eps, INF)

    def _conz_t(self, v):
        """transposed(con_z(v)): columns = orthonormal frame with z // v
        (reference src/vectors.h:315-322)."""
        from actinon_tpu import math3d as m3
        return m3.transposed(m3.con_z(v))

    def _oren_nayar(self, weight, theta_i, on_a, on_b, out_d, nor, ray_prj):
        """reference src/scene.c:394-416."""
        theta_r = safe_acos(weight)
        proj = _norm3(out_d - nor * _dot(out_d, nor)[:, None])
        cos_phi = -_dot(proj, ray_prj)
        tan_arg = jnp.minimum(jnp.minimum(theta_i, theta_r),
                              np.pi / 2 - 1e-6)
        return weight * (on_a + on_b * jnp.maximum(cos_phi, 0.0)
                         * jnp.sin(jnp.maximum(theta_i, theta_r))
                         * jnp.tan(tan_arg))

    def _sphere_hit(self, c, r, p, d):
        from actinon_tpu.render.tracer import _sphere_first_hit
        return _sphere_first_hit(c, r, p, d, self.tr.eps)

    # ------------------------------------------------------------------

    def _spawn_paths(self, pp: Dict):
        """Expand path-spawn descriptors into child rays
        (reference src/scene.c:584-621): hemisphere cap sampling with
        cos weight, Oren-Nayar adjust, child tint includes albedo and the
        2/ns estimator factor."""
        dt = self.dtype
        pos, surf_d = pp["pos"], pp["surf_d"]
        B = pos.shape[0]
        frame = self._conz_t(surf_d)
        ns = pp["ns"]
        cap = self.path_cap

        js = jnp.arange(cap)
        u1 = argn.uniform(pp["rv"][:, None],
                          4 * self.direct_cap * max(self.n_lights, 1)
                          + 2 * js[None, :], dt)
        u2 = argn.uniform(pp["rv"][:, None],
                          4 * self.direct_cap * max(self.n_lights, 1)
                          + 2 * js[None, :] + 1, dt)
        from actinon_tpu import math3d as m3
        local = m3.sphere_cap_sample(u1, u2, 1.0)   # hemisphere cap
        out_d = _frame_apply(frame, local)                    # [B,cap,3]
        w = _dotk(out_d, surf_d)
        ok = pp["mask"][:, None] & (js[None, :] < ns[:, None]) & (w > 0)

        won = jnp.where(
            (pp["on_b"] > 0)[:, None],
            self._oren_nayar_b(w, pp["theta_i"], pp["on_a"], pp["on_b"],
                               out_d, surf_d, pp["ray_prj"]), w)

        child_int = won * pp["di"][:, None]
        fac = (2.0 / ns.astype(dt))[:, None, None]
        child_tint = pp["tint"][:, None, :] * fac
        return dict(
            mask=ok,
            p=jnp.broadcast_to(pos[:, None, :], (B, cap, 3)),
            d=out_d,
            intensity=child_int,
            tint=jnp.broadcast_to(child_tint, (B, cap, 3)),
            depth=jnp.broadcast_to(pp["depth"][:, None], (B, cap)),
            sample_id=jnp.broadcast_to(pp["sample_id"][:, None], (B, cap)))

    def _expand_parents(self, q: Dict, allow):
        """Expand parent lanes of a mixed batch into PATH_EXPAND path
        children each plus one continuation (device-resident form of
        _spawn_paths; identical RNG counters, estimator factors and depth
        bookkeeping — reference src/scene.c:584-621).  A parent lane
        stores: p=hit pos, d=outward normal, intensity=di,
        tint=tint*albedo, depth=child depth (already depth-10), plus the
        aux fields (ray_prj/theta_i/on_a/on_b/rv/j0/ns).

        `allow` [B] bool: parents denied by the drain's queue-headroom
        budget emit NO children this trip and re-enqueue unchanged."""
        dt = self.dtype
        K = PATH_EXPAND
        is_parent = q["kind"] == 2
        pos, surf_d = q["p"], q["d"]
        di, ns, j0 = q["intensity"], q["ns"], q["j0"]
        B = pos.shape[0]
        frame = self._conz_t(surf_d)
        js = j0[:, None] + jnp.arange(K, dtype=jnp.int32)[None, :]
        c0 = 4 * self.direct_cap * max(self.n_lights, 1)
        u1 = argn.uniform(q["rv"][:, None], c0 + 2 * js, dt)
        u2 = argn.uniform(q["rv"][:, None], c0 + 2 * js + 1, dt)
        from actinon_tpu import math3d as m3
        local = m3.sphere_cap_sample(u1, u2, 1.0)       # hemisphere cap
        out_d = _frame_apply(frame, local)
        w = _dotk(out_d, surf_d)
        ok = (is_parent & allow)[:, None] & (js < ns[:, None]) & (w > 0) \
            & (di > 0)[:, None]
        won = jnp.where(
            (q["aux_b"] > 0)[:, None],
            self._oren_nayar_b(w, q["aux_t"], q["aux_a"], q["aux_b"],
                               out_d, surf_d, q["aux_prj"]), w)
        ns_f = jnp.maximum(ns.astype(dt), 1.0)
        child_tint = q["tint"] * (2.0 / ns_f)[:, None]
        zero3 = jnp.zeros((B, 3), dt)
        z1 = jnp.zeros((B,), dt)
        zi = jnp.zeros((B,), jnp.int32)
        zu = jnp.zeros((B,), jnp.uint32)
        blocks = []
        for k in range(K):
            blocks.append(dict(
                mask=ok[:, k], p=pos, d=out_d[:, k, :],
                intensity=won[:, k] * di, tint=child_tint,
                depth=q["depth"], sample_id=q["sample_id"],
                kind=jnp.ones((B,), jnp.int32),
                aux_prj=zero3, aux_t=z1, aux_a=z1, aux_b=z1,
                rv=zu, j0=zi, ns=zi))
        cont = is_parent & (di > 0) \
            & jnp.where(allow, j0 + K < ns, True)
        blocks.append(dict(
            mask=cont,
            p=pos, d=surf_d, intensity=di, tint=q["tint"],
            depth=q["depth"], sample_id=q["sample_id"],
            kind=jnp.full((B,), 2, jnp.int32),
            aux_prj=q["aux_prj"], aux_t=q["aux_t"], aux_a=q["aux_a"],
            aux_b=q["aux_b"], rv=q["rv"],
            j0=jnp.where(allow, j0 + K, j0), ns=ns))
        return blocks

    def _oren_nayar_b(self, weight, theta_i, on_a, on_b, out_d, nor,
                      ray_prj):
        """Batched over [B, K] sample axis."""
        theta_r = safe_acos(weight)
        proj = out_d - nor[:, None, :] * _dotk(out_d, nor)[..., None]
        proj = _norm3(proj)
        cos_phi = -_dotk(proj, ray_prj)
        ti = theta_i[:, None]
        tan_arg = jnp.minimum(jnp.minimum(ti, theta_r), np.pi / 2 - 1e-6)
        return weight * (on_a[:, None] + on_b[:, None]
                         * jnp.maximum(cos_phi, 0.0)
                         * jnp.sin(jnp.maximum(ti, theta_r))
                         * jnp.tan(tan_arg))

    # ------------------------------------------------------------------

    def _camera_rays_dev(self, pos_xy):
        """Primary camera rays on device (lum_machine_s_func, reference
        src/scene.c:958-996) — ships [N,2] f32 subpixel positions instead
        of 12 prebuilt ray fields."""
        dt = self.dtype
        cfg = self.cfg
        ir = self.ir
        unit = dt.type(1.0 / (cfg.image_height >> 1))
        x = unit * (pos_xy[:, 0] - (cfg.image_width >> 1))
        z = unit * ((cfg.image_height >> 1) - pos_xy[:, 1])
        d = jnp.stack([x, jnp.full_like(x, cfg.camera_focal_length), z], -1)
        d = _norm3(d)
        d = d @ jnp.asarray(ir.cam_rot, dt).T
        p = jnp.broadcast_to(jnp.asarray(ir.cam_pos, dt), d.shape)
        return p, d

    def run_samples(self, pos_xy: np.ndarray) -> np.ndarray:
        """Render primary camera samples at subpixel positions [N,2]
        (x, y).  On the device drain the queue is BUILT on device from the
        positions; otherwise falls back to host raygen + run()."""
        n = len(pos_xy)
        if getattr(self, "device_drain", True):
            return self.run_device(None, n, pos_xy=pos_xy)
        from actinon_tpu.render.driver import camera_rays
        p, d = camera_rays(self.ir, np.asarray(pos_xy, np.float64),
                           self.dtype)
        primary = RayQueue(
            p, d, np.ones(n, self.dtype), np.ones((n, 3), self.dtype),
            np.full(n, self.cfg.trace_depth, np.int32),
            np.arange(n, dtype=np.int32))
        return self.run(primary, n)

    @property
    def _n_child_blocks(self):
        """Child candidate blocks emitted per drain trip: the 3 specular
        branches, plus (path configs) 1 new-parent block + PATH_EXPAND
        path children + 1 parent continuation."""
        return 3 if self.path_cap == 0 else 5 + PATH_EXPAND

    def _mixed_pad_fields(self, pad):
        """Zero-filled mixed-queue aux fields for `pad` dead lanes."""
        dt = self.dtype
        return dict(
            kind=jnp.zeros((pad,), jnp.int32),
            aux_prj=jnp.zeros((pad, 3), dt),
            aux_t=jnp.zeros((pad,), dt),
            aux_a=jnp.zeros((pad,), dt),
            aux_b=jnp.zeros((pad,), dt),
            rv=jnp.zeros((pad,), jnp.uint32),
            j0=jnp.zeros((pad,), jnp.int32),
            ns=jnp.zeros((pad,), jnp.int32))

    def run_device(self, primary: Optional[RayQueue], n_samples: int,
                   pos_xy: Optional[np.ndarray] = None) -> np.ndarray:
        """Device-resident wavefront drain: the whole pass is ONE jitted
        `lax.while_loop` — raygen (when pos_xy is given), queue, child
        compaction and accumulation all stay on device, so there is no
        per-step host round trip.  Path configs
        (path_samples > 0) run the mixed-kind drain: path spawn parents
        live in the same queue and expand in place (_expand_parents)."""
        dt = self.dtype
        N = n_samples
        # bucket the sample count to a power of two: adaptive passes call
        # with varying N, and every distinct N would otherwise recompile
        # the whole drain (pad lanes are dead: intensity 0)
        Np = 1 << int(np.ceil(np.log2(max(N, 64))))
        B = self.batch
        nb = self._n_child_blocks
        # path configs queue path children transiently: double the slack
        cap_fac = 4 if self.path_cap == 0 else 8
        C = 1 << int(np.ceil(np.log2(max(cap_fac * Np, 4 * B))))

        if not hasattr(self, "_drain_jit"):
            self._drain_jit = {}
        if pos_xy is not None:
            if Np > N:
                pos_xy = np.concatenate(
                    [np.asarray(pos_xy), np.zeros((Np - N, 2))])
            key = ("pos", C, Np)
            if key not in self._drain_jit:
                def init_pos(pos, n_valid):
                    p, d = self._camera_rays_dev(pos)
                    pad = C + nb * B - Np
                    live = (jnp.arange(Np) < n_valid).astype(dt)
                    q = dict(
                        p=jnp.concatenate([p, jnp.zeros((pad, 3), dt)]),
                        d=jnp.concatenate(
                            [d, jnp.tile(jnp.asarray([[0, 0, 1]], dt),
                                         (pad, 1))]),
                        intensity=jnp.concatenate(
                            [live, jnp.zeros((pad,), dt)]),
                        tint=jnp.concatenate(
                            [jnp.broadcast_to(live[:, None], (Np, 3)),
                             jnp.zeros((pad, 3), dt)]),
                        depth=jnp.concatenate(
                            [jnp.full((Np,), self.cfg.trace_depth,
                                      jnp.int32),
                             jnp.zeros((pad,), jnp.int32)]),
                        sample_id=jnp.concatenate(
                            [jnp.arange(Np, dtype=jnp.int32),
                             jnp.zeros((pad,), jnp.int32)]))
                    if self.path_cap:
                        q.update(self._mixed_pad_fields(C + nb * B))
                    return self._init_carry(q, jnp.int32(n_valid), Np)
                # first_fn fuses init + the first chunk: one dispatch
                # instead of two per pass (each costs a host round
                # trip, which matters for sub-second draft passes)
                self._drain_jit[key] = (
                    jax.jit(lambda pos, n_valid, bud: self._drain_carry(
                        init_pos(pos, n_valid), bud, Np, C)),
                    jax.jit(lambda c, bud: self._drain_carry(
                        c, bud, Np, C), donate_argnums=0))
            first_fn, chunk_fn = self._drain_jit[key]
            out = self._drain_chunked(
                chunk_fn, None, key=key,
                first=lambda bud: first_fn(jnp.asarray(pos_xy, dt),
                                           jnp.int32(N), bud))
        else:
            # buffer physically sized C + nb*B so the child write-back is
            # always a full in-bounds block; logical entries live in
            # [0, count)
            buf = primary.padded(C + nb * self.batch, dt)
            init = dict(
                p=jnp.asarray(buf.p), d=jnp.asarray(buf.d),
                intensity=jnp.asarray(buf.intensity),
                tint=jnp.asarray(buf.tint),
                depth=jnp.asarray(buf.depth),
                sample_id=jnp.asarray(buf.sample_id))
            if self.path_cap:
                init.update(self._mixed_pad_fields(C + nb * self.batch))
            key = (C, n_samples)
            if key not in self._drain_jit:
                self._drain_jit[key] = (
                    jax.jit(lambda q, count, bud: self._drain_carry(
                        self._init_carry(q, count, n_samples), bud,
                        n_samples, C)),
                    jax.jit(lambda c, bud: self._drain_carry(
                        c, bud, n_samples, C), donate_argnums=0))
            first_fn, chunk_fn = self._drain_jit[key]
            out = self._drain_chunked(
                chunk_fn, None, key=key,
                first=lambda bud: first_fn(init, jnp.int32(N), bud))
        acc, dropped, queries, trips = jax.device_get(out)
        self.rays_traced += int(queries) * self.per_lane_queries
        self.last_trips = int(trips)
        if int(dropped):
            print(f"warning: ray queue overflow, {int(dropped)} rays "
                  f"dropped", flush=True)
        if int(trips) >= DRAIN_TRIP_CAP:
            print(f"warning: drain trip cap ({DRAIN_TRIP_CAP}) reached — "
                  f"wavefront terminated early, image under-rendered",
                  flush=True)
        return acc[:n_samples].astype(np.float64)

    def _init_carry(self, q0, count0, n_samples, axis=None):
        """Initial drain carry (queue, count, acc, trip, dropped,
        queries) with shard_map varying-axes marking when `axis` is
        set."""
        dt = self.dtype
        # under shard_map the while carry must have consistent varying-axes
        # types: the loop-updated values become device-varying, so every
        # init must be marked varying too (camera origin rows / arange
        # sample ids enter as replicated constants)
        if axis is None:
            pv = lambda x: x
        else:
            def pv(x):
                vma = getattr(jax.typeof(x), "vma", frozenset())
                return x if axis in vma else jax.lax.pcast(
                    x, axis, to="varying")
        acc0 = pv(jnp.zeros((n_samples, 3), dt))
        # `it` advances identically on every device (stays replicated);
        # dropped/queries accumulate device-local values (varying)
        return ({k: pv(v) for k, v in q0.items()}, pv(count0), acc0,
                jnp.int32(0), pv(jnp.int32(0)), pv(jnp.int32(0)))

    def _drain_chunked(self, chunk_fn, carry, target_s=None, key=None,
                       first=None):
        """Host loop around budget-bounded drain chunks.  Each chunk
        runs up to `budget` trips with the carry donated in place on
        device; the host fetches two scalars per chunk and adapts the
        budget toward `target_s` seconds of wall time per call, so no
        single device program runs for an unbounded time and the host
        sees progress between chunks.  The number of chunks of the last
        pass is kept in `last_chunks`.

        Each chunk boundary costs a host round trip, so short draft
        passes must not pay the 8->32->128 ramp every time: the measured
        trips/second is remembered per drain `key` and the next pass
        starts at the budget that should finish it in ~one chunk."""
        import time as _time
        target_s = target_s or DRAIN_CHUNK_TARGET_S
        if not hasattr(self, "_chunk_rate"):
            self._chunk_rate = {}
        rate = self._chunk_rate.get(key)
        # cold start small: a heavy config's trips can run hundreds of
        # ms each, and the FIRST call must stay near the target too
        budget = 8 if rate is None else \
            max(8, min(1 << 16, int(rate * target_s)))
        t_all = _time.time()
        n_chunks = 0
        while True:
            t0 = _time.time()
            if first is not None and n_chunks == 0:
                carry = first(jnp.int32(budget))
            else:
                carry = chunk_fn(carry, jnp.int32(budget))
            n_chunks += 1
            if rate is not None:
                # warm key: the pass usually finishes in this chunk —
                # fetch results together with the stop scalars so a
                # finished pass costs ONE result round trip
                count, it, acc, dropped, queries = jax.device_get(
                    (carry[1], carry[3], carry[2], carry[4], carry[5]))
                count, it = int(count), int(it)
                done = count <= 0 or it >= DRAIN_TRIP_CAP
            else:
                count, it = map(int, jax.device_get((carry[1],
                                                     carry[3])))
                done = count <= 0 or it >= DRAIN_TRIP_CAP
                if done:
                    acc, dropped, queries = jax.device_get(
                        (carry[2], carry[4], carry[5]))
            wall = _time.time() - t0
            if done:
                break
            # grow at most 4x per chunk: per-trip cost can jump when the
            # wavefront enters a heavier phase (path spawn)
            budget = max(8, min(1 << 16, 4 * budget,
                                int(budget * target_s / max(wall, 0.05))))
        if key is not None and it > 0:
            self._chunk_rate[key] = it / max(_time.time() - t_all, 1e-3)
        self.last_chunks = n_chunks
        return acc, dropped, queries, it

    def _drain(self, q0, count0, n_samples, C, axis=None, batch=None):
        """One-shot drain (the sharded per-device body, parallel/mesh.py,
        where the host cannot intervene mid-shard_map).  Single-device
        callers use _init_carry + _drain_carry chunks instead (see
        _drain_chunked)."""
        carry = self._init_carry(q0, count0, n_samples, axis)
        carry = self._drain_carry(carry, jnp.int32(DRAIN_TRIP_CAP),
                                  n_samples, C, axis=axis, batch=batch)
        q, count, acc, it, dropped, queries = carry
        return acc, dropped, queries, it

    def _drain_carry(self, carry, trip_budget, n_samples, C, axis=None,
                     batch=None):
        """Staged drain: pop up to B lanes from the tail, step, compact
        the child rays (cumsum scatter) back onto the tail; runs at most
        `trip_budget` additional trips (the chunk bound).

        The wavefront decays geometrically, so a single batch size wastes
        most of its lane slots on the tail generations (a trip always
        pays the full [B] step whatever `take` is).  The drain therefore
        runs a CASCADE of while_loops with shrinking batch sizes
        [B, B/8, B/64, ...]: stage k runs while count > B_{k+1}, so its
        occupancy never falls below 1/8, and the tail finishes in cheap
        small-batch trips.  Children from a trip of B_k lanes are at most
        3*B_k, so the queue cannot regrow past an earlier stage's domain.

        With `axis` set this runs as the per-device body of a shard_map
        drain (parallel/mesh.py): every device owns an independent local
        queue, and each stage continues until ALL devices pass its
        threshold (pmax over the mesh axis) so the SPMD trip counts
        agree; devices that finish early take zero live lanes per trip."""
        dt = self.dtype
        B = self.batch if batch is None else batch
        it_end = jnp.minimum(carry[3] + trip_budget,
                             jnp.int32(DRAIN_TRIP_CAP))

        # each cascade stage embeds a full scene-traversal body in the
        # module, so stage count trades tail-trip efficiency against XLA
        # compile time; composite-heavy scenes get a two-stage cascade
        stages = [B]
        if len(self.tr.composites) <= 32:
            while stages[-1] > 1024:
                stages.append(max(stages[-1] // 8, 512))
        elif B > 1024:
            stages.append(max(B // 32, 512))

        mixed = self.path_cap > 0
        nb = self._n_child_blocks
        fields = ("p", "d", "intensity", "tint", "depth", "sample_id") \
            + (("kind", "aux_prj", "aux_t", "aux_a", "aux_b", "rv",
                "j0", "ns") if mixed else ())

        def make_body(Bk):
            def body(carry):
                q, count, acc, it, dropped, queries = carry
                s = jnp.maximum(count - Bk, 0)
                take = count - s
                lanes = {k: jax.lax.dynamic_slice_in_dim(v, s, Bk, axis=0)
                         for k, v in q.items()}
                valid = jnp.arange(Bk) < take
                lanes["intensity"] = jnp.where(valid, lanes["intensity"],
                                               0.0)

                sid, contrib, children, _ = self._step(lanes,
                                                       path_ray=False,
                                                       mixed=mixed)
                acc = acc.at[sid].add(
                    jnp.where(valid[:, None], contrib, 0.0))

                # compact [nb*Bk] child candidates into a dense prefix:
                # scatter ONLY an int32 source index and pull the row
                # fields through one gather instead of scattering full
                # rows
                ch = list(children.values())
                if mixed:
                    # parent expansion under a queue-headroom budget: a
                    # trip's specular+new-parent children take <= 4*Bk
                    # rows; each allowed parent adds K+1 more.  Parents
                    # beyond the budget re-enqueue untouched, so the
                    # queue can NEVER overflow from path spawn (the >=1
                    # floor guarantees drain progress; its worst-case
                    # overshoot is one parent's K+1 rows, absorbed by the
                    # buffer slack and the dropped-rays backstop).
                    K = PATH_EXPAND
                    is_par = valid & (lanes["kind"] == 2)
                    # headroom from the ACTUAL take, not the static stage
                    # width: with `take` live lanes a trip emits at most
                    # 4*take specular/new-parent rows, so that is what
                    # the budget must reserve.  (Round-4 fix: budgeting
                    # with Bk let a steady-state queue of ~0.3*Bk path
                    # parents starve to allow_n=1 — ONE parent expansion
                    # per trip — which made wine_glass's shipped config
                    # crawl through thousands of trips.)
                    allow_n = jnp.maximum((C - s - 4 * take) // (K + 1), 1)
                    rank = jnp.cumsum(is_par.astype(jnp.int32)) - 1
                    allow = is_par & (rank < allow_n)
                    ch = ch + self._expand_parents(lanes, allow)
                cmask = jnp.concatenate(
                    [c["mask"] & valid & (c["intensity"] > 0) for c in ch])
                posn = jnp.cumsum(cmask.astype(jnp.int32)) - 1
                nv = posn[-1] + 1
                pos = jnp.where(cmask, posn, nb * Bk)  # invalid -> dropped
                nv_fit = jnp.minimum(nv, C - s)
                dropped = dropped + (nv - nv_fit)

                src = jnp.zeros((nb * Bk,), jnp.int32).at[pos].set(
                    jnp.arange(nb * Bk, dtype=jnp.int32), mode="drop")
                live = jnp.arange(nb * Bk) < nv_fit
                qn = {}
                for f in fields:
                    a = jnp.concatenate([c[f] for c in ch])
                    comp = a[src]
                    if f == "intensity":
                        comp = jnp.where(live, comp, 0.0)
                    qn[f] = jax.lax.dynamic_update_slice_in_dim(
                        q[f], comp.astype(q[f].dtype), s, axis=0)
                # count only LIVE non-parent lanes (shared accounting
                # definition, per_lane_queries): dead pad lanes do no
                # work and must not count on any drain
                alive = valid & (lanes["intensity"] > 0)
                if mixed:
                    alive = alive & (lanes["kind"] != 2)
                tq = jnp.sum(alive, dtype=jnp.int32)
                return (qn, s + nv_fit, acc, it + 1, dropped,
                        queries + tq)
            return body

        def make_cond(thresh):
            def cond(carry):
                q, count, acc, it, dropped, queries = carry
                c = count if axis is None else jax.lax.pmax(count, axis)
                return (c > thresh) & (it < it_end)
            return cond

        for k, Bk in enumerate(stages):
            thresh = stages[k + 1] if k + 1 < len(stages) else 0
            carry = jax.lax.while_loop(make_cond(thresh), make_body(Bk),
                                       carry)
        return carry

    def run(self, primary: RayQueue, n_samples: int,
            progress=None) -> np.ndarray:
        """Drain the wavefront; returns per-sample radiance [n_samples, 3]
        (un-saturated)."""
        if self.path_cap == 0 and getattr(self, "device_drain", True):
            return self.run_device(primary, n_samples)
        dt = self.dtype
        acc = np.zeros((n_samples, 3), np.float64)
        qn = RayQueue.empty(dt)
        qn.append(primary)
        qp = RayQueue.empty(dt)
        spawn_jit = jax.jit(self._spawn_paths) if self.path_cap else None

        # path batches are wide ([B, path_cap] children): keep B modest
        path_parent_batch = max(1, (1 << 22) // max(self.path_cap, 1)) \
            if self.path_cap else 0

        steps = 0
        # shared accounting definition (see __init__.per_lane_queries)
        per_ray_queries = self.per_lane_queries
        while len(qn) or len(qp):
            use_path = len(qp) >= len(qn)
            queue = qp if use_path else qn
            B = min(self.batch, max(len(queue), 1))
            # bucket B to limit recompiles
            B = 1 << max(int(np.ceil(np.log2(B))), 6)
            n_eff = min(B, len(queue))
            self.rays_traced += n_eff * per_ray_queries
            got = queue.pop(n_eff).padded(B, dt)
            jq = {k: jnp.asarray(getattr(got, k))
                  for k in ("p", "d", "intensity", "tint", "depth",
                            "sample_id")}
            step = self._step_path if use_path else self._step_normal
            out = step(jq)
            # single bulk transfer: per-array np.asarray would pay one
            # host<->device round trip each
            sid, contrib, children, path_parent = jax.device_get(out)
            np.add.at(acc, sid, contrib.astype(np.float64))

            for ch in children.values():
                self._enqueue(qn, ch)
            if path_parent is not None:
                self._enqueue_paths(qp, path_parent, spawn_jit,
                                    path_parent_batch)
            steps += 1
            if progress:
                progress(steps, len(qn), len(qp))
        return acc

    def _enqueue(self, queue: RayQueue, ch: Dict):
        mask = np.asarray(ch["mask"])
        # cull: dead, depth<=0 children that cannot contribute anything?
        # NO: a depth-0 child still contributes background on miss
        # (reference parent-side miss handling, src/scene.c:484-493), so
        # only intensity==0 rays are dropped.
        keep = mask & (np.asarray(ch["intensity"]) > 0)
        if not keep.any():
            return
        queue.append(RayQueue(
            np.asarray(ch["p"])[keep], np.asarray(ch["d"])[keep],
            np.asarray(ch["intensity"])[keep],
            np.asarray(ch["tint"])[keep],
            np.asarray(ch["depth"])[keep].astype(np.int32),
            np.asarray(ch["sample_id"])[keep].astype(np.int32)))

    def _enqueue_paths(self, queue: RayQueue, pp: Dict, spawn_jit, pb: int):
        mask = np.asarray(pp["mask"])
        idx = np.flatnonzero(mask)
        if len(idx) == 0:
            return
        for s in range(0, len(idx), pb):
            sel = idx[s:s + pb]
            sub = {k: (jnp.asarray(np.asarray(v)[sel])
                       if not np.isscalar(v) else v)
                   for k, v in pp.items()}
            ch = jax.device_get(spawn_jit(sub))
            m = np.asarray(ch["mask"]).reshape(-1)
            if not m.any():
                continue
            flat = lambda a: np.asarray(a).reshape(
                (-1,) + np.asarray(a).shape[2:])[m]
            queue.append(RayQueue(
                flat(ch["p"]), flat(ch["d"]),
                flat(ch["intensity"]).astype(self.dtype),
                flat(ch["tint"]),
                flat(ch["depth"]).astype(np.int32),
                flat(ch["sample_id"]).astype(np.int32)))
