"""Differentiable rendering path (no counterpart in the reference).

The forward framework reproduces the reference renderer
(scene_s_lum, reference src/scene.c:420-667); this module adds the
backward pass over it: per-pixel radiance as a differentiable function of

  * all material parameters (albedo/texture colors, radiance, refractive
    index, fresnel/chromatic/diffuse weights, sigma, transparency,
    light position/radiance/radius, background), and
  * all analytic geometry parameters (sphere centers/radii, plane
    normals/offsets, quadric frames/coefficients — standalone or inside
    CSG composites), via implicit-function differentiation, which is free
    here because every hit distance is in closed form.

Design constraints under XLA:

  * The production wavefront drain (integrator.run_device) compacts
    queues inside a `lax.while_loop`, which has no reverse-mode rule.
    The differentiable integrator instead uses **stochastic path replay**:
    at every bounce exactly ONE child branch (fresnel / chromatic /
    refraction / path sample) is selected, with probability proportional
    to its (detached) contribution weight, and reweighted by 1/p — an
    unbiased single-sample estimator of the full branching recursion.
    The chain becomes a fixed-trip `lax.scan` over bounces with a
    constant-size ray batch: reverse-differentiable, static shapes,
    nothing but the tracer's straight-line XLA inside.
  * RNG streams are derived from (sample_id, depth) counters instead of
    hit positions (integrator.seed_mode="counter") so the randomness is
    *frozen* with respect to the scene parameters — the reference's
    position-hashed seeding (src/scene.c:537) would make the sample set a
    discontinuous function of geometry and break finite-difference
    validation.
  * Discrete events (nearest-object selection, CSG boundary identity)
    are treated as locally constant: gradients are the *interior*
    derivatives, exact wherever the integrand is smooth.  The NEE
    visibility discontinuity additionally gets an explicit **silhouette
    boundary term** when `edge_aware=True`: deterministic quadrature
    over each sphere occluder's silhouette circle adds the Reynolds
    transport term of the moving shadow edge
    (integrator._nee_edge_terms), FD-validated in tests/test_diff.py.
    The light's own edge needs no term — cap sampling is already a
    differentiable reparameterization of the moving cone domain.

Validation: tests/test_diff.py checks jax.grad against central finite
differences through multi-bounce transport (diffuse NEE, Fresnel
reflection, refraction chains, Beer-Lambert absorption, CSG geometry).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

from actinon_tpu import rng as argn
from actinon_tpu.render.integrator import Integrator
from actinon_tpu.render.tracer import _norm3, _dot

_SEL_SALT = 0xB5297A4D


class EdgeCoverageWarning(UserWarning):
    """A diff-mode scene contains occluder classes whose silhouette
    motion the edge-aware NEE boundary term does not cover."""


def edge_coverage_gaps(tracer):
    """Occluder classes in this scene that _nee_edge_terms treats as
    interior-only (round-4 verdict next #8: surface the gap instead of
    silently returning zero silhouette gradients).  Returns a set of
    human-readable class names (empty = full coverage)."""
    from actinon_tpu.scene import ir as sir
    tab = tracer.tab
    gaps = set()

    def quad_covered(c2s, rrs):
        c2s = np.asarray(c2s, float)
        if (c2s > 0).all() and rrs < 0:
            return True                        # ellipsoid
        z = np.isclose(c2s, 0.0)
        return bool(z.sum() == 1 and (c2s[~z] > 0).all() and rrs < 0)

    rows = list(np.asarray(tab.qua_rows))
    keys = {row for row, _k, fam in tab.comp_keys if fam == sir.QUADRIC}
    for row in rows:
        if tab.is_light[row] or not (tab.single[row] or row in keys):
            continue
        if not quad_covered(tab.c2[row], tab.rr[row]):
            gaps.add("cone/hyperboloid quadric")
    if any(not light for *_, light in tracer.sdf_singles):
        gaps.add("SDF object")
    for comp in tracer.comp_solo:
        if not comp.is_light and any(lf is not None
                                     for lf in comp.sdf_leaves):
            gaps.add("SDF CSG leaf")
    return gaps


class DiffRenderer:
    """Differentiable radiance estimator over an Integrator's scene.

    Usage:
        dr = DiffRenderer(integ)
        params = dr.params()                  # pytree of traced leaves
        f = lambda ps: dr.radiance(ps, q0).mean()
        val, grads = jax.value_and_grad(f)(params)
    """

    def __init__(self, integ: Integrator, n_steps: Optional[int] = None,
                 sel_mode: str = "balanced", edge_aware: bool = False):
        self.integ = integ
        self.tr = integ.tr
        self.dtype = integ.dtype
        # edge_aware: add the silhouette boundary term of the NEE
        # visibility integral (integrator._nee_edge_terms) so occluder
        # geometry gets correct gradients across shadow edges
        self.edge_aware = edge_aware
        if edge_aware:
            gaps = edge_coverage_gaps(self.tr)
            if gaps:
                import warnings
                warnings.warn(
                    "edge-aware NEE gradients do not cover these "
                    f"occluder classes in this scene: {sorted(gaps)} — "
                    "their silhouette motion contributes no gradient "
                    "(interior terms only; see "
                    "integrator._nee_edge_terms docstring)",
                    EdgeCoverageWarning, stacklevel=2)
        # one scan step consumes >= 1 depth unit, so trace_depth bounds
        # the chain length
        self.n_steps = int(integ.cfg.trace_depth) if n_steps is None \
            else n_steps
        # branch selection law:
        #  "balanced" — probability proportional to the (detached) branch
        #    weight; lowest variance, and the AD gradient is unbiased, but
        #    the *realized* sample is not differentiable-by-FD because the
        #    detached 1/p factors move under parameter perturbation.
        #  "uniform" — theta-independent probabilities 1/K; realized
        #    FD == AD exactly (used by the finite-difference tests),
        #    higher variance (dead branches get selected).
        assert sel_mode in ("balanced", "uniform")
        self.sel_mode = sel_mode

    # ------------------------------------------------------------------

    def params(self) -> Dict:
        """All differentiable scene parameters as a pytree."""
        return {"geom": self.tr.geom_params(),
                "mat": self.integ.mat_params()}

    def primary(self, pos2d: np.ndarray) -> Dict:
        """Primary ray batch for subpixel positions [N,2] (x, y)."""
        from actinon_tpu.render.driver import camera_rays
        p, d = camera_rays(self.tr.ir, np.asarray(pos2d, np.float64),
                           self.dtype)
        n = len(p)
        return {
            "p": jnp.asarray(p), "d": jnp.asarray(d),
            "intensity": jnp.ones((n,), self.dtype),
            "tint": jnp.ones((n, 3), self.dtype),
            "depth": jnp.full((n,), self.integ.cfg.trace_depth, jnp.int32),
            "sample_id": jnp.arange(n, dtype=jnp.int32),
            "is_path": jnp.zeros((n,), bool),
        }

    # ------------------------------------------------------------------

    def _path_child(self, pp: Dict):
        """ONE hemisphere path sample from the path-spawn descriptors —
        the single-sample unbiased analog of _spawn_paths (reference
        src/scene.c:584-621: ns samples averaged with tint*2/ns; one
        sample scaled by ns gives tint*2)."""
        integ = self.integ
        dt = self.dtype
        frame = integ._conz_t(pp["surf_d"])
        c0 = 4 * integ.direct_cap * max(integ.n_lights, 1)
        u1 = argn.uniform(pp["rv"], c0, dt)
        u2 = argn.uniform(pp["rv"], c0 + 1, dt)
        phi = 2.0 * jnp.pi * u1
        z = 1.0 - u2
        sc = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
        local = jnp.stack([jnp.sin(phi) * sc, jnp.cos(phi) * sc, z], -1)
        out_d = jnp.einsum("rij,rj->ri", frame, local)
        w = _dot(out_d, pp["surf_d"])
        won = jnp.where(
            pp["on_b"] > 0,
            integ._oren_nayar(w, pp["theta_i"], pp["on_a"], pp["on_b"],
                              out_d, pp["surf_d"], pp["ray_prj"]), w)
        mask = pp["mask"] & (w > 0)
        return dict(
            mask=mask, p=pp["pos"], d=out_d,
            intensity=won * pp["di"],
            tint=pp["tint"] * 2.0,
            depth=pp["depth"], sample_id=pp["sample_id"])

    def _diff_step(self, q: Dict, step_i):
        """One bounce: shade, then stochastically follow ONE child branch.
        Returns (contrib [B,3], next ray state)."""
        integ = self.integ
        dt = self.dtype
        B = q["p"].shape[0]
        is_path = q["is_path"]
        lane = {k: q[k] for k in ("p", "d", "intensity", "tint", "depth",
                                  "sample_id")}

        sid, contrib, children, pp = integ._step(lane, path_ray=False)
        if integ.path_cap > 0:
            # path rays trace matter-only and clamp at max_path_length
            # (reference src/scene.c:596-617); run both classifications and
            # select per-lane — only needed when path tracing is enabled
            _, contrib_p, children_p, pp_p = integ._step(lane, path_ray=True)
            contrib = jnp.where(is_path[:, None], contrib_p, contrib)
            for k in children:
                a, b = children[k], children_p[k]
                children[k] = {
                    f: jnp.where(
                        is_path.reshape((B,) + (1,) * (a[f].ndim - 1)),
                        b[f], a[f]) for f in a}
            if pp is not None:
                pp = {f: (jnp.where(
                    is_path.reshape((B,) + (1,) * (np.ndim(pp[f]) - 1)),
                    pp_p[f], pp[f]) if not np.isscalar(pp[f]) else pp[f])
                    for f in pp}

        # candidate branches
        cand = [children["fresnel"], children["chromatic"],
                children["refract"]]
        path_sel = None
        if integ.path_cap > 0 and pp is not None:
            path_sel = self._path_child(pp)
            cand.append(path_sel)
        K = len(cand)

        w = jnp.stack([jnp.where(c["mask"], c["intensity"], 0.0)
                       for c in cand], axis=-1)                  # [B,K]
        w_det = jax.lax.stop_gradient(w)
        W_det = jnp.sum(w_det, axis=-1)
        alive = W_det > 0
        W_safe = jnp.where(alive, W_det, 1.0)
        if self.sel_mode == "uniform":
            probs = jnp.full_like(w_det, 1.0 / K)
        else:
            probs = w_det / W_safe[:, None]
        cum = jnp.cumsum(probs, axis=-1)

        sel_seed = argn.mix(q["sample_id"].astype(jnp.uint32), _SEL_SALT)
        u = argn.uniform(sel_seed, step_i, dt)
        k_sel = jnp.sum((u[:, None] >= cum).astype(jnp.int32), axis=-1)
        k_sel = jnp.minimum(k_sel, K - 1)

        def pick(field, default):
            out = default
            for k in range(K):
                v = cand[k][field]
                m = (k_sel == k).reshape((B,) + (1,) * (v.ndim - 1))
                out = jnp.where(m, v, out)
            return out

        # 1/p reweighting: chosen branch's intensity w_k scaled by
        # W_det / w_k_det keeps the estimator unbiased and the gradient
        # of w_k intact
        w_sel = jnp.take_along_axis(w, k_sel[:, None], axis=-1)[:, 0]
        w_sel_det = jnp.take_along_axis(w_det, k_sel[:, None],
                                        axis=-1)[:, 0]
        if self.sel_mode == "uniform":
            scale = self.dtype.type(K)
        else:
            scale = W_det / jnp.where(w_sel_det > 0, w_sel_det, 1.0)
        new_int = jnp.where(alive, w_sel * scale, 0.0)

        nq = {
            "p": pick("p", q["p"]),
            "d": pick("d", q["d"]),
            "intensity": new_int,
            "tint": pick("tint", q["tint"]),
            "depth": pick("depth", jnp.zeros((B,), jnp.int32)),
            "sample_id": q["sample_id"],
            "is_path": (k_sel == 3) & alive if path_sel is not None
            else jnp.zeros((B,), bool),
        }
        return contrib, nq

    # ------------------------------------------------------------------

    def radiance(self, params: Dict, q0: Dict,
                 n_steps: Optional[int] = None):
        """Per-sample radiance [B,3], differentiable w.r.t. `params`.
        Pure function of (params, q0); call under jit/grad."""
        integ, tr = self.integ, self.tr
        n = self.n_steps if n_steps is None else n_steps
        saved = (integ.ovr, tr.ovr, tr.diff, integ.seed_mode,
                 getattr(integ, "edge_aware", False))
        integ.ovr = dict(params.get("mat", {}))
        tr.ovr = dict(params.get("geom", {}))
        tr.diff = True
        integ.seed_mode = "counter"
        integ.edge_aware = self.edge_aware
        try:
            B = q0["p"].shape[0]
            acc0 = jnp.zeros((B, 3), self.dtype)

            def body(carry, i):
                q, acc = carry
                contrib, nq = self._diff_step(q, i)
                return (nq, acc + contrib), None

            (_, acc), _ = jax.lax.scan(
                body, (q0, acc0), jnp.arange(n, dtype=jnp.int32))
            return acc
        finally:
            (integ.ovr, tr.ovr, tr.diff, integ.seed_mode,
             integ.edge_aware) = saved

    def render_loss(self, params: Dict, q0: Dict, weight=None):
        """Scalar mean weighted radiance — convenience loss head."""
        rad = self.radiance(params, q0)
        if weight is not None:
            rad = rad * weight
        return jnp.mean(rad)

    def value_and_grad(self, q0: Dict, weight=None):
        """(loss, grads) at the scene's own parameters."""
        f = lambda ps: self.render_loss(ps, q0, weight)
        return jax.value_and_grad(f)(self.params())
