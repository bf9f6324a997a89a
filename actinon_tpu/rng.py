"""Counter-based, position-seedable RNG for wavefront kernels.

The reference threads a 64-bit LCG state through every sampling loop and
derives the seed deterministically from the surface point being shaded
(v3d_s_random_seed, reference src/vectors.h:177-190, used at
src/scene.c:537 and src/objects.c:269).  That per-position determinism is the
reference's key reproducibility trick: re-rendering a pixel re-produces the
same light samples.

In a vectorized wavefront a mutable per-lane LCG state serializes the
sampler, so we keep the *seeding scheme* (hash of the surface point) but
replace the LCG stream with a
stateless counter-based generator: draw k of stream s is ``mix(s, k)`` where
``mix`` is a murmur3-style avalanche over uint32 lanes.  Fully vectorized,
no cross-iteration dependency, identical reproducibility properties.

Bit-exact parity with the reference stream is impossible anyway (the LCG
constants live in the non-vendored beth library); validation therefore targets
estimator equivalence, not bitstreams (SURVEY.md section 7, 'RNG strategy').
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


_M1 = np.uint32(0x85EBCA6B)
_M2 = np.uint32(0xC2B2AE35)
_GOLDEN = np.uint32(0x9E3779B9)


def _fmix32(h):
    """murmur3 finalizer — full-avalanche 32-bit mixer."""
    h = h ^ (h >> 16)
    h = h * _M1
    h = h ^ (h >> 13)
    h = h * _M2
    h = h ^ (h >> 16)
    return h


def mix(seed, counter):
    """One uint32 draw of stream `seed` at position `counter` (broadcast)."""
    seed = jnp.asarray(seed, jnp.uint32)
    counter = jnp.asarray(counter, jnp.uint32)
    return _fmix32(seed ^ _fmix32(counter * _GOLDEN + np.uint32(1)))


def uniform(seed, counter, dtype=jnp.float32):
    """Uniform in [0, 1): top 24 bits of the draw (enough for rendering in
    either storage dtype)."""
    dtype = np.dtype(dtype)
    bits = mix(seed, counter)
    return (bits >> np.uint32(8)).astype(dtype) * dtype.type(1.0 / (1 << 24))


def uniform_signed(seed, counter, dtype=jnp.float32):
    """Uniform in (-1, 1), the f3_rnd0 analog (reference src/vectors.h:45)."""
    dtype = np.dtype(dtype)
    return uniform(seed, counter, dtype) * dtype.type(2.0) - dtype.type(1.0)


def seed_from_v3(pos, salt):
    """Deterministic stream id from a 3-D position, the v3d_s_random_seed
    analog (reference src/vectors.h:177-190): hash of the (f32) coordinate
    bits, mixed per component with distinct salts."""
    import jax
    # seeding is bit-twiddling on the coordinates: never differentiable,
    # and bitcasts have no AD rule — detach explicitly
    p32 = jax.lax.stop_gradient(jnp.asarray(pos, jnp.float32))
    bx = jnp.asarray(p32[..., 0]).view(jnp.uint32)
    by = jnp.asarray(p32[..., 1]).view(jnp.uint32)
    bz = jnp.asarray(p32[..., 2]).view(jnp.uint32)
    s = jnp.asarray(np.uint32(salt & 0xFFFFFFFF), jnp.uint32)
    h = _fmix32(bx ^ s)
    h = _fmix32(by ^ (h * _M1))
    h = _fmix32(bz ^ (h * _M2))
    return h


def fold(seed_a, seed_b):
    """Combine two stream ids."""
    return _fmix32(jnp.asarray(seed_a, jnp.uint32) * _M1
                   ^ jnp.asarray(seed_b, jnp.uint32) * _M2)


# --------------------------------------------------------------------------
# host-side sequential generator (sample-position generation, envelope
# estimation): mirrors the role of beth's bcore_lcg00_u3 stream
# (reference src/vectors.h:45-48) with Knuth MMIX constants.

_LCG_MUL = np.uint64(6364136223846793005)
_LCG_ADD = np.uint64(1442695040888963407)


class HostLcg:
    """Sequential 64-bit LCG for host-side (scene build / driver) sampling."""

    def __init__(self, state: int):
        self.state = np.uint64(state)

    def next_u64(self) -> np.uint64:
        with np.errstate(over="ignore"):
            self.state = self.state * _LCG_MUL + _LCG_ADD
        return self.state

    def rnd1(self) -> float:
        """Uniform in (0, 1) (f3_rnd1 analog, reference src/vectors.h:48)."""
        return float(self.next_u64()) * (1.0 / float(0xFFFFFFFFFFFFFFFF))

    def rnd0(self) -> float:
        """Uniform in (-1, 1) (f3_rnd0 analog, reference src/vectors.h:45)."""
        return self.rnd1() * 2.0 - 1.0

    def sphere_belt(self, h: float) -> np.ndarray:
        """v3d_s_random_sphere_belt analog (reference src/vectors.h:209-218)."""
        phi = 2.0 * np.pi * self.rnd1()
        z = self.rnd0() * h
        scale = np.sqrt(max(1.0 - z * z, 0.0))
        return np.array([np.sin(phi) * scale, np.cos(phi) * scale, z])
