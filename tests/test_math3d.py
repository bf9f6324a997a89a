"""Unit tests for the batched vector/matrix layer (actinon_tpu.math3d)
against numpy oracles and the reference's documented semantics."""

import numpy as np
import jax.numpy as jnp
import pytest

from actinon_tpu import math3d as m3


def rng_vecs(n=64, seed=0):
    r = np.random.default_rng(seed)
    return r.normal(size=(n, 3))


def test_dot_cross_sqr():
    a, b = rng_vecs(seed=1), rng_vecs(seed=2)
    np.testing.assert_allclose(m3.dot(a, b), (a * b).sum(-1), rtol=1e-12)
    np.testing.assert_allclose(m3.cross(a, b), np.cross(a, b), rtol=1e-12)
    np.testing.assert_allclose(m3.sqr(a), (a * a).sum(-1), rtol=1e-12)


def test_of_length_semantics():
    v = np.array([[3.0, 4.0, 0.0], [0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    out = np.asarray(m3.of_length(v, 2.0))
    np.testing.assert_allclose(out[0], [1.2, 1.6, 0.0], atol=1e-12)
    # zero vector stays zero
    np.testing.assert_allclose(out[1], [0, 0, 0])
    # already-unit vector passes through unchanged (reference src/vectors.h:150)
    np.testing.assert_allclose(out[2], [1, 0, 0])


def test_normalize():
    a = rng_vecs(seed=3)
    n = np.asarray(m3.normalize(a))
    np.testing.assert_allclose((n * n).sum(-1), 1.0, rtol=1e-9)


def test_von_orthogonal():
    o, v = rng_vecs(seed=4), rng_vecs(seed=5)
    w = np.asarray(m3.von(o, v))
    np.testing.assert_allclose((w * o).sum(-1) / np.linalg.norm(o, axis=-1),
                               0.0, atol=1e-9)
    np.testing.assert_allclose((w * w).sum(-1), 1.0, rtol=1e-9)


def test_con_orthogonal_unit():
    o = rng_vecs(seed=6)
    c = np.asarray(m3.con(o))
    np.testing.assert_allclose((c * o).sum(-1) / np.linalg.norm(o, axis=-1),
                               0.0, atol=1e-9)
    np.testing.assert_allclose((c * c).sum(-1), 1.0, rtol=1e-9)


def test_reflect():
    d = np.array([[1.0, -1.0, 0.0]]) / np.sqrt(2)
    n = np.array([[0.0, 1.0, 0.0]])
    r = np.asarray(m3.reflect(d, n))
    np.testing.assert_allclose(r, [[1 / np.sqrt(2), 1 / np.sqrt(2), 0]],
                               atol=1e-12)


def test_rotations_orthonormal():
    for rot in (m3.rot_x, m3.rot_y, m3.rot_z):
        m = np.asarray(rot(jnp.asarray(0.7)))
        np.testing.assert_allclose(m @ m.T, np.eye(3), atol=1e-12)
        assert np.isclose(np.linalg.det(m), 1.0)


def test_rot_z_action():
    m = np.asarray(m3.rot_z(jnp.asarray(np.pi / 2)))
    np.testing.assert_allclose(m @ np.array([1.0, 0, 0]), [0, 1, 0], atol=1e-12)


def test_mlm_matches_reference_contract():
    """m3d_s_mlm: row i of result = a applied to row i of b
    (reference src/vectors.h:278-281)."""
    r = np.random.default_rng(7)
    a, b = r.normal(size=(3, 3)), r.normal(size=(3, 3))
    out = np.asarray(m3.mlm(a, b))
    for i in range(3):
        np.testing.assert_allclose(out[i], a @ b[i], rtol=1e-12)


def test_con_z_frame():
    v = rng_vecs(seed=8)
    f = np.asarray(m3.con_z(v))
    # rows orthonormal, z-row parallel to v
    np.testing.assert_allclose(
        np.einsum("nij,nkj->nik", f, f), np.tile(np.eye(3), (len(v), 1, 1)),
        atol=1e-9)
    vn = v / np.linalg.norm(v, axis=-1, keepdims=True)
    np.testing.assert_allclose(f[:, 2, :], vn, atol=1e-9)


def test_sphere_cap_sample_bounds():
    u = np.random.default_rng(9).uniform(size=(1000, 2))
    h = 0.3
    pts = np.asarray(m3.sphere_cap_sample(u[:, 0], u[:, 1], h))
    np.testing.assert_allclose((pts * pts).sum(-1), 1.0, rtol=1e-9)
    assert pts[:, 2].min() >= 1.0 - h - 1e-12
    # Archimedes: z uniform in [1-h, 1]
    assert abs(pts[:, 2].mean() - (1.0 - h / 2)) < 0.02


def test_sphere_belt_sample_bounds():
    u = np.random.default_rng(10).uniform(size=(1000, 2))
    h = 0.8
    pts = np.asarray(m3.sphere_belt_sample(u[:, 0], u[:, 1], h))
    np.testing.assert_allclose((pts * pts).sum(-1), 1.0, rtol=1e-9)
    assert np.abs(pts[:, 2]).max() <= h + 1e-12


def test_saturate_color():
    c = np.array([[0.25, 1.5, -0.1]])
    out = np.asarray(m3.saturate_color(c, 0.5))
    np.testing.assert_allclose(out, [[0.5, 1.0, 0.0]], atol=1e-12)


@pytest.mark.parametrize("sample", [m3.sphere_cap_sample,
                                    m3.sphere_belt_sample])
def test_cap_sample_gradient_finite_at_degenerate_height(sample):
    """A cap thinner than the f32 spacing at 1 (a small light far away)
    gives z == 1 exactly; the gradient must stay finite there."""
    import jax

    def f(h):
        return sample(jnp.float32(0.3), jnp.float32(0.5), h).sum()

    for h in (1e-9, 0.0):
        g = jax.grad(f)(jnp.float32(h))
        assert np.isfinite(np.asarray(g))
