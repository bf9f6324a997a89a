"""chip_smoke.py's phase helpers at tiny sizes on the CPU.

The script's main() needs a GPU and refuses the CPU; the helpers it runs
on the card are plain functions, so their control flow, shapes and
comparisons are checked here.  The four-device sharded phase runs on
four of the virtual CPU devices that conftest.py creates.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def test_main_refuses_cpu(capsys):
    assert cs.main([]) == 2
    out = capsys.readouterr()
    assert "no GPU" in out.err
    assert '"ok"' not in out.out


def test_precision_probe_full_f32():
    assert cs.precision_probe(n=64) < 1e-5


def test_time_scenes_reports_pass_figures():
    """Phase 3 with two scenes compiling in concurrent threads: each
    thread's XLA compile seconds are its own."""
    cfgs = {"primitives": (16, 12, 2, 0, 6), "wine_glass": (8, 6, 2, 0, 6)}
    out = cs.time_scenes(cfgs, batch=256)
    assert set(out) == set(cfgs)
    for r in out.values():
        assert r["warm_pass_s"] > 0 and r["first_pass_s"] > 0
        assert 0 < r["compile_s"] < r["first_pass_s"]
        assert r["queries"] > 0 and r["queries_per_s"] > 0
        assert r["chunks"] >= 1 and r["trips"] >= 1
        assert np.isfinite(r["mean"])
        assert r["temp_size_in_bytes"] >= 0


def test_drain_memory_of_the_pass_program():
    sc = cs.scene_with("wine_glass", 8, 6, 2, 0, 4)
    integ = cs.integrator(sc, np.float32, 256)
    pos = cs.pixel_centers(8, 6)
    integ.run_samples(pos)
    mem = cs.drain_memory(integ, len(pos))
    assert all(v >= 0 for v in mem.values())


_TINY_SCRIPT = """
def scene = scene_s;
scene.image_width = 16; scene.image_height = 12;
scene.trace_depth = 12; scene.direct_samples = 2;
scene.gradient_cycles = 1; scene.gradient_samples = 2;
scene.gradient_threshold = 0.01;
scene.camera_position = vec(0,-6,2);
scene.camera_view_direction = vec(0,6,-1);
scene.camera_top_direction = vec(0,0,1);
def lamp = create_sphere(0.5) + vec(0,0,6);
lamp.set_radiance( 20 );
scene.push( lamp );
scene.push( create_plane() );
def ball = create_sphere(1) + vec(0,0,1.2);
ball.set_material( "diffuse" );
scene.push( ball );
scene.create_image( "tiny.pnm" );
"""


def test_main_path_cli_then_path_pass(tmp_path):
    script = tmp_path / "tiny.acn"
    script.write_text(_TINY_SCRIPT)
    out = tmp_path / "out"
    out.mkdir()
    t_cli, t_path = cs.main_path(str(out), str(script), path_samples=2)
    assert t_cli > 0 and t_path > 0
    assert (out / "tiny.pnm").exists()          # the CLI's own output
    assert (out / "tiny_path.pnm").exists()


def test_compare_renders():
    rng = np.random.default_rng(0)
    a = rng.uniform(0.1, 1.0, (48, 3))
    c = cs.compare_renders(a, a, 0.6)
    assert c == {"mean_rel": 0.0, "share": 1.0, "max_abs": 0.0}
    b = a.copy()
    b[0] += 0.5
    c = cs.compare_renders(b, a, 1.0)
    assert c["share"] == pytest.approx(47 / 48)
    assert c["mean_rel"] > 0


def test_check_render_f32_against_f64_within_bounds():
    """The correctness phase's comparison on the CPU: f32 against f64
    with counter-seeded streams stays inside the stated bounds (the
    tests run with x64 enabled, conftest.py)."""
    ref, gamma = cs.check_render("wine_glass", np.float64, *cs.CHECK_CFG)
    acc, _ = cs.check_render("wine_glass", np.float32, *cs.CHECK_CFG)
    c = cs.compare_renders(acc, ref, gamma)
    assert c["mean_rel"] <= cs.MEAN_REL_BOUND
    assert c["share"] >= cs.PIXEL_SHARE_BOUND


def test_diff_steps_finite():
    vals, secs = cs.diff_steps(16, 2)
    assert len(vals) == 2 and all(np.isfinite(vals))
    assert len(secs) == 2


def test_cpu_reference_writes_every_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(cs, "CHECK_CFG", (8, 6, 2, 6))
    monkeypatch.setattr(cs, "DIFF_CHECK_BATCH", 8)
    path = str(tmp_path / "ref.npz")
    cs.cpu_reference(path)
    ref = np.load(path)
    for name in cs.CHECK_SCENES:
        assert ref[name].shape == (48, 3)
        assert ref[name].dtype == np.float64
    assert np.isfinite(float(ref["diff_value"]))
    assert np.isfinite(ref["diff_grad"]).all()
    d = cs.compare_diff(float(ref["diff_value"]), ref["diff_grad"],
                        float(ref["diff_value"]), ref["diff_grad"])
    assert d == {"value_rel": 0.0, "grad_rel_l2": 0.0}


def test_sharded_check_on_four_devices():
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    # the script runs without x64 (conftest.py turns it on for the
    # f64 tests); under x64 the drains' accumulation order differs
    with jax.enable_x64(False):
        r = cs.sharded_check(4, (16, 12, 2, 0, 8), (8, 6, 2, 2, 12),
                             normal_batch=1 << 12, path_batch=1 << 9,
                             diff_batch=16, batch_per_device=64)
    for label in ("normal", "path"):
        assert r[label]["max_err"] < cs.SHARD_BOUND
        assert 0 < r[label]["balance"] <= 1.0
    assert r["diff"]["value_err"] < 1e-5
