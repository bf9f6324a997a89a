"""The benchmark scenes in scenes/, the render path they drive, and the
persistent compile cache's placement."""

import glob
import os

import jax
import numpy as np
import pytest

from actinon_tpu import compile_cache, scenes
from actinon_tpu.render.integrator import Integrator
from actinon_tpu.render.tracer import Tracer
from actinon_tpu.scene import ir as sir


def test_scene_dir_holds_exactly_the_named_scenes():
    entries = {os.path.splitext(os.path.basename(p))[0]
               for p in glob.glob(os.path.join(scenes.SCENE_DIR, "*.acn"))}
    entries |= {os.path.basename(d) for d in
                glob.glob(os.path.join(scenes.SCENE_DIR, "*"))
                if os.path.isdir(d)}
    assert entries == set(scenes.NAMES)
    for name in scenes.NAMES:
        assert os.path.exists(scenes.scene_path(name))


@pytest.mark.parametrize("name", scenes.NAMES)
def test_scene_parses_and_compiles_to_ir(name):
    sc = scenes.load(name)
    ir = sir.compile_scene(sc)
    assert ir.lights, "every benchmark scene has a light"
    assert len(ir.objects) > len(ir.lights)
    assert sc.cfg.image_width >= 640 and sc.cfg.image_height >= 480
    with open(scenes.scene_path(name)) as f:
        head = f.read(600)
    assert "not the reference" in head


@pytest.mark.parametrize("name", scenes.NAMES)
def test_render_step_builds_no_pallas_call(name):
    """The f32 wavefront step of every scene lowers to plain XLA."""
    sc = scenes.load(name)
    ir = sir.compile_scene(sc)
    integ = Integrator(Tracer(ir, dtype=np.float32), batch=64)
    B = 64
    q = dict(p=np.zeros((B, 3), np.float32),
             d=np.tile(np.float32([[0, 1, 0]]), (B, 1)),
             intensity=np.ones(B, np.float32),
             tint=np.ones((B, 3), np.float32),
             depth=np.full(B, 5, np.int32),
             sample_id=np.arange(B, dtype=np.int32))
    jaxpr = jax.make_jaxpr(lambda q: integ._step(q, path_ray=False))(q)
    assert "pallas_call" not in str(jaxpr)


def test_compile_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.cache_dir() == os.path.join(root, ".jax_cache")


def test_compile_cache_dir_follows_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_compile_cache_stays_off_on_cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    compile_cache.enable()
    assert not jax.config.jax_enable_compilation_cache
    assert jax.config.jax_compilation_cache_dir == before
    assert not os.listdir(tmp_path)
