"""Tests of the .acn language front-end: lexer, evaluator, operator model,
containers, closures, and the benchmark scenes (SURVEY.md section 2.8)."""

import os

import numpy as np
import pytest

from actinon_tpu.acn.interp import AcnError, run_file, run_source
from actinon_tpu.scenes import scene_path
from actinon_tpu.scene.objects import (
    ArrS, Compound, MapS, Neg, PairInside, PairOutside, Plane, ScaleWrap,
    Sphere, Squaroid,
)


def ev(src, **kw):
    """Evaluate a single expression statement and return its value."""
    ret, _ = run_source(src, **kw)
    return ret


# ---------------------------------------------------------------------------
# expressions & types


def test_arithmetic():
    assert ev("1 + 2 * 3;") == 7
    assert ev("(1 + 2) * 3;") == 9
    assert ev("7 % 3;") == 1
    assert ev("1 / 2;") == 0.5
    # reference model: a - b - c = a + (-b + -c)  (src/interpreter.c:1706)
    assert ev("2 - 3 - 4;") == -5
    assert ev("10 - 2 * 3;") == 4
    assert abs(ev("1.5e2;") - 150.0) < 1e-12


def test_comparisons_and_logic():
    assert ev("1 < 2;") is True
    assert ev("2 <= 2;") is True
    assert ev("3 <> 4;") is True
    assert ev("true & false;") is False
    assert ev("true | false;") is True
    assert ev("true ^ true;") is False
    assert ev("!false;") is True


def test_strings():
    assert ev('"a" + "b";') == "ab"
    assert ev('"n=" + 5;') == "n=5"
    assert ev('5 + "=n";') == "5=n"
    assert ev('string_to_num( "42" );') == 42
    assert abs(ev('string_to_num( "4.5" );') - 4.5) < 1e-12


def test_string_fa_format():
    assert ev('string_fa( "v#<f3_t>x", 2.5 );') == "v2.5x"
    assert ev('string_fa( "n#<s3_t>!", 7 );') == "n7!"
    assert ev("string_fa( \"#pl3'0'{#<s3_t>}\", 5 );") == "005"


def test_variables_and_def():
    assert ev("def x = 5; x + 1;") == 6
    assert ev("def x; x = 3; x * 2;") == 6
    assert ev("def x = 1; x += 2; x;") == 3
    assert ev("def x = 8; x /= 2; x;") == 4.0
    with pytest.raises(AcnError):
        ev("y = 5;")  # undefined
    with pytest.raises(AcnError):
        ev("def x = 1; def x = 2;")  # redefinition


def test_vectors():
    v = ev("vec(1,2,3);")
    np.testing.assert_allclose(v, [1, 2, 3])
    np.testing.assert_allclose(ev("vecz(2) + vecx(1);"), [1, 0, 2])
    assert ev("vec(1,2,3) * vec(4,5,6);") == 32.0  # dot product
    np.testing.assert_allclose(ev("vec(1,2,3) * 2;"), [2, 4, 6])
    v = ev("def p = vec(1,2,3); p.y = 9; p;")
    np.testing.assert_allclose(v, [1, 9, 3])
    assert ev("vec(1,2,3).z;") == 3.0


def test_rotations():
    m = ev("rotz(90);")
    np.testing.assert_allclose(m @ np.array([1.0, 0, 0]), [0, 1, 0], atol=1e-12)
    v = ev("rotz(90) * vec(1,0,0);")
    np.testing.assert_allclose(v, [0, 1, 0], atol=1e-12)
    # m3d*m3d uses m3d_s_mlm: row i of (a*b) = a @ (row i of b)
    # (reference src/vectors.h:278-281) — so rotz(90)*rotz(90) is identity.
    v = ev("( rotz(90) * rotz(90) ) * vec(1,0,0);")
    np.testing.assert_allclose(v, [1, 0, 0], atol=1e-12)
    m = ev("rotz(90) * rotx(45);")
    rz, rx = np.asarray(ev("rotz(90);")), np.asarray(ev("rotx(45);"))
    for i in range(3):
        np.testing.assert_allclose(m[i], rz @ rx[i], atol=1e-12)


def test_math_builtins():
    assert abs(ev("sqrt(16);") - 4) < 1e-12
    assert abs(ev("sqr(3);") - 9) < 1e-12
    assert abs(ev("sin_d(90);") - 1) < 1e-12
    assert abs(ev("cos_d(60);") - 0.5) < 1e-12
    assert abs(ev("pow(2,10);") - 1024) < 1e-9
    assert abs(ev("to_deg(3.141592653589793);") - 180) < 1e-9
    assert ev("floor(2.7);") == 2.0
    assert ev("ceiling(2.2);") == 3.0


# ---------------------------------------------------------------------------
# control flow


def test_if_else():
    assert ev("def x = 0; if (true) x = 1; x;") == 1
    assert ev("def x = 0; if (false) x = 1; x;") == 0
    assert ev("def x = 0; if (false) x = 1 else x = 2; x;") == 2
    assert ev("def x = 0; if (true) x = 1 else x = 2; x;") == 1


def test_while():
    assert ev("def i = 0; def s = 0; while (i < 5) { s += i; i += 1; } (); s;") == 10


def test_while_simple_body():
    assert ev("def i = 0; while (i < 4) i += 1; i;") == 4


def test_for_in():
    src = """
    def l = [];
    l[0] = 1; l[1] = 2; l[2] = 3;
    def s = 0;
    for x (in l) s += x;
    s;
    """
    assert ev(src) == 6


def test_block_closure():
    src = """
    def f = { 42; };
    f();
    """
    assert ev(src) == 42


def test_typed_closure():
    src = """
    def add = <-( num a, num b ) * { a + b; };
    add( 2, 3 );
    """
    assert ev(src) == 5


def test_closure_lexical_scope():
    src = """
    def base = 10;
    def addb = <-( num a ) * { a + base; };
    addb( 5 );
    """
    assert ev(src) == 15


def test_closure_type_error():
    with pytest.raises(AcnError):
        ev('def f = <-( num a ) * { a; }; f( "x" );')


def test_recursion():
    src = """
    def fac; fac = <-( int n ) * { def r = 1; if (n > 1) r = n * fac( n - 1 ); r; };
    fac( 5 );
    """
    assert ev(src) == 120


# ---------------------------------------------------------------------------
# containers


def test_list_ops():
    assert ev("def l = []; l.push(7); l[0];") == 7
    assert ev("def l = []; l[4] = 1; l.size();") == 5
    l = ev("1 : 2 : 3;")
    assert isinstance(l, ArrS) and l.data == [1, 2, 3]


def test_map_module_pattern():
    src = """
    def m = map_s;
    m.answer = 42;
    m.fn = <-( num x ) * { x + m.answer; };
    m.fn( 1 );
    """
    assert ev(src) == 43


def test_map_has():
    assert ev("def m = map_s; m.k = 1; m.has( k );") is True
    assert ev("def m = map_s; m.has( k );") is False


def test_value_semantics_def_clones():
    src = """
    def a = vec(1,2,3);
    def b = a;
    b.x = 9;
    a.x;
    """
    assert ev(src) == 1.0


# ---------------------------------------------------------------------------
# object algebra


def test_object_factories():
    assert isinstance(ev("create_sphere(2);"), Sphere)
    assert isinstance(ev("create_plane();"), Plane)
    assert isinstance(ev("create_cylinder(1,1);"), Squaroid)
    assert isinstance(ev("obj_sphere_s;"), Sphere)


def test_obj_move_rotate_scale_operators():
    s = ev("create_sphere(1) + vec(0,0,5);")
    np.testing.assert_allclose(s.prp.pos, [0, 0, 5])
    s = ev("create_sphere(1) * 2;")
    assert s.radius == 2.0
    s = ev("create_sphere(1) * vec(2,1,1);")
    assert isinstance(s, ScaleWrap)
    s = ev("( create_sphere(1) + vecx(1) ) * rotz(90);")
    np.testing.assert_allclose(s.prp.pos, [0, 1, 0], atol=1e-12)


def test_obj_csg_operators():
    assert isinstance(ev("create_sphere(1) & create_sphere(1);"), PairInside)
    assert isinstance(ev("create_sphere(1) | create_sphere(1);"), PairOutside)
    assert isinstance(ev("!create_sphere(1);"), Neg)


def test_composite_prefixes():
    src = "def l = create_sphere(1) : ( create_sphere(1) + vecx(1) );"
    assert isinstance(ev(src + " (&) l;"), PairInside)
    assert isinstance(ev(src + " (|) l;"), PairOutside)
    assert isinstance(ev(src + " (:) l;"), Compound)
    c = ev(src + " (@) l;")
    assert isinstance(c, Compound) and c.envelope is not None


def test_obj_methods():
    s = ev('def s = create_sphere(1); s.set_color( color(1,0,0) ); s;')
    np.testing.assert_allclose(s.prp.color, [1, 0, 0])
    s = ev('def s = create_sphere(1); s.set_material( "glass" ); s;')
    assert s.prp.refractive_index == 1.46
    s = ev('def s = create_sphere(1); s.set_radiance( 25 ); s;')
    assert s.prp.radiance == 25.0
    s = ev('def s = create_sphere(1); s.radius = 3; s;')
    assert s.radius == 3.0


def test_scene_configuration():
    src = """
    def scene = scene_s;
    scene.image_width = 320;
    scene.trace_depth = 25;
    scene.camera_position = vec(0,-10,2);
    scene.push( create_sphere(1) );
    scene;
    """
    sc = ev(src)
    assert sc.cfg.image_width == 320
    assert sc.cfg.trace_depth == 25
    np.testing.assert_allclose(sc.cfg.camera_position, [0, -10, 2])
    assert sc.matter.size() == 1


def test_program_args():
    assert ev("program_args.size();", args=["-f", "x"]) == 2
    assert ev("program_args[1];", args=["-f", "x"]) == "x"


def test_file_ops(tmp_path):
    p = str(tmp_path / "claim.tmp")
    src = f"""
    def claimed = false;
    if ( !file_exists( "{p}" ) ) {{
        file_touch( "{p}" );
        claimed = true;
    }} ();
    claimed;
    """
    assert ev(src) is True
    assert os.path.exists(p)
    assert ev(f'file_rename( "{p}", "{p}.done" );') is True
    assert ev(f'file_delete( "{p}.done" );') is True


# ---------------------------------------------------------------------------
# benchmark scenes (the integration suite, SURVEY.md section 4)

CORPUS = [
    ("primitives", 1, 7),
    ("wine_glass", 1, 3),
    ("diamond", 1, 4),
    ("many_spheres", 1, 1366),
    ("hanging_lamp", 1, 63),
]


@pytest.mark.parametrize("scene,nlight,nmatter", CORPUS)
def test_corpus_builds(scene, nlight, nmatter):
    captured = []

    def render_fn(sc, fname):
        captured.append((len(sc.light.leaf_objects()),
                         len(sc.matter.leaf_objects())))

    run_file(scene_path(scene), render_fn=render_fn, args=["-f"])
    assert captured, "scene never called create_image"
    assert captured[0] == (nlight, nmatter)
