"""Golden-corpus regression oracle.

The reference's own regression mechanism is the per-pass fold-hash of the
packed 8-bit image (reference src/scene.c:141-146, printed each pass at
src/scene.c:881): with deterministic position-seeded RNG a scene renders
bit-identically, so the hash is a full-image check.  This suite renders
every benchmark scene in scenes/ at a tiny deterministic config on the
CPU and compares the hash (exact) and the mean radiance
(tolerance-friendly secondary signal) against tests/golden_hashes.json
(regenerate with tests/golden_gen.py).

A one-pixel change anywhere in the render stack fails the hash compare.
"""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from golden_gen import CORPUS, render_one  # noqa: E402

GOLDEN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "golden_hashes.json")

with open(GOLDEN_PATH) as f:
    GOLDEN = json.load(f)

# the full corpus is rendered by default; mark the slowest scenes so a
# quick pass (-m "not slow_golden") still covers every subsystem
SLOW = {"hanging_lamp", "many_spheres"}


def test_golden_covers_corpus():
    """Every corpus scene must have a recorded golden entry (or a
    documented skip reason)."""
    missing = [n for n in CORPUS
               if n not in GOLDEN and f"{n}__skipped" not in GOLDEN]
    assert not missing, f"no golden entry for: {missing}"


@pytest.mark.parametrize(
    "name",
    [pytest.param(n, marks=pytest.mark.slow_golden) if n in SLOW
     else n for n in sorted(CORPUS)])
def test_golden(name):
    if name not in GOLDEN:
        reason = GOLDEN.get(f"{name}__skipped", "no golden entry")
        pytest.skip(f"{name}: {reason}")
    got = render_one(name)
    want = GOLDEN[name]
    assert abs(got["mean"] - want["mean"]) < 1e-6, \
        f"{name}: mean {got['mean']} != {want['mean']}"
    assert got["hash"] == want["hash"], \
        f"{name}: image hash changed (mean ok: {got['mean']})"
