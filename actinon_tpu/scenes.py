"""The benchmark scenes kept in this repository (`scenes/` at its root).

Each scene is an `.acn` script written for one benchmark config and the
mechanisms that config stands for; a multi-file scene lives in a
subdirectory named like its entry file (`scenes/hanging_lamp/`).
"""

from __future__ import annotations

import os

SCENE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")

NAMES = ("primitives", "wine_glass", "many_spheres", "diamond",
         "hanging_lamp")


def scene_path(name: str) -> str:
    """Entry file of scene `name`."""
    path = os.path.join(SCENE_DIR, f"{name}.acn")
    if not os.path.exists(path):
        path = os.path.join(SCENE_DIR, name, f"{name}.acn")
    return path


def load(name: str):
    """The Scene that scene `name` passes to its first create_image
    call (nothing is rendered or written)."""
    from actinon_tpu.acn.interp import run_file

    captured = []
    run_file(scene_path(name),
             render_fn=lambda sc, fn: captured.append(sc.clone()),
             args=["-f"])
    if not captured:
        raise ValueError(f"scene {name!r} never calls create_image")
    return captured[0]
