"""Scene build must stay host-side: no import-time device arrays.

Module-level ``jnp`` constants (BIG/UP/...) would be placed on the default
accelerator at import time, and every eager CPU-context op that touched one
during DemoScene().build() would pay a device->host transfer. Module-level
constants are numpy; this test pins it by AST-scanning the package for any
import-time ``jnp.`` expression (module-level assignment or function default
argument).
"""

import ast
import pathlib

import numpy as np
import pytest

pytestmark = pytest.mark.fast

PKG = pathlib.Path(__file__).resolve().parent.parent / "swift_game_engine_tpu"


def _uses_jnp(expr: ast.AST) -> bool:
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Name) and sub.id == "jnp":
            return True
    return False


def test_no_import_time_jnp_arrays():
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text())
        # module-level assignments (col_offset 0 = top level statements)
        for node in tree.body:
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                value = getattr(node, "value", None)
                if value is not None and _uses_jnp(value):
                    offenders.append(f"{path.name}:{node.lineno} module assign")
        # default arguments anywhere (evaluated at def time == import time
        # for module-level functions)
        for node in ast.walk(tree):
            if isinstance(node, ast.arguments):
                for d in list(node.defaults) + [d for d in node.kw_defaults if d]:
                    if _uses_jnp(d):
                        offenders.append(f"{path.name}:{d.lineno} default arg")
    assert not offenders, (
        "import-time jnp expressions place arrays on the accelerator and "
        "make eager host-context ops pay device transfers:\n" +
        "\n".join(offenders))


def test_build_produces_host_arrays():
    """DemoScene.build() output must not require accelerator round trips:
    the hot packed products it returns are numpy (or CPU-backed) arrays."""
    from swift_game_engine_tpu.scene.demo_scene import DemoScene
    import jax

    scene = DemoScene(include_imported_assets=False).build()
    geo = scene["geometry"]
    for name, arr in [("tri", geo.tri), ("static_pos", geo.static_pos)]:
        if isinstance(arr, jax.Array):
            assert arr.devices() == {jax.devices("cpu")[0]} or \
                jax.default_backend() == "cpu", \
                f"geometry.{name} built on accelerator"
