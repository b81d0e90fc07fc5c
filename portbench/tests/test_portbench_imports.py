"""No module that a run loads is JAX's, flax's, optax's, orbax's or the
JAX package's (top-level names compared whole), and the plain reference
loads nothing of the program."""

import ast
import json
import subprocess
import sys

import pytest

from portbench import run, spec

PROGRAM = "rl_selfplay_mnk_tpu_torch"
REFERENCE_FILES = ("reference.py", "check.py", "yardstick.py", "trace.py", "spec.py",
                   *sorted(f"families/{p.name}" for p in (spec.ROOT / "families").glob("*.py")))


def loaded_by(code: str) -> list:
    """Top-level names of the modules a fresh interpreter holds after ``code``."""
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(spec.ROOT.parent)!r}); "
         f"{code}; import json; print(json.dumps(sorted({{m.split('.')[0] "
         f"for m in sys.modules}})))"],
        capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_harness_and_the_port_load_no_jax():
    names = loaded_by(
        "import portbench.run, portbench.harness, portbench.check, portbench.control; "
        f"import {PROGRAM}.train, {PROGRAM}.train_fused, {PROGRAM}.alg.fused, "
        f"{PROGRAM}.selfplay.validation, {PROGRAM}.models.registry")
    assert PROGRAM in names
    assert not set(names) & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_by("import portbench.reference, portbench.check, portbench.yardstick, "
                      "portbench.trace, portbench.spec; "
                      "[portbench.spec.family({'family': f}) for f in portbench.spec.families()]")
    assert not {n for n in names if n.startswith("rl_selfplay_mnk_tpu")}
    assert not set(names) & set(run.FORBIDDEN)


@pytest.mark.parametrize("name", REFERENCE_FILES)
def test_the_reference_files_import_no_program(name):
    tree = ast.parse((spec.ROOT / name).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert not mod.split(".")[0].startswith("rl_selfplay_mnk_tpu"), (name, mod)
            assert mod.split(".")[0] not in run.FORBIDDEN, (name, mod)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax_like_but_not_jax", object())
    monkeypatch.setitem(sys.modules, PROGRAM + ".fake_leaf", object())
    assert "rl_selfplay_mnk_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.core", object())
    assert run.forbidden_modules() == ["flax"]
