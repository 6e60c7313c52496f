"""The benchmark imports nothing of JAX or the JAX package, and its
references import nothing of the program either (top-level names compared
whole: deepcut_tpu_torch is not deepcut_tpu)."""

import ast
from pathlib import Path

PB = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "deepcut_tpu"}


def imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    bad = {str(p.relative_to(PB)): sorted(set(imported(p)) & JAX) for p in PB.rglob("*.py")}
    assert not {k: v for k, v in bad.items() if v}


def test_references_import_no_program():
    refs = list((PB / "reference").glob("*.py"))
    assert refs
    bad = {p.name: sorted(set(imported(p)) & (JAX | {"deepcut_tpu_torch"})) for p in refs}
    assert not {k: v for k, v in bad.items() if v}


def test_the_walk_sees_an_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom deepcut_tpu.ops import conv\nimport deepcut_tpu_torch\n")
    assert set(imported(probe)) == {"jax", "deepcut_tpu", "deepcut_tpu_torch"}
