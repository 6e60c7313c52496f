"""The port's public surface against the JAX package's, read with `ast`.

For every module of `deepcut_tpu/` (read as source, never imported: no JAX
module is loaded here) the port must hold the counterpart module at the
same path under `deepcut_tpu_torch/`, defining every public top-level
function and class and every public method of a public class. "Public" is
a name without a leading underscore. The port may bind a name by a `def`, a
`class`, an import or an assignment at the module's top level (a method:
in the class body).

The only exceptions are the entries of `EXCEPTIONS`, each with its reason
and the port's replacement, which must exist. An exception that is no
longer needed (the JAX package lost the name, or the port gained it) fails
too, so the list cannot outgrow what it excuses.
"""

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "deepcut_tpu"
PORT_PKG = REPO / "deepcut_tpu_torch"

# (module path under the package, public name or None for the whole module)
#   -> (reason, the port's replacement as (module path, name or None))
EXCEPTIONS: Dict[Tuple[str, Optional[str]], Tuple[str, Tuple[str, Optional[str]]]] = {
    ("ops/pallas_decode.py", None): (
        "the TPU's Pallas kernel; the port's decode is a hand-written Hopper kernel "
        "(csrc/decode_pose.cu) behind its own wrapper",
        ("ops/cuda_decode.py", "decode_fused")),
    ("solver/orbax_ckpt.py", None): (
        "Orbax is a JAX checkpoint library (ROADMAP, Not to port); the port snapshots "
        ".npz, .caffemodel and .solverstate",
        ("solver/solver.py", "PoseSolver.snapshot")),
    ("ops/conv.py", "conv2d_s2d"): (
        "fast_semantics' space-to-depth conv for the TPU's matrix unit (ROADMAP, Not to port)",
        ("ops/conv.py", "conv2d")),
    ("ops/pool.py", "max_pool2d_eqgrad"): (
        "fast_semantics' equal-split max-pool gradient for the TPU (ROADMAP, Not to port)",
        ("ops/pool.py", "max_pool2d")),
    ("parallel/mesh.py", "batch_sharding"): (
        "a JAX NamedSharding; the port runs one process per GPU and shards a batch by hand",
        ("parallel/mesh.py", "shard_batch")),
    ("ops/losses.py", "make_smooth_l1_loss"): (
        "a shard_map loss factory; the port's losses reduce their normalisers over the "
        "axis of `sharded_losses`",
        ("ops/losses.py", "sharded_losses")),
    ("ops/losses.py", "make_softmax_loss_vec"): (
        "a shard_map loss factory, as make_smooth_l1_loss",
        ("ops/losses.py", "sharded_losses")),
    ("ops/losses.py", "make_softmax_with_loss"): (
        "a shard_map loss factory, as make_smooth_l1_loss",
        ("ops/losses.py", "sharded_losses")),
}


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def public_names(path: Path) -> Set[str]:
    """A module's public top-level functions and classes, and each public
    class's public methods as ``Class.method``."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _is_public(node.name):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef) and _is_public(node.name):
            names.add(node.name)
            names.update(f"{node.name}.{sub.name}" for sub in node.body
                         if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                         and _is_public(sub.name))
    return names


def _bound(body) -> Set[str]:
    """The names a module or class body binds: defs, classes, imports,
    assignments."""
    names = set()
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
    return names


def defined_names(path: Path) -> Set[str]:
    """What a module binds at its top level, and what each of its classes
    binds as ``Class.name``."""
    tree = ast.parse(path.read_text())
    names = _bound(tree.body)
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            names.update(f"{node.name}.{n}" for n in _bound(node.body))
    return names


def modules(root: Path) -> List[str]:
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*.py"))


def missing(jax_root: Path, port_root: Path, rel: str, exceptions=EXCEPTIONS) -> List[str]:
    """What the port lacks of one JAX module, less the excepted: ``[None]``
    for the whole module, else the missing names."""
    if (rel, None) in exceptions:
        return []
    port = port_root / rel
    if not port.is_file():
        return [None]
    have = defined_names(port)
    return sorted(n for n in public_names(jax_root / rel) - have if (rel, n) not in exceptions)


@pytest.mark.parametrize("rel", modules(JAX_PKG))
def test_port_has_the_modules_public_surface(rel):
    gaps = missing(JAX_PKG, PORT_PKG, rel)
    assert not gaps, (f"deepcut_tpu_torch/{rel} lacks "
                      + ("the whole module" if gaps == [None] else ", ".join(gaps)))


@pytest.mark.parametrize("key", sorted(EXCEPTIONS, key=str), ids=lambda k: f"{k[0]}:{k[1]}")
def test_each_exception_is_needed_and_replaced(key):
    rel, name = key
    reason, (rep_rel, rep_name) = EXCEPTIONS[key]
    assert reason
    assert (JAX_PKG / rel).is_file()
    if name is None:
        assert not (PORT_PKG / rel).is_file(), f"deepcut_tpu_torch/{rel} exists now"
    else:
        assert name in public_names(JAX_PKG / rel), f"{rel}: the JAX package has no {name}"
        assert name not in defined_names(PORT_PKG / rel), f"{rel}: the port has {name} now"
    assert (PORT_PKG / rep_rel).is_file()
    assert rep_name is None or rep_name in defined_names(PORT_PKG / rep_rel), (rep_rel, rep_name)


SYNTHETIC = '''
import os
from os import path as _p

LIMIT = 3


def visible(x):
    return x


def _hidden():
    pass


class Box:
    size = 1

    def grow(self):
        pass

    def _shrink(self):
        pass


class _Private:
    def method(self):
        pass
'''


def _tree(root: Path, text: str, other: str = "") -> None:
    (root / "sub").mkdir(parents=True)
    (root / "__init__.py").write_text("")
    (root / "sub" / "mod.py").write_text(text)
    (root / "sub" / "other.py").write_text(other)


@pytest.mark.parametrize("cut, gap", [
    (("def visible(x):\n    return x\n", ""), ["visible"]),
    (("    def grow(self):\n        pass\n", ""), ["Box.grow"]),
    (("class Box:\n    size = 1\n", "def Box():\n    pass\n\n\nclass _Box:\n    size = 1\n"),
     ["Box.grow"]),
    (None, [None]),
], ids=["function", "method", "class-turned-function", "module"])
def test_checker_sees_a_deleted_name(tmp_path, cut, gap):
    """The checker on a synthetic pair of trees: the copy passes, and the
    copy with one public name (or the module) deleted fails on it, while
    private names, a private class's methods and module-level constants
    never count."""
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    _tree(jax_root, SYNTHETIC)
    port_text = SYNTHETIC if cut is None else SYNTHETIC.replace(*cut)
    assert cut is None or port_text != SYNTHETIC
    _tree(port_root, port_text.replace("def _hidden():\n    pass\n", ""))
    assert public_names(jax_root / "sub" / "mod.py") == {"visible", "Box", "Box.grow"}
    assert missing(jax_root, port_root, "sub/other.py") == []
    if cut is None:
        (port_root / "sub" / "mod.py").unlink()
    assert missing(jax_root, port_root, "sub/mod.py") == gap
    excused = {("sub/mod.py", g): ("a reason", ("sub/other.py", None)) for g in gap}
    assert missing(jax_root, port_root, "sub/mod.py", excused) == []


def test_a_name_imported_into_the_port_counts(tmp_path):
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    _tree(jax_root, "def helper():\n    pass\n")
    _tree(port_root, "from sub.other import helper\n", "def helper():\n    pass\n")
    assert missing(jax_root, port_root, "sub/mod.py") == []
