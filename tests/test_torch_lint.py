"""The port's files pass the pyflakes checks that CI's ``ruff check .``
selects (``ruff.toml``: ``F``), by an AST scan that needs no linter:

  * F811: no function, class or import redefined in one scope before the
    first binding was used;
  * F401: no unused import (names listed in ``__all__`` count as used);
  * F841: no local variable assigned and never read (names starting with
    ``_`` excepted, as ruff's dummy-variable pattern does).

It covers ``src/repro_torch``, ``chip_smoke.py``, ``tools/stream_ab.py`` and
``tests/test_torch_*.py``.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FILES = sorted([*(REPO / "src" / "repro_torch").rglob("*.py"),
                REPO / "chip_smoke.py", REPO / "tools" / "stream_ab.py",
                *(REPO / "tests").glob("test_torch_*.py")])


def _loads(tree: ast.AST) -> set[str]:
    """Every name read anywhere below ``tree``, string annotations too."""
    names = {n.id for n in ast.walk(tree)
             if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}
    for node in ast.walk(tree):
        anns = []
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            anns = [a.annotation for a in (*node.args.args,
                                           *node.args.kwonlyargs,
                                           *node.args.posonlyargs)]
            anns.append(node.returns)
        elif isinstance(node, ast.AnnAssign):
            anns = [node.annotation]
        for ann in anns:
            if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
                names |= _loads(ast.parse(ann.value, mode="eval"))
    return names


def _bound(stmt: ast.stmt) -> list[str]:
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return [stmt.name]
    if isinstance(stmt, (ast.Import, ast.ImportFrom)):
        return [(a.asname or a.name).split(".")[0] for a in stmt.names]
    return []


def _redefinitions(body: list[ast.stmt], where: str) -> list[str]:
    found, seen = [], {}
    for i, stmt in enumerate(body):
        decorated = getattr(stmt, "decorator_list", [])
        if any(isinstance(d, ast.Attribute) or
               getattr(d, "id", "") == "overload" for d in decorated):
            continue      # property setters, typing.overload
        for name in _bound(stmt):
            if name in seen and not any(
                    name in _loads(s) for s in body[seen[name] + 1:i]):
                found.append(f"{where}:{stmt.lineno}: F811 {name}")
            seen[name] = i
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            found += _redefinitions(stmt.body, where)
    return found


def _unused_imports(tree: ast.Module, where: str) -> list[str]:
    used = _loads(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", "") == "__all__" for t in node.targets):
            used |= {e.value for e in ast.walk(node.value)
                     if isinstance(e, ast.Constant)}
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "__future__":
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                name = (a.asname or a.name).split(".")[0]
                if name not in used and a.asname != a.name:
                    found.append(f"{where}:{node.lineno}: F401 {name}")
    return found


def _unused_locals(tree: ast.Module, where: str) -> list[str]:
    found = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        declared = {n for node in ast.walk(fn)
                    if isinstance(node, (ast.Global, ast.Nonlocal))
                    for n in node.names}
        used = _loads(fn)
        if "locals" in used:
            continue
        for node in ast.walk(fn):
            targets = []
            if isinstance(node, ast.Assign):
                targets = [t for t in node.targets if isinstance(t, ast.Name)]
            elif isinstance(node, ast.AnnAssign) and node.value is not None \
                    and isinstance(node.target, ast.Name):
                targets = [node.target]
            elif isinstance(node, ast.ExceptHandler) and node.name:
                targets = [ast.Name(id=node.name, lineno=node.lineno)]
            for t in targets:
                if t.id not in used and t.id not in declared \
                        and not t.id.startswith("_"):
                    found.append(f"{where}:{t.lineno}: F841 {t.id}")
    return found


@pytest.mark.parametrize("path", FILES, ids=[str(f.relative_to(REPO))
                                             for f in FILES])
def test_no_pyflakes_findings(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    where = str(path.relative_to(REPO))
    found = (_redefinitions(tree.body, where) + _unused_imports(tree, where)
             + _unused_locals(tree, where))
    assert not found, "\n".join(found)


def test_scan_finds_each_kind():
    src = ("import os\nimport sys\n"
           "def f():\n    x = 1\n    return sys\n"
           "def f():\n    pass\n")
    tree = ast.parse(src)
    assert [m.split(": ")[1] for m in _redefinitions(tree.body, "m")] == \
        ["F811 f"]
    assert [m.split(": ")[1] for m in _unused_imports(tree, "m")] == \
        ["F401 os"]
    assert [m.split(": ")[1] for m in _unused_locals(tree, "m")] == \
        ["F841 x"]
