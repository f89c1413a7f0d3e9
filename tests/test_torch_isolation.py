"""repro_torch and chip_smoke.py stand alone: no import of jax or of the JAX
package ``repro`` (``repro_torch`` itself is fine)."""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")


def _files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        out += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_package_exists():
    files = _files()
    assert os.path.exists(files[0]) and len(files) > 10


@pytest.mark.parametrize("path", _files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [m for m in _imported(tree) if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
