"""Static checks on the PyTorch port's sources: they parse, keep to the
repo's 120-column limit, import neither jax nor the JAX package (nor the
``onnx`` and ``flatbuffers`` packages, which the card host lacks: the port
reads and writes both formats itself), and import triton only inside
functions, so every module imports where triton is absent."""

import ast
import os
import pathlib

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "openwakeword_tpu_torch"
SOURCES = (sorted(str(p) for p in PKG.rglob("*.py"))
           + [str(PKG.parent / "chip_smoke.py")])
MAX_LINE = 120


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name, node) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module, node


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, PKG.parent))
def test_port_source_static(path):
    src = open(path).read()
    tree = ast.parse(src, filename=path)
    long_lines = [i + 1 for i, line in enumerate(src.splitlines()) if len(line) > MAX_LINE]
    assert not long_lines, f"lines over {MAX_LINE} chars: {long_lines}"
    for module, node in _imported_modules(tree):
        root = module.split(".")[0]
        assert root not in ("jax", "jaxlib", "openwakeword_tpu", "onnx", "flatbuffers"), \
            f"line {node.lineno} imports {module}"
        if root == "triton":
            assert node not in tree.body, f"line {node.lineno}: triton imported at module level"
