"""The port stands alone: a static scan (the interpreter may have imported
jax at start-up, so ``sys.modules`` proves nothing) that no file of
``video_depth_anything_torch/`` and not ``chip_smoke.py`` imports jax,
flax or the JAX package."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "video_depth_anything_tpu")
FILES = sorted((ROOT / "video_depth_anything_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_sees_the_package():
    assert len(FILES) > 15
