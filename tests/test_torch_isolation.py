"""The PyTorch port imports nothing of JAX or of the JAX package ``repro``.

An AST scan of every module under ``src/repro_torch/`` and of
``chip_smoke.py``: no ``import jax``/``from jax`` and no ``repro`` import
other than ``repro_torch``.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_scan_covers_the_package():
    names = {p.name for p in FILES}
    assert {"engine.py", "dispatcher.py", "gmm.py", "flash.py", "chip_smoke.py"} <= names
    rel = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"src/repro_torch/data/pipeline.py", "src/repro_torch/optim/adamw.py",
            "src/repro_torch/train/loop.py", "src/repro_torch/launch/train.py",
            "src/repro_torch/launch/profile_train.py", "src/repro_torch/core/folding.py",
            "src/repro_torch/core/comm.py", "src/repro_torch/core/overlap.py",
            "src/repro_torch/launch/world.py", "src/repro_torch/core/pipeline.py",
            "src/repro_torch/checkpoint/store.py", "src/repro_torch/resilience/driver.py",
            "src/repro_torch/resilience/faults.py"} <= rel
