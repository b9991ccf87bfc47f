"""The port stands alone: no file of ``src/repro_torch``, nor
``chip_smoke.py`` or ``kernel_ab.py``, imports JAX, the ``repro`` package
or ``ml_dtypes`` (the card's machine has none; the checkpointer stores
narrow floats through ``torch.Tensor.view``)."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "kernel_ab.py"]


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "ml_dtypes")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_file_imports_neither_jax_nor_repro(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_checker_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom repro.core import vq\n"
                   "from repro_torch.core import vq as tvq\nimport torch\n"
                   "import ml_dtypes\n")
    assert [n for n in _imported_modules(src) if _forbidden(n)] == [
        "jax.numpy", "repro.core", "ml_dtypes"]
