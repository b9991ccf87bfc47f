"""The port stands alone: no file of ``src/repro_torch``, nor
``chip_smoke.py``, ``kernel_ab.py``, ``ring_group_ab.py`` or
``examples/*_torch.py``, imports JAX, the ``repro`` package
or ``ml_dtypes`` (the card's machine has none; the checkpointer stores
narrow floats through ``torch.Tensor.view``).  The observability modules
are the port's own copies, and the thread runtime's modules start no
thread when imported; so are the LM side's models, configs, serving and
training steps, optimizers and data pipeline."""

import ast
import importlib
import threading
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "kernel_ab.py",
    REPO / "ring_group_ab.py"] + sorted(
    (REPO / "examples").glob("*_torch.py"))


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


@pytest.mark.parametrize("name", [
    "repro_torch.obs", "repro_torch.obs.trace", "repro_torch.obs.metrics",
    "repro_torch.obs.check", "repro_torch.core.async_runtime",
    "repro_torch.engine.threads", "repro_torch.obs.profile",
    "repro_torch.obs.report", "repro_torch.distributed.roofline",
    "repro_torch.distributed.comm_analysis", "repro_torch.launch.dryrun",
    "repro_torch.distributed.process_group", "repro_torch.core.dvq",
    "repro_torch.topology.topology", "repro_torch.serve.lookup",
    "repro_torch.distributed.elastic", "repro_torch.models.common",
    "repro_torch.models.blocks", "repro_torch.models.transformer",
    "repro_torch.models.encdec", "repro_torch.models.api",
    "repro_torch.models.quantization", "repro_torch.configs.registry",
    "repro_torch.training.steps", "repro_torch.launch.serve",
    "repro_torch.optim.optimizers", "repro_torch.optim.compression",
    "repro_torch.data.pipeline", "repro_torch.launch.train",
    "repro_torch.engine.merge", "repro_torch.distributed.sharding",
    "repro_torch.training.pipeline", "repro_torch.distributed.hlo_analysis",
    *(f"repro_torch.configs.{arch}" for arch in (
        "granite_34b", "granite_8b", "starcoder2_7b", "command_r_35b",
        "whisper_tiny", "moonshot_v1_16b_a3b", "olmoe_1b_7b",
        "mamba2_2p7b", "internvl2_76b", "hymba_1p5b"))])
def test_new_module_is_the_ports_own_and_starts_nothing(name):
    before = threading.active_count()
    mod = importlib.import_module(name)
    assert threading.active_count() == before
    path = Path(mod.__file__).resolve()
    assert path.is_relative_to(REPO / "src" / "repro_torch")
    assert path in PORT_FILES
