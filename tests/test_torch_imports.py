"""Guard: the port and its chip check import neither JAX nor the JAX
package, and its kernel sources never ask for fast-math sines."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "neuralsim_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
KERNELS = sorted(PORT.rglob("*.cu")) + sorted(PORT.rglob("*.cuh"))


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "neuralsim_tpu", "flax", "optax")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value


def test_port_files_exist():
    assert (PORT / "__init__.py").exists() and (ROOT / "chip_smoke.py").exists()
    assert KERNELS, "the port's CUDA sources are missing"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if _banned(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_banned_names():
    assert _banned("neuralsim_tpu.ops.render") and _banned("jax.numpy")
    assert not _banned("neuralsim_tpu_torch.ops.render")


def test_kernels_use_accurate_sines():
    for path in KERNELS + [PORT / "kernels" / "build.py"]:
        text = path.read_text()
        assert "use_fast_math" not in text, path
        assert "__sinf" not in text and "__cosf" not in text, path
