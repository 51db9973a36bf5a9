"""Nothing under bench_port/ imports the JAX stack or the JAX package
(compared by whole top-level name: the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

from bench_port.harness import FORBIDDEN, HERE

FILES = sorted(p for p in HERE.rglob("*.py"))


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    found = set(top_level_imports(path)) & set(FORBIDDEN)
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert "neuralsim_tpu_torch" not in set(top_level_imports(path))


def test_guard_compares_whole_names():
    import sys

    from bench_port import harness

    sys.modules["neuralsim_tpu_torch_fake_check"] = object()
    try:
        assert harness.forbidden_modules() == []
        sys.modules["neuralsim_tpu.fake_check"] = object()
        assert harness.forbidden_modules() == ["neuralsim_tpu"]
    finally:
        sys.modules.pop("neuralsim_tpu_torch_fake_check", None)
        sys.modules.pop("neuralsim_tpu.fake_check", None)


def test_module_loaded_by_the_check_refuses_the_run(monkeypatch, tmp_path):
    """The guard looks at sys.modules after the check, which imports the
    reference and may call into the program: a JAX module that only the
    check loads still refuses the run."""
    import sys

    from bench_port import harness
    from bench_port.tests.tiny import run

    saved = sys.modules.get("jax")
    entry = harness.entry_module("render_images")
    real = entry.Cell.check

    def check(self, *args, **kw):
        sys.modules["jax"] = object()
        return real(self, *args, **kw)

    monkeypatch.setattr(entry.Cell, "check", check)
    monkeypatch.setattr(harness, "entry_module", lambda name: entry)
    try:
        with pytest.raises(harness.RunRefused, match="jax"):
            run("render.nerf256.exact_f32.k50", tmpdir=tmp_path)
    finally:
        if saved is None:
            sys.modules.pop("jax", None)
        else:
            sys.modules["jax"] = saved
