"""Rules the port keeps: no JAX and nothing of the JAX package inside it,
every public op has a plain version and a parity test naming both, and the
entry points run on the card unless told otherwise."""
import ast
import inspect
import re
from pathlib import Path

import pytest

from repro_torch.api.serving import ServeSession
from repro_torch.api.session import Session
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.launch import serve as serve_driver
from repro_torch.launch import train as train_driver

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_repro(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _public_ops():
    return [name for name, fn in vars(ops).items()
            if inspect.isfunction(fn) and fn.__module__ == ops.__name__
            and not name.startswith("_") and name != "reset_launches"]


def test_every_public_op_has_a_ref_and_a_parity_test():
    names = _public_ops()
    assert set(names) == set(ops.LAUNCHES), "every op keeps a launch counter"
    tests = "\n".join(p.read_text() for p in (ROOT / "tests").glob("test_torch_*.py"))
    for name in names:
        assert callable(getattr(R, f"{name}_ref", None)), f"no ref.{name}_ref"
        assert re.search(rf"\bops\.{name}\(", tests), f"no test calls ops.{name}"
        assert re.search(rf"\bR\.{name}_ref\(", tests), f"no test calls R.{name}_ref"


def test_entry_points_default_to_cuda():
    assert serve_driver.build_parser().parse_args([]).device == "cuda"
    assert inspect.signature(ServeSession).parameters["device"].default == "cuda"
    assert train_driver.build_parser().parse_args([]).device == "cuda"
    assert inspect.signature(Session).parameters["device"].default == "cuda"
    assert inspect.signature(train_driver.train_session_factory).parameters[
        "device"].default == "cuda"
