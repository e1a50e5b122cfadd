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
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as R
from repro_torch.launch import serve as serve_driver
from repro_torch.launch import train as train_driver
from repro_torch.serve import ServeEngine

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
    assert not set(ops.LAUNCHES) & set(ops.COMPOSITE_OPS)
    assert set(names) == set(ops.LAUNCHES) | set(ops.COMPOSITE_OPS), \
        "every op keeps a launch counter or is made of ops that do"
    for parts in ops.COMPOSITE_OPS.values():
        assert parts and set(parts) <= set(ops.LAUNCHES)
    tests = "\n".join(p.read_text() for p in (ROOT / "tests").glob("test_torch_*.py"))
    for name in names:
        assert callable(getattr(R, f"{name}_ref", None)), f"no ref.{name}_ref"
        assert re.search(rf"\bops\.{name}\(", tests), f"no test calls ops.{name}"
        assert re.search(rf"\bR\.{name}_ref\(", tests), f"no test calls R.{name}_ref"


def test_entry_points_default_to_cuda():
    assert serve_driver.build_parser().parse_args([]).device == "cuda"
    assert inspect.signature(ServeSession).parameters["device"].default == "cuda"
    assert inspect.signature(ServeEngine).parameters["device"].default == "cuda"
    assert train_driver.build_parser().parse_args([]).device == "cuda"
    assert inspect.signature(Session).parameters["device"].default == "cuda"
    assert inspect.signature(train_driver.train_session_factory).parameters[
        "device"].default == "cuda"


def _c_entries():
    """(name, [P/I/F per argument]) of every ``extern "C"`` entry in csrc/*.cu."""
    for src in _build.sources():
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', text):
            args = [a.strip() for a in m.group(2).split(",")]
            kinds = ["P" if "*" in a else "F" if a.split()[0] in ("float", "double") else "I"
                     for a in args]
            yield src.stem, m.group(1), kinds


C_ENTRIES = list(_c_entries())


@pytest.mark.parametrize("entry", C_ENTRIES, ids=[e[1] for e in C_ENTRIES])
def test_ctypes_signature_matches_the_c_entry(entry):
    """A ctypes signature that drifts from its C entry passes arguments into
    the wrong slots silently: each entry's source, argument count and kinds
    (pointer, int, float) are read from the C source and held to
    ``_build.SIGNATURES``."""
    stem, name, kinds = entry
    assert name in _build.SIGNATURES, f"{name} has no ctypes signature"
    sig_stem, argtypes = _build.SIGNATURES[name]
    code = {_build.P: "P", _build.I: "I", _build.F: "F"}
    assert sig_stem == stem
    assert [code[t] for t in argtypes] == kinds


def test_every_ctypes_signature_has_a_c_entry():
    assert {e[1] for e in C_ENTRIES} == set(_build.SIGNATURES)


def test_cluster_entry_points_default_to_cuda_and_refuse_the_cpu():
    """The cluster's session factories run on the card unless told
    otherwise, and a worker that sees no card raises instead of training on
    the CPU (no card here)."""
    from repro_torch.launch import cluster

    assert inspect.signature(cluster.demo_session_factory).parameters["device"].default == "cuda"
    assert "cluster_processes" in inspect.signature(train_driver.train_session_factory).parameters
    runtime = cluster.WorkerRuntime(
        process_id=0, num_processes=1, sync_address=None,
        membership_dir=None, factory="repro_torch.launch.cluster:demo_session_factory",
        factory_kwargs={"processes": 1})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.run()
