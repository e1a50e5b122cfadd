"""The reference's static custody gate (``repro.analysis``, rule
``custody-taint``) over the port, with no edit to the JAX package.

The rule proves statically that bytes read from a storage device's custody
(``device.read`` / ``assemble`` / ``_materialize``) never reach a
serialization, network or checkpoint sink, and cross the host-to-device
feed only under a transfer guard, which sanitizes them: the batch landed by
a guarded feed, and the loss and parameters trained on it, are clean.  The
port's checkpoint manager and ``Session.run`` (which saves trained state
every ``checkpoint_every`` steps) must show no finding.

Limits of the rule over this port, recorded here:
  * Its feed boundary is ``jax.device_put`` / ``.feed`` and its guard is a
    ``with`` over anything named ``transfer_guard``.  It does not know
    ``Tensor.to(device)``: a tainted tensor copied to the card is not
    flagged as crossing (``test_rule_limit_to_device_is_not_a_feed``).  The
    port's feed (``DeviceFleet.to_device_batch``) therefore copies under its
    own ``transfer_guard_host_to_device``, which counts the bytes every
    host-to-device copy in it moves and raises unless they are exactly the
    batch's.
  * It resolves a method by name to the first loaded class that defines it,
    so with both packages loaded the port's ``FleetBatcher`` calls resolve to
    the reference's (whose feed holds ``jax.transfer_guard``).  The gate is
    run over the port's files alone as well, where only the port's own guard
    can sanitize.
  * Its ``use-after-donate`` and ``jit-purity`` rules have no eager-PyTorch
    counterpart (the port neither donates nor traces); they find nothing
    here because there is nothing of theirs to check.  Kernel-parity
    coverage of the port is ``tests/test_torch_port_rules.py``'s.
"""
import ast
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import Project, run_analysis
from repro.analysis.project import Module
from repro_torch.storage.fleet import transfer_guard_host_to_device

ROOT = Path(__file__).resolve().parents[1]
PORT = ("src/repro_torch",)
PORT_FILES = sorted(f.relative_to(ROOT).as_posix() for f in (ROOT / PORT[0]).rglob("*.py"))
RULES = ("custody-taint", "use-after-donate", "jit-purity")


def _violations(project, rule="custody-taint"):
    return run_analysis(ROOT, rules=[rule], project=project).violations


@pytest.fixture(scope="module")
def port_alone():
    return Project.load(ROOT, paths=PORT_FILES, analyzed=PORT)


@pytest.fixture(scope="module")
def whole_repo():
    return Project.load(ROOT, analyzed=PORT)


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("loaded", ["whole_repo", "port_alone"])
def test_port_passes_the_gate(rule, loaded, request):
    project = request.getfixturevalue(loaded)
    assert {m.path for m in project.analyzed_modules()} >= {
        "src/repro_torch/checkpoint/manager.py", "src/repro_torch/api/session.py"}
    assert _violations(project, rule) == []


def test_the_gate_flags_session_run_without_the_feed_guard(port_alone):
    """Take the guard out of the port's feed and the batch stays tainted, so
    ``Session.run``'s checkpoint save of the state trained on it is flagged."""
    rel = "src/repro_torch/storage/fleet.py"
    src = port_alone.modules[rel].source
    guard = "with transfer_guard_host_to_device(crossing):"
    assert guard in src
    src = src.replace(guard, "with contextlib.nullcontext():")
    modules = dict(port_alone.modules)
    modules[rel] = Module(path=rel, tree=ast.parse(src), source=src)
    found = _violations(Project(ROOT, modules, analyzed=PORT))
    assert [(v.path, v.symbol) for v in found] == [("src/repro_torch/api/session.py", "Session.run")]
    assert "checkpoint sink 'ckpt.save'" in found[0].message


def test_rule_limit_to_device_is_not_a_feed(tmp_path):
    files = {
        "src/repro_torch/storage/device.py": """
            class BaseStorageDevice:
                def read(self, key):
                    return b"private-bytes"
        """,
        "src/repro_torch/api/leak.py": """
            from repro_torch.storage.device import BaseStorageDevice

            def land(device: BaseStorageDevice):
                rows = device.read("private-csd/0")
                return rows.to("cuda")
        """,
    }
    for rel, src in files.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(textwrap.dedent(src))
    project = Project.load(tmp_path, paths=list(files), analyzed=PORT)
    assert run_analysis(tmp_path, rules=["custody-taint"], project=project).violations == []


# ---------------------------------------------------------------------------
# the port's feed guard at run time
# ---------------------------------------------------------------------------


def _host(n):
    return torch.from_numpy(np.arange(n, dtype=np.int32))


def test_feed_guard_counts_the_bytes_that_cross():
    # "meta" stands in for the card here: a copy off the host is what counts
    with transfer_guard_host_to_device(4 * 12):
        _host(5).to("meta")
        torch.empty(7, dtype=torch.int32, device="meta").copy_(_host(7))
        _host(3).to("cpu")                   # stays on the host
    with transfer_guard_host_to_device(0):
        _host(3).clone()


@pytest.mark.parametrize("declared", [4 * 4, 4 * 6, 0], ids=["declared_short", "declared_long", "declared_none"])
def test_feed_guard_raises_on_any_other_amount(declared):
    with pytest.raises(RuntimeError, match="host-to-device"):
        with transfer_guard_host_to_device(declared):
            _host(5).to("meta")
