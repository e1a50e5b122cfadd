"""The port's checkpoint manager (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint.manager``): the single-process cases of
``tests/test_checkpoint.py`` on the port, then the on-disk format both ways.

The format is the contract between the packages: for the same values both
write the same ``.npy`` bytes and the same manifest.  A bfloat16 leaf is
written by the reference as raw 2-byte voids (``ml_dtypes`` gives numpy a
``'<V2'`` descr) and named only by the manifest's ``"dtype"``.  The
reference's own ``restore`` cannot read such a file back (``jnp.asarray`` of
``|V2`` raises ``TypeError: Dtype |V2 is not a valid JAX array type``,
ROADMAP §3), so for bf16 the bytes are held equal and the port restores the
reference's files; the reference restores the port's f32 / int32 files.
"""
import filecmp
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as J
from repro.optim.optimizers import OptState as JOptState
from repro_torch.checkpoint import CheckpointManager, latest_step, restore, save
from repro_torch.checkpoint import manager as M
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import OptState

torch.set_num_threads(1)   # the suite runs files in parallel processes: one thread each


def _values(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "b": rng.standard_normal((16,)).astype(np.float32),
            "mu": rng.standard_normal((8, 16)).astype(np.float32)}


def _tree(v, bf16=False):
    """The port's training-state shape: params + an OptState (nu None, as SGD)."""
    b = torch.from_numpy(v["b"])
    return {"params": {"w": torch.from_numpy(v["w"]).clone(),
                       "b": b.to(torch.bfloat16) if bf16 else b.clone()},
            "opt": OptState(step=7, mu={"w": torch.from_numpy(v["mu"]).clone(),
                                        "b": torch.zeros(16)}, nu=None)}


def _jax_tree(v, bf16=False):
    b = jnp.asarray(v["b"])
    return {"params": {"w": jnp.asarray(v["w"]), "b": b.astype(jnp.bfloat16) if bf16 else b},
            "opt": JOptState(step=jnp.int32(7), mu={"w": jnp.asarray(v["mu"]),
                                                     "b": jnp.zeros(16)}, nu=None)}


def _assert_trees_equal(got, want):
    assert got["opt"].step == want["opt"].step and isinstance(got["opt"].step, int)
    assert got["opt"].nu is None
    for a, b in ((got["params"], want["params"]), (got["opt"].mu, want["opt"].mu)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.fixture
def tree():
    return _tree(_values())


# ---------------------------------------------------------------------------
# the single-process cases of tests/test_checkpoint.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_roundtrip(tmp_path, bf16):
    tree = _tree(_values(), bf16)
    save(str(tmp_path), 10, tree, metadata={"step": 10})
    got, meta = restore(str(tmp_path), tree)
    assert meta["step"] == 10
    _assert_trees_equal(got, tree)


def test_latest_valid_wins(tmp_path, tree):
    save(str(tmp_path), 1, tree)
    save(str(tmp_path), 2, tree)
    assert latest_step(str(tmp_path)) == 2


@pytest.mark.parametrize("damage", ["manifest", "leaf"])
def test_corrupt_checkpoint_skipped(tmp_path, tree, damage):
    save(str(tmp_path), 1, tree)
    p2 = save(str(tmp_path), 2, tree)
    # a crash mid-write: no manifest, or a manifest naming a missing file
    os.remove(os.path.join(p2, "manifest.json" if damage == "manifest" else "params__w.npy"))
    assert latest_step(str(tmp_path)) == 1


def test_crc_detects_corruption(tmp_path, tree):
    p = save(str(tmp_path), 1, tree)
    path = os.path.join(p, "params__w.npy")
    arr = np.load(path).copy()
    arr.reshape(-1)[0] += 1.0
    np.save(path, arr)
    with pytest.raises(IOError, match="CRC mismatch"):
        restore(str(tmp_path), tree)


def test_rotation(tmp_path, tree):
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        m.save(s, tree)
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == [3, 4]


def test_async_save(tmp_path, tree):
    m = CheckpointManager(str(tmp_path), keep=3)
    m.save(5, tree, async_=True)
    m.wait()
    got, _ = m.restore(tree)
    _assert_trees_equal(got, tree)
    assert m.last_snapshot_s > 0 and m.last_write_s > 0


def test_tmp_dir_never_visible(tmp_path, tree):
    save(str(tmp_path), 1, tree)
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_shape_mismatch_raises(tmp_path, tree):
    save(str(tmp_path), 1, tree)
    wrong = _tree(_values())
    wrong["params"]["w"] = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(str(tmp_path), wrong)


def test_background_error_surfaces_on_wait(tmp_path, tree):
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("")
    m = CheckpointManager(str(blocker))
    m.save(1, tree, async_=True)
    with pytest.raises(OSError):
        m.wait()
    m.wait()                                  # raised once, then cleared


def test_in_place_step_during_async_save_leaves_saved_bytes(tmp_path, monkeypatch):
    """The optimizer updates params and moments in place; AdamW steps taken
    after an async save returns, and before its writer runs, must not reach
    the files.  The writer is held until the steps are done."""
    stepped = threading.Event()
    write = M._write

    def held_write(*args):
        assert stepped.wait(timeout=60)
        return write(*args)

    monkeypatch.setattr(M, "_write", held_write)
    rng = np.random.default_rng(1)
    params = {"w": torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))}
    opt = adamw()
    state = opt.init(params)
    want = {"w": params["w"].clone()}
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"params": params, "opt": state}, async_=True)
    grads = {"w": torch.ones(64, 128)}
    for _ in range(3):
        state, params = opt.update(grads, state, params, torch.tensor(0.1))
    stepped.set()
    m.wait()
    assert not torch.equal(params["w"], want["w"])
    got, _ = restore(str(tmp_path), {"params": params, "opt": state})
    assert torch.equal(got["params"]["w"], want["w"])
    assert got["opt"].step == 0 and not got["opt"].mu["w"].any()


# ---------------------------------------------------------------------------
# the format across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_same_bytes_and_manifest_as_the_reference(tmp_path, bf16):
    v = _values()
    meta = {"step": 3, "schedule": [2, 2, 20], "cursors": {"csd/0": 6, "host/0": 60}}
    pj = J.save(str(tmp_path / "jax"), 3, _jax_tree(v, bf16), metadata=meta)
    pt = save(str(tmp_path / "port"), 3, _tree(v, bf16), metadata=meta)
    names = sorted(os.listdir(pj))
    assert names == sorted(os.listdir(pt))
    assert "opt__step.npy" in names and not any("nu" in n for n in names)
    for n in names:
        assert filecmp.cmp(os.path.join(pj, n), os.path.join(pt, n), shallow=False), n
    mj = json.load(open(os.path.join(pj, "manifest.json")))
    mt = json.load(open(os.path.join(pt, "manifest.json")))
    assert mt == mj
    assert mt["entries"]["params/b"]["dtype"] == ("bfloat16" if bf16 else "float32")
    assert mt["entries"]["opt/step"] == {**mj["entries"]["opt/step"], "shape": [],
                                         "dtype": "int32"}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_port_restores_a_reference_checkpoint(tmp_path, bf16):
    v = _values(2)
    J.save(str(tmp_path), 4, _jax_tree(v, bf16), metadata={"step": 4})
    got, meta = restore(str(tmp_path), _tree(_values(), bf16))
    assert meta == {"step": 4}
    _assert_trees_equal(got, _tree(v, bf16))


def test_reference_restores_a_port_checkpoint(tmp_path):
    v = _values(3)
    save(str(tmp_path), 4, _tree(v), metadata={"step": 4})
    got, meta = J.restore(str(tmp_path), _jax_tree(_values()))
    assert meta == {"step": 4}
    want = _jax_tree(v)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(got["opt"].step) == 7
