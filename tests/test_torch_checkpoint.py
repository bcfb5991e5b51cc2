"""The port's params checkpoints and their integrity ladder on the CPU.

genrec_tpu_torch/core/checkpoint.py keeps the params half of
genrec_tpu/core/checkpoint.py in a format of its own (orbax records are
JAX's): a round trip is bit-exact for every dtype the models hold; a
flipped byte (in a tensor's data or in the file's container bytes), a
truncated tensor file, a missing commit marker, an unreadable manifest
or a non-finite tensor is quarantined to ``quarantine/p0/<step>`` and the
ladder returns the previous step, with the JAX ladder's flight events; a
record whose names, shapes or dtypes differ from the live state stays on
disk (the verdict the JAX docstring intends, which its ladder misses for
garbled orbax bytes: ROADMAP C); ``max_to_keep`` holds.
"""

import json
import os

import numpy as np
import pytest
import torch

from genrec_tpu_torch.core.checkpoint import (
    COMMIT_MARKER,
    MANIFEST,
    TENSORS,
    CheckpointCorruptError,
    CheckpointManager,
    CheckpointMismatchError,
    flatten_tree,
    load_params,
    save_params,
)
from genrec_tpu_torch.obs import get_flight_recorder


def _state(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {
        "emb.weight": torch.randn(7, 5, generator=g),
        "proj.weight": torch.randn(3, 5, generator=g).to(torch.bfloat16),
        "proj.bias": torch.randn(3, generator=g).to(torch.float16),
        "steps": torch.randint(0, 1000, (4,), generator=g),
        "mask": torch.rand(6, generator=g) > 0.5,
        "scalar": torch.tensor(3.5),
        "empty": torch.zeros(0, 4),
    }


def _equal(a: dict, b: dict) -> None:
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert torch.equal(fa[k].reshape(-1).view(torch.uint8),
                           fb[k].reshape(-1).view(torch.uint8)), k


@pytest.mark.parametrize("nested", [False, True], ids=["state_dict", "by_head"])
def test_round_trip_is_bit_exact(tmp_path, nested):
    state = {"tiger": _state(0), "cobra": _state(1)} if nested else _state(0)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(7, state)
    assert mgr.all_steps() == [7] and mgr.latest_step() == 7
    _equal(mgr.restore(state), state)
    restored, step = mgr.restore_latest_valid(state)
    assert step == 7
    _equal(restored, state)
    assert set(os.listdir(tmp_path / "ckpt" / "7")) == {TENSORS, MANIFEST, COMMIT_MARKER}
    # A flat load (no layout to hold it to) names the nested levels with "/".
    flat = mgr.restore(None)
    assert ("tiger/emb.weight" in flat) == nested
    save_params(str(tmp_path / "best"), state)
    _equal(load_params(str(tmp_path / "best"), like=state), state)


def _flip_tensor_byte(step_dir):
    """Flip one byte inside the float32 data of ``emb.weight`` (found in
    the file by its bytes, so the container stays well formed)."""
    path = os.path.join(step_dir, TENSORS)
    raw = bytearray(open(path, "rb").read())
    data = _state(2)["emb.weight"].numpy().tobytes()
    at = raw.find(data)
    assert at >= 0
    raw[at + 5] ^= 0x10
    open(path, "wb").write(bytes(raw))


def _flip_middle_byte(step_dir):
    path = os.path.join(step_dir, TENSORS)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))


def _truncate(step_dir):
    path = os.path.join(step_dir, TENSORS)
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[: len(raw) // 3])


def _drop_marker(step_dir):
    os.remove(os.path.join(step_dir, COMMIT_MARKER))


def _garble_manifest(step_dir):
    with open(os.path.join(step_dir, MANIFEST), "w") as f:
        f.write('{"tensors": [')


def _rewrite_checksum(step_dir):
    """A manifest whose file checksum matches but a tensor's does not."""
    path = os.path.join(step_dir, MANIFEST)
    m = json.load(open(path))
    m["tensors"][0]["crc32"] ^= 1
    json.dump(m, open(path, "w"))


DAMAGE = {"tensor_byte": _flip_tensor_byte, "container_byte": _flip_middle_byte,
          "truncated": _truncate, "no_marker": _drop_marker, "manifest": _garble_manifest,
          "tensor_checksum": _rewrite_checksum}


@pytest.mark.parametrize("damage", sorted(DAMAGE))
def test_damaged_step_is_quarantined_and_the_ladder_falls_back(tmp_path, damage):
    fr = get_flight_recorder()
    fr.clear()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    DAMAGE[damage](str(tmp_path / "2"))
    with pytest.raises(CheckpointCorruptError):
        mgr.validate_and_restore(_state(0), 2)
    restored, step = mgr.restore_latest_valid(_state(0))
    assert step == 1
    _equal(restored, _state(1))
    assert mgr.all_steps() == [1]
    assert os.path.isdir(tmp_path / "quarantine" / "p0" / "2")
    verdicts = [(e["step"], e["verdict"]) for e in fr.events("integrity_ladder")]
    assert verdicts == [(2, "corrupt"), (1, "valid")]
    assert [e["step"] for e in fr.events("checkpoint_quarantine")] == [2]


def test_non_finite_step_is_corrupt(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1))
    bad = _state(2)
    bad["emb.weight"][0, 0] = float("nan")
    mgr.save(2, bad)
    restored, step = mgr.restore_latest_valid(_state(0))
    assert step == 1 and os.path.isdir(tmp_path / "quarantine" / "p0" / "2")


@pytest.mark.parametrize("change", ["shape", "dtype", "name"])
def test_mismatched_layout_stays_on_disk(tmp_path, change):
    fr = get_flight_recorder()
    fr.clear()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1))
    other = _state(2)
    if change == "shape":
        other["emb.weight"] = torch.zeros(8, 5)
    elif change == "dtype":
        other["steps"] = other["steps"].to(torch.int32)
    else:
        other["renamed"] = other.pop("scalar")
    mgr.save(2, other)
    with pytest.raises(CheckpointMismatchError):
        mgr.validate_and_restore(_state(0), 2)
    restored, step = mgr.restore_latest_valid(_state(0))
    assert step == 1
    assert mgr.all_steps() == [1, 2]  # intact: left for a rollback
    assert not os.path.exists(tmp_path / "quarantine")
    assert [e["verdict"] for e in fr.events("integrity_ladder")] == ["mismatch", "valid"]
    # Without a live layout to hold it to, the step loads.
    assert mgr.restore(None, 2)["emb.weight"].shape == other["emb.weight"].shape


def test_nothing_valid_returns_none(tmp_path):
    fr = get_flight_recorder()
    fr.clear()
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_latest_valid(_state(0)) == (None, None)
    mgr.save(3, _state(3))
    _drop_marker(str(tmp_path / "3"))
    assert mgr.restore_latest_valid(_state(0)) == (None, None)
    assert [e["verdict"] for e in fr.events("integrity_ladder")] == [
        "nothing_valid", "corrupt", "nothing_valid"]


def test_max_to_keep_and_step_order(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 5, 9):
        mgr.save(step, _state(step))
    assert mgr.all_steps() == [5, 9]
    mgr.save(9, _state(0))  # the latest again: a no-op, as orbax's
    _equal(mgr.restore(_state(0)), _state(9))
    with pytest.raises(RuntimeError, match="below the latest"):
        mgr.save(4, _state(4))
    # Leftover temporary directories and quarantine are not steps.
    os.makedirs(tmp_path / ".10.tmp.x")
    os.makedirs(tmp_path / "quarantine" / "p0" / "3")
    assert mgr.all_steps() == [5, 9]
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path), max_to_keep=0)


def test_a_numpy_state_round_trips(tmp_path):
    state = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "i": np.arange(3)}
    save_params(str(tmp_path / "p"), state)
    back = load_params(str(tmp_path / "p"))
    np.testing.assert_array_equal(back["w"].numpy(), state["w"])
    np.testing.assert_array_equal(back["i"].numpy(), state["i"])
