"""The port's CheckpointManager against the JAX package's: the keep policy
and the preemption handler (the JAX package's tests, ported), bit-equal
restores, and one on-disk format that either package restores."""
import json
import os
import signal
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.checkpoint import CheckpointManager as JxManager
from repro.train.optimizer import AdamWState as JxAdamWState
from repro_torch.distributed.checkpoint import (CheckpointManager,
                                                install_preemption_handler)
from repro_torch.train.optimizer import AdamWState


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits as integers (bit equality, -0.0 and NaN included)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.view(ints[t.dtype]) if t.dtype in ints else t


def _torch_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(4, 3, generator=g).to(torch.bfloat16),
                   "b": torch.tensor([-0.0, 1.5, float("inf")]),
                   "layers": [torch.randn(2, generator=g),
                              torch.arange(5, dtype=torch.int64)]},
        "opt": AdamWState(torch.tensor(7, dtype=torch.int32),
                          {"w": torch.randn(4, 3, generator=g)},
                          {"w": torch.rand(4, 3, generator=g)}),
        "none": None,
    }


def _numpy_tree(AdamW):
    rng = np.random.default_rng(0)
    return {
        "params": {"w": np.asarray(jnp.asarray(rng.normal(size=(4, 3)),
                                               jnp.bfloat16)),
                   "b": rng.normal(size=3).astype(np.float32),
                   "layers": (rng.normal(size=2).astype(np.float32),
                              np.arange(5, dtype=np.int32))},
        "opt": AdamW(np.int32(3), {"w": np.ones((4, 3), np.float32)},
                     {"w": np.full((4, 3), 0.5, np.float32)}),
    }


def _assert_bit_equal(got, exp):
    assert set(got) == set(exp)
    for k in exp:
        if exp[k] is None:
            assert got[k] is None
        elif isinstance(exp[k], torch.Tensor):
            assert got[k].dtype == exp[k].dtype and \
                got[k].shape == exp[k].shape, k
            assert torch.equal(_bits(got[k]), _bits(exp[k])), k
        elif isinstance(exp[k], dict):
            _assert_bit_equal(got[k], exp[k])
        else:
            assert type(got[k]) is type(exp[k]), k
            _assert_bit_equal(dict(enumerate(got[k])), dict(enumerate(exp[k])))


def test_checkpoint_keep_policy(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.ones(4)}
    for s in [1, 2, 3, 4]:
        cm.save(s, tree)
    assert cm.list_steps() == [3, 4]


def test_preemption_handler_saves(tmp_path):
    saved = []
    old = signal.getsignal(signal.SIGTERM)
    try:
        install_preemption_handler(lambda: saved.append(True))
        with pytest.raises(SystemExit):
            signal.raise_signal(signal.SIGTERM)
        assert saved == [True]
    finally:
        signal.signal(signal.SIGTERM, old)


@pytest.mark.parametrize("blocking", [True, False])
def test_save_restore_bit_equal(tmp_path, blocking):
    """float32 (with -0.0 and inf), bfloat16 and int leaves in mappings,
    lists and an AdamWState come back bit for bit; an async save has
    copied to the host when it returns, so later writes to the tensors do
    not reach the files."""
    cm = CheckpointManager(str(tmp_path), keep=3)
    tree = _torch_tree()
    saved = {k: v for k, v in _torch_tree().items()}
    cm.save(5, tree, blocking=blocking)
    tree["params"]["w"].add_(1)  # after the host copy
    cm.wait()
    assert cm.list_steps() == [5]
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    like = _torch_tree(seed=1)
    restored, step = cm.restore(like)
    assert step == 5
    assert isinstance(restored["opt"], AdamWState)
    _assert_bit_equal(restored, saved)


def test_one_save_in_flight(tmp_path):
    """A second async save waits for the first; both land."""
    cm = CheckpointManager(str(tmp_path), keep=5)
    big = {"x": torch.zeros(1 << 20)}
    cm.save(1, big, blocking=False)
    cm.save(2, {"x": torch.ones(1 << 20)}, blocking=False)
    cm.wait()
    assert cm.list_steps() == [1, 2]
    restored, _ = cm.restore({"x": torch.empty(1 << 20)}, step=1)
    assert float(restored["x"].sum()) == 0


def test_shardings_must_be_one_device(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    tree = {"a": torch.ones(2), "b": torch.ones(3)}
    cm.save(1, tree, shardings={"a": None, "b": None})
    cm.restore(tree, shardings=None)
    with pytest.raises(NotImplementedError, match="A8"):
        cm.save(2, tree, shardings={"a": "mesh", "b": None})


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:010d}",
                           "manifest.json")) as f:
        m = json.load(f)
    assert m.pop("written_at") > 0
    return m


def _npz(directory, step):
    path = os.path.join(directory, f"step_{step:010d}", "shard_0_of_1.npz")
    with zipfile.ZipFile(path) as z:
        names = sorted(z.namelist())
    with np.load(path) as data:
        return names, {k: data[k] for k in data.files}


def test_same_files_as_the_jax_package(tmp_path):
    """For the same numpy tree (a bfloat16 leaf, a NamedTuple, a tuple),
    the port writes the JAX package's npz arrays and manifest (without
    ``written_at``), and each package restores the other's checkpoint."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JxManager(jdir).save(3, _numpy_tree(JxAdamWState))
    CheckpointManager(tdir).save(3, _numpy_tree(AdamWState))
    assert _manifest(jdir, 3) == _manifest(tdir, 3)
    jnames, jarrays = _npz(jdir, 3)
    tnames, tarrays = _npz(tdir, 3)
    assert jnames == tnames
    for k, a in jarrays.items():
        assert a.dtype == tarrays[k].dtype and np.array_equal(
            a, tarrays[k]), k
    assert jarrays["['params']/['w']"].dtype == np.uint16

    # the port's files into the JAX package, and back
    restored, _ = JxManager(tdir).restore(_numpy_tree(JxAdamWState))
    exp = _numpy_tree(JxAdamWState)
    assert str(restored["params"]["w"].dtype) == "bfloat16"
    assert np.array_equal(np.asarray(restored["params"]["w"]).view(np.uint16),
                          exp["params"]["w"].view(np.uint16))
    assert int(restored["opt"].step) == 3


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """A checkpoint the JAX package wrote (bfloat16, float32 and int32
    device arrays) restores into a tree of the port's tensors, bit for
    bit, without ml_dtypes on the port's side."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(8, 4)).astype(np.float32)
    jtree = {"embed": jnp.asarray(w, jnp.bfloat16),
             "norm": jnp.asarray(w[0]),
             "step": jnp.asarray(np.int32(11))}
    JxManager(str(tmp_path)).save(9, jtree)
    like = {"embed": torch.zeros(8, 4, dtype=torch.bfloat16),
            "norm": torch.zeros(4), "step": torch.zeros((), dtype=torch.int32)}
    restored, step = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 9
    exp_bits = np.asarray(jtree["embed"]).view(np.uint16).astype(np.int32)
    got_bits = _bits(restored["embed"]).numpy().view(np.uint16)
    assert restored["embed"].dtype == torch.bfloat16
    assert np.array_equal(got_bits.astype(np.int32), exp_bits)
    assert torch.equal(restored["norm"], torch.from_numpy(w[0]))
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 11
