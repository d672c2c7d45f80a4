"""The port's checkpoints against the reference package's, on the CPU.

* :class:`~repro_torch.checkpoint.Checkpointer`: the reference's layout
  (``step_XXXXXXXX/`` of ``.npy`` leaves and a JSON manifest), so each
  package restores the other's float32 checkpoints; bfloat16 leaves saved
  as their ``uint16`` bits and restored bit for bit; ``keep`` and
  ``save_async``, whose host copy is taken before it returns; a failed
  background write raised by the next ``wait``.
* :func:`~repro_torch.checkpoint.add_checkpoint_tasks`: a writer that
  crashes mid-write aborts the run and leaves the sink torn, and the file
  grant it held is released (the port of
  ``tests/test_resources.py::test_crash_mid_write_releases_the_file_grant``).

Values are compared bit for bit: a checkpoint stores and restores them
unchanged.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro_torch import Graph, Session
from repro_torch.checkpoint import (Checkpointer, CheckpointSink,
                                    TornWriteError, add_checkpoint_tasks,
                                    checkpoint_resource)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"blocks.0.attn.wq": torch.from_numpy(
                rng.standard_normal((4, 6)).astype(np.float32)
            ).to(torch.bfloat16),
            "final_norm": torch.from_numpy(
                rng.standard_normal(6).astype(np.float32))},
            "opt_state": {"step": torch.tensor(7, dtype=torch.int32),
                          "m": {"final_norm": torch.zeros(6)}}}


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_trees(a[k], b[k])
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                       else a, b.view(torch.int16)
                       if b.dtype == torch.bfloat16 else b)


def test_bfloat16_round_trip_is_bit_exact(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = _tree()
    # bit patterns across the whole range: signs, zeros, infinities, NaNs
    bits = torch.arange(-32768, 32767, 97, dtype=torch.int16)
    tree["params"]["bits"] = bits.view(torch.bfloat16)
    ck.save(10, tree, extra={"foo": 1})
    restored, manifest = ck.restore(device="cpu")
    assert manifest["step"] == 10 and manifest["extra"]["foo"] == 1
    _equal_trees(tree, restored)
    dtypes = {"/".join(leaf["path"]): leaf["dtype"]
              for leaf in manifest["leaves"]}
    assert dtypes["params/bits"] == "bfloat16"
    assert dtypes["params/final_norm"] == "float32"
    assert dtypes["opt_state/step"] == "int32"
    leaf = next(x for x in manifest["leaves"]
                if x["path"] == ["params", "bits"])
    on_disk = np.load(os.path.join(tmp_path, "step_00000010", leaf["file"]))
    assert on_disk.dtype == np.uint16
    assert np.array_equal(on_disk.view(np.int16), bits.numpy())


def test_gc_and_async_copy_before_returning(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    x = torch.zeros(2)
    for s in (1, 2, 3):
        x.fill_(s)
        ck.save_async(s, {"x": x})
        x.fill_(-1.0)          # the train step's in-place update: too late
    ck.wait()
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    restored, _ = ck.restore(step=2, device="cpu")
    assert restored["x"].tolist() == [2.0, 2.0]
    assert ck.restore(device="cpu")[0]["x"].tolist() == [3.0, 3.0]


def test_each_package_restores_the_others_float32_checkpoint(tmp_path):
    rng = np.random.default_rng(1)
    arrays = {"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": {"c": np.arange(4, dtype=np.int32)}}
    JaxCheckpointer(str(tmp_path / "ref")).save(
        5, {"a": jnp.asarray(arrays["a"]),
            "b": {"c": jnp.asarray(arrays["b"]["c"])}}, extra={"k": 2})
    ours, manifest = Checkpointer(str(tmp_path / "ref")).restore(device="cpu")
    assert manifest["step"] == 5 and manifest["extra"] == {"k": 2}
    assert np.array_equal(ours["a"].numpy(), arrays["a"])
    assert ours["b"]["c"].dtype == torch.int32
    assert np.array_equal(ours["b"]["c"].numpy(), arrays["b"]["c"])

    Checkpointer(str(tmp_path / "port")).save(
        6, {"a": torch.from_numpy(arrays["a"]),
            "b": {"c": torch.from_numpy(arrays["b"]["c"])}})
    theirs, _ = JaxCheckpointer(str(tmp_path / "port")).restore()
    assert np.array_equal(np.asarray(theirs["a"]), arrays["a"])
    assert np.array_equal(np.asarray(theirs["b"]["c"]), arrays["b"]["c"])
    with open(tmp_path / "port" / "step_00000006" / "manifest.json") as f:
        assert [leaf["path"] for leaf in json.load(f)["leaves"]] == \
            [["a"], ["b", "c"]]


def test_restore_needs_a_device_and_no_sharding(tmp_path):
    ck = Checkpointer(str(tmp_path))
    assert ck.restore(device="cpu") == (None, None)
    ck.save(1, {"x": torch.ones(1)})
    # a leaf without placements restores whole (the elastic cases run on
    # gloo meshes in test_torch_sharding.py)
    tree, _ = ck.restore(device="cpu", shardings={"x": None})
    assert torch.equal(tree["x"], torch.ones(1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ck.restore()


def test_a_failed_background_write_is_raised_by_wait(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save_async(1, {"x": torch.ones(1)}, extra={"bad": object()})
    with pytest.raises(RuntimeError, match="background checkpoint write"):
        ck.wait()
    ck.wait()                             # the error is raised once
    assert ck.all_steps() == []


def test_crash_mid_write_releases_the_file_grant():
    n_shards = 3
    with Session(workers=3) as s:
        sink = CheckpointSink(n_shards)
        g = Graph("ckpt")
        add_checkpoint_tasks(g, sink, list(range(n_shards)),
                             resource=checkpoint_resource(), crash_on=1)
        with pytest.raises(Exception, match="simulated crash"):
            s.run(g, timeout=30.0)
        assert sink.torn and not sink.complete
        with pytest.raises(TornWriteError, match="incomplete"):
            sink.finalize()
        # the dead writer's grant is gone: a fresh attempt on the SAME
        # session acquires the file cleanly (a leak would deadlock here)
        sink2 = CheckpointSink(n_shards)
        g2 = Graph("ckpt")
        add_checkpoint_tasks(g2, sink2, list(range(n_shards)),
                             resource=checkpoint_resource())
        s.run(g2, timeout=30.0)
        assert sink2.complete and sorted(sink2.write_log) == [0, 1, 2]
