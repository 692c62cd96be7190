"""The port's Checkpointer (``tests/test_checkpoint.py``'s five cases on
the port): crash-safe commit, garbage collection of uncommitted and old
steps, restore, signature checks, the asynchronous save; and what the
port adds: a bf16 round trip bit for bit through the reference's
uint16 layout, the optimizer state (adafactor's ``(row, col)``
moments, the step) round trip, restore into a meta-device template, the
on-disk layout equal to the JAX package's for the same values, a
serialisation error surfacing on ``wait()``, and a save / restore with
``ml_dtypes`` unimportable.  A few seconds."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.core.tree import leaves, tree_map
from repro_torch.optim import adafactor
from tests.torch_threads import one_torch_thread  # noqa: F401


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(
        rng.normal(size=(8, 8)).astype(np.float32))},
            "step": torch.tensor(seed, dtype=torch.int32)}


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    st = _state(3)
    ck.save(3, st, extra={"data_state": {"step": 3}}, blocking=True)
    restored, extra = ck.restore(st)
    assert extra == {"data_state": {"step": 3}}
    assert torch.equal(restored["params"]["w"], st["params"]["w"])
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) \
        == 3


def test_uncommitted_checkpoint_is_garbage_collected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state(1), blocking=True)
    # a crash mid-write: a directory without COMMIT
    os.makedirs(tmp_path / "step_000000002")
    (tmp_path / "step_000000002" / "manifest.json").write_text("{}")
    assert ck.all_steps() == [1]
    assert not (tmp_path / "step_000000002").exists()
    assert ck.latest_step() == 1


def test_keep_n_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _state(s), blocking=True)
    assert ck.all_steps() == [3, 4]


def test_signature_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state(1), blocking=True)
    wrong = {"params": {"w": torch.zeros((4, 4))},
             "step": torch.zeros((), dtype=torch.int32)}
    with pytest.raises(ValueError, match="signature"):
        ck.restore(wrong)
    with pytest.raises(ValueError, match="signature"):   # dtype alone
        ck.restore({"params": {"w": torch.zeros((8, 8),
                                                dtype=torch.float64)},
                    "step": torch.zeros((), dtype=torch.int32)})


def test_async_save_overlaps_then_waits(tmp_path):
    ck = Checkpointer(str(tmp_path))
    st = _state(5)
    before = st["params"]["w"].clone()
    ck.save(5, st)          # non-blocking: the snapshot is taken now
    st["params"]["w"].add_(1.0)
    ck.wait()
    assert ck.latest_step() == 5
    restored, _ = ck.restore(st)
    assert torch.equal(restored["params"]["w"], before)


def test_async_error_surfaces_on_wait(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state(1), extra={"bad": object()})   # not JSON
    with pytest.raises(TypeError):
        ck.wait()
    assert ck.all_steps() == []


def _bf16(seed, shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16)


def test_bf16_and_opt_state_roundtrip(tmp_path):
    params = {"blocks": [{"w": _bf16(0, (130, 128))},
                         {"w": _bf16(1, (130, 128))}],
              "ln": torch.ones(128)}
    opt = adafactor()
    state = opt.init(params)
    opt.update(tree_map(lambda p: torch.ones_like(p), params), state,
               params, 0.1)
    ck = Checkpointer(str(tmp_path))
    ck.save(7, {"params": params, "opt": state}, blocking=True)
    # a meta template of the same structure restores it, on the CPU
    template = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"),
                        {"params": params, "opt": state})
    restored, _ = ck.restore(template)
    assert isinstance(restored["opt"].v["blocks"][0]["w"], tuple)
    for a, b in zip(leaves(restored), leaves({"params": params,
                                              "opt": state})):
        assert a.dtype == b.dtype and a.device.type == "cpu"
        assert torch.equal(a, b)
    manifest = json.loads(
        (tmp_path / "step_000000007" / "manifest.json").read_text())
    data = np.load(tmp_path / "step_000000007" / "shard_00000.npz")
    bf16 = [i for i, d in enumerate(manifest["dtypes"]) if d == "bfloat16"]
    assert len(bf16) == 2
    assert all(data[f"leaf_{i}"].dtype == np.uint16 for i in bf16)


def test_layout_is_the_references(tmp_path):
    """The same values saved by the JAX package and by the port: the same
    files, manifest keys, leaf order, dtypes and stored bits (bf16 as
    uint16).  The signatures differ: each hashes its own tree paths."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.checkpoint import Checkpointer as JCheckpointer
    w, b = _bf16(3, (16, 8)), torch.arange(5, dtype=torch.float32)
    jw = jnp.asarray(w.view(torch.int16).numpy().view(np.uint16)).view(
        jnp.bfloat16)
    JCheckpointer(str(tmp_path / "j")).save(
        1, {"w": jw, "b": jnp.asarray(b.numpy())}, extra={"step": 1},
        blocking=True)
    Checkpointer(str(tmp_path / "t")).save(1, {"w": w, "b": b},
                                           extra={"step": 1}, blocking=True)
    step = "step_000000001"
    assert sorted(os.listdir(tmp_path / "j" / step)) == \
        sorted(os.listdir(tmp_path / "t" / step)) == \
        ["COMMIT", "manifest.json", "shard_00000.npz"]
    mj, mt = (json.loads((tmp_path / d / step / "manifest.json").read_text())
              for d in ("j", "t"))
    assert sorted(mj) == sorted(mt)
    assert mj["dtypes"] == mt["dtypes"] == ["float32", "bfloat16"]
    assert mj["extra"] == mt["extra"] and mj["n_leaves"] == mt["n_leaves"]
    dj, dt = (np.load(tmp_path / d / step / "shard_00000.npz")
              for d in ("j", "t"))
    for i in range(2):
        assert dj[f"leaf_{i}"].dtype == dt[f"leaf_{i}"].dtype
        assert np.array_equal(dj[f"leaf_{i}"], dt[f"leaf_{i}"])


def test_roundtrip_without_ml_dtypes(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from repro_torch.checkpoint import Checkpointer\n"
        "w = torch.randn(4, 6).to(torch.bfloat16)\n"
        f"ck = Checkpointer({str(tmp_path)!r})\n"
        "ck.save(2, {'w': w}, blocking=True)\n"
        "got, _ = ck.restore({'w': torch.empty(4, 6, dtype=torch.bfloat16)})\n"
        "assert torch.equal(got['w'], w)\n"
        "assert 'ml_dtypes' not in {m for m, v in sys.modules.items() if v}\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env={"PYTHONPATH": os.path.join(root, "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
