"""Asynchronous, crash-safe checkpointing (PyTorch counterpart of
``repro.checkpoint.checkpointer``), in the reference's layout:

    <dir>/step_000123/
        shard_00000.npz      (the state's leaves, ``leaf_<i>`` in leaf
                              order: ``core.tree``'s, the reference's)
        manifest.json        (step, the tree's signature, leaf count and
                              dtypes, extra: the data stream's position)
        COMMIT               (written LAST: a directory without it is a
                              crashed write, removed when steps are listed)

Written into ``step_<n>.tmp`` and renamed; the newest ``keep`` steps are
kept.  ``save`` snapshots every tensor to host memory before it returns
(the train step then updates the device tensors in place), and a worker
thread serializes; an error in it surfaces on the next ``save`` or
``wait()``.  npz has no bfloat16: a bf16 leaf is stored as its uint16
bits, named in the manifest's ``dtypes``, and moved through
``Tensor.view(torch.int16)``, so restoring needs no ``ml_dtypes``.

The state is any tree ``core.tree`` walks (dicts, lists, tuples,
``optim.OptState``) of tensors; restore takes a template tree of the
same paths, shapes and dtypes (the meta device will do) and refuses a
checkpoint of another structure.

On a (data, model) mesh of ranks (``mesh=``, ``specs=``: the state's
spec tree) a checkpoint holds the WHOLE tree, as the reference's hold
global arrays: every rank gathers its pieces back
(``distributed.sharding.unshard_params``) and rank 0 writes; on restore
every rank reads the whole tree and keeps its own pieces.  So a run
saved on one mesh resumes on another, or on one rank.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.tree import (leaves, leaves_with_paths, tree_map,
                                   unflatten)

__all__ = ["Checkpointer"]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _tree_signature(tree: Any) -> str:
    desc = ";".join(f"{p}:{tuple(t.shape)}:{_dtype_name(t)}"
                    for p, t in leaves_with_paths(tree))
    return hashlib.sha1(desc.encode()).hexdigest()


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (never a view of it: the caller goes on
    updating ``t`` in place), bf16 as its uint16 bits."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Any, extra: Optional[dict] = None,
             blocking: bool = False, *, mesh=None, specs: Any = None
             ) -> None:
        """Snapshot ``state`` and write it (on a worker thread unless
        ``blocking``).  On ``mesh`` a collective: ``state`` is the rank's
        pieces cut as ``specs``; rank 0 writes the whole tree, and with
        ``blocking`` every rank returns once it is committed."""
        if mesh is not None:
            from repro_torch.distributed.sharding import unshard_params
            state = unshard_params(state, specs, mesh)
            if mesh.rank == 0:
                self._save(step, state, extra, blocking)
            if blocking:
                mesh.barrier()
            return
        self._save(step, state, extra, blocking)

    def _save(self, step: int, state: Any, extra: Optional[dict],
              blocking: bool) -> None:
        self.wait()
        ls = leaves(state)
        dtypes = [_dtype_name(t) for t in ls]
        host = [_to_numpy(t) for t in ls]
        sig = _tree_signature(state)

        def work():
            try:
                path = os.path.join(self.dir, f"step_{step:09d}")
                tmp = path + ".tmp"
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, "shard_00000.npz"),
                         **{f"leaf_{i}": a for i, a in enumerate(host)})
                manifest = {"step": step, "signature": sig,
                            "n_leaves": len(host), "dtypes": dtypes,
                            "extra": extra or {}}
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                with open(os.path.join(tmp, "COMMIT"), "w") as f:
                    f.write("ok")
                if os.path.exists(path):
                    shutil.rmtree(path)
                os.rename(tmp, path)
                self._gc()
            except BaseException as e:  # surfaced on the next save / wait
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        """The committed steps, ascending; an uncommitted ``step_*``
        directory (a crashed write) is removed on the way."""
        out = []
        for d in sorted(os.listdir(self.dir)):
            full = os.path.join(self.dir, d)
            if d.startswith("step_") and not d.endswith(".tmp") \
                    and os.path.exists(os.path.join(full, "COMMIT")):
                out.append(int(d.split("_")[1]))
            elif d.startswith("step_") and os.path.isdir(full) \
                    and not os.path.exists(os.path.join(full, "COMMIT")):
                shutil.rmtree(full, ignore_errors=True)
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                device=None, *, mesh=None, specs: Any = None
                ) -> tuple[Any, dict]:
        """(state, extra) of ``step`` (default the latest committed) in
        ``template``'s structure; each leaf on ``device``, or where the
        template's leaf lies (the CPU for a meta template).  On ``mesh``
        ``template`` is the whole tree (the meta device's will do) and
        the result the rank's pieces of it, cut as ``specs``, on
        ``device`` or the mesh's."""
        if mesh is not None:
            from repro_torch.distributed.sharding import shard_tree
            whole, extra = self.restore(template, step, "cpu")
            dev = device if device is not None else mesh.device
            return tree_map(lambda t: t.to(dev), shard_tree(
                whole, specs, mesh, mesh.coords)), extra
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["signature"] != _tree_signature(template):
            raise ValueError("checkpoint tree signature mismatch — "
                             "restoring into a different model/optimizer?")
        out = []
        with np.load(os.path.join(path, "shard_00000.npz")) as data:
            for i, t in enumerate(leaves(template)):
                dev = device if device is not None else (
                    "cpu" if t.device.type == "meta" else t.device)
                out.append(_from_numpy(data[f"leaf_{i}"],
                                       manifest["dtypes"][i]).to(dev))
        return unflatten(template, out), manifest["extra"]
