"""Deterministic synthetic token stream and its prefetching loader
(PyTorch counterpart of ``repro.data.pipeline``).

``SyntheticLMStream.batch(step)`` is a pure function of ``(seed, step)``
and draws, number for number, what the JAX package's stream draws, so
calibration batches, prompts and training batches are the same in both
packages: ``tokens``, ``labels`` (the tokens) and ``mask`` (fp32 ones).
With ``encoder_seq`` (the audio family) the batch also carries
``encoder_features``, (B, encoder_seq, d_model) fp32 stub frame
embeddings drawn after the tokens, so the tokens are the same with or
without them.

``ShardedLoader`` keeps ``depth`` batches in flight on a background
thread, each copied to the device from pinned host memory, and exposes
its stream position for checkpointing (restart at step k reproduces the
stream exactly).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device

__all__ = ["SyntheticLMStream", "ShardedLoader", "check_data_split",
           "make_calibration_batch"]


class SyntheticLMStream:
    """Zipf-ish synthetic token stream with n-gram structure (a token
    repeats its predecessor with probability 0.3), deterministic per
    step."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, encoder_seq: Optional[int] = None,
                 d_model: Optional[int] = None):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.encoder_seq = encoder_seq
        self.d_model = d_model

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        b, s = self.global_batch, self.seq_len
        base = rng.zipf(1.3, size=(b, s)).astype(np.int64)
        base = np.minimum(base - 1, self.vocab_size - 1)
        rep = rng.random((b, s)) < 0.3
        shifted = np.roll(base, 1, axis=1)
        tokens = np.where(rep, shifted, base).astype(np.int32)
        out = {"tokens": tokens, "labels": tokens,
               "mask": np.ones((b, s), np.float32)}
        if self.encoder_seq is not None:
            out["encoder_features"] = rng.standard_normal(
                (b, self.encoder_seq, self.d_model), dtype=np.float32)
        return out


def check_data_split(batch: int, data: int, accum: int = 1) -> None:
    """Refuse a global batch that the data axis's ``data`` ranks times
    ``accum`` microbatches do not divide into equal blocks."""
    if batch % (data * accum):
        raise NotImplementedError(
            f"a global batch of {batch} does not split into {data} data "
            f"ranks x {accum} microbatches of equal rows; uneven data "
            f"blocks are ROADMAP Queue 1 item 8's")


class ShardedLoader:
    """Prefetch of the stream's batches onto ``device`` (default
    ``cuda``): a thread draws batch after batch from ``start_step`` and
    keeps ``depth`` of them queued, each array copied to the device from
    pinned host memory without blocking.  ``next(loader)`` gives
    ``(step, batch)``; ``state()`` / ``restore()`` carry the position
    through a checkpoint; ``close()`` stops the thread.  (The reference
    places each batch with its input sharding.)  On a (data, model)
    ``mesh`` (``launch.mesh.RankMesh``) data rank ``d`` of D takes rows
    ``[d B/D, (d + 1) B/D)`` of each global batch, the stream seeded the
    same on every rank, and the rank's device is the mesh's; a global
    batch that D x ``accum`` (the train step's microbatches) does not
    divide is refused."""

    def __init__(self, stream: SyntheticLMStream, device=None,
                 start_step: int = 0, depth: int = 2, *, mesh=None,
                 accum: int = 1):
        self.stream = stream
        self.rows = None
        if mesh is not None:
            d = mesh.shape["data"]
            check_data_split(stream.global_batch, d, accum)
            per = stream.global_batch // d
            self.rows = slice(mesh.coords["data"] * per,
                              (mesh.coords["data"] + 1) * per)
            device = mesh.device
        self.device = resolve_device(device)
        self.depth = depth
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _place(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            if self.rows is not None:
                v = v[self.rows]
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def _fill(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._place(self.stream.batch(step))),
                            timeout=0.1)
                step += 1
            except queue.Full:
                continue

    def __next__(self) -> tuple[int, dict]:
        step, batch = self._q.get()
        self._step = step + 1
        return step, batch

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        while True:
            yield next(self)

    def state(self) -> dict:
        return {"step": self._step, "seed": self.stream.seed}

    @classmethod
    def restore(cls, stream: SyntheticLMStream, device, state: dict,
                depth: int = 2, **on_mesh) -> "ShardedLoader":
        """The loader at a saved ``state()`` (``on_mesh``: ``mesh`` and
        ``accum``, as the constructor's)."""
        stream.seed = state["seed"]
        return cls(stream, device, start_step=state["step"], depth=depth,
                   **on_mesh)

    def close(self):
        self._stop.set()
        while not self._q.empty():
            self._q.get_nowait()
        self._thread.join(timeout=2)


def make_calibration_batch(vocab_size: int, seq_len: int, batch: int,
                           seed: int = 17) -> dict:
    """The paper calibrates on a single batch ("a single image", §2.1)."""
    return SyntheticLMStream(vocab_size, seq_len, batch, seed).batch(0)
