"""Per-step cost analysis and the roofline's three terms (PyTorch
counterpart of ``repro.launch.analysis``).

Where the reference reads XLA's ``cost_analysis()`` and parses the
compiled HLO for its collectives, the port counts one call of a step as
it runs, on the card, the CPU or the ``meta`` device (shapes only, nothing
allocated: the counterpart of lowering), under :class:`CostMode`:

* FLOPs: ``torch.utils.flop_counter``'s formulas for the aten ops that
  multiply (matmuls, convolutions, attention), and each hand-written
  kernel's reckoning (``kernels.cost``), which its wrapper charges in
  place of the plain version's ops;
* bytes: the inputs plus the outputs of every other aten op (a view
  moves nothing, nor does a copy between devices: a host transfer, not
  memory traffic), and the kernels' reckonings;
* peak live bytes: the storages the call makes, tracked as they are made
  and freed (the counterpart of ``memory_analysis().temp_size_in_bytes``);
* collectives: each one a mesh (``launch.mesh.RankMesh``, or the dry
  run's ``CountingMesh``) makes, recorded as (kind, result bytes, group
  size, link) and turned into per-rank traffic by the reference's ring
  model (:func:`collective_traffic`).

The counts do not depend on the device: a step counted on ``meta``, on
CPU tensors and on the card gives the same FLOPs and bytes (where a
kernel's work depends on the data, ``kernels.cost`` says what ``meta``
counts).  They do depend on the implementation's op granularity: the
port counts each aten op's operands, where XLA counts a fusion's (ROADMAP
Queue 3).

Hardware constants: NVIDIA H100 SXM5 80GB (700 W) data sheet, dense: 989
TFLOP/s bf16 for every FLOP (int8 products included: the reference's one
compute peak), 3.35 TB/s HBM3, 450 GB/s a direction over NVLink between
the 8 cards of a node, 50 GB/s a card across nodes (400 Gb/s NDR).  A
collective's group takes the slowest link it crosses.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as kcost

__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "NETWORK_BW", "CostSample",
           "CostMode", "collective_traffic", "sample_of", "roofline_terms",
           "COLLECTIVE_KINDS"]

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
NETWORK_BW = 50e9

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


def collective_traffic(records) -> dict:
    """Per-rank ring-model traffic (bytes) by collective kind from
    recorded ``(kind, result_bytes, group_size[, link])`` entries, result
    size R and group size P (the reference's multipliers):

    all-gather:      R x (P-1)/P  (result = gathered tensor)
    all-reduce:      2 x R x (P-1)/P  (ring reduce-scatter + all-gather)
    reduce-scatter:  R x (P-1)   (result = shard; input = R x P)
    all-to-all:      R x (P-1)/P
    collective-permute: R

    ``total`` sums the kinds; ``network`` is the part whose group crosses
    nodes (link ``network``; a record without a link stays on NVLink)."""
    out: dict[str, float] = {}
    network = 0.0
    for rec in records:
        kind, r, p = rec[0], float(rec[1]), int(rec[2])
        if kind not in COLLECTIVE_KINDS:
            raise ValueError(f"unknown collective kind {kind!r}")
        if kind == "all-gather":
            traffic = r * (p - 1) / p
        elif kind == "all-reduce":
            traffic = 2.0 * r * (p - 1) / p
        elif kind == "reduce-scatter":
            traffic = r * (p - 1)
        elif kind == "all-to-all":
            traffic = r * (p - 1) / p
        else:
            traffic = r
        out[kind] = out.get(kind, 0.0) + traffic
        if len(rec) > 3 and rec[3] == "network":
            network += traffic
    out["total"] = sum(out.values())
    out["network"] = network
    return out


@dataclasses.dataclass
class CostSample:
    """Per-rank costs of one counted call."""

    flops: float
    bytes_hbm: float
    collectives: dict

    def scaled(self, w: float) -> "CostSample":
        return CostSample(self.flops * w, self.bytes_hbm * w,
                          {k: v * w for k, v in self.collectives.items()})

    def __add__(self, other: "CostSample") -> "CostSample":
        keys = set(self.collectives) | set(other.collectives)
        return CostSample(
            self.flops + other.flops, self.bytes_hbm + other.bytes_hbm,
            {k: self.collectives.get(k, 0) + other.collectives.get(k, 0)
             for k in keys})


# aten ops that move no bytes: metadata, a scalar read back, fresh storage
# without a write (their storages are still tracked as allocations)
_NO_BYTES = {torch.ops.aten.lift_fresh, torch.ops.aten.detach,
             torch.ops.aten._unsafe_view, torch.ops.aten._local_scalar_dense,
             torch.ops.aten.sym_size, torch.ops.aten.sym_stride,
             torch.ops.aten.sym_numel, torch.ops.aten.sym_storage_offset,
             torch.ops.aten.is_same_size, torch.ops.aten.empty,
             torch.ops.aten.empty_strided, torch.ops.aten.empty_like,
             torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}
_COPIES = {torch.ops.aten._to_copy, torch.ops.aten.copy_,
           torch.ops.aten.copy}


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts the FLOPs, bytes, peak live bytes, kernel charges and
    collectives of everything run inside it (one rank's; module doc).
    ``kernels`` maps each charged kernel wrapper to [calls, flops,
    bytes]; ``records`` holds the collectives.  Counting runs nothing
    twice and changes nothing that runs."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.kernels: dict[str, list] = {}
        self.records: list = []
        self.live = 0
        self.peak = 0
        self._pause = 0
        self._refs: dict[int, tuple] = {}

    # -- registration with the kernel wrappers ----------------------------

    def __enter__(self):
        kcost._ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            kcost._ACTIVE.remove(self)

    @property
    def is_paused(self) -> bool:
        return self._pause > 0

    @contextlib.contextmanager
    def paused(self):
        self._pause += 1
        try:
            yield
        finally:
            self._pause -= 1

    # -- the dispatch ------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._pause:
            return out
        self.ops += 1
        packet = func.overloadpacket
        fl = flop_registry.get(packet)
        if fl is not None:
            self.flops += fl(*args, **kwargs, out_val=out)
        if func.is_view:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        # an in-place op's output is its input's storage: no allocation
        self._track(outs, {id(t.untyped_storage()) for t in ins})
        if packet in _NO_BYTES:
            return out
        if packet in _COPIES and len({t.device for t in ins + outs}) > 1:
            return out          # a host transfer
        self.bytes += sum(_nbytes(t) for t in ins) \
            + sum(_nbytes(t) for t in outs)
        return out

    def _track(self, tensors, inputs: frozenset = frozenset()) -> None:
        """The storages of ``tensors`` not tracked yet, and not among the
        ``inputs``' (ids), as allocations that live until freed."""
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._refs or key in inputs:
                continue
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            self._refs[key] = (weakref.ref(st, self._freed(key, n)), n)

    def _freed(self, key: int, n: int) -> Callable:
        def cb(_):
            self.live -= n
            self._refs.pop(key, None)
        return cb

    # -- what the kernel wrappers and meshes report ------------------------

    def charge(self, name: str, flops: float, n_bytes: float, out) -> None:
        """A kernel wrapper's call: its reckoning, and its outputs' fresh
        storages as allocations."""
        self.flops += flops
        self.bytes += n_bytes
        entry = self.kernels.setdefault(name, [0, 0.0, 0.0])
        entry[0] += 1
        entry[1] += flops
        entry[2] += n_bytes
        self._track(_tensors(out))

    def collective(self, kind: str, result_bytes: int, group: int,
                   link: str) -> None:
        self.records.append((kind, int(result_bytes), int(group), link))

    def sample(self) -> CostSample:
        return CostSample(flops=float(self.flops), bytes_hbm=float(self.bytes),
                          collectives=collective_traffic(self.records))


def sample_of(fn: Callable, *args, **kwargs) -> CostSample:
    """A :class:`CostSample` of one call ``fn(*args, **kwargs)``."""
    with CostMode() as mode:
        fn(*args, **kwargs)
    return mode.sample()


def roofline_terms(sample: CostSample) -> dict:
    """Three per-rank roofline terms in seconds + the dominant one: the
    FLOPs over the compute peak, the bytes over HBM, and the collectives'
    traffic over the links their groups cross."""
    t_compute = sample.flops / PEAK_FLOPS
    t_memory = sample.bytes_hbm / HBM_BW
    total = sample.collectives.get("total", 0.0)
    network = sample.collectives.get("network", 0.0)
    t_coll = (total - network) / NVLINK_BW + network / NETWORK_BW
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dominant}
