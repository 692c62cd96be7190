"""The (data, model) mesh over processes (PyTorch counterpart of
``repro.launch.mesh``'s ``make_local_mesh``).

The JAX package builds a mesh over the devices one process sees and lets
GSPMD move the slices; the port runs one process a rank, each holding its
own slices, over ``torch.distributed``.  Rank ``r`` of a D x M mesh sits
at (data ``r // M``, model ``r % M``) and, on the card, on
``cuda:(r % device_count)``.  The backend is named by the caller, never
chosen: ``gloo`` (the CPU; also CUDA tensors, through the host, and ranks
that share a card) or ``nccl`` (one card a rank; it refuses two ranks on
one card, so that asks for an error here).

:func:`run_ranks` starts the D x M ranks itself (``spawn``: the parent
may hold a CUDA context already) and returns each rank's result;
:func:`join_world` joins a world that ``torchrun`` started.  Nothing
here starts a process or touches a device at import.

:func:`make_production_mesh` is the reference's production layout (no
ranks), and :class:`CountingMesh` rank 0 of a layout alone, whose
collectives are recorded and not made: the dry run's
(``launch.dryrun``).
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.kernels.cost import note_collective, uncounted

__all__ = ["RankMesh", "CountingMesh", "make_production_mesh",
           "make_local_mesh", "run_ranks", "join_world", "in_torchrun",
           "parse_mesh", "pick_backend", "on_ranks", "BACKENDS",
           "CARDS_PER_NODE"]

BACKENDS = ("gloo", "nccl")
_TIMEOUT = datetime.timedelta(minutes=15)


def parse_mesh(text: str) -> tuple[int, int]:
    """``"DxM"`` (the CLI's ``--mesh``) as (data, model)."""
    try:
        d, m = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes DATAxMODEL, e.g. 1x2, not "
                         f"{text!r}") from None
    if d < 1 or m < 1:
        raise ValueError(f"mesh axes are at least 1, got {text!r}")
    return d, m


# cards a node joins over NVLink; a collective group that spans nodes
# crosses the network (``launch.analysis``'s link rates)
CARDS_PER_NODE = 8


class RankMesh:
    """One rank's view of a (data, model) mesh of processes: ``shape``
    (axis name -> size) and ``axis_names``, which the sharding rules read,
    this rank's ``coords``, its ``device``, and the collectives over one
    axis's group (a no-op over an axis of size 1).  ``RankMesh(d, m)``
    alone is the layout, before any rank exists (the build-time refusals
    read it); its collectives over an axis longer than one fail.

    Each collective is noted for the cost analysis (``kernels.cost.
    note_collective``: what it means, its result's bytes, its group's size
    and whether the group spans nodes of :data:`CARDS_PER_NODE` cards).
    A reduce-scatter is noted as one, whatever gloo runs for it; the moves
    through the host around gloo are not counted."""

    axis_names = ("data", "model")

    def __init__(self, data: int, model: int, rank: int = 0,
                 groups: Optional[dict] = None,
                 device: Optional[torch.device] = None,
                 backend: Optional[str] = None):
        if data < 1 or model < 1:
            raise ValueError(f"mesh axes are at least 1, got "
                             f"({data}, {model})")
        self.shape = {"data": data, "model": model}
        self.size = data * model
        self.rank = rank
        self.coords = {"data": rank // model, "model": rank % model}
        self.device = device
        self.backend = backend
        self._groups = groups or {}

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(data={self.shape['data']}, model="
                f"{self.shape['model']}, rank={self.rank}, "
                f"{self.backend} on {self.device})")

    # -- the record -------------------------------------------------------

    def _group_ranks(self, axis: str) -> list:
        """The ranks of this rank's group over ``axis``, in order."""
        d, m = self.coords["data"], self.coords["model"]
        if axis == "model":
            return [d * self.shape["model"] + j
                    for j in range(self.shape["model"])]
        return [i * self.shape["model"] + m
                for i in range(self.shape["data"])]

    def _note(self, kind: str, result_bytes: int, axis: str) -> None:
        nodes = {r // CARDS_PER_NODE for r in self._group_ranks(axis)}
        note_collective(kind, int(result_bytes), self.shape[axis],
                        "nvlink" if len(nodes) == 1 else "network")

    # -- what crosses the ranks (a stand-in replaces these two) -----------

    def _reduce(self, t: torch.Tensor, axis: str, op: str) -> None:
        with uncounted():
            dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                            else dist.ReduceOp.MAX,
                            group=self._groups[axis])

    def _gather(self, t: torch.Tensor, axis: str) -> list:
        """The ranks' ``t`` of ``axis`` in rank order (contiguous).  Over
        gloo a CUDA tensor is gathered through the host (a copy each
        way), as gloo's own CUDA all-reduce works."""
        with uncounted():
            dev = t.device
            host = self.backend == "gloo" and dev.type == "cuda"
            t = (t.cpu() if host else t).contiguous()
            parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
            dist.all_gather(parts, t, group=self._groups[axis])
            return [p.to(dev) for p in parts] if host else parts

    # -- the collectives --------------------------------------------------

    def all_reduce(self, t: torch.Tensor, axis: str = "model",
                   op: str = "sum") -> torch.Tensor:
        """``t`` reduced IN PLACE over ``axis``'s ranks (``sum`` or
        ``max``) and returned."""
        if self.shape[axis] > 1:
            self._note("all-reduce", t.numel() * t.element_size(), axis)
            self._reduce(t, axis, op)
        return t

    def all_reduced(self, t: torch.Tensor, axis: str = "model",
                    op: str = "sum") -> torch.Tensor:
        """A new tensor: ``t`` reduced over ``axis``'s ranks, ``t`` left as
        it is (autograd's collectives take this one: an in-place reduce
        bumps a saved tensor's version)."""
        if self.shape[axis] == 1:
            return t
        return self.all_reduce(t.clone(memory_format=torch.contiguous_format),
                               axis, op)

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int
                       ) -> torch.Tensor:
        """``t`` summed over ``axis``'s ranks, and this rank's block of
        ``dim`` of the sum (the axis's size divides it): the all-reduce,
        then the block (gloo has no reduce-scatter on every build; the
        values are a reduce-scatter's, and it is noted as one)."""
        n = self.shape[axis]
        if n == 1:
            return t
        size = t.shape[dim] // n
        out = t.clone(memory_format=torch.contiguous_format)
        self._note("reduce-scatter", out.numel() * out.element_size() // n,
                   axis)
        self._reduce(out, axis, "sum")
        return out.narrow(dim, self.coords[axis] * size, size)

    def all_gather(self, t: torch.Tensor, axis: str = "model",
                   dim: int = -1) -> torch.Tensor:
        """The ranks' ``t`` of ``axis`` concatenated along ``dim`` in
        rank order."""
        if self.shape[axis] == 1:
            return t
        out = torch.cat(self._gather(t, axis), dim=dim)
        self._note("all-gather", out.numel() * out.element_size(), axis)
        return out

    def all_gather_rows(self, t: torch.Tensor, axis: str,
                        sizes) -> list:
        """The ranks' ``t`` of ``axis`` in rank order, where rank i's
        holds ``sizes[i]`` rows (dim 0; every rank passes the same
        ``sizes``): each padded to the largest, gathered, and cut back,
        so only those rows cross (the MoE exchange's kept rows)."""
        if self.shape[axis] == 1:
            return [t]
        most = max(sizes)
        if most == 0:
            return [t[:0] for _ in sizes]
        pad = t.new_zeros((most,) + tuple(t.shape[1:]))
        pad[:t.shape[0]] = t
        got = self.all_gather(pad, axis, 0)
        return [got[i * most:i * most + n] for i, n in enumerate(sizes)]

    def barrier(self) -> None:
        """Wait for every rank of the mesh."""
        if self.size > 1:
            dist.barrier()

    def gather_objects(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order, on every rank."""
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s picklable ``obj`` on every rank."""
        box = [obj if self.rank == src else None]
        dist.broadcast_object_list(box, src=src)
        return box[0]


class CountingMesh(RankMesh):
    """Rank 0 of a (data, model) layout, alone: its collectives are noted
    as :class:`RankMesh`'s are, then return tensors of the right shape
    without communicating (a reduce leaves this rank's values, a gather
    repeats them; filled uncounted), so one rank's step of a mesh of any
    size runs, and is counted, in one process (the dry run's,
    ``launch.dryrun``).  Its values are not the mesh's."""

    def __init__(self, data: int, model: int,
                 device: Optional[torch.device] = None):
        super().__init__(data, model, 0, None, device, None)

    def _reduce(self, t, axis, op) -> None:
        return None

    def _gather(self, t, axis) -> list:
        return [t] * self.shape[axis]

    def barrier(self) -> None:
        return None

    def gather_objects(self, obj) -> list:
        return [obj] * self.size

    def broadcast_object(self, obj, src: int = 0):
        return obj


def make_production_mesh(*, multi_pod: bool = False) -> RankMesh:
    """The reference's production layout as a :class:`RankMesh` layout
    with no ranks: (16, 16) over ``("data", "model")``, 256 cards; with
    ``multi_pod`` two such pods, whose ``pod`` axis the port folds into
    ``data`` (32, 16): the port's data-parallel collectives run over one
    ``data`` axis (ROADMAP Queue 3)."""
    return RankMesh(32 if multi_pod else 16, 16)


def pick_backend(dist_backend: Optional[str], device) -> str:
    """The ranks' backend: as given, else ``nccl`` on the card (one card a
    rank) and ``gloo`` on the CPU; never chosen for the caller past that
    (:func:`make_local_mesh` refuses nccl on a shared card)."""
    if dist_backend is not None:
        return dist_backend
    return "gloo" if torch.device(device or "cuda").type == "cpu" \
        else "nccl"


def on_ranks(fn: Callable, mesh_shape, device, dist_backend: Optional[str],
             kwargs: dict) -> list:
    """``fn(mesh, **kwargs)`` on every rank of the mesh: in this process
    when ``torchrun`` started it (a one-element list), else on D x M ranks
    spawned here (every rank's result, in rank order), the CPU's ranks
    sharing this process's intra-op threads."""
    dev = "cuda" if device is None else str(device)
    backend = pick_backend(dist_backend, dev)
    if in_torchrun():
        return [fn(join_world(mesh_shape, device=dev, backend=backend),
                   **kwargs)]
    threads = (max(1, torch.get_num_threads() // (mesh_shape[0]
                                                   * mesh_shape[1]))
               if torch.device(dev).type == "cpu" else None)
    return run_ranks(fn, mesh_shape, device=dev, backend=backend,
                     kwargs=kwargs, threads=threads)


def make_local_mesh(model_axis: int = 1, *, device: str = "cuda",
                    backend: str) -> RankMesh:
    """The (world / ``model_axis``, ``model_axis``) mesh over the ranks of
    the initialised world, its groups made with ``backend``; this rank's
    device is ``cuda:(rank % device_count)`` (made current) or the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh runs in an initialised world "
                           "(run_ranks, join_world or torchrun)")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    world, rank = dist.get_world_size(), dist.get_rank()
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"{world} ranks")
    dev = torch.device(device)
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("no CUDA device for the mesh's ranks")
        if backend == "nccl" and world > n_cards:
            raise ValueError(
                f"{world} ranks share {n_cards} card(s): NCCL refuses two "
                f"ranks on one device; pass backend='gloo' (it reduces "
                f"CUDA tensors through the host)")
        dev = torch.device("cuda", rank % n_cards)
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("nccl reduces CUDA tensors only; the CPU's ranks "
                         "take backend='gloo'")
    data = world // model_axis
    groups = {}
    # every rank makes every group, in one order
    for d in range(data):
        ranks = [d * model_axis + m for m in range(model_axis)]
        g = dist.new_group(ranks, backend=backend) if model_axis > 1 \
            else None
        if rank in ranks:
            groups["model"] = g
    for m in range(model_axis):
        ranks = [d * model_axis + m for d in range(data)]
        g = dist.new_group(ranks, backend=backend) if data > 1 else None
        if rank in ranks:
            groups["data"] = g
    return RankMesh(data, model_axis, rank, groups, dev, backend)


def join_world(mesh_shape: tuple[int, int], *, device: str = "cuda",
               backend: str) -> RankMesh:
    """Join the world ``torchrun`` started (its ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` / ``MASTER_PORT``) and make the mesh over it; the
    world must hold D x M ranks."""
    d, m = mesh_shape
    world = int(os.environ["WORLD_SIZE"])
    if world != d * m:
        raise ValueError(f"a {d}x{m} mesh needs {d * m} ranks; torchrun "
                         f"started {world}")
    if torch.device(device).type == "cuda" and torch.cuda.device_count():
        torch.cuda.set_device(int(os.environ["RANK"])
                              % torch.cuda.device_count())
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                timeout=_TIMEOUT)
    return make_local_mesh(m, device=device, backend=backend)


def in_torchrun() -> bool:
    """Whether this process is a rank ``torchrun`` started."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR"))


def _rank_main(rank: int, world: int, mesh_shape, device: str, backend: str,
               workdir: str, fn: Callable, kwargs: dict,
               threads: Optional[int]) -> None:
    """A spawned rank: join the world through the file store in
    ``workdir``, run ``fn(mesh, **kwargs)`` and save its result there."""
    if threads is not None:
        torch.set_num_threads(threads)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(str(Path(workdir) / "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=_TIMEOUT)
    try:
        mesh = make_local_mesh(mesh_shape[1], device=device, backend=backend)
        result = fn(mesh, **kwargs)
        torch.save(result, Path(workdir) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, mesh_shape: tuple[int, int], *,
              device: str = "cuda", backend: str,
              kwargs: Optional[dict] = None,
              workdir: Optional[str] = None,
              threads: Optional[int] = None) -> list:
    """Start the D x M ranks of ``mesh_shape`` (``spawn``), each running
    ``fn(mesh, **kwargs)`` (``fn`` a module-level function: the ranks
    import it), and return their results in rank order.  They meet
    through a file store in a fresh directory under ``workdir`` (default
    the system's temporary directory), removed after.  A rank that raises
    stops the others, and the error is raised here.  ``threads`` sets
    each rank's intra-op torch threads."""
    d, m = mesh_shape
    world = d * m
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the mesh's ranks run on a CUDA device and none "
                           "is available; pass device='cpu'")
    tmp = tempfile.mkdtemp(prefix="repro-mesh-", dir=workdir)
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(world, (d, m), device, backend, tmp, fn,
                              dict(kwargs or {}), threads),
            nprocs=world, join=True, start_method="spawn")
        # our own ranks' files
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
