"""Serving cases run on every rank of a spawned mesh and, for comparison,
in one process: the one case runner of the tensor-parallel tests
(``tests/test_torch_tp_serve.py``) and of ``chip_smoke.py``'s phase 27.

Each spawned rank imports this module and ``repro_torch`` only.  A case
is ``(kind, keywords)`` on qwen3-1.7B: ``"classic"`` runs
``launch.serve.serve``, ``"engine"`` ``launch.serve.serve_engine``, each
with ``graphs=False``.  An engine is watched while it serves
(:func:`watched_engines`): its step function's first logits and the
requests each of its steps admitted are kept, from outside the engine.
:func:`run` keeps what the callers compare, and the run's wall time.
"""
import contextlib
import time

import numpy as np
import torch

from repro_torch.launch import serve as tserve
from repro_torch.serving import engine as tengine

ARCH = "qwen3_1_7b"


@contextlib.contextmanager
def watched_engines():
    """Every ``ServingEngine`` that ``serve_engine`` builds inside this
    block is one that also keeps ``first_logits`` (its first step's
    logits, on the host) and ``steps`` (each step's admitted request ids,
    in order); yields the list of those built."""
    base, built = tengine.ServingEngine, []

    class Watched(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.first_logits, self.steps = None, []
            for name in ("_ragged_fn", "_paged_fn", "_rec_fn"):
                if hasattr(self, name):
                    setattr(self, name, self._first(getattr(self, name)))
            built.append(self)

        def _first(self, fn):
            def step_fn(*args, **kwargs):
                logits, cache = fn(*args, **kwargs)
                if self.first_logits is None:
                    self.first_logits = logits.detach().to("cpu", copy=True)
                return logits, cache
            return step_fn

        def step(self):
            n = len(self.sched.admission_log)
            super().step()
            self.steps.append(tuple(self.sched.admission_log[n:]))

    tengine.ServingEngine = Watched
    try:
        yield built
    finally:
        tengine.ServingEngine = base


def run(kind: str, kw: dict, **where) -> dict:
    """One case, on a rank (``mesh=``) or in this process (``device=``):
    tokens (classic) or outputs (engine), the first step's logits, the
    launches, the calibrated table, and ``wall_s`` (synchronized); the
    engine's report, its steps' admissions and, under ``record``, its
    recorded decisions; classic's decode seconds a token."""
    t0 = time.perf_counter()
    if kind == "classic":
        out = tserve.serve(ARCH, graphs=False, **kw, **where)
        res = {"tokens": np.asarray(out["tokens"]), "logits": out["logits"],
               "decode_s_per_tok": out["decode_s_per_tok"]}
    else:
        with watched_engines() as built:
            out = tserve.serve_engine(ARCH, graphs=False, **kw, **where)
        eng = built[-1]
        res = {"outputs": out["outputs"], "logits": eng.first_logits,
               "steps": eng.steps, "report": out["report"],
               "decisions": (out["record"].decisions
                             if out["record"] is not None else None)}
        del eng, built
    dev = where.get("mesh").device if "mesh" in where \
        else torch.device(where.get("device") or "cuda")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    res.update(launches=out["launches"], wall_s=time.perf_counter() - t0,
               table={k: tuple(vars(v).values())
                      for k, v in out["ctx"].table.items()})
    del out
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def run_cases(mesh, cases) -> list:
    """The rank worker: every case on this rank of ``mesh``."""
    return [run(kind, kw, mesh=mesh) for kind, kw in cases]
