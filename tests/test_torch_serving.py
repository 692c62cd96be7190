"""Differential tests: the port's serving stack against the JAX package's.

* Host state: the same random alloc / extend / commit / copy-on-write /
  free / evict trace, with the prefix cache on, gives identical block ids,
  tables, refcounts and stats in both packages' ``BlockPool``; the same
  request stream gives identical admission, preemption and tables in both
  ``Scheduler``s.
* Engine: the port's ``serve_engine(device="cpu")`` is token-identical
  (greedy) to the JAX ``serve_engine`` on the same ``poisson_workload``
  with the JAX weights carried over, in FP and INT-uncalibrated modes,
  with a shared prefix that hits the prefix cache and an undersized pool
  that forces preemption.  Requests all arrive at once so the schedule
  does not depend on either engine's wall clock.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import kv_pool as jkv  # noqa: E402
from repro.serving import scheduler as jsch  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import from_jax_params  # noqa: E402
from repro_torch.serving import kv_pool as tkv  # noqa: E402
from repro_torch.serving import scheduler as tsch  # noqa: E402


def _pool_state(pool):
    seqs = {s: pool.seq_blocks(s) for s in pool.seq_ids()}
    cache = None if pool.cache is None else dataclasses.asdict(pool.cache.stats)
    return (seqs, pool.refcount.tolist(), pool.scale_exp.tolist(),
            list(pool._free), list(pool._idle), dataclasses.asdict(pool.stats),
            cache)


def _pool_trace(mod, seed):
    """Apply a seeded random op trace to a fresh pool of module ``mod``;
    returns the list of (op result, pool state) after every op."""
    rng = np.random.default_rng(seed)
    bs = 4
    pool = mod.BlockPool(num_blocks=24, block_size=bs, scale_exp=4,
                         prefix_cache=True)
    prefix = rng.integers(0, 5, size=12).astype(np.int32)
    live: dict[int, list] = {}          # seq -> committed token ids
    log, sid = [], 0
    for _ in range(120):
        op = int(rng.integers(6))
        res = None
        try:
            if op == 0:                 # alloc, often sharing the prefix
                n = int(rng.integers(1, 20))
                toks = np.concatenate([prefix, rng.integers(0, 5, size=n)]
                                      ).astype(np.int32)
                res = pool.alloc_seq(sid, len(toks), token_ids=toks)
                pool.commit(sid, 0, toks)           # its KV is resident
                live[sid] = toks
                sid += 1
            elif op == 1 and live:      # extend + commit the new rows
                s = int(rng.choice(sorted(live)))
                extra = rng.integers(0, 5, size=int(rng.integers(1, 9))
                                     ).astype(np.int32)
                start = len(live[s])
                res = pool.extend(s, start + len(extra))
                live[s] = np.concatenate([live[s], extra])
                pool.commit(s, start, extra)
            elif op == 2 and live:      # re-commit of the last row: no-op
                s = int(rng.choice(sorted(live)))
                pool.commit(s, len(live[s]) - 1, live[s][-1:])
            elif op == 3 and live:      # copy-on-write of a shared block
                s = int(rng.choice(sorted(live)))
                for idx in range(pool.n_blocks_of(s)):
                    if not pool.block_writable(s, idx):
                        res = pool.cow(s, idx)
                        break
            elif op == 4 and live:
                s = int(rng.choice(sorted(live)))
                res = pool.free_seq(s)
                del live[s]
            elif op == 5 and live:
                s = int(rng.choice(sorted(live)))
                res = pool.evict(s)
                del live[s]
        except mod.BlockPoolError as e:
            res = ("error", str(e))
        pool.check_invariants()
        log.append((op, res, _pool_state(pool)))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_pool_trace_identical(seed):
    jlog, tlog = _pool_trace(jkv, seed), _pool_trace(tkv, seed)
    assert jlog == tlog
    assert any(st[6]["hits"] for _, _, st in tlog)       # cache was hit


def _sched_trace(kv_mod, sch_mod, seed):
    rng = np.random.default_rng(seed)
    pool = kv_mod.BlockPool(num_blocks=10, block_size=4, scale_exp=4,
                            prefix_cache=True)
    sched = sch_mod.Scheduler(pool, n_slots=3, chunk=6, max_model_len=24)
    prefix = rng.integers(0, 7, size=8).astype(np.int32)
    for rid in range(8):
        tail = rng.integers(0, 7, size=int(rng.integers(1, 9)))
        sched.submit(sch_mod.Request(
            rid=rid, prompt=np.concatenate([prefix, tail]).astype(np.int32),
            max_new_tokens=int(rng.integers(2, 8)), arrival=0.0))
    log, now = [], 0.0
    while not sched.idle:
        now += 1.0
        sched.admit(now)
        for req in sched.prefill_jobs():
            c = min(sched.chunk, len(req.feed) - req.n_prefilled)
            pool.commit(req.rid, req.n_prefilled,
                        req.feed[req.n_prefilled:req.n_prefilled + c])
            req.n_prefilled += c
            req.n_ctx = req.n_prefilled
            if req.n_prefilled == len(req.feed):
                req.generated.append(int(rng.integers(0, 7)))
                req.state = sch_mod.RequestState.DECODE
        for req in list(sched.decode_reqs()):
            if req.slot is None or not sched.grow_for_decode(req, now):
                continue
            pool.commit(req.rid, req.n_ctx, [req.generated[-1]])
            req.n_ctx += 1
            tok = int(rng.integers(0, 7))
            done = req.finished_by(tok, sched.max_model_len)
            req.generated.append(tok)
            if done:
                sched.finish(req, now)
        log.append((list(sched.admission_log),
                    [None if r is None else (r.rid, r.state.value, r.n_ctx)
                     for r in sched.slots],
                    {s: pool.table_row(s, sched.nbmax).tolist()
                     for s in pool.seq_ids()},
                    pool.refcount.tolist()))
    return log, [(r.rid, r.preemptions, list(r.generated)) for r in sched.done]


@pytest.mark.parametrize("seed", [3, 4])
def test_scheduler_trace_identical(seed):
    jlog, jdone = _sched_trace(jkv, jsch, seed)
    tlog, tdone = _sched_trace(tkv, tsch, seed)
    assert jlog == tlog and jdone == tdone
    assert sum(p for _, p, _ in tdone) > 0               # preemption ran


@pytest.mark.parametrize("mode", ["fp", "int"])
def test_engine_greedy_tokens_identical(mode):
    jcfg = dataclasses.replace(get_smoke_config("qwen3_1_7b"),
                               kv_cache_bits=8, dtype="float32")
    tcfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})
    kw = dict(n_requests=8, rate=1e9, mode=mode, calibrate=False, kv_bits=8,
              cfg_overrides={"dtype": "float32"}, shared_prefix=16,
              num_blocks=8)
    jo = jserve.serve_engine("qwen3_1_7b", **kw)
    params = from_jax_params(
        jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0))),
        tcfg, device="cpu")
    to = tserve.serve_engine("qwen3_1_7b", params=params, device="cpu", **kw)
    assert sorted(jo["outputs"]) == sorted(to["outputs"]) == list(range(8))
    for rid, toks in jo["outputs"].items():
        assert np.array_equal(toks, to["outputs"][rid]), rid
    tr, jr = to["report"], jo["report"]
    assert tr["preemptions"] == jr["preemptions"] > 0
    assert tr["prefix_cache"]["hits"] == jr["prefix_cache"]["hits"] > 0
    assert tr["ragged_steps"] == jr["ragged_steps"]
    assert tr["padded_tokens"] == jr["padded_tokens"]
    assert tr["kernel_launches"] == {"int8_matmul": 0, "ragged_attention": 0}


def test_sampling_matches_jax():
    """Greedy rows take the first argmax (ties included) in both
    packages; top-k keeps exactly k candidates, ties broken lowest index
    first; sampled rows draw only inside that support."""
    import torch
    from repro.serving.engine import sample_tokens as jsample
    from repro.serving.spec import apply_top_k as jtopk
    from repro_torch.serving.engine import sample_tokens as tsample
    from repro_torch.serving.spec import apply_top_k as ttopk
    rng = np.random.default_rng(9)
    logits = rng.integers(-3, 4, size=(6, 50)).astype(np.float32)  # ties
    top_k = np.asarray([0, 1, 3, 5, 50, 7], np.int32)
    jm = np.asarray(jtopk(jax.numpy.asarray(logits), jax.numpy.asarray(top_k),
                          k_cap=8))
    tm = ttopk(torch.from_numpy(logits), torch.from_numpy(top_k), k_cap=8)
    assert np.array_equal(np.isfinite(jm), torch.isfinite(tm).numpy())
    temps = np.zeros(6, np.float32)
    jg = np.asarray(jsample(jax.numpy.asarray(logits), jax.random.PRNGKey(0),
                            jax.numpy.asarray(temps)))
    gen = torch.Generator().manual_seed(0)
    tg = tsample(torch.from_numpy(logits), gen, torch.from_numpy(temps))
    assert np.array_equal(jg, tg.numpy())
    hot = tsample(torch.from_numpy(logits), gen, torch.ones(6),
                  torch.from_numpy(top_k), k_cap=8).numpy()
    assert all(np.isfinite(jm[i, hot[i]]) for i in range(6))
