"""The port's partition rules (``repro_torch.distributed.sharding``)
against the JAX package's (``repro.distributed.sharding``).

* Params: on every registered LM config at full size, across the meshes
  (2, 2), (1, 4), (4, 1), (16, 16) and a (pod, data, model) one, with
  FSDP on and off and serve on and off, the port's stacked spec of each
  per-layer leaf equals the reference's spec of its stacked leaf (whose
  shape it also reproduces), and the per-layer spec is that spec minus
  its stacking entries.  Every reference leaf is covered.
* Optimizer moments, the batch, and the caches (classic dense under
  'chunked' and 'flash', the engine's block pool) alike; the recurrent
  states and whisper's memory depart (whole over ``model``, ROADMAP
  Queue 3), the engine's state slabs are whole.
* ``shard_params`` cuts each leaf into pieces whose concatenation is the
  leaf, float weights and int8 codes alike; ``local_config`` divides the
  heads, KV heads and d_ff.

The rules read a mesh's ``shape`` and ``axis_names`` only: the reference
gets an ``AbstractMesh`` (no devices), the port a stand-in.
"""
import dataclasses

import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.optim.optimizers import adamw as jadamw  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.qmodel import (QuantContext, QuantMode,  # noqa: E402
                                     quantize_params)
from repro_torch.core.tree import leaves_with_paths  # noqa: E402
from repro_torch.distributed import sharding as tshd  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

LM_ARCHS = [a for a in ARCH_IDS if a != "resnet_paper"]
MESHES = [((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((4, 1), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


class StandIn:
    """What the rules read of a mesh."""

    def __init__(self, sizes, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


def _abstract_mesh(sizes, names):
    try:
        return AbstractMesh(tuple(sizes), tuple(names))
    except TypeError:                       # jax 0.4.x
        return AbstractMesh(tuple(zip(names, sizes)))


def _jflat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jshd._path_str(p): leaf for p, leaf in flat}


def _spec(p) -> tuple:
    """A spec's entries, a one-axis tuple entry as its axis (newer JAX's
    PartitionSpec normalizes them so; both mean the same cut)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in p)


@pytest.fixture(scope="module")
def trees():
    """Per arch: (port cfg, JAX abstract params, port meta params)."""
    return {arch: (get_config(arch), JS.abstract_params(jget(arch)),
                   TM.init_params(get_config(arch), device="meta"))
            for arch in LM_ARCHS}


@pytest.mark.parametrize("sizes,names", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
def test_param_rules_equal_reference(trees, sizes, names):
    amesh, smesh = _abstract_mesh(sizes, names), StandIn(sizes, names)
    for arch, (tcfg, jparams, tparams) in trees.items():
        jshapes = {k: tuple(v.shape) for k, v in _jflat(jparams).items()}
        for fsdp in (False, True):
            for serve in (False, True):
                jspecs = _jflat(jshd.param_sharding_rules(
                    jparams, amesh, fsdp=fsdp, serve=serve))
                stacked = tshd._param_specs(tparams, smesh, fsdp, serve,
                                            tcfg, True)
                layer = tshd._param_specs(tparams, smesh, fsdp, serve,
                                          tcfg, False)
                seen = set()
                for (path, leaf), st, ly in zip(leaves_with_paths(tparams), stacked,
                                                layer):
                    ref, shape, lead = tshd.reference_leaf(
                        tparams, path, tuple(leaf.shape), tcfg)
                    what = (arch, path, fsdp, serve)
                    assert shape == jshapes[ref], what
                    assert st == _spec(jspecs[ref]), what
                    assert ly == st[lead:], what
                    seen.add(ref)
                assert seen == set(jspecs), arch


def test_per_layer_specs_are_stacked_minus_leading():
    """Spot values: a qwen3 layer's attention and MLP cuts on (2, 2), and
    FSDP's data axis past the stacking dim (counted on the stacked
    leaf's elements)."""
    cfg = get_config("qwen3_1_7b")
    p = TM.init_params(cfg, device="meta")
    mesh = StandIn((2, 2), ("data", "model"))
    specs = tshd.param_sharding_rules(p, mesh, fsdp=False, serve=True)
    b0 = specs["blocks"][0]
    assert b0["attn"]["wq"] == (None, "model")
    assert b0["attn"]["wo"] == ("model", None)
    assert b0["mlp"]["w1"] == (None, "model")
    assert b0["mlp"]["w2"] == ("model", None)
    assert b0["ln1"] == (None,)
    assert specs["embed"] == ("model", None)
    assert specs["lm_head"] == (None, "model")
    fs = tshd.param_sharding_rules(p, mesh, fsdp=True)
    assert fs["blocks"][5]["attn"]["wq"] == ("data", "model")
    # a leaf whose one layer is under min_size but whose stack is not
    small = {"blocks": [{"mlp": {"w1": torch.empty((512, 512),
                                                    device="meta")}}] * 8}
    assert tshd.param_sharding_rules(small, mesh, fsdp=True)[
        "blocks"][0]["mlp"]["w1"] == ("data", "model")
    one = {"blocks": small["blocks"][:1]}
    assert tshd.param_sharding_rules(one, mesh, fsdp=True)[
        "blocks"][0]["mlp"]["w1"] == (None, "model")


@pytest.mark.parametrize("sizes,names", MESHES[:2] + MESHES[-1:],
                         ids=["2x2", "1x4", "2x16x16"])
def test_opt_and_batch_rules_equal_reference(sizes, names):
    amesh, smesh = _abstract_mesh(sizes, names), StandIn(sizes, names)
    assert _spec(tshd.batch_sharding(smesh, 3)) == \
        _spec(jshd.batch_sharding(amesh, 3))
    for arch in ("qwen3_1_7b", "zamba2_2_7b", "granite_moe_3b_a800m"):
        cfg = get_smoke_config(arch)
        jopt = JS.abstract_opt_state(
            dataclasses.replace(jget(arch), **{
                f.name: getattr(cfg, f.name)
                for f in dataclasses.fields(ModelConfig)}), jadamw())
        jspecs = jshd.opt_sharding_rules(jopt, None, amesh)
        tparams = TM.init_params(cfg, device="meta")
        topt = tadamw().init(tparams)
        tspecs = tshd.opt_sharding_rules(topt, None, smesh, cfg=cfg,
                                         stacked=True)
        assert tspecs.step == ()
        for field in ("m", "v"):
            jmap = _jflat(getattr(jspecs, field))
            tmom = getattr(topt, field)
            specs = getattr(tspecs, field)
            for path, leaf in leaves_with_paths(tmom):
                ref, _, _ = tshd.reference_leaf(tmom, path,
                                                tuple(leaf.shape), cfg)
                got = _lookup(specs, path)
                assert got == _spec(jmap[ref]), (arch, field, path)


def _lookup(tree, path: str):
    for part in path.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _cache_groups(jtree, ttree):
    """Both caches' specs grouped by top-level key, in field order."""
    jflat, _ = jax.tree_util.tree_flatten_with_path(
        jtree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    jg: dict = {}
    for p, s in jflat:
        jg.setdefault(jshd._path_str(p[:1]), []).append(_spec(s))
    tg: dict = {}
    for path, s in _spec_walk(ttree):
        tg.setdefault(path.split("/")[0], []).append(_spec(s))
    return jg, tg


def _latents_whole(groups: dict) -> dict:
    """The reference's specs of MLA's (L, B, S, lat) latents and rope
    keys with their sequence entry dropped: the port keeps them whole over
    ``model`` (a rank's absorbed decode reads every latent row for its
    heads; ROADMAP Queue 3), cut by batch as the reference's."""
    return {k: [s[:2] + (None,) + s[3:] if len(s) == 4 else s
                for s in specs] for k, specs in groups.items()}


def _spec_walk(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_walk(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            yield from _spec_walk(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("sizes,names", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
def test_cache_rules_equal_reference(sizes, names):
    amesh, smesh = _abstract_mesh(sizes, names), StandIn(sizes, names)
    for arch in LM_ARCHS:
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
        if cfg.hybrid is not None:
            cfg = dataclasses.replace(cfg, n_layers=cfg.hybrid.attn_every)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, n_dense_layers=min(cfg.moe.n_dense_layers, 1)))
        jcfg = dataclasses.replace(jget(arch), **{
            f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(ModelConfig)})
        tcache = TM.init_cache(cfg, 4, 32, device="cpu")
        jcache = JS.abstract_cache(jcfg, 4, 32)
        for kernel in ("chunked", "flash"):
            jg, tg = _cache_groups(
                jshd.cache_sharding_rules(jcache, amesh, attn_kernel=kernel),
                tshd.cache_sharding_rules(tcache, smesh, attn_kernel=kernel))
            if cfg.mla is not None:
                jg = _latents_whole(jg)
            # the recurrent states and whisper's memory depart
            # (test_recurrent_and_audio_cache_rules); the rest is equal
            for part in STATE_PARTS:
                jg.pop(part, None)
                tg.pop(part, None)
            assert jg == tg, (arch, kernel)
        if cfg.family in ("dense", "vlm"):
            tpool = TM.init_paged_cache(cfg, 6, 16, device="cpu")
            jpool = JS.abstract_paged_cache(jcfg, 6, 16)
            jg, tg = _cache_groups(jshd.cache_sharding_rules(jpool, amesh),
                                   tshd.cache_sharding_rules(tpool, smesh))
            assert jg == tg, (arch, "pool")
            kv = tg["paged_kv"][0]
            assert kv[3] == ("model" if cfg.n_kv_heads % smesh.shape["model"]
                             == 0 else None)


# the caches' parts the port lays out apart from the reference's rule
STATE_PARTS = ("state", "ssm", "memory")
# each part's batch dim: RWKV6's (L, B, ...), the hybrid's (G, g, B, ...),
# whisper's (B, T, d)
_BATCH_DIM = {"state": 1, "ssm": 2, "memory": 0}


def _recurrent_cfg(arch):
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    if cfg.hybrid is not None:
        cfg = dataclasses.replace(cfg, n_layers=cfg.hybrid.attn_every)
    jcfg = dataclasses.replace(jget(arch), **{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(ModelConfig)})
    return cfg, jcfg


@pytest.mark.parametrize("sizes,names", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
def test_recurrent_and_audio_cache_rules(sizes, names):
    """The recurrent states (RWKV6's token shifts and wkv, the hybrid's
    conv windows and SSD states) and whisper's encoder memory: cut by
    batch over the data axes where they divide it, WHOLE over ``model``
    (every rank runs the scans on the whole state; the cross attention's
    column-cut wk / wv read whole memory rows).  The reference's rule
    departs on the meshes of up to 4 model ranks (on 16 its cuts divide
    none of rwkv6's dims and fall back to whole): it reads a 5-d state as a
    stacked KV (``model`` on the wkv's heads or its dk, on the hybrid's
    conv arena ``data`` on the group's blocks and ``model`` on the batch)
    and cuts the memory's d over ``model`` (ROADMAP Queue 3, "recurrent
    and audio caches on a mesh").  The engine's state slabs are whole (the
    data ranks are replicas), the hybrid's pool holds its KV heads."""
    amesh, smesh = _abstract_mesh(sizes, names), StandIn(sizes, names)
    dp = tuple(a for a in ("pod", "data") if a in names)
    dsize = 1
    for a in dp:
        dsize *= smesh.shape[a]
    entry = dp[0] if len(dp) == 1 else dp
    for arch in ("rwkv6_3b", "zamba2_2_7b", "whisper_large_v3"):
        cfg, jcfg = _recurrent_cfg(arch)
        tcache = TM.init_cache(cfg, 4, 32, device="cpu")
        jcache = JS.abstract_cache(jcfg, 4, 32)
        tspecs = tshd.cache_sharding_rules(tcache, smesh)
        _, tg = _cache_groups(jshd.cache_sharding_rules(jcache, amesh),
                              tspecs)
        jg, _ = _cache_groups(jshd.cache_sharding_rules(jcache, amesh),
                              tspecs)
        leaves = {p.split("/")[0]: [] for p, _ in _spec_walk(tspecs)}
        for p, leaf in leaves_with_paths(tcache):
            leaves[p.split("/")[0]].append(tuple(leaf.shape))
        departs = False
        for part in STATE_PARTS:
            if part not in tg:
                continue
            b = _BATCH_DIM[part]
            for spec, shape, ref in zip(tg[part], leaves[part], jg[part]):
                want = [None] * len(shape)
                if shape[b] % dsize == 0:
                    want[b] = entry
                assert spec == tuple(want), (arch, part, shape)
                departs |= spec != ref
        if smesh.shape["model"] <= 4:
            assert departs, (arch, "the reference's rule is the port's")
        if cfg.family in ("ssm", "hybrid"):
            slabs = TM.init_paged_state(cfg, 3, num_blocks=4, block_size=16,
                                        device="cpu")
            for path, spec in _spec_walk(tshd.cache_sharding_rules(slabs,
                                                                   smesh)):
                if path.startswith("paged_kv"):
                    assert spec[3] == ("model" if cfg.n_kv_heads
                                       % smesh.shape["model"] == 0
                                       else None), path
                else:
                    assert all(e is None for e in spec), (arch, path)


@pytest.mark.parametrize("sizes", [(1, 2), (2, 2), (1, 4)])
def test_shard_params_round_trip(sizes):
    cfg = dataclasses.replace(get_smoke_config("qwen3_1_7b"), n_kv_heads=4,
                              dtype="float32")
    mesh = StandIn(sizes, ("data", "model"))
    full = TM.init_params(cfg, 0, device="cpu")
    ctx = QuantContext(mode=QuantMode.INT)
    codes = quantize_params(full, ctx).tree
    specs = tshd.param_sharding_rules(full, mesh, fsdp=False, serve=True)
    for tree in (full, codes):
        pieces = {(d, m): tshd.shard_params(tree, mesh,
                                            {"data": d, "model": m})
                  for d in range(sizes[0]) for m in range(sizes[1])}
        for (path, leaf), spec in zip(leaves_with_paths(tree),
                                      tshd._param_specs(tree, mesh, False,
                                                        True, None, False)):
            assert spec == _lookup(specs, path)
            for d in range(sizes[0]):
                parts = [_lookup(pieces[(d, m)], path)
                         for m in range(sizes[1])]
                cut = [i for i, e in enumerate(spec) if e is not None]
                assert all(e in (None, "model") for e in spec), path
                if cut:
                    back = torch.cat(parts, dim=cut[0])
                else:
                    assert all(torch.equal(p, leaf) for p in parts), path
                    back = parts[0]
                assert back.dtype == leaf.dtype and torch.equal(back, leaf), \
                    path


def test_local_config_divides_heads_and_ff():
    cfg = get_config("qwen3_1_7b")
    mesh = StandIn((1, 2), ("data", "model"))
    loc = tshd.local_config(cfg, mesh)
    assert (loc.n_heads, loc.n_kv_heads, loc.d_ff, loc.resolved_head_dim,
            loc.vocab_size) == (8, 4, 3072, 128, cfg.vocab_size)
    assert tshd.local_config(cfg, StandIn((2, 1), ("data", "model"))) is cfg
    assert tshd.local_config(cfg, None) is cfg
    with tshd.activation_sharding(mesh, batch_split=True):
        assert tshd.current_mesh() is mesh
        assert tshd.data_shards() == 1 and tshd.model_shards() == 2
        assert tshd.tp_mesh() is mesh
    assert tshd.current_mesh() is None and tshd.data_shards() == 1
    with tshd.activation_sharding(StandIn((2, 2), ("data", "model")),
                                  batch_split=True):
        assert tshd.batch_shards() == 2
    with tshd.activation_sharding(StandIn((2, 2), ("data", "model"))):
        assert tshd.batch_shards() == 1
