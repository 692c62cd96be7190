"""The port's dry run (``repro_torch.launch.dryrun``) and its step helpers
(``launch.steps``) against the reference's (``repro.launch.dryrun``,
``repro.launch.steps``).

* ``model_flops`` and ``supported_shapes`` for every LM arch equal the
  reference's; ``input_specs`` (the decode cache included) and
  ``abstract_paged_cache`` have the reference's shapes and dtypes, at
  smoke and full size.
* ``jit_serve_step`` / ``jit_prefill_step`` / ``jit_train_step`` give the
  reference's spec trees on a (16, 16) mesh for the archs the port
  accepts there, apart from ROADMAP Queue 3's departures (the recurrent
  states, MLA's latents whole over ``model``).
* On a (2, 2) mesh (conftest's four host devices) a smoke decode, prefill
  and train cell's ``arg_bytes_per_device`` equals XLA's
  ``argument_size_in_bytes``; a train cell's FLOPs are held against
  XLA's within the band ``TRAIN_FLOPS_BAND``: the port counts the
  multiplies (matmuls, convolutions, attention: ``torch.utils.
  flop_counter`` and the kernels' reckonings), XLA every elementwise op
  too (PERF.md §6).
* The refused production cells are pinned, each with its item 8 reason;
  the accepted ones pass every build-time check; ``main`` reports a
  refused cell FAILED and exits 1, a traced one with every field.

``--all`` takes minutes on a CPU (deepseek-v3's train cell, 16
microsteps of 61 layers, the longest trace): ``chip_smoke.py`` phase
33(d) runs it."""
import dataclasses
import json
import os

import pytest

jax = pytest.importorskip("jax")

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.configs import supported_shapes as jshapes  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import scan_lib  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_config,  # noqa: E402
                                 get_smoke_config, supported_shapes)
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.core.qmodel import QuantContext, QuantMode  # noqa: E402
from repro_torch.core.tree import leaves, leaves_with_paths  # noqa: E402
from repro_torch.distributed import sharding as tshd  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch.mesh import RankMesh, make_production_mesh  # noqa: E402
from repro_torch.optim.schedule import warmup_cosine  # noqa: E402
from tests.test_torch_sharding_rules import (STATE_PARTS,  # noqa: E402
                                             _abstract_mesh, _cache_groups,
                                             _jflat, _latents_whole, _spec)
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

LM_ARCHS = [a for a in ARCH_IDS if a != "resnet_paper"]
# the production cells the port refuses (ROADMAP Queue 1 item 8, part 4:
# the sequence-cut cache for KV heads the model axis does not divide)
REFUSED_ARCHS = ("qwen3_1_7b", "llama3_2_1b", "qwen3_32b", "deepseek_67b",
                 "chameleon_34b", "granite_moe_3b_a800m", "whisper_large_v3")
REFUSED = {(a, s) for a in REFUSED_ARCHS
           for s in supported_shapes(get_config(a))}
ACCEPTED = {(a, s) for a in LM_ARCHS for s in supported_shapes(
    get_config(a))} - REFUSED
# the port's FLOPs of a smoke train cell over XLA's (see the docstring)
TRAIN_FLOPS_BAND = (0.4, 1.0)


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module, imported without keeping the
    512-device ``XLA_FLAGS`` it sets for a process of its own."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jd
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jd


def test_cells_and_model_flops_equal_reference(jdry):
    assert len(REFUSED) == 21 and len(ACCEPTED) == 11
    for arch in LM_ARCHS:
        cfg, jcfg = get_config(arch), jget(arch)
        assert supported_shapes(cfg) == jshapes(jcfg), arch
        for name in supported_shapes(cfg):
            assert TD.model_flops(cfg, SHAPES[name]) == jdry.model_flops(
                jcfg, jdry.SHAPES[name]), (arch, name)


def _shapes(tree, torch_tree: bool) -> list:
    if torch_tree:
        return sorted((tuple(t.shape), str(t.dtype).replace("torch.", ""))
                      for t in leaves(tree))
    return sorted((tuple(t.shape), str(t.dtype))
                  for t in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_input_specs_and_caches_equal_reference(arch, size):
    cfg = (get_smoke_config if size == "smoke" else get_config)(arch)
    jcfg = (jsmoke if size == "smoke" else jget)(arch)
    for name in supported_shapes(cfg):
        shape = SHAPES[name]
        if size == "smoke":
            shape = dataclasses.replace(shape, seq_len=64, global_batch=4)
        jshape = JShape(shape.name, shape.seq_len, shape.global_batch,
                        shape.kind)
        specs = S.input_specs(cfg, shape)
        assert all(t.device.type == "meta" for t in leaves(specs))
        assert _shapes(specs, True) == _shapes(JS.input_specs(jcfg, jshape),
                                               False), name
    if cfg.family in ("dense", "vlm"):
        assert _shapes(S.abstract_paged_cache(cfg, 6, 16), True) == \
            _shapes(JS.abstract_paged_cache(jcfg, 6, 16), False)
    else:
        with pytest.raises(NotImplementedError, match="paged serving"):
            S.abstract_paged_cache(cfg, 6, 16)


def _param_specs_equal(arch, tparams, tspec, jspec_tree):
    jspecs = _jflat(jspec_tree)
    cfg = get_config(arch)
    for (path, leaf), sp in zip(leaves_with_paths(tparams),
                                tshd.spec_list(tparams, tspec)):
        ref, _, lead = tshd.reference_leaf(tparams, path, tuple(leaf.shape),
                                           cfg)
        assert sp == _spec(jspecs[ref])[lead:], (arch, path)


@pytest.mark.parametrize("arch", sorted({a for a, _ in ACCEPTED}))
def test_step_spec_trees_equal_reference(arch):
    amesh = _abstract_mesh((16, 16), ("data", "model"))
    mesh = make_production_mesh()
    cfg, jcfg = get_config(arch), jget(arch)
    ctx = QuantContext(mode=QuantMode.FP)
    jparams = JS.abstract_params(jcfg)
    shape = SHAPES["decode_32k"]
    _, (tparams, cache_abs, p_spec, c_spec) = S.jit_serve_step(
        cfg, ctx, mesh, shape, fsdp=False)
    serve_specs = jshd.param_sharding_rules(jparams, amesh, fsdp=False,
                                            serve=True)
    _param_specs_equal(arch, tparams, p_spec, serve_specs)
    jcache = JS.abstract_cache(jcfg, shape.global_batch, shape.seq_len)
    jg, tg = _cache_groups(jshd.cache_sharding_rules(
        jcache, amesh, attn_kernel="flash"), c_spec)
    if cfg.mla is not None:
        jg = _latents_whole(jg)
    for part in STATE_PARTS:
        jg.pop(part, None)
        tg.pop(part, None)
    assert jg == tg
    _, (tparams, batch, p_spec) = S.jit_prefill_step(
        cfg, ctx, mesh, SHAPES["prefill_32k"], fsdp=False)
    _param_specs_equal(arch, tparams, p_spec, serve_specs)
    jbatch = JS.input_specs(jcfg, JShape("prefill_32k", 32768, 32,
                                         "prefill"))["batch"]
    assert {k: _spec(v) for k, v in JS.batch_specs_tree(
        jbatch, amesh).items()} == {k: _spec(v) for k, v in
                                    S.batch_specs_tree(batch, mesh).items()}
    opt = S.pick_optimizer(cfg)
    _, (tparams, opt_abs, p_spec, o_spec) = S.jit_train_step(
        cfg, ctx, mesh, opt, warmup_cosine(3e-4, 100, 10_000), fsdp=True)
    train_specs = jshd.param_sharding_rules(jparams, amesh, fsdp=True)
    _param_specs_equal(arch, tparams, p_spec, train_specs)
    # each moment takes its param's spec (ZeRO-1), adafactor's factored
    # (row, col) moments the prefixes, the reference's _opt_spec_like
    specs = tshd.spec_list(tparams, p_spec)
    assert o_spec.step == ()
    moments = _moment_specs(o_spec.v, p_spec)
    assert len(moments) == len(specs)
    for sp, m in zip(specs, moments):
        assert m in (sp, (sp[:-1], sp[:-2] + sp[-1:])), (arch, sp, m)
    with pytest.raises(NotImplementedError, match="item 8"):
        S.jit_serve_step(cfg, ctx, mesh, shape, fsdp=True)


def _moment_specs(moments, p_spec) -> list:
    """A moment tree's spec entries, one a param leaf (a factored pair
    as one entry), in the params' leaf order."""
    out = []

    def walk(m, p):
        if isinstance(p, dict):
            for k in p:
                walk(m[k], p[k])
        elif isinstance(p, list):
            for a, b in zip(m, p):
                walk(a, b)
        else:
            out.append(m)
    walk(moments, p_spec)
    return out


def _auto_mesh(sizes, names):
    try:
        from jax.sharding import AxisType
        return jax.make_mesh(sizes, names,
                             axis_types=(AxisType.Auto,) * len(sizes))
    except (ImportError, TypeError):
        return jax.make_mesh(sizes, names)


@pytest.fixture(scope="module")
def xla_cells(jdry):
    """(XLA's compiled artifact, the port's trace) of qwen3-1.7B's smoke
    decode, prefill and train cells on (2, 2), every scan unrolled in
    the reference's lowering (exact counts)."""
    jm = _auto_mesh((2, 2), ("data", "model"))
    out = {}
    for name in ("decode_32k", "prefill_32k", "train_4k"):
        with scan_lib.analysis_unroll():
            _, compiled, _ = jdry.lower_cell(
                "qwen3_1_7b", name, jm, cfg=jsmoke("qwen3_1_7b"))
        _, traced, _ = TD.lower_cell("qwen3_1_7b", name, RankMesh(2, 2),
                                     cfg=get_smoke_config("qwen3_1_7b"))
        out[name] = (compiled, traced)
    return out


@pytest.mark.parametrize("name", ["decode_32k", "prefill_32k", "train_4k"])
def test_arg_bytes_equal_xla_on_2x2(xla_cells, name):
    compiled, traced = xla_cells[name]
    assert traced.arg_bytes == \
        compiled.memory_analysis().argument_size_in_bytes


def test_train_flops_against_xla_on_2x2(xla_cells):
    compiled, traced = xla_cells["train_4k"]
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    ratio = traced.flops / float(cost["flops"])
    lo, hi = TRAIN_FLOPS_BAND
    assert lo <= ratio <= hi, ratio


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                          "2x16x16"])
def test_refused_cells_pinned(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    for arch, name in sorted(REFUSED):
        with pytest.raises(NotImplementedError, match="item 8") as e:
            TD.lower_cell(arch, name, mesh)
        kvh = get_config(arch).n_kv_heads
        assert f"KV head count ({kvh}" in str(e.value), (arch, name)
    for arch, name in sorted(ACCEPTED):
        cfg = get_config(arch)
        S._resolve_attn_kernel(cfg, mesh, train=SHAPES[name].kind ==
                               "train")


def test_main_reports_cells(tmp_path, capsys):
    out = tmp_path / "cells.json"
    assert TD.main(["--arch", "rwkv6_3b", "--shape", "long_500k",
                    "--json", str(out)]) == 0
    rec = json.loads(out.read_text())["records"][0]
    want = {"arch", "shape", "devices", "hlo_flops_per_device",
            "hlo_bytes_per_device", "collective_bytes_per_device",
            "t_compute_s", "t_memory_s", "t_collective_s", "dominant",
            "model_flops_global", "useful_flops_ratio",
            "temp_bytes_per_device", "arg_bytes_per_device", "multi_pod",
            "mode", "lower_compile_s", "accum_steps"}
    assert want <= set(rec) and rec["devices"] == 256
    assert rec["arg_bytes_per_device"] > 0 and rec["hlo_flops_per_device"] > 0
    assert TD.main(["--arch", "qwen3_1_7b", "--shape", "decode_32k"]) == 1
    assert "FAILED qwen3_1_7b x decode_32k" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        TD.main([])
