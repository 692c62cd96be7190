"""The MoE family (granite-moe-3b, and deepseek-v3 with MLA) on a (data,
model) mesh: the per-shard dispatch against the JAX package's ``moe``
with its ``data_shards()`` patched, and classic ``serve`` on spawned gloo
ranks against one rank, on the smoke configs in fp32:

* (1) the port's ``moe(data_shards=D)`` against the reference's ``moe``
  under ``data_shards() == D`` (``repro.models.mlp.data_shards``
  monkeypatched; outside a mesh its ``constrain`` is a no-op), D in {1, 2,
  4}, on the JAX smoke weights (the bridge), FP and INT, with a router
  that overflows expert 0 (its column raised by 5.0) and with the
  seed's, which overflows nothing: in INT every pair kept by both with
  the same expert reads the reference's expert output row before the
  combine bit for bit; the layer within ``tests/test_torch_moe.py``'s
  tolerances (INT within its 2e-6: the router's fp32 probabilities,
  which weigh those rows, may differ in the last bit; FP within atol
  1e-4, the outputs reaching 12),
  and under overflow D = 1, 2, 4 give different layers (by far more than
  the tolerance), as the reference's do;
* (2) classic ``serve`` (INT, calibrated INT, FP; flash attention) at (1,
  2), (2, 1), (2, 2) and, deepseek-v3 only (granite's 2 KV heads), (1, 4)
  on gloo ranks against one rank: tokens identical, every step's INT
  logits bit-identical, FP's within 1e-5 (the row-cut modules' and the
  2-D cut's fp32 partials summed in another order);
* (3) the overflowing MoE layer at (2, 1) and (2, 2), its hidden cut over
  ``data``: bit-identical in INT to the one-process ``data_shards=2``
  form (FP within atol 1e-4), which (1) holds to the patched reference;
* (4) K2's grouped form's new plain versions (the int32 output kind, the
  (E, D) count grid of the exchanged layout) against per-expert int64
  products, and a rank's int8 expert slices equal to the slices of the
  whole tree's codes;
* the training rank views of the ssm, hybrid, audio and moe families
  (their serving ones beside: the moe family's experts whole in their
  hidden), and the refusals: experts the model axis does not divide, a
  moe batch the data axis does not cut, and deepseek-v3 at full depth
  where the reference would turn FSDP on.

One spawn of two ranks and one of four (the cases of both mesh shapes on
the same ranks, ``tests/moe_mesh_cases.py``); this process runs the
one-rank cases meanwhile.
"""
import concurrent.futures
import copy
import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.core.qmodel import QuantContext as JCtx  # noqa: E402
from repro.core.qmodel import QuantMode as JMode  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.core import qmodel as tqmodel  # noqa: E402
from repro_torch.core.integer_ops import LinearQuantSpec  # noqa: E402
from repro_torch.core.qmodel import QuantContext, QuantMode  # noqa: E402
from repro_torch.core.tree import leaves_with_paths  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from tests import moe_mesh_cases as cases_lib  # noqa: E402
from tests.test_torch_recurrent_blocks import tcfg_of  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

GRANITE, DEEPSEEK = "granite_moe_3b_a800m", "deepseek_v3_671b"
ARCHS = [GRANITE, DEEPSEEK]
FP32 = {"dtype": "float32", "kv_cache_bits": 8}
SERVE = dict(batch=4, prompt_len=12, gen=5, attn_kernel="flash",
             cfg_overrides=FP32)
# the MoE layer's inputs: 4 x 160 tokens, whose capacity (256, cut into
# D slices) expert 0 overflows under the raised router column
LAYER_B, LAYER_S, SKEW = 4, 160, 5.0
INT_TOL = dict(atol=2e-6, rtol=2e-6)       # tests/test_torch_moe.py's
FP_TOL = dict(atol=1e-4, rtol=1e-5)        # its overflowing layer's
FP_LOGITS_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def jax_layer(arch):
    """The JAX smoke weights' first MoE layer (fp32), as numpy."""
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jax.tree.map(lambda a: np.asarray(a[0]),
                              jp["blocks"]["moe"])


def layer_inputs(arch, skew: bool):
    """(the layer's params with the router raised or not, x)."""
    jcfg, p = jax_layer(arch)
    p = jax.tree.map(np.copy, p)
    if skew:
        p["router"][:, 0] += SKEW
    x = np.random.default_rng(30).standard_normal(
        (LAYER_B, LAYER_S, jcfg.d_model)).astype(np.float32)
    return p, x


def t_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def jax_moe(arch, mode, p, x, d):
    """The reference's ``moe`` with ``data_shards()`` patched to ``d``:
    (its output, its experts' (E, C, d) output buffer before the
    combine, ``w2``'s product)."""
    jcfg, _ = jax_layer(arch)
    base = jmlp._qexpert

    def layer(p, x):
        seen = {}

        def watched(ctx, name, a, w):
            seen[name] = base(ctx, name, a, w)
            return seen[name]

        with mock.patch.object(jmlp, "_qexpert", watched):
            out = jmlp.moe(JCtx(mode=JMode(mode)), p, x, jcfg)
        return out, seen["moe/w2"]

    with mock.patch.object(jmlp, "data_shards", lambda: d):
        out, buf = jax.jit(layer)(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x))
    return np.asarray(out), np.asarray(buf)


def port_moe(arch, mode, p, x, d):
    """The port's ``moe(data_shards=d)``: (its output, its experts'
    (E, C, d) output buffer before the combine)."""
    jcfg, _ = jax_layer(arch)
    base, seen = tmlp._expert_ffn, []

    def watched(*args, **kwargs):
        seen.append(base(*args, **kwargs))
        return seen[-1]

    with torch.no_grad(), mock.patch.object(tmlp, "_expert_ffn", watched):
        out = tmlp.moe(QuantContext(mode=QuantMode(mode)), t_tree(p),
                       torch.from_numpy(x), tcfg_of(jcfg), data_shards=d)
    return out, seen[0]



@functools.partial(jax.jit, static_argnums=(2, 3))
def jax_keep(xt, router, m, d):
    """The reference's routing and shard-local ranking lines
    (``repro/models/mlp.py:136-156`` under ``data_shards() == d``): each
    pair's expert, whether its shard keeps it, and its rank there."""
    cap_local = -(-jmlp.moe_capacity(xt.shape[0], m) // d)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ router, axis=-1)
    _, top_e = jax.lax.top_k(probs, m.top_k)
    flat_e = top_e.reshape(d, -1)
    one_hot = jax.nn.one_hot(flat_e, m.e_padded, dtype=jnp.int32)
    rank = jnp.sum(jnp.cumsum(one_hot, axis=1) * one_hot, axis=-1) - 1
    return flat_e, rank < cap_local, rank


def same_pair_rows(arch, p, x, d, got_buf, want_buf) -> int:
    """Every pair that both the port and the reference keep with the same
    expert reads the same row of its experts' output before the combine,
    bit for bit (each at its own slot, ``e * C + shard * cap_l + rank``);
    returns how many pairs were compared."""
    jcfg, _ = jax_layer(arch)
    m = tcfg_of(jcfg).moe
    t = LAYER_B * LAYER_S
    xt = x.reshape(t, -1)
    _, top_e = tmlp.route(torch.from_numpy(xt),
                          torch.from_numpy(p["router"]), m.top_k)
    cap_l = -(-tmlp.moe_capacity(t, m) // d)
    flat_e = top_e.reshape(d, -1)
    rank, keep, _ = tmlp.rank_pairs(flat_e, m.e_padded, cap_l)
    j_e, j_keep, j_rank = (np.asarray(a) for a in jax_keep(
        jnp.asarray(xt), jnp.asarray(p["router"]), jcfg.moe, d))
    shard = np.arange(d)[:, None] * cap_l
    slot = flat_e.numpy() * cap_l * d + shard + rank.numpy()
    j_slot = j_e * cap_l * d + shard + j_rank
    both = keep.numpy() & j_keep & (flat_e.numpy() == j_e)
    got = got_buf.reshape(-1, got_buf.shape[-1]).numpy()[slot[both]]
    want = want_buf.reshape(-1, want_buf.shape[-1])[j_slot[both]]
    np.testing.assert_array_equal(got, want)
    return int(both.sum())


def same_drops(arch, p, x, d) -> int:
    """The port's per-shard ranking keeps exactly the reference's pairs,
    and picks the reference's experts but where a pair weighs under 1e-6
    (the raised router's runners-up, whose probabilities underflow to
    near-ties); returns how many pairs it drops."""
    jcfg, _ = jax_layer(arch)
    m = tcfg_of(jcfg).moe
    t = LAYER_B * LAYER_S
    xt = x.reshape(t, -1)
    top_p, top_e = tmlp.route(torch.from_numpy(xt),
                              torch.from_numpy(p["router"]), m.top_k)
    cap_l = -(-tmlp.moe_capacity(t, m) // d)
    _, keep, _ = tmlp.rank_pairs(top_e.reshape(d, -1), m.e_padded, cap_l)
    j_e, j_keep, _ = jax_keep(jnp.asarray(xt), jnp.asarray(p["router"]),
                              jcfg.moe, d)
    other = top_e.reshape(-1).numpy() != np.asarray(j_e).reshape(-1)
    assert (top_p.reshape(-1).numpy()[other] < 1e-6).all()
    assert np.array_equal(keep.numpy(), np.asarray(j_keep))
    return int((~keep).sum())


@pytest.mark.parametrize("mode", ["fp", "int"])
@pytest.mark.parametrize("arch", ARCHS)
def test_per_shard_dispatch_matches_patched_reference(arch, mode):
    """Each shard keeps exactly the reference's pairs; in INT every pair
    kept by both with the same expert reads the reference's expert output
    row before the combine bit for bit; the layer within the tolerances
    of ``tests/test_torch_moe.py`` (INT's 2e-6 under the seed's router;
    under the raised one its logits reach about 40, whose fp32 last bits,
    summed in XLA's order by the reference and rounded from float64 by
    the port, move the probabilities by about 1e-5 relative: the
    ``top_p``-weighted combine within FP's atol 1e-4 there)."""
    outs = {}
    for skew in (False, True):
        p, x = layer_inputs(arch, skew)
        for d in (1, 2, 4):
            got, got_buf = port_moe(arch, mode, p, x, d)
            want, want_buf = jax_moe(arch, mode, p, x, d)
            np.testing.assert_allclose(
                got.numpy(), want, err_msg=f"{arch} {mode} skew {skew} "
                f"D={d}", **(INT_TOL if mode == "int" and not skew
                             else FP_TOL))
            if mode == "int":
                assert same_pair_rows(arch, p, x, d, got_buf, want_buf) > 0
            outs[skew, d] = got
            assert (same_drops(arch, p, x, d) > 0) == skew, (skew, d)
    for d in (2, 4):
        # without overflow the shards' ranking is the one-shard one
        assert torch.equal(outs[False, d], outs[False, 1])
        # with it each shard drops its own pairs: a different layer
        assert (outs[True, d] - outs[True, 1]).abs().max() > 0.5
    assert (outs[True, 4] - outs[True, 2]).abs().max() > 0.5


def test_grouped_plain_versions_against_int64():
    gen = torch.Generator().manual_seed(31)
    e, d_, cap_l, k, n = 5, 3, 8, 48, 24
    c = d_ * cap_l
    x = torch.randint(-128, 128, (e, c, k), generator=gen,
                      dtype=torch.int32).to(torch.int8)
    w = torch.randint(-128, 128, (e, k, n), generator=gen,
                      dtype=torch.int32).to(torch.int8)
    grid = torch.randint(0, cap_l + 3, (e, d_), generator=gen,
                         dtype=torch.int32)
    grid[0] = 0
    rows_cap = cap_l - 2
    want = torch.einsum("eck,ekn->ecn", x.to(torch.int64), w.to(torch.int64))
    live = torch.zeros(e, c, dtype=torch.bool)
    for i in range(e):
        for s in range(d_):
            r = min(int(grid[i, s]), rows_cap)
            live[i, s * cap_l:s * cap_l + r] = True
    want = torch.where(live[..., None], want, 0)
    got = tops.int8_matmul_grouped_partial(x, w, grid, rows_cap=rows_cap)
    assert got.dtype == torch.int32 and torch.equal(got.to(torch.int64),
                                                    want)
    spec = LinearQuantSpec(n_x=4, n_w=8, n_b=8, n_o=3)
    for out_float in (None, torch.bfloat16):
        codes = tops.int8_matmul_grouped(x, w, grid, spec, rows_cap=rows_cap,
                                         out_float=out_float)
        fin = tref.int8_matmul_finish_ref(
            want.to(torch.int32).reshape(-1, n), None,
            shift=spec.requant_shift,
            out_dtype=out_float or torch.int8,
            n_o=spec.n_o if out_float else None).reshape(e, c, n)
        assert torch.equal(codes, torch.where(live[..., None], fin, 0))
    # one segment: the (E,) counts, the old layout, rows_cap C
    flat = tops.int8_matmul_grouped_partial(x, w, grid[:, 0])
    one = torch.zeros(e, c, dtype=torch.bool)
    for i in range(e):
        one[i, :min(int(grid[i, 0]), c)] = True
    assert torch.equal(flat, torch.where(one[..., None], torch.einsum(
        "eck,ekn->ecn", x.to(torch.int64), w.to(torch.int64)), 0).to(
        torch.int32))
    assert not any(tops.LAUNCHES.values())
    assert not any(tops.FORM_LAUNCHES.values())


def test_rank_slices_quantize_to_the_whole_codes():
    """A rank's expert slices (2-D cut at (2, 2)) quantize to the slices
    of the whole tree's codes: an expert stack's grid is its module's
    table entry, never its values'."""
    cfg = dataclasses.replace(tsmoke(DEEPSEEK),
                              dtype="float32")
    params = TM.init_params(cfg, 0, device="cpu")
    ctx = QuantContext(mode=QuantMode.INT, table={
        "moe/w1": tqmodel.ModuleBits(n_w=9), "mla/wo": tqmodel.ModuleBits(
            n_w=7)})
    name_fn = functools.partial(TM.qlinear_weight, cfg=cfg)
    whole = tqmodel.quantize_weight_tree(params, ctx, name_fn=name_fn)
    mesh = tmesh.RankMesh(2, 2)
    for rank in range(4):
        coords = {"data": rank // 2, "model": rank % 2}
        want = shd.shard_params(whole, mesh, coords, cfg=cfg)
        got = tqmodel.quantize_weight_tree(
            shd.shard_params(params, mesh, coords, cfg=cfg), ctx,
            name_fn=name_fn)
        for (path, a), (_, b) in zip(leaves_with_paths(want),
                                     leaves_with_paths(got)):
            assert a.dtype == b.dtype and torch.equal(a, b), (rank, path)
    w1 = shd.shard_params(whole, mesh, {"data": 1, "model": 1},
                          cfg=cfg)["blocks"][0]["moe"]["w1"]
    assert tuple(w1.shape) == (4, cfg.d_model, cfg.moe.d_expert // 2)


# ---------------------------------------------------------------------------
# classic serve and the layer on gloo ranks
# ---------------------------------------------------------------------------

def serve_case(arch, mode, calibrate=False, **extra):
    return dict(SERVE, kind="serve", arch=arch, mode=mode,
                calibrate=calibrate, **extra)


def serve_cases() -> dict:
    named = {(arch, mode): serve_case(arch, mode)
             for arch in ARCHS for mode in ("fp", "int")}
    named[GRANITE, "int calibrated"] = serve_case(GRANITE, "int",
                                                  calibrate=True)
    return named


def layer_case(arch, mode):
    p, x = layer_inputs(arch, skew=True)
    return dict(kind="layer", arch=arch, mode=mode, p=t_tree(p),
                x=torch.from_numpy(x), cfg_overrides={"dtype": "float32"})


def on_ranks(world, rank_cases, tmp_path):
    """``rank_cases`` on every rank of a spawned world of ``world`` ranks
    ([rank][case]); a future, so this process works meanwhile."""
    cases = copy.deepcopy(rank_cases)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(tmesh.run_ranks, cases_lib.run_cases, (world, 1),
                      device="cpu", backend="gloo",
                      kwargs={"cases": cases}, workdir=str(tmp_path),
                      threads=1)
    pool.shutdown(wait=False)
    return fut


@pytest.fixture(scope="module")
def one_rank() -> dict:
    """Each serve case's one-rank result and each layer case's
    one-process ``data_shards=2`` form, made once a module."""
    return {}


def one_rank_of(one_rank, key, case):
    if key not in one_rank:
        if case["kind"] == "layer":
            case = dict(case, data_shards=2)
        one_rank[key] = cases_lib.run(case, device="cpu")
    return one_rank[key]


def held_serve(name, one, got):
    exact = "int" in name[1]
    for r, res in enumerate(got):
        what = (name, r)
        assert np.array_equal(res["tokens"], one["tokens"]), what
        assert res["table"] == one["table"], what
        assert len(res["logits"]) == len(one["logits"]) == SERVE["gen"]
        for step, (a, b) in enumerate(zip(res["logits"], one["logits"])):
            if exact:
                assert torch.equal(a, b), (what, step)
            else:
                err = (a - b).abs().max().item()
                assert err <= FP_LOGITS_TOL, (what, step, err)


def held_layer(name, one, got):
    for r, res in enumerate(got):
        if name[1] == "int":
            assert torch.equal(res["out"], one["out"]), (name, r)
        else:
            np.testing.assert_allclose(res["out"].numpy(),
                                       one["out"].numpy(), err_msg=str(name),
                                       **FP_TOL)


def test_mesh_two_ranks(one_rank, tmp_path):
    """(1, 2) and (2, 1) on the same two ranks: serve both archs, then
    the overflowing layer at (2, 1)."""
    named = serve_cases()
    layers = {(arch, mode): layer_case(arch, mode)
              for arch in ARCHS for mode in ("fp", "int")}
    rank_cases = ([dict(c, model_axis=2) for c in named.values()]
                  + [dict(c, model_axis=1) for c in named.values()]
                  + [dict(c, model_axis=1) for c in layers.values()])
    fut = on_ranks(2, rank_cases, tmp_path)
    ones = {k: one_rank_of(one_rank, k, c) for k, c in named.items()}
    lay = {k: one_rank_of(one_rank, ("layer",) + k, c)
           for k, c in layers.items()}
    ranks = fut.result(timeout=600)
    n = len(named)
    for i, name in enumerate(named):
        held_serve(name, ones[name], [r[i] for r in ranks])          # (1, 2)
        held_serve(name, ones[name], [r[n + i] for r in ranks])      # (2, 1)
    for j, name in enumerate(layers):
        held_layer(name, lay[name], [r[2 * n + j] for r in ranks])


def test_mesh_four_ranks(one_rank, tmp_path):
    """(2, 2) on four ranks (both archs, serve and the overflowing
    layer), then (1, 4) (deepseek-v3: 4 heads, 8 experts)."""
    named = serve_cases()
    layers = {(arch, mode): layer_case(arch, mode)
              for arch in ARCHS for mode in ("fp", "int")}
    wide = {k: v for k, v in named.items() if k[0] == DEEPSEEK}
    rank_cases = ([dict(c, model_axis=2) for c in named.values()]
                  + [dict(c, model_axis=2) for c in layers.values()]
                  + [dict(c, model_axis=4) for c in wide.values()])
    fut = on_ranks(4, rank_cases, tmp_path)
    ones = {k: one_rank_of(one_rank, k, c) for k, c in named.items()}
    lay = {k: one_rank_of(one_rank, ("layer",) + k, c)
           for k, c in layers.items()}
    ranks = fut.result(timeout=600)
    n, nl = len(named), len(layers)
    for i, name in enumerate(named):
        held_serve(name, ones[name], [r[i] for r in ranks])
    for j, name in enumerate(layers):
        held_layer(name, lay[name], [r[n + j] for r in ranks])
    for i, name in enumerate(wide):
        held_serve(name, ones[name], [r[n + nl + i] for r in ranks])


def test_refusals():
    # the ssm, hybrid and audio families serve on (1, 2) (their rank view:
    # the attention's heads and the MLP hidden halved, d_model whole;
    # RWKV6 has no attention), and train there on the same view
    for arch in ("rwkv6_3b", "zamba2_2_7b", "whisper_large_v3"):
        cfg, shape = tserve._resolve_cfg_mesh(arch, smoke=True,
                                              mesh_shape=(1, 2))
        loc = shd.local_config(cfg, tmesh.RankMesh(*shape))
        cut = 1 if arch == "rwkv6_3b" else 2
        assert (loc.n_heads, loc.n_kv_heads, loc.d_ff, loc.d_model) == (
            cfg.n_heads // cut, cfg.n_kv_heads // cut, cfg.d_ff // 2,
            cfg.d_model)
        assert shd.local_config(cfg, tmesh.RankMesh(*shape),
                                train=True) == loc
    # the moe family trains under training's rules: on (1, 2) the experts
    # over model, on (2, 1) every expert whole on each rank, where
    # serving's 2-D rule cuts each one's hidden over data
    view = shd.local_config(tsmoke(GRANITE), tmesh.RankMesh(1, 2),
                            train=True)
    assert (view.moe.expert_shards, view.moe.hidden_shards) == (2, 1)
    cfg = tsmoke(DEEPSEEK)
    tsteps.build_train_step(cfg, QuantContext(), tsteps.pick_optimizer(cfg),
                            lambda s: 1e-3, mesh=tmesh.RankMesh(2, 1))
    view = shd.local_config(cfg, tmesh.RankMesh(2, 1), train=True)
    assert (view.moe.expert_shards, view.moe.hidden_shards) == (1, 1)
    assert shd.local_config(cfg, tmesh.RankMesh(2, 1)).moe.hidden_shards \
        == 2
    # the reference serves deepseek-v3's 61 layers on (1, 2) with FSDP
    with pytest.raises(NotImplementedError, match="item 8"):
        tserve._resolve_cfg_mesh(DEEPSEEK, smoke=False, mesh_shape=(1, 2))
    cut = dataclasses.replace(get_config(DEEPSEEK), n_layers=4)
    tsteps._resolve_attn_kernel(cut, tmesh.RankMesh(1, 2))
    # experts the model axis does not divide (the rules' fall-back), under
    # serving's rules and training's
    for train in (False, True):
        with pytest.raises(NotImplementedError, match="item 8"):
            shd.local_config(dataclasses.replace(
                cfg, n_heads=6, n_kv_heads=6), tmesh.RankMesh(1, 3),
                train=train)
    # a data axis that does not cut the moe batch (3 rows on 2 ranks)
    mcfg = shd.local_config(tsmoke(GRANITE),
                            tmesh.RankMesh(2, 1))
    p = TM.init_params(tsmoke(GRANITE), 0,
                       device="cpu")["blocks"][0]["moe"]
    with shd.activation_sharding(tmesh.RankMesh(2, 1)), \
            pytest.raises(NotImplementedError, match="item 8"):
        tmlp.moe(QuantContext(), p, torch.zeros(3, 4, mcfg.d_model), mcfg)
