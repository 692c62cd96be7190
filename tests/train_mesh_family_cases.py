"""Training the ssm (rwkv6-3b), hybrid (zamba2-2.7b), audio
(whisper-large-v3) and moe (granite-moe-3b, deepseek-v3 with MLA)
families over a (data, model) mesh: the cases of
``tests/test_torch_train_mesh_families.py`` and the configurations of
``chip_smoke.py``'s phase 32, run by ``tests/train_mesh_cases.py``'s
runner (:func:`run_cases`, on every rank of a spawned mesh, and
``train_mesh_cases.run`` in one process).

Each spawned rank imports this module and ``repro_torch`` only.

* :data:`CASES` / :data:`ON_MESH`: the CPU test's cases (fp32 smoke
  configs, the JAX package's initial weights filled in by the test) and
  the mesh shapes each runs on: every family's train steps and one
  batch's gradients at (1, 2) and (2, 1), granite and zamba2 also at
  (2, 2); INT and FAKE at (1, 2); ``remat`` for zamba2 and whisper at (1, 2); FSDP at (2, 1) for
  zamba2 and granite at widths whose leaves the rules cut over ``data``;
  and granite's gradients over a batch whose expert 0 overflows a data
  shard's capacity (the router raised by :data:`SKEW`,
  :func:`skew_router`).
* :func:`chip_cfg`: a family at full width cut in depth
  (:data:`CHIP_LAYERS`), as phase 32 trains it on the card.
"""
try:                                    # as the tests import it
    from tests.train_mesh_cases import run, run_cases  # noqa: F401
except ImportError:                     # chip_smoke.py: tests/ on the path
    from train_mesh_cases import run, run_cases  # noqa: F401

RWKV, ZAMBA, WHISPER = "rwkv6_3b", "zamba2_2_7b", "whisper_large_v3"
GRANITE, DEEPSEEK = "granite_moe_3b_a800m", "deepseek_v3_671b"
ARCHS = (RWKV, ZAMBA, WHISPER, GRANITE, DEEPSEEK)
SHORT = {RWKV: "rwkv6", ZAMBA: "zamba2", WHISPER: "whisper",
         GRANITE: "granite", DEEPSEEK: "deepseek-v3"}

FP32 = {"dtype": "float32"}
# the router's column 0 raised by this much: expert 0 takes nearly every
# token, past a data shard's slice of its capacity (as tests/
# test_torch_moe_mesh.py raises it)
SKEW = 5.0
# 8 x 32 tokens: moe_capacity(256) = 128, a shard's 64 of 128 tokens
OVERFLOW_BATCH = 8

CASES = {}
for _a in ARCHS:
    _n = SHORT[_a]
    CASES[_n] = dict(kind="train", arch=_a, cfg=FP32)
    CASES[f"{_n} grads"] = dict(kind="grads", arch=_a, cfg=FP32)
    for _m in ("int", "fake"):
        CASES[f"{_n} {_m}"] = dict(kind="train", arch=_a, cfg=FP32,
                                   mode=_m, steps=2)
CASES.update({
    "zamba2 remat": dict(kind="train", arch=ZAMBA, cfg=FP32, remat=True),
    "whisper remat": dict(kind="train", arch=WHISPER, cfg=FP32, remat=True),
    # the reference's FSDP cuts a (stacked) leaf of 2^20 elements or
    # more: zamba2's shared MLP ((64, 16384) w1, w3 and its w2) and
    # granite's expert stacks ((2, 8, 64, 4096) w1, w3, w2)
    "zamba2 wide fsdp": dict(kind="train", arch=ZAMBA, fsdp=True,
                             cfg=dict(FP32, d_ff=16384)),
    "granite wide fsdp": dict(kind="train", arch=GRANITE, fsdp=True,
                              cfg=dict(FP32, moe={"d_expert": 4096})),
    "granite overflow grads": dict(kind="grads", arch=GRANITE, cfg=FP32,
                                   batch=OVERFLOW_BATCH, skew=True),
})
# the leaves FSDP cuts in each wide case
FSDP_LEAVES = {"zamba2 wide fsdp": 3, "granite wide fsdp": 3 * 2}

_EACH = [f"{SHORT[a]}{s}" for a in ARCHS for s in ("", " grads")]
ON_MESH = {
    (1, 2): _EACH + [f"{SHORT[a]} {m}" for a in ARCHS
                     for m in ("int", "fake")]
    + ["zamba2 remat", "whisper remat"],
    (2, 1): _EACH + ["zamba2 wide fsdp", "granite wide fsdp",
                     "granite overflow grads"],
    (2, 2): ["granite", "granite grads", "zamba2", "zamba2 grads",
             "granite overflow grads"],
}


def skew_router(tree, by: float = SKEW):
    """A copy of the JAX package's params ``tree`` (numpy leaves, the
    layers stacked) with every MoE layer's router column 0 raised by
    ``by``."""
    import copy
    out = copy.deepcopy(tree)
    out["blocks"]["moe"]["router"][..., 0] += by
    return out


# phase 32's depths: rwkv6-3b on 4 of its 32 layers, zamba2-2.7b on one
# group (6 of 54 Mamba blocks and the shared block), whisper-large-v3 on
# 2 + 2 of its 32 + 32 layers over its 1500 stub frames, granite-moe-3b
# on 4 of 32, deepseek-v3 on its first (dense, MLA) layer: one of its MoE
# layers holds 11.3 B expert parameters, whose AdamW state two ranks
# cannot hold on one card
CHIP_LAYERS = {RWKV: 4, ZAMBA: 6, WHISPER: 2, GRANITE: 4, DEEPSEEK: 1}


def chip_cfg(arch: str, dtype: str = "float32") -> dict:
    """``cfg`` overrides of ``arch``'s published config (``smoke=False``)
    as phase 32 trains it: :data:`CHIP_LAYERS` deep, ``dtype``, flash
    attention."""
    over = {"n_layers": CHIP_LAYERS[arch], "dtype": dtype,
            "attn_kernel": "flash"}
    if arch == WHISPER:
        over["encdec"] = {"n_encoder_layers": CHIP_LAYERS[arch]}
    if arch == DEEPSEEK:
        over["moe"] = {"n_dense_layers": 1}
    return over
