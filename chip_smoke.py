#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--only 6,7]

(``--only`` runs the build and the named phases alone, for iterating on
a kernel or a path; the check is the run without it.)

Run from a checkout of the repository on a machine with a CUDA device and
the CUDA toolkit.  Phases, one line each (or a few):

1. device: the card's name and power limit, the build of every CUDA
   kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per source, in
   parallel), and the launch floor: the device time of a one-element K3
   launch and of a one-element PyTorch ``add_``, timed as every kernel;
2. K2 (int8 shift-requant matmul) against its plain PyTorch version on the
   card, bit-exact: its epilogue variants, then a grid of M in {1, 4, 8,
   16, 23, 24, 25, 64, 127, 128} x every serving (K, N) and the split-K
   boundary shapes, and large-M shapes on every tile, x int8 / uint8
   activations x four epilogue variants;
   at the serving path's shapes each with its tile and K splits, and the
   kernel's, the plain version's and ``torch._int_mm``'s times beside the
   bound;
3. K1 (ragged paged attention) against its plain version on a mixed
   work-list, int8 and bf16 pools, with padding rows exactly 0; a grid of
   work-lists (decode-only with kv_len on and beside the split
   boundaries, prefill-only, speculative tails, mixed) x GQA 1/2/4/16 x
   D 64/128 (and 100, 256 on the mixed list) x blocks of 16/128 rows x
   both q types and pool types, with padding rows and slots; the mixed work-list timed (its work list
   planned once, as the engine plans it); and a long case at qwen3-1.7B's
   heads (a decode row over 32768 positions, a 16-row chunk over 4096
   resident rows, two short decodes), held row by row at a tolerance a
   repeated pool block fails, timed beside its bound;
4. model: a two-step mixed ``ragged_step`` of qwen3-1.7B at full width and
   2 layers in fp32, kernels on the card against the plain path on the
   CPU, in FP and INT mode;
5. engine: ``serve_engine`` at full depth in bf16, FP and INT mode, with
   the kernel launch counts of each run (K3 141 a step in INT: four module
   inputs and the K/V write a layer and the LM head's input; 28 in FP, the
   K/V write), and a repeat run that must give the same greedy tokens;
6. K5 (flash prefill over a dense cache) against its plain version at the
   classic path's shapes, over a grid of GQA groups, head dims (one
   zero-padded), query counts and cache tails on both of its paths (bf16
   q on the tensor cores, fp32 q on the CUDA cores), and at one long
   prefill (held row by row, at a tolerance a repeated kv tile fails),
   with the kernel's, the plain version's and
   ``scaled_dot_product_attention``'s times;
7. K6 (split-KV flash decode, its position a device int32 and its splits
   planned for the cache length) the same way: a grid of GQA groups, head
   dims and cache types at positions 0, on and beside split boundaries
   and 32767 of a 32768-row cache, the path's positions, and one long
   int8 cache at positions 100 (most planned splits empty) and 32767;
   one launch captured in a CUDA graph and replayed after new positions
   are written into its staged int32, each replay equal to the plain
   version there; timed at the path's shape and both long positions;
8. Algorithm-1 calibration of qwen3-1.7B at full width and 2 layers on
   the card and on the CPU: the tables must agree, apart from declared
   near-ties (the run order is 1-3, 6, 7, 10, 15, 4, 5, 11, 16-18, 8,
   9, 30a's card side, 20, 22, 12-14, 19, 21, 23-33: the CPU's
   calibration runs on a background thread beside 4, 5, 11 and 16-18, as
   30a's CPU side and 26b's CPU steps do beside 20 and 22, and phase
   33's two dry runs in processes of their own beside 4, 5, 11, 16-18,
   8, 9, 30a's card side, 20 and 22, phases that time nothing; every
   other phase waits for that thread to be idle and the dry runs to end,
   so no kernel, step or profile is timed beside them);
9. the 2-layer dense model (prefill + 3 decode steps, flash attention)
   on the card against the CPU: INT with an int8 cache (identical), FP
   with an fp32 cache (phase 4's FP rule) and FP with an int8 cache, with
   K5 / K6 launch counts;
10. classic ``serve`` at full depth in bf16 with flash attention: INT with
    calibration and an int8 cache, FP with a bf16 cache, each with its
    decode steps captured (the first eager, the second captured, the rest
    replayed) and eagerly, in turns (graphs, eager, graphs, eager): all
    four token-identical, with the launch counts of every kernel, the
    decode ms/token of the replays and of eager, the first call plus
    capture, and peak memory;
11. the W8A8 engine (``serve_engine(w8a8=True)``) at full depth, twice,
    K3 141 a step;
12. K3 (Eq.-1 quantize) and K7 (residual requant, standalone) against
    their plain versions, bit-exact, at the ResNet path's shapes and one
    64M-element shape; the convolution kernel (``csrc/int_conv.cu``,
    implicit GEMM with K7's arithmetic as its residual epilogue) bit-exact
    against its plain version and against the im2col + K2 (+ K7) chain it
    replaced at every convolution of the path (batch 256), through K2's
    four epilogue variants and the residual epilogue with an int8 and a
    uint8 shortcut on two grids (one saturating), and on odd cases (batch
    1, size 7, the stem alone, Cout 8 / 10 / 96, misaligned operands); each
    path convolution timed in its path form (the kernel, the old chain,
    the plain version), conv2 also without its residual epilogue, beside
    its bound, with its tile;
13. Algorithm-1 calibration of the paper's ResNet (``resnet_paper``
    CONFIG width, batch 64) on the card and on the CPU: the tables must
    agree, apart from declared near-ties;
14. the ResNet's integer forward at batch 256 on the card against the
    CPU's plain path: identical logits, exactly 15 convolution kernel, 1
    K2 (the head), 0 K7 and 2 K3 launches, twice cold with identical
    logits, then five warm forwards (median and spread on the host clock,
    images per second) and one forward's device time (CUDA events);
15. K4 (paged attention over the KV block pool, on the work list its
    positions plan) against its plain version and its split-and-combine
    twin over a grid of query counts, GQA groups, pool types, head dims
    and block sizes (shuffled tables with trash tails, a padded slot, the
    speculative step's extra trash column); split cases (positions before,
    at and after the 512-row split edge and 4095, head dims 12, 100 and
    128, bf16 and fp32 q) and a 16-query chunk with a planned chunk edge
    among its rows; the legacy engine's decode, prefill-chunk and verify
    shapes and one long int8 cache (held row by row, at a tolerance a
    repeated pool block fails), and zamba2-2.7b's shared block in the
    recurrent engine's (4, 64) step (32 heads, GQA 1, head dim 80, padded
    positions on the trash column; a mixed and a decode step over a bf16
    and an int8 pool), each with its items and chunks and the kernel's,
    the plain version's and gather + dequantize + SDPA's times beside its
    bound;
16. ``paged_step`` of qwen3-1.7B at full width and 2 layers in fp32, the
    decode, prefill-chunk and (4, 4) verify shapes, kernels on the card
    against the plain path on the CPU, in phase 9's three cases: INT with
    an int8 pool and FP with an fp32 pool under phase 4's rules, FP with
    an int8 pool under phase 9's (every pool block but the trash block
    compared);
17. the legacy per-shape engine (``serve_engine(ragged=False)``) at full
    depth in bf16, FP and INT, twice each (token-identical repeats), with
    K4 = 28 x its dispatches, K1 = 0 and K2 = 197 a dispatch in INT; then
    the ragged engine once, and speculative decoding (``spec_k=3``) on the
    legacy and the ragged engine (K1 = 28 x ragged steps, K4 = 0 there),
    with tokens/s, TTFT, TPOT and the acceptance rate, every speculative
    run token-identical to the same engine's non-speculative run; for each
    request on which the two engines' plain runs differ, the top-2 logit
    margin (in bf16 ulps) at the first divergent token, from the classic
    dense prefill of the agreed prefix (printed, not gated);
18. the engine's observability on phase 5's workload (at full width on
    ``ENGINE_LAYERS``, 8 of qwen3-1.7B's 28 layers): the ragged INT engine with obs off and with ``trace=True, slo=True`` and a
    metrics export, interleaved (off, on, on, off) for tokens/s, TPOT and
    TTFT, every run token-identical with the same launches; an obs-on
    INT and W8A8 run each held to K1 = 14 x steps and K2 = 99 x steps,
    a clean schema diff and Chrome trace (one dispatch span a step), the
    energy proxy reconciled exactly with the hwcost counters, and the
    requant ops performed (and, W8A8, forward) equal to the rows each
    step's descriptors scatter into the pool, counted independently;
    the trace's split of the run's wall time into dispatch spans by shape
    and the host time between them; a ``record=True`` run of the legacy
    engine with ``spec_k=3`` (INT) and of the ragged engine (FP), each
    through the JSON round trip and replayed on a fresh engine with
    identical tokens, an empty decision diff and a matching fingerprint;
    and a ``profile_dir`` run whose ``torch.profiler`` trace holds one
    ``ragged_step#N`` annotation per dispatch, each with K1's launches
    inside, and as many K1 kernels as the engine counted;
19. the compiled serving step: phase 5's workload (at ``ENGINE_LAYERS``,
    as phase 18) on the ragged engine (FP, INT, W8A8, INT with ``spec_k=3``, INT sampled at temperature 0.8
    and top-k 50) and the legacy engine (INT, INT with ``spec_k=3``),
    each with CUDA graphs (the engines' default on the card) and with
    ``graphs=False``, cold (a fresh engine) and warm (the same engine
    again after ``reset_metrics``), in turns: identical tokens and kernel
    launches in all four runs; cold, each key's first call eager and every
    other call a replay, warm every call a replay, each key captured once;
    tokens/s, TPOT and TTFT p50, the trace's split into dispatch spans and
    host time between them, first calls, captures, replays and peak memory
    of each run; and the busy share of a profiled warm INT run without
    graphs (``launch/profile_engine.py::profile_run``, at full depth), its
    kernels, copies and fills a dispatch, the K1 kernels of
    ``key_averages()`` equal to those of the profiler's Kineto events and
    to the engine's count (phase 18 holds a graph run's K1 count to its
    profile; the comment at the check says why a profiled graph run is
    not held so).
20. the recurrent and hybrid substrate: ``paged_recurrent_step`` of
    rwkv6-3b (2 layers) and zamba2-2.7b (one group: 6 Mamba blocks and the
    shared block) at full width in fp32, two (4, 64) steps with an idle
    lane, kernels on the card against the plain path on the CPU, FP and
    INT x fp32 and int8 slabs (zamba2's pool int8 with int8 slabs); then
    ``serve_engine`` at full width in bf16 (``REC_DEPTH`` of the layers:
    16 of rwkv6-3b's 32, 30 of zamba2-2.7b's 54) on phase 5's workload with
    chunk 64 (rwkv6-3b FP, FP with int8 slabs, INT; zamba2-2.7b FP on a
    bf16 pool, FP with int8 pool and slabs, INT), each with CUDA graphs and
    eagerly, cold and warm, in turns: identical tokens and launches, K1 0,
    K4 = 5 x dispatches on zamba2 (0 on rwkv6), K2 = 129 / 101 a dispatch
    in INT at that depth, one step key (first calls + replays = dispatches), the state
    requant ops equal to one slab's elements (from the arenas) x the
    dispatches' live rows (counted on the host side of the dispatch), with
    tokens/s, TTFT and TPOT p50, peak memory and the slabs' bytes; and
    rwkv6-3b on 3 slabs for 4 slots and with a forced mid-decode snapshot
    preemption, both on the full-slab run's tokens.
21. K3 as the LM path's quantizer and K2's float epilogue: K3's multi-grid
    form (one read, codes on up to three grids) bit-exact against its
    plain version over rows {1, 23, 24, 25, 256, 4096} x widths {1024,
    2048, 6144} (and two odd widths) x bf16 / fp32 x one to three grids of
    -2 / 0 / 4 / 8 / 12 with repeats, aligned and misaligned; its
    quantize-and-scatter form (K and V to their pool rows, int32 / int64
    rows, padding rows colliding on the trash rows, each code there one of
    theirs) over the same rows and
    widths; K2's float epilogue (bf16, fp32) against ``dequant`` of its
    own codes at every serving (K, N) and a dp4a-tile N, M {1, 24, 256},
    through the mma, split-K finish and dp4a stores; qwen3-1.7B INT at
    full width (2 layers, bf16) through the package's wiring and through
    the old chain (``quant`` -> K2 codes -> ``dequant``; ``quant`` +
    ``index_copy_``) the phase builds itself: every module output, the
    logits and the pools identical; and each K3 form and K2's float
    epilogue timed at the engine step's shapes beside the plain version,
    the chain it replaced and the bound.
22. the paper's dense configurations and its scaling-factor baseline:
    llama3.2-1B at full width and depth (1.24 B parameters, tied
    embeddings, head dim 64, 4 query heads a KV head) through classic
    ``serve`` (INT, calibrated, int8 cache) with its decode steps
    captured, the ragged engine on phase 5's workload in FP and INT (phase
    5's launch formula, the tied LM head's weight quantized once a step)
    and a FAKE_SF classic ``serve``; its 2-layer full-width fp32 model
    card against CPU in phase 9's cases and FAKE_SF over an fp32 cache
    module by module under phase 9's FP rule (end to end its per-tensor
    grids turn the devices' last-bit differences into code flips);
    ``scale_quant`` card against CPU bit for bit
    on full-width fp32 and bf16 activations; qwen3-32B, deepseek-67B and
    chameleon-34B (family ``vlm``) at full width with ``n_layers`` cut to
    2 (their bf16 weights at full depth, printed, would not leave room to
    serve), one ragged INT engine run each, tokens in range and launches
    by phase 5's formula.
23. the recurrent families' classic path: (a) rwkv6-3b (2 layers) and
    zamba2-2.7b (one group, its dense cache int8) at full width in fp32,
    ``prefill`` of the (4, 32) prompt and 3 ``decode_step`` calls, kernels
    on the card against the plain path on the CPU, each step from the
    card's state: FP logits within 2e-4 and tokens identical, INT module
    by module identical; (b) classic ``serve`` of both at ``REC_DEPTH`` in
    bf16 (flash attention, zamba2 over an int8 cache), calibrated INT and
    FP, graphs and eager in turns as phase 10: tokens identical, launches
    by ``_rec_serve_want`` (K2 129 / 101 a forward, K5 5 a zamba2 forward
    and 5 for INT's calibration forward, K6 5 a decode step), calibration
    and prefill seconds, decode ms/token replayed and eager, peak memory;
    (c) ``serve_engine`` of both at ``REC_DEPTH`` on phase 20's workload,
    int8 slabs (and pool), calibrated INT and ``w8a8=True`` cold and warm:
    W8A8 token-identical to INT, K2 by ``_rec_per_dispatch``; (d) the
    classic path against the engine on phase 20's workload, fp32, 2
    layers / one group: tokens agreeing, and the top-2 margin at any first
    divergence (printed); (e) K5 (4 x 32 over 48 rows) and K6 (pos 47 of
    48, pos 32767 of 32768) at zamba2's shared block (32 heads over 32 KV
    heads of 80, bf16 q, int8 cache) against their plain versions, timed
    beside the bound and SDPA on the dequantized K/V.
24. the MoE family with MLA: (a) K2's grouped form (the experts' (E, C,
    K) x (E, K, N) products in one launch, each expert's row count read
    on the card) bit-exact against its plain version at granite-moe-3b's
    and deepseek-v3's expert shapes (C 128) and four odd shapes, with
    every count 0, 1, C, random and (granite) the padding experts empty,
    rows_cap C and 4, through the code, bf16 and fp32 (negative shift)
    epilogues; then timed at a decode step's routing (4 tokens) and the
    prefill's (128 tokens) beside the plain version, ``torch._int_mm``
    looped over the active experts and the bound (the active experts'
    int8 weight bytes); (b) K5 at MLA's expanded shape (H = KVH 128, Dk
    192, Dv 128, bf16 K/V) and at granite's prefill (24 heads over 8 KV
    heads of 64, int8 cache), K6 at granite's decode, against their plain
    versions beside SDPA; (c) granite-moe-3b at full width on 2 layers in
    fp32, prefill of the (4, 32) prompt and 3 decode steps card against
    CPU under phase 23a's rules (FP logits within 2e-4, INT every qlinear
    and MoE layer identical on the card's input), and deepseek-v3's MLA
    attention alone at full width, expanded (K5) and absorbed (prefill
    and 3 decode steps), FP within 1e-4, INT module by module identical;
    (d) classic ``serve`` of granite-moe-3b at full depth (int8 cache)
    and deepseek-v3 at full width on 4 layers (its 3 dense layers and 1
    MoE layer), bf16, flash attention, calibrated INT and FP, graphs and
    eager in turns: tokens identical, launches by ``_moe_serve_want``,
    calibration and prefill seconds, decode ms/token, peak memory.
25. the audio family: (a) K5's non-causal form (every query over every
    kv row) against its plain version at whisper's encoder shape (B 4,
    1500 over 1500, H = KVH 20, D 64; held row by row, a repeated kv tile
    caught) and the cross prefill's (B 4, 32 over 1500) and five odd
    shapes, x fp32 / bf16 q x int8 / float K/V, the encoder and cross
    shapes timed beside non-causal SDPA and the bound; K6 at the cross
    decode (one query over all 1500 memory rows, pos 1499) the same way;
    K2 with a bias at 6000 x 1280 -> 1280, -> 5120 and 6000 x 5120 ->
    1280, bit-exact (bias shifted left and right, the bf16 epilogue),
    timed; (b) whisper at full width on 2 encoder and 2 decoder layers,
    fp32, batch 2, prefill and 3 decode steps card against CPU under phase
    24c's rules (FP logits within 2e-4, INT every qlinear identical on the
    card's input); (c) classic ``serve`` of whisper-large-v3 at full width
    and depth, bf16, flash attention, calibrated INT and FP, graphs and
    eager in turns: tokens identical, launches by ``_whisper_launches``
    (a decode step K6 64, INT K2 321; a prefill K5 96, 64 of them
    non-causal), calibration and prefill seconds, decode ms/token, peak
    memory.
26. training: (a) K5 under autograd (``ops.flash_attention`` over q, k,
    v that require grad: the kernel forward, the backward the plain
    version's recomputed, as the reference's ``custom_vjp``) against the
    plain version's forward and autograd at llama3.2-1B's train shape (B
    8, S 128, H 32 over 8 KV heads of 64, bf16, causal), an fp32 case, a
    non-causal case with Sq != Skv and phase 6's 4096^2 bf16 case; the
    output and dq / dk / dv within the tolerances in ``TRAIN_K5_CASES``;
    a q that requires grad over int8 K/V refused; at the train shape the
    forward, the recompute backward and SDPA's forward + backward timed
    beside the bounds; (b) llama3.2-1B's width on 2 layers, fp32, card
    against CPU from the same params and AdamW state: one
    ``build_train_step`` step and one with ``accum_steps=2`` (loss,
    grad_norm, params, moments), then a checkpoint saved, restored and
    resumed against the uninterrupted run's losses; (c) ``train()`` of
    llama3.2-1B at full width and depth, 8 steps of 8 x 128 tokens, flash
    attention: losses finite, the last below step 1's, K5 16 a step; the
    step time, tokens/s and peak memory; (d) Algorithm 1 on the trained
    weights and the INT forward on one batch: FP vs INT argmax agreement,
    K2 and K3 launches by phase 22's formula.
27. tensor-parallel serving on a (data, model) mesh: (a) K2's rank-split
    form (each rank's int32 partial, the partials summed in int32, the
    finish's epilogue once) bit-exact against the single launch at
    qwen3-1.7B's row-cut shapes (wo 2048 -> 2048, w2 6144 -> 2048) over 2
    and 4 ranks x M {1, 4, 24, 256} x bias or none x int8 / uint8 x codes
    / bf16; the partial (beside ``torch._int_mm``), the finish and the
    single launch timed at M 24 beside their bounds; (b) two spawned
    ranks sharing the card over gloo (a (1, 2) mesh), qwen3-1.7B at full
    width on 8 of its 28 layers (``TP_LAYERS``; the script's time), bf16:
    the ragged engine in FP, calibrated INT and
    W8A8 on phase 5's workload, the legacy engine in INT, classic
    ``serve`` with flash attention in FP and INT, each against the
    one-rank eager run here: the ranks token-identical, INT and W8A8
    tokens and first-step logits bit-identical to one rank's, FP's
    first-step logits within ``TP_FP_REL`` of the largest |logit| (token
    agreement printed), each rank's launches by ``_tp_want``, tokens/s of
    the 2 ranks on one card (no speed-up: one card does both ranks'
    work, and every collective goes through the host); (c) a (1, 16)
    mesh on qwen3's 8 KV heads refused at build time.
28. training over a (data, model) mesh (``launch.steps.jit_train_step``
    on spawned ranks sharing the card over gloo, the cases of
    ``tests/train_mesh_cases.py``): (a) llama3.2-1B at full width and
    depth on a (1, 2) mesh, bf16, flash attention, 3 steps of 8 x 128
    tokens: the ranks' metrics identical, each step's loss and grad_norm
    against one rank's on the card (``TM_LOSS_REL`` / ``TM_GNORM_REL``
    on the seeded params; the third step, after the second's update,
    ``TM_UPDATED_LOSS_REL`` / ``TM_UPDATED_GNORM_REL``), K5 16 a step on
    each rank and no other kernel; step time, tokens/s and peak memory a
    rank; before them ``train(mesh_shape=(1, 2), dist_backend='gloo')``
    of the smoke config with whole-tree checkpoints, whose first steps
    the case runner's ranks repeat and, its last commit dropped, resume
    (losses bit-identical until the first update, then within
    ``TM_UPDATED_LOSS_REL``); (b) on the same ranks as a (2, 1) mesh,
    with and without FSDP, the width cut to 2 layers (the gradients'
    mean crosses the host), fp32, two steps each at a rate with no
    warmup (the second step sees the first's update) against the CPU's
    one rank under phase 26b's rules (loss and grad_norm within
    ``TRAIN_LOSS_RTOL``, the first step's moments within
    ``TRAIN_MOMENT_TOL`` of a leaf's largest); (c) one INT step on the (1, 2) mesh: the loss one rank's
    bit for bit, grad_norm 0, the launches one rank's with each row-cut
    module's K2 a partial and a finish.
29. the MoE family with MLA over a (data, model) mesh: (a) K2's grouped
    form's int32 output kind and exchanged layout (an (E, D) count grid)
    bit-exact against their plain versions at the decode shapes of a (1,
    2) and a (2, 1) rank, timed beside their bounds and looped
    ``torch._int_mm``; (b) granite-moe-3b at full width on 8 of its 32
    layers (``MM_GRANITE_LAYERS``: the script's time) and (c)
    deepseek-v3 at full width on 4 layers through classic ``serve`` on a
    (1, 2) mesh of two ranks sharing the card over gloo, FP and calibrated
    INT, the cases of ``tests/moe_mesh_cases.py``: tokens one rank's, INT
    every step's logits bit for bit, bf16 FP against one rank with its
    row-cut sums in the mesh's order within ``MM_FP_REL`` (one rank alone
    printed beside, with the prefill's routing choices that flip between
    the two one-rank runs and the first flip's margin, ``_route_flips``),
    granite in fp32 on ``MM_FP32_LAYERS`` layers against
    one rank within ``MM_FP32_REL``, each rank's launches by
    ``_mm_want``, tokens/s and peak memory a rank; (d) two
    full-width granite MoE layers in fp32 on a (2, 1) mesh (the hidden
    cut over data) under a router that overflows expert 0, against the
    CPU's one-process per-shard dispatch (INT identical, FP within
    ``MM_LAYER_FP_REL``), each rank's launches a layer.
30. training every family on one card: (a) K5 under autograd at
    whisper's encoder (non-causal, 1500 over 1500) and MLA's expanded
    shape (Dk 192, Dv 128) against the plain version's forward and
    autograd, timed beside SDPA's forward and forward + backward; each
    family at full width cut in depth (granite-moe-3b and rwkv6-3b on 2
    layers, deepseek-v3 on its first, dense MLA layer, whisper on 2 + 2
    over 1500 frames, zamba2 on one group), fp32, one
    ``build_train_step`` step (remat at its default) on the card and on
    the CPU from the same weights: loss and grad_norm within
    ``TRAIN_LOSS_RTOL``; zamba2's gradients with ``remat='full'`` equal
    to those without, on the card; (b) ``train()`` of granite-moe-3b,
    whisper-large-v3, rwkv6-3b and zamba2-2.7b at full width and depth,
    bf16, flash attention, ``FAM_STEPS`` steps: the bytes of params,
    gradients and moments reckoned against the free memory first, finite
    the mean loss of the last two steps below that of the first two (both
    on the seeded weights, step 1's rate 0), K5 once an attention layer a step (no
    other kernel), step ms, tokens/s, peak memory (deepseek-v3 is not
    trained: one MoE layer's 11.3 B expert parameters, 22.5 GB in bf16,
    with gradients and moments would not fit); (c) the three example
    twins at smoke size: the continuous-batching twin's dense-cache check
    (K5 / K6) exact on the ragged and the legacy engine, the replay twin
    EXACT with its legacy A/B, the inspect twin on the port engine's
    trace.
31. the recurrent and audio families over a (data, model) mesh of two
    ranks sharing the card over gloo, at full width (rwkv6-3b on 4 of 32
    layers, zamba2-2.7b on 6 of 54, whisper-large-v3 on 2 + 2 of 32 + 32
    over 1500 frames; ``RM_LAYERS``), the cases of
    ``tests/recurrent_mesh_cases.py``: (a) classic ``serve`` on (1, 2),
    calibrated INT, bf16 FP and fp32 FP (2 layers, zamba2 one group; an
    fp32 cache), (b) on (2, 1) whisper INT and rwkv6 W8A8 (the batch and
    the encoder frames cut), (c) the fixed-slab engine on (1, 2) for
    rwkv6 (INT) and zamba2 (INT and W8A8), on phase 20's workload in
    chunks of 16; each against one rank:
    tokens identical, INT and W8A8 every step's logits bit for bit, bf16
    FP within ``RM_FP_REL`` of one rank with every product in the mesh's
    order, fp32 FP within ``RM_FP32_REL`` of the largest |logit|,
    ``RM_GEN`` tokens a classic case, each rank's launches
    one rank's with K2's rank-split form (a partial and a finish) at each
    row-cut module (``_rm_row_cut``), decode ms a step and tokens/s of
    the ranks beside one rank's.
32. training the recurrent (rwkv6-3b, zamba2-2.7b), audio
    (whisper-large-v3) and MoE (granite-moe-3b, deepseek-v3 with MLA)
    families over a (data, model) mesh (``launch.steps.jit_train_step``
    on two spawned ranks sharing the card over gloo, the configurations of
    ``tests/train_mesh_family_cases.py``): full width, cut in depth
    (rwkv6 4 of 32 layers, zamba2 one group of 6, whisper 2 + 2 over
    1500 frames, granite 4 of 32, deepseek-v3 its first, dense MLA
    layer), 2 x 128 tokens a step against one rank alone on the card:
    (a) fp32, 2 steps on (1, 2) and (2, 1) (deepseek-v3 on (1, 2) alone),
    the ranks' metrics identical, the loss and grad_norm within
    ``TRAIN_LOSS_RTOL`` of one rank's (the second step, after an update,
    ``TMF_UPDATED_LOSS_REL`` / ``TMF_UPDATED_GNORM_REL``), K5 once an
    attention layer a step and no other kernel; (b) one INT step on (1, 2): the loss one rank's bit for bit,
    grad_norm 0, K2 (single, rank-split and, for the MoE family,
    grouped), K3 and K5 launched on each rank; (c) bf16, 3 steps on (1,
    2): step ms a rank and tokens/s beside one rank's.
33. the per-step cost analysis (``launch.analysis.CostMode``: each
    kernel charged by its reckoning, ``kernels.cost``, every other aten op
    by its operands) and the dry run (``launch.dryrun``): (a) qwen3-1.7B's
    classic prefill and decode step at phase 10's shape at full depth
    (INT calibrated over an int8 cache, then FP over a bf16 one) counted
    on the card and traced on the meta device: FLOPs and bytes equal,
    launches a counted call's = an uncounted call's = phase 10's, the
    card's allocation peak within ``COST_PEAK_FACTOR`` of the trace's
    peak live bytes, the decode step's replay (CUDA events) beside
    max(t_compute, t_memory); (b) phase 5's INT engine workload at
    ``ENGINE_LAYERS`` with ``profile_cost=True``: tokens and launches
    those of the run without, one cost entry a step shape; (c) rank 0 of
    rwkv6-3b x decode_32k on the production (16, 16) mesh for real on the
    card (zeros of its slices, ``CountingMesh``'s collectives recorded,
    not made): its allocated arguments the dry run's
    ``arg_bytes_per_device``, its collectives, FLOPs and bytes the meta
    trace's, its step's device time beside the three terms; (d) ``dryrun
    --all`` and ``--all --multi-pod`` (``DRYRUN_JOBS`` workers each,
    within ``DRYRUN_LIMIT_S``): exactly the 21 refused cells of
    ``DRYRUN_REFUSED_ARCHS`` fail, for item 8's reason, and each other
    cell prints its dominant term and its three terms.

Since the compiled step (phase 19), every engine phase runs with graphs,
as the engines do by default on the card, and phases 3 and 15 also
launch each work list padded to its step shape's capacity, which must
give the unpadded list's output bit for bit; they time K1 at the engine's
T24xS4 step and K4 at the legacy engine's shapes both padded (the launch
the engine makes, which the kernels line gives) and unpadded.  A launch
is counted where it runs on the card: a step key's eager first call by
its kernel wrappers, each replay with the counts its capture recorded
(phase 18's trace holds the engine's K1 count to the K1 kernels the card
ran).

It then prints the card line, a JSON line describing every kernel (K4's
``library_ms`` is null: no single PyTorch call reads a block table; K3's
and K2's times are one engine step's launches, K3's ResNet launches
beside them; K7's its standalone launches at the ResNet's adds, which
the forward no longer makes, and the convolution kernel's one forward's,
its old chain beside; K5's and K6's also at zamba2's head dim 80,
from phase 23, and at the MoE family's shapes, from phase 24; K2's
grouped form one granite-moe-3b decode step's 96 launches, from phase
24; K5's non-causal form at whisper's encoder, from phase 25; K5's
training launches and its recompute backward at the train shape, from
phase 26; K2's rank-split form and every kernel's launches on each rank
of phase 27's mesh; K5's, K2's and K3's launches on each rank of phase
28's training mesh; K2's grouped form's int32 kind and exchanged
layout, and every kernel's launches on each rank of phase 29's mesh;
K5's training launches in every family's steps and its recompute
backward at MLA's and whisper's shapes, from phase 30; every kernel's
launches on each rank of phase 31's mesh; K5's, K2's and K3's launches
on each rank of phase 32's training meshes), and
as its last line ``{"ok": true, "device": {...}}``.  Any failed check exits
non-zero before that line; without a CUDA device, or outside a checkout,
it exits non-zero at once.  It imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate for their type; elementwise integer and float work (K3,
# K7) is counted against the CUDA cores' fp32 rate, the table's one rate
# outside the tensor cores
PEAK = {"bytes": 3.35e12, "int8": 1979e12, "bfloat16": 989e12,
        "float32": 67e12}
# device clock cycles per second, at least the card's boost clock, for
# sizing the sleep kernel that holds the timed launches back
SLEEP_CYCLES_PER_S = 2.0e9

# the serving path's K2 shapes: (K, N) -> launches per engine step for
# qwen3-1.7B (28 layers: wq, wo; wk, wv; w1, w3; w2; plus the LM head)
K2_SHAPES = {(2048, 2048): 56, (2048, 1024): 56, (2048, 6144): 56,
             (6144, 2048): 28, (2048, 151936): 1}
K2_ROWS = (8, 16, 24, 64, 128)
K2_STEP_ROWS = 24          # the engine's full mixed-step stream bucket
# K2's bit-exactness grid: rows on and beside the one-block-row sizes (16,
# 32, 64, 128) and the engine's 24 bucket; (K, N) where the K splits end
# short, K ends inside a 64-row pipeline step, K is one split, N is one
# 8-column group; the epilogue variants (name, spec, ReLU)
K2_GRID_ROWS = (1, 4, 8, 16, 23, 24, 25, 64, 127, 128)
K2_SPLIT_EDGES = ((2112, 1024), (2064, 1024), (128, 1024), (16, 8),
                  (6144, 8), (4096, 264))
# large-M products, one per tall / narrow tile (the ResNet's tiles, and
# those a long prefill or a calibration batch would take), an N that ends
# inside a column tile, the first row count past one block row
K2_LARGE_M = ((4096, 256, 2048), (300, 256, 2048), (40000, 64, 64),
              (1000, 144, 32), (70000, 32, 32), (129, 2048, 1024),
              (3000, 96, 72))
K2_GRID_SPECS = (("bias<<", dict(n_x=4, n_w=8, n_b=7, n_o=4), False),
                 ("bias>>", dict(n_x=2, n_w=3, n_b=9, n_o=4), False),
                 ("relu-u8", dict(n_x=2, n_w=3, n_b=9, n_o=4,
                                  out_unsigned=True), True),
                 ("shift<0", dict(n_x=0, n_w=1, n_b=1, n_o=6), False))

# K1 work-list at qwen3-1.7B's attention shape: (q_len, kv_len) per
# sequence — a prefill chunk continuing 128 resident rows, two decode
# rows, a 5-token tail, a fresh prefill — then padding rows and a slot
K1_ITEMS = ((16, 144), (1, 131), (1, 47), (5, 37), (16, 16))
K1_HEADS, K1_KV_HEADS, K1_DIM, K1_BS, K1_PAD_ROWS = 16, 8, 128, 16, 9
# K1's grid of work-lists ((q_len, kv_len) per sequence): kv_len on and
# beside the 512-row split threshold and twice it
K1_GRID_LISTS = {
    "decode-only": ((1, 1), (1, 64), (1, 511), (1, 512), (1, 513),
                    (1, 1024), (1, 1025)),
    "prefill-only": ((16, 16), (16, 80), (7, 7), (16, 600)),
    "spec tails": ((4, 40), (4, 516), (2, 130), (4, 4)),
    "mixed": K1_ITEMS + ((1, 1030),),
}
# the long case at qwen3-1.7B's heads: a decode row over 32768 positions,
# a 16-row chunk over 4096 resident rows, two short decodes
K1_LONG_ITEMS = ((1, 32768), (16, 4112), (1, 100), (1, 37))
# the ResNet path (configs/resnet_paper.py CONFIG): the integer forward's
# batch, the calibration batch and the elementwise kernels' long shape
RESNET_BATCH, RESNET_CALIB_BATCH, ELEMWISE_LONG = 256, 64, 64 * 2**20
# warm forwards timed in phase 14 (median and spread)
RESNET_WARM = 5
# the convolution kernel's residual grids (n_a, n_b, n_o): the path's kind
# (the shortcut coarser), and an add whose shifted sum overflows int32
# under a negative requant shift (the saturating form decides)
CONV_RES_GRIDS = ((7, 6, 7), (0, 20, 30))
# its odd cases (label, input (B, H, W, Cin), Cout, k, stride, input
# dtype): M not a multiple of the tile (batch 1, size 7, odd padding), the
# stem's byte gather alone, Cout 10 (byte weight copies and stores), Cout
# 8 (SMOKE width, Cin 8 gathered byte by byte), Cout 96 (two column
# tiles, the second half empty), a 1x1 on 48 channels
CONV_ODD = (("batch 1 size 7", (1, 7, 7, 16), 16, 3, 1, "u8"),
            ("batch 1 size 7 stride 2", (1, 7, 7, 32), 64, 3, 2, "u8"),
            ("1x1 stride 2 size 7", (1, 7, 7, 32), 64, 1, 2, "u8"),
            ("stem batch 1", (1, 32, 32, 3), 16, 3, 1, "i8"),
            ("Cout 10", (2, 9, 9, 16), 10, 3, 1, "u8"),
            ("Cout 8", (3, 16, 16, 8), 8, 3, 1, "u8"),
            ("Cout 96", (2, 8, 8, 64), 96, 3, 1, "i8"),
            ("1x1 Cin 48", (2, 8, 8, 48), 32, 1, 1, "u8"))
# K5 / K6 at their long shapes: each output held within this share of its
# row's largest |value| (``_close_rows``)
LONG_ROW_TOL = 2e-2
# K6's long cache and the early position on it (most planned splits empty)
K6_LONG, K6_EARLY_POS = 32768, 100
KV_FRAC_BITS = 4
# K4 at the legacy engine's decode shape (4 slots, qwen3-1.7B's heads, 16-row
# blocks, tables of 5 blocks as the phase-17 workload's 80-position model
# length) and over one long cache (2048 shuffled blocks a slot)
K4_DECODE_POS = (40, 55, 23, 70)
K4_NBMAX, K4_LONG_BLOCKS = 5, 2048
# K4's split cases: each slot's last position before, at and after the
# 512-row split edge, and a 4096-row range; and a 16-query chunk ending at
# K4_EDGE_LAST, whose second item's 33733-row range ends in a 5-row chunk
K4_SPLIT_LAST = (511, 512, 513, 4095)
K4_EDGE_LAST = 33732
# the longest context of phase 5's engine (nbmax 4 x 16-row blocks; phase
# 5 holds the engine to it): with graphs the engine pads every work list
# to its step shape's capacity at these rows.  K1 at the engine's full
# mixed step T24xS4: a 16-token chunk continuing 32 resident rows, two
# decode rows, 6 padding rows and a padding slot, over tables of 4 blocks
ENGINE_ROWS = 4 * K1_BS
K1_STEP_ITEMS, K1_STEP_T = ((16, 48), (1, 64), (1, 57)), 24
# the recurrent engine's step (phase 20): 4 slots x chunk 64, tables of
# nbmax = 4 blocks (the workload's 64-row model length) and the trash
# column.  K4 at zamba2's shared block, rows (start, real tokens): a
# prompt's first chunk beside decode rows and an idle lane, then every
# row decoding, the last one at the table's last row
HYBRID_CHUNK, HYBRID_NBMAX = 64, 4
HYBRID_K4_CASES = {"mixed step": ((0, 24), (40, 1), (0, 0), (0, 7)),
                   "decode step": ((40, 1), (55, 1), (23, 1), (63, 1))}
K4_HYBRID_TIMED = "hybrid decode step int8 pool"


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# CPU references that a later phase compares the card against run on one
# background thread (each torch op releases the interpreter lock), only
# beside phases that time nothing: ``_run_phase`` waits for the thread to
# be idle before any other phase
_CPU_POOL: list = []


def on_cpu_thread(fn, *args):
    """``fn(*args)`` queued on the background thread: its future."""
    if not _CPU_POOL:
        _CPU_POOL.append(concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="cpu-reference"))
    return _CPU_POOL[0].submit(fn, *args)


def cpu_thread_idle() -> float:
    """Wait until the background thread has run all it was given: the
    seconds waited."""
    t0 = time.perf_counter()
    if _CPU_POOL:
        _CPU_POOL[0].submit(lambda: None).result()
    return time.perf_counter() - t0


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events).

    The timed calls queue behind a sleep kernel that outlasts the host's
    issuing of them, so the events time the device's work rather than the
    host's launch rate (a small launch takes the device less time than its
    Python wrapper takes the host)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    issue_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * issue_s * SLEEP_CYCLES_PER_S) + 1000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float, op_type: str):
    t_bytes = n_bytes / PEAK["bytes"] * 1e3
    t_ops = n_ops / PEAK[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------------

def phase_device(torch, out):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    from repro_torch.kernels import _build
    from repro_torch.kernels.quantize import quantize_multi_cuda
    secs = _build.build()
    log(f"[1] device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | kernels built in {secs:.1f} s")
    for name in _build.KERNEL_SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")
    # what one launch of a kernel with nothing to do costs the device,
    # timed as every kernel below is: a one-element K3 launch through the
    # port's ctypes binding (uncounted), and PyTorch's own add_
    one = torch.ones(1, device="cuda")
    floor_ms = time_ms(torch, lambda: quantize_multi_cuda(
        one, [0], lo=-128, hi=127), 500)
    torch_ms = time_ms(torch, lambda: one.add_(1.0), 500)
    log(f"[1] launch floor: {floor_ms:.5f} ms a one-element K3 launch, "
        f"{torch_ms:.5f} ms a one-element PyTorch add_ (device time, "
        f"launches queued behind the sleep kernel)")
    out["device"] = dict(card=smi, build_s=secs, launch_floor_ms=floor_ms,
                         torch_launch_floor_ms=torch_ms)
    return smi, secs


# ---------------------------------------------------------------------------
# phase 2: K2
# ---------------------------------------------------------------------------

def _k2_operands(torch, gen, m, k, n, copies=1):
    x = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    ws = [torch.randint(-128, 128, (k, n), generator=gen, device="cuda",
                        dtype=torch.int8) for _ in range(copies)]
    return x, ws


def _plan_str(plan) -> str:
    if plan.cfg < 0:
        return f"dp4a tile {plan.bm}x{plan.bn}"
    return (f"mma tile {plan.bm}x{plan.bn}, {plan.splits} split"
            f"{'s' if plan.splits > 1 else ''} of K")


def _k2_grid(torch, gen, pair, max_diff) -> int:
    """K2 bit-exact against its plain version over the grid's rows x every
    serving (K, N) and the split-K boundary shapes (a short last split, a
    K tail inside a pipeline step, the smallest split, narrow N, one
    weight row step), and over the large-M shapes (every tile), int8 and
    uint8 activations, every epilogue variant."""
    from repro_torch.core.integer_ops import LinearQuantSpec
    from repro_torch.kernels.int8_matmul import plan_int8_matmul
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(m, k, nn) for k, nn in list(K2_SHAPES) + list(K2_SPLIT_EDGES)
             for m in K2_GRID_ROWS] + list(K2_LARGE_M)
    n, plans, wkn, w, b = 0, {}, None, None, None
    for m, k, nn in cases:
        plans[(m, k, nn)] = _plan_str(plan_int8_matmul(m, k, nn, sms))
        if wkn != (k, nn):         # one weight matrix at a time (LM head 311 MB)
            del w
            wkn, (_, (w,)) = (k, nn), _k2_operands(torch, gen, 1, k, nn)
            b = torch.randint(-128, 128, (nn,), generator=gen,
                              device="cuda", dtype=torch.int8)
        for x_dt in (torch.int8, torch.uint8):
            lo, hi = (0, 256) if x_dt == torch.uint8 else (-128, 128)
            x = torch.randint(lo, hi, (m, k), generator=gen, device="cuda",
                              dtype=torch.int32).to(x_dt)
            for name, spec_kw, relu in K2_GRID_SPECS:
                got, want = pair(x, w, b, LinearQuantSpec(**spec_kw), relu)
                err = max_diff(got, want)
                check(got.dtype == want.dtype and err == 0,
                      f"K2 grid {name} M={m} K={k} N={nn} {x_dt}: kernel "
                      f"!= plain ({err} max diff)")
                n += 1
    log("    K2 large M: " + "; ".join(
        f"M={m} K={k} N={nn} {plans[(m, k, nn)]}" for m, k, nn in K2_LARGE_M))
    for (k, nn) in K2_SPLIT_EDGES:
        log(f"    K2 split-K edge K={k} N={nn}: "
            + "; ".join(f"M={m} {plans[(m, k, nn)]}" for m in (1, 24, 128)))
    return n


def phase_k2(torch, out):
    from repro_torch.core.integer_ops import LinearQuantSpec
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.int8_matmul import plan_int8_matmul
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def pair(x, w, b, spec, relu=False):
        """The wrapper ``qlinear`` calls (kernel on these CUDA tensors)
        and the plain version, with the clip range and output type the
        spec implies."""
        unsigned = relu and spec.out_unsigned
        lo, hi = (0, 255) if unsigned else (-128, 127)
        dt = torch.uint8 if unsigned else torch.int8
        return (ops.int8_matmul(x, w, b, spec, relu=relu),
                ref.int8_matmul_ref(x, w, b, shift=spec.requant_shift,
                                    bias_shift=spec.bias_shift, relu=relu,
                                    lo=lo, hi=hi, out_dtype=dt))

    # epilogue variants, and the byte-load path on odd shapes
    variants = [
        ("bias<<", (24, 2048, 2048), dict(n_x=4, n_w=8, n_b=7, n_o=4), False),
        ("bias>>", (24, 2048, 2048), dict(n_x=2, n_w=3, n_b=9, n_o=4), False),
        ("relu-u8", (24, 2048, 2048),
         dict(n_x=2, n_w=3, n_b=9, n_o=4, out_unsigned=True), True),
        ("shift<0", (24, 2048, 1024), dict(n_x=0, n_w=1, n_b=1, n_o=6), False),
        ("odd", (5, 100, 130), dict(n_x=4, n_w=8, n_b=7, n_o=4), False),
        ("odd-relu", (37, 301, 67),
         dict(n_x=3, n_w=5, n_b=10, n_o=2, out_unsigned=True), True),
    ]
    max_err = 0

    def max_diff(got, want):
        nonlocal max_err
        err = int((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        return err

    for name, (m, k, n), spec_kw, relu in variants:
        x, (w,) = _k2_operands(torch, gen, m, k, n)
        b = torch.randint(-128, 128, (n,), generator=gen, device="cuda",
                          dtype=torch.int8)
        got, want = pair(x, w, b, LinearQuantSpec(**spec_kw), relu)
        err = max_diff(got, want)
        check(got.dtype == want.dtype and err == 0,
              f"K2 {name} M={m} K={k} N={n}: kernel != plain ({err} max "
              f"diff)")
    log(f"[2] K2 epilogue variants bit-exact: "
        f"{', '.join(v[0] for v in variants)}")
    n_grid = _k2_grid(torch, gen, pair, max_diff)
    log(f"[2] K2 grid bit-exact ({n_grid} cases: M {list(K2_GRID_ROWS)} x "
        f"every serving (K, N) and the split-K boundary shapes, and "
        f"{len(K2_LARGE_M)} large-M shapes, x int8 / uint8 activations x "
        f"the {len(K2_GRID_SPECS)} epilogue variants)")

    spec = LinearQuantSpec(n_x=4, n_w=8, n_b=8, n_o=4)   # the serving grid
    rows, step = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                      "library_ms": 0.0, "bytes": 0, "ops": 0}
    for (k, n), per_step in K2_SHAPES.items():
        w_bytes = k * n
        copies = max(1, math.ceil(128e6 / w_bytes))       # beat the L2
        for m in K2_ROWS:
            x, ws = _k2_operands(torch, gen, m, k, n, copies)
            got, want = pair(x, ws[0], None, spec)
            check(max_diff(got, want) == 0,
                  f"K2 M={m} K={k} N={n}: kernel != plain")
            it = [0]

            def kernel():
                it[0] += 1
                ops.int8_matmul(x, ws[it[0] % copies], None, spec)

            def plain():
                it[0] += 1
                ref.int8_matmul_ref(x, ws[it[0] % copies], None,
                                    shift=spec.requant_shift)

            def library():
                it[0] += 1
                torch._int_mm(x, ws[it[0] % copies])

            ms = time_ms(torch, kernel, 20)
            plain_ms = time_ms(torch, plain, 3, warmup=1)
            lib_ok = m > 16 and k % 8 == 0 and n % 8 == 0   # _int_mm's rule
            lib_ms = time_ms(torch, library, 20) if lib_ok else None
            n_bytes = m * k + k * n + m * n
            n_ops = 2 * m * k * n
            b_ms, b_by = bound_ms(n_bytes, n_ops, "int8")
            plan = plan_int8_matmul(m, k, n, sms)
            rows.append(dict(m=m, k=k, n=n, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                             tile=[plan.bm, plan.bn], splits=plan.splits))
            log(f"    K2 M={m:<3} K={k:<4} N={n:<6} exact, {_plan_str(plan)} "
                f"| kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, _int_mm "
                f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
                f"bound {b_ms:.4f} ms ({b_by})")
            if m == K2_STEP_ROWS:
                step["ms"] += per_step * ms
                step["plain_ms"] += per_step * plain_ms
                step["library_ms"] += per_step * lib_ms
                step["bytes"] += per_step * n_bytes
                step["ops"] += per_step * n_ops
            del x, ws
    step["bound_ms"], step["bound_by"] = bound_ms(step["bytes"], step["ops"],
                                                  "int8")
    log(f"[2] K2 one engine step at M={K2_STEP_ROWS} (197 launches): kernel "
        f"{step['ms']:.3f} ms, plain {step['plain_ms']:.3f} ms, _int_mm "
        f"{step['library_ms']:.3f} ms, bound {step['bound_ms']:.3f} ms "
        f"({step['bound_by']}, {step['bytes'] / 1e9:.3f} GB)")
    step["max_abs_err"] = max_err
    out["k2"] = {"shapes": rows, "step": step}
    return step


# ---------------------------------------------------------------------------
# phase 3: K1
# ---------------------------------------------------------------------------

def _k1_build(torch, gen, items, h, kvh, d, bs, q_dtype, kv_dtype,
              pad_rows=K1_PAD_ROWS):
    """A K1 work-list ((q_len, kv_len) per sequence, packed into one
    stream) over a shuffled pool, as CUDA tensors: padding rows at the end
    of the stream and a trailing padding slot whose table names the trash
    block."""
    from repro_torch.core.qscheme import quant
    ns = len(items)
    nbmax = -(-max(kl for _, kl in items) // bs)
    t_real = sum(q for q, _ in items)
    t = t_real + pad_rows
    q = torch.randn((t, h, d), generator=gen, device="cuda").to(q_dtype)
    nb = 1 + ns * nbmax
    kf = torch.randn((nb, bs, kvh, d), generator=gen, device="cuda")
    vf = torch.randn((nb, bs, kvh, d), generator=gen, device="cuda")
    if kv_dtype == torch.int8:
        kp, vp = quant(kf, KV_FRAC_BITS), quant(vf, KV_FRAC_BITS)
    else:
        kp, vp = kf.to(kv_dtype), vf.to(kv_dtype)
    del kf, vf
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    bt = torch.zeros((ns + 1, nbmax), dtype=torch.int32, device="cuda")
    bt[:ns] = perm.reshape(ns, nbmax).to(torch.int32)
    q_len = torch.tensor([ql for ql, _ in items] + [0], dtype=torch.int32,
                         device="cuda")
    kv_len = torch.tensor([kl for _, kl in items] + [0],
                          dtype=torch.int32, device="cuda")
    q_start = torch.zeros_like(q_len)
    q_start[1:ns] = torch.cumsum(q_len[:ns - 1], 0).to(torch.int32)
    q_start[ns] = t
    nkv = KV_FRAC_BITS if kv_dtype == torch.int8 else None
    return (q, kp, vp, bt, q_start, q_len, kv_len), nkv, t_real


def _k1_work(args, h, d, q_bytes):
    """Bytes K1 must move (q in, out, the kv rows each sequence's last
    token sees, descriptors) and its operations (QK and PV, causal)."""
    q, kp, _, bt, q_start, q_len, kv_len = args
    kvh = kp.shape[2]
    items = list(zip(q_len.tolist(), kv_len.tolist()))
    t_real = sum(ql for ql, _ in items)
    kv_rows = sum(kl for _, kl in items)
    n_bytes = (t_real * h * d * q_bytes * 2 + kv_rows * kvh * 2 * d
               * kp.element_size() + 4 * (bt.numel() + 3 * q_start.numel()))
    pairs = sum(sum(kl - ql + i + 1 for i in range(ql)) for ql, kl in items)
    return n_bytes, pairs * h * 4 * d


def _padded_same(torch, launch, got, work, cap, what) -> None:
    """``launch(work)`` over ``work`` (a host plan) padded to ``cap``, the
    fixed launch a captured engine step makes, must give ``got``, the
    unpadded list's output, bit for bit."""
    from repro_torch.kernels.ragged_flash import pad_work
    padded = pad_work(work, cap)
    again = launch(padded.to("cuda"))
    torch.cuda.synchronize()
    check(torch.equal(again, got),
          f"{what}: the list padded to {padded.n_items} items and "
          f"{padded.n_combine} combine entries differs from the unpadded "
          f"one ({work.n_items}, {work.n_combine}); max |diff| "
          f"{float((again.float() - got.float()).abs().max()):.3e}")


def _k1_padded_same(torch, args, nkv, got, what) -> None:
    """K1 over the padded list of these descriptors (the capacity of
    their stream length, slots and longest table) is ``got``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ragged_flash import (plan_from_descriptors,
                                                  ragged_capacity)
    q, kp, _, bt = args[:4]
    groups = q.shape[1] // kp.shape[2]
    work = plan_from_descriptors(*args[4:7], groups)
    cap = ragged_capacity(q.shape[0], bt.shape[0], groups=groups,
                          rows=bt.shape[1] * kp.shape[1])
    _padded_same(torch, lambda w: ops.ragged_attention(
        *args, kv_frac_bits=nkv, work=w), got, work, cap, what)


def _k1_grid(torch, gen):
    """K1 against its plain version over work-lists (decode-only with
    kv_len on and beside the split boundaries, prefill-only, speculative
    tails, mixed), GQA 1/2/4/16, pool blocks of 16 and 128 rows, head dims
    64 and 128 (and on the mixed list 100, staged value by value, and
    256, the widest), int8 and float pools, bf16 q (tensor cores) and fp32
    q (CUDA cores); every list has padding rows and a padding slot, which
    must be exactly 0."""
    from repro_torch.kernels import ops, ref
    shapes = [(lname, groups, d, bs) for lname in K1_GRID_LISTS
              for groups in (1, 2, 4, 16) for d in (64, 128)
              for bs in (16, 128)]
    shapes += [("mixed", 2, d, 16) for d in (100, 256)]
    n, worst = 0, 0.0
    for lname, groups, d, bs in shapes:
        for q_dt, kv_dt, tol in ((torch.bfloat16, torch.int8, 2e-2),
                                 (torch.bfloat16, torch.bfloat16, 2e-2),
                                 (torch.float32, torch.int8, 1e-4),
                                 (torch.float32, torch.float32, 1e-4)):
            args, nkv, t_real = _k1_build(torch, gen, K1_GRID_LISTS[lname],
                                          2 * groups, 2, d, bs, q_dt, kv_dt,
                                          pad_rows=3)
            got = ops.ragged_attention(*args, kv_frac_bits=nkv)
            want = ref.ragged_attention_ref(*args, kv_frac_bits=nkv)
            torch.cuda.synchronize()
            what = (f"K1 grid {lname} G {groups} D {d} bs {bs} {q_dt} q "
                    f"{kv_dt} pool")
            worst = max(worst, _close(torch, got, want, tol, what))
            check(int(torch.count_nonzero(got[t_real:])) == 0,
                  f"{what}: padding rows are not exactly 0")
            _k1_padded_same(torch, args, nkv, got, what)
            n += 1
    return n, worst


def _k1_table_fault_caught(torch, args, want, nkv, seq, col):
    """The plain version over a table whose column ``col`` of sequence
    ``seq`` names the block of column ``col - 1`` (a kernel that reads one
    pool block twice and skips the next) must fall outside the row
    tolerance."""
    from repro_torch.kernels import ref
    bad_bt = args[3].clone()
    bad_bt[seq, col] = args[3][seq, col - 1]
    bad = ref.ragged_attention_ref(*args[:3], bad_bt, *args[4:],
                                   kv_frac_bits=nkv)
    return not _rows_within(torch, bad, want, LONG_ROW_TOL)


def phase_k1(torch, out):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ragged_flash import (pad_work,
                                                  plan_from_descriptors,
                                                  ragged_capacity)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    # (name, q dtype, pool dtype, tolerance, KV heads, block size): the
    # serving shape first, then GQA 4 and 128-row blocks
    cases = [("int8 pool, fp32 q", torch.float32, torch.int8, 1e-4, 8, 16),
             ("int8 pool, bf16 q", torch.bfloat16, torch.int8, 2e-2, 8, 16),
             ("bf16 pool, bf16 q", torch.bfloat16, torch.bfloat16, 2e-2, 8, 16),
             ("int8 pool, fp32 q, GQA 4, bs 128", torch.float32, torch.int8,
              1e-4, 4, 128),
             ("bf16 pool, bf16 q, GQA 4, bs 128", torch.bfloat16,
              torch.bfloat16, 2e-2, 4, 128)]
    main = None
    for name, q_dt, kv_dt, tol, kvh, bs in cases:
        args, nkv, t_real = _k1_build(torch, gen, K1_ITEMS, K1_HEADS, kvh,
                                      K1_DIM, bs, q_dt, kv_dt)
        got = ops.ragged_attention(*args, kv_frac_bits=nkv)
        want = ref.ragged_attention_ref(*args, kv_frac_bits=nkv)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        check(got.dtype == q_dt and got.shape == want.shape,
              f"K1 {name}: output {got.dtype} {tuple(got.shape)}")
        check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
              f"K1 {name}: kernel vs plain max |diff| {err:.3e} > tol {tol}")
        check(int(torch.count_nonzero(got[t_real:])) == 0,
              f"K1 {name}: padding rows are not exactly 0")
        _k1_padded_same(torch, args, nkv, got, f"K1 {name}")
        log(f"[3] K1 {name}: within atol=rtol={tol} (max |diff| {err:.2e}), "
            f"{K1_PAD_ROWS} padding rows exactly 0, padded work list "
            f"bit-identical")
        if main is None and kv_dt == torch.int8 and q_dt == torch.bfloat16:
            main = (args, nkv, err)
    grid_n, grid_err = _k1_grid(torch, gen)
    log(f"[3] K1 grid ({grid_n} cases: work-lists "
        f"{', '.join(K1_GRID_LISTS)} x GQA 1/2/4/16 x D 64/128 x bs 16/128, "
        f"the mixed list at D 100 and 256, x bf16 q over int8 / bf16 pools "
        f"within atol=rtol=2e-2, fp32 q over int8 / fp32 pools within 1e-4; "
        f"padding rows and slots exactly 0; each list padded to its "
        f"capacity bit-identical to the unpadded one): max |diff| "
        f"{grid_err:.2e}")
    h, kvh, d = K1_HEADS, K1_KV_HEADS, K1_DIM
    groups = h // kvh

    def timed(args, nkv, iters):
        """Kernel and plain times, the work list planned once as the
        engine plans it (not inside the timed calls)."""
        work = plan_from_descriptors(*args[4:7], groups, "cuda")
        ms = time_ms(torch, lambda: ops.ragged_attention(
            *args, kv_frac_bits=nkv, work=work), iters)
        plain_ms = time_ms(torch, lambda: ref.ragged_attention_ref(
            *args, kv_frac_bits=nkv), 3 if iters < 50 else 10, warmup=1)
        return work, ms, plain_ms

    args, nkv, err = main
    work, ms, plain_ms = timed(args, nkv, 50)
    n_bytes, n_ops = _k1_work(args, h, d, args[0].element_size())
    b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
    t_real = sum(ql for ql, _ in K1_ITEMS)
    log(f"[3] K1 main-path case (bf16 q, int8 pool, H={h} KVH={kvh} D={d} "
        f"bs={K1_BS}, {t_real}+{K1_PAD_ROWS} rows, {work.n_items} items, "
        f"{work.n_combine} split): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}, {n_bytes} B)")
    res = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               max_abs_err=err, bytes=n_bytes, ops=n_ops,
               grid_cases=grid_n, grid_max_abs_err=grid_err)

    # the launch the engine makes at its T24xS4 step: the work list padded
    # to the step shape's capacity at the engine's longest context, timed
    # beside the unpadded list
    t_real = sum(ql for ql, _ in K1_STEP_ITEMS)
    args, nkv, _ = _k1_build(torch, gen, K1_STEP_ITEMS, h, kvh, d, K1_BS,
                             torch.bfloat16, torch.int8,
                             pad_rows=K1_STEP_T - t_real)
    got = ops.ragged_attention(*args, kv_frac_bits=nkv)
    want = ref.ragged_attention_ref(*args, kv_frac_bits=nkv)
    torch.cuda.synchronize()
    err = _close(torch, got, want, 2e-2, "K1 engine step")
    work = plan_from_descriptors(*args[4:7], groups)
    cap = ragged_capacity(K1_STEP_T, args[3].shape[0], groups=groups,
                          rows=ENGINE_ROWS)
    _padded_same(torch, lambda w: ops.ragged_attention(
        *args, kv_frac_bits=nkv, work=w), got, work, cap, "K1 engine step")
    padded = pad_work(work, cap)
    work_d, padded_d = work.to("cuda"), padded.to("cuda")
    ms = time_ms(torch, lambda: ops.ragged_attention(
        *args, kv_frac_bits=nkv, work=work_d), 50)
    padded_ms = time_ms(torch, lambda: ops.ragged_attention(
        *args, kv_frac_bits=nkv, work=padded_d), 50)
    plain_ms = time_ms(torch, lambda: ref.ragged_attention_ref(
        *args, kv_frac_bits=nkv), 3, warmup=1)
    n_bytes, n_ops = _k1_work(args, h, d, args[0].element_size())
    b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
    log(f"[3] K1 engine step T{K1_STEP_T}xS{args[3].shape[0]} ((q_len, "
        f"kv_len) {list(K1_STEP_ITEMS)}, bf16 q, int8 pool, tables of "
        f"{args[3].shape[1]} blocks; {work.n_items} items, padded to "
        f"{padded.n_items} items, {padded.n_combine} combine entries, "
        f"max_splits {padded.max_splits} at {ENGINE_ROWS} rows): within "
        f"atol=rtol=2e-2 (max |diff| {err:.2e}), padded bit-identical | "
        f"kernel padded (the engine's launch) {padded_ms:.4f} ms, unpadded "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"({b_by}, {n_bytes} B)")
    res["step"] = dict(ms=padded_ms, unpadded_ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                       bytes=n_bytes, ops=n_ops, items=work.n_items,
                       padded_items=padded.n_items,
                       padded_combine=padded.n_combine)
    del args, got, want

    # the long case, held row by row
    args, nkv, _ = _k1_build(torch, gen, K1_LONG_ITEMS, h, kvh, d, K1_BS,
                             torch.bfloat16, torch.int8)
    got = ops.ragged_attention(*args, kv_frac_bits=nkv)
    want = ref.ragged_attention_ref(*args, kv_frac_bits=nkv)
    torch.cuda.synchronize()
    err = _close_rows(torch, got, want, LONG_ROW_TOL, "K1 long case")
    _k1_padded_same(torch, args, nkv, got, "K1 long case")
    col = K1_LONG_ITEMS[0][1] // K1_BS // 2
    check(_k1_table_fault_caught(torch, args, want, nkv, 0, col),
          "K1 long case: the row tolerance passes a repeated pool block")
    del want
    work, ms, plain_ms = timed(args, nkv, 20)
    n_bytes, n_ops = _k1_work(args, h, d, args[0].element_size())
    b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
    log(f"[3] K1 long case ((q_len, kv_len) {list(K1_LONG_ITEMS)}, bf16 q, "
        f"int8 pool, H={h} KVH={kvh} D={d} bs={K1_BS}; {work.n_items} items, "
        f"{work.n_combine} split into {work.n_parts} chunks): within "
        f"{LONG_ROW_TOL} of each row's largest |value|, which a repeated "
        f"pool block fails (max |diff| {err:.2e}), padded work list "
        f"bit-identical | kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}, {n_bytes} "
        f"B), {ms / b_ms:.2f}x the bound")
    res["long"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       max_abs_err=err, bytes=n_bytes, ops=n_ops,
                       items=work.n_items, splits=work.n_parts)
    del args, got
    torch.cuda.empty_cache()
    out["k1"] = res
    return res


# ---------------------------------------------------------------------------
# phase 4: full-width model, kernels on the card vs plain path on the CPU
# ---------------------------------------------------------------------------

def _model_steps(vocab, bs):
    """Two ragged steps: seq A prefills 16 tokens (blocks 1, 2); then seq B's
    12-token chunk (block 3), A's decode row at position 16, 3 padding rows
    and a padding slot."""
    import numpy as np
    rng = np.random.default_rng(11)
    a = rng.integers(0, vocab, size=17).astype(np.int32)
    b = rng.integers(0, vocab, size=12).astype(np.int32)
    s1 = dict(tokens=a[:16], positions=np.arange(16, dtype=np.int32),
              dest=(bs + np.arange(16)).astype(np.int32),
              bt=np.asarray([[1, 2], [0, 0], [0, 0]], np.int32),
              q_start=np.asarray([0, 16, 16], np.int32),
              q_len=np.asarray([16, 0, 0], np.int32),
              kv_len=np.asarray([16, 0, 0], np.int32))
    tok = np.zeros(16, np.int32)
    tok[:12], tok[12] = b, a[16]
    pos = np.zeros(16, np.int32)
    pos[:12], pos[12] = np.arange(12), 16
    dest = np.zeros(16, np.int32)
    dest[:12], dest[12] = 3 * bs + np.arange(12), 2 * bs
    s2 = dict(tokens=tok, positions=pos, dest=dest,
              bt=np.asarray([[3, 0], [1, 2], [0, 0]], np.int32),
              q_start=np.asarray([0, 12, 16], np.int32),
              q_len=np.asarray([12, 1, 0], np.int32),
              kv_len=np.asarray([12, 17, 0], np.int32))
    return s1, s2


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def phase_model(torch, out):
    """fp32 on both sides.  Tolerances, set before the first run: the CPU
    and the card sum fp32 products in different orders, so a float that
    lands within an ulp of a quantization boundary may round to the
    neighbouring code.  INT mode: the layer-0 pool is written before any
    such sum (rmsnorm and rope are float64-then-round on both devices,
    the products are exact integers), so it must be identical; elsewhere
    every code is within one step of the CPU's and at most 0.1% differ;
    logits (on the 2^-4 output grid) differ in at most 0.1% of entries,
    by at most 4 grid steps.  FP mode: pools as above; logits within
    atol=rtol=1e-3 in at least 99.9% of entries, all within 5e-2."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.qmodel import (QuantContext, QuantMode,
                                         quantize_weight_tree)
    from repro_torch.models import model as M
    from repro_torch.models.attention import RaggedBatch
    cfg = dataclasses.replace(get_config("qwen3_1_7b"), n_layers=2,
                              dtype="float32", kv_cache_bits=8)
    t0 = time.perf_counter()
    p_cpu = M.init_params(cfg, 0, device="cpu")
    p_gpu = _tree_to(p_cpu, "cuda")
    bs, nb = 16, 8
    res = {}
    for mode in ("fp", "int"):
        ctx = QuantContext(mode=QuantMode(mode))
        pc, pg = p_cpu, p_gpu
        if ctx.mode is QuantMode.INT:
            pc, pg = quantize_weight_tree(p_cpu, ctx), \
                quantize_weight_tree(p_gpu, ctx)
            check(torch.equal(pc["lm_head"], pg["lm_head"].cpu()),
                  "INT weight codes differ between the card and the CPU")
        caches = {d: M.init_paged_cache(cfg, nb, bs, device=d)
                  for d in ("cpu", "cuda")}
        worst = {"frac": 0.0, "max": 0.0}
        for step in _model_steps(cfg.vocab_size, bs):
            logits = {}
            for dev, params in (("cpu", pc), ("cuda", pg)):
                t = {k: torch.from_numpy(v).to(dev) for k, v in step.items()}
                rb = RaggedBatch(dest=t["dest"], block_tables=t["bt"],
                                 q_start=t["q_start"], q_len=t["q_len"],
                                 kv_len=t["kv_len"])
                lg, caches[dev] = M.ragged_step(params, t["tokens"],
                                                caches[dev], t["positions"],
                                                rb, cfg, ctx)
                logits[dev] = lg.float().cpu()
            a, b = logits["cuda"], logits["cpu"]
            check(bool(torch.isfinite(a).all()) and a.shape == b.shape,
                  f"model {mode}: non-finite or misshapen logits")
            diff = (a - b).abs()
            if ctx.mode is QuantMode.INT:
                frac = float((diff > 0).float().mean())
            else:
                frac = float((diff > 1e-3 + 1e-3 * b.abs()).float().mean())
            worst["frac"] = max(worst["frac"], frac)
            worst["max"] = max(worst["max"], float(diff.max()))
        pools = []
        for name, arr_c, arr_g in zip(("k", "v"), caches["cpu"]["paged_kv"],
                                      caches["cuda"]["paged_kv"]):
            d = (arr_g.cpu().int() - arr_c.int()).abs()
            for layer in range(cfg.n_layers):
                pools.append((name, layer, int((d[layer] > 0).sum()),
                              int(d[layer].max()), d[layer].numel()))
        max_code = max(p[3] for p in pools)
        frac_code = sum(p[2] for p in pools) / sum(p[4] for p in pools)
        log(f"[4] model {mode}: logits max |diff| {worst['max']:.3e}, "
            f"{worst['frac']:.2e} of entries "
            f"{'differ' if mode == 'int' else 'beyond 1e-3'}; pool codes "
            f"differing per (k/v, layer): "
            f"{[(p[0], p[1], p[2]) for p in pools]} of {pools[0][4]}, "
            f"max {max_code}")
        check(max_code <= 1 and frac_code <= 1e-3,
              f"model {mode}: pool codes differ by {max_code} steps in "
              f"{frac_code:.2e} of entries")
        if ctx.mode is QuantMode.INT:
            check(all(p[2] == 0 for p in pools if p[1] == 0),
                  "model int: the layer-0 pool differs from the CPU's")
            check(worst["frac"] <= 1e-3 and worst["max"] <= 0.25,
                  f"model int: logits differ in {worst['frac']:.2e} of "
                  f"entries, max {worst['max']}")
        else:
            check(worst["frac"] <= 1e-3 and worst["max"] <= 5e-2,
                  f"model fp: logits beyond tolerance in {worst['frac']:.2e}"
                  f" of entries, max {worst['max']}")
        res[mode] = dict(logits_max_abs=worst["max"],
                         logits_frac=worst["frac"], pool_codes=pools)
    log(f"[4] model phase {time.perf_counter() - t0:.1f} s")
    out["model"] = res
    del p_cpu, p_gpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: the engine at full depth
# ---------------------------------------------------------------------------

def phase_engine(torch, out):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_engine
    cfg = get_config("qwen3_1_7b")
    per_layer_k2 = 7
    res = {}
    for mode in ("fp", "int"):
        runs = []
        for rep in range(2):
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            # rate=1e9: every request arrives at t=0, so the schedule, and
            # with it every step's shapes, repeats exactly between runs
            o = serve_engine("qwen3_1_7b", smoke=False, mode=mode,
                             calibrate=False, kv_bits=8, n_requests=8,
                             n_slots=4, rate=1e9, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            rep_ = o["report"]
            steps = rep_["ragged_steps"]
            eng = o["engine"]
            check(eng.sched.nbmax * eng.pool.block_size == ENGINE_ROWS,
                  f"engine {mode}: longest context {eng.sched.nbmax} x "
                  f"{eng.pool.block_size} rows, phases 3 and 15 time the "
                  f"padded lists at {ENGINE_ROWS}")
            peak = torch.cuda.max_memory_allocated() / 2**30
            k2_want = (cfg.n_layers * per_layer_k2 + 1) * steps \
                if mode == "int" else 0
            # K3: the four module inputs and the K/V write a layer and the
            # LM head's input in INT; the K/V write alone in FP
            k3_want = (K3_PER_LAYER * cfg.n_layers + 1 if mode == "int"
                       else cfg.n_layers) * steps
            log(f"[5] engine {mode} run {rep}: {rep_['completed']} requests, "
                f"{rep_['gen_tokens']} tokens, {rep_['tokens_per_s']} tok/s, "
                f"{steps} ragged steps, launches K1 "
                f"{launches['ragged_attention']} K2 {launches['int8_matmul']}"
                f" K3 {launches['quantize']} ({launches['quantize'] / steps:g}"
                f" a step), TTFT p50 {rep_['ttft_s']['p50']:.4f} s, TPOT p50 "
                f"{rep_['tpot_s']['p50']:.4f} s, peak "
                f"{peak:.2f} GiB, {wall:.1f} s")
            check(rep_["completed"] == 8, f"engine {mode}: not all done")
            check(launches["ragged_attention"] == cfg.n_layers * steps,
                  f"engine {mode}: K1 launched {launches['ragged_attention']}"
                  f" times, want {cfg.n_layers} x {steps}")
            check(launches["int8_matmul"] == k2_want,
                  f"engine {mode}: K2 launched {launches['int8_matmul']} "
                  f"times, want {k2_want}")
            check(launches["quantize"] == k3_want,
                  f"engine {mode}: K3 launched {launches['quantize']} "
                  f"times, want {k3_want}")
            check({k: launches[k] for k in rep_["kernel_launches"]}
                  == rep_["kernel_launches"],
                  f"engine {mode}: report launches {rep_['kernel_launches']}")
            for req in o["requests"]:
                toks = o["outputs"][req.rid]
                check(1 <= len(toks) <= req.max_new_tokens
                      and int(toks.min()) >= 0
                      and int(toks.max()) < cfg.vocab_size,
                      f"engine {mode}: request {req.rid} tokens {toks}")
            runs.append((o["outputs"], launches, rep_, peak, wall))
            del o, eng
            torch.cuda.empty_cache()
        (a, *_), (b, *_) = runs
        check(sorted(a) == sorted(b)
              and all(len(a[r]) == len(b[r]) and (a[r] == b[r]).all()
                      for r in a),
              f"engine {mode}: a repeated greedy run gave other tokens")
        log(f"[5] engine {mode}: repeat run token-identical")
        res[mode] = dict(launches=runs[0][1], report=runs[0][2],
                         peak_gib=runs[0][3], wall_s=runs[0][4])
    out["engine"] = res
    return res


# ---------------------------------------------------------------------------
# phases 6 and 7: K5 and K6 against their plain versions
# ---------------------------------------------------------------------------

def _dense_qkv(torch, gen, b, sq, skv, h, kvh, d, q_dt, kv_dt):
    from repro_torch.core.qscheme import quant
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(q_dt)
    k = torch.randn((b, skv, kvh, d), generator=gen, device="cuda")
    v = torch.randn((b, skv, kvh, d), generator=gen, device="cuda")
    if kv_dt == torch.int8:
        return q, quant(k, KV_FRAC_BITS), quant(v, KV_FRAC_BITS), KV_FRAC_BITS
    return q, k.to(kv_dt), v.to(kv_dt), None


def _sdpa(torch):
    """``scaled_dot_product_attention`` over (B, S, H, D) tensors with
    grouped KV heads: ``enable_gqa`` where the installed PyTorch has it,
    else K/V repeated per group.  Timed as the yardstick only."""
    F = torch.nn.functional
    probe = torch.zeros((1, 2, 1, 8), device="cuda")
    try:
        F.scaled_dot_product_attention(probe, probe[:, :1], probe[:, :1],
                                       enable_gqa=True)
        gqa = True
    except TypeError:
        gqa = False

    def call(q, k, v, causal):
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        if gqa:
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal,
                                                  enable_gqa=True)
        g = qt.shape[1] // kt.shape[1]
        return F.scaled_dot_product_attention(
            qt, kt.repeat_interleave(g, 1), vt.repeat_interleave(g, 1),
            is_causal=causal)
    return call, ("enable_gqa" if gqa else "repeated K/V")


def _deq(torch, k, nkv, dt):
    from repro_torch.core.qscheme import dequant
    return dequant(k, nkv, out_dtype=dt) if nkv is not None else k.to(dt)


def _close(torch, got, want, tol, what):
    err = float((got.float() - want.float()).abs().max())
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: output {got.dtype} {tuple(got.shape)}")
    check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
          f"{what}: kernel vs plain max |diff| {err:.3e} > tol {tol}")
    return err


def _close_rows(torch, got, want, rel, what):
    """Hold a long-shape output row by row at ``rel`` times the row's
    largest |value| (a row is one (batch, query, head) of D values).  Its
    outputs average thousands of V rows and are far below the path's
    shapes' atol, so an absolute 2e-2 would pass a kernel that drops or
    repeats a whole kv tile; this bound passes a bf16 rounding flip (at
    most 2^-7 of a value) and fails such a tile."""
    err = float((got.float() - want.float()).abs().max())
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: output {got.dtype} {tuple(got.shape)}")
    check(_rows_within(torch, got, want, rel),
          f"{what}: kernel vs plain max |diff| {err:.3e} beyond {rel} of "
          "its row's largest value")
    return err


def _rows_within(torch, got, want, rel):
    w = want.float()
    bound = rel * w.abs().amax(dim=-1, keepdim=True)
    return bool(((got.float() - w).abs() <= bound).all())


def _tile_fault_caught(torch, plain, q, k, v, want, rel, tile, **kw):
    """The plain version over K/V whose kv tile ``tile`` (128 rows) holds
    a copy of the tile before it (a kernel that repeats one tile and
    skips the next) must fall outside the row tolerance."""
    lo = tile * 128
    kb, vb = k.clone(), v.clone()
    kb[:, lo:lo + 128], vb[:, lo:lo + 128] = k[:, lo - 128:lo], \
        v[:, lo - 128:lo]
    bad = plain(q, kb, vb, **kw)
    return not _rows_within(torch, bad, want, rel)


def _k5_grid(torch, gen):
    """K5 against its plain version over GQA groups (up to the largest it
    takes), head dims (one not a multiple of 16), query counts and cache
    tails, on both of its paths: bf16 q (tensor cores) and fp32 q (CUDA
    cores)."""
    from repro_torch.kernels import ops, ref
    n, worst = 0, 0.0
    for groups in (1, 2, 4, 64):
        for d in (64, 100, 128):
            for sq in (1, 17, 32, 100):
                for skv in (sq, sq + 27):
                    for q_dt, kv_dt, tol in (
                            (torch.bfloat16, torch.int8, 2e-2),
                            (torch.bfloat16, torch.bfloat16, 2e-2),
                            (torch.float32, torch.int8, 1e-4),
                            (torch.float32, torch.float32, 1e-4)):
                        q, k, v, nkv = _dense_qkv(torch, gen, 2, sq, skv,
                                                  2 * groups, 2, d, q_dt,
                                                  kv_dt)
                        got = ops.flash_attention(q, k, v, kv_frac_bits=nkv)
                        want = ref.flash_attention_ref(q, k, v,
                                                       kv_frac_bits=nkv)
                        torch.cuda.synchronize()
                        worst = max(worst, _close(
                            torch, got, want, tol,
                            f"K5 grid G {groups} D {d} Sq {sq} Skv {skv} "
                            f"{q_dt} q {kv_dt} K/V"))
                        n += 1
    return n, worst


def phase_k5(torch, out):
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    h, kvh, d = K1_HEADS, K1_KV_HEADS, K1_DIM
    sdpa, sdpa_how = _sdpa(torch)
    # (name, B, Sq, Skv, q dtype, K/V dtype, tolerance): the classic path's
    # shapes first — the prefill over the int8 max_seq cache (bf16 model,
    # fp32 model phase) and the calibration forward over its own bf16 K/V
    cases = [("prefill, int8 cache", 4, 32, 48, torch.bfloat16, torch.int8,
              2e-2),
             ("prefill, int8 cache, fp32 q", 4, 32, 48, torch.float32,
              torch.int8, 1e-4),
             ("prefill, bf16 cache", 4, 32, 48, torch.bfloat16,
              torch.bfloat16, 2e-2),
             ("forward, bf16 K/V", 4, 32, 32, torch.bfloat16, torch.bfloat16,
              2e-2),
             ("forward, fp32", 4, 32, 32, torch.float32, torch.float32,
              1e-4),
             ("long prefill", 1, 4096, 4096, torch.bfloat16, torch.bfloat16,
              LONG_ROW_TOL)]
    rows, max_err = [], 0.0
    for name, b, sq, skv, q_dt, kv_dt, tol in cases:
        q, k, v, nkv = _dense_qkv(torch, gen, b, sq, skv, h, kvh, d, q_dt,
                                  kv_dt)
        got = ops.flash_attention(q, k, v, kv_frac_bits=nkv)
        want = ref.flash_attention_ref(q, k, v, kv_frac_bits=nkv)
        torch.cuda.synchronize()
        if sq < 1024:
            err = _close(torch, got, want, tol, f"K5 {name}")
            held = f"atol=rtol={tol}"
        else:
            err = _close_rows(torch, got, want, tol, f"K5 {name}")
            check(_tile_fault_caught(torch, ref.flash_attention_ref, q, k, v,
                                     want, tol, sq // 256, kv_frac_bits=nkv),
                  f"K5 {name}: the row tolerance passes a repeated kv tile")
            held = (f"{tol} of each row's largest |value|, which a repeated "
                    "kv tile fails")
        if q_dt == torch.bfloat16 and kv_dt == torch.int8:
            max_err = max(max_err, err)
        line = (f"[6] K5 {name} (B {b}, Sq {sq}, Skv {skv}, {q_dt} q, "
                f"{kv_dt} K/V): within {held} (max |diff| {err:.2e})")
        if name in ("prefill, int8 cache", "long prefill"):
            iters = 50 if sq < 1024 else 5
            ms = time_ms(torch, lambda: ops.flash_attention(
                q, k, v, kv_frac_bits=nkv), iters)
            plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(
                q, k, v, kv_frac_bits=nkv), 3, warmup=1)
            kf, vf = _deq(torch, k, nkv, q_dt), _deq(torch, v, nkv, q_dt)
            if skv > sq:     # SDPA's is_causal aligns the top-left corner
                kf, vf = kf[:, :sq].contiguous(), vf[:, :sq].contiguous()
            lib = sdpa(q, kf, vf, True).transpose(1, 2)
            check(torch.allclose(lib.float(), want.float(), atol=5e-2,
                                 rtol=5e-2), f"K5 {name}: SDPA disagrees")
            lib_ms = time_ms(torch, lambda: sdpa(q, kf, vf, True), iters)
            kv_rows = b * min(sq, skv)
            n_bytes = (2 * q.numel() * q.element_size()
                       + 2 * kv_rows * kvh * d * k.element_size())
            n_ops = b * h * 4 * d * sum(min(i + 1, skv) for i in range(sq))
            b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
            rows.append(dict(name=name, b=b, sq=sq, skv=skv, ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                             bytes=n_bytes, ops=n_ops))
            line += (f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
                     f"({sdpa_how}) {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
                     f"({b_by})")
        log(line)
    grid_n, grid_err = _k5_grid(torch, gen)
    log(f"[6] K5 grid ({grid_n} cases: GQA 1/2/4/64, D 64/100/128 (100 "
        f"zero-padded), Sq 1/17/32/100 over Skv = Sq and Sq + 27, bf16 q "
        f"(tensor cores) over int8 / bf16 K/V within atol=rtol=2e-2, fp32 q "
        f"over int8 / fp32 K/V within 1e-4): max |diff| {grid_err:.2e}")
    # no kv row at all: l == 0 on every row, written as exactly 0
    q, k, v, nkv = _dense_qkv(torch, gen, 2, 16, 16, h, kvh, d,
                              torch.bfloat16, torch.int8)
    empty = ops.flash_attention(q, k[:, :0], v[:, :0], kv_frac_bits=nkv)
    torch.cuda.synchronize()
    check(int(torch.count_nonzero(empty)) == 0,
          "K5: rows with l == 0 are not exactly 0")
    log("[6] K5 rows with l == 0 (no kv rows) exactly 0")
    res = dict(rows[0], max_abs_err=max_err, long=rows[1], sdpa=sdpa_how,
               grid_cases=grid_n, grid_max_abs_err=grid_err)
    out["k5"] = res
    return res


def _pos(torch, p):
    """K6's position as the kernel takes it: a 0-d int32 on the card."""
    return torch.tensor(p, dtype=torch.int32, device="cuda")


def _k6_grid(torch, gen):
    """K6 against its plain version over GQA groups (16: two row tiles a
    split), head dims, cache and q types, at positions 0, inside one
    split, at split boundaries (a full last split and a last split of one
    or two rows) and 32767, each held at its type's tolerance and, past
    1024 rows, row by row.  The splits are planned for the 32768-row
    cache, so every position but the last leaves splits empty."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import plan_decode_splits
    b, kvh, s_max = 2, 2, 32768
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    positions = (0, 63, 255, 256, 257, 1023, 1024, 1025, s_max - 1)
    splits, chunk = plan_decode_splits(s_max, b, kvh, sms)
    n, worst = 0, 0.0
    for groups in (1, 2, 4, 16):
        for d in (64, 128):
            for q_dt, kv_dt, tol in ((torch.bfloat16, torch.int8, 2e-2),
                                     (torch.bfloat16, torch.bfloat16, 2e-2),
                                     (torch.float32, torch.int8, 1e-4),
                                     (torch.float32, torch.float32, 1e-4)):
                q, k, v, nkv = _dense_qkv(torch, gen, b, 1, s_max,
                                          kvh * groups, kvh, d, q_dt, kv_dt)
                for pos in positions:
                    got = ops.flash_decode(q, k, v, pos=_pos(torch, pos),
                                           kv_frac_bits=nkv)
                    want = ref.flash_decode_ref(q, k, v, pos=pos,
                                                kv_frac_bits=nkv)
                    torch.cuda.synchronize()
                    what = (f"K6 grid G {groups} D {d} {q_dt} q {kv_dt} "
                            f"cache pos {pos}")
                    worst = max(worst, _close(torch, got, want, tol, what))
                    if pos >= 1024:
                        _close_rows(torch, got, want, LONG_ROW_TOL, what)
                    n += 1
                del q, k, v
    return n, worst, (splits, chunk)


def _k6_replays(torch, q, k, v, nkv, tol, positions):
    """One K6 launch captured in a CUDA graph over a staged position,
    then replayed after each of ``positions`` is written into it: each
    replay must give the plain version at that position, which shows the
    kernel reads its position when it runs, not when it was captured.
    Returns the largest |diff|."""
    from repro_torch.kernels import ops, ref
    pos_t = _pos(torch, positions[0])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up outside the capture
        ops.flash_decode(q, k, v, pos=pos_t, kv_frac_bits=nkv)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = ops.flash_decode(q, k, v, pos=pos_t, kv_frac_bits=nkv)
    worst = 0.0
    for p in positions[1:]:
        pos_t.fill_(p)
        graph.replay()
        want = ref.flash_decode_ref(q, k, v, pos=p, kv_frac_bits=nkv)
        torch.cuda.synchronize()
        what = f"K6 graph replay at pos {p} (captured at {positions[0]})"
        worst = max(worst, _close_rows(torch, got, want, tol, what)
                    if p >= 1024 else _close(torch, got, want, tol, what))
    del graph
    return worst


def phase_k6(torch, out):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import plan_decode_splits
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    h, kvh, d = K1_HEADS, K1_KV_HEADS, K1_DIM
    sdpa, sdpa_how = _sdpa(torch)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid_n, grid_err, (g_splits, g_chunk) = _k6_grid(torch, gen)
    log(f"[7] K6 grid ({grid_n} cases: GQA 1/2/4/16, D 64/128, bf16 q over "
        f"int8 / bf16 caches within atol=rtol=2e-2, fp32 q over int8 / fp32 "
        f"within 1e-4, from 1024 rows also within {LONG_ROW_TOL} of each "
        f"row's largest |value|; B 2, KVH 2, {g_splits} splits of {g_chunk} "
        f"rows planned for the 32768-row cache, those past pos empty; pos a "
        f"device int32): max |diff| {grid_err:.2e}")
    # (name, B, S_max, q type, cache type, tolerance, positions, timed
    # positions, replayed positions: the first the capture's)
    cases = [("int8 cache", 4, SERVE_PROMPT + SERVE_GEN, torch.bfloat16,
              torch.int8, 2e-2, (0, 15, 32, 47), (47,), (47, 0, 15, 32)),
             ("int8 cache, fp32 q", 4, 48, torch.float32, torch.int8, 1e-4,
              (0, 15, 32, 47), (), ()),
             ("bf16 cache", 4, 48, torch.bfloat16, torch.bfloat16, 2e-2,
              (0, 15, 32, 47), (), ()),
             ("long int8 cache", 4, K6_LONG, torch.bfloat16, torch.int8,
              LONG_ROW_TOL, (K6_EARLY_POS, K6_LONG - 1),
              (K6_LONG - 1, K6_EARLY_POS),
              (K6_LONG - 1, K6_EARLY_POS, 5000, 0, K6_LONG - 1))]
    rows, max_err, replay_err = [], 0.0, 0.0
    for name, b, s_max, q_dt, kv_dt, tol, positions, timed, replayed \
            in cases:
        q, k, v, nkv = _dense_qkv(torch, gen, b, 1, s_max, h, kvh, d, q_dt,
                                  kv_dt)
        errs, held = [], set()
        for pos in positions:
            got = ops.flash_decode(q, k, v, pos=_pos(torch, pos),
                                   kv_frac_bits=nkv)
            want = ref.flash_decode_ref(q, k, v, pos=pos, kv_frac_bits=nkv)
            torch.cuda.synchronize()
            if pos < 1024:
                errs.append(_close(torch, got, want, tol,
                                   f"K6 {name} pos {pos}"))
                held.add(f"atol=rtol={tol}")
            else:
                errs.append(_close_rows(torch, got, want, tol,
                                        f"K6 {name} pos {pos}"))
                check(_tile_fault_caught(torch, ref.flash_decode_ref, q, k, v,
                                         want, tol, pos // 256, pos=pos,
                                         kv_frac_bits=nkv),
                      f"K6 {name}: the row tolerance passes a repeated kv "
                      "tile")
                held.add(f"{tol} of each row's largest |value|, which a "
                         "repeated kv tile fails")
        # the kernels line reports the error at the path's shape
        if q_dt == torch.bfloat16 and kv_dt == torch.int8 and s_max < 1024:
            max_err = max(max_err, *errs)
        n_splits, chunk = plan_decode_splits(s_max, b, kvh, sms)
        log(f"[7] K6 {name} (B {b}, S_max {s_max}, {q_dt} q, {kv_dt} "
            f"cache; {n_splits} split(s) of {chunk} rows), pos "
            f"{list(positions)}: within {' / '.join(sorted(held))} (max "
            f"|diff| {max(errs):.2e})")
        if replayed:
            err = _k6_replays(torch, q, k, v, nkv, tol, replayed)
            replay_err = max(replay_err, err)
            log(f"[7] K6 {name}: one launch captured at pos {replayed[0]}, "
                f"replayed at pos {list(replayed[1:])} written into its "
                f"staged int32: each replay equals the plain version there "
                f"(max |diff| {err:.2e})")
        for pos in timed:
            pos_t = _pos(torch, pos)
            ms = time_ms(torch, lambda: ops.flash_decode(
                q, k, v, pos=pos_t, kv_frac_bits=nkv), 50)
            plain_ms = time_ms(torch, lambda: ref.flash_decode_ref(
                q, k, v, pos=pos_t, kv_frac_bits=nkv), 5, warmup=1)
            kf = _deq(torch, k[:, :pos + 1], nkv, q_dt).contiguous()
            vf = _deq(torch, v[:, :pos + 1], nkv, q_dt).contiguous()
            lib_ms = time_ms(torch, lambda: sdpa(q, kf, vf, False), 50)
            # the rows this position needs: q, the output and K/V to pos
            n_bytes = (2 * q.numel() * q.element_size()
                       + 2 * b * (pos + 1) * kvh * d * k.element_size())
            n_ops = b * h * 4 * d * (pos + 1)
            b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
            live = -(-(pos + 1) // chunk)
            rows.append(dict(name=name, b=b, s_max=s_max, pos=pos, ms=ms,
                             splits=n_splits, live_splits=live, chunk=chunk,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             max_abs_err=max(errs),
                             bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
                             ops=n_ops))
            log(f"[7] K6 {name} at pos {pos}: {live} of {n_splits} "
                f"split(s) hold rows <= pos, kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, SDPA ({sdpa_how}) on the dequantized "
                f"slice {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
            del kf, vf
        del q, k, v
    res = dict(rows[0], max_abs_err=max_err, long=rows[1],
               long_early=rows[2], sdpa=sdpa_how, grid_cases=grid_n,
               grid_max_abs_err=grid_err, grid_splits=(g_splits, g_chunk),
               replay_max_abs_err=replay_err)
    out["k6"] = res
    return res


# ---------------------------------------------------------------------------
# phases 8 and 9: calibration and the dense model, card against CPU
# ---------------------------------------------------------------------------

SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 32, 16


def _serve_tokens(vocab):
    """The classic path's prompt batch (``launch.serve.serve``'s draw)."""
    from repro_torch.data import SyntheticLMStream
    return SyntheticLMStream(vocab, SERVE_PROMPT, SERVE_BATCH,
                             seed=0).batch(0)["tokens"]


def _calibrate_cfg():
    """Phases 8 and 9's model: qwen3-1.7B's width on 2 layers, fp32, an
    int8 cache, flash attention."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3_1_7b"), n_layers=2,
                               dtype="float32", kv_cache_bits=8,
                               attn_kernel="flash")


def _calibrate_on(params, device):
    """Algorithm 1 of ``_calibrate_cfg`` on ``params`` (on ``device``)
    and the serve prompt: (ctx, report, seconds)."""
    import torch
    from repro_torch.core.lm_calibrate import calibrate_lm
    from repro_torch.models import model as M
    cfg = _calibrate_cfg()
    tokens = torch.from_numpy(_serve_tokens(cfg.vocab_size)).to(device)
    t0 = time.perf_counter()
    ctx, rep = calibrate_lm(lambda p, b, c: M.forward(p, b, cfg, c),
                            params, {"tokens": tokens})
    if device == "cuda":
        torch.cuda.synchronize()
    return ctx, rep, time.perf_counter() - t0


def _calibrate_cpu():
    """Phase 8's CPU side (a CPU reference): the seeded weights and
    Algorithm 1 on them."""
    from repro_torch.models import model as M
    return _calibrate_on(M.init_params(_calibrate_cfg(), 0, device="cpu"),
                         "cpu")


def phase_calibrate(torch, out, cpu=None):
    """Algorithm 1 on the card and on the CPU from the same weights and
    batch (the CPU's run ``cpu``, the future of ``_calibrate_cpu`` on the
    background thread, started here if not given).  Tolerance:
    the fp32 products and attention sums run in other orders on the two
    devices, so a module whose best two candidates' errors nearly tie may
    pick differently; that is accepted only where the two chosen errors
    agree within 1e-4 relative."""
    from repro_torch.models import model as M
    cfg = _calibrate_cfg()
    p_cpu = M.init_params(cfg, 0, device="cpu")
    p_gpu = _tree_to(p_cpu, "cuda")
    cg, rg, tg = _calibrate_on(p_gpu, "cuda")
    cc, rc, tc = (cpu or on_cpu_thread(_calibrate_cpu)).result()
    check(list(cg.table) == list(cc.table), "calibration: module lists")
    ties = []
    for name in cc.table:
        a, b = cg.table[name], cc.table[name]
        if a == b:
            continue
        eg, ec = rg.results[name].error, rc.results[name].error
        rel = abs(eg - ec) / max(ec, 1e-30)
        log(f"[8] calibration {name}: card {a} error {eg!r}, CPU {b} error "
            f"{ec!r} (relative {rel:.2e})")
        check(rel <= 1e-4, f"calibration {name}: card and CPU choose "
              f"differently and their errors differ by {rel:.2e}")
        ties.append(name)
    log(f"[8] calibration ({len(cc.table)} modules, qwen3-1.7B full width, "
        f"2 layers, fp32, {SERVE_BATCH}x{SERVE_PROMPT} tokens): tables "
        f"{'identical' if not ties else f'identical apart from near-ties {ties}'}"
        f"; card {tg:.2f} s, CPU {tc:.2f} s (on a background thread)")
    out["calibration"] = dict(card_s=tg, cpu_s=tc, near_ties=ties,
                              table={k: dataclasses.astuple(v)
                                     for k, v in cc.table.items()})
    return cfg, p_cpu, p_gpu, cc


def phase_dense_model(torch, out, cfg, p_cpu, p_gpu, cal_ctx, *, tag="9",
                      key="dense_model"):
    """prefill + 3 decode steps, both devices fed the same tokens (the
    CPU's greedy choices), in three cases.  Tolerances:

    * INT mode, int8 cache: logits and every cache code identical, as
      phase 4 found for the ragged path (every run so far agreed).
    * FP mode, fp32 cache: phase 4's FP rule, logits within
      atol=rtol=1e-3 in at least 99.9% of entries, all within 5e-2.  No
      code can flip here, so only the fp32 summation orders differ.
    * FP mode, int8 cache: the card and the CPU sum fp32 products and
      softmaxes in different orders, so a K/V value within an ulp of a
      rounding boundary may take the neighbouring code (on an H100, 112
      of the 2x35-position cache's codes come out one step apart), and
      each flipped code moves every later logit of its sequence by about
      1e-3.  So here: every code within one step of the CPU's, at most
      0.1% differing, and logits all within 5e-2; the 1e-3 share is
      printed.  The fp32-cache case shows the rest of the path holds the
      tighter rule."""
    from repro_torch.core.qmodel import QuantMode, quantize_weight_tree
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    tokens = torch.from_numpy(_serve_tokens(cfg.vocab_size))
    max_seq = SERVE_PROMPT + SERVE_GEN
    res = {}
    for mode, kv_bits in (("int", 8), ("fp", None), ("fp", 8)):
        ctx = dataclasses.replace(cal_ctx, mode=QuantMode(mode))
        ccfg = dataclasses.replace(cfg, kv_cache_bits=kv_bits)
        case = f"{mode}, {'int8' if kv_bits else 'fp32'} cache"
        pc, pg = p_cpu, p_gpu
        if ctx.mode is QuantMode.INT:
            pc, pg = quantize_weight_tree(p_cpu, ctx), \
                quantize_weight_tree(p_gpu, ctx)
        prefill = S.build_prefill_step(ccfg, ctx, max_seq=max_seq)
        logits, caches, fed = {}, {}, []
        for dev, params in (("cpu", pc), ("cuda", pg)):
            ops.reset_launch_counts()
            with torch.no_grad():
                lg, cache = prefill(params, {"tokens": tokens.to(dev)})
                seq = [lg.float().cpu()]
                for i in range(3):
                    if dev == "cpu":      # the CPU's greedy token, fed to both
                        fed.append(torch.argmax(seq[-1], -1).to(
                            torch.int32)[:, None])
                    lg, cache = M.decode_step(params, fed[i].to(dev), cache,
                                              SERVE_PROMPT + i, ccfg, ctx)
                    seq.append(lg.float().cpu())
            logits[dev], caches[dev] = seq, cache
            launches = dict(ops.LAUNCHES)
        check(launches["flash_prefill"] == cfg.n_layers
              and launches["flash_decode"] == cfg.n_layers * 3,
              f"dense model {case}: K5/K6 launched "
              f"{launches['flash_prefill']}/{launches['flash_decode']} times, "
              f"want {cfg.n_layers}/{cfg.n_layers * 3}")
        worst_frac = worst_max = 0.0
        for a, b in zip(logits["cuda"], logits["cpu"]):
            check(bool(torch.isfinite(a).all()) and a.shape == b.shape,
                  f"dense model {case}: non-finite or misshapen logits")
            diff = (a - b).abs()
            frac = float(((diff > 0) if mode == "int" else
                          (diff > 1e-3 + 1e-3 * b.abs())).float().mean())
            worst_frac, worst_max = max(worst_frac, frac), \
                max(worst_max, float(diff.max()))
        codes = []                  # (k/v, layer, entries differing, max diff)
        for name, a, b in zip("kv", caches["cuda"]["kv"], caches["cpu"]["kv"]):
            dd = (a.cpu().double() - b.double()).abs()
            codes += [(name, layer, int((dd[layer] > 0).sum()),
                       float(dd[layer].max())) for layer in range(cfg.n_layers)]
        n_codes = 2 * caches["cpu"]["kv"].k.numel()
        identical = worst_max == 0 and not any(c[2] for c in codes)
        log(f"[{tag}] dense model {cfg.name} {case} (prefill "
            f"{SERVE_BATCH}x{SERVE_PROMPT} + "
            f"3 decode steps, 2 layers, full width, fp32, flash): logits max "
            f"|diff| {worst_max:.3e}, {worst_frac:.2e} of entries "
            f"{'differ' if mode == 'int' else 'beyond 1e-3'}; cache entries "
            f"differing (k/v, layer, count, max |diff|) {codes} of "
            f"{n_codes // 4} a layer; launches K5 {launches['flash_prefill']} "
            f"K6 {launches['flash_decode']}"
            + ("; identical" if identical else ""))
        if mode == "int":
            check(identical, f"dense model {case}: card and CPU differ "
                  f"(logits max {worst_max}, cache {codes})")
        elif kv_bits is None:
            check(worst_frac <= 1e-3 and worst_max <= 5e-2,
                  f"dense model {case}: logits beyond 1e-3 in "
                  f"{worst_frac:.2e} of entries, max {worst_max}")
        else:
            check(max(c[3] for c in codes) <= 1
                  and sum(c[2] for c in codes) <= 1e-3 * n_codes,
                  f"dense model {case}: cache codes differ {codes}")
            check(worst_max <= 5e-2, f"dense model {case}: logits differ by "
                  f"up to {worst_max}")
        res[case] = dict(logits_max_abs=worst_max, logits_frac=worst_frac,
                         cache_diff=codes, launches=launches)
    out[key] = res
    return res


# ---------------------------------------------------------------------------
# phases 10 and 11: classic serve and the W8A8 engine at full depth
# ---------------------------------------------------------------------------

def _serve_want(cfg, mode, kv_int8, gen=SERVE_GEN):
    """Kernel launches of one classic ``serve`` call: K5 once a layer in
    prefill (and in INT calibration's forward), K6 once a layer a decode
    step; in INT, K2 once a projection a forward and K3 once a module
    input a layer and the LM head's input, plus its weight when the head
    is the tied embedding (quantized on the fly, as the reference does),
    and K3 once a layer for every int8 K/V write."""
    L, forwards = cfg.n_layers, gen
    k3 = 0
    if mode == "int":
        k3 = (K3_PER_LAYER * L + 1 + int(cfg.tie_embeddings)) * forwards
    elif kv_int8:
        k3 = L * forwards
    return {"flash_prefill": (2 if mode == "int" else 1) * L,
            "flash_decode": L * (gen - 1),
            "int8_matmul": (7 * L + 1) * forwards if mode == "int" else 0,
            "ragged_attention": 0, "paged_attention": 0, "quantize": k3,
            "residual_requant": 0, "int_conv": 0, "int8_matmul_grouped": 0}


def phase_serve(torch, out):
    """Classic ``serve`` of qwen3-1.7B at full depth, INT (calibrated, int8
    cache) and FP (bf16 cache), each run with its decode steps captured
    (``graphs=True``: the first eager, the second captured, the rest
    replays) and eagerly, in turns (graphs, eager, graphs, eager): every
    run token-identical, with the same launches, equal to the formula."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    cfg = get_config("qwen3_1_7b")
    res = {}
    for mode, overrides in (("int", {"kv_cache_bits": 8}), ("fp", None)):
        want = _serve_want(cfg, mode, overrides is not None)
        runs = []
        for rep, graphs in enumerate((True, False, True, False)):
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            o = serve("qwen3_1_7b", batch=SERVE_BATCH,
                      prompt_len=SERVE_PROMPT, gen=SERVE_GEN, mode=mode,
                      calibrate=True, smoke=False, attn_kernel="flash",
                      cfg_overrides=overrides, graphs=graphs, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2**30
            toks, g = o["tokens"], o["graphs"]
            tag = "graphs" if graphs else "eager"
            log(f"[10] serve {mode} run {rep} ({tag}): tokens {toks.shape}, "
                f"prefill {o['prefill_s']:.4f} s, decode "
                f"{1e3 * o['decode_s_per_tok']:.2f} ms/token ("
                + ("replays; first call + capture "
                   if graphs else "every step eager; first step ")
                + f"{1e3 * o['compile_decode_s']:.2f} ms), first calls "
                f"{g['first_calls']} captures {g['captures']} replays "
                f"{g['replays']}, launches K5 {launches['flash_prefill']} K6 "
                f"{launches['flash_decode']} K2 {launches['int8_matmul']} K3 "
                f"{launches['quantize']}, peak {peak:.2f} GiB, {wall:.1f} s")
            check(toks.shape == (SERVE_BATCH, SERVE_GEN)
                  and int(toks.min()) >= 0
                  and int(toks.max()) < cfg.vocab_size,
                  f"serve {mode}: tokens {toks}")
            check(launches == want, f"serve {mode} {tag}: launches "
                  f"{launches}, want {want}")
            check(g == dict(enabled=graphs, first_calls=int(graphs),
                            captures=int(graphs),
                            replays=SERVE_GEN - 2 if graphs else 0),
                  f"serve {mode} {tag}: step graphs {g}")
            runs.append(dict(graphs=graphs, tokens=toks, launches=launches,
                             prefill_s=o["prefill_s"],
                             decode_s_per_tok=o["decode_s_per_tok"],
                             first_decode_s=o["compile_decode_s"],
                             peak_gib=peak, wall_s=wall))
            del o
            torch.cuda.empty_cache()
        check(all((r["tokens"] == runs[0]["tokens"]).all() for r in runs),
              f"serve {mode}: graphs and eager runs, or repeats, gave "
              "other tokens")
        log(f"[10] serve {mode}: graphs and eager runs token-identical, "
            f"decode {[round(1e3 * r['decode_s_per_tok'], 3) for r in runs]}"
            f" ms/token (graphs, eager, graphs, eager)")
        res[mode] = runs
    out["serve"] = res
    return res


def phase_w8a8(torch, out):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_engine
    cfg = get_config("qwen3_1_7b")
    runs = []
    for rep in range(2):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        o = serve_engine("qwen3_1_7b", smoke=False, w8a8=True,
                         n_requests=8, n_slots=4, rate=1e9, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        r = o["report"]
        steps = r["ragged_steps"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[11] w8a8 engine run {rep}: {r['completed']} requests, "
            f"{r['gen_tokens']} tokens, {r['tokens_per_s']} tok/s, {steps} "
            f"ragged steps, launches K1 {launches['ragged_attention']} K2 "
            f"{launches['int8_matmul']} K3 {launches['quantize']}, TTFT p50 "
            f"{r['ttft_s']['p50']:.4f} s, TPOT p50 {r['tpot_s']['p50']:.4f} s, "
            f"{len(o['quantized'].converted)} weight tensors as int8 codes, "
            f"peak {peak:.2f} GiB, {wall:.1f} s")
        check(r["completed"] == 8, "w8a8 engine: not all done")
        check(launches["ragged_attention"] == cfg.n_layers * steps
              and launches["int8_matmul"] == (7 * cfg.n_layers + 1) * steps
              and launches["quantize"]
              == (K3_PER_LAYER * cfg.n_layers + 1) * steps
              and r["kernel_launches"] == {
                  k: launches[k] for k in r["kernel_launches"]},
              f"w8a8 engine: launches {launches} over {steps} steps")
        check(len(o["quantized"].converted) == 7 * cfg.n_layers + 1,
              "w8a8 engine: not every matmul weight is int8 codes")
        runs.append((o["outputs"], launches, r, peak, wall))
        del o
        torch.cuda.empty_cache()
    (a, *_), (b, *_) = runs
    check(sorted(a) == sorted(b)
          and all(len(a[k]) == len(b[k]) and (a[k] == b[k]).all() for k in a),
          "w8a8 engine: a repeated greedy run gave other tokens")
    log("[11] w8a8 engine: repeat run token-identical")
    res = dict(launches=runs[0][1], report=runs[0][2], peak_gib=runs[0][3],
               wall_s=runs[0][4], report_repeat=runs[1][2])
    out["w8a8_engine"] = res
    return res


# ---------------------------------------------------------------------------
# phases 12-14: the paper's ResNet path (K3, K7, K2 on uint8 activations)
# ---------------------------------------------------------------------------

def _resnet_shapes(cfg, batch):
    """The integer forward's shapes at ``batch``: the image, the head's
    input, each residual add's (shape, branch dtype, shortcut dtype) and
    each convolution's (name, input (B, H, W, Cin), Cout, k, stride, input
    dtype, shortcut dtype or None), the latter for each block's conv2,
    which carries the add as its epilogue; in the forward's order."""
    import torch
    u8, i8 = torch.uint8, torch.int8
    side, adds = cfg.img_size, []
    convs = [("stem", (batch, side, side, 3), cfg.stages[0], 3, 1, i8, None)]
    cin, bi = cfg.stages[0], 0
    for si, ch in enumerate(cfg.stages):
        for blk in range(cfg.blocks_per_stage):
            stride = 2 if (blk == 0 and si > 0) else 1
            side_o = -(-side // stride)
            x_in, h1 = (batch, side, side, cin), (batch, side_o, side_o, ch)
            convs.append((f"b{bi}/conv1", x_in, ch, 3, stride, u8, None))
            if cin != ch:
                convs.append((f"b{bi}/proj", x_in, ch, 1, stride, u8, None))
            sc = i8 if cin != ch else u8
            convs.append((f"b{bi}/conv2", h1, ch, 3, 1, u8, sc))
            adds.append((h1, i8, sc))
            side, cin, bi = side_o, ch, bi + 1
    return ((batch, cfg.img_size, cfg.img_size, 3), (batch, cfg.stages[-1]),
            adds, convs)


def _exact(got, want, what) -> int:
    """The largest code difference of a kernel against its plain version,
    which must be 0 with the same output type."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: output {got.dtype} {tuple(got.shape)}, plain "
          f"{want.dtype} {tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    check(err == 0, f"{what}: kernel != plain (max |diff| {err})")
    return err


def _codes(torch, gen, shape, dtype):
    lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
    return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                         dtype=torch.int32).to(dtype)


def phase_cnn_kernels(torch, out):
    """K3 and K7 bit-exact against their plain versions at the ResNet
    path's shapes (and misaligned views, which take the scalar loop) and
    at one 64M-element shape; the convolution kernel bit-exact against its
    plain version and the im2col + K2 (+ K7) chain it replaced at every
    convolution of the path and the odd cases (``_conv_kernel_checks``).
    Times per forward at batch 256 sum the path's launches, each shape
    timed alone; K7's standalone launches are no longer the path's."""
    from repro_torch.configs.resnet_paper import CONFIG
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    img, head_in, adds, convs = _resnet_shapes(CONFIG, RESNET_BATCH)
    res = {}

    # K3: the image (fp32 in [0, 1) on the 2^-7 grid, as the path's n_in)
    # and the pooled head input, plus .5 ties on the grid and bf16 input
    def k3_case(shape, n, dtype=torch.float32):
        x = torch.rand(shape, generator=gen, device="cuda") * 1.7
        flat = x.view(-1)
        k = min(flat.numel(), 4096)
        flat[:k] = (torch.randint(-300, 300, (k,), generator=gen,
                                  device="cuda") + 0.5) * 2.0 ** -n
        return x.to(dtype)

    k3 = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0, "shapes": [],
          "max_abs_err": 0}
    for name, shape, n in (("image", img, 7), ("head input", head_in, 5)):
        x = k3_case(shape, n)
        for bits, uns, dt in ((8, False, torch.float32),
                              (8, True, torch.float32),
                              (8, False, torch.bfloat16)):
            xx = x.to(dt)
            for v in (xx, xx.view(-1)[1:]):
                k3["max_abs_err"] = max(k3["max_abs_err"], _exact(
                    ops.quantize_act(v, n, bits, uns),
                    ref.quantize_ref(v, n=n, bits=bits, unsigned=uns),
                    f"K3 {name} {tuple(v.shape)} bits {bits} unsigned "
                    f"{uns} {dt}"))
        ms = time_ms(torch, lambda: ops.quantize_act(x, n, 8), 50)
        plain_ms = time_ms(torch, lambda: ref.quantize_ref(x, n=n), 20)
        n_bytes, n_ops = 5 * x.numel(), 4 * x.numel()
        b_ms, b_by = bound_ms(n_bytes, n_ops, "float32")
        k3["ms"] += ms
        k3["plain_ms"] += plain_ms
        k3["bytes"] += n_bytes
        k3["ops"] += n_ops
        k3["shapes"].append(dict(name=name, shape=list(shape), ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms))
        log(f"[12] K3 {name} {tuple(shape)} fp32 -> int8: bit-exact (also "
            f"uint8, bf16, a misaligned view) | kernel {ms:.4f} ms,"
            f" plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    k3["bound_ms"], k3["bound_by"] = bound_ms(k3["bytes"], k3["ops"],
                                              "float32")
    x = k3_case((ELEMWISE_LONG,), 5)
    _exact(ops.quantize_act(x, 5, 8), ref.quantize_ref(x, n=5), "K3 long")
    ms = time_ms(torch, lambda: ops.quantize_act(x, 5, 8), 10)
    plain_ms = time_ms(torch, lambda: ref.quantize_ref(x, n=5), 3, warmup=1)
    b_ms, b_by = bound_ms(5 * x.numel(), 4 * x.numel(), "float32")
    k3["long"] = dict(elements=x.numel(), ms=ms, plain_ms=plain_ms,
                      bound_ms=b_ms, bound_by=b_by)
    log(f"[12] K3 {x.numel()} fp32 -> int8: bit-exact | kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    log(f"[12] K3 one forward (2 launches): kernel {k3['ms']:.4f} ms, plain "
        f"{k3['plain_ms']:.4f} ms, bound {k3['bound_ms']:.5f} ms")
    del x
    res["k3"] = k3

    # K7: each add's shapes and operand dtypes, both semantics, the
    # path's grids and an overflowing negative shift; then one long shape
    k7 = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0, "shapes": [],
          "max_abs_err": 0}
    grids = ((7, 6, 7), (6, 7, 6), (0, 20, 30))
    for i, (shape, da, db) in enumerate(adds):
        a, b = _codes(torch, gen, shape, da), _codes(torch, gen, shape, db)
        for grid in grids:
            for relu in (True, False):
                for sat in (True, False):
                    kw = dict(n_a=grid[0], n_b=grid[1], n_o=grid[2],
                              relu=relu, saturate=sat)
                    for aa, bb in ((a, b), (a.view(-1)[1:], b.view(-1)[1:])):
                        k7["max_abs_err"] = max(k7["max_abs_err"], _exact(
                            ops.residual_requant(aa, bb, **kw),
                            ref.residual_requant_ref(aa, bb, **kw),
                            f"K7 add {i} {tuple(aa.shape)} {grid} relu "
                            f"{relu} saturate {sat}"))
        kw = dict(n_a=7, n_b=6, n_o=7, relu=True, saturate=True)
        ms = time_ms(torch, lambda: ops.residual_requant(a, b, **kw), 50)
        plain_ms = time_ms(torch, lambda: ref.residual_requant_ref(a, b, **kw),
                           20)
        n_bytes, n_ops = 3 * a.numel(), 10 * a.numel()
        k7["ms"] += ms
        k7["plain_ms"] += plain_ms
        k7["bytes"] += n_bytes
        k7["ops"] += n_ops
        k7["shapes"].append(dict(shape=list(shape), a=str(da), b=str(db),
                                 ms=ms, plain_ms=plain_ms))
        log(f"[12] K7 add {i} {tuple(shape)} {str(da)[6:]} + {str(db)[6:]}: "
            f"bit-exact (grids {list(grids)}, ReLU on/off, both left-shift "
            f"semantics, misaligned) | kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
    k7["bound_ms"], k7["bound_by"] = bound_ms(k7["bytes"], k7["ops"],
                                              "float32")
    a = _codes(torch, gen, (ELEMWISE_LONG,), torch.int8)
    b = _codes(torch, gen, (ELEMWISE_LONG,), torch.uint8)
    kw = dict(n_a=7, n_b=6, n_o=7, relu=True, saturate=True)
    _exact(ops.residual_requant(a, b, **kw),
           ref.residual_requant_ref(a, b, **kw), "K7 long")
    ms = time_ms(torch, lambda: ops.residual_requant(a, b, **kw), 10)
    plain_ms = time_ms(torch, lambda: ref.residual_requant_ref(a, b, **kw), 3,
                       warmup=1)
    b_ms, b_by = bound_ms(3 * a.numel(), 10 * a.numel(), "float32")
    k7["long"] = dict(elements=a.numel(), ms=ms, plain_ms=plain_ms,
                      bound_ms=b_ms, bound_by=b_by)
    log(f"[12] K7 {a.numel()} int8 + uint8: bit-exact | kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    log(f"[12] K7 one forward (6 launches): kernel {k7['ms']:.4f} ms, plain "
        f"{k7['plain_ms']:.4f} ms, bound {k7['bound_ms']:.5f} ms "
        f"({k7['bound_by']}, {k7['bytes'] / 1e6:.1f} MB)")
    del a, b
    res["k7"] = k7

    res["conv"] = _conv_kernel_checks(torch, gen, convs, sms)
    out["cnn_kernels"] = res
    return res


def _conv_chain(torch, x, w, b, spec, stride, relu, residual):
    """The design the convolution kernel replaced: the im2col gather in
    plain PyTorch, K2 over it, then K7 for a residual add."""
    from repro_torch.core.integer_ops import im2col_same
    from repro_torch.kernels import ops
    kh, kw, cin, cout = w.shape
    cols, (bsz, ho, wo) = im2col_same(x, kh, kw, stride)
    h = ops.int8_matmul(cols, w.reshape(kh * kw * cin, cout), b, spec,
                        relu=relu).reshape(bsz, ho, wo, cout)
    if residual is None:
        return h
    sc, n_a, n_b, n_o = residual
    return ops.residual_requant(h, sc, n_a=n_a, n_b=n_b, n_o=n_o, relu=True,
                                saturate=True)


def _conv_held(torch, acc, x, w, b, spec, stride, relu, residual, what):
    """The convolution kernel against its plain version and the old chain
    (im2col + K2 (+ K7)), bit for bit; adds its checks to ``acc["checks"]``
    and its largest code difference to ``acc["max_abs_err"]``; returns the
    kernel's output."""
    from repro_torch.kernels import ops, ref
    got = ops.int_conv2d(x, w, b, spec, stride=stride, relu=relu,
                         residual=residual)
    errs = (_exact(got, ref.int_conv2d_ref(x, w, b, spec, stride=stride,
                                           relu=relu, residual=residual),
                   f"{what} vs plain"),
            _exact(got, _conv_chain(torch, x, w, b, spec, stride, relu,
                                    residual),
                   f"{what} vs im2col + K2" + (" + K7" if residual else "")))
    acc["checks"] += len(errs)
    acc["max_abs_err"] = max(acc["max_abs_err"], *errs)
    return got


def _conv_variants(torch, acc, gen, shape, cout, k, stride, xdt, what,
                   x=None):
    """One convolution shape through every epilogue: K2_GRID_SPECS' four
    plain epilogues, then the residual epilogue with an int8 and a uint8
    shortcut on each of CONV_RES_GRIDS; accumulates into ``acc`` as
    ``_conv_held``."""
    from repro_torch.core.integer_ops import LinearQuantSpec
    x = _codes(torch, gen, shape, xdt) if x is None else x
    w = _codes(torch, gen, (k, k, shape[3], cout), torch.int8)
    b = _codes(torch, gen, (cout,), torch.int8)
    ho = -(-shape[1] // stride)
    for sname, skw, relu in K2_GRID_SPECS:
        spec = LinearQuantSpec(**skw)
        _conv_held(torch, acc, x, w, b, spec, stride, relu, None,
                   f"{what} {sname}")
    spec = LinearQuantSpec(**K2_GRID_SPECS[1][1])
    for scdt in (torch.int8, torch.uint8):
        sc = _codes(torch, gen, (shape[0], ho, ho, cout), scdt)
        for grid in CONV_RES_GRIDS:
            _conv_held(torch, acc, x, w, b, spec, stride, False, (sc, *grid),
                       f"{what} + {str(scdt)[6:]} shortcut {grid}")


def _conv_kernel_checks(torch, gen, convs, sms):
    """The convolution kernel bit-exact against its plain version and the
    im2col + K2 (+ K7) chain at every convolution of the path (batch 256)
    and the odd cases; each path convolution timed in its path form (the
    kernel, the old chain, the plain version) beside its bound, conv2 also
    without its residual epilogue; sums per forward."""
    from repro_torch.core.integer_ops import LinearQuantSpec
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.int_conv import plan_int_conv
    conv = {"ms": 0.0, "chain_ms": 0.0, "plain_ms": 0.0, "bytes": 0,
            "ops": 0, "checks": 0, "shapes": [], "conv2_ms": 0.0,
            "conv2_plain_epilogue_ms": 0.0, "max_abs_err": 0}
    relu_spec = LinearQuantSpec(**K2_GRID_SPECS[2][1])
    signed_spec = LinearQuantSpec(**K2_GRID_SPECS[1][1])
    for name, shape, cout, k, stride, xdt, scdt in convs:
        what = f"conv {name} {shape}->{cout} k{k} s{stride}"
        checks0 = conv["checks"]
        _conv_variants(torch, conv, gen, shape, cout, k, stride, xdt, what)
        # the path's form: ReLU + uint8 out on conv1 and the stem, signed on
        # the projection, the residual epilogue on conv2
        x = _codes(torch, gen, shape, xdt)
        w = _codes(torch, gen, (k, k, shape[3], cout), torch.int8)
        b = _codes(torch, gen, (cout,), torch.int8)
        plan = plan_int_conv(*shape, cout, k, k, stride, sms)
        relu = name == "stem" or name.endswith("conv1")
        spec = relu_spec if relu else signed_spec
        residual = None
        if scdt is not None:
            residual = (_codes(torch, gen, (shape[0], plan.ho, plan.wo, cout),
                               scdt), *CONV_RES_GRIDS[0])
        args = (x, w, b, spec, stride, relu, residual)
        _conv_held(torch, conv, *args, f"{what} path form")
        n = conv["checks"] - checks0

        def kernel(res=residual):
            return ops.int_conv2d(x, w, b, spec, stride=stride, relu=relu,
                                  residual=res)
        ms = time_ms(torch, kernel, 20)
        chain_ms = time_ms(torch, lambda: _conv_chain(torch, *args), 10)
        plain_ms = time_ms(torch, lambda: ref.int_conv2d_ref(
            x, w, b, spec, stride=stride, relu=relu, residual=residual), 3,
            warmup=1)
        n_bytes = (x.numel() + w.numel() + cout + plan.m * cout
                   * (1 if residual is None else 2))
        n_ops = 2 * plan.m * plan.k * cout
        b_ms, b_by = bound_ms(n_bytes, n_ops, "int8")
        row = dict(name=name, shape=list(shape), cout=cout, k=k,
                   stride=stride, x=str(xdt), shortcut=str(scdt), ms=ms,
                   chain_ms=chain_ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, tile=[plan.bm, plan.bn],
                   grid=list(plan.grid), checks=n)
        extra = ""
        if residual is not None:
            row["plain_epilogue_ms"] = time_ms(torch, lambda: kernel(None),
                                               20)
            conv["conv2_ms"] += ms
            conv["conv2_plain_epilogue_ms"] += row["plain_epilogue_ms"]
            extra = (f" (without the residual epilogue "
                     f"{row['plain_epilogue_ms']:.4f} ms)")
        for key, v in (("ms", ms), ("chain_ms", chain_ms),
                       ("plain_ms", plain_ms), ("bytes", n_bytes),
                       ("ops", n_ops)):
            conv[key] += v
        conv["shapes"].append(row)
        log(f"[12] {what} {str(xdt)[6:]}"
            f"{'' if scdt is None else ' + ' + str(scdt)[6:] + ' shortcut'}:"
            f" bit-exact ({n} checks vs plain and im2col + K2"
            f"{' + K7' if scdt is not None else ''}), tile {plan.bm}x"
            f"{plan.bn}, grid {plan.grid} | kernel {ms:.4f} ms{extra}, old "
            f"chain {chain_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.5f} ms ({b_by})")
        del x, w, b, residual, args
    for label, shape, cout, k, stride, xdt in CONV_ODD:
        _conv_variants(torch, conv, gen, shape, cout, k, stride,
                       torch.uint8 if xdt == "u8" else torch.int8,
                       f"conv {label}")
    # misaligned operands (a view one byte into its buffer): the byte
    # gather for the input, byte loads and stores for the shortcut / output
    shape = (2, 9, 9, 16)
    buf = _codes(torch, gen, (math.prod(shape) + 1,), torch.uint8)
    x = buf[1:].view(shape)
    check(x.data_ptr() % 16 != 0, "misaligned case is aligned")
    _conv_variants(torch, conv, gen, shape, 16, 3, 1, torch.uint8,
                   "conv misaligned input", x=x)
    w = _codes(torch, gen, (3, 3, 16, 16), torch.int8)
    scb = _codes(torch, gen, (math.prod(shape) + 1,), torch.int8)
    _conv_held(torch, conv, x, w, None, signed_spec, 1, False,
               (scb[1:].view(shape), *CONV_RES_GRIDS[0]),
               "conv misaligned input and shortcut, no bias")
    # Table 4's 7 bits: the branch clipped to 7-bit codes, the add still
    # emitting 8-bit ones (the reference's int_residual_add default)
    spec7 = LinearQuantSpec(**{**K2_GRID_SPECS[1][1], "bits": 7})
    got = _conv_held(torch, conv, x, w, _codes(torch, gen, (16,), torch.int8),
                     spec7, 1, False,
                     (_codes(torch, gen, shape, torch.uint8), 7, 7, 7),
                     "conv 7-bit branch, 8-bit residual add")
    check(int(got.max()) > 127, "7-bit case: no add output past 127")
    conv["bound_ms"], conv["bound_by"] = bound_ms(conv["bytes"], conv["ops"],
                                                  "int8")
    log(f"[12] conv kernel: {conv['checks']} checks bit-exact (max |diff| "
        f"{conv['max_abs_err']}) "
        f"at the path's {len(convs)} convolutions and {len(CONV_ODD) + 3} "
        f"odd cases")
    log(f"[12] conv kernel one forward ({len(convs)} launches): kernel "
        f"{conv['ms']:.4f} ms, old chain (im2col + K2, + K7 at conv2) "
        f"{conv['chain_ms']:.4f} ms, plain {conv['plain_ms']:.4f} ms, bound "
        f"{conv['bound_ms']:.5f} ms ({conv['bound_by']}, "
        f"{conv['bytes'] / 1e6:.1f} MB, {conv['ops'] / 1e9:.2f} G int8 "
        f"operations); the conv2s {conv['conv2_ms']:.4f} ms with the "
        f"residual epilogue, {conv['conv2_plain_epilogue_ms']:.4f} without")
    return conv


def _resnet_images(cfg, batch):
    import numpy as np
    return np.random.default_rng(13).uniform(
        0, 1, size=(batch, cfg.img_size, cfg.img_size, 3)).astype(np.float32)


def phase_resnet_calibrate(torch, out):
    """Algorithm 1 on the card and on the CPU from the same weights and
    images, with phase 8's near-tie rule: the card's cuDNN and the CPU's
    convolutions sum in other orders, so a module whose best candidates
    nearly tie may pick differently; that is accepted only where the two
    chosen errors agree within 1e-4 relative."""
    from repro_torch.configs.resnet_paper import CONFIG
    from repro_torch.models import resnet as R
    gen = torch.Generator()
    gen.manual_seed(0)
    p_cpu = R.init_resnet(CONFIG, generator=gen, device="cpu")
    p_gpu = _tree_to(p_cpu, "cuda")
    x = torch.from_numpy(_resnet_images(CONFIG, RESNET_CALIB_BATCH))
    res = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        t0 = time.perf_counter()
        q = R.quantize_resnet(params, x.to(dev), CONFIG)
        if dev == "cuda":
            torch.cuda.synchronize()
        res[dev] = (q, time.perf_counter() - t0)
    (qg, tg), (qc, tc) = res["cuda"], res["cpu"]
    check(list(qg.specs) == list(qc.specs), "resnet calibration: modules")
    ties = []
    for name in qc.specs:
        if qg.specs[name] == qc.specs[name]:
            continue
        eg = qg.report.results[name].error
        ec = qc.report.results[name].error
        rel = abs(eg - ec) / max(ec, 1e-30)
        log(f"[13] calibration {name}: card {qg.specs[name]} error {eg!r}, "
            f"CPU {qc.specs[name]} error {ec!r} (relative {rel:.2e})")
        check(rel <= 1e-4, f"resnet calibration {name}: card and CPU choose "
              f"differently and their errors differ by {rel:.2e}")
        ties.append(name)
    log(f"[13] ResNet calibration ({len(qc.specs)} modules, CONFIG width, "
        f"batch {RESNET_CALIB_BATCH}): tables "
        f"{'identical' if not ties else f'identical apart from near-ties {ties}'}"
        f"; card {tg:.2f} s, CPU {tc:.2f} s")
    out["resnet_calibration"] = dict(
        card_s=tg, cpu_s=tc, near_ties=ties,
        table={k: v if isinstance(v, tuple) else dataclasses.astuple(v)
               for k, v in qc.specs.items()})
    return qg


def phase_resnet_forward(torch, out, q_gpu):
    """The card's calibration artifact, run by the integer forward on the
    card (the kernels) and by the CPU's plain path: every integer op is
    exact, so the logits must be identical.  Two cold card runs, each with
    the launch counts reset just before and read just after (the
    convolution kernel 15, K2 1 (the head), K3 2, K7 0: every residual add
    is a conv2's epilogue); then RESNET_WARM warm forwards on the host
    clock (median and spread) and the device time of one forward (CUDA
    events, the launches queued behind a sleep kernel), which tells the
    host's share from the card's."""
    from repro_torch.configs.resnet_paper import CONFIG
    from repro_torch.kernels import ops
    from repro_torch.models import resnet as R
    x = torch.from_numpy(_resnet_images(CONFIG, RESNET_BATCH))
    q_cpu = R.QuantizedResNet(
        weights={k: v.cpu() for k, v in q_gpu.weights.items()},
        biases={k: v.cpu() for k, v in q_gpu.biases.items()},
        specs=q_gpu.specs, report=q_gpu.report, n_in=q_gpu.n_in)
    t0 = time.perf_counter()
    want = R.resnet_int_forward(q_cpu, x, CONFIG)
    cpu_s = time.perf_counter() - t0
    xg = x.cuda()
    want_launches = {"int_conv": 15, "int8_matmul": 1, "residual_requant": 0,
                     "quantize": 2, "ragged_attention": 0,
                     "paged_attention": 0, "flash_prefill": 0,
                     "flash_decode": 0, "int8_matmul_grouped": 0}
    runs = []
    for rep in range(2):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits = R.resnet_int_forward(q_gpu, xg, CONFIG)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        got = logits.cpu()
        check(got.shape == (RESNET_BATCH, CONFIG.n_classes)
              and bool(torch.isfinite(got).all()),
              f"resnet forward: logits {tuple(got.shape)} not finite")
        check(torch.equal(got, want), f"resnet forward run {rep}: card "
              f"logits differ from the CPU's (max |diff| "
              f"{float((got - want).abs().max())})")
        check(launches == want_launches,
              f"resnet forward: launches {launches}, want {want_launches}")
        runs.append(dict(logits=got, launches=launches, wall_s=wall,
                         images_per_s=RESNET_BATCH / wall))
        log(f"[14] ResNet int forward run {rep} (CONFIG, batch "
            f"{RESNET_BATCH}, cold): logits identical to the CPU's; launches"
            f" conv {launches['int_conv']} K2 {launches['int8_matmul']} K7 "
            f"{launches['residual_requant']} K3 {launches['quantize']}; "
            f"{wall * 1e3:.2f} ms, {RESNET_BATCH / wall:.1f} images/s (CPU "
            f"plain path {cpu_s:.2f} s, {RESNET_BATCH / cpu_s:.1f} images/s)")
    check(torch.equal(runs[0]["logits"], runs[1]["logits"]),
          "resnet forward: a repeated run gave other logits")
    warm = []
    for _ in range(RESNET_WARM):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = R.resnet_int_forward(q_gpu, xg, CONFIG)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        check(torch.equal(logits.cpu(), want),
              "resnet forward: a warm run gave other logits")
    warm.sort()
    med = warm[len(warm) // 2]
    device_ms = time_ms(torch, lambda: R.resnet_int_forward(q_gpu, xg,
                                                            CONFIG), 10)
    log(f"[14] ResNet int forward, {RESNET_WARM} warm runs: median "
        f"{med * 1e3:.3f} ms ({RESNET_BATCH / med:.1f} images/s), spread "
        f"{warm[0] * 1e3:.3f}-{warm[-1] * 1e3:.3f} ms; device time of one "
        f"forward {device_ms:.4f} ms ({RESNET_BATCH / device_ms * 1e3:.1f} "
        f"images/s at the card's pace); host share of the warm median "
        f"{1 - device_ms / (med * 1e3):.3f}; logits identical every run")
    res = dict(launches=runs[0]["launches"], cpu_s=cpu_s,
               runs=[{k: v for k, v in r.items() if k != "logits"}
                     for r in runs],
               warm_s=warm, warm_median_s=med,
               warm_images_per_s=RESNET_BATCH / med, device_ms=device_ms)
    out["resnet_forward"] = res
    return res


# ---------------------------------------------------------------------------
# phases 15-17: the legacy per-shape engine and speculative decoding (K4)
# ---------------------------------------------------------------------------

def _k4_case(torch, gen, b, c, h, kvh, d, bs, nbmax, last, q_dt, kv_dt,
             spec=False, padded_slot=None):
    """q (B, C, H, D) at positions ``last[b] - C + 1 .. last[b]`` (floored
    at 0) over a shuffled pool whose tables hold only the blocks a slot's
    positions need, trash after them; ``padded_slot`` gets an all-trash
    table at position 0; with ``spec`` the table has one trash column more
    and the last slot's last query sits on it (a padded draft row)."""
    from repro_torch.core.qscheme import quant
    nb = 1 + b * nbmax
    q = torch.randn((b, c, h, d), generator=gen, device="cuda").to(q_dt)
    kf = torch.randn((nb, bs, kvh, d), generator=gen, device="cuda")
    vf = torch.randn((nb, bs, kvh, d), generator=gen, device="cuda")
    if kv_dt == torch.int8:
        kp, vp = quant(kf, KV_FRAC_BITS), quant(vf, KV_FRAC_BITS)
    else:
        kp, vp = kf.to(kv_dt), vf.to(kv_dt)
    del kf, vf
    perm = (torch.randperm(nb - 1, generator=gen, device="cuda") + 1).to(
        torch.int32).reshape(b, nbmax)
    w = nbmax + 1 if spec else nbmax
    bt = torch.zeros((b, w), dtype=torch.int32, device="cuda")
    pos = torch.zeros((b, c), dtype=torch.int32, device="cuda")
    for i in range(b):
        if i == padded_slot:
            continue
        p = [max(last[i] - c + 1 + j, 0) for j in range(c)]
        pos[i] = torch.tensor(p, dtype=torch.int32)
        live = p[-1] // bs + 1
        bt[i, :live] = perm[i, :live]
    if spec:
        pos[b - 1, -1] = nbmax * bs
    nkv = KV_FRAC_BITS if kv_dt == torch.int8 else None
    return (q, kp, vp, bt, pos), nkv


def _k4_work(args):
    """Bytes K4 must move (q in, out, the kv rows its queries see, tables,
    positions) and its operations (QK and PV), from this case's data."""
    q, kp, vp, bt, pos = args
    b, c, h, d = q.shape
    bs, kvh = kp.shape[1], kp.shape[2]
    seen = (pos.max(dim=1).values.clamp(max=bt.shape[1] * bs - 1) + 1)
    n_bytes = (2 * q.numel() * q.element_size()
               + int(seen.sum()) * kvh * 2 * d * kp.element_size()
               + 4 * (bt.numel() + pos.numel()))
    n_ops = int((pos.clamp(max=bt.shape[1] * bs - 1) + 1).sum()) * h * 4 * d
    return n_bytes, n_ops


def _gather_sdpa(torch, args, nkv, mask, gqa):
    """The yardstick, two calls: gather + dequantize every block the tables
    name, then ``scaled_dot_product_attention`` under ``mask`` (B, 1, C,
    W * bs), True where a kv row is visible: the same function as K4."""
    F = torch.nn.functional
    q, kp, vp, bt, pos = args
    b, c, h, d = q.shape
    w, bs, kvh = bt.shape[1], kp.shape[1], kp.shape[2]
    k = _deq(torch, kp[bt.long()].reshape(b, w * bs, kvh, d), nkv, q.dtype)
    v = _deq(torch, vp[bt.long()].reshape(b, w * bs, kvh, d), nkv, q.dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if gqa:
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    g = h // kvh
    return F.scaled_dot_product_attention(
        qt, kt.repeat_interleave(g, 1), vt.repeat_interleave(g, 1),
        attn_mask=mask)


def _table_fault_caught(torch, plain, args, want, rel, nkv, col):
    """The plain version over tables whose column ``col`` names the block
    of column ``col - 1`` (a kernel that reads one pool block twice and
    skips the next) must fall outside the row tolerance."""
    q, kp, vp, bt, pos = args
    bad_bt = bt.clone()
    bad_bt[:, col] = bt[:, col - 1]
    bad = plain(q, kp, vp, bad_bt, pos, kv_frac_bits=nkv)
    return not _rows_within(torch, bad, want, rel)


def _k4_held(torch, args, nkv, tol, what, rows=False):
    """K4 on the plan of its positions (planned once, as the engine
    plans) against its plain version and the split-and-combine twin on the
    same plan, within atol = rtol = ``tol`` (and, with ``rows``, within
    LONG_ROW_TOL of each row's largest |value|); the plan padded to its
    shape's capacity bit-identical to it.  Returns (max |diff|, host plan,
    kernel output, plain output)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (paged_capacity,
                                                     paged_plan_from_positions)
    q, kp, _, bt, pos = args
    work = paged_plan_from_positions(pos, table_width=bt.shape[1],
                                     block_size=kp.shape[1],
                                     groups=q.shape[2] // kp.shape[2])
    got = ops.paged_attention(*args, kv_frac_bits=nkv, work=work.to("cuda"))
    want = ref.paged_attention_ref(*args, kv_frac_bits=nkv)
    split = ref.paged_attention_split_ref(*args, work=work, kv_frac_bits=nkv)
    torch.cuda.synchronize()
    err = 0.0
    for name, plain in (("plain", want), ("split plain", split)):
        err = max(err, _close(torch, got, plain, tol, f"{what} vs {name}"))
        if rows:
            _close_rows(torch, got, plain, LONG_ROW_TOL, f"{what} vs {name}")
    cap = paged_capacity(*pos.shape, groups=q.shape[2] // kp.shape[2],
                         table_width=bt.shape[1], block_size=kp.shape[1])
    _padded_same(torch, lambda w: ops.paged_attention(
        *args, kv_frac_bits=nkv, work=w), got, work, cap, what)
    return err, work, got, want


def _k4_timed(torch, name, args, nkv, iters, sdpa_how, long=False):
    """One K4 shape held (``_k4_held``, atol = rtol = 2e-2 for bf16 q, and
    with ``long`` the row tolerance a repeated pool block fails), then
    timed: the list padded to its shape's capacity (the launch a captured
    engine step makes) and unpadded, the plain version, gather +
    dequantize + SDPA, and the bound of this case's work."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import paged_capacity
    from repro_torch.kernels.ragged_flash import pad_work
    q, kp, _, bt, pos = args
    b, c, h, _ = q.shape
    err, work, got, want = _k4_held(torch, args, nkv, 2e-2, f"K4 {name}",
                                    rows=long)
    if long:
        check(work.n_combine == b and _table_fault_caught(
                  torch, ref.paged_attention_ref, args, want,
                  LONG_ROW_TOL, nkv, bt.shape[1] // 2),
              f"K4 {name}: not split, or the row tolerance passes a "
              f"repeated pool block")
    work_d = work.to("cuda")
    padded = pad_work(work, paged_capacity(
        b, c, groups=h // kp.shape[2], table_width=bt.shape[1],
        block_size=kp.shape[1]))
    padded_d = padded.to("cuda")
    ms = time_ms(torch, lambda: ops.paged_attention(
        *args, kv_frac_bits=nkv, work=work_d), iters)
    padded_ms = time_ms(torch, lambda: ops.paged_attention(
        *args, kv_frac_bits=nkv, work=padded_d), iters)
    plain_ms = time_ms(torch, lambda: ref.paged_attention_ref(
        *args, kv_frac_bits=nkv), 5, warmup=1)
    w_rows = bt.shape[1] * kp.shape[1]
    mask = (torch.arange(w_rows, device="cuda")[None, None, None, :]
            <= pos[:, None, :, None])
    gqa = sdpa_how == "enable_gqa"
    gs = _gather_sdpa(torch, args, nkv, mask, gqa).transpose(1, 2)
    check(_rows_within(torch, gs, want, LONG_ROW_TOL),
          f"K4 {name}: gather + SDPA disagrees with the plain version")
    gs_ms = time_ms(torch, lambda: _gather_sdpa(torch, args, nkv, mask,
                                                gqa), iters)
    n_bytes, n_ops = _k4_work(args)
    b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
    log(f"[15] K4 {name} (B {b}, C {c}, H {h}, KVH {kp.shape[2]}, D "
        f"{q.shape[3]}, last positions {pos.max(dim=1).values.tolist()}, "
        f"{bt.shape[1]} blocks a table, {q.dtype} q, {kp.dtype} pool; "
        f"{work.n_items} items, {work.n_combine} split into "
        f"{work.n_parts} chunks; padded to {padded.n_items} items and "
        f"{padded.n_combine} combine entries): within atol=rtol=2e-2"
        + (f" and {LONG_ROW_TOL} of each row's largest |value|, which a "
           f"repeated pool block fails" if long else "")
        + f", padded list bit-identical (max |diff| {err:.2e}) | kernel "
        f"padded (the engine's launch) {padded_ms:.4f} ms, unpadded "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, gather + dequantize + SDPA "
        f"({sdpa_how}, two calls) {gs_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"({b_by}, {n_bytes} B), {padded_ms / b_ms:.1f}x the bound")
    return dict(b=b, c=c, positions=pos.tolist(), ms=padded_ms,
                unpadded_ms=ms, plain_ms=plain_ms, gather_sdpa_ms=gs_ms,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                bytes=n_bytes, ops=n_ops, library_ms=None,
                items=work.n_items, splits=work.n_parts,
                padded_items=padded.n_items,
                padded_combine=padded.n_combine)


def _k4_hybrid_case(torch, gen, rows, kv_dt):
    """K4 at zamba2-2.7b's shared block in the recurrent engine's (4, 64)
    step: bf16 q (4, 64, 32, 80) over a shuffled pool of 16-row blocks,
    tables of HYBRID_NBMAX + 1 blocks (the last the trash column); row b
    feeds ``rows[b] = (start, n)`` real tokens at positions start ..
    start + n - 1 (n = 0: an idle lane, its table all trash) and the rest
    of its 64 positions point at the trash column (HYBRID_NBMAX * 16)."""
    from repro_torch.core.qscheme import quant
    b, c, h, d, bs, nbmax = 4, HYBRID_CHUNK, 32, 80, 16, HYBRID_NBMAX
    nb = 1 + b * nbmax
    q = torch.randn((b, c, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    kf = torch.randn((nb, bs, h, d), generator=gen, device="cuda")
    vf = torch.randn((nb, bs, h, d), generator=gen, device="cuda")
    if kv_dt == torch.int8:
        kp, vp = quant(kf, KV_FRAC_BITS), quant(vf, KV_FRAC_BITS)
    else:
        kp, vp = kf.to(kv_dt), vf.to(kv_dt)
    del kf, vf
    perm = (torch.randperm(nb - 1, generator=gen, device="cuda") + 1).to(
        torch.int32).reshape(b, nbmax)
    bt = torch.zeros((b, nbmax + 1), dtype=torch.int32, device="cuda")
    pos = torch.full((b, c), nbmax * bs, dtype=torch.int32, device="cuda")
    for i, (start, n) in enumerate(rows):
        if n == 0:
            continue
        pos[i, :n] = torch.arange(start, start + n, dtype=torch.int32)
        bt[i, :nbmax] = perm[i]
    nkv = KV_FRAC_BITS if kv_dt == torch.int8 else None
    return (q, kp, vp, bt, pos), nkv


def phase_k4(torch, out):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import paged_capacity
    from repro_torch.kernels.ragged_flash import pad_work
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    _, sdpa_how = _sdpa(torch)
    # the CPU tests' grid: fp32 q, shuffled tables with trash tails, slot 2
    # padded, a position at a block edge, the spec table at C = 4
    n_grid, grid_err = 0, 0.0
    for c in (1, 4, 16):
        for groups in (1, 2, 4):
            for kv_dt in (torch.int8, torch.float32):
                for d, bs in ((64, 16), (128, 128)):
                    last = (bs, 3 * bs - 1, 0, min(5, bs - 1))
                    args, nkv = _k4_case(torch, gen, 4, c, 2 * groups, 2, d,
                                         bs, 3, last, torch.float32, kv_dt,
                                         spec=c == 4, padded_slot=2)
                    err, *_ = _k4_held(torch, args, nkv, 1e-4,
                                       f"K4 C {c} G {groups} {kv_dt} D {d} "
                                       f"bs {bs}")
                    grid_err = max(grid_err, err)
                    n_grid += 1
    log(f"[15] K4 grid ({n_grid} cases: C 1/4/16, GQA 1/2/4, int8/fp32 "
        f"pools, D 64/128, bs 16/128, fp32 q): within atol=rtol=1e-4 of the "
        f"plain version and of the split-and-combine twin, and every case "
        f"below on its list padded to its shape's capacity bit-identical to "
        f"the unpadded one (max |diff| {grid_err:.2e})")
    h, kvh = K1_HEADS, K1_KV_HEADS
    # split cases at qwen3-1.7B's heads: positions before, at and after the
    # 512-row split edge and a 4096-row range, at C 1 and 4 (a 4-query run
    # ending there), head dims 12, 100 and 128, both q types over an int8
    # pool and q's own type as the pool
    n_split, split_err = 0, 0.0
    nbmax = K4_SPLIT_LAST[-1] // 16 + 1
    for c in (1, 4):
        for d in (12, 100, 128):
            for q_dt, kv_dt, tol in ((torch.bfloat16, torch.int8, 2e-2),
                                     (torch.float32, torch.int8, 1e-4),
                                     (torch.bfloat16, torch.bfloat16, 2e-2),
                                     (torch.float32, torch.float32, 1e-4)):
                args, nkv = _k4_case(torch, gen, 4, c, h, kvh, d, 16, nbmax,
                                     K4_SPLIT_LAST, q_dt, kv_dt)
                err, work, *_ = _k4_held(torch, args, nkv, tol,
                                         f"K4 split C {c} D {d} {q_dt} q "
                                         f"{kv_dt} pool")
                check(work.n_combine == 3, f"K4 split C {c}: "
                      f"{work.n_combine} combine entries, not 3")
                split_err = max(split_err, err)
                n_split += 1
    log(f"[15] K4 split cases ({n_split}: last positions "
        f"{list(K4_SPLIT_LAST)} x C 1/4 x D 12/100/128 x bf16/fp32 q over "
        f"int8 and q-typed pools, H {h} KVH {kvh}): within atol=rtol=2e-2 "
        f"(bf16 q) / 1e-4 (fp32 q) of the plain version and the split twin "
        f"(max |diff| {split_err:.2e})")
    # a 16-query chunk whose second item sees 33733 rows: 31 chunks of 1088
    # and a last one of 5, so 3 of its 8 queries see nothing of the last
    # chunk (a partial with m = -inf) and 5 see part of it
    for q_dt, kv_dt, tol in ((torch.bfloat16, torch.int8, 2e-2),
                             (torch.float32, torch.int8, 1e-4)):
        args, nkv = _k4_case(torch, gen, 1, 16, h, kvh, 128, 16,
                             K4_EDGE_LAST // 16 + 1, (K4_EDGE_LAST,), q_dt,
                             kv_dt)
        err, work, *_ = _k4_held(torch, args, nkv, tol,
                                 f"K4 chunk edge {q_dt} q", rows=True)
        starts = sorted(work.table[:work.n_items, 3].tolist())
        check(K4_EDGE_LAST - 7 < starts[-1] <= K4_EDGE_LAST,
              f"K4 chunk edge: no chunk starts among the queries "
              f"({starts[-3:]})")
        log(f"[15] K4 chunk edge (C 16 at positions {K4_EDGE_LAST - 15}.."
            f"{K4_EDGE_LAST}, a chunk from {starts[-1]}, {q_dt} q, int8 pool, "
            f"{work.n_items} items, {work.n_combine} split): within "
            f"atol=rtol={tol} and {LONG_ROW_TOL} of each row's largest "
            f"|value| (max |diff| {err:.2e})")
        del args
    rows = {}
    # the engine's three shapes (decode, prefill chunk, verify with a
    # padded draft row on the trash column) and one long int8 cache
    cases = [("decode shape", 4, 1, K4_NBMAX, K4_DECODE_POS, False, 200),
             ("prefill chunk", 1, 16, K4_NBMAX, K4_DECODE_POS[:1], False, 200),
             ("verify", 4, 4, K4_NBMAX, K4_DECODE_POS, True, 200),
             ("long int8 cache", 4, 1, K4_LONG_BLOCKS,
              (K4_LONG_BLOCKS * 16 - 1,) * 4, False, 20)]
    for name, b, c, nbmax, last, spec, iters in cases:
        args, nkv = _k4_case(torch, gen, b, c, h, kvh, K1_DIM, 16, nbmax,
                             last, torch.bfloat16, torch.int8, spec=spec)
        rows[name] = _k4_timed(torch, name, args, nkv, iters, sdpa_how,
                               long=name.startswith("long"))
        del args
        torch.cuda.empty_cache()
    # zamba2-2.7b's shared attention block: 32 query heads over 32 KV
    # heads (GQA 1) at head dim 80, the recurrent engine's (4, 64) step
    # over tables of nbmax + 1 blocks, padded positions on the trash
    # column, over a bf16 and an int8 pool
    hybrid = {}
    for case, hrows in HYBRID_K4_CASES.items():
        for kv_dt in (torch.bfloat16, torch.int8):
            name = (f"hybrid {case} "
                    f"{'int8' if kv_dt == torch.int8 else 'bf16'} pool")
            args, nkv = _k4_hybrid_case(torch, gen, hrows, kv_dt)
            hybrid[name] = _k4_timed(torch, name, args, nkv, 100,
                                     sdpa_how)
            del args
            torch.cuda.empty_cache()
    res = dict(rows["decode shape"], prefill=rows["prefill chunk"],
               verify=rows["verify"], long=rows["long int8 cache"],
               hybrid=hybrid, grid_max_abs_err=grid_err,
               split_max_abs_err=split_err, sdpa=sdpa_how)
    out["k4"] = res
    return res


def _paged_model_steps(vocab, bs, nbmax):
    """Four legacy steps as (tokens, positions, tables, real rows): A's
    16-token prefill chunk (blocks 1, 2); B's 12 tokens padded to a 16
    chunk (block 3, trash after it); a (4, 1) decode of A at 16 and B at 12
    with two padded slots; a (4, 4) verify of A's fed token + 3 drafts and
    B's fed token + 1 draft, padded rows on the extra trash column.  The
    real-row mask (B, C) marks the rows whose logits the engine reads."""
    import numpy as np
    rng = np.random.default_rng(16)
    a = rng.integers(0, vocab, size=20).astype(np.int32)
    b = rng.integers(0, vocab, size=14).astype(np.int32)
    s1 = (a[None, :16], np.arange(16, dtype=np.int32)[None],
          np.asarray([[1, 2]], np.int32), np.ones((1, 16), bool))
    tok = np.zeros((1, 16), np.int32)
    tok[0, :12] = b[:12]
    s2 = (tok, np.arange(16, dtype=np.int32)[None],
          np.asarray([[3, 0]], np.int32), np.arange(16)[None] < 12)
    bt3 = np.zeros((4, nbmax), np.int32)
    bt3[0], bt3[1] = (1, 2), (3, 0)
    s3 = (np.asarray([[a[16]], [b[12]], [0], [0]], np.int32),
          np.asarray([[16], [12], [0], [0]], np.int32), bt3,
          np.asarray([[True], [True], [False], [False]]))
    tok4 = np.zeros((4, 4), np.int32)
    tok4[0], tok4[1, :2] = a[16:20], b[12:14]
    pos4 = np.full((4, 4), nbmax * bs, np.int32)
    pos4[0], pos4[1, :2] = 17 + np.arange(4), 13 + np.arange(2)
    bt4 = np.zeros((4, nbmax + 1), np.int32)
    bt4[0, :2], bt4[1, :2] = (1, 2), (3, 4)
    real4 = np.zeros((4, 4), bool)
    real4[0], real4[1, :2] = True, True
    return s1, s2, s3, (tok4, pos4, bt4, real4)


def phase_paged_model(torch, out):
    """The legacy step card against CPU, fp32 on both sides, in phase 9's
    three cases.  The trash block (0) is left out of every pool comparison
    and padded rows out of every logits comparison: padded rows of several
    slots write the trash block's rows with different values (from layer 1
    on their inputs differ), in no fixed order on the card, and padded
    rows read those rows back; no engine reads a padded row's logits.

    * INT mode, int8 pool: phase 4's INT rule, the layer-0 pool identical,
      every code within one step of the CPU's and at most 0.1% differing,
      logits differing in at most 0.1% of entries by at most 0.25.
    * FP mode, fp32 pool: phase 4's FP rule, logits within atol=rtol=1e-3
      in at least 99.9% of entries and all within 5e-2; pool values within
      atol=rtol=1e-4.  No code can flip, so only fp32 summation orders
      differ.
    * FP mode, int8 pool: phase 9's rule for an int8 cache in FP mode.  A
      K/V value within an ulp of a rounding boundary may take the
      neighbouring code (the float projections sum in another order on the
      card; on an H100 one layer-0 K code of 114688 flipped, a place no
      attention kernel reaches), and every later logit of its sequence
      moves by about 1e-3.  So: every code within one step, at most 0.1%
      differing, logits all within 5e-2, the 1e-3 share printed."""
    from repro_torch.configs import get_config
    from repro_torch.core.qmodel import (QuantContext, QuantMode,
                                         quantize_weight_tree)
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_paged_step
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("qwen3_1_7b"), n_layers=2,
                              dtype="float32")
    t0 = time.perf_counter()
    p_cpu = M.init_params(cfg, 0, device="cpu")
    p_gpu = _tree_to(p_cpu, "cuda")
    bs, nb, nbmax = 16, 8, 2
    steps = _paged_model_steps(cfg.vocab_size, bs, nbmax)
    res = {}
    for mode, kv_bits in (("int", 8), ("fp", None), ("fp", 8)):
        ctx = QuantContext(mode=QuantMode(mode))
        ccfg = dataclasses.replace(cfg, kv_cache_bits=kv_bits)
        case = f"{mode}, {'int8' if kv_bits else 'fp32'} pool"
        step_fn = build_paged_step(ccfg, ctx)
        pc, pg = p_cpu, p_gpu
        if ctx.mode is QuantMode.INT:
            pc, pg = quantize_weight_tree(p_cpu, ctx), \
                quantize_weight_tree(p_gpu, ctx)
        caches = {dv: M.init_paged_cache(ccfg, nb, bs, device=dv)
                  for dv in ("cpu", "cuda")}
        worst = {"frac": 0.0, "max": 0.0}
        ops.reset_launch_counts()
        for tokens, positions, bt, real in steps:
            logits = {}
            for dv, params in (("cpu", pc), ("cuda", pg)):
                with torch.no_grad():
                    lg, caches[dv] = step_fn(
                        params, torch.from_numpy(tokens).to(dv), caches[dv],
                        torch.from_numpy(positions).to(dv),
                        torch.from_numpy(bt).to(dv))
                logits[dv] = lg.float().cpu()
            a, b = logits["cuda"], logits["cpu"]
            check(bool(torch.isfinite(a).all()) and a.shape == b.shape
                  == (*tokens.shape, cfg.vocab_padded),
                  f"paged model {case}: non-finite or misshapen logits")
            a, b = a[torch.from_numpy(real)], b[torch.from_numpy(real)]
            diff = (a - b).abs()
            frac = float(((diff > 0) if mode == "int" else
                          (diff > 1e-3 + 1e-3 * b.abs())).float().mean())
            worst["frac"] = max(worst["frac"], frac)
            worst["max"] = max(worst["max"], float(diff.max()))
        launches = dict(ops.LAUNCHES)
        check(launches["paged_attention"] == cfg.n_layers * len(steps)
              and launches["ragged_attention"] == 0,
              f"paged model {case}: K4 launched "
              f"{launches['paged_attention']} times, want "
              f"{cfg.n_layers} x {len(steps)}")
        pools = []              # (k/v, layer, entries differing, max |diff|)
        n_entries = 0
        for name, arr_c, arr_g in zip(("k", "v"), caches["cpu"]["paged_kv"],
                                      caches["cuda"]["paged_kv"]):
            dd = (arr_g[:, 1:].cpu().double() - arr_c[:, 1:].double()).abs()
            if kv_bits is None:         # float pools: beyond atol=rtol=1e-4
                dd = dd * (dd > 1e-4 + 1e-4 * arr_c[:, 1:].double().abs())
            for layer in range(cfg.n_layers):
                pools.append((name, layer, int((dd[layer] > 0).sum()),
                              float(dd[layer].max())))
                n_entries += dd[layer].numel()
        max_code = max(p[3] for p in pools)
        frac_code = sum(p[2] for p in pools) / n_entries
        log(f"[16] paged model {case} (prefill chunks (1, 16), decode (4, 1),"
            f" verify (4, 4); 2 layers, full width, fp32): real rows' logits "
            f"max |diff| {worst['max']:.3e}, {worst['frac']:.2e} of entries "
            f"{'differ' if mode == 'int' else 'beyond 1e-3'}; pool entries "
            f"{'differing' if kv_bits else 'beyond 1e-4'} outside the trash "
            f"block (k/v, layer, count, max |diff|) {pools} of "
            f"{n_entries // len(pools)} a layer; K4 launches "
            f"{launches['paged_attention']}")
        if kv_bits is None:
            check(frac_code == 0, f"paged model {case}: pool values beyond "
                  f"atol=rtol=1e-4 {pools}")
            check(worst["frac"] <= 1e-3 and worst["max"] <= 5e-2,
                  f"paged model {case}: logits beyond tolerance in "
                  f"{worst['frac']:.2e} of entries, max {worst['max']}")
        else:
            check(max_code <= 1 and frac_code <= 1e-3,
                  f"paged model {case}: pool codes differ by {max_code} steps"
                  f" in {frac_code:.2e} of entries")
            if ctx.mode is QuantMode.INT:
                check(all(p[2] == 0 for p in pools if p[1] == 0),
                      f"paged model {case}: the layer-0 pool differs from "
                      "the CPU's")
                check(worst["frac"] <= 1e-3 and worst["max"] <= 0.25,
                      f"paged model {case}: logits differ in "
                      f"{worst['frac']:.2e} of entries, max {worst['max']}")
            else:
                check(worst["max"] <= 5e-2, f"paged model {case}: logits "
                      f"differ by up to {worst['max']}")
        res[case] = dict(logits_max_abs=worst["max"],
                         logits_frac=worst["frac"], pool_diff=pools,
                         launches=launches)
    log(f"[16] paged model phase {time.perf_counter() - t0:.1f} s")
    out["paged_model"] = res
    del p_cpu, p_gpu
    torch.cuda.empty_cache()


def _engine_run(torch, mode, ragged, spec_k):
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_engine
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    o = serve_engine("qwen3_1_7b", smoke=False, mode=mode, calibrate=False,
                     kv_bits=8, n_requests=8, n_slots=4, rate=1e9,
                     ragged=ragged, spec_k=spec_k, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    return dict(outputs=o["outputs"], requests=o["requests"],
                report=o["report"], launches=launches, wall_s=wall,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                engine=o["engine"])


def _divergence_margins(torch, legacy, ragged):
    """For each request whose tokens differ between the two engines'
    runs, the agreed prefix (prompt and the tokens both generated) replayed
    through the classic dense prefill on the card: the top-2 logit margin
    at the first divergent position, in units of the top logit's bf16 ulp
    (2^(floor(log2 |top|) - 7)), and which engine's token the replay
    takes.  Returns [(rid, index, legacy token, ragged token, replay's
    token, margin in ulps)]."""
    import numpy as np
    from repro_torch.models import model as M
    eng = legacy["engine"]
    rows = []
    for req in legacy["requests"]:
        a, b = legacy["outputs"][req.rid], ragged["outputs"][req.rid]
        n = min(len(a), len(b))
        diff = [i for i in range(n) if a[i] != b[i]]
        if not diff:
            continue
        i = diff[0]
        prefix = torch.from_numpy(np.concatenate(
            [np.asarray(req.prompt, np.int64), np.asarray(a[:i], np.int64)]
        )).to("cuda")[None]
        with torch.no_grad():
            logits, _ = M.prefill(eng.params, {"tokens": prefix}, eng.cfg,
                                  eng.ctx)
        top = torch.topk(logits[0].float(), 2)
        t1, t2 = (float(v) for v in top.values)
        ulp = (2.0 ** (math.floor(math.log2(abs(t1))) - 7) if t1
               else 2.0 ** -133)
        rows.append((req.rid, i, int(a[i]), int(b[i]),
                     int(top.indices[0]), (t1 - t2) / ulp))
    return rows


def _agree(a, b):
    """Share of b's tokens that a reproduces position for position."""
    same = 0
    for r in b:
        n = min(len(a[r]), len(b[r]))
        same += int((a[r][:n] == b[r][:n]).sum())
    return same / max(1, sum(len(b[r]) for r in b))


def phase_legacy_engine(torch, out):
    from repro_torch.configs import get_config
    cfg = get_config("qwen3_1_7b")
    L, per_dispatch_k2 = cfg.n_layers, 7 * cfg.n_layers + 1
    res = {}

    def summary(tag, r):
        rep = r["report"]
        sp = rep["speculative"]
        return (f"[17] {tag}: {rep['completed']} requests, "
                f"{rep['gen_tokens']} tokens, {rep['tokens_per_s']} tok/s, "
                f"TTFT p50 {rep['ttft_s']['p50']:.4f} s, TPOT p50 "
                f"{rep['tpot_s']['p50']:.4f} s, prefill chunks "
                f"{rep['prefill_chunks']}, decode steps {rep['decode_steps']},"
                f" verify steps {rep['spec_steps']}, ragged steps "
                f"{rep['ragged_steps']}, launches K1 "
                f"{r['launches']['ragged_attention']} K4 "
                f"{r['launches']['paged_attention']} K2 "
                f"{r['launches']['int8_matmul']}"
                + ("" if sp is None else
                   f", acceptance {sp['acceptance_rate']} "
                   f"({sp['accepted_tokens']}/{sp['drafted_tokens']})")
                + f", peak {r['peak_gib']:.2f} GiB, {r['wall_s']:.1f} s")

    def check_done(tag, r):
        check(r["report"]["completed"] == 8, f"{tag}: not all done")
        for req in r["requests"]:
            toks = r["outputs"][req.rid]
            check(1 <= len(toks) <= req.max_new_tokens
                  and int(toks.min()) >= 0
                  and int(toks.max()) < cfg.vocab_size,
                  f"{tag}: request {req.rid} tokens {toks}")
        check({k: r["launches"][k] for k in r["report"]["kernel_launches"]}
              == r["report"]["kernel_launches"],
              f"{tag}: report launches {r['report']['kernel_launches']}")

    def check_legacy(tag, r, mode):
        rep = r["report"]
        dispatches = (rep["decode_steps"] + rep["prefill_chunks"]
                      + rep["spec_steps"])
        want_k2 = per_dispatch_k2 * dispatches if mode == "int" else 0
        check(rep["ragged_steps"] == 0
              and r["launches"]["paged_attention"] == L * dispatches
              and r["launches"]["ragged_attention"] == 0
              and r["launches"]["int8_matmul"] == want_k2,
              f"{tag}: launches {r['launches']} over {dispatches} dispatches "
              f"(want K4 {L * dispatches}, K1 0, K2 {want_k2})")

    for mode in ("fp", "int"):
        runs = []
        for rep_i in range(2):
            r = _engine_run(torch, mode, False, 0)
            tag = f"legacy engine {mode} run {rep_i}"
            log(summary(tag, r))
            check_done(tag, r)
            check_legacy(tag, r, mode)
            runs.append(r)
        a, b = runs[0]["outputs"], runs[1]["outputs"]
        check(sorted(a) == sorted(b)
              and all(len(a[k]) == len(b[k]) and (a[k] == b[k]).all()
                      for k in a),
              f"legacy engine {mode}: a repeated greedy run gave other tokens")
        log(f"[17] legacy engine {mode}: repeat run token-identical")
        res[f"legacy_{mode}"] = {k: v for k, v in runs[0].items()
                                 if k not in ("outputs", "requests")}
        # each engine's speculative run against its own plain run
        plain = {False: runs[0]["outputs"]}
        r = _engine_run(torch, mode, True, 0)
        plain[True] = r["outputs"]
        share = _agree(r["outputs"], plain[False])
        log(summary(f"ragged engine {mode}", r) + f"; {share:.4f} of the "
            f"tokens agree with the legacy engine's")
        check_done(f"ragged engine {mode}", r)
        margins = _divergence_margins(torch, runs[0], r)
        for run in (*runs, r):     # the engines' weights and pools go
            run.pop("engine")
        for rid, i, ta, tb, tr, ulps in margins:
            log(f"[17]   request {rid}: first divergence at generated token "
                f"{i} (legacy {ta}, ragged {tb}); the dense prefill of the "
                f"agreed prefix picks {tr}, top-2 margin {ulps:.2f} bf16 ulp")
        log(f"[17] {mode}: {len(margins)} requests diverge between the "
            f"engines; largest top-2 margin at a first divergence "
            + (f"{max(m[-1] for m in margins):.2f} bf16 ulp" if margins
               else "none"))
        res[f"ragged_{mode}"] = dict(
            {k: v for k, v in r.items() if k not in ("outputs", "requests")},
            agree_with_legacy=share, divergence_margins_ulp=margins)
        for ragged in (False, True):
            r = _engine_run(torch, mode, ragged, 3)
            name = "ragged" if ragged else "legacy"
            tag = f"{name} engine {mode} spec_k=3"
            share = _agree(r["outputs"], plain[ragged])
            log(summary(tag, r) + f"; {share:.4f} of the tokens agree with "
                f"the same engine's non-speculative run")
            check_done(tag, r)
            check(share == 1.0, f"{tag}: {share:.4f} of the tokens agree "
                  f"with the same engine's non-speculative run, not all")
            check(r["report"]["speculative"]["drafted_tokens"] > 0,
                  f"{tag}: nothing was drafted")
            if ragged:
                steps = r["report"]["ragged_steps"]
                check(r["launches"]["ragged_attention"] == L * steps
                      and r["launches"]["paged_attention"] == 0,
                      f"{tag}: launches {r['launches']} over {steps} ragged "
                      f"steps (want K1 {L * steps}, K4 0)")
            else:
                check_legacy(tag, r, mode)
            r.pop("engine")
            entry = {k: v for k, v in r.items()
                     if k not in ("outputs", "requests")}
            entry["agree_with_plain"] = share
            res[f"{name}_spec_{mode}"] = entry
        torch.cuda.empty_cache()
    out["legacy_engine"] = res
    return res


# ---------------------------------------------------------------------------
# phase 18: the engine's observability at full depth
# ---------------------------------------------------------------------------

OBS_DIR = ROOT / "build" / "obs"
# phases 18 and 19 serve qwen3-1.7B at full width on ENGINE_LAYERS of its
# 28 layers (phase 19's profiled run, ``profile_engine.profile_run``, at
# full depth): full depth until phase 29 took the script past its time
# (phase 19 took 153.2 s at full depth on an H100 80GB HBM3 at 700 W,
# the script 1143.7 s), 14 until phase 30 did (the script 973.3 s)
ENGINE_LAYERS = 8


def _obs_run(torch, count_rows=False, **kw):
    """One full-depth engine run on phase 5's workload (8 requests at
    once, 4 slots, the int8 pool); with ``count_rows`` the rows each
    ragged step scatters into the pool (its ``dest`` outside the trash
    block) are counted from the step's own descriptors as the engine
    hands them to its dispatch, independently of the engine's requant
    counters (a replayed step runs no Python, so they are counted on the
    host side of the dispatch)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_engine
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_pool import TRASH_BLOCK
    rows = []
    real_dispatch = ServingEngine._dispatch_ragged
    if count_rows:
        def counting_dispatch(self, tokens, positions, dest, *a, **k):
            rows.append(int((dest // self.pool.block_size
                             != TRASH_BLOCK).sum()))
            return real_dispatch(self, tokens, positions, dest, *a, **k)
        ServingEngine._dispatch_ragged = counting_dispatch
    args = dict(smoke=False, kv_bits=8, n_requests=8, n_slots=4, rate=1e9,
                device="cuda", cfg_overrides={"n_layers": ENGINE_LAYERS})
    args.update(kw)
    if not args.get("w8a8"):
        args.setdefault("calibrate", False)
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        o = serve_engine("qwen3_1_7b", **args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ServingEngine._dispatch_ragged = real_dispatch
    o.update(launches=dict(ops.LAUNCHES), wall_s=wall, rows=sum(rows))
    return o


def _same_tokens(a, b) -> bool:
    return sorted(a) == sorted(b) and all(
        len(a[r]) == len(b[r]) and (a[r] == b[r]).all() for r in a)


def _trace_split(chrome, wall_s):
    """Wall time into dispatch spans by shape, and the host time between
    them (wall minus the spans' sum)."""
    by = {}
    for e in chrome["traceEvents"]:
        if e.get("cat") == "dispatch" and e["ph"] == "X":
            key = f"{e['name']} {e['args']['shape']}"
            n, us = by.get(key, (0, 0.0))
            by[key] = (n + 1, us + e["dur"])
    span_s = sum(us for _, us in by.values()) / 1e6
    return {k: {"calls": n, "s": us / 1e6} for k, (n, us) in sorted(
        by.items())}, span_s, wall_s - span_s


def _profile_check(path, n_dispatch):
    """Every ragged dispatch has its ``ragged_step#N`` annotation, and
    every annotation holds at least one launch of K1's kernel (its
    runtime launch call, matched to the kernel by correlation id, lies
    inside the annotation's range).  Returns the annotations, K1's
    kernels, the kernels launched inside each annotation and the summed
    device time of every kernel in the trace (s)."""
    import bisect
    events = json.loads(Path(path).read_text())["traceEvents"]
    ann = [e for e in events if str(e.get("name", "")).startswith(
        "ragged_step#") and e.get("cat") == "user_annotation"]
    launch_ts = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") == "cuda_runtime" and corr is not None:
            launch_ts[corr] = e["ts"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "RelLimit" in str(e.get("name", ""))]

    def launches(evs):
        return sorted(launch_ts[c] for c in
                      ((e.get("args") or {}).get("correlation")
                       for e in evs) if c in launch_ts)

    k1_ts, all_ts = launches(k1), launches(kernels)
    empty, per = [], []
    for a in ann:
        lo, hi = a["ts"], a["ts"] + a["dur"]
        i = bisect.bisect_left(k1_ts, lo)
        if i == len(k1_ts) or k1_ts[i] > hi:
            empty.append(a["name"])
        per.append(bisect.bisect_right(all_ts, hi)
                   - bisect.bisect_left(all_ts, lo))
    check(len(ann) == n_dispatch,
          f"profile: {len(ann)} ragged_step annotations for {n_dispatch} "
          f"dispatches")
    check(k1 and len(k1_ts) == len(k1) and len(all_ts) == len(kernels),
          f"profile: {len(k1)} K1 kernels and {len(kernels)} kernels in the "
          f"trace, {len(k1_ts)} and {len(all_ts)} matched to their launches")
    check(not empty, f"profile: no K1 launch inside {empty[:5]}")
    return len(ann), len(k1), per, sum(e["dur"] for e in kernels) / 1e6


def phase_obs(torch, out):
    from repro_torch.configs import get_config
    from repro_torch.core import hwcost
    from repro_torch.obs.replay import (WorkloadRecord, build_requests,
                                        engine_fingerprint, replay_workload)
    from repro_torch.obs.schema import diff_schema, schema_of
    from repro_torch.obs.trace import validate_chrome_trace
    from repro_torch.serving.engine import ServingEngine
    cfg = dataclasses.replace(get_config("qwen3_1_7b"),
                              n_layers=ENGINE_LAYERS)
    L = cfg.n_layers
    per_step_k2 = 7 * L + 1
    kv_elems = L * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    OBS_DIR.mkdir(parents=True, exist_ok=True)
    res = {}

    def obs_checks(tag, on, off, fwd_elems):
        rep, eng = on["report"], on["engine"]
        steps = rep["ragged_steps"]
        check(_same_tokens(on["outputs"], off["outputs"]),
              f"{tag}: obs-on tokens differ from the obs-off run's")
        check(on["launches"] == off["launches"],
              f"{tag}: launches {on['launches']} with obs on, "
              f"{off['launches']} off")
        check(on["launches"]["ragged_attention"] == L * steps
              and on["launches"]["int8_matmul"] == per_step_k2 * steps
              and rep["kernel_launches"] == {
                  k: on["launches"][k] for k in rep["kernel_launches"]},
              f"{tag}: launches {on['launches']} over {steps} steps (want "
              f"K1 {L * steps}, K2 {per_step_k2 * steps})")
        errs = diff_schema(schema_of(eng.metrics), spec=False, cache=True,
                           slo=True)
        check(not errs, f"{tag}: schema drift {errs[:5]}")
        chrome = eng.tracer.to_chrome()
        faults = validate_chrome_trace(chrome)
        check(not faults, f"{tag}: chrome trace faults {faults[:5]}")
        spans = [e for e in chrome["traceEvents"]
                 if e.get("cat") == "dispatch" and e["ph"] == "X"]
        check(len(spans) == steps and rep["obs"]["trace_dropped"] == 0,
              f"{tag}: {len(spans)} dispatch spans for {steps} steps")
        en, hw = rep["energy"], rep["hwcost"]
        check(en["total_quant_ops"] == sum(
            en[p]["quant_ops"] for p in ("prefill", "decode", "spec_wasted"))
            == hw["requant_ops_performed"] + hw["requant_ops_forward"],
            f"{tag}: energy {en['total_quant_ops']} != hwcost "
            f"{hw['requant_ops_performed']} + {hw['requant_ops_forward']}")
        check(en["total_energy_uj"] == round(hwcost.estimate(
            "bit_shifting", hw["requant_ops_performed"]
            + hw["requant_ops_forward"]).energy_uj, 6),
            f"{tag}: energy uJ {en['total_energy_uj']}")
        check(hw["requant_ops_performed"] == on["rows"] * kv_elems
              and hw["requant_ops_forward"] == on["rows"] * fwd_elems
              and on["rows"] == rep["dispatched_tokens"]
              - rep["padded_tokens"] > 0,
              f"{tag}: requant ops performed {hw['requant_ops_performed']}"
              f", forward {hw['requant_ops_forward']}, for {on['rows']} "
              f"rows scattered into the pool ({kv_elems} and {fwd_elems} "
              f"a row)")
        split, span_s, host_s = _trace_split(chrome, rep["wall_s"])
        log(f"[18] {tag}: {steps} steps, {on['rows']} rows scattered, "
            f"requant ops {hw['requant_ops_performed']} performed / "
            f"{hw['requant_ops_avoided']} avoided / "
            f"{hw['requant_ops_avoided_prefix_cache']} prefix-cache / "
            f"{hw['requant_ops_forward']} forward, energy proxy "
            f"{en['proxy_uj_per_token']} uJ/token, slo alerts "
            f"{rep['slo']['alerts_fired']}; schema clean, trace clean")
        log(f"[18] {tag}: wall {rep['wall_s']:.4f} s = dispatch spans "
            f"{span_s:.4f} s + host between {host_s:.4f} s; "
            + ", ".join(f"{k} {v['calls']}x {v['s']:.4f} s"
                        for k, v in split.items()))
        return dict(steps=steps, rows=on["rows"], hwcost=hw, energy=en,
                    wall_s=rep["wall_s"], span_s=span_s, host_s=host_s,
                    split=split, slo=rep["slo"]["alerts_fired"])

    # INT: obs off and on interleaved (off, on, on, off) for tokens/s,
    # then an obs-on run that counts the rows scattered into the pool
    timed = {"off": [], "on": []}
    runs = []
    for i, on in enumerate((False, True, True, False)):
        kw = dict(trace=True, slo=True) if on else {}
        if on and i == 1:
            kw["metrics_path"] = str(OBS_DIR / "int.prom")
        r = _obs_run(torch, mode="int", **kw)
        rep = r["report"]
        timed["on" if on else "off"].append(
            (rep["tokens_per_s"], rep["tpot_s"]["p50"], rep["ttft_s"]["p50"]))
        r.pop("engine")
        runs.append(r)
        del r
        torch.cuda.empty_cache()
    for r in runs[1:]:
        check(_same_tokens(r["outputs"], runs[0]["outputs"])
              and r["launches"] == runs[0]["launches"],
              "int: the four timing runs differ in tokens or launches")
    text = (OBS_DIR / "int.prom").read_text()
    check("# TYPE hwcost_requant_ops_performed counter" in text
          and "kernel_launches" in text, "int: metrics export incomplete")
    for k in ("off", "on"):
        log(f"[18] int obs {k}: tokens/s "
            + ", ".join(f"{t[0]}" for t in timed[k]) + "; TPOT p50 "
            + ", ".join(f"{t[1]:.5f}" for t in timed[k]) + " s; TTFT p50 "
            + ", ".join(f"{t[2]:.5f}" for t in timed[k]) + " s")
    res["timed_int"] = timed
    off = runs[0]
    int_off = dict(outputs=off["outputs"], launches=off["launches"])
    on = _obs_run(torch, count_rows=True, mode="int", trace=True, slo=True)
    res["int"] = obs_checks("int", on, off, 0)
    del on, runs
    torch.cuda.empty_cache()

    # W8A8: obs off, then obs on with the row count
    off = _obs_run(torch, w8a8=True)
    off.pop("engine")
    on = _obs_run(torch, count_rows=True, w8a8=True, trace=True, slo=True,
                  metrics_path=str(OBS_DIR / "w8a8.prom"))
    fwd = hwcost.forward_quant_ops_per_token(
        dataclasses.replace(cfg, matmul_kernel="int8"))
    res["w8a8"] = obs_checks("w8a8", on, off, fwd)
    del on, off
    torch.cuda.empty_cache()

    # the flight recorder: record, JSON round trip, replay on a fresh
    # engine (the capture's weights and context, a new pool)
    for tag, kw in (("legacy int spec_k=3", dict(mode="int", ragged=False,
                                                  spec_k=3)),
                    ("ragged fp", dict(mode="fp"))):
        r = _obs_run(torch, record=True, **kw)
        eng = r["engine"]
        rec = WorkloadRecord.from_json(json.loads(json.dumps(
            r["record"].to_json())))
        es = rec.engine
        fresh = ServingEngine(
            eng.cfg, eng.params, eng.ctx, n_slots=es["n_slots"],
            block_size=es["block_size"], max_model_len=es["max_model_len"],
            num_blocks=es["num_blocks"], chunk=es["chunk"],
            prefill_token_budget=es["prefill_token_budget"],
            top_k=es["default_top_k"], seed=es["seed"],
            prefix_cache=es["prefix_cache"], spec_k=es["spec_k"],
            ragged=es["ragged"], record=True, virtual_dt=es["virtual_dt"],
            device="cuda")
        with torch.no_grad():
            rr = replay_workload(rec, fresh, strict_fingerprint=True)
        rep = r["report"]
        dispatches = rep["ragged_steps"] if es["ragged"] else (
            rep["prefill_chunks"] + rep["decode_steps"] + rep["spec_steps"])
        log(f"[18] {tag} record: {len(rec.requests)} requests, "
            f"{len(rec.decisions)} decisions, {dispatches} dispatches, "
            f"fingerprint {rec.fingerprint}; replay on a fresh engine: "
            f"tokens {'identical' if rr.token_identical else 'DIFFER'}, "
            f"decision diff {len(rr.decision_diff)} lines, fingerprint "
            f"{'match' if rr.fingerprint_match else 'MISMATCH'}")
        check(rr.ok and rr.fingerprint_match
              and rr.outputs == rec.outputs
              and engine_fingerprint(fresh) == rec.fingerprint,
              f"{tag}: replay differs {rr.mismatched_rids} "
              f"{rr.decision_diff[:10]}")
        check(build_requests(rec)[0].prompt == list(rec.requests[0]["prompt"]),
              f"{tag}: record requests")
        res[f"record {tag}"] = dict(decisions=len(rec.decisions),
                                    dispatches=dispatches)
        del r, eng, fresh, rr
        torch.cuda.empty_cache()

    # torch.profiler capture: one annotation per dispatch, K1 inside
    prof_dir = OBS_DIR / "profile"
    r = _obs_run(torch, mode="int", profile_dir=str(prof_dir))
    rep = r["report"]
    (path,) = rep["profile"]["trace_files"]
    n_ann, n_k1, per, dev_s = _profile_check(path, rep["ragged_steps"])
    check(_same_tokens(r["outputs"], int_off["outputs"])
          and r["launches"] == int_off["launches"],
          "profile: tokens or launches differ from the obs-off run's")
    # the engine's K1 count against the K1 kernels the card ran
    check(n_k1 == rep["kernel_launches"]["ragged_attention"],
          f"profile: {n_k1} K1 kernels on the card, the engine counted "
          f"{rep['kernel_launches']['ragged_attention']}")
    log(f"[18] profile: {n_ann} ragged_step annotations for "
        f"{rep['ragged_steps']} dispatches, {n_k1} K1 kernels on the card "
        f"= the engine's count, each annotation holding K1 launches -> "
        f"{path}")
    log(f"[18] profile: kernels launched a dispatch min {min(per)} / mean "
        f"{sum(per) / len(per):.1f} / max {max(per)} ({sum(per) / len(per) / L:.1f}"
        f" a layer); device time of all kernels {dev_s:.4f} s over a "
        f"profiled wall of {rep['wall_s']:.4f} s (busy share "
        f"{dev_s / rep['wall_s']:.3f})")
    res["profile"] = dict(annotations=n_ann, k1_kernels=n_k1,
                          kernels_per_dispatch=per, device_s=dev_s,
                          wall_s=rep["wall_s"])
    del r
    torch.cuda.empty_cache()
    out["obs"] = res
    return res


# ---------------------------------------------------------------------------
# phase 19: the compiled serving step (CUDA graphs) against eager steps
# ---------------------------------------------------------------------------

GRAPH_CASES = (("ragged fp", dict(mode="fp")),
               ("ragged int", dict(mode="int")),
               ("ragged w8a8", dict(w8a8=True)),
               ("ragged int spec_k=3", dict(mode="int", spec_k=3)),
               ("legacy int", dict(mode="int", ragged=False)),
               ("legacy int spec_k=3", dict(mode="int", ragged=False,
                                            spec_k=3)),
               ("ragged int sampled", dict(mode="int", temperature=0.8,
                                           top_k=50)))


def _dispatches(rep) -> int:
    if rep["ragged"]:
        return rep["ragged_steps"]
    return rep["prefill_chunks"] + rep["decode_steps"] + rep["spec_steps"]


def _replay_ms(torch, eng, iters=10) -> dict:
    """The device time of one replay of each step key the engine
    captured: CUDA events around ``iters`` replays of its graph on the
    drained engine (each rewrites its last step's pool rows with the same
    codes), by key."""
    res = {}
    for key, entry in eng.graphs._entries.items():
        if entry.graph is None:     # called once: phase 19 fails it
            continue
        entry.graph.replay()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(iters):
            entry.graph.replay()
        t1.record()
        t1.synchronize()
        res[key] = t0.elapsed_time(t1) / iters
    return res


def _graph_runs(torch, graphs, kw):
    """Phase 5's workload on one engine twice, traced: cold (a fresh
    engine: with graphs, each key's first step eager and its second
    captured) and warm (the same engine after ``reset_metrics``, the same
    requests again: with graphs, every step a replay).  Each run's report,
    tokens, trace split and peak device memory; with graphs, the device
    time of one replay of each key after the warm run."""
    from repro_torch.launch.serve import poisson_workload
    runs = []
    gc.collect()            # earlier engines' memory out of the peaks
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    o = _obs_run(torch, trace=True, graphs=graphs, **kw)
    eng = o["engine"]
    for warm in (False, True):
        if warm:
            eng.reset_metrics()
            reqs = poisson_workload(eng.cfg.vocab_size, n_requests=8,
                                    rate=1e9,
                                    temperature=kw.get("temperature", 0.0))
            torch.cuda.reset_peak_memory_stats()
            with torch.no_grad():
                eng.run(reqs)
            torch.cuda.synchronize()
        rep = eng.report()
        split, span_s, host_s = _trace_split(eng.tracer.to_chrome(),
                                             rep["wall_s"])
        runs.append(dict(report=rep, outputs=eng.outputs(), span_s=span_s,
                         host_s=host_s, split=split,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30))
    if graphs:
        runs[-1]["replay_ms"] = _replay_ms(torch, eng)
    del o, eng
    gc.collect()            # the engine's metric closures form cycles
    torch.cuda.empty_cache()
    return runs


def phase_graphs(torch, out):
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_engine import K1_TAG, profile_run
    cfg = dataclasses.replace(get_config("qwen3_1_7b"),
                              n_layers=ENGINE_LAYERS)
    L = cfg.n_layers
    res = {}
    greedy_int = None
    for i, (tag, kw) in enumerate(GRAPH_CASES):
        runs = {}
        # in turns: eager first, then graphs first in the next case
        for graphs in ((False, True) if i % 2 == 0 else (True, False)):
            runs[graphs] = _graph_runs(torch, graphs, kw)
        ref_run = runs[False][0]
        for graphs, pair in runs.items():
            for warm, r in enumerate(pair):
                what = (f"{tag} {'graphs' if graphs else 'eager'} "
                        f"{'warm' if warm else 'cold'}")
                rep = r["report"]
                n = _dispatches(rep)
                check(rep["completed"] == 8, f"{what}: not all done")
                check(_same_tokens(r["outputs"], ref_run["outputs"]),
                      f"{what}: tokens differ from the eager cold run's")
                check(rep["kernel_launches"]
                      == ref_run["report"]["kernel_launches"],
                      f"{what}: launches {rep['kernel_launches']}, eager "
                      f"{ref_run['report']['kernel_launches']}")
                k1 = rep["kernel_launches"].get("ragged_attention")
                k4 = rep["kernel_launches"].get("paged_attention")
                check((k1 if rep["ragged"] else k4) == L * n,
                      f"{what}: attention launched {k1 or k4} times, want "
                      f"{L} x {n} dispatches")
                k2_want = (7 * L + 1) * n if kw.get("mode") != "fp" else 0
                check(rep["kernel_launches"]["int8_matmul"] == k2_want,
                      f"{what}: K2 launched "
                      f"{rep['kernel_launches']['int8_matmul']}, want "
                      f"{k2_want}")
                g = rep["step_graphs"]
                if graphs:
                    # cold: each key's first call eager, every other call
                    # a replay; warm: every call a replay, and each key
                    # captured once over the two runs
                    check(g["enabled"] and g["keys"] > 0
                          and g["first_calls"] == (0 if warm else g["keys"])
                          and g["first_calls"] + g["replays"] == n
                          and (not warm or g["captures"]
                               + pair[0]["report"]["step_graphs"]["captures"]
                               == g["keys"]),
                          f"{what}: step graphs {g} over {n} dispatches "
                          f"(want first calls = keys cold and 0 warm, first "
                          f"calls + replays = dispatches, each key captured "
                          f"once)")
                else:
                    check(not g["enabled"] and g["replays"] == 0
                          and g["first_calls"] == g["captures"] == 0,
                          f"{what}: graphs {g}")
        if tag == "ragged int":
            greedy_int = ref_run["outputs"]
        if tag == "ragged int sampled":
            check(not _same_tokens(ref_run["outputs"], greedy_int),
                  f"{tag}: the sampled run gave the greedy run's tokens")
        rows = {}
        for graphs, pair in sorted(runs.items()):
            mode = "graphs" if graphs else "eager"
            for warm, r in enumerate(pair):
                rep = r["report"]
                rows[f"{mode} {'warm' if warm else 'cold'}"] = dict(
                    tokens_per_s=rep["tokens_per_s"],
                    tpot_p50=rep["tpot_s"]["p50"],
                    ttft_p50=rep["ttft_s"]["p50"], wall_s=rep["wall_s"],
                    span_s=r["span_s"], host_s=r["host_s"],
                    dispatches=_dispatches(rep), peak_gib=r["peak_gib"],
                    step_graphs=rep["step_graphs"])
        for name, v in rows.items():
            g = v["step_graphs"]
            log(f"[19] {tag} {name}: {v['tokens_per_s']} tok/s, TPOT p50 "
                f"{v['tpot_p50']:.5f} s, TTFT p50 {v['ttft_p50']:.5f} s, "
                f"wall {v['wall_s']:.4f} s = dispatch spans "
                f"{v['span_s']:.4f} s + host between {v['host_s']:.4f} s "
                f"over {v['dispatches']} dispatches; first calls "
                f"{g['first_calls']}, captures {g['captures']}, replays "
                f"{g['replays']}, keys {g['keys']}; peak "
                f"{v['peak_gib']:.3f} GiB")
        warm = runs[True][1]
        per_key = {}
        for key, ms in warm["replay_ms"].items():
            shape = (f"ragged_step T{key[1]}xS{key[2]}" if key[0] == "ragged"
                     else f"{key[0]}x{key[1]}{' verify' if key[2] else ''}")
            per_key[shape] = ms
        log(f"[19] {tag} graphs warm, by key: dispatch span per call "
            + ", ".join(f"{k} {v['s'] / v['calls'] * 1e3:.3f} ms"
                        for k, v in warm["split"].items())
            + "; device time of one replay (events) "
            + ", ".join(f"{k} {ms:.3f} ms" for k, ms in per_key.items()))
        rows["graphs warm"]["replay_ms"] = per_key
        log(f"[19] {tag}: tokens and launches identical with and without "
            f"graphs, cold and warm; cold, each key's first call eager and "
            f"every other call a replay; warm, every call a replay; each "
            f"key captured once")
        res[tag] = rows
    # the busy share of a profiled warm eager run at the module's own full
    # depth, and the engine's K1 count against the K1 kernels the profiler
    # saw: key_averages() must hold every K1 kernel of the profiler's own
    # (Kineto) events, and those must be the engine's count.  (A profiled
    # graph run is not held so: such runs have read 918 and 874 of 980,
    # the Kineto events short by the same count as the table, the records
    # lost inside the profiler while every token matched; phase 18 holds a
    # graph run's trace to the engine's count)
    L = get_config("qwen3_1_7b").n_layers
    r = profile_run("int", graphs=False)
    rep = r["report"]
    check(r["device_s"] > 0, "profile eager: no device time")
    k1_card = sum(c for k, _, c in r["rows"] if K1_TAG in k)
    k1_raw = sum(c for k, c in r["raw_counts"].items() if K1_TAG in k)
    k1 = rep["kernel_launches"]["ragged_attention"]
    steps = rep["ragged_steps"]
    events = sum(c for _, _, c in r["rows"])
    check(k1 == L * steps and k1_card == k1_raw == k1,
          f"profile eager: {k1_card} K1 kernels in the profile ({k1_raw} "
          f"in its Kineto events), the engine counted {k1} over {steps} "
          f"steps")
    log(f"[19] profiled warm int run (eager, {L} layers): {steps} steps, "
        f"{k1_card} K1 kernels in the profile's key_averages() ({k1_raw} "
        f"in its Kineto events, {sum(r['raw_counts'].values())} device "
        f"events there) of the engine's {k1}; {events / steps:.1f} "
        f"kernels, copies and fills a dispatch ({events} over {steps}); "
        f"wall {r['wall_s']:.4f} s, device time of all kernels "
        f"{r['device_s']:.4f} s, busy share {r['busy']:.3f}; top: "
        + ", ".join(f"{k[:40]} {us / 1e3:.3f} ms ({c}x)"
                    for k, us, c in r["rows"][:8]))
    res["profile eager"] = dict(wall_s=r["wall_s"], device_s=r["device_s"],
                                busy=r["busy"], top=r["rows"][:10],
                                events_per_dispatch=events / steps,
                                k1_profile=k1_card, k1_kineto=k1_raw,
                                k1_engine=k1)
    del r
    gc.collect()
    torch.cuda.empty_cache()
    out["graphs"] = res
    return res


# ---------------------------------------------------------------------------
# phase 20: the recurrent and hybrid substrate (fixed state slabs)
# ---------------------------------------------------------------------------

# the two-step batches of the model comparison, one (slab, start, real
# tokens) per row: a 24-token prompt, a full 64-token chunk, an idle lane
# on the trash slab and a 7-token prompt; then two decode rows beside the
# chunked prompt's next 30 tokens.  Tables of REC_MODEL_NBMAX 16-row blocks
# and the trash column
REC_MODEL_ROWS = (((1, 0, 24), (2, 0, 64), (0, 0, 0), (3, 0, 7)),
                  ((1, 24, 1), (2, 64, 30), (0, 0, 0), (3, 7, 1)))
REC_MODEL_NBMAX = 6
# the engine cases: (tag, arch, serve_engine options)
# phases 20 and 23 run the recurrent archs at full width on these of
# their layers (rwkv6-3b 8 of 32, zamba2-2.7b 3 of its 9 groups of 6):
# full depth until PR 30, whose phase 29 took the script past its time;
# 16 and 30 layers until phase 30's training (phase 20 took 102.1 s and
# the script 973.3 s at those on an H100 80GB HBM3 at 700 W)
REC_DEPTH = {"rwkv6_3b": 8, "zamba2_2_7b": 18}


def _rec_cfg(arch):
    """The recurrent arch's full config at REC_DEPTH of its layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=REC_DEPTH[arch])


REC_CASES = (("rwkv fp", "rwkv6_3b", dict(mode="fp")),
             ("rwkv fp int8 slabs", "rwkv6_3b", dict(mode="fp",
                                                     state_bits=8)),
             ("rwkv int", "rwkv6_3b", dict(mode="int")),
             ("zamba fp", "zamba2_2_7b", dict(mode="fp", kv_bits=None)),
             ("zamba fp int8 pool + slabs", "zamba2_2_7b",
              dict(mode="fp", kv_bits=8, state_bits=8)),
             ("zamba int", "zamba2_2_7b", dict(mode="int", kv_bits=8)))


def _rec_per_dispatch(cfg) -> dict:
    """Launches of one recurrent dispatch: K2 in INT mode (RWKV6: 8 a layer
    -- r, k, v, g, o and the channel mix's k, v, r -- and the head;
    zamba2: 2 a Mamba block, 8 a shared-block application -- in_proj, q,
    k, v, o, w1, w3, w2 -- and the head), K4 once a shared-block
    application."""
    if cfg.family == "ssm":
        return {"int8_matmul": 8 * cfg.n_layers + 1, "paged_attention": 0}
    groups = cfg.n_layers // cfg.hybrid.attn_every
    return {"int8_matmul": 2 * cfg.n_layers + 8 * groups + 1,
            "paged_attention": groups}


def _slab_arrays(cache):
    """(arena, slab axis) of every state arena of a recurrent cache."""
    if "state" in cache:
        return [(a, 1) for a in cache["state"].values()]
    return [(a, 2) for a in cache["ssm"]]


def _rec_model_batch(torch, step, vocab, hybrid, gen):
    import numpy as np
    b, c, bs = len(step), HYBRID_CHUNK, 16
    tokens = torch.randint(0, vocab, (b, c), generator=gen).to(torch.int32)
    ids = torch.tensor([r[0] for r in step], dtype=torch.int32)
    q_len = torch.tensor([r[2] for r in step], dtype=torch.int32)
    pos = bt = None
    if hybrid:
        pos = np.full((b, c), REC_MODEL_NBMAX * bs, np.int32)
        bt = np.zeros((b, REC_MODEL_NBMAX + 1), np.int32)
        for i, (slab, start, n) in enumerate(step):
            if n:
                pos[i, :n] = start + np.arange(n)
                bt[i, :REC_MODEL_NBMAX] = (slab - 1) * REC_MODEL_NBMAX + 1 \
                    + np.arange(REC_MODEL_NBMAX)
    return tokens, ids, q_len, pos, bt


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _rec_state_diff(torch, cpu, gpu, acc):
    """Card against CPU state after one step, added into ``acc``: int8
    slab codes (differing, largest step, entries), fp32 slab values
    (entries beyond 1e-4 of the arena's largest |value|, the largest
    |diff| over that value), and the pool outside its trash block (int8
    codes differing, or float entries beyond atol=rtol=1e-4; largest
    |diff|; entries)."""
    for (ac, _), (ag, _) in zip(_slab_arrays(cpu), _slab_arrays(gpu)):
        dd = (ag.cpu().double() - ac.double()).abs()
        if ac.dtype == torch.int8:
            key, bad, top = "slab codes", dd > 0, 1.0
        else:
            top = max(1.0, float(ac.abs().max()))
            key, bad = "slab fp32", dd > 1e-4 * top
        n, m, e = acc.get(key, (0, 0.0, 0))
        acc[key] = (n + int(bad.sum()), max(m, float(dd.max()) / top),
                    e + dd.numel())
    if "paged_kv" in cpu:
        for ac, ag in zip(cpu["paged_kv"], gpu["paged_kv"]):
            c_, g_ = ac[:, 1:].double(), ag[:, 1:].cpu().double()
            dd = (g_ - c_).abs()
            bad = dd > 0 if ac.dtype == torch.int8 else \
                dd > 1e-4 + 1e-4 * c_.abs()
            n, m, e = acc.get("pool", (0, 0.0, 0))
            acc["pool"] = (n + int(bad.sum()), max(m, float(dd.max())),
                           e + dd.numel())


class _ModuleSync:
    """Comparison module by module: on the card every ``qlinear`` call's
    input and output are recorded; on the CPU each call runs on the card's
    input for the same call (``on``), its output compared with the card's:
    ``y_diff`` counts the outputs that differ (with ``tol``, those beyond
    atol = rtol = ``tol``).  Only the calls of the thread that entered
    ``on`` are recorded or replayed: another thread's (a CPU reference on
    the background thread) run the real op.  Disabled, ``on`` changes
    nothing."""

    def __init__(self, enabled: bool, tol=None):
        import repro_torch.models.common as common
        self.enabled, self.common, self.tol = enabled, common, tol
        self.card, self.calls, self.x_diff, self.y_diff = [], 0, 0.0, 0

    def _n_diff(self, y, yc) -> int:
        if self.tol is None:
            return int((y != yc).sum())
        return int(((y - yc).abs() > self.tol * (1 + yc.abs())).sum())

    def on(self, device):
        """Modules that share an input (``common.linears``) are one call,
        all their outputs compared."""
        if not self.enabled:
            return contextlib.nullcontext()
        common = self.common
        real, real_many = common.qlinear, common.linears

        def card_many(ctx, names, x, ws, bs=None):
            ys = real_many(ctx, names, x, ws, bs)
            self.card.append((x.cpu(), [y.cpu() for y in ys]))
            return ys

        def cpu_many(ctx, names, x, ws, bs=None):
            xc, ycs = self.card.pop(0)
            check(xc.shape == x.shape and len(ycs) == len(names),
                  f"modules {names}: the CPU's call order differs from the "
                  f"card's")
            self.x_diff = max(self.x_diff, float((xc - x).abs().max()))
            ys = real_many(ctx, names, xc, ws, bs)
            self.y_diff += sum(self._n_diff(y, yc) for y, yc in zip(ys, ycs))
            self.calls += len(names)
            return ys

        def card(ctx, name, x, w, b=None, **kw):
            y = real(ctx, name, x, w, b, **kw)
            self.card.append((x.cpu(), [y.cpu()]))
            return y

        def cpu(ctx, name, x, w, b=None, **kw):
            xc, (yc,) = self.card.pop(0)
            check(xc.shape == x.shape, f"module {name}: the CPU's call "
                  f"order differs from the card's")
            self.x_diff = max(self.x_diff, float((xc - x).abs().max()))
            y = real(ctx, name, xc, w, b, **kw)
            self.y_diff += self._n_diff(y, yc)
            self.calls += 1
            return y

        owner = threading.get_ident()

        def mine(fn, other):
            return lambda *a, **kw: (
                fn if threading.get_ident() == owner else other)(*a, **kw)

        @contextlib.contextmanager
        def patched():
            on_card = device == "cuda"
            common.qlinear = mine(card if on_card else cpu, real)
            common.linears = mine(card_many if on_card else cpu_many,
                                  real_many)
            try:
                yield
            finally:
                common.qlinear, common.linears = real, real_many
            check(device == "cuda" or not self.card,
                  f"{len(self.card)} card module calls the CPU never made")
        return patched()


def phase_recurrent_model(torch, out):
    """``paged_recurrent_step`` at full width and reduced depth (RWKV6: 2
    layers; zamba2: one group, 6 Mamba blocks and the shared block) in
    fp32, kernels on the card against the plain path on the CPU, two
    steps over REC_MODEL_ROWS, K4's list planned and padded as the
    engine's.  Each step starts from the same state on both devices (the
    card's state is copied to the CPU after the comparison), so a code
    flipped in one step is not counted again through the next.
    Tolerances, as phases 4, 9 and 16 set them: the two devices sum fp32
    products in other orders, so a float within an ulp of a rounding
    boundary may take the neighbouring code.  FP: the real rows' logits
    within atol=rtol=1e-3 in at least 99.9% of entries, all within 5e-2.
    INT: a flipped r / k / v (or Mamba input) code feeds the recurrence
    and moves every later token of its row, so the devices are held
    module by module: the CPU's step runs each ``qlinear`` on the card's
    input for that call (the largest input difference printed: padded
    rows of the hybrid attend over the trash block, whose rows the two
    devices fill in other orders), and every module's output codes and
    the logits must be identical.  Both:
    every real row's greedy token identical;
    int8 slab codes (all arenas together, as phase 9 pools its layers)
    and pool codes (the trash block left out) within one step, at most
    0.1% differing; fp32 slab values within 1e-2 of the arena's largest
    |value|; float pools beyond atol=rtol=1e-4 in at most 0.1% of
    entries; K4 launched once a group and step, K2 as
    ``_rec_per_dispatch`` says in INT."""
    from repro_torch.configs import get_config
    from repro_torch.core.qmodel import (QuantContext, QuantMode,
                                         quantize_weight_tree)
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (paged_capacity,
                                                     plan_paged_work)
    from repro_torch.kernels.ragged_flash import pad_work
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    res = {}
    for arch, depth in (("rwkv6_3b", 2), ("zamba2_2_7b", 6)):
        hybrid = arch.startswith("zamba")
        base = dataclasses.replace(get_config(arch), n_layers=depth,
                                   dtype="float32")
        p_gpu = M.init_params(base, 0, device="cuda")
        p_cpu = _tree_to(p_gpu, "cpu")
        for mode, bits in (("fp", None), ("fp", 8), ("int", None),
                           ("int", 8)):
            cfg = dataclasses.replace(base, state_bits=bits,
                                      kv_cache_bits=bits if hybrid else None)
            ctx = QuantContext(mode=QuantMode(mode))
            case = (f"{arch} {mode}, {'int8' if bits else 'fp32'} slabs"
                    + (f", {'int8' if bits else 'fp32'} pool" if hybrid
                       else ""))
            pc, pg = p_cpu, p_gpu
            if ctx.mode is QuantMode.INT:
                pc = quantize_weight_tree(p_cpu, ctx,
                                          name_fn=M.qlinear_weight)
                pg = quantize_weight_tree(p_gpu, ctx,
                                          name_fn=M.qlinear_weight)
            kw = dict(num_blocks=1 + 3 * REC_MODEL_NBMAX, block_size=16) \
                if hybrid else {}
            caches = {dv: M.init_paged_state(cfg, 4, device=dv, **kw)
                      for dv in ("cpu", "cuda")}
            gen = torch.Generator().manual_seed(20)
            worst = {"frac": 0.0, "max": 0.0}
            state = {}
            tokens_same = True
            sync = _ModuleSync(ctx.mode is QuantMode.INT)
            ops.reset_launch_counts()
            for step in REC_MODEL_ROWS:
                tokens, ids, q_len, pos, bt = _rec_model_batch(
                    torch, step, cfg.vocab_size, hybrid, gen)
                logits = {}
                for dv, params in (("cuda", pg), ("cpu", pc)):
                    work = None
                    if hybrid and dv == "cuda":
                        work = pad_work(plan_paged_work(
                            pos, table_width=bt.shape[1], block_size=16,
                            groups=1), paged_capacity(
                            *pos.shape, groups=1, table_width=bt.shape[1],
                            block_size=16)).to("cuda")
                    with torch.no_grad(), sync.on(dv):
                        lg, caches[dv] = M.paged_recurrent_step(
                            params, tokens.to(dv), caches[dv], ids.to(dv),
                            q_len.to(dv),
                            None if pos is None
                            else torch.from_numpy(pos).to(dv),
                            None if bt is None
                            else torch.from_numpy(bt).to(dv), cfg, ctx,
                            work=work)
                    logits[dv] = lg.float().cpu()
                real = q_len > 0
                a, b = logits["cuda"][real], logits["cpu"][real]
                check(bool(torch.isfinite(a).all()) and a.shape == b.shape
                      == (int(real.sum()), cfg.vocab_padded),
                      f"recurrent model {case}: non-finite or misshapen "
                      f"logits")
                tokens_same &= torch.equal(a.argmax(-1), b.argmax(-1))
                diff = (a - b).abs()
                frac = float(((diff > 0) if mode == "int" else
                              (diff > 1e-3 + 1e-3 * b.abs())).float().mean())
                worst["frac"] = max(worst["frac"], frac)
                worst["max"] = max(worst["max"], float(diff.max()))
                _rec_state_diff(torch, caches["cpu"], caches["cuda"], state)
                for c_, g_ in zip(_tree_leaves(caches["cpu"]),
                                  _tree_leaves(caches["cuda"])):
                    c_.copy_(g_.cpu())
            launches = {k: ops.LAUNCHES[k] for k in
                        ("int8_matmul", "paged_attention",
                         "ragged_attention")}
            want = {k: v * len(REC_MODEL_ROWS) * (k != "int8_matmul"
                                                  or mode == "int")
                    for k, v in _rec_per_dispatch(cfg).items()}
            log(f"[20] recurrent model {case} ({depth} layers, full width, "
                f"fp32, 2 steps of (4, {HYBRID_CHUNK}) with an idle lane, "
                f"each from the same state): real rows' greedy tokens "
                f"{'identical' if tokens_same else 'DIFFER'}; logits max "
                f"|diff| {worst['max']:.3e}, {worst['frac']:.2e} of "
                f"entries {'differ' if mode == 'int' else 'beyond 1e-3'}; "
                f"state over both steps (differing, max |diff| (fp32 slabs:"
                f" over the largest |value|), entries) {state}; launches "
                f"{launches}" + (f"; module by module ({sync.calls} calls): "
                                 f"largest input |diff| {sync.x_diff:.3e}, "
                                 f"output codes differing {sync.y_diff}"
                                 if sync.enabled else ""))
            check(tokens_same, f"recurrent model {case}: greedy tokens "
                  f"differ")
            check(launches == dict(want, ragged_attention=0),
                  f"recurrent model {case}: launches {launches}, want "
                  f"{want}")
            for key, (n, m, e) in state.items():
                if key == "slab fp32":
                    check(m <= 1e-2, f"recurrent model {case}: fp32 slab "
                          f"values differ by {m:.2e} of the largest |value|")
                else:
                    check(n <= 1e-3 * e and (m <= 1 or key == "pool"
                                             and not bits),
                          f"recurrent model {case}: {key} differ in {n} of "
                          f"{e}, max {m}")
            if mode == "int":
                check(sync.y_diff == 0 and worst["max"] == 0,
                      f"recurrent model {case}: {sync.y_diff} module output "
                      f"codes and logits by up to {worst['max']} differ on "
                      f"the same inputs")
            else:
                check(worst["frac"] <= 1e-3 and worst["max"] <= 5e-2,
                      f"recurrent model {case}: logits beyond tolerance in "
                      f"{worst['frac']:.2e} of entries, max {worst['max']}")
            res[case] = dict(logits_max_abs=worst["max"],
                             logits_frac=worst["frac"], state=state,
                             launches=launches, module_input_diff=sync.x_diff)
            del caches, pc, pg
        del p_cpu, p_gpu
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[20] recurrent model phase {time.perf_counter() - t0:.1f} s")
    out["recurrent_model"] = res


def _live_rows_of(fn):
    """``fn()`` with every recurrent dispatch's live rows (q_len > 0)
    counted on the host side of the dispatch, independently of the
    engine's counters: (fn's result, the rows' sum)."""
    from repro_torch.serving.engine import ServingEngine
    rows = []
    real = ServingEngine._dispatch_recurrent

    def counting(self, tokens, slab_ids, q_len, *a, **k):
        rows.append(int((q_len > 0).sum()))
        return real(self, tokens, slab_ids, q_len, *a, **k)

    ServingEngine._dispatch_recurrent = counting
    try:
        return fn(), sum(rows)
    finally:
        ServingEngine._dispatch_recurrent = real


def _rec_engine(torch, arch, params, graphs, kw, num_slabs=None):
    """A cold run of phase 5's workload (8 requests at once, 4 slots) with
    chunk 64 on a fresh recurrent engine at REC_DEPTH, traced."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_engine
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    o, rows = _live_rows_of(lambda: serve_engine(
        arch, smoke=False, params=params, n_requests=8, n_slots=4,
        chunk=HYBRID_CHUNK, rate=1e9, calibrate=False, trace=True,
        graphs=graphs, num_slabs=num_slabs, device="cuda",
        cfg_overrides={"n_layers": REC_DEPTH[arch]}, **kw))
    torch.cuda.synchronize()
    return o["engine"], _rec_result(torch, o["engine"], o["report"], rows,
                                    time.perf_counter() - t0)


def _rec_warm(torch, eng):
    """The same engine again after ``reset_metrics``, the same requests."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import poisson_workload
    eng.reset_metrics()
    reqs = poisson_workload(eng.cfg.vocab_size, n_requests=8, rate=1e9)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        rep, rows = _live_rows_of(lambda: eng.run(reqs))
    torch.cuda.synchronize()
    return _rec_result(torch, eng, rep, rows, time.perf_counter() - t0)


def _rec_result(torch, eng, rep, rows, wall):
    from repro_torch.kernels import ops
    return dict(report=rep, outputs=eng.outputs(), rows=rows,
                launches={k: ops.LAUNCHES[k] for k in
                          ("int8_matmul", "paged_attention",
                           "ragged_attention")},
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                wall_s=wall)


def _slab_elems(eng) -> int:
    """Elements of one sequence's whole state, from the engine's arenas."""
    return sum(a.numel() // a.shape[ax] for a, ax in _slab_arrays(eng.cache))


def _cache_bytes(cache) -> int:
    if isinstance(cache, dict):
        return sum(_cache_bytes(v) for v in cache.values())
    if isinstance(cache, tuple):
        return sum(_cache_bytes(v) for v in cache)
    return cache.numel() * cache.element_size()


def _rec_check(tag, r, ref_run, per, mode, slab_elems, graphs, warm,
               cold_captures=None):
    rep = r["report"]
    n = rep["recurrent_steps"]
    what = (f"{tag} {'graphs' if graphs else 'eager'} "
            f"{'warm' if warm else 'cold'}")
    check(rep["completed"] == 8, f"{what}: not all done")
    check(_same_tokens(r["outputs"], ref_run["outputs"]),
          f"{what}: tokens differ from the eager cold run's")
    check(r["launches"] == ref_run["launches"]
          and rep["kernel_launches"] == {
              k: r["launches"][k] for k in rep["kernel_launches"]},
          f"{what}: launches {r['launches']} (engine "
          f"{rep['kernel_launches']}), eager cold {ref_run['launches']}")
    want = {k: v * n * (k != "int8_matmul" or mode == "int")
            for k, v in per.items()}
    check(r["launches"] == dict(want, ragged_attention=0),
          f"{what}: launches {r['launches']}, want {want} over {n} "
          f"dispatches")
    st = rep["state_pool"]
    check(st["state_quant_ops_per_step"] == slab_elems
          and st["requant_ops_state"] == slab_elems * r["rows"],
          f"{what}: state requant ops {st['requant_ops_state']} "
          f"({st['state_quant_ops_per_step']} a step), counted "
          f"{slab_elems} x {r['rows']} live rows")
    g = rep["step_graphs"]
    if graphs:
        check(g["enabled"] and g["keys"] == 1
              and g["first_calls"] == (0 if warm else 1)
              and g["first_calls"] + g["replays"] == n
              and (not warm or g["captures"] + cold_captures == 1),
              f"{what}: step graphs {g} over {n} dispatches")
    else:
        check(not g["enabled"] and g["replays"] == g["first_calls"]
              == g["captures"] == 0, f"{what}: graphs {g}")


def _rec_preempt_run(torch, params, ref_outputs):
    """RWKV6 FP with graphs, the request with the longest generation
    preempted once after 4 decoded tokens: its slab is copied to the host
    and restored at readmission; every request's tokens must equal the
    uninterrupted run's.  Returns (the report, the preempted rid)."""
    from repro_torch.core.qmodel import QuantContext
    from repro_torch.launch.serve import poisson_workload
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import RequestState
    cfg = _rec_cfg("rwkv6_3b")
    reqs = poisson_workload(cfg.vocab_size, n_requests=8, rate=1e9)
    need = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    eng = ServingEngine(cfg, params, QuantContext(), n_slots=4,
                        chunk=HYBRID_CHUNK, max_model_len=-(-need // 16) * 16,
                        device="cuda")
    victim = max(reqs, key=lambda r: (r.max_new_tokens, -r.rid))
    snapped = False
    with torch.no_grad():
        for r in reqs:
            eng.submit(r)
        while not eng.sched.idle:
            if (not snapped and victim.state is RequestState.DECODE
                    and len(victim.generated) >= 4):
                eng.sched.preempt(victim, eng._now())
                check(victim.snapshot is not None,
                      "recurrent preemption took no snapshot")
                snapped = True
            eng.step()
    check(snapped and eng.state_pool.stats.seq_evictions == 1
          and victim.preemptions == 1,
          f"rwkv snapshot run: request {victim.rid} was not preempted once")
    check(_same_tokens(eng.outputs(), ref_outputs),
          "rwkv snapshot run: tokens differ from the uninterrupted run's")
    return eng.report(), victim.rid


def phase_recurrent_engine(torch, out):
    """serve_engine on rwkv6-3b and zamba2-2.7b at full width in bf16,
    REC_DEPTH of their layers (REC_CASES), each with CUDA graphs and
    eagerly, cold and warm, in turns; after RWKV6's FP case, RWKV6 on an
    undersized slab pool and with a forced snapshot preemption."""
    from repro_torch.models import model as M
    res = {}
    params = {}
    for i, (tag, arch, kw) in enumerate(REC_CASES):
        cfg = _rec_cfg(arch)
        if arch not in params:         # one model's weights at a time
            params.clear()
            gc.collect()
            torch.cuda.empty_cache()
            params[arch] = M.init_params(cfg, 0, device="cuda")
        per = _rec_per_dispatch(cfg)
        runs = {}
        for graphs in ((False, True) if i % 2 == 0 else (True, False)):
            eng, cold = _rec_engine(torch, arch, params[arch], graphs, kw)
            warm = _rec_warm(torch, eng)
            if graphs:
                # the device time of one replay of the step (the engine is
                # drained: a replay rewrites its last step's slabs)
                warm["replay_ms"] = list(_replay_ms(torch, eng).values())
            slab = _slab_elems(eng)
            slab_bytes = _cache_bytes(eng.cache)
            runs[graphs] = (cold, warm)
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        ref_run = runs[False][0]
        rows = {}
        for graphs, (cold, warm) in sorted(runs.items()):
            for w, r in enumerate((cold, warm)):
                _rec_check(tag, r, ref_run, per, kw["mode"], slab, graphs,
                           bool(w), cold["report"]["step_graphs"]["captures"])
                rep = r["report"]
                name = (f"{'graphs' if graphs else 'eager'} "
                        f"{'warm' if w else 'cold'}")
                rows[name] = dict(
                    tokens_per_s=rep["tokens_per_s"],
                    ttft_p50=rep["ttft_s"]["p50"],
                    tpot_p50=rep["tpot_s"]["p50"], wall_s=rep["wall_s"],
                    dispatches=rep["recurrent_steps"],
                    peak_gib=r["peak_gib"], launches=r["launches"],
                    step_graphs=rep["step_graphs"],
                    gen_tokens=rep["gen_tokens"],
                    replay_ms=r.get("replay_ms"))
                log(f"[20] {tag} {name}: {rep['tokens_per_s']} tok/s, TTFT "
                    f"p50 {rep['ttft_s']['p50']:.5f} s, TPOT p50 "
                    f"{rep['tpot_s']['p50']:.5f} s, {rep['gen_tokens']} "
                    f"tokens over {rep['recurrent_steps']} dispatches, "
                    f"launches {r['launches']}, step graphs "
                    f"{rep['step_graphs']}, peak {r['peak_gib']:.3f} GiB"
                    + (f", device time of one replay (events) "
                       f"{r['replay_ms'][0]:.3f} ms" if "replay_ms" in r
                       else ""))
        log(f"[20] {tag}: tokens and launches identical with and without "
            f"graphs, cold and warm; K1 0, K4 {per['paged_attention']} a "
            f"dispatch, K2 "
            f"{per['int8_matmul'] if kw['mode'] == 'int' else 0} a dispatch;"
            f" state requant ops = {slab} a live row and step (counted "
            f"from the arenas) x the dispatches' live rows; state slabs + "
            f"pool {slab_bytes / 2**20:.1f} MiB "
            f"({ref_run['report']['state_pool']['num_slabs']} slabs)")
        rows["slab_elems"], rows["cache_bytes"] = slab, slab_bytes
        res[tag] = rows
        if tag == "rwkv fp":
            res["undersized slabs"] = _rec_extra_runs(
                torch, params[arch], ref_run["outputs"])
    params.clear()
    gc.collect()
    torch.cuda.empty_cache()
    out["recurrent_engine"] = res
    return res


def _rec_extra_runs(torch, params, ref_outputs) -> dict:
    """RWKV6 FP on 3 slabs for 4 slots (admission waits for a slab), and
    with a forced mid-decode snapshot preemption: both on the full-slab
    run's tokens."""
    eng, small = _rec_engine(torch, "rwkv6_3b", params, None,
                             dict(mode="fp"), num_slabs=3)
    del eng
    gc.collect()
    check(_same_tokens(small["outputs"], ref_outputs),
          "rwkv on 3 slabs: tokens differ from the full-slab run's")
    snap, rid = _rec_preempt_run(torch, params, ref_outputs)
    st = small["report"]["state_pool"]
    log(f"[20] rwkv fp on 3 slabs for 4 slots: tokens identical to the "
        f"full-slab run, peak live slabs {st['peak_live_slabs']}, "
        f"{small['report']['tokens_per_s']} tok/s; a forced mid-decode "
        f"preemption copied request {rid}'s slab to the host and resumed "
        f"on the uninterrupted run's tokens "
        f"({snap['state_pool']['seq_evictions']} eviction)")
    return dict(peak_live_slabs=st["peak_live_slabs"],
                tokens_per_s=small["report"]["tokens_per_s"],
                snapshot_rid=rid)


def phase_recurrent(torch, out):
    t0 = time.perf_counter()
    phase_recurrent_model(torch, out)
    res = phase_recurrent_engine(torch, out)
    log(f"[20] recurrent phase {time.perf_counter() - t0:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 23: the recurrent families' classic path
# ---------------------------------------------------------------------------

# zamba2-2.7b's shared attention block: 32 query heads over 32 KV heads of
# 80 (one group a KV head)
ZAMBA_HEADS, ZAMBA_HEAD_DIM = 32, 80
# the card-against-CPU model: decode steps after the (4, 32) prefill
REC_CLASSIC_DECODES = 3


def _rec_classic_cfgs():
    """The card-against-CPU configurations: rwkv6-3b cut to 2 layers and
    zamba2-2.7b to one group (6 Mamba blocks and the shared block, its
    dense cache int8, flash attention), fp32, full width."""
    from repro_torch.configs import get_config
    return (("rwkv6_3b", dataclasses.replace(
                get_config("rwkv6_3b"), n_layers=2, dtype="float32")),
            ("zamba2_2_7b", dataclasses.replace(
                get_config("zamba2_2_7b"), n_layers=6, dtype="float32",
                kv_cache_bits=8, attn_kernel="flash")))


def _rec_forward_launches(cfg, mode, kv_int8):
    """(K2, K3) launches of one classic forward (a prefill or a decode
    step) of a recurrent model.  INT: K2 once a projection (RWKV6: 8 a
    layer -- r, k, v, g, o and the channel mix's k, v, r -- and the head;
    zamba2: 2 a Mamba block, 8 a shared-block application -- in_proj, q,
    k, v, o, w1, w3, w2 -- and the head) and K3 once a module input
    (RWKV6: each projection's own; zamba2: each Mamba projection's, 5 a
    shared-block application -- in_proj, q / k / v together, o, w1 / w3
    together, w2 -- and the head's), plus the tied head's weight; in
    either mode K3 once a shared-block application for its int8 K/V
    write."""
    if cfg.family == "ssm":
        k2 = k3_in = 8 * cfg.n_layers + 1
        kv = 0
    else:
        groups = cfg.n_layers // cfg.hybrid.attn_every
        k2 = 2 * cfg.n_layers + 8 * groups + 1
        k3_in = 2 * cfg.n_layers + 5 * groups + 1
        kv = groups if kv_int8 else 0
    if mode == "int":
        return k2, k3_in + int(cfg.tie_embeddings) + kv
    return 0, kv


def _rec_serve_want(cfg, mode, kv_int8, gen=SERVE_GEN, calibrated=True):
    """Kernel launches of one classic ``serve`` call of a recurrent model:
    ``gen`` forwards (the prefill and gen - 1 decode steps) at
    ``_rec_forward_launches``; on zamba2 K5 once a group in the prefill
    and K6 once a group a decode step; INT's calibration forward (FP mode)
    adds K5 once a group and, over the int8 cache, K3 once a group for
    its K/V write."""
    k2, k3 = _rec_forward_launches(cfg, mode, kv_int8)
    groups = 0 if cfg.family == "ssm" else \
        cfg.n_layers // cfg.hybrid.attn_every
    cal = int(mode == "int" and calibrated)
    return {"flash_prefill": groups * (1 + cal),
            "flash_decode": groups * (gen - 1),
            "int8_matmul": k2 * gen,
            "ragged_attention": 0, "paged_attention": 0,
            "quantize": k3 * gen + cal * (groups if kv_int8 else 0),
            "residual_requant": 0, "int_conv": 0, "int8_matmul_grouped": 0}


def _state_diff(torch, cpu, gpu, acc):
    """Card against CPU cache after one classic step, added into ``acc``:
    float states (entries beyond 1e-4 of the tensor's largest |value|,
    the largest |diff| over that value) and int8 K/V codes (differing,
    largest step), as phase 20 holds its slabs and pool."""
    for ac, ag in zip(_tree_leaves(cpu), _tree_leaves(gpu)):
        dd = (ag.cpu().double() - ac.double()).abs()
        if ac.dtype == torch.int8:
            key, bad, top = "kv codes", dd > 0, 1.0
        else:
            top = max(1.0, float(ac.abs().max()))
            key, bad = "states", dd > 1e-4 * top
        n, m, e = acc.get(key, (0, 0.0, 0))
        acc[key] = (n + int(bad.sum()), max(m, float(dd.max()) / top),
                    e + dd.numel())


def _rec_classic_model(torch, res):
    """(a) ``prefill`` of the (4, 32) serve prompt and REC_CLASSIC_DECODES
    ``decode_step`` calls, kernels on the card against the plain path on
    the CPU, FP and INT, each step from the card's state (the card's cache
    is copied to the CPU after each comparison) and both devices fed the
    card's greedy tokens.  FP: logits within atol = rtol = 2e-4 (phase
    20's reading), greedy tokens identical; INT module by module
    (``_ModuleSync``): every module output and logit identical on the
    card's input.  States within 1e-2 of each tensor's largest |value|,
    int8 K/V codes within one step on at most 0.1%; launches by
    ``_rec_serve_want`` without calibration."""
    from repro_torch.core.qmodel import (QuantContext, QuantMode,
                                         quantize_weight_tree)
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    for arch, cfg in _rec_classic_cfgs():
        p_gpu = M.init_params(cfg, 0, device="cuda")
        p_cpu = _tree_to(p_gpu, "cpu")
        tok0 = torch.from_numpy(_serve_tokens(cfg.vocab_size))
        for mode in ("fp", "int"):
            ctx = QuantContext(mode=QuantMode(mode))
            pc, pg = p_cpu, p_gpu
            if ctx.mode is QuantMode.INT:
                pc = quantize_weight_tree(p_cpu, ctx,
                                          name_fn=M.qlinear_weight)
                pg = quantize_weight_tree(p_gpu, ctx,
                                          name_fn=M.qlinear_weight)
            sync = _ModuleSync(ctx.mode is QuantMode.INT)
            ops.reset_launch_counts()
            state, worst, same = {}, 0.0, True
            caches, tok = {}, {"cuda": tok0.cuda(), "cpu": tok0}
            for step in range(1 + REC_CLASSIC_DECODES):
                logits = {}
                for dv, params in (("cuda", pg), ("cpu", pc)):
                    with torch.no_grad(), sync.on(dv):
                        if step == 0:
                            lg, caches[dv] = M.prefill(
                                params, {"tokens": tok[dv]}, cfg, ctx,
                                max_seq=SERVE_PROMPT + SERVE_GEN)
                        else:
                            pos = SERVE_PROMPT + step - 1
                            lg, caches[dv] = M.decode_step(
                                params, tok[dv], caches[dv],
                                _pos(torch, pos) if dv == "cuda" else pos,
                                cfg, ctx)
                    logits[dv] = lg.float().cpu()
                a, b = logits["cuda"], logits["cpu"]
                check(bool(torch.isfinite(a).all()) and a.shape == b.shape,
                      f"classic {arch} {mode}: non-finite or misshapen "
                      f"logits")
                same &= torch.equal(a.argmax(-1), b.argmax(-1))
                diff = (a - b).abs()
                worst = max(worst, float((diff / (1 + b.abs())).max()))
                _state_diff(torch, caches["cpu"], caches["cuda"], state)
                for c_, g_ in zip(_tree_leaves(caches["cpu"]),
                                  _tree_leaves(caches["cuda"])):
                    c_.copy_(g_.cpu())
                nxt = a.argmax(-1).to(torch.int32)[:, None]
                tok = {"cuda": nxt.cuda(), "cpu": nxt}
            launches = dict(ops.LAUNCHES)
            want = _rec_serve_want(cfg, mode, cfg.kv_cache_bits == 8,
                                   gen=1 + REC_CLASSIC_DECODES,
                                   calibrated=False)
            tag = f"{arch} ({cfg.n_layers} layers) {mode}"
            log(f"[23a] classic {tag}, full width, fp32, prefill (4, "
                f"{SERVE_PROMPT}) + {REC_CLASSIC_DECODES} decode steps, each "
                f"from the card's state: greedy tokens "
                f"{'identical' if same else 'DIFFER'}; logits max |diff| / "
                f"(1 + |logit|) {worst:.3e}; states and codes (differing, "
                f"max |diff| (states: over the largest |value|), entries) "
                f"{state}; launches K2 {launches['int8_matmul']} K3 "
                f"{launches['quantize']} K5 {launches['flash_prefill']} K6 "
                f"{launches['flash_decode']}"
                + (f"; module by module ({sync.calls} calls): largest "
                   f"input |diff| {sync.x_diff:.3e}, output codes differing "
                   f"{sync.y_diff}" if sync.enabled else ""))
            check(same, f"classic {tag}: greedy tokens differ")
            check(launches == want, f"classic {tag}: launches {launches}, "
                  f"want {want}")
            for key, (n, m, e) in state.items():
                if key == "states":
                    check(m <= 1e-2, f"classic {tag}: states differ by "
                          f"{m:.2e} of the largest |value|")
                else:
                    check(n <= 1e-3 * e and m <= 1, f"classic {tag}: K/V "
                          f"codes differ in {n} of {e}, max {m}")
            if mode == "int":
                check(sync.y_diff == 0 and worst == 0,
                      f"classic {tag}: {sync.y_diff} module output codes "
                      f"and logits by up to {worst} differ on the same "
                      f"inputs")
            else:
                check(worst <= 2e-4, f"classic {tag}: logits differ by "
                      f"{worst:.3e} (atol = rtol = 2e-4)")
            res["model"][f"{arch} {mode}"] = dict(
                logits_max_rel=worst, state=state, launches=launches,
                module_input_diff=sync.x_diff)
            del caches, pc, pg
        del p_cpu, p_gpu
        gc.collect()
        torch.cuda.empty_cache()


def _rec_classic_serve(torch, res, params, arch):
    """(b) classic ``serve`` at REC_DEPTH, bf16, flash attention (zamba2
    over its int8 dense cache): INT (calibrated) and FP, each with its
    decode steps captured and eagerly, in turns (graphs, eager, graphs,
    eager), as phase 10: tokens identical, launches by
    ``_rec_serve_want``, the step graphs' counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    cfg = _rec_cfg(arch)
    hybrid = cfg.family == "hybrid"
    overrides = {"n_layers": cfg.n_layers}
    if hybrid:
        overrides["kv_cache_bits"] = 8
    for mode in ("int", "fp"):
        want = _rec_serve_want(cfg, mode, hybrid)
        runs = []
        for rep, graphs in enumerate((True, False, True, False)):
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            o = serve(arch, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                      gen=SERVE_GEN, mode=mode, calibrate=True, smoke=False,
                      params=params, attn_kernel="flash",
                      cfg_overrides=overrides, graphs=graphs, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2**30
            toks, g = o["tokens"], o["graphs"]
            tag = "graphs" if graphs else "eager"
            log(f"[23b] serve {arch} {mode} run {rep} ({tag}): calibration "
                f"{o['calibrate_s']:.3f} s, prefill {o['prefill_s']:.4f} s, "
                f"decode {1e3 * o['decode_s_per_tok']:.3f} ms/token ("
                + ("replays; first call + capture "
                   if graphs else "every step eager; first step ")
                + f"{1e3 * o['compile_decode_s']:.2f} ms), first calls "
                f"{g['first_calls']} captures {g['captures']} replays "
                f"{g['replays']}, launches K2 {launches['int8_matmul']} K3 "
                f"{launches['quantize']} K5 {launches['flash_prefill']} K6 "
                f"{launches['flash_decode']}, peak {peak:.2f} GiB, "
                f"{wall:.1f} s")
            check(toks.shape == (SERVE_BATCH, SERVE_GEN)
                  and int(toks.min()) >= 0
                  and int(toks.max()) < cfg.vocab_size,
                  f"serve {arch} {mode}: tokens {toks}")
            check(launches == want, f"serve {arch} {mode} {tag}: launches "
                  f"{launches}, want {want}")
            check(g == dict(enabled=graphs, first_calls=int(graphs),
                            captures=int(graphs),
                            replays=SERVE_GEN - 2 if graphs else 0),
                  f"serve {arch} {mode} {tag}: step graphs {g}")
            runs.append(dict(graphs=graphs, tokens=toks, launches=launches,
                             calibrate_s=o["calibrate_s"],
                             prefill_s=o["prefill_s"],
                             decode_s_per_tok=o["decode_s_per_tok"],
                             first_decode_s=o["compile_decode_s"],
                             peak_gib=peak, wall_s=wall))
            del o
            torch.cuda.empty_cache()
        check(all((r["tokens"] == runs[0]["tokens"]).all() for r in runs),
              f"serve {arch} {mode}: graphs and eager runs, or repeats, "
              f"gave other tokens")
        log(f"[23b] serve {arch} {mode}: graphs and eager runs "
            f"token-identical, decode "
            f"{[round(1e3 * r['decode_s_per_tok'], 3) for r in runs]} "
            f"ms/token (graphs, eager, graphs, eager)")
        res["serve"][f"{arch} {mode}"] = [
            {k: v for k, v in r.items() if k != "tokens"} for r in runs]


def _rec_classic_engine(torch, res, params, arch):
    """(c) ``serve_engine`` at REC_DEPTH, bf16, on phase 20's workload
    (chunk 64), int8 slabs (and zamba2's int8 pool): calibrated INT and
    ``w8a8=True``, each cold and warm; W8A8's tokens identical to INT's
    (both compute on the same codes), K2 by ``_rec_per_dispatch``."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_engine
    cfg = _rec_cfg(arch)
    per = _rec_per_dispatch(cfg)
    got = {}
    for tag, kw in (("int", dict(mode="int", calibrate=True)),
                    ("w8a8", dict(w8a8=True))):
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        o = serve_engine(arch, smoke=False, params=params, n_requests=8,
                         n_slots=4, chunk=HYBRID_CHUNK, rate=1e9,
                         state_bits=8, kv_bits=8, device="cuda",
                         cfg_overrides={"n_layers": cfg.n_layers}, **kw)
        torch.cuda.synchronize()
        eng = o["engine"]
        cold = _rec_result(torch, eng, o["report"], 0,
                           time.perf_counter() - t0)
        warm = _rec_warm(torch, eng)
        for when, r in (("cold", cold), ("warm", warm)):
            rep = r["report"]
            n = rep["recurrent_steps"]
            log(f"[23c] engine {arch} {tag} {when} (int8 slabs"
                + (", int8 pool" if cfg.family == "hybrid" else "")
                + f"): {rep['tokens_per_s']} tok/s, TTFT p50 "
                f"{rep['ttft_s']['p50']:.5f} s, TPOT p50 "
                f"{rep['tpot_s']['p50']:.5f} s, {rep['gen_tokens']} tokens "
                f"over {n} dispatches, launches {r['launches']}, peak "
                f"{r['peak_gib']:.3f} GiB"
                + (f", {len(o['quantized'].converted)} weight tensors as "
                   f"int8 codes" if o["quantized"] is not None else ""))
            check(rep["completed"] == 8, f"engine {arch} {tag}: not all "
                  f"done")
            check(r["launches"]["int8_matmul"] == per["int8_matmul"] * n
                  and r["launches"]["paged_attention"]
                  == per["paged_attention"] * n,
                  f"engine {arch} {tag} {when}: launches {r['launches']} "
                  f"over {n} dispatches, want {per} a dispatch")
        check(_same_tokens(cold["outputs"], warm["outputs"]),
              f"engine {arch} {tag}: warm tokens differ from cold")
        got[tag] = (cold, warm)
        res["engine"][f"{arch} {tag}"] = {
            when: dict(tokens_per_s=r["report"]["tokens_per_s"],
                       ttft_p50=r["report"]["ttft_s"]["p50"],
                       tpot_p50=r["report"]["tpot_s"]["p50"],
                       dispatches=r["report"]["recurrent_steps"],
                       launches=r["launches"], peak_gib=r["peak_gib"])
            for when, r in (("cold", cold), ("warm", warm))}
        del o, eng
        gc.collect()
        torch.cuda.empty_cache()
    check(_same_tokens(got["w8a8"][0]["outputs"], got["int"][0]["outputs"]),
          f"engine {arch}: W8A8 tokens differ from calibrated INT's")
    log(f"[23c] engine {arch}: W8A8 token-identical to calibrated INT")


def _ulps(t1: float, t2: float, mantissa: int) -> float:
    """The top-2 margin in units of the top value's ulp."""
    ulp = 2.0 ** (math.floor(math.log2(abs(t1))) - mantissa) if t1 \
        else 2.0 ** -149
    return (t1 - t2) / ulp


def _rec_classic_vs_engine(torch, res):
    """(d) the classic path against the engine (fp32 slabs, FP) on phase
    20's workload, 2 layers / one group, fp32: whether each request's
    greedy tokens agree, and at the first divergent token the top-2 logit
    margin (fp32 ulps) of the classic prefill of the agreed prefix.
    Printed, not gated (the CPU tests gate it)."""
    import numpy as np
    from repro_torch.core.qmodel import QuantContext
    from repro_torch.launch.serve import poisson_workload
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingEngine
    ctx = QuantContext()
    for arch, cfg in _rec_classic_cfgs():
        params = M.init_params(cfg, 0, device="cuda")
        reqs = poisson_workload(cfg.vocab_size, n_requests=8, rate=1e9)
        need = max(len(r.prompt) + r.max_new_tokens for r in reqs)
        eng = ServingEngine(cfg, params, ctx, n_slots=4, chunk=HYBRID_CHUNK,
                            max_model_len=-(-need // 16) * 16,
                            device="cuda")
        rows, n_same = [], 0
        with torch.no_grad():
            eng.run(reqs)
            outs = eng.outputs()
            for r in reqs:
                prompt = torch.from_numpy(
                    np.asarray(r.prompt, np.int64)).cuda()[None]
                logits, cache = M.prefill(params, {"tokens": prompt}, cfg,
                                          ctx, max_seq=need)
                got = []
                for i in range(r.max_new_tokens):
                    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
                    got.append(int(tok))
                    if i + 1 < r.max_new_tokens:
                        logits, cache = M.decode_step(
                            params, tok, cache,
                            _pos(torch, len(r.prompt) + i), cfg, ctx)
                eng_toks = [int(t) for t in outs[r.rid]]
                if got == eng_toks:
                    n_same += 1
                    continue
                i = next(j for j, (a, b) in enumerate(zip(got, eng_toks))
                         if a != b)
                prefix = torch.from_numpy(np.concatenate(
                    [np.asarray(r.prompt, np.int64),
                     np.asarray(got[:i], np.int64)])).cuda()[None]
                lg, _ = M.prefill(params, {"tokens": prefix}, cfg, ctx)
                top = torch.topk(lg[0].float(), 2)
                t1, t2 = (float(v) for v in top.values)
                rows.append((r.rid, i, got[i], eng_toks[i],
                             _ulps(t1, t2, 23)))
        log(f"[23d] classic vs engine {arch} ({cfg.n_layers} layers, fp32, "
            f"FP, fp32 slabs{', int8 cache and pool' if cfg.kv_cache_bits else ''}): "
            f"{n_same} of {len(reqs)} requests token-identical"
            + "".join(f"; request {rid} first differs at token {i} "
                      f"(classic {a}, engine {b}), top-2 margin "
                      f"{m:.1f} fp32 ulps" for rid, i, a, b, m in rows))
        res["classic_vs_engine"][arch] = dict(same=n_same, total=len(reqs),
                                              divergences=rows)
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()


def _rec_attention_kernels(torch, res):
    """(e) K5 and K6 at zamba2-2.7b's shared block (32 query heads over 32
    KV heads of 80, bf16 q, int8 cache): K5 the (4, 32) prefill over 48
    rows, K6 a decode step at pos 47 of 48 and at pos 32767 of 32768, each
    held against its plain version (atol = rtol = 2e-2; past 1024 rows
    also within LONG_ROW_TOL of each row's largest |value|, which a
    repeated kv tile fails) and timed as phases 6 and 7 time them, beside
    the bound and SDPA on the dequantized K/V."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import plan_decode_splits
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    h = kvh = ZAMBA_HEADS
    d = ZAMBA_HEAD_DIM
    sdpa, sdpa_how = _sdpa(torch)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    b, sq, skv = SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT + SERVE_GEN
    q, k, v, nkv = _dense_qkv(torch, gen, b, sq, skv, h, kvh, d,
                              torch.bfloat16, torch.int8)
    got = ops.flash_attention(q, k, v, kv_frac_bits=nkv)
    want = ref.flash_attention_ref(q, k, v, kv_frac_bits=nkv)
    torch.cuda.synchronize()
    err = _close(torch, got, want, 2e-2, "K5 at zamba2's shape")
    ms = time_ms(torch, lambda: ops.flash_attention(
        q, k, v, kv_frac_bits=nkv), 50)
    plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(
        q, k, v, kv_frac_bits=nkv), 3, warmup=1)
    kf = _deq(torch, k[:, :sq], nkv, q.dtype).contiguous()
    vf = _deq(torch, v[:, :sq], nkv, q.dtype).contiguous()
    lib = sdpa(q, kf, vf, True).transpose(1, 2)
    check(torch.allclose(lib.float(), want.float(), atol=5e-2, rtol=5e-2),
          "K5 at zamba2's shape: SDPA disagrees")
    lib_ms = time_ms(torch, lambda: sdpa(q, kf, vf, True), 50)
    n_bytes = 2 * q.numel() * q.element_size() + 2 * b * sq * kvh * d
    n_ops = b * h * 4 * d * sum(i + 1 for i in range(sq))
    b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
    res["k5"] = dict(name="zamba2 prefill, int8 cache", b=b, sq=sq, skv=skv,
                     h=h, kvh=kvh, d=d, ms=ms, plain_ms=plain_ms,
                     library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                     max_abs_err=err)
    log(f"[23e] K5 at zamba2's shape (B {b}, Sq {sq} over {skv} int8 rows, "
        f"H {h}, KVH {kvh}, D {d}, bf16 q): within atol=rtol=2e-2 (max "
        f"|diff| {err:.2e}) | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"SDPA ({sdpa_how}) {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    del q, k, v, kf, vf
    for s_max, pos in ((skv, skv - 1), (K6_LONG, K6_LONG - 1)):
        q, k, v, nkv = _dense_qkv(torch, gen, b, 1, s_max, h, kvh, d,
                                  torch.bfloat16, torch.int8)
        pos_t = _pos(torch, pos)
        got = ops.flash_decode(q, k, v, pos=pos_t, kv_frac_bits=nkv)
        want = ref.flash_decode_ref(q, k, v, pos=pos, kv_frac_bits=nkv)
        torch.cuda.synchronize()
        what = f"K6 at zamba2's shape, pos {pos} of {s_max}"
        err = _close(torch, got, want, 2e-2, what)
        if pos >= 1024:
            _close_rows(torch, got, want, LONG_ROW_TOL, what)
            check(_tile_fault_caught(torch, ref.flash_decode_ref, q, k, v,
                                     want, LONG_ROW_TOL, pos // 256, pos=pos,
                                     kv_frac_bits=nkv),
                  f"{what}: the row tolerance passes a repeated kv tile")
        ms = time_ms(torch, lambda: ops.flash_decode(
            q, k, v, pos=pos_t, kv_frac_bits=nkv), 50)
        plain_ms = time_ms(torch, lambda: ref.flash_decode_ref(
            q, k, v, pos=pos_t, kv_frac_bits=nkv), 5, warmup=1)
        kf = _deq(torch, k[:, :pos + 1], nkv, q.dtype).contiguous()
        vf = _deq(torch, v[:, :pos + 1], nkv, q.dtype).contiguous()
        lib_ms = time_ms(torch, lambda: sdpa(q, kf, vf, False), 50)
        n_bytes = 2 * q.numel() * q.element_size() + 2 * b * (pos + 1) \
            * kvh * d
        n_ops = b * h * 4 * d * (pos + 1)
        b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
        splits, chunk = plan_decode_splits(s_max, b, kvh, sms)
        key = "k6" if s_max == skv else "k6_long"
        res[key] = dict(name=f"zamba2 decode, pos {pos} of {s_max}", b=b,
                        s_max=s_max, pos=pos, h=h, kvh=kvh, d=d, ms=ms,
                        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                        bound_by=b_by, max_abs_err=err, splits=splits,
                        chunk=chunk)
        log(f"[23e] {what} (B {b}, H {h}, KVH {kvh}, D {d}, bf16 q, int8 "
            f"cache; {splits} split(s) of {chunk} rows): within "
            f"atol=rtol=2e-2 (max |diff| {err:.2e}) | kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, SDPA ({sdpa_how}) on the dequantized "
            f"slice {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        del q, k, v, kf, vf
        torch.cuda.empty_cache()


def phase_recurrent_classic(torch, out):
    """Phase 23: the recurrent families' classic path -- (a) the 2-layer /
    one-group model card against CPU, (b) classic ``serve`` and (c) the
    calibrated INT and W8A8 engines at REC_DEPTH, (d) the classic path
    against the engine, (e) K5 and K6 at zamba2's head dim 80."""
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    res = {"model": {}, "serve": {}, "engine": {}, "classic_vs_engine": {}}
    _rec_classic_model(torch, res)
    for arch in ("rwkv6_3b", "zamba2_2_7b"):
        params = M.init_params(_rec_cfg(arch), 0, device="cuda")
        _rec_classic_serve(torch, res, params, arch)
        _rec_classic_engine(torch, res, params, arch)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    _rec_classic_vs_engine(torch, res)
    _rec_attention_kernels(torch, res)
    res["seconds"] = time.perf_counter() - t0
    log(f"[23] recurrent classic phase {res['seconds']:.1f} s")
    out["recurrent_classic"] = res
    return res


# ---------------------------------------------------------------------------
# phase 21: K3 as the LM path's quantizer, K2's float epilogue
# ---------------------------------------------------------------------------

# K3's bit-exactness grid: the serving and recurrent row counts and a long
# prefill's, the module inputs' and the K/V rows' widths (and two widths
# whose rows end off a vector), the grids -2 / 0 / 4 / 8 / 12, one to three
# of them a launch, with repeats
K3_ROWS = (1, 23, 24, 25, 256, 4096)
K3_WIDTHS = (1024, 2048, 6144)
K3_ODD_WIDTHS = (1001, 15)
K3_GRIDS = (-2, 0, 4, 8, 12)
K3_GRID_SETS = ((4,), (4, 4), (0, 8), (-2, 12, 4), (8, 8, 0))
# the engine step's K3 launches at qwen3-1.7B (T = 24 rows, bf16): the
# module inputs (width, launches a step: wq / wk / wv, wo, w1 / w3 and w2
# a layer, the LM head), the K/V write (rows of KVH x D, a layer)
K3_STEP_INPUTS = (("wq/wk/wv input", 2048, 28), ("wo input", 2048, 28),
                  ("w1/w3 input", 2048, 28), ("w2 input", 6144, 28),
                  ("lm_head input", 2048, 1))
K3_SCATTER_WIDTH, K3_SCATTER_PER_STEP = 1024, 28
K3_PER_LAYER = 5           # launches a layer: 4 module inputs + the K/V write
# K2's float epilogue: the serving (K, N) and one N off the 8-column
# groups (the dp4a tile) at these rows
K2F_ROWS = (1, 24, 256)
K2F_ODD = (2048, 1004)


def _k3_input(torch, gen, rows, width, ns, dtype, misaligned=False):
    """(rows, width) float values spanning past the clip range of every
    grid in ``ns``, exact .5 ties on each grid, 0 and -0.0; misaligned: a
    contiguous view one element off the allocation (the scalar path)."""
    n = rows * width
    x = torch.randn(n + 1, generator=gen, device="cuda") \
        * 2.0 ** (6 - max(ns))
    k = min(n, 4096)
    grid = torch.tensor(ns, device="cuda")[torch.arange(k, device="cuda")
                                           % len(ns)]
    codes = torch.randint(-140, 140, (k,), generator=gen, device="cuda")
    x[:k] = (codes + 0.5) * torch.pow(2.0, -grid.float())
    x[:2] = torch.tensor([0.0, -0.0], device="cuda")
    x = x.to(dtype)
    return (x[1:] if misaligned else x[:n]).view(rows, width)


def _k3_multi_grid(torch, gen):
    """K3's multi-grid form against its plain version over the grid, each
    case also on a misaligned input; returns the case count and the
    largest code difference."""
    from repro_torch.kernels import ops, ref
    cases, err = 0, 0
    shapes = [(r, w) for r in K3_ROWS for w in K3_WIDTHS] + \
        [(r, w) for r in (3, 24) for w in K3_ODD_WIDTHS]
    for rows, width in shapes:
        for dt in (torch.bfloat16, torch.float32):
            for ns in K3_GRID_SETS:
                for mis in (False, True):
                    x = _k3_input(torch, gen, rows, width, ns, dt, mis)
                    got = ops.quantize_multi(x, ns)
                    want = ref.quantize_multi_ref(x, ns)
                    for i, (g, w) in enumerate(zip(got, want)):
                        err = max(err, _exact(
                            g, w, f"K3 multi ({rows}, {width}) {dt} grids "
                                  f"{ns} [{i}]{' misaligned' * mis}"))
                    check(all((got[i] is got[j]) == (ns[i] == ns[j])
                              for i in range(len(ns))
                              for j in range(len(ns))),
                          f"K3 multi grids {ns}: equal grids must share one "
                          f"output")
                    cases += 1
    return cases, err


def _k3_scatter_case(torch, gen, rows, width, n, dt, idx_dt, mis):
    """K and V rows to a pool of 16 trash rows + 2 x rows live rows: the
    last rows // 8 + 1 rows to the trash rows 0..4 (duplicates), the rest
    to shuffled live rows; kernel against plain on equal pools (a trash
    row that several rows race to: each code is one of theirs); returns
    the largest code difference of the rows held to the plain version."""
    from repro_torch.kernels import ops, ref
    pool_rows = 16 + 2 * rows
    pad = min(rows, rows // 8 + 1)
    live = torch.randperm(2 * rows, generator=gen, device="cuda")[
        :rows - pad] + 16
    trash = torch.randint(0, 5, (pad,), generator=gen, device="cuda")
    index = torch.cat([live, trash]).to(idx_dt)
    k = _k3_input(torch, gen, rows, width, (n,), dt, mis)
    v = _k3_input(torch, gen, rows, width, (n,), dt, mis)
    init = torch.randint(-128, 128, (2, pool_rows * width + 1),
                         generator=gen, device="cuda", dtype=torch.int32
                         ).to(torch.int8)
    pools = []
    for _ in range(2):
        buf = init.clone()
        pools.append([(b[1:] if mis else b[:-1]).view(pool_rows, width)
                      for b in buf])
    (gk, gv), (pk, pv) = pools
    ops.quantize_scatter(k, v, index, gk, gv, n=n)
    ref.quantize_scatter_ref(k, v, index, pk, pv, n=n)
    what = (f"K3 scatter ({rows}, {width}) {dt} n {n} {idx_dt}"
            f"{' misaligned' * mis}")
    err = max(_exact(gk[16:], pk[16:], what + " K pool"),
              _exact(gv[16:], pv[16:], what + " V pool"))
    for got, src, plain in ((gk, k, pk), (gv, v, pv)):
        codes = ref.quantize_ref(src, n=n)
        for t in range(16):
            sent = (index == t).nonzero().flatten()
            if sent.numel() == 0:
                err = max(err, _exact(got[t], plain[t],
                                      what + f" untouched trash row {t}"))
            else:
                # rows racing to one pool row: each code from one of them
                check(bool((got[t][None] == codes[sent]).any(0).all()),
                      f"{what}: trash row {t} holds a code none of its "
                      f"{sent.numel()} rows has in that column")
    return err


def _k2_float_grid(torch, gen):
    """K2's float epilogue (bf16 and fp32) against ``dequant`` of the
    kernel's own codes, bit for bit, at every serving (K, N) and the dp4a
    tile's N, rows K2F_ROWS, three epilogue specs, an aligned and (for
    the dp4a tile) a misaligned activation; returns (cases, the paths
    covered, the largest |difference| from ``dequant``)."""
    from repro_torch.core.integer_ops import LinearQuantSpec
    from repro_torch.core.qscheme import dequant
    from repro_torch.kernels import ops
    from repro_torch.kernels.int8_matmul import plan_int8_matmul
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    specs = (("serving", dict(n_x=4, n_w=8, n_b=8, n_o=4), False),
             ("bias>>", dict(n_x=2, n_w=3, n_b=9, n_o=4), True),
             ("shift<0", dict(n_x=0, n_w=1, n_b=1, n_o=6), True))
    cases, paths, err = 0, set(), 0.0
    for k, nn in list(K2_SHAPES) + [K2F_ODD]:
        _, (w,) = _k2_operands(torch, gen, 1, k, nn)
        b = torch.randint(-128, 128, (nn,), generator=gen, device="cuda",
                          dtype=torch.int8)
        for m in K2F_ROWS:
            xs = [torch.randint(-128, 128, (m, k), generator=gen,
                                device="cuda", dtype=torch.int8)]
            if (k, nn) == K2F_ODD:
                buf = torch.randint(-128, 128, (m * k + 1,), generator=gen,
                                    device="cuda", dtype=torch.int32
                                    ).to(torch.int8)
                xs.append(buf[1:].view(m, k))
            for x in xs:
                plan = plan_int8_matmul(m, k, nn, sms,
                                        aligned=x.data_ptr() % 16 == 0)
                paths.add("dp4a" if plan.cfg < 0 else
                          "split-K finish" if plan.splits > 1 else "mma")
                for name, kw, bias in specs:
                    spec = LinearQuantSpec(**kw)
                    bb = b if bias else None
                    codes = ops.int8_matmul(x, w, bb, spec)
                    for dt in (torch.bfloat16, torch.float32):
                        got = ops.int8_matmul(x, w, bb, spec, out_float=dt)
                        want = dequant(codes, spec.n_o, out_dtype=dt)
                        check(got.dtype == dt and got.shape == want.shape,
                              f"K2 float epilogue {name}: output {got.dtype}"
                              f" {tuple(got.shape)}")
                        diff = float((got.float() - want.float()).abs().max())
                        err = max(err, diff)
                        check(diff == 0 and torch.equal(got, want),
                              f"K2 float epilogue {name} M={m} K={k} N={nn} "
                              f"{dt} ({_plan_str(plan)}): != dequant of its "
                              f"codes")
                        cases += 1
        del w
    return cases, paths, err


class _OldChain:
    """The module boundary as the port computed it before K3 and K2's
    float epilogue took it: ``qscheme.quant`` of the input, K2's codes,
    ``qscheme.dequant``; the K/V write as ``quant`` + ``index_copy_``.
    Patched over the package's calls (``common.qlinear`` /
    ``common.linears`` / ``ops.quantize_scatter``) while ``on``; every
    module output is recorded in call order either way."""

    def __init__(self, torch):
        import repro_torch.models.common as common
        from repro_torch.kernels import ops
        self.torch, self.common, self.ops = torch, common, ops

    def qlinear(self, ctx, name, x, w, b=None, reduce=False):
        # (``reduce``: a row-cut module on a mesh; this chain runs on one
        # rank, where it changes nothing)
        from repro_torch.core.integer_ops import LinearQuantSpec
        from repro_torch.core.qscheme import dequant, quant
        int8 = self.torch.int8
        mb = ctx.bits_for(name)
        n_b = mb.n_b if mb.n_b is not None else mb.n_w
        w_int = w if w.dtype == int8 else quant(w, mb.n_w, ctx.bits)
        b_int = None if b is None else (
            b if b.dtype == int8 else quant(b, n_b, ctx.bits))
        spec = LinearQuantSpec(n_x=mb.n_x, n_w=mb.n_w, n_b=n_b, n_o=mb.n_o,
                               bits=ctx.bits)
        codes = self.ops.int8_matmul(quant(x, mb.n_x, ctx.bits), w_int,
                                     b_int, spec)
        return dequant(codes, mb.n_o, out_dtype=x.dtype)

    @staticmethod
    def scatter(k, v, index, k_rows, v_rows, *, n):
        from repro_torch.core.qscheme import quant
        idx = index.long()
        k_rows.index_copy_(0, idx, quant(k, n, 8))
        v_rows.index_copy_(0, idx, quant(v, n, 8))

    @contextlib.contextmanager
    def on(self, old: bool, outputs: list):
        common, ops = self.common, self.ops
        real = (common.qlinear, common.linears, ops.quantize_scatter)
        one = self.qlinear if old else real[0]

        def qlinear(ctx, name, x, w, b=None, **kw):
            y = one(ctx, name, x, w, b, **kw)
            outputs.append((name, y))
            return y

        def linears(ctx, names, x, ws, bs=None):
            if not old:
                ys = real[1](ctx, names, x, ws, bs)
                outputs.extend(zip(names, ys))
                return ys
            bs = [None] * len(names) if bs is None else bs
            return [qlinear(ctx, *a) for a in zip(names, [x] * len(names),
                                                   ws, bs)]

        common.qlinear, common.linears = qlinear, linears
        if old:
            ops.quantize_scatter = self.scatter
        try:
            yield
        finally:
            common.qlinear, common.linears, ops.quantize_scatter = real


def _module_parity(torch):
    """qwen3-1.7B at full width and 2 layers in bf16, INT, two mixed
    ragged steps (phase 4's) on the card through the package's wiring and
    through the old chain, each from a fresh pool: every module output,
    the logits and the pools outside the trash block identical; K3 launched
    5 x layers + 1 times a step by the wiring, never by the old chain."""
    from repro_torch.configs import get_config
    from repro_torch.core.qmodel import (QuantContext, QuantMode,
                                         quantize_weight_tree)
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.attention import RaggedBatch
    cfg = dataclasses.replace(get_config("qwen3_1_7b"), n_layers=2,
                              kv_cache_bits=8)
    ctx = QuantContext(mode=QuantMode.INT)
    params = quantize_weight_tree(M.init_params(cfg, 0, device="cuda"), ctx)
    bs, nb = 16, 8
    steps = _model_steps(cfg.vocab_size, bs)
    chain = _OldChain(torch)
    runs = {}
    for old in (False, True):
        cache = M.init_paged_cache(cfg, nb, bs, device="cuda")
        outputs, logits = [], []
        ops.reset_launch_counts()
        with torch.no_grad(), chain.on(old, outputs):
            for step in steps:
                t = {k: torch.from_numpy(v).to("cuda")
                     for k, v in step.items()}
                rb = RaggedBatch(dest=t["dest"], block_tables=t["bt"],
                                 q_start=t["q_start"], q_len=t["q_len"],
                                 kv_len=t["kv_len"])
                lg, cache = M.ragged_step(params, t["tokens"], cache,
                                          t["positions"], rb, cfg, ctx)
                logits.append(lg)
        torch.cuda.synchronize()
        runs[old] = dict(outputs=outputs, logits=logits, cache=cache,
                         launches=dict(ops.LAUNCHES))
    new, old = runs[False], runs[True]
    check([n for n, _ in new["outputs"]] == [n for n, _ in old["outputs"]],
          "module parity: the wiring and the old chain call other modules")
    bad = [n for (n, a), (_, b) in zip(new["outputs"], old["outputs"])
           if a.dtype != b.dtype or not torch.equal(a, b)]
    check(not bad, f"module parity: {len(bad)} module outputs differ from "
                   f"the old chain's, first {bad[:3]}")
    check(all(torch.equal(a, b) for a, b in zip(new["logits"],
                                                old["logits"])),
          "module parity: logits differ from the old chain's")
    for a, b in zip(new["cache"]["paged_kv"], old["cache"]["paged_kv"]):
        check(torch.equal(a[:, 1:], b[:, 1:]),
              "module parity: pool codes outside the trash block differ")
    per_step = K3_PER_LAYER * cfg.n_layers + 1
    k2_step = 7 * cfg.n_layers + 1
    check(new["launches"]["quantize"] == per_step * len(steps)
          and old["launches"]["quantize"] == 0
          and new["launches"]["int8_matmul"] == k2_step * len(steps)
          == old["launches"]["int8_matmul"],
          f"module parity: launches {new['launches']} (wiring), "
          f"{old['launches']} (old chain)")
    log(f"[21] qwen3-1.7B INT, full width, 2 layers, bf16, {len(steps)} "
        f"mixed ragged steps: {len(new['outputs'])} module outputs, the "
        f"logits and the pools identical through the wiring (K3 "
        f"{new['launches']['quantize']}, K2 "
        f"{new['launches']['int8_matmul']} launches) and the old chain "
        f"(quant -> K2 codes -> dequant, quant + index_copy_; K3 0)")
    return dict(modules=len(new["outputs"]), launches=new["launches"])


def _k3_step_times(torch, gen):
    """K3 at the engine step's shapes (T = 24, bf16): each form's kernel,
    plain version and the chain it replaced (``qscheme.quant``; + two
    ``index_copy_``), beside the bound; summed over one step's 141
    launches."""
    from repro_torch.core.qscheme import quant
    from repro_torch.kernels import ops, ref
    t = K2_STEP_ROWS
    rows, step = [], dict(ms=0.0, plain_ms=0.0, chain_ms=0.0, bytes=0,
                          ops=0, launches=0)

    def add(name, per, ms, plain_ms, chain_ms, n_bytes, n_ops):
        b_ms, b_by = bound_ms(n_bytes, n_ops, "float32")
        rows.append(dict(name=name, per_step=per, ms=ms, plain_ms=plain_ms,
                         chain_ms=chain_ms, bound_ms=b_ms, bound_by=b_by))
        log(f"    K3 {name}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
            f"old chain {chain_ms:.5f} ms, bound {b_ms:.6f} ms ({b_by}); "
            f"{per} a step")
        if per:
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("chain_ms", chain_ms), ("bytes", n_bytes),
                             ("ops", n_ops), ("launches", 1)):
                step[key] += per * val

    for name, width, per in K3_STEP_INPUTS:
        x = torch.randn(t, width, generator=gen, device="cuda").to(
            torch.bfloat16)
        add(f"{name} ({t}, {width}) bf16, one grid", per,
            time_ms(torch, lambda: ops.quantize_multi(x, (4,)), 200),
            time_ms(torch, lambda: ref.quantize_multi_ref(x, (4,)), 50),
            time_ms(torch, lambda: quant(x, 4, 8), 50),
            3 * x.numel(), 4 * x.numel())
    x = torch.randn(t, 2048, generator=gen, device="cuda").to(torch.bfloat16)
    ns = (3, 4, 5)
    add(f"calibrated wq/wk/wv input ({t}, 2048) bf16, three grids", 0,
        time_ms(torch, lambda: ops.quantize_multi(x, ns), 200),
        time_ms(torch, lambda: ref.quantize_multi_ref(x, ns), 50),
        time_ms(torch, lambda: [quant(x, n, 8) for n in ns], 50),
        5 * x.numel(), 12 * x.numel())
    k, v = (torch.randn(t, K3_SCATTER_WIDTH, generator=gen, device="cuda"
                        ).to(torch.bfloat16) for _ in range(2))
    pool_rows = 64 * 16
    pk, pv = (torch.zeros(pool_rows, K3_SCATTER_WIDTH, dtype=torch.int8,
                          device="cuda") for _ in range(2))
    idx = (torch.randperm(pool_rows - 16, generator=gen, device="cuda")[:t]
           + 16).to(torch.int32)

    def chain():
        il = idx.long()
        pk.index_copy_(0, il, quant(k, 4, 8))
        pv.index_copy_(0, il, quant(v, 4, 8))

    add(f"K/V write ({t}, {K3_SCATTER_WIDTH}) x 2 bf16 -> int8 pool rows",
        K3_SCATTER_PER_STEP,
        time_ms(torch, lambda: ops.quantize_scatter(k, v, idx, pk, pv, n=4),
                200),
        time_ms(torch, lambda: ref.quantize_scatter_ref(k, v, idx, pk, pv,
                                                        n=4), 50),
        time_ms(torch, chain, 50), 6 * k.numel() + 4 * t, 8 * k.numel())
    step["bound_ms"], step["bound_by"] = bound_ms(step["bytes"], step["ops"],
                                                  "float32")
    log(f"[21] K3 one engine step at T={t} ({step['launches']} launches): "
        f"kernel {step['ms']:.4f} ms, plain {step['plain_ms']:.4f} ms, old "
        f"chain {step['chain_ms']:.4f} ms, bound {step['bound_ms']:.5f} ms "
        f"({step['bound_by']})")
    return dict(shapes=rows, step=step)


def _k2_float_step_times(torch, gen):
    """K2 at M = 24 at every serving (K, N): the float epilogue (bf16, the
    engine's launch), the code epilogue, and the code epilogue + the
    ``dequant`` chain it replaced, beside the float launch's bound and its
    plain version; summed over one step's 197 launches."""
    from repro_torch.core.integer_ops import LinearQuantSpec
    from repro_torch.core.qscheme import dequant
    from repro_torch.kernels import ops, ref
    spec = LinearQuantSpec(n_x=4, n_w=8, n_b=8, n_o=4)
    m = K2_STEP_ROWS
    rows = []
    step = dict(ms=0.0, codes_ms=0.0, chain_ms=0.0, plain_ms=0.0, bytes=0,
                ops=0)
    for (k, n), per in K2_SHAPES.items():
        copies = max(1, math.ceil(128e6 / (k * n)))        # beat the L2
        x, ws = _k2_operands(torch, gen, m, k, n, copies)
        it = [0]

        def nxt():
            it[0] += 1
            return ws[it[0] % copies]

        ms = time_ms(torch, lambda: ops.int8_matmul(
            x, nxt(), None, spec, out_float=torch.bfloat16), 20)
        codes_ms = time_ms(torch, lambda: ops.int8_matmul(x, nxt(), None,
                                                          spec), 20)
        chain_ms = time_ms(torch, lambda: dequant(
            ops.int8_matmul(x, nxt(), None, spec), spec.n_o,
            out_dtype=torch.bfloat16), 20)
        plain_ms = time_ms(torch, lambda: ref.int8_matmul_ref(
            x, nxt(), None, shift=spec.requant_shift,
            out_dtype=torch.bfloat16, n_o=spec.n_o), 3, warmup=1)
        n_bytes, n_ops = m * k + k * n + 2 * m * n, 2 * m * k * n
        b_ms, b_by = bound_ms(n_bytes, n_ops, "int8")
        rows.append(dict(k=k, n=n, ms=ms, codes_ms=codes_ms,
                         chain_ms=chain_ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by))
        log(f"    K2 M={m} K={k:<4} N={n:<6} float epilogue (bf16) "
            f"{ms:.4f} ms, code epilogue {codes_ms:.4f} ms, codes + "
            f"dequant {chain_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        for key, val in (("ms", ms), ("codes_ms", codes_ms),
                         ("chain_ms", chain_ms), ("plain_ms", plain_ms),
                         ("bytes", n_bytes), ("ops", n_ops)):
            step[key] += per * val
        del x, ws
    step["bound_ms"], step["bound_by"] = bound_ms(step["bytes"], step["ops"],
                                                  "int8")
    log(f"[21] K2 one engine step at M={m} (197 launches): float epilogue "
        f"{step['ms']:.3f} ms, code epilogue {step['codes_ms']:.3f} ms, "
        f"codes + dequant {step['chain_ms']:.3f} ms, plain "
        f"{step['plain_ms']:.3f} ms, bound {step['bound_ms']:.3f} ms "
        f"({step['bound_by']})")
    return dict(shapes=rows, step=step)


def phase_quant_fusion(torch, out):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    t0 = time.perf_counter()
    n_multi, k3_err = _k3_multi_grid(torch, gen)
    log(f"[21] K3 multi-grid bit-exact (max |diff| {k3_err}; {n_multi} "
        f"cases: rows {list(K3_ROWS)} x widths {list(K3_WIDTHS)} and rows "
        f"3 / 24 x odd widths {list(K3_ODD_WIDTHS)}, bf16 / fp32, grid sets "
        f"{list(K3_GRID_SETS)}, aligned and misaligned input)")
    n_scatter = 0
    for rows in K3_ROWS:
        for width in K3_WIDTHS + K3_ODD_WIDTHS:
            for dt in (torch.bfloat16, torch.float32):
                k3_err = max(k3_err, _k3_scatter_case(
                    torch, gen, rows, width, K3_GRIDS[n_scatter % 5], dt,
                    (torch.int32, torch.int64)[n_scatter % 2],
                    n_scatter % 3 == 2))
                n_scatter += 1
    log(f"[21] K3 quantize-and-scatter bit-exact (max |diff| of both "
        f"forms {k3_err}; {n_scatter} cases: rows "
        f"{list(K3_ROWS)} x widths {list(K3_WIDTHS + K3_ODD_WIDTHS)} x bf16 "
        f"/ fp32, grids {list(K3_GRIDS)} in turn, int32 / int64 rows, every "
        f"third case misaligned inputs and pools; padding rows on the trash "
        f"rows: each code there one of their rows')")
    n_k2, paths, k2_err = _k2_float_grid(torch, gen)
    check(paths == {"mma", "split-K finish", "dp4a"},
          f"K2 float epilogue: paths covered {sorted(paths)}")
    log(f"[21] K2 float epilogue bit-exact against dequant of its codes "
        f"(max |diff| {k2_err}; {n_k2} cases: M {list(K2F_ROWS)} x every "
        f"serving (K, N) and {K2F_ODD}, three epilogue specs, bf16 / fp32; "
        f"paths "
        f"{sorted(paths)})")
    parity = _module_parity(torch)
    torch.cuda.empty_cache()
    k3 = _k3_step_times(torch, gen)
    k2 = _k2_float_step_times(torch, gen)
    log(f"[21] phase {time.perf_counter() - t0:.1f} s")
    res = dict(k3_cases=n_multi + n_scatter, k2_cases=n_k2,
               parity=parity, k3=k3, k2_float=k2, k3_max_abs_err=k3_err,
               k2_float_max_abs_err=k2_err)
    out["quant_fusion"] = res
    return res


# ---------------------------------------------------------------------------
# phase 22: the paper's dense configurations and its scaling-factor baseline
# ---------------------------------------------------------------------------

# the dense configurations served at full width with the depth cut to
# CUT_LAYERS: their bf16 weights at full depth (``_dense_params``) would
# not leave the card room to serve
CUT_ARCHS, CUT_LAYERS = ("qwen3_32b", "deepseek_67b", "chameleon_34b"), 2
# full-width activations for ``scale_quant`` card against CPU: an engine
# step's stream at llama3.2-1B's and the 8192-wide models' widths, and a
# prompt batch at d_ff
SCALE_QUANT_SHAPES = ((24, 2048), (4, 32, 8192), (128, 22016))


def _dense_params(cfg) -> int:
    """Parameters of a dense GQA config: the embedding (and an untied LM
    head) at the padded vocabulary, and per layer q / o, k / v, the three
    MLP matrices and the norms."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    per_layer = (2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                 + 3 * d * cfg.d_ff + 2 * d + (2 * hd if cfg.qk_norm else 0))
    tables = (1 if cfg.tie_embeddings else 2) * cfg.vocab_padded * d
    return cfg.n_layers * per_layer + tables + d


def _engine_launches_ok(torch, tag, cfg, mode, o, launches):
    """Phase 5's checks on one ragged-engine run of its workload: every
    request done with tokens in the vocabulary, K1 once a layer a step,
    and in INT K2 once a projection and K3 once a module input a layer,
    the LM head's input and (tied embedding) its weight a step; in FP K3
    once a layer a step, the int8 K/V write."""
    rep_ = o["report"]
    steps, L = rep_["ragged_steps"], cfg.n_layers
    want = {"ragged_attention": L * steps,
            "int8_matmul": (7 * L + 1) * steps if mode == "int" else 0,
            "quantize": (K3_PER_LAYER * L + 1 + int(cfg.tie_embeddings)
                         if mode == "int" else L) * steps}
    check(rep_["completed"] == len(o["requests"]),
          f"{tag}: not all requests done")
    for req in o["requests"]:
        toks = o["outputs"][req.rid]
        check(1 <= len(toks) <= req.max_new_tokens and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab_size,
              f"{tag}: request {req.rid} tokens {toks}")
    got = {k: launches[k] for k in want}
    check(got == want, f"{tag}: launches {got}, want {want} ({steps} steps)")
    return steps


def _fake_sf_model(torch, cfg, p_cpu, p_gpu):
    """FAKE_SF (the scaling-factor baseline) prefill + 3 decode steps of the
    2-layer fp32 model over an fp32 cache, card against CPU module by
    module (``_ModuleSync``: the CPU runs each projection on the card's
    input; both fed the card's greedy tokens).  End to end the two cannot
    agree: each projection quantizes its input on a per-tensor grid,
    max|x| / 127, so the fp32 summation orders' last-bit differences flip
    codes and move later layers by whole code steps (ROADMAP Queue 3).
    Module by module every projection's output, and so the logits, must
    hold phase 9's FP rule (atol = rtol = 1e-3 in all but 0.1% of entries,
    all within 5e-2); the projections are held at 1e-3 with none beyond."""
    from repro_torch.core.qmodel import QuantContext, QuantMode
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    ctx = QuantContext(mode=QuantMode.FAKE_SF)
    ccfg = dataclasses.replace(cfg, kv_cache_bits=None)
    tokens = torch.from_numpy(_serve_tokens(cfg.vocab_size))
    prefill = S.build_prefill_step(ccfg, ctx,
                                   max_seq=SERVE_PROMPT + SERVE_GEN)
    sync = _ModuleSync(True, tol=1e-3)
    logits, fed = {}, []
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        with torch.no_grad(), sync.on(dev):
            lg, cache = prefill(params, {"tokens": tokens.to(dev)})
            seq = [lg.float().cpu()]
            for i in range(3):
                if dev == "cuda":       # the card's greedy token, fed to both
                    fed.append(torch.argmax(seq[-1], -1).to(
                        torch.int32)[:, None])
                lg, cache = M.decode_step(params, fed[i].to(dev), cache,
                                          SERVE_PROMPT + i, ccfg, ctx)
                seq.append(lg.float().cpu())
        logits[dev] = seq
    worst_frac = worst_max = 0.0
    for a, b in zip(logits["cuda"], logits["cpu"]):
        check(bool(torch.isfinite(a).all()) and a.shape == b.shape,
              "fake_sf model: non-finite or misshapen logits")
        diff = (a - b).abs()
        worst_frac = max(worst_frac,
                         float((diff > 1e-3 + 1e-3 * b.abs()).float().mean()))
        worst_max = max(worst_max, float(diff.max()))
    log(f"[22] dense model {cfg.name} fake_sf, fp32 cache, module by module "
        f"({sync.calls} projection calls, each on the card's input; the "
        f"CPU's own inputs differ by up to {sync.x_diff:.3e}): outputs "
        f"beyond 1e-3 {sync.y_diff}; logits max |diff| {worst_max:.3e}, "
        f"{worst_frac:.2e} of entries beyond 1e-3")
    check(sync.y_diff == 0, f"fake_sf model: {sync.y_diff} projection "
          f"outputs beyond 1e-3")
    check(worst_frac <= 1e-3 and worst_max <= 5e-2,
          f"fake_sf model: logits beyond 1e-3 in {worst_frac:.2e} of "
          f"entries, max {worst_max}")
    return dict(calls=sync.calls, input_max_abs=sync.x_diff,
                logits_max_abs=worst_max, logits_frac=worst_frac)


def phase_configs(torch, out):
    """llama3.2-1B at full width and depth: classic ``serve`` (INT,
    calibrated, int8 cache) with its decode steps captured, the ragged
    engine on phase 5's workload in FP and INT, and a FAKE_SF (the
    paper's scaling-factor baseline) classic ``serve``; its 2-layer
    full-width model card against CPU under phase 9's rules, and FAKE_SF
    over an fp32 cache module by module under phase 9's FP rule
    (``_fake_sf_model``); ``scale_quant`` card against CPU bit for bit; and qwen3-32B, deepseek-67B and chameleon-34B (family
    ``vlm``) at full width, their depth cut to CUT_LAYERS, one ragged INT
    engine run each."""
    from repro_torch.configs import get_config
    from repro_torch.core.baselines import scale_quant
    from repro_torch.core.qmodel import QuantContext
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve, serve_engine
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    res = {}
    cfg = get_config("llama3_2_1b")
    n_par = _dense_params(cfg)
    params = M.init_params(cfg, 0, device="cuda")
    check(sum(t.numel() for t in _tree_leaves(params)) == n_par,
          f"llama3.2-1B: {n_par} parameters by the formula")
    for mode, overrides in (("int", {"kv_cache_bits": 8}),
                            ("fake_sf", None)):
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        o = serve("llama3_2_1b", batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                  gen=SERVE_GEN, mode=mode, calibrate=True, smoke=False,
                  attn_kernel="flash", cfg_overrides=overrides,
                  params=params, graphs=True, device="cuda")
        torch.cuda.synchronize()
        launches, toks = dict(ops.LAUNCHES), o["tokens"]
        want = _serve_want(cfg, mode, overrides is not None)
        log(f"[22] llama3.2-1B ({n_par / 1e9:.3f} B parameters, 16 layers) "
            f"classic serve {mode}, graphs: tokens {toks.shape}, decode "
            f"{1e3 * o['decode_s_per_tok']:.2f} ms/token (replays; first "
            f"call + capture {1e3 * o['compile_decode_s']:.2f} ms), "
            f"launches K5 {launches['flash_prefill']} K6 "
            f"{launches['flash_decode']} K2 {launches['int8_matmul']} K3 "
            f"{launches['quantize']}, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"{time.perf_counter() - t0:.1f} s")
        check(toks.shape == (SERVE_BATCH, SERVE_GEN) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab_size,
              f"llama serve {mode}: tokens {toks}")
        check(launches == want, f"llama serve {mode}: launches {launches}, "
              f"want {want}")
        check(o["graphs"]["replays"] == SERVE_GEN - 2,
              f"llama serve {mode}: step graphs {o['graphs']}")
        res[f"serve {mode}"] = dict(decode_s_per_tok=o["decode_s_per_tok"],
                                    first_decode_s=o["compile_decode_s"],
                                    launches=launches)
        del o
    for mode in ("fp", "int"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        o = serve_engine("llama3_2_1b", smoke=False, mode=mode,
                         calibrate=False, kv_bits=8, n_requests=8,
                         n_slots=4, rate=1e9, params=params, device="cuda")
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        steps = _engine_launches_ok(torch, f"llama engine {mode}", cfg, mode,
                                    o, launches)
        r = o["report"]
        log(f"[22] llama3.2-1B engine {mode}: {r['gen_tokens']} tokens, "
            f"{r['tokens_per_s']} tok/s, {steps} ragged steps, launches K1 "
            f"{launches['ragged_attention']} K2 {launches['int8_matmul']} K3 "
            f"{launches['quantize']}, TPOT p50 {r['tpot_s']['p50']:.4f} s, "
            f"{time.perf_counter() - t0:.1f} s")
        res[f"engine {mode}"] = dict(tokens_per_s=r["tokens_per_s"],
                                     steps=steps, launches=launches)
        del o
    del params
    torch.cuda.empty_cache()
    # the 2-layer full-width model, fp32, card against CPU (uncalibrated:
    # the default grids), and FAKE_SF under phase 9's FP rule
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                               attn_kernel="flash")
    p_cpu = M.init_params(cfg2, 0, device="cpu")
    p_gpu = _tree_to(p_cpu, "cuda")
    res["dense_model"] = phase_dense_model(
        torch, out, cfg2, p_cpu, p_gpu, QuantContext(), tag="22",
        key="llama_dense_model")
    res["fake_sf_model"] = _fake_sf_model(torch, cfg2, p_cpu, p_gpu)
    del p_cpu, p_gpu
    torch.cuda.empty_cache()
    # scale_quant: card against CPU on the same values, bit for bit
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    n_sq = 0
    for shape in SCALE_QUANT_SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda") * 3
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            got = scale_quant(xd).cpu()
            want = scale_quant(xd.cpu())
            check(got.dtype == dt and torch.equal(got, want),
                  f"scale_quant {dt} {shape}: card and CPU differ in "
                  f"{int((got != want).sum())} entries")
            n_sq += 1
    log(f"[22] scale_quant card against CPU: {n_sq} tensors (fp32 and bf16 "
        f"at {list(SCALE_QUANT_SHAPES)}) bit-identical")
    # the larger dense configurations, depth cut
    for arch in CUT_ARCHS:
        full = get_config(arch)
        cfg_c = dataclasses.replace(full, n_layers=CUT_LAYERS)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        o = serve_engine(arch, smoke=False, mode="int", calibrate=False,
                         kv_bits=8, n_requests=8, n_slots=4, rate=1e9,
                         cfg_overrides={"n_layers": CUT_LAYERS},
                         device="cuda")
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        steps = _engine_launches_ok(torch, f"{arch} engine int", cfg_c,
                                    "int", o, launches)
        r = o["report"]
        log(f"[22] {full.name} ({full.family}) engine int at full width, "
            f"n_layers cut {full.n_layers} -> {CUT_LAYERS} (bf16 weights at "
            f"full depth {2 * _dense_params(full) / 1e9:.1f} GB): "
            f"{r['gen_tokens']} tokens, {steps} ragged steps, launches K1 "
            f"{launches['ragged_attention']} K2 {launches['int8_matmul']} K3 "
            f"{launches['quantize']}, {time.perf_counter() - t0:.1f} s")
        res[arch] = dict(steps=steps, launches=launches,
                         full_depth_bf16_gb=2 * _dense_params(full) / 1e9)
        del o
        torch.cuda.empty_cache()
    log(f"[22] phase {time.perf_counter() - t_phase:.1f} s")
    out["configs"] = res
    return res


# ---------------------------------------------------------------------------
# phase 24: the MoE family with MLA, and K2's grouped form
# ---------------------------------------------------------------------------

# the grouped K2's path shapes: (label, E, K, N) at C = 128 (the experts'
# capacity at the serve prompt and at a decode step)
GK2_SHAPES = (("granite w1/w3", 48, 1536, 512), ("granite w2", 48, 512, 1536),
              ("deepseek w1/w3", 256, 7168, 2048),
              ("deepseek w2", 256, 2048, 7168))
GK2_CAP = 128
# small odd shapes (E, C, K, N): C off the 16-row tiles, one expert, one
# row, the narrowest K and N the tensor-core tile takes
GK2_ODD = ((3, 40, 48, 24), (5, 17, 16, 8), (1, 1, 32, 16), (7, 130, 64, 40))
# the epilogues held: (name, spec, output)
GK2_SPECS = (("codes", dict(n_x=4, n_w=8, n_b=8, n_o=4), None),
             ("bf16", dict(n_x=4, n_w=8, n_b=8, n_o=4), "bfloat16"),
             ("fp32 shift<0", dict(n_x=0, n_w=1, n_b=1, n_o=6), "float32"))
# the MLA attention's K5 shape at deepseek-v3's width (the expanded
# forward of the serve prompt): H = KVH 128, Dk 192, Dv 128, bf16 K/V
MLA_HEADS, MLA_DK, MLA_DV = 128, 192, 128
# granite's attention: 24 heads over 8 KV heads of 64
GRANITE_HEADS, GRANITE_KV_HEADS, GRANITE_HEAD_DIM = 24, 8, 64
MOE_CLASSIC_DECODES = 3


def _gk2_counts(torch, gen, e, cap, kind, real=None):
    """Row counts (E,) int32 on the card: every expert 0, 1, C, random in
    [0, C], or the granite pattern (random on the first ``real`` experts,
    the padding experts empty)."""
    if kind == "zero":
        c = torch.zeros(e, dtype=torch.int32)
    elif kind == "one":
        c = torch.ones(e, dtype=torch.int32)
    elif kind == "full":
        c = torch.full((e,), cap, dtype=torch.int32)
    else:
        c = torch.randint(0, cap + 1, (e,), generator=gen).to(torch.int32)
        if kind == "padding":
            c[real:] = 0
    return c.cuda()


def _gk2_plain(torch, x, w, counts, rows_cap, spec, out_dtype, n_o,
               group=8):
    """The plain version on the card over the experts with live rows, a
    few at a time (its float64 product of a whole deepseek stack would
    take 30 GB); returns {expert: (rows, output rows)}."""
    from repro_torch.core.qscheme import int_bounds
    from repro_torch.kernels import ref
    lo, hi = int_bounds(spec.bits)
    live = [int(i) for i in torch.nonzero(torch.clamp(
        counts, max=rows_cap) > 0).flatten().tolist()]
    got = {}
    for i in range(0, len(live), group):
        sel = torch.tensor(live[i:i + group], device="cuda")
        o = ref.int8_matmul_grouped_ref(
            x.index_select(0, sel), w.index_select(0, sel),
            counts.index_select(0, sel), rows_cap=rows_cap,
            shift=spec.requant_shift, lo=lo, hi=hi, out_dtype=out_dtype,
            n_o=n_o)
        for j, e_ in enumerate(live[i:i + group]):
            r = min(int(counts[e_]), rows_cap)
            got[e_] = (r, o[j, :r])
    return got


def _gk2_held(torch, x, w, counts, rows_cap, spec_kw, out_name, what):
    """The kernel against its plain version on every live row, bit for
    bit; returns the largest difference (0)."""
    from repro_torch.core.integer_ops import LinearQuantSpec
    from repro_torch.kernels import ops
    spec = LinearQuantSpec(**spec_kw)
    out_float = getattr(torch, out_name) if out_name else None
    got = ops.int8_matmul_grouped(x, w, counts, spec, rows_cap=rows_cap,
                                  out_float=out_float)
    want = _gk2_plain(torch, x, w, counts, rows_cap, spec,
                      out_float or torch.int8,
                      spec.n_o if out_float else None)
    check(got.shape == (x.shape[0], x.shape[1], w.shape[2])
          and got.dtype == (out_float or torch.int8),
          f"{what}: output {got.dtype} {tuple(got.shape)}")
    diff = 0.0
    for e_, (r, o) in want.items():
        d = float((got[e_, :r].double() - o.double()).abs().max()) \
            if r else 0.0
        diff = max(diff, d)
    check(diff == 0, f"{what}: kernel != plain by {diff}")
    return diff


def _decode_counts(torch, gen, e_real, e_pad, tokens, top_k):
    """The counts a routed step gives: each of ``tokens`` tokens picks
    ``top_k`` distinct experts of ``e_real`` (random), the padding
    experts none."""
    pick = torch.rand((tokens, e_real), generator=gen).argsort(dim=1)
    c = torch.zeros(e_pad, dtype=torch.int64)
    c.index_add_(0, pick[:, :top_k].flatten(),
                 torch.ones(tokens * top_k, dtype=torch.int64))
    return c.to(torch.int32).cuda()


def _gk2_timed(torch, gen, label, e, k, n, e_real, tokens, top_k):
    """One path launch timed: the kernel (rows_cap = min(C, tokens)), the
    plain version over the live experts, ``torch._int_mm`` looped over
    the active experts (their C rows each; int32 result only), the bound
    (the active experts' int8 weight bytes, the live rows in and the bf16
    rows out)."""
    from repro_torch.core.integer_ops import LinearQuantSpec
    from repro_torch.kernels import ops
    cap = GK2_CAP
    rows_cap = min(cap, tokens)
    counts = _decode_counts(torch, gen, e_real, e, tokens, top_k)
    counts = torch.clamp(counts, max=rows_cap)
    copies = max(1, math.ceil(128e6 / (e * k * n)))       # beat the L2
    x = torch.randint(-128, 128, (e, cap, k), generator=None,
                      device="cuda", dtype=torch.int8)
    ws = [torch.randint(-128, 128, (e, k, n), device="cuda",
                        dtype=torch.int8) for _ in range(copies)]
    spec = LinearQuantSpec(n_x=4, n_w=8, n_b=8, n_o=4)
    err = _gk2_held(torch, x, ws[0], counts, rows_cap,
                    dict(n_x=4, n_w=8, n_b=8, n_o=4), "bfloat16",
                    f"grouped K2 {label} at {tokens} tokens")
    it = [0]

    def kernel():
        it[0] += 1
        ops.int8_matmul_grouped(x, ws[it[0] % copies], counts, spec,
                                rows_cap=rows_cap, out_float=torch.bfloat16)

    active = [int(i) for i in torch.nonzero(counts).flatten().tolist()]

    def library():
        it[0] += 1
        w = ws[it[0] % copies]
        for i in active:
            torch._int_mm(x[i], w[i])

    def plain():
        _gk2_plain(torch, x, ws[0], counts, rows_cap, spec, torch.bfloat16,
                   spec.n_o)

    ms = time_ms(torch, kernel, 20)
    lib_ms = time_ms(torch, library, 10)
    plain_ms = time_ms(torch, plain, 2, warmup=1)
    rows = int(counts.sum())
    n_bytes = len(active) * k * n + rows * k + 2 * rows * n
    b_ms, b_by = bound_ms(n_bytes, 2 * rows * k * n, "int8")
    rec = dict(shape=label, e=e, c=cap, k=k, n=n, tokens=tokens,
               rows_cap=rows_cap, active=len(active), rows=rows, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, max_abs_err=err)
    log(f"    grouped K2 {label} (E {e}, C {cap}, K {k}, N {n}), {tokens} "
        f"tokens top-{top_k}: {len(active)} active experts, {rows} rows, "
        f"rows_cap {rows_cap}, exact | kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, _int_mm x {len(active)} {lib_ms:.4f} ms, "
        f"bound {b_ms:.5f} ms ({b_by}, {n_bytes / 1e6:.1f} MB)")
    del x, ws
    torch.cuda.empty_cache()
    return rec


def _gk2_phase(torch, res):
    """(a) K2's grouped form against its plain version on the card, bit
    for bit: the path's (E, K, N) at C = 128 and four odd shapes, with
    every expert's count 0, 1, C, random, and (granite) random with the
    padding experts empty, through three epilogues, rows_cap C and 4;
    then timed at a decode step's counts (4 tokens) and the prefill's
    (128 tokens)."""
    gen = torch.Generator()
    gen.manual_seed(24)
    n_checks, err = 0, 0.0
    shapes = [(f"{lab}", e, GK2_CAP, k, n) for lab, e, k, n in GK2_SHAPES] \
        + [(f"odd {s}", *s) for s in GK2_ODD]
    for label, e, cap, k, n in shapes:
        x = torch.randint(-128, 128, (e, cap, k), device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (e, k, n), device="cuda",
                          dtype=torch.int8)
        kinds = ["zero", "one", "full", "random"] + \
            (["padding"] if e == 48 else [])
        for kind in kinds:
            counts = _gk2_counts(torch, gen, e, cap, kind, real=40)
            for rows_cap in sorted({cap, min(cap, 4)}):
                for name, spec_kw, out_name in GK2_SPECS:
                    if e == 256 and name != "bf16" and kind != "random":
                        continue        # the deepseek stack: fewer cases
                    err = max(err, _gk2_held(
                        torch, x, w, counts, rows_cap, spec_kw, out_name,
                        f"grouped K2 {label} counts {kind} rows_cap "
                        f"{rows_cap} {name}"))
                    n_checks += 1
        del x, w
        torch.cuda.empty_cache()
    log(f"[24a] grouped K2 bit-exact against its plain version in "
        f"{n_checks} cases (the path's shapes at C {GK2_CAP} and "
        f"{len(GK2_ODD)} odd shapes x counts 0 / 1 / C / random / padding "
        f"experts empty x rows_cap C and 4 x codes, bf16, fp32 with a "
        f"negative shift)")
    timed = []
    for tokens in (SERVE_BATCH, SERVE_BATCH * SERVE_PROMPT):
        for label, e, k, n in GK2_SHAPES:
            e_real = 40 if e == 48 else e
            timed.append(_gk2_timed(torch, gen, label, e, k, n, e_real,
                                    tokens, 8))
    res["k2_grouped"] = dict(checks=n_checks, max_abs_err=err, timed=timed)


def _attn_held(torch, tag, q, k, v, nkv, causal_prefill, pos=None):
    """One K5 (``pos`` None) or K6 launch against its plain version
    (atol = rtol = 2e-2), timed beside the plain version, SDPA on the
    (dequantized) K/V and the bound."""
    from repro_torch.kernels import ops, ref
    sdpa, sdpa_how = _sdpa(torch)
    b, sq, h, dk = q.shape
    kvh, dv = k.shape[2], v.shape[3]
    if pos is None:
        launch = lambda: ops.flash_attention(q, k, v, kv_frac_bits=nkv)
        want = ref.flash_attention_ref(q, k, v, kv_frac_bits=nkv)
        plain = lambda: ref.flash_attention_ref(q, k, v, kv_frac_bits=nkv)
        rows = sq
        kf = _deq(torch, k[:, :sq], nkv, q.dtype).contiguous()
        vf = _deq(torch, v[:, :sq], nkv, q.dtype).contiguous()
        lib = lambda: sdpa(q, kf, vf, True)
        n_ops = b * h * 2 * (dk + dv) * sum(i + 1 for i in range(sq))
    else:
        pos_t = _pos(torch, pos)
        launch = lambda: ops.flash_decode(q, k, v, pos=pos_t,
                                          kv_frac_bits=nkv)
        want = ref.flash_decode_ref(q, k, v, pos=pos, kv_frac_bits=nkv)
        plain = lambda: ref.flash_decode_ref(q, k, v, pos=pos_t,
                                             kv_frac_bits=nkv)
        rows = pos + 1
        kf = _deq(torch, k[:, :rows], nkv, q.dtype).contiguous()
        vf = _deq(torch, v[:, :rows], nkv, q.dtype).contiguous()
        lib = lambda: sdpa(q, kf, vf, False)
        n_ops = b * h * 2 * (dk + dv) * rows
    got = launch()
    torch.cuda.synchronize()
    err = _close(torch, got, want, 2e-2, tag)
    ms = time_ms(torch, launch, 50)
    plain_ms = time_ms(torch, plain, 3, warmup=1)
    try:
        lib_ms = time_ms(torch, lib, 50)
    except RuntimeError as e:        # no SDPA backend takes the shape
        log(f"    SDPA at {tag}: {e}")
        lib_ms = None
    n_bytes = (q.numel() + b * sq * h * dv) * q.element_size() \
        + b * rows * kvh * (dk + dv) * k.element_size()
    b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
    log(f"[24b] {tag} (B {b}, Sq {sq}, H {h}, KVH {kvh}, Dk {dk}, Dv {dv}, "
        f"{k.dtype} K/V): within atol=rtol=2e-2 (max |diff| {err:.2e}) | "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA ({sdpa_how}) "
        + (f"{lib_ms:.4f} ms" if lib_ms is not None else "n/a")
        + f", bound {b_ms:.5f} ms ({b_by})")
    return dict(name=tag, b=b, sq=sq, h=h, kvh=kvh, dk=dk, dv=dv, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err)


def _moe_attention_kernels(torch, res):
    """(b) K5 at MLA's expanded shape (the serve prompt at deepseek-v3's
    width: H = KVH 128, Dk 192, Dv 128, bf16 q and K/V, 32 rows) and at
    granite's (24 heads over 8 KV heads of 64, the prompt over the 48-row
    int8 cache), K6 at granite's decode (pos 47 of 48), each against its
    plain version."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    b, sq, skv = SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT + SERVE_GEN
    q = torch.randn((b, sq, MLA_HEADS, MLA_DK), generator=gen,
                    device="cuda").to(torch.bfloat16)
    k = torch.randn((b, sq, MLA_HEADS, MLA_DK), generator=gen,
                    device="cuda").to(torch.bfloat16)
    v = torch.randn((b, sq, MLA_HEADS, MLA_DV), generator=gen,
                    device="cuda").to(torch.bfloat16)
    res["k5_mla"] = _attn_held(torch, "K5 at MLA's expanded shape", q, k, v,
                               None, True)
    q, k, v, nkv = _dense_qkv(torch, gen, b, sq, skv, GRANITE_HEADS,
                              GRANITE_KV_HEADS, GRANITE_HEAD_DIM,
                              torch.bfloat16, torch.int8)
    res["k5_granite"] = _attn_held(torch, "K5 at granite's prefill", q, k,
                                   v, nkv, True)
    q, k, v, nkv = _dense_qkv(torch, gen, b, 1, skv, GRANITE_HEADS,
                              GRANITE_KV_HEADS, GRANITE_HEAD_DIM,
                              torch.bfloat16, torch.int8)
    res["k6_granite"] = _attn_held(torch, "K6 at granite's decode", q, k,
                                   v, nkv, False, pos=skv - 1)


class _MoESync(_ModuleSync):
    """``_ModuleSync`` that also holds each MoE layer (``mlp.moe``) on the
    card's input: the routing, the grouped expert products and the
    combine, compared with the card's output."""

    def on(self, device):
        inner = super().on(device)
        if not self.enabled:
            return inner
        from repro_torch.models import mlp as mlp_lib
        real = mlp_lib.moe

        def card(ctx, p, x, cfg, name="moe"):
            slot = [x.cpu(), None]
            self.card.append((slot[0], slot))
            y = real(ctx, p, x, cfg, name=name)
            slot[1] = [y.cpu()]
            return y

        def cpu(ctx, p, x, cfg, name="moe"):
            xc, slot = self.card.pop(0)
            check(isinstance(slot, list) and xc.shape == x.shape,
                  "moe: the CPU's call order differs from the card's")
            self.x_diff = max(self.x_diff, float((xc - x).abs().max()))
            y = real(ctx, p, xc, cfg, name=name)
            self.y_diff += self._n_diff(y, slot[1][0])
            self.moe_calls += 1
            return y

        @contextlib.contextmanager
        def patched():
            mlp_lib.moe = card if device == "cuda" else cpu
            try:
                with inner:
                    yield
            finally:
                mlp_lib.moe = real
        return patched()

    moe_calls = 0


def _moe_model(torch, res):
    """(c) granite-moe-3b at full width on 2 layers, fp32, ``prefill`` of
    the (4, 32) serve prompt and MOE_CLASSIC_DECODES ``decode_step``
    calls, kernels on the card against the plain path on the CPU (phase
    23a's loop): FP logits within atol = rtol = 2e-4 and greedy tokens
    identical; INT module by module (every qlinear and MoE layer on the
    card's input) identical; then deepseek-v3's MLA attention alone at
    full width (one layer, fp32), its expanded forward (K5) and its
    absorbed prefill and decode steps, FP within 1e-4 and INT module by
    module identical."""
    from repro_torch.configs import get_config
    from repro_torch.core.qmodel import (QuantContext, QuantMode,
                                         quantize_weight_tree)
    from repro_torch.kernels import ops
    from repro_torch.models import attention as att
    from repro_torch.models import model as M
    from repro_torch.models.common import Initializer, rope_tables
    cfg = dataclasses.replace(get_config("granite_moe_3b_a800m"),
                              n_layers=2, dtype="float32",
                              kv_cache_bits=8, attn_kernel="flash")
    p_gpu = M.init_params(cfg, 0, device="cuda")
    p_cpu = _tree_to(p_gpu, "cpu")
    tok0 = torch.from_numpy(_serve_tokens(cfg.vocab_size))
    name_fn = functools.partial(M.qlinear_weight, cfg=cfg)
    for mode in ("fp", "int"):
        ctx = QuantContext(mode=QuantMode(mode))
        pc, pg = p_cpu, p_gpu
        if ctx.mode is QuantMode.INT:
            pc = quantize_weight_tree(p_cpu, ctx, name_fn=name_fn)
            pg = quantize_weight_tree(p_gpu, ctx, name_fn=name_fn)
        sync = _MoESync(ctx.mode is QuantMode.INT)
        ops.reset_launch_counts()
        worst, same, caches = 0.0, True, {}
        tok = {"cuda": tok0.cuda(), "cpu": tok0}
        codes = [0, 0]
        for step in range(1 + MOE_CLASSIC_DECODES):
            logits = {}
            for dv, params in (("cuda", pg), ("cpu", pc)):
                with torch.no_grad(), sync.on(dv):
                    if step == 0:
                        lg, caches[dv] = M.prefill(
                            params, {"tokens": tok[dv]}, cfg, ctx,
                            max_seq=SERVE_PROMPT + SERVE_GEN)
                    else:
                        pos = SERVE_PROMPT + step - 1
                        lg, caches[dv] = M.decode_step(
                            params, tok[dv], caches[dv],
                            _pos(torch, pos) if dv == "cuda" else pos,
                            cfg, ctx)
                logits[dv] = lg.float().cpu()
            a, b = logits["cuda"], logits["cpu"]
            check(bool(torch.isfinite(a).all()) and a.shape == b.shape,
                  f"moe model {mode}: non-finite or misshapen logits")
            same &= torch.equal(a.argmax(-1), b.argmax(-1))
            worst = max(worst, float(((a - b).abs() / (1 + b.abs())).max()))
            for c_, g_ in zip(_tree_leaves(caches["cpu"]),
                              _tree_leaves(caches["cuda"])):
                d = (g_.cpu().int() - c_.int()).abs()
                codes[0] += int((d > 0).sum())
                codes[1] = max(codes[1], int(d.max()))
                c_.copy_(g_.cpu())
            nxt = a.argmax(-1).to(torch.int32)[:, None]
            tok = {"cuda": nxt.cuda(), "cpu": nxt}
        launches = dict(ops.LAUNCHES)
        want = _moe_serve_want(cfg, mode, True, gen=1 + MOE_CLASSIC_DECODES,
                               calibrated=False)
        tag = f"granite ({cfg.n_layers} layers) {mode}"
        log(f"[24c] {tag}, full width, fp32, int8 cache, prefill (4, "
            f"{SERVE_PROMPT}) + {MOE_CLASSIC_DECODES} decode steps, each "
            f"from the card's cache: greedy tokens "
            f"{'identical' if same else 'DIFFER'}; logits max |diff| / (1 "
            f"+ |logit|) {worst:.3e}; K/V codes differing {codes[0]} (max "
            f"step {codes[1]}); launches {launches}"
            + (f"; module by module ({sync.calls} qlinear, {sync.moe_calls} "
               f"MoE calls): largest input |diff| {sync.x_diff:.3e}, "
               f"outputs differing {sync.y_diff}" if sync.enabled else ""))
        check(same, f"moe model {tag}: greedy tokens differ")
        check(launches == want, f"moe model {tag}: launches {launches}, "
              f"want {want}")
        n_codes = sum(t.numel() for t in _tree_leaves(caches["cpu"]))
        check(codes[0] <= 1e-3 * n_codes and codes[1] <= 1,
              f"moe model {tag}: K/V codes differ in {codes[0]}")
        if mode == "int":
            check(sync.y_diff == 0 and worst == 0 and sync.moe_calls
                  == cfg.n_layers * (1 + MOE_CLASSIC_DECODES),
                  f"moe model {tag}: {sync.y_diff} module outputs and "
                  f"logits by up to {worst} differ on the same inputs")
        else:
            check(worst <= 2e-4, f"moe model {tag}: logits differ by "
                  f"{worst:.3e} (atol = rtol = 2e-4)")
        res["model"][tag] = dict(logits_max_rel=worst, launches=launches,
                                 kv_codes_differing=codes[0],
                                 module_input_diff=sync.x_diff)
        del caches, pc, pg
    del p_cpu, p_gpu
    gc.collect()
    torch.cuda.empty_cache()

    # deepseek-v3's MLA attention alone, full width, fp32
    mcfg = dataclasses.replace(get_config("deepseek_v3_671b"),
                               dtype="float32", attn_kernel="flash")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    pg = att.init_mla(Initializer(gen, torch.float32, torch.device("cuda")),
                      mcfg)
    pc = _tree_to(pg, "cpu")
    xg = torch.randn((SERVE_BATCH, SERVE_PROMPT, mcfg.d_model),
                     generator=gen, device="cuda")
    m = mcfg.mla
    s_max = SERVE_PROMPT + SERVE_GEN
    for mode in ("fp", "int"):
        ctx = QuantContext(mode=QuantMode(mode))
        sync = _ModuleSync(mode == "int")
        ops.reset_launch_counts()
        outs, worst = {}, 0.0
        cache = {}
        for step in range(2 + MOE_CLASSIC_DECODES):
            for dv, p in (("cuda", pg), ("cpu", pc)):
                x = xg.to(dv)
                if step >= 2:
                    x = x[:, step - 2:step - 1] * 0.5
                s = x.shape[1]
                pos = 0 if step < 2 else SERVE_PROMPT + step - 2
                positions = torch.arange(s, device=dv)[None] + pos
                rope = rope_tables(positions, m.qk_rope_head_dim,
                                   mcfg.rope_theta, torch.float32)
                if step == 1:
                    cache[dv] = att.MLACache(
                        torch.zeros((SERVE_BATCH, s_max, m.kv_lora_rank),
                                    device=dv),
                        torch.zeros((SERVE_BATCH, s_max, m.qk_rope_head_dim),
                                    device=dv))
                with torch.no_grad(), sync.on(dv):
                    y, _ = att.mla_attention(
                        ctx, p, x, mcfg, rope=rope,
                        cache=None if step == 0 else cache[dv],
                        cache_pos=(_pos(torch, pos) if dv == "cuda"
                                   else pos) if step else 0)
                outs[dv] = y.float().cpu()
            a, b = outs["cuda"], outs["cpu"]
            check(bool(torch.isfinite(a).all()), f"MLA {mode}: non-finite")
            worst = max(worst, float(((a - b).abs() / (1 + b.abs())).max()))
        launches = dict(ops.LAUNCHES)
        log(f"[24c] deepseek-v3 MLA alone, full width, fp32, {mode}: the "
            f"expanded forward of ({SERVE_BATCH}, {SERVE_PROMPT}) (K5 "
            f"{launches['flash_prefill']}), the absorbed prefill and "
            f"{MOE_CLASSIC_DECODES} decode steps: max |diff| / (1 + |y|) "
            f"{worst:.3e}"
            + (f"; module by module ({sync.calls} calls): largest input "
               f"|diff| {sync.x_diff:.3e}, outputs differing {sync.y_diff}"
               if sync.enabled else ""))
        check(launches["flash_prefill"] == 1, f"MLA {mode}: K5 launched "
              f"{launches['flash_prefill']} times, want 1")
        if mode == "int":
            check(sync.y_diff == 0, f"MLA int: {sync.y_diff} module outputs "
                  f"differ on the same inputs")
        else:
            check(worst <= 1e-4, f"MLA fp: outputs differ by {worst:.3e}")
        res["model"][f"deepseek MLA {mode}"] = dict(max_rel=worst,
                                                    launches=launches)
    del pg, pc, cache
    gc.collect()
    torch.cuda.empty_cache()


def _moe_forward_launches(cfg, mode, kv_int8):
    """(K2, K3, grouped K2) launches of one classic forward (a prefill or a
    decode step) of a MoE model.  INT: K3 once a module input -- GQA's q /
    k / v together and o, MLA's wq_a, wq_b, wkv_a and wo (the absorbed path
    has no wkv_b call), a dense MLP's w1 / w3 together and w2, the experts'
    token rows (w1 / w3) and their hidden buffer (w2), a shared expert's
    two, the head's input and a tied head's weight -- and once a GQA layer
    for its int8 K/V write (in FP too); K2 once a projection; the grouped
    K2 three times a MoE layer."""
    nd = cfg.moe.n_dense_layers
    nm = cfg.n_layers - nd
    mla = cfg.mla is not None
    kv = 0 if mla or not kv_int8 else cfg.n_layers
    if mode != "int":
        return 0, kv, 0
    shared_k3, shared_k2 = (2, 3) if cfg.moe.n_shared else (0, 0)
    k3 = (cfg.n_layers * (4 if mla else 2) + 2 * nd + nm * (2 + shared_k3)
          + 1 + int(cfg.tie_embeddings) + kv)
    k2 = 4 * cfg.n_layers + 3 * nd + nm * shared_k2 + 1
    return k2, k3, 3 * nm


def _moe_serve_want(cfg, mode, kv_int8, gen=SERVE_GEN, calibrated=True):
    """Launches of one classic ``serve`` call of a MoE model: ``gen``
    forwards at ``_moe_forward_launches``; K5 once a GQA layer in the
    prefill and K6 once a GQA layer a decode step (MLA's prefill and
    decode are absorbed: no K5, no K6); INT's calibration forward (FP mode,
    no cache) adds K5 once a layer, GQA or MLA's expanded form."""
    k2, k3, grouped = _moe_forward_launches(cfg, mode, kv_int8)
    gqa = 0 if cfg.mla is not None else cfg.n_layers
    cal = int(mode == "int" and calibrated)
    return {"int8_matmul": k2 * gen, "int8_matmul_grouped": grouped * gen,
            "ragged_attention": 0, "paged_attention": 0,
            "flash_prefill": gqa + cal * cfg.n_layers,
            "flash_decode": gqa * (gen - 1), "quantize": k3 * gen,
            "residual_requant": 0, "int_conv": 0}


def _moe_serve(torch, res, arch, cfg_overrides):
    """(d) classic ``serve`` at full width, bf16, flash attention: INT
    (calibrated) and FP, graphs and eager in turns (graphs, eager, graphs,
    eager): tokens identical, launches by ``_moe_serve_want``, the step
    graphs' counts; calibration, prefill, decode ms/token and peak memory
    of each run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config(arch), **cfg_overrides)
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tree_leaves(params))
    log(f"[24d] {arch} ({cfg.n_layers} layers): {n_params / 1e9:.3f} B "
        f"parameters, bf16, made in {time.perf_counter() - t0:.1f} s")
    kv_int8 = cfg.kv_cache_bits == 8
    for mode in ("int", "fp"):
        want = _moe_serve_want(cfg, mode, kv_int8)
        runs = []
        for rep, graphs in enumerate((True, False, True, False)):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            o = serve(arch, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                      gen=SERVE_GEN, mode=mode, calibrate=True, smoke=False,
                      params=params, attn_kernel="flash",
                      cfg_overrides=cfg_overrides, graphs=graphs,
                      device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2**30
            toks, g = o["tokens"], o["graphs"]
            tag = "graphs" if graphs else "eager"
            log(f"[24d] serve {arch} {mode} run {rep} ({tag}): calibration "
                f"{o['calibrate_s']:.3f} s, prefill {o['prefill_s']:.4f} s, "
                f"decode {1e3 * o['decode_s_per_tok']:.3f} ms/token ("
                + ("replays; first call + capture "
                   if graphs else "every step eager; first step ")
                + f"{1e3 * o['compile_decode_s']:.2f} ms), first calls "
                f"{g['first_calls']} captures {g['captures']} replays "
                f"{g['replays']}, launches K2 {launches['int8_matmul']} "
                f"grouped K2 {launches['int8_matmul_grouped']} K3 "
                f"{launches['quantize']} K5 {launches['flash_prefill']} K6 "
                f"{launches['flash_decode']}, peak {peak:.2f} GiB, "
                f"{wall:.1f} s")
            # the head covers the padded vocabulary (its padding ids are
            # dead classes of random weight, as in the reference)
            check(toks.shape == (SERVE_BATCH, SERVE_GEN)
                  and int(toks.min()) >= 0
                  and int(toks.max()) < cfg.vocab_padded,
                  f"serve {arch} {mode}: tokens {toks}")
            check(launches == want, f"serve {arch} {mode} {tag}: launches "
                  f"{launches}, want {want}")
            check(g == dict(enabled=graphs, first_calls=int(graphs),
                            captures=int(graphs),
                            replays=SERVE_GEN - 2 if graphs else 0),
                  f"serve {arch} {mode} {tag}: step graphs {g}")
            runs.append(dict(graphs=graphs, tokens=toks, launches=launches,
                             calibrate_s=o["calibrate_s"],
                             prefill_s=o["prefill_s"],
                             decode_s_per_tok=o["decode_s_per_tok"],
                             first_decode_s=o["compile_decode_s"],
                             peak_gib=peak, wall_s=wall))
            del o
        check(all((r["tokens"] == runs[0]["tokens"]).all() for r in runs),
              f"serve {arch} {mode}: graphs and eager runs, or repeats, "
              f"gave other tokens")
        log(f"[24d] serve {arch} {mode}: graphs and eager runs "
            f"token-identical, decode "
            f"{[round(1e3 * r['decode_s_per_tok'], 3) for r in runs]} "
            f"ms/token (graphs, eager, graphs, eager)")
        res["serve"][f"{arch} {mode}"] = [
            {k: v for k, v in r.items() if k != "tokens"} for r in runs]
        res["serve"][f"{arch} {mode}"][0]["n_params"] = n_params
    del params
    gc.collect()
    torch.cuda.empty_cache()


def phase_moe(torch, out):
    """Phase 24: the MoE family with MLA -- (a) K2's grouped form, (b) K5
    and K6 at the family's shapes, (c) the 2-layer granite model and
    deepseek-v3's MLA card against CPU, (d) classic ``serve`` of
    granite-moe-3b at full depth and deepseek-v3 on 4 layers."""
    t0 = time.perf_counter()
    res = {"model": {}, "serve": {}, "part_s": {}}
    for part, run in (
            ("a", lambda: _gk2_phase(torch, res)),
            ("b", lambda: _moe_attention_kernels(torch, res)),
            ("c", lambda: _moe_model(torch, res)),
            ("d granite", lambda: _moe_serve(
                torch, res, "granite_moe_3b_a800m", {"kv_cache_bits": 8})),
            ("d deepseek", lambda: _moe_serve(
                torch, res, "deepseek_v3_671b", {"n_layers": 4}))):
        t1 = time.perf_counter()
        run()
        res["part_s"][part] = time.perf_counter() - t1
    res["seconds"] = time.perf_counter() - t0
    log(f"[24] moe phase {res['seconds']:.1f} s (parts "
        f"{ {k: round(v, 1) for k, v in res['part_s'].items()} })")
    out["moe"] = res
    return res


# ---------------------------------------------------------------------------
# phase 25: the audio family (whisper-large-v3) and K5's non-causal form
# ---------------------------------------------------------------------------

# whisper-large-v3's attention: 20 heads over 20 KV heads of 64, the
# encoder over 1500 frames
WHISPER_HEADS, WHISPER_DIM, WHISPER_FRAMES = 20, 64, 1500
# K5's non-causal odd shapes (B, Sq, Skv, H, KVH, D): one query over one
# row, one query over a tail of 100, more queries than rows, Sq and Skv off
# the tiles with GQA and D 80, Skv one past two tiles
K5_NC_ODD = ((1, 1, 1, 2, 2, 64), (2, 1, 100, 4, 2, 64),
             (2, 70, 1, 4, 4, 64), (2, 33, 131, 8, 2, 80),
             (1, 129, 257, 20, 20, 64))
K5_NC_DTYPES = (("bf16 q, int8 K/V", "bfloat16", "int8", 2e-2),
                ("bf16 q, bf16 K/V", "bfloat16", "bfloat16", 2e-2),
                ("fp32 q, int8 K/V", "float32", "int8", 1e-4),
                ("fp32 q, fp32 K/V", "float32", "float32", 1e-4))
# K2 with a bias at whisper's prefill shapes, M = 4 x 1500 frames: the
# projections, w1 and w2 (and a decode step's cross K / V)
WHISPER_K2 = ((6000, 1280, 1280), (6000, 1280, 5120), (6000, 5120, 1280))
WHISPER_DECODES = 3


def _nc_held(torch, q, k, v, nkv, tol, what):
    """K5's non-causal form against its plain version: atol = rtol = tol,
    or, over 1024 kv rows and more, ``tol`` of each row's largest |value|
    (a row averages that many V rows), a repeated kv tile caught."""
    from repro_torch.kernels import ops, ref
    got = ops.flash_attention(q, k, v, kv_frac_bits=nkv, causal=False)
    want = ref.flash_attention_ref(q, k, v, kv_frac_bits=nkv, causal=False)
    torch.cuda.synchronize()
    if k.shape[1] < 1024:
        return _close(torch, got, want, tol, what)
    err = _close_rows(torch, got, want, tol, what)
    check(_tile_fault_caught(torch, ref.flash_attention_ref, q, k, v, want,
                             tol, 1, kv_frac_bits=nkv, causal=False),
          f"{what}: the row tolerance passes a repeated kv tile")
    return err


def _w_attn_timed(torch, tag, q, k, v, nkv, pos=None):
    """One non-causal K5 launch (``pos`` None) or K6 launch at ``pos``,
    held against its plain version row by row (each output averages up to
    1500 V rows), timed beside it, non-causal SDPA over the same K/V and
    the bound: every query reads every kv row (K6: rows <= pos)."""
    from repro_torch.kernels import ops, ref
    sdpa, sdpa_how = _sdpa(torch)
    b, sq, h, dk = q.shape
    kvh, dv = k.shape[2], v.shape[3]
    if pos is None:
        launch = lambda: ops.flash_attention(q, k, v, kv_frac_bits=nkv,
                                             causal=False)
        plain = lambda: ref.flash_attention_ref(q, k, v, kv_frac_bits=nkv,
                                                causal=False)
        rows = k.shape[1]
    else:
        pos_t = _pos(torch, pos)
        launch = lambda: ops.flash_decode(q, k, v, pos=pos_t,
                                          kv_frac_bits=nkv)
        plain = lambda: ref.flash_decode_ref(q, k, v, pos=pos_t,
                                             kv_frac_bits=nkv)
        rows = pos + 1
    kf = _deq(torch, k[:, :rows], nkv, q.dtype).contiguous()
    vf = _deq(torch, v[:, :rows], nkv, q.dtype).contiguous()
    lib = sdpa(q, kf, vf, False).transpose(1, 2)
    want = plain()
    check(torch.allclose(lib.float(), want.float(), atol=5e-2, rtol=5e-2),
          f"{tag}: SDPA disagrees with the plain version")
    got = launch()
    torch.cuda.synchronize()
    err = _close_rows(torch, got, want, LONG_ROW_TOL, tag)
    ms = time_ms(torch, launch, 20)
    plain_ms = time_ms(torch, plain, 3, warmup=1)
    lib_ms = time_ms(torch, lambda: sdpa(q, kf, vf, False), 20)
    n_ops = b * h * 2 * (dk + dv) * sq * rows
    n_bytes = (q.numel() + b * sq * h * dv) * q.element_size() \
        + b * rows * kvh * (dk + dv) * k.element_size()
    b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
    log(f"[25a] {tag} (B {b}, Sq {sq}, Skv {k.shape[1]}"
        + (f", pos {pos}" if pos is not None else "")
        + f", H {h}, KVH {kvh}, D {dk}, {q.dtype} q, {k.dtype} K/V): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA ({sdpa_how}, "
        f"non-causal) {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
        f"{n_ops / 1e9:.2f} GFLOP, {n_bytes / 1e6:.1f} MB); within "
        f"{LONG_ROW_TOL} of each row's largest |value| (max |diff| "
        f"{err:.2e})")
    return dict(name=tag, b=b, sq=sq, skv=k.shape[1], h=h, kvh=kvh, d=dk,
                pos=pos, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err, ops=n_ops,
                bytes=n_bytes)


def _whisper_k2(torch, gen, res):
    """K2 with a bias at whisper's prefill shapes, bit for bit against its
    plain version: the codes epilogue with the bias shifted left and right
    and the float (bf16) epilogue the path launches; the path's form timed
    beside the plain version, ``torch._int_mm`` and the bound."""
    from repro_torch.core.integer_ops import LinearQuantSpec
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.int8_matmul import plan_int8_matmul
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    specs = (("bias<<", dict(n_x=4, n_w=8, n_b=7, n_o=4), None),
             ("bias>>", dict(n_x=2, n_w=3, n_b=9, n_o=4), None),
             ("bias, bf16 out", dict(n_x=4, n_w=8, n_b=9, n_o=5),
              torch.bfloat16))
    timed, n = [], 0
    for m, k, nn in WHISPER_K2:
        x, (w,) = _k2_operands(torch, gen, m, k, nn)
        b = torch.randint(-128, 128, (nn,), generator=gen, device="cuda",
                          dtype=torch.int8)
        for name, spec_kw, out_float in specs:
            spec = LinearQuantSpec(**spec_kw)
            got = ops.int8_matmul(x, w, b, spec, out_float=out_float)
            want = ref.int8_matmul_ref(
                x, w, b, shift=spec.requant_shift,
                bias_shift=spec.bias_shift,
                out_dtype=out_float or torch.int8, n_o=spec.n_o)
            torch.cuda.synchronize()
            check(got.dtype == want.dtype and torch.equal(got, want),
                  f"K2 {name} at {m}x{k}->{nn}: kernel != plain")
            n += 1
        spec = LinearQuantSpec(**specs[-1][1])
        ms = time_ms(torch, lambda: ops.int8_matmul(
            x, w, b, spec, out_float=torch.bfloat16), 20)
        plain_ms = time_ms(torch, lambda: ref.int8_matmul_ref(
            x, w, b, shift=spec.requant_shift, bias_shift=spec.bias_shift,
            out_dtype=torch.bfloat16, n_o=spec.n_o), 3, warmup=1)
        lib_ms = time_ms(torch, lambda: torch._int_mm(x, w), 20)
        n_bytes = m * k + k * nn + nn + 2 * m * nn
        b_ms, b_by = bound_ms(n_bytes, 2 * m * k * nn, "int8")
        timed.append(dict(shape=f"{m}x{k}->{nn}", ms=ms, plain_ms=plain_ms,
                          library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                          plan=_plan_str(plan_int8_matmul(m, k, nn, sms))))
        log(f"[25a] K2 with a bias {m}x{k}->{nn} ({timed[-1]['plan']}): "
            f"bit-exact (codes, bias << and >>; bf16 epilogue) | kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch._int_mm (int32 "
            f"out, no bias) {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        del x, w
    res["k2_bias"] = dict(checks=n, timed=timed)


def _whisper_kernels(torch, res):
    """(a) K5's non-causal form against its plain version at whisper's
    encoder shape (B 4, 1500 over 1500, H = KVH 20, D 64) and the cross
    prefill's (B 4, 32 over 1500), and at the odd shapes, each over fp32
    and bf16 q and int8 and float K/V; the encoder and cross shapes timed
    (bf16, the path's types).  K6 at the cross decode's shape (one query
    over all 1500 memory rows: pos 1499).  K2 with a bias at whisper's
    shapes."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)
    h, d = WHISPER_HEADS, WHISPER_DIM
    shapes = [("encoder", (4, WHISPER_FRAMES, WHISPER_FRAMES, h, h, d)),
              ("cross prefill", (4, SERVE_PROMPT, WHISPER_FRAMES, h, h, d))] \
        + [(f"odd {s}", s) for s in K5_NC_ODD]
    n, err = 0, 0.0
    for label, (b, sq, skv, hh, kvh, dd) in shapes:
        for dname, q_dt, kv_dt, tol in K5_NC_DTYPES:
            q, k, v, nkv = _dense_qkv(torch, gen, b, sq, skv, hh, kvh, dd,
                                      getattr(torch, q_dt),
                                      getattr(torch, kv_dt))
            e = _nc_held(torch, q, k, v, nkv, tol,
                         f"non-causal K5 {label} {dname}")
            if q_dt == "bfloat16":
                err = max(err, e)
            n += 1
        del q, k, v
    log(f"[25a] non-causal K5 against its plain version in {n} cases "
        f"(encoder and cross-prefill shapes and {len(K5_NC_ODD)} odd ones x "
        f"fp32 / bf16 q x int8 / float K/V; fp32 q within 1e-4, bf16 within "
        f"2e-2, over 1024+ rows 2e-2 of each row's largest |value|): bf16 "
        f"max |diff| {err:.2e}")
    res["k5_nc_checks"], res["k5_nc_max_abs_err"] = n, err
    bf = torch.bfloat16
    q, k, v, _ = _dense_qkv(torch, gen, 4, WHISPER_FRAMES, WHISPER_FRAMES,
                            h, h, d, bf, bf)
    res["k5_encoder"] = _w_attn_timed(torch, "non-causal K5, encoder", q, k,
                                      v, None)
    res["k5_cross"] = _w_attn_timed(torch, "non-causal K5, cross prefill",
                                    q[:, :SERVE_PROMPT].contiguous(), k, v,
                                    None)
    res["k6_cross"] = _w_attn_timed(torch, "K6, cross decode",
                                    q[:, :1].contiguous(), k, v, None,
                                    pos=WHISPER_FRAMES - 1)
    # K6 at the memory's last row is the non-causal function
    got = ops.flash_decode(q[:, :1].contiguous(), k, v,
                           pos=_pos(torch, WHISPER_FRAMES - 1))
    want = ref.flash_attention_ref(q[:, :1], k, v, causal=False)
    torch.cuda.synchronize()
    res["k6_cross"]["vs_noncausal_k5_plain"] = _close_rows(
        torch, got, want, LONG_ROW_TOL,
        "K6 at pos S_enc - 1 vs non-causal plain K5")
    del q, k, v
    _whisper_k2(torch, gen, res)


def _whisper_launches(cfg, mode, gen, calibrated=True):
    """Launches of one classic ``serve`` call (a prefill and ``gen - 1``
    decode steps; ``gen`` 1: a prefill alone) of whisper.  A decoder layer
    launches K5 twice in a prefill (causal self-attention, non-causal
    cross-attention) and K6 twice a decode step (self over the cache,
    cross at the memory's last row); an encoder layer K5 once (non-causal).
    INT: K2 once a projection (an encoder layer 6, a decoder layer 10: q,
    k, v and o of both attentions, w1, w2; the head 1); K3 once a module
    input (the q / k / v input once, the cross K / V's memory once, each
    other projection once) and once a bias (q, k and v of each attention),
    an encoder layer 7, a decoder layer 13, the head 1; and once a decoder
    layer for an int8 K/V write.  INT's calibration forward (FP, no cache)
    adds the prefill's K5 launches.  Returns (LAUNCHES, non-causal K5)."""
    n_enc, n_dec = cfg.encdec.n_encoder_layers, cfg.n_layers
    kv = n_dec if cfg.kv_cache_bits == 8 else 0
    k2 = k3 = (0, 0)
    if mode == "int":
        k2, k3 = (6 * n_enc, 10 * n_dec + 1), (7 * n_enc, 13 * n_dec + 1)
    cal = int(mode == "int" and calibrated)
    want = {"int8_matmul": k2[0] + k2[1] * gen, "int8_matmul_grouped": 0,
            "ragged_attention": 0, "paged_attention": 0,
            "flash_prefill": (1 + cal) * (n_enc + 2 * n_dec),
            "flash_decode": 2 * n_dec * (gen - 1),
            "quantize": k3[0] + (k3[1] + kv) * gen if mode == "int"
            else kv * gen,
            "residual_requant": 0, "int_conv": 0}
    return want, (1 + cal) * (n_enc + n_dec)


def _whisper_model(torch, res):
    """(b) whisper at full width on 2 encoder and 2 decoder layers (1500
    frames), fp32, batch 2, the attention biases drawn from a seed:
    ``prefill`` of the prompt's first 2 rows and WHISPER_DECODES
    ``decode_step`` calls, kernels on the card against the plain path on
    the CPU (phase 24c's loop, each step from the card's cache): FP logits
    within atol = rtol = 2e-4 and greedy tokens identical; INT module by
    module (every qlinear on the card's input) identical, logits too;
    launches as ``_whisper_launches`` says."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import EncDecConfig
    from repro_torch.core.qmodel import (QuantContext, QuantMode,
                                         quantize_weight_tree)
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    cfg = dataclasses.replace(
        get_config("whisper_large_v3"), n_layers=2, dtype="float32",
        attn_kernel="flash",
        encdec=EncDecConfig(n_encoder_layers=2, encoder_seq=WHISPER_FRAMES))
    p_gpu = M.init_params(cfg, 0, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(28)
    for blk in p_gpu["enc_blocks"] + p_gpu["blocks"]:
        for part in ("attn", "cross"):
            for name in ("bq", "bk", "bv"):
                if part in blk:
                    blk[part][name].copy_(0.1 * torch.randn(
                        blk[part][name].shape, generator=gen, device="cuda"))
    p_cpu = _tree_to(p_gpu, "cpu")
    b = 2
    tok0 = torch.from_numpy(_serve_tokens(cfg.vocab_size)[:b])
    feats = torch.randn((b, WHISPER_FRAMES, cfg.d_model), generator=gen,
                        device="cuda")
    name_fn = functools.partial(M.qlinear_weight, cfg=cfg)
    for mode in ("fp", "int"):
        ctx = QuantContext(mode=QuantMode(mode))
        pc, pg = p_cpu, p_gpu
        if ctx.mode is QuantMode.INT:
            pc = quantize_weight_tree(p_cpu, ctx, name_fn=name_fn)
            pg = quantize_weight_tree(p_gpu, ctx, name_fn=name_fn)
        sync = _ModuleSync(ctx.mode is QuantMode.INT)
        ops.reset_launch_counts()
        worst, same, caches, cache_diff = 0.0, True, {}, 0.0
        tok = {"cuda": tok0.cuda(), "cpu": tok0}
        for step in range(1 + WHISPER_DECODES):
            logits = {}
            for dv, params in (("cuda", pg), ("cpu", pc)):
                with torch.no_grad(), sync.on(dv):
                    if step == 0:
                        lg, caches[dv] = M.prefill(
                            params, {"tokens": tok[dv],
                                     "encoder_features": feats.to(dv)},
                            cfg, ctx, max_seq=SERVE_PROMPT + SERVE_GEN)
                    else:
                        pos = SERVE_PROMPT + step - 1
                        lg, caches[dv] = M.decode_step(
                            params, tok[dv], caches[dv],
                            _pos(torch, pos) if dv == "cuda" else pos,
                            cfg, ctx)
                logits[dv] = lg.float().cpu()
            a, bb = logits["cuda"], logits["cpu"]
            check(bool(torch.isfinite(a).all()) and a.shape == bb.shape,
                  f"whisper model {mode}: non-finite or misshapen logits")
            same &= torch.equal(a.argmax(-1), bb.argmax(-1))
            worst = max(worst, float(((a - bb).abs() / (1 + bb.abs())).max()))
            for c_, g_ in zip(_tree_leaves(caches["cpu"]),
                              _tree_leaves(caches["cuda"])):
                g_ = g_.cpu()
                cache_diff = max(cache_diff, float(
                    ((g_ - c_).abs() / (1 + c_.abs())).max()))
                c_.copy_(g_)
            nxt = a.argmax(-1).to(torch.int32)[:, None]
            tok = {"cuda": nxt.cuda(), "cpu": nxt}
        launches = dict(ops.LAUNCHES)
        want, _ = _whisper_launches(cfg, mode, 1 + WHISPER_DECODES,
                                    calibrated=False)
        tag = f"whisper (2 + 2 layers) {mode}"
        log(f"[25b] {tag}, full width, fp32, batch {b}, prefill of "
            f"{SERVE_PROMPT} tokens over {WHISPER_FRAMES} frames + "
            f"{WHISPER_DECODES} decode steps, each from the card's cache: "
            f"greedy tokens {'identical' if same else 'DIFFER'}; logits max "
            f"|diff| / (1 + |logit|) {worst:.3e}; cache (K/V, memory) max "
            f"|diff| / (1 + |x|) {cache_diff:.3e}; launches {launches}"
            + (f"; module by module ({sync.calls} qlinear calls): largest "
               f"input |diff| {sync.x_diff:.3e}, outputs differing "
               f"{sync.y_diff}" if sync.enabled else ""))
        check(same, f"{tag}: greedy tokens differ")
        check(launches == want, f"{tag}: launches {launches}, want {want}")
        check(cache_diff <= 1e-3, f"{tag}: caches differ by {cache_diff}")
        if mode == "int":
            check(sync.y_diff == 0 and worst == 0,
                  f"{tag}: {sync.y_diff} module outputs and logits by up to "
                  f"{worst} differ on the same inputs")
        else:
            check(worst <= 2e-4, f"{tag}: logits differ by {worst:.3e} "
                  f"(atol = rtol = 2e-4)")
        res["model"][tag] = dict(logits_max_rel=worst, launches=launches,
                                 cache_max_rel=cache_diff,
                                 module_input_diff=sync.x_diff)
        del caches, pc, pg
    del p_cpu, p_gpu
    gc.collect()
    torch.cuda.empty_cache()


def _whisper_serve(torch, res):
    """(c) classic ``serve`` of whisper-large-v3 at full width and depth
    (32 + 32 layers, 1500 frames), bf16, flash attention: INT (calibrated)
    and FP, graphs and eager in turns (graphs, eager, graphs, eager):
    tokens identical, launches by ``_whisper_launches`` (K6 64 a decode
    step; INT K2 321 a decode step; K5 96 a prefill, 64 of them
    non-causal), the step graphs' counts; calibration, prefill, decode
    ms/token and peak memory of each run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    arch = "whisper_large_v3"
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tree_leaves(params))
    n_enc = sum(t.numel() for t in _tree_leaves(params["enc_blocks"]))
    n_dec = sum(t.numel() for t in _tree_leaves(params["blocks"]))
    log(f"[25c] {arch} ({cfg.encdec.n_encoder_layers} encoder + "
        f"{cfg.n_layers} decoder layers): {n_params / 1e9:.3f} B parameters "
        f"({n_enc / 1e6:.1f} M encoder, {n_dec / 1e6:.1f} M decoder), bf16, "
        f"made in {time.perf_counter() - t0:.1f} s")
    for mode in ("int", "fp"):
        want, want_nc = _whisper_launches(cfg, mode, SERVE_GEN)
        runs = []
        for rep, graphs in enumerate((True, False, True, False)):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            o = serve(arch, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                      gen=SERVE_GEN, mode=mode, calibrate=True, smoke=False,
                      params=params, attn_kernel="flash", graphs=graphs,
                      device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            nc = ops.FORM_LAUNCHES["flash_prefill_noncausal"]
            peak = torch.cuda.max_memory_allocated() / 2**30
            toks, g = o["tokens"], o["graphs"]
            tag = "graphs" if graphs else "eager"
            log(f"[25c] serve {arch} {mode} run {rep} ({tag}): calibration "
                f"{o['calibrate_s']:.3f} s, prefill {o['prefill_s']:.4f} s, "
                f"decode {1e3 * o['decode_s_per_tok']:.3f} ms/token ("
                + ("replays; first call + capture "
                   if graphs else "every step eager; first step ")
                + f"{1e3 * o['compile_decode_s']:.2f} ms), first calls "
                f"{g['first_calls']} captures {g['captures']} replays "
                f"{g['replays']}, launches K2 {launches['int8_matmul']} K3 "
                f"{launches['quantize']} K5 {launches['flash_prefill']} "
                f"({nc} non-causal) K6 {launches['flash_decode']}, peak "
                f"{peak:.2f} GiB, {wall:.1f} s")
            check(toks.shape == (SERVE_BATCH, SERVE_GEN)
                  and int(toks.min()) >= 0
                  and int(toks.max()) < cfg.vocab_padded,
                  f"serve {arch} {mode}: tokens {toks}")
            check(launches == want and nc == want_nc,
                  f"serve {arch} {mode} {tag}: launches {launches} ({nc} "
                  f"non-causal K5), want {want} ({want_nc})")
            check(g == dict(enabled=graphs, first_calls=int(graphs),
                            captures=int(graphs),
                            replays=SERVE_GEN - 2 if graphs else 0),
                  f"serve {arch} {mode} {tag}: step graphs {g}")
            runs.append(dict(graphs=graphs, tokens=toks, launches=launches,
                             noncausal_k5=nc, calibrate_s=o["calibrate_s"],
                             prefill_s=o["prefill_s"],
                             decode_s_per_tok=o["decode_s_per_tok"],
                             first_decode_s=o["compile_decode_s"],
                             peak_gib=peak, wall_s=wall))
            del o
        check(all((r["tokens"] == runs[0]["tokens"]).all() for r in runs),
              f"serve {arch} {mode}: graphs and eager runs, or repeats, "
              f"gave other tokens")
        log(f"[25c] serve {arch} {mode}: graphs and eager runs "
            f"token-identical, decode "
            f"{[round(1e3 * r['decode_s_per_tok'], 3) for r in runs]} "
            f"ms/token (graphs, eager, graphs, eager)")
        res["serve"][f"{arch} {mode}"] = [
            {k: v for k, v in r.items() if k != "tokens"} for r in runs]
        res["serve"][f"{arch} {mode}"][0].update(
            n_params=n_params, n_encoder=n_enc, n_decoder=n_dec)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def phase_whisper(torch, out):
    """Phase 25: the audio family -- (a) K5's non-causal form, K6 at the
    cross decode and K2 with a bias at whisper's shapes, (b) the 2 + 2
    layer model card against CPU, (c) classic ``serve`` of
    whisper-large-v3 at full width and depth."""
    t0 = time.perf_counter()
    res = {"model": {}, "serve": {}, "part_s": {}}
    for part, run in (("a", lambda: _whisper_kernels(torch, res)),
                      ("b", lambda: _whisper_model(torch, res)),
                      ("c", lambda: _whisper_serve(torch, res))):
        t1 = time.perf_counter()
        run()
        res["part_s"][part] = time.perf_counter() - t1
    res["seconds"] = time.perf_counter() - t0
    log(f"[25] whisper phase {res['seconds']:.1f} s (parts "
        f"{ {k: round(v, 1) for k, v in res['part_s'].items()} })")
    out["whisper"] = res
    return res


# ---------------------------------------------------------------------------
# phase 26: training
# ---------------------------------------------------------------------------

# K5 under autograd: (name, B, Sq, Skv, H, KVH, D, dtype, causal, forward
# tolerance).  The forward is the kernel's, held as phase 6 holds it
# (atol = rtol = tol; the long case row by row); the backward is the plain
# version's autograd recomputed on the same inputs, so dq / dk / dv are
# held within TRAIN_GRAD_TOL of each gradient's largest |value| (the same
# arithmetic: only a reduction's order may differ)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 128, 8
TRAIN_K5_CASES = (
    ("train shape", TRAIN_B, TRAIN_S, TRAIN_S, 32, 8, 64, "bfloat16", True,
     2e-2),
    ("fp32", 2, 128, 128, 8, 2, 64, "float32", True, 1e-4),
    ("non-causal, Sq != Skv", 2, 100, 160, 8, 4, 64, "bfloat16", False,
     2e-2),
    ("long", 1, 4096, 4096, K1_HEADS, K1_KV_HEADS, K1_DIM, "bfloat16", True,
     LONG_ROW_TOL))
TRAIN_GRAD_TOL = 1e-5
# phase 26b: card against CPU, fp32.  The loss and grad_norm within
# TRAIN_LOSS_RTOL relative, the moments within TRAIN_MOMENT_TOL of each
# leaf's largest |value| (fp32 sums in other orders); the params after a
# step at rate lr within 2 lr (+ 1e-6): Adam's update is about
# sign(g) for the first steps, and a gradient element near 0 may take
# either sign on the two devices, moving its parameter by at most 2 lr
TRAIN_LOSS_RTOL, TRAIN_MOMENT_TOL = 1e-5, 1e-4
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 4, 64


def _rel_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def _k5_autograd_case(torch, gen, case):
    """One case of 26a: the kernel's output and the recompute's gradients
    against the plain version's forward and autograd."""
    from repro_torch.kernels import ops, ref
    name, b, sq, skv, h, kvh, d, dt, causal, tol = case
    q_dt = getattr(torch, dt)
    q, k, v, _ = _dense_qkv(torch, gen, b, sq, skv, h, kvh, d, q_dt, q_dt)
    g = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(q_dt)
    got_in = [t.clone().requires_grad_() for t in (q, k, v)]
    want_in = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*got_in, causal=causal)
    got = torch.autograd.grad(out, got_in, g)
    want_out = ref.flash_attention_ref(*want_in, causal=causal)
    want = torch.autograd.grad(want_out, want_in, g)
    torch.cuda.synchronize()
    if sq < 1024:
        err = _close(torch, out.detach(), want_out.detach(), tol,
                     f"K5 train {name}")
    else:
        err = _close_rows(torch, out.detach(), want_out.detach(), tol,
                          f"K5 train {name}")
    grad_err = 0.0
    for gname, a, w in zip(("dq", "dk", "dv"), got, want):
        check(a.dtype == w.dtype and a.shape == w.shape,
              f"K5 train {name}: {gname} {a.dtype} {tuple(a.shape)}")
        e = _rel_err(torch, a, w)
        check(e <= TRAIN_GRAD_TOL, f"K5 train {name}: {gname} off the "
              f"plain version's by {e:.2e} of its largest value")
        grad_err = max(grad_err, float((a.float() - w.float()).abs().max()))
    log(f"[26a] K5 under autograd, {name} (B {b}, Sq {sq}, Skv {skv}, H "
        f"{h}, KVH {kvh}, D {d}, {dt}, causal {causal}): output within "
        f"{tol} (max |diff| {err:.2e}), dq / dk / dv within "
        f"{TRAIN_GRAD_TOL} of their largest (max |diff| {grad_err:.2e})")
    return dict(name=name, max_abs_err=err, grad_max_abs_err=grad_err)


def _k5_train_times(torch, gen):
    """26a's times at the train shape: K5's forward, the recompute
    backward (the ``autograd.Function``'s, replayed from one graph), the
    plain version's forward, SDPA's forward and forward + backward; the
    bounds of the forward (q, k, v read, o written; its products) and of
    the backward (q, k, v, dO read, dq, dk, dv written; 2.5x the
    forward's operations: five products against two)."""
    from repro_torch.kernels import ops, ref
    b, s, h, kvh, d = TRAIN_B, TRAIN_S, 32, 8, 64
    sdpa, sdpa_how = _sdpa(torch)
    q, k, v, _ = _dense_qkv(torch, gen, b, s, s, h, kvh, d, torch.bfloat16,
                            torch.bfloat16)
    g = torch.randn((b, s, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    with torch.no_grad():
        fwd_ms = time_ms(torch, lambda: ops.flash_attention(q, k, v), 50)
        plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v),
                           20)
        lib_ms = time_ms(torch, lambda: sdpa(q, k, v, True), 50)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*ins)
    bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        out, ins, g, retain_graph=True), 20)
    sins = [t.clone().requires_grad_() for t in (q, k, v)]

    def sdpa_train():
        o = sdpa(*sins, True).transpose(1, 2)
        return torch.autograd.grad(o, sins, g)
    lib_train_ms = time_ms(torch, sdpa_train, 20)
    n_bytes = 2 * (2 * q.numel() + 2 * k.numel())
    n_ops = b * h * 4 * d * sum(i + 1 for i in range(s))
    b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
    bwd_bytes = 2 * (3 * q.numel() + 4 * k.numel())
    bb_ms, bb_by = bound_ms(bwd_bytes, 2.5 * n_ops, "bfloat16")
    res = dict(ms=fwd_ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=b_ms, bound_by=b_by, bytes=n_bytes, ops=n_ops,
               backward_ms=bwd_ms, backward_bound_ms=bb_ms,
               backward_bound_by=bb_by, library_train_ms=lib_train_ms,
               sdpa=sdpa_how)
    log(f"[26a] K5 at the train shape (B {b}, S {s}, H {h}, KVH {kvh}, D "
        f"{d}, bf16, causal): forward {fwd_ms:.4f} ms (bound {b_ms:.5f} ms, "
        f"{b_by}, {n_bytes / 1e6:.1f} MB), recompute backward "
        f"{bwd_ms:.4f} ms (bound {bb_ms:.5f} ms, {bb_by}), plain forward "
        f"{plain_ms:.4f} ms; SDPA ({sdpa_how}) forward {lib_ms:.4f} ms, "
        f"forward + backward {lib_train_ms:.4f} ms against K5 + recompute "
        f"{fwd_ms + bwd_ms:.4f} ms")
    return res


def _train_kernels(torch, res):
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    res["k5_cases"] = [_k5_autograd_case(torch, gen, c)
                       for c in TRAIN_K5_CASES]
    # int8 K/V codes take no gradient, as in the reference
    q, k, v, nkv = _dense_qkv(torch, gen, 2, 16, 16, 8, 4, 64,
                              torch.bfloat16, torch.int8)
    try:
        ops.flash_attention(q.requires_grad_(), k, v, kv_frac_bits=nkv)
    except NotImplementedError as e:
        log(f"[26a] K5: a q that requires grad over int8 K/V refused ({e})")
    else:
        check(False, "K5: a q that requires grad over int8 K/V was taken")
    res["k5_train"] = _k5_train_times(torch, gen)


def _train_batches(cfg, device, n):
    import torch
    from repro_torch.data import SyntheticLMStream
    stream = SyntheticLMStream(cfg.vocab_size, TRAIN_CPU_SEQ,
                               TRAIN_CPU_BATCH, seed=0)
    return [{k: torch.from_numpy(v).to(device)
             for k, v in stream.batch(i).items()} for i in range(n)]


# 26b's two steps from the seeded weights: (accum_steps, rate)
TRAIN_ACCUMS = ((1, 0.0), (2, 3e-3))


def _train_cut():
    """26b's model, optimizer and schedule: llama3.2-1B's width on 2
    layers, fp32, flash attention, AdamW, a warmup-cosine rate."""
    from repro_torch.configs import get_config
    from repro_torch.optim import adamw, warmup_cosine
    cfg = dataclasses.replace(get_config("llama3_2_1b"), n_layers=2,
                              dtype="float32", attn_kernel="flash")
    return cfg, adamw(), warmup_cosine(3e-3, 1, 10)


def _train_cpu_steps():
    """26b's CPU side (a CPU reference): TRAIN_ACCUMS' steps from the
    seeded weights and a fresh AdamW state; after each, its metrics and
    seconds and copies of the moments and params."""
    from repro_torch.core.qmodel import QuantContext
    from repro_torch.core.tree import leaves
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    cfg, opt, lr_fn = _train_cut()
    p = M.init_params(cfg, 0, device="cpu")
    st = opt.init(p)
    batches = _train_batches(cfg, "cpu", 2)
    out = []
    for accum, _ in TRAIN_ACCUMS:
        step = S.build_train_step(cfg, QuantContext(), opt, lr_fn,
                                  remat=False, accum_steps=accum)
        t0 = time.perf_counter()
        _, _, m = step(p, st, batches[accum - 1])
        out.append(dict(metrics={k: float(v) for k, v in m.items()},
                        s=time.perf_counter() - t0,
                        m=[t.clone() for t in leaves(st.m)],
                        v=[t.clone() for t in leaves(st.v)],
                        params=[t.clone() for t in leaves(p)]))
    return out


def _train_card_vs_cpu(torch, res, cpu=None):
    """26b: the 2-layer full-width model, fp32, one step and one
    accumulated step on the card from the same params and state as the
    CPU's (``cpu``, the future of ``_train_cpu_steps``), then a checkpoint round
    trip resumed on the card."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.qmodel import QuantContext
    from repro_torch.core.tree import leaves
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    cfg, opt, lr_fn = _train_cut()
    p_cpu = M.init_params(cfg, 0, device="cpu")
    p0 = leaves(p_cpu)
    p = {"cuda": _tree_to(p_cpu, "cuda")}
    st = {"cuda": opt.init(p["cuda"])}
    batches = {"cuda": _train_batches(cfg, "cuda", 4)}
    cpu_steps = (cpu or on_cpu_thread(_train_cpu_steps)).result()
    for (accum, lr), cpu in zip(TRAIN_ACCUMS, cpu_steps):
        step = S.build_train_step(cfg, QuantContext(), opt, lr_fn,
                                  remat=False, accum_steps=accum)
        t0 = time.perf_counter()
        _, _, mc = step(p["cuda"], st["cuda"], batches["cuda"][accum - 1])
        torch.cuda.synchronize()
        m = {"cuda": {k: float(v) for k, v in mc.items()},
             "cpu": cpu["metrics"]}
        m["cuda"]["s"], m["cpu"]["s"] = time.perf_counter() - t0, cpu["s"]
        for key in ("loss", "grad_norm"):
            e = abs(m["cuda"][key] - m["cpu"][key]) / abs(m["cpu"][key])
            check(e <= TRAIN_LOSS_RTOL, f"26b accum {accum}: {key} card "
                  f"{m['cuda'][key]} CPU {m['cpu'][key]}")
        check(m["cuda"]["lr"] == m["cpu"]["lr"]
              and abs(m["cpu"]["lr"] - lr) <= 1e-9,
              f"26b accum {accum}: lr {m['cuda']['lr']}")
        mom = max(_rel_err(torch, a.cpu(), b)
                  for name in ("m", "v")
                  for a, b in zip(leaves(getattr(st["cuda"], name)),
                                  cpu[name]))
        check(mom <= TRAIN_MOMENT_TOL, f"26b accum {accum}: moments off by "
              f"{mom:.2e} of a leaf's largest")
        dp = max(float((a.cpu() - b).abs().max())
                 for a, b in zip(leaves(p["cuda"]), cpu["params"]))
        moved = sum(int(((a.cpu() - b).abs() > 1e-6).sum())
                    for a, b in zip(leaves(p["cuda"]), cpu["params"]))
        check(dp <= 2 * lr + 1e-6, f"26b accum {accum}: params off by "
              f"{dp:.2e}, beyond 2 lr = {2 * lr}")
        if lr == 0.0:
            check(all(torch.equal(a.cpu(), b) for a, b in
                      zip(leaves(p["cuda"]), p0)),
                  "26b: a step at lr 0 moved a parameter")
        n_par = sum(t.numel() for t in p0)
        log(f"[26b] 2-layer llama3.2-1B width, fp32, step with accum_steps "
            f"{accum} at lr {lr}: loss card {m['cuda']['loss']:.6f} "
            f"CPU {m['cpu']['loss']:.6f}, grad_norm card "
            f"{m['cuda']['grad_norm']:.6f} CPU "
            f"{m['cpu']['grad_norm']:.6f} (within "
            f"{TRAIN_LOSS_RTOL}), moments within {mom:.2e} of a leaf's "
            f"largest, params max |diff| {dp:.2e} ({moved} of {n_par} "
            f"beyond 1e-6); step {m['cuda']['s']:.2f} s card, "
            f"{m['cpu']['s']:.2f} s CPU (on a background thread)")
        res[f"card_vs_cpu accum {accum}"] = dict(
            loss=(m["cuda"]["loss"], m["cpu"]["loss"]),
            grad_norm=(m["cuda"]["grad_norm"], m["cpu"]["grad_norm"]),
            moment_rel_err=mom, param_max_diff=dp, params_moved=moved)
    del cpu_steps, p0
    # checkpoint after these steps; two more steps straight on, then the
    # same two from the restored state
    step = S.build_train_step(cfg, QuantContext(), opt, lr_fn, remat=False)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ck = Checkpointer(tmp)
        t0 = time.perf_counter()
        ck.save(2, {"params": p["cuda"], "opt": st["cuda"]},
                extra={"step": 2}, blocking=True)
        save_s = time.perf_counter() - t0
        direct = [float(step(p["cuda"], st["cuda"], b)[2]["loss"])
                  for b in batches["cuda"][2:]]
        t0 = time.perf_counter()
        state, extra = ck.restore({"params": p["cuda"], "opt": st["cuda"]})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(extra == {"step": 2} and int(state["opt"].step) == 2,
              f"26b: restored {extra}, step {int(state['opt'].step)}")
        resumed = [float(step(state["params"], state["opt"], b)[2]["loss"])
                   for b in batches["cuda"][2:]]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    e = max(abs(a - b) / abs(b) for a, b in zip(resumed, direct))
    check(e <= TRAIN_LOSS_RTOL, f"26b: resumed losses {resumed}, "
          f"uninterrupted {direct}")
    log(f"[26b] checkpoint of params + AdamW state saved in {save_s:.1f} s, "
        f"restored in {restore_s:.1f} s; the resumed steps' losses "
        f"{resumed} against the uninterrupted run's {direct} (within "
        f"{TRAIN_LOSS_RTOL} relative)")
    res["resume"] = dict(direct=direct, resumed=resumed, save_s=save_s,
                         restore_s=restore_s)


def _train_full(torch, res):
    """26c: ``train()`` of llama3.2-1B at full width and depth on the
    card, flash attention, no checkpoint."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import train
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    o = train("llama3_2_1b", TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
              smoke=False, attn_kernel="flash", log_every=1)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    cfg, losses = o["cfg"], o["losses"]
    n_par = S.param_count(cfg)
    check(n_par == _dense_params(cfg),
          f"26c: param_count {n_par}, the formula {_dense_params(cfg)}")
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(x)
                                              for x in losses),
          f"26c: losses {losses}")
    check(losses[-1] < losses[1], f"26c: the loss did not fall after step "
          f"1: {losses}")
    want = {k: 0 for k in launches}
    want["flash_prefill"] = cfg.n_layers * TRAIN_STEPS
    check(launches == want, f"26c: launches {launches}, want {want}")
    step_s = sorted(o["step_s"][1:])
    med = step_s[len(step_s) // 2]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[26c] train llama3.2-1B at full width and depth "
        f"({n_par / 1e9:.3f} B parameters, AdamW), {TRAIN_STEPS} steps of "
        f"{TRAIN_B} x {TRAIN_S} tokens, flash attention: losses "
        f"{[round(x, 4) for x in losses]}; step (host clock, synchronized) "
        f"median of steps 2-{TRAIN_STEPS} {1e3 * med:.1f} ms (range "
        f"{1e3 * step_s[0]:.1f}-{1e3 * step_s[-1]:.1f}; step 1 "
        f"{1e3 * o['step_s'][0]:.1f} ms), "
        f"{TRAIN_B * TRAIN_S / med:.0f} tokens/s, peak "
        f"{peak:.2f} GiB, K5 {launches['flash_prefill']} launches "
        f"({cfg.n_layers} a step), {wall:.1f} s")
    res["full"] = dict(losses=losses, step_s=o["step_s"], median_step_s=med,
                       tokens_per_s=TRAIN_B * TRAIN_S / med, peak_gib=peak,
                       params=n_par, launches=launches, wall_s=wall)
    return o


def _train_then_int(torch, res, trained):
    """26d: Algorithm 1 on the trained weights, their matmul weights
    quantized once to int8 codes (as ``serve`` deploys them), then the FP
    and INT forwards of one batch: K2 and K3 by phase 22's formula for a
    forward without a cache (no int8 K/V write: K3_PER_LAYER - 1 a
    layer)."""
    from repro_torch.core.lm_calibrate import calibrate_lm
    from repro_torch.core.qmodel import (QuantContext, QuantMode,
                                         quantize_weight_tree)
    from repro_torch.data import SyntheticLMStream
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    cfg, params = trained["cfg"], trained["params"]
    tokens = SyntheticLMStream(cfg.vocab_size, TRAIN_S, TRAIN_B,
                               seed=123).batch(0)["tokens"]
    b = {"tokens": torch.from_numpy(tokens).to("cuda")}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ctx, _ = calibrate_lm(lambda p, bb, c: M.forward(p, bb, cfg, c),
                          params, b)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    int_ctx = dataclasses.replace(ctx, mode=QuantMode.INT)
    with torch.no_grad():
        lf, _ = M.forward(params, b, cfg, QuantContext(mode=QuantMode.FP))
        codes = quantize_weight_tree(params, int_ctx)
        li, _ = M.forward(codes, b, cfg, int_ctx)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    L = cfg.n_layers
    want = {k: 0 for k in launches}
    want.update(flash_prefill=3 * L, int8_matmul=7 * L + 1,
                quantize=(K3_PER_LAYER - 1) * L + 1
                + int(cfg.tie_embeddings))
    check(launches == want, f"26d: launches {launches}, want {want}")
    check(bool(torch.isfinite(li).all()), "26d: INT logits not finite")
    agree = float((lf.argmax(-1) == li.argmax(-1)).float().mean())
    log(f"[26d] Algorithm 1 on the trained weights in {cal_s:.2f} s "
        f"({len(ctx.table)} modules); FP vs INT argmax agreement "
        f"{agree:.4f} on {TRAIN_B} x {TRAIN_S} tokens; launches K2 "
        f"{launches['int8_matmul']} K3 {launches['quantize']} K5 "
        f"{launches['flash_prefill']} (calibration forward, FP, INT)")
    res["int"] = dict(agreement=agree, calibrate_s=cal_s, launches=launches)


def phase_train(torch, out, cpu=None):
    """Phase 26: training -- (a) K5 under autograd, (b) the 2-layer
    full-width model card against CPU (``cpu``: the future of
    ``_train_cpu_steps``, started here if not given) and a checkpoint
    resume, (c)
    ``train()`` of llama3.2-1B at full width and depth, (d) Algorithm 1
    and the INT forward on the trained weights."""
    t0 = time.perf_counter()
    res = {"part_s": {}}
    trained = {}
    for part, run in (
            ("a", lambda: _train_kernels(torch, res)),
            ("b", lambda: _train_card_vs_cpu(torch, res, cpu)),
            ("c", lambda: trained.update(_train_full(torch, res))),
            ("d", lambda: _train_then_int(torch, res, trained))):
        t1 = time.perf_counter()
        run()
        torch.cuda.empty_cache()
        res["part_s"][part] = time.perf_counter() - t1
    trained.clear()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    log(f"[26] training phase {res['seconds']:.1f} s (parts "
        f"{ {k: round(v, 1) for k, v in res['part_s'].items()} })")
    out["train"] = res
    return res

# ---------------------------------------------------------------------------
# phase 27: tensor-parallel serving over a (data, model) mesh
# ---------------------------------------------------------------------------

# qwen3-1.7B's row-cut modules (K, N) cut over the model axis's ranks, at
# these stream rows (the engine's 24 bucket among them), timed at
# TP_TIMED_ROWS
TP_ROW_CUT = {"wo": (2048, 2048), "w2": (6144, 2048)}
TP_RANKS, TP_ROWS, TP_TIMED_ROWS = (2, 4), (1, 4, 24, 256), 24
# the FP rule: a mesh's first-step logits (the row-cut modules' fp32
# partials summed in another order, rounded once to bf16) within this
# share of the one rank's largest |logit|
TP_FP_REL = 5e-2
# requests a second of 27b's wall-clock engine run on the mesh
TP_PACED_RATE = 10.0
# 27b's depth: 8 of qwen3-1.7B's 28 layers (full depth until the script
# took phase 28, 14 until it took phase 30).  On an H100 80GB HBM3 at 700
# W phase 27 took 93.5 s at full depth and 48.4 s at half, and whole runs
# of the script spread by over 100 s between calls
TP_LAYERS = 8


def _tp_k2(torch, res):
    """27a: K2's rank-split form (each rank's int32 partial, the partials
    summed in int32, the finish once) against the single launch, bit-exact,
    at qwen3-1.7B's row-cut shapes over 2 and 4 ranks; the partial (and
    ``torch._int_mm``, the same int32 product), the finish and the single
    launch timed beside their bounds."""
    from repro_torch.core.integer_ops import LinearQuantSpec
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)
    spec = LinearQuantSpec(n_x=4, n_w=8, n_b=7, n_o=4)
    n_checks, timed, max_err = 0, [], 0.0
    for name, (k, n) in TP_ROW_CUT.items():
        w = torch.randint(-128, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-128, 128, (n,), generator=gen, device="cuda",
                          dtype=torch.int8)
        for ranks in TP_RANKS:
            kr = k // ranks
            for m in TP_ROWS:
                for x_dt in (torch.int8, torch.uint8):
                    lo, hi = (0, 256) if x_dt == torch.uint8 else (-128, 128)
                    x = torch.randint(lo, hi, (m, k), generator=gen,
                                      device="cuda",
                                      dtype=torch.int32).to(x_dt)
                    parts = [ops.int8_matmul_partial(
                        x[:, r * kr:(r + 1) * kr], w[r * kr:(r + 1) * kr])
                        for r in range(ranks)]
                    check(torch.equal(parts[0], ref.int8_matmul_partial_ref(
                        x[:, :kr], w[:kr])),
                        f"27a {name} M={m}: partial != plain")
                    acc = parts[0].clone()
                    for p in parts[1:]:
                        acc += p        # the ranks' int32 all-reduce
                    for bias in (None, b):
                        for out_float in (None, torch.bfloat16):
                            want = ops.int8_matmul(x, w, bias, spec,
                                                   out_float=out_float)
                            got = ops.int8_matmul_finish(
                                acc, bias, spec, out_float=out_float)
                            max_err = max(max_err, float(
                                (got.double() - want.double()).abs().max()))
                            check(got.dtype == want.dtype
                                  and torch.equal(got, want),
                                  f"27a {name} {ranks} ranks M={m} {x_dt} "
                                  f"bias {bias is not None} {out_float}: "
                                  f"rank-split != single launch")
                            n_checks += 1
            # timed at the engine's rows, bf16 epilogue, weights rotated
            # past the L2
            m = TP_TIMED_ROWS
            copies = max(1, math.ceil(128e6 / (kr * n)))
            x = torch.randint(-128, 128, (m, k), generator=gen,
                              device="cuda", dtype=torch.int8)
            xr = x[:, :kr].contiguous()
            ws = [torch.randint(-128, 128, (kr, n), generator=gen,
                                device="cuda", dtype=torch.int8)
                  for _ in range(copies)]
            wf = [torch.randint(-128, 128, (k, n), generator=gen,
                                device="cuda", dtype=torch.int8)
                  for _ in range(max(1, math.ceil(128e6 / (k * n))))]
            acc = ops.int8_matmul_partial(xr, ws[0])
            it = [0]

            def turn(pool):
                it[0] += 1
                return pool[it[0] % len(pool)]

            part_ms = time_ms(torch, lambda: ops.int8_matmul_partial(
                xr, turn(ws)), 50)
            lib_ms = time_ms(torch, lambda: torch._int_mm(xr, turn(ws)), 50)
            fin_ms = time_ms(torch, lambda: ops.int8_matmul_finish(
                acc, None, spec, out_float=torch.bfloat16), 50)
            one_ms = time_ms(torch, lambda: ops.int8_matmul(
                x, turn(wf), None, spec, out_float=torch.bfloat16), 50)
            plain_ms = time_ms(torch, lambda: ref.int8_matmul_finish_ref(
                ref.int8_matmul_partial_ref(xr, turn(ws)), None,
                shift=spec.requant_shift, out_dtype=torch.bfloat16,
                n_o=spec.n_o), 3, warmup=1)
            pb, pby = bound_ms(m * kr + kr * n + 4 * m * n, 2 * m * kr * n,
                               "int8")
            fb, fby = bound_ms(4 * m * n + 2 * m * n, 2 * m * n, "float32")
            ob, oby = bound_ms(m * k + k * n + 2 * m * n, 2 * m * k * n,
                               "int8")
            row = dict(module=name, k=k, n=n, ranks=ranks, m=m,
                       partial_ms=part_ms, partial_bound_ms=pb,
                       partial_bound_by=pby, int_mm_ms=lib_ms,
                       finish_ms=fin_ms, finish_bound_ms=fb,
                       finish_bound_by=fby, single_ms=one_ms,
                       single_bound_ms=ob, single_bound_by=oby,
                       plain_ms=plain_ms)
            timed.append(row)
            log(f"    27a {name} K={k} N={n} over {ranks} ranks, M={m}: "
                f"partial {part_ms:.4f} ms (bound {pb:.5f}, {pby}; _int_mm "
                f"{lib_ms:.4f}), finish {fin_ms:.4f} ms (bound {fb:.5f}, "
                f"{fby}), single launch {one_ms:.4f} ms (bound {ob:.5f}, "
                f"{oby}), plain partial + finish {plain_ms:.4f} ms")
            del ws, wf
    log(f"[27a] K2 rank-split bit-exact against the single launch: "
        f"{n_checks} cases (wo, w2 x {list(TP_RANKS)} ranks x M "
        f"{list(TP_ROWS)} x int8 / uint8 x bias or none x codes / bf16), "
        f"max |diff| {max_err:.3g}")
    res["k2"] = dict(checks=n_checks, timed=timed, max_abs_err=max_err)


def _tp_one(res_run, kind):
    """What phase 27b compares of one run of ``tests/tp_cases.py``'s
    runner: tokens, first-step logits, launches, the calibrated table and
    (engine) the report."""
    toks = res_run["tokens"] if kind == "serve" else res_run["outputs"]
    return dict(res_run, tokens=toks, logits=res_run["logits"].float(),
                report=res_run.get("report"),
                decode_s_per_tok=res_run.get("decode_s_per_tok"))


def _tp_want(cfg, kind, mode, rep) -> dict:
    """One rank's launches on a (1, 2) mesh: K2 a launch a column-cut
    module (q, k, v, w1, w3, the head) and a partial and a finish a
    row-cut one (wo, w2), 9 a layer and the head in INT; K3 as one rank's
    (4 module inputs and the K/V write a layer, the head's input); K1 (the
    ragged engine) or K4 (the legacy one) once a layer a step; classic: K5
    once a layer in prefill, K6 once a layer a decode step."""
    L = cfg.n_layers
    if kind == "serve":
        forwards = SERVE_GEN
        want = {"flash_prefill": L, "flash_decode": L * (SERVE_GEN - 1)}
    else:
        forwards = _dispatches(rep)
        want = {"ragged_attention" if rep["ragged"] else
                "paged_attention": L * forwards}
    if mode == "int":
        want.update(int8_matmul=(9 * L + 1) * forwards,
                    int8_matmul_partial=2 * L * forwards,
                    int8_matmul_finish=2 * L * forwards,
                    quantize=(K3_PER_LAYER * L + 1) * forwards)
    else:
        want.update(int8_matmul=0, int8_matmul_partial=0,
                    int8_matmul_finish=0,
                    quantize=L * forwards if kind != "serve" else 0)
    return want


def _tp_serving(torch, res):
    """27b: two ranks sharing the card over gloo, qwen3-1.7B at full width
    on TP_LAYERS of its 28 layers, bf16: the (1, 2) ragged engine in FP,
    calibrated INT and
    W8A8 on phase 5's workload, the legacy engine in INT, classic ``serve``
    with flash attention in FP and INT, each against the one-rank eager
    run of the same workload here."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    # the case runner the tensor-parallel tests use; the spawned ranks
    # import it through this process's path
    sys.path.insert(0, str(ROOT / "tests"))
    import tp_cases
    import numpy as np
    cfg = dataclasses.replace(get_config("qwen3_1_7b"), n_layers=TP_LAYERS)
    cut = {"n_layers": TP_LAYERS}
    eng = dict(smoke=False, kv_bits=8, n_requests=8, n_slots=4, rate=1e9,
               cfg_overrides=cut)
    cls = dict(smoke=False, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
               gen=SERVE_GEN, attn_kernel="flash", cfg_overrides=cut)
    cases = [("ragged fp", "serve_engine", dict(eng, mode="fp")),
             ("ragged int", "serve_engine",
              dict(eng, mode="int", calibrate=True)),
             ("ragged w8a8", "serve_engine", dict(eng, w8a8=True)),
             ("legacy int", "serve_engine",
              dict(eng, mode="int", calibrate=True, ragged=False)),
             ("classic fp", "serve", dict(cls, mode="fp", calibrate=False)),
             ("classic int", "serve",
              dict(cls, mode="int", calibrate=True,
                   cfg_overrides=dict(cut, kv_cache_bits=8)))]
    kinds = {"serve": "classic", "serve_engine": "engine"}
    ones = [_tp_one(tp_cases.run(kinds[fn], kw, device="cuda"), fn)
            for _, fn, kw in cases]
    t0 = time.perf_counter()
    # last, on the ranks only: the INT engine at a finite rate on the
    # wall clock, where rank 0's clock decides each step's admissions
    paced = dict(eng, mode="int", calibrate=True, rate=TP_PACED_RATE)
    ranks = run_ranks(tp_cases.run_cases, (1, 2), device="cuda",
                      backend="gloo",
                      kwargs={"cases": [(kinds[fn], kw)
                                        for _, fn, kw in cases]
                              + [("engine", paced)]})
    mesh_s = time.perf_counter() - t0
    log(f"[27b] qwen3-1.7B at full width on {TP_LAYERS} of its 28 layers; "
        f"one rank: {sum(o['wall_s'] for o in ones):.1f} s for the "
        f"{len(cases)} runs; the (1, 2) mesh's ranks: {mesh_s:.1f} s, "
        f"spawned, the weights built and cut on each, every run")
    runs = {}
    for i, (tag, fn, kw) in enumerate(cases):
        one = ones[i]
        got = [_tp_one(r[i], fn) for r in ranks]
        mode = "int" if ("int" in tag or "w8a8" in tag) else "fp"
        kind = "serve" if fn == "serve" else "engine"
        if kind == "engine":
            same_ranks = all(g["tokens"].keys() == got[0]["tokens"].keys()
                             and all(np.array_equal(g["tokens"][r],
                                                    got[0]["tokens"][r])
                                     for r in g["tokens"]) for g in got)
            agree = np.mean([float(np.array_equal(got[0]["tokens"][r],
                                                  one["tokens"][r]))
                             for r in one["tokens"]])
        else:
            same_ranks = all(np.array_equal(g["tokens"], got[0]["tokens"])
                             for g in got)
            agree = float(np.mean(got[0]["tokens"] == one["tokens"]))
        check(same_ranks, f"27b {tag}: the ranks' tokens differ")
        err = float((got[0]["logits"] - one["logits"]).abs().max())
        scale = float(one["logits"].abs().max())
        for r, g in enumerate(got):
            check(g["table"] == one["table"],
                  f"27b {tag} rank {r}: calibrated table != one rank's")
            rep = g["report"] if kind == "engine" else None
            want = _tp_want(cfg, fn, mode, rep)
            have = {k: g["launches"][k] for k in want}
            check(have == want, f"27b {tag} rank {r}: launches {have}, "
                  f"want {want}")
            check(bool(torch.isfinite(g["logits"]).all()),
                  f"27b {tag} rank {r}: non-finite logits")
        if mode == "int":
            check(agree == 1.0, f"27b {tag}: tokens differ from one rank's "
                  f"(agreement {agree})")
            check(all(torch.equal(g["logits"], one["logits"]) for g in got),
                  f"27b {tag}: first-step logits != one rank's "
                  f"(max |diff| {err})")
        else:
            check(err <= TP_FP_REL * scale,
                  f"27b {tag}: first-step logits {err} apart, over "
                  f"{TP_FP_REL} x {scale}")
        # the engine's tokens/s over its run; classic serve's decode
        # steps (batch x 1 token a step) per second
        if kind == "engine":
            tps = got[0]["report"]["tokens_per_s"]
            one_tps = one["report"]["tokens_per_s"]
        else:
            tps = SERVE_BATCH / got[0]["decode_s_per_tok"]
            one_tps = SERVE_BATCH / one["decode_s_per_tok"]
        launches = {k: v for k, v in got[0]["launches"].items() if v}
        log(f"[27b] {tag}: ranks token-identical; against one rank tokens "
            f"agree {agree:.4f}, first-step logits max |diff| {err:.6g} "
            f"(|logit| up to {scale:.4g})"
            + (" bit-identical" if mode == "int" else "")
            + f"; {tps:.2f} tokens/s on 2 ranks sharing one card over "
            f"gloo ({one_tps:.2f} one rank, eager"
            + ("" if kind == "engine" else
               f"; decode {1e3 * got[0]['decode_s_per_tok']:.1f} / "
               f"{1e3 * one['decode_s_per_tok']:.1f} ms a step")
            + f"); rank 0 launches {launches}")
        runs[tag] = dict(agree=agree, logits_max_abs_diff=err,
                         logits_scale=scale, tokens_per_s=tps,
                         one_rank_tokens_per_s=one_tps,
                         decode_s_per_tok=got[0]["decode_s_per_tok"],
                         one_rank_decode_s_per_tok=one["decode_s_per_tok"],
                         launches=[g["launches"] for g in got],
                         wall_s=[g["wall_s"] for g in got],
                         one_rank_wall_s=one["wall_s"])
    got = [r[-1] for r in ranks]
    admitting = sum(1 for st in got[0]["steps"] if st)
    check(all(g["steps"] == got[0]["steps"] for g in got),
          "27b paced: the ranks' steps admitted different requests")
    check(all(g["outputs"].keys() == got[0]["outputs"].keys()
              and all(np.array_equal(g["outputs"][q], got[0]["outputs"][q])
                      for q in g["outputs"]) for g in got),
          "27b paced: the ranks' tokens differ")
    check(admitting > 1, f"27b paced: every arrival joined in one step "
          f"({got[0]['steps']}); the rate did not pace the run")
    log(f"[27b] ragged int at {TP_PACED_RATE} requests/s on the wall "
        f"clock: the ranks' {len(got[0]['steps'])} steps admitted the same "
        f"requests ({admitting} steps admitting), tokens identical; "
        f"{got[0]['report']['tokens_per_s']:.2f} tokens/s on 2 ranks "
        f"sharing one card over gloo")
    runs["ragged int paced"] = dict(
        steps=len(got[0]["steps"]), admitting_steps=admitting,
        tokens_per_s=got[0]["report"]["tokens_per_s"],
        launches=[g["launches"] for g in got],
        wall_s=[g["wall_s"] for g in got])
    res["serving"] = runs
    res["mesh_s"] = mesh_s


def _tp_refusal(res):
    """27c: a (1, 16) mesh on qwen3's 8 KV heads raises at build time,
    before any rank starts."""
    from repro_torch.launch.serve import serve
    try:
        serve("qwen3_1_7b", smoke=False, mesh_shape=(1, 16),
              dist_backend="gloo", device="cuda")
    except NotImplementedError as e:
        check("must divide" in str(e), f"27c: refused for another reason: "
              f"{e}")
        log(f"[27c] a (1, 16) mesh refused at build time: {e}")
        res["refusal"] = str(e)
        return
    check(False, "27c: a (1, 16) mesh on 8 KV heads was not refused")


def phase_tp(torch, out):
    t0 = time.perf_counter()
    res = {}
    _tp_k2(torch, res)
    torch.cuda.empty_cache()
    _tp_serving(torch, res)
    _tp_refusal(res)
    res["seconds"] = time.perf_counter() - t0
    log(f"[27] tensor-parallel serving: {res['seconds']:.1f} s")
    out["tp"] = res
    return res


# ---------------------------------------------------------------------------
# phase 28: training over a (data, model) mesh
# ---------------------------------------------------------------------------

# 28a: llama3.2-1B at full width and depth on a (1, 2) mesh, bf16, flash
# attention, TM_STEPS steps of TM_B x TM_S tokens from weights and a
# stream seeded TM_SEED, against one rank's on the card.  The rate is 0 at
# the first step, so the first TM_FIXED steps run on the seeded params:
# their loss within TM_LOSS_REL and grad_norm within TM_GNORM_REL (bf16:
# the row-cut modules' partials summed in fp32 and rounded once, the
# ranks' heads apart).  The steps after see the params an update moved:
# loss within TM_UPDATED_LOSS_REL, grad_norm within TM_UPDATED_GNORM_REL.
# The card's atomic adds (``index_add_`` in the vocab-cut embedding's
# backward) reorder fp32 sums, and AdamW's first update, about lr
# sign(g), moves a parameter whose gradient is near 0 by +lr on one run
# and -lr on another (measured, a repeat of the same run: 4.9e-5 in the
# loss at full size, 9.1e-6 on the smoke config; mesh against one rank:
# 1.8e-5 in the loss, 1.0e-3 in grad_norm)
TM_B, TM_S, TM_STEPS, TM_SEED, TM_FIXED = 8, 128, 3, 0, 2
TM_LOSS_REL, TM_GNORM_REL = 5e-3, 2e-3
TM_UPDATED_LOSS_REL, TM_UPDATED_GNORM_REL = 5e-4, 1e-2
# 28a's ``train(mesh_shape=(1, 2))``: the smoke config (the call at full
# size took 36.6 s and put phase 28 past its 150 s), TM_CKPT["steps"]
# steps saved every ckpt_every; the (1, 2) case runner then repeats its
# first TM_STEPS steps (the rates agree to there) and, with the last
# commit dropped, resumes from the one before.  A repeat's losses are
# bit-identical to the first run's before the first update, within
# TM_UPDATED_LOSS_REL after it
TM_CKPT = dict(steps=6, ckpt_every=3, batch=4, seq=32)
# 28b: the 2-layer full-width model, fp32, two steps of the CPU's 26b
# batch shape on a (2, 1) mesh, with and without FSDP, against the CPU's
# one rank; the rate has no warmup, so the first step moves the params
# and the second step's loss and grad_norm see where they went.  The
# moments are held after the first step (its gradients, of the seeded
# params): after an update the two devices' params part by +-lr where a
# gradient is near 0, and the next gradients follow them (7.8e-4 of a
# leaf's largest after the second step, against 26b's 1e-4)
TM_DATA_LAYERS, TM_DATA_STEPS = 2, 2


def _tm_case(**kw):
    return dict(kind="train", arch="llama3_2_1b", smoke=False, **kw)


def _tm_repeat_gap(got: list, want: list, exact: int) -> float:
    """The largest relative gap of a repeat's losses ``got`` from the
    first run's ``want`` past their first ``exact`` steps, which must be
    bit-identical (inf when they are not, or the lengths differ)."""
    if len(got) != len(want) or got[:exact] != want[:exact]:
        return math.inf
    return max([abs(a - b) / abs(b) for a, b in
                zip(got[exact:], want[exact:])] + [0.0])


def _tm_launches_want(one: dict, layers: int) -> dict:
    """One rank of a (1, 2) mesh in an INT step: the one rank's launches,
    but a row-cut module (wo, w2) is K2's rank-split form, a partial and
    a finish where one rank launches K2 once."""
    want = dict(one)
    want["int8_matmul"] = one["int8_matmul"] + 2 * layers
    want["int8_matmul_partial"] = 2 * layers
    want["int8_matmul_finish"] = 2 * layers
    return want


def _tm_data_case() -> dict:
    """28b's case: the 2-layer full-width model in fp32, TM_DATA_STEPS
    steps at a rate with no warmup, on the (2, 1) mesh over the ranks."""
    return _tm_case(cfg={"n_layers": TM_DATA_LAYERS, "dtype": "float32",
                         "attn_kernel": "flash"},
                    batch=TRAIN_CPU_BATCH, seq=TRAIN_CPU_SEQ,
                    steps=TM_DATA_STEPS, warmup=0, keep="rank 0",
                    keep_after=1, params_back=False, model_axis=1)


def _tm_full(torch, res):
    """28a + 28c: two ranks sharing the card over gloo, llama3.2-1B at
    full width and depth, a (1, 2) mesh: TM_STEPS bf16 train steps (K5 the
    attention forward), then one INT step (K2's rank-split form), each
    against one rank's here; before them ``train(mesh_shape=(1, 2))`` of
    the smoke config with checkpoints, which the same ranks repeat and
    resume.  The same ranks then run 28b's cases on a (2, 1) mesh, while
    its CPU reference runs here (``res["data_runs"]``)."""
    import concurrent.futures
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import model as M
    sys.path.insert(0, str(ROOT / "tests"))
    import train_mesh_cases as tmc
    L = get_config("llama3_2_1b").n_layers
    base = dict(cfg={"attn_kernel": "flash"}, batch=TM_B, seq=TM_S,
                keep=False, seed=TM_SEED, data_seed=TM_SEED)
    fp, int_ = _tm_case(steps=TM_STEPS, timed_step=True, **base), \
        _tm_case(steps=1, mode="int", **base)
    ones = {}
    # one rank: every step compared, the warm ones timed
    for tag, case in (("fp", fp), ("int", int_)):
        torch.cuda.reset_peak_memory_stats()
        ones[tag] = tmc.run(case, device="cuda")
        ones[tag]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        gc.collect()
        torch.cuda.empty_cache()
    # 28b's CPU reference runs here beside the ranks, from the weights
    # they build on the card (a device's generator draws its own numbers)
    data = _tm_data_case()
    w = tree_map(lambda t: t.cpu(), M.init_params(tmc.config(data), 0,
                                                   device="cuda"))
    torch.cuda.empty_cache()
    # train() itself: its spawn, each rank's whole seeded weights on the
    # card, the mesh's loader, whole-tree checkpoints (rank 0 writing)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_ckpt_")
    smoke = dict(kind="train", batch=TM_CKPT["batch"], seq=TM_CKPT["seq"],
                 steps=TM_STEPS, seed=TM_SEED, data_seed=TM_SEED,
                 keep=False)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            fut = pool.submit(tmc.run, dict(data, params=w), device="cpu")
            t0 = time.perf_counter()
            tr = T.train("llama3_2_1b", TM_CKPT["steps"], seed=TM_SEED,
                         ckpt_dir=ckpt_dir, log_every=TM_CKPT["steps"],
                         device="cuda", mesh_shape=(1, 2),
                         dist_backend="gloo",
                         **{k: TM_CKPT[k] for k in ("batch", "seq",
                                                    "ckpt_every")})
            train_s = time.perf_counter() - t0
            resume = dict(kind="resume", ckpt_dir=ckpt_dir,
                          drop=TM_CKPT["steps"], seed=TM_SEED, **TM_CKPT)
            t0 = time.perf_counter()
            ranks = run_ranks(
                tmc.run_cases, (1, 2), device="cuda", backend="gloo",
                kwargs={"cases": [fp, int_, smoke, resume, data,
                                  dict(data, fsdp=True)]})
            mesh_s = time.perf_counter() - t0
            cpu = fut.result()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    res["data_runs"] = dict(ranks=[r[4:] for r in ranks], cpu=cpu,
                            mesh_s=mesh_s)
    got = [r[0] for r in ranks]
    m0, one = got[0]["metrics"], ones["fp"]["metrics"]
    for r, g in enumerate(got):
        check(g["metrics"] == m0, f"28a rank {r}: metrics differ from rank "
              f"0's: {g['metrics']} / {m0}")
        want = {k: 0 for k in g["launches"]}
        want["flash_prefill"] = L * TM_STEPS
        check(g["launches"] == want, f"28a rank {r}: launches "
              f"{g['launches']}, want {want}")
    loss_e = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
              for a, b in zip(m0, one)]
    gn_e = [abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
            for a, b in zip(m0, one)]
    check(len(m0) == len(one) == TM_STEPS, f"28a: {len(m0)} / {len(one)} "
          f"steps")
    limits = [(TM_LOSS_REL, TM_GNORM_REL) if i < TM_FIXED else
              (TM_UPDATED_LOSS_REL, TM_UPDATED_GNORM_REL)
              for i in range(TM_STEPS)]
    check(all(le <= lim[0] and ge <= lim[1]
              for le, ge, lim in zip(loss_e, gn_e, limits)),
          f"28a: losses {[m['loss'] for m in m0]}, grad_norm "
          f"{[m['grad_norm'] for m in m0]} against one rank's "
          f"{[m['loss'] for m in one]}, {[m['grad_norm'] for m in one]}: "
          f"gaps {loss_e}, {gn_e}, limits {limits}")
    check(all(math.isfinite(m[k]) for m in m0 for k in ("loss",
                                                        "grad_norm")),
          f"28a: non-finite metrics {m0}")
    step_s = sorted(got[0]["step_s"][1:])
    med = step_s[len(step_s) // 2]
    tps = TM_B * TM_S / med
    one_s = sorted(ones["fp"]["step_s"][1:])
    one_tps = TM_B * TM_S / one_s[len(one_s) // 2]
    timed = [g["timed_step"] for g in got]
    log(f"[28a] llama3.2-1B at full width and depth on a (1, 2) mesh (two "
        f"ranks sharing the card over gloo), bf16, flash attention, "
        f"{TM_STEPS} steps of {TM_B} x {TM_S} tokens: losses "
        f"{[round(m['loss'], 5) for m in m0]}, grad_norm "
        f"{[round(m['grad_norm'], 4) for m in m0]}; one rank's on the card: "
        f"losses {[round(m['loss'], 5) for m in one]}, grad_norm "
        f"{[round(m['grad_norm'], 4) for m in one]} (relative gaps "
        f"{[f'{e:.2e}' for e in loss_e]} / {[f'{e:.2e}' for e in gn_e]}, "
        f"limits {limits}); step (host clock, synchronized) "
        f"{[round(1e3 * s, 1) for s in got[0]['step_s']]} ms, "
        f"{tps:.0f} tokens/s (one rank's steps "
        f"{[round(1e3 * s, 1) for s in ones['fp']['step_s']]} ms, "
        f"{one_tps:.0f} tokens/s); "
        f"peak {[round(g['peak_gib'], 2) for g in got]} GiB a rank (one "
        f"rank {ones['fp']['peak_gib']:.2f}); K5 "
        f"{[g['launches']['flash_prefill'] for g in got]} a rank ({L} a "
        f"step); the spawn, both ranks' builds and all their cases (28b's "
        f"too) {mesh_s:.1f} s")
    for r, t in enumerate(timed):
        log(f"    28a rank {r}, one more step with each collective timed "
            f"(the card synchronized around it): {t['calls']} collectives, "
            f"{t['bytes'] / 1e6:.1f} MB handed to them, "
            f"{1e3 * t['seconds']:.1f} ms in them of a "
            f"{1e3 * t['step_s']:.1f} ms step")
    # train()'s run: the case runner's repeat of its first steps, then
    # the resume from its checkpoint
    n = TM_CKPT["steps"]
    for r, rk in enumerate(tr["ranks"]):
        check(rk["losses"] == tr["losses"] and len(rk["losses"]) == n,
              f"28a train() rank {r}: losses {rk['losses']} against rank "
              f"0's {tr['losses']}")
    rep_l = [m["loss"] for m in ranks[0][2]["metrics"]]
    resumed = ranks[0][3]["losses"]
    for r, rk in enumerate(ranks):
        check([m["loss"] for m in rk[2]["metrics"]] == rep_l
              and rk[3]["losses"] == resumed, f"28a rank {r}: the repeat's "
              f"or the resume's losses differ from rank 0's")
    tr_e = _tm_repeat_gap(rep_l, tr["losses"][:TM_STEPS], TM_FIXED)
    redo = tr["losses"][n - len(resumed):]
    # the first resumed step runs on the restored params and data
    ck_e = _tm_repeat_gap(resumed, redo, 1)
    check(tr_e <= TM_UPDATED_LOSS_REL, f"28a: the case runner's repeat "
          f"{rep_l} of train(mesh_shape=(1, 2))'s {tr['losses']}")
    check(0 < len(resumed) < n and ck_e <= TM_UPDATED_LOSS_REL,
          f"28a: resumed {resumed} against train()'s {tr['losses']}")
    log(f"[28a] train('llama3_2_1b', {n}, mesh_shape=(1, 2), "
        f"dist_backend='gloo', ckpt_every={TM_CKPT['ckpt_every']}) of the "
        f"smoke config on the card: losses {tr['losses']} in {train_s:.1f} "
        f"s; the case runner's first {TM_STEPS} on new ranks {rep_l} (the "
        f"first {TM_FIXED} bit-identical, then {tr_e:.2e}, limit "
        f"{TM_UPDATED_LOSS_REL}); with the last commit dropped, resumed "
        f"{resumed} against {redo} (the first bit-identical, then "
        f"{ck_e:.2e})")
    res["full"] = dict(metrics=m0, one_rank=one, loss_rel=loss_e,
                       collectives=timed,
                       grad_norm_rel=gn_e, step_s=got[0]["step_s"],
                       tokens_per_s=tps, one_rank_step_s=ones["fp"]["step_s"],
                       one_rank_tokens_per_s=one_tps,
                       peak_gib=[g["peak_gib"] for g in got],
                       one_rank_peak_gib=ones["fp"]["peak_gib"],
                       launches=[g["launches"] for g in got], mesh_s=mesh_s,
                       train_call=dict(losses=tr["losses"], seconds=train_s,
                                       repeat=rep_l, repeat_rel_err=tr_e,
                                       resumed=resumed, resume_rel_err=ck_e))
    # 28c: one INT step
    got = [r[1] for r in ranks]
    want = _tm_launches_want(ones["int"]["launches"], L)
    loss1 = ones["int"]["metrics"][0]["loss"]
    for r, g in enumerate(got):
        check(g["metrics"][0]["loss"] == loss1, f"28c rank {r}: INT loss "
              f"{g['metrics'][0]['loss']} != one rank's {loss1}")
        check(g["metrics"][0]["grad_norm"] == 0.0, f"28c rank {r}: INT "
              f"grad_norm {g['metrics'][0]['grad_norm']}, not 0")
        check(g["launches"] == want, f"28c rank {r}: launches "
              f"{g['launches']}, want {want}")
    log(f"[28c] one INT step on the (1, 2) mesh: loss {loss1:.6f} "
        f"bit-identical to one rank's, grad_norm 0 (as the reference's); "
        f"launches a rank {{'int8_matmul': {want['int8_matmul']}, "
        f"'int8_matmul_partial': {want['int8_matmul_partial']}, "
        f"'int8_matmul_finish': {want['int8_matmul_finish']}, 'quantize': "
        f"{want['quantize']}, 'flash_prefill': {want['flash_prefill']}}} "
        f"(one rank: K2 {ones['int']['launches']['int8_matmul']}); step "
        f"{1e3 * got[0]['step_s'][0]:.1f} ms (one rank "
        f"{1e3 * ones['int']['step_s'][0]:.1f})")
    res["int"] = dict(loss=loss1, launches=[g["launches"] for g in got],
                      one_rank_launches=ones["int"]["launches"],
                      step_s=got[0]["step_s"],
                      one_rank_step_s=ones["int"]["step_s"])


def _tm_data(torch, res):
    """28b: (2, 1) and FSDP (2, 1), the 2-layer full-width model in fp32,
    TM_DATA_STEPS steps each on the card (the ranks of 28a, two sharing
    the card over gloo) at a rate with no warmup, against the CPU's one
    rank, under phase 26b's rules."""
    runs = res.pop("data_runs")
    ranks, cpu, mesh_s = runs["ranks"], runs["cpu"], runs["mesh_s"]
    cpu_s = cpu["wall_s"]
    want = cpu["metrics"]
    out = {}
    for i, tag in enumerate(("(2, 1)", "FSDP (2, 1)")):
        got = [r[i] for r in ranks]
        ms = got[0]["metrics"]
        for r, g in enumerate(got):
            check(g["metrics"] == ms, f"28b {tag} rank {r}: metrics differ "
                  f"from rank 0's")
        check(len(ms) == len(want) == TM_DATA_STEPS, f"28b {tag}: "
              f"{len(ms)} / {len(want)} steps")
        errs = {}
        for key in ("loss", "grad_norm"):
            errs[key] = [abs(m[key] - w[key]) / abs(w[key])
                         for m, w in zip(ms, want)]
            check(max(errs[key]) <= TRAIN_LOSS_RTOL, f"28b {tag}: {key} "
                  f"card {[m[key] for m in ms]} CPU "
                  f"{[w[key] for w in want]}")
        check([m["lr"] for m in ms] == [w["lr"] for w in want]
              and want[0]["lr"] > 0, f"28b {tag}: lr {[m['lr'] for m in ms]}")
        mom = max(_rel_err(torch, a, b)
                  for k in ("m", "v")
                  for a, b in zip(got[0]["moments"][k], cpu["moments"][k]))
        check(mom <= TRAIN_MOMENT_TOL, f"28b {tag}: moments off by "
              f"{mom:.2e} of a leaf's largest")
        n_fsdp = got[0]["fsdp_leaves"]
        check((n_fsdp > 0) == (i == 1), f"28b {tag}: {n_fsdp} leaves cut "
              f"over data")
        log(f"[28b] {tag}, llama3.2-1B's width cut to {TM_DATA_LAYERS} "
            f"layers (the host-staged gradient traffic: "
            f"{sum(t.numel() for t in cpu['moments']['m']) * 4 / 1e9:.2f} "
            f"GB of "
            f"fp32 gradients a rank a step), fp32, {TM_DATA_STEPS} steps "
            f"of {TRAIN_CPU_BATCH} x {TRAIN_CPU_SEQ} tokens at lr "
            f"{[m['lr'] for m in ms]} (the second step's metrics see the "
            f"first step's update), {n_fsdp} "
            f"leaves FSDP-cut: loss card {[m['loss'] for m in ms]} CPU "
            f"{[w['loss'] for w in want]}, grad_norm card "
            f"{[m['grad_norm'] for m in ms]} CPU "
            f"{[w['grad_norm'] for w in want]} (largest relative gaps "
            f"{max(errs['loss']):.2e} / {max(errs['grad_norm']):.2e}, "
            f"limit {TRAIN_LOSS_RTOL}), the first step's moments within "
            f"{mom:.2e} of a "
            f"leaf's largest (limit {TRAIN_MOMENT_TOL}); steps "
            f"{[round(1e3 * s, 1) for s in got[0]['step_s']]} ms a rank "
            f"(peak {[round(g['peak_gib'], 2) for g in got]} GiB)")
        out[tag] = dict(metrics=ms, rel_err=errs, moment_rel_err=mom,
                        fsdp_leaves=n_fsdp, step_s=got[0]["step_s"],
                        peak_gib=[g["peak_gib"] for g in got])
    log(f"[28b] the CPU's one rank {cpu_s:.1f} s, beside train() and the "
        f"ranks ({mesh_s:.1f} s with 28a's cases)")
    res["data"] = dict(out, cpu=want, cpu_s=cpu_s, mesh_s=mesh_s)


def phase_train_mesh(torch, out):
    t0 = time.perf_counter()
    res = {}
    _tm_full(torch, res)
    gc.collect()
    torch.cuda.empty_cache()
    _tm_data(torch, res)
    res["seconds"] = time.perf_counter() - t0
    log(f"[28] training over a mesh: {res['seconds']:.1f} s")
    out["train_mesh"] = res
    return res


# ---------------------------------------------------------------------------
# phase 29: the MoE family with MLA over a (data, model) mesh
# ---------------------------------------------------------------------------

# 29a: the grouped K2's int32 output kind and its exchanged layout (an (E,
# D) count grid, each expert's C = 128 rows D segments of C / D) at the
# decode shapes one rank sees: (label, E a rank, segments, K, N) of w1 (and
# w3) and w2 on a (1, 2) mesh (half the experts, one segment) and a (2, 1)
# mesh (every expert, half its hidden, two segments)
MM_GK2_SHAPES = (
    ("granite w1 (1, 2)", 24, 1, 1536, 512),
    ("granite w2 (1, 2)", 24, 1, 512, 1536),
    ("granite w1 (2, 1)", 48, 2, 1536, 256),
    ("granite w2 (2, 1)", 48, 2, 256, 1536),
    ("deepseek w1 (1, 2)", 128, 1, 7168, 2048),
    ("deepseek w2 (1, 2)", 128, 1, 2048, 7168),
    ("deepseek w1 (2, 1)", 256, 2, 7168, 1024),
    ("deepseek w2 (2, 1)", 256, 2, 1024, 7168))
MM_CAP = 128
# 29b's depth: 8 of granite-moe-3b's 32 layers (the script's time; 16
# until phase 30)
MM_GRANITE_LAYERS = 8
# 29b / 29c: bf16 FP on the mesh sums each row-cut module's fp32 partials
# and rounds once, where one rank's bf16 product rounds its own fp32 sum:
# the last bits part, an expert's routing near-tie flips, and one rank's
# tokens part from the mesh's (measured: granite's 32 layers agree on no
# token, deepseek-v3's 4 layers on 92%; one rank with only those sums
# taken in the mesh's order parts from one rank by the same amounts).  So
# the mesh is held to one rank with its row-cut sums in the mesh's order
# (``tests/moe_mesh_cases.py::split_sums``): tokens identical, every
# step's logits within this share of the largest |logit|
MM_FP_REL = 1e-2
# and in fp32 on MM_FP32_LAYERS of granite's layers: tokens identical,
# every step's logits within MM_FP32_REL of the largest |logit|
MM_FP32_LAYERS, MM_FP32_REL = 4, 1e-4
# 29d: granite at full width, 2 MoE layers in fp32, each alone on a (2, 1)
# mesh (its hidden cut over data) over MM_LAYER_B x MM_LAYER_S tokens whose
# capacity expert 0 overflows (its router column raised by MM_SKEW): the
# card's ranks against the CPU's one-process ``data_shards=2`` form; FP
# within MM_LAYER_FP_REL of the largest |output|
MM_LAYER_B, MM_LAYER_S, MM_SKEW, MM_LAYER_FP_REL = 4, 80, 5.0, 1e-4


def _mm_counts(torch, gen, e, segs, stride, kind, tokens, e_real):
    """An (E,) or (E, segs) int32 count grid on the card: ``decode``, each
    segment's ``tokens`` tokens routing top-8 among the ``e_real`` real
    experts (the padding experts none); ``random`` in [0, stride]; ``full``
    every segment full."""
    if kind == "decode":
        c = torch.stack([_decode_counts(torch, gen, e_real, e, tokens, 8)
                         for _ in range(segs)], dim=1)
    elif kind == "full":
        c = torch.full((e, segs), stride, dtype=torch.int32, device="cuda")
    else:
        c = torch.randint(0, stride + 1, (e, segs), generator=gen).to(
            torch.int32).cuda()
    return c if segs > 1 else c[:, 0].contiguous()


def _mm_gk2_run(torch, x, w, counts, rows_cap, kind):
    """The form under test: ``int32`` the int32 sums, ``bf16`` the
    float epilogue's values."""
    from repro_torch.core.integer_ops import LinearQuantSpec
    from repro_torch.kernels import ops
    if kind == "int32":
        return ops.int8_matmul_grouped_partial(x, w, counts,
                                               rows_cap=rows_cap)
    return ops.int8_matmul_grouped(x, w, counts,
                                   LinearQuantSpec(n_x=4, n_w=8, n_b=8,
                                                   n_o=4),
                                   rows_cap=rows_cap,
                                   out_float=torch.bfloat16)


def _mm_gk2_plain(torch, x, w, counts, rows_cap, kind, group=8):
    """The plain versions over the experts with live rows, a few at a time
    (a deepseek stack's float64 product whole would take 30 GB); returns
    [(experts, their live-row mask (n, C), their outputs)]."""
    from repro_torch.core.integer_ops import LinearQuantSpec
    from repro_torch.kernels import ref
    spec = LinearQuantSpec(n_x=4, n_w=8, n_b=8, n_o=4)
    grid = counts.reshape(counts.shape[0], -1)
    live = [int(i) for i in torch.nonzero(
        torch.clamp(grid, max=rows_cap).sum(dim=1) > 0).flatten().tolist()]
    parts = []
    for i in range(0, len(live), group):
        sel = torch.tensor(live[i:i + group], device="cuda")
        xs, ws, cs = (x.index_select(0, sel), w.index_select(0, sel),
                      counts.index_select(0, sel))
        if kind == "int32":
            o = ref.int8_matmul_grouped_partial_ref(xs, ws, cs,
                                                    rows_cap=rows_cap)
        else:
            o = ref.int8_matmul_grouped_ref(
                xs, ws, cs, rows_cap=rows_cap, shift=spec.requant_shift,
                out_dtype=torch.bfloat16, n_o=spec.n_o)
        parts.append((sel, ref._grouped_live(cs, x.shape[1], rows_cap), o))
    return parts


def _mm_gk2_held(torch, x, w, counts, rows_cap, kind, what) -> float:
    """The kernel against its plain version on every live row, bit for
    bit; returns the largest difference (0)."""
    got = _mm_gk2_run(torch, x, w, counts, rows_cap, kind)
    check(got.shape == (x.shape[0], x.shape[1], w.shape[2])
          and got.dtype == (torch.int32 if kind == "int32"
                            else torch.bfloat16),
          f"{what}: output {got.dtype} {tuple(got.shape)}")
    diff = 0.0
    for sel, live, o in _mm_gk2_plain(torch, x, w, counts, rows_cap, kind):
        g = got.index_select(0, sel)
        d = (g.double() - o.double()).abs()
        diff = max(diff, float(d[live].max()) if bool(live.any()) else 0.0)
    check(diff == 0, f"{what}: kernel != plain by {diff}")
    return diff


def _mm_gk2(torch, res):
    """29a: the int32 kind and the exchanged layout against their plain
    versions, bit for bit, at the decode shapes of both meshes (counts a
    decode step's, random and full, rows_cap the step's and the segment),
    then each shape timed at a decode step's counts in the form the path
    launches (w1 / w3 the bf16 epilogue, w2 the int32 kind where the
    hidden is cut): the kernel, the plain version, ``torch._int_mm`` looped
    over the live (expert, segment) pairs (the int32 products alone) and
    the bound."""
    gen = torch.Generator()
    gen.manual_seed(29)
    n_checks, err, timed = 0, 0.0, []
    for label, e, segs, k, n in MM_GK2_SHAPES:
        stride = MM_CAP // segs
        tokens = SERVE_BATCH // segs
        # the tokens route among the rank's experts (granite's (2, 1)
        # rank holds all 48, the last 8 padding)
        e_real = 40 if e == 48 else e
        x = torch.randint(-128, 128, (e, MM_CAP, k), device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (e, k, n), device="cuda",
                          dtype=torch.int8)
        kinds = ("decode", "random") if e >= 128 else ("decode", "random",
                                                        "full")
        for ck in kinds:
            counts = _mm_counts(torch, gen, e, segs, stride, ck, tokens,
                                e_real)
            for rows_cap in sorted({stride, min(stride, tokens)}):
                for kind in ("int32", "bf16"):
                    err = max(err, _mm_gk2_held(
                        torch, x, w, counts, rows_cap, kind,
                        f"29a {label} counts {ck} rows_cap {rows_cap} "
                        f"{kind}"))
                    n_checks += 1
        # timed at a decode step's counts, in the path's form
        kind = "int32" if segs > 1 and "w2" in label else "bf16"
        counts = _mm_counts(torch, gen, e, segs, stride, "decode", tokens,
                            e_real)
        rows_cap = min(stride, tokens)
        copies = max(1, math.ceil(128e6 / (e * k * n)))      # beat the L2
        ws = [w] + [torch.randint(-128, 128, (e, k, n), device="cuda",
                                  dtype=torch.int8)
                    for _ in range(copies - 1)]
        it = [0]

        def kernel():
            it[0] += 1
            _mm_gk2_run(torch, x, ws[it[0] % copies], counts, rows_cap,
                        kind)

        grid = counts.reshape(e, -1)
        pairs = [(int(i), int(s)) for i, s in
                 torch.nonzero(grid > 0).tolist()]

        def library():
            it[0] += 1
            wl = ws[it[0] % copies]
            for i, s in pairs:
                torch._int_mm(x[i, s * stride:(s + 1) * stride], wl[i])

        ms = time_ms(torch, kernel, 20)
        lib_ms = time_ms(torch, library, 10)
        plain_ms = time_ms(torch, lambda: _mm_gk2_plain(
            torch, x, w, counts, rows_cap, kind), 2, warmup=1)
        rows = int(torch.clamp(grid, max=rows_cap).sum())
        active = len({i for i, _ in pairs})
        out_b = 4 if kind == "int32" else 2
        n_bytes = active * k * n + rows * k + out_b * rows * n
        b_ms, b_by = bound_ms(n_bytes, 2 * rows * k * n, "int8")
        timed.append(dict(shape=label, e=e, segments=segs, c=MM_CAP, k=k,
                          n=n, kind=kind, tokens=tokens, rows_cap=rows_cap,
                          active=active, rows=rows, ms=ms, plain_ms=plain_ms,
                          library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        log(f"    29a {label} (E {e}, {segs} segment(s) of {stride}, K {k}, "
            f"N {n}), {kind}, {tokens} tokens a shard top-8: {active} "
            f"active experts, {rows} rows | kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, _int_mm x {len(pairs)} {lib_ms:.4f} ms, "
            f"bound {b_ms:.5f} ms ({b_by}, {n_bytes / 1e6:.1f} MB)")
        del x, w, ws
        torch.cuda.empty_cache()
    log(f"[29a] grouped K2's int32 kind and exchanged layout bit-exact "
        f"against their plain versions in {n_checks} cases ("
        f"{len(MM_GK2_SHAPES)} decode shapes of (1, 2) and (2, 1) x counts "
        f"decode / random / full x rows_cap the step's and the segment's x "
        f"int32 sums and bf16 values)")
    res["k2"] = dict(checks=n_checks, max_abs_err=err, timed=timed)


def _mm_want(cfg, mode, model_axis: int, gen=SERVE_GEN) -> dict:
    """One rank's launches of a classic ``serve`` on a (1, M) mesh (the
    calibration, whole on rank 0 before the cut, outside them): a forward
    as one rank's (``_moe_forward_launches``), and each row-cut module --
    attention's wo, a dense MLP's and a shared expert's w2 -- a partial
    and a finish in K2's place; the grouped K2 three times a MoE layer
    (over the rank's experts, one segment: no data cut); K5 once a GQA
    layer in the prefill, K6 once a GQA layer a decode step (MLA's are
    absorbed)."""
    k2, k3, grouped = _moe_forward_launches(cfg, mode, cfg.kv_cache_bits
                                            == 8)
    nd = cfg.moe.n_dense_layers
    row_cut = 0
    if model_axis > 1 and mode == "int":
        row_cut = cfg.n_layers + nd + (cfg.n_layers - nd) * int(
            cfg.moe.n_shared > 0)
    gqa = 0 if cfg.mla is not None else cfg.n_layers
    return {"int8_matmul": (k2 + row_cut) * gen,
            "int8_matmul_partial": row_cut * gen,
            "int8_matmul_finish": row_cut * gen,
            "int8_matmul_grouped": grouped * gen,
            "int8_matmul_grouped_partial": 0,
            "int8_matmul_grouped_segments": 0,
            "quantize": k3 * gen, "flash_prefill": gqa,
            "flash_decode": gqa * (gen - 1)}


def _mm_serve_cases(torch, arch, overrides, fp32_layers=0):
    """29b / 29c's cases (classic ``serve`` at full width, bf16, flash
    attention, FP and calibrated INT; with ``fp32_layers`` FP in fp32 on
    that many layers) and their one-rank eager runs here, bf16 FP also
    with its row-cut sums in the mesh's order: (cfg, cases, one-rank
    results)."""
    from repro_torch.configs import get_config
    sys.path.insert(0, str(ROOT / "tests"))
    import moe_mesh_cases as mmc
    cfg = dataclasses.replace(get_config(arch), **overrides)
    base = dict(kind="serve", arch=arch, smoke=False, batch=SERVE_BATCH,
                prompt_len=SERVE_PROMPT, gen=SERVE_GEN, attn_kernel="flash",
                cfg_overrides=overrides)
    cases = {"fp": dict(base, mode="fp", calibrate=False),
             "int": dict(base, mode="int", calibrate=True)}
    # bf16 FP's yardstick: one rank with its row-cut sums in the mesh's
    # order (``MM_FP_REL``); one rank as it runs alone beside it, both
    # keeping every router call's choices (``_route_flips``)
    ones = {"fp split": mmc.run(dict(cases["fp"], split_sums=2, routes=True),
                                device="cuda")}
    if fp32_layers:
        cases["fp32"] = dict(base, mode="fp", calibrate=False,
                             cfg_overrides=dict(overrides, dtype="float32",
                                                n_layers=fp32_layers))
    for mode, case in cases.items():
        ones[mode] = mmc.run(dict(case, routes=mode == "fp"), device="cuda")
        gc.collect()
        torch.cuda.empty_cache()
    return cfg, cases, ones


def _route_flips(torch, alone, split, n_moe: int) -> dict:
    """Where one rank alone and one rank with the mesh's row-cut sums
    first route a token differently: their router calls in order (a
    forward's MoE layers, then the next forward's), a (token, layer)
    choice flipped where its top-k sets differ.  Returns the prefill's
    flips by layer (of its T tokens), the first flip (forward, layer,
    tokens) and, there, the flipped tokens' largest relative margin
    between the k-th and (k+1)-th probabilities in either run beside the
    share of that layer's tokens with a margin as small (a near-tie
    flips where that share is small)."""
    a, b = alone["routes"], split["routes"]
    check(len(a) == len(b) and len(a) % n_moe == 0,
          f"route calls {len(a)} / {len(b)} over {n_moe} MoE layers")
    flips = []
    for (ea, _), (eb, _) in zip(a, b):
        flips.append((ea.sort(dim=1).values != eb.sort(dim=1).values
                      ).any(dim=1))
    out = {"tokens": int(a[0][0].shape[0]),
           "prefill_by_layer": [int(f.sum()) for f in flips[:n_moe]],
           "first": None}
    for i, f in enumerate(flips):
        if not bool(f.any()):
            continue
        margin = torch.maximum(a[i][1][f].max(), b[i][1][f].max())
        share = float((torch.minimum(a[i][1], b[i][1]) <= margin)
                      .float().mean())
        out["first"] = dict(forward=i // n_moe, layer=i % n_moe,
                            flipped=int(f.sum()), of=int(f.numel()),
                            margin=float(margin), share_as_near=share)
        break
    return out


def _mm_serve(torch, res, tag, arch, cfg, cases, ones, ranks):
    """29b / 29c: the cases of ``_mm_serve_cases`` on a (1, 2) mesh of two
    ranks sharing the card over gloo (``ranks``: each rank's results, in
    the cases' order) against their one-rank runs ``ones``: tokens
    identical; INT every step's logits bit for bit, bf16 FP within
    ``MM_FP_REL`` of one rank with the mesh's row-cut sums, fp32 FP within
    ``MM_FP32_REL`` of one rank; each rank's launches by ``_mm_want``;
    decode tokens/s and peak memory a rank (the ranks build the whole
    model one at a time, rank 0 calibrating it, and keep their
    slices)."""
    import numpy as np
    out = {}
    for i, mode in enumerate(cases):
        one, got = ones[mode], [r[i] for r in ranks]
        alone = None
        if mode == "fp":
            alone, one = one, ones["fp split"]
        want = _mm_want(dataclasses.replace(cfg, **cases[mode][
            "cfg_overrides"]), "fp" if mode == "fp32" else mode, 2)
        scale = max(float(t.abs().max()) for t in one["logits"])
        errs = []
        agree = float(np.mean(got[0]["tokens"] == one["tokens"]))
        for r, g in enumerate(got):
            check(np.array_equal(g["tokens"], got[0]["tokens"]),
                  f"{tag} {mode} rank {r}: the ranks' tokens differ")
            check(len(g["logits"]) == len(one["logits"]) == SERVE_GEN,
                  f"{tag} {mode} rank {r}: {len(g['logits'])} steps' logits")
            for step, (a, b) in enumerate(zip(g["logits"], one["logits"])):
                check(bool(torch.isfinite(a).all()),
                      f"{tag} {mode} rank {r} step {step}: non-finite")
                e_ = float((a - b).abs().max())
                errs.append(e_)
                if mode == "int":
                    check(torch.equal(a, b), f"{tag} {mode} rank {r} step "
                          f"{step}: logits != one rank's (max |diff| {e_})")
            if mode == "int":
                check(agree == 1.0, f"{tag} {mode}: tokens differ from one "
                      f"rank's (agreement {agree})")
            else:
                rel = MM_FP_REL if mode == "fp" else MM_FP32_REL
                check(agree == 1.0, f"{tag} {mode}: tokens differ from one "
                      f"rank's (agreement {agree})")
                check(max(errs) <= rel * scale, f"{tag} {mode} rank {r}: "
                      f"logits {max(errs)} apart, over {rel} x {scale}")
            have = {k: g["launches"][k] for k in want}
            check(have == want, f"{tag} {mode} rank {r}: launches {have}, "
                  f"want {want}")
            check(g["table"] == one["table"],
                  f"{tag} {mode} rank {r}: calibrated table != one rank's")
        if alone is not None:       # the yardstick's run; one rank alone
            one_tps = SERVE_BATCH / alone["decode_s_per_tok"]
            alone_agree = float(np.mean(got[0]["tokens"] == alone["tokens"]))
            alone_errs = [float((a - b).abs().max()) for a, b in
                          zip(got[0]["logits"], alone["logits"])]
            flips = _route_flips(torch, alone, one, cfg.n_layers
                                 - cfg.moe.n_dense_layers)
            one = dict(one, peak_gib=alone["peak_gib"],
                       prefill_s=alone["prefill_s"],
                       decode_s_per_tok=alone["decode_s_per_tok"],
                       wall_s=alone["wall_s"])
        tps = SERVE_BATCH / got[0]["decode_s_per_tok"]
        one_tps = SERVE_BATCH / one["decode_s_per_tok"]
        peaks = [g["peak_gib"] for g in got]
        log(f"[{tag}] {arch} ({cfg.n_layers} layers) {mode}: ranks "
            f"token-identical; against one rank"
            + (" with the mesh's row-cut sums" if alone is not None else "")
            + f" tokens agree {agree:.4f}, "
            + ("every step's logits bit-identical" if mode == "int" else
               f"logits apart by {[round(e_, 5) for e_ in errs[:SERVE_GEN]]}"
               f" a step (|logit| up to {scale:.4g})")
            + ("" if alone is None else
               f"; against one rank alone tokens agree {alone_agree:.4f}, "
               f"logits apart by {[round(e_, 5) for e_ in alone_errs]}; "
               f"routing against one rank alone: prefill (token, layer) "
               f"choices flipped by layer {flips['prefill_by_layer']} of "
               f"{flips['tokens']} tokens a layer, first flip {flips['first']}")
            + f"; decode {1e3 * got[0]['decode_s_per_tok']:.1f} ms a step, "
            f"{tps:.2f} tokens/s on 2 ranks sharing one card over gloo "
            f"(one rank eager {1e3 * one['decode_s_per_tok']:.1f} ms, "
            f"{one_tps:.2f}); prefill {got[0]['prefill_s']:.3f} s (one rank "
            f"{one['prefill_s']:.3f}); calibration {got[0]['calibrate_s']:.2f}"
            f" s on rank 0; peak {peaks[0]:.2f} / {peaks[1]:.2f} GiB a rank "
            f"(one rank {one['peak_gib']:.2f}); rank 0 launches "
            f"{ {k: v for k, v in got[0]['launches'].items() if v} }")
        out[mode] = dict(agree=agree, logits_max_abs_diff=errs[:SERVE_GEN],
                         logits_scale=scale,
                         **({} if alone is None else dict(
                             one_rank_alone_agree=alone_agree,
                             one_rank_alone_logits_diff=alone_errs,
                             route_flips=flips)),
                         tokens_per_s=tps, one_rank_tokens_per_s=one_tps,
                         decode_s_per_tok=got[0]["decode_s_per_tok"],
                         one_rank_decode_s_per_tok=one["decode_s_per_tok"],
                         prefill_s=got[0]["prefill_s"],
                         calibrate_s=got[0]["calibrate_s"],
                         peak_gib=peaks, one_rank_peak_gib=one["peak_gib"],
                         launches=[g["launches"] for g in got],
                         wall_s=[g["wall_s"] for g in got],
                         one_rank_wall_s=one["wall_s"])
    res[tag] = out


def _mm_layer_cases(torch):
    """29d's cases: granite at full width, its 2 MoE layers in fp32, each
    alone (FP and INT) over MM_LAYER_B x MM_LAYER_S tokens whose capacity
    expert 0 overflows (its router column raised by MM_SKEW), on a (2, 1)
    mesh; and each layer's dropped pairs."""
    from repro_torch.configs import get_config
    from repro_torch.models import mlp as tmlp
    from repro_torch.models import model as M
    over = {"n_layers": 2, "dtype": "float32"}
    cfg = dataclasses.replace(get_config("granite_moe_3b_a800m"), **over)
    params = M.init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(29)
    x = torch.randn((MM_LAYER_B, MM_LAYER_S, cfg.d_model), generator=gen)
    cases, drops = [], []
    for layer in range(cfg.n_layers):
        p = {k: v for k, v in params["blocks"][layer]["moe"].items()}
        p["router"] = p["router"].clone()
        p["router"][:, 0] += MM_SKEW
        t = MM_LAYER_B * MM_LAYER_S
        _, top_e = tmlp.route(x.reshape(t, -1), p["router"], cfg.moe.top_k)
        cap_l = -(-tmlp.moe_capacity(t, cfg.moe) // 2)
        _, keep, _ = tmlp.rank_pairs(top_e.reshape(2, -1), cfg.moe.e_padded,
                                     cap_l)
        drops.append(int((~keep).sum()))
        check(drops[-1] > 0, f"29d layer {layer}: no pair overflows")
        for mode in ("fp", "int"):
            cases.append(dict(kind="layer", arch="granite_moe_3b_a800m",
                              smoke=False, mode=mode, p=p, x=x,
                              cfg_overrides=over, model_axis=1))
    return cases, drops


def _mm_layer(torch, res, cases, drops, ranks):
    """29d: ``_mm_layer_cases`` on the ranks as a (2, 1) mesh sharing the
    card (every expert on each, its hidden cut over data: the token rows
    exchanged, w2's sums added over data, INT through the int32 kind and
    the exchanged layout; ``ranks`` each rank's results) against the
    CPU's one-process ``data_shards=2`` form: INT identical, FP within
    ``MM_LAYER_FP_REL`` of the largest |output|; each rank's launches a
    layer."""
    sys.path.insert(0, str(ROOT / "tests"))
    import moe_mesh_cases as mmc
    t0 = time.perf_counter()
    cpu = [mmc.run(dict(c, data_shards=2), device="cpu") for c in cases]
    cpu_s = time.perf_counter() - t0
    want = {"fp": dict.fromkeys(("int8_matmul_grouped",
                                 "int8_matmul_grouped_partial",
                                 "int8_matmul_grouped_segments",
                                 "int8_matmul_finish", "quantize"), 0),
            # K3: the token rows (one grid), the hidden buffer, and the
            # three float expert stacks' slices quantized in the call
            "int": {"int8_matmul_grouped": 3,
                    "int8_matmul_grouped_partial": 1,
                    "int8_matmul_grouped_segments": 3,
                    "int8_matmul_finish": 1, "quantize": 5}}
    errs = {"fp": 0.0, "int": 0.0}
    launches = []
    for i, c in enumerate(cases):
        ref_out = cpu[i]["out"]
        scale = float(ref_out.abs().max())
        for r, rk in enumerate(ranks):
            got = rk[i]
            e_ = float((got["out"] - ref_out).abs().max())
            errs[c["mode"]] = max(errs[c["mode"]], e_ / scale)
            if c["mode"] == "int":
                check(torch.equal(got["out"], ref_out),
                      f"29d case {i} rank {r}: INT layer != the CPU's "
                      f"(max |diff| {e_})")
            else:
                check(e_ <= MM_LAYER_FP_REL * scale,
                      f"29d case {i} rank {r}: FP layer {e_} from the CPU's, "
                      f"over {MM_LAYER_FP_REL} x {scale}")
            have = {k: got["launches"][k] for k in want[c["mode"]]}
            check(have == want[c["mode"]], f"29d case {i} rank {r}: "
                  f"launches {have}, want {want[c['mode']]}")
            launches.append(have)
    log(f"[29d] granite at full width, 2 MoE layers in fp32 on a (2, 1) "
        f"mesh, {MM_LAYER_B} x {MM_LAYER_S} tokens, expert 0 overflowing "
        f"(drops {drops} pairs a layer): the card's ranks against the CPU's "
        f"data_shards=2 form, INT identical, FP within "
        f"{errs['fp']:.3g} of the largest |output|; a rank's INT layer "
        f"launches {want['int']}; CPU {cpu_s:.1f} s")
    res["29d"] = dict(drops=drops, fp_rel_err=errs["fp"], cpu_s=cpu_s,
                      launches=launches, int_layer_launches=want["int"])


def phase_moe_mesh(torch, out):
    """Phase 29: the MoE family with MLA over a (data, model) mesh -- (a)
    the grouped K2's int32 kind and exchanged layout, (b) granite-moe-3b
    on MM_GRANITE_LAYERS and (c) deepseek-v3 on 4 layers through classic
    ``serve`` on (1, 2), (d) the per-shard dispatch under overflow on (2,
    1), card against CPU."""
    t0 = time.perf_counter()
    res = {"part_s": {}}
    # what this process still holds on the card when the ranks come
    log(f"[29] this process: {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
        f"reserved")
    from repro_torch.launch.mesh import run_ranks
    sys.path.insert(0, str(ROOT / "tests"))
    import moe_mesh_cases as mmc

    def part(name, fn, *args, **kwargs):
        t1 = time.perf_counter()
        got = fn(*args, **kwargs)
        gc.collect()
        torch.cuda.empty_cache()
        res["part_s"][name] = time.perf_counter() - t1
        return got

    part("a", _mm_gk2, torch, res)
    # the one-rank runs here, then every case of b, c and d on one spawn
    # of two ranks: (1, 2) for b and c, (2, 1) over the same ranks for d
    b = part("b one rank", _mm_serve_cases, torch, "granite_moe_3b_a800m",
             {"kv_cache_bits": 8, "n_layers": MM_GRANITE_LAYERS},
             MM_FP32_LAYERS)
    c = part("c one rank", _mm_serve_cases, torch, "deepseek_v3_671b",
             {"n_layers": 4})
    d_cases, drops = _mm_layer_cases(torch)
    nb, nc = len(b[1]), len(c[1])
    ranks = part("ranks", run_ranks, mmc.run_cases, (1, 2), device="cuda",
                 backend="gloo", kwargs={"cases": list(b[1].values())
                                         + list(c[1].values()) + d_cases})
    log(f"[29] the ranks: {res['part_s']['ranks']:.1f} s, spawned once, "
        f"the model built whole on each in turn and cut, every run of b, "
        f"c and d")
    _mm_serve(torch, res, "29b", "granite_moe_3b_a800m", *b,
              [r[:nb] for r in ranks])
    _mm_serve(torch, res, "29c", "deepseek_v3_671b", *c,
              [r[nb:nb + nc] for r in ranks])
    part("d CPU", _mm_layer, torch, res, d_cases, drops,
         [r[nb + nc:] for r in ranks])
    res["seconds"] = time.perf_counter() - t0
    log(f"[29] moe over a mesh {res['seconds']:.1f} s (parts "
        f"{ {k: round(v, 1) for k, v in res['part_s'].items()} })")
    out["moe_mesh"] = res
    return res


# ---------------------------------------------------------------------------
# phase 30: training every family on one card, and the example twins
# ---------------------------------------------------------------------------

# 30a: each family at full width, cut in depth (``_fam_cuts``), fp32, one
# train step (``build_train_step`` at its defaults: remat=True) of
# FAM_CPU_BATCH x FAM_CPU_SEQ tokens on the card, its loss and gradient
# norm against the CPU's from the same weights within phase 26b's
# TRAIN_LOSS_RTOL
FAM_CPU_BATCH, FAM_CPU_SEQ = 1, 32
# 30b: ``train()`` at full width, bf16, flash attention, FAM_STEPS steps
# of FAM_B x FAM_S tokens (whisper with 1500 stub frames a row) at a peak
# rate of FAM_LR (train()'s default 3e-3 sent rwkv6-3b's loss from 11.5
# to 20.5 in one update); the first updates move the bf16 weights by
# sign-like steps and the loss swings (whisper 10.8, 11.1, 12.3, 7.5), so
# it is held to fall over the run
FAM_B, FAM_S, FAM_STEPS, FAM_LR = 4, 128, 5, 3e-4
FAM_TRAINED = ("granite_moe_3b_a800m", "whisper_large_v3", "rwkv6_3b",
               "zamba2_2_7b")
# K5 under autograd at the shapes the training path gives it that phase
# 26a does not run: whisper's encoder (non-causal) and MLA's expanded
# form (Dk != Dv): (name, B, Sq, Skv, H, KVH, Dk, Dv, causal)
FAM_K5_CASES = (
    ("whisper encoder, non-causal", FAM_B, WHISPER_FRAMES, WHISPER_FRAMES,
     WHISPER_HEADS, WHISPER_HEADS, WHISPER_DIM, WHISPER_DIM, False),
    ("MLA expanded, Dk 192 != Dv 128", FAM_B, FAM_S, FAM_S, 128, 128, 192,
     128, True))
TWIN_DIR = ROOT / "build" / "twins"


def _fam_cuts():
    """30a's configurations, fp32, flash attention: granite-moe-3b and
    rwkv6-3b on 2 layers, deepseek-v3 on its first layer (dense, MLA:
    one of its MoE layers holds 256 x 3 x 7168 x 2048 = 11.3 B expert
    parameters, 45 GB in fp32 before gradients and moments), whisper on
    2 + 2 layers over its 1500 frames, zamba2 on one group (6 Mamba
    blocks and the shared block)."""
    from repro_torch.configs import get_config
    cuts = {"granite_moe_3b_a800m": dict(n_layers=2),
            "deepseek_v3_671b": dict(n_layers=1),
            "whisper_large_v3": dict(n_layers=2),
            "rwkv6_3b": dict(n_layers=2),
            "zamba2_2_7b": dict(n_layers=get_config("zamba2_2_7b")
                                .hybrid.attn_every)}
    out = {}
    for arch, kw in cuts.items():
        cfg = get_config(arch)
        if cfg.moe is not None and arch == "deepseek_v3_671b":
            kw["moe"] = dataclasses.replace(cfg.moe, n_dense_layers=1)
        if cfg.encdec is not None:
            kw["encdec"] = dataclasses.replace(cfg.encdec,
                                               n_encoder_layers=2)
        out[arch] = dataclasses.replace(cfg, dtype="float32",
                                        attn_kernel="flash", **kw)
    return out


def _opt_name(opt) -> str:
    """'adamw' or 'adafactor': the function that built ``opt``."""
    return opt.init.__qualname__.split(".")[0]


def _fam_batch(cfg, b, s, seed=0):
    """One batch of the synthetic stream (the audio family's with its
    stub ``encoder_features``), numpy."""
    from repro_torch.data import SyntheticLMStream
    audio = cfg.family == "audio"
    return SyntheticLMStream(
        cfg.vocab_size, s, b, seed=seed,
        encoder_seq=cfg.encdec.encoder_seq if audio else None,
        d_model=cfg.d_model if audio else None).batch(0)


def _fam_k5_case(torch, gen, case):
    """K5 under autograd at one training shape: the kernel's output and
    the recompute's gradients against the plain version's forward and
    autograd (gradients within TRAIN_GRAD_TOL of their largest), then
    the forward, the recompute backward, SDPA's forward and forward +
    backward timed, beside the forward's and the backward's bounds (26a's
    formula: the backward reads q, k, v, dO and writes dq, dk, dv, 2.5x
    the forward's products)."""
    from repro_torch.kernels import ops, ref
    name, b, sq, skv, h, kvh, dk, dv, causal = case
    dt = torch.bfloat16
    q = torch.randn((b, sq, h, dk), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, skv, kvh, dk), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, skv, kvh, dv), generator=gen, device="cuda").to(dt)
    g = torch.randn((b, sq, h, dv), generator=gen, device="cuda").to(dt)
    got_in = [t.clone().requires_grad_() for t in (q, k, v)]
    want_in = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*got_in, causal=causal)
    got = torch.autograd.grad(out, got_in, g, retain_graph=True)
    want_out = ref.flash_attention_ref(*want_in, causal=causal)
    want = torch.autograd.grad(want_out, want_in, g)
    torch.cuda.synchronize()
    err = _close_rows(torch, out.detach(), want_out.detach(), 2e-2,
                      f"K5 train {name}")
    grad_err = 0.0
    for gname, a, w in zip(("dq", "dk", "dv"), got, want):
        check(a.dtype == w.dtype and a.shape == w.shape,
              f"K5 train {name}: {gname} {a.dtype} {tuple(a.shape)}")
        e = _rel_err(torch, a, w)
        check(e <= TRAIN_GRAD_TOL, f"K5 train {name}: {gname} off the "
              f"plain version's by {e:.2e} of its largest value")
        grad_err = max(grad_err, float((a.float() - w.float()).abs().max()))
    sdpa, sdpa_how = _sdpa(torch)
    with torch.no_grad():
        fwd_ms = time_ms(torch, lambda: ops.flash_attention(
            q, k, v, causal=causal), 20)
        lib_ms = time_ms(torch, lambda: sdpa(q, k, v, causal), 20)
    bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        out, got_in, g, retain_graph=True), 5, warmup=1)
    sins = [t.clone().requires_grad_() for t in (q, k, v)]

    def sdpa_train():
        o = sdpa(*sins, causal).transpose(1, 2)
        return torch.autograd.grad(o, sins, g)
    lib_train_ms = time_ms(torch, sdpa_train, 5, warmup=1)
    pairs = (sum(i + 1 for i in range(sq)) if causal else sq * skv)
    n_ops = b * h * 2 * (dk + dv) * pairs
    n_bytes = 2 * (q.numel() + k.numel() + v.numel() + g.numel())
    b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
    bwd_bytes = 2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                     + g.numel())
    bb_ms, bb_by = bound_ms(bwd_bytes, 2.5 * n_ops, "bfloat16")
    log(f"[30a] K5 under autograd, {name} (B {b}, Sq {sq}, Skv {skv}, H "
        f"{h}, KVH {kvh}, Dk {dk}, Dv {dv}, bf16): output rows within 2e-2 "
        f"(max |diff| {err:.2e}), dq / dk / dv within {TRAIN_GRAD_TOL} of "
        f"their largest (max |diff| {grad_err:.2e}); forward {fwd_ms:.4f} "
        f"ms (bound {b_ms:.5f} ms, {b_by}), recompute backward "
        f"{bwd_ms:.4f} ms (bound {bb_ms:.5f} ms, {bb_by}); SDPA "
        f"({sdpa_how}) forward {lib_ms:.4f} ms, forward + backward "
        f"{lib_train_ms:.4f} ms against K5 + recompute "
        f"{fwd_ms + bwd_ms:.4f} ms")
    return dict(name=name, max_abs_err=err, grad_max_abs_err=grad_err,
                ms=fwd_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                backward_ms=bwd_ms, backward_bound_ms=bb_ms,
                backward_bound_by=bb_by, library_train_ms=lib_train_ms,
                sdpa=sdpa_how)


def _fam_cpu_grads(cfg, params, batch):
    """30a's CPU side of one family: the loss and the gradients' norm
    (``loss_and_grads`` without remat, whose values remat leaves alone,
    and ``clip_by_global_norm``: the step's first two parts, without the
    CPU's update of every parameter), and its seconds."""
    import torch
    from repro_torch.core.qmodel import QuantContext
    from repro_torch.core.tree import unflatten
    from repro_torch.launch import steps as S
    from repro_torch.optim import clip_by_global_norm
    t0 = time.perf_counter()
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _, grads = S.loss_and_grads(params, b, cfg, QuantContext())
    _, gnorm = clip_by_global_norm(unflatten(params, grads), 1.0)
    return dict(loss=float(loss), grad_norm=float(gnorm),
                s=time.perf_counter() - t0)


def _fam_card_vs_cpu(torch, res):
    """30a on the card: each family's cut configuration, one train step
    (``build_train_step`` at its defaults, a fresh optimizer state) from
    the weights a copy of which goes to the CPU's side
    (``_fam_cpu_grads``, compared by ``_fam_card_vs_cpu_check``); zamba2's
    gradients with ``remat='full'`` and without, equal.  The CPU sides
    are queued on the background thread once every card step has run, so
    that none runs beside them: returns their futures."""
    from repro_torch.core.qmodel import QuantContext
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.optim import warmup_cosine
    out = res["card_vs_cpu"] = {}
    cpu_args = {}
    for arch, cfg in _fam_cuts().items():
        params = M.init_params(cfg, 0, device="cuda")
        batch = _fam_batch(cfg, FAM_CPU_BATCH, FAM_CPU_SEQ)
        b = {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}
        remat_same = None
        if arch == "zamba2_2_7b":
            plain = S.loss_and_grads(params, b, cfg, QuantContext())
            full_r = S.loss_and_grads(params, b, cfg, QuantContext(),
                                      remat="full")
            remat_same = bool(torch.equal(plain[0], full_r[0]) and all(
                torch.equal(x, y) for x, y in zip(plain[2], full_r[2])))
            check(remat_same, "30a zamba2: gradients with remat='full' "
                  "differ from those without")
            del plain, full_r
        cpu_args[arch] = (cfg, _tree_to(params, "cpu"), batch)
        opt = S.pick_optimizer(cfg)
        step = S.build_train_step(cfg, QuantContext(), opt,
                                  warmup_cosine(3e-3, 1, 10))
        t0 = time.perf_counter()
        _, _, mc = step(params, opt.init(params), b)
        card = {k: float(mc[k]) for k in ("loss", "grad_norm")}
        card["s"] = time.perf_counter() - t0
        del params, mc
        out[arch] = dict(layers=cfg.n_layers, params=S.param_count(cfg),
                         optimizer=_opt_name(opt), card=card,
                         remat_equal=remat_same)
    return {arch: on_cpu_thread(_fam_cpu_grads, *a)
            for arch, a in cpu_args.items()}


def _fam_card_vs_cpu_check(res, pending):
    """30a's comparison: each family's card loss and gradient norm within
    TRAIN_LOSS_RTOL of its CPU side's."""
    for arch, fut in pending.items():
        r = res["card_vs_cpu"][arch]
        card, cpu = r["card"], fut.result()
        r["cpu"] = cpu
        for key in ("loss", "grad_norm"):
            e = abs(card[key] - cpu[key]) / abs(cpu[key])
            check(math.isfinite(card[key]) and e <= TRAIN_LOSS_RTOL,
                  f"30a {arch}: {key} card {card[key]} CPU {cpu[key]}")
        log(f"[30a] {arch} ({r['layers']} layers, full width, "
            f"{r['params'] / 1e9:.3f} B parameters, fp32, "
            f"{r['optimizer']}), {FAM_CPU_BATCH} x {FAM_CPU_SEQ} tokens: "
            f"loss card {card['loss']:.6f} CPU {cpu['loss']:.6f}, "
            f"grad_norm card {card['grad_norm']:.6f} CPU "
            f"{cpu['grad_norm']:.6f} (within {TRAIN_LOSS_RTOL}); the "
            f"card's step {card['s']:.2f} s, the CPU's gradients "
            f"{cpu['s']:.2f} s (on a background thread)"
            + ("" if r["remat_equal"] is None else
               "; remat='full' gradients equal to remat=False's"))


def _fam_attention_layers(cfg) -> tuple[int, int]:
    """(K5 launches, of them non-causal) of one training forward: a
    causal launch an attention layer; whisper's encoder layers and its
    decoder's cross-attention non-causal; zamba2's shared block once a
    group; none in rwkv6."""
    if cfg.family == "audio":
        nc = cfg.encdec.n_encoder_layers + cfg.n_layers
        return cfg.n_layers + nc, nc
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid.attn_every, 0
    if cfg.family == "ssm":
        return 0, 0
    return cfg.n_layers, 0


def _fam_train(torch, res):
    """30b: ``train()`` of each family at full width, bf16, flash
    attention: the bytes of its params, gradients and AdamW moments
    reckoned first against the card's free memory, then FAM_STEPS steps:
    finite losses that fall after step 1, K5 launched once an attention
    layer a step (no other kernel), the step's median ms after the
    first, tokens/s, peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import train
    out = res["train"] = {}
    failed = []
    for arch in FAM_TRAINED:
        n_par = S.param_count(get_config(arch))
        # bf16 params and gradients, AdamW's two fp32 moments
        need = n_par * (2 + 2 + 8)
        free, _ = torch.cuda.mem_get_info()
        check(need < free, f"30b {arch}: {need / 2**30:.1f} GiB of "
              f"params, gradients and moments, {free / 2**30:.1f} GiB "
              f"free on the card")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        o = train(arch, FAM_STEPS, batch=FAM_B, seq=FAM_S, smoke=False,
                  lr=FAM_LR, attn_kernel="flash", log_every=FAM_STEPS)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        nc = ops.FORM_LAUNCHES["flash_prefill_noncausal"]
        losses = o["losses"]
        # every family trains before a failed check is raised
        if not (len(losses) == FAM_STEPS and all(math.isfinite(x)
                                                 for x in losses)):
            failed.append(f"30b {arch}: losses {losses}")
        elif not sum(losses[-2:]) < sum(losses[:2]):
            failed.append(f"30b {arch}: the mean loss of the last two "
                          f"steps is not below that of the first two (the "
                          f"seeded weights): {losses}")
        per, per_nc = _fam_attention_layers(o["cfg"])
        want = {"flash_prefill": per * FAM_STEPS} if per else {}
        if not (launches == want and nc == per_nc * FAM_STEPS):
            failed.append(f"30b {arch}: launches {launches} (non-causal K5 "
                          f"{nc}), want {want} ({per_nc * FAM_STEPS} "
                          f"non-causal)")
        step_s = sorted(o["step_s"][1:])
        med = step_s[len(step_s) // 2]
        peak = torch.cuda.max_memory_allocated() / 2**30
        tps = FAM_B * FAM_S / med
        log(f"[30b] train {arch} at full width ({o['cfg'].n_layers} layers"
            + (f" + {o['cfg'].encdec.n_encoder_layers} encoder layers over "
               f"{o['cfg'].encdec.encoder_seq} frames"
               if o["cfg"].encdec is not None else "")
            + f", {n_par / 1e9:.3f} B parameters, "
            f"{_opt_name(S.pick_optimizer(o['cfg']))}; params, "
            f"gradients and moments {need / 2**30:.1f} GiB), {FAM_STEPS} "
            f"steps of {FAM_B} x {FAM_S} tokens, bf16, flash attention, "
            f"peak rate {FAM_LR}: "
            f"losses {[round(x, 4) for x in losses]}; step median of steps "
            f"2-{FAM_STEPS} {1e3 * med:.1f} ms (step 1 "
            f"{1e3 * o['step_s'][0]:.1f} ms), {tps:.0f} tokens/s, peak "
            f"{peak:.2f} GiB; K5 {per} a step ({per_nc} non-causal), launches "
            f"{launches}; {wall:.1f} s")
        out[arch] = dict(layers=o["cfg"].n_layers, params=n_par,
                         reckoned_gib=need / 2**30, losses=losses,
                         step_s=o["step_s"], median_step_ms=1e3 * med,
                         tokens_per_s=tps, peak_gib=peak, launches=launches,
                         noncausal_k5=nc, k5_per_step=per, wall_s=wall)
        del o
        gc.collect()
        torch.cuda.empty_cache()
    check(not failed, "; ".join(failed))


def _fam_twins(torch, res):
    """30c: the three example twins at smoke size: the continuous-batching
    twin's dense-cache check (K5 / K6) exact for the ragged engine (its
    legacy A/B token-identical) and for the legacy engine alone, the
    replay twin EXACT with its legacy A/B, and the inspect twin on a trace
    the port's engine wrote: no schema problem, every request's
    timeline."""
    from repro_torch.kernels import ops
    from repro_torch.launch import continuous_batching, inspect_trace
    from repro_torch.launch import replay_workload
    from repro_torch.launch.serve import serve_engine
    TWIN_DIR.mkdir(parents=True, exist_ok=True)
    out = res["twins"] = {}
    for tag, argv in (("ragged", []), ("legacy", ["--no-ragged"])):
        ops.reset_launch_counts()
        r = continuous_batching.main(["--attn-kernel", "flash"] + argv)
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        check(r["exact"], f"30c continuous batching ({tag}): the dense-"
              f"cache check parted from the engine's tokens")
        check(r.get("legacy_identical", True), "30c continuous batching: "
              "the legacy A/B's tokens differ")
        kernel = "ragged_attention" if tag == "ragged" \
            else "paged_attention"
        check(all(launches.get(k, 0) > 0 for k in (
            kernel, "flash_prefill", "flash_decode")),
            f"30c continuous batching ({tag}): launches {launches}")
        out[f"continuous_batching {tag}"] = dict(
            exact=r["exact"], legacy_identical=r.get("legacy_identical"),
            launches=launches)
    rec_path = TWIN_DIR / "record.json"
    r = replay_workload.main(["--legacy-ab", "--record", str(rec_path)])
    check(r["replay"].ok and r["legacy_ab"].token_identical,
          "30c replay: not exact, or the legacy A/B's tokens differ")
    out["replay"] = dict(ok=r["replay"].ok,
                         legacy_ab_diff_lines=len(r["legacy_ab"]
                                                  .decision_diff))
    trace_path = TWIN_DIR / "trace.json"
    serve_engine("qwen3_1_7b", n_requests=8, trace=str(trace_path))
    s = inspect_trace.main([str(trace_path)])
    check(s["n_requests"] == 8, f"30c inspect: {s['n_requests']} request "
          f"timelines in the trace, want 8")
    out["inspect"] = dict(events=s["events"], spans=s["spans"],
                          requests=s["n_requests"])
    log(f"[30c] twins: continuous batching exact on the ragged and the "
        f"legacy engine (dense-cache check through K5 / K6), replay EXACT "
        f"(legacy A/B {out['replay']['legacy_ab_diff_lines']} decision "
        f"diff lines, tokens identical), inspect: {s['events']} events, "
        f"{s['n_requests']} request timelines, no schema problem")


def phase_train_families_card(torch, out):
    """Phase 30a's card side (``_fam_card_vs_cpu``), which the whole run
    makes before phases 20 and 22 so that its CPU side runs beside them:
    the results so far and the CPU side's futures, for
    ``phase_train_families``."""
    t0 = time.perf_counter()
    res = {"part_s": {}}
    pending = _fam_card_vs_cpu(torch, res)
    gc.collect()
    torch.cuda.empty_cache()
    res["part_s"]["a"] = time.perf_counter() - t0
    log(f"[30] part a: {res['part_s']['a']:.1f} s (its CPU side on the "
        f"background thread)")
    return res, pending


def phase_train_families(torch, out, card=None):
    """Phase 30: training every family -- (a) K5 under autograd at
    whisper's encoder and MLA's shapes, each family's cut model card
    against CPU (``card``: its card side, ``phase_train_families_card``,
    if it already ran, else it runs here after the K5 cases), zamba2's
    remat on the card; (c) the three example twins (beside 30a's CPU
    side when part a runs here); (b) ``train()`` at full width of granite-moe-3b,
    whisper-large-v3, rwkv6-3b and zamba2-2.7b, once that CPU side is
    done, so that no step is timed beside it."""
    t0 = time.perf_counter()
    res, pending = card if card is not None else ({"part_s": {}}, {})
    early_s = sum(res["part_s"].values())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(30)
    parts = [("a kernels", lambda: res.update(k5=[
        _fam_k5_case(torch, gen, c) for c in FAM_K5_CASES]))]
    if card is None:
        parts.append(("a", lambda: pending.update(
            _fam_card_vs_cpu(torch, res))))
    parts += [("c", lambda: _fam_twins(torch, res)),
              ("a CPU", lambda: _fam_card_vs_cpu_check(res, pending)),
              ("b", lambda: _fam_train(torch, res))]
    for part, run in parts:
        t1 = time.perf_counter()
        run()
        gc.collect()
        torch.cuda.empty_cache()
        res["part_s"][part] = time.perf_counter() - t1
        log(f"[30] part {part}: {res['part_s'][part]:.1f} s")
    res["seconds"] = time.perf_counter() - t0 + early_s
    log(f"[30] training every family {res['seconds']:.1f} s (parts "
        f"{ {k: round(v, 1) for k, v in res['part_s'].items()} }"
        + ("; part a before phase 20" if card is not None else "") + ")")
    out["train_families"] = res
    return res


# ---------------------------------------------------------------------------
# phase 31: the recurrent and audio families served over a (data, model)
# mesh
# ---------------------------------------------------------------------------

# each family at full width on two ranks sharing the card over gloo, cut in
# depth (the script's time; 8, 12 and 4 + 4 layers until phase 32):
# rwkv6-3b on 4 of its 32 layers, zamba2-2.7b on 6 of its 54 (one group
# of 6 Mamba blocks and the shared block), whisper-large-v3 on 2 + 2 of
# its 32 + 32 layers over its 1500 stub frames; fp32 FP on 2 layers
# (zamba2: one group of 6; whisper: 2 + 2)
RM_ARCHS = ("rwkv6_3b", "zamba2_2_7b", "whisper_large_v3")
RM_LAYERS = {"rwkv6_3b": (4, 2), "zamba2_2_7b": (6, 6),
             "whisper_large_v3": (2, 2)}
# bf16 FP on the mesh sums each row-cut module's fp32 partials and rounds
# once where one rank's bf16 product rounds its own sum, and a column-cut
# module's bf16 product over half the columns may round otherwise (the
# library picks its algorithm by shape: zamba2's tokens parted so on an
# H100 80GB HBM3 at 700 W): held to one rank with every product in
# the mesh's order (``recurrent_mesh_cases.mesh_order``) within this
# share of the largest |logit|, tokens identical
RM_FP_REL = 1e-2
# fp32 FP: every step's logits within this share of the largest |logit|
# of one rank's (the row-cut sums' other order; |logit| reaches ~5 at
# full width: 1.14e-5 apart on an H100 80GB HBM3 at 700 W)
RM_FP32_REL = 1e-5
# each classic case decodes RM_GEN tokens (the script's time: at
# SERVE_GEN's 16 the ranks' gloo steps took 73 s of cases)
RM_GEN = 8
# 31c: phase 20's workload (8 requests at once through 4 slots) in chunks
# of 16 (the engine's default; phase 20's 64 took 15.0-19.9 s an engine
# case on the ranks on an H100 80GB HBM3 at 700 W: every dispatch is (4,
# chunk) rows, each row-cut sum crossing the host at that size)
RM_ENGINE = dict(n_requests=8, n_slots=4, chunk=16, rate=1e9)


def _rm_overrides(arch, layers, dtype="bfloat16"):
    """``cfg_overrides`` of ``arch`` on ``layers`` layers (whisper's
    encoder as deep as its decoder) in ``dtype``; zamba2's and whisper's
    K/V in an int8 cache, but in fp32, whose cache is fp32: a last bit of
    the row-cut sums' other order moves an int8 K/V code there (zamba2's
    logits moved by 2.0e-4 so on an H100 80GB HBM3 at 700 W, as phase
    9's FP over an int8 cache moves codes between the card and the
    CPU)."""
    from repro_torch.configs import get_config
    over = {"n_layers": layers, "dtype": dtype}
    if arch != "rwkv6_3b" and dtype != "float32":
        over["kv_cache_bits"] = 8
    if arch == "whisper_large_v3":
        over["encdec"] = dataclasses.replace(get_config(arch).encdec,
                                             n_encoder_layers=layers)
    return over


def _rm_cases():
    """31a-c's cases, in the ranks' order: (tag, arch, mode, case)."""
    out = []
    for arch in RM_ARCHS:
        deep, shallow = RM_LAYERS[arch]
        base = dict(kind="serve", arch=arch, smoke=False, batch=SERVE_BATCH,
                    prompt_len=SERVE_PROMPT, gen=RM_GEN,
                    attn_kernel="flash", model_axis=2)
        out += [("31a", arch, "int", dict(
                     base, mode="int", calibrate=True,
                     cfg_overrides=_rm_overrides(arch, deep))),
                ("31a", arch, "fp", dict(
                     base, mode="fp", calibrate=False,
                     cfg_overrides=_rm_overrides(arch, deep))),
                ("31a", arch, "fp32", dict(
                     base, mode="fp", calibrate=False,
                     cfg_overrides=_rm_overrides(arch, shallow,
                                                 "float32")))]
    # 31b: (2, 1), whisper INT and rwkv6 W8A8 (INT over the int8 weight
    # codes, ``matmul_kernel='int8'``)
    for tag, arch, mode, case in list(out):
        if mode == "int" and arch == "whisper_large_v3":
            out.append(("31b", arch, "int", dict(case, model_axis=1)))
        if mode == "int" and arch == "rwkv6_3b":
            out.append(("31b", arch, "w8a8", dict(
                case, model_axis=1, cfg_overrides=dict(
                    case["cfg_overrides"], matmul_kernel="int8"))))
    # 31c: the engine, INT on both, W8A8 on zamba2 (the script's time)
    for arch in ("rwkv6_3b", "zamba2_2_7b"):
        over = {"n_layers": RM_LAYERS[arch][0]}
        for mode in ("int",) if arch == "rwkv6_3b" else ("int", "w8a8"):
            kw = dict(w8a8=True) if mode == "w8a8" else dict(
                mode="int", calibrate=False)
            out.append(("31c", arch, mode, dict(
                kind="engine", arch=arch, smoke=False, cfg_overrides=over,
                kv_bits=8 if arch == "zamba2_2_7b" else None, model_axis=2,
                **RM_ENGINE, **kw)))
    return out


def _rm_row_cut(cfg, steps: int) -> int:
    """K2's rank-split launches (partials; finishes alike) of one rank of
    a (1, 2) mesh: each row-cut module call, RWKV6's w[rkvgo] and channel
    mix's wv (6 a layer), mamba2's w_in (one a block) and the shared
    block's attention wo and MLP w2 (2 a group), whisper's encoder wo and
    w2 (2 a layer, the prefill only) and decoder wo, cross wo and w2 (3 a
    layer) over ``steps`` forwards (the classic path's prefill and
    decode steps, or the engine's dispatches)."""
    if cfg.family == "ssm":
        return 6 * cfg.n_layers * steps
    if cfg.family == "hybrid":
        return (cfg.n_layers + 2 * cfg.n_layers
                // cfg.hybrid.attn_every) * steps
    return 2 * cfg.encdec.n_encoder_layers + 3 * cfg.n_layers * steps


def _rm_one_rank(torch, cases):
    """The one-rank run of each case (rank cases less ``model_axis``; the
    (2, 1) cases are their (1, 2) cases' one rank; bf16 FP's, one rank
    with every product in a (1, 2) rank's order,
    ``recurrent_mesh_cases.mesh_order``): {(engine, arch, mode):
    result}."""
    sys.path.insert(0, str(ROOT / "tests"))
    import recurrent_mesh_cases as rmc
    ones = {}
    for tag, arch, mode, case in cases:
        key = (tag == "31c", arch, mode)
        if key in ones:
            continue
        one = {k: v for k, v in case.items() if k != "model_axis"}
        if mode == "fp":
            one["mesh_order"] = 2
        ones[key] = rmc.run(one, device="cuda")
        gc.collect()
        torch.cuda.empty_cache()
    return ones


def _rm_held(torch, res, cases, ones, ranks):
    """Each case on the two ranks against its one-rank run: tokens
    identical; INT and W8A8 every step's logits (the engine's first
    step's) bit for bit, bf16 FP within ``RM_FP_REL`` of one rank with
    every product in the mesh's order, fp32 FP within ``RM_FP32_REL``,
    each of the
    largest |logit|; each rank's
    launches one rank's but K2's row-cut modules, each a partial and a
    finish in one launch's place on a (1, 2) mesh (``_rm_row_cut``); decode
    ms a step and tokens/s of the ranks beside one rank's (the ranks share
    the card and talk through the host over gloo: no speed-up is
    claimed)."""
    import numpy as np
    from repro_torch.configs import get_config
    sys.path.insert(0, str(ROOT / "tests"))
    import recurrent_mesh_cases as rmc
    for i, (tag, arch, mode, case) in enumerate(cases):
        one = ones[(tag == "31c", arch, mode)]
        got = [r[i] for r in ranks]
        cfg = dataclasses.replace(get_config(arch), **case["cfg_overrides"])
        engine = case["kind"] == "engine"
        scale = max(float(t.abs().max()) for t in one["logits"])
        errs = []
        for r, g in enumerate(got):
            what = f"{tag} {arch} {mode} rank {r}"
            check(rmc.same_tokens(g, one), f"{what}: tokens != one rank's")
            check(len(g["logits"]) == len(one["logits"]),
                  f"{what}: {len(g['logits'])} steps' logits")
            for step, (a, b) in enumerate(zip(g["logits"], one["logits"])):
                check(bool(torch.isfinite(a).all()),
                      f"{what} step {step}: non-finite logits")
                e_ = float((a - b).abs().max())
                errs.append(e_)
                if mode in ("int", "w8a8"):
                    check(torch.equal(a, b), f"{what} step {step}: logits "
                          f"!= one rank's (max |diff| {e_})")
                elif mode == "fp":
                    check(e_ <= RM_FP_REL * scale, f"{what} step {step}: "
                          f"logits {e_} apart, over {RM_FP_REL} x {scale}")
                else:
                    check(e_ <= RM_FP32_REL * scale, f"{what} step {step}: "
                          f"logits {e_} apart, over {RM_FP32_REL} x "
                          f"{scale}")
            check(g["table"] == one["table"],
                  f"{what}: calibrated table != one rank's")
            steps = (g["report"]["recurrent_steps"] if engine
                     else RM_GEN)
            split = (_rm_row_cut(cfg, steps) if case["model_axis"] == 2
                     and mode in ("int", "w8a8") else 0)
            want = dict(one["launches"])
            want["int8_matmul"] += split
            want["int8_matmul_partial"] = want["int8_matmul_finish"] = split
            check(g["launches"] == want, f"{what}: launches "
                  f"{ {k: v for k, v in g['launches'].items() if v} }, want "
                  f"{ {k: v for k, v in want.items() if v} }")
            if engine:
                check(g["steps"] == one["steps"]
                      and g["decisions"] == one["decisions"],
                      f"{what}: admissions or decisions != one rank's")
        if engine:
            n_tok = sum(len(t) for t in one["outputs"].values())
            rate = n_tok / got[0]["wall_s"]
            one_rate = n_tok / one["wall_s"]
            speed = (f"{n_tok} tokens in {got[0]['wall_s']:.2f} s, "
                     f"{rate:.1f} tokens/s on the ranks (one rank "
                     f"{one['wall_s']:.2f} s, {one_rate:.1f} tokens/s), "
                     f"{got[0]['report']['recurrent_steps']} dispatches")
            dec = dict(tokens=n_tok, tokens_per_s=rate,
                       one_rank_tokens_per_s=one_rate)
        else:
            tps = SERVE_BATCH / got[0]["decode_s_per_tok"]
            one_tps = SERVE_BATCH / one["decode_s_per_tok"]
            speed = (f"decode {1e3 * got[0]['decode_s_per_tok']:.1f} ms a "
                     f"step, {tps:.1f} tokens/s on the ranks (one rank "
                     + ("in the mesh's order " if mode == "fp" else "")
                     + f"{1e3 * one['decode_s_per_tok']:.1f} ms, "
                     f"{one_tps:.1f}); prefill {got[0]['prefill_s']:.3f} s "
                     f"(one rank {one['prefill_s']:.3f})")
            dec = dict(decode_s_per_tok=got[0]["decode_s_per_tok"],
                       one_rank_decode_s_per_tok=one["decode_s_per_tok"],
                       tokens_per_s=tps, one_rank_tokens_per_s=one_tps,
                       prefill_s=got[0]["prefill_s"])
        shape = "(1, 2)" if case["model_axis"] == 2 else "(2, 1)"
        log(f"[{tag}] {arch} ({cfg.n_layers} layers) {mode} on {shape}: "
            f"ranks token-identical to one rank"
            + (" in the mesh's order" if mode == "fp" else "")
            + ", " + ("every step's logits bit-identical" if mode in
                      ("int", "w8a8") else
                      f"logits apart by up to {max(errs):.3g} "
                      f"(|logit| up to {scale:.4g})")
            + f"; {speed}; peak {got[0]['peak_gib']:.2f} / "
            f"{got[1]['peak_gib']:.2f} GiB a rank; rank 0 launches "
            f"{ {k: v for k, v in got[0]['launches'].items() if v} } "
            f"(rank 1's the same; one rank "
            f"{ {k: v for k, v in one['launches'].items() if v} })")
        res.setdefault(tag, {})[f"{arch} {mode}"] = dict(
            max_abs_diff=max(errs), logits_scale=scale,
            launches=[g["launches"] for g in got],
            one_rank_launches=one["launches"],
            peak_gib=[g["peak_gib"] for g in got],
            wall_s=[g["wall_s"] for g in got], one_rank_wall_s=one["wall_s"],
            **dec)


def phase_recurrent_mesh(torch, out):
    """Phase 31: the recurrent (rwkv6-3b, zamba2-2.7b) and audio
    (whisper-large-v3) families served over a (data, model) mesh of two
    ranks sharing the card over gloo, at full width (``RM_LAYERS``): (a)
    classic ``serve`` on (1, 2), calibrated INT, bf16 FP and fp32 FP, (b)
    whisper INT and rwkv6 W8A8 on (2, 1) (the batch and the encoder frames
    cut), (c) the slab engine on (1, 2), rwkv6 INT, zamba2 INT and W8A8,
    on phase 20's workload in chunks of 16; each against one rank
    (``_rm_held``)."""
    t0 = time.perf_counter()
    res = {"part_s": {}}
    from repro_torch.launch.mesh import run_ranks
    sys.path.insert(0, str(ROOT / "tests"))
    import recurrent_mesh_cases as rmc
    cases = _rm_cases()
    t1 = time.perf_counter()
    ones = _rm_one_rank(torch, cases)
    res["part_s"]["one rank"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    ranks = run_ranks(rmc.run_cases, (1, 2), device="cuda", backend="gloo",
                      kwargs={"cases": [c for *_, c in cases]})
    gc.collect()
    torch.cuda.empty_cache()
    res["part_s"]["ranks"] = time.perf_counter() - t1
    res["case_s"] = {f"{tag} {arch} {mode}": (
        ranks[0][i]["wall_s"], ones[(tag == "31c", arch, mode)]["wall_s"])
        for i, (tag, arch, mode, _) in enumerate(cases)}
    log(f"[31] the ranks: {res['part_s']['ranks']:.1f} s, spawned once, "
        f"each model built whole on each rank in turn and cut, every case "
        f"of a, b and c ((2, 1) over the same ranks); each case's seconds, "
        f"rank 0 / one rank: "
        f"{ {k: (round(a, 1), round(b, 1)) for k, (a, b) in res['case_s'].items()} }")
    _rm_held(torch, res, cases, ones, ranks)
    res["seconds"] = time.perf_counter() - t0
    log(f"[31] recurrent and audio serving over a mesh {res['seconds']:.1f}"
        f" s (parts { {k: round(v, 1) for k, v in res['part_s'].items()} })")
    out["recurrent_mesh"] = res
    return res


# ---------------------------------------------------------------------------
# phase 32: training the recurrent, audio and MoE families over a (data,
# model) mesh
# ---------------------------------------------------------------------------

# each family at full width cut in depth (``tests/train_mesh_family_cases.
# py``'s CHIP_LAYERS: rwkv6-3b 4 of 32 layers, zamba2-2.7b one group, 6 of
# 54, whisper-large-v3 2 + 2 of 32 + 32 over its 1500 stub frames,
# granite-moe-3b 4 of 32, deepseek-v3 its first, dense MLA layer) on two
# ranks sharing the card over gloo, the reference's ``jit_train_step``
# over them, TMF_B x TMF_S tokens a step from weights and a stream
# seeded 0, against one rank alone on the card: (a) fp32, TMF_STEPS steps
# at a peak rate of FAM_LR with no warmup (the second step sees the
# first's update) on (1, 2) and (2, 1), the first step's loss and
# grad_norm within TRAIN_LOSS_RTOL (28b's) of one rank's, the second's
# within TMF_UPDATED_LOSS_REL / TMF_UPDATED_GNORM_REL: AdamW's first
# update moves each param by about lr sign(g), and where g is near 0 the
# mesh's summation order and one rank's give it either sign, so those
# params part by up to 2 lr and the second step's gradients follow them
# (at a peak of 3e-3 zamba2's second grad_norm parted by 1.6e-2, its loss
# by 8.6e-5, on an H100 80GB HBM3 at 700 W; the first step's by 2.8e-7);
# deepseek-v3 on (1, 2) alone: on (2, 1) each rank holds
# the whole 2.4 B parameters, whose fp32 params, gradients and AdamW
# moments (38 GB a rank) two ranks cannot hold on one card; (b) one INT
# step on (1, 2), the loss one rank's bit for bit, grad_norm 0; (c) bf16,
# TMF_BF16_STEPS steps on (1, 2): step ms a rank and tokens/s beside one
# rank's, printed and not gated.  The moe family on (2, 1) ranks each data
# shard's pairs against its slice of the capacity (the reference's
# per-shard dispatch; synthetic Zipf tokens repeat, so an expert may
# overflow a shard's 64 rows), so its one rank runs that dispatch in one
# process (``moe(data_shards=2)``)
TMF_B, TMF_S, TMF_STEPS, TMF_BF16_STEPS = 2, 128, 2, 3
TMF_UPDATED_LOSS_REL, TMF_UPDATED_GNORM_REL = 1e-4, 1e-2


def _tmf_cases():
    """32a-c's cases in the ranks' order: (tag, arch, case)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import train_mesh_family_cases as fam
    out = []
    for arch in fam.ARCHS:
        base = dict(kind="train", arch=arch, smoke=False, batch=TMF_B,
                    seq=TMF_S, keep=False, warmup=0, lr=FAM_LR,
                    cfg=fam.chip_cfg(arch))
        out += [("32a (1, 2)", arch, dict(base, steps=TMF_STEPS,
                                          model_axis=2)),
                ("32b", arch, dict(base, steps=1, mode="int",
                                   model_axis=2))]
        if arch != fam.DEEPSEEK:
            out.append(("32a (2, 1)", arch, dict(base, steps=TMF_STEPS,
                                                 model_axis=1)))
        out.append(("32c", arch, dict(base, steps=TMF_BF16_STEPS,
                                      model_axis=2,
                                      cfg=fam.chip_cfg(arch, "bfloat16"))))
    return out


def _tmf_one_rank(torch, cases) -> dict:
    """Each case on one rank alone on the card: {_tmf_key: result}.  A
    (2, 1) case is its (1, 2) case's one rank, but for the moe family,
    whose mesh dispatches per data shard (each shard's pairs ranked
    against its slice of the capacity, the reference's): there the one
    rank runs ``models.mlp.moe(data_shards=2)``, the one-process form of
    the same dispatch (``tests/test_torch_moe_mesh.py`` holds it to the
    reference's)."""
    from unittest import mock
    import train_mesh_cases as tmc
    from repro_torch.models import mlp as tmlp
    ones = {}
    for tag, arch, case in cases:
        key = _tmf_key(tag, case)
        if key in ones:
            continue
        one = {k: v for k, v in case.items() if k != "model_axis"}
        torch.cuda.reset_peak_memory_stats()
        shards = key[2]
        with (mock.patch.object(tmlp, "moe", functools.partial(
                tmlp.moe, data_shards=shards)) if shards > 1
              else contextlib.nullcontext()):
            ones[key] = tmc.run(one, device="cuda")
        ones[key]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        gc.collect()
        torch.cuda.empty_cache()
    return ones


def _tmf_kind(tag: str) -> str:
    return {"32a": "fp32", "32b": "int", "32c": "bf16"}[tag[:3]]


def _tmf_key(tag: str, case: dict) -> tuple:
    """(kind, arch, the data shards of the moe family's dispatch) of a
    case's one-rank run."""
    import train_mesh_cases as tmc
    moe = tmc.config(case).moe is not None
    shards = 3 - case["model_axis"] if moe else 1
    return _tmf_kind(tag), case["arch"], shards


def _tmf_held(torch, res, cases, ones, ranks):
    """Every case on the two ranks against its one-rank run (32a-c's
    rules); each rank's launches: K5 once an attention layer a step (the
    non-causal form at whisper's encoder and cross-attention), in INT also
    K3, K2 and its rank-split form at each row-cut module and, for the
    moe family, its grouped form; the same on both ranks."""
    import train_mesh_cases as tmc
    failed = []
    res["cases"] = {}
    for i, (tag, arch, case) in enumerate(cases):
        kind = _tmf_kind(tag)
        got = [r[i] for r in ranks]
        one = ones[_tmf_key(tag, case)]
        m0 = got[0]["metrics"]
        name = f"{tag} {arch}"
        for r, g in enumerate(got):
            if g["metrics"] != m0 or g["launches"] != got[0]["launches"]:
                failed.append(f"{name} rank {r}: metrics or launches differ "
                              f"from rank 0's")
        ms, om = [m["loss"] for m in m0], [m["loss"] for m in one["metrics"]]
        gs = [m["grad_norm"] for m in m0]
        ogs = [m["grad_norm"] for m in one["metrics"]]
        if not all(math.isfinite(x) for x in ms + gs):
            failed.append(f"{name}: non-finite metrics {m0}")
        cfg = tmc.config(case)
        per, per_nc = _fam_attention_layers(cfg)
        lz = got[0]["launches"]
        steps = case["steps"]
        errs = None
        if kind == "int":
            if ms != om or gs != [0.0] or ogs != [0.0]:
                failed.append(f"{name}: INT loss {ms} (one rank {om}), "
                              f"grad_norm {gs} (one rank {ogs})")
            need = ["int8_matmul", "quantize", "int8_matmul_partial",
                    "int8_matmul_finish"]
            if cfg.moe is not None and cfg.n_layers > cfg.moe.n_dense_layers:
                need.append("int8_matmul_grouped")      # a MoE layer's
            if any(not lz.get(k) for k in need) or \
                    lz["flash_prefill"] != per * steps:
                failed.append(f"{name}: launches {lz}, want {need} and K5 "
                              f"{per * steps}")
        else:
            want = {k: 0 for k in lz}
            want.update(flash_prefill=per * steps,
                        flash_prefill_noncausal=per_nc * steps)
            if lz != want:
                failed.append(f"{name}: launches {lz}, want {want}")
        if kind == "fp32":
            errs = {k: [abs(a - b) / abs(b) for a, b in zip(
                [m[k] for m in m0], [m[k] for m in one["metrics"]])]
                for k in ("loss", "grad_norm")}
            lims = {"loss": [TRAIN_LOSS_RTOL]
                    + [TMF_UPDATED_LOSS_REL] * (steps - 1),
                    "grad_norm": [TRAIN_LOSS_RTOL]
                    + [TMF_UPDATED_GNORM_REL] * (steps - 1)}
            if len(m0) != steps or any(
                    e > lim for k in errs
                    for e, lim in zip(errs[k], lims[k])):
                failed.append(f"{name}: loss {ms} grad_norm {gs} against "
                              f"one rank's {om} / {ogs}: gaps {errs}, "
                              f"limits {lims}")
        med = sorted(got[0]["step_s"][1:] or got[0]["step_s"])
        one_med = sorted(one["step_s"][1:] or one["step_s"])
        step_ms = 1e3 * med[len(med) // 2]
        one_ms = 1e3 * one_med[len(one_med) // 2]
        res["cases"][name] = dict(
            metrics=m0, one_rank=one["metrics"], rel_err=errs, launches=[
                g["launches"] for g in got],
            one_rank_launches=one["launches"], step_ms=step_ms,
            one_rank_step_ms=one_ms,
            tokens_per_s=TMF_B * TMF_S / step_ms * 1e3,
            one_rank_tokens_per_s=TMF_B * TMF_S / one_ms * 1e3,
            peak_gib=[g["peak_gib"] for g in got],
            one_rank_peak_gib=one["peak_gib"], wall_s=got[0]["wall_s"])
        c = res["cases"][name]
        mode = "INT" if kind == "int" else "FP"
        log(f"[{tag[:3]}] {arch} {cfg.dtype} {mode} on "
            f"{tag[4:] or '(1, 2)'} ({cfg.n_layers} layers"
            + (f" + {cfg.encdec.n_encoder_layers} encoder layers over "
               f"{cfg.encdec.encoder_seq} frames" if cfg.encdec else "")
            + f"), {steps} steps of {TMF_B} x {TMF_S} tokens: losses "
            f"{ms} grad_norm {gs}; one rank {om} / {ogs}"
            + (f"; relative gaps {errs}" if errs else "")
            + f"; step {step_ms:.1f} ms a rank ({c['tokens_per_s']:.0f} "
            f"tokens/s; one rank {one_ms:.1f} ms, "
            f"{c['one_rank_tokens_per_s']:.0f} tokens/s), peak "
            f"{[round(x, 2) for x in c['peak_gib']]} GiB a rank (one rank "
            f"{one['peak_gib']:.2f}); launches a rank {lz} (one rank "
            f"{ {k: v for k, v in one['launches'].items() if v} }); "
            f"{got[0]['wall_s']:.1f} s on the ranks")
    check(not failed, "; ".join(failed))


def phase_train_mesh_families(torch, out):
    """Phase 32: training the recurrent (rwkv6-3b, zamba2-2.7b), audio
    (whisper-large-v3) and MoE (granite-moe-3b, deepseek-v3 with MLA)
    families over a (data, model) mesh of two ranks sharing the card over
    gloo, at full width cut in depth: 32a-c (``_tmf_cases``) against one
    rank alone on the card (``_tmf_held``)."""
    t0 = time.perf_counter()
    res = {"part_s": {}}
    from repro_torch.launch.mesh import run_ranks
    sys.path.insert(0, str(ROOT / "tests"))
    import train_mesh_family_cases as fam
    cases = _tmf_cases()
    t1 = time.perf_counter()
    ones = _tmf_one_rank(torch, cases)
    res["part_s"]["one rank"] = time.perf_counter() - t1
    free, total = torch.cuda.mem_get_info()
    log(f"[32] {free / 2**30:.1f} of {total / 2**30:.1f} GiB free on the "
        f"card before the ranks")
    t1 = time.perf_counter()
    ranks = run_ranks(fam.run_cases, (1, 2), device="cuda", backend="gloo",
                      kwargs={"cases": [c for *_, c in cases]})
    gc.collect()
    torch.cuda.empty_cache()
    res["part_s"]["ranks"] = time.perf_counter() - t1
    _tmf_held(torch, res, cases, ones, ranks)
    res["seconds"] = time.perf_counter() - t0
    log(f"[32] training the recurrent, audio and MoE families over a mesh "
        f"{res['seconds']:.1f} s (parts "
        f"{ {k: round(v, 1) for k, v in res['part_s'].items()} })")
    out["train_mesh_families"] = res
    return res


# the phases that time nothing (no CUDA-event time, no profile, no
# training step), which may run beside the background thread; before any
# other phase ``_run_phase`` waits for that thread to be idle
# ---------------------------------------------------------------------------
# phase 33: the per-step cost analysis and the dry run
# ---------------------------------------------------------------------------

# (a): the card's allocation peak during a counted step, over what was
# allocated before it, within this factor of the trace's peak live bytes
# either way (the trace counts the step's own tensors; the caching
# allocator rounds blocks up, and the kernels' scratch is not traced)
COST_PEAK_FACTOR = 2.0
# (c): the production cell rank 0 of which runs for real on the card
COST_CELL = ("rwkv6_3b", "decode_32k")
# (d): each dry run's time limit, from its start, and its worker processes
# (deepseek-v3's train cell, 16 microsteps, takes one worker most of the
# run; the other cells fit the second)
DRYRUN_LIMIT_S, DRYRUN_JOBS = 720, 2
# (d): the archs whose production cells the port refuses: a model axis of
# 16 does not divide their KV heads (ROADMAP Queue 1 item 8, part 4)
DRYRUN_REFUSED_ARCHS = ("qwen3_1_7b", "llama3_2_1b", "qwen3_32b",
                        "deepseek_67b", "chameleon_34b",
                        "granite_moe_3b_a800m", "whisper_large_v3")
DRYRUN_DIR = ROOT / "build" / "dryrun"
# (d)'s two dry runs: tag -> (process, json, log, log file, start)
_DRYRUNS: dict = {}


def start_dryruns() -> None:
    """(d)'s two dry runs (``--all`` and ``--all --multi-pod``, each over
    DRYRUN_JOBS worker processes) as processes of their own, once: host
    work on the meta device, one torch thread a process, no CUDA device.
    The whole script starts them beside phases 4, 5, 11, 16-18, 8, 9,
    30a's card side, 20 and 22, which time nothing; every other phase
    waits for them first (``_run_phase``)."""
    if _DRYRUNS:
        return
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [str(SRC)] + [x for x in [os.environ.get("PYTHONPATH")]
                                 if x]))
    for tag, extra in (("16x16", []), ("2x16x16", ["--multi-pod"])):
        js, lg = DRYRUN_DIR / f"{tag}.json", DRYRUN_DIR / f"{tag}.log"
        js.unlink(missing_ok=True)
        fh = open(lg, "w")
        # a session of its own: stopping it stops its worker processes
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--jobs", str(DRYRUN_JOBS), "--json", str(js)] + extra,
            cwd=ROOT, env=env, stdout=fh, stderr=subprocess.STDOUT,
            start_new_session=True)
        _DRYRUNS[tag] = (proc, js, lg, fh, time.perf_counter())


def dryruns_idle() -> float:
    """Wait for the dry runs to end (each up to its limit): the seconds
    waited."""
    t0 = time.perf_counter()
    for proc, _, _, _, start in _DRYRUNS.values():
        left = DRYRUN_LIMIT_S - (time.perf_counter() - start)
        try:
            proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            pass            # killed and reported by phase 33
    return time.perf_counter() - t0


def _kill(proc) -> None:
    """``proc`` and the rest of its session (the dry run's workers)."""
    import signal
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def stop_dryruns() -> None:
    for proc, _, _, fh, _ in _DRYRUNS.values():
        _kill(proc)
        fh.close()


def _cost_counted(torch, fn, *args):
    """``fn(*args)`` counted on the card: (the trace, the output, each
    kernel's launches, the allocation peak over what was allocated
    before)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.analysis import CostMode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = dict(ops.LAUNCHES)
    with torch.no_grad(), CostMode() as mode:
        got = fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    return mode, got, _launch_delta(start), peak


def _launch_delta(start: dict) -> dict:
    from repro_torch.kernels import ops
    return {k: n - start[k] for k, n in ops.LAUNCHES.items()
            if n != start[k]}


def _uncounted_launches(torch, fn, *args) -> dict:
    from repro_torch.kernels import ops
    start = dict(ops.LAUNCHES)
    with torch.no_grad():
        fn(*args)
    torch.cuda.synchronize()
    return _launch_delta(start)


def _meta_trace(torch, fn, *args):
    from repro_torch.launch.analysis import CostMode
    with torch.no_grad(), CostMode() as mode:
        got = fn(*args)
    return mode, got


def _cost_card_vs_meta(torch, res):
    """(a) qwen3-1.7B's classic prefill and decode step at phase 10's
    shape (batch 4, the 32-token prompt, S_max 48, bf16, flash attention;
    INT calibrated over an int8 cache, then FP over a bf16 one), counted
    on the card and traced on the meta device: FLOPs and bytes equal,
    launches a counted call's = an uncounted call's = phase 10's a
    forward, the allocation peak within COST_PEAK_FACTOR of the trace's,
    and the decode step's replay (CUDA events) beside its roofline."""
    from repro_torch.configs import get_config
    from repro_torch.core.qmodel import (QuantContext, QuantMode,
                                         quantize_weight_tree)
    from repro_torch.core.tree import leaves, unflatten
    from repro_torch.launch import analysis as A
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    s_max = SERVE_PROMPT + SERVE_GEN
    pos = s_max - 1             # the meta trace counts the cache's last row
    res["a"] = {}
    for mode, kv_bits in (("int", 8), ("fp", None)):
        cfg = dataclasses.replace(get_config("qwen3_1_7b"),
                                  attn_kernel="flash", kv_cache_bits=kv_bits)
        params = M.init_params(cfg, 0, device="cuda")
        tokens = torch.from_numpy(_serve_tokens(cfg.vocab_size))
        prompt = {"tokens": tokens.cuda()}
        ctx = QuantContext(mode=QuantMode.FP)
        if mode == "int":
            ctx, _ = serve_mod._calibrated(cfg, params, "int", prompt)
            params = quantize_weight_tree(params, ctx)
        meta_params = unflatten(params, [t.to("meta") for t in
                                         leaves(params)])
        pre = S.build_prefill_step(cfg, ctx, max_seq=s_max)
        dec = S.build_serve_step(cfg, ctx)
        one = _serve_want(cfg, mode, kv_bits is not None, gen=1)
        two = _serve_want(cfg, mode, kv_bits is not None, gen=2)
        want = {"prefill": {k: v for k, v in dict(
                    one, flash_prefill=cfg.n_layers).items() if v},
                "decode": {k: two[k] - one[k] for k in two
                           if two[k] != one[k]}}
        plain = _uncounted_launches(torch, pre, params, prompt)
        card, (logits, cache), launched, peak = _cost_counted(
            torch, pre, params, prompt)
        meta, (_, meta_cache) = _meta_trace(
            torch, pre, meta_params, {"tokens": tokens.to("meta")})
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        dec_args = (params, tok, cache, pos_t)
        d_plain = _uncounted_launches(torch, dec, *dec_args)
        d_card, _, d_launched, d_peak = _cost_counted(torch, dec, *dec_args)
        d_meta, _ = _meta_trace(torch, dec, meta_params, tok.to("meta"),
                                meta_cache, pos_t.to("meta"))
        rows = {}
        for step, c, m, got, base, pk in (
                ("prefill", card, meta, launched, plain, peak),
                ("decode", d_card, d_meta, d_launched, d_plain, d_peak)):
            tag = f"{mode} {step}"
            check((c.flops, c.bytes) == (m.flops, m.bytes),
                  f"33a {tag}: counted on the card {c.flops} FLOP / "
                  f"{c.bytes} B, traced on meta {m.flops} / {m.bytes}")
            check(got == base == want[step],
                  f"33a {tag}: launches counted {got}, uncounted {base}, "
                  f"phase 10's {want[step]}")
            check(c.peak / COST_PEAK_FACTOR <= pk <= c.peak
                  * COST_PEAK_FACTOR,
                  f"33a {tag}: allocation peak {pk} B against the trace's "
                  f"{c.peak} B, outside a factor {COST_PEAK_FACTOR}")
            terms = A.roofline_terms(c.sample())
            rows[step] = dict(flops=c.flops, bytes=c.bytes, peak=c.peak,
                              alloc_peak=pk, launches=got,
                              kernels={k: v[0] for k, v in c.kernels.items()},
                              t_compute_ms=terms["t_compute_s"] * 1e3,
                              t_memory_ms=terms["t_memory_s"] * 1e3)
            log(f"[33a] qwen3-1.7B {tag}: {c.flops / 1e9:.3f} GFLOP, "
                f"{c.bytes / 1e6:.3f} MB on the card = the meta trace's; "
                f"launches {got} (= uncounted = phase 10's); peak live "
                f"{c.peak / 1e6:.3f} MB traced, {pk / 1e6:.3f} MB allocated; "
                f"roofline compute {terms['t_compute_s'] * 1e3:.4f} ms, "
                f"memory {terms['t_memory_s'] * 1e3:.4f} ms")
        graphs = S.StepGraphs("cuda", capture=True)
        tok_np = tok.cpu().numpy()
        for _ in range(3):          # eager, capture, replay
            S.run_serve_step(graphs, dec, params, tok_np, cache, pos)
        check(graphs.last == "replay", f"33a {mode}: decode not replayed")
        ms = time_ms(torch, lambda: S.run_serve_step(
            graphs, dec, params, tok_np, cache, pos), 20)
        bound = max(rows["decode"]["t_compute_ms"],
                    rows["decode"]["t_memory_ms"])
        rows["decode"].update(replay_ms=ms, roofline_ms=bound)
        log(f"[33a] qwen3-1.7B {mode} decode step replayed: {ms:.4f} ms of "
            f"device time against max(t_compute, t_memory) = {bound:.4f} "
            f"ms ({ms / bound:.1f}x)")
        res["a"][mode] = rows
        del params, meta_params, cache, meta_cache, graphs, logits
        torch.cuda.empty_cache()


def _cost_engine(torch, res):
    """(b) phase 5's INT engine workload at ENGINE_LAYERS with
    ``profile_cost=True``: tokens and launches those of the run without
    costs, one cost entry for each step shape."""
    plain = _obs_run(torch, mode="int")
    costed = _obs_run(torch, mode="int", profile_cost=True)
    check(_same_tokens(plain["outputs"], costed["outputs"]),
          "33b: the engine with costs on gave other tokens")
    check(plain["launches"] == costed["launches"],
          f"33b: launches {costed['launches']} with costs, "
          f"{plain['launches']} without")
    table = costed["report"]["profile"]["cost_analysis"]
    shapes = {str(k) for k in costed["engine"]._step_times}
    check(set(table) == shapes,
          f"33b: cost entries {sorted(table)} for step shapes "
          f"{sorted(shapes)}")
    for key, c in sorted(table.items()):
        log(f"[33b] engine INT step {key}: {c['flops'] / 1e9:.4f} GFLOP, "
            f"{c['bytes_accessed'] / 1e6:.3f} MB, peak live "
            f"{c['peak_bytes'] / 1e6:.3f} MB, kernels "
            f"{ {k: v['calls'] for k, v in c['kernels'].items()} }")
    log(f"[33b] engine INT on {ENGINE_LAYERS} layers with profile_cost: "
        f"tokens and launches identical to the run without, "
        f"{len(table)} step shapes each with its entry")
    res["b"] = dict(shapes=table, launches=costed["launches"])
    del plain, costed
    torch.cuda.empty_cache()


def _cost_production_rank(torch, res):
    """(c) rank 0 of COST_CELL on the production (16, 16) mesh for real
    on the card (zeros of its slices, the stand-in mesh's collectives):
    its allocated argument bytes = the dry run's arg_bytes_per_device, its
    collectives, FLOPs and bytes = the meta trace's, next tokens in the
    vocabulary; its step's device time beside the three terms."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves
    from repro_torch.launch import analysis as A
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    arch, shape = COST_CELL
    mesh = make_production_mesh()
    _, meta, _ = D.lower_cell(arch, shape, mesh)
    def requested() -> int:
        # the bytes the caching allocator was asked for (its blocks round
        # them up, by up to a block's split threshold)
        torch.cuda.synchronize()
        return torch.cuda.memory_stats()["requested_bytes.all.current"]

    req0, mem0 = requested(), torch.cuda.memory_allocated()
    step, args, _ = D.rank_step(arch, shape, mesh, device="cuda")
    asked, alloc = requested() - req0, torch.cuda.memory_allocated() - mem0
    n_bytes, n_tensors = D.tree_bytes(args), len(leaves(args))
    check(n_bytes == asked == meta.arg_bytes,
          f"33c: the rank's arguments {n_bytes} B, {asked} B asked of the "
          f"card's allocator, the dry run's arg_bytes_per_device "
          f"{meta.arg_bytes}")
    with torch.no_grad(), A.CostMode() as card:
        nxt, _ = step(*args)
    torch.cuda.synchronize()
    check(card.records == meta.records,
          f"33c: {len(card.records)} collectives on the card, "
          f"{len(meta.records)} traced on meta")
    check((card.flops, card.bytes) == (meta.flops, meta.bytes),
          f"33c: card {card.flops} FLOP / {card.bytes} B, meta "
          f"{meta.flops} / {meta.bytes}")
    vocab = get_config(arch).vocab_size
    check(tuple(nxt.shape) == tuple(args[1].shape)
          and 0 <= int(nxt.min()) and int(nxt.max()) < vocab,
          f"33c: next tokens {tuple(nxt.shape)} {nxt.flatten()[:8]}")
    with torch.no_grad():
        ms = time_ms(torch, lambda: step(*args), 10)
    terms = A.roofline_terms(card.sample())
    log(f"[33c] {arch} x {shape}, rank 0 of (16, 16) on the card: "
        f"arguments {n_bytes} B (= the dry run's = asked of the allocator; "
        f"{alloc} B in its blocks, {n_tensors} tensors), "
        f"{len(card.records)} collectives recorded (= the meta "
        f"trace's), step {ms:.3f} ms of device time (eager, collectives "
        f"not made) against compute {terms['t_compute_s'] * 1e3:.4f} ms, "
        f"memory {terms['t_memory_s'] * 1e3:.4f} ms, collective "
        f"{terms['t_collective_s'] * 1e3:.4f} ms -> {terms['dominant']}")
    res["c"] = dict(arg_bytes=n_bytes, alloc=alloc, ms=ms,
                    collectives=len(card.records), flops=card.flops,
                    bytes=card.bytes,
                    **{k: v for k, v in terms.items()})
    del args, step, nxt
    torch.cuda.empty_cache()


def _dryrun_results(res):
    """(d) both dry runs ended within DRYRUN_LIMIT_S, exit 1 with exactly
    the expected refused cells, each for item 8's reason, and every
    other cell analysed: one line each, the dominant term and the three
    terms."""
    from repro_torch.configs import ARCH_IDS, get_config, supported_shapes
    cells = {(a, s) for a in ARCH_IDS if a != "resnet_paper"
             for s in supported_shapes(get_config(a))}
    refused = {(a, s) for a, s in cells if a in DRYRUN_REFUSED_ARCHS}
    res["d"] = {}
    for tag, (proc, js, lg, _, start) in _DRYRUNS.items():
        dryruns_idle()
        if proc.poll() is None:
            _kill(proc)
            check(False, f"33d: the {tag} dry run passed its "
                         f"{DRYRUN_LIMIT_S} s limit (log {lg})")
        check(proc.returncode == 1 and js.exists(),
              f"33d: the {tag} dry run exited {proc.returncode} (log {lg})")
        data = json.loads(js.read_text())
        failed = {(f["arch"], f["shape"]): f["error"]
                  for f in data["failures"]}
        check(set(failed) == refused,
              f"33d: {tag} failed {sorted(set(failed) - refused)} beyond the "
              f"refused cells, or traced {sorted(refused - set(failed))}")
        check(all("item 8" in e for e in failed.values()),
              f"33d: {tag}: a refusal without item 8's reason")
        recs = data["records"]
        check(len(recs) == len(cells) - len(refused),
              f"33d: {tag}: {len(recs)} cells analysed")
        for r in recs:
            check(all(math.isfinite(r[k]) and r[k] >= 0 for k in (
                "t_compute_s", "t_memory_s", "t_collective_s",
                "hlo_flops_per_device", "arg_bytes_per_device",
                "temp_bytes_per_device")),
                f"33d: {tag} {r['arch']} x {r['shape']}: {r}")
            log(f"[33d] {tag} {r['arch']} x {r['shape']}: {r['dominant']} "
                f"| compute {r['t_compute_s'] * 1e3:.3f} ms, memory "
                f"{r['t_memory_s'] * 1e3:.3f} ms, collective "
                f"{r['t_collective_s'] * 1e3:.3f} ms (args "
                f"{r['arg_bytes_per_device'] / 1e9:.2f} GB, temp "
                f"{r['temp_bytes_per_device'] / 1e9:.2f} GB a rank; traced "
                f"in {r['lower_compile_s']:.1f} s)")
        secs = time.perf_counter() - start
        log(f"[33d] dry run {tag}: {len(recs)} cells analysed, "
            f"{len(failed)} refused (item 8), ended within {secs:.1f} s of "
            f"its start")
        res["d"][tag] = dict(records=recs, refused=sorted(failed),
                             seconds_since_start=secs)


def phase_cost(torch, out):
    start_dryruns()
    res = {}
    try:
        _cost_card_vs_meta(torch, res)
        _cost_engine(torch, res)
        _cost_production_rank(torch, res)
        _dryrun_results(res)
    finally:
        stop_dryruns()
    out["cost"] = res
    return res


BESIDE_CPU_THREAD = {"phase_model", "phase_engine", "phase_w8a8",
                     "phase_paged_model", "phase_legacy_engine",
                     "phase_calibrate", "phase_dense_model",
                     "phase_train_families_card", "phase_obs",
                     "phase_recurrent", "phase_configs"}


def _run_phase(out, fn, *args):
    """``fn(*args)``, its seconds logged and kept under ``phase_s``; first,
    unless it is one of BESIDE_CPU_THREAD, the wait for the background
    thread to be idle and for phase 33's dry runs to end, kept under
    ``cpu_wait_s``."""
    name = fn.__name__
    wait = 0.0 if name in BESIDE_CPU_THREAD \
        else cpu_thread_idle() + dryruns_idle()
    t0 = time.perf_counter()
    res = fn(*args)
    secs = time.perf_counter() - t0
    out.setdefault("phase_s", {})[name] = secs
    out.setdefault("cpu_wait_s", {})[name] = wait
    log(f"[time] {name}: {secs:.1f} s"
        + (f" (after {wait:.1f} s waiting for the background work)"
           if wait >= 0.05 else ""))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--only", default=None, metavar="PHASES",
                    help="run only these phases after the build (1, the "
                         "build and launch floor, always runs), "
                         "comma-separated (1, 2, 3, 5, 6, 7, 10, 11, 12, "
                         "13, 14 (after 13's calibration), 15, 17, 18, 19, "
                         "20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, "
                         "32, 33); "
                         "prints no kernels or ok line")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is missing: run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    out: dict = {}
    try:
        return _run(torch, args, out, t_start)
    finally:
        for pool in _CPU_POOL:
            pool.shutdown(wait=False, cancel_futures=True)
        stop_dryruns()


def _run(torch, args, out, t_start) -> int:
    """``main``'s phases: those ``args.only`` names, or all of them and
    the kernels line."""
    if args.only:
        alone = {1: lambda torch, out: None, 2: phase_k2, 3: phase_k1,
                 5: phase_engine, 6: phase_k5, 7: phase_k6, 10: phase_serve,
                 11: phase_w8a8, 12: phase_cnn_kernels,
                 13: phase_resnet_calibrate,
                 14: lambda torch, out: phase_resnet_forward(
                     torch, out, phase_resnet_calibrate(torch, out)),
                 15: phase_k4,
                 17: phase_legacy_engine, 18: phase_obs, 19: phase_graphs,
                 20: phase_recurrent, 21: phase_quant_fusion,
                 22: phase_configs, 23: phase_recurrent_classic,
                 24: phase_moe, 25: phase_whisper, 26: phase_train,
                 27: phase_tp, 28: phase_train_mesh, 29: phase_moe_mesh,
                 30: phase_train_families, 31: phase_recurrent_mesh,
                 32: phase_train_mesh_families, 33: phase_cost}
        try:
            picked = [alone[int(n)] for n in args.only.split(",")]
        except (KeyError, ValueError) as e:
            print(f"chip_smoke: --only takes phases {sorted(alone)}: {e}",
                  file=sys.stderr)
            return 2
        try:
            _run_phase(out, phase_device, torch, out)
            for phase in picked:
                _run_phase(out, phase, torch, out)
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(out, indent=1, default=str))
        log(f"partial run (phases {args.only}) passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    try:
        smi, build_s = _run_phase(out, phase_device, torch, out)
        k2 = _run_phase(out, phase_k2, torch, out)
        k1 = _run_phase(out, phase_k1, torch, out)
        k5 = _run_phase(out, phase_k5, torch, out)
        k6 = _run_phase(out, phase_k6, torch, out)
        srv = _run_phase(out, phase_serve, torch, out)
        k4 = _run_phase(out, phase_k4, torch, out)
        torch.cuda.empty_cache()
        # phase 8's CPU side on the background thread beside phases that
        # time nothing (BESIDE_CPU_THREAD); phase 13, itself a CPU
        # calibration, comes after 8 so that the two do not share the cores
        cal_cpu = on_cpu_thread(_calibrate_cpu)
        # phase 33's dry runs, host work beside the same phases
        start_dryruns()
        _run_phase(out, phase_model, torch, out)
        eng = _run_phase(out, phase_engine, torch, out)
        _run_phase(out, phase_w8a8, torch, out)
        _run_phase(out, phase_paged_model, torch, out)
        legacy = _run_phase(out, phase_legacy_engine, torch, out)
        torch.cuda.empty_cache()
        _run_phase(out, phase_obs, torch, out)
        torch.cuda.empty_cache()
        cal = _run_phase(out, phase_calibrate, torch, out, cal_cpu)
        _run_phase(out, phase_dense_model, torch, out, *cal)
        del cal, cal_cpu
        torch.cuda.empty_cache()
        # 30a's card side, then its CPU side and phase 26b's beside phases
        # 20 and 22 (the dry runs go on beside all three)
        fam_card = _run_phase(out, phase_train_families_card, torch, out)
        train_cpu = on_cpu_thread(_train_cpu_steps)
        rec = _run_phase(out, phase_recurrent, torch, out)
        torch.cuda.empty_cache()
        _run_phase(out, phase_configs, torch, out)
        torch.cuda.empty_cache()
        cnn = _run_phase(out, phase_cnn_kernels, torch, out)
        q_resnet = _run_phase(out, phase_resnet_calibrate, torch, out)
        rfwd = _run_phase(out, phase_resnet_forward, torch, out, q_resnet)
        del q_resnet
        torch.cuda.empty_cache()
        _run_phase(out, phase_graphs, torch, out)
        torch.cuda.empty_cache()
        qf = _run_phase(out, phase_quant_fusion, torch, out)
        torch.cuda.empty_cache()
        rcl = _run_phase(out, phase_recurrent_classic, torch, out)
        torch.cuda.empty_cache()
        moe = _run_phase(out, phase_moe, torch, out)
        torch.cuda.empty_cache()
        wsp = _run_phase(out, phase_whisper, torch, out)
        torch.cuda.empty_cache()
        trn = _run_phase(out, phase_train, torch, out, train_cpu)
        del train_cpu
        torch.cuda.empty_cache()
        tp = _run_phase(out, phase_tp, torch, out)
        torch.cuda.empty_cache()
        tm = _run_phase(out, phase_train_mesh, torch, out)
        torch.cuda.empty_cache()
        mm = _run_phase(out, phase_moe_mesh, torch, out)
        torch.cuda.empty_cache()
        fam = _run_phase(out, phase_train_families, torch, out, fam_card)
        del fam_card
        torch.cuda.empty_cache()
        rm = _run_phase(out, phase_recurrent_mesh, torch, out)
        torch.cuda.empty_cache()
        tmf = _run_phase(out, phase_train_mesh_families, torch, out)
        torch.cuda.empty_cache()
        _run_phase(out, phase_cost, torch, out)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    launches = eng["int"]["launches"]
    # "per" says what one timing covers: K1's times are one launch at the
    # engine's T24xS4 step, its work list padded as the engine launches it
    # (the unpadded list's time beside it); K2's and K3's sum one engine
    # step's 197 / 141 launches (each shape timed at the step's row
    # bucket, times its launches per step; K2 with the float epilogue the
    # engine launches, its code epilogue's time beside it)
    k1s = k1["step"]
    k2f, k3s = qf["k2_float"]["step"], qf["k3"]["step"]
    kernels = [
        {"name": "ragged_paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/ragged_attention.cu",
         "replaces": "src/repro/kernels/ragged_flash.py:63",
         "launches": launches["ragged_attention"],
         "max_abs_err": k1s["max_abs_err"], "ms": k1s["ms"],
         "plain_ms": k1s["plain_ms"], "bound_ms": k1s["bound_ms"],
         "bound_by": k1s["bound_by"], "library_ms": None,
         "per": f"launch at the engine's T{K1_STEP_T}xS4 step, work list "
                f"padded to its capacity",
         "unpadded_ms": k1s["unpadded_ms"]},
        {"name": "int8_matmul_requant", "route": "cuda",
         "source": "src/repro_torch/csrc/int8_matmul.cu",
         "replaces": "src/repro/kernels/int8_matmul.py:59",
         "launches": launches["int8_matmul"],
         "max_abs_err": qf["k2_float_max_abs_err"],
         "ms": k2f["ms"], "plain_ms": k2f["plain_ms"],
         "bound_ms": k2f["bound_ms"], "bound_by": k2f["bound_by"],
         "library_ms": k2["library_ms"],
         "per": f"engine step: 197 launches at M={K2_STEP_ROWS}, the float "
                f"(bf16) epilogue",
         "code_epilogue_ms": k2["ms"],
         "code_epilogue_max_abs_err": k2["max_abs_err"],
         "codes_and_dequant_ms": k2f["chain_ms"],
         "recurrent_launches": {
             tag: rec[tag]["graphs cold"]["launches"]["int8_matmul"]
             for tag, _, kw in REC_CASES if kw["mode"] == "int"},
         "recurrent_classic_launches": {
             tag: runs[0]["launches"]["int8_matmul"]
             for tag, runs in rcl["serve"].items() if tag.endswith("int")}},
    ]
    # K5 / K6: one launch at the classic path's shapes (K5: the prefill of
    # the 4x32 prompt into the int8 48-position cache; K6: a decode step
    # at position 47, its position a device int32); launches from phase
    # 10's first INT serve run, its decode steps replayed from a graph
    # (the captured launches counted once a replay)
    srv_launches = srv["int"][0]["launches"]
    for name, key, res, line in (
            ("flash_prefill", "flash_prefill", k5, 68),
            ("flash_decode", "flash_decode", k6, 184)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": f"src/repro/kernels/flash_attention.py:{line}",
            "launches": srv_launches[key], "max_abs_err": res["max_abs_err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": res["library_ms"], "per": "launch"})
    # K5 / K6 at zamba2-2.7b's shared block (phase 23: D 80, 32 heads over
    # 32 KV heads, int8 cache), launches from its first INT serve run
    zl = rcl["serve"]["zamba2_2_7b int"][0]["launches"]
    kernels[-2]["zamba2_d80"] = dict(
        {k: v for k, v in rcl["k5"].items() if k != "name"},
        launches=zl["flash_prefill"],
        per="launch: the (4, 32) prefill over the 48-row int8 cache")
    kernels[-1]["zamba2_d80"] = dict(
        {k: v for k, v in rcl["k6"].items() if k != "name"},
        launches=zl["flash_decode"],
        per="launch at pos 47 of the 48-row int8 cache",
        long={k: v for k, v in rcl["k6_long"].items() if k != "name"})
    kernels[-1]["long"] = {
        tag: {k: k6[tag][k] for k in ("pos", "s_max", "splits",
                                      "live_splits", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "max_abs_err")}
        for tag in ("long", "long_early")}
    kernels[-1]["replay_max_abs_err"] = k6["replay_max_abs_err"]
    # K3: one engine step's 141 launches (phase 21; launches from phase 5's
    # INT run), its ResNet launches beside; ResNet launches from phase 14
    k3r, k7 = cnn["k3"], cnn["k7"]
    kernels.append({
        "name": "quantize", "route": "cuda",
        "source": "src/repro_torch/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:19",
        "launches": launches["quantize"],
        "max_abs_err": max(k3r["max_abs_err"], qf["k3_max_abs_err"]),
        "ms": k3s["ms"], "plain_ms": k3s["plain_ms"],
        "bound_ms": k3s["bound_ms"], "bound_by": k3s["bound_by"],
        "library_ms": None,
        "per": f"engine step at T={K2_STEP_ROWS}: {k3s['launches']} "
               f"launches (module inputs one grid, the K/V write)",
        "old_chain_ms": k3s["chain_ms"],
        "resnet": dict(launches=rfwd["launches"]["quantize"],
                       ms=k3r["ms"], plain_ms=k3r["plain_ms"],
                       bound_ms=k3r["bound_ms"], bound_by=k3r["bound_by"],
                       per=f"ResNet forward at batch {RESNET_BATCH}")})
    # K7: the forward's six adds timed standalone (each shape alone); the
    # forward launches it 0 times since each add became conv2's epilogue,
    # whose cost is the fused conv2s' time with and without it
    cv = cnn["conv"]
    kernels.append({
        "name": "residual_requant", "route": "cuda",
        "source": "src/repro_torch/csrc/residual_requant.cu",
        "replaces": "src/repro/kernels/residual_requant.py:20",
        "launches": rfwd["launches"]["residual_requant"],
        "max_abs_err": k7["max_abs_err"],
        "ms": k7["ms"], "plain_ms": k7["plain_ms"],
        "bound_ms": k7["bound_ms"], "bound_by": k7["bound_by"],
        "library_ms": None,
        "per": f"the ResNet forward's {len(k7['shapes'])} adds at batch "
               f"{RESNET_BATCH}, standalone launches; the forward launches "
               f"none (the adds are its conv2s' epilogue)",
        "fused_epilogue": dict(
            conv2_ms=cv["conv2_ms"],
            conv2_plain_epilogue_ms=cv["conv2_plain_epilogue_ms"],
            per="the forward's conv2 launches with the residual epilogue and "
                "without it")})
    # the convolution kernel: one ResNet forward's 15 launches (each shape
    # timed alone, in its path form), beside the chain it replaced
    kernels.append({
        "name": "int_conv", "route": "cuda",
        "source": "src/repro_torch/csrc/int_conv.cu",
        "replaces": "src/repro/core/integer_ops.py:106 (XLA's integer "
                    "convolution, lax.conv_general_dilated: no Pallas "
                    "kernel) and, as its residual epilogue, "
                    "src/repro/kernels/residual_requant.py:20",
        "launches": rfwd["launches"]["int_conv"],
        "max_abs_err": cv["max_abs_err"], "ms": cv["ms"],
        "plain_ms": cv["plain_ms"], "bound_ms": cv["bound_ms"],
        "bound_by": cv["bound_by"], "library_ms": None,
        "library_note": "PyTorch has no int8 convolution on CUDA",
        "old_chain_ms": cv["chain_ms"],
        "per": f"ResNet forward at batch {RESNET_BATCH}: "
               f"{len(cv['shapes'])} launches, conv2 with its residual "
               f"epilogue; old chain im2col + K2 (+ K7)"})
    # K4: one launch at the legacy engine's decode shape, its work list
    # padded as the engine launches it (the unpadded list's time beside
    # it); launches from phase 17's first INT legacy run.  No single
    # PyTorch call reads a block table: gather + dequantize + SDPA (two
    # calls) is kept beside it
    kernels.append({
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:285",
        "launches": legacy["legacy_int"]["launches"]["paged_attention"],
        "max_abs_err": k4["max_abs_err"], "ms": k4["ms"],
        "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"], "library_ms": None,
        "per": "launch at the decode shape, work list padded to its "
               "capacity",
        "unpadded_ms": k4["unpadded_ms"],
        "hybrid": dict(
            {k: v for k, v in k4["hybrid"][K4_HYBRID_TIMED].items()
             if k in ("ms", "unpadded_ms", "plain_ms", "bound_ms",
                      "bound_by", "max_abs_err")},
            launches=rec["zamba int"]["graphs cold"]["launches"][
                "paged_attention"],
            per=f"launch at zamba2-2.7b's {K4_HYBRID_TIMED} (4, "
                f"{HYBRID_CHUNK}), work list padded to its capacity; "
                f"launches from phase 20's zamba int graphs run"),
        "library_note": "no single PyTorch call reads a block table; gather "
                        f"+ dequantize + SDPA (two calls) "
                        f"{k4['gather_sdpa_ms']:.4f} ms"})
    # the MoE family (phase 24): K2's grouped form, one granite decode
    # step's 96 launches (32 layers x w1, w3, w2 at 4 tokens, each shape
    # timed alone); launches from granite's first INT serve run; the
    # other shapes beside.  K2, K3, K5 and K6 at the family's shapes
    gk = moe["k2_grouped"]
    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0}
    for r in gk["timed"]:
        if r["tokens"] == SERVE_BATCH and r["shape"].startswith("granite"):
            per = 32 * (2 if "w1" in r["shape"] else 1)
            for key in ("ms", "plain_ms", "library_ms"):
                step[key] += per * r[key]
            step["bytes"] += per * r["bound_ms"] * PEAK["bytes"] / 1e3
    g_int = moe["serve"]["granite_moe_3b_a800m int"][0]["launches"]
    d_int = moe["serve"]["deepseek_v3_671b int"][0]["launches"]
    kernels.append({
        "name": "int8_matmul_grouped", "route": "cuda",
        "source": "src/repro_torch/csrc/int8_matmul.cu",
        "replaces": "src/repro/models/mlp.py:91 (the experts' int8 "
                    "lax.dot_general, XLA: no Pallas kernel); K2's tile and "
                    "epilogue (src/repro/kernels/int8_matmul.py:59)",
        "launches": g_int["int8_matmul_grouped"],
        "max_abs_err": gk["max_abs_err"], "ms": step["ms"],
        "plain_ms": step["plain_ms"],
        "bound_ms": step["bytes"] / PEAK["bytes"] * 1e3,
        "bound_by": "bytes", "library_ms": step["library_ms"],
        "library_note": "torch._int_mm looped over the active experts "
                        "(int32 result only; no batched int8 product on "
                        "CUDA)",
        "per": "granite-moe-3b decode step at batch 4: 96 launches (w1, "
               "w3, w2 a layer), each shape timed alone",
        "deepseek_launches": d_int["int8_matmul_grouped"],
        "shapes": gk["timed"], "checks": gk["checks"]})
    for k_name, key in (("int8_matmul_requant", "int8_matmul"),
                        ("quantize", "quantize")):
        entry = next(e for e in kernels if e["name"] == k_name)
        entry["moe_classic_launches"] = {
            tag: runs[0]["launches"][key]
            for tag, runs in moe["serve"].items() if tag.endswith("int")}
    for k_name, keys in (("flash_prefill", ("k5_mla", "k5_granite")),
                         ("flash_decode", ("k6_granite",))):
        entry = next(e for e in kernels if e["name"] == k_name)
        for key in keys:
            entry[key] = {k: v for k, v in moe[key].items() if k != "name"}
        entry["moe_classic_launches"] = {
            tag: runs[0]["launches"][k_name]
            for tag, runs in moe["serve"].items()}
    # the audio family (phase 25): K5's non-causal form, its own entry at
    # whisper's encoder shape (launches: the first calibrated INT serve
    # run's non-causal K5, the encoder's and the cross-attention's in the
    # prefill and the calibration forward), the cross prefill beside; K6
    # at the cross decode; K2 with a bias at whisper's prefill shapes
    w_int = wsp["serve"]["whisper_large_v3 int"][0]
    enc = wsp["k5_encoder"]
    kernels.append({
        "name": "flash_prefill_noncausal", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:68 (causal=False)",
        "launches": w_int["noncausal_k5"],
        "max_abs_err": wsp["k5_nc_max_abs_err"], "ms": enc["ms"],
        "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
        "bound_by": enc["bound_by"], "library_ms": enc["library_ms"],
        "per": f"launch at whisper's encoder: B {SERVE_BATCH}, "
               f"{WHISPER_FRAMES} over {WHISPER_FRAMES}, H = KVH "
               f"{WHISPER_HEADS}, D {WHISPER_DIM}, bf16",
        "cross_prefill": {k: v for k, v in wsp["k5_cross"].items()
                          if k != "name"},
        "checks": wsp["k5_nc_checks"]})
    for k_name, key, extra in (
            ("flash_prefill", "flash_prefill", {}),
            ("flash_decode", "flash_decode",
             {"whisper_cross": {k: v for k, v in wsp["k6_cross"].items()
                                if k != "name"}}),
            ("int8_matmul_requant", "int8_matmul",
             {"whisper_bias": wsp["k2_bias"]}),
            ("quantize", "quantize", {})):
        entry = next(e for e in kernels if e["name"] == k_name)
        entry.update(extra, whisper_classic_launches={
            tag: runs[0]["launches"][key]
            for tag, runs in wsp["serve"].items()})
    # training (phase 26): K5's launches in the 8 full-depth train steps
    # (forward only: the backward recomputes through the plain version),
    # its forward and the recompute backward at the train shape
    kt = trn["k5_train"]
    entry = next(e for e in kernels if e["name"] == "flash_prefill")
    entry["training"] = dict(
        launches=trn["full"]["launches"]["flash_prefill"],
        per=f"launch at llama3.2-1B's train shape: B {TRAIN_B}, S "
            f"{TRAIN_S}, H 32, KVH 8, D 64, bf16, causal; launches from "
            f"phase 26c's {TRAIN_STEPS} steps",
        max_abs_err=max(c["max_abs_err"] for c in trn["k5_cases"]),
        grad_max_abs_err=max(c["grad_max_abs_err"]
                             for c in trn["k5_cases"]),
        **{k: kt[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "backward_ms",
                              "backward_bound_ms", "backward_bound_by",
                              "library_train_ms")})
    # tensor-parallel serving (phase 27): K2's rank-split form (each
    # rank's partial, the int32 all-reduce, the finish) at qwen3-1.7B's
    # row-cut shapes, and every kernel's launches on each rank of the
    # (1, 2) mesh (two ranks sharing the card over gloo)
    srv_tp = tp["serving"]
    k2tp = next(t for t in tp["k2"]["timed"]
                if t["module"] == "wo" and t["ranks"] == 2)
    entry = next(e for e in kernels if e["name"] == "int8_matmul_requant")
    entry["rank_split"] = dict(
        checks=tp["k2"]["checks"], max_abs_err=tp["k2"]["max_abs_err"],
        ms=k2tp["partial_ms"] + k2tp["finish_ms"],
        plain_ms=k2tp["plain_ms"],
        bound_ms=k2tp["partial_bound_ms"] + k2tp["finish_bound_ms"],
        bound_by=k2tp["partial_bound_by"], library_ms=k2tp["int_mm_ms"],
        library_note="torch._int_mm: the partial's int32 product alone",
        launches={f"rank {r}": {k: srv_tp["ragged int"]["launches"][r][k]
                                for k in ("int8_matmul",
                                          "int8_matmul_partial",
                                          "int8_matmul_finish")}
                  for r in range(2)},
        per=f"one rank's partial + the finish of wo (2048 -> 2048 over 2 "
            f"ranks) at M={TP_TIMED_ROWS}, bf16 epilogue; launches from "
            f"phase 27b's ragged INT engine run",
        shapes=tp["k2"]["timed"])
    for k_name, key, tag in (
            ("ragged_paged_attention", "ragged_attention", "ragged int"),
            ("int8_matmul_requant", "int8_matmul", "ragged int"),
            ("quantize", "quantize", "ragged int"),
            ("paged_attention", "paged_attention", "legacy int"),
            ("flash_prefill", "flash_prefill", "classic int"),
            ("flash_decode", "flash_decode", "classic int")):
        entry = next(e for e in kernels if e["name"] == k_name)
        entry["mesh_launches"] = dict(
            per_rank=[r[key] for r in srv_tp[tag]["launches"]],
            per=f"each rank of the (1, 2) mesh, phase 27b's {tag} run")
    # training over a mesh (phase 28): each rank's launches in 28a's
    # bf16 steps (K5) and 28c's INT step (K2's rank-split form, K3)
    for k_name, key, part in (
            ("flash_prefill", "flash_prefill", "full"),
            ("int8_matmul_requant", "int8_matmul", "int"),
            ("quantize", "quantize", "int")):
        entry = next(e for e in kernels if e["name"] == k_name)
        entry["train_mesh_launches"] = dict(
            per_rank=[r[key] for r in tm[part]["launches"]],
            per=("each rank of the (1, 2) mesh, phase 28a's "
                 f"{TM_STEPS} bf16 train steps" if part == "full" else
                 "each rank of the (1, 2) mesh, phase 28c's INT train "
                 "step"))
    entry = next(e for e in kernels if e["name"] == "int8_matmul_requant")
    entry["train_mesh_launches"].update(
        partial=[r["int8_matmul_partial"] for r in tm["int"]["launches"]],
        finish=[r["int8_matmul_finish"] for r in tm["int"]["launches"]])
    # the MoE family over a mesh (phase 29): K2's grouped form's int32 kind
    # and exchanged layout, each its own entry at the (2, 1) decode shape
    # the path launches it at (launches: 29d's ranks, a layer each), the
    # other shapes beside; every kernel's launches on each rank of 29b's
    # and 29c's (1, 2) INT serve runs
    mk = mm["k2"]
    for name, shape, form in (
            ("int8_matmul_grouped_partial", "granite w2 (2, 1)",
             "the int32 output kind (w2's sums over a hidden cut over "
             "data, finished once after the ranks' int32 sum)"),
            ("int8_matmul_grouped_segments", "granite w1 (2, 1)",
             "the exchanged layout (an (E, D) count grid, each expert's "
             "C rows D segments of C / D)")):
        t = next(r for r in mk["timed"] if r["shape"] == shape)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/int8_matmul.cu",
            "replaces": "src/repro/models/mlp.py:91 (the experts' int8 "
                        "lax.dot_general over the reference's (E, D * "
                        "cap_l) exchange buffer, XLA: no Pallas kernel)",
            "launches": sum(r[name] for r in mm["29d"]["launches"][::2]),
            "max_abs_err": mk["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_note": "torch._int_mm looped over the live (expert, "
                            "segment) pairs (int32 products alone)",
            "per": f"K2's grouped form, {form}: one launch at granite's "
                   f"{shape} decode shape, {t['tokens']} tokens a shard; "
                   f"launches: rank 0 of phase 29d's (2, 1) mesh",
            "shapes": mk["timed"], "checks": mk["checks"]})
    for k_name, key in (("int8_matmul_requant", "int8_matmul"),
                        ("int8_matmul_grouped", "int8_matmul_grouped"),
                        ("quantize", "quantize"),
                        ("flash_prefill", "flash_prefill"),
                        ("flash_decode", "flash_decode")):
        entry = next(e for e in kernels if e["name"] == k_name)
        entry["moe_mesh_launches"] = {
            tag: [r[key] for r in mm[tag]["int"]["launches"]]
            for tag in ("29b", "29c")}
    # training every family (phase 30): K5's launches in each family's
    # train() steps (the forward; the backward recomputes through the
    # plain version), its forward and recompute backward at MLA's Dk !=
    # Dv shape and, on the non-causal entry, at whisper's encoder
    k5_fam = {c["name"]: c for c in fam["k5"]}
    fam_launches = {arch: dict(flash_prefill=r["launches"].get(
                        "flash_prefill", 0), noncausal=r["noncausal_k5"],
                        per_step=r["k5_per_step"])
                    for arch, r in fam["train"].items()}
    entry = next(e for e in kernels if e["name"] == "flash_prefill")
    entry["training_families"] = dict(
        launches=fam_launches,
        per=f"phase 30b's {FAM_STEPS} train() steps of {FAM_B} x {FAM_S} "
            f"tokens a family, full width, bf16; times: one launch at the "
            f"MLA shape below",
        mla={k: v for k, v in k5_fam[FAM_K5_CASES[1][0]].items()
             if k != "name"})
    entry = next(e for e in kernels if e["name"] == "flash_prefill_noncausal")
    entry["training"] = dict(
        launches=fam_launches["whisper_large_v3"]["noncausal"],
        per=f"launch at whisper's encoder in training: B {FAM_B}, "
            f"{WHISPER_FRAMES} over {WHISPER_FRAMES}, H = KVH "
            f"{WHISPER_HEADS}, D {WHISPER_DIM}, bf16; launches from phase "
            f"30b's {FAM_STEPS} steps",
        **{k: v for k, v in k5_fam[FAM_K5_CASES[0][0]].items()
           if k != "name"})
    # the recurrent and audio families over a mesh (phase 31): every
    # kernel's launches on each rank of 31a's calibrated INT serve runs
    # and 31c's INT engine runs on (1, 2)
    for k_name, key in (("int8_matmul_requant", "int8_matmul"),
                        ("quantize", "quantize"),
                        ("flash_prefill", "flash_prefill"),
                        ("flash_prefill_noncausal", "flash_prefill_noncausal"),
                        ("flash_decode", "flash_decode"),
                        ("paged_attention", "paged_attention")):
        entry = next(e for e in kernels if e["name"] == k_name)
        entry["recurrent_mesh_launches"] = {
            f"{tag} {run}": [r[key] for r in rm[tag][run]["launches"]]
            for tag in ("31a", "31c") for run in rm[tag]
            if run.endswith(" int")}
    entry = next(e for e in kernels if e["name"] == "int8_matmul_requant")
    entry["recurrent_mesh_launches"].update(
        {f"{tag} {run} {form}": [r[f"int8_matmul_{form}"]
                                 for r in rm[tag][run]["launches"]]
         for tag in ("31a", "31c") for run in rm[tag]
         if run.endswith(" int") for form in ("partial", "finish")})
    # training the recurrent, audio and MoE families over a mesh (phase
    # 32): each kernel's launches on each rank of 32a's fp32 and 32b's INT
    # steps
    for k_name, key in (("flash_prefill", "flash_prefill"),
                        ("flash_prefill_noncausal", "flash_prefill_noncausal"),
                        ("int8_matmul_requant", "int8_matmul"),
                        ("int8_matmul_grouped", "int8_matmul_grouped"),
                        ("quantize", "quantize")):
        entry = next(e for e in kernels if e["name"] == k_name)
        entry["train_mesh_family_launches"] = {
            run: [r[key] for r in c["launches"]]
            for run, c in tmf["cases"].items() if not run.startswith("32c")}
    entry = next(e for e in kernels if e["name"] == "int8_matmul_requant")
    entry["train_mesh_family_launches"].update(
        {f"{run} {form}": [r[f"int8_matmul_{form}"] for r in c["launches"]]
         for run, c in tmf["cases"].items() if run.startswith("32b")
         for form in ("partial", "finish")})
    out.update(card=smi, build_s=build_s, kernels=kernels,
               seconds=time.perf_counter() - t_start)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1, default=str))
    log(f"total {out['seconds']:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
