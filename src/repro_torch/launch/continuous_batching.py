"""Continuous-batching serving on the paged int8-KV block pool: the port's
counterpart of ``examples/continuous_batching.py``.

    PYTHONPATH=src python -m repro_torch.launch.continuous_batching \\
        [--arch qwen3_1_7b] [--shared-prefix 48] [--spec-k 0] \\
        [--ragged | --no-ragged] [--attn-kernel flash] [--device cpu]

Submits a mixed-length Poisson workload to the serving engine: requests
are admitted FCFS into a fixed-width slot batch as others finish, prompts
prefill in chunks under a token budget, and every request's KV lives as
int8 blocks (power-of-two scales) written once and never requantized
while resident.  The demo re-runs request 0 alone through the dense-cache
path (``models.model.prefill`` / ``decode_step``) to show the paged
engine is token-exact, and prints the paper-Table-5 requant-energy
accounting.

``--shared-prefix N`` (default 48) prepends the same N-token system
prompt to every request: the content-addressed prefix cache quantizes it
once and serves every later request from the same physical blocks (the
hit rate and the quantization ops sharing deleted are printed; 0 turns it
off).  ``--spec-k K`` (default 0, off) drafts up to K tokens a slot with
the n-gram self-drafter and verifies them in one step; greedy outputs are
token-identical with speculation on or off.

By default every step is one ragged dispatch (K1 over the flattened
stream); ``--ragged`` (the default) also replays the workload through the
legacy per-shape engine (K4) and prints dispatch counts and padding side
by side; ``--no-ragged`` serves with the legacy engine only.
``--attn-kernel flash`` runs the dense-cache check through K5 / K6 (the
config's plain attention by default).

``--arch rwkv6_3b`` / ``--arch zamba2_2_7b`` serve a recurrent or hybrid
arch from the fixed-slab substrate (prefix cache and speculation off: a
recurrent state is a running summary, not addressable token history),
check every request against the dense fp32 recurrent path, and serve the
equal-length workload through the attention engine too, printing both
requant ops a token.

Runs on the CUDA device unless ``--device cpu`` is given.  ``main``
returns the runs and the checks.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import serve_engine
from repro_torch.models import model as M
from repro_torch.serving.substrate import substrate_for

__all__ = ["main", "dense_oracle"]


def dense_oracle(engine, requests) -> dict:
    """Each request's greedy tokens through the dense-cache path
    (``prefill`` and ``decode_step`` one request at a time, no paging) on
    the engine's weights, device and config: {rid: tokens}."""
    cfg, ctx, params = engine.cfg, engine.ctx, engine.params
    dev = engine.device
    # one cache size for every request checked, as the reference's
    max_seq = max(len(r.prompt) + r.max_new_tokens for r in requests)
    out = {}
    with torch.no_grad():
        for req in requests:
            p = len(req.prompt)
            prompt = torch.from_numpy(np.asarray(req.prompt)[None]).to(dev)
            logits, cache = M.prefill(params, {"tokens": prompt}, cfg, ctx,
                                      max_seq=max_seq)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            toks = [tok]
            for i in range(req.max_new_tokens - 1):
                logits, cache = M.decode_step(params, tok, cache, p + i,
                                              cfg, ctx)
                tok = logits.argmax(-1)[:, None].to(torch.int32)
                toks.append(tok)
            out[req.rid] = torch.cat(toks, 1)[0].cpu().numpy()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", "--model", dest="arch", default="qwen3_1_7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--shared-prefix", type=int, default=48,
                    help="N-token system prompt shared by every request "
                         "(0 disables the prefix-cache demo)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft up to K tokens per "
                         "slot and verify them in one step (0 disables)")
    ap.add_argument("--ragged", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="--ragged (default): one ragged dispatch a step, "
                         "with a legacy per-shape replay for the A/B "
                         "numbers; --no-ragged: the legacy engine only")
    ap.add_argument("--attn-kernel", choices=["flash", "chunked"],
                    default=None,
                    help="the dense-cache check's attention (default: the "
                         "config's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    sub = substrate_for(get_smoke_config(args.arch))
    recurrent = sub.fixed_state
    if recurrent and (args.shared_prefix or args.spec_k):
        print(f"note: {args.arch} serves from the {sub.kind} substrate — "
              f"prefix cache and speculation need addressable/rollback-"
              f"able token history, disabling both for this run")
        args.shared_prefix = args.spec_k = 0
    # long contexts are where the context-free slab requant pays:
    # attention's per-token accounting grows with the cached range
    lens = (dict(prompt_lens=(48, 56, 64), gen_lens=(32, 40, 48))
            if recurrent else {})
    kernel = ({} if args.attn_kernel is None
              else {"attn_kernel": args.attn_kernel})

    def run(ragged, arch=None, **kw):
        overrides = dict(kernel, **kw.pop("cfg_overrides", {}))
        if recurrent and arch is None:
            # token-exactness against the dense fp32 path needs fp32 end
            # to end: the fixed-shape recurrent step reorders bf16 sums
            overrides.setdefault("dtype", "float32")
        return serve_engine(arch or args.arch, n_requests=args.requests,
                            rate=50.0, n_slots=4, block_size=16,
                            chunk=64 if recurrent else 16, mode="fp",
                            calibrate=False, temperature=args.temperature,
                            shared_prefix=args.shared_prefix,
                            spec_k=args.spec_k, ragged=ragged,
                            cfg_overrides=overrides, device=args.device,
                            **lens, **kw)

    res = {"substrate": sub.kind}
    out = res["run"] = run(args.ragged)
    rep = out["report"]
    print(f"[{args.arch}] {rep['completed']}/{rep['n_requests']} requests, "
          f"{rep['gen_tokens']} tokens in {rep['wall_s']}s "
          f"({rep['tokens_per_s']} tok/s incl. first calls)")
    if rep["pool"] is not None:
        print(f"pool: {rep['pool']['peak_live_blocks']} peak blocks "
              f"({rep['pool']['peak_utilization']:.0%} of "
              f"{rep['pool']['num_blocks'] - 1}), "
              f"{rep['pool']['evictions']} evictions")
    sl = rep.get("state_pool")
    if sl is not None:
        print(f"state slabs ({rep['substrate']}): {sl['peak_live_slabs']} "
              f"peak of {sl['num_slabs'] - 1}, one per sequence; "
              f"{sl['state_quant_ops_per_step']} state elems requantized "
              f"per step per sequence — independent of context length")
    hw = rep["hwcost"]
    print(f"requant ops: {hw['requant_ops_performed']} performed "
          f"(write-once int8 blocks) vs "
          f"{hw['requant_ops_performed'] + hw['requant_ops_avoided']} for a "
          f"dequantize-per-step cache — "
          f"{hw['energy_uj_bit_shift']:.2f} uJ vs "
          f"{hw['energy_uj_if_requant_per_step']:.2f} uJ bit-shift "
          f"({hw['energy_uj_if_scaling_factor']:.2f} uJ scaling-factor, "
          f"paper Table 5)")
    pc = rep.get("prefix_cache")
    if pc is not None and args.shared_prefix:
        print(f"prefix cache (shared {args.shared_prefix}-token system "
              f"prompt): hit-rate {pc['hit_rate']:.1%}, "
              f"{pc['cached_prefill_tokens']} prefill tokens served from "
              f"cache, {pc['quant_ops_avoided']} quantization ops never "
              f"ran, {pc['cow_copies']} COW copies, "
              f"{pc['resident_cached_blocks']} blocks still resident for "
              f"the next request")
    sp = rep.get("speculative")
    if sp is not None:
        print(f"speculative (K={sp['spec_k']}, {sp['drafter']}): "
              f"acceptance {sp['acceptance_rate']}, "
              f"{sp['tokens_per_step']} tokens/step over "
              f"{sp['verify_steps']} verify steps; "
              f"{sp['retracted_blocks']} rejected-tail blocks retracted, "
              f"{sp['requant_ops_wasted']} quant ops spent on rejected "
              f"drafts (never published)")
    for rid, toks in sorted(out["outputs"].items())[:4]:
        print(f"  req {rid}: {toks[:12].tolist()}")

    if args.ragged and not recurrent:
        # A/B: the same workload through the legacy per-shape engine
        leg = res["legacy"] = run(False)
        lrep = leg["report"]
        r_disp = rep["ragged_steps"]
        l_disp = (lrep["prefill_chunks"] + lrep["decode_steps"]
                  + lrep["spec_steps"])
        print("ragged vs per-shape (same workload):")
        print(f"  dispatches:   {r_disp} unified ragged steps vs "
              f"{l_disp} legacy ({lrep['prefill_chunks']} prefill + "
              f"{lrep['decode_steps']} decode + {lrep['spec_steps']} "
              f"verify)")
        print(f"  padding:      {rep['padded_tokens']}/"
              f"{rep['dispatched_tokens']} tokens padded "
              f"({rep['padding_frac']:.1%}) vs {lrep['padded_tokens']}/"
              f"{lrep['dispatched_tokens']} ({lrep['padding_frac']:.1%}) "
              f"legacy")
        if args.temperature == 0.0:
            same = res["legacy_identical"] = all(
                np.array_equal(out["outputs"][r.rid], leg["outputs"][r.rid])
                for r in out["requests"])
            print(f"  greedy tokens: "
                  f"{'identical' if same else 'MISMATCH'}")

    if args.temperature == 0.0:
        # token-exactness against the dense cache path, one request at a
        # time: request 0 on attention; every request on a recurrent arch
        # (a recycled slab that skipped zero-on-admission diverges only a
        # few decode tokens in)
        to_check = (out["requests"] if recurrent
                    else [next(r for r in out["requests"] if r.rid == 0)])
        oracle = dense_oracle(out["engine"], to_check)
        ok = res["exact"] = all(
            np.array_equal(out["outputs"][r.rid], oracle[r.rid])
            for r in to_check)
        label = (f"all {len(to_check)} requests" if recurrent
                 else "req 0")
        print(f"paged engine vs dense fp32 oracle ({label}): "
              f"{'exact match' if ok else 'MISMATCH'}")

    if recurrent:
        # equal-length attention baseline: the same Poisson workload shape
        # through the transformer engine, at the serving bench's
        # transformer geometry (4L/d256): attention requants scale with
        # the cached context, slab requants do not
        base = res["baseline"] = run(args.ragged, arch="qwen3_1_7b",
                                     cfg_overrides=dict(
                                         dtype="float32", n_layers=4,
                                         d_model=256, n_heads=8,
                                         n_kv_heads=4, d_ff=1024,
                                         head_dim=32, kv_cache_bits=8))
        b = base["report"]["hwcost"]["requant_ops_per_token"]
        total = rep["hwcost"]["requant_ops_per_token"]
        share = rep["state_pool"]["state_ops_per_token"]
        verdict = "BELOW" if share < b else "NOT BELOW"
        print(f"requant ops/token, equal-length workload: attention "
              f"baseline {b}; {args.arch} total {total}, of which the "
              f"recurrent (slab) substrate pays {share} — context-free "
              f"state requant is {verdict} the attention baseline")
    return res


if __name__ == "__main__":
    main()
