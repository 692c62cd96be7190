"""Batched int8 serving and, with ``--sharded``, the same on a (data=1,
model=2) mesh: the port's counterpart of ``examples/serve_quantized.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve_quantized \\
        [--arch qwen3_1_7b] [--device cpu] [--sharded [--dist-backend gloo]]

Calibrates with Algorithm 1 on one batch, converts to the integer deploy
path, then serves batched requests (prefill + greedy decode), comparing
tokens against the FP path.

With ``--sharded`` the flash-serving pass also runs on two ranks, a
(1, 2) mesh (``launch.mesh``): the attention heads (whole GQA groups, and
their int8 KV with its power-of-two scale), the MLP hidden and the vocab
cut over the model axis, the row-cut projections summed through K2's
rank-split form, so INT's tokens are the one rank's.  On one card the
two ranks share it and take ``--dist-backend gloo``.  Equivalent CLI:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_1_7b \\
        --attn-kernel flash --mesh 1x2 [--device cpu | --dist-backend gloo]

Runs on the CUDA device unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.launch.serve import serve

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_1_7b")
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--sharded", action="store_true",
                    help="also run flash serving on a (1, 2) mesh of two "
                         "ranks")
    ap.add_argument("--dist-backend", default=None, choices=["gloo", "nccl"],
                    help="[--sharded] the ranks' backend (default nccl on "
                         "the card, gloo on the CPU; two ranks on one card "
                         "take gloo)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    fp = serve(args.arch, mode="fp", calibrate=False, gen=args.gen,
               device=args.device)
    q = serve(args.arch, mode="int", calibrate=True, gen=args.gen,
              device=args.device)
    agree = float(np.mean(fp["tokens"] == q["tokens"]))
    print(f"\n[{args.arch}] int8 vs FP greedy tokens: {agree:.2%} agreement")
    print(f"fp  sample: {fp['tokens'][0]}")
    print(f"int sample: {q['tokens'][0]}")
    print(f"decode: fp {1e3 * fp['decode_s_per_tok']:.1f} ms/tok | int "
          f"{1e3 * q['decode_s_per_tok']:.1f} ms/tok")

    if args.sharded:
        # head dim 128 and prompt 120: the flash kernels' serving shapes;
        # fp32, so the one-rank run's tokens are the comparison
        kern = dict(gen=8, prompt_len=120, mode="int", calibrate=True,
                    cfg_overrides={"head_dim": 128, "kv_cache_bits": 8,
                                   "dtype": "float32"})
        ref = serve(args.arch, device=args.device, **kern)
        sh = serve(args.arch, attn_kernel="flash", mesh_shape=(1, 2),
                   dist_backend=args.dist_backend, device=args.device,
                   **kern)
        agree_sh = float(np.mean(sh["tokens"] == ref["tokens"]))
        same = all(np.array_equal(r["tokens"], sh["tokens"])
                   for r in sh["ranks"])
        print(f"\n[{args.arch}] (1, 2) mesh flash vs one-rank chunked int8 "
              f"tokens: {agree_sh:.2%} agreement; the ranks' tokens "
              f"identical: {same}")
        print(f"sharded-flash decode: {1e3 * sh['decode_s_per_tok']:.1f} "
              f"ms/tok on a (data=1, model=2) mesh, KV heads split across "
              f"the ranks, int8 codes and scales resident on each")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
