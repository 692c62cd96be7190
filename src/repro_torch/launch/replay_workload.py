"""Capture a serving workload and replay it deterministically: the port's
counterpart of ``examples/replay_workload.py``.

    PYTHONPATH=src python -m repro_torch.launch.replay_workload \\
        [--arch qwen3_1_7b] [--record OUT.json] [--legacy-ab] [--device cpu]

The flight recorder runs the engine on a virtual clock (``record=True``):
idle gaps jump straight to the next arrival and every step advances time
by a fixed ``virtual_dt``, so every scheduler decision is a function of
the workload and the engine's settings alone.  The capture freezes
arrivals, prompts, sampling parameters, seeds, the emitted tokens and the
scheduler-decision stream into a JSON
:class:`~repro_torch.obs.replay.WorkloadRecord`.

Replaying it on a fresh engine of the same settings reproduces the run
exactly: identical tokens and an empty decision diff.  Replaying it on
other settings (``--legacy-ab``: the legacy per-shape engine) keeps the
greedy tokens while the decision diff shows where the two schedulers
parted.  A record from either package replays on the other.  The same
flow from the CLI:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_1_7b \\
        --engine --requests 8 --record /tmp/rec.json
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_1_7b \\
        --replay /tmp/rec.json

Runs on the CUDA device unless ``--device cpu`` is given.  ``main``
returns the capture and the replays' results.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch.serve import serve_engine
from repro_torch.obs.replay import WorkloadRecord, replay_workload

__all__ = ["main"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_1_7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--record", default=None,
                    help="where to save the record (default: a temporary "
                         "file)")
    ap.add_argument("--legacy-ab", action="store_true",
                    help="also replay on the legacy per-shape engine and "
                         "show the decision diff")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    path = args.record
    if path is None:
        fd, path = tempfile.mkstemp(suffix="_record.json")
        os.close(fd)

    # -- capture ----------------------------------------------------------
    def build(**kw):
        kw.setdefault("record", True)
        return serve_engine(args.arch, n_requests=args.requests,
                            rate=200.0, n_slots=4, mode="fp",
                            calibrate=False, seed=args.seed, spec_k=2,
                            device=args.device, **kw)

    cap = build(record=path)
    rec = cap["record"]
    print(f"captured {rec.meta['n_requests']} requests, "
          f"{rec.meta['n_decisions']} scheduler decisions, "
          f"{rec.meta['wall_s_virtual']:.3f}s virtual "
          f"(fingerprint {rec.fingerprint}) -> {path}")

    # -- exact replay on a fresh engine -----------------------------------
    rec = WorkloadRecord.load(path)            # the portable artifact
    res = replay_workload(rec, build()["engine"])
    print(f"replay: token_identical={res.token_identical}, "
          f"decision diff {len(res.decision_diff)} lines, "
          f"fingerprint_match={res.fingerprint_match} "
          f"-> {'EXACT' if res.ok else 'DIVERGED'}")
    if not res.ok:
        raise SystemExit("identical settings must replay exactly")
    out = {"capture": cap, "record": rec, "path": path, "replay": res}

    # -- cross-config A/B --------------------------------------------------
    if args.legacy_ab:
        ab = out["legacy_ab"] = replay_workload(
            rec, build(ragged=False)["engine"])
        print(f"\nlegacy per-shape A/B: "
              f"token_identical={ab.token_identical}, "
              f"decision diff {len(ab.decision_diff)} lines "
              f"(fingerprints differ: {not ab.fingerprint_match})")
        for line in ab.decision_diff[:30]:
            print(f"  {line}")
        if len(ab.decision_diff) > 30:
            print(f"  ... {len(ab.decision_diff) - 30} more lines")
    return out


if __name__ == "__main__":
    main()
