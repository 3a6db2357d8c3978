"""The readings that the correctness limits are set from: for each seed,
one short window of the cell at its own sizes and load, the program's
numbers against the reference, and the control's: the reference at
bfloat16 put in the program's place on the same captured stages.

    python3 -m slam_bench.readings --workload <name> --seeds 11 12 13 --seconds 10 --out <file.jsonl>

A configuration and mix that ``BENCHMARK.json`` does not pair (a cell left
out for a fault of the program) are read with ``--config`` and
``--traffic``; the limits are then those of ``limits/<workload>.json``.

One process for all the seeds (the kernels build once); each line of the
output is one seed's ``{"seed", "program", "control", "correct"}``. Not part
of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback


def main(argv=None) -> int:
    from slam_bench import check, registry, run

    ap = argparse.ArgumentParser(prog="python3 -m slam_bench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--control", type=int, choices=[0, 1], default=1)
    ap.add_argument("--config")
    ap.add_argument("--traffic")
    args = ap.parse_args(argv)
    run._cache_dirs()
    if args.config:
        cell = {"name": args.workload, "config": args.config, "traffic": args.traffic}
    else:
        cell = registry.workload(registry.load_benchmark(), args.workload)
    with open(args.out, "a") as f:
        for seed in args.seeds:
            try:
                res = run.run_cell(cell["name"], registry.config(cell["config"]), registry.traffic(cell["traffic"]), seed,
                                   args.seconds, False, "cuda", check.load_limits(cell["name"]),
                                   judge_low=bool(args.control))
            except Exception:  # noqa: BLE001 - one seed's failure is a reading too; the others go on
                line = {"seed": seed, "error": traceback.format_exc()}
                f.write(json.dumps(line) + "\n")
                print(line["error"], file=sys.stderr, flush=True)
                continue
            line = {"seed": seed, "program": res["numbers"], "control": res["control"], "correct": res["correct"],
                    "sampled_ticks": res["sampled_ticks"], "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
