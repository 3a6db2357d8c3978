#!/usr/bin/env python3
"""Instructions K5 (``csrc/score_hypotheses.cu``, RANSAC scoring) runs a
point-hypothesis test, read from the SASS of its built library.

    python semantic_slam_tpu_torch/tools/k5_sass.py [--out FILE]

Builds the kernel libraries with nvcc if they are missing or stale (the CUDA
toolkit is needed, a card is not), disassembles ``libscore_hypotheses.so``
with ``cuobjdump -sass`` and finds the scoring kernel's inner loop: the
smallest backward-branch loop that holds warp sums (REDUX, one a
hypothesis), in which each thread tests its ``PTS_PER_THREAD`` points
against the hypotheses. Of that loop it counts the test's own fp32
instructions (the two dot products' FMUL and FFMA, the offset's FADD, the
compares' FSETP with the predicate AND folded in) over hypotheses x points,
and adds the count's select and add (``c += test ? 1 : 0``), which the
compiler writes as predicated integer moves and adds among the loop's own
integer work. The loop's shared-memory loads, warp sums, the ``lane == j``
select and the loop counter are the kernel's overhead, not the function's,
and are left out. ``chip_smoke.py`` bounds K5 with this count
(``K5_INSTR_PER_TEST``) at the card's instruction rate. Prints one JSON
object; ``--out`` also writes the loop's SASS.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
# the test's fp32 instructions: products, FMAs, the offset add, the compares
FP_OPS = ("FMUL", "FFMA", "FADD", "FSETP")
# the count's select and add a test, written in the source as c += test ? 1 : 0
COUNT_OPS = 2


def inner_loop(sass: str) -> tuple[list[str], int]:
    """The instructions of ``score_kernel``'s smallest backward-branch loop
    that holds warp sums, and its number of warp sums (hypotheses)."""
    text = sass[sass.index("score_kernel"):]
    ins = [(int(a, 16), op) for a, op in re.findall(r"^\s*/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", text, re.M)]
    loops = []
    for addr, op in ins:
        m = re.search(r"\bBRA\s+(0x[0-9a-f]+)", op)
        if m and int(m.group(1), 16) < addr:
            body = [o for a, o in ins if int(m.group(1), 16) <= a <= addr]
            redux = sum(1 for o in body if "REDUX" in o)
            if redux:
                loops.append((len(body), redux, body))
    if not loops:
        raise ValueError("score_kernel's SASS holds no loop with a warp sum")
    _, redux, body = min(loops, key=lambda t: t[0])
    return body, redux


def per_test(sass: str, pts: int) -> dict:
    """The count a point-hypothesis test: fp32 instructions of the inner loop
    over hypotheses x ``pts`` points, plus ``COUNT_OPS``."""
    body, hyps = inner_loop(sass)
    opcode = [o.split()[1] if o.startswith("@") else o.split()[0] for o in body]
    fp = sum(1 for op in opcode if op.split(".")[0] in FP_OPS)
    return {"loop_instructions": len(body), "hypotheses": hyps, "points": pts, "fp_instructions": fp,
            "fp_per_test": fp / (hyps * pts), "count_ops": COUNT_OPS, "per_test": fp / (hyps * pts) + COUNT_OPS}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", help="write the inner loop's SASS here")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from semantic_slam_tpu_torch import _build

    _build.build()
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    lib = str(_build.lib_path("score_hypotheses"))
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, timeout=120, check=True).stdout
    with open(_build.SOURCES_DIR / "score_hypotheses.cu") as f:
        pts = int(re.search(r"PTS_PER_THREAD = (\d+);", f.read()).group(1))
    res = per_test(sass, pts)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(inner_loop(sass)[0]) + "\n")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
