#!/usr/bin/env python3
"""Two checkouts' ``chip_smoke.py`` in one call, parent and change
alternated, with the arrival time of each phase's line.

    python3 tools/smoke_compare.py PARENT_DIR CHANGE_DIR

PARENT_DIR and CHANGE_DIR each hold a whole checkout (for instance
``git archive <commit> | tar -x -C DIR`` into a git-ignored directory).
The runs go parent, change, change, parent. Each run's standard output
and error go to ``chiprun_out/cmp_<i>_<label>.log`` and ``.err``; one
JSON line a run gives its exit code, wall seconds, each phase line's
arrival in seconds from the run's start (a phase's wall is the
difference from the line before it) and the sum of the ``tools_cli``
steps' walls; all of them go to ``chiprun_out/cmp_summary.json``. Needs
a CUDA card, as ``chip_smoke.py`` does.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

OUT = "chiprun_out"


def run_one(i: int, label: str, checkout: str) -> dict:
    t0 = time.time()
    stamps, tools, last = [], None, ""
    base = os.path.join(OUT, f"cmp_{i}_{label}")
    with open(base + ".err", "w") as err, open(base + ".log", "w") as log:
        p = subprocess.Popen([sys.executable, "chip_smoke.py"],
                             cwd=checkout, stdout=subprocess.PIPE,
                             stderr=err, text=True)
        for line in p.stdout:
            log.write(line)
            last = line.strip()
            if not line.startswith('{"phase"'):
                continue
            try:
                phase = json.loads(line)
            except ValueError:  # a phase line cut short by a failure
                continue
            stamps.append((phase["phase"], round(time.time() - t0, 1)))
            if phase["phase"] == "tools_cli":
                tools = phase["times_s"]
        rc = p.wait()
    return {"run": i, "label": label, "rc": rc,
            "wall_s": round(time.time() - t0, 1), "phases": stamps,
            "tools_steps_s": round(sum(tools.values()), 2) if tools else None,
            "last": last[:120]}


def main() -> None:
    args = sys.argv[1:]
    if len(args) != 2:
        raise SystemExit("usage: smoke_compare.py PARENT_DIR CHANGE_DIR")
    parent, change = ("parent", args[0]), ("change", args[1])
    os.makedirs(OUT, exist_ok=True)
    summary = []
    for i, (label, checkout) in enumerate((parent, change, change, parent)):
        summary.append(run_one(i, label, checkout))
        print(json.dumps(summary[-1]), flush=True)
    with open(os.path.join(OUT, "cmp_summary.json"), "w") as f:
        json.dump(summary, f)


if __name__ == "__main__":
    main()
