"""Same-call A/B of the whole `chip_smoke.py` between checkouts of the port.

    python -m craytracer_tpu_torch.profiling.ab_smoke ROOT [ROOT ...]
        [--out DIR]

Each ROOT is a directory holding a checkout's `chip_smoke.py` (an older
checkout unpacked with `git archive`, or `.` for this one). The roots
run one after another, each as `python3 chip_smoke.py` with no
arguments from its root, unbuffered, so give them in an interleaved
order (parent, change, change, parent) to see the machine's drift. Every line a smoke
prints is stamped with the seconds since its process started and
written to DIR/ab_smoke_<i>.log (default chiprun_out/, the directory
the card's runner brings back). Printed per root: the exit code, the
seconds to its end, and the seconds of each phase group, from the first
line of the group's tag to the first line of the next group present
(null for a group that root does not run), then the card's name and
power limit. Needs a CUDA card; the phase tags are those the smoke
prints.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

# (group, the tag of its first line), in the order the smoke runs them
GROUPS = (("1-36", "[device]"), ("38-43 slice F", "[slice-f] 38"),
          ("44-48 slice I", "[slice-i] 44"), ("49-50 slice H", "[slice-h] 49"),
          ("51-54 slice K", "[slice-k] 51"), ("55 slice L", "[slice-l] 55"),
          ("56 slice M", "[slice-m] 56"), ("37 and the result", "[inverse]"))
_STAMP = re.compile(r"\s*(\d+(?:\.\d+)?) (.*)")


def group_seconds(stamped_lines) -> tuple[dict, float]:
    """({group: seconds or None}, seconds of the last line) of one smoke's
    stamped output lines ("<seconds> <line>")."""
    first, end = {}, 0.0
    for line in stamped_lines:
        m = _STAMP.match(line)
        if not m:
            continue
        t, text = float(m.group(1)), m.group(2)
        end = t
        for name, tag in GROUPS:
            if name not in first and text.startswith(tag):
                first[name] = t
    starts = [(first[n], n) for n, _ in GROUPS if n in first]
    out = dict.fromkeys((n for n, _ in GROUPS), None)
    for (t, n), (t_next, _) in zip(starts, starts[1:] + [(end, None)]):
        out[n] = t_next - t
    return out, end


def run_smoke(root: str, log: str) -> int:
    """Run `root`'s chip_smoke.py, writing its stamped lines to `log`;
    return its exit code."""
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    t0 = time.perf_counter()
    with open(log, "w") as out, subprocess.Popen(
            [sys.executable, "chip_smoke.py"], cwd=root, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT) as proc:
        for line in proc.stdout:
            out.write(f"{time.perf_counter() - t0:9.2f} {line}")
        return proc.wait()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    results = []
    for i, root in enumerate(args.roots):
        log = os.path.join(args.out, f"ab_smoke_{i}.log")
        rc = run_smoke(os.path.abspath(root), log)
        with open(log) as f:
            groups, end = group_seconds(f)
        results.append({"root": root, "rc": rc, "seconds": round(end, 2),
                        "groups": {k: None if v is None else round(v, 2)
                                   for k, v in groups.items()}, "log": log})
        print(json.dumps(results[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0 if all(r["rc"] == 0 for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
