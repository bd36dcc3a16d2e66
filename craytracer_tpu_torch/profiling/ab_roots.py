"""What the same-call A/B scripts (ab_k1, ab_bvh4, ab_render) share.

Each script times one checkout of the port (a ROOT) per fresh process:
`run_roots` starts the script itself with `--one ROOT` in that root and
collects the one JSON object each process prints last; `report` prints,
per case, each root's time in run order, the later roots' mean over the
first root's and, where the case is hashed, whether every root's outputs
are equal. The scripts start their child processes by file path, so
this module imports nothing of the package: a child imports the package
from its own root only.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys


def import_root(root: str) -> str:
    """Put `root` first on sys.path, import the package from it and
    return the absolute root; raise if the package came from elsewhere."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import craytracer_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(craytracer_tpu_torch.__file__)))
    if pkg_root != root:
        raise RuntimeError(f"imported the package from {pkg_root}, not {root}")
    return root


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else "unknown card"


def run_roots(script: str, roots, extra=(), timeout: int = 900):
    """Run `script --one ROOT *extra` in each root, one after another, each
    in a fresh process; print and return each one's last-line JSON object,
    or None after printing the first failure."""
    results = []
    for root in map(os.path.abspath, roots):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(script), "--one", root, *extra],
            capture_output=True, text=True, cwd=root, timeout=timeout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            print(f"FAIL: {root} exited {proc.returncode}")
            return None
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    return results


def report(tag: str, card_: str, results, cases) -> bool:
    """Print one line per case and return whether every hashed case has
    one hash across the roots. `cases` holds (heading, ms(result),
    hash(result) or None) triples; roots are named relative to the
    working directory."""
    first = results[0]["root"]
    same = True
    for heading, ms, hash_ in cases:
        by_root = {}
        for r in results:
            by_root.setdefault(r["root"], []).append(ms(r))
        means = {k: statistics.mean(v) for k, v in by_root.items()}
        line = (f"[{tag}] {card_}, {heading}, in run order: "
                + ", ".join(f"{os.path.relpath(r['root'])} {ms(r):.4f}"
                            for r in results)
                + "; each other root's mean / the first root's: "
                + ", ".join(f"{os.path.relpath(k)} "
                            f"{means[k] / means[first]:.4f}"
                            for k in means if k != first))
        if hash_ is not None:
            hashes = sorted({hash_(r) for r in results})
            same = same and len(hashes) == 1
            line += f"; output hashes {hashes}"
        print(line, flush=True)
    return same


def write_out(path, card_: str, results) -> None:
    """Save the card and every root's result as JSON, when a path is
    given."""
    if path:
        with open(path, "w") as f:
            json.dump({"card": card_, "runs": results}, f, indent=1)
