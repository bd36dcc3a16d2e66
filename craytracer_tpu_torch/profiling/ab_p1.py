"""Same-call A/B of P1, the pop probe, between checkouts of the port.

    python -m craytracer_tpu_torch.profiling.ab_p1 ROOT [ROOT ...]
        [--nodes 20000] [--pops 512] [--warps 4224] [--out FILE.json]

Each ROOT is a directory holding a `craytracer_tpu_torch/` package (an
older checkout unpacked with `git archive`, or `.` for this one). Each
root, one after another, runs in a fresh process that imports the
package from its root (ab_roots.run_roots), builds its own P1 and, on
the same inputs (pop_probe.main's: `nodes` random rows of 128 floats and
`warps` packets of 32 random rays, from seed 0), launches every mode
through `pop_probe_kernel` (a signature every checkout of the port
shares): once at `pops` pops, t and sink hashed, then `measure`'s ns per
pop (the slope of the launch time between `pops` and 3 x `pops`, CUDA
events, median of 5 each). Give the roots interleaved (parent, change,
change, parent) to see the machine's drift. Prints one JSON line per
process, the card's name and power limit, and per mode each root's ns
per pop of the launch and per packet-pop, the later roots' mean over the
first root's, and whether every root's outputs are equal. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

if __package__:
    from craytracer_tpu_torch.profiling import ab_roots
else:  # a child process, started by file path: a sibling import
    import ab_roots

# pop_probe.MODES, named here: this process imports nothing of a package
MODES = ("empty", "rowload", "cols", "colsdir", "box", "mt", "full")


def _one(root: str, nodes: int, pops: int, warps: int) -> dict:
    root = ab_roots.import_root(root)
    import numpy as np
    import torch

    from craytracer_tpu_torch.profiling import pop_probe as pp

    dev = torch.device("cuda")
    pp.LIBRARY.load()
    rng = np.random.default_rng(0)
    fat = torch.from_numpy(rng.random((nodes, pp.FAT_COLS), np.float32)
                           + 0.5).to(dev)
    n = warps * pp.PACKET
    o = torch.from_numpy(rng.random((n, 3), np.float32)).to(dev)
    d = torch.from_numpy(rng.random((n, 3), np.float32) + 0.1).to(dev)
    out = {"root": root, "ptxas": [
        line.strip() for line in pp.LIBRARY.ptxas_log.splitlines()
        if "registers" in line or "spill" in line]}
    per_pop = pp.measure(fat, o, d, pops)
    for mode in MODES:
        h = hashlib.sha256()
        for r in pp.pop_probe_kernel(fat, o, d, mode, pops):
            h.update(r.cpu().numpy().tobytes())
        out[mode] = {"hash": h.hexdigest()[:16],
                     "ns_per_pop": per_pop[mode][0],
                     "ns_per_packet_pop": per_pop[mode][1]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--nodes", type=int, default=20000)
    ap.add_argument("--pops", type=int, default=512)
    ap.add_argument("--warps", type=int, default=4224)
    ap.add_argument("--out")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(_one(args.one, args.nodes, args.pops, args.warps)),
              flush=True)
        return 0
    if not args.roots:
        ap.error("give at least one ROOT")
    results = ab_roots.run_roots(
        __file__, args.roots, ("--nodes", str(args.nodes), "--pops",
                               str(args.pops), "--warps", str(args.warps)))
    if results is None:
        return 1
    card = ab_roots.card()
    print(card)
    cases = []
    for mode in MODES:
        cases.append((f"P1 {mode}, {args.warps} packets, {args.nodes} rows, "
                      f"ns per pop of the launch",
                      lambda r, m=mode: r[m]["ns_per_pop"],
                      lambda r, m=mode: r[m]["hash"]))
        cases.append((f"P1 {mode}, ns per packet-pop",
                      lambda r, m=mode: r[m]["ns_per_packet_pop"], None))
    same = ab_roots.report("ab-p1", card, results, cases)
    print(f"[ab-p1] every root's outputs bit-equal in every mode: {same}")
    ab_roots.write_out(args.out, card, results)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
