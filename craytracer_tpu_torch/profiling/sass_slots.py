"""Issue slots per (ray, triangle) pair of K6, counted from its SASS.

    python -m craytracer_tpu_torch.profiling.sass_slots [--rays N]
        [--tris T]

Builds csrc/tri_closest.cu (K6) as the port builds it (--fmad=false,
precise division), disassembles the library with `cuobjdump -sass`, and
finds the innermost loop of `k6_tri_kernel` that holds the Moller-Trumbore
test: the shortest span closed by a backward branch that contains the
test's reciprocal (MUFU.RCP, one per pair). Its instructions divided by
its MUFU.RCP count are the issue slots one pair takes (the division's slow
path, a call outside the loop, is left out). A streaming multiprocessor
issues one warp instruction per scheduler and cycle, four schedulers, so
the card issues 132 x 4 x 32 thread-instructions a cycle; at the card's
top SM clock (nvidia-smi clocks.max.sm) that is the issue-slot bound of
N x T pairs, printed beside the 67 TFLOP/s one of K6_OPS f32 operations a
pair (chip_smoke.py). Defaults: chip_smoke.py's K6 launch, 262,144 rays
against parity_mesh_mid's 20,480 triangles. Needs the CUDA toolkit and a
card (for the clock).
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

SMS, SCHEDULERS, WARP = 132, 4, 32
F32_OPS_PER_S = 67e12
K6_OPS = 53  # chip_smoke.py: f32 operations of one Moller-Trumbore test
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_TARGET = re.compile(r"\bBRA\S*\s+(?:[^,]*,\s*)?`?\(?0x([0-9a-f]+)")


def parse(sass: str, kernel: str):
    """[(address, opcode, text)] of the function whose name holds
    `kernel`."""
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if kernel in name:
            out = []
            for addr, text in _INSN.findall(part):
                toks = text.split()
                op = toks[1] if toks[0].startswith("@") else toks[0]
                out.append((int(addr, 16), op, text.strip()))
            return out
    raise ValueError(f"no function {kernel!r} in the SASS")


def innermost_loop(insns, marker: str = "MUFU.RCP"):
    """The instructions of the shortest backward-branch span holding
    `marker`."""
    best = None
    for k, (addr, op, text) in enumerate(insns):
        m = _TARGET.search(text) if op.startswith("BRA") else None
        if m is None or int(m.group(1), 16) > addr:
            continue
        lo = int(m.group(1), 16)
        span = [x for x in insns if lo <= x[0] <= addr]
        if any(x[1] == marker for x in span) and (
                best is None or len(span) < len(best)):
            best = span
    if best is None:
        raise ValueError(f"no loop holds {marker}")
    return best


def max_sm_clock_hz() -> float:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rays", type=int, default=262_144)
    ap.add_argument("--tris", type=int, default=20_480)
    args = ap.parse_args(argv)
    from craytracer_tpu_torch.cuda_build import nvcc
    from craytracer_tpu_torch.ops import tri_kernel
    from craytracer_tpu_torch.profiling import ab_roots

    lib = tri_kernel.LIBRARY
    lib.load()
    so = lib._paths()[0]
    tool = (shutil.which("cuobjdump")
            or os.path.join(os.path.dirname(nvcc()), "cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    loop = innermost_loop(parse(sass, "k6_tri_kernel"))
    pairs = sum(op == "MUFU.RCP" for _, op, _ in loop)
    slots = len(loop) / pairs
    hist = collections.Counter(op.split(".")[0] for _, op, _ in loop)
    clock = max_sm_clock_hz()
    n_pairs = args.rays * args.tris
    slot_ms = n_pairs * slots / (SMS * SCHEDULERS * WARP * clock) * 1e3
    ops_ms = n_pairs * K6_OPS / F32_OPS_PER_S * 1e3
    print(ab_roots.card())
    print(f"[sass] k6_tri_kernel ({so.name}): innermost loop "
          f"{len(loop)} instructions for {pairs} pairs: {slots:.2f} issue "
          f"slots a pair; per pair by opcode: "
          + ", ".join(f"{k} {v / pairs:.2f}" for k, v in hist.most_common()))
    print(f"[sass] {args.rays} rays x {args.tris} triangles = {n_pairs} "
          f"pairs at {clock / 1e6:.0f} MHz: issue-slot bound {slot_ms:.4f} "
          f"ms; {K6_OPS} f32 operations a pair at 67 TFLOP/s "
          f"{ops_ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
