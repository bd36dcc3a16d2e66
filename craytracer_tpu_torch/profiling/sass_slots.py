"""Issue slots per unit of work of K6 or P1, counted from their SASS.

    python -m craytracer_tpu_torch.profiling.sass_slots [--kernel k6]
        [--rays N] [--tris T]
    python -m craytracer_tpu_torch.profiling.sass_slots --kernel p1
        [--rays N] [--pops P]

Builds the kernel's source as the port builds it (--fmad=false, precise
division), disassembles the library with `cuobjdump -sass`, and finds the
innermost loop that holds the Moller-Trumbore tests: the shortest span
closed by a backward branch that contains the test's reciprocal
(MUFU.RCP, one per test). K6 (csrc/tri_closest.cu `k6_tri_kernel`): its
instructions over its MUFU.RCP count are the issue slots one (ray,
triangle) pair takes. P1 (csrc/pop_probe.cu, full mode `p1_kernel<6>`):
the shortest such loop with eight MUFU.RCP (the stack fill's integer
modulo has one) is one pop of a lane (eight tests), its instructions the
slots a lane-pop takes. The division's slow path, a
call outside the loop, is left out. A streaming multiprocessor issues
one warp instruction per scheduler and cycle, four schedulers, so the
card issues 132 x 4 x 32 thread-instructions a cycle; at the card's top
SM clock (nvidia-smi clocks.max.sm) that is the issue-slot bound of the
launch, printed beside the f32 operations it needs (chip_smoke.py's
counts: K6_OPS a pair; 4 slab tests, 8 Moller-Trumbore tests and the
sort a P1 lane-pop) at 67 TFLOP/s, the FMA rate, and at 33.5 T op/s, the
rate at which the --fmad=false build can issue them (every multiply and
add in its own slot). Defaults: chip_smoke.py's launches, K6 262,144 rays
against parity_mesh_mid's 20,480 triangles, P1 full mode 135,168 lanes x
128 pops. Needs the CUDA toolkit and a card (for the clock).
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
NO_FMA_OPS_PER_S = F32_OPS_PER_S / 2  # a multiply and an add, two slots
K6_OPS = 53  # chip_smoke.py: f32 operations of one Moller-Trumbore test
P1_OPS = 4 * 25 + 8 * 53 + 16  # chip_smoke.py: 4 BOX_OPS, 8 SLOT_OPS, SORT
P1_TESTS = 8  # Moller-Trumbore tests (MUFU.RCP) in one P1 pop
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


def innermost_loop(insns, marker: str = "MUFU.RCP", count: int = 1):
    """The instructions of the shortest backward-branch span holding
    `marker` at least `count` times."""
    best = None
    for k, (addr, op, text) in enumerate(insns):
        m = _TARGET.search(text) if op.startswith("BRA") else None
        if m is None or int(m.group(1), 16) > addr:
            continue
        lo = int(m.group(1), 16)
        span = [x for x in insns if lo <= x[0] <= addr]
        if sum(x[1] == marker for x in span) >= count and (
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
    ap.add_argument("--kernel", choices=("k6", "p1"), default="k6")
    ap.add_argument("--rays", type=int)
    ap.add_argument("--tris", type=int, default=20_480)
    ap.add_argument("--pops", type=int, default=128)
    args = ap.parse_args(argv)
    from craytracer_tpu_torch.cuda_build import nvcc
    from craytracer_tpu_torch.profiling import ab_roots

    if args.kernel == "k6":
        from craytracer_tpu_torch.ops import tri_kernel

        lib, func = tri_kernel.LIBRARY, "k6_tri_kernel"
        rays = args.rays or 262_144
        items, per, unit, ops = rays * args.tris, 1, "pair", K6_OPS
        what = f"{rays} rays x {args.tris} triangles"
    else:
        from craytracer_tpu_torch.profiling import pop_probe

        lib, func = pop_probe.LIBRARY, "p1_kernelILi6E"
        rays = args.rays or 135_168
        items, per, unit, ops = rays * args.pops, P1_TESTS, "lane-pop", \
            P1_OPS
        what = f"full mode, {rays} lanes x {args.pops} pops"
    lib.load()
    so = lib._paths()[0]
    tool = (shutil.which("cuobjdump")
            or os.path.join(os.path.dirname(nvcc()), "cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    loop = innermost_loop(parse(sass, func), count=per)
    units = sum(op == "MUFU.RCP" for _, op, _ in loop) / per
    slots = len(loop) / units
    hist = collections.Counter(op.split(".")[0] for _, op, _ in loop)
    clock = max_sm_clock_hz()
    slot_ms = items * slots / (SMS * SCHEDULERS * WARP * clock) * 1e3
    ops_ms = items * ops / F32_OPS_PER_S * 1e3
    no_fma_ms = items * ops / NO_FMA_OPS_PER_S * 1e3
    print(ab_roots.card())
    print(f"[sass] {func} ({so.name}): innermost loop {len(loop)} "
          f"instructions for {units:g} {unit}s: {slots:.2f} issue slots a "
          f"{unit}; per {unit} by opcode: "
          + ", ".join(f"{k} {v / units:.2f}" for k, v in hist.most_common()))
    print(f"[sass] {what} = {items} {unit}s at {clock / 1e6:.0f} MHz: "
          f"issue-slot bound {slot_ms:.4f} ms; {ops} f32 operations a "
          f"{unit} at 67 TFLOP/s {ops_ms:.4f} ms, at the --fmad=false "
          f"issue rate (33.5 T op/s) {no_fma_ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
