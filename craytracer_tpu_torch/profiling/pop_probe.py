"""P1, what one pop of the BVH4 packet walk costs on the card (counterpart
of profiling/ablate_pallas_pop.py: `make_kernel` :43, `run` :160, `main`
:177).

    python -m craytracer_tpu_torch.profiling.pop_probe [--nodes 20000]
        [--pops 512] [--warps 4224]

A packet (a warp of 32 lanes on the card) walks a preloaded stack of
`pops` node ids, the LCG (i * 1103515245 + 12345) mod m in int32, with
no pushes, so the trip count is exactly `pops`; each of the seven modes
(MODES: empty, rowload, cols, colsdir, box, mt, full) adds one piece of
K3's loop body (csrc/pop_probe.cu describes each). `pop_probe` is the
plain version in torch ops at the same packet width, `pop_probe_kernel`
the wrapper (plain version for CPU tensors; the CUDA C++ kernel for CUDA
tensors, or it raises), `KERNEL.launches` its launch count. `measure`
times every mode at two pop counts with CUDA events (median of 5 each)
and takes the slope: ns per pop of the whole launch and per packet.
`main` does so on a table of random rows, as the TPU probe does, and
prints one JSON line with the card's name and power limit. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from craytracer_tpu_torch.cuda_build import CudaLibrary, LaunchCount

MODES = ("empty", "rowload", "cols", "colsdir", "box", "mt", "full")
PACKET = 32
BIG = 3.0e38
MAX_POPS = 3072  # four packets' stacks in 48 KB of shared memory
FAT_COLS = 128


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.p1_launch.argtypes = [vp, ci, vp, vp, ci, ci, ci, vp, vp, vp]
    lib.p1_launch.restype = ci


LIBRARY = CudaLibrary("pop_probe", bind=_bind)
KERNEL = LaunchCount()  # P1 launches


def lcg_nodes(pops: int, m: int) -> list:
    """The preloaded stack: (i * 1103515245 + 12345) wrapped to int32,
    floor-mod m, for i < pops."""
    out = []
    for i in range(pops):
        v = (i * 1103515245 + 12345) & 0xFFFFFFFF
        v = v - (1 << 32) if v >= (1 << 31) else v
        out.append(v % m)
    return out


def _wrap32(x):
    """int64 tensor -> its value wrapped to int32."""
    return (((x + (1 << 31)) % (1 << 32)) - (1 << 31)).to(torch.int32)


@torch.no_grad()
def pop_probe(fat, o, d, mode: str, pops: int):
    """Plain version: (t [N] f32, sink [N] int32) of `pops` pops in
    `mode`, packets of 32 consecutive lanes (N a multiple of 32)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    n = o.shape[0]
    if n % PACKET:
        raise ValueError(f"P1 takes a multiple of {PACKET} rays")
    dev = o.device
    w = n // PACKET
    ox, oy, oz = (o[:, k].reshape(w, PACKET) for k in range(3))
    dx, dy, dz = (d[:, k].reshape(w, PACKET) for k in range(3))
    ivx, ivy, ivz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    best_t = torch.full((w, PACKET), BIG, dtype=torch.float32, device=dev)
    acc = torch.zeros((w, 1), dtype=torch.int64, device=dev)
    sink = torch.zeros((w, 1), dtype=torch.int64, device=dev)
    nodes = lcg_nodes(pops, fat.shape[0])
    for node in reversed(nodes):
        row = fat[node]
        if mode == "empty":
            acc = acc + node
            continue
        if mode == "rowload":
            acc = acc + int(row[0].to(torch.int32))
            continue
        if mode in ("cols", "colsdir"):
            s = row[0]
            for j in range(1, 108):
                s = s + row[j]
            acc = acc + int(s.to(torch.int32))
            continue
        key, cval = [], []
        if mode in ("box", "full"):
            for c in range(4):
                t0x = (row[c * 3] - ox) * ivx
                t1x = (row[12 + c * 3] - ox) * ivx
                t0y = (row[c * 3 + 1] - oy) * ivy
                t1y = (row[12 + c * 3 + 1] - oy) * ivy
                t0z = (row[c * 3 + 2] - oz) * ivz
                t1z = (row[12 + c * 3 + 2] - oz) * ivz
                tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                                 torch.minimum(t0y, t1y)),
                                   torch.minimum(t0z, t1z))
                tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                                 torch.maximum(t0y, t1y)),
                                   torch.maximum(t0z, t1z))
                lane_hit = (tn <= tf) & (tf > 0.0) & (tn < best_t)
                tn_c = torch.where(lane_hit, tn, BIG).amin(dim=1,
                                                           keepdim=True)
                hit_any = lane_hit.any(dim=1, keepdim=True)
                child = int(row[24 + c].to(torch.int32))
                sink = (sink + hit_any.to(torch.int64)
                        + tn_c.view(torch.int32).to(torch.int64))
                want = hit_any & (child >= 0)
                key.append(torch.where(want, tn_c, -BIG))
                cval.append(torch.where(want, child, -1))
        if mode in ("mt", "full"):
            for k in range(8):
                b = 28 + k * 10
                v0x, v0y, v0z = row[b], row[b + 1], row[b + 2]
                e1x, e1y, e1z = row[b + 3], row[b + 4], row[b + 5]
                e2x, e2y, e2z = row[b + 6], row[b + 7], row[b + 8]
                tid = int(row[b + 9].to(torch.int32))
                px = dy * e2z - dz * e2y
                py = dz * e2x - dx * e2z
                pz = dx * e2y - dy * e2x
                det = e1x * px + e1y * py + e1z * pz
                inv_det = 1.0 / det
                tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
                beta = (tx * px + ty * py + tz * pz) * inv_det
                qx = ty * e1z - tz * e1y
                qy = tz * e1x - tx * e1z
                qz = tx * e1y - ty * e1x
                gamma = (dx * qx + dy * qy + dz * qz) * inv_det
                tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
                ok = ((tid >= 0) & (beta >= 0.0) & (gamma >= 0.0)
                      & (beta + gamma <= 1.0) & (tt > 1e-4) & (tt < best_t))
                best_t = torch.where(ok, tt, best_t)
        if mode == "full":
            for i, j in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
                do = key[i] < key[j]
                key[i], key[j] = (torch.where(do, key[j], key[i]),
                                  torch.where(do, key[i], key[j]))
                cval[i], cval[j] = (torch.where(do, cval[j], cval[i]),
                                    torch.where(do, cval[i], cval[j]))
            acc = acc + cval[0]
    t = best_t + _wrap32(acc).to(torch.float32)
    return (t.reshape(n), _wrap32(sink).expand(w, PACKET).reshape(n))


@torch.no_grad()
def pop_probe_kernel(fat, o, d, mode: str, pops: int):
    """(t [N] f32, sink [N] int32): P1 for CUDA tensors, the plain version
    for CPU tensors."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    dev = o.device
    for x in (fat, o, d):
        if x.device != dev:
            raise ValueError(f"P1 inputs on {x.device} and {dev}")
    if dev.type == "cpu":
        return pop_probe(fat, o, d, mode, pops)
    if dev.type != "cuda":
        raise ValueError(f"P1 runs on CUDA tensors, not {dev}")
    n = o.shape[0]
    if not (fat.dtype == o.dtype == d.dtype == torch.float32
            and fat.dim() == 2 and fat.shape[1] == FAT_COLS
            and fat.shape[0] > 0 and fat.is_contiguous()
            and fat.data_ptr() % 16 == 0 and o.shape == d.shape == (n, 3)
            and o.is_contiguous() and d.is_contiguous()
            and n % PACKET == 0 and 1 <= pops <= MAX_POPS):
        raise ValueError(
            f"P1 takes contiguous f32 CUDA tensors: fat [M, {FAT_COLS}] "
            f"(16-byte aligned), o, d [N, 3] with N a multiple of {PACKET}, "
            f"and 1 <= pops <= {MAX_POPS}")
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    sink = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t, sink
    lib = LIBRARY.load()
    err = lib.p1_launch(fat.data_ptr(), fat.shape[0], o.data_ptr(),
                        d.data_ptr(), n, pops, MODES.index(mode),
                        t.data_ptr(), sink.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
    LIBRARY.check(err, "P1")
    KERNEL.launches += 1
    return t, sink


def _launch_ms(fat, o, d, mode, pops, reps=5):
    """Median ms of one P1 launch (CUDA events, after a warm-up)."""
    pop_probe_kernel(fat, o, d, mode, pops)
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        pop_probe_kernel(fat, o, d, mode, pops)
        stop.record()
        torch.cuda.synchronize()
        ts.append(start.elapsed_time(stop))
    return statistics.median(ts)


def measure(fat, o, d, pops: int = 512):
    """{mode: (ns per pop of the whole launch, ns per packet-pop)}: the
    slope of the launch time between `pops` and 3 * `pops` pops; a
    packet-pop is that over the launch's packets (o.shape[0] / 32)."""
    packets = o.shape[0] // PACKET
    out = {}
    for mode in MODES:
        ms1 = _launch_ms(fat, o, d, mode, pops)
        ms3 = _launch_ms(fat, o, d, mode, 3 * pops)
        step_ns = (ms3 - ms1) * 1e6 / (2 * pops)
        out[mode] = (step_ns, step_ns / packets)
    return out


def card_line() -> str:
    """nvidia-smi's name and power limit of the card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else "?"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=20000)
    ap.add_argument("--pops", type=int, default=512)
    ap.add_argument("--warps", type=int, default=4224,
                    help="packets of 32 lanes (default: 32 per SM of 132)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("P1 measures the card: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    fat = torch.from_numpy(rng.random((args.nodes, FAT_COLS), np.float32)
                           + 0.5).to(dev)
    n = args.warps * PACKET
    o = torch.from_numpy(rng.random((n, 3), np.float32)).to(dev)
    d = torch.from_numpy(rng.random((n, 3), np.float32) + 0.1).to(dev)
    res = measure(fat, o, d, args.pops)
    print(json.dumps({
        "card": card_line(), "nodes": args.nodes, "pops": args.pops,
        "packets": args.warps, "packet_lanes": PACKET,
        "ns_per_pop": {k: v[0] for k, v in res.items()},
        "ns_per_packet_pop": {k: v[1] for k, v in res.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
