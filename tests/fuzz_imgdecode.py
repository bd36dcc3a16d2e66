"""Fuzz the port's image decoders (craytracer_tpu_torch/csrc/imgdecode*)
under AddressSanitizer and UndefinedBehaviorSanitizer.

Each case is a texture fixture of craytracer_tpu_torch/testdata/textures
mutated at random: cut short, bytes set or flipped, bytes inserted, or a
16- or 32-bit field of its first 512 bytes set to an edge value (0, 1,
the top bit, all ones), which reaches header fields such as sizes, bit
counts and channel masks. The plugin PIL's search picks
(io/imgopen.py) names the decoder; a decode must give an image or raise
ValueError / NotImplementedError / HandOn (the plugin hands the file on);
a sanitizer report, a crash, or a
decode that runs past 120 s ends the run, the case left in --out (an
image at PIL's pixel limit, which a mutated header can ask for, takes
about 10 s in this build).

    python tests/fuzz_imgdecode.py [--cases 20000] [--seed 0] [--out DIR]
                                   [--phase N]

--phase takes only the fixtures manifest.json marks with that chip_smoke.py
phase (55 for those without a mark), to fuzz one slice's decoders.

The library is built with g++ into craytracer_tpu_torch/_build/ with the
sanitizer flags, and the script runs itself again with libasan preloaded
(a Python that is not built with ASan needs it, and libstdc++, first in
the process).
"""

import argparse
import json
import os
import signal
import struct
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from craytracer_tpu_torch import native  # noqa: E402
from craytracer_tpu_torch.io import imgdecode  # noqa: E402
from craytracer_tpu_torch.io.teximage import image_kind  # noqa: E402

FIXTURES = ROOT / "craytracer_tpu_torch" / "testdata" / "textures"
SAN_FLAGS = ("-O1", "-g", "-fPIC", "-std=c++17", "-shared",
             "-ffp-contract=off", "-fsanitize=address,undefined",
             "-fno-sanitize-recover=all", "-fno-omit-frame-pointer")
EDGES = (0, 1, 0x7F, 0x80, 0xFF, 0x7FFF, 0x8000, 0xFFFF, 0x7FFFFFFF,
         0x80000000, 0xFFFFFFFF)


def mutate(data: bytearray, rng) -> bytearray:
    mode = int(rng.integers(5))
    if mode == 0:
        return data[:int(rng.integers(len(data)))]
    if mode == 4:
        width = 4 if rng.integers(2) else 2
        top = min(len(data), 512) - width
        if top > 0:
            i = int(rng.integers(top // width)) * width
            v = int(EDGES[int(rng.integers(len(EDGES)))]) & (
                (1 << 8 * width) - 1)
            fmt = ("<" if rng.integers(2) else ">") + "HI"[width // 4]
            data[i:i + width] = struct.pack(fmt, v)
        return data
    for _ in range(int(rng.integers(1, 8))):
        i = int(rng.integers(len(data)))
        data[i] = (int(rng.integers(256)) if mode == 1
                   else data[i] ^ (1 << int(rng.integers(8))))
    if mode == 3:
        j = int(rng.integers(len(data)))
        data[j:j] = rng.integers(0, 256, int(rng.integers(1, 40))).astype(
            np.uint8).tobytes()
    return data


def run(args) -> int:
    imgdecode._LIB = imgdecode.bind(
        native.build_shared(imgdecode.SOURCE, "imgdecode_san", SAN_FLAGS))
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    names = sorted(n for n, v in manifest.items() if "2048" not in n and (
        args.phase is None or v.get("phase", 55) == args.phase))
    rng = np.random.default_rng(args.seed)
    signal.signal(signal.SIGALRM, signal.SIG_DFL)  # a hang ends the process
    case = Path(args.out) / "fuzz_case.bin"
    counts = {"image": 0, "ValueError": 0, "NotImplementedError": 0,
              "HandOn": 0}
    for it in range(args.cases):
        name = names[int(rng.integers(len(names)))]
        data = bytes(mutate(bytearray((FIXTURES / name).read_bytes()), rng))
        case.write_bytes(data)
        (Path(args.out) / "fuzz_case.txt").write_text(f"{it} {name}\n")
        try:
            kind = image_kind(data)
        except (ValueError, NotImplementedError):
            continue
        signal.alarm(120)
        try:
            imgdecode.decode(data, kind, name)
            counts["image"] += 1
        except (ValueError, NotImplementedError, imgdecode.HandOn) as e:
            counts[type(e).__name__] += 1
        signal.alarm(0)
    print(f"{args.cases} cases over {len(names)} fixtures: {counts}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=tempfile.gettempdir())
    ap.add_argument("--phase", type=int, default=None)
    args = ap.parse_args()
    if os.environ.get("IMGDECODE_FUZZ_CHILD"):
        return run(args)
    # libstdc++ too, so that ASan finds the __cxa_throw it wraps
    pre = [subprocess.run(["g++", f"-print-file-name={lib}"],
                          capture_output=True, text=True).stdout.strip()
           for lib in ("libasan.so", "libstdc++.so")]
    env = dict(os.environ, IMGDECODE_FUZZ_CHILD="1", LD_PRELOAD=" ".join(pre),
               ASAN_OPTIONS="detect_leaks=0")
    rc = subprocess.run([sys.executable, *sys.argv], env=env).returncode
    if rc:
        print(f"the decoder failed (exit {rc}) on the case in "
              f"{args.out}/fuzz_case.bin: "
              f"{(Path(args.out) / 'fuzz_case.txt').read_text().strip()}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
