"""The full-fidelity demonstration scene's mesh: writes
scenes/fullscene.obj (the port's copy of the OBJ emission of
scenes/make_fullscene.py:152-261, which needs the JAX package to write its
EXR and PIL for its PNGs).

A 64 x 64 floor grid 120 units across (uv tiled 6x, material `floor`:
the checker texture and the normal map), a field of icosphere(3)
spheres (1,280 triangles each) on a jittered grid with materials drawn
from one seeded generator (seed 11: `blotch` with spherical uv, GOLD,
SILVER, COPPER, glass, plastic_blue with vertex normals), three
icosphere(5) boulders (20,480 triangles each) and two emissive icosphere(3)
lamp spheres, each a `g`/`usemtl` group, and `mtllib fullscene.mtl`.
With the default 380 spheres that is 558,592 triangles. The XL variant
(`xl`, make_fullscene.py --xl, :156-169) takes icosphere(4) spheres and
lamps (5,120 triangles each) and icosphere(6) boulders (81,920), 450
spheres by default, and writes scenes/fullscene_xl.obj: 2,568,192
triangles. The tracked scenes/fullscene.txt and fullscene_xl.txt, .mtl,
PNGs and EXR are read as they are; only the OBJ is written, and its bytes
equal make_fullscene.py's for the same sphere count and variant.

    python -m craytracer_tpu_torch.scene.fullscene [--xl] [--spheres N]
        [--out PATH]
"""

from __future__ import annotations

import argparse
import io
import os

import numpy as np

from craytracer_tpu_torch.scene.city import icosphere

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "scenes")
OBJ = os.path.join(SCENES, "fullscene.obj")
OBJ_XL = os.path.join(SCENES, "fullscene_xl.obj")
SPHERES = 380
SPHERES_XL = 450
# (sphere and lamp, boulder) icosphere levels of each variant
LEVELS = {False: (3, 5), True: (4, 6)}


def obj_text(spheres: int = SPHERES, xl: bool = False) -> str:
    """The OBJ file's text for `spheres` spheres, of the XL variant when
    `xl`."""
    rng = np.random.default_rng(11)
    buf = io.StringIO()
    buf.write("mtllib fullscene.mtl\n")
    base = {"v": 1, "vt": 1}  # OBJ indices are 1-based

    def emit(verts, faces, uvs, norms, group, mtl):
        np.savetxt(buf, verts, fmt="v %.5f %.5f %.5f")
        if uvs is not None:
            np.savetxt(buf, uvs, fmt="vt %.5f %.5f")
        if norms is not None:
            np.savetxt(buf, norms, fmt="vn %.4f %.4f %.4f")
        buf.write(f"g {group}\nusemtl {mtl}\n")
        f = faces + base["v"]
        if uvs is not None:
            t = faces + base["vt"]
            if norms is not None:
                rows = np.stack([f[:, 0], t[:, 0], f[:, 0], f[:, 1], t[:, 1],
                                 f[:, 1], f[:, 2], t[:, 2], f[:, 2]], axis=1)
                np.savetxt(buf, rows, fmt="f %d/%d/%d %d/%d/%d %d/%d/%d")
            else:
                rows = np.stack([f[:, 0], t[:, 0], f[:, 1], t[:, 1],
                                 f[:, 2], t[:, 2]], axis=1)
                np.savetxt(buf, rows, fmt="f %d/%d %d/%d %d/%d")
            base["vt"] += uvs.shape[0]
        else:
            np.savetxt(buf, f, fmt="f %d %d %d")
        base["v"] += verts.shape[0]

    # the floor: 64 x 64 cells over 120 x 120 units, uv tiled 6x
    n, ext = 64, 60.0
    g = np.linspace(-ext, ext, n + 1)
    gx, gz = np.meshgrid(g, g)
    fverts = np.stack([gx.ravel(), np.zeros(gx.size), gz.ravel()], axis=-1)
    fuv = np.stack([(gx.ravel() / ext + 1) * 3, (gz.ravel() / ext + 1) * 3],
                   axis=-1)
    idx = np.arange((n + 1) * (n + 1)).reshape(n + 1, n + 1)
    a, b, c, d = (idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel(),
                  idx[1:, 1:].ravel(), idx[1:, :-1].ravel())
    emit(fverts, np.concatenate([np.stack([a, b, c], axis=-1),
                                 np.stack([a, c, d], axis=-1)]),
         fuv, None, "floor", "floor")

    def sphere_uv(v):
        return np.stack([0.5 + np.arctan2(v[:, 2], v[:, 0]) / (2 * np.pi),
                         0.5 - np.arcsin(np.clip(v[:, 1], -1, 1)) / np.pi],
                        axis=-1)

    # the sphere field
    v3, f3 = icosphere(LEVELS[xl][0])
    v5, f5 = icosphere(LEVELS[xl][1])
    uv3 = sphere_uv(v3)
    groups = ["blotch", "GOLD", "SILVER", "COPPER", "glass", "plastic_blue"]
    weights = [0.34, 0.13, 0.13, 0.12, 0.14, 0.14]
    grid_n = int(np.ceil(np.sqrt(spheres)))
    step = 2 * (ext - 4) / grid_n
    k = 0
    for i in range(grid_n):
        for j in range(grid_n):
            if k >= spheres:
                break
            c = np.array([-(ext - 4) + (i + 0.5) * step + rng.normal(0, 0.5),
                          0.0,
                          -(ext - 4) + (j + 0.5) * step + rng.normal(0, 0.5)])
            s = 0.55 + rng.random() * 0.9
            c[1] = s  # resting on the floor
            mtl = groups[rng.choice(len(groups), p=weights)]
            emit(v3 * s + c, f3, uv3 if mtl == "blotch" else None,
                 v3 if mtl != "blotch" else None, f"s{k}", mtl)
            k += 1

    # three smooth high-resolution boulders
    for bi, (bx, bz, bs, mtl) in enumerate(
            [(-18, -12, 6.0, "blotch"), (14, 6, 7.5, "GOLD"),
             (2, -25, 5.0, "glass")]):
        c = np.array([bx, bs * 0.8, bz])
        emit(v5 * bs + c, f5, sphere_uv(v5) if mtl == "blotch" else None,
             v5 if mtl != "blotch" else None, f"boulder{bi}", mtl)

    # two emissive lamp spheres
    for li, (lx, lz) in enumerate([(-8, 14), (22, -18)]):
        emit(v3 * 1.8 + np.array([lx, 6.0, lz]), f3, None, None,
             f"lamp{li}", "lamp")
    return buf.getvalue()


def write_obj(path: str = OBJ, spheres: int = SPHERES,
              xl: bool = False) -> str:
    with open(path, "w") as f:
        f.write(obj_text(spheres, xl))
    return path


def triangle_count(spheres: int = SPHERES, xl: bool = False) -> int:
    """Triangles in the OBJ for `spheres` spheres: the floor's 2 x 64 x 64,
    20 x 4^level per sphere and lamp and per boulder (1,280 and 20,480;
    5,120 and 81,920 in the XL variant)."""
    small, big = (20 * 4 ** k for k in LEVELS[xl])
    return 2 * 64 * 64 + (spheres + 2) * small + 3 * big


def ensure_obj(path: str = OBJ, spheres: int = SPHERES,
               xl: bool = False) -> bool:
    """Write the OBJ for `spheres` spheres unless the file at `path`
    already holds exactly that text (a file written for another sphere
    count or variant is replaced); True when it was written."""
    text = obj_text(spheres, xl)
    if os.path.exists(path):
        with open(path) as f:
            if f.read() == text:
                return False
    with open(path, "w") as f:
        f.write(text)
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--xl", action="store_true",
                    help=f"the XL variant ({SPHERES_XL} spheres by "
                    "default, scenes/fullscene_xl.obj)")
    ap.add_argument("--spheres", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    spheres = args.spheres
    if spheres is None:
        spheres = SPHERES_XL if args.xl else SPHERES
    out = write_obj(args.out or (OBJ_XL if args.xl else OBJ), spheres,
                    args.xl)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
