"""Reference-compatible scene-file parser (counterpart of
craytracer_tpu/io/scenefile.py; `_parse_material` :135, `_load_texture`
:198, `_parse_object` :210, `_ns_to_roughness` :261,
`_mtl_material_name` :269, `_parse_mesh` :313, `load_scene_file` :347).

The same keyword-driven, tolerant reading of the positional grammar
(scene/scenefile.h:92-791): block collection, preset colors, legacy
material keys, C-`atof` floats, film/camera header defaults; every
material type (MATTE, MIRROR, TRANSPARENT, EMISSIVE, PLASTIC, GLASS,
METAL with its TYPE preset, and the legacy REFLECTIVE as plastic);
OBJECT SPHERE (with the PHI / MIN_THETA / MAX_THETA clip defaults),
PLANE, RECTANGLE, TRIANGLE, DISK, the instanced BOX, OPENCYLINDER (with
its NORMAL_TYPE), SOLIDCYLINDER and TORUS (LOCATION, SCALE,
ORIENTATION), and MESH (FILE/FILE_NAME, SMOOTH, SCALING, LOCATION,
ORIENTATION; the file is looked up beside the scene file, then in the
working directory, and a mesh file that cannot be found is skipped, as
the JAX parser skips it, :323-324; `MATERIAL FROM_MTL` binds each OBJ
group to its MTL material), the POINT_LIGHT and DIRECTIONAL_LIGHT
blocks (:387-405, the JAX grammar's extension), and ENV_LIGHT of TYPE
CONSTANT or TEXTURE (a lat-long image through the fixed rot-y(-0.76),
with `IMPORTANCE yes` for texel sampling). Materials take `TEXTURE` or
`KD_TEXTURE` (and the `COLOR TEXTURE <file>` form) as diffuse texture
and MATTE a `NORMAL_MAP`; a texture is looked up beside the scene file,
then in the working directory, and one that is missing or unreadable is
dropped, as the JAX parser drops it (io/teximage.py). A shape the parser
does not know is skipped, as in the JAX parser.

Returns (Scene, Camera, Film) on the CUDA card unless the caller asks
for another device.
"""

from __future__ import annotations

import math
import os

import torch

from craytracer_tpu_torch.camera import Film, make_camera
from craytracer_tpu_torch.constants import METAL_PRESETS, PI, PRESET_COLORS
from craytracer_tpu_torch.io.objloader import compute_vertex_normals, load_obj
from craytracer_tpu_torch.io.teximage import load_texture_image
from craytracer_tpu_torch.io.tokenizer import TokenStream, atof, tokenize
from craytracer_tpu_torch.scene import types as T
from craytracer_tpu_torch.scene.build import SceneBuilder
from craytracer_tpu_torch.scene.types import resolve_device

_OBJECT_TYPES = {
    "SPHERE", "PLANE", "RECTANGLE", "TRIANGLE", "BOX", "OPENCYLINDER",
    "SOLIDCYLINDER", "DISK", "TORUS", "MESH",
}
_MATERIAL_TYPES = {
    "MATTE", "MIRROR", "TRANSPARENT", "EMISSIVE", "PLASTIC", "GLASS", "METAL",
    "REFLECTIVE", "PHONG",
}
_KNOWN_KEYS = {
    "NAME", "COLOR", "SIGMA", "NORMAL_MAP", "TEXTURE", "KD", "KD_TEXTURE",
    "IMPORTANCE",
    "KS", "ROUGHNESS", "IOR_IN", "IOR_OUT", "CF_IN", "CF_OUT", "INTENSITY",
    "TYPE",
    "SHADOWED", "AMB_COLOR", "AMB_CONSTANT", "DIFF_COLOR", "DIFF_CONSTANT",
    "SPEC_COLOR", "SPEC_CONSTANT", "EXP",
    "CAST_SHADOW", "RADIUS", "CENTER", "PHI", "MIN_THETA", "MAX_THETA",
    "MATERIAL", "POINT", "NORMAL", "WIDTH", "HEIGHT", "V0", "V1", "V2",
    "LENGTH", "LOCATION", "SCALE", "ORIENTATION", "NORMAL_TYPE",
    "SWEPT_RADIUS", "TUBE_RADIUS", "FILE", "FILE_NAME", "SMOOTH", "SCALING",
    "DIST_ATTEN", "DIRECTION",
}
_NORMAL_TYPES = {"OPEN": T.NORMAL_OPEN, "CONVEX": T.NORMAL_CONVEX,
                 "CONCAVE": T.NORMAL_CONCAVE}


def _is_block_start(ts: TokenStream) -> bool:
    """`MATERIAL` starts a block only when a material type follows
    (scenefile.py:60-73)."""
    tok = ts.peek()
    if tok in ("OBJECT", "ENV_LIGHT", "END_MATERIALS", "POINT_LIGHT",
               "DIRECTIONAL_LIGHT"):
        return True
    if tok == "MATERIAL":
        nxt = ts.tokens[ts.pos + 1] if ts.pos + 1 < len(ts.tokens) else None
        return nxt in _MATERIAL_TYPES
    return False


def _collect_block(ts: TokenStream) -> dict:
    """KEY [values...] pairs until the next block starter or END
    (scenefile.py:85-108)."""
    kv: dict[str, list[str]] = {}
    while not ts.eof():
        if _is_block_start(ts):
            break
        tok = ts.next()
        if tok == "END":
            break
        vals: list[str] = []
        if not ts.eof() and not _is_block_start(ts) and ts.peek() != "END":
            vals.append(ts.next())
        while not ts.eof():
            if _is_block_start(ts):
                break
            nxt = ts.peek()
            if nxt == "END" or nxt in _KNOWN_KEYS:
                break
            vals.append(ts.next())
        kv[tok] = vals
    return kv


def _vec3_from(vals, default=(0.0, 0.0, 0.0)):
    if not vals:
        return default
    nums = [atof(v) for v in vals[:3]]
    while len(nums) < 3:
        nums.append(0.0)
    return tuple(nums)


def _color_from(vals, default=(0.0, 0.0, 0.0)):
    if vals and vals[0] in PRESET_COLORS:
        return PRESET_COLORS[vals[0]]
    return _vec3_from(vals, default)


def _f(vals, default=0.0):
    return atof(vals[0]) if vals else default


def _parse_material(builder: SceneBuilder, mat_type: str, kv: dict,
                    search_dirs=()):
    """One MATERIAL block (scenefile.py:135-195). A texture is loaded
    whatever the type (into the pack, as the JAX parser loads it); MATTE
    and PLASTIC use it as their diffuse color, MATTE a NORMAL_MAP."""
    name = (kv.get("NAME") or ["unnamed"])[0]
    diffuse_tex = -1
    if "TEXTURE" in kv or "KD_TEXTURE" in kv:
        tex_file = (kv.get("TEXTURE") or kv.get("KD_TEXTURE"))[0]
        diffuse_tex = _load_texture(builder, tex_file, search_dirs)
    # `COLOR TEXTURE <file>` is taken too (the reference's grammar reads a
    # bare `TEXTURE <file>` in COLOR's place, scene/scenefile.h:140-151)
    cvals = kv.get("COLOR")
    if diffuse_tex < 0 and cvals and cvals[0] == "TEXTURE" and len(cvals) > 1:
        diffuse_tex = _load_texture(builder, cvals[1], search_dirs)
        cvals = ["0.5", "0.5", "0.5"]  # the table color, unused
    if mat_type == "MATTE":
        normal_tex = -1
        if kv.get("NORMAL_MAP"):
            normal_tex = _load_texture(builder, kv["NORMAL_MAP"][0],
                                       search_dirs)
        builder.add_matte(name, _color_from(cvals or kv.get("DIFF_COLOR"),
                                            (0.5, 0.5, 0.5)),
                          _f(kv.get("SIGMA"), 0.0), diffuse_tex=diffuse_tex,
                          normal_tex=normal_tex)
    elif mat_type == "MIRROR":
        builder.add_mirror(name, _color_from(cvals, (1, 1, 1)))
    elif mat_type == "TRANSPARENT":
        builder.add_transparent(
            name, ior_in=_f(kv.get("IOR_IN"), 1.5),
            ior_out=_f(kv.get("IOR_OUT"), 1.0),
            cf_in=_color_from(kv.get("CF_IN"), (1, 1, 1)),
            cf_out=_color_from(kv.get("CF_OUT"), (1, 1, 1)))
    elif mat_type == "EMISSIVE":
        builder.add_emissive(name, _color_from(cvals, (1, 1, 1)),
                             _f(kv.get("INTENSITY"), 1.0))
    elif mat_type == "PLASTIC":
        builder.add_plastic(name, kd=_color_from(kv.get("KD"),
                                                 (0.5, 0.5, 0.5)),
                            ks=_color_from(kv.get("KS"), (0.5, 0.5, 0.5)),
                            roughness=_f(kv.get("ROUGHNESS"), 0.1),
                            diffuse_tex=diffuse_tex)
    elif mat_type == "GLASS":
        builder.add_glass(name, roughness=_f(kv.get("ROUGHNESS"), 0.0))
    elif mat_type == "METAL":
        builder.add_metal(name, preset=(kv.get("TYPE") or ["GOLD"])[0],
                          roughness=_f(kv.get("ROUGHNESS"), 0.05))
    elif mat_type == "REFLECTIVE":
        # the legacy grammar (example_scene.txt) maps to plastic with the
        # listed diffuse/specular colors scaled by their constants
        kd = _color_from(kv.get("DIFF_COLOR"), (0.5, 0.5, 0.5))
        ks = _color_from(kv.get("SPEC_COLOR"), (0.5, 0.5, 0.5))
        kd_c = _f(kv.get("DIFF_CONSTANT"), 1.0)
        ks_c = _f(kv.get("SPEC_CONSTANT"), 1.0)
        builder.add_plastic(name, kd=tuple(c * kd_c for c in kd),
                            ks=tuple(c * ks_c for c in ks), roughness=0.05)
    else:
        builder.add_matte(name, (0.5, 0.5, 0.5))


def _load_texture(builder: SceneBuilder, file_name: str, search_dirs) -> int:
    """The texture's id in the pack, or -1 when no search directory holds
    a readable file of that name (scenefile.py:198-207)."""
    for d in search_dirs:
        p = os.path.join(d, file_name)
        if os.path.exists(p):
            img = load_texture_image(p)
            if img is not None:
                return builder.add_texture(file_name, img)
    return -1


def _ns_to_roughness(ns: float) -> float:
    """Phong exponent -> microfacet roughness sqrt(2 / (Ns + 2)), at least
    0.01 (scenefile.py:261-266)."""
    return max(0.01, math.sqrt(2.0 / (max(ns, 0.0) + 2.0)))


def _mtl_material_name(builder: SceneBuilder, m, base_dir, search_dirs):
    """Bind an MTL material to a scene material named "mtl:<name>", added
    once (scenefile.py:269-311; the reference parses MTL and discards it,
    buildscene.h:232-239): Ke > 0 -> EMISSIVE (a mesh light); illum 7 or
    transmissive -> GLASS (Ni); a metal preset's name -> METAL; illum 3 or
    5 -> MIRROR; Ks > 0.05 -> PLASTIC (Kd, Ks, Ns, map_Kd); else MATTE
    (Kd, map_Kd, map_bump). Textures load beside the OBJ first."""
    name = "mtl:" + (m.name or "__nameless__")
    if name in builder._mat_index:
        return name
    dirs = [base_dir] + list(search_dirs)
    diffuse_tex = _load_texture(builder, m.map_kd, dirs) if m.map_kd else -1
    normal_tex = (_load_texture(builder, m.map_bump, dirs) if m.map_bump
                  else -1)
    ke = max(m.ke)
    ks = max(m.ks)
    if ke > 0.0:
        builder.add_emissive(name, color=tuple(c / ke for c in m.ke),
                             intensity=float(ke))
    elif m.illum == 7 or (m.d < 1.0 and m.ni != 1.0):
        builder.add_glass(name, roughness=(0.0 if m.ns <= 0
                                           else _ns_to_roughness(m.ns)),
                          ior_in=m.ni if m.ni > 1.0 else 1.5)
    elif m.name.upper() in METAL_PRESETS:
        builder.add_metal(name, preset=m.name.upper(),
                          roughness=_ns_to_roughness(m.ns))
    elif m.illum in (3, 5):
        builder.add_mirror(name, color=m.ks if ks > 0 else (1.0, 1.0, 1.0))
    elif ks > 0.05:
        builder.add_plastic(name, kd=m.kd, ks=m.ks,
                            roughness=_ns_to_roughness(m.ns),
                            diffuse_tex=diffuse_tex)
    else:
        builder.add_matte(name, color=m.kd, diffuse_tex=diffuse_tex,
                          normal_tex=normal_tex)
    return name


def _parse_mesh(builder: SceneBuilder, kv: dict, mat: str, search_dirs):
    """OBJECT MESH (scenefile.py:313-344): every OBJ group becomes one
    baked mesh with the object's material, or with `MATERIAL FROM_MTL`
    its usemtl material from the file's mtllib ("__default__" when the
    library lacks it). A mesh file that cannot be found is skipped (the
    reference errors out; the JAX parser skips it, :323-324)."""
    file_name = (kv.get("FILE") or kv.get("FILE_NAME") or [""])[0]
    path = next((p for p in (os.path.join(d, file_name) for d in search_dirs)
                 if file_name and os.path.isfile(p)), None)
    if path is None:
        return
    smooth = (kv.get("SMOOTH") or ["no"])[0] == "yes"
    shapes, mtl_mats = load_obj(path)
    base_dir = os.path.dirname(path)
    for shape in shapes:
        normals = shape.normals
        if smooth and normals is None:
            normals = compute_vertex_normals(shape.positions, shape.indices)
        shape_mat = mat
        if mat == "FROM_MTL":
            m = mtl_mats.get(shape.mat_name)
            shape_mat = (_mtl_material_name(builder, m, base_dir, search_dirs)
                         if m is not None else "__default__")
        builder.add_mesh(shape.positions, shape.indices, shape_mat,
                         normals=normals, uvs=shape.texcoords, smooth=smooth,
                         scaling=_vec3_from(kv.get("SCALING"), (1, 1, 1)),
                         location=_vec3_from(kv.get("LOCATION")),
                         orientation=_vec3_from(kv.get("ORIENTATION")))


def _placement(kv: dict):
    """An instanced object's LOCATION, SCALE and ORIENTATION."""
    return dict(location=_vec3_from(kv.get("LOCATION")),
                scale=_vec3_from(kv.get("SCALE"), (1, 1, 1)),
                orientation=_vec3_from(kv.get("ORIENTATION")))


def _parse_object(builder: SceneBuilder, obj_type: str, kv: dict,
                  search_dirs=()):
    """One OBJECT block (scenefile.py:210-258)."""
    mat = (kv.get("MATERIAL") or ["__default__"])[0]
    if obj_type == "MESH":
        _parse_mesh(builder, kv, mat, search_dirs)
    elif obj_type == "SPHERE":
        builder.add_sphere(center=_vec3_from(kv.get("CENTER")),
                           radius=_f(kv.get("RADIUS"), 1.0), mat=mat,
                           phi=_f(kv.get("PHI"), PI),
                           min_theta=_f(kv.get("MIN_THETA"), 0.0),
                           max_theta=_f(kv.get("MAX_THETA"), PI))
    elif obj_type == "RECTANGLE":
        builder.add_rect(_vec3_from(kv.get("POINT")),
                         _vec3_from(kv.get("WIDTH"), (1, 0, 0)),
                         _vec3_from(kv.get("HEIGHT"), (0, 1, 0)), mat)
    elif obj_type == "TRIANGLE":
        builder.add_triangle(_vec3_from(kv.get("V0")),
                             _vec3_from(kv.get("V1")),
                             _vec3_from(kv.get("V2")), mat)
    elif obj_type == "PLANE":
        builder.add_plane(_vec3_from(kv.get("POINT")),
                          _vec3_from(kv.get("NORMAL"), (0, 1, 0)), mat)
    elif obj_type == "DISK":
        builder.add_disk(_vec3_from(kv.get("CENTER")),
                         _vec3_from(kv.get("NORMAL"), (0, 1, 0)),
                         _f(kv.get("RADIUS"), 1.0), mat)
    elif obj_type == "BOX":
        builder.add_box(_f(kv.get("LENGTH"), 1.0), _f(kv.get("HEIGHT"), 1.0),
                        _f(kv.get("WIDTH"), 1.0), mat, **_placement(kv))
    elif obj_type == "OPENCYLINDER":
        ntype = _NORMAL_TYPES.get((kv.get("NORMAL_TYPE") or ["OPEN"])[0],
                                  T.NORMAL_OPEN)
        builder.add_open_cylinder(_f(kv.get("PHI"), PI), mat,
                                  normal_type=ntype, **_placement(kv))
    elif obj_type == "SOLIDCYLINDER":
        builder.add_solid_cylinder(mat, **_placement(kv))
    elif obj_type == "TORUS":
        builder.add_torus(_f(kv.get("SWEPT_RADIUS"), 1.0),
                          _f(kv.get("TUBE_RADIUS"), 0.25),
                          _f(kv.get("PHI"), PI), mat, **_placement(kv))


def load_scene_file(path: str, accel: str = "auto", device=None):
    """Parse a scene file -> (Scene, Camera, Film) on `device` (default:
    the CUDA card; raises when there is none)."""
    device = resolve_device(device)
    with open(path) as f:
        ts = TokenStream(tokenize(f.read()))
    search_dirs = [os.path.dirname(os.path.abspath(path)), os.getcwd()]
    builder = SceneBuilder()
    film_kv = dict(WINDOW_WIDTH=256, WINDOW_HEIGHT=256, IMAGE_WIDTH=256,
                   IMAGE_HEIGHT=256, FOV=40.0)
    cam_pos = (0.0, 0.0, 5.0)
    look_point = (0.0, 0.0, 0.0)

    while not ts.eof():
        tok = ts.next()
        if tok in ("WINDOW_WIDTH", "WINDOW_HEIGHT", "IMAGE_WIDTH",
                   "IMAGE_HEIGHT"):
            film_kv[tok] = ts.next_int()
        elif tok == "FOV":
            film_kv["FOV"] = ts.next_float()
        elif tok == "CAMERA_POS":
            cam_pos = ts.next_vec3()
        elif tok == "LOOK_POINT":
            look_point = ts.next_vec3()
        elif tok == "MATERIAL":
            mat_type = ts.next()
            _parse_material(builder, mat_type, _collect_block(ts),
                            search_dirs)
        elif tok == "END_MATERIALS":
            continue
        elif tok == "OBJECT":
            obj_type = ts.next()
            kv = _collect_block(ts)
            if obj_type in _OBJECT_TYPES:
                _parse_object(builder, obj_type, kv, search_dirs)
        elif tok == "POINT_LIGHT":
            kv = _collect_block(ts)
            builder.add_point_light(
                _vec3_from(kv.get("POINT")),
                _color_from(kv.get("COLOR"), (1, 1, 1)),
                _f(kv.get("INTENSITY"), 1.0),
                dist_atten=(kv.get("DIST_ATTEN") or ["yes"])[0] != "no")
        elif tok == "DIRECTIONAL_LIGHT":
            kv = _collect_block(ts)
            builder.add_directional_light(
                _vec3_from(kv.get("DIRECTION"), (0, 1, 0)),
                _color_from(kv.get("COLOR"), (1, 1, 1)),
                _f(kv.get("INTENSITY"), 1.0))
        elif tok == "ENV_LIGHT":
            kv = _collect_block(ts)
            kind = (kv.get("TYPE") or ["CONSTANT"])[0]
            intensity = _f(kv.get("INTENSITY"), 0.0)
            tex_id = (_load_texture(builder, (kv.get("COLOR") or [""])[0],
                                    search_dirs) if kind == "TEXTURE" else -1)
            if tex_id >= 0:
                # the reference's fixed rot-y(-0.76) for a texture env
                # (buildscene.h:516); IMPORTANCE yes is the JAX grammar's
                # extension for texel sampling (scenefile.py:406-420)
                builder.set_env_light(
                    "texture", intensity=intensity, tex_id=tex_id,
                    rotate_y_angle=-0.76,
                    importance=(kv.get("IMPORTANCE") or ["no"])[0] == "yes")
            elif kind == "TEXTURE":  # no readable image: a white constant
                builder.set_env_light("constant", (1.0, 1.0, 1.0), intensity)
            else:
                builder.set_env_light("constant",
                                      _color_from(kv.get("COLOR"), (1, 1, 1)),
                                      intensity)

    scene = builder.build(accel=accel, device=device)
    camera = make_camera(cam_pos, look_point, device=device)
    film = Film(fov=torch.tensor(math.radians(film_kv["FOV"]),
                                 dtype=torch.float32, device=device),
                width=int(film_kv["IMAGE_WIDTH"]),
                height=int(film_kv["IMAGE_HEIGHT"]))
    return scene, camera, film
