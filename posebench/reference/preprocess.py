"""The on-device preprocessing in plain fp32 PyTorch: the augmentation's
draws, the composed crop affine, the shear-decomposed bilinear warp, colour
jitter, normalisation and the left/right joint swap.

A frozen copy of the math of the port's ``data/augment.py`` and
``data/transforms.py``, with the row shift as a gather.  Every affine
product is written out elementwise and the resampling products run with
TF32 off, so the images equal those the port's plain path makes.
"""

from __future__ import annotations

import math

import torch

MPII_SCALE_BOX_PX = 200.0
FLIP_PAIRS = ((0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13))


def step_seed(seed: int, step: int) -> int:
    """The augmentation generator's seed for a train step."""
    return ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)


def draws(batch: int, data: dict, seed: int, device) -> dict:
    """The train augmentation's draws from a generator on ``device`` seeded
    with ``seed``, in the order rot, (rotation gate), scale, flip, jitter."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def uniform(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    rot = uniform(batch, lo=-data["max_rotation_deg"],
                  hi=data["max_rotation_deg"]) * (math.pi / 180.0)
    if data["rotation_prob"] < 1.0:
        rot = torch.where(uniform(batch) < data["rotation_prob"], rot, 0.0)
    scale = uniform(batch, lo=data["scale_range"][0], hi=data["scale_range"][1])
    flip = uniform(batch) < data["flip_prob"]
    jitter = None
    if data["color_jitter"] > 0:
        jitter = uniform(batch, 1, 1, 3, lo=1.0 - data["color_jitter"],
                         hi=1.0 + data["color_jitter"])
    return {"rot": rot, "scale": scale, "flip": flip, "jitter": jitter}


def compose(a, b):
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(dim=-2)


def _stack3(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _translation(tx, ty):
    tx, ty = torch.broadcast_tensors(tx, ty)
    o, z = torch.ones_like(tx), torch.zeros_like(tx)
    return _stack3([(o, z, tx), (z, o, ty), (z, z, o)])


def _scaling(sx, sy):
    sx, sy = torch.broadcast_tensors(sx, sy)
    o, z = torch.ones_like(sx), torch.zeros_like(sx)
    return _stack3([(sx, z, z), (z, sy, z), (z, z, o)])


def _rotation(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _stack3([(c, -s, z), (s, c, z), (z, z, o)])


def crop_transform(center, scale, out_size, rot, scale_aug, flip):
    """Original px -> crop px: the person box onto the crop, rotated about
    its center, mirrored about the crop's center under ``flip``."""
    cx, cy = center[..., 0], center[..., 1]
    s = out_size / (scale * MPII_SCALE_BOX_PX / scale_aug)
    half = torch.full_like(cx, (out_size - 1) / 2.0)
    m = compose(_translation(half, half),
                compose(_scaling(s, s), compose(_rotation(rot), _translation(-cx, -cy))))
    f = flip.to(torch.float32)
    sign = 1.0 - 2.0 * f
    fm = compose(_translation(f * (out_size - 1.0), torch.zeros_like(f)),
                 _scaling(sign, torch.ones_like(sign)))
    return compose(fm, m)


def transform_coords(m, coords):
    homo = torch.cat([coords, torch.ones_like(coords[..., :1])], dim=-1)
    out = (m.unsqueeze(-3) * homo.unsqueeze(-2)).sum(dim=-1)
    return out[..., :2] / out[..., 2:3]


def invert(m):
    a, b, c, d = m[..., 0, 0], m[..., 0, 1], m[..., 1, 0], m[..., 1, 1]
    tx, ty = m[..., 0, 2], m[..., 1, 2]
    det = a * d - b * c
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return _stack3([(ia, ib, -(ia * tx + ib * ty)),
                    (ic, id_, -(ic * tx + id_ * ty)), (z, z, o)])


def flip_permutation(num_joints: int, device) -> torch.Tensor:
    perm = list(range(num_joints))
    for a, b in FLIP_PAIRS:
        perm[a], perm[b] = perm[b], perm[a]
    return torch.tensor(perm, dtype=torch.int64, device=device)


def shift_rows(rows, starts, fracs, out_len: int, stride: int):
    """``(1 - f) * rows[r, k_r + i] + f * rows[r, k_r + i + stride]``;
    taps outside a row read 0."""
    length = rows.shape[1]
    ia = starts.to(torch.int64)[:, None] + torch.arange(out_len, device=rows.device)

    def tap(idx):
        ok = (idx >= 0) & (idx < length)
        vals = rows.gather(1, idx.clamp(0, length - 1))
        return torch.where(ok, vals, torch.zeros((), device=rows.device))

    f = fracs.to(torch.float32)[:, None]
    return (1.0 - f) * tap(ia) + f * tap(ia + stride)


def _shift_lerp(rows, offsets, out_len, pad_left, stride):
    k = torch.floor(offsets)
    f = offsets - k
    starts = (k.to(torch.int32) + pad_left).clamp(
        0, rows.shape[1] // stride - out_len - 1) * stride
    return shift_rows(rows, starts, f, out_len * stride, stride)


def _tents(positions, in_len):
    g = torch.arange(in_len, dtype=torch.float32, device=positions.device)
    return (1.0 - (positions[..., None] - g).abs()).clamp_min(0.0)


def shear_extents(canvas: int, out_size: int, max_abs_shear: float) -> dict:
    """The shear warp's padded extents (all in pixels)."""
    px = math.ceil(max_abs_shear * (canvas - 1)) + 1
    py = math.ceil(max_abs_shear * (out_size - 1)) + 1
    return {"px": px, "py": py, "w1": canvas + 2 * px, "s2": out_size + 2 * py,
            "pad1": 2 * px + 2, "pad3": 2}


def warp_shear(canvas, m_out_to_in, out_size: int, max_abs_shear: float):
    """``A = Hx(a) D Hy(b)``: an x-shear of the canvas rows, a separable
    scale and translation by two tent-weight products, a y-shear."""
    bsz, h, w, c = canvas.shape
    s, dev = out_size, canvas.device
    e = shear_extents(h, s, max_abs_shear)
    a2, t2 = m_out_to_in[:, :2, :2], m_out_to_in[:, :2, 2]
    a = a2[:, 0, 1] / a2[:, 1, 1]
    b = a2[:, 1, 0] / a2[:, 1, 1]
    dy = a2[:, 1, 1]
    dx = a2[:, 0, 0] - a2[:, 0, 1] * a2[:, 1, 0] / a2[:, 1, 1]
    tpx = t2[:, 0] - a * t2[:, 1]
    tpy = t2[:, 1]
    pad = e["pad1"]
    rows = torch.nn.functional.pad(canvas, (0, 0, pad, pad)).reshape(
        bsz * h, (w + 2 * pad) * c)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    offs = (a[:, None] * ys[None, :] - e["px"]).reshape(bsz * h)
    img1 = _shift_lerp(rows, offs, e["w1"], pad, c).reshape(bsz, h, e["w1"], c)
    xs = torch.arange(s, dtype=torch.float32, device=dev)
    ax = _tents(dx[:, None] * xs + tpx[:, None] + e["px"], e["w1"])
    uy = torch.arange(e["s2"], dtype=torch.float32, device=dev) - e["py"]
    ay = _tents(dy[:, None] * uy + tpy[:, None], h)
    tmp = torch.einsum("bxw,bhwc->bhxc", ax, img1)
    img2 = torch.einsum("bsh,bhxc->bsxc", ay, tmp)
    pad3 = e["pad3"]
    cols = torch.nn.functional.pad(img2.transpose(1, 2), (0, 0, pad3, pad3)).reshape(
        bsz * s, (e["s2"] + 2 * pad3) * c)
    offs3 = (b[:, None] * xs[None, :] + e["py"]).reshape(bsz * s)
    out = _shift_lerp(cols, offs3, s, pad3, c).reshape(bsz, s, s, c)
    return out.transpose(1, 2)


def max_shear(data: dict, train: bool) -> float:
    if data["warp_method"] != "shear" or data["max_rotation_deg"] > 60.0:
        raise ValueError("the reference warps by shear only, up to 60 degrees")
    rotates = train and data["max_rotation_deg"] > 0 and data["rotation_prob"] > 0
    return math.tan(math.radians(data["max_rotation_deg"])) * 1.01 if rotates else 0.0


def preprocess(batch: dict, data: dict, out_size: int, dr: dict | None = None) -> dict:
    """Canvases -> normalized NHWC images, (-1, 1) targets, mask and the
    original -> crop affine; ``dr`` the train draws (None: the eval crop)."""
    canvas = batch["canvases"]
    b, c_size = canvas.shape[:2]
    dev = canvas.device
    canvas = canvas.to(torch.float32) / 255.0
    train = dr is not None
    if train:
        rot, scale, flip = dr["rot"].float(), dr["scale"].float(), dr["flip"].bool()
    else:
        rot = torch.zeros((b,), device=dev)
        scale = torch.ones((b,), device=dev)
        flip = torch.zeros((b,), dtype=torch.bool, device=dev)
    margin = batch["canvas_margin"].to(torch.float32).reshape(b)
    center = torch.full((b, 2), (c_size - 1) / 2.0, device=dev)
    m_crop = crop_transform(center, (c_size / margin) / MPII_SCALE_BOX_PX, out_size,
                            rot, scale, flip)
    warped = warp_shear(canvas, invert(m_crop), out_size, max_shear(data, train))
    if train and dr.get("jitter") is not None:
        warped = (warped * dr["jitter"].float()).clamp(0.0, 1.0)
    mean = torch.tensor(data["mean"], dtype=torch.float32, device=dev)
    std = torch.tensor(data["std"], dtype=torch.float32, device=dev)
    coords = transform_coords(m_crop, batch["coords_px"].to(torch.float32))
    mask = batch["mask"].to(torch.float32)
    if train:
        perm = flip_permutation(coords.shape[1], dev)
        coords = torch.where(flip[:, None, None], coords[:, perm], coords)
        mask = torch.where(flip[:, None], mask[:, perm], mask)
    return {"images": (warped - mean) / std,
            "coords": (2.0 * coords + 1.0) / out_size - 1.0,
            "mask": mask,
            "crop_from_orig": compose(m_crop, batch["canvas_from_orig"].to(torch.float32))}


def to_original_px(coords_norm, crop_from_orig, out_size: int):
    crop_px = ((coords_norm + 1.0) * out_size - 1.0) / 2.0
    return transform_coords(invert(crop_from_orig), crop_px)
