"""3x3 affine utilities for the three coordinate frames
(port of ``dsnt_pose2d_tpu/data/transforms.py``).

Frames: original-image pixels, crop pixels (the model's input square), and
normalized (-1, 1).  Affines are row-major 3x3 matrices acting on column
vectors ``[x, y, 1]^T``, batch dims leading.

Every product here is written out elementwise, so it is strict fp32 whatever
the TF32 settings: translations are O(100-400) px, and a TF32 or bf16
product rounds them by 1-2 px (the JAX package pins ``Precision.HIGHEST``
for the same reason).
"""

from __future__ import annotations

import torch

MPII_SCALE_BOX_PX = 200.0

# MPII 16-joint order: 0 r_ankle, 1 r_knee, 2 r_hip, 3 l_hip, 4 l_knee,
# 5 l_ankle, 6 pelvis, 7 thorax, 8 upper_neck, 9 head_top, 10 r_wrist,
# 11 r_elbow, 12 r_shoulder, 13 l_shoulder, 14 l_elbow, 15 l_wrist.
MPII_FLIP_PAIRS = ((0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13))


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for ``(..., 3, 3)`` affines, elementwise fp32."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(dim=-2)


def flip_permutation(num_joints: int = 16, pairs=MPII_FLIP_PAIRS,
                     device=None) -> torch.Tensor:
    perm = list(range(num_joints))
    for a, b in pairs:
        perm[a], perm[b] = perm[b], perm[a]
    return torch.tensor(perm, dtype=torch.int64, device=device)


def _stack3(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def translation(tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    tx, ty = torch.broadcast_tensors(tx, ty)
    o, z = torch.ones_like(tx), torch.zeros_like(tx)
    return _stack3([(o, z, tx), (z, o, ty), (z, z, o)])


def scaling(sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    sx, sy = torch.broadcast_tensors(sx, sy)
    o, z = torch.ones_like(sx), torch.zeros_like(sx)
    return _stack3([(sx, z, z), (z, sy, z), (z, z, o)])


def rotation(theta_rad: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta_rad), torch.sin(theta_rad)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _stack3([(c, -s, z), (s, c, z), (z, z, o)])


def crop_transform(center_xy, scale, out_size: int, rot_rad, scale_aug,
                   flip) -> torch.Tensor:
    """Affine mapping ORIGINAL-image px -> CROP px (``out_size`` square).

    The person box (side ``scale * 200 / scale_aug`` px) centered at
    ``center_xy`` lands on the crop frame, rotated by ``rot_rad`` about the
    person center; ``flip`` mirrors about the crop's center.  All arguments
    are float32 tensors with the batch shape (``center_xy`` has a trailing 2).
    """
    cx, cy = center_xy[..., 0], center_xy[..., 1]
    box = scale * MPII_SCALE_BOX_PX / scale_aug
    s = out_size / box
    half = torch.full_like(cx, (out_size - 1) / 2.0)
    m = translation(half, half)
    m = compose(m, compose(scaling(s, s),
                           compose(rotation(rot_rad), translation(-cx, -cy))))
    flip_f = flip.to(torch.float32)
    sign = 1.0 - 2.0 * flip_f
    fm = compose(translation(flip_f * (out_size - 1.0), torch.zeros_like(flip_f)),
                 scaling(sign, torch.ones_like(sign)))
    return compose(fm, m)


def transform_coords(m: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Apply ``(..., 3, 3)`` affines to ``(..., N, 2)`` points (or ``(..., 2)``)."""
    squeeze = coords.dim() == m.dim() - 1
    if squeeze:
        coords = coords.unsqueeze(-2)
    homo = torch.cat([coords, torch.ones_like(coords[..., :1])], dim=-1)
    out = (m.unsqueeze(-3) * homo.unsqueeze(-2)).sum(dim=-1)   # (..., N, 3)
    out = out[..., :2] / out[..., 2:3]
    return out[..., 0, :] if squeeze else out


def invert(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of ``(..., 3, 3)`` affines (2x2 adjugate)."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    tx, ty = m[..., 0, 2], m[..., 1, 2]
    det = a * d - b * c
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return _stack3([(ia, ib, itx), (ic, id_, ity), (z, z, o)])
