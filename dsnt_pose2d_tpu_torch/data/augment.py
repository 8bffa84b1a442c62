"""On-device preprocessing (port of ``dsnt_pose2d_tpu/data/augment.py``).

    canvas (B, C, C, 3) uint8/float
      -> one composed affine (crop * rotate * scale * flip) bilinear warp
      -> per-channel color jitter (train)
      -> mean/std normalize
    coords: same affine + flip joint swap -> normalized (-1, 1);
    crop_from_orig for PCKh

The warp is either the shear decomposition (``warp_method='shear'``, the
default: two passes of the row_shift kernel around two resampling products)
or the direct bilinear gather (``'gather'``, its oracle).  For the eval
path's rotation-free affine both give the same image.

The train path's random draws (rotation, scale, flip, jitter) are tensors
that the caller passes in (:func:`sample_train_draws` makes them from a
``torch.Generator``): torch cannot reproduce ``jax.random``'s bits, so the
tests hand both packages the draws that JAX makes.
"""

from __future__ import annotations

import contextlib
import math
import warnings

import torch
import torch.nn.functional as F

from ..device import device_constant, strict_fp32
from ..ops.cuda.row_shift import shift_rows, shift_rows_reference
from ..utils.config import DataConfig
from . import transforms as T


def affine_warp_bilinear(images: torch.Tensor, m_out_to_in: torch.Tensor,
                         out_size: int) -> torch.Tensor:
    """Warp ``(B, H, W, C)`` images with affines mapping OUTPUT px -> INPUT px.

    Bilinear sampling at pixel centers; taps outside the image read 0.
    """
    bsz, h, w, c = images.shape
    dev = images.device
    images = images.to(torch.float32)
    gy, gx = torch.meshgrid(torch.arange(out_size, dtype=torch.float32, device=dev),
                            torch.arange(out_size, dtype=torch.float32, device=dev),
                            indexing="ij")
    pts = torch.stack([gx, gy], dim=-1).reshape(1, -1, 2)
    src = T.transform_coords(m_out_to_in, pts.expand(bsz, -1, -1))  # (B, S*S, 2)
    x, y = src[..., 0], src[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    flat = images.reshape(bsz, h * w, c)

    def tap(xi, yi):
        ok = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h))[..., None]
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = flat.gather(1, idx[..., None].expand(-1, -1, c))
        return torch.where(ok, vals, torch.zeros((), device=dev))

    top = tap(x0i, y0i) * (1 - fx) + tap(x0i + 1, y0i) * fx
    bot = tap(x0i, y0i + 1) * (1 - fx) + tap(x0i + 1, y0i + 1) * fx
    out = top * (1 - fy) + bot * fy
    return out.reshape(bsz, out_size, out_size, c)


def _row_shift_lerp(rows: torch.Tensor, offsets: torch.Tensor, out_len: int,
                    pad_left: int, stride: int = 1) -> torch.Tensor:
    """Per-row fractional PIXEL shift on ``(R, L_px * stride)`` element rows.

    ``offsets``/``pad_left``/``out_len`` are in pixels; ``stride`` is the
    elements per pixel (C for channel-interleaved rows).  The caller
    zero-pads the rows; reads outside yield 0.
    """
    length = rows.shape[1]
    k = torch.floor(offsets)
    f = (offsets - k).to(rows.dtype)
    starts = (k.to(torch.int32) + pad_left).clamp(
        0, length // stride - out_len - 1) * stride
    return shift_rows(rows, starts.to(torch.int32), f, out_len * stride, stride)


@contextlib.contextmanager
def plain_row_shift():
    """Inside the block the shear warp runs row_shift's plain version in
    place of its kernel, on any device (the bench's plain path)."""
    global shift_rows
    kernel, shift_rows = shift_rows, shift_rows_reference
    try:
        yield
    finally:
        shift_rows = kernel


def _resample_matrix(positions: torch.Tensor, in_len: int) -> torch.Tensor:
    """``(B, OUT)`` source positions -> ``(B, OUT, in_len)`` bilinear tent
    weights, zero outside ``[0, in_len)``."""
    grid = torch.arange(in_len, dtype=torch.float32, device=positions.device)
    return (1.0 - (positions[..., None] - grid).abs()).clamp_min(0.0)


def affine_warp_shear(canvas: torch.Tensor, m_out_to_in: torch.Tensor,
                      out_size: int, max_abs_shear: float) -> torch.Tensor:
    """Batched affine warp via shear decomposition ``A = Hx(a) D Hy(b)``.

    1. x-shear of the input: a per-(image, row) fractional shift (row_shift),
    2. separable scale+translate: two per-sample resampling products over
       tent-weight matrices, in strict fp32 (TF32 off) for eval and train
       alike.  The JAX package runs them at ``Precision.HIGHEST`` for eval
       and ``Precision.DEFAULT`` (one reduced-precision pass) for train;
       here the train products stay strict fp32 too, which costs well under
       a millisecond of a train step and keeps the card's numbers those of
       the CPU tests,
    3. y-shear of the transposed intermediate (row_shift again).

    The shift passes run on channel-interleaved rows (a one-pixel shift is C
    elements).  For rotation-free affines every shear is a zero shift and the
    result equals :func:`affine_warp_bilinear`.  ``max_abs_shear`` bounds
    ``|a|`` and ``|b|`` and sizes the intermediate extents.
    """
    bsz, h, w, c = canvas.shape
    s = out_size
    dev = canvas.device
    img = canvas.to(torch.float32)
    a2 = m_out_to_in[:, :2, :2]
    t2 = m_out_to_in[:, :2, 2]
    a = a2[:, 0, 1] / a2[:, 1, 1]
    b = a2[:, 1, 0] / a2[:, 1, 1]
    dy = a2[:, 1, 1]
    dx = a2[:, 0, 0] - a2[:, 0, 1] * a2[:, 1, 0] / a2[:, 1, 1]
    tpx = t2[:, 0] - a * t2[:, 1]
    tpy = t2[:, 1]

    px = math.ceil(max_abs_shear * (h - 1)) + 1
    py = math.ceil(max_abs_shear * (s - 1)) + 1
    w1 = w + 2 * px          # extended x extent of the sheared canvas
    s2 = s + 2 * py          # extended y extent before the final y-shear

    # Pass 1: x-shear, one kernel row per (b, y), channels interleaved.
    pad = 2 * px + 2
    rows = F.pad(img, (0, 0, pad, pad)).reshape(bsz * h, (w + 2 * pad) * c)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    offs = (a[:, None] * ys[None, :] - px).reshape(bsz * h)
    img1 = _row_shift_lerp(rows, offs, w1, pad, stride=c).reshape(bsz, h, w1, c)

    # Pass 2: separable scale+translate via two per-sample products.
    xs = torch.arange(s, dtype=torch.float32, device=dev)
    ax = _resample_matrix(dx[:, None] * xs + tpx[:, None] + px, w1)
    uy = torch.arange(s2, dtype=torch.float32, device=dev) - py
    ay = _resample_matrix(dy[:, None] * uy + tpy[:, None], h)
    with strict_fp32():
        tmp = torch.einsum("bxw,bhwc->bhxc", ax, img1)     # (B, H, S, C)
        img2 = torch.einsum("bsh,bhxc->bsxc", ay, tmp)     # (B, S2, S, C)

    # Pass 3: y-shear along s2, on x-major rows.
    pad3 = 2
    cols = F.pad(img2.transpose(1, 2), (0, 0, pad3, pad3)).reshape(
        bsz * s, (s2 + 2 * pad3) * c)
    offs3 = (b[:, None] * xs[None, :] + py).reshape(bsz * s)
    outt = _row_shift_lerp(cols, offs3, s, pad3, stride=c).reshape(bsz, s, s, c)
    return outt.transpose(1, 2)     # (B, x, y, C) -> (B, y, x, C)


def sample_train_draws(batch: int, cfg: DataConfig,
                       generator: torch.Generator) -> dict:
    """The train augmentation's draws, on ``generator``'s device.

    As the JAX package's ``preprocess_batch`` draws them: ``rot`` (B,)
    radians from U(-max_rotation_deg, max_rotation_deg), zeroed with
    probability ``1 - rotation_prob``; ``scale`` (B,) from U(*scale_range);
    ``flip`` (B,) bool with probability ``flip_prob``; ``jitter`` (B, 1, 1, 3)
    per-channel scales from U(1 - color_jitter, 1 + color_jitter), or
    ``None`` when ``color_jitter`` is 0.
    """
    dev = generator.device

    def uniform(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           device=dev)

    rot = uniform(batch, lo=-cfg.max_rotation_deg,
                  hi=cfg.max_rotation_deg) * (math.pi / 180.0)
    if cfg.rotation_prob < 1.0:
        rot = torch.where(uniform(batch) < cfg.rotation_prob, rot, 0.0)
    scale = uniform(batch, lo=cfg.scale_range[0], hi=cfg.scale_range[1])
    flip = uniform(batch) < cfg.flip_prob
    jitter = None
    if cfg.color_jitter > 0:
        jitter = uniform(batch, 1, 1, 3, lo=1.0 - cfg.color_jitter,
                         hi=1.0 + cfg.color_jitter)
    return {"rot": rot, "scale": scale, "flip": flip, "jitter": jitter}


def _max_shear(cfg: DataConfig, train: bool) -> float | None:
    """Bound on |tan(rotation)| for the shear warp (0 when no rotation can
    occur: eval, rotation off), or ``None`` for the gather warp."""
    if cfg.warp_method != "shear":
        return None
    if train and cfg.max_rotation_deg > 60.0:
        # The shear decomposition divides by A11 ~ cos(rot): its extents
        # balloon toward 90 deg.  The JAX package falls back the same way.
        warnings.warn(
            f"warp_method='shear' requires max_rotation_deg <= 60 "
            f"(got {cfg.max_rotation_deg}); falling back to 'gather'")
        return None
    rotates = train and cfg.max_rotation_deg > 0 and cfg.rotation_prob > 0
    return (math.tan(math.radians(cfg.max_rotation_deg)) * 1.01
            if rotates else 0.0)


def preprocess_batch(canvas, coords_px, mask, head_len_px, canvas_from_orig,
                     cfg: DataConfig, out_size: int, train: bool = False,
                     canvas_margin=None, eval_scale: float = 1.0,
                     draws: dict | None = None) -> dict:
    """The preprocessing graph; all inputs are tensors on one device.

    Args:
        canvas: (B, C, C, 3) float32 in [0, 1] or uint8 person canvases.
        coords_px: (B, J, 2) joint coords in canvas pixels.
        mask: (B, J) visibility.
        head_len_px: (B,) PCKh head length in original-image pixels.
        canvas_from_orig: (B, 3, 3) affine original px -> canvas px.
        cfg: data config (augmentation ranges, ``warp_method``, ``mean``,
            ``std``).
        out_size: model input size.
        train: augment with ``draws`` (required then, see
            :func:`sample_train_draws`) instead of the deterministic center
            crop.
        canvas_margin: optional (B,) person-box margin of each canvas.
        eval_scale: deterministic crop scale of the eval path (larger zooms
            in).
        draws: the train path's ``rot``, ``scale``, ``flip`` and ``jitter``.

    Returns dict with normalized ``images`` (B, S, S, 3), ``coords``
    (B, J, 2) in (-1, 1), ``mask``, ``head_length`` and ``crop_from_orig``
    (B, 3, 3) mapping original px -> crop px.
    """
    b, c_size = canvas.shape[:2]
    dev = canvas.device
    if canvas.dtype == torch.uint8:
        canvas = canvas.to(torch.float32) / 255.0
    else:
        canvas = canvas.to(torch.float32)

    if train:
        if draws is None:
            raise ValueError("train=True needs the augmentation draws "
                             "(see sample_train_draws)")
        rot, scale, flip = (draws[k].to(dev) for k in ("rot", "scale", "flip"))
        rot, scale, flip = rot.float(), scale.float(), flip.bool()
    else:
        rot = torch.zeros((b,), device=dev)
        scale = torch.full((b,), float(eval_scale), device=dev)
        flip = torch.zeros((b,), dtype=torch.bool, device=dev)
    if canvas_margin is None:
        margin = torch.ones((b,), device=dev)
    else:
        margin = canvas_margin.to(torch.float32).reshape(b)
    center = torch.full((b, 2), (c_size - 1) / 2.0, device=dev)
    m_crop_from_canvas = T.crop_transform(
        center, (c_size / margin) / T.MPII_SCALE_BOX_PX, out_size,
        rot_rad=rot, scale_aug=scale, flip=flip)
    m_out_to_in = T.invert(m_crop_from_canvas)

    max_shear = _max_shear(cfg, train)
    if max_shear is None:
        warped = affine_warp_bilinear(canvas, m_out_to_in, out_size)
    else:
        warped = affine_warp_shear(canvas, m_out_to_in, out_size, max_shear)

    if train and draws.get("jitter") is not None:
        warped = (warped * draws["jitter"].to(dev).float()).clamp(0.0, 1.0)

    mean = device_constant(cfg.mean, torch.float32, dev)
    std = device_constant(cfg.std, torch.float32, dev)
    images = (warped - mean) / std

    # Joint coordinates through the same affine, + L/R swap under flip.
    coords_crop = T.transform_coords(m_crop_from_canvas, coords_px.to(torch.float32))
    mask = mask.to(torch.float32)
    if train:
        perm = T.flip_permutation(coords_crop.shape[1], device=dev)
        coords_crop = torch.where(flip[:, None, None], coords_crop[:, perm],
                                  coords_crop)
        mask = torch.where(flip[:, None], mask[:, perm], mask)
    coords_norm = (2.0 * coords_crop + 1.0) / out_size - 1.0
    crop_from_orig = T.compose(m_crop_from_canvas, canvas_from_orig.to(torch.float32))
    return {
        "images": images,
        "coords": coords_norm,
        "mask": mask,
        "head_length": head_len_px,
        "crop_from_orig": crop_from_orig,
    }
