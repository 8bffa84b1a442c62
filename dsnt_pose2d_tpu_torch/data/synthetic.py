"""Synthetic-MPII fixture: a learnable fake dataset for CI and overfit tests.

A copy of ``dsnt_pose2d_tpu/data/synthetic.py`` (numpy only): the same seed
gives the same arrays in both packages.

SURVEY.md section 4's rebuild test plan item (d): a small set of generated
samples with the exact MPII record schema (canvas image, joint coords,
visibility, head length, center/scale) so the full train loop runs without the
real dataset.  Each joint is rendered as a distinct-colored Gaussian blob on a
textured background, so joint locations are recoverable from pixels and a
small model can overfit quickly.
"""

from __future__ import annotations

import numpy as np

NUM_JOINTS = 16


def make_synthetic_mpii(num_samples: int, canvas_size: int = 96,
                        seed: int = 0, num_joints: int = NUM_JOINTS):
    """Generate a dict-of-arrays synthetic dataset.

    Returns dict with:
        canvases: (N, C, C, 3) float32 in [0, 1]
        coords_px: (N, J, 2) joint coords in canvas px
        mask: (N, J) float32 visibility
        head_length: (N,) float32, in "original" px
        canvas_from_orig: (N, 3, 3) affine (identity: canvas IS the original)
    """
    rng = np.random.default_rng(seed)
    c = canvas_size
    canvases = rng.uniform(0.0, 0.25, size=(num_samples, c, c, 3)).astype(np.float32)

    # Distinct color per joint.  The palette must be the SAME across splits
    # (independent of `seed`) or joint identification cannot generalize from
    # train to val.
    palette_rng = np.random.default_rng(20260816)
    palette = palette_rng.uniform(0.5, 1.0, size=(num_joints, 3)).astype(np.float32)

    margin = 0.15 * c
    coords = rng.uniform(margin, c - 1 - margin,
                         size=(num_samples, num_joints, 2)).astype(np.float32)
    mask = (rng.uniform(size=(num_samples, num_joints)) > 0.1).astype(np.float32)

    yy, xx = np.mgrid[0:c, 0:c].astype(np.float32)
    sigma = c / 32.0
    for n in range(num_samples):
        for j in range(num_joints):
            if mask[n, j] == 0:
                continue
            x, y = coords[n, j]
            blob = np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * sigma ** 2))
            canvases[n] = np.clip(
                canvases[n] + blob[..., None] * palette[j], 0.0, 1.0)

    head_length = np.full((num_samples,), 0.12 * c, np.float32)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (num_samples, 3, 3)).copy()
    return {
        "canvases": canvases,
        "coords_px": coords,
        "mask": mask,
        "head_length": head_length,
        "canvas_from_orig": eye,
        # The synthetic canvas IS the annotation region (no crop headroom).
        "canvas_margin": np.ones((num_samples,), np.float32),
    }
