"""Data pipeline: MPII reader, packed archive, synthetic fixture, on-device
augmentation and the batch loader."""

from .augment import affine_warp_bilinear, preprocess_batch
from .loader import ShardedLoader
from .mpii import ArrayDataset, MPIIDataset, load_annotations
from .synthetic import make_synthetic_mpii
from .transforms import (
    MPII_FLIP_PAIRS,
    MPII_SCALE_BOX_PX,
    crop_transform,
    flip_permutation,
    invert,
    rotation,
    scaling,
    transform_coords,
    translation,
)

__all__ = [
    "ArrayDataset",
    "MPIIDataset",
    "MPII_FLIP_PAIRS",
    "MPII_SCALE_BOX_PX",
    "ShardedLoader",
    "affine_warp_bilinear",
    "crop_transform",
    "flip_permutation",
    "invert",
    "load_annotations",
    "make_synthetic_mpii",
    "preprocess_batch",
    "rotation",
    "scaling",
    "transform_coords",
    "translation",
]
