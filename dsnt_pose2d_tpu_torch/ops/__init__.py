"""Plain PyTorch DSNT ops (port of ``dsnt_pose2d_tpu/ops``) and, in
:mod:`.cuda`, the hand-written Hopper kernels with their plain versions."""

from .activations import (HEATMAP_ACTIVATIONS, abs_normalized, flat_softmax,
                          relu_normalized, sigmoid_normalized,
                          thresholded_softmax)
from .coords import (coordinate_grids, normalized_linspace, normalized_to_pixel,
                     pixel_to_normalized)
from .decode import heatmaps_to_coords
from .dsnt import dsnt
from .gauss import make_gauss
from .losses import (COORD_LOSSES, REGULARIZERS, average_loss,
                     euclidean_losses, js_reg_losses, kl_reg_losses,
                     l1_losses, mse_losses, mse_reg_losses,
                     variance_reg_losses)

__all__ = [
    "COORD_LOSSES", "HEATMAP_ACTIVATIONS", "REGULARIZERS", "abs_normalized",
    "average_loss", "coordinate_grids", "dsnt", "euclidean_losses",
    "flat_softmax", "heatmaps_to_coords", "js_reg_losses", "kl_reg_losses",
    "l1_losses", "make_gauss", "mse_losses", "mse_reg_losses",
    "normalized_linspace", "normalized_to_pixel", "pixel_to_normalized",
    "relu_normalized", "sigmoid_normalized", "thresholded_softmax",
    "variance_reg_losses",
]
