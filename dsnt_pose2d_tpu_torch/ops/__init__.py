"""Plain PyTorch DSNT ops (port of ``dsnt_pose2d_tpu/ops``) and, in
:mod:`.cuda`, the hand-written Hopper kernels with their plain versions."""

from .activations import HEATMAP_ACTIVATIONS, flat_softmax, thresholded_softmax
from .coords import coordinate_grids, normalized_linspace
from .dsnt import dsnt
from .gauss import make_gauss
from .losses import (REGULARIZERS, average_loss, euclidean_losses,
                     js_reg_losses, kl_reg_losses, mse_reg_losses,
                     variance_reg_losses)

__all__ = [
    "HEATMAP_ACTIVATIONS", "REGULARIZERS", "average_loss", "coordinate_grids",
    "dsnt", "euclidean_losses", "flat_softmax", "js_reg_losses",
    "kl_reg_losses", "make_gauss", "mse_reg_losses", "normalized_linspace",
    "thresholded_softmax", "variance_reg_losses",
]
