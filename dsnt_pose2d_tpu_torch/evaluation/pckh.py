"""PCKh@0.5 evaluation, MPII protocol (port of ``dsnt_pose2d_tpu/evaluation/pckh.py``).

A prediction is correct iff its distance to the ground truth in
ORIGINAL-image pixels is <= 0.5 * head segment length.  The per-batch
reduction :func:`pckh_batch_counts` runs on the device inside the eval step;
:class:`PCKhEvaluator` accumulates counts on the host.
"""

from __future__ import annotations

import numpy as np
import torch

# Reporting groups of the MPII PCKh table.
JOINT_GROUPS = {
    "head": (8, 9),
    "shoulder": (12, 13),
    "elbow": (11, 14),
    "wrist": (10, 15),
    "hip": (2, 3),
    "knee": (1, 4),
    "ankle": (0, 5),
}

# The MPII "total" is over the 14 group joints (no pelvis 6, thorax 7).
TOTAL_JOINTS = tuple(sorted(i for g in JOINT_GROUPS.values() for i in g))


def pckh_batch_counts(pred_orig_px: torch.Tensor, true_orig_px: torch.Tensor,
                      mask: torch.Tensor, head_length: torch.Tensor,
                      threshold: float = 0.5):
    """Per-joint ``(correct, total)`` float counts, each ``(J,)``."""
    dist = torch.linalg.vector_norm(pred_orig_px - true_orig_px, dim=-1)
    ok = (dist <= threshold * head_length[:, None]).to(torch.float32)
    mask = mask.to(torch.float32)
    return (ok * mask).sum(dim=0), mask.sum(dim=0)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class PCKhEvaluator:
    """Accumulates per-joint PCKh meters (reference ``add()`` surface)."""

    def __init__(self, num_joints: int = 16, threshold: float = 0.5):
        self.num_joints = num_joints
        self.threshold = threshold
        self.correct = np.zeros(num_joints)
        self.total = np.zeros(num_joints)
        # Split provenance ('val-list:...' or 'hash-holdout:...'), printed
        # with the table so that no PCKh number goes without its caveat.
        self.provenance = ""

    def add(self, pred_coords, true_coords, joint_mask, head_lengths):
        """All inputs in ORIGINAL-image pixel space."""
        c, t = pckh_batch_counts(
            torch.as_tensor(pred_coords), torch.as_tensor(true_coords),
            torch.as_tensor(joint_mask), torch.as_tensor(head_lengths),
            self.threshold)
        self.add_counts(c, t)

    def add_counts(self, correct, total):
        """Merge pre-reduced ``(J,)`` counts."""
        self.correct += _host(correct)
        self.total += _host(total)

    def per_joint(self) -> np.ndarray:
        return self.correct / np.maximum(self.total, 1.0)

    def groups(self) -> dict:
        return {name: sum(self.correct[i] for i in ids)
                / max(sum(self.total[i] for i in ids), 1.0)
                for name, ids in JOINT_GROUPS.items()}

    def total_pckh(self) -> float:
        """MPII total over the 14 group joints; all joints if not MPII's 16."""
        ids = [i for i in TOTAL_JOINTS if i < self.num_joints]
        if self.num_joints != 16 or not ids:
            return self.total_pckh_all()
        c = sum(self.correct[i] for i in ids)
        t = sum(self.total[i] for i in ids)
        return float(c / max(t, 1.0))

    def total_pckh_all(self) -> float:
        return float(self.correct.sum() / max(self.total.sum(), 1.0))

    def table(self) -> str:
        lines = ["PCKh@%.1f" % self.threshold]
        for name, v in self.groups().items():
            lines.append(f"  {name:<9s} {100 * v:6.2f}")
        lines.append(f"  {'total':<9s} {100 * self.total_pckh():6.2f}")
        lines.append(f"  {'total16':<9s} {100 * self.total_pckh_all():6.2f}")
        if self.provenance:
            note = ("" if self.provenance.startswith("val-list")
                    else " (NOT comparable to published Tompson-split numbers)")
            lines.append(f"  split: {self.provenance}{note}")
        return "\n".join(lines)

    def reset(self):
        self.correct[:] = 0
        self.total[:] = 0
