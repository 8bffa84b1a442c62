"""Training on a split staged in device memory, as the Trainer does when the
packed train split fits (``device_resident=auto``).

Set-up makes the split's records and the weights from the seed, stages the
split through the port's ``data/resident.py::ResidentTrainData`` and builds
one train step, ``train/loop.py::make_resident_multi_step`` (``k`` =
``steps_per_dispatch`` steps a call, gathered on the device from the epoch
order of the split).  The first calls of that step, through the window's
own feed, are the warm-up; an optimizer hook reads the state they leave
after step 1 (the first gradient, from RMSProp's square average) and after
the last compared step (each leaf's change), and the losses come back as
the step returns them.  The window then dispatches until ``--seconds``
have passed and ends on a read of the last dispatch's loss.  No eval pass
and no checkpoint run.

The reference follows the compared steps from the same weights, on the rows
the epoch order gives (worked out again from the seed) and the draws the
step's seed gives.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import compare, harness, inputs
from ..metrics._roofline import step_calls
from ..reference import steps as R

class _Probe:
    """An optimizer post-hook that reads the state after step 1 (each
    leaf's gradient norm, ``sqrt(sum(square_avg) / (1 - alpha))``) and
    after step ``last`` (each leaf's change from ``start``)."""

    def __init__(self, chain, names: list, start: list, last: int):
        self.opt = chain.optimizer
        self.params = list(chain.params)
        self.names, self.start, self.last = names, start, last
        self.count = 0
        self.grad1 = self.change = None
        self.handle = self.opt.register_step_post_hook(self)

    @torch.no_grad()
    def __call__(self, opt, *_):
        self.count += 1
        if self.count == 1:
            alpha = opt.param_groups[0]["alpha"]
            sums = torch._foreach_norm([opt.state[p]["square_avg"] for p in self.params], 1)
            self.grad1 = (torch.stack(sums) / (1.0 - alpha)).sqrt()
        if self.count == self.last:
            self.change = torch.stack(torch._foreach_norm(
                torch._foreach_sub([p.detach() for p in self.params], self.start)))

    def readings(self) -> dict:
        self.handle.remove()
        return {"grad1": dict(zip(self.names, self.grad1.tolist())),
                "change": dict(zip(self.names, self.change.tolist()))}


def epoch_rows(rows: int, seed: int, epoch: int) -> np.ndarray:
    """The split's row order in ``epoch``: one shard's permutation from
    ``(seed, epoch, 0)``, as the resident split orders it."""
    return np.random.default_rng((seed, epoch, 0)).permutation(rows)


class Traffic:
    def __init__(self, cell):
        from dsnt_pose2d_tpu_torch.data.mpii import ArrayDataset
        from dsnt_pose2d_tpu_torch.data.resident import ResidentTrainData
        from dsnt_pose2d_tpu_torch.train import loop

        self.cell, p, dev = cell, cell.traffic, cell.device
        self.cfg = harness.program_config(cell)
        self.compute_dtype = harness.COMPUTE_DTYPES[self.cfg.model.dtype]
        self.batch = self.cfg.train.batch_size
        self.k = self.cfg.train.steps_per_dispatch
        self.compare_steps = p["compare_steps"]
        if p["rows"] // self.batch % self.k:
            raise ValueError("an epoch of the split must be whole dispatches")
        split = inputs.make_split(p["rows"], inputs.canvas_side(cell.config), cell.seed, dev)
        harness.log("records made")
        calib = {k: v[:p["calibration_rows"]] for k, v in split.items()}
        weights = inputs.make_weights(cell.config, cell.seed, calib, dev,
                                      **cell.config_file["weights"]["made"])
        harness.log("weights made")
        model = harness.program_model(self.cfg, weights, dev)
        self.data = ResidentTrainData(ArrayDataset(split), self.batch, device=dev,
                                      seed=cell.seed)
        harness.log("split staged")
        order = epoch_rows(p["rows"], cell.seed, 0)
        self.ref_batches = [{k: v[order[i * self.batch:(i + 1) * self.batch]]
                             for k, v in split.items()} for i in range(self.compare_steps)]
        del split, calib
        spe = self.data.steps_per_epoch
        self.steps_per_epoch = spe
        step = loop.make_train_fn(model, self.cfg, dev, spe)
        self.multi = loop.make_resident_multi_step(model, self.cfg, dev, spe, step)
        self.single = loop.make_resident_step(model, self.cfg, dev, spe, step)
        self.groups = self._groups()
        harness.log("train step built; warm-up")
        names = [n for n, _ in model.net.named_parameters()]
        probe = _Probe(self.multi.state.optimizer, names,
                       [weights[n] for n in names], self.compare_steps)
        losses = []
        for _ in range(math.ceil(p["warmup_steps"] / self.k)):
            losses.extend(self._dispatch()["loss"].reshape(-1).tolist())
        self.prog = {"losses": losses[:self.compare_steps], **probe.readings()}
        self.weights = {k: v.cpu() for k, v in weights.items()}
        del weights, probe
        self.setup_peak_bytes = harness.peak_bytes(dev)

    def _groups(self):
        epoch = 0
        while True:
            yield from self.data.epoch_groups(epoch, self.k)
            epoch += 1

    def _dispatch(self) -> dict:
        kind, idx = next(self.groups)
        step = self.multi if kind == "multi" else self.single
        return step(self.data.resident, idx)

    def window(self, seconds: float) -> dict:
        harness.sync(self.cell.device)
        if self.cell.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        outs, marks, t0 = [], [], time.perf_counter()
        while True:
            outs.append(self._dispatch())
            marks.append(time.perf_counter() - t0)
            if marks[-1] >= seconds:
                break
        float(outs[-1]["loss"].reshape(-1)[-1])
        took = time.perf_counter() - t0
        harness.log("dispatches returned at " + " ".join(f"{m:.2f}" for m in marks)
                    + f"; window {took:.3f} s")
        losses = torch.cat([o["loss"].reshape(-1) for o in outs])
        steps = len(losses)
        peak = harness.peak_bytes(self.cell.device)
        return {"seconds": took, "attempted": steps, "work": steps,
                "failed": int((~torch.isfinite(losses)).sum()), "peak_bytes": peak,
                "train_img_s": steps * self.batch / took, "peak_mem_gib": peak / 2 ** 30}

    def flops_per_work(self) -> float:
        """FLOPs of one train step (forward and backward) at the batch."""
        return inputs.flops(self.cell.config, self.batch, train=True)

    def traced(self):
        n = math.ceil(self.cell.traffic["trace_steps"] / self.k)

        def run():
            for _ in range(n):
                self._dispatch()

        one = step_calls(self.cell.config, self.batch, train=True)
        units = n * self.k
        calls = {k: v * units for k, v in one.items()}
        return run, units, calls

    def release(self):
        del self.multi, self.single, self.data, self.groups

    def program(self) -> dict:
        return self.prog

    def reference(self, control=None) -> dict:
        """The reference's (or a control's) run of the compared steps."""
        return R.train_steps(self.cell.config, self.weights, self.ref_batches,
                             self.cell.seed, self.steps_per_epoch, self.cell.device,
                             control=control)

    compare = staticmethod(compare.train_readings)

    def readings(self) -> dict:
        return self.compare(self.program(), self.reference())

