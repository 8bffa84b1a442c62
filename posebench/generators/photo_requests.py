"""Serving photos in a closed loop: one client sends a photo's detected
people as one request, and the next photo once the answer is back.

Set-up makes a pool of person canvases (pageable host memory, as a decoded
photo's crops are) and the weights from the seed, builds the serving step
``train/loop.py::make_infer_fn`` under the configuration's own eval
settings, as ``cli/infer.py`` runs it, and warms up every request size.
Request ``i`` holds ``n_i`` crops, consecutive rows of the pool from an
offset drawn from the seed; the sizes come in blocks that hold each size in
a set proportion, shuffled by the seed, so every seed serves the same mix.
A request is timed on the host clock from the call until its predictions
are on the host.

The reference works out again the predictions of a sample of the requests
the window answered, drawn from the seed, with the largest request in it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import compare, harness, inputs
from ..metrics._roofline import step_calls
from ..reference import steps as R


class Traffic:
    def __init__(self, cell):
        from dsnt_pose2d_tpu_torch.train import loop

        self.cell, p, dev = cell, cell.traffic, cell.device
        self.cfg = harness.program_config(cell)
        self.compute_dtype = harness.COMPUTE_DTYPES[self.cfg.model.dtype]
        self.pool = inputs.make_split(p["pool_rows"], inputs.canvas_side(cell.config),
                                      cell.seed, dev)
        calib = {k: v[:p["calibration_rows"]] for k, v in self.pool.items()}
        weights = inputs.make_weights(cell.config, cell.seed, calib, dev,
                                      **cell.config_file["weights"]["made"])
        self.infer = loop.make_infer_fn(harness.program_model(self.cfg, weights, dev),
                                        self.cfg, dev)
        self.weights = {k: v.cpu() for k, v in weights.items()}
        del weights
        self.sizes = inputs.request_sizes(p["size_weights"], p["size_block"], cell.seed,
                                          p["max_requests"])
        rng = np.random.default_rng((cell.seed, 1))
        self.offsets = rng.integers(0, p["pool_rows"] - len(p["size_weights"]) + 1,
                                    size=len(self.sizes))
        harness.log("pool and weights made, serving step built; warm-up")
        self.next = 0
        for n in range(1, len(p["size_weights"]) + 1):
            for _ in range(p["warmup_per_size"]):
                self.infer(self._crops(0, n)).cpu()
        self.answers = {}
        self.setup_peak_bytes = harness.peak_bytes(dev)

    def _crops(self, offset: int, n: int) -> dict:
        return {k: v[offset:offset + n] for k, v in self.pool.items()}

    def _request(self) -> tuple[int, float]:
        i = self.next
        self.next += 1
        if i >= len(self.sizes):
            raise RuntimeError("the window outran max_requests")
        t0 = time.perf_counter()
        preds = self.infer(self._crops(self.offsets[i], self.sizes[i])).cpu()
        took = time.perf_counter() - t0
        self.answers[i] = preds
        return i, took

    def window(self, seconds: float) -> dict:
        harness.sync(self.cell.device)
        if self.cell.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        first, lat, t0 = self.next, [], time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            lat.append(self._request()[1])
        took = time.perf_counter() - t0
        q = np.percentile(lat, [5, 25, 50, 75, 95, 99]) * 1e3
        harness.log(f"{len(lat)} requests in {took:.3f} s; latency ms p5-p99 "
                    + " ".join(f"{v:.1f}" for v in q))
        done = range(first, self.next)
        crops = int(sum(self.sizes[i] for i in done))
        self.window_requests = list(done)
        peak = harness.peak_bytes(self.cell.device)
        failed = sum(not torch.isfinite(self.answers[i]).all() for i in done)
        return {"seconds": took, "attempted": len(lat), "failed": int(failed),
                "work": crops, "peak_bytes": peak,
                "serve_img_s": crops / took,
                "serve_p95_ms": 1e3 * float(np.percentile(lat, 95))}

    def flops_per_work(self) -> float:
        """FLOPs of one crop's forward pass."""
        return inputs.flops(self.cell.config, 1, train=False)

    def traced(self):
        n = self.cell.traffic["trace_requests"]
        sizes = [int(s) for s in self.sizes[self.next:self.next + n]]

        def run():
            for _ in range(n):
                self._request()

        calls = {}
        for s in sizes:
            for k, v in step_calls(self.cell.config, s, train=False).items():
                calls.setdefault(k, []).extend(v)
        return run, n, calls

    def release(self):
        del self.infer

    def sample(self) -> list:
        """The compared requests: a seeded sample of the window's, with its
        largest."""
        done = self.window_requests
        k = min(self.cell.traffic["check_requests"], len(done))
        rng = np.random.default_rng((self.cell.seed, 2))
        picked = set(rng.choice(done, size=k, replace=False).tolist())
        picked.add(max(done, key=lambda i: (self.sizes[i], -i)))
        return sorted(picked)

    def program(self) -> torch.Tensor:
        return torch.cat([self.answers[i] for i in self.sample()])

    def reference(self, control=None) -> torch.Tensor:
        """The reference's (or a control's) predictions of the sampled
        requests' crops."""
        picked = self.sample()
        batch = {k: np.concatenate([v[self.offsets[i]:self.offsets[i] + self.sizes[i]]
                                    for i in picked]) for k, v in self.pool.items()}
        return R.predict(self.cell.config, self.weights, batch, self.cell.device, control)

    compare = staticmethod(compare.serve_readings)

    def readings(self) -> dict:
        return self.compare(self.program(), self.reference())
