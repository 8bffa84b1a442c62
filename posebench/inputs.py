"""What a run makes from its seed: the person canvases with their records,
and the weights.

Both are made on the device in a few large calls.  The canvases are smooth
random images (noise at an eighth of the side, upsampled, plus fine
noise) in the MPII record layout of the port's packed archive: uint8
``(N, C, C, 3)`` canvases, joints in canvas pixels, visibility, head
lengths, the original -> canvas affine and the canvas margin.  They come
back to the host, where a packed split lives before it is staged.

The weights follow flax's default initializers (LeCun-normal conv kernels
truncated at two deviations, zero biases, unit BN scales), then the
backbone module's own draws for the leaves these leave (a transformer's
dense kernels, norms and position embeddings) and its residual branches
scaled (:mod:`.reference.model` says what a backbone module holds).  Then one fp32
pass of the reference over a few eval crops writes each BN's batch
statistics into its running ones, as training would, and scales each
stack's score conv so that its logits have a set deviation, stack by stack
in the same pass: at random initialization they would make one-hot or
uniform softmax maps, and the head would see no real distribution.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .reference import model as M
from .reference import preprocess as P

NUM_JOINTS = 16
CANVAS_MARGIN = 1.5        # the canvas spans 1.5x the person box, as the packer's
_BLOCK = 256               # canvases made per call


def canvas_side(cfg: dict) -> int:
    """The canvas side: 1.5x the model input (384 px for 256, 672 for 448)."""
    return 3 * M.input_size(cfg["model"]) // 2


def make_split(rows: int, canvas: int, seed: int, device) -> dict:
    """``rows`` records at ``canvas`` px from ``seed``, as host numpy arrays."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def uniform(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    pinned = torch.device(device).type == "cuda"
    host = torch.empty((rows, canvas, canvas, 3), dtype=torch.uint8, pin_memory=pinned)
    coarse = max(2, canvas // 8)
    for lo in range(0, rows, _BLOCK):
        n = min(_BLOCK, rows - lo)
        low = uniform(n, 3, coarse, coarse, lo=0.0, hi=255.0)
        img = F.interpolate(low, size=(canvas, canvas), mode="bilinear",
                            align_corners=False)
        img = img + uniform(n, 3, canvas, canvas, lo=-16.0, hi=16.0)
        host[lo:lo + n].copy_(img.clamp(0.0, 255.0).round().to(torch.uint8)
                              .permute(0, 2, 3, 1), non_blocking=pinned)
    if pinned:
        torch.cuda.synchronize(device)
    canvases = host.numpy()
    box = 200.0 * uniform(rows, lo=1.0, hi=3.0)          # MPII scale * 200 px
    center = torch.stack([uniform(rows, lo=300.0, hi=1000.0),
                          uniform(rows, lo=200.0, hi=500.0)], dim=-1)
    side = CANVAS_MARGIN * box
    s = canvas / side
    left, top = center[:, 0] - side / 2, center[:, 1] - side / 2
    aff = torch.zeros((rows, 3, 3), device=device)
    aff[:, 0, 0] = s
    aff[:, 1, 1] = s
    aff[:, 0, 2] = 0.5 * s - 0.5 - left * s
    aff[:, 1, 2] = 0.5 * s - 0.5 - top * s
    aff[:, 2, 2] = 1.0
    inner = canvas / CANVAS_MARGIN                        # the person box on the canvas
    coords = uniform(rows, NUM_JOINTS, 2, lo=(canvas - inner) / 2, hi=(canvas + inner) / 2)
    mask = (uniform(rows, NUM_JOINTS) < 0.85).float()
    head = 0.3 * box * uniform(rows, lo=0.8, hi=1.2)
    meta = {"coords_px": coords, "mask": mask, "head_length": head,
            "canvas_from_orig": aff,
            "canvas_margin": torch.full((rows,), CANVAS_MARGIN, device=device)}
    return {"canvases": canvases,
            **{k: v.float().cpu().numpy() for k, v in meta.items()}}


@torch.no_grad()
def make_weights(cfg: dict, seed: int, calib: dict, device, logit_std: float,
                 residual_scale: float = 1.0) -> dict:
    """The state dict of ``cfg``'s model from ``seed`` (on ``device``):
    flax's initializers for the convs and BNs, the backbone module's for
    the other leaves, its residual branches scaled by ``residual_scale``,
    then BN statistics and score-conv scales from one
    train-mode pass of the reference over the ``calib`` records' eval
    crops."""
    with torch.device("meta"):
        net = M.PoseNet(cfg)
    net = net.to_empty(device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    convs = [m for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    M.lecun_normal_(convs, gen)
    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d) and m.bias is not None:
            m.bias.zero_()
        elif isinstance(m, M.BatchNorm):
            m.reset_parameters()
    backbone = M.backbone_of(cfg)
    backbone.init_weights_(net, gen)
    backbone.scale_residual_(net, residual_scale)
    scores = net.backbone.score_convs()

    def temper(conv, _inputs, out):
        scale = logit_std / out.std()
        conv.weight.mul_(scale)
        conv.bias.mul_(scale)
        return out * scale

    hooks = [c.register_forward_hook(temper) for c in scores]
    batch = {k: torch.as_tensor(v).to(device) for k, v in calib.items()}
    try:
        with M.strict_fp32(), M.calibrating(net):
            pre = P.preprocess(batch, cfg["data"], M.input_size(cfg["model"]))
            net.train()(pre["images"])
    finally:
        for h in hooks:
            h.remove()
    return {k: v.detach() for k, v in net.state_dict().items()}


def flops(cfg: dict, batch: int, train: bool) -> float:
    """FLOPs of the model's forward (and, with ``train``, backward) pass at
    ``batch`` rows, counted by ``FlopCounterMode`` over the reference on the
    meta device: the convolutions' multiply-adds as two operations each."""
    from torch.utils.flop_counter import FlopCounterMode

    size = M.input_size(cfg["model"])
    with torch.device("meta"):
        net = M.PoseNet(cfg).train(train)
        images = torch.empty(batch, size, size, 3, requires_grad=False)
    counter = FlopCounterMode(display=False)
    with counter:
        out = net(images)
        if train:
            out.sum().backward()
    return float(counter.get_total_flops())


def request_sizes(weights: list, block: int, seed: int, count: int) -> np.ndarray:
    """``count`` request sizes: blocks of ``block`` requests holding size
    ``n`` exactly ``round(block * weights[n-1] / sum)`` times, each block
    shuffled by the seed, so every seed serves the same mix."""
    w = np.asarray(weights, np.float64)
    per = np.floor(block * w / w.sum()).astype(int)
    per[0] += block - per.sum()
    base = np.repeat(np.arange(1, len(w) + 1), per)
    rng = np.random.default_rng(seed)
    blocks = math.ceil(count / block)
    return np.concatenate([rng.permutation(base) for _ in range(blocks)])[:count]
