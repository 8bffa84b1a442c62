"""The reference's train steps and serving predictions.

:func:`train_steps` follows the program's first train steps from the same
weights, rows and draws: fp32 forward with flax's train-mode BN, the DSNT
loss, autograd's gradients and torch-compatible RMSProp (eps outside the
square root).  :func:`predict` is the serving path: the eval crop, the
eval-mode forward on the running statistics, the soft-argmax of the last
stack and the map back to original-image pixels.

Both take a ``control``: None, ``"fp8"`` (the forward under bf16 autocast
as the program runs it, every conv on fp8 operands: e4m3 inputs and
weights, e5m2 output gradients) or ``"half_batch"`` (the loss over the
first half of the rows; in serving, half of the crops left out and given
the other half's answers), which the harness's tests and calibration put
in the program's place.
"""

from __future__ import annotations

import torch

from . import head, model as M, preprocess as P


def _schedule_lr(optim: dict, steps_per_epoch: int, step: int) -> float:
    if optim["schedule"] == "constant":
        return optim["lr"]
    if optim["schedule"] != "step":
        raise ValueError(f"the reference has no schedule {optim['schedule']!r}")
    drops = sum(step >= e * steps_per_epoch for e in set(optim["lr_drop_epochs"]))
    return optim["lr"] * optim["lr_drop_factor"] ** drops


def check_optim(optim: dict):
    plain = (optim["optimizer"], optim["momentum"], optim["weight_decay"],
             optim["grad_clip_norm"])
    if plain != ("rmsprop", 0.0, 0.0, 0.0):
        raise ValueError(f"the reference optimizer is plain RMSProp, not {plain}")


def build(cfg: dict, weights: dict, device) -> torch.nn.Module:
    head.check_model(cfg["model"])
    with torch.device("meta"):
        net = M.PoseNet(cfg)
    net = net.to_empty(device=device)
    net.load_state_dict({k: v.to(device) for k, v in weights.items()}, strict=True)
    return net


CONTROLS = (None, "fp8", "half_batch")


def forward(net, images, control=None, remat: bool = False) -> torch.Tensor:
    """The raw maps in fp32; under the ``fp8`` control the forward runs as
    the program's bf16 autocast does, every conv on fp8 operands."""
    if control not in CONTROLS:
        raise ValueError(f"unknown control {control!r}")
    if control != "fp8":
        return net(images, remat=remat)
    with M.quantized(), torch.autocast(images.device.type, dtype=torch.bfloat16):
        return net(images, remat=remat).float()


def leaf_norms(tensors) -> torch.Tensor:
    return torch.stack([t.float().norm() for t in tensors])


def train_steps(cfg: dict, weights: dict, batches: list, train_seed: int,
                steps_per_epoch: int, device, control=None) -> dict:
    """``len(batches)`` train steps from ``weights``: each step's loss, each
    leaf's gradient norm at step 1 (``grad1``) and each leaf's change after
    the last step (``change``), by leaf name."""
    check_optim(cfg["optim"])
    optim, data, mcfg = cfg["optim"], cfg["data"], cfg["model"]
    size = M.input_size(mcfg)
    net = build(cfg, weights, device).train()
    names = [n for n, _ in net.named_parameters()]
    params = [p for _, p in net.named_parameters()]
    start = [p.detach().clone() for p in params]
    nus = [torch.zeros_like(p) for p in params]
    alpha, eps = optim["rmsprop_decay"], optim["eps"]
    losses, grad1 = [], None
    with M.strict_fp32():
        for step, host in enumerate(batches):
            batch = {k: torch.as_tensor(v).to(device) for k, v in host.items()}
            b = batch["canvases"].shape[0]
            with torch.no_grad():
                pre = P.preprocess(batch, data, size,
                                   P.draws(b, data, P.step_seed(train_seed, step), device))
            keep = slice(0, b // 2) if control == "half_batch" else slice(None)
            raw = forward(net, pre["images"][keep], control, remat=True)
            loss = head.pose_loss(raw, pre["coords"][keep], pre["mask"][keep], mcfg)
            for p in params:
                p.grad = None
            loss.backward()
            losses.append(float(loss.detach()))
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            if grad1 is None:
                grad1 = leaf_norms(grads)
            lr = _schedule_lr(optim, steps_per_epoch, step)
            with torch.no_grad():
                for p, g, nu in zip(params, grads, nus):
                    nu.mul_(alpha).addcmul_(g, g, value=1.0 - alpha)
                    p.sub_(lr * g / (nu.sqrt() + eps))
    change = leaf_norms([p.detach() - s for p, s in zip(params, start)])
    return {"losses": losses, "grad1": dict(zip(names, grad1.tolist())),
            "change": dict(zip(names, change.tolist()))}


@torch.no_grad()
def predict(cfg: dict, weights: dict, batch: dict, device, control=None,
            block: int = 32) -> torch.Tensor:
    """Original-image (N, J, 2) predictions for the crops of ``batch``
    (host arrays), ``block`` rows at a time."""
    mcfg, data = cfg["model"], cfg["data"]
    size = M.input_size(mcfg)
    net = build(cfg, weights, device).eval()
    n = len(batch["canvases"])
    out = []
    with M.strict_fp32():
        for lo in range(0, n, block):
            part = {k: torch.as_tensor(v[lo:lo + block]).to(device) for k, v in batch.items()}
            pre = P.preprocess(part, data, size)
            rows = pre["images"]
            if control == "half_batch":
                # The second half of the block is left out: its rows get
                # the first half's answers.
                half = max(1, len(rows) // 2)
                rows = rows[torch.arange(len(rows), device=rows.device) % half]
            coords = head.decode(forward(net, rows, control)[-1])
            out.append(P.to_original_px(coords, pre["crop_from_orig"], size).cpu())
    return torch.cat(out)
