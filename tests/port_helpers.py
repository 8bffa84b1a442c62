"""Helpers shared by the port's parity tests (``tests/test_torch_*.py``)."""

import jax
import jax.numpy as jnp
import numpy as np


def perturb(variables, seed=0):
    """Non-trivial BN statistics/affines and biases, so the mapping of every
    tensor shows in the output (flax initialises mean 0, var 1, scale 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        x = np.array(x)
        if name == "mean":
            return x + rng.normal(0, 0.1, x.shape).astype(x.dtype)
        if name in ("var", "scale"):
            return x * rng.uniform(0.6, 1.4, x.shape).astype(x.dtype)
        if name == "bias":
            return x + rng.normal(0, 0.05, x.shape).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def jax_train_draws(key, batch: int, cfg) -> dict:
    """The train augmentation draws that the JAX package's ``preprocess_batch``
    makes from ``key`` (the train branch's draws and the color jitter of
    ``dsnt_pose2d_tpu/data/augment.py``), as numpy arrays, so that the port's
    train path can be fed the same draws."""
    k_rot, k_scale, k_flip, k_jit, k_rotp = jax.random.split(key, 5)
    rot = jax.random.uniform(k_rot, (batch,), minval=-cfg.max_rotation_deg,
                             maxval=cfg.max_rotation_deg) * (jnp.pi / 180.0)
    if cfg.rotation_prob < 1.0:
        apply_rot = jax.random.bernoulli(k_rotp, cfg.rotation_prob, (batch,))
        rot = jnp.where(apply_rot, rot, 0.0)
    scale = jax.random.uniform(k_scale, (batch,), minval=cfg.scale_range[0],
                               maxval=cfg.scale_range[1])
    flip = jax.random.bernoulli(k_flip, cfg.flip_prob, (batch,))
    jitter = None
    if cfg.color_jitter > 0:
        jitter = np.array(jax.random.uniform(
            k_jit, (batch, 1, 1, 3), minval=1.0 - cfg.color_jitter,
            maxval=1.0 + cfg.color_jitter))
    return {"rot": np.array(rot), "scale": np.array(scale),
            "flip": np.array(flip), "jitter": jitter}


def jax_backbone(base: str, num_joints: int, dtype, features: int = 32,
                 depth: int = 4, dilate: int = 0, truncate: int = 0):
    """The bare flax backbone of ``base`` (``hg*`` or ``resnet*``) in ``dtype``."""
    from dsnt_pose2d_tpu.models.hourglass import HourglassNet
    from dsnt_pose2d_tpu.models.resnet import ResNetPose

    if base.startswith("hg"):
        return HourglassNet(num_stacks=int(base[2:]), num_joints=num_joints,
                            features=features, depth=depth, dtype=dtype)
    return ResNetPose(arch=base, num_joints=num_joints, dilate=dilate,
                      truncate=truncate, dtype=dtype)


def fp64_train_step(model_kw: dict, loss_fns, batch: int = 2, seed: int = 0):
    """One fp64 train step of a ``PoseNet`` (backbone, fc head where the
    strategy has one) in both packages, from the same perturbed weights,
    images, targets and mask.

    ``loss_fns = (jax_loss, port_loss)``, each ``(output, t, mask, cfg) ->
    (loss, aux)`` over its package's ``PoseOutput``.  The JAX side is the
    bare flax backbone in fp64 (``jax.enable_x64``) plus the fc head as the
    JAX ``PoseNet`` applies it; the port side is its ``PoseNet`` in fp64
    (``.double()``, the backbone's dtype fp64), loaded through
    ``pose_net_from_jax``.  Both take one step of their RMSProp chain.
    Returns ``(got, exp)`` namespaces of ``loss``, ``aux``, ``grads`` and
    ``after`` (parameters and BN statistics) under the port's names.
    """
    from types import SimpleNamespace

    import optax
    import torch

    from dsnt_pose2d_tpu.models import heads as jheads
    from dsnt_pose2d_tpu.train.state import make_optimizer as j_make_optimizer
    from dsnt_pose2d_tpu.utils import config as jconfig
    from dsnt_pose2d_tpu_torch.models.factory import build_pose_model
    from dsnt_pose2d_tpu_torch.models.from_jax import pose_net_from_jax
    from dsnt_pose2d_tpu_torch.train.state import make_optimizer
    from dsnt_pose2d_tpu_torch.utils import config as tconfig

    jcfg = jconfig.ModelConfig(**model_kw, dtype="float32", use_pallas=False)
    tcfg = tconfig.ModelConfig(**model_kw, dtype="float32", use_pallas=False)
    size, j = jcfg.resolved_input_size, jcfg.num_joints
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, size, size, 3)) * 0.5
    t = rng.uniform(-0.7, 0.7, size=(batch, j, 2))
    mask = (rng.uniform(size=(batch, j)) > 0.2).astype(np.float64)
    jax_loss, port_loss = loss_fns
    with jax.enable_x64(True):
        backbone = jax_backbone(jcfg.base, j, jnp.float64, jcfg.hg_features,
                                jcfg.hg_depth, jcfg.dilate, jcfg.truncate)
        init = backbone.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
        variables = {"params": {"backbone": init["params"]},
                     "batch_stats": {"backbone": init["batch_stats"]}}
        if jcfg.output_strat == "fc":
            hw = np.prod(backbone.apply(init, jnp.asarray(x[:1]),
                                        train=False).shape[-2:])
            variables["params"]["fc_head_kernel"] = rng.normal(
                0, 1e-3, size=(j, int(hw), 2))
            variables["params"]["fc_head_bias"] = rng.normal(0, 1e-2, size=(j, 2))
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                           perturb(variables, seed=seed))
        params, stats = variables["params"], variables["batch_stats"]

        def loss_fn(p):
            raw, mutated = backbone.apply(
                {"params": p["backbone"], "batch_stats": stats["backbone"]},
                jnp.asarray(x), train=True, mutable=["batch_stats"])
            fc = None
            if "fc_head_kernel" in p:
                s, b, jj, h, w = raw.shape
                flat = raw.reshape(s, b, jj, h * w).astype(jnp.float32)
                fc = jnp.einsum("sbjp,jpc->sbjc", flat,
                                p["fc_head_kernel"]) + p["fc_head_bias"]
            loss, aux = jax_loss(jheads.PoseOutput(heatmaps=raw, fc_coords=fc),
                                 jnp.asarray(t), jnp.asarray(mask), jcfg)
            return loss, (aux, mutated["batch_stats"])

        (loss_j, (aux_j, stats_j)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
        tx = j_make_optimizer(jconfig.OptimConfig())
        updates, _ = tx.update(grads, tx.init(params), params)
        params_j = optax.apply_updates(params, updates)
        exp = SimpleNamespace(
            loss=float(loss_j), aux=jax.device_get(aux_j),
            grads=pose_net_from_jax({"params": grads, "batch_stats": stats}, jcfg),
            after=pose_net_from_jax({"params": params_j,
                                     "batch_stats": {"backbone": stats_j}}, jcfg))

    model = build_pose_model(tcfg, device="cpu", state_dict=pose_net_from_jax(
        variables, jcfg))
    net = model.net.double()
    net.backbone.dtype = torch.float64
    net.train()
    opt = make_optimizer(net.parameters(), tconfig.OptimConfig())
    loss_t, aux_t = port_loss(net(torch.from_numpy(x)), torch.from_numpy(t),
                              torch.from_numpy(mask), tcfg)
    opt.zero_grad()
    loss_t.backward()
    grads_t = {n: p.grad.numpy().copy() for n, p in net.named_parameters()}
    opt.step()
    got = SimpleNamespace(
        loss=loss_t.item(), aux={k: v.detach().numpy() for k, v in aux_t.items()},
        grads=grads_t, after={k: v.numpy() for k, v in net.state_dict().items()})
    return got, exp
