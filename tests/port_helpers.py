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
