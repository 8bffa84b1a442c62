"""The calibration kernels' plain versions against the TPU kernels' bodies.

``_copy_k``, ``_exp_k`` and ``_smax_k`` are nested inside
``bench_kernel.py::calibrate`` and cannot be imported; their bodies are
copied here from ``bench_kernel.py:247-257`` and run through
``pl.pallas_call(..., interpret=True)`` with the same ``cdiv(n, 128)`` grid
and ``(128, cols)`` blocks, without the TPU memory spaces.

Tolerances: copy bitwise (one fp32 add); exp rtol 2e-6 (XLA-CPU's exp
against torch's on the CPU, each within a few ulp); softmax rtol 2e-6 and
atol 1e-9 (sums of 4096 terms in different orders).  The port's wrappers
run the plain versions for CPU tensors; the kernels themselves are held
against the plain versions on the card (``tests/test_torch_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dsnt_pose2d_tpu_torch.ops.cuda import calib, launch_counts, reset_launch_counts


# Copied from bench_kernel.py:247-257.
def _copy_k(s_ref, x_ref, o_ref):
    o_ref[:] = x_ref[:] + s_ref[0]


def _exp_k(s_ref, x_ref, o_ref):
    o_ref[:] = jnp.exp(x_ref[:] + s_ref[0])


def _smax_k(s_ref, x_ref, o_ref):
    xs = x_ref[:] + s_ref[0]
    m = jnp.max(xs, axis=1, keepdims=True)
    e = jnp.exp(xs - m)
    o_ref[:] = e / jnp.sum(e, axis=1, keepdims=True)


JAX_KERNELS = {"copy": _copy_k, "exp": _exp_k, "smax": _smax_k}
TOL = {"copy": None, "exp": dict(rtol=2e-6, atol=0),
       "smax": dict(rtol=2e-6, atol=1e-9)}


def _jax_calib(kernel, s, x):
    n, cols = x.shape
    return np.asarray(pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n, 128),),
        in_specs=[pl.BlockSpec((1,), lambda i: (0,)),
                  pl.BlockSpec((128, cols), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((128, cols), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n, cols), jnp.float32),
        interpret=True,
    )(jnp.asarray(s), jnp.asarray(x)))


def _inputs(rows, cols, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, cols)) * 3.0).astype(np.float32)
    s = np.array([0.37], np.float32)
    return x, s


@pytest.mark.parametrize("kind", sorted(JAX_KERNELS))
@pytest.mark.parametrize("rows", [256, 200])
def test_plain_version_matches_tpu_kernel_body(kind, rows):
    x, s = _inputs(rows, 4096, seed=rows)
    exp = _jax_calib(JAX_KERNELS[kind], s, x)
    reset_launch_counts()
    got = getattr(calib, f"calib_{kind}")(torch.from_numpy(x),
                                         torch.from_numpy(s)).numpy()
    assert not any(launch_counts().values())     # CPU: the plain version ran
    if TOL[kind] is None:
        np.testing.assert_array_equal(got, exp)
    else:
        np.testing.assert_allclose(got, exp, **TOL[kind])


@pytest.mark.parametrize("kind", sorted(JAX_KERNELS))
def test_wrappers_check_their_inputs(kind):
    fn = getattr(calib, f"calib_{kind}")
    x = torch.zeros((8, 16))
    s = torch.zeros((1,))
    with pytest.raises(ValueError, match="float32"):
        fn(x.double(), s)
    with pytest.raises(ValueError, match="float32"):
        fn(x, s.double())
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.zeros((16, 8)).t(), s)
    with pytest.raises(ValueError, match="multiple of 4"):
        fn(torch.zeros((8, 18)), s)
    with pytest.raises(ValueError, match="one value"):
        fn(x, torch.zeros((2,)))
    with pytest.raises(ValueError, match=r"\(rows, cols\)"):
        fn(torch.zeros((2, 8, 16)), s)
    if kind == "smax":
        with pytest.raises(ValueError, match="at most 4096"):
            fn(torch.zeros((2, 4100)), s)
    else:
        assert fn(torch.zeros((2, 4100)), s).shape == (2, 4100)


def test_wrappers_take_the_plain_version_only_for_cpu_tensors():
    # A CPU tensor runs the plain version; a tensor on any other device that
    # is not CUDA is refused (there is no fallback from the kernel).
    x, s = torch.ones((4, 8)), torch.full((1,), 0.5)
    assert torch.equal(calib.calib_copy(x, s), torch.full((4, 8), 1.5))
    meta_x, meta_s = x.to("meta"), s.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        calib.calib_exp(meta_x, meta_s)
    with pytest.raises(ValueError, match="s must be on x's device"):
        calib.calib_smax(x, meta_s)
