"""The port's pointwise losses against the JAX package's, element-wise in f64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops.losses import loss_for_task as jax_loss_for_task
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_torch.ops.losses import loss_for_task
from photon_ml_torch.types import TaskType
from tests.torch_parity import LOSSES, loss_pair

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

# margins across the range, with |z| > 20 (where a thresholded softplus
# would return z itself) and the hinge's t = 0 and t = 1 boundaries exactly
MARGINS = np.concatenate([
    np.linspace(-40.0, 40.0, 161),
    [-1.0, -0.5, -1e-12, 0.0, 1e-12, 0.5, 1.0 - 1e-12, 1.0, 1.0 + 1e-12, 20.0, 20.5, 35.0],
])


def _labels(binary: bool, n: int) -> np.ndarray:
    rng = np.random.default_rng(3)
    if binary:
        return (np.arange(n) % 2).astype(np.float64)
    return rng.uniform(0.0, 4.0, size=n)


@pytest.mark.parametrize("part", ["loss", "dz", "d2z"])
@pytest.mark.parametrize("name,binary", LOSSES, ids=[n for n, _ in LOSSES])
def test_loss_elementwise_f64(name, binary, part):
    jl, tl = loss_pair(name)
    z = MARGINS
    if name == "PoissonLoss":
        z = z[np.abs(z) <= 25.0]  # exp(40) would only test float overflow
    # each margin once with each label value
    z = np.repeat(z, 2)
    y = _labels(binary, z.size)
    zj, yj = jnp.asarray(z), jnp.asarray(y)
    zt, yt = torch.from_numpy(z), torch.from_numpy(y)
    if part == "d2z":
        ref, got = jl.d2z(zj, yj), tl.d2z(zt, yt)
    else:
        k = 0 if part == "loss" else 1
        ref, got = jl.loss_and_dz(zj, yj)[k], tl.loss_and_dz(zt, yt)[k]
        np.testing.assert_allclose(tl.loss(zt, yt).numpy(),
                                   np.asarray(jl.loss(zj, yj)), rtol=1e-13, atol=1e-12)
    assert got.dtype == torch.float64
    # atol 1e-12 holds the values near 0; rtol 1e-13 allows an ulp of the
    # libm exp at |z| up to 25, where exp(z) ~ 7e10
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13, atol=1e-12)


def test_softplus_is_exact_beyond_threshold():
    """softplus(z) - z at z = 21 is e^-21 ~ 7.6e-10: the port keeps it."""
    from photon_ml_torch.ops.losses import LogisticLoss

    z = torch.tensor([21.0], dtype=torch.float64)
    l, _ = LogisticLoss().loss_and_dz(z, torch.zeros_like(z))
    # l - z cancels all but ~7 digits of e^-21
    np.testing.assert_allclose((l - z).numpy(), np.exp(-z.numpy()), rtol=1e-5)


def test_hinge_boundaries_exact():
    from photon_ml_torch.ops.losses import SmoothedHingeLoss

    y = torch.ones(3, dtype=torch.float64)
    z = torch.tensor([0.0, 1.0, 0.5], dtype=torch.float64)
    l, dz = SmoothedHingeLoss().loss_and_dz(z, y)
    assert l.tolist() == [0.5, 0.0, 0.125]
    assert dz.tolist() == [-1.0, 0.0, -0.5]
    assert SmoothedHingeLoss().d2z(z, y).tolist() == [0.0, 0.0, 1.0]


@pytest.mark.parametrize("task", [t for t in TaskType if t != TaskType.NONE])
def test_loss_for_task_matches(task):
    port = loss_for_task(task)
    ref = jax_loss_for_task(JaxTaskType(task.value))
    assert type(port).__name__ == type(ref).__name__
    assert port.twice_differentiable == ref.twice_differentiable


def test_loss_for_task_none_raises():
    with pytest.raises(ValueError):
        loss_for_task(TaskType.NONE)
