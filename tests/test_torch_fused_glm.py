"""The fused value+gradient's plain version against the JAX Pallas kernel.

The JAX kernel runs in interpret mode on the CPU, as tests/test_pallas_glm.py
runs it; the port's wrapper takes its plain version for a CPU batch. The
CUDA kernel itself is held against the plain version on the card in
tests/test_torch_fused_glm_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops.pallas_glm import fused_value_and_gradient as jax_fused
from photon_ml_torch.data.batch import LabeledPointBatch
from photon_ml_torch.ops import fused_glm
from photon_ml_torch.ops.losses import LogisticLoss
from tests.torch_parity import LOSSES, NORMS, batches, loss_pair, make_data, normalizations, to_np


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,binary", LOSSES, ids=[n for n, _ in LOSSES])
def test_plain_version_matches_pallas_interpret(name, binary, bf16, norm):
    # ragged n and d (neither a tile nor a lane multiple), zero-weight rows
    n, d = 300, 20
    x, y, o, ws = make_data(11, n, d, binary, dtype=np.float32)
    jb, tb = batches(x, y, o, ws, bf16=bf16)
    jn, tn = normalizations(norm, x, intercept_index=d - 1, dtype=np.float32)
    w = (np.random.default_rng(1).normal(size=d) * 0.3).astype(np.float32)
    jl, tl = loss_pair(name)
    ref_v, ref_g = jax_fused(jl, jnp.asarray(w), jb, l2_weight=0.7, normalization=jn,
                             interpret=True)
    v, g = fused_glm.fused_value_and_gradient(tl, torch.from_numpy(w), tb, l2_weight=0.7,
                                              normalization=tn)
    assert v.dtype == torch.float32 and g.dtype == torch.float32
    # tolerances of tests/test_pallas_glm.py:47-48; both sides read the same
    # bf16-rounded X, so bf16 is held to the f32 tolerances too
    np.testing.assert_allclose(float(v), float(ref_v), rtol=2e-5)
    np.testing.assert_allclose(to_np(g), to_np(ref_g), rtol=2e-4, atol=2e-4)


def test_zero_weight_rows_ignored():
    x, y, o, ws = make_data(2, 64, 8, False, dtype=np.float32, zero_weight_every=0)
    ws[32:] = 0.0
    full = LabeledPointBatch.create(x, y, o, ws, device="cpu")
    cut = LabeledPointBatch.create(x[:32], y[:32], o[:32], ws[:32], device="cpu")
    w = torch.from_numpy(np.random.default_rng(2).normal(size=8).astype(np.float32))
    loss = loss_pair("SquaredLoss")[1]
    v1, g1 = fused_glm.fused_value_and_gradient(loss, w, full)
    v2, g2 = fused_glm.fused_value_and_gradient(loss, w, cut)
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-6)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-5)


def test_f64_batch_is_computed_in_f32_and_returned_in_f64():
    """A non-f32/bf16 feature block is cast to f32 (pallas_glm.py:182-183);
    value and gradient come back in the coefficients' dtype."""
    x, y, o, ws = make_data(4, 50, 6, True)
    b64 = LabeledPointBatch.create(x, y, o, ws, device="cpu")
    b32 = LabeledPointBatch.create(x.astype(np.float32), y, o, ws, dtype=torch.float32,
                                   device="cpu")
    w = torch.from_numpy(np.random.default_rng(3).normal(size=6))
    v64, g64 = fused_glm.fused_value_and_gradient(LogisticLoss(), w, b64, l2_weight=0.2)
    v32, g32 = fused_glm.fused_value_and_gradient(LogisticLoss(), w.float(), b32, l2_weight=0.2)
    assert v64.dtype == torch.float64 and g64.dtype == torch.float64
    np.testing.assert_allclose(float(v64), float(v32), rtol=1e-6)
    np.testing.assert_allclose(g64.numpy(), g32.double().numpy(), rtol=1e-5, atol=1e-5)


def test_reference_equals_wrapper_on_cpu():
    x, y, o, ws = make_data(5, 40, 5, True, dtype=np.float32)
    b = LabeledPointBatch.create(x, y, o, ws, device="cpu")
    w = torch.zeros(5)
    a = fused_glm.fused_value_and_gradient(LogisticLoss(), w, b, l2_weight=0.1)
    r = fused_glm.fused_value_and_gradient_reference(LogisticLoss(), w, b, l2_weight=0.1)
    assert torch.equal(a[0], r[0]) and torch.equal(a[1], r[1])


def test_kernel_entry_points_refuse_cpu_tensors():
    """The launchers take CUDA tensors only: a CPU tensor raises, it never
    falls back."""
    before = fused_glm.launches
    x = torch.zeros(4, 3)
    v = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        fused_glm.fused_partials(LogisticLoss(), x, v, v, v, torch.zeros(3))
    with pytest.raises(ValueError, match="CUDA"):
        fused_glm.reduce_partials(torch.zeros(2), torch.zeros(2), torch.zeros(2, 3))
    assert fused_glm.launches == before


def test_reduce_partials_reference():
    pv, pr, pg = torch.arange(3.0), torch.ones(3), torch.arange(6.0).reshape(3, 2)
    v, g, r = fused_glm.reduce_partials_reference(pv, pr, pg)
    assert float(v) == 3.0 and float(r) == 3.0 and g.tolist() == [6.0, 9.0]


@pytest.mark.parametrize("blocks,d", [(1, 1), (31, 17), (32, 512), (264, 512), (265, 4099),
                                      (132, 2048)])
def test_reduce_order_model(blocks, d):
    """The kernel's reduction order in plain f32 (``reduce_partials_in_order``):
    within f32 rounding of ``sum(0)`` (2·blocks·2^-24·Σ|terms|, the limit
    chip_smoke.py holds the card to); bitwise equal to it where every sum is
    exact (small integers); each column's result is the f32 sum of its 32
    strided sums, added in stride order; value and Σr as a xor butterfly
    over 32 lane sums; a None Σr stays None."""
    gen = torch.Generator().manual_seed(blocks * 7919 + d)
    pg = torch.randn(blocks, d, generator=gen)
    pv, pr = torch.randn(blocks, generator=gen), torch.randn(blocks, generator=gen)
    v, g, r = fused_glm.reduce_partials_in_order(pv, pr, pg)
    wv, wg, wr = fused_glm.reduce_partials_reference(pv, pr, pg)
    share = 2.0 * blocks * 2.0 ** -24
    assert bool(((g - wg).abs() <= share * pg.abs().sum(0) + 1e-30).all())
    assert abs(float(v - wv)) <= share * float(pv.abs().sum()) + 1e-30
    assert abs(float(r - wr)) <= share * float(pr.abs().sum()) + 1e-30
    # the order itself, column 0 and value, as scalar f32 additions
    col = [np.float32(0)] * 32
    for b in range(blocks):
        col[b % 32] = np.float32(col[b % 32] + np.float32(pg[b, 0]))
    want = np.float32(0)
    for k in range(32):
        want = np.float32(want + col[k])
    assert np.float32(g[0]) == want
    lanes = np.zeros(32, np.float32)
    for b in range(blocks):
        lanes[b % 32] = np.float32(lanes[b % 32] + np.float32(pv[b]))
    for off in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[np.arange(32) ^ off]).astype(np.float32)
    assert np.float32(v) == lanes[0]
    ints = torch.randint(-50, 50, (blocks, d), generator=gen).float()
    assert torch.equal(fused_glm.reduce_partials_in_order(pv, None, ints)[1], ints.sum(0))
    assert fused_glm.reduce_partials_in_order(pv, None, pg)[2] is None


#: the widths the card tests run B1 at (tests/test_torch_fused_glm_cuda.py):
#: one to 16 rows a tile, 1-8 column vectors a thread, odd bf16 rows
WIDE = [1, 15, 512, 1537, 2048, 3072, 4099]


@pytest.mark.parametrize("d", WIDE)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,binary", LOSSES, ids=[n for n, _ in LOSSES])
def test_plain_version_matches_pallas_interpret_wide(name, binary, bf16, d):
    """The widths the kernel's tile plan cuts differently (16 rows a tile at
    512, 4 or 8 at 2048, 2 or 4 at a ragged 4099): the plain version against
    the Pallas kernel in interpret mode, at a ragged n, standardized."""
    n = 97
    x, y, o, ws = make_data(d, n, d, binary, dtype=np.float32)
    jb, tb = batches(x, y, o, ws, bf16=bf16)
    jn, tn = normalizations("STANDARDIZATION", x, intercept_index=d - 1, dtype=np.float32)
    w = (np.random.default_rng(d).normal(size=d) * 0.3 / np.sqrt(d / 16)).astype(np.float32)
    jl, tl = loss_pair(name)
    ref_v, ref_g = jax_fused(jl, jnp.asarray(w), jb, l2_weight=0.7, normalization=jn,
                             interpret=True)
    v, g = fused_glm.fused_value_and_gradient(tl, torch.from_numpy(w), tb, l2_weight=0.7,
                                              normalization=tn)
    np.testing.assert_allclose(float(v), float(ref_v), rtol=2e-5)
    np.testing.assert_allclose(to_np(g), to_np(ref_g), rtol=2e-4, atol=2e-4)
