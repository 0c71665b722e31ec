"""The CUDA kernel of ops/packed_glm.py against its plain version, on the card.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed. Every test needs an NVIDIA GPU and skips without one; on the
card run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_packed_glm_cuda.py
"""

import numpy as np
import pytest
import torch

from photon_ml_torch.ops import losses, packed_glm
from photon_ml_torch.ops.normalization import NormalizationContext

pytestmark = pytest.mark.cuda

LOSS_NAMES = ["LogisticLoss", "SquaredLoss", "PoissonLoss", "SmoothedHingeLoss"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(n, d, binary, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    x = t(rng.normal(size=(n, d))).to(dtype)
    y = t((rng.uniform(size=n) < 0.5) if binary else rng.uniform(0, 3, size=n))
    o = t(rng.normal(scale=0.1, size=n))
    ws = rng.uniform(0.2, 2.0, size=n)
    ws[::5] = 0.0
    w = t(rng.normal(size=d) * 0.3 / np.sqrt(d / 16))
    return x, y, o, t(ws), w


def _limits(dtype, units):
    """(value rel, gradient atol as a share of max|g|): f32 1e-5 and 1e-4;
    bf16 (the same rounded inputs on both sides) 1e-4; a product in TF32
    (``mma`` on an f32 block, ``mma_tf32`` on either) against the plain
    version's f32: 1e-4 and 5e-3."""
    if "mma_tf32" in units or (dtype == torch.float32 and "mma" in units):
        return 1e-4, 5e-3
    return (1e-5 if dtype == torch.float32 else 1e-4), 1e-4


def _check(kernel, plain, dtype, units):
    v1, g1, s1 = kernel()
    v2, g2, s2 = kernel()
    vr, gr, sr = plain()
    torch.cuda.synchronize()
    assert torch.equal(v1, v2) and torch.equal(g1, g2)  # bitwise repeatable
    vtol, gshare = _limits(dtype, units)
    assert abs(float(v1 - vr)) <= vtol * abs(float(vr))
    assert torch.allclose(g1, gr, rtol=1e-4, atol=gshare * float(gr.abs().max()))
    assert (s1 is None) == (sr is None)
    if s1 is not None:
        assert torch.equal(s1, s2)


@pytest.mark.parametrize("n,d", [(4096, 512), (1007, 123), (33, 1), (17, 1536)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("loss_name", LOSS_NAMES)
def test_packed_kernel_matches_plain(cuda, loss_name, dtype, n, d):
    loss = getattr(losses, loss_name)()
    x, y, o, ws, w = _case(n, d, loss_name in ("LogisticLoss", "SmoothedHingeLoss"), dtype, cuda)
    aux = packed_glm.pack_aux(y, o, ws)
    shift = torch.tensor(0.05, device=cuda)
    before = packed_glm.packed_launches
    for with_rsum in (True, False):
        for units in (("fma", "fma"), ("mma", "mma"), ("fma", "mma"), ("mma", "fma")):
            for rows in sorted(packed_glm.SOURCES):
                if d > packed_glm.max_staged_d(x.element_size(), rows):
                    continue
                kw = dict(with_rsum=with_rsum, margin_unit=units[0], grad_unit=units[1])
                _check(lambda: packed_glm.packed_core(loss, x, aux, w, shift, rows_per_tile=rows,
                                                      **kw),
                       lambda: packed_glm.packed_core_reference(loss, x, aux, w, shift, **kw),
                       dtype, units)
    assert packed_glm.packed_launches > before


@pytest.mark.parametrize("with_o", [True, False])
@pytest.mark.parametrize("with_rsum", [True, False])
def test_columns_kernel_matches_plain(cuda, with_o, with_rsum):
    loss = losses.LogisticLoss()
    x, y, o, ws, w = _case(1007, 123, True, torch.float32, cuda, seed=1)
    off = o if with_o else None
    before = packed_glm.columns_launches
    _check(lambda: packed_glm.columns_core(loss, x, y, ws, off, w, with_rsum=with_rsum),
           lambda: packed_glm.columns_core_reference(loss, x, y, ws, off, w,
                                                     with_rsum=with_rsum),
           torch.float32, ("fma", "fma"))
    assert packed_glm.columns_launches == before + 2


@pytest.mark.parametrize("n,d", [(1 << 14, 512), (1007, 123)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_probe_forms_match_plain(cuda, dtype, n, d):
    """The form of experiments/kernel_probe.py, kernel_probe2.py and
    kernel_probe3.py: separate columns with neither offsets nor Σr, every
    unit pair (``mma_tf32`` included), both tile builds."""
    loss = losses.LogisticLoss()
    x, y, _, ws, w = _case(n, d, True, dtype, cuda, seed=3)
    for units in [(mu, gu) for mu in packed_glm.UNITS for gu in packed_glm.UNITS]:
        for rows in sorted(packed_glm.SOURCES):
            before = packed_glm.columns_launches
            kw = dict(with_rsum=False, margin_unit=units[0], grad_unit=units[1])
            _check(lambda: packed_glm.columns_core(loss, x, y, ws, None, w, **kw),
                   lambda: packed_glm.columns_core_reference(loss, x, y, ws, None, w, **kw),
                   dtype, units)
            assert packed_glm.columns_launches == before + 2


def test_tf32_unit_on_a_bf16_block_widens_the_tile(cuda):
    """On a bf16 block ``mma_tf32`` keeps w and r out of bf16: it lands
    nearer the f32 product than the bf16 ``mma`` does, and on an f32 block
    it is ``mma``, bit for bit."""
    loss = losses.LogisticLoss()
    x, y, o, ws, w = _case(4096, 256, True, torch.bfloat16, cuda, seed=4)
    aux = packed_glm.pack_aux(y, o, ws)
    plain = packed_glm.packed_core_reference(loss, x, aux, w)
    tf32 = packed_glm.packed_core(loss, x, aux, w, margin_unit="mma_tf32", grad_unit="mma_tf32")
    bf16 = packed_glm.packed_core(loss, x, aux, w, margin_unit="mma", grad_unit="mma")
    assert float((tf32[1] - plain[1]).abs().max()) < float((bf16[1] - plain[1]).abs().max())
    xf = x.float()
    a = packed_glm.packed_core(loss, xf, aux, w, margin_unit="mma_tf32", grad_unit="mma_tf32")
    b = packed_glm.packed_core(loss, xf, aux, w, margin_unit="mma", grad_unit="mma")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_wrapper_with_normalization_and_refusals(cuda):
    loss = losses.LogisticLoss()
    x, y, o, ws, w = _case(2000, 64, True, torch.float32, cuda, seed=2)
    aux = packed_glm.pack_aux(y, o, ws)
    norm = NormalizationContext(0.5 + torch.rand(64, device=cuda),
                                0.1 * torch.randn(64, device=cuda))
    got = packed_glm.packed_value_and_gradient(loss, w, x, aux, l2_weight=0.5,
                                               normalization=norm)
    ref = packed_glm.packed_value_and_gradient(loss, w, x, aux, l2_weight=0.5,
                                               normalization=norm, reference=True)
    assert abs(float(got[0] - ref[0])) <= 1e-5 * abs(float(ref[0]))
    assert torch.allclose(got[1], ref[1], rtol=1e-4, atol=1e-4 * float(ref[1].abs().max()))
    assert packed_glm._lib().packed_glm_max_staged_d(4) == packed_glm.max_staged_d(4)
    assert packed_glm._lib(32).packed_glm_max_staged_d(2) == packed_glm.max_staged_d(2, 32)
    with pytest.raises(ValueError, match="wider than one staged pass"):
        packed_glm.packed_core(loss, torch.zeros((8, 2000), device=cuda),
                               torch.zeros((8, 3), device=cuda), torch.zeros(2000, device=cuda))
    with pytest.raises(ValueError, match="aux must be"):
        packed_glm.packed_core(loss, x, aux[:, :2].contiguous(), w)
    with pytest.raises(ValueError, match="contiguous"):
        packed_glm.packed_core(loss, x.t().contiguous().t(), aux, w)
    with pytest.raises(ValueError, match="logistic loss only"):
        packed_glm.packed_core(losses.SquaredLoss(), x.to(torch.bfloat16), aux, w,
                               margin_unit="mma_tf32")
