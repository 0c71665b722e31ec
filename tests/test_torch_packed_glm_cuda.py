"""The CUDA kernel of ops/packed_glm.py against its plain version, on the card.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed. Every test needs an NVIDIA GPU and skips without one; on the
card run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_packed_glm_cuda.py
"""

import numpy as np
import pytest
import torch

from dev import torch_kernel_probe as tkp
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


def _check(kernel, plain, dtype, units, loss=None, inputs=None):
    """Twice bitwise equal, and within the f32 (value rel 1e-5, gradient
    atol 1e-4 max|g|) or bf16 (1e-4, the same rounded inputs on both sides)
    limits of the plain version, plus what a product in TF32 may move each
    output by (``dev/torch_kernel_probe.tf32_slack`` over ``inputs`` =
    (x, labels, offsets, weights, w, shift))."""
    name = str(dtype).replace("torch.", "")
    slack = None if inputs is None else tkp.tf32_slack(loss, *inputs, *units)
    rsum_scale = 1.0 if inputs is None else float(inputs[3].abs().sum())
    return tkp.compare(torch, f"{name} {units}", kernel, plain, *tkp.limits(name),
                       rsum_scale, slack)


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
                       dtype, units, loss, (x, y, o, ws, w, shift))
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
           torch.float32, ("fma", "fma"), loss, (x, y, off, ws, w, None))
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
                   dtype, units, loss, (x, y, None, ws, w, None))
            assert packed_glm.columns_launches == before + 2


ALL_UNITS = [(mu, gu) for mu in packed_glm.UNITS for gu in packed_glm.UNITS]


@pytest.mark.parametrize("d", [1, 123, 250, 513])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ragged_rows_and_widths_every_unit(cuda, dtype, d):
    """n not a multiple of either tile's rows and d not a multiple of 8, 16
    or 32: the staged rows' zero padding and the ragged last tile, every
    unit pair (twice bitwise equal) at both tile builds."""
    loss = losses.LogisticLoss()
    x, y, o, ws, w = _case(1000 + 7, d, True, dtype, cuda, seed=5)
    aux = packed_glm.pack_aux(y, o, ws)
    shift = torch.tensor(-0.1, device=cuda)
    for units in ALL_UNITS:
        for rows in sorted(packed_glm.SOURCES):
            kw = dict(margin_unit=units[0], grad_unit=units[1])
            _check(lambda: packed_glm.packed_core(loss, x, aux, w, shift, rows_per_tile=rows,
                                                  **kw),
                   lambda: packed_glm.packed_core_reference(loss, x, aux, w, shift, **kw),
                   dtype, units, loss, (x, y, o, ws, w, shift))


@pytest.mark.parametrize("rows", [16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_widest_staged_block_and_one_wider(cuda, dtype, rows):
    """d at ``max_staged_d`` runs (the library agrees on the width); one
    column more is refused with its message."""
    loss = losses.SquaredLoss()
    itemsize = torch.tensor([], dtype=dtype).element_size()
    widest = packed_glm.max_staged_d(itemsize, rows)
    assert packed_glm._lib(rows).packed_glm_max_staged_d(itemsize) == widest
    x, y, o, ws, w = _case(rows + 3, widest, False, dtype, cuda, seed=6)
    aux = packed_glm.pack_aux(y, o, ws)
    for units in (("fma", "fma"), ("mma", "mma")):
        kw = dict(margin_unit=units[0], grad_unit=units[1])
        _check(lambda: packed_glm.packed_core(loss, x, aux, w, rows_per_tile=rows, **kw),
               lambda: packed_glm.packed_core_reference(loss, x, aux, w, **kw),
               dtype, units, loss, (x, y, o, ws, w, None))
    wider = torch.zeros((rows, widest + 1), dtype=dtype, device=cuda)
    with pytest.raises(ValueError, match=f"d={widest + 1} is wider than one staged pass"):
        packed_glm.packed_core(loss, wider, aux[:rows], torch.zeros(widest + 1, device=cuda),
                               rows_per_tile=rows)


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


FORMS = ["packed fma Σr", "packed fma", "packed mma Σr", "columns fma o Σr", "columns fma",
         "packed fma Σr rows=32"]


@pytest.mark.parametrize("dtype,form", [(t, f) for t in (torch.float32, torch.bfloat16)
                                        for f in FORMS] + [(torch.bfloat16, "columns mma_tf32")],
                         ids=lambda v: str(v).replace("torch.", ""))
def test_ordered_reduce_matches_the_order_model(cuda, dtype, form):
    """Every operand form's reduction: value, gradient and Σr (or None)
    bitwise equal to the plain f32 model of its order
    (``fused_glm.reduce_partials_in_order``) over the partials kernel's
    partials; an evaluation (both kernels) captures into a CUDA graph and
    replays bitwise."""
    from photon_ml_torch.ops import fused_glm

    n, d = 20_011, 256
    loss = losses.LogisticLoss()
    x, y, o, ws, w = _case(n, d, True, dtype, cuda, seed=3)
    aux = packed_glm.pack_aux(y, o, ws)
    unit = next(u for u in ("mma_tf32", "mma", "fma") if u in form)
    with_rsum = "Σr" in form
    rows = 32 if "rows=32" in form else 16
    if form.startswith("packed"):
        args = (loss, x, aux, None, None, None, w, None, with_rsum, unit, unit, rows)
    else:
        args = (loss, x, None, y, o if " o " in form else None, ws, w, None, with_rsum, unit,
                unit, rows)
    before = packed_glm.reduce_launches
    parts = packed_glm.launch_partials(*args)
    got = packed_glm.reduce_partials(*parts)
    torch.cuda.synchronize()
    assert packed_glm.reduce_launches == before + 1 and parts[2].shape[0] > 32
    want = fused_glm.reduce_partials_in_order(*parts)
    assert (got[2] is None) == (not with_rsum) == (want[2] is None)
    for a, b in zip(got, want):
        assert a is None or torch.equal(a, b)

    def call():
        return tuple(t for t in packed_glm.reduce_partials(*packed_glm.launch_partials(*args))
                     if t is not None)

    eager = call()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for t in out:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, eager))
