"""The packed-aux GLM kernel's plain versions against the TPU kernels they
replace (``experiments/kernel_probe5.py``, ``kernel_probe6.py``,
``kernel_probe7.py``, run in Pallas interpret mode) and the packed wrapper
against ``photon_ml_tpu.ops.pallas_glm.fused_value_and_gradient`` in
interpret mode, on the CPU; and the wrapper's device rules.

f32 tiles: rtol 1e-5 (gradient atol 1e-5 of its largest entry). bf16 tiles
see the same rounded inputs on both sides: rtol 1e-4."""

import functools
import importlib.util
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jax_pallas

from photon_ml_tpu.ops import pallas_glm
from photon_ml_torch.ops import fused_glm, packed_glm
from photon_ml_torch.ops.objective import BoundObjective, GLMObjective, PackedBoundObjective
from tests.torch_parity import LOSSES, NORMS, batches, loss_pair, make_data, normalizations

REPO = Path(__file__).resolve().parents[1]
N, D, TILE = 1024, 128, 256


def _probe(name: str):
    """Load experiments/<name>.py with its ``pl.pallas_call`` in interpret
    mode, so the TPU kernel runs on the CPU; the file stays as it is."""
    spec = importlib.util.spec_from_file_location(f"_torch_parity_{name}",
                                                  REPO / "experiments" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    pl = types.SimpleNamespace(**vars(jax_pallas))
    pl.pallas_call = functools.partial(jax_pallas.pallas_call, interpret=True)
    module.pl = pl
    return module


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, D)).astype(np.float32)
    w_true = rng.normal(size=D).astype(np.float32) / np.sqrt(D)
    y = (rng.uniform(size=N) < 1 / (1 + np.exp(-(x @ w_true)))).astype(np.float32)
    o = rng.normal(scale=0.2, size=N).astype(np.float32)
    ws = rng.uniform(0.2, 2.0, size=N).astype(np.float32)
    ws[::7] = 0.0
    w = (0.3 * rng.normal(size=D) / np.sqrt(D / 16)).astype(np.float32)
    return x, y, o, ws, w


def _assert_close(got, ref, rtol):
    (gv, gg), (rv, rg) = got, ref
    rg = np.asarray(rg, dtype=np.float64)
    np.testing.assert_allclose(float(gv), float(rv), rtol=rtol)
    np.testing.assert_allclose(gg.double().numpy(), rg, rtol=rtol, atol=rtol * np.abs(rg).max())


def _tile(x, bf16):
    if bf16:
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("with_o", [True, False], ids=["o", "no-o"])
@pytest.mark.parametrize("with_rsum", [True, False], ids=["rsum", "no-rsum"])
def test_columns_plain_version_matches_probe5(data, with_o, with_rsum):
    x, y, o, ws, w = data
    probe = _probe("kernel_probe5")
    col = lambda v: jnp.asarray(v).reshape(-1, 1)  # noqa: E731
    ref = probe.local_fused(with_o, with_rsum, TILE, jnp.asarray(x), col(y),
                            col(o) if with_o else None, col(ws), jnp.asarray(w))
    t = torch.from_numpy
    loss = loss_pair("LogisticLoss")[1]
    value, grad, rsum = packed_glm.columns_core(loss, t(x), t(y), t(ws),
                                                t(o) if with_o else None, t(w),
                                                with_rsum=with_rsum)
    _assert_close((value, grad), ref, 1e-5)
    assert (rsum is not None) == with_rsum
    if with_rsum:
        m = x.astype(np.float64) @ w + (o if with_o else 0.0)
        np.testing.assert_allclose(float(rsum), float(np.sum(ws * (1 / (1 + np.exp(-m)) - y))),
                                   rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_rsum", [True, False], ids=["rsum", "no-rsum"])
def test_packed_plain_version_matches_probe6(data, with_rsum, bf16):
    x, y, o, ws, w = data
    probe = _probe("kernel_probe6")
    jx, tx = _tile(x, bf16)
    aux = np.stack([y, o, ws], axis=1)
    ref = probe.fused(with_rsum, TILE, jx, jnp.asarray(aux), jnp.asarray(w))
    t = torch.from_numpy
    taux = packed_glm.pack_aux(t(y), t(o), t(ws))
    assert np.array_equal(taux.numpy(), aux) and taux.is_contiguous()
    value, grad, rsum = packed_glm.packed_core(loss_pair("LogisticLoss")[1], tx, taux, t(w),
                                               with_rsum=with_rsum)
    _assert_close((value, grad), ref, 1e-4 if bf16 else 1e-5)
    assert (rsum is not None) == with_rsum


MODES = {"mxu": "mma", "mxu_cast": "fma", "vpu": "fma"}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("grad_mode", list(MODES))
@pytest.mark.parametrize("margin_mode", list(MODES))
def test_unit_plain_versions_match_probe7(data, margin_mode, grad_mode, bf16):
    """``mxu`` (operands rounded to the tile's type) is the port's "mma";
    ``mxu_cast`` and ``vpu`` (f32 arithmetic on the widened tile) its "fma"."""
    x, y, o, ws, w = data
    probe = _probe("kernel_probe7")
    jx, tx = _tile(x, bf16)
    aux = np.stack([y, o, ws], axis=1)
    ref = probe.fused(True, TILE, jx, jnp.asarray(aux), jnp.asarray(w), margin_mode, grad_mode)
    t = torch.from_numpy
    value, grad, _ = packed_glm.packed_core(
        loss_pair("LogisticLoss")[1], tx, t(aux), t(w), margin_unit=MODES[margin_mode],
        grad_unit=MODES[grad_mode])
    _assert_close((value, grad), ref, 1e-4 if bf16 else 1e-5)


def test_mma_rounding_changes_the_bf16_result_only(data):
    x, y, o, ws, w = data
    t = torch.from_numpy
    loss = loss_pair("LogisticLoss")[1]
    aux = packed_glm.pack_aux(t(y), t(o), t(ws))
    for tile, differs in ((t(x), False), (t(x).to(torch.bfloat16), True)):
        fma = packed_glm.packed_core(loss, tile, aux, t(w))
        mma = packed_glm.packed_core(loss, tile, aux, t(w), margin_unit="mma", grad_unit="mma")
        assert (not torch.equal(fma[1], mma[1])) == differs
    with pytest.raises(ValueError, match="unit must be one of"):
        packed_glm.packed_core(loss, t(x), aux, t(w), margin_unit="mxu")


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("loss_name,binary", LOSSES)
def test_packed_wrapper_matches_pallas_wrapper(loss_name, binary, norm, bf16):
    """The whole wrapper (normalization algebra, Σr exactly when there are
    shifts, L2) against the JAX package's, whose kernel packs the same
    ``[n, 3]`` block; ragged n and d."""
    x, y, o, ws = make_data(3, 300, 37, binary, dtype=np.float32)
    jloss, tloss = loss_pair(loss_name)
    jb, tb = batches(x, y, o, ws, bf16=bf16)
    jn, tn = normalizations(norm, x, intercept_index=36, dtype=np.float32)
    w = (np.random.default_rng(4).normal(size=37) * 0.1).astype(np.float32)
    ref = pallas_glm.fused_value_and_gradient(jloss, jnp.asarray(w), jb, l2_weight=0.3,
                                              normalization=jn, interpret=True)
    aux = packed_glm.pack_aux(tb.labels, tb.offsets, tb.weights)
    got = packed_glm.packed_value_and_gradient(tloss, torch.from_numpy(w), tb.features, aux,
                                               l2_weight=0.3, normalization=tn)
    _assert_close(got, ref, 2e-4 if bf16 else 2e-5)
    # the separate-column form and the repo's separate-column kernel agree with it
    cols = packed_glm.columns_value_and_gradient(
        tloss, torch.from_numpy(w), tb.features, tb.labels, tb.weights, tb.offsets,
        l2_weight=0.3, normalization=tn)
    b1 = fused_glm.fused_value_and_gradient(tloss, torch.from_numpy(w), tb, l2_weight=0.3,
                                            normalization=tn)
    for other in (cols, b1):
        np.testing.assert_allclose(float(other[0]), float(got[0]), rtol=1e-6)
        np.testing.assert_allclose(other[1].numpy(), got[1].numpy(), rtol=1e-5,
                                   atol=1e-5 * float(got[1].abs().max()))
    ref_plain = packed_glm.packed_value_and_gradient(
        tloss, torch.from_numpy(w), tb.features, aux, l2_weight=0.3, normalization=tn,
        reference=True)
    assert torch.equal(ref_plain[0], got[0]) and torch.equal(ref_plain[1], got[1])


def test_bind_packed_dispatch():
    x, y, o, ws = make_data(5, 200, 9, True, dtype=np.float32)
    _, tb = batches(x, y, o, ws)
    loss = loss_pair("LogisticLoss")[1]
    w = torch.zeros(9) + 0.1
    closed = GLMObjective(loss, l2_weight=0.5).bind_packed(tb)  # auto on the CPU: closed form
    assert type(closed) is BoundObjective
    for aux_form in ("packed", "columns"):
        bound = GLMObjective(loss, l2_weight=0.5, use_kernel=True,
                             kernel_aux=aux_form).bind_packed(tb)
        assert isinstance(bound, PackedBoundObjective)
        assert (bound.aux is not None) == (aux_form == "packed")
        v, g = bound.value_and_grad(w)
        vc, gc = closed.value_and_grad(w)
        np.testing.assert_allclose(float(v), float(vc), rtol=1e-6)
        np.testing.assert_allclose(g.numpy(), gc.numpy(), rtol=1e-5, atol=1e-5)
        assert torch.equal(bound.value(w), closed.value(w))
        assert torch.equal(bound.hessian_vector(w, w), closed.hessian_vector(w, w))
    f64 = GLMObjective(loss, use_kernel=True).bind_packed(
        batches(x.astype(np.float64), y, o, ws)[1])
    assert type(f64) is BoundObjective  # the kernel takes f32 and bf16 blocks only
    with pytest.raises(ValueError, match="kernel_unit"):
        GLMObjective(loss, kernel_unit="mxu")
    with pytest.raises(ValueError, match="kernel_aux"):
        GLMObjective(loss, kernel_aux="stacked")


def test_wrapper_limits_and_counters():
    assert packed_glm.max_staged_d(4) == 1536 and packed_glm.max_staged_d(2) == 1536
    assert packed_glm.max_staged_d(4, 32) == 784 and packed_glm.max_staged_d(2, 32) == 1536
    assert packed_glm.supports(torch.zeros((4, 1536)))
    assert not packed_glm.supports(torch.zeros((4, 1537)))
    assert packed_glm.supports(torch.zeros((4, 1536), dtype=torch.bfloat16))
    assert not packed_glm.supports(torch.zeros((4, 1537), dtype=torch.bfloat16))
    assert not packed_glm.supports(torch.zeros((4, 8), dtype=torch.float64))
    assert sorted(packed_glm.SOURCES) == [16, 32]
    for name in packed_glm.SOURCES.values():
        assert (REPO / "photon_ml_torch" / "csrc" / f"{name}.cu").exists()
    before = (packed_glm.packed_launches, packed_glm.mma_launches, packed_glm.columns_launches,
              packed_glm.reduce_launches)
    loss = loss_pair("SquaredLoss")[1]
    packed_glm.packed_core(loss, torch.zeros((3, 2)), torch.zeros((3, 3)), torch.zeros(2))
    assert before == (packed_glm.packed_launches, packed_glm.mma_launches,
                      packed_glm.columns_launches, packed_glm.reduce_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        packed_glm._launch(loss, torch.zeros((3, 2)), torch.zeros((3, 3)), None, None, None,
                           torch.zeros(2), None, True, "fma", "fma")


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", [16, 32])
def test_max_staged_d_is_the_widest_that_fits(itemsize, rows):
    """The widest block: at most the gradient registers' MAX_D columns, and
    two staged tiles of rows padded to round_up(d, 16) + 8 elements within
    STAGE_BYTES_MAX, where one column more would not be."""
    widest = packed_glm.max_staged_d(itemsize, rows)

    def two_tiles(d):
        return 2 * rows * ((d + 15) // 16 * 16 + 8) * itemsize

    assert widest <= packed_glm.MAX_D and two_tiles(widest) <= packed_glm.STAGE_BYTES_MAX
    assert widest == packed_glm.MAX_D or two_tiles(widest + 1) > packed_glm.STAGE_BYTES_MAX
    src = (REPO / "photon_ml_torch" / "csrc" / "packed_glm.cu").read_text()
    assert f"kStageBytesMax = {packed_glm.STAGE_BYTES_MAX // 1024} * 1024;" in src
    assert "kMaxChunks = 12;" in src and packed_glm.MAX_D == 8 * 12 * 16


def test_build_hashes_included_sources():
    from photon_ml_torch import build

    assert {"fused_glm", "packed_glm", "packed_glm_r32", "sparse_gather"} <= set(build.sources())
    whole = build._source_bytes(build.CSRC / "packed_glm_r32.cu")
    assert (build.CSRC / "packed_glm.cu").read_bytes() in whole
    assert build.library_path("packed_glm") != build.library_path("packed_glm_r32")
