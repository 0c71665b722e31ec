"""Fused GLM value + gradient: one pass over X per evaluation.

Counterpart of ``photon_ml_tpu/ops/pallas_glm.py`` (``fused_value_and_gradient``
over the Pallas kernel ``_kernel``/``_fused_padded``). The kernel is
hand-written CUDA for Hopper, ``csrc/fused_glm.cu``; its header states the
bound and the design. Per evaluation on a CUDA tensor the wrapper launches
two kernels: the per-block partials and their ordered reduction
(``csrc/glm_tile.cuh``, shared with the packed kernel;
:func:`reduce_partials_in_order` is its order in plain PyTorch). The
partials kernel stages row tiles of X in a ring in shared memory under a
tile plan that it chooses from the width and the type (rows a tile, stages,
row phases of the gradient; :func:`tile_plan` reads it); blocks wider than
8192 take its two-pass form.

The normalization algebra is that of the JAX wrapper
(ValueAndGradientAggregator.scala:36-49): the kernel reads X with the
effective coefficients ``eff = factors*w`` and the margin shift
``eff . shifts`` taken off every offset; the chain rule back to ``w`` uses
the kernel's Σr output, ``grad = factors * (X'r - Σr*shifts)``; L2 is added
outside the kernel. A feature block that is neither f32 nor bf16 is cast to
f32. Value and gradient come back in the coefficients' dtype.

On a CPU tensor the wrapper runs the plain PyTorch version
(``fused_value_and_gradient_reference``); on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from photon_ml_torch.build import check_cuda as _check
from photon_ml_torch.build import on_device as _on
from photon_ml_torch.data.batch import LabeledPointBatch
from photon_ml_torch.ops.losses import PointwiseLoss

#: launches of the partials kernel (one per evaluation on the card)
launches = 0
#: launches of the ordered reduction kernel (one per evaluation on the card)
reduce_launches = 0

_LIB = None
_GRID: dict[tuple, int] = {}
_VP = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from photon_ml_torch import build

        lib = build.load("fused_glm")
        lib.fused_glm_grid_blocks.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.fused_glm_grid_blocks.restype = ctypes.c_int
        lib.fused_glm_partials.argtypes = [
            ctypes.c_int, ctypes.c_int, _VP, _VP, _VP, _VP, _VP, _VP,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _VP, _VP, _VP, _VP]
        lib.fused_glm_partials.restype = ctypes.c_int
        lib.fused_glm_reduce.argtypes = [
            _VP, _VP, _VP, ctypes.c_int, ctypes.c_int, _VP, _VP, _VP, _VP]
        lib.fused_glm_reduce.restype = ctypes.c_int
        _LIB = lib
    return _LIB


class TilePlan(NamedTuple):
    """How the partials kernel walks X (chosen in ``csrc/fused_glm.cu`` from
    the width and the type): ``rows`` a staged tile (0: the two-pass form),
    ``stages`` in the ring, the gradient's row ``phases``, the 16-byte column
    ``vectors`` a thread owns, and the ``smem_bytes`` it asks for."""

    rows: int
    stages: int
    phases: int
    vectors: int
    smem_bytes: int


def tile_plan(d: int, dtype: torch.dtype) -> TilePlan:
    """The kernel's tile plan for a block ``d`` wide of ``dtype`` (f32 or
    bf16) features, for logs and tests. Builds the kernel."""
    lib = _lib()
    lib.fused_glm_tile_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 5)()
    _check(lib.fused_glm_tile_plan(int(dtype == torch.bfloat16), d, out), "fused_glm_tile_plan")
    return TilePlan(*out)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_glm kernel: {msg}")


def _vector(t: torch.Tensor, n: int, name: str, device) -> None:
    _require(t.device == device and t.dtype == torch.float32 and t.is_contiguous()
             and t.shape == (n,),
             f"{name} must be a contiguous float32 [{n}] tensor on {device}")


def fused_partials(loss: PointwiseLoss, x, labels, offsets, weights, eff, shift=None):
    """Launch the partials kernel: per-block (value, Σr, grad[d]) tensors of
    shapes [blocks], [blocks], [blocks, d]. ``shift`` is None or a one-element
    float32 tensor on the device."""
    global launches
    _require(x.is_cuda, "x must be a CUDA tensor")
    _require(x.dim() == 2 and x.dtype in (torch.float32, torch.bfloat16),
             "x must be a 2-D float32 or bfloat16 tensor")
    _require(x.is_contiguous() and x.data_ptr() % 16 == 0,
             "x must be contiguous and 16-byte aligned")
    n, d = x.shape
    _require(1 <= d < 2**31, f"d={d} out of range")
    _require(loss.kernel_id >= 0, f"{type(loss).__name__} has no kernel")
    dev = x.device
    for t, name in ((labels, "labels"), (offsets, "offsets"), (weights, "weights")):
        _vector(t, n, name, dev)
    _vector(eff, d, "eff", dev)
    if shift is not None:
        _require(shift.device == dev and shift.dtype == torch.float32 and shift.numel() == 1,
                 "shift must be a one-element float32 tensor on the device")
    lib = _lib()
    is_bf16 = int(x.dtype == torch.bfloat16)
    with _on(dev):
        key = (loss.kernel_id, is_bf16, n, d, dev.index)
        blocks = _GRID.get(key)
        if blocks is None:
            out = ctypes.c_int(0)
            _check(lib.fused_glm_grid_blocks(loss.kernel_id, is_bf16, n, d,
                                             ctypes.byref(out)), "fused_glm_grid_blocks")
            blocks = _GRID[key] = out.value
        part_value = torch.empty((blocks,), dtype=torch.float32, device=dev)
        part_rsum = torch.empty((blocks,), dtype=torch.float32, device=dev)
        part_grad = torch.empty((blocks, d), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib.fused_glm_partials(
            loss.kernel_id, is_bf16, x.data_ptr(), labels.data_ptr(),
            offsets.data_ptr(), weights.data_ptr(), eff.data_ptr(),
            None if shift is None else shift.data_ptr(), n, d, blocks,
            part_value.data_ptr(), part_rsum.data_ptr(), part_grad.data_ptr(),
            stream), "fused_glm_partials")
        launches += 1
    return part_value, part_rsum, part_grad


def reduce_partials(part_value, part_rsum, part_grad):
    """Launch the ordered reduction of the partials: (value, grad[d], Σr),
    summed in the order of :func:`reduce_partials_in_order`."""
    global reduce_launches
    _require(part_grad.is_cuda and part_grad.dim() == 2, "part_grad must be a 2-D CUDA tensor")
    blocks, d = part_grad.shape
    dev = part_grad.device
    _require(part_grad.dtype == torch.float32 and part_grad.is_contiguous(),
             "part_grad must be contiguous float32")
    _vector(part_value, blocks, "part_value", dev)
    _vector(part_rsum, blocks, "part_rsum", dev)
    lib = _lib()
    with _on(dev):
        value = torch.empty((1,), dtype=torch.float32, device=dev)
        rsum = torch.empty((1,), dtype=torch.float32, device=dev)
        grad = torch.empty((d,), dtype=torch.float32, device=dev)
        _check(lib.fused_glm_reduce(
            part_value.data_ptr(), part_rsum.data_ptr(), part_grad.data_ptr(),
            blocks, d, value.data_ptr(), rsum.data_ptr(), grad.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "fused_glm_reduce")
        reduce_launches += 1
    return value[0], grad, rsum[0]


def reduce_partials_reference(part_value, part_rsum, part_grad):
    """Plain PyTorch version of :func:`reduce_partials` (sums in PyTorch's
    own order)."""
    return part_value.sum(), part_grad.sum(dim=0), part_rsum.sum()


def reduce_partials_in_order(part_value, part_rsum, part_grad):
    """The kernel's reduction of its partials (``reduce_partials_kernel`` in
    ``csrc/glm_tile.cuh``), in plain PyTorch with each f32 addition made
    elementwise in the kernel's order, so on the same partials it is
    bitwise the kernel's: (value, grad [d], Σr, or None with ``part_rsum``
    None). Column c of the gradient is the sum of its 32 strided sums S_k
    (blocks k, k + 32, ... added from 0), added from 0 in k order; value and
    Σr are 32 lane sums (blocks l, l + 32, ...) added by a xor butterfly."""
    blocks, d = part_grad.shape
    pad = -blocks % 32
    strided = torch.zeros((32, d), dtype=torch.float32, device=part_grad.device)
    rows = torch.cat([part_grad, part_grad.new_zeros((pad, d))]).reshape(-1, 32, d)
    for j in range(rows.shape[0]):  # S_k += row 32 j + k (adding a zero pad row is exact)
        strided = strided + rows[j]
    grad = torch.zeros((d,), dtype=torch.float32, device=part_grad.device)
    for k in range(32):
        grad = grad + strided[k]

    def lanes(v):
        acc = torch.zeros((32,), dtype=torch.float32, device=v.device)
        for row in torch.cat([v, v.new_zeros(pad)]).reshape(-1, 32):
            acc = acc + row
        lane = torch.arange(32, device=v.device)
        for off in (16, 8, 4, 2, 1):
            acc = acc + acc[lane ^ off]
        return acc[0]

    return lanes(part_value), grad, None if part_rsum is None else lanes(part_rsum)


def _plain_core(loss, x, labels, offsets, weights, eff, shift):
    """(value, X'r, Σr) in plain PyTorch, f32 arithmetic like the kernel."""
    x32 = x.float()
    o = offsets if shift is None else offsets - shift
    margins = x32 @ eff + o
    l, dz = loss.loss_and_dz(margins, labels)
    r = weights * dz
    return torch.sum(weights * l), r @ x32, torch.sum(r)


def _kernel_core(loss, x, labels, offsets, weights, eff, shift):
    return reduce_partials(*fused_partials(
        loss, x, labels, offsets, weights, eff,
        None if shift is None else shift.reshape(1)))


def _evaluate(core, loss, coefficients, batch, l2_weight, normalization):
    x = batch.features
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    factors = shifts = None
    if normalization is not None:
        factors, shifts = normalization.factors, normalization.shifts
    eff = coefficients.float()
    if factors is not None:
        eff = eff * factors.float()
    shift = None if shifts is None else torch.dot(eff, shifts.float())
    value, grad, rsum = core(loss, x, batch.labels.float(), batch.offsets.float(),
                             batch.weights.float(), eff, shift)
    if shifts is not None:
        grad = grad - rsum * shifts.float()
    if factors is not None:
        grad = grad * factors.float()
    grad = grad.to(coefficients.dtype)
    value = value.to(coefficients.dtype)
    if l2_weight > 0.0:
        value = value + 0.5 * l2_weight * torch.dot(coefficients, coefficients)
        grad = grad + l2_weight * coefficients
    return value, grad


def fused_value_and_gradient(
    loss: PointwiseLoss,
    coefficients: torch.Tensor,
    batch: LabeledPointBatch,
    *,
    l2_weight: float = 0.0,
    normalization=None,
):
    """(value, gradient) of the weighted GLM objective in one pass over X:
    the CUDA kernel for a CUDA batch, the plain version for a CPU batch."""
    core = _plain_core if batch.features.device.type == "cpu" else _kernel_core
    return _evaluate(core, loss, coefficients, batch, l2_weight, normalization)


def fused_value_and_gradient_reference(
    loss: PointwiseLoss,
    coefficients: torch.Tensor,
    batch: LabeledPointBatch,
    *,
    l2_weight: float = 0.0,
    normalization=None,
):
    """Plain PyTorch version of :func:`fused_value_and_gradient` on any
    device: the same algebra and the same f32/bf16 inputs."""
    return _evaluate(_plain_core, loss, coefficients, batch, l2_weight, normalization)
