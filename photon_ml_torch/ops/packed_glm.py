"""Fused GLM value + gradient from a packed ``[n, 3]`` auxiliary block.

Counterpart of the operand forms that ``photon_ml_tpu/ops/pallas_glm.py``
grew out of: ``experiments/kernel_probe6.py`` (labels | offsets | weights
packed into one ``[n, 3]`` block), ``experiments/kernel_probe7.py`` (the
same, each product on the matrix or the vector unit) and
``experiments/kernel_probe5.py`` (separate columns, optional offsets and
optional Σr); and the three earlier probes ``experiments/kernel_probe.py``,
``kernel_probe2.py`` and ``kernel_probe3.py``, which are the separate form
with neither offsets nor Σr (logistic loss, each product on either unit).
The kernel is hand-written CUDA for Hopper, ``csrc/packed_glm.cu``; its
header states the bound and the design.

In a GAME fixed-effect solve the three columns are constant through one
``update_model`` (the residual offsets change once per sweep, not per
evaluation), so the coordinate packs them once (:func:`pack_aux`) and every
evaluation streams X and the one aux block.

Units, for the margin product and the gradient product independently:

- ``"fma"``: f32 arithmetic on the widened tile.
- ``"mma"``: tensor-core ``mma.sync`` with f32 accumulation. For a bf16 tile
  the coefficients and the residuals are rounded to bf16 first (the probe's
  ``mxu`` mode); for an f32 tile the kernel rounds the operands to TF32,
  which the plain version does not repeat (it keeps f32, as the probe does
  in interpret mode), so the f32 ``mma`` kernel is held to a wider limit.
- ``"mma_tf32"``: tensor-core ``mma.sync`` in TF32 on the tile widened to
  f32 (exact for bf16), w and r rounded to TF32 — the function of a bf16
  product that promotes an f32 operand or casts the tile up (probe 1's
  ``mxu`` margins, probe 3's ``mxu_cast``). On an f32 tile it is ``"mma"``.
  Its plain version is f32 on the widened tile, held to the f32 ``mma``
  limit. It is built for the logistic loss only (the probes' loss), and the
  wrappers refuse it for any other.

On a CPU tensor the wrappers run the plain PyTorch versions; on a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from photon_ml_torch.build import check_cuda as _check
from photon_ml_torch.build import on_device as _on
from photon_ml_torch.ops.losses import PointwiseLoss

#: launches of the partials kernel in the packed form (one per evaluation)
packed_launches = 0
#: of those, launches with a product on the tensor cores
mma_launches = 0
#: launches of the partials kernel in the separate-column form
columns_launches = 0
#: launches of the ordered reduction kernel (one per evaluation)
reduce_launches = 0

UNITS = ("fma", "mma", "mma_tf32")

#: rows per staged tile -> kernel source under csrc/ (the 16-row build is
#: the one the training path uses; the 32-row build exists for comparison)
SOURCES = {16: "packed_glm", 32: "packed_glm_r32"}

_LIBS: dict[int, ctypes.CDLL] = {}
_GRID: dict[tuple, int] = {}
_VP = ctypes.c_void_p


def _lib(rows_per_tile: int = 16) -> ctypes.CDLL:
    lib = _LIBS.get(rows_per_tile)
    if lib is None:
        from photon_ml_torch import build

        _require(rows_per_tile in SOURCES, f"rows_per_tile must be one of {sorted(SOURCES)}")
        lib = build.load(SOURCES[rows_per_tile])
        lib.packed_glm_max_staged_d.argtypes = [ctypes.c_int]
        lib.packed_glm_max_staged_d.restype = ctypes.c_int
        lib.packed_glm_grid_blocks.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.packed_glm_grid_blocks.restype = ctypes.c_int
        lib.packed_glm_partials.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _VP, _VP, _VP, _VP, _VP, _VP, _VP,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _VP, _VP, _VP, _VP]
        lib.packed_glm_partials.restype = ctypes.c_int
        lib.packed_glm_reduce.argtypes = [
            _VP, _VP, _VP, ctypes.c_int, ctypes.c_int, _VP, _VP, _VP, _VP]
        lib.packed_glm_reduce.restype = ctypes.c_int
        _LIBS[rows_per_tile] = lib
    return lib


#: csrc/packed_glm.cu: the gradient's registers hold kMaxD columns, and two
#: staged tiles of rows padded to round_up(d, 16) + 8 elements must fit in
#: kStageBytesMax bytes
MAX_D = 1536
STAGE_BYTES_MAX = 200 * 1024


def max_staged_d(itemsize: int, rows_per_tile: int = 16) -> int:
    """Widest block the kernel stages in one pass: ``MAX_D``, or less where
    two padded tiles of ``rows_per_tile`` rows would not fit in
    ``STAGE_BYTES_MAX`` (f32 at 32 rows a tile)."""
    by_smem = (STAGE_BYTES_MAX // (2 * rows_per_tile * itemsize) - 8) // 16 * 16
    return min(MAX_D, by_smem)


def supports(x: torch.Tensor) -> bool:
    """Whether the kernel takes this feature block (dtype and width)."""
    return (x.dim() == 2 and x.dtype in (torch.float32, torch.bfloat16)
            and 1 <= x.shape[1] <= max_staged_d(x.element_size()))


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"packed_glm kernel: {msg}")


def _unit_id(unit: str) -> int:
    _require(unit in UNITS, f"unit must be one of {UNITS}, got {unit!r}")
    return UNITS.index(unit)


def check_units(loss, margin_unit: str, grad_unit: str) -> None:
    """Refuse a unit the kernel is not built for: ``mma_tf32`` exists for the
    logistic loss only."""
    _unit_id(margin_unit), _unit_id(grad_unit)
    _require(loss.kernel_id == 0 or "mma_tf32" not in (margin_unit, grad_unit),
             f"unit 'mma_tf32' is built for the logistic loss only, not {type(loss).__name__}")


def pack_aux(labels: torch.Tensor, offsets: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The ``[n, 3]`` f32 block, row i = (y_i, o_i, ws_i); f32 whatever X is."""
    return torch.stack([labels.float(), offsets.float(), weights.float()], dim=1).contiguous()


def _column(t, n: int, name: str, device) -> None:
    _require(t.device == device and t.dtype == torch.float32 and t.is_contiguous()
             and t.shape == (n,),
             f"{name} must be a contiguous float32 [{n}] tensor on {device}")


def launch_partials(loss, x, aux, labels, offsets, weights, eff, shift, with_rsum, margin_unit,
                    grad_unit, rows_per_tile=16):
    """Launch the partials kernel: per-block (value [blocks], Σr [blocks] or
    None, grad [blocks, d]). ``aux`` selects the packed form; with ``aux``
    None the separate labels/weights (and offsets, or None) are read."""
    global packed_launches, mma_launches, columns_launches
    _require(x.is_cuda, "x must be a CUDA tensor")
    _require(x.dim() == 2 and x.dtype in (torch.float32, torch.bfloat16),
             "x must be a 2-D float32 or bfloat16 tensor")
    _require(x.is_contiguous() and x.data_ptr() % 16 == 0,
             "x must be contiguous and 16-byte aligned")
    n, d = x.shape
    widest = max_staged_d(x.element_size(), rows_per_tile)
    _require(1 <= d <= widest, f"d={d} is wider than one staged pass ({widest})")
    _require(loss.kernel_id >= 0, f"{type(loss).__name__} has no kernel")
    check_units(loss, margin_unit, grad_unit)
    munit, gunit = _unit_id(margin_unit), _unit_id(grad_unit)
    dev = x.device
    if aux is not None:
        _require(aux.device == dev and aux.dtype == torch.float32 and aux.is_contiguous()
                 and aux.shape == (n, 3),
                 f"aux must be a contiguous float32 [{n}, 3] tensor on {dev}")
    else:
        _column(labels, n, "labels", dev)
        _column(weights, n, "weights", dev)
        if offsets is not None:
            _column(offsets, n, "offsets", dev)
    _column(eff, d, "eff", dev)
    if shift is not None:
        _require(shift.device == dev and shift.dtype == torch.float32 and shift.numel() == 1,
                 "shift must be a one-element float32 tensor on the device")
    lib = _lib(rows_per_tile)
    is_bf16 = int(x.dtype == torch.bfloat16)
    with _on(dev):
        key = (rows_per_tile, loss.kernel_id, is_bf16, munit, gunit, n, d, dev.index)
        blocks = _GRID.get(key)
        if blocks is None:
            out = ctypes.c_int(0)
            _check(lib.packed_glm_grid_blocks(loss.kernel_id, is_bf16, munit, gunit, n, d,
                                              ctypes.byref(out)), "packed_glm_grid_blocks")
            blocks = _GRID[key] = out.value
        part_value = torch.empty((blocks,), dtype=torch.float32, device=dev)
        part_rsum = torch.empty((blocks,), dtype=torch.float32, device=dev) if with_rsum else None
        part_grad = torch.empty((blocks, d), dtype=torch.float32, device=dev)
        _check(lib.packed_glm_partials(
            loss.kernel_id, is_bf16, munit, gunit, x.data_ptr(), _ptr(aux), _ptr(labels),
            _ptr(offsets), _ptr(weights), eff.data_ptr(), _ptr(shift), n, d, blocks,
            part_value.data_ptr(), _ptr(part_rsum), part_grad.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "packed_glm_partials")
        if aux is not None:
            packed_launches += 1
            mma_launches += int(munit > 0 or gunit > 0)
        else:
            columns_launches += 1
    return part_value, part_rsum, part_grad


def reduce_partials(part_value, part_rsum, part_grad):
    """Launch the ordered reduction of the partials: (value, grad [d], Σr or
    None when ``part_rsum`` is None), summed in the order of
    ``fused_glm.reduce_partials_in_order`` (one kernel for both,
    ``csrc/glm_tile.cuh``)."""
    global reduce_launches
    _require(part_grad.is_cuda and part_grad.dim() == 2 and part_grad.dtype == torch.float32
             and part_grad.is_contiguous(), "part_grad must be a contiguous 2-D float32 CUDA tensor")
    blocks, d = part_grad.shape
    dev = part_grad.device
    _column(part_value, blocks, "part_value", dev)
    if part_rsum is not None:
        _column(part_rsum, blocks, "part_rsum", dev)
    with _on(dev):
        value = torch.empty((1,), dtype=torch.float32, device=dev)
        rsum = None if part_rsum is None else torch.empty((1,), dtype=torch.float32, device=dev)
        grad = torch.empty((d,), dtype=torch.float32, device=dev)
        _check(_lib().packed_glm_reduce(
            part_value.data_ptr(), _ptr(part_rsum), part_grad.data_ptr(), blocks, d,
            value.data_ptr(), _ptr(rsum), grad.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "packed_glm_reduce")
        reduce_launches += 1
    return value[0], grad, None if rsum is None else rsum[0]


def reduce_partials_reference(part_value, part_rsum, part_grad):
    """Plain PyTorch version of :func:`reduce_partials`."""
    return (part_value.sum(), part_grad.sum(dim=0),
            None if part_rsum is None else part_rsum.sum())


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(*args, **kw):
    """Both kernels of one evaluation: (value, grad [d], Σr or None)."""
    return reduce_partials(*launch_partials(*args, **kw))


def _plain(loss, x, labels, offsets, weights, eff, shift, with_rsum, margin_unit, grad_unit):
    """(value, X'r, Σr or None) in plain PyTorch with the kernel's f32
    arithmetic; in ``mma`` mode on a bf16 block w and r round to bf16
    (``mma_tf32`` keeps them f32, as ``fma`` does)."""
    check_units(loss, margin_unit, grad_unit)
    x32 = x.float()
    bf16 = x.dtype == torch.bfloat16
    w = eff.to(torch.bfloat16).float() if bf16 and margin_unit == "mma" else eff
    margins = x32 @ w
    if offsets is not None:
        margins = margins + offsets
    if shift is not None:
        margins = margins - shift
    l, dz = loss.loss_and_dz(margins, labels)
    r = weights * dz
    rg = r.to(torch.bfloat16).float() if bf16 and grad_unit == "mma" else r
    return torch.sum(weights * l), rg @ x32, (torch.sum(r) if with_rsum else None)


def packed_core_reference(loss, x, aux, eff, shift=None, *, with_rsum=True, margin_unit="fma",
                          grad_unit="fma"):
    """Plain PyTorch version of :func:`packed_core` on any device."""
    return _plain(loss, x, aux[:, 0], aux[:, 1], aux[:, 2], eff, shift, with_rsum, margin_unit,
                  grad_unit)


def packed_core(loss: PointwiseLoss, x, aux, eff, shift=None, *, with_rsum=True,
                margin_unit="fma", grad_unit="fma", rows_per_tile=16):
    """(value Σ ws·l, X'r [d], Σr or None) from X and the packed aux block:
    the CUDA kernel for a CUDA block, the plain version for a CPU block.
    ``shift`` is None or a one-element f32 tensor taken off every offset;
    ``rows_per_tile`` picks the kernel build (the arithmetic is the same)."""
    if x.device.type == "cpu":
        return packed_core_reference(loss, x, aux, eff, shift, with_rsum=with_rsum,
                                     margin_unit=margin_unit, grad_unit=grad_unit)
    return _launch(loss, x, aux, None, None, None, eff,
                   None if shift is None else shift.reshape(1), with_rsum, margin_unit,
                   grad_unit, rows_per_tile)


def columns_core_reference(loss, x, labels, weights, offsets, eff, shift=None, *,
                           with_rsum=True, margin_unit="fma", grad_unit="fma"):
    """Plain PyTorch version of :func:`columns_core` on any device."""
    return _plain(loss, x, labels, offsets, weights, eff, shift, with_rsum, margin_unit,
                  grad_unit)


def columns_core(loss: PointwiseLoss, x, labels, weights, offsets, eff, shift=None, *,
                 with_rsum=True, margin_unit="fma", grad_unit="fma"):
    """The separate-column form: ``offsets`` may be None (not read), and Σr
    is neither accumulated nor written when ``with_rsum`` is False."""
    if x.device.type == "cpu":
        return columns_core_reference(loss, x, labels, weights, offsets, eff, shift,
                                      with_rsum=with_rsum, margin_unit=margin_unit,
                                      grad_unit=grad_unit)
    return _launch(loss, x, None, labels, offsets, weights, eff,
                   None if shift is None else shift.reshape(1), with_rsum, margin_unit,
                   grad_unit)


def _evaluate(core, coefficients, l2_weight, normalization):
    """The normalization algebra of ``ops/fused_glm.py`` around a core that
    maps (eff, shift, with_rsum) to (value, X'r, Σr): Σr is asked for exactly
    when the context has shifts."""
    factors = shifts = None
    if normalization is not None:
        factors, shifts = normalization.factors, normalization.shifts
    eff = coefficients.float()
    if factors is not None:
        eff = eff * factors.float()
    shift = None if shifts is None else torch.dot(eff, shifts.float())
    value, grad, rsum = core(eff, shift, shifts is not None)
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


def _features(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype in (torch.float32, torch.bfloat16) else x.float()


def packed_value_and_gradient(loss: PointwiseLoss, coefficients: torch.Tensor, x: torch.Tensor,
                              aux: torch.Tensor, *, l2_weight: float = 0.0, normalization=None,
                              margin_unit: str = "fma", grad_unit: str = "fma",
                              reference: bool = False):
    """(value, gradient) of the weighted GLM objective over X and the packed
    aux block, in the coefficients' dtype. ``reference=True`` takes the plain
    version on any device."""
    x = _features(x)
    fn = packed_core_reference if reference else packed_core

    def core(eff, shift, with_rsum):
        return fn(loss, x, aux, eff, shift, with_rsum=with_rsum, margin_unit=margin_unit,
                  grad_unit=grad_unit)

    return _evaluate(core, coefficients, l2_weight, normalization)


def columns_value_and_gradient(loss: PointwiseLoss, coefficients: torch.Tensor, x: torch.Tensor,
                               labels, weights, offsets=None, *, l2_weight: float = 0.0,
                               normalization=None, margin_unit: str = "fma",
                               grad_unit: str = "fma", reference: bool = False):
    """:func:`packed_value_and_gradient` over separate f32 columns."""
    x = _features(x)
    fn = columns_core_reference if reference else columns_core

    def core(eff, shift, with_rsum):
        return fn(loss, x, labels, weights, offsets, eff, shift, with_rsum=with_rsum,
                  margin_unit=margin_unit, grad_unit=grad_unit)

    return _evaluate(core, coefficients, l2_weight, normalization)
