"""GLM objective: value / gradient / Hessian-vector / Hessian matrix.

Counterpart of ``photon_ml_tpu/ops/objective.py``; reference photon-lib
function/glm/ValueAndGradientAggregator.scala, HessianVectorAggregator.scala,
HessianMatrixAggregator.scala, function/ObjectiveFunction.scala:25-73 and
L2Regularization.scala:26-72.

Where the JAX package differentiates a scalar function with ``jax.grad`` and
``jax.jvp``, the port writes the derivatives in closed form: with
``r = ws * dl/dz`` the gradient is ``X'r``, and the Hessian-vector product
is ``X'(ws * d2l/dz2 * Xv)``, both under the normalization algebra
(ValueAndGradientAggregator.scala:36-49).

``value_and_gradient`` dispatches like ``objective.py:152-173`` of the JAX
package, with ``use_kernel`` in place of ``use_pallas``:

- ``None`` (auto): a CUDA batch goes to the fused kernel
  (``ops/fused_glm.py``); a CPU batch takes the closed form in the batch's
  own dtype, as the JAX auto mode does off the TPU.
- ``True``: the fused kernel on a CUDA batch, its plain f32/bf16 version on
  a CPU batch.
- ``False``: the closed form with ``torch.matmul``.

One objective keeps one evaluation path for a whole solve: the kernel and
the closed form differ by about 5e-6 relative in f32, enough to flip
accept tests near an optimum.

``bind_packed`` is the binding of a solve whose labels, offsets and weights
stay fixed while the coefficients move (a GAME fixed-effect update): the
three columns are packed once into the ``[n, 3]`` block of
``ops/packed_glm.py`` and every kernel evaluation streams X and that block.
``kernel_unit`` (one of ``packed_glm.UNITS``) picks the unit of both products there, and
``kernel_aux="columns"`` keeps the three columns separate (the same kernel
source reading them one by one). The Hessian-vector product and the
variances keep the closed forms.
"""

from __future__ import annotations

import torch

from photon_ml_torch.data.batch import LabeledPointBatch
from photon_ml_torch.ops import packed_glm
from photon_ml_torch.ops.fused_glm import fused_value_and_gradient
from photon_ml_torch.ops.losses import PointwiseLoss
from photon_ml_torch.ops.normalization import NormalizationContext, no_normalization


def _matvec(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """X @ v. A bf16 block multiplies bf16-rounded v with f32 accumulation
    (the JAX path's matmul with preferred_element_type)."""
    if x.dtype == torch.bfloat16 and v.dtype != torch.bfloat16:
        return x.to(v.dtype) @ v.to(torch.bfloat16).to(v.dtype)
    return x @ v


def _rmatvec(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """X' r in r's dtype."""
    return r @ (x.to(r.dtype) if x.dtype != r.dtype else x)


def chain_rule(norm: NormalizationContext, g_eff: torch.Tensor,
               rsum: torch.Tensor) -> torch.Tensor:
    """Gradient in w from X'r in effective coordinates and Σr:
    ``factors ⊙ (X'r − Σr·shifts)``."""
    if norm.shifts is not None:
        g_eff = g_eff - rsum * norm.shifts
    if norm.factors is not None:
        g_eff = g_eff * norm.factors
    return g_eff


class GLMObjective:
    """Weighted GLM objective: sum_i w_i * l(margin_i, y_i) + (l2/2)‖w‖².

    The L1 term of elastic net is not part of this smooth objective: OWL-QN
    handles it through its pseudo-gradient (reference OWLQN.scala:40-86).
    """

    def __init__(
        self,
        loss: PointwiseLoss,
        l2_weight: float = 0.0,
        normalization: NormalizationContext | None = None,
        use_kernel: bool | None = None,
        kernel_unit: str = "fma",
        kernel_aux: str = "packed",
    ):
        if kernel_unit not in packed_glm.UNITS:
            raise ValueError(f"kernel_unit must be one of {packed_glm.UNITS}, got {kernel_unit!r}")
        packed_glm.check_units(loss, kernel_unit, kernel_unit)
        if kernel_aux not in ("packed", "columns"):
            raise ValueError(f"kernel_aux must be 'packed' or 'columns', got {kernel_aux!r}")
        self.loss = loss
        self.l2_weight = float(l2_weight)
        self.normalization = normalization if normalization is not None else no_normalization()
        self.use_kernel = use_kernel
        self.kernel_unit = kernel_unit
        self.kernel_aux = kernel_aux

    # Value-based identity (the JAX package's): a program label's signature
    # describes a static objective by its hash, so an objective rebuilt each
    # sweep with the same settings is the same program. Normalization
    # contexts hold tensors, so they compare by object identity;
    # coordinates build theirs once.
    def _key(self):
        return (type(self.loss), self.l2_weight, id(self.normalization), self.use_kernel,
                self.kernel_unit, self.kernel_aux)

    def __eq__(self, other):
        return isinstance(other, GLMObjective) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    # -- core scalar function ------------------------------------------------

    def margins(self, coefficients: torch.Tensor, batch: LabeledPointBatch) -> torch.Tensor:
        eff = self.normalization.effective_coefficients(coefficients)
        shift = self.normalization.margin_shift(eff)
        return _matvec(batch.features, eff) - shift + batch.offsets

    def _data_value(self, coefficients, batch) -> torch.Tensor:
        losses = self.loss.loss(self.margins(coefficients, batch), batch.labels)
        return torch.sum(batch.weights * losses)

    def value(self, coefficients: torch.Tensor, batch: LabeledPointBatch) -> torch.Tensor:
        total = self._data_value(coefficients, batch)
        if self.l2_weight > 0.0:
            total = total + 0.5 * self.l2_weight * torch.dot(coefficients, coefficients)
        return total

    # -- derivatives ---------------------------------------------------------

    def _kernel_enabled(self, batch: LabeledPointBatch) -> bool:
        if self.use_kernel is None:
            return batch.features.device.type == "cuda"
        return self.use_kernel

    def value_and_gradient(self, coefficients: torch.Tensor, batch: LabeledPointBatch):
        if self._kernel_enabled(batch):
            return fused_value_and_gradient(
                self.loss, coefficients, batch,
                l2_weight=self.l2_weight, normalization=self.normalization,
            )
        margins = self.margins(coefficients, batch)
        l, dz = self.loss.loss_and_dz(margins, batch.labels)
        r = batch.weights * dz
        value = torch.sum(batch.weights * l)
        grad = chain_rule(self.normalization, _rmatvec(batch.features, r), torch.sum(r))
        if self.l2_weight > 0.0:
            value = value + 0.5 * self.l2_weight * torch.dot(coefficients, coefficients)
            grad = grad + self.l2_weight * coefficients
        return value, grad

    def gradient(self, coefficients, batch) -> torch.Tensor:
        return self.value_and_gradient(coefficients, batch)[1]

    def hessian_vector(self, coefficients: torch.Tensor, vector: torch.Tensor,
                       batch: LabeledPointBatch) -> torch.Tensor:
        """H @ v in closed form: X'(ws * d2 * X v) under the normalization
        algebra, plus l2 * v. TRON calls this once per CG step
        (reference TRON.scala:298-300)."""
        margins = self.margins(coefficients, batch)
        d2 = self.loss.d2z(margins, batch.labels) * batch.weights
        ev = self.normalization.effective_coefficients(vector)
        xv = _matvec(batch.features, ev) - self.normalization.margin_shift(ev)
        q = d2 * xv
        hv = chain_rule(self.normalization, _rmatvec(batch.features, q), torch.sum(q))
        if self.l2_weight > 0.0:
            hv = hv + self.l2_weight * vector
        return hv

    def _normalized_features(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """X' = (X - shifts) * factors, materialized (small d only)."""
        factors, shifts = self.normalization.factors, self.normalization.shifts
        x = x.to(dtype)
        if factors is not None:
            x = x * factors
        if shifts is not None:
            x = x - shifts * (factors if factors is not None else 1.0)
        return x

    def hessian_matrix(self, coefficients: torch.Tensor, batch: LabeledPointBatch) -> torch.Tensor:
        """Dense Hessian X'ᵀ D X' + l2·I, for variance estimation and
        diagnostics on small d (reference HessianMatrixAggregator)."""
        margins = self.margins(coefficients, batch)
        d2 = self.loss.d2z(margins, batch.labels) * batch.weights
        x = self._normalized_features(batch.features, margins.dtype)
        h = x.T @ (d2[:, None] * x)
        if self.l2_weight > 0.0:
            h = h + self.l2_weight * torch.eye(h.shape[0], dtype=h.dtype, device=h.device)
        return h

    def hessian_diagonal(self, coefficients: torch.Tensor, batch: LabeledPointBatch) -> torch.Tensor:
        """diag(H) without materializing H."""
        margins = self.margins(coefficients, batch)
        d2 = self.loss.d2z(margins, batch.labels) * batch.weights
        x = self._normalized_features(batch.features, margins.dtype)
        diag = torch.einsum("n,nd,nd->d", d2, x, x)
        if self.l2_weight > 0.0:
            diag = diag + self.l2_weight
        return diag

    def bind(self, batch: LabeledPointBatch) -> "BoundObjective":
        return BoundObjective(self, batch)

    def bind_packed(self, batch: LabeledPointBatch) -> "BoundObjective":
        """Bind for a solve over fixed labels/offsets/weights: with the
        kernel on and a block it takes, evaluations go through
        ``ops/packed_glm.py``; otherwise this is :meth:`bind`."""
        if self._kernel_enabled(batch) and packed_glm.supports(batch.features):
            return PackedBoundObjective(self, batch)
        return BoundObjective(self, batch)


class BoundObjective:
    """Objective closed over a fixed batch: functions of the coefficients,
    which is what the optimizers consume."""

    def __init__(self, objective: GLMObjective, batch: LabeledPointBatch):
        self.objective = objective
        self.batch = batch

    def value(self, w: torch.Tensor) -> torch.Tensor:
        return self.objective.value(w, self.batch)

    def value_and_grad(self, w: torch.Tensor):
        return self.objective.value_and_gradient(w, self.batch)

    def hessian_vector(self, w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return self.objective.hessian_vector(w, v, self.batch)

    def hessian_matrix(self, w: torch.Tensor) -> torch.Tensor:
        return self.objective.hessian_matrix(w, self.batch)


class PackedBoundObjective(BoundObjective):
    """A bound objective whose value+gradient streams X and the aux columns
    packed once at binding (``kernel_aux="packed"``) or kept as three f32
    columns (``"columns"``)."""

    def __init__(self, objective: GLMObjective, batch: LabeledPointBatch):
        super().__init__(objective, batch)
        self.aux = None
        if objective.kernel_aux == "packed":
            self.aux = packed_glm.pack_aux(batch.labels, batch.offsets, batch.weights)
        else:
            self.columns = (batch.labels.float().contiguous(),
                            batch.weights.float().contiguous(),
                            batch.offsets.float().contiguous())

    def value_and_grad(self, w: torch.Tensor):
        o = self.objective
        kw = dict(l2_weight=o.l2_weight, normalization=o.normalization,
                  margin_unit=o.kernel_unit, grad_unit=o.kernel_unit)
        if self.aux is not None:
            return packed_glm.packed_value_and_gradient(o.loss, w, self.batch.features,
                                                        self.aux, **kw)
        return packed_glm.columns_value_and_gradient(o.loss, w, self.batch.features,
                                                     *self.columns, **kw)
