"""GLM objective over sparse batches (giant feature spaces).

Counterpart of ``photon_ml_tpu/ops/sparse_objective.py``; reference
photon-lib function/ObjectiveFunction.scala and the sparse-aware
aggregators in function/glm/ValueAndGradientAggregator.scala:36-49,133-154
(effectiveCoefficients and marginShift keep sparse vectors sparse).

Every margin goes through the gather-sum of ``ops/sparse_gather.py``
(``data/sparse_batch.sparse_margins``). Where the JAX package differentiates
by autodiff, the port writes the closed form, as ``ops/objective.py`` does:
with ``r = ws · dl/dz`` and effective coefficients ``f ⊙ w``,

    ∂/∂w = f ⊙ (Xᵀr − (Σr)·shifts) + λw
    H v  = f ⊙ (Xᵀt − (Σt)·shifts) + λv
    t    = ws · d²l/dz² · (X(f⊙v) − (f⊙v)·shifts)

``Xᵀr`` (``data/sparse_batch.sparse_column_sum``) is the gather-sum again,
over a column-sorted copy of the ELL block and the flat tail, plus a scatter
of the hybrid head's k_hot columns; with the column-sorted view it is
sorted-run prefix sums. Either way a column sums in a fixed order, so on the
card a gradient, like the value, is bitwise the same from call to call.

``use_kernel`` has the meaning of ``ops/objective.py``: None (auto) and True
take the gather kernel on a CUDA batch and its plain version on a CPU one;
False takes the plain version everywhere.
"""

from __future__ import annotations

import torch

from photon_ml_torch.data.sparse_batch import (
    SparseLabeledPointBatch,
    feature_product,
    sparse_column_sum,
    tail_column_sums,
)
from photon_ml_torch.ops.losses import PointwiseLoss
from photon_ml_torch.ops.normalization import NormalizationContext, no_normalization
from photon_ml_torch.ops.objective import BoundObjective, chain_rule

#: chunk width of the sorted-run reduction: bounds the magnitude any prefix
#: difference can cancel against (f32 error ~ eps·|within-chunk prefix|)
_RUN_CHUNK = 4096


def _sorted_run_sums(contrib: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Sum each contiguous run of a column-sorted contribution vector
    (run j = ``contrib[bounds[j]:bounds[j+1]]``) by a two-level prefix sum
    over [C, _RUN_CHUNK] chunks and one gather per boundary:

        P(p) = chunk_prefix[p // B] + intra_chunk_cumsum[p]
        run_sum[j] = (intra(end) − intra(start)) + (prefix(end) − prefix(start))

    grouped so that a run inside one chunk cancels the chunk prefix
    exactly. Empty runs come out exactly 0."""
    dim = bounds.shape[0] - 1
    nnz = contrib.shape[0]
    if nnz == 0:
        return torch.zeros((dim,), dtype=contrib.dtype, device=contrib.device)
    pad = (-nnz) % _RUN_CHUNK
    if pad:
        contrib = torch.nn.functional.pad(contrib, (0, pad))
    intra = torch.cumsum(contrib.reshape(-1, _RUN_CHUNK), dim=1)
    chunk_prefix = torch.cat([torch.zeros((1,), dtype=intra.dtype, device=intra.device),
                              torch.cumsum(intra[:, -1], dim=0)])
    intra_flat = intra.reshape(-1)
    b = bounds.long()

    def parts(pos):
        safe = torch.clamp(pos, min=0)
        valid = pos >= 0
        zero = torch.zeros((), dtype=intra.dtype, device=intra.device)
        return (torch.where(valid, intra_flat[safe], zero),
                torch.where(valid, chunk_prefix[safe // _RUN_CHUNK], zero))

    i_end, p_end = parts(b[1:] - 1)
    i_start, p_start = parts(b[:-1] - 1)
    return (i_end - i_start) + (p_end - p_start)


class SparseGLMObjective:
    """Sparse twin of GLMObjective: the same interface over
    SparseLabeledPointBatch. It has no ``hessian_matrix``, so variance
    estimation takes the diagonal approximation (``ops/variance.py``)."""

    def __init__(
        self,
        loss: PointwiseLoss,
        l2_weight: float = 0.0,
        normalization: NormalizationContext | None = None,
        use_kernel: bool | None = None,
    ):
        self.loss = loss
        self.l2_weight = float(l2_weight)
        self.normalization = normalization if normalization is not None else no_normalization()
        self.use_kernel = use_kernel

    # value-based identity, as GLMObjective's (GLMObjective._key)
    def _key(self):
        return (type(self.loss), self.l2_weight, id(self.normalization), self.use_kernel)

    def __eq__(self, other):
        return isinstance(other, SparseGLMObjective) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    # -- core scalar function ------------------------------------------------

    def _product(self, v: torch.Tensor, batch: SparseLabeledPointBatch) -> torch.Tensor:
        """X' v = X(f⊙v) − (f⊙v)·shifts, without offsets."""
        eff = self.normalization.effective_coefficients(v)
        return feature_product(batch, eff, use_kernel=self.use_kernel) \
            - self.normalization.margin_shift(eff)

    def margins(self, coefficients: torch.Tensor, batch: SparseLabeledPointBatch) -> torch.Tensor:
        return self._product(coefficients, batch) + batch.offsets

    def _l2_value(self, total, coefficients):
        if self.l2_weight > 0.0:
            total = total + 0.5 * self.l2_weight * torch.dot(coefficients, coefficients)
        return total

    def value(self, coefficients: torch.Tensor, batch: SparseLabeledPointBatch) -> torch.Tensor:
        losses = self.loss.loss(self.margins(coefficients, batch), batch.labels)
        return self._l2_value(torch.sum(batch.weights * losses), coefficients)

    # -- derivatives ---------------------------------------------------------

    def _tail_gradient_update(self, g_eff: torch.Tensor, dzw: torch.Tensor,
                              batch: SparseLabeledPointBatch) -> torch.Tensor:
        """``g_eff`` plus the ELL block's and the flat tail's contributions
        ``dzw_i · x_ij``."""
        return g_eff + tail_column_sums(batch, dzw, use_kernel=self.use_kernel)

    def _transpose(self, r: torch.Tensor, batch: SparseLabeledPointBatch) -> torch.Tensor:
        """Xᵀr in effective coordinates, by the batch's view: sorted runs of
        the column-sorted view, else ``sparse_column_sum``."""
        if batch.has_column_sorted_view and not batch.has_hybrid_view:
            contrib = r[batch.rows_by_col] * batch.vals_by_col.to(r.dtype)
            if batch.col_bounds is not None:
                return _sorted_run_sums(contrib, batch.col_bounds)
            out = torch.zeros((batch.dim,), dtype=r.dtype, device=r.device)
            return out.index_add_(0, batch.cols_sorted, contrib)
        return sparse_column_sum(batch, r, use_kernel=self.use_kernel)

    def value_and_gradient(self, coefficients: torch.Tensor, batch: SparseLabeledPointBatch):
        margins = self.margins(coefficients, batch)
        losses, dz = self.loss.loss_and_dz(margins, batch.labels)
        total = torch.sum(batch.weights * losses)
        dzw = batch.weights * dz
        grad = chain_rule(self.normalization, self._transpose(dzw, batch), torch.sum(dzw))
        if self.l2_weight > 0.0:
            grad = grad + self.l2_weight * coefficients
        return self._l2_value(total, coefficients), grad

    def gradient(self, coefficients: torch.Tensor, batch: SparseLabeledPointBatch) -> torch.Tensor:
        return self.value_and_gradient(coefficients, batch)[1]

    def hessian_vector(self, coefficients: torch.Tensor, vector: torch.Tensor,
                       batch: SparseLabeledPointBatch) -> torch.Tensor:
        """H @ v in closed form: one forward gather-sum for X'(v), one
        transpose by the batch's view. TRON calls this once per CG step."""
        d2w = self.loss.d2z(self.margins(coefficients, batch), batch.labels) * batch.weights
        t = d2w * self._product(vector, batch)
        hv = chain_rule(self.normalization, self._transpose(t, batch), torch.sum(t))
        if self.l2_weight > 0.0:
            hv = hv + self.l2_weight * vector
        return hv

    def hessian_diagonal(self, coefficients: torch.Tensor,
                         batch: SparseLabeledPointBatch) -> torch.Tensor:
        """diag(H) = Σ_i w_i l''_i x'_ij² without materializing H; with
        shifts x'_ij = f_j (x_ij − s_j) expands into column sums."""
        d2 = self.loss.d2z(self.margins(coefficients, batch), batch.labels) * batch.weights
        f, s = self.normalization.factors, self.normalization.shifts
        diag = sparse_column_sum(batch, d2, square_values=True, use_kernel=self.use_kernel)
        if s is not None:
            diag = diag - 2.0 * s * sparse_column_sum(batch, d2, use_kernel=self.use_kernel) \
                + s * s * torch.sum(d2)
        if f is not None:
            diag = diag * f * f
        if self.l2_weight > 0.0:
            diag = diag + self.l2_weight
        return diag

    # -- functional views ----------------------------------------------------

    def bind(self, batch: SparseLabeledPointBatch) -> BoundObjective:
        """The optimizers consume the same BoundObjective as the dense path."""
        return BoundObjective(self, batch)
