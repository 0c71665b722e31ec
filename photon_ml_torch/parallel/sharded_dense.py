"""Sample-sharded GLM objectives: the fused kernel on every rank's rows,
then one all-reduce.

Counterpart of ``photon_ml_tpu/parallel/sharded_dense.py``
(``ShardedDenseGLMObjective``); reference photon-lib
function/glm/ValueAndGradientAggregator.scala:133-154 (the one-pass seqOp
on every executor) and :236-251 (the treeAggregate combine). Each rank
evaluates its own ``[n/R, d]`` rows with L2 off, the packed per-rank
partials ``[value, Σr, X'r...]`` are summed by ONE ``all_reduce`` (the
collective that replaces treeAggregate and the JAX program's psum), and the
normalization chain rule and the L2 term are applied once, after the sum.
The coefficients stay replicated: every rank runs the same solver on the
same summed values and takes the same steps.

Evaluation path, as in ``ops/objective.py``: ``use_kernel`` None runs the
fused GLM kernel B1 (``ops/fused_glm.py``) on a CUDA block and the closed
form on a CPU one; True runs B1, or its plain f32 version on the CPU; False
the closed form. B1 launches on the current stream, and so does the
collective on it, so NCCL orders after the kernel with no extra sync. The
Hessian-vector product is the closed form's, summed the same way.

The buffer of an objective has the same size at every evaluation of a
solve, so NCCL keeps one algorithm for it and two runs at one rank count
sum in one order: they are bitwise equal.

``ShardedSparseGLMObjective`` does the same over a rank's rows of a sparse
batch (the gather kernel G1 on the card): the rank's value and gradient
partials, one all-reduce, then L2.
"""

from __future__ import annotations

import torch

from photon_ml_torch.data.batch import LabeledPointBatch
from photon_ml_torch.ops import fused_glm
from photon_ml_torch.ops.losses import PointwiseLoss
from photon_ml_torch.ops.normalization import NormalizationContext, no_normalization
from photon_ml_torch.ops.objective import BoundObjective, GLMObjective, _matvec, _rmatvec
from photon_ml_torch.ops.sparse_objective import SparseGLMObjective
from photon_ml_torch.parallel.mesh import all_reduce_sum, check_data_mesh


class ShardedDenseGLMObjective:
    """GLM objective over each rank's rows of a dense batch, summed over the
    mesh's data axis. A drop-in for :class:`GLMObjective` at the solvers
    (``bind(batch)`` with ``batch`` this rank's rows)."""

    def __init__(
        self,
        loss: PointwiseLoss,
        mesh,
        l2_weight: float = 0.0,
        normalization: NormalizationContext | None = None,
        use_kernel: bool | None = None,
    ):
        check_data_mesh(mesh)
        self.loss = loss
        self.mesh = mesh
        self.l2_weight = float(l2_weight)
        self.normalization = normalization if normalization is not None else no_normalization()
        self.use_kernel = use_kernel
        #: the rank's data term (L2 off), for what has no sharded form here
        self._local = GLMObjective(loss, l2_weight=0.0, normalization=self.normalization,
                                   use_kernel=use_kernel)

    def _kernel_enabled(self, batch: LabeledPointBatch) -> bool:
        # a zero-width block (an RE/MF-only fit's placeholder fixed effect)
        # takes the closed form: there is nothing for B1 to stream
        return self._local._kernel_enabled(batch) and batch.features.shape[1] > 0

    def _local_terms(self, w: torch.Tensor, batch: LabeledPointBatch):
        """This rank's (value, X'r in effective coordinates, Σr), in f32 on
        the kernel path (B1's outputs) and in w's dtype otherwise."""
        norm = self.normalization
        if self._kernel_enabled(batch):
            x = batch.features
            if x.dtype not in (torch.float32, torch.bfloat16):
                x = x.float()
            eff = w.float()
            if norm.factors is not None:
                eff = eff * norm.factors.float()
            shift = None if norm.shifts is None else torch.dot(eff, norm.shifts.float())
            core = fused_glm._plain_core if x.device.type == "cpu" else fused_glm._kernel_core
            return core(self.loss, x, batch.labels.float(), batch.offsets.float(),
                        batch.weights.float(), eff, shift)
        margins = self._local.margins(w, batch)
        l, dz = self.loss.loss_and_dz(margins, batch.labels)
        r = batch.weights * dz
        return torch.sum(batch.weights * l), _rmatvec(batch.features, r), torch.sum(r)

    def value_and_gradient(self, w: torch.Tensor, batch: LabeledPointBatch):
        value, xtr, rsum = self._local_terms(w, batch)
        packed = torch.cat([value.reshape(1), rsum.reshape(1).to(value.dtype),
                            xtr.to(value.dtype)])
        total = all_reduce_sum(packed, self.mesh)
        value, rsum, grad = total[0], total[1], total[2:]
        norm = self.normalization
        if norm.shifts is not None:
            grad = grad - rsum * norm.shifts.to(grad.dtype)
        if norm.factors is not None:
            grad = grad * norm.factors.to(grad.dtype)
        value, grad = value.to(w.dtype), grad.to(w.dtype)
        if self.l2_weight > 0.0:
            value = value + 0.5 * self.l2_weight * torch.dot(w, w)
            grad = grad + self.l2_weight * w
        return value, grad

    def value(self, w: torch.Tensor, batch: LabeledPointBatch) -> torch.Tensor:
        total = all_reduce_sum(self._local.value(w, batch).reshape(1), self.mesh)[0]
        if self.l2_weight > 0.0:
            total = total + 0.5 * self.l2_weight * torch.dot(w, w)
        return total

    def hessian_vector(self, w: torch.Tensor, v: torch.Tensor,
                       batch: LabeledPointBatch) -> torch.Tensor:
        norm = self.normalization
        margins = self._local.margins(w, batch)
        d2 = self.loss.d2z(margins, batch.labels) * batch.weights
        ev = norm.effective_coefficients(v)
        q = d2 * (_matvec(batch.features, ev) - norm.margin_shift(ev))
        packed = all_reduce_sum(torch.cat([torch.sum(q).reshape(1),
                                           _rmatvec(batch.features, q)]), self.mesh)
        hv = packed[1:]
        if norm.shifts is not None:
            hv = hv - packed[0] * norm.shifts
        if norm.factors is not None:
            hv = hv * norm.factors
        if self.l2_weight > 0.0:
            hv = hv + self.l2_weight * v
        return hv

    def hessian_matrix(self, w: torch.Tensor, batch: LabeledPointBatch) -> torch.Tensor:
        h = all_reduce_sum(self._local.hessian_matrix(w, batch), self.mesh)
        if self.l2_weight > 0.0:
            h = h + self.l2_weight * torch.eye(h.shape[0], dtype=h.dtype, device=h.device)
        return h

    def bind(self, batch: LabeledPointBatch) -> BoundObjective:
        return BoundObjective(self, batch)


class ShardedSparseGLMObjective:
    """:class:`SparseGLMObjective` over each rank's rows of a sparse batch:
    the rank's value and gradient (or Hv) partials with L2 off, one
    all-reduce, then L2."""

    def __init__(self, loss: PointwiseLoss, mesh, l2_weight: float = 0.0,
                 normalization: NormalizationContext | None = None,
                 use_kernel: bool | None = None):
        check_data_mesh(mesh)
        self.loss = loss
        self.mesh = mesh
        self.l2_weight = float(l2_weight)
        self._local = SparseGLMObjective(loss, l2_weight=0.0, normalization=normalization,
                                         use_kernel=use_kernel)
        self.normalization = self._local.normalization
        self.use_kernel = use_kernel

    def value(self, w, batch) -> torch.Tensor:
        total = all_reduce_sum(self._local.value(w, batch).reshape(1), self.mesh)[0]
        if self.l2_weight > 0.0:
            total = total + 0.5 * self.l2_weight * torch.dot(w, w)
        return total

    def value_and_gradient(self, w, batch):
        value, grad = self._local.value_and_gradient(w, batch)
        total = all_reduce_sum(torch.cat([value.reshape(1), grad]), self.mesh)
        value, grad = total[0], total[1:]
        if self.l2_weight > 0.0:
            value = value + 0.5 * self.l2_weight * torch.dot(w, w)
            grad = grad + self.l2_weight * w
        return value, grad

    def hessian_vector(self, w, v, batch) -> torch.Tensor:
        hv = all_reduce_sum(self._local.hessian_vector(w, v, batch), self.mesh)
        if self.l2_weight > 0.0:
            hv = hv + self.l2_weight * v
        return hv

    def bind(self, batch) -> BoundObjective:
        return BoundObjective(self, batch)
