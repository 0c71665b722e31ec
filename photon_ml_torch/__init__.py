"""photon-ml-torch: the PyTorch/CUDA port of ``photon_ml_tpu`` for NVIDIA Hopper.

The JAX package stays the reference. This package keeps its module names
so each port module sits at the same path as its counterpart, and it
imports only ``torch``, numpy and the standard library.

Ported so far: single-GLM training (``estimators.train_glm``) on dense and
sparse batches with the L-BFGS / LBFGSB / OWL-QN / TRON / Newton solvers,
normalization, variances, the four pointwise losses and GLM scoring; in-core
GAME training on one device (``estimators.GameEstimator``: a fixed effect
plus per-entity random effects by block coordinate descent, lane-batched
L-BFGS, Newton, OWL-QN and TRON solves, IDENTITY, INDEX_MAP and RANDOM
projections, ``projector/projectors.py``, and matrix-factorization
coordinates, ``algorithm/mf_coordinate.py``); the three drivers and the host
tools on Avro (through the columnar C++ decoder under ``native/``) and LibSVM
(its C++ parser); streamed out-of-core GLM solves
(``estimators.train_glm_streaming``), checkpoints and resume
(``io/checkpoint.py``) and restarts after a transient failure
(``resilience/``); and the hand-written kernels under ``csrc/``
(``ops/fused_glm.py``, ``ops/packed_glm.py``, ``ops/sparse_gather.py``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``device.resolve_device``).
"""

__version__ = "0.1.0"

from photon_ml_torch.types import TaskType  # noqa: F401
