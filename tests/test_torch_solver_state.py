"""The single-vector solvers' loop state (``optim/lbfgs.LBFGSState``,
``owlqn.OWLQNState``, ``tron.TRONState``) and hooks: the field names of the
JAX package's state structs, a solve with an observer bitwise the solve
without, and a resume from a state saved mid-solve bitwise the
uninterrupted solve, in f32 and f64."""

import dataclasses

import numpy as np
import pytest
import torch

from photon_ml_tpu.optim.lbfgs import _LBFGSState
from photon_ml_tpu.optim.owlqn import _OWLQNState
from photon_ml_tpu.optim.tron import _TRONState
from photon_ml_torch.data.batch import LabeledPointBatch
from photon_ml_torch.ops.losses import loss_for_task
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.optim.common import run_while
from photon_ml_torch.optim.optimizer import (
    OptimizerConfig,
    OptimizerType,
    solve,
    solver_state_class,
)
from photon_ml_torch.types import TaskType

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

SOLVERS = [("LBFGS", 0.0, None), ("LBFGSB", 0.0, (-0.5, 0.8)), ("OWLQN", 0.4, None),
           ("TRON", 0.0, None)]


def _problem(dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(400, 10))
    y = (rng.random(400) < 1.0 / (1.0 + np.exp(-x @ rng.normal(size=10)))).astype(float)
    batch = LabeledPointBatch.create(x, y, device="cpu", dtype=dtype)
    return GLMObjective(loss_for_task(TaskType.LOGISTIC_REGRESSION), 0.3).bind(batch)


def _solve(kind, l1, box, dtype, **hooks):
    cfg = OptimizerConfig(optimizer_type=OptimizerType[kind], l1_weight=l1, max_iterations=25,
                          tolerance=1e-12)
    kw = {}
    if box is not None:
        kw = dict(lower_bounds=torch.full((10,), box[0], dtype=dtype),
                  upper_bounds=torch.full((10,), box[1], dtype=dtype))
    return cfg, solve(cfg, _problem(dtype), torch.zeros(10, dtype=dtype), **kw, **hooks)


def _same(a, b):
    assert a.iterations == b.iterations and a.reason == b.reason
    for field in ("coefficients", "value", "gradient_norm", "value_history",
                  "grad_norm_history"):
        np.testing.assert_array_equal(getattr(a, field).numpy(), getattr(b, field).numpy())


@pytest.mark.parametrize("ours,theirs", [("LBFGS", _LBFGSState), ("OWLQN", _OWLQNState),
                                         ("TRON", _TRONState)])
def test_state_fields_are_the_reference_structs(ours, theirs):
    cls = solver_state_class(OptimizerConfig(optimizer_type=OptimizerType[ours]))
    assert [f.name for f in dataclasses.fields(cls)] == \
        [f.name for f in dataclasses.fields(theirs)]


def test_solver_state_class_refuses_newton():
    with pytest.raises(ValueError, match="no host-loop"):
        solver_state_class(OptimizerConfig(optimizer_type=OptimizerType.NEWTON))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kind,l1,box", SOLVERS, ids=[s[0] for s in SOLVERS])
def test_observer_changes_nothing(kind, l1, box, dtype):
    seen = []
    _, plain = _solve(kind, l1, box, dtype)
    _, watched = _solve(kind, l1, box, dtype,
                        state_observer=lambda st: seen.append(st.iteration))
    _same(plain, watched)
    assert seen == list(range(1, plain.iterations + 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kind,l1,box", SOLVERS, ids=[s[0] for s in SOLVERS])
def test_resume_mid_solve_is_bitwise(kind, l1, box, dtype):
    """A state saved at iteration 3 (through host arrays, as a checkpoint
    holds it) resumes to the uninterrupted solve's bits."""
    saved = {}

    def keep(st):
        if st.iteration == 3:
            saved.update(st.to_arrays())

    cfg, whole = _solve(kind, l1, box, dtype, state_observer=keep)
    assert whole.iterations > 3 and saved
    state = solver_state_class(cfg).from_arrays(saved, dtype=dtype, device="cpu")
    _, resumed = _solve(kind, l1, box, dtype, resume_state=state)
    _same(whole, resumed)


def test_state_arrays_keep_the_reference_dtypes():
    saved = {}
    _solve("LBFGS", 0.0, None, torch.float64,
           state_observer=lambda st: saved.update(st.to_arrays()))
    assert saved["count"].dtype == np.int32 and saved["count"].shape == ()
    assert saved["f"].dtype == np.float64 and saved["f"].shape == ()
    assert saved["s_hist"].shape == (10, 10) and saved["value_history"].shape == (26,)


def test_run_while_observes_every_step():
    seen = []
    out = run_while(lambda s: s < 5, lambda s: s + 1, 0, observer=seen.append)
    assert out == 5 and seen == [1, 2, 3, 4, 5]


def test_newton_takes_no_hooks():
    cfg = OptimizerConfig(optimizer_type=OptimizerType.NEWTON)
    with pytest.raises(ValueError, match="LBFGS/OWLQN/TRON"):
        solve(cfg, _problem(torch.float64), torch.zeros(10, dtype=torch.float64),
              state_observer=lambda st: None)
