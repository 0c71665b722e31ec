"""Streamed GLM solves (``estimators.train_glm_streaming`` over
``algorithm/streaming.StreamingGLMObjective``) against the JAX package's
``train_glm_streaming`` on the same chunks, and against the port's in-core
``train_glm``, in f64 at rel 1e-8: L-BFGS, LBFGSB, OWL-QN and TRON, dense,
sparse ELL and hybrid, with standardization from ``streaming_summarize``;
the solver-state checkpoints (a mid-solve resume and a crash through
``run_with_recovery`` bitwise the uninterrupted run); and the refusals."""

import errno

import jax.numpy as jnp

import numpy as np
import pytest
import torch

from photon_ml_tpu import estimators as jest
from photon_ml_tpu.algorithm import streaming as jstream
from photon_ml_tpu.data.sparse_batch import HybridPolicy as JHybrid
from photon_ml_tpu.io import stream_reader as jsr
from photon_ml_tpu.io.checkpoint import SolverCheckpointer as JSolverCk
from photon_ml_tpu.ops.normalization import NormalizationType as JNormType
from photon_ml_tpu.ops.normalization import build_normalization as jbuild_norm
from photon_ml_tpu.optim.optimizer import OptimizerConfig as JCfg
from photon_ml_tpu.optim.optimizer import OptimizerType as JType
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch import estimators as test_
from photon_ml_torch import resilience as tres
from photon_ml_torch.algorithm import streaming as tstream
from photon_ml_torch.data.batch import LabeledPointBatch
from photon_ml_torch.data.sparse_batch import HybridPolicy as THybrid
from photon_ml_torch.data.sparse_batch import SparseLabeledPointBatch
from photon_ml_torch.io import stream_reader as tsr
from photon_ml_torch.io.checkpoint import SolverCheckpointer
from photon_ml_torch.ops.normalization import NormalizationType as TNormType
from photon_ml_torch.ops.normalization import build_normalization as tbuild_norm
from photon_ml_torch.optim.optimizer import OptimizerConfig as TCfg
from photon_ml_torch.optim.optimizer import OptimizerType as TType
from photon_ml_torch.resilience import recovery
from photon_ml_torch.types import TaskType as TTask

LAMS = (0.3, 3.0)


def _dense(seed=0, n=230, d=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x[:, -1] = 1.0
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-x @ rng.normal(size=d)))).astype(float)
    return x, y, 0.1 * rng.normal(size=n), rng.uniform(0.5, 1.5, n)


def _coo(seed=1, n=240, d=60, per_row=6):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = np.where(rng.random(n * per_row) < 0.4, rng.integers(0, 4, n * per_row),
                    rng.integers(0, d, n * per_row))
    vals = rng.normal(size=n * per_row)
    z = np.zeros(n)
    np.add.at(z, rows, vals * rng.normal(size=d)[cols] * 0.5)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(float)
    return rows, cols, vals, y, d


def _sources(kind, chunk_rows=64, hook=None):
    if kind == "dense":
        x, y, o, w = _dense()
        return (jsr.ArrayChunkSource(x, y, offsets=o, weights=w, chunk_rows=chunk_rows),
                tsr.ArrayChunkSource(x, y, offsets=o, weights=w, chunk_rows=chunk_rows,
                                     decode_hook=hook))
    rows, cols, vals, y, d = _coo()
    jp = tp = None
    if kind == "hybrid":
        jp, tp = JHybrid(hot_cols=4, pad_multiple=4), THybrid(hot_cols=4, pad_multiple=4)
    return (jsr.SparseArrayChunkSource(rows, cols, vals, y, dim=d, chunk_rows=chunk_rows,
                                       hybrid=jp),
            tsr.SparseArrayChunkSource(rows, cols, vals, y, dim=d, chunk_rows=chunk_rows,
                                       hybrid=tp, decode_hook=hook))


def _in_core(kind):
    if kind == "dense":
        x, y, o, w = _dense()
        return LabeledPointBatch.create(x, y, o, w, device="cpu")
    rows, cols, vals, y, d = _coo()
    return SparseLabeledPointBatch.from_coo(rows, cols, vals, y, dim=d, dtype=torch.float64,
                                            device="cpu")


#: (layout, optimizer, elastic-net alpha): every solver on dense chunks, the
#: two sparse layouts with a first- and a second-order or L1 solve
CASES = [("dense", "LBFGS", 0.0), ("dense", "LBFGSB", 0.0), ("dense", "OWLQN", 0.0),
         ("dense", "TRON", 0.0), ("dense", "LBFGS", 0.6), ("ell", "LBFGS", 0.0),
         ("ell", "TRON", 0.0), ("hybrid", "LBFGS", 0.6), ("hybrid", "TRON", 0.0)]


def _bounds(kind, d):
    if kind != "LBFGSB":
        return None, None
    return np.full(d, -0.3), np.full(d, 0.4)


def _close(ref, got, rtol=1e-8):
    ref, got = np.asarray(ref), np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("layout,opt,alpha", CASES,
                         ids=[f"{lay}-{opt.lower()}" + ("-l1" if a else "") for lay, opt, a in CASES])
def test_streamed_path_matches_jax_and_in_core(layout, opt, alpha):
    jsrc, tsrc = _sources(layout)
    lo, hi = _bounds(opt, tsrc.dim)
    kw = dict(regularization_weights=LAMS, elastic_net_alpha=alpha, lower_bounds=lo,
              upper_bounds=hi)
    jm = jest.train_glm_streaming(
        jsrc, JTask.LOGISTIC_REGRESSION,
        optimizer=JCfg(optimizer_type=JType[opt], max_iterations=15), **kw)
    tm = test_.train_glm_streaming(
        tsrc, TTask.LOGISTIC_REGRESSION,
        optimizer=TCfg(optimizer_type=TType[opt], max_iterations=15), device="cpu", **kw)
    im = test_.train_glm(_in_core(layout), TTask.LOGISTIC_REGRESSION,
                         optimizer=TCfg(optimizer_type=TType[opt], max_iterations=15), **kw)
    for lam in LAMS:
        _close(jm[lam].coefficients.means, tm[lam].coefficients.means.numpy())
        _close(im[lam].coefficients.means.numpy(), tm[lam].coefficients.means.numpy())


def test_standardized_stream_matches_jax():
    jsrc, tsrc = _sources("dense")
    js = jstream.streaming_summarize(jsrc)
    ts = tstream.streaming_summarize(tsrc)
    for key in ("mean", "variance", "max_magnitude"):
        _close(js[key], ts[key], 1e-12)
    assert (ts["count"], ts["weight_sum"]) == (js["count"], js["weight_sum"])
    jn = jbuild_norm(JNormType.STANDARDIZATION, mean=jnp.asarray(js["mean"]), variance=jnp.asarray(js["variance"]),
                     max_magnitude=jnp.asarray(js["max_magnitude"]), intercept_index=tsrc.dim - 1)
    tn = tbuild_norm(TNormType.STANDARDIZATION,
                     **{k: torch.as_tensor(ts[k]) for k in ("mean", "variance",
                                                           "max_magnitude")},
                     intercept_index=tsrc.dim - 1)
    jm = jest.train_glm_streaming(jsrc, JTask.LOGISTIC_REGRESSION, regularization_weights=LAMS,
                                  normalization=jn, intercept_index=tsrc.dim - 1)
    tm = test_.train_glm_streaming(tsrc, TTask.LOGISTIC_REGRESSION, regularization_weights=LAMS,
                                   normalization=tn, intercept_index=tsrc.dim - 1, device="cpu")
    for lam in LAMS:
        _close(jm[lam].coefficients.means, tm[lam].coefficients.means.numpy())
    with pytest.raises(ValueError, match="dense sources"):
        tstream.streaming_summarize(_sources("ell")[1])


@pytest.mark.parametrize("layout", ["dense", "ell"])
def test_prefetch_off_and_repeat_runs_are_bitwise(layout):
    runs = [test_.train_glm_streaming(_sources(layout)[1], TTask.LOGISTIC_REGRESSION,
                                      regularization_weights=LAMS, prefetch=p, device="cpu")
            for p in (True, False, True)]
    for lam in LAMS:
        for other in runs[1:]:
            assert torch.equal(runs[0][lam].coefficients.means, other[lam].coefficients.means)


def test_epoch_accounting():
    _, tsrc = _sources("dense")
    seen = {}
    test_.train_glm_streaming(tsrc, TTask.LOGISTIC_REGRESSION, regularization_weights=(1.0,),
                              device="cpu",
                              on_solve=lambda lam, r, obj: seen.update(obj=obj, r=r))
    obj = seen["obj"]
    assert obj.epochs >= seen["r"].iterations + 1
    assert obj.last_epoch["chunks"] == tsrc.num_chunks
    assert obj.totals["chunks"] == obj.epochs * tsrc.num_chunks
    assert obj.last_epoch["bytes"] == sum(c.nbytes for c in tsr.ChunkPrefetcher(tsrc,
                                                                                prefetch=False))


def _train(ck=None, hook=None, opt="LBFGS", lams=LAMS, save_every=1, retry=None):
    return test_.train_glm_streaming(
        _sources("dense", hook=hook)[1], TTask.LOGISTIC_REGRESSION,
        optimizer=TCfg(optimizer_type=TType[opt], max_iterations=12), regularization_weights=lams,
        checkpointer=ck, device="cpu", retry_policy=retry)


def _equal(a, b):
    for lam in a:
        assert torch.equal(a[lam].coefficients.means, b[lam].coefficients.means)


@pytest.mark.parametrize("opt", ["LBFGS", "TRON", "OWLQN"])
def test_checkpointing_is_bitwise_and_resumes_mid_solve(tmp_path, opt):
    base = _train(opt=opt)
    ck = SolverCheckpointer(tmp_path / "ck", max_to_keep=50)
    _equal(base, _train(SolverCheckpointer(tmp_path / "on"), opt=opt))
    # a run stopped after its third mid-solve save of the second λ resumes
    # from it bitwise
    state = {"saves": 0}
    real = ck.save_progress

    def stop_after(**kw):
        path = real(**kw)
        if kw["lam_index"] == 1 and kw["solver_state"] is not None:
            state["saves"] += 1
            if state["saves"] == 3:
                raise tres.TransientError("stopped")
        return path

    ck.save_progress = stop_after
    with pytest.raises(tres.TransientError):
        _train(ck, opt=opt)
    ck.save_progress = real
    before = recovery.counts["checkpoint_restores"]
    _equal(base, _train(ck, opt=opt))
    assert recovery.counts["checkpoint_restores"] == before + 1


def test_crash_mid_epoch_recovers_bitwise(tmp_path):
    """A transient OSError(EIO) from the decode, mid-epoch in the second λ,
    escapes a one-attempt retry policy, and ``run_with_recovery`` resumes
    from the solver checkpoint to the uninterrupted run's bits."""
    loads = {"n": 0}
    base = _train(hook=lambda: loads.__setitem__("n", loads["n"] + 1))
    fire = {"at": loads["n"] * 3 // 4, "n": 0, "fired": False}

    def hook():
        fire["n"] += 1
        if fire["n"] == fire["at"] and not fire["fired"]:
            fire["fired"] = True
            raise OSError(errno.EIO, "Input/output error")

    ck = SolverCheckpointer(tmp_path / "ck")
    recovery.reset_counts()
    models = tres.run_with_recovery(
        lambda restart: _train(ck, hook=hook, retry=tres.RetryPolicy(max_attempts=1)),
        max_restarts=2, checkpointer=ck)
    assert fire["fired"]
    _equal(base, models)
    assert recovery.counts["checkpoint_restores"] == 1 and recovery.counts["retries"] == 1
    assert recovery.counts["epochs_resumed"] > 0


def test_fingerprint_mismatch_names_the_same_fields_as_jax(tmp_path):
    jsrc, tsrc = _sources("dense")
    messages = []
    for train, src, ckcls, cfg, task in (
            (jest.train_glm_streaming, jsrc, JSolverCk, JCfg, JTask),
            (test_.train_glm_streaming, tsrc, SolverCheckpointer, TCfg, TTask)):
        ck = ckcls(tmp_path / ckcls.__module__)
        extra = {} if train is jest.train_glm_streaming else {"device": "cpu"}
        train(src, task.LOGISTIC_REGRESSION, regularization_weights=(1.0,), checkpointer=ck,
              **extra)
        with pytest.raises(ValueError, match="fingerprint") as e:
            train(src, task.LOGISTIC_REGRESSION, regularization_weights=(2.0,),
                  optimizer=cfg(max_iterations=7), checkpointer=ck, **extra)
        messages.append(str(e.value).split("fingerprint (")[1].split(")")[0])
    assert messages[0] == messages[1]
    assert "lambdas" in messages[1] and "max_iterations" in messages[1]


@pytest.mark.parametrize("kw", [{"mesh": object()},
                                {"exchange": type("X", (), {"num_ranks": 2, "rank": 0})()}],
                         ids=["mesh", "exchange"])
def test_refusals_before_any_data(kw):
    """A mesh that is not the port's data-axis mesh raises ValueError
    saying so; an exchange of several ranks is ported and gets past every
    check to the data (``tests/test_torch_streaming_game_ranks.py`` and
    ``test_torch_coordinated.py`` train over ranks)."""
    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"touched {name}")

    expected = (ValueError, "no counterpart") if "mesh" in kw else (AssertionError, "touched")
    with pytest.raises(expected[0], match=expected[1]):
        test_.train_glm_streaming(Untouchable(), TTask.LOGISTIC_REGRESSION, device="cpu", **kw)
    with pytest.raises(expected[0], match=expected[1]):
        tstream.StreamingGLMObjective(Untouchable(), None, device="cpu", **kw)


def test_newton_and_bounded_l1_are_refused():
    _, tsrc = _sources("dense")
    with pytest.raises(ValueError, match="NEWTON cannot stream"):
        test_.train_glm_streaming(tsrc, TTask.LOGISTIC_REGRESSION, device="cpu",
                                  optimizer=TCfg(optimizer_type=TType.NEWTON))
    with pytest.raises(ValueError, match="box constraints"):
        test_.train_glm_streaming(tsrc, TTask.LOGISTIC_REGRESSION, device="cpu",
                                  elastic_net_alpha=0.5, lower_bounds=np.zeros(tsrc.dim))
