"""The drivers' streaming, checkpoint and restart flags, on the CPU: the GLM
driver's ``--streaming-chunks`` (with and without prefetch, with
``--checkpoint-dir`` and ``--max-restarts``) and the GAME training driver's
``--checkpoint-dir``/``--resume``/``--max-restarts`` against the JAX
drivers at the repo's driver bound of 1e-3·max|w|, and against the port's
own uninterrupted runs bit for bit."""

import errno
import json
import os
from pathlib import Path

import numpy as np
import pytest

from photon_ml_tpu.cli import game_training_driver as jtrain
from photon_ml_tpu.cli import glm_driver as jglm
from photon_ml_tpu.io import avro as javro
from photon_ml_tpu.io import photon_schemas as jschemas
from photon_ml_torch.algorithm import coordinates as tcoord
from photon_ml_torch.cli import game_training_driver as ttrain
from photon_ml_torch.cli import glm_driver as tglm
from photon_ml_torch.io import stream_reader as tsr
from photon_ml_torch.resilience import recovery
from tests import torch_driver_parity as P

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds


@pytest.fixture(scope="module")
def logistic(tmp_path_factory):
    base = tmp_path_factory.mktemp("logistic")
    # blocks of 64 records: several chunks an epoch
    for split, n, seed in (("train", 400, 11), ("test", 150, 12)):
        os.makedirs(base / split)
        javro.write_container(str(base / split / "part-00000.avro"),
                              jschemas.TRAINING_EXAMPLE_AVRO, P.make_logistic_records(n, 12, seed),
                              block_records=64)
    return base


def _glm_args(data, out, *extra, lams="0.1,1,10"):
    return ["--input-data-path", str(data / "train"), "--validation-data-path",
            str(data / "test"), "--output-dir", str(out), "--task-type",
            "LOGISTIC_REGRESSION", "--regularization-weights", lams, *extra]


def _within_driver_bound(j, t):
    for lam in j.models:
        wj = np.asarray(j.models[lam].coefficients.means, np.float64)
        wt = t.models[lam].coefficients.means.double().numpy()
        assert np.abs(wj - wt).max() <= 1e-3 * np.abs(wj).max(), lam


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.mark.parametrize("optimizer,lams", [("LBFGS", "0.1,1,10"), ("TRON", "1")])
def test_streaming_glm_driver_matches_the_jax_driver(logistic, tmp_path, optimizer, lams):
    extra = ("--streaming-chunks", "128", "--optimizer", optimizer)
    if optimizer == "TRON":  # the reference's TRON defaults (TRON.scala:257-262)
        extra += ("--max-iterations", "15", "--tolerance", "1e-5")
    j = jglm.main(_glm_args(logistic, tmp_path / "j", *extra, lams=lams))
    t = tglm.main(_glm_args(logistic, tmp_path / "t", *extra, lams=lams), device="cpu")
    _within_driver_bound(j, t)
    assert t.best_lambda == j.best_lambda and t.stage.name == "VALIDATED"
    in_core = tglm.main(_glm_args(logistic, tmp_path / "c", *extra[2:], lams=lams),
                        device="cpu")
    _within_driver_bound(in_core, t)
    off = tglm.main(_glm_args(logistic, tmp_path / "off", *extra, "--no-streaming-prefetch",
                              lams=lams), device="cpu")
    assert _files(tmp_path / "off" / "models-text") == _files(tmp_path / "t" / "models-text")
    for lam in t.models:
        assert off.models[lam].coefficients.means.equal(t.models[lam].coefficients.means)


def test_streaming_glm_driver_standardized_matches_the_jax_driver(logistic, tmp_path):
    extra = ("--streaming-chunks", "200", "--normalization", "STANDARDIZATION",
             "--data-validation", "VALIDATE_FULL")
    j = jglm.main(_glm_args(logistic, tmp_path / "j", *extra, lams="1"))
    t = tglm.main(_glm_args(logistic, tmp_path / "t", *extra, lams="1"), device="cpu")
    _within_driver_bound(j, t)


def test_glm_checkpoint_dir_resumes_at_the_last_step(logistic, tmp_path):
    """A finished checkpointed run rerun resumes at its last λ boundary (no
    epoch redone) and writes the same model files; the JAX driver's
    checkpointed run agrees within the driver bound."""
    extra = ("--streaming-chunks", "128", "--checkpoint-dir", str(tmp_path / "ck"))
    first = tglm.main(_glm_args(logistic, tmp_path / "a", *extra, lams="0.1,10"), device="cpu")
    steps = sorted(os.listdir(tmp_path / "ck"))
    recovery.reset_counts()
    again = tglm.main(_glm_args(logistic, tmp_path / "b", *extra, lams="0.1,10"), device="cpu")
    assert recovery.counts["checkpoint_restores"] == 1
    assert sorted(os.listdir(tmp_path / "ck")) == steps
    assert _files(tmp_path / "a" / "models-text") == _files(tmp_path / "b" / "models-text")
    j = jglm.main(_glm_args(logistic, tmp_path / "j", "--streaming-chunks", "128",
                            "--checkpoint-dir", str(tmp_path / "jck"), lams="0.1,10"))
    _within_driver_bound(j, first)
    assert again.best_lambda == first.best_lambda


def test_glm_driver_restarts_and_resumes_bitwise(logistic, tmp_path, monkeypatch):
    """Three decode failures in a row in the second λ exhaust the retry
    policy; ``--max-restarts 1`` restarts the stages, which resume from the
    solver checkpoint to the uninterrupted run's bits."""
    base = tglm.main(_glm_args(logistic, tmp_path / "base", "--streaming-chunks", "128",
                               lams="0.5,5"), device="cpu")
    real = tsr.AvroChunkSource.load
    state = {"n": 0, "failed": 0}

    def flaky(self, spec):
        state["n"] += 1
        if state["n"] > 60 and state["failed"] < 3:
            state["failed"] += 1
            raise ConnectionResetError(errno.ECONNRESET, "connection reset by peer")
        return real(self, spec)

    monkeypatch.setattr(tsr.AvroChunkSource, "load", flaky)
    monkeypatch.setattr("photon_ml_torch.resilience.policy.time.sleep", lambda s: None)
    recovery.reset_counts()
    got = tglm.main(_glm_args(logistic, tmp_path / "r", "--streaming-chunks", "128",
                              "--checkpoint-dir", str(tmp_path / "ck"), "--max-restarts", "1",
                              lams="0.5,5"), device="cpu")
    assert state["failed"] == 3
    assert recovery.counts["retries"] >= 1 and recovery.counts["checkpoint_restores"] == 1
    for lam in base.models:
        assert got.models[lam].coefficients.means.equal(base.models[lam].coefficients.means)


def test_glm_driver_checks(logistic, tmp_path):
    with pytest.raises(ValueError, match="--checkpoint-every"):
        tglm.main(_glm_args(logistic, tmp_path / "o", "--streaming-chunks", "8",
                            "--checkpoint-every", "0"), device="cpu")
    with pytest.raises(ValueError, match="NEWTON"):
        tglm.main(_glm_args(logistic, tmp_path / "o", "--streaming-chunks", "8",
                            "--optimizer", "NEWTON"), device="cpu")
    with pytest.raises(ValueError, match="variances"):
        tglm.main(_glm_args(logistic, tmp_path / "o", "--streaming-chunks", "8",
                            "--compute-variance"), device="cpu")


# -- the GAME training driver -------------------------------------------------------


@pytest.fixture(scope="module")
def music(tmp_path_factory):
    base = tmp_path_factory.mktemp("music")
    P.write_music(str(base))
    return base


GAME = P.FE_ARGS + P.PER_USER_ARGS + ["--coordinate-descent-iterations", "2"]


def _models(root: Path) -> dict:
    return {k: v for k, v in _files(root).items() if k.startswith(("models", "best"))}


def test_game_checkpoint_dir_matches_the_jax_driver_and_resumes(music, tmp_path):
    """The port's checkpointed run: the JAX driver's per-configuration
    directory names and steps, its metric within the driver bound; rerun, it
    resumes at the last step and writes byte-identical model files."""
    extra = GAME + ["--checkpoint-dir", str(tmp_path / "tck")]
    jsum = jtrain.main(P.training_args(music, tmp_path / "j",
                                       GAME + ["--checkpoint-dir", str(tmp_path / "jck")]))
    tsum = ttrain.main(P.training_args(music, tmp_path / "t", extra), device="cpu")
    assert tsum["best_metric"] == pytest.approx(jsum["best_metric"], rel=1e-3)
    assert sorted(os.listdir(tmp_path / "tck")) == sorted(os.listdir(tmp_path / "jck"))
    (config,) = os.listdir(tmp_path / "tck")
    assert sorted(os.listdir(tmp_path / "tck" / config)) == \
        sorted(os.listdir(tmp_path / "jck" / config))
    recovery.reset_counts()
    ttrain.main(P.training_args(music, tmp_path / "t2", extra), device="cpu")
    assert recovery.counts["checkpoint_restores"] == 1
    assert _models(tmp_path / "t2") == _models(tmp_path / "t")


@pytest.mark.parametrize("resume", [True, False], ids=["resume", "no-resume"])
def test_game_driver_restarts_resume_even_under_no_resume(music, tmp_path, monkeypatch,
                                                          resume):
    base = ttrain.main(P.training_args(music, tmp_path / "base", GAME), device="cpu")
    real = tcoord.FixedEffectCoordinate.update_model
    state = {"n": 0}

    def flaky(self, *args, **kwargs):
        state["n"] += 1
        if state["n"] == 2:
            raise RuntimeError("UNAVAILABLE: worker has been preempted")
        return real(self, *args, **kwargs)

    monkeypatch.setattr(tcoord.FixedEffectCoordinate, "update_model", flaky)
    recovery.reset_counts()
    extra = GAME + ["--checkpoint-dir", str(tmp_path / "ck"), "--max-restarts", "1"]
    if not resume:
        extra.append("--no-resume")
    summary = ttrain.main(P.training_args(music, tmp_path / "r", extra), device="cpu")
    assert recovery.counts["checkpoint_restores"] == 1 and recovery.counts["preemptions"] == 1
    assert summary["best_metric"] == base["best_metric"]
    assert _models(tmp_path / "r") == _models(tmp_path / "base")
    with open(tmp_path / "r" / "training-summary.json") as f:
        assert json.load(f)["best_metric"] == base["best_metric"]


def test_game_driver_without_checkpoints_gives_up_on_a_fatal_error(music, tmp_path,
                                                                   monkeypatch):
    def sticky(self, *args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(tcoord.FixedEffectCoordinate, "update_model", sticky)
    recovery.reset_counts()
    with pytest.raises(RuntimeError, match="illegal memory access"):
        ttrain.main(P.training_args(music, tmp_path / "o", GAME + ["--max-restarts", "3"]),
                    device="cpu")
    assert recovery.counts["retries"] == 0


def test_game_driver_restarts_on_several_ranks_wait_for_step_2(music, tmp_path):
    """``--max-restarts`` above 0 on a group of two ranks is ported (every
    run of several ranks takes coordinated recovery): the run gets past
    every refusal and fails on the missing input, on each rank."""
    from tests import torch_mesh_worker as W

    argv = P.training_args(tmp_path / "no-such-input", tmp_path / "o",
                           GAME + ["--distributed", "--max-restarts", "1"], validation=False)
    (tmp_path / "ranks").mkdir()
    with pytest.raises(RuntimeError, match="FileNotFoundError") as ei:
        W.spawn_ranks(2, [dict(kind="driver_runs", runs=[("train", argv)])], tmp_path / "ranks")
    assert "ROADMAP.md item" not in str(ei.value)


def test_distributed_game_driver_recovers_a_killed_rank(music, tmp_path):
    """A plain ``--distributed`` run on two gloo ranks (no partitioned I/O)
    with rank 1 killed at the sweep-2 commit barrier: the driver's
    coordinated recovery rolls both ranks back to step 1 on a new group
    (rank 0 through the peer-abort marker, at once), spends one restart of
    the default budget, and both ranks write the uninterrupted run's model
    files byte for byte."""
    from tests import torch_mesh_worker as W

    def argv(name):
        return P.training_args(music, tmp_path / name, GAME + [
            "--distributed", "--checkpoint-dir", str(tmp_path / f"{name}-ck")])

    (tmp_path / "ranks").mkdir()
    plain, killed = W.spawn_ranks(
        2, [dict(kind="driver_runs", runs=[("train", argv("plain"))]),
            dict(kind="driver_recovery", argv=argv("killed"))],
        tmp_path / "ranks", timeout_s=240, group_timeout_s=30)
    for r in range(2):
        assert killed[r]["exchanges"] == 1
        assert killed[r]["fired"] == (1 if r == 1 else 0)
        assert killed[r]["counts"]["coordinated_restarts"] == 1
        assert killed[r]["counts"]["checkpoint_restores"] == 1
        assert killed[r]["summary"]["best_metric"] == plain[r][0]["summary"]["best_metric"]
    assert killed[0]["counts"]["peer_aborts"] == 1
    assert killed[1]["counts"]["preemptions"] == 1
    for sub in ("", ".worker-1"):
        got = _models(tmp_path / "killed" / sub)
        assert got and got == _models(tmp_path / "plain" / sub)
