"""The port's program ledger (``photon_ml_torch/telemetry/program_ledger.py``)
against the JAX package's, on the CPU.

Signatures, their diffs and summaries are equal on the same inputs (numpy
leaves; a tensor against a JAX array differs only in the ``sharding`` slot,
which holds the tensor's device string in the port). The ledger is driven
through ``ProgramLedger.observed_call`` in both packages with the same call
sequence and a plain callable that records compiles into the ledger's
registry (the JAX package's ``ledger_jit`` needs
``jax.core.trace_state_clean``, which the installed JAX lacks, and no
analysis runs): the journal rows and the ``xla/<label>/*`` metrics are
equal field for field, the stamps apart. The labelled programs of the port
give bitwise-equal outputs with a ledger installed and without.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.telemetry import journal as tj
from photon_ml_torch.telemetry import probes as tp
from photon_ml_torch.telemetry import program_ledger as tl
from photon_ml_torch.telemetry import registry as treg
from photon_ml_tpu.telemetry import journal as jj
from photon_ml_tpu.telemetry import probes as jp
from photon_ml_tpu.telemetry import program_ledger as jl
from photon_ml_tpu.telemetry import registry as jreg

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

STAMPS = {"seq", "ts", "elapsed_ms"}
Pair = collections.namedtuple("Pair", ["left", "right"])


@dataclasses.dataclass
class TBlock:
    features: object
    labels: object
    extra: object = None


@dataclasses.dataclass
class JBlock:
    features: object
    labels: object
    extra: object = None


jax.tree_util.register_dataclass(JBlock, data_fields=["features", "labels", "extra"],
                                 meta_fields=[])


class Settings:
    """A static argument described by type and hash in both packages."""

    def __init__(self, k):
        self.k = k

    def __hash__(self):
        return hash(("Settings", self.k))

    def __eq__(self, other):
        return isinstance(other, Settings) and other.k == self.k


def _arrays(seed, n=8, d=3):
    r = np.random.default_rng(seed)
    return {"x": r.normal(size=(n, d)), "y": r.normal(size=n).astype(np.float32),
            "idx": r.integers(0, 5, size=n).astype(np.int32), "mask": r.random(n) > 0.5}


def _call(block, a, n=8):
    """(args, kwargs, static_argnums, static_argnames) of one call, with the
    package's dataclass: nested dicts (keys out of order), tuples, a named
    tuple, a dataclass with a None field, weak scalars, statics by number
    and by name."""
    args = ({"zeta": a["y"], "alpha": {"b": a["idx"], "a": (a["x"], None, 2.5)}},
            block(features=a["x"], labels=a["y"]),
            (7, "mode", (1, 2.0)),
            Pair(a["mask"], True))
    kwargs = {"settings": Settings(n), "scale": 0.5, "rows": a["idx"]}
    return args, kwargs, (2,), ("settings",)


@pytest.mark.parametrize("seed", [0, 1])
def test_signatures_and_diffs_match(seed):
    """build_signature on nested dicts, tuples, a named tuple, dataclasses,
    static arguments and weak scalars: equal leaves, statics and JSON;
    diff_signatures and diff_summary of two calls that differ in shapes,
    dtypes, a static and a leaf's presence: equal."""
    a, b = _arrays(seed), _arrays(seed + 7, n=16)
    b["y"] = b["y"].astype(np.float64)
    sigs = []
    for pkg, block in ((tl, TBlock), (jl, JBlock)):
        s1 = pkg.build_signature(*_call(block, a))
        args, kwargs, nums, names = _call(block, b, n=16)
        kwargs["extra_leaf"] = b["idx"]
        s2 = pkg.build_signature(args, kwargs, nums, names)
        sigs.append((s1, s2))
    (t1, t2), (j1, j2) = sigs
    assert t1.leaves == j1.leaves and t1.static == j1.static and t1.key == j1.key
    assert t2.to_json() == j2.to_json()
    changes = tl.diff_signatures(t1, t2)
    assert changes == jl.diff_signatures(j1, j2)
    assert {c["field"] for c in changes} >= {"shape", "dtype", "static", "presence"}
    assert tl.diff_summary(changes) == jl.diff_summary(changes)
    assert tl.diff_summary(changes, limit=2) == jl.diff_summary(changes, limit=2)
    assert tl.diff_summary([]) == jl.diff_summary([])
    assert tl.diff_signatures(t1, t1) == []


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "bool", "bfloat16"])
def test_tensor_leaves_differ_only_in_the_sharding_slot(dtype):
    """A tensor against a JAX array of the same values: the same shape and
    the numpy dtype name; the sharding slot holds the device string."""
    x = np.arange(6).reshape(2, 3) % 2
    t = torch.as_tensor(x).to(getattr(torch, dtype))
    j = jnp.asarray(x).astype(dtype)
    (tpath, tdesc), = tl.build_signature(({"w": t},), {}).leaves
    (jpath, jdesc), = jl.build_signature(({"w": j},), {}).leaves
    assert tpath == jpath == "arg0.w"
    assert tdesc[:3] == jdesc[:3] == ("array", (2, 3), dtype)
    assert tdesc[3] == "cpu" and jdesc[3] is not None


class _Program:
    """A plain callable standing in for a compiled program: each call
    records the compiles the sequence asks for into the ledger's registry
    (0.125 s each) and raises when asked."""

    def __init__(self, registry):
        self.registry = registry
        self.compiles = 0
        self.fail = False

    def __call__(self, *args, **kwargs):
        for _ in range(self.compiles):
            self.registry.counter("jax/backend_compile_count").inc()
            self.registry.histogram("jax/backend_compile_seconds").observe(0.125)
        if self.fail:
            raise ValueError("program failed")
        return len(args)


def _sequence():
    """(phase, label, args, kwargs, static_argnames, compiles, fail) of each
    call: a first compile, a cached call, a shape recompile, a new dtype
    without a compile, a static change, an evicted program recompiling twice,
    a failing call, and a second label."""
    x8, x16 = np.zeros((8, 3)), np.zeros((16, 3))
    return [
        ("warm", "a", (x8,), {}, (), 1, False),
        ("warm", "a", (x8,), {}, (), 0, False),
        ("warm", "a", (x16,), {}, (), 1, False),
        ("warm", "a", (x16.astype(np.float32),), {}, (), 0, False),
        ("warm", "b", (x8, 3), {"mode": "sum"}, ("mode",), 1, False),
        ("replay", "b", (x8, 4), {"mode": "max"}, ("mode",), 1, False),
        ("replay", "a", (x8,), {}, (), 2, False),
        ("replay", "c", ({"u": x8, "v": [x16, 1]},), {}, (), 1, True),
        ("replay", "c", ({"u": x8, "v": [x16, 1]},), {}, (), 0, False),
        ("replay", "d", (x8,), {}, (), 0, False),
    ]


def _drive(pkg, reg_mod, journal_mod, tmp, max_signatures):
    registry = reg_mod.MetricsRegistry()
    journal = journal_mod.RunJournal(tmp)
    # the port has no cost analysis; the JAX package's is turned off
    kw = {"analyze_cost": False} if pkg is jl else {}
    ledger = pkg.ProgramLedger(registry=registry, journal=journal, analyze_memory=False,
                               max_signatures=max_signatures, **kw)
    program = _Program(registry)
    for phase, label, args, kwargs, names, compiles, fail in _sequence():
        ledger.set_phase(phase)
        program.compiles, program.fail = compiles, fail
        if fail:
            with pytest.raises(ValueError, match="program failed"):
                ledger.observed_call(program, label, args, kwargs, (), names)
        else:
            assert ledger.observed_call(program, label, args, kwargs, (), names) == len(args)
    journal.close()
    rows = [{k: v for k, v in r.items() if k not in STAMPS}
            for r in journal_mod.read_journal(tmp / "run-journal.jsonl")
            if r["kind"].startswith("program_")]
    return ledger, registry, rows


@pytest.mark.parametrize("max_signatures", [64, 2])
def test_ledger_rows_and_metrics_match(tmp_path, max_signatures):
    """The same call sequence through both packages' observed_call: equal
    compile, recompile and signature rows (attribution, phase, error,
    seconds), equal snapshots and signature counts, and equal ``xla/*``
    counters, gauges and histograms; a diff cache of 2 keeps the counts
    monotone in both."""
    tled, treg_, trows = _drive(tl, treg, tj, tmp_path / "t", max_signatures)
    jled, jreg_, jrows = _drive(jl, jreg, jj, tmp_path / "j", max_signatures)
    assert trows == jrows
    kinds = [r["kind"] for r in trows]
    assert kinds.count("program_recompile") == 3 and "program_signature" in kinds
    assert [r["error"] for r in trows if r["kind"] == "program_compile"][-1] == "ValueError"
    assert tled.snapshot() == jled.snapshot()
    assert tled.labels() == jled.labels() == ["a", "b", "c", "d"]
    assert [tled.signature_count(k) for k in "abcde"] == \
        [jled.signature_count(k) for k in "abcde"]
    tsnap, jsnap = treg_.snapshot(), jreg_.snapshot()
    for part in ("counters", "gauges", "histograms"):
        assert {k: v for k, v in tsnap[part].items() if k.startswith("xla/")} == \
            {k: v for k, v in jsnap[part].items() if k.startswith("xla/")}
    assert tsnap["counters"]["jax/backend_compile_count"] == \
        jsnap["counters"]["jax/backend_compile_count"] == 7


def test_ledger_call_is_inert_without_a_ledger_and_nests_with_one(tmp_path):
    """Without a ledger a labelled call is a passthrough; with one, a compile
    event inside a labelled call (``probes.record_compile``, as a build or a
    graph capture records it) is that label's compile. A labelled call
    nested in another is part of the outer call, as a ``ledger_jit`` call
    under a JAX trace is: not observed on its own, its compile the outer
    label's."""
    @tl.ledger_call(label="test/inner", static_argnums=(1,))
    def inner(x, compile_it):
        if compile_it:
            tp.record_compile(0.25)
        return x * 2

    @tl.ledger_call(label="test/outer")
    def outer(x):
        return inner(x, True) + 1

    assert inner.label == "test/inner" and not tl.ledger_active()
    x = torch.arange(4.0)
    assert torch.equal(outer(x), x * 2 + 1)
    journal = tj.RunJournal(tmp_path)
    ledger = tl.install_ledger(tl.ProgramLedger(registry=treg.MetricsRegistry(),
                                                journal=journal))
    try:
        assert tl.current_ledger() is ledger
        assert torch.equal(outer(x), x * 2 + 1)
        assert torch.equal(inner(x, False), x * 2)
    finally:
        assert tl.uninstall_ledger() is ledger
    journal.close()
    snap = ledger.snapshot()
    assert snap["test/inner"] == {"calls": 1, "compiles": 0, "recompiles": 0, "signatures": 1}
    assert snap["test/outer"] == {"calls": 1, "compiles": 1, "recompiles": 0, "signatures": 1}
    rows = tj.read_journal(tmp_path / "run-journal.jsonl")
    compiled = [r for r in rows if r["kind"] == "program_compile"]
    assert [r["label"] for r in compiled] == ["test/outer"]
    assert all(r["compile_seconds"] == 0.25 and r["cost"] is None for r in compiled)
    assert [r["label"] for r in rows if r["kind"] == "program_signature"] == ["test/inner"]


def test_memory_analysis_reports_graph_pool_bytes(tmp_path):
    """analyze_memory: a labelled call whose capture grew the graph pool
    reports those bytes as temp_size_in_bytes (and the gauge); without it
    the memory fields stay None. On the CPU there is no device limit."""
    @tl.ledger_call(label="test/capture")
    def capture(x):
        tp.record_compile(0.5, pool_bytes=4096)
        return x

    for analyze in (False, True):
        reg = treg.MetricsRegistry()
        reg.gauge("serve/resident_params_bytes").set(1000)
        journal = tj.RunJournal(tmp_path / str(analyze))
        tl.install_ledger(tl.ProgramLedger(registry=reg, journal=journal,
                                           analyze_memory=analyze))
        try:
            capture(np.zeros(3))
        finally:
            tl.uninstall_ledger()
        journal.close()
        row, = [r for r in tj.read_journal(tmp_path / str(analyze) / "run-journal.jsonl")
                if r["kind"] == "program_compile"]
        if analyze:
            assert row["memory"] == {"temp_size_in_bytes": 4096}
            assert row["hbm_forecast_bytes"] == 5096
            assert reg.gauge("xla/test/capture/temp_bytes").value == 4096
        else:
            assert row["memory"] is None and row["hbm_forecast_bytes"] is None
        assert row["device_bytes_limit"] is None


def _with_ledger(run, tmp):
    """``run()`` with a ledger installed (and its journal closed after);
    returns (output, ledger)."""
    journal = tj.RunJournal(tmp)
    ledger = tl.install_ledger(tl.ProgramLedger(registry=treg.MetricsRegistry(),
                                                journal=journal))
    try:
        out = run()
    finally:
        tl.uninstall_ledger()
        journal.close()
    return out, ledger


def _estimator_run():
    from tests.torch_game_parity import datasets, estimator_pair, game_arrays

    _, td = datasets(game_arrays(5, n=240, n_users=10))
    _, te = estimator_pair(num_iterations=2, lane_iterations=5, compute_variance=True)
    return lambda: te.fit(td).model


def _scheduled_run():
    import dataclasses as dc

    from photon_ml_torch.optim.optimizer import LaneSchedulerConfig
    from tests.torch_game_parity import datasets, estimator_pair, game_arrays

    _, td = datasets(game_arrays(6, n=240, n_users=10))
    _, te = estimator_pair(num_iterations=2, lane_iterations=6)
    cfgs = dict(te.coordinate_configs)
    for cid in ("per_user", "per_item"):
        c = cfgs[cid]
        opt = dc.replace(c.optimization.optimizer,
                         scheduler=LaneSchedulerConfig(probe_iterations=2))
        cfgs[cid] = dc.replace(c, optimization=dc.replace(c.optimization, optimizer=opt))
    te = dc.replace(te, coordinate_configs=cfgs)
    return lambda: te.fit(td).model


def _grid_run():
    from photon_ml_torch import estimators as test_
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.types import TaskType
    from tests.torch_parity import batches, make_data

    x, y, offsets, weights = make_data(2, 200, 5, True)
    _, tb = batches(x, y, offsets, weights)
    return lambda: test_.train_glm_grid(
        tb, TaskType.LOGISTIC_REGRESSION, optimizer=OptimizerConfig(OptimizerType.LBFGS, 30),
        regularization_weights=(0.1, 1.0, 10.0), compute_variance=True, variance_mode="full")


def _streaming_run():
    from photon_ml_torch import estimators as test_
    from photon_ml_torch.io.stream_reader import ArrayChunkSource
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.types import TaskType
    from tests.torch_parity import make_data

    x, y, offsets, weights = make_data(3, 200, 5, True)
    source = ArrayChunkSource(x, y, chunk_rows=64, offsets=offsets, weights=weights)
    return lambda: test_.train_glm_streaming(
        source, TaskType.LOGISTIC_REGRESSION, optimizer=OptimizerConfig(OptimizerType.TRON, 8),
        regularization_weights=(0.5,), device="cpu")


def _serving_run():
    from photon_ml_torch.serving import ResidentScorer
    from tests.test_torch_serving import _arrays, tdataset, tmodel

    a = _arrays("ell", seed=3)
    ds, model = tdataset(a), tmodel(a)
    return lambda: ResidentScorer(model, shapes=(8, 32, 64)).score(ds)


def _fused_run(scheduled: bool):
    from photon_ml_torch import convert
    from photon_ml_torch.parallel import distributed as tdist
    from tests.test_torch_scheduled_program import _build

    jds, tds, jre, tre, _, _, (jprog, tprog) = _build("identity-freeze", scheduled=scheduled)
    state = convert.train_state_from_numpy(jprog.init_state(jds, jre), device="cpu")
    return lambda: tdist.train_distributed(tprog, tds, tre, num_iterations=2,
                                           state=state).state


def _flat(out) -> list:
    """Every tensor and array of an output, in a fixed order, as numpy."""
    if isinstance(out, torch.Tensor):
        return [out.detach().numpy()]
    if isinstance(out, np.ndarray):
        return [out]
    if isinstance(out, dict):
        return [v for k in sorted(out, key=str) for v in _flat(out[k])]
    if isinstance(out, (list, tuple)):
        return [v for x in out for v in _flat(x)]
    if dataclasses.is_dataclass(out):
        return [v for f in dataclasses.fields(out) for v in _flat(getattr(out, f.name))]
    if hasattr(out, "models"):
        return _flat(out.models)
    return []


RUNS = {
    "estimator": (_estimator_run, {"coord/fe_solve", "coord/re_bucket_solve",
                                   "coord/re_bucket_variances"}),
    "scheduled": (_scheduled_run, {"coord/fe_solve", "scheduler/solve_identity"}),
    "grid": (_grid_run, {"glm/grid_solve", "glm/grid_full_variances"}),
    "streaming": (_streaming_run, {"streaming/accumulate_value_grad",
                                   "streaming/accumulate_hessian_vector"}),
    "serving": (_serving_run, {"serve/score"}),
    "fused": (lambda: _fused_run(False), {"train/step"}),
    "fused_scheduled": (lambda: _fused_run(True), {"train/sched_scores", "train/sched_fe_solve",
                                                   "train/sched_loss",
                                                   "scheduler/solve_identity"}),
}

#: the pieces of a fused sweep the JAX package dispatches on their own only
#: in the scheduled sweep (inside "train/step" they are traced into its jit)
SWEEP_PIECES = {"train/sched_scores", "train/sched_fe_solve", "train/sched_fe_margin",
                "train/sched_re_score", "train/sched_offsets", "train/sched_loss"}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_outputs_are_bitwise_with_the_ledger_on_and_off(name, tmp_path):
    """The labelled programs observe and never gate: a GAME fit with
    variances, a scheduled fit, a λ grid with full variances, a streamed
    TRON solve and the resident scorer give the same bits with a ledger
    installed and without, and the ledger saw the expected labels."""
    make, labels = RUNS[name]
    run = make()
    plain = _flat(run())
    observed, ledger = _with_ledger(run, tmp_path)
    observed = _flat(observed)
    assert plain and len(plain) == len(observed)
    for a, b in zip(plain, observed):
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    assert labels <= set(ledger.labels())
    assert all(v["compiles"] == 0 for v in ledger.snapshot().values())


@pytest.mark.parametrize("scheduled", [False, True])
def test_fused_sweep_pieces_are_observed_where_they_are_dispatched(scheduled, tmp_path):
    """A plain fused sweep is one call under "train/step", its pieces part
    of it; the scheduled sweep runs no "train/step" and observes each piece
    under its "train/sched_*" label, and the RE solves under the
    scheduler's."""
    _, ledger = _with_ledger(_fused_run(scheduled), tmp_path)
    labels = set(ledger.labels())
    if scheduled:
        assert "train/step" not in labels and SWEEP_PIECES <= labels
        assert "scheduler/solve_identity" in labels and "train/sched_re_solve" not in labels
    else:
        assert labels == {"train/step"}
        assert ledger.snapshot()["train/step"]["calls"] == 2


def test_forecast_refeed_matches(tmp_path):
    """refeed_resident_forecast: None until a peak is known, then the
    resident bytes plus the label's temp bytes, journaled, in both
    packages."""
    out = []
    for pkg, reg_mod, journal_mod, sub in ((tl, treg, tj, "t"), (jl, jreg, jj, "j")):
        reg = reg_mod.MetricsRegistry()
        journal = journal_mod.RunJournal(tmp_path / sub)
        kw = {"analyze_cost": False} if pkg is jl else {}
        ledger = pkg.ProgramLedger(registry=reg, journal=journal, **kw)
        first = ledger.refeed_resident_forecast("serve/score")
        reg.gauge("xla/serve/score/temp_bytes").set(300)
        reg.gauge("serve/resident_params_bytes").set(700)
        second = ledger.refeed_resident_forecast("serve/score")
        journal.close()
        rows = [{k: v for k, v in r.items() if k not in STAMPS}
                for r in journal_mod.read_journal(tmp_path / sub / "run-journal.jsonl")
                if r["kind"] == "program_forecast_refeed"]
        out.append((first, second, rows, reg.gauge("xla/serve/score/hbm_forecast_bytes").value))
    assert out[0] == out[1] and out[0][1] == 1000


def test_probe_names_are_the_jax_packages():
    """The compile metrics and row kinds keep the JAX package's names."""
    assert (tp.COMPILE_COUNT_METRIC, tp.COMPILE_SECONDS_METRIC) == \
        (jp.COMPILE_COUNT_METRIC, jp.COMPILE_SECONDS_METRIC)
    assert (tl.COMPILE_ROW, tl.RECOMPILE_ROW, tl.SIGNATURE_ROW, tl.LEDGER_METRIC_PREFIX,
            tl.MAX_SIGNATURES_PER_LABEL) == \
        (jl.COMPILE_ROW, jl.RECOMPILE_ROW, jl.SIGNATURE_ROW, jl.LEDGER_METRIC_PREFIX,
         jl.MAX_SIGNATURES_PER_LABEL)
