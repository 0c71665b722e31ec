"""The port's device and runtime probes (``photon_ml_torch/telemetry/probes.py``)
against the JAX package's, on the CPU.

``median_spread`` and ``MarginalTimer`` on a deterministic fake timer are
equal; ``read_scalar`` reads the same value from a tensor as from a JAX
array; the compile counter and ``CompileMonitor`` count what the port
records (``record_compile``: a kernel or host-library build, a CUDA graph
capture), and a host library's ``g++`` build records one compile;
``stream_calibration`` returns the JAX package's keys. One named difference:
on an explicit CPU device the port's ``live_buffer_bytes`` and
``device_memory_limit_bytes`` are None (torch keeps no allocator count
there), where the JAX package sums its live arrays.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.telemetry import journal as tj
from photon_ml_torch.telemetry import probes as tp
from photon_ml_torch.telemetry import registry as treg
from photon_ml_tpu.telemetry import journal as jj
from photon_ml_tpu.telemetry import probes as jp
from photon_ml_tpu.telemetry import registry as jreg

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds


def _fake(values):
    it = itertools.cycle(values)
    return lambda *_: next(it)


@pytest.mark.parametrize("reps", [1, 3, 4])
def test_median_spread_matches(reps):
    values = [0.5, 0.125, 2.0, 0.75, 1.5]
    assert tp.median_spread(_fake(values), reps) == jp.median_spread(_fake(values), reps)
    assert tp.GATE_REPS == jp.GATE_REPS


@pytest.mark.parametrize("k_lo,k_hi,floor", [(1, 5, 1e-6), (16, 256, 1e-6), (2, 3, 0.5)])
def test_marginal_timer_matches(k_lo, k_hi, floor):
    """The same fake timer (seconds a function of k, with a step that makes
    one difference negative) gives the same marginals, spreads and floors."""
    def timed(base):
        calls = itertools.count()
        return lambda k: base + 0.01 * k + (0.3 if next(calls) % 5 == 3 else 0.0)

    t = tp.MarginalTimer(k_lo=k_lo, k_hi=k_hi, floor=floor).measure(timed(0.2))
    j = jp.MarginalTimer(k_lo=k_lo, k_hi=k_hi, floor=floor).measure(timed(0.2))
    assert (t.median, t.spread) == (j.median, j.spread)
    with pytest.raises(ValueError, match="must exceed"):
        tp.MarginalTimer(k_lo=3, k_hi=3)


def test_read_scalar_matches():
    x = np.array([[2.5, 1.0], [3.0, 4.0]])
    assert tp.read_scalar(torch.as_tensor(x)) == jp.read_scalar(jnp.asarray(x)) == 2.5
    assert tp.read_scalar(x[1]) == jp.read_scalar(x[1]) == 3.0
    assert tp.read_scalar(torch.tensor(7)) == 7.0


def test_compile_monitor_counts_recorded_compiles():
    """record_compile feeds the process registry and every installed one;
    CompileMonitor counts the events and seconds of its block."""
    reg = treg.MetricsRegistry()
    before = tp.compile_count()
    with tp.CompileMonitor(reg) as cm:
        tp.record_compile(0.5)
        tp.record_compile(0.25, pool_bytes=1024)
    assert cm.count == 2 and cm.seconds == 0.75
    assert tp.compile_count(reg) == 2 and tp.compile_count() - before == 2
    assert reg.counter(tp.GRAPH_POOL_BYTES_METRIC).value == 1024
    tp.record_compile(1.0)
    assert cm.count == 3  # the monitor's registry stays fed after its block


def test_host_library_build_is_one_compile(tmp_path, monkeypatch):
    """A g++ build of a native library records one compile of its seconds;
    loading a library that is already built records none."""
    from photon_ml_torch import build

    monkeypatch.setattr(build, "HOST_BUILD_DIR", tmp_path)
    out = build.host_library_path("libsvm_loader")
    assert out.parent == tmp_path and not out.exists()
    with tp.CompileMonitor() as cm:
        build._build_host("libsvm_loader", out)
    assert out.exists() and cm.count == 1 and cm.seconds > 0
    monkeypatch.setattr(build, "_HOST_LOADED", {})
    with tp.CompileMonitor() as cm:
        build.load_host("libsvm_loader", lambda lib: None)
    assert cm.count == 0


def test_heartbeat_compiles_field_matches(tmp_path):
    """A heartbeat carries the absolute compile count where the registry
    has the counter, in both packages (``hbm_bytes`` apart: the JAX
    package's live arrays on the CPU)."""
    rows = []
    for reg_mod, journal_mod, sub in ((treg, tj, "t"), (jreg, jj, "j")):
        reg = reg_mod.MetricsRegistry()
        journal = journal_mod.RunJournal(tmp_path / sub)
        journal.heartbeat(registry=reg, sweep=0)
        reg.counter("jax/backend_compile_count").inc(3)
        journal.heartbeat(registry=reg, sweep=1)
        journal.close()
        rows.append([{k: v for k, v in r.items() if k not in ("seq", "ts", "elapsed_ms",
                                                              "hbm_bytes")}
                     for r in journal_mod.read_journal(tmp_path / sub / "run-journal.jsonl")
                     if r["kind"] == "heartbeat"])
    assert rows[0] == rows[1]
    assert "compiles" not in rows[0][0] and rows[0][1]["compiles"] == 3


def test_device_memory_probes_on_the_cpu():
    """The named CPU difference: None on an explicit CPU device (the JAX
    package reports its live arrays' bytes there); without a CUDA device,
    device=None raises as every entry point does."""
    assert tp.live_buffer_bytes("cpu") is None
    assert tp.device_memory_limit_bytes("cpu") is None
    assert isinstance(jp.live_buffer_bytes(), int)
    assert jp.device_memory_limit_bytes() is None
    if not torch.cuda.is_available():
        for probe in (tp.live_buffer_bytes, tp.device_memory_limit_bytes):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                probe()


def test_stream_calibration_keys_and_bytes():
    """stream_calibration on a small CPU block: the JAX package's keys, the
    block's bytes a step, a positive rate and a spread that brackets it."""
    x = np.random.default_rng(0).normal(size=(512, 16)).astype(np.float32)
    t = tp.stream_calibration(torch.as_tensor(x), k_lo=2, k_hi=6, reps=1)
    j = jp.stream_calibration(jnp.asarray(x), k_lo=2, k_hi=6, reps=1)
    assert set(t) == set(j)
    assert t["bytes_per_eval"] == j["bytes_per_eval"] == x.nbytes
    assert (t["n"], t["d"]) == (j["n"], j["d"]) == (512, 16)
    assert t["gbps"] > 0 and t["spread_gbps"][0] <= t["gbps"] <= t["spread_gbps"][1]


def test_scan_step_marginal_consumes_the_carry():
    """Each step consumes the carry: the chain of K steps is what is timed
    (the step counts its calls), and the result is (median, [min, max])."""
    calls = []

    def step(w, op):
        calls.append(1)
        return w + op.sum() * 1e-30, torch.zeros(())

    median, spread = tp.scan_step_marginal(step, torch.ones(4, 3), 3, k_lo=1, k_hi=3,
                                           reps=1, warmups=2)
    assert spread[0] <= median <= spread[1]
    # per k: one unmeasured run and `warmups` timed runs
    assert len(calls) == (1 + 2) * (1 + 3)
