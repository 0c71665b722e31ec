"""The port's resilience layer (``photon_ml_torch/resilience``) against the
JAX package's: the classifier on every reference case, the retry policy's
delays, and ``run_with_recovery``'s restart rules; plus the port-side
shapes (CUDA's sticky errors and NCCL's failures), each named and tested."""

import errno

import pytest

from photon_ml_tpu import resilience as jres
from photon_ml_tpu.io.checkpoint import DivergenceError as JDivergence
from photon_ml_torch import resilience as tres
from photon_ml_torch.io import checkpoint as tck
from photon_ml_torch.io.stream_reader import (
    ChunkPrefetcher,
    StreamDecodeError,
    TransientStreamDecodeError,
)
from photon_ml_torch.resilience import recovery

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds


def _reference_cases():
    """(id, factory) of every shape the JAX package's tests classify; a
    factory builds the same exception in either package's classes."""
    return [
        ("connection", lambda m: ConnectionError("x")),
        ("connection-reset", lambda m: ConnectionResetError("x")),
        ("timeout", lambda m: TimeoutError("x")),
        ("broken-pipe", lambda m: BrokenPipeError("x")),
        ("etimedout", lambda m: OSError(110, "Connection timed out")),
        ("eio", lambda m: OSError(errno.EIO, "Input/output error")),
        ("eagain", lambda m: OSError(errno.EAGAIN, "try again")),
        ("enoent", lambda m: FileNotFoundError(errno.ENOENT, "missing")),
        ("forced", lambda m: m.TransientError("forced")),
        ("unavailable", lambda m: RuntimeError("UNAVAILABLE: socket closed")),
        ("deadline", lambda m: RuntimeError("DEADLINE_EXCEEDED while fetching")),
        ("value", lambda m: ValueError("bad shape")),
        ("key", lambda m: KeyError("missing")),
        ("exploded", lambda m: RuntimeError("something exploded")),
        ("413", lambda m: ConnectionError("tunnel returned HTTP 413 payload too large")),
        ("port-41352", lambda m: RuntimeError(
            "UNAVAILABLE: ipv4:10.0.0.2:41352: connection reset")),
        ("xla-oom", lambda m: RuntimeError(
            "RESOURCE_EXHAUSTED: Out of memory while trying to allocate 1.2GiB")),
        ("quota", lambda m: RuntimeError("RESOURCE_EXHAUSTED: quota exceeded for resource")),
        ("invalid-argument", lambda m: RuntimeError("INVALID_ARGUMENT: shapes differ")),
        ("exchange-timeout", lambda m: m.ExchangeTimeout("tag", missing_ranks=[1], timeout=2)),
        ("peer-abort", lambda m: m.PeerAbort("tag", origin_rank=1, cause="preempted")),
        ("device-lost", lambda m: RuntimeError("INTERNAL: device lost during execution")),
        ("preempted", lambda m: RuntimeError("worker has been preempted")),
        ("wrapped-preemption", lambda m: RuntimeError(
            "streaming epoch failed decoding chunk 3: RuntimeError: device is lost")),
        ("socket-closed", lambda m: RuntimeError("INTERNAL: Socket closed")),
        ("oom-device", lambda m: RuntimeError("out of memory on device lost")),
        ("interrupted", lambda m: InterruptedError("x")),
        ("timed-out", lambda m: RuntimeError("the request timed out")),
    ]


CASES = _reference_cases()


@pytest.mark.parametrize("make", [c[1] for c in CASES], ids=[c[0] for c in CASES])
def test_classifier_matches_the_reference(make):
    jexc, texc = make(jres), make(tres)
    assert tres.classify_exception(texc).value == jres.classify_exception(jexc).value
    assert tres.is_transient(texc) == jres.is_transient(jexc)
    assert tres.is_preemption(texc) == jres.is_preemption(jexc)
    assert (tres.fatal_hint(texc) is None) == (jres.fatal_hint(jexc) is None)


#: CUDA's sticky errors in the words torch's RuntimeError carries them
CUDA_STICKY = [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: device-side assert triggered\nCUDA kernel errors might be asynchronously "
    "reported",
    "CUDA error: unspecified launch failure",
    "CUDA error: the launch timed out and was terminated",
    "CUDA error: misaligned address",
    "CUDA error: an illegal instruction was encountered",
    "CUDA error: hardware stack error",
    "CUDA error: uncorrectable ECC error encountered",
    "CUDA error: no CUDA-capable device is detected",
    "CUDA driver version is insufficient for CUDA runtime version",
]


@pytest.mark.parametrize("message", CUDA_STICKY, ids=[m.split(": ")[-1][:32] for m in CUDA_STICKY])
def test_cuda_sticky_errors_are_fatal_with_a_hint(message):
    exc = RuntimeError(message)
    assert tres.classify_exception(exc) is tres.Transience.FATAL
    assert not tres.is_preemption(exc)
    assert "sticky CUDA error" in tres.fatal_hint(exc)


def test_launch_timeout_is_fatal_where_the_reference_pattern_would_retry():
    """The reference's ``timed? ?out`` matches the launch timeout: the port
    tests the sticky patterns first."""
    message = "CUDA error: the launch timed out and was terminated"
    assert jres.classify_exception(RuntimeError(message)) is jres.Transience.TRANSIENT
    assert tres.classify_exception(RuntimeError(message)) is tres.Transience.FATAL


def test_cuda_out_of_memory_is_fatal():
    torch = pytest.importorskip("torch")
    exc = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    assert tres.classify_exception(exc) is tres.Transience.FATAL
    assert "OOM" in tres.fatal_hint(exc)


NCCL = [
    ("NCCL error in: ProcessGroupNCCL.cpp:1, unhandled system error (run with NCCL_DEBUG=INFO "
     "for details), NCCL version 2.21.5\nncclSystemError: System call failed", "transient"),
    ("NCCL error: remote process exited or there was a network error, ncclRemoteError",
     "transient"),
    ("NCCL communicator was aborted on rank 1", "transient"),
    ("Watchdog caught collective operation timeout: WorkNCCL(SeqNum=7, OpType=ALLREDUCE)",
     "transient"),
    ("NCCL error in: ProcessGroupNCCL.cpp:1, invalid usage (run with NCCL_DEBUG=WARN for "
     "details)\nncclInvalidUsage: This usually reflects invalid usage of NCCL library.",
     "fatal"),
    ("ncclInvalidArgument: Invalid value for an argument.", "fatal"),
]


@pytest.mark.parametrize("message,verdict", NCCL, ids=[f"nccl-{i}" for i in range(len(NCCL))])
def test_nccl_errors(message, verdict):
    assert tres.classify_exception(RuntimeError(message)).value == verdict


@pytest.mark.parametrize("name", ["default_io_policy", "default_dispatch_policy",
                                  "default_kv_policy"])
def test_retry_delays_match_the_reference(name):
    jp, tp = getattr(jres, name)(), getattr(tres, name)()
    for attempt in range(6):
        for key in ("", "decode chunk 3", "kv/get"):
            assert tp.delay(attempt, key) == jp.delay(attempt, key)


def test_retry_policy_retries_transient_only():
    sleeps = []
    policy = tres.RetryPolicy(max_attempts=3, sleep=sleeps.append)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError(errno.EIO, "flaky")
        return 42

    assert policy.call(flaky) == 42 and len(sleeps) == 2
    with pytest.raises(RuntimeError):
        policy.call(lambda: (_ for _ in ()).throw(RuntimeError(CUDA_STICKY[0])))
    assert len(sleeps) == 2  # the sticky error burned no retry
    before = recovery.counts["giveups"]
    with pytest.raises(TimeoutError):
        policy.call(lambda: (_ for _ in ()).throw(TimeoutError("t")))
    assert recovery.counts["giveups"] == before + 1


class _Ckpt:
    def __init__(self, step):
        self.step = step

    def latest_step(self):
        return self.step


@pytest.mark.parametrize("error,checkpoint,max_restarts", [
    ("transient", None, 2), ("preemption", None, 2), ("divergence", 4, 2),
    ("divergence", None, 2), ("fatal", 4, 2), ("cuda", 4, 2), ("transient", None, 1),
], ids=["transient", "preemption", "divergence-with-checkpoint", "divergence-alone", "fatal",
        "cuda-sticky", "budget"])
def test_run_with_recovery_matches_the_reference(error, checkpoint, max_restarts):
    """Both packages restart (or give up on) the same failures the same
    number of times."""
    def make(m, divergence):
        return {"transient": lambda: OSError(errno.EIO, "flaky"),
                "preemption": lambda: RuntimeError("worker has been preempted"),
                "divergence": lambda: divergence("NaN"),
                "fatal": lambda: ValueError("bad"),
                "cuda": lambda: RuntimeError(CUDA_STICKY[0])}[error]()

    outcomes = []
    for mod, div in ((jres, JDivergence), (tres, tck.DivergenceError)):
        attempts = []

        def fn(restart, mod=mod, div=div, attempts=attempts):
            attempts.append(restart)
            if len(attempts) <= 2:
                raise make(mod, div)
            return "done"

        try:
            result = mod.run_with_recovery(fn, max_restarts=max_restarts,
                                           checkpointer=_Ckpt(checkpoint))
        except Exception as e:  # the outcome compared below
            result = type(e).__name__
        outcomes.append((result, attempts))
    assert outcomes[1] == outcomes[0]


def test_recovery_counts_restarts_and_preemptions():
    recovery.reset_counts()
    state = {"n": 0}

    def fn(restart):
        state["n"] += 1
        if state["n"] == 1:
            raise RuntimeError("INTERNAL: device lost")
        return restart

    assert tres.run_with_recovery(fn, max_restarts=2) == 1
    assert recovery.counts["retries"] == 1 and recovery.counts["preemptions"] == 1


def test_coordinated_recovery_waits_for_step_2():
    """Coordinated recovery is ported (``resilience/coordinated.py``): a
    coordinator's budget replaces ``max_restarts`` and a one-rank run
    restarts through its rendezvous (``tests/test_torch_coordinated.py``
    holds the multi-rank cases)."""
    from photon_ml_torch.parallel.multihost import SingleProcessExchange

    coord = tres.CoordinatedRecovery(SingleProcessExchange(), max_restarts=1)
    calls = []

    def fn(restart):
        calls.append(restart)
        if restart == 0:
            raise RuntimeError("INTERNAL: device lost")
        return restart

    assert tres.run_with_recovery(fn, max_restarts=0, coordinator=coord) == 1
    assert calls == [0, 1] and coord.generation == 1 and coord.resume_step == 0


class _FailingSource:
    specs = []

    def __init__(self, exc):
        from photon_ml_torch.io.stream_reader import ChunkSpec

        self.exc = exc
        self.specs = [ChunkSpec(index=0, num_records=4)]

    def load(self, spec):
        raise self.exc


@pytest.mark.parametrize("prefetch", [True, False], ids=["prefetch", "inline"])
@pytest.mark.parametrize("cause,transient", [(OSError(errno.EIO, "flaky"), True),
                                             (ValueError("corrupt block"), False)],
                         ids=["eio", "corrupt"])
def test_stream_decode_errors_keep_their_cause_class(prefetch, cause, transient):
    """A decode failure that survives the retry policy reaches the consumer
    attributed to its chunk; a transient cause keeps the wrapper transient
    (the port-side shape ``run_with_recovery`` restarts on)."""
    policy = tres.RetryPolicy(max_attempts=1)
    with pytest.raises(StreamDecodeError, match="chunk 0") as e:
        with ChunkPrefetcher(_FailingSource(cause), prefetch=prefetch,
                             retry_policy=policy) as chunks:
            list(chunks)
    assert isinstance(e.value, TransientStreamDecodeError) == transient
    assert tres.is_transient(e.value) == transient
