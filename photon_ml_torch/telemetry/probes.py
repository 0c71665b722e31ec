"""Device and runtime probes: compile counts, device memory, marginal timing
(the port's own copy).

Counterpart of ``photon_ml_tpu/telemetry/probes.py``; the reference leaned on
the Spark UI for executor and runtime attribution. The measurement helpers
live here as a library:

- ``MarginalTimer`` / ``scan_step_marginal``: K_hi-vs-K_lo differencing that
  ends on a host read, so the fixed cost of a call cancels. On the card the
  K steps of ``scan_step_marginal`` are one captured CUDA graph, so the
  difference is device time.
- ``stream_calibration``: the same-run memory-speed probe (GB/s of one
  ``[n, d]`` matrix-vector read a step), so a kernel's rate is judged against
  this run's card.
- ``record_compile`` / ``install_compile_listener`` / ``CompileMonitor``:
  the compile counter and seconds histogram. There is no
  ``jax.monitoring`` in the port: a compile is recorded where the port makes
  one, and the names stay the JAX package's (``jax/backend_compile_count``,
  ``jax/backend_compile_seconds``) so one findings code reads both packages'
  journals. In the port a compile is an ``nvcc`` build of a ``csrc/*.cu``
  kernel source, a host-compiler build of a ``native/*.cpp`` library
  (``photon_ml_torch/build.py``), or one ``torch.cuda.CUDAGraph`` capture
  (``serving/resident.py``). A library that is already built is not a
  compile, and neither is an eager launch.
- ``live_buffer_bytes`` / ``device_memory_limit_bytes``: the caching
  allocator's bytes and the card's total memory. On an explicit CPU device
  torch keeps no allocator count, so both are None there.
"""

from __future__ import annotations

import dataclasses
import statistics
import threading
import time
from typing import Callable

import numpy as np

from photon_ml_torch.telemetry.registry import default_registry

#: median-of-K reps for gate metrics (single-shot numbers on a shared host
#: swing between back-to-back reps)
GATE_REPS = 3


def median_spread(measure_once: Callable[[], float], reps: int = GATE_REPS):
    """Run a marginal measurement ``reps`` times; return
    (median, [min, max]). The spread is the error bar of a comparison."""
    vals = [measure_once() for _ in range(reps)]
    return statistics.median(vals), [min(vals), max(vals)]


def read_scalar(x) -> float:
    """Host-read synchronization point: returns the first element of ``x``
    as a float. For a tensor this is ``.item()``, which waits for the
    device's stream to reach it."""
    item = getattr(x, "item", None)
    if item is not None and getattr(x, "numel", None) is not None:
        return float(x.reshape(-1)[0].item())
    return float(np.asarray(x).ravel()[0])


@dataclasses.dataclass
class MarginalResult:
    median: float  # marginal seconds per unit of work
    spread: list  # [min, max] across reps


@dataclasses.dataclass
class MarginalTimer:
    """K_hi-vs-K_lo marginal differencing over an arbitrary timed unit.

    ``measure(timed_k)`` calls ``timed_k(k)`` — which must run ``k`` units
    of work and return elapsed seconds, ending on a host read (use
    :func:`read_scalar`) — and returns the per-unit marginal
    ``(t(k_hi) - t(k_lo)) / (k_hi - k_lo)`` as a median-of-``reps`` with
    [min, max] spread. Differencing cancels the fixed per-call cost;
    ``k_hi - k_lo`` must be large enough that the work dwarfs its jitter."""

    k_lo: int = 1
    k_hi: int = 5
    reps: int = GATE_REPS
    floor: float = 1e-6

    def __post_init__(self):
        if self.k_hi <= self.k_lo:
            raise ValueError(f"k_hi ({self.k_hi}) must exceed k_lo ({self.k_lo})")

    def measure(self, timed_k: Callable[[int], float]) -> MarginalResult:
        def once() -> float:
            lo = timed_k(self.k_lo)
            hi = timed_k(self.k_hi)
            return max((hi - lo) / (self.k_hi - self.k_lo), self.floor)

        median, spread = median_spread(once, self.reps)
        return MarginalResult(median=median, spread=spread)


def scan_step_marginal(
    step_fn,
    operand,
    dim: int,
    *,
    k_lo: int = 16,
    k_hi: int = 256,
    reps: int = GATE_REPS,
    warmups: int = 4,
    rng=None,
) -> tuple[float, list]:
    """Marginal seconds per evaluation of ``step_fn(w, operand) -> (w', v)``.

    K evaluations run back to back, each consuming the previous carry (so
    no step can be skipped or hoisted), from a warm start perturbed a rep,
    and the timing ends on a host read. On a CUDA operand the K steps are
    captured once into a ``torch.cuda.CUDAGraph`` and replayed, so the
    K_hi-K_lo difference is device time; on the CPU they run eagerly.
    Returns ``(median, [min, max])`` like :func:`median_spread`."""
    import torch

    rng = np.random.default_rng(7) if rng is None else rng
    dev = operand.device

    def chain(w0, k):
        w, acc = w0, None
        for _ in range(k):
            w, v = step_fn(w, operand)
            acc = v if acc is None else acc + v
        return acc.sum() + w.sum()

    def timed(k: int) -> float:
        w_in = torch.zeros(dim, dtype=torch.float32, device=dev)
        if dev.type == "cuda":
            # warm the libraries the steps call on a side stream, then capture
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                chain(w_in, k)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = chain(w_in, k)

            def run():
                graph.replay()
                return out
        else:
            def run():
                return chain(w_in, k)
        read_scalar(run())
        best = None
        for _ in range(warmups):
            w_in.copy_(torch.from_numpy(rng.normal(size=dim).astype(np.float32) * 0.01))
            t0 = time.perf_counter()
            read_scalar(run())
            el = time.perf_counter() - t0
            best = el if best is None or el < best else best
        return best

    return median_spread(
        lambda: max((timed(k_hi) - timed(k_lo)) / (k_hi - k_lo), 1e-6), reps
    )


def stream_calibration(
    features,
    *,
    k_lo: int = 16,
    k_hi: int = 256,
    reps: int = GATE_REPS,
    rng=None,
) -> dict:
    """Same-run memory-speed calibration: achieved GB/s of one ``[n, d]``
    matrix-vector product that reads ``features`` once a step
    (``torch.matmul``, a calibration probe and not a kernel of the port).
    A hand kernel's bytes over its time, divided by this, says how near it
    runs to what this card streams in this run; a fraction above 1.0 is
    real (the probe is a library product, not the card's peak)."""
    import torch

    n, d = features.shape
    xbytes = n * d * features.element_size()

    def step(w, x):
        return w + torch.sum(x @ w) * 1e-30, torch.zeros((), dtype=torch.float32,
                                                           device=x.device)

    marginal, spread = scan_step_marginal(
        step, features, d, k_lo=k_lo, k_hi=k_hi, reps=reps, rng=rng
    )
    return {
        "gbps": xbytes / marginal / 1e9,
        "spread_gbps": [xbytes / s / 1e9 for s in spread[::-1]],
        "marginal_sec": marginal,
        "spread_sec": spread,
        "bytes_per_eval": xbytes,
        "n": int(n),
        "d": int(d),
    }


# --- compile events ---------------------------------------------------------

#: registry names of the compile counter and seconds histogram (the JAX
#: package's names): the program ledger takes scoped deltas of them and the
#: heartbeats snapshot the count
COMPILE_COUNT_METRIC = "jax/backend_compile_count"
COMPILE_SECONDS_METRIC = "jax/backend_compile_seconds"
#: bytes the caching allocator grew by across CUDA graph captures (the
#: graphs' memory pools); the ledger's memory analysis reads its delta
GRAPH_POOL_BYTES_METRIC = "cuda/graph_pool_bytes"
_COMPILE_COUNTER = COMPILE_COUNT_METRIC
_COMPILE_SECONDS = COMPILE_SECONDS_METRIC

#: registries fed by :func:`record_compile` besides the process registry
_sinks: dict[int, object] = {}
_sinks_lock = threading.Lock()


def install_compile_listener(registry=None) -> None:
    """Feed ``registry``'s compile counter and histogram from every later
    compile event. The process registry is always fed; idempotent per
    registry."""
    reg = registry or default_registry()
    with _sinks_lock:
        _sinks[id(reg)] = reg


def record_compile(seconds: float, *, pool_bytes: int | None = None) -> None:
    """One compile event of ``seconds`` (an ``nvcc`` or ``g++`` build, or a
    CUDA graph capture with the allocator growth ``pool_bytes`` of its
    pool) into the process registry and every installed one."""
    with _sinks_lock:
        regs = [default_registry(), *(r for r in _sinks.values()
                                      if r is not default_registry())]
    for reg in regs:
        reg.counter(_COMPILE_COUNTER).inc()
        reg.histogram(_COMPILE_SECONDS).observe(seconds)
        if pool_bytes is not None:
            reg.counter(GRAPH_POOL_BYTES_METRIC).inc(int(pool_bytes))


def compile_count(registry=None) -> int:
    """Compile events recorded into ``registry`` so far."""
    reg = registry or default_registry()
    return reg.counter(_COMPILE_COUNTER).value


class CompileMonitor:
    """``with CompileMonitor() as cm: ...; cm.count`` — compiles (and compile
    seconds) attributable to the enclosed block."""

    def __init__(self, registry=None):
        self.registry = registry or default_registry()
        # snapshot at construction too, so count/seconds are well-defined
        # even when read from a finally block after __enter__ failed
        self._count0 = self.registry.counter(_COMPILE_COUNTER).value
        self._secs0 = self.registry.histogram(_COMPILE_SECONDS).total

    def __enter__(self) -> "CompileMonitor":
        install_compile_listener(self.registry)
        self._count0 = self.registry.counter(_COMPILE_COUNTER).value
        self._secs0 = self.registry.histogram(_COMPILE_SECONDS).total
        return self

    def __exit__(self, *exc) -> bool:
        return False

    @property
    def count(self) -> int:
        return self.registry.counter(_COMPILE_COUNTER).value - self._count0

    @property
    def seconds(self) -> float:
        return self.registry.histogram(_COMPILE_SECONDS).total - self._secs0


def _device(device):
    from photon_ml_torch.device import resolve_device

    return resolve_device(device)


def live_buffer_bytes(device=None) -> "int | None":
    """Bytes the caching allocator holds for live tensors on the CUDA device
    (``torch.cuda.memory_allocated``). ``device=None`` is the CUDA device
    (``RuntimeError`` without one); an explicit CPU device gives None, since
    torch keeps no allocator count there."""
    import torch

    dev = _device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.memory_allocated(dev))


def device_memory_limit_bytes(device=None) -> "int | None":
    """The CUDA device's total memory (``torch.cuda.mem_get_info``), the
    budget the program ledger's memory forecast is judged against; None on
    an explicit CPU device."""
    import torch

    dev = _device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(dev)[1])
