"""Program ledger: per-label compile and memory accounting with recompile
attribution (the port's own copy).

Counterpart of ``photon_ml_tpu/telemetry/program_ledger.py``; no reference
analogue (the reference observed Spark tasks). The port's hot programs are a
bounded set of labelled functions (the solvers a coordinate runs, the fused
step, the streamed accumulators, the resident scorer), and the ledger
observes each labelled call.

The JAX package's names stay, so one findings code (``telemetry/verdicts``)
reads both packages' journals: rows ``program_compile``,
``program_recompile`` and ``program_signature``, metrics ``xla/<label>/…``,
the compile counter ``jax/backend_compile_count``. In the port they mean
what the port compiles: an ``nvcc`` build of a kernel source, a host
library build, or a ``torch.cuda.CUDAGraph`` capture (``telemetry/probes``
records each), never an XLA compile.

- ``ledger_call(fn, label=...)`` (the counterpart of ``ledger_jit``) wraps a
  function under a stable label. With no ledger installed a call costs one
  global read and a passthrough call; with one installed, every labelled
  call that is not inside another is an observation. It observes and never gates: the same arguments
  in the same order, no device synchronization.
- **Compile detection is a scoped delta of the compile counter** around the
  call: a graph capture or a kernel build inside it is that label's
  compile. A labelled call made while another runs on the same thread (a
  labelled solve inside a labelled step) is not observed on its own, as a
  ``ledger_jit`` call made while a JAX trace is in flight is inlined into
  the outer program: the outer label counts what it compiled.
- **Signatures** record every tensor or array leaf's shape, dtype (numpy's
  name: ``float32``) and the tensor's device string in the ``sharding``
  slot, weak-typed Python scalars (whose value is not part of the
  signature) and static arguments (by value for simple types, by type and
  hash otherwise). Dicts (keys sorted), lists, tuples, named tuples and
  dataclasses are flattened with the JAX package's leaf paths
  (``arg0.features``); ``None`` is no leaf, and neither is a dataclass
  field that takes no part in equality (``compare=False``: a cache). A
  ``torch.dtype`` is described by its numpy name.
- **Recompile attribution**: a compile under a label that already compiled
  diffs the new signature against the last compiled one and journals the
  differing leaves ("arg0.fixed/values: shape (1024,) -> (2048,) at
  serve/score").
- **Cost analysis** has no counterpart (eager torch has no HLO to analyse):
  ``cost`` is always None.
- **Memory analysis** stays opt-in (``analyze_memory=True``), because it
  alone may synchronize (it reads the card's total memory): for a labelled
  call that captured a graph it reports the allocator's growth over the
  capture (the graph's pool) as ``temp_size_in_bytes``, and the forecast is
  the resident parameters (the ``serve/resident_params_bytes`` gauge, else
  the live allocator bytes) plus those bytes, against
  ``probes.device_memory_limit_bytes``.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import threading

import numpy as np

logger = logging.getLogger(__name__)

#: registry namespace for every per-label metric the ledger emits
LEDGER_METRIC_PREFIX = "xla/"

#: journal row kinds
COMPILE_ROW = "program_compile"
RECOMPILE_ROW = "program_recompile"
SIGNATURE_ROW = "program_signature"

#: signatures retained per label for diffing; the oldest fall off
MAX_SIGNATURES_PER_LABEL = 64

# ---------------------------------------------------------------------------
# Signatures
# ---------------------------------------------------------------------------

#: leaf kinds
ARRAY = "array"
WEAK = "weak"
STATIC = "static"


def _describe_static(v) -> str:
    """Stable description of a static argument: simple values by repr, rich
    objects by type and hash (a default identity hash means a fresh
    instance is a new entry, and the ledger says so)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return repr(v)
    if type(v).__module__ == "torch" and type(v).__name__ == "dtype":
        return _dtype_name(v)
    if isinstance(v, tuple):
        return "(" + ", ".join(_describe_static(x) for x in v) + ")"
    try:
        h = hash(v)
    except TypeError:
        return f"{type(v).__qualname__}@{id(v):#x}"
    return f"{type(v).__qualname__}#{h}"


def _dtype_name(dtype) -> str:
    """numpy's name of a dtype (``torch.float32`` -> ``float32``)."""
    return str(dtype).removeprefix("torch.")


def _describe_leaf(v) -> tuple:
    shape = getattr(v, "shape", None)
    dtype = getattr(v, "dtype", None)
    if shape is not None and dtype is not None:
        device = getattr(v, "device", None)
        return (
            ARRAY,
            tuple(int(s) for s in shape),
            _dtype_name(dtype),
            None if device is None or isinstance(v, np.ndarray) else str(device),
        )
    if isinstance(v, (bool, int, float, complex)):
        # a weak-typed scalar: its value is not part of the signature
        return (WEAK, type(v).__name__)
    return (STATIC, _describe_static(v))


def _flatten(v, path: tuple, out: list) -> None:
    """(path, leaf) pairs in the JAX package's tree order: dict keys sorted,
    sequences by index, named tuples and dataclasses by field name (their
    ``compare=False`` caches left out), None dropped."""
    if v is None:
        return
    if isinstance(v, dict):
        for k in sorted(v):
            _flatten(v[k], path + (str(k),), out)
    elif isinstance(v, tuple) and hasattr(v, "_fields"):
        for name in v._fields:
            _flatten(getattr(v, name), path + (name,), out)
    elif isinstance(v, (list, tuple)):
        for i, x in enumerate(v):
            _flatten(x, path + (str(i),), out)
    elif dataclasses.is_dataclass(v) and not isinstance(v, type):
        for f in dataclasses.fields(v):
            if not f.compare:
                continue  # a cache, not part of the value
            _flatten(getattr(v, f.name), path + (f.name,), out)
    else:
        out.append((".".join(path), v))


@dataclasses.dataclass(frozen=True)
class ProgramSignature:
    """One call's argument signature: dynamic leaves (path -> description)
    and static arguments (name -> description)."""

    leaves: tuple  # ((path, desc-tuple), ...)
    static: tuple  # ((name, description), ...)

    @property
    def key(self):
        return (self.leaves, self.static)

    def to_json(self) -> dict:
        return {
            "leaves": [
                {"path": p, "kind": d[0],
                 **({"shape": list(d[1]), "dtype": d[2], "sharding": d[3]}
                    if d[0] == ARRAY else {"value": d[1]})}
                for p, d in self.leaves
            ],
            "static": [{"name": n, "value": s} for n, s in self.static],
        }


def build_signature(args, kwargs, static_argnums=(), static_argnames=()) -> ProgramSignature:
    dyn: dict = {}
    statics: list = []
    nums = set(static_argnums or ())
    names = set(static_argnames or ())
    for i, a in enumerate(args):
        if i in nums:
            statics.append((f"arg{i}", _describe_static(a)))
        else:
            dyn[f"arg{i}"] = a
    for k, v in kwargs.items():
        if k in names:
            statics.append((k, _describe_static(v)))
        else:
            dyn[k] = v
    flat: list = []
    _flatten(dyn, (), flat)
    leaves = tuple((path, _describe_leaf(leaf)) for path, leaf in flat)
    return ProgramSignature(leaves=leaves, static=tuple(sorted(statics)))


_ARRAY_FIELDS = (("shape", 1), ("dtype", 2), ("sharding", 3))


def diff_signatures(old: ProgramSignature, new: ProgramSignature) -> list[dict]:
    """The differing leaves between two signatures, the attribution a
    recompile row carries. Each change names the leaf path, the field
    (shape/dtype/sharding/kind/presence/static) and old -> new values."""
    changes: list[dict] = []
    o, n = dict(old.leaves), dict(new.leaves)
    for path in sorted(o.keys() | n.keys()):
        a, b = o.get(path), n.get(path)
        if a == b:
            continue
        if a is None or b is None:
            changes.append({"leaf": path, "field": "presence",
                            "old": None if a is None else list(a),
                            "new": None if b is None else list(b)})
            continue
        if a[0] != b[0]:
            changes.append({"leaf": path, "field": "kind",
                            "old": a[0], "new": b[0]})
            continue
        if a[0] == ARRAY:
            for field, idx in _ARRAY_FIELDS:
                if a[idx] != b[idx]:
                    changes.append({
                        "leaf": path, "field": field,
                        "old": list(a[idx]) if field == "shape" else a[idx],
                        "new": list(b[idx]) if field == "shape" else b[idx],
                    })
        else:
            changes.append({"leaf": path, "field": a[0],
                            "old": a[1], "new": b[1]})
    os_, ns_ = dict(old.static), dict(new.static)
    for name in sorted(os_.keys() | ns_.keys()):
        if os_.get(name) != ns_.get(name):
            changes.append({"leaf": name, "field": "static",
                            "old": os_.get(name), "new": ns_.get(name)})
    return changes


def diff_summary(changes: list[dict], limit: int = 4) -> str:
    """One human line per recompile row: 'leaf: field old -> new; ...'."""
    if not changes:
        return ("signature identical to the previous compile — a fresh "
                "program instance or an evicted executable recompiled the "
                "same shapes")
    parts = [
        f"{c['leaf']}: {c['field']} {c['old']} -> {c['new']}"
        for c in changes[:limit]
    ]
    if len(changes) > limit:
        parts.append(f"(+{len(changes) - limit} more)")
    return "; ".join(parts)


# ---------------------------------------------------------------------------
# The ledger
# ---------------------------------------------------------------------------


class _LabelRecord:
    __slots__ = ("signatures", "order", "last_compiled", "calls", "compiles",
                 "recompiles", "distinct")

    def __init__(self):
        self.signatures: dict = {}  # key -> ProgramSignature
        self.order: list = []  # keys, oldest first (bounded eviction)
        self.last_compiled: ProgramSignature | None = None
        self.calls = 0
        self.compiles = 0
        self.recompiles = 0
        #: monotone distinct-signature count: the diff cache's eviction
        #: never lowers it
        self.distinct = 0


class ProgramLedger:
    """Per-label compile and memory accounting over ``ledger_call`` sites.

    registry: metrics sink (default: the process registry) —
    ``xla/<label>/{calls,compiles,recompiles}`` counters,
    ``xla/<label>/compile_seconds`` histogram, ``xla/<label>/{signatures,
    temp_bytes,peak_bytes,hbm_forecast_bytes}`` gauges. journal: optional
    RunJournal — compile, recompile and signature rows land there (inert on
    ranks > 0, the journal's own rule). There is no cost analysis (eager
    torch has no HLO), so a row's ``cost`` is None. analyze_memory: opt-in
    graph-pool bytes and forecast (it reads the card's total memory).
    """

    def __init__(self, *, registry=None, journal=None,
                 analyze_memory: bool = False,
                 max_signatures: int = MAX_SIGNATURES_PER_LABEL):
        from photon_ml_torch.telemetry.registry import default_registry

        self.registry = registry or default_registry()
        self.journal = journal
        self.analyze_memory = bool(analyze_memory)
        self.max_signatures = int(max_signatures)
        #: free-form run phase ("warm"/"replay"/...) stamped on rows
        self.phase: str | None = None
        self._labels: dict[str, _LabelRecord] = {}
        self._lock = threading.Lock()

    # -- introspection -------------------------------------------------------

    def set_phase(self, phase: str | None) -> None:
        self.phase = phase

    def labels(self) -> list[str]:
        with self._lock:
            return sorted(self._labels)

    def signature_count(self, label: str) -> int:
        """Distinct signatures observed under ``label`` (monotone)."""
        with self._lock:
            rec = self._labels.get(label)
            return 0 if rec is None else rec.distinct

    def snapshot(self) -> dict:
        """{label: {calls, compiles, recompiles, signatures}}."""
        with self._lock:
            return {
                label: {
                    "calls": rec.calls,
                    "compiles": rec.compiles,
                    "recompiles": rec.recompiles,
                    "signatures": rec.distinct,
                }
                for label, rec in sorted(self._labels.items())
            }

    # -- observation ---------------------------------------------------------

    def _metric(self, label: str, name: str) -> str:
        return f"{LEDGER_METRIC_PREFIX}{label}/{name}"

    def observed_call(self, fn, label: str, args, kwargs,
                      static_argnums=(), static_argnames=()):
        """Call ``fn(*args, **kwargs)`` under observation. The call itself is
        untouched; everything else is host bookkeeping, recorded on success
        and failure."""
        from photon_ml_torch.telemetry import probes

        probes.install_compile_listener(self.registry)
        sig = build_signature(args, kwargs, static_argnums, static_argnames)
        with self._lock:
            rec = self._labels.setdefault(label, _LabelRecord())
            is_new = sig.key not in rec.signatures
        counter = self.registry.counter(probes.COMPILE_COUNT_METRIC)
        seconds = self.registry.histogram(probes.COMPILE_SECONDS_METRIC)
        pool = (self.registry.counter(probes.GRAPH_POOL_BYTES_METRIC)
                if self.analyze_memory else None)
        c0, s0 = counter.value, seconds.total
        p0 = 0 if pool is None else pool.value
        error = None
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            error = type(e).__name__
            raise
        finally:
            compiles = counter.value - c0
            pool_bytes = 0 if pool is None else pool.value - p0
            analysis = (self._analyze(pool_bytes)
                        if is_new or compiles > 0 else None)
            self._record(
                label, sig, is_new, analysis,
                compiles=compiles,
                compile_seconds=seconds.total - s0,
                error=error,
            )

    def _analyze(self, pool_bytes: int) -> dict:
        """The call's memory analysis, when opted in: the graph pools its
        captures grew (``temp_size_in_bytes``), the forecast and the card's
        total memory. ``cost`` has no counterpart and stays None."""
        from photon_ml_torch.telemetry import probes

        out: dict = {"cost": None, "memory": None, "hbm_forecast_bytes": None,
                     "device_bytes_limit": None}
        if not self.analyze_memory or pool_bytes <= 0:
            return out
        out["memory"] = {"temp_size_in_bytes": int(pool_bytes)}
        resident = self._resident_bytes()
        if resident is not None:
            out["hbm_forecast_bytes"] = int(resident) + int(pool_bytes)
        import torch

        if torch.cuda.is_available():
            out["device_bytes_limit"] = probes.device_memory_limit_bytes()
        return out

    def refeed_resident_forecast(self, label: str) -> int | None:
        """Recompute ``xla/<label>/hbm_forecast_bytes`` from the current
        resident parameter bytes plus the label's recorded peak (a hot swap
        captures nothing, so without this the gauge would price the old
        model). Returns the new forecast, or None when either input is
        unknown; journals a ``program_forecast_refeed`` row."""
        peak = self.registry.gauge(self._metric(label, "peak_bytes")).value
        if peak is None:
            peak = self.registry.gauge(self._metric(label, "temp_bytes")).value
        resident = self._resident_bytes()
        if peak is None or resident is None:
            return None
        forecast = int(resident) + int(peak)
        self.registry.gauge(
            self._metric(label, "hbm_forecast_bytes")
        ).set(forecast)
        if self.journal is not None:
            self.journal.record(
                "program_forecast_refeed", label=label, phase=self.phase,
                resident_bytes=int(resident), peak_bytes=int(peak),
                hbm_forecast_bytes=forecast,
            )
        return forecast

    def _resident_bytes(self) -> int | None:
        """Resident parameter bytes: the resident scorer's gauge when it is
        fed, else the live allocator bytes (None without a CUDA device)."""
        from photon_ml_torch.telemetry import serving_counters

        gauge = self.registry.gauge(
            serving_counters.RESIDENT_PARAMS_BYTES
        ).value
        if gauge is not None:
            return int(gauge)
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        from photon_ml_torch.telemetry.probes import live_buffer_bytes

        return live_buffer_bytes()

    def _record(self, label: str, sig: ProgramSignature, is_new: bool,
                analysis: dict | None, *, compiles: int,
                compile_seconds: float, error: str | None) -> None:
        reg = self.registry
        with self._lock:
            rec = self._labels[label]
            rec.calls += 1
            prior = rec.last_compiled
            if prior is None:
                # the program may have compiled before this ledger was
                # installed: attribute against the most recent other
                # signature rather than dropping the diff
                for key in reversed(rec.order):
                    if key != sig.key:
                        prior = rec.signatures[key]
                        break
            if is_new and sig.key not in rec.signatures:
                rec.distinct += 1
                rec.signatures[sig.key] = sig
                rec.order.append(sig.key)
                while len(rec.order) > self.max_signatures:
                    del rec.signatures[rec.order.pop(0)]
            if compiles > 0:
                rec.compiles += compiles
                rec.last_compiled = sig
                if prior is not None:
                    rec.recompiles += 1
            num_signatures = rec.distinct
            recompiled = compiles > 0 and prior is not None
        reg.counter(self._metric(label, "calls")).inc()
        reg.gauge(self._metric(label, "signatures")).set(num_signatures)
        if compiles <= 0:
            if is_new and self.journal is not None:
                # observed without a compile (built or captured before):
                # still a row, so the ledger table covers the label
                self.journal.record(
                    SIGNATURE_ROW, label=label, phase=self.phase,
                    signature=sig.to_json(),
                    cost=None if analysis is None else analysis["cost"],
                )
            return
        reg.counter(self._metric(label, "compiles")).inc(compiles)
        reg.histogram(self._metric(label, "compile_seconds")).observe(
            compile_seconds
        )
        if recompiled:
            reg.counter(self._metric(label, "recompiles")).inc()
        cost = memory = forecast = limit = None
        if analysis is not None:
            cost = analysis["cost"]
            memory = analysis["memory"]
            forecast = analysis["hbm_forecast_bytes"]
            limit = analysis["device_bytes_limit"]
            if memory is not None:
                for attr, name in (("temp_size_in_bytes", "temp_bytes"),
                                   ("peak_memory_in_bytes", "peak_bytes"),
                                   ("argument_size_in_bytes",
                                    "argument_bytes"),
                                   ("output_size_in_bytes", "output_bytes")):
                    if attr in memory:
                        reg.gauge(self._metric(label, name)).set(memory[attr])
            if forecast is not None:
                reg.gauge(
                    self._metric(label, "hbm_forecast_bytes")
                ).set(forecast)
        if self.journal is None:
            return
        if recompiled:
            changes = diff_signatures(prior, sig)
            self.journal.record(
                RECOMPILE_ROW, label=label, phase=self.phase,
                changed=changes, summary=diff_summary(changes),
                compiles=compiles,
                compile_seconds=round(compile_seconds, 6), error=error,
            )
        self.journal.record(
            COMPILE_ROW, label=label, phase=self.phase,
            new_signature=is_new, signature=sig.to_json(),
            compiles=compiles, compile_seconds=round(compile_seconds, 6),
            cost=cost, memory=memory, hbm_forecast_bytes=forecast,
            device_bytes_limit=limit, error=error,
        )


# ---------------------------------------------------------------------------
# The module-level hook (inert by default) and the labelling wrapper
# ---------------------------------------------------------------------------

_LEDGER: ProgramLedger | None = None


def ledger_active() -> bool:
    return _LEDGER is not None


def current_ledger() -> ProgramLedger | None:
    return _LEDGER


def install_ledger(ledger: ProgramLedger) -> ProgramLedger:
    """Make ``ledger`` the process-wide sink for ``ledger_call`` sites."""
    global _LEDGER
    _LEDGER = ledger
    return ledger


def uninstall_ledger() -> ProgramLedger | None:
    """Remove (and return) the installed ledger; drivers pair this with
    install in a try/finally."""
    global _LEDGER
    ledger, _LEDGER = _LEDGER, None
    return ledger


#: the label of the observed call running on this thread, if any
_OBSERVING = threading.local()


def _as_tuple(v) -> tuple:
    if v is None:
        return ()
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v,)


def ledger_call(fn=None, *, label: str, static_argnums=(), static_argnames=()):
    """``fn`` under a stable program label the ledger observes by: the
    counterpart of the JAX package's ``ledger_jit`` (there is no jit to
    wrap). ``static_argnums``/``static_argnames`` name the arguments
    described by value in the signature, as the JAX site's jit declares
    them. With no ledger installed a call is one global read and a
    passthrough; a call made inside another labelled call on the same
    thread is a passthrough too (the outer call observes it). Usable bare
    or through ``partial`` as a decorator."""
    if fn is None:
        return functools.partial(ledger_call, label=label, static_argnums=static_argnums,
                                 static_argnames=static_argnames)
    nums = _as_tuple(static_argnums)
    names = _as_tuple(static_argnames)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        ledger = _LEDGER
        if ledger is None or getattr(_OBSERVING, "label", None) is not None:
            return fn(*args, **kwargs)
        _OBSERVING.label = label
        try:
            return ledger.observed_call(fn, label, args, kwargs, nums, names)
        finally:
            _OBSERVING.label = None

    wrapper.label = label
    wrapper.wrapped = fn
    return wrapper
