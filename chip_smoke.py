#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--seed 0]

Phases, each failing loudly (an exception or a failed check exits non-zero):

1. Device: requires CUDA; prints the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``) and
   the torch and CUDA versions.
2. Build: compiles every kernel under ``photon_ml_torch/csrc`` into
   ``build/torch_kernels/`` (one ``nvcc`` per source, all at once).
3. Dense kernels against their plain versions, on the card: the fused GLM
   value+gradient (4 losses x {f32, bf16} x {no normalization, scaling,
   standardization} at n=2^18, d=512, plus ragged n=1000/d=123 and
   n=1001/d=4099, the widest one-pass plan at d=8192 and the two-pass form
   at d=8200), zero-weight rows included, each called twice and required
   bitwise equal; and the ordered reduction of its partials.
4. The dense slice: ``train_glm`` at n=2^18, d=512 on an f32 logistic
   dataset made with numpy from ``--seed``: an L-BFGS λ path with
   standardization, an elastic-net λ (OWL-QN), a TRON solve and an L-BFGS
   solve on a bf16 feature block, with the launch counters set to 0 just
   before and read just after. The L-BFGS path is repeated through the
   closed form (``use_kernel=False``) and the final objective values must
   agree; a small problem solved on the card must agree with the CPU in f64.
5. The sparse slice, at the shapes of bench.py's giant-FE rows (data made
   with numpy from ``--seed``), ``train_glm`` on ``SparseLabeledPointBatch``:
   a. ELL, n=2^19, d=10^7, 32 random + 4 planted columns per row, scaled by
      ``summarize_sparse``'s deviations: L-BFGS over λ in {0.1, 1}, an
      elastic-net λ (OWL-QN), L-BFGS on bf16 values, variances (the sparse
      Hessian diagonal), the scaled L-BFGS path again through the plain
      gather-sum (``use_kernel=False``) and through the kernel (gaps
      printed), and bench.py's unnormalized λ path {0.1, 1} (L-BFGS, up to
      100 iterations) through the kernel and the plain gather-sum (final
      values within rel 1e-4); the
      unnormalized λ=0.1 model's AUC on 2^16 held-out rows of the same
      planted model must exceed 0.6;
   b. hybrid, n=2^19, d=10^7, Zipf columns, a 256-column dense head: L-BFGS;
   c. hybrid, n=2^18, d=10^8, Zipf columns, a 512-column head: TRON (CG
      capped at 2), the hybrid Hessian-vector path.
   On each path's own inputs, before its solves, the gather kernel is held
   against its plain version in f64 (twice, bitwise equal; per row
   ``|k - p| <= 1e-5 * sum|vals*w|``): ELL f32 and bf16, and the ELL+tail
   of both hybrid batches; then on empty and overlong rows, and at the
   shapes of the TPU kernels it replaces (G1: one segment of 2^24 entries,
   d=2^22; G2: 2^22 entries, d=2^21; limit ``1e-7 * sum|vals*w|``); the
   chunk kernel (rows of more than 2048 entries) alone at each of its
   launch shapes (the planted transpose in f32 and bf16, the overlong rows,
   G1, G2) against its plain version in f64 (per chunk, 1e-5), with its own
   entries in the kernels line. The launch counter is set to 0 before each
   solve
   and read after it. A small standardized problem (n=4096, d=2^16, ELL and
   column-sorted) solved on the card must agree with the CPU in f64, and
   the card's ELL solve, run twice, must repeat bitwise; so must two sparse
   gradients at the ELL shape (the transpose Xᵀr is the gather's segment
   kernel over a column-sorted plan of the entries, held against its plain
   version at the ELL batch's d=10^7 columns with f32 and bf16 values, and
   on the tails of both hybrid batches; its launches are counted apart from
   the margins' row kernel, and the plan's bytes are printed, its compact
   chunk plan apart).
6. Times (CUDA events, median of 20 after warm-up): per-λ solve times, the
   device time of one sparse evaluation and its parts (the hybrid
   transposes split into the segment kernel and the head), B1 at the wide
   shapes [2^17, 2048] and [2^17, 4099] in f32 and bf16 (held against its
   plain version), and a ``{"kernels": ...}`` JSON line.
7. The GAME slice (``GameEstimator.fit``: a fixed effect plus per-user and
   per-item random effects by coordinate descent), data made with numpy from
   ``--seed``:
   a. the packed-aux kernel's operand forms and units against their plain
      versions at [2^17, 512] and at a ragged shape, twice and bitwise equal,
      with their times (``dev/torch_kernel_probe.py``);
   b. the Newton lanes' Cholesky solve against Gauss-Jordan elimination at
      [2000, 16, 16], with both times;
   c. at bench.py's flagship GAME shape (n=2^17, ``global`` d=256,
      ``per_entity`` d=16, 2000 users, 1500 items, one 128-slot bucket, L2
      weight 1, f32), 4 sweeps each: logistic labels with L-BFGS lanes and
      with Newton lanes, the Newton fit again with the kernel's products on
      the tensor cores (``kernel_unit="mma"``) and through the closed form
      (``use_kernel=False``), bench.py's linear labels with L-BFGS lanes and
      with Newton lanes (the latter through the separate-column form). The
      launch counters are set to 0 before each fit and read after it: every
      fixed-effect evaluation launched the packed kernel. Checks: training
      loss non-increasing over the sweeps; final training losses within rel
      1e-4 (kernel against closed form), 1e-3 (fma against mma; L-BFGS lanes
      against Newton lanes); the logistic model's AUC on 2^15 held-out rows
      (a quarter of unseen users) above the fixed effect's alone;
   d. the kernels on the main path's own inputs at [2^17, 256] against their
      plain versions, with device times, bounds and the two-matmul closed
      form's time;
   e. a small problem (n=4096) on the card in f32 against the CPU in f64:
      coefficients and tables within 1e-3 max|w|;
   f. a larger run (n=2^20, 16,000 users, 12,000 items, logistic, Newton
      lanes, 2 sweeps) whose times are printed.
   The probe study of (a) also runs every variant of the three earliest
   probes (P1-P3: separate columns without offsets or Σr, logistic loss),
   each held against its plain version and timed, with ``STEPS`` gradient
   steps per variant as their launches; the kernels line gains one P1, P2
   and P3 entry.
8. The drivers on the card, in a temporary directory (``DRIVERS`` gives the
   row counts; rows are cut, never widths): TrainingExample Avro written with
   the port's writer from ``--seed`` (GAME training and validation sets at
   the flagship widths: a ``global`` bag of 255 features plus the intercept,
   a ``perEntity`` bag of 16 for the per-user and per-item effects; a dense
   GLM set at d=512); the GLM driver (L-BFGS, λ in {1, 10}, validation AUC;
   B1 and its reduction launched once for every evaluation, the text model
   reloads); the GAME training driver (a fixed effect plus per-user and
   per-item Newton lanes, 2 sweeps, two λ values, validation AUC; every
   fixed-effect update launched the packed kernel, once for every
   evaluation, the best model's AUC above its fixed effect's alone); the
   GAME scoring driver on the saved best model (the scores read back from
   its Avro equal the loaded model's in-process scores bitwise, its AUC
   within 1e-4 of the training driver's); then B1 on the GLM driver's batch
   and the packed kernel on the GAME driver's fixed-effect inputs, both read
   back from the Avro, at the trained coefficients: each held against its
   plain version (twice bitwise equal; phase 3's f32 limits) with its
   reduction, and timed (the kernels line's ``driver_path``); the time of
   each stage, records per second of the Avro codec and peak device
   memory.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet): memory rate, f32 (non-tensor) rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def _log(msg: str) -> None:
    print(msg, flush=True)


def _eager_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call as the solver loop makes it: the
    device work plus any host-side launch overhead it cannot hide."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _device_ms(torch, fn, reps: int = 20, calls: int = 10) -> float:
    """Median device time of one call: ``calls`` calls captured in a CUDA
    graph, the graph replayed ``reps`` times between CUDA events, so no host
    overhead is in the time."""
    fn()  # warm up outside the capture (kernel build, grid query)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    del graph
    return statistics.median(times)


def _bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _kernel_cases(torch, fused_glm, losses, LabeledPointBatch, NormalizationContext, seed):
    """Phase 3: every loss x dtype x normalization at the main shape plus the
    ragged and wide shapes. Returns the worst errors seen."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = {"value_rel": 0.0, "grad_rel_to_max": 0.0, "main_grad_abs": 0.0, "cases": 0}
    shapes = [(1 << 18, 512, ("NONE", "SCALE", "STANDARDIZATION")),
              (1000, 123, ("STANDARDIZATION",)),
              (1001, 4099, ("STANDARDIZATION",)),
              (4096, 8192, ("STANDARDIZATION",)),
              (4096, 8200, ("STANDARDIZATION",))]
    for n, d, norms in shapes:
        x = torch.randn(n, d, device=dev, generator=gen)
        y_bin = (torch.rand(n, device=dev, generator=gen) < 0.5).float()
        y_real = torch.rand(n, device=dev, generator=gen) * 3.0
        offsets = 0.1 * torch.randn(n, device=dev, generator=gen)
        weights = 0.2 + 1.8 * torch.rand(n, device=dev, generator=gen)
        weights[::5] = 0.0
        w = torch.randn(d, device=dev, generator=gen) * 0.3 / (d / 16) ** 0.5
        factors = 0.5 + 1.5 * torch.rand(d, device=dev, generator=gen)
        factors[-1] = 1.0
        shifts = 0.1 * torch.randn(d, device=dev, generator=gen)
        shifts[-1] = 0.0
        contexts = {"NONE": None, "SCALE": NormalizationContext(factors, None),
                    "STANDARDIZATION": NormalizationContext(factors, shifts)}
        for dtype in (torch.float32, torch.bfloat16):
            for name in ("LogisticLoss", "SquaredLoss", "PoissonLoss", "SmoothedHingeLoss"):
                loss = getattr(losses, name)()
                y = y_bin if name in ("LogisticLoss", "SmoothedHingeLoss") else y_real
                batch = LabeledPointBatch.create(x, y, offsets, weights, dtype=dtype, device=dev)
                for norm in norms:
                    kw = dict(l2_weight=0.5, normalization=contexts[norm])
                    v1, g1 = fused_glm.fused_value_and_gradient(loss, w, batch, **kw)
                    v2, g2 = fused_glm.fused_value_and_gradient(loss, w, batch, **kw)
                    vr, gr = fused_glm.fused_value_and_gradient_reference(loss, w, batch, **kw)
                    torch.cuda.synchronize()
                    tag = f"{name} {str(dtype)[6:]} {norm} n={n} d={d}"
                    assert torch.equal(v1, v2) and torch.equal(g1, g2), f"not bitwise: {tag}"
                    assert bool(torch.isfinite(v1)) and bool(torch.isfinite(g1).all()), tag
                    value_rel = abs(float(v1 - vr)) / max(abs(float(vr)), 1e-30)
                    gmax = float(gr.abs().max())
                    grad_abs = float((g1 - gr).abs().max())
                    # f32 value rel 1e-5; bf16 (same bf16 inputs on both
                    # sides) 1e-4; gradient rtol 1e-4, atol 1e-4 * max|g|
                    vtol = 1e-5 if dtype == torch.float32 else 1e-4
                    assert value_rel <= vtol, f"value {value_rel} > {vtol}: {tag}"
                    assert torch.allclose(g1, gr, rtol=1e-4, atol=1e-4 * gmax), \
                        f"gradient off by {grad_abs} (max |g| {gmax}): {tag}"
                    worst["value_rel"] = max(worst["value_rel"], value_rel)
                    worst["grad_rel_to_max"] = max(worst["grad_rel_to_max"], grad_abs / gmax)
                    if (n, d, dtype, name, norm) == (1 << 18, 512, torch.float32,
                                                      "LogisticLoss", "STANDARDIZATION"):
                        worst["main_grad_abs"] = grad_abs
                    worst["cases"] += 1
        del x, batch
    return worst


def _wide_b1_entries(torch, fused_glm, loss, seed: int, card: str) -> list:
    """B1 at the wide shapes (n=2^17, d=2048 and a ragged 4099; f32 and
    bf16; bf16 at 2048 is the width at which a GAME fixed effect falls back
    from the packed kernel to B1): the kernel twice (bitwise equal) against
    its plain version within phase 3's limits, its plan, and its time
    beside the bound, the plain version's and the two products ``X@w``,
    ``r'X`` in X's dtype. No path of this run solves at these widths, so
    ``launches`` is 0."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    n = 1 << 17
    entries = []
    for d in (2048, 4099):
        x32 = torch.randn(n, d, device=dev, generator=gen)
        y = (torch.rand(n, device=dev, generator=gen) < 0.5).float()
        o = 0.1 * torch.randn(n, device=dev, generator=gen)
        ws = 0.2 + 1.8 * torch.rand(n, device=dev, generator=gen)
        w = 0.3 * torch.randn(d, device=dev, generator=gen) / (d / 16) ** 0.5
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)

            def kernel():
                return fused_glm.reduce_partials(*fused_glm.fused_partials(loss, x, y, o, ws, w))

            v1, g1, _ = kernel()
            v2, g2, _ = kernel()
            vr, gr, _ = fused_glm._plain_core(loss, x, y, o, ws, w, None)
            torch.cuda.synchronize()
            tag = f"B1 [{n}, {d}] {str(dtype)[6:]}"
            assert torch.equal(v1, v2) and torch.equal(g1, g2), f"not bitwise: {tag}"
            vtol = 1e-5 if dtype == torch.float32 else 1e-4
            assert abs(float(v1 - vr)) <= vtol * abs(float(vr)), tag
            gmax = float(gr.abs().max())
            assert torch.allclose(g1, gr, rtol=1e-4, atol=1e-4 * gmax), tag
            nbytes = n * d * x.element_size() + 12 * n + 4 * d + 4 * d + 8
            bound, by = _bound_ms(nbytes, 4.0 * n * d)
            wx, r = w.to(dtype), ws.to(dtype)
            plan = fused_glm.tile_plan(d, dtype)
            entry = {
                "name": "fused_glm", "route": "cuda",
                "source": "photon_ml_torch/csrc/fused_glm.cu",
                "replaces": "photon_ml_tpu/ops/pallas_glm.py:128", "launches": 0,
                "max_abs_err": float((g1 - gr).abs().max()),
                "ms": _device_ms(torch, kernel),
                "plain_ms": _device_ms(torch, lambda: fused_glm._plain_core(
                    loss, x, y, o, ws, w, None)),
                "bound_ms": bound, "bound_by": by,
                "library_ms": _device_ms(torch, lambda: (torch.matmul(x, wx),
                                                         torch.matmul(r, x))),
                "shape": [n, d], "dtype": str(dtype)[6:], "on_main_path": False,
                "plan": [plan.rows, plan.stages, plan.phases, plan.vectors]}
            _log(f"{tag} ({card}): {entry['ms']:.4f} ms (bound {bound:.4f}, plain "
                 f"{entry['plain_ms']:.4f}, X@w + r'X {entry['library_ms']:.4f}), plan "
                 f"{plan}, max |dg| {entry['max_abs_err']:.3g} of max |g| {gmax:.3g}")
            entries.append(entry)
            del x
        del x32
    torch.cuda.empty_cache()
    return entries


def _dataset(np, seed: int, n: int, d: int):
    """f32 logistic data: shifted/scaled columns, the last one a constant-1
    intercept (STANDARDIZATION needs it), labels from a planted model."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d), dtype=np.float32)
    x *= rng.uniform(0.5, 3.0, size=d).astype(np.float32)
    x += rng.normal(size=d).astype(np.float32)
    x[:, -1] = 1.0
    w_true = (rng.normal(size=d) * 2.0 / np.sqrt(d)).astype(np.float32)
    z = (x - x.mean(axis=0)) @ w_true
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    return x, y


#: shapes of the sparse slice: bench.py's giant-FE rows (bench_sparse_fe,
#: bench_sparse_fe_hybrid, bench_sparse_fe_1e8), the TPU kernels' probe
#: shapes (G1, G2), ragged rows, and the card-against-CPU problem
SPARSE = {
    "ell": dict(n=1 << 19, d=10_000_000, per_row=32, held_out=1 << 16),
    "hybrid": dict(n=1 << 19, d=10_000_000, per_row=32, hot_cols=256),
    "hybrid_1e8": dict(n=1 << 18, d=100_000_000, per_row=16, hot_cols=512),
    "ragged": dict(n=1 << 16, d=1_000_000, width=16),
    "g1": dict(nnz=1 << 24, d=1 << 22),
    "g2": dict(nnz=1 << 22, d=1 << 21),
    "small": dict(n=4096, d=1 << 16, per_row=16),
}


def _zipf_cols(np, rng, size: int, d: int, gamma: float = 24.0):
    """bench.py's ``_zipf_cols``: bounded power-law column ids (the top k
    columns hold a (k/d)^(1/gamma) share of the entries), scattered over
    [0, d) by an odd multiplicative bijection."""
    raw = (rng.random(size) ** gamma * d).astype(np.int64)
    return (raw * 2654435761) % d


def _planted_ell_data(np, seed: int, n: int, d: int, per_row: int, held_out: int):
    """bench.py's d=10^7 data (bench_sparse_fe): per row ``per_row`` uniform
    columns plus 4 columns of a 256-column planted support, f32 values,
    logistic labels drawn from the planted model. Returns the COO and labels
    of ``n`` training rows and of ``held_out`` more rows of the same model."""
    rows, cols, vals, y = _planted_rows(np, seed, n + held_out, d, per_row)
    train = rows < n
    held = ~train
    return (rows[train], cols[train], vals[train], y[:n]), \
        (rows[held] - n, cols[held], vals[held], y[n:])


def _planted_rows(np, seed: int, n: int, d: int, per_row: int):
    rng = np.random.default_rng(seed + 3)
    rows = np.repeat(np.arange(n), per_row)
    cols = rng.integers(0, d, size=n * per_row)
    vals = rng.normal(size=n * per_row).astype(np.float32)
    support = rng.choice(d, size=256, replace=False)
    w_true = rng.normal(size=256).astype(np.float32)
    sig = rng.integers(0, 256, size=(n, 4))
    sig_vals = rng.normal(size=(n, 4)).astype(np.float32)
    logits = (sig_vals * w_true[sig]).sum(axis=1)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    rows = np.concatenate([rows, np.repeat(np.arange(n), 4)])
    cols = np.concatenate([cols, support[sig].ravel()])
    vals = np.concatenate([vals, sig_vals.ravel()])
    return rows, cols, vals, y


def _zipf_data(np, seed: int, n: int, d: int, per_row: int):
    """bench.py's hybrid data: ``per_row`` Zipf columns per row, f32 values,
    coin-flip labels."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = _zipf_cols(np, rng, n * per_row, d)
    vals = rng.normal(size=n * per_row).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return rows, cols, vals, y


def _gather_check(torch, tag: str, w, n: int, ell=None, tail=None, chunks=None,
                  rel: float = 1e-5) -> dict:
    """The gather kernel, called twice (bitwise equal), against its plain
    version on the same inputs, evaluated in f64 (the bf16 and f32 values
    widen exactly): per row |k - p| <= rel * sum|vals * w| + 1e-30.

    rel is 1e-5 for rows of the batch layouts. The one-segment cases pass
    1e-7: at G1's shape (2^24 products of two standard normals, sum|vals*w|
    about 1.07e7) that is about 1.1, where the sum of one 2048-entry chunk
    is typically about 45, so a lost or doubled chunk fails."""
    from photon_ml_torch.ops import sparse_gather

    k1 = sparse_gather.gather_sum(w, n, ell=ell, tail=tail, chunks=chunks)
    k2 = sparse_gather.gather_sum(w, n, ell=ell, tail=tail, chunks=chunks)

    def wide(part, fn=lambda v: v):
        return None if part is None else (fn(part[0].double()), *part[1:])

    plain = sparse_gather.gather_sum_reference(w.double(), n, ell=wide(ell), tail=wide(tail))
    scale = sparse_gather.gather_sum_reference(w.abs().double(), n, ell=wide(ell, torch.abs),
                                               tail=wide(tail, torch.abs))
    torch.cuda.synchronize()
    assert torch.equal(k1, k2), f"gather kernel not bitwise repeatable: {tag}"
    assert k1.dtype == torch.float32 and bool(torch.isfinite(k1).all()), tag
    err = (k1.double() - plain).abs()
    bad = int((err > rel * scale + 1e-30).sum())
    assert bad == 0, f"gather kernel off its plain version in {bad} of {n} rows: {tag}"
    return {"case": tag, "rows": n, "rel_limit": rel, "max_abs_err": float(err.max()),
            "max_err_over_scale": float((err / (scale + 1e-30)).max())}


def _gather_entry(torch, replaces: str, w, n: int, check: dict, ell=None, tail=None,
                  chunks=None) -> dict:
    """One ``sparse_gather`` entry of the kernels line: device and eager
    time, the plain version's, one PyTorch call of the same function
    (``library_ms``: for ELL rows a cuSPARSE CSR product of the same
    entries, built outside the timing; for one segment ``torch.dot`` of the
    values with ``w`` gathered at their columns, which ``dot_ms`` also times
    for ELL rows as one sum), the worst row error as a share of its limit,
    and the bound from the
    bytes these inputs need (every stored entry, the outputs, the row
    pointers and each distinct column of w once) and 2 f32 operations per
    entry."""
    from photon_ml_torch.ops import sparse_gather

    vals, cols = ell if ell is not None else tail[:2]
    stored = vals.numel()
    nbytes = stored * (vals.element_size() + 4) + 4 * n
    nbytes += 4 * int(torch.unique(cols).numel())
    if tail is not None:
        nbytes += 4 * (n + 1)
        if chunks is not None:
            nbytes += chunks.nbytes()
    bound, by = _bound_ms(nbytes, 2.0 * stored)
    w_lib = w.to(vals.dtype)
    flat_vals, flat_cols = vals.reshape(-1), cols.reshape(-1).long()
    # the same gathers summed into one number (G1's one-segment yardstick)
    dot = lambda: torch.dot(flat_vals, w_lib[flat_cols])  # noqa: E731
    if ell is not None:
        crow = torch.arange(n + 1, dtype=torch.int32, device=vals.device) * vals.shape[1]
        csr = torch.sparse_csr_tensor(crow, cols.reshape(-1), flat_vals,
                                      (n, w.shape[0]), check_invariants=False)
        library = lambda: csr @ w_lib  # noqa: E731
    else:
        assert n == 1, "the library call times one segment"
        library = dot

    def kernel():
        return sparse_gather.gather_sum(w, n, ell=ell, tail=tail, chunks=chunks)

    return {"name": "sparse_gather", "route": "cuda",
            "source": "photon_ml_torch/csrc/sparse_gather.cu", "replaces": replaces,
            "launches": None, "max_abs_err": check["max_abs_err"],
            "ms": _device_ms(torch, kernel), "eager_ms": _eager_ms(torch, kernel),
            # fewer repeats: the plain version's one-segment index_add_ (every
            # entry's atomic add lands on one slot) takes milliseconds at G1's shape
            "plain_ms": _device_ms(torch, lambda: sparse_gather.gather_sum_reference(
                w, n, ell=ell, tail=tail), reps=5, calls=2),
            "bound_ms": bound, "bound_by": by,
            "library_ms": _device_ms(torch, library, reps=5, calls=2),
            "dot_ms": _device_ms(torch, dot, reps=5, calls=2),
            "worst_err_share_of_limit": check["max_err_over_scale"] / check["rel_limit"],
            "shape": [n, vals.shape[1]] if ell is not None else [n, stored],
            "layout": "ell" if ell is not None else "one segment",
            "dtype": str(vals.dtype).replace("torch.", ""), "d": int(w.shape[0]),
            "bytes": nbytes}


def _transpose_entry(torch, replaces: str, r, d: int, check: dict, plan, layout: str,
                     **extra) -> dict:
    """The ``sparse_gather`` entry of the gradient's transpose: the segment
    kernel over a batch's column-sorted plan (segments: the d columns;
    gathered: ``r`` at each entry's row). ``library_ms`` is cuSPARSE's
    product of the same entries as a CSR ``[d, n]`` matrix with ``r`` (bf16
    values widened to f32 first, outside the timing: the same function; its
    product with a bf16 ``r``, which rounds r, is ``library_bf16_r_ms``).
    The bound counts what the function needs: each entry, the column
    pointers, the output and each distinct row of ``r`` once (not the chunk
    plan, which only this kernel reads), and 2 operations per entry. The
    plain version's column ids are rebuilt from the pointers outside its
    timing."""
    from photon_ml_torch.ops import sparse_gather

    vals, rows, col_ptr, chunks = plan
    cols = sparse_gather.segment_ids(col_ptr)
    stored = vals.numel()
    nbytes = stored * (vals.element_size() + 4) + 4 * d + 4 * (d + 1)
    nbytes += 4 * int(torch.unique(rows).numel())
    bound, by = _bound_ms(nbytes, 2.0 * stored)
    csr = torch.sparse_csr_tensor(col_ptr, rows, vals.float(), (d, r.shape[0]),
                                  check_invariants=False)
    if vals.dtype != torch.float32:
        csr_16 = torch.sparse_csr_tensor(col_ptr, rows, vals, (d, r.shape[0]),
                                         check_invariants=False)
        r_16 = r.to(vals.dtype)
        extra["library_bf16_r_ms"] = _device_ms(torch, lambda: csr_16 @ r_16)

    def kernel():
        return sparse_gather.gather_sum(r, d, tail=(vals, rows, None, col_ptr), chunks=chunks)

    return {"name": "sparse_gather", "route": "cuda",
            "source": "photon_ml_torch/csrc/sparse_gather.cu", "replaces": replaces,
            "launches": None, "max_abs_err": check["max_abs_err"],
            "ms": _device_ms(torch, kernel), "eager_ms": _eager_ms(torch, kernel),
            "plain_ms": _device_ms(torch, lambda: sparse_gather.gather_sum_reference(
                r, d, tail=(vals, rows, cols, col_ptr))),
            "bound_ms": bound, "bound_by": by,
            "library_ms": _device_ms(torch, lambda: csr @ r),
            "worst_err_share_of_limit": check["max_err_over_scale"] / check["rel_limit"],
            "shape": [d, stored], "layout": f"transpose (column-sorted plan), {layout}",
            "dtype": str(vals.dtype).replace("torch.", ""), "chunks": None if chunks is None
            else chunks.count, "bytes": nbytes, **extra}


def _chunk_csr(torch, tail, chunks, width: int):
    """The chunk kernel's function as one CSR matrix ``[chunks.count,
    width]`` and the tail positions of its entries: the long rows' entries
    copied in order into contiguous arrays (bf16 values widened to f32),
    one matrix row a chunk of the plan, so ``csr @ w`` is cuSPARSE's
    per-chunk partials. Built once, outside any timing."""
    from photon_ml_torch.ops import sparse_gather

    vals, cols, _, row_ptr = tail
    dev = vals.device
    rows = chunks.rows.long()
    starts, lens = row_ptr[rows].long(), (row_ptr[rows + 1] - row_ptr[rows]).long()
    offsets = torch.cumsum(lens, 0) - lens  # each long row's start in the copy
    of = torch.repeat_interleave(torch.arange(rows.numel(), device=dev), lens)
    entry = starts[of] + torch.arange(of.numel(), device=dev) - offsets[of]
    first = chunks.chunk_ptr[:-1].long()
    r = torch.repeat_interleave(torch.arange(rows.numel(), device=dev), chunks.chunk_ptr[1:].long()
                                - first)
    begin = offsets[r] + (torch.arange(chunks.count, device=dev) - first[r]) \
        * sparse_gather.SEGMENT_CHUNK
    crow = torch.cat([begin, begin.new_full((1,), entry.numel())]).to(torch.int32)
    csr = torch.sparse_csr_tensor(crow, cols[entry], vals[entry].float(), (chunks.count, width),
                                  check_invariants=False)
    return csr, entry


def _chunk_entry(torch, replaces: str, w, tail, chunks, case: str) -> dict:
    """The chunk kernel's entry of the kernels line
    (``sparse_gather.chunk_partials``) at one of its launch shapes: held
    against its plain version in f64 (every chunk within 1e-5·Σ|v·w| of its
    chunk, twice bitwise equal) and timed beside it. The bound counts the
    long rows' entries, the compact plan, the long rows' two pointers, the
    partials written and each distinct column of w (or row of r) those
    entries gather, once each, and 2 operations an entry. ``library_ms`` is
    cuSPARSE's product of a CSR matrix whose rows are the chunks with w
    (``_chunk_csr``), held to the same limit."""
    from photon_ml_torch.ops import sparse_gather

    vals, cols, _, row_ptr = tail
    p1 = sparse_gather.chunk_partials(w, tail, chunks)
    p2 = sparse_gather.chunk_partials(w, tail, chunks)
    wide = (vals.double(), *tail[1:])
    plain = sparse_gather.chunk_partials_reference(w.double(), wide, chunks)
    scale = sparse_gather.chunk_partials_reference(w.double().abs(), (wide[0].abs(), *tail[1:]),
                                                   chunks)
    csr, entry = _chunk_csr(torch, tail, chunks, w.shape[0])
    lib_share = float(((csr @ w).double() - plain).abs().div(1e-5 * scale + 1e-30).max())
    torch.cuda.synchronize()
    assert torch.equal(p1, p2), f"chunk kernel not bitwise repeatable: {case}"
    err = (p1.double() - plain).abs()
    share = float((err / (1e-5 * scale + 1e-30)).max())
    assert share <= 1.0, f"chunk kernel off its plain version ({share} of the limit): {case}"
    assert lib_share <= 1.0, f"the chunks' CSR product is another function: {case}"
    nnz = entry.numel()
    nbytes = nnz * (vals.element_size() + 4) + chunks.nbytes() + 8 * chunks.rows.numel() \
        + 4 * chunks.count + 4 * int(torch.unique(cols[entry]).numel())
    bound, by = _bound_ms(nbytes, 2.0 * nnz)
    del entry
    return {"name": "sparse_gather_chunks", "route": "cuda",
            "source": "photon_ml_torch/csrc/sparse_gather.cu", "replaces": replaces,
            "launches": None, "max_abs_err": float(err.max()),
            "ms": _device_ms(torch, lambda: sparse_gather.chunk_partials(w, tail, chunks)),
            "plain_ms": _device_ms(torch, lambda: sparse_gather.chunk_partials_reference(
                w, tail, chunks), reps=5, calls=2),
            "bound_ms": bound, "bound_by": by, "library_ms": _device_ms(torch, lambda: csr @ w),
            "library_note": "cuSPARSE CSR [chunks, d] @ w, the long rows' entries copied "
                            "contiguous outside the timing",
            "worst_err_share_of_limit": share, "case": case, "chunks": chunks.count,
            "long_rows": int(chunks.rows.numel()), "entries": nnz,
            "dtype": str(vals.dtype).replace("torch.", ""), "bytes": nbytes}


def _plan_bytes(plan) -> int:
    """Device bytes of a transpose plan (values, rows, pointers, chunk plan)."""
    vals, rows, col_ptr, chunks = plan
    return sum(t.numel() * t.element_size() for t in (vals, rows, col_ptr)) \
        + (0 if chunks is None else chunks.nbytes())


def _transpose_head_ms(torch, batch, r) -> float:
    """Device time of the hybrid head's share of the transpose: ``r'X_hot``
    and its ``index_add_`` into the distinct hot columns."""
    out = torch.zeros(batch.dim, device=r.device)
    return _device_ms(torch, lambda: out.index_add_(0, batch.hot_col_ids,
                                                    r @ batch.hot_vals.to(r.dtype)))


def _one_segment(torch, sparse_gather, dev, seed: int, nnz: int, d: int):
    """G1/G2's case: one row holding ``nnz`` random entries, with its chunk plan."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, d, (nnz,), dtype=torch.int32, device=dev, generator=gen)
    vals = torch.randn(nnz, device=dev, generator=gen)
    w = torch.randn(d, device=dev, generator=gen)
    row_ids = torch.zeros(nnz, dtype=torch.int32, device=dev)
    row_ptr, chunks = sparse_gather.segment_plan(row_ids, 1)
    return w, (vals, idx, row_ids, row_ptr), chunks


def _small_sparse_agreement(torch, np, seed: int, card) -> list[str]:
    """A small standardized logistic problem (16 random columns per row with
    values in [0.5, 1.5), plus an intercept column) trained on ``card`` in
    f32 and on the CPU in f64, ELL and column-sorted: the coefficients agree
    within 1e-3 max|w|. (Values near 0 in a column seen once give it a huge
    standardization factor, and f32 prefix sums of the column-sorted view
    then miss by more than that.) The card's ELL solve runs twice and must
    repeat bitwise: the gradient's transpose sums each column in a fixed
    order (``sparse_batch.tail_column_sums``). With float atomics
    (``index_add_``) some addition orders made the f32 L-BFGS stop at a
    failed line search a few iterations early (once 0.0175 from the f64
    optimum, 5.6x the limit), so the check passed or failed by that draw."""
    from photon_ml_torch.data.sparse_batch import SparseLabeledPointBatch, summarize_sparse
    from photon_ml_torch.estimators import train_glm
    from photon_ml_torch.ops.normalization import NormalizationType, build_normalization
    from photon_ml_torch.types import TaskType

    n, d, per_row = (SPARSE["small"][k] for k in ("n", "d", "per_row"))
    rng = np.random.default_rng(seed + 7)
    rows = np.repeat(np.arange(n), per_row)
    cols = rng.integers(0, d - 1, size=n * per_row)
    vals = rng.uniform(0.5, 1.5, size=n * per_row)
    z = np.bincount(rows, weights=vals * rng.normal(size=d)[cols] * 0.5, minlength=n) + 0.3
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.full(n, d - 1)])
    vals = np.concatenate([vals, np.ones(n)])
    stats = summarize_sparse(rows, cols, vals, n=n, dim=d)
    lines = []
    for layout in ("ell", "column_sorted"):
        got = {}
        for where, dtype in ((card, torch.float32), ("cpu", torch.float64), ("again", None)):
            if where == "again":  # the card's solve once more
                where, dtype = card, torch.float32
                got["first"] = got[card]
            batch = SparseLabeledPointBatch.from_coo(
                rows, cols, vals, y, dim=d, dtype=dtype, device=where,
                column_sorted_gradient=layout == "column_sorted")
            stat = {k: torch.as_tensor(stats[k], dtype=dtype, device=where)
                    for k in ("mean", "variance", "max_magnitude")}
            norm = build_normalization(NormalizationType.STANDARDIZATION, mean=stat["mean"],
                                       variance=stat["variance"],
                                       max_magnitude=stat["max_magnitude"],
                                       intercept_index=d - 1)
            models = train_glm(batch, TaskType.LOGISTIC_REGRESSION, regularization_weights=(1.0,),
                               normalization=norm, intercept_index=d - 1)
            got[where] = models[1.0].coefficients.means.double().cpu()
        gap = float((got[card] - got["cpu"]).abs().max())
        scale = float(got["cpu"].abs().max())
        repeat = bool(torch.equal(got["first"], got[card]))
        lines.append(f"small sparse problem n={n} d={d} {layout}: card f32 vs cpu f64 max |dw| "
                     f"{gap:.3g} (max |w| {scale:.3g}); two card solves bitwise equal: {repeat}")
        assert gap <= 1e-3 * scale, lines[-1]
        # the ELL scatters add in a fixed order; the column-sorted view's
        # prefix sums are reported, not required, to repeat
        assert repeat or layout != "ell", lines[-1]
    return lines


def _sparse_slice(torch, np, seed: int, dev, card: str) -> list:
    """Phase 5: the sparse slice at full width, printing as it goes. Returns
    the sparse_gather entries of the kernels line."""
    from photon_ml_torch.data.sparse_batch import (
        HybridPolicy,
        SparseLabeledPointBatch,
        transpose_plan,
        sparse_column_sum,
        sparse_margins,
        summarize_sparse,
    )
    from photon_ml_torch.estimators import train_glm
    from photon_ml_torch.evaluation import local_metrics
    from photon_ml_torch.ops import sparse_gather
    from photon_ml_torch.ops.losses import LogisticLoss
    from photon_ml_torch.ops.normalization import NormalizationType, build_normalization
    from photon_ml_torch.ops.sparse_objective import SparseGLMObjective
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.types import TaskType

    checks, entries, solves = [], [], []
    # launches of the row kernel (margins), the segment kernel (the
    # transposes) and the chunk kernel over the path's solves
    total = {"launches": 0, "segment_launches": 0, "chunk_launches": 0}

    def take():
        """The gather counters' launches since the last call (row, segment
        and chunk kernels), added to the path's totals; the counters go to 0."""
        got = {k: getattr(sparse_gather, k) for k in total}
        for k, v in got.items():
            total[k] += v
            setattr(sparse_gather, k, 0)
        return got

    def run(label, batch, use_kernel=None, **kw):
        """train_glm with the gather counters set to 0 before each λ's solve
        and read just after it; returns the models and the launches made
        after the last solve (the variances' Hessian diagonal)."""
        marks = {"t": time.perf_counter()}
        for k in total:
            setattr(sparse_gather, k, 0)

        def on_solve(lam, result):
            torch.cuda.synchronize()
            now = time.perf_counter()
            got = take()
            hist = result.value_history[: result.iterations + 1].double().cpu().numpy()
            solves.append({"run": label, "lambda": lam, "seconds": now - marks["t"],
                           "launches": got["launches"] + got["segment_launches"],
                           "margin_launches": got["launches"],
                           "transpose_launches": got["segment_launches"],
                           "iterations": result.iterations,
                           "reason": result.reason, "value": float(result.value),
                           "history": hist, "kernel": use_kernel is not False})
            marks["t"] = now

        models = train_glm(batch, TaskType.LOGISTIC_REGRESSION, use_kernel=use_kernel,
                           on_solve=on_solve, **kw)
        torch.cuda.synchronize()
        got = take()
        return models, got["launches"] + got["segment_launches"]

    def timed(step, label, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        _log(f"{step} {label}: {time.perf_counter() - t0:.2f} s")
        return out

    # a. ELL at d=10^7 (bench_sparse_fe)
    n, d, per_row, n_held = (SPARSE["ell"][k] for k in ("n", "d", "per_row", "held_out"))
    (rows, cols, vals, y), held_coo = timed(
        "numpy data", f"ELL n={n} (+{n_held} held out) d={d}",
        lambda: _planted_ell_data(np, seed, n, d, per_row, n_held))
    ell = timed("from_coo", "ELL", lambda: SparseLabeledPointBatch.from_coo(
        rows, cols, vals, y, dim=d, device=dev))
    held = SparseLabeledPointBatch.from_coo(*held_coo, dim=d, device=dev)
    stats = timed("summarize_sparse", "ELL", lambda: summarize_sparse(rows, cols, vals, n=n, dim=d))
    del rows, cols, vals, held_coo
    stat = {k: torch.as_tensor(stats[k], dtype=torch.float32, device=dev)
            for k in ("mean", "variance", "max_magnitude")}
    scale = build_normalization(NormalizationType.SCALE_WITH_STANDARD_DEVIATION, **stat)
    del stats, stat
    ell16 = ell.replace(ell_vals=ell.ell_vals.to(torch.bfloat16),
                        values=ell.values.to(torch.bfloat16))
    width = ell.ell_vals.shape[1]
    assert ell.has_ell_view and ell.nnz == 0, "the ELL batch should have no flat tail"
    _log(f"ELL batch: [{n}, {width}] stored entries, flat tail {ell.nnz}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    w_chk = torch.randn(d, device=dev, generator=gen)
    checks.append(_gather_check(torch, "ELL f32", w_chk, n, ell=(ell.ell_vals, ell.ell_cols)))
    checks.append(_gather_check(torch, "ELL bf16", w_chk, n,
                                ell=(ell16.ell_vals, ell16.ell_cols)))

    lbfgs20 = OptimizerConfig(OptimizerType.LBFGS, max_iterations=20)
    common = dict(optimizer=lbfgs20, normalization=scale)
    models, _ = run("ell_lbfgs", ell, regularization_weights=(0.1, 1.0), **common)
    run("ell_owlqn", ell, regularization_weights=(1.0,), elastic_net_alpha=0.5, **common)
    run("ell_lbfgs_bf16", ell16, regularization_weights=(1.0,), **common)
    var_models, var_launches = run("ell_variance", ell, regularization_weights=(1.0,),
                                   compute_variance=True, **common)
    variances = var_models[1.0].coefficients.variances
    assert var_launches >= 1, "the Hessian diagonal launched no gather"
    assert variances.shape == (d,) and bool(torch.isfinite(variances).all()) \
        and bool((variances > 0).all()), "variances not finite and positive"
    _log(f"ELL variances (diagonal mode): min {float(variances.min()):.6g} max "
                 f"{float(variances.max()):.6g}, {var_launches} gather launch(es) after the solve")
    # Scaled by their deviations, the columns seen once or twice fit the
    # training rows alone: the loss heads for 0 and two f32 runs split (the
    # gradient scatter's atomics differ from run to run), so the scaled path
    # is repeated through the plain gather and through the kernel again and
    # the gaps are printed. bench.py's own setting (no normalization) is
    # well posed: it is held kernel against plain, and its λ=0.1 model to
    # the rows it did not see. Cut at 20 iterations its final values still
    # moved with rounding (up to 7e-5 rel apart on an H100), so these solves
    # may run on to a flat value.
    lbfgs100 = OptimizerConfig(OptimizerType.LBFGS, max_iterations=100)
    run("ell_lbfgs_plain", ell, use_kernel=False, regularization_weights=(0.1, 1.0), **common)
    run("ell_lbfgs_again", ell, regularization_weights=(0.1, 1.0), **common)
    plain_models, _ = run("ell_lbfgs_unscaled", ell, optimizer=lbfgs100,
                          regularization_weights=(0.1, 1.0))
    run("ell_lbfgs_unscaled_plain", ell, use_kernel=False, optimizer=lbfgs100,
        regularization_weights=(0.1, 1.0))

    def final(run_name, lam):
        return next(s for s in solves if s["run"] == run_name and s["lambda"] == lam)

    for lam in (0.1, 1.0):
        k, p, again = (final(r, lam) for r in ("ell_lbfgs", "ell_lbfgs_plain", "ell_lbfgs_again"))
        _log(f"scaled λ={lam:g}: final value kernel {k['value']:.8g} ({k['iterations']} "
             f"iterations), plain {p['value']:.8g} ({p['iterations']}), kernel again "
             f"{again['value']:.8g} ({again['iterations']}); rel gaps "
             f"{abs(k['value'] - p['value']) / abs(p['value']):.3g} to plain, "
             f"{abs(k['value'] - again['value']) / abs(k['value']):.3g} to the repeat")
        k, p = final("ell_lbfgs_unscaled", lam), final("ell_lbfgs_unscaled_plain", lam)
        gap = abs(k["value"] - p["value"]) / abs(p["value"])
        _log(f"unscaled λ={lam:g}: final value kernel {k['value']:.8g} ({k['iterations']} "
             f"iterations), plain {p['value']:.8g} ({p['iterations']}); rel gap {gap:.3g}")
        assert gap <= 1e-4, f"unscaled λ={lam}: kernel {k['value']} vs plain {p['value']}"

    def auc_of(model, batch, labels):
        margins = sparse_margins(batch, model.coefficients.means)
        return local_metrics.area_under_roc_curve(margins, labels)

    held_y = held.labels.cpu().numpy()
    for name, model in (("scaled λ=1", models[1.0]), ("scaled λ=0.1", models[0.1]),
                        ("unscaled λ=0.1", plain_models[0.1])):
        _log(f"ELL planted-signal model, {name}: training AUC {auc_of(model, ell, y):.6f}, "
             f"held-out AUC ({held.num_samples} rows) {auc_of(model, held, held_y):.6f}")
    auc = auc_of(plain_models[0.1], held, held_y)
    assert 0.6 < auc <= 1.0, f"held-out AUC {auc}"

    # one evaluation at the ELL shape and its parts (device times)
    obj = SparseGLMObjective(LogisticLoss(), l2_weight=1.0, normalization=scale)
    w_eval = 1e-2 * w_chk
    v1, g1 = obj.value_and_gradient(w_eval, ell)
    v2, g2 = obj.value_and_gradient(w_eval, ell)
    torch.cuda.synchronize()
    assert torch.equal(v1, v2), "the sparse value is not bitwise repeatable"
    assert torch.equal(g1, g2), \
        f"the sparse gradient is not bitwise repeatable: {float((g1 - g2).abs().max())}"
    r = torch.rand(n, device=dev, generator=gen)
    vg_ms = _device_ms(torch, lambda: obj.value_and_gradient(w_eval, ell))
    gather_ms = _device_ms(torch, lambda: sparse_gather.gather_sum(
        w_eval, n, ell=(ell.ell_vals, ell.ell_cols)))
    transpose_ms = _device_ms(torch, lambda: sparse_column_sum(ell, r))
    index_add_ms = _device_ms(torch, lambda: sparse_column_sum(ell, r, use_kernel=False))
    ell.__dict__.pop("_transpose_plan", None)  # time the plan's one-off build
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = transpose_plan(ell)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    plan_peak = torch.cuda.max_memory_allocated() - base
    plan_bytes = _plan_bytes(plan)
    _log(
        f"ELL evaluation n={n} d={d} L={width} f32 ({card}): value_and_gradient {vg_ms:.4f} ms "
        f"(eager {_eager_ms(torch, lambda: obj.value_and_gradient(w_eval, ell)):.4f} ms); "
        f"gather kernel {gather_ms:.4f} ms; gradient transpose (the gather kernel over the "
        f"column-sorted plan, a fixed order) {transpose_ms:.4f} ms; the plain index_add_ with "
        f"float atomics, for comparison, {index_add_ms:.4f} ms; the rest "
        f"{vg_ms - gather_ms - transpose_ms:.4f} ms; two gradients and values bitwise equal; "
        f"the plan's build (once per batch) {plan_s:.3f} s; the plan holds {plan_bytes} bytes "
        f"(values and rows {plan[0].numel() * 8}, column pointers {4 * (d + 1)}, the chunk plan "
        f"{0 if plan[3] is None else plan[3].nbytes()} for "
        f"{0 if plan[3] is None else plan[3].rows.numel()} long columns; a [d+1] chunk-pointer "
        f"array would add {4 * (d + 1)}), its build peaked {plan_peak} bytes above what "
        f"the phase held")
    g1_replaces = "experiments/sparse_gather_probe.py:70"
    entries.append(_gather_entry(torch, g1_replaces, w_eval, n, checks[0],
                                 ell=(ell.ell_vals, ell.ell_cols)))
    entries.append(_gather_entry(torch, g1_replaces, w_eval, n, checks[1],
                                 ell=(ell16.ell_vals, ell16.ell_cols)))
    for batch, dtype in ((ell, "f32"), (ell16, "bf16")):
        t_plan = transpose_plan(batch)
        t_tail = (t_plan[0], t_plan[1], None, t_plan[2])
        checks.append(_gather_check(
            torch, f"transpose of the ELL batch, {dtype} values (segments: its columns)", r, d,
            tail=t_tail, chunks=t_plan[3]))
        entries.append(_transpose_entry(torch, g1_replaces, r, d, checks[-1], t_plan,
                                        f"ELL [{n}, {width}]", plan_bytes=_plan_bytes(t_plan)))
        assert t_plan[3] is not None, "the planted columns should take the chunk kernel"
        entries.append(_chunk_entry(torch, g1_replaces, r, t_tail, t_plan[3],
                                    f"planted ELL transpose, {dtype} values"))
    del t_plan
    del ell, ell16, held, models, plain_models, var_models, variances, obj, g1, g2, plan
    torch.cuda.empty_cache()

    # b. hybrid at d=10^7 (bench_sparse_fe_hybrid)
    n, d, per_row, k_hot = (SPARSE["hybrid"][k] for k in ("n", "d", "per_row", "hot_cols"))
    rows, cols, vals, y = timed("numpy data", f"Zipf n={n} d={d}",
                                lambda: _zipf_data(np, seed + 11, n, d, per_row))
    hyb = timed("from_coo", f"hybrid hot_cols={k_hot}", lambda: SparseLabeledPointBatch.from_coo(
        rows, cols, vals, y, dim=d, hybrid=HybridPolicy(hot_cols=k_hot), device=dev))
    del rows, cols, vals
    assert hyb.has_hybrid_view and hyb.has_ell_view and hyb.nnz > 0
    _log(f"hybrid batch: head [{n}, {hyb.hot_vals.shape[1]}], hot coverage "
                 f"{hyb.layout['hot_coverage']:.6f} ({hyb.layout['hot_nnz']} of "
                 f"{hyb.layout['hot_nnz'] + hyb.layout['tail_nnz']} entries), ELL tail "
                 f"[{n}, {hyb.ell_vals.shape[1]}], flat tail {hyb.nnz}")
    tail = (hyb.values, hyb.col_indices, hyb.row_ids, hyb.row_ptr)
    checks.append(_gather_check(torch, "ELL+tail f32 (hybrid tail)", w_chk, n,
                                ell=(hyb.ell_vals, hyb.ell_cols), tail=tail,
                                chunks=hyb.row_chunks))
    run("hybrid_lbfgs", hyb, optimizer=OptimizerConfig(OptimizerType.LBFGS, max_iterations=10),
        regularization_weights=(0.1,))
    obj = SparseGLMObjective(LogisticLoss(), l2_weight=0.1)
    r = torch.rand(n, device=dev, generator=gen)
    vg_ms = _device_ms(torch, lambda: obj.value_and_gradient(w_eval, hyb))
    gather_ms = _device_ms(torch, lambda: sparse_gather.gather_sum(
        w_eval, n, ell=(hyb.ell_vals, hyb.ell_cols), tail=tail, chunks=hyb.row_chunks))
    head_ms = _device_ms(torch, lambda: hyb.hot_vals @ w_eval[hyb.hot_col_ids.long()])
    transpose_ms = _device_ms(torch, lambda: sparse_column_sum(hyb, r))
    t_plan = transpose_plan(hyb)
    checks.append(_gather_check(torch, "transpose of the hybrid tail, d=10^7", r, d,
                                tail=(t_plan[0], t_plan[1], None, t_plan[2]), chunks=t_plan[3]))
    t_head = _transpose_head_ms(torch, hyb, r)
    entries.append(_transpose_entry(torch, g1_replaces, r, d, checks[-1], t_plan,
                                    f"hybrid tail d={d}", head_ms=t_head,
                                    plan_bytes=_plan_bytes(t_plan)))
    # the plain transpose: index_add_ of every ELL slot (pad slots, value 0,
    # all in column 0) and of the flat tail
    plain_ms = _device_ms(torch, lambda: sparse_column_sum(hyb, r, use_kernel=False))
    _log(
        f"hybrid evaluation n={n} d={d} ({card}): value_and_gradient {vg_ms:.4f} ms; gather "
        f"kernel (ELL+tail) {gather_ms:.4f} ms; head product {head_ms:.4f} ms; gradient "
        f"transpose (head + the segment kernel over the column-sorted plan of the "
        f"{int(t_plan[0].numel())} nonzero tail entries) {transpose_ms:.4f} ms, of which the "
        f"segment kernel {entries[-1]['ms']:.4f} ms and the head's r'X_hot and index_add_ "
        f"{t_head:.4f} ms; "
        f"the rest {vg_ms - gather_ms - head_ms - transpose_ms:.4f} ms; the plain transpose "
        f"(index_add_ of the ELL tail's {hyb.ell_vals.numel()} slots and the flat tail, float "
        f"atomics), for comparison, {plain_ms:.4f} ms")
    del hyb, tail, obj, w_chk, w_eval, r, t_plan
    torch.cuda.empty_cache()

    # c. hybrid at d=10^8 with TRON (bench_sparse_fe_1e8)
    n, d, per_row, k_hot = (SPARSE["hybrid_1e8"][k] for k in ("n", "d", "per_row", "hot_cols"))
    rows, cols, vals, y = timed("numpy data", f"Zipf n={n} d={d}",
                                lambda: _zipf_data(np, seed + 5, n, d, per_row))
    big = timed("from_coo", f"hybrid hot_cols={k_hot}", lambda: SparseLabeledPointBatch.from_coo(
        rows, cols, vals, y, dim=d, hybrid=HybridPolicy(hot_cols=k_hot), device=dev))
    del rows, cols, vals
    _log(f"d=10^8 hybrid batch: head [{n}, {big.hot_vals.shape[1]}], hot coverage "
                 f"{big.layout['hot_coverage']:.6f}, ELL tail [{n}, {big.ell_vals.shape[1]}], "
                 f"flat tail {big.nnz}")
    w_big = torch.randn(d, device=dev, generator=gen)
    checks.append(_gather_check(torch, "ELL+tail f32 (hybrid tail, d=10^8)", w_big, n,
                                ell=(big.ell_vals, big.ell_cols),
                                tail=(big.values, big.col_indices, big.row_ids, big.row_ptr),
                                chunks=big.row_chunks))
    del w_big
    tron = OptimizerConfig(OptimizerType.TRON, max_iterations=3, max_cg_iterations=2)
    run("hybrid_1e8_tron", big, optimizer=tron, regularization_weights=(0.1,))
    r = torch.rand(n, device=dev, generator=gen)
    t_plan = transpose_plan(big)
    checks.append(_gather_check(torch, "transpose of the hybrid tail, d=10^8", r, d,
                                tail=(t_plan[0], t_plan[1], None, t_plan[2]), chunks=t_plan[3]))
    t_head = _transpose_head_ms(torch, big, r)
    entries.append(_transpose_entry(torch, g1_replaces, r, d, checks[-1], t_plan,
                                    f"hybrid tail d={d}", head_ms=t_head,
                                    plan_bytes=_plan_bytes(t_plan)))
    _log(f"hybrid d={d} transpose ({card}): the segment kernel over {int(t_plan[0].numel())} "
         f"nonzero tail entries {entries[-1]['ms']:.4f} ms (cuSPARSE "
         f"{entries[-1]['library_ms']:.4f}, bound {entries[-1]['bound_ms']:.4f}); the head "
         f"{t_head:.4f} ms; whole transpose "
         f"{_device_ms(torch, lambda: sparse_column_sum(big, r)):.4f} ms")
    del big, t_plan, r
    torch.cuda.empty_cache()

    # the path's counts: every kernel solve launched the gather kernel
    for s in solves:
        h = s["history"]
        assert np.isfinite(h).all() and (np.diff(h) <= 0).all(), f"not decreasing: {s['run']}"
        if s["kernel"]:
            assert s["launches"] >= max(s["iterations"], 1), f"too few launches: {s['run']}"
        else:
            assert s["launches"] == 0, f"the plain run launched the kernel: {s['run']}"
    _log(f"sparse path: {len(solves)} solves, {total['launches']} sparse_gather row-kernel "
         f"launches (margins), {total['segment_launches']} segment-kernel launches (the "
         f"transposes), {total['chunk_launches']} chunk launches")
    assert total["launches"] > 0 and total["segment_launches"] > 0

    # d. ragged rows, G1 and G2
    n, d, width = (SPARSE["ragged"][k] for k in ("n", "d", "width"))
    rng = np.random.default_rng(seed + 17)
    counts = rng.integers(0, 40, size=n)
    counts[::7] = 0
    counts[[3, n // 2, n - 2]] = [5000, 20000, 3000]
    rows = np.repeat(np.arange(n), counts)
    ragged = SparseLabeledPointBatch.from_coo(
        rows, rng.integers(0, d, size=len(rows)), rng.normal(size=len(rows)).astype(np.float32),
        np.zeros(n, np.float32), dim=d, ell=width, device=dev)
    assert ragged.row_chunks is not None and ragged.nnz > 0
    w = torch.randn(d, device=dev, generator=gen)
    r_tail = (ragged.values, ragged.col_indices, ragged.row_ids, ragged.row_ptr)
    checks.append(_gather_check(
        torch, f"empty rows and rows of up to 20000 entries, ELL width {width}", w, n,
        ell=(ragged.ell_vals, ragged.ell_cols), tail=r_tail, chunks=ragged.row_chunks))
    entries.append(_chunk_entry(torch, g1_replaces, w, r_tail, ragged.row_chunks,
                                "ragged rows of up to 20000 entries"))
    del ragged, r_tail
    for key, replaces in (("g1", g1_replaces), ("g2", "experiments/sparse_gather_probe2.py:61")):
        nnz, d = SPARSE[key]["nnz"], SPARSE[key]["d"]
        w, tail, chunks = _one_segment(torch, sparse_gather, dev, seed + nnz, nnz, d)
        checks.append(_gather_check(torch, f"{key.upper()} one segment nnz={nnz} d={d}", w, 1,
                                    tail=tail, chunks=chunks, rel=1e-7))
        entries.append(_gather_entry(torch, replaces, w, 1, checks[-1], tail=tail,
                                     chunks=chunks))
        entries.append(_chunk_entry(torch, replaces, w, tail, chunks,
                                    f"{key.upper()} one segment nnz={nnz} d={d}"))
    _log(f"gather kernel checks: {json.dumps(checks)}")
    for text in _small_sparse_agreement(torch, np, seed, dev):
        _log(text)
    for entry in entries:
        if entry["name"] == "sparse_gather_chunks":
            entry["launches"] = total["chunk_launches"]
            _log(f"chunk kernel, {entry['case']} ({card}): {entry['ms']:.4f} ms over "
                 f"{entry['chunks']} chunks of {entry['long_rows']} long rows (bound "
                 f"{entry['bound_ms']:.4f}, plain {entry['plain_ms']:.4f}, cuSPARSE CSR "
                 f"{entry['library_ms']:.4f})")
            continue
        transpose = entry["layout"].startswith("transpose")
        entry["launches"] = total["segment_launches" if transpose else "launches"]
        entry["chunk_launches"] = total["chunk_launches"]
    for s in solves:
        rate = s["launches"] / s["seconds"]
        _log(f"sparse solve {s['run']} λ={s['lambda']:g}: {s['iterations']} iterations, "
                     f"reason {s['reason']}, {s['launches']} gather launches in "
                     f"{s['seconds']:.4f} s ({rate:.1f} launches/s), value {s['value']:.8g}")
    return entries


#: the GAME slice: bench.py's flagship GAME shape (bench_game_sweep), a larger
#: run whose times give a later benchmark a size to start from, and the small
#: problem held against the CPU
GAME = {
    "flagship": dict(n=1 << 17, d_fe=256, d_re=16, users=2000, items=1500, held_out=1 << 15,
                     sweeps=4),
    "large": dict(n=1 << 20, d_fe=256, d_re=16, users=16000, items=12000, held_out=0, sweeps=2),
    "small": dict(n=4096, d_fe=32, d_re=8, users=48, items=24, held_out=0, sweeps=3),
    "cap": 128,
}


def _game_arrays(np, seed: int, n: int, d_fe: int, d_re: int, users: int, items: int,
                 held_out: int, **_):
    """bench.py's GAME data (bench_game_sweep) with planted random effects:
    uniform user and item ids, standard-normal ``global`` and ``per_entity``
    shards in f32, bench.py's linear labels (a planted fixed effect plus unit
    noise) and logistic labels drawn from a planted fixed effect plus planted
    per-user and per-item effects. ``held_out`` more rows of the same model
    follow the training rows, a quarter of them of users never trained on."""
    rng = np.random.default_rng(seed)
    total = n + held_out
    user_idx = rng.integers(0, users, size=total)
    item_idx = rng.integers(0, items, size=total)
    if held_out:
        user_idx[n + 3 * held_out // 4:] += users
    x_fe = rng.standard_normal((total, d_fe), dtype=np.float32)
    x_re = rng.standard_normal((total, d_re), dtype=np.float32)
    w_fe = rng.normal(size=d_fe).astype(np.float32) / np.sqrt(d_fe)
    y_linear = x_fe @ w_fe + rng.normal(size=total).astype(np.float32)
    w_user = (0.5 * rng.normal(size=(2 * users, d_re))).astype(np.float32)
    w_item = (0.5 * rng.normal(size=(items, d_re))).astype(np.float32)
    z = x_fe @ w_fe + np.einsum("nd,nd->n", x_re, w_user[user_idx]) \
        + np.einsum("nd,nd->n", x_re, w_item[item_idx])
    y_logistic = (rng.uniform(size=total) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    keys = {"user": np.char.add("u", user_idx.astype(str)),
            "item": np.char.add("i", item_idx.astype(str))}

    def part(lo, hi):
        return dict(x_fe=x_fe[lo:hi], x_re=x_re[lo:hi],
                    keys={t: k[lo:hi] for t, k in keys.items()},
                    labels={"LINEAR_REGRESSION": y_linear[lo:hi],
                            "LOGISTIC_REGRESSION": y_logistic[lo:hi]})

    return part(0, n), (part(n, total) if held_out else None)


def _game_dataset(arrays, task: str, device, vocabs=None, dtype=None):
    from photon_ml_torch.data.game_data import build_game_dataset

    kw = {} if dtype is None else {"dtype": dtype}
    return build_game_dataset(
        labels=arrays["labels"][task],
        feature_shards={"global": arrays["x_fe"], "per_entity": arrays["x_re"]},
        entity_keys=arrays["keys"], entity_vocabs=vocabs, device=device, **kw)


def _game_estimator(task: str, lanes: str, sweeps: int, *, random_effects: bool = True, **kw):
    """bench.py's GAME configuration: L-BFGS (10 iterations) on the fixed
    effect, ``lanes`` (10 iterations) on the per-user and per-item effects,
    L2 weight 1 everywhere, one bucket of 128 slots per entity."""
    from photon_ml_torch.algorithm.coordinates import CoordinateOptimizationConfig
    from photon_ml_torch.estimators import (
        FixedEffectCoordinateConfig,
        GameEstimator,
        RandomEffectCoordinateConfig,
    )
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.types import TaskType

    def opt(kind):
        return CoordinateOptimizationConfig(
            optimizer=OptimizerConfig(OptimizerType[kind], max_iterations=10), l2_weight=1.0)

    configs = {"fixed": FixedEffectCoordinateConfig("global", opt("LBFGS"))}
    if random_effects:
        for cid, re_type in (("per_user", "user"), ("per_item", "item")):
            configs[cid] = RandomEffectCoordinateConfig(re_type, "per_entity", opt(lanes),
                                                        bucket_sizes=(GAME["cap"],))
    return GameEstimator(task=TaskType[task], coordinate_configs=configs, num_iterations=sweeps,
                         **kw)


class _GameTimers:
    """Wall-clock seconds (synchronized) of the coordinates' ``update_model``
    and ``score`` and of the bucket builder during one fit, by wrapping the
    port's methods; restored on exit."""

    def __init__(self, torch):
        self.torch = torch
        self.seconds: dict = {}
        self._saved = []

    def _wrap(self, owner, name, key_of):
        fn = getattr(owner, name)
        torch, seconds = self.torch, self.seconds

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            key = key_of(*args, **kw)
            seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
            return out

        self._saved.append((owner, name, fn))
        setattr(owner, name, timed)

    def __enter__(self):
        from photon_ml_torch import estimators
        from photon_ml_torch.algorithm import coordinates

        for cls in (coordinates.FixedEffectCoordinate, coordinates.RandomEffectCoordinate):
            self._wrap(cls, "update_model", lambda self_, *a, **k: f"solve {self_.coordinate_id}")
            self._wrap(cls, "score", lambda self_, *a, **k: "rescoring")
        self._wrap(estimators, "build_random_effect_dataset", lambda *a, **k: "bucket builder")
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)


def _game_fit(torch, label: str, estimator, dataset, sweeps: int) -> dict:
    """One ``GameEstimator.fit`` with the launch counters set to 0 just before
    and read just after. Every fixed-effect update must have launched the
    packed kernel once per evaluation and no other dense kernel."""
    from photon_ml_torch.algorithm.coordinates import lane_iteration_histogram
    from photon_ml_torch.ops import fused_glm, packed_glm
    from photon_ml_torch.optim.common import LaneTraces

    counters = ("packed_launches", "mma_launches", "columns_launches", "reduce_launches")
    for name in counters:
        setattr(packed_glm, name, 0)
    b1_before = fused_glm.launches
    updates, marks = [], {"packed": 0, "columns": 0}

    def on_update(iteration, cid, info):
        row = {"sweep": iteration, "coordinate": cid}
        if isinstance(info, LaneTraces):
            row["lane_iterations"] = lane_iteration_histogram(info)
        elif info is not None:
            packed, columns = packed_glm.packed_launches, packed_glm.columns_launches
            row.update(iterations=info.iterations, reason=info.reason,
                       evaluations=(packed - marks["packed"]) + (columns - marks["columns"]))
            marks.update(packed=packed, columns=columns)
        updates.append(row)

    estimator.on_update = on_update
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _GameTimers(torch) as timers:
        result = estimator.fit(dataset)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: getattr(packed_glm, name) for name in counters}
    uses_kernel = estimator.use_kernel is not False
    for row in updates:
        if "evaluations" in row:
            # every evaluation of the solve went through the packed kernel
            wanted = row["iterations"] + 1 if uses_kernel else 0
            assert (row["evaluations"] >= wanted) if uses_kernel else row["evaluations"] == 0, \
                f"{label}: fixed-effect update {row} launched too few packed kernels"
    assert fused_glm.launches == b1_before, f"{label}: the separate-column kernel was launched"
    assert launches["reduce_launches"] == launches["packed_launches"] + launches["columns_launches"]
    loss_name = next(k for k in result.metric_history[0] if k.startswith("train:"))
    last = [h[loss_name] for h in result.metric_history
            if h["coordinate"] == result.metric_history[-1]["coordinate"]]
    assert len(last) == sweeps and all(math.isfinite(v) for v in last), f"{label}: {last}"
    assert all(b <= a * (1 + 1e-5) for a, b in zip(last, last[1:])), \
        f"{label}: training loss rose over the sweeps: {last}"
    solves = {k: v for k, v in timers.seconds.items() if k.startswith("solve ")}
    known = sum(solves.values()) + timers.seconds.get("rescoring", 0.0) \
        + timers.seconds.get("bucket builder", 0.0)
    fe_rows = [r for r in updates if "evaluations" in r]
    lanes: dict = {}
    for r in updates:
        for its, count in r.get("lane_iterations", {}).items():
            lanes[its] = lanes.get(its, 0) + count
    out = {"fit": label, "seconds": seconds, "sweeps": sweeps,
           "seconds_per_sweep": (seconds - timers.seconds.get("bucket builder", 0.0)) / sweeps,
           "per_sweep": {k: v / sweeps for k, v in solves.items()},
           "rescoring_per_sweep": timers.seconds.get("rescoring", 0.0) / sweeps,
           "host_rest_per_sweep": (seconds - known) / sweeps,
           "bucket_builder_seconds": timers.seconds.get("bucket builder", 0.0),
           "fe_evaluations_per_solve": [r["evaluations"] for r in fe_rows],
           "fe_iterations_per_solve": [r["iterations"] for r in fe_rows],
           "lane_iteration_histogram": dict(sorted(lanes.items())),
           "loss_per_sweep": last, "launches": launches,
           "peak_memory_MiB": torch.cuda.max_memory_allocated() / 2**20}
    _log(f"GAME fit {json.dumps(out)}")
    out["result"] = result
    return out


def _rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _lane_loop_share(torch, estimator, dataset) -> dict:
    """Where one random-effect update's wall time goes: the wall clock of one
    ``update_model`` of the per-user coordinate (synchronized) beside the sum
    of its kernels' device time from ``torch.profiler``; the rest is time the
    card waits for the host."""
    sequence, coordinates = estimator._build_coordinates(dataset, None)
    coord = coordinates["per_user"]
    model = coord.initial_model()
    coord.update_model(model, None)  # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coord.update_model(model, None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        coord.update_model(model, None)
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                    for e in events)
    kernels = sum(e.count for e in events
                  if getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) > 0)
    out = {"wall_ms": wall * 1e3, "device_ms": device_us / 1e3 if device_us else None,
           "device_events": kernels}
    out["host_share"] = None if not device_us else max(0.0, 1.0 - device_us / 1e6 / wall)
    return out


def _packed_entry(torch, name, replaces, launches, kernel, plain, library, x, n_aux_bytes,
                  limits, slack=None, **extra):
    """One ``packed_glm`` entry of the kernels line at the GAME fixed-effect
    shape: :func:`_path_check` on the main path's inputs, with the bound
    from the bytes (X, the aux columns, w in, the gradient, the value and
    Σr out) and 4 n d operations."""
    n, d = x.shape
    nbytes = n * d * x.element_size() + n_aux_bytes + 4 * d + 4 * d + 8
    check = _path_check(torch, name, kernel, plain, library, limits, nbytes, x.shape, slack)
    return {"name": name, "route": "cuda", "source": "photon_ml_torch/csrc/packed_glm.cu",
            "replaces": replaces, "launches": launches, **check,
            "eager_ms": _eager_ms(torch, kernel), "dtype": str(x.dtype).replace("torch.", ""),
            "bytes": nbytes, **extra}


#: the form of each of probes 1-3 that its kernels-line entry times: probe
#: 1's bf16 tensor-core form (mma_tf32 margins, bf16 mma gradient), its bf16
#: workaround with w and r in bf16 (P2) and its cast-up TF32 product (P3)
PROBE_ENTRY_VARIANT = {"P1": "P1 mxu/mxu t1024 bf16", "P2": "P2 mxu_w128/mxu_r128 t1024 bf16",
                       "P3": "P3 mxu_cast/mxu_cast t512 bf16"}


def _probe_entries(probe_rows) -> list:
    """The P1, P2 and P3 entries of the kernels line from the probe study's
    rows at [2^17, 512]: the entry variant's times, every variant's launches
    (its gradient steps) summed, the worst error over the probe's variants
    as a share of its limit, and each variant's times, bound and share. The
    bound counts X, y, ws and w read once and the gradient and value written
    once."""
    from dev import torch_kernel_probe

    library = {r["dtype"]: r["library_ms"] for r in probe_rows if "library_ms" in r}
    entries = []
    for probe, replaces in torch_kernel_probe.PROBE_REPLACES.items():
        rows = [r for r in probe_rows if r.get("kernel") == probe]
        main = next(r for r in rows if r["variant"] == PROBE_ENTRY_VARIANT[probe])
        n, d = main["shape"]

        def bound_of(r):
            itemsize = 2 if r["dtype"] == "bfloat16" else 4
            return _bound_ms(n * d * itemsize + 8 * n + 8 * d + 4, 4.0 * n * d)

        bound, by = bound_of(main)
        worst = max(rows, key=lambda r: r["limit_share"])
        entries.append({
            "name": f"packed_glm[{probe}]", "route": "cuda",
            "source": "photon_ml_torch/csrc/packed_glm.cu", "replaces": replaces,
            "launches": sum(r["launches"] for r in rows),
            "max_abs_err": max(r["grad_abs"] for r in rows),
            "worst_err_share_of_limit": worst["limit_share"], "worst_variant": worst["variant"],
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": bound, "bound_by": by,
            "library_ms": library[main["dtype"]], "shape": [n, d], "dtype": main["dtype"],
            "form": f"{main['variant']}: columns, no o, no Σr, {main['margin_unit']}/"
                    f"{main['grad_unit']}, w rounded {main['round_w']}",
            "variants": [{"variant": r["variant"], "units": [r["margin_unit"], r["grad_unit"]],
                          "ms": r["ms"], "plain_ms": r["plain_ms"],
                          "bound_ms": bound_of(r)[0], "library_ms": library[r["dtype"]],
                          "err_share_of_limit": r["limit_share"]} for r in rows]})
    return entries


def _game_slice(torch, np, seed: int, dev, card: str) -> list:
    """The GAME slice at full width, printing as it goes. Returns the
    packed_glm entries of the kernels line."""
    from dev import torch_kernel_probe
    from photon_ml_torch.evaluation import local_metrics
    from photon_ml_torch.ops import packed_glm
    from photon_ml_torch.ops.losses import LogisticLoss
    from photon_ml_torch.optim import newton

    # a. the operand-form and unit study at the probes' shape (a phase of its own)
    for name in ("packed_launches", "mma_launches", "columns_launches", "reduce_launches"):
        setattr(packed_glm, name, 0)
    t0 = time.perf_counter()
    probe_rows = torch_kernel_probe.run(torch, _device_ms, seed, dev)
    for row in probe_rows:
        _log(f"kernel probe: {json.dumps(row)}")
    probe_launches = {name: getattr(packed_glm, name) for name in
                      ("packed_launches", "mma_launches", "columns_launches")}
    assert all(v > 0 for v in probe_launches.values()), probe_launches
    _log(f"kernel probe phase: {time.perf_counter() - t0:.2f} s, launches {probe_launches}")

    # b. the positive-definite solve of the Newton lanes at [2000, 16, 16]
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(2000, 32, 16, device=dev, generator=gen)
    h = torch.einsum("bnd,bne->bde", a, a) + torch.eye(16, device=dev)
    g = torch.randn(2000, 16, device=dev, generator=gen)
    p_chol, ok = newton.solve_pd(h, g)
    p_gj = newton.solve_pd_gauss_jordan(h, g)
    gap = float((p_chol - p_gj).abs().max() / p_gj.abs().max())
    assert bool(ok.all()) and gap <= 1e-4, f"Cholesky solve off Gauss-Jordan by {gap}"
    # eager times: the batched Cholesky solve allocates inside the library
    # call and cannot be captured in a CUDA graph
    _log(f"Newton solve [2000, 16, 16] f32 ({card}): cholesky_ex + cholesky_solve "
         f"{_eager_ms(torch, lambda: newton.solve_pd(h, g)):.4f} ms, Gauss-Jordan elimination "
         f"{_eager_ms(torch, lambda: newton.solve_pd_gauss_jordan(h, g)):.4f} ms (eager, one "
         f"call as the lane loop makes it), max rel gap {gap:.3g}")
    del a, h, g

    # c. the fits at the flagship shape
    shape = GAME["flagship"]
    sweeps = shape["sweeps"]
    t0 = time.perf_counter()
    train, held = _game_arrays(np, seed, **shape)
    t_arrays = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = {task: _game_dataset(train, task, dev)
            for task in ("LOGISTIC_REGRESSION", "LINEAR_REGRESSION")}
    held_ds = _game_dataset(held, "LOGISTIC_REGRESSION", dev,
                            vocabs=data["LOGISTIC_REGRESSION"].entity_vocabs)
    torch.cuda.synchronize()
    _log(f"GAME data n={shape['n']} (+{shape['held_out']} held out) global d={shape['d_fe']} "
         f"per_entity d={shape['d_re']} users={shape['users']} items={shape['items']}: numpy "
         f"{t_arrays:.2f} s, build_game_dataset x3 {time.perf_counter() - t0:.2f} s")
    unseen = int((held_ds.entity_idx["user"] < 0).sum())
    assert unseen > 0, "the held-out rows should hold users never trained on"

    log, lin = "LOGISTIC_REGRESSION", "LINEAR_REGRESSION"
    fits = {}
    # warm up (kernel build caches, cuBLAS/cuSOLVER handles) outside the times
    _game_estimator(log, "NEWTON", 1).fit(data[log])
    _game_estimator(log, "LBFGS", 1, kernel_unit="mma").fit(data[log])
    for label, task, lanes, kw in (
            ("logistic lbfgs-lanes fma", log, "LBFGS", {}),
            ("logistic newton-lanes fma", log, "NEWTON", {}),
            ("logistic newton-lanes mma", log, "NEWTON", {"kernel_unit": "mma"}),
            ("logistic newton-lanes closed-form", log, "NEWTON", {"use_kernel": False}),
            ("linear lbfgs-lanes fma", lin, "LBFGS", {}),
            ("linear newton-lanes columns", lin, "NEWTON", {"kernel_aux": "columns"})):
        fits[label] = _game_fit(torch, label, _game_estimator(task, lanes, sweeps, **kw),
                                data[task], sweeps)
    fe_only = _game_fit(torch, "logistic fixed effect only", _game_estimator(
        log, "NEWTON", 1, random_effects=False), data[log], 1)

    def final(label):
        return fits[label]["loss_per_sweep"][-1]

    main = fits["logistic newton-lanes fma"]
    path_launches = {
        "P6": sum(f["launches"]["packed_launches"] - f["launches"]["mma_launches"]
                  for f in fits.values()),
        "P7": sum(f["launches"]["mma_launches"] for f in fits.values()),
        "P5": sum(f["launches"]["columns_launches"] for f in fits.values()),
        "reduce": sum(f["launches"]["reduce_launches"] for f in fits.values())}
    assert all(v > 0 for v in path_launches.values()), path_launches
    assert fits["logistic newton-lanes closed-form"]["launches"]["reduce_launches"] == 0
    gaps = {
        # the kernel and the closed form differ by f32 rounding only
        "kernel vs closed form": (_rel_gap(main["loss_per_sweep"][-1],
                                           final("logistic newton-lanes closed-form")), 1e-4),
        # TF32 operands perturb each evaluation by about 1e-6 relative; both
        # fits converge on the same optimum
        "fma vs mma": (_rel_gap(final("logistic newton-lanes mma"),
                                main["loss_per_sweep"][-1]), 1e-3),
        "lbfgs lanes vs newton lanes (logistic)": (_rel_gap(
            final("logistic lbfgs-lanes fma"), main["loss_per_sweep"][-1]), 1e-3),
        "lbfgs lanes vs newton lanes (linear)": (_rel_gap(
            final("linear lbfgs-lanes fma"), final("linear newton-lanes columns")), 1e-3)}
    _log("GAME final training loss, rel gaps (limit): " + ", ".join(
        f"{k} {v:.3g} ({lim:g})" for k, (v, lim) in gaps.items()))
    for k, (v, lim) in gaps.items():
        assert v <= lim, f"{k}: rel gap {v} > {lim}"

    held_y = held_ds.host_array("labels")
    aucs = {}
    for name, model in (("GAME", main["result"].model), ("fixed effect only",
                                                         fe_only["result"].model)):
        scores = model.score(held_ds)
        assert scores.shape == (shape["held_out"],) and bool(torch.isfinite(scores).all())
        aucs[name] = local_metrics.area_under_roc_curve(scores, held_y)
    train_scores = main["result"].model.score(data[log])
    assert train_scores.shape == (shape["n"],) and bool(torch.isfinite(train_scores).all())
    _log(f"GAME logistic AUC on {shape['held_out']} held-out rows ({unseen} of unseen users): "
         f"{aucs['GAME']:.6f} against the fixed effect alone {aucs['fixed effect only']:.6f}; "
         f"training AUC "
         f"{local_metrics.area_under_roc_curve(train_scores, data[log].host_array('labels')):.6f}")
    assert aucs["GAME"] > aucs["fixed effect only"] > 0.5, aucs

    share = _lane_loop_share(torch, _game_estimator(log, "LBFGS", 1), data[log])
    _log(f"lane loop, one per-user L-BFGS update [2000, 128, 16] ({card}): {json.dumps(share)}")
    share = _lane_loop_share(torch, _game_estimator(log, "NEWTON", 1), data[log])
    _log(f"lane loop, one per-user Newton update [2000, 128, 16] ({card}): {json.dumps(share)}")

    # d. the kernels at the shape and on the inputs the main path gives them
    ds = data[log]
    x = ds.feature_shards["global"]
    w = main["result"].model.get("fixed").glm.coefficients.means.float().contiguous()
    residual = main["result"].model.score(ds) - x @ w
    y, o, ws = ds.labels, (ds.offsets + residual).contiguous(), ds.weights
    aux = packed_glm.pack_aux(y, o, ws)
    loss = LogisticLoss()
    n = x.shape[0]
    r = torch.rand(n, device=dev)
    library = lambda: (torch.matmul(x, w), torch.matmul(r, x))  # noqa: E731
    # the TF32 variant (operands rounded to 10 mantissa bits against the
    # plain version's f32) is held to the f32 limits plus what TF32's
    # rounding can move each output by on these inputs
    tf32 = torch_kernel_probe.tf32_slack(loss, x, y, o, ws, w, None, "mma", "mma")
    p6 = "experiments/kernel_probe6.py:99"
    entries = [
        _packed_entry(torch, "packed_glm", p6, path_launches["P6"],
                      lambda: packed_glm.packed_core(loss, x, aux, w, with_rsum=False),
                      lambda: packed_glm.packed_core_reference(loss, x, aux, w, with_rsum=False),
                      library, x, 12 * n, torch_kernel_probe.limits("float32"),
                      form="packed aux, fma, no Σr (the GAME path's call)"),
        _packed_entry(torch, "packed_glm[mma]", "experiments/kernel_probe7.py:112",
                      path_launches["P7"],
                      lambda: packed_glm.packed_core(loss, x, aux, w, with_rsum=False,
                                                     margin_unit="mma", grad_unit="mma"),
                      lambda: packed_glm.packed_core_reference(
                          loss, x, aux, w, with_rsum=False, margin_unit="mma", grad_unit="mma"),
                      library, x, 12 * n, torch_kernel_probe.limits("float32"),
                      tf32, form="packed aux, mma (TF32) for both products"),
        _packed_entry(torch, "packed_glm[columns]", "experiments/kernel_probe5.py:121",
                      path_launches["P5"],
                      lambda: packed_glm.columns_core(loss, x, y, ws, o, w, with_rsum=False),
                      lambda: packed_glm.columns_core_reference(loss, x, y, ws, o, w,
                                                                with_rsum=False),
                      library, x, 12 * n, torch_kernel_probe.limits("float32"),
                      form="separate y, ws, o columns, no Σr"),
    ]
    p6_args = (loss, x, aux, None, None, None, w, None, True, "fma", "fma")
    entries.append({
        "name": "packed_glm_reduce", "route": "cuda",
        "source": "photon_ml_torch/csrc/glm_tile.cuh", "replaces": p6,
        "launches": path_launches["reduce"],
        **_reduce_entry(torch, "packed_glm_reduce", lambda: packed_glm.launch_partials(*p6_args),
                        packed_glm.reduce_partials, packed_glm.reduce_partials_reference)})
    keep = ("variant", "kernel", "dtype", "ms", "plain_ms", "frac")
    entries[0]["probe_shape_rows"] = [{k: r_[k] for k in keep if k in r_} for r_ in probe_rows
                                      if "ms" in r_]
    entries.extend(_probe_entries(probe_rows))
    del fits, fe_only, data, held_ds, train, held, x, aux, p6_args
    torch.cuda.empty_cache()

    # e. a small problem on the card (f32, the kernel) against the CPU (f64)
    small = GAME["small"]
    arrays, _ = _game_arrays(np, seed + 1, **small)
    got = {}
    for where, dtype in ((dev, None), ("cpu", np.float64)):
        ds = _game_dataset(arrays, log, where, dtype=dtype)
        model = _game_estimator(log, "NEWTON", small["sweeps"]).fit(ds).model
        got[str(where)] = torch.cat(
            [model.get("fixed").glm.coefficients.means.double().cpu()]
            + [model.get(c).coefficients.double().cpu().reshape(-1)
               for c in ("per_user", "per_item")])
    gap = float((got[str(dev)] - got["cpu"]).abs().max())
    scale = float(got["cpu"].abs().max())
    _log(f"small GAME problem n={small['n']}: card f32 vs cpu f64 max |dw| {gap:.3g} "
         f"(max |w| {scale:.3g})")
    assert gap <= 1e-3 * scale

    # f. the larger run: times for a later benchmark to start from
    shape = GAME["large"]
    t0 = time.perf_counter()
    train, _ = _game_arrays(np, seed + 2, **shape)
    t_arrays = time.perf_counter() - t0
    t0 = time.perf_counter()
    big = _game_dataset(train, log, dev)
    torch.cuda.synchronize()
    _log(f"large GAME data n={shape['n']} users={shape['users']} items={shape['items']}: numpy "
         f"{t_arrays:.2f} s, build_game_dataset {time.perf_counter() - t0:.2f} s")
    del train
    large = _game_fit(torch, "large logistic newton-lanes fma",
                      _game_estimator(log, "NEWTON", shape["sweeps"]), big, shape["sweeps"])
    assert large["launches"]["packed_launches"] > 0
    del big, large
    torch.cuda.empty_cache()
    return entries


#: phase 8's rows: the flagship GAME widths (bench.py:542-560) with the rows
#: cut to 8,192 training and 2,048 validation rows, users and items cut to
#: keep about the flagship's 66 and 87 rows per entity; the dense GLM width
#: (bench.py:59, 511 features plus the intercept) with 4,096 training and
#: 1,024 validation rows. The pure-Python Avro codec is the cost that cuts them.
DRIVERS = dict(game_rows=8192, validation_rows=2048, users=125, items=95, d_fe=255, d_re=16,
               glm_rows=4096, glm_validation_rows=1024, glm_d=512)


def _game_avro_schema():
    """TrainingExampleAvro with a second feature bag, ``perEntityFeatures``,
    for the per-user and per-item effects."""
    from photon_ml_torch.io import photon_schemas as schemas

    feature = f"{schemas.NAMESPACE}.FeatureAvro"
    return dict(schemas.TRAINING_EXAMPLE_AVRO, name="GameTrainingExampleAvro", fields=[
        *schemas.TRAINING_EXAMPLE_AVRO["fields"],
        {"name": "perEntityFeatures", "type": {"type": "array", "items": feature}}])


def _write_avro(path, schema, rows: int, make) -> float:
    """Write ``make(i)`` for i < rows into one container file; seconds."""
    from photon_ml_torch.io import avro

    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    avro.write_container(path, schema, (make(i) for i in range(rows)))
    return time.perf_counter() - t0


def _ntv(prefix, values):
    return [{"name": f"{prefix}{j}", "term": "", "value": v} for j, v in enumerate(values)]


def _path_check(torch, tag, kernel, plain, library, limits, nbytes: float, shape,
                slack=None) -> dict:
    """A value + gradient kernel held against its plain version on a path's
    own inputs: twice bitwise equal, the value within rel ``limits[0]``, the
    gradient within rtol 1e-4 and atol ``limits[1]`` times max|g|, each
    plus its part of ``slack`` where a product runs in TF32
    (``dev/torch_kernel_probe.tf32_slack``). Returns the errors, the largest
    error as a share of its limit, the device times of kernel, plain version
    and library call, and the bound (``nbytes`` moved, 4 operations per
    element of X)."""
    v1, g1 = kernel()[:2]
    v2, g2 = kernel()[:2]
    vr, gr = plain()[:2]
    torch.cuda.synchronize()
    assert torch.equal(v1, v2) and torch.equal(g1, g2), f"{tag}: not bitwise repeatable"
    vtol, gshare = limits
    v_slack, g_slack = (0.0, 0.0) if slack is None else slack[:2]
    gmax = float(gr.abs().max())
    value_err = abs(float(v1) - float(vr))
    value_limit = vtol * abs(float(vr)) + v_slack
    g_err = (g1.double() - gr.double()).abs()
    g_limit = 1e-4 * gr.double().abs() + gshare * gmax + g_slack
    share = max(value_err / value_limit, float((g_err / g_limit).max()))
    assert value_err <= value_limit, \
        f"{tag}: value off its plain version by {value_err} > {value_limit}"
    assert bool((g_err <= g_limit).all()), \
        f"{tag}: gradient off its plain version by {float(g_err.max())} (max |g| {gmax}, " \
        f"{share:.3g} of its limit)"
    bound, by = _bound_ms(nbytes, 4.0 * shape[0] * shape[1])
    return {"shape": list(shape), "max_abs_err": float(g_err.max()), "max_abs_gradient": gmax,
            "value_rel_err": value_err / abs(float(vr)), "limits": list(limits),
            "tf32_slack": slack is not None, "worst_err_share_of_limit": share,
            "ms": _device_ms(torch, kernel), "plain_ms": _device_ms(torch, plain),
            "bound_ms": bound, "bound_by": by, "library_ms": _device_ms(torch, library)}


def _reduce_entry(torch, tag, partials, reduce, reference) -> dict:
    """The ordered reduction of per-block partials (value, Σr or None, grad
    [blocks, d]): ``partials`` launches the partials kernel, ``reduce`` the
    reduction kernel on what it wrote; an evaluation launches both. The
    reduction's sums must be bitwise the order model's over those partials
    (``fused_glm.reduce_partials_in_order``: f32 adds on the card in the
    kernel's order), and within the worst case of two f32 orders of the same
    terms, 2·blocks·2^-24·Σ|terms|, of the plain sums (near an optimum the
    gradient is what is left of a cancellation). ``ms`` is the reduction's
    own cost, the evaluation's time less the partials' (both by graph
    replay), beside ``alone_ms``, the reduction kernel alone on fixed
    partials; the bound, plain and library times are those of summing the
    same partials."""
    from photon_ml_torch.ops import fused_glm

    parts = partials()
    got = reduce(*parts)
    order = fused_glm.reduce_partials_in_order(*parts)
    want = reference(*parts)
    torch.cuda.synchronize()
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, order)), \
        f"{tag}: the kernel's sums are not its order's"
    blocks, d = parts[2].shape
    share = 2.0 * blocks * 2.0 ** -24
    g_err = (got[1] - want[1]).abs()
    v_err = abs(float(got[0] - want[0]))
    assert bool((g_err <= share * parts[2].abs().sum(dim=0)).all()) \
        and v_err <= share * float(parts[0].abs().sum()), \
        f"{tag}: off its plain sums by {float(g_err.max())} (value {v_err})"
    err = max(float(g_err.max()), v_err)
    bound, by = _bound_ms(4.0 * (blocks + 1) * (d + 2), float(blocks * (d + 2)))
    sums = [p for p in parts if p is not None]  # the same sums as PyTorch calls
    whole_ms = _device_ms(torch, lambda: reduce(*partials()))
    partials_ms = _device_ms(torch, partials)
    return {"shape": [blocks, d], "blocks": blocks, "max_abs_err": err, "order_bitwise": True,
            "ms": whole_ms - partials_ms, "whole_ms": whole_ms, "partials_ms": partials_ms,
            "alone_ms": _device_ms(torch, lambda: reduce(*parts)),
            "plain_ms": _device_ms(torch, lambda: reference(*parts)), "bound_ms": bound,
            "bound_by": by, "library_ms": _device_ms(torch, lambda: [torch.sum(p, dim=0)
                                                                     for p in sums])}


def _driver_slice(torch, np, seed: int, dev, card: str) -> dict:
    """Phase 8: the three drivers end to end on Avro, printing as it goes.
    Returns, for each kernel this path runs, its launches there (the counts
    set to 0 just before each driver and read just after), the evaluations
    that launched it, and its check against its plain version on the
    path's own inputs (read back from the Avro the phase wrote), with times."""
    from dev import torch_kernel_probe
    from photon_ml_torch.algorithm import coordinates
    from photon_ml_torch.cli import game_scoring_driver, game_training_driver, glm_driver
    from photon_ml_torch.data.batch import LabeledPointBatch
    from photon_ml_torch.evaluation import local_metrics
    from photon_ml_torch.io import photon_schemas
    from photon_ml_torch.io.data_reader import FeatureShardConfiguration, read_merged
    from photon_ml_torch.io.index_map import INTERCEPT_KEY, IndexMap, feature_key
    from photon_ml_torch.io.model_io import load_game_model, read_scores
    from photon_ml_torch.ops import fused_glm, objective, packed_glm
    from photon_ml_torch.ops.losses import LogisticLoss
    from photon_ml_torch.util.timed import timing_summary

    cfg = DRIVERS
    _log(f"driver phase rows (cut from the flagship's, widths kept): GAME {cfg['game_rows']} "
         f"training + {cfg['validation_rows']} validation rows (flagship 2^17), {cfg['users']} "
         f"users and {cfg['items']} items (flagship 2000 and 1500); GLM {cfg['glm_rows']} + "
         f"{cfg['glm_validation_rows']} rows (bench.py 2^18); widths global 255 + intercept, "
         f"perEntity 16, GLM 511 + intercept")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # tensors earlier phases still hold
    path = {}
    evaluations = {"fused": 0, "packed": 0}
    loss = LogisticLoss()
    with tempfile.TemporaryDirectory(prefix="photon-drivers-") as tmp:
        tmp = Path(tmp)
        # a. TrainingExample Avro from --seed with the port's writer
        n, nv = cfg["game_rows"], cfg["validation_rows"]
        train, held = _game_arrays(np, seed + 3, n=n, d_fe=cfg["d_fe"], d_re=cfg["d_re"],
                                   users=cfg["users"], items=cfg["items"], held_out=nv)
        schema = _game_avro_schema()

        def game_record(part, offset):
            x_fe, x_re = part["x_fe"].tolist(), part["x_re"].tolist()
            y = part["labels"]["LOGISTIC_REGRESSION"].tolist()
            users, items = part["keys"]["user"].tolist(), part["keys"]["item"].tolist()
            return lambda i: {"uid": str(offset + i), "label": y[i],
                              "features": _ntv("g", x_fe[i]),
                              "perEntityFeatures": _ntv("e", x_re[i]), "weight": 1.0,
                              "offset": 0.0, "foldId": None,
                              "metadataMap": {"userId": users[i], "itemId": items[i]}}

        write_s = {"game training": _write_avro(tmp / "game/train/part-00000.avro", schema, n,
                                                game_record(train, 0)),
                   "game validation": _write_avro(tmp / "game/validation/part-00000.avro",
                                                  schema, nv, game_record(held, n))}
        ng, ngv, dg = cfg["glm_rows"], cfg["glm_validation_rows"], cfg["glm_d"]
        x, y = _dataset(np, seed + 4, ng + ngv, dg)
        xl, yl = x[:, :-1].tolist(), y.tolist()  # the last column is the driver's intercept

        def glm_record(offset):
            return lambda i: {"uid": str(offset + i), "label": yl[offset + i],
                              "features": _ntv("f", xl[offset + i]), "weight": 1.0,
                              "offset": 0.0, "foldId": None, "metadataMap": None}

        te = photon_schemas.TRAINING_EXAMPLE_AVRO
        write_s["glm training"] = _write_avro(tmp / "glm/train/part-00000.avro", te, ng,
                                              glm_record(0))
        write_s["glm validation"] = _write_avro(tmp / "glm/validation/part-00000.avro", te, ngv,
                                                glm_record(ng))
        rows_written = {"game training": n, "game validation": nv, "glm training": ng,
                        "glm validation": ngv}
        _log("Avro write (port's pure-Python codec): " + ", ".join(
            f"{k} {rows_written[k]} records in {v:.2f} s ({rows_written[k] / v:.0f} records/s)"
            for k, v in write_s.items()))
        del train, held, x, y, xl, yl

        # b. the GLM driver: B1 on every evaluation, the text model reloads
        value_and_gradient = objective.GLMObjective.value_and_gradient

        def counted_evaluation(self, coefficients, batch):
            evaluations["fused"] += int(self._kernel_enabled(batch))
            return value_and_gradient(self, coefficients, batch)

        objective.GLMObjective.value_and_gradient = counted_evaluation
        fused_glm.launches = fused_glm.reduce_launches = 0
        t0 = time.perf_counter()
        try:
            glm = glm_driver.main([
                "--input-data-path", str(tmp / "glm/train"),
                "--validation-data-path", str(tmp / "glm/validation"),
                "--output-dir", str(tmp / "glm/out"), "--task-type", "LOGISTIC_REGRESSION",
                "--regularization-weights", "1,10", "--optimizer", "LBFGS",
                "--max-iterations", "50"], device=dev)
            torch.cuda.synchronize()
        finally:
            objective.GLMObjective.value_and_gradient = value_and_gradient
        glm_s = time.perf_counter() - t0
        glm_times = timing_summary()
        fused_launches = {"fused_glm": fused_glm.launches,
                          "fused_glm_reduce": fused_glm.reduce_launches}
        assert fused_launches["fused_glm"] == evaluations["fused"] > 0 \
            and fused_launches["fused_glm_reduce"] == evaluations["fused"], \
            (fused_launches, evaluations)
        assert glm.stage.name == "VALIDATED" and glm.best_lambda in (1.0, 10.0)
        imap = IndexMap.from_keys({feature_key(f"f{j}", "") for j in range(dg - 1)},
                                  add_intercept=True)
        for lam, model in glm.models.items():
            w = model.coefficients.means.cpu().numpy()
            lines = (tmp / "glm/out/models-text" / f"{lam}.txt").read_text().splitlines()
            assert len(lines) == dg == w.shape[0]
            for line in lines:
                name, term, value = line.split("\t")
                assert float(value) == float(w[imap.get_index(feature_key(name, term))]), line
        assert imap.get_index(INTERCEPT_KEY) == dg - 1
        aucs = {lam: m["AUC"] for lam, m in glm.validation_metrics.items()}
        assert all(0.6 < a <= 1.0 for a in aucs.values()), aucs
        _log(f"GLM driver ({card}): {glm_s:.2f} s, {fused_launches['fused_glm']} fused_glm "
             f"launches for {evaluations['fused']} evaluations, validation AUC "
             f"{json.dumps(aucs)}, best λ {glm.best_lambda}; stages "
             + json.dumps({k: round(v['total'], 4) for k, v in glm_times.items()}))

        # B1 on the GLM driver's own batch, read back from its Avro, at each
        # λ's trained coefficients
        read = read_merged(tmp / "glm/train",
                           {"features": FeatureShardConfiguration(feature_bags=("features",))},
                           device=dev).dataset
        batch = LabeledPointBatch(features=read.feature_shards["features"], labels=read.labels,
                                  offsets=read.offsets, weights=read.weights)
        x = batch.features
        assert tuple(x.shape) == (ng, dg), x.shape
        r = torch.rand(ng, device=dev)
        for lam, model in sorted(glm.models.items()):
            w = model.coefficients.means.float()
            # the kernel computes the data term; the driver's L2 term is added
            # after it, and at the optimum would cancel X'r down to noise
            kw = dict(l2_weight=0.0)
            check = _path_check(
                torch, f"fused_glm on the GLM driver's batch, λ={lam}",
                lambda: fused_glm.fused_value_and_gradient(loss, w, batch, **kw),
                lambda: fused_glm.fused_value_and_gradient_reference(loss, w, batch, **kw),
                lambda: (torch.matmul(x, w), torch.matmul(r, x)), (1e-5, 1e-4),
                ng * dg * 4 + 12 * ng + 8 * dg + 8, x.shape)
            _log(f"fused_glm on the GLM driver's batch [{ng}, {dg}] λ={lam} ({card}): "
                 + json.dumps(check))
            if lam == glm.best_lambda:
                path["fused_glm"] = dict(check, launches=fused_launches["fused_glm"],
                                         evaluations=evaluations["fused"], reg_weight=lam)
                glm_args = (loss, x, batch.labels.float(), batch.offsets.float(),
                            batch.weights.float(), w, None)
                path["fused_glm_reduce"] = dict(
                    _reduce_entry(torch, "fused_glm_reduce on the GLM driver's batch",
                                  lambda: fused_glm.fused_partials(*glm_args),
                                  fused_glm.reduce_partials,
                                  fused_glm.reduce_partials_reference),
                    launches=fused_launches["fused_glm_reduce"],
                    evaluations=evaluations["fused"])
        del read, batch, x, r, glm_args

        # c. the GAME training driver: every fixed-effect update launches the
        # packed kernel; the best model beats its fixed effect alone
        for name in ("packed_launches", "mma_launches", "columns_launches", "reduce_launches"):
            setattr(packed_glm, name, 0)
        per_update = []
        update = coordinates.FixedEffectCoordinate.update_model

        def counted(self, *args, **kw):
            before = packed_glm.packed_launches
            out = update(self, *args, **kw)
            per_update.append(packed_glm.packed_launches - before)
            return out

        packed_evaluation = objective.PackedBoundObjective.value_and_grad

        def counted_packed(self, w):
            evaluations["packed"] += int(self.aux is not None)
            return packed_evaluation(self, w)

        coordinates.FixedEffectCoordinate.update_model = counted
        objective.PackedBoundObjective.value_and_grad = counted_packed
        shards = ["--feature-shard-configurations",
                  "name=global,feature.bags=features,intercept=true",
                  "--feature-shard-configurations",
                  "name=per_entity,feature.bags=perEntityFeatures,intercept=false"]
        re_spec = ("feature.shard=per_entity,reg.weights=1,optimizer=NEWTON,max.iter=10,"
                   "random.effect.type=")
        t0 = time.perf_counter()
        try:
            game = game_training_driver.main([
                "--input-data-path", str(tmp / "game/train"),
                "--validation-data-path", str(tmp / "game/validation"),
                "--root-output-dir", str(tmp / "game/out"), "--task-type",
                "LOGISTIC_REGRESSION", *shards,
                "--coordinate-configurations",
                "name=fixed,feature.shard=global,reg.weights=1|10,max.iter=10",
                "--coordinate-configurations", f"name=per_user,{re_spec}userId",
                "--coordinate-configurations", f"name=per_item,{re_spec}itemId",
                "--coordinate-descent-iterations", "2", "--evaluators", "AUC"], device=dev)
            torch.cuda.synchronize()
        finally:
            coordinates.FixedEffectCoordinate.update_model = update
            objective.PackedBoundObjective.value_and_grad = packed_evaluation
        game_s = time.perf_counter() - t0
        packed_launches = {"packed_glm": packed_glm.packed_launches,
                           "packed_glm_reduce": packed_glm.reduce_launches}
        assert len(per_update) == 2 * 2 and min(per_update) > 0, per_update
        assert packed_launches["packed_glm"] == evaluations["packed"] == sum(per_update) \
            and packed_launches["packed_glm_reduce"] == evaluations["packed"], \
            (packed_launches, evaluations, per_update)
        assert game["num_configurations"] == 2
        # configuration 0 starts cold (the later one warm-starts from it), so
        # its first update scores the fixed effect alone, random effects at 0
        fe_alone = game["metric_history"][0]["metrics"][0]
        assert fe_alone["iteration"] == 0 and fe_alone["coordinate"] == "fixed"
        assert game["best_metric"] > fe_alone["validate:AUC"] > 0.5, (game["best_metric"],
                                                                     fe_alone)
        _log(f"GAME training driver ({card}): {game_s:.2f} s, fixed-effect updates launched "
             f"{per_update} packed kernels ({evaluations['packed']} evaluations), validation AUC {game['best_metric']:.6f} (λ "
             f"{game['best_reg_weights']}) against the fixed effect alone "
             f"{fe_alone['validate:AUC']:.6f}; stages "
             + json.dumps({k: round(v["total"], 4) for k, v in game["timings"].items()}))
        read_s = game["timings"]["avro decode"]["total"]

        # d. the scoring driver on the saved best model
        t0 = time.perf_counter()
        scored = game_scoring_driver.main([
            "--input-data-path", str(tmp / "game/validation"),
            "--model-input-dir", str(tmp / "game/out/best"),
            "--output-dir", str(tmp / "game/scored"), "--evaluators", "AUC", *shards],
            device=dev)
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        score_times = timing_summary()
        avro_scores = np.asarray([r["predictionScore"]
                                  for r in read_scores(tmp / "game/scored/scores")])
        maps = IndexMap.load_directory(tmp / "game/out/index-maps")
        model = load_game_model(tmp / "game/out/best", maps, device=dev)
        vocabs = {m.random_effect_type: m.entity_keys for m in model.models.values()
                  if hasattr(m, "entity_keys")}
        shard_cfg = {"global": FeatureShardConfiguration(feature_bags=("features",)),
                     "per_entity": FeatureShardConfiguration(feature_bags=("perEntityFeatures",),
                                                             has_intercept=False)}
        ds = read_merged(tmp / "game/validation", shard_cfg, index_maps=maps,
                         random_effect_id_columns=("itemId", "userId"), entity_vocabs=vocabs,
                         device=dev).dataset
        in_process = (model.score(ds) + ds.offsets).cpu().numpy()
        assert avro_scores.shape == (nv,) and np.isfinite(avro_scores).all()
        # the scores are written as the doubles their f32 values are: bitwise
        assert np.array_equal(avro_scores, in_process.astype(np.float64)), \
            float(np.abs(avro_scores - in_process).max())
        auc_file = local_metrics.area_under_roc_curve(avro_scores, ds.host_array("labels"))
        # the saved model drops coefficients under 1e-4 (the reference's
        # sparsity threshold), so its AUC may move in the last digits
        gap = abs(scored["evaluations"]["AUC"] - game["best_metric"])
        assert gap <= 1e-4 and abs(auc_file - scored["evaluations"]["AUC"]) <= 1e-12, \
            (scored["evaluations"], game["best_metric"], auc_file)
        _log(f"GAME scoring driver ({card}): {score_s:.2f} s, {nv} scores bitwise equal to the "
             f"loaded model's in-process scores, AUC {scored['evaluations']['AUC']:.6f} (training "
             f"driver's validation AUC {game['best_metric']:.6f}, gap {gap:.3g}); stages "
             + json.dumps({k: round(v["total"], 4) for k, v in score_times.items()}))

        # the packed kernel on the GAME driver's fixed-effect inputs, read
        # back from its training Avro, at the best model's coefficients with
        # the random effects' scores as residual offsets (the last sweep's)
        ds = read_merged(tmp / "game/train", shard_cfg, index_maps=maps,
                         random_effect_id_columns=("itemId", "userId"), entity_vocabs=vocabs,
                         device=dev).dataset
        x = ds.feature_shards["global"]
        assert tuple(x.shape) == (n, cfg["d_fe"] + 1), x.shape
        w = model.get("fixed").glm.coefficients.means.float().contiguous()
        aux = packed_glm.pack_aux(ds.labels, ds.offsets + model.score(ds) - x @ w, ds.weights)
        r = torch.rand(n, device=dev)
        check = _path_check(
            torch, "packed_glm on the GAME driver's fixed effect",
            lambda: packed_glm.packed_core(loss, x, aux, w, with_rsum=False),
            lambda: packed_glm.packed_core_reference(loss, x, aux, w, with_rsum=False),
            lambda: (torch.matmul(x, w), torch.matmul(r, x)),
            torch_kernel_probe.limits("float32"),
            x.shape[0] * x.shape[1] * 4 + 12 * n + 8 * x.shape[1] + 8, x.shape)
        path["packed_glm"] = dict(check, launches=packed_launches["packed_glm"],
                                  evaluations=evaluations["packed"])
        fe_args = (loss, x, aux, None, None, None, w, None, False, "fma", "fma")
        path["packed_glm_reduce"] = dict(
            _reduce_entry(torch, "packed_glm_reduce on the GAME driver's fixed effect",
                          lambda: packed_glm.launch_partials(*fe_args),
                          packed_glm.reduce_partials, packed_glm.reduce_partials_reference),
            launches=packed_launches["packed_glm_reduce"], evaluations=evaluations["packed"])
        _log(f"packed_glm on the GAME driver's fixed effect {list(x.shape)} ({card}): "
             + json.dumps(path["packed_glm"]))
        del ds, x, aux, r, fe_args
        _log(f"driver phase ({card}): Avro decode {n / read_s:.0f} records/s ({n} GAME training "
             f"records of 272 features in {read_s:.2f} s), write "
             f"{rows_written['game training'] / write_s['game training']:.0f} records/s; peak "
             f"device memory {(torch.cuda.max_memory_allocated() - resident) / 2**20:.1f} MiB "
             f"above the {resident / 2**20:.1f} MiB earlier phases still hold")
    return path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from photon_ml_torch import build
    from photon_ml_torch.data.batch import LabeledPointBatch
    from photon_ml_torch.estimators import train_glm
    from photon_ml_torch.evaluation import local_metrics
    from photon_ml_torch.ops import fused_glm, losses
    from photon_ml_torch.ops.normalization import (
        NormalizationContext,
        NormalizationType,
        build_normalization,
    )
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.types import TaskType

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    _log(card)
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    dev = torch.device("cuda")

    # 2. build
    t0 = time.perf_counter()
    built = build.build_all()
    _log(f"build: {json.dumps(built)} ({time.perf_counter() - t0:.2f} s); B1's tile plan at "
         f"d=512: f32 {fused_glm.tile_plan(512, torch.float32)}, bf16 "
         f"{fused_glm.tile_plan(512, torch.bfloat16)}; one pass to d=8192: "
         f"{fused_glm.tile_plan(8192, torch.float32)}")

    # 3. kernels against their plain versions
    worst = _kernel_cases(torch, fused_glm, losses, LabeledPointBatch, NormalizationContext,
                          args.seed)
    _log(f"kernel checks: {json.dumps(worst)}")

    # 4. the slice at n=2^18, d=512
    n, d = 1 << 18, 512
    t0 = time.perf_counter()
    x_np, y_np = _dataset(np, args.seed, n, d)
    batch = LabeledPointBatch.create(x_np, y_np, device=dev)
    batch16 = LabeledPointBatch.create(x_np, y_np, dtype=torch.bfloat16, device=dev)
    del x_np
    xd = batch.features.double()
    norm = build_normalization(
        NormalizationType.STANDARDIZATION, mean=xd.mean(0), variance=xd.var(0),
        max_magnitude=xd.abs().amax(0), intercept_index=d - 1)
    norm = NormalizationContext(norm.factors.float(), norm.shifts.float())
    del xd
    torch.cuda.synchronize()
    _log(f"dataset n={n} d={d}: {time.perf_counter() - t0:.2f} s")

    task = TaskType.LOGISTIC_REGRESSION
    solves = []

    def run(label, b, use_kernel=None, **kw):
        marks = {"t": time.perf_counter(), "launches": fused_glm.launches}

        def on_solve(lam, result):
            torch.cuda.synchronize()
            now = time.perf_counter()
            hist = result.value_history[: result.iterations + 1].double().cpu().numpy()
            solves.append({"run": label, "lambda": lam, "seconds": now - marks["t"],
                           "evaluations": fused_glm.launches - marks["launches"],
                           "iterations": result.iterations, "reason": result.reason,
                           "value": float(result.value), "history": hist})
            marks.update(t=now, launches=fused_glm.launches)

        return train_glm(b, task, normalization=norm, intercept_index=d - 1,
                         use_kernel=use_kernel, on_solve=on_solve, **kw)

    lbfgs20 = OptimizerConfig(OptimizerType.LBFGS, max_iterations=20)
    fused_glm.launches = fused_glm.reduce_launches = 0
    models = run("lbfgs", batch, optimizer=lbfgs20, regularization_weights=(1.0, 10.0))
    run("owlqn", batch, optimizer=lbfgs20, regularization_weights=(1.0,), elastic_net_alpha=0.5)
    run("tron", batch, optimizer=OptimizerConfig(OptimizerType.TRON, max_iterations=5,
                                                 tolerance=1e-5),
        regularization_weights=(1.0,))
    run("lbfgs_bf16", batch16, optimizer=lbfgs20, regularization_weights=(1.0,))
    torch.cuda.synchronize()
    launches, reduce_launches = fused_glm.launches, fused_glm.reduce_launches
    iterations = sum(s["iterations"] for s in solves)
    _log(f"main path: {len(solves)} solves, {iterations} iterations, {launches} fused_glm "
         f"launches, {reduce_launches} reduce launches")
    assert launches >= iterations > 0 and reduce_launches == launches
    for s in solves:
        h = s["history"]
        assert np.isfinite(h).all() and (np.diff(h) <= 0).all(), f"not decreasing: {s['run']}"
        assert s["evaluations"] > 0

    # the L-BFGS path again through the closed form: same final values
    kernel_values = [s["value"] for s in solves if s["run"] == "lbfgs"]
    run("lbfgs_closed_form", batch, use_kernel=False, optimizer=lbfgs20,
        regularization_weights=(1.0, 10.0))
    assert fused_glm.launches == launches  # the closed form launches no kernel
    closed_values = [s["value"] for s in solves if s["run"] == "lbfgs_closed_form"]
    for kv, cv in zip(kernel_values, closed_values):
        assert abs(kv - cv) <= 1e-4 * abs(cv), f"kernel {kv} vs closed form {cv}"

    scores = models[1.0].score(batch.features)
    assert scores.shape == (n,) and bool(torch.isfinite(scores).all())
    auc = local_metrics.area_under_roc_curve(scores, y_np)
    assert 0.6 < auc <= 1.0, auc

    # a small problem solved to convergence: card (kernel) against CPU (f64)
    xs, ys = _dataset(np, args.seed + 1, 4096, 64)
    small = {}
    for where, dtype in (("cuda", None), ("cpu", torch.float64)):
        b = LabeledPointBatch.create(xs, ys, dtype=dtype, device=where)
        small[where] = train_glm(b, task, regularization_weights=(1.0,))[1.0] \
            .coefficients.means.double().cpu()
    gap = float((small["cuda"] - small["cpu"]).abs().max())
    scale = float(small["cpu"].abs().max())
    _log(f"small problem n=4096 d=64: card vs cpu f64 max |dw| {gap:.3g} (max |w| {scale:.3g})")
    assert gap <= 1e-3 * scale

    # 6. times at the main path's shape and inputs (logistic, standardization):
    # "ms"/"plain_ms"/"library_ms" are device times (CUDA graph replay),
    # "eager_ms" the time of one call as the solver loop makes it
    loss = losses.LogisticLoss()
    w = models[1.0].coefficients.means.float()
    kw = dict(l2_weight=1.0, normalization=norm)
    timed = {}
    for b, label in ((batch, "float32"), (batch16, "bfloat16")):
        x = b.features
        nbytes = n * d * x.element_size() + 12 * n + 4 * d + 4 * d + 8
        bound, by = _bound_ms(nbytes, 4.0 * n * d)
        kernel = lambda: fused_glm.fused_value_and_gradient(loss, w, b, **kw)  # noqa: E731
        wx, r = w.to(x.dtype), torch.rand(n, device=dev).to(x.dtype)
        timed[label] = {
            "ms": _device_ms(torch, kernel),
            "plain_ms": _device_ms(
                torch, lambda: fused_glm.fused_value_and_gradient_reference(loss, w, b, **kw)),
            "bound_ms": bound, "bound_by": by,
            # the closed form's two products X@w and r'X, in X's dtype
            "library_ms": _device_ms(torch, lambda: (torch.matmul(x, wx), torch.matmul(r, x))),
            "eager_ms": _eager_ms(torch, kernel),
            "partials_ms": _device_ms(torch, lambda: fused_glm.fused_partials(
                loss, x, b.labels, b.offsets, b.weights, w, None)),
        }
    b1_args = (loss, batch.features, batch.labels, batch.offsets, batch.weights, w, None)
    line = {"kernels": [
        {"name": "fused_glm", "route": "cuda", "source": "photon_ml_torch/csrc/fused_glm.cu",
         "replaces": "photon_ml_tpu/ops/pallas_glm.py:128", "launches": launches,
         "max_abs_err": worst["main_grad_abs"], **timed["float32"], "shape": [n, d],
         "dtype": "float32", "bf16": timed["bfloat16"]},
        {"name": "fused_glm_reduce", "route": "cuda",
         "source": "photon_ml_torch/csrc/glm_tile.cuh",
         "replaces": "photon_ml_tpu/ops/pallas_glm.py:128", "launches": reduce_launches,
         **_reduce_entry(torch, "fused_glm_reduce", lambda: fused_glm.fused_partials(*b1_args),
                         fused_glm.reduce_partials, fused_glm.reduce_partials_reference)},
    ]}
    line["kernels"].extend(_wide_b1_entries(torch, fused_glm, loss, args.seed, card))
    for s in solves:
        _log(f"solve {s['run']} λ={s['lambda']:g}: {s['iterations']} iterations, reason "
             f"{s['reason']}, {s['evaluations']} evaluations in {s['seconds']:.4f} s "
             f"({s['evaluations'] / s['seconds']:.1f} evaluations/s), value {s['value']:.8g}")
    _log(f"AUC (λ=1, training data): {auc:.6f}")
    del batch, batch16, b1_args, models, scores
    torch.cuda.empty_cache()

    # 5. the sparse slice (its times are device times, as above)
    t0 = time.perf_counter()
    sparse_entries = _sparse_slice(torch, np, args.seed, dev, card)
    _log(f"sparse phases: {time.perf_counter() - t0:.2f} s")
    line["kernels"].extend(sparse_entries)

    # 7. the GAME slice
    t0 = time.perf_counter()
    line["kernels"].extend(_game_slice(torch, np, args.seed, dev, card))
    _log(f"GAME phases: {time.perf_counter() - t0:.2f} s")

    # 8. the drivers: each kernel of that path with its launches there, and
    # its check and times on that path's own inputs
    t0 = time.perf_counter()
    driver_path = _driver_slice(torch, np, args.seed, dev, card)
    _log(f"driver phase: {time.perf_counter() - t0:.2f} s, launches "
         + json.dumps({k: v["launches"] for k, v in driver_path.items()}))
    for entry in line["kernels"]:
        if entry["name"] in driver_path:
            entry["driver_path"] = driver_path[entry["name"]]
    assert all(any(e["name"] == k for e in line["kernels"]) for k in driver_path)
    _log(card)
    _log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
