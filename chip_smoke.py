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
7b. The projected GAME slice (``PROJECTED``): bench.py's flagship GAME shape
   with the per-user effect on a wider shard, ``per_user_wide`` (d=512,
   column 0 an intercept, each user owning 8-32 of columns 1-511, N(0,1)
   values there), the per-item effect IDENTITY on ``per_entity`` d=16,
   logistic labels from a planted fixed effect, per-user and per-item
   models, 4 sweeps through ``GameEstimator.fit`` with the fixed effect on
   the packed kernel: (a) INDEX_MAP with Newton lanes against IDENTITY over
   the 512 columns (one per-user update of each from the same model and
   residuals: training losses within rel 1e-5; the 4-sweep fits' final
   losses within rel 1e-4; on-support coefficients within 1e-3 max|w|,
   off-support ones exactly 0); (b) INDEX_MAP with
   STANDARDIZATION and full variances (finite and positive on each support,
   NaN off it); (c) RANDOM, projected_dim 64, scaled, L-BFGS lanes, full and
   diagonal variances (finite and positive); (d) INDEX_MAP with
   features_to_samples_ratio 0.25, the kernel's products on the tensor
   cores; (e) on ``per_entity``: Newton, TRON (through the separate-column
   form; final loss within rel 1e-3 of Newton's) and elastic-net OWL-QN
   lanes (L1 0.1). Every fit: training loss non-increasing, held-out AUC
   above the fixed effect's alone, the packed kernel launched on every
   fixed-effect evaluation. Printed: each bucket's bytes, seconds per sweep
   by coordinate, lane iteration histograms, one update's wall and device
   ms, kernels and host reads per lane kind; the packed kernel (P6, P7, P5)
   and its reduce held against their plain versions on this path's own
   fixed-effect inputs (the kernels line's ``projected_path``).
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
   within 1e-4 of the training driver's); the GAME training driver again
   with the per-user effect at ``projector=INDEX_MAP`` and ``reg.alpha`` 0.5
   (elastic-net lanes) and the scoring driver on its model (the same
   checks); then B1 on the GLM driver's batch
   and the packed kernel on the GAME driver's fixed-effect inputs, both read
   back from the Avro, at the trained coefficients: each held against its
   plain version (twice bitwise equal; phase 3's f32 limits) with its
   reduction, and timed (the kernels line's ``driver_path``); the time of
   each stage, records per second of the Avro codec and peak device
   memory. Then the sparse drivers (``SPARSE_DRIVERS``): (i) Avro whose
   ``features`` bag is a name-term bag at phase 9's distribution (rows cut
   to 8,192 + 2,048, users to 250), its index maps from the port's feature
   indexing driver (``--index-maps-dir``), the GAME training driver with a
   fixed effect and a compact per-user effect on that one sparse shard, and
   the scoring driver on its model loaded compact (Avro scores bitwise the
   loaded model's in-process scores); (ii) the GLM driver on LibSVM at
   LIBSVM a1a's widths (123 features, 14 a row, 1,605 rows; validation AUC
   above 0.6); (iii) the GAME training driver on pre-indexed LibSVM at full
   width (d=10^6, 2^16 rows of 16 entries), with the parse's records per
   second. On each GAME run's own data, after its launches are read, G1 is
   held against its plain version (per row 1e-5 Σ|v·w| in f64, twice
   bitwise equal): the training runs' fixed-effect margins and transposes
   (with their chunk plans) on the driver's training batch at its fitted
   coefficients and its compact scores, the scoring run's margins and
   compact scores on the validation rows. Their launches and checks join
   the kernels line's ``driver_path``. Every read of the phase takes the
   port's native Avro decoder (``avro_native.fallbacks`` must stay 0); the
   GAME and GLM training sets are read again with the Python codec
   (``PHOTON_NO_NATIVE_AVRO=1``) and must give equal arrays, with each
   codec's records per second; a GAME training driver run adds an MF
   coordinate (userId × itemId, k=16) and the scoring driver scores its
   model (Avro scores bitwise the in-process ones); a run with
   ``--input-date-range`` over two daily directories must write the
   one-directory run's model files byte for byte; and one GAME training run
   at the flagship's rows, uncut (2^17 + 2^15, the Avro written by a pool of
   the port's pure-Python writers, one part file each), prints its stages,
   with the packed kernel held on its own fixed-effect inputs.
9. The sparse GAME slice at bench.py:721's shapes (``SPARSE_GAME``, none
   cut): n=2^16 rows of 16 Zipf columns (γ=24) over d=10^6, values
   N(0,1)/4, 2000 users, linear labels, 2^14 held-out rows; a fixed effect
   (L-BFGS, 10 iterations, L2 1) and a per-user random effect on the same
   sparse shard, so compact (``[2000, K]`` over each user's active
   columns). Fits of 4 sweeps: (a) ELL fixed effect and L-BFGS lanes,
   twice (bitwise equal tables and scores); (b) a hybrid fixed effect (a
   256-column head) and Newton lanes; (c) SCALE_WITH_MAX_MAGNITUDE
   (pre-normalized compact blocks) and full variances (finite and positive
   on each support, NaN off it), L-BFGS lanes. Every fit: the training
   loss and the coordinate-descent objective non-increasing; the unscaled
   fits' held-out RMSE below the fixed effect's alone, the scaled fit's
   within 1% of the JAX package's at this size (``SCALED_FIT_REFERENCE``:
   its blocks overfit this data's rare columns there too).
   STANDARDIZATION on the compact effect is refused; a small problem's
   per-user Newton update on the card agrees with the CPU in f64 (1e-3
   max|w|). G1 is held against its plain version in f64 on the phase's own
   inputs (per row 1e-5 Σ|v·w|, twice bitwise equal): the fixed effect's
   margins and transposes (Zipf-hot columns through the chunk kernel) on
   fits a's and b's batches, and compact scoring on fit a's table and
   entries, which is also timed beside cuSPARSE (its own kernels-line
   entry; the path's launches and checks under ``sparse_game_path``). Printed: K and the bucket bytes, the host build
   seconds, seconds a sweep by coordinate, one lane update's wall and
   device ms and kernels.
10. Matrix factorization through ``GameEstimator.fit`` (``MF``), the fixed
   effect on the packed kernel, data from ``--seed``: (a) the flagship
   widths with a user × item MF coordinate (k=16, 2 alternations, L2 10)
   beside the fixed effect and the per-user effect, linear labels with a
   planted rank-16 user·item term, 4 sweeps with Newton MF lanes (twice:
   bitwise equal models), with L-BFGS MF lanes (final loss within rel 1e-3
   of Newton's) and without MF (the products on the tensor cores): training
   loss non-increasing, held-out RMSE (2^15 rows, a quarter of unseen users,
   whose MF scores must be exactly 0) below the fit's without MF; the packed
   kernel and its reduce held on the path's own [2^17, 256] inputs (the
   kernels line's ``mf_path``); (b) MovieLens-1M's published widths, none
   cut (6,040 users with Zipf-like counts of 20-2,314 ratings, 3,706
   movies, 1,000,209 ratings 1-5 from a planted rank-32 model; ``global``
   the one-hot of its attributes, d=49), fixed effect plus MF k=32, Newton,
   4 sweeps: loss non-increasing, held-out RMSE below the fixed effect's
   alone; printed: the MF buckets' shapes and bytes, the host builder's
   seconds, seconds a sweep by coordinate, one half-step's wall and device
   ms, kernels and host reads; (c) one MF update of a small problem (n=4096,
   k=4) from the same factors, card f32 against CPU f64 within
   1e-3·max|factor|.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
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
        from photon_ml_torch.algorithm import coordinates, mf_coordinate

        for cls in (coordinates.FixedEffectCoordinate, coordinates.RandomEffectCoordinate,
                    mf_coordinate.MatrixFactorizationCoordinate):
            self._wrap(cls, "update_model", lambda self_, *a, **k: f"solve {self_.coordinate_id}")
            self._wrap(cls, "score", lambda self_, *a, **k: "rescoring")
        for builder in ("build_random_effect_dataset", "build_mf_dataset"):
            self._wrap(estimators, builder, lambda *a, **k: "bucket builder")
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


def _profiled(torch, fn) -> dict:
    """Wall ms of ``fn()`` (synchronized, after one warm-up call), beside the
    device ms and kernel count of a third call under ``torch.profiler``, and
    the lane loops' host reads of one call."""
    from photon_ml_torch.optim import common

    fn()
    torch.cuda.synchronize()
    reads = common.lane_host_reads
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reads = common.lane_host_reads - reads
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    total = sum(device_us(e) for e in events)
    return {"wall_ms": wall * 1e3, "device_ms": total / 1e3 if total else None,
            "kernels": sum(e.count for e in events if device_us(e) > 0), "host_reads": reads,
            "host_share": None if not total else max(0.0, 1.0 - total / 1e6 / wall)}


def _lane_loop_share(torch, estimator, dataset) -> dict:
    """Where one random-effect update's wall time goes: :func:`_profiled`
    over one ``update_model`` of the per-user coordinate from its initial
    model."""
    _, coordinates = estimator._build_coordinates(dataset, None)
    coord = coordinates["per_user"]
    model = coord.initial_model()
    return _profiled(torch, lambda: coord.update_model(model, None))


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


#: the projected GAME slice: bench.py's flagship GAME shape with the per-user
#: effect on a wider shard, ``per_user_wide`` (d=512, column 0 an intercept,
#: each user owning 8-32 of columns 1-511)
PROJECTED = dict(n=1 << 17, d_fe=256, d_wide=512, d_re=16, users=2000, items=1500,
                 held_out=1 << 15, sweeps=4, owned=(8, 32), projected_dim=64, ratio=0.25,
                 l1=0.1)


def _projected_arrays(np, seed: int, n: int, d_fe: int, d_wide: int, d_re: int, users: int,
                      items: int, held_out: int, owned, **_):
    """:func:`_game_arrays`' layout plus ``per_user_wide``: each user owns
    ``owned`` columns of 1..d_wide-1 (drawn from ``seed``), its rows hold
    N(0, 1) values there, zeros elsewhere, 1 in column 0. Logistic labels
    from a planted fixed effect, a per-user model over each user's columns
    and a per-item effect on ``per_entity``; ``held_out`` more rows, a
    quarter of them of unseen users."""
    rng = np.random.default_rng(seed)
    total = n + held_out
    user_idx = rng.integers(0, users, size=total)
    item_idx = rng.integers(0, items, size=total)
    support = np.zeros((users, d_wide), dtype=bool)
    support[:, 0] = True
    for u in range(users):
        cols = rng.choice(d_wide - 1, size=int(rng.integers(owned[0], owned[1] + 1)),
                          replace=False)
        support[u, 1 + cols] = True
    x_wide = rng.standard_normal((total, d_wide), dtype=np.float32)
    x_wide *= support[user_idx]
    x_wide[:, 0] = 1.0
    x_fe = rng.standard_normal((total, d_fe), dtype=np.float32)
    x_re = rng.standard_normal((total, d_re), dtype=np.float32)
    w_fe = rng.normal(size=d_fe).astype(np.float32) / np.sqrt(d_fe)
    w_user = (0.5 * rng.normal(size=(users, d_wide)) * support).astype(np.float32)
    w_item = (0.5 * rng.normal(size=(items, d_re))).astype(np.float32)
    z = x_fe @ w_fe + np.einsum("nd,nd->n", x_wide, w_user[user_idx]) \
        + np.einsum("nd,nd->n", x_re, w_item[item_idx])
    y = (rng.uniform(size=total) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    keys = user_idx.copy()
    if held_out:
        keys[n + 3 * held_out // 4:] += users
    keys = {"user": np.char.add("u", keys.astype(str)),
            "item": np.char.add("i", item_idx.astype(str))}

    def part(lo, hi):
        return dict(shards={"global": x_fe[lo:hi], "per_user_wide": x_wide[lo:hi],
                            "per_entity": x_re[lo:hi]}, labels=y[lo:hi],
                    keys={t: k[lo:hi] for t, k in keys.items()})

    return part(0, n), part(n, total), support


def _projected_estimator(lanes: str, user_shard: str, sweeps: int, *, l1: float = 0.0,
                         max_iterations: int = 10, compute_variance: bool = False,
                         variance_mode: str = "auto", normalization: str = "NONE",
                         random_effects: bool = True, kernel_unit: str = "fma",
                         kernel_aux: str = "packed", **user):
    """bench.py's GAME configuration (``_game_estimator``) with the per-user
    effect on ``user_shard`` under ``user`` options (projector, width,
    Pearson ratio) and an L1 weight ``l1`` on both random effects."""
    from photon_ml_torch.algorithm.coordinates import CoordinateOptimizationConfig
    from photon_ml_torch.estimators import (
        FixedEffectCoordinateConfig,
        GameEstimator,
        RandomEffectCoordinateConfig,
    )
    from photon_ml_torch.ops.normalization import NormalizationType
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.types import TaskType

    def opt(kind, **kw):
        return CoordinateOptimizationConfig(
            optimizer=OptimizerConfig(OptimizerType[kind], max_iterations=max_iterations
                                      if kind == lanes else 10), l2_weight=1.0, **kw)

    re_opt = dict(l1_weight=l1, compute_variance=compute_variance, variance_mode=variance_mode)
    configs = {"fixed": FixedEffectCoordinateConfig("global", opt("LBFGS"))}
    if random_effects:
        configs["per_user"] = RandomEffectCoordinateConfig(
            "user", user_shard, opt(lanes, **re_opt), bucket_sizes=(GAME["cap"],), **user)
        configs["per_item"] = RandomEffectCoordinateConfig(
            "item", "per_entity", opt(lanes, l1_weight=l1), bucket_sizes=(GAME["cap"],))
    return GameEstimator(task=TaskType.LOGISTIC_REGRESSION, coordinate_configs=configs,
                         num_iterations=sweeps, normalization=NormalizationType[normalization],
                         intercept_indices={"per_user_wide": 0}, kernel_unit=kernel_unit,
                         kernel_aux=kernel_aux)


def _bucket_bytes(torch, estimator, dataset) -> dict:
    """Bytes of the per-user coordinate's bucket tensors as this estimator
    builds them, with the bucket shapes and the build's seconds."""
    t0 = time.perf_counter()
    _, coordinates = estimator._build_coordinates(dataset, None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    re = coordinates["per_user"].re_dataset
    fields = ("features", "labels", "weights", "entity_rows", "sample_rows", "col_index")
    total = sum(getattr(b, f).numel() * getattr(b, f).element_size() for b in re.buckets
                for f in fields if getattr(b, f) is not None)
    return {"projector": re.projector_type.value, "bytes": total,
            "shapes": [list(b.features.shape) for b in re.buckets], "build_seconds": seconds}


def _per_user_update(torch, estimator, dataset, model):
    """One update of ``estimator``'s per-user coordinate from ``model``'s
    per-user table with the residuals of ``model``'s other coordinates:
    (the training loss of the model it gives, the new table)."""
    from photon_ml_torch.evaluation.evaluators import EvaluationData, default_evaluator_for_task

    _, coordinates = estimator._build_coordinates(dataset, None)
    coord = coordinates["per_user"]
    others = model.get("fixed").score_dataset(dataset) + model.get("per_item").score_dataset(
        dataset)
    new, _ = coord.update_model(model.get("per_user"), others)
    total = (others + coord.score(new)).cpu().numpy() + dataset.host_array("offsets")
    data = EvaluationData(labels=dataset.host_array("labels"),
                          offsets=dataset.host_array("offsets"),
                          weights=dataset.host_array("weights"), ids=dataset.ids)
    return default_evaluator_for_task(estimator.task).evaluate(total, data), new.coefficients


def _projected_slice(torch, np, seed: int, dev, card: str) -> dict:
    """The projected GAME slice at the flagship shape: INDEX_MAP, RANDOM,
    Pearson selection, normalization and variances on the per-user effect,
    and OWL-QN and TRON lanes, each through ``GameEstimator.fit`` with the
    fixed effect on the packed kernel. Returns, for each kernel this path
    runs, its launches here and its check on the path's own fixed-effect
    inputs."""
    from dev import torch_kernel_probe
    from photon_ml_torch.data.game_data import build_game_dataset
    from photon_ml_torch.evaluation import local_metrics
    from photon_ml_torch.ops import packed_glm
    from photon_ml_torch.ops.losses import LogisticLoss

    shape = PROJECTED
    sweeps = shape["sweeps"]
    t0 = time.perf_counter()
    train, held, support = _projected_arrays(np, seed + 5, **shape)
    t_arrays = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = build_game_dataset(labels=train["labels"], feature_shards=train["shards"],
                            entity_keys=train["keys"], device=dev)
    held_ds = build_game_dataset(labels=held["labels"], feature_shards=held["shards"],
                                 entity_keys=held["keys"], entity_vocabs=ds.entity_vocabs,
                                 device=dev)
    torch.cuda.synchronize()
    owned = support.sum(axis=1) - 1
    _log(f"projected GAME data n={shape['n']} (+{shape['held_out']} held out) global "
         f"d={shape['d_fe']} per_user_wide d={shape['d_wide']} (each user owns {owned.min()}-"
         f"{owned.max()} columns, mean {owned.mean():.1f}, plus the intercept) per_entity "
         f"d={shape['d_re']} users={shape['users']} items={shape['items']}: numpy "
         f"{t_arrays:.2f} s, build_game_dataset x2 {time.perf_counter() - t0:.2f} s")
    del train, held

    # bucket bytes of the per-user coordinate under each projector
    buckets = {name: _bucket_bytes(torch, _projected_estimator("NEWTON", "per_user_wide", 1,
                                                               **kw), ds)
               for name, kw in (("IDENTITY", {}), ("INDEX_MAP", {"projector_type": "INDEX_MAP"}),
                                ("RANDOM", {"projector_type": "RANDOM",
                                            "projected_dim": shape["projected_dim"]}))}
    _log(f"per-user bucket bytes [{shape['users']} users, {GAME['cap']} slots] ({card}): "
         + json.dumps(buckets))
    torch.cuda.empty_cache()

    wide, im = "per_user_wide", {"projector_type": "INDEX_MAP"}
    rnd = {"projector_type": "RANDOM", "projected_dim": shape["projected_dim"]}
    # warm up outside the times (cuSOLVER and cuBLAS handles, the kernels)
    _projected_estimator("NEWTON", wide, 1, **im).fit(ds)
    _projected_estimator("TRON", "per_entity", 1).fit(ds)
    plan = {
        "a. index-map newton": ("NEWTON", wide, im),
        "a. identity d=512 newton": ("NEWTON", wide, {}),
        "b. index-map standardized, full variances": (
            "NEWTON", wide, dict(im, normalization="STANDARDIZATION", compute_variance=True,
                                 variance_mode="full")),
        "c. random k=64 scaled lbfgs, full variances": (
            "LBFGS", wide, dict(rnd, normalization="SCALE_WITH_STANDARD_DEVIATION",
                                compute_variance=True, variance_mode="full")),
        "c. random k=64 scaled lbfgs, diagonal variances": (
            "LBFGS", wide, dict(rnd, normalization="SCALE_WITH_STANDARD_DEVIATION",
                                compute_variance=True, variance_mode="diagonal")),
        "d. index-map pearson 0.25, mma": (
            "NEWTON", wide, dict(im, features_to_samples_ratio=shape["ratio"],
                                 kernel_unit="mma")),
        "e. per_entity newton": ("NEWTON", "per_entity", {}),
        "e. per_entity tron, columns": ("TRON", "per_entity", {"kernel_aux": "columns"}),
        "e. per_entity elastic-net owlqn": ("OWLQN", "per_entity", {"l1": shape["l1"]}),
    }
    fits = {}
    for label, (lanes, shard, kw) in plan.items():
        fits[label] = _game_fit(torch, label, _projected_estimator(lanes, shard, sweeps, **kw),
                                ds, sweeps)
        torch.cuda.empty_cache()
    fe_only = _game_fit(torch, "projected: fixed effect only", _projected_estimator(
        "NEWTON", wide, 1, random_effects=False), ds, 1)

    def final(label):
        return fits[label]["loss_per_sweep"][-1]

    def user_table(label):
        return fits[label]["result"].model.get("per_user")

    # a. INDEX_MAP against IDENTITY over the same 512 columns: the whole
    # fits, and one per-user update of each from the same model and residuals
    gap = _rel_gap(final("a. index-map newton"), final("a. identity d=512 newton"))
    t_im = user_table("a. index-map newton").coefficients.double().cpu().numpy()
    t_id = user_table("a. identity d=512 newton").coefficients.double().cpu().numpy()
    rows = np.array([int(k[1:]) for k in user_table("a. identity d=512 newton").entity_keys])
    on = support[rows]
    coef_gap = float(np.abs(t_im - t_id)[on].max())
    scale = float(np.abs(t_id).max())
    off_zero = bool((t_id[~on] == 0.0).all() and (t_im[~on] == 0.0).all())
    start = fits["a. identity d=512 newton"]["result"].model
    one = {name: _per_user_update(torch, _projected_estimator("NEWTON", wide, 1, **kw), ds, start)
           for name, kw in (("INDEX_MAP", im), ("IDENTITY", {}))}
    one_gap = _rel_gap(one["INDEX_MAP"][0], one["IDENTITY"][0])
    one_w = {k: v[1].double().cpu().numpy() for k, v in one.items()}
    one_coef_gap = float(np.abs(one_w["INDEX_MAP"] - one_w["IDENTITY"])[on].max())
    one_off_zero = bool((one_w["IDENTITY"][~on] == 0.0).all()
                        and (one_w["INDEX_MAP"][~on] == 0.0).all())
    _log(f"a. INDEX_MAP vs IDENTITY d={shape['d_wide']} ({card}): one per-user update from the "
         f"same model and residuals: training loss rel gap {one_gap:.3g} (limit 1e-5), "
         f"on-support coefficients max |dw| {one_coef_gap:.3g}; the {sweeps}-sweep fits: final "
         f"training loss rel gap {gap:.3g} (limit 1e-4: the fixed effect's L-BFGS stops at its "
         f"function tolerance, 1e-7, one iteration apart on f32-different residuals; "
         f"iterations {fits['a. index-map newton']['fe_iterations_per_solve']} and "
         f"{fits['a. identity d=512 newton']['fe_iterations_per_solve']}), on-support "
         f"coefficients max |dw| {coef_gap:.3g} (limit 1e-3 · max|w| = {1e-3 * scale:.3g}), "
         f"off-support coefficients exactly 0: {off_zero and one_off_zero}")
    assert one_gap <= 1e-5 and one_coef_gap <= 1e-3 * scale and one_off_zero
    assert gap <= 1e-4 and coef_gap <= 1e-3 * scale and off_zero

    # b. variances finite and positive on each support, NaN off it
    var_b = user_table("b. index-map standardized, full variances").variances
    var_b = var_b.double().cpu().numpy()
    assert np.isfinite(var_b[on]).all() and (var_b[on] > 0).all() and np.isnan(var_b[~on]).all()
    # c. RANDOM variances finite and positive, full and diagonal
    var_c = {mode: user_table(f"c. random k=64 scaled lbfgs, {mode} variances").variances
             .double().cpu().numpy() for mode in ("full", "diagonal")}
    for mode, v in var_c.items():
        assert np.isfinite(v).all() and (v > 0).all(), mode
    _log(f"b./c. variances ({card}): INDEX_MAP full on support {var_b[on].min():.4g}-"
         f"{var_b[on].max():.4g}, NaN off it; RANDOM full {var_c['full'].min():.4g}-"
         f"{var_c['full'].max():.4g}, diagonal {var_c['diagonal'].min():.4g}-"
         f"{var_c['diagonal'].max():.4g}")
    # e. TRON against Newton lanes
    gap_e = _rel_gap(final("e. per_entity tron, columns"), final("e. per_entity newton"))
    _log(f"e. TRON vs Newton lanes final training loss rel gap {gap_e:.3g} (limit 1e-3)")
    assert gap_e <= 1e-3

    held_y = held_ds.host_array("labels")
    aucs = {label: local_metrics.area_under_roc_curve(
        f["result"].model.score(held_ds), held_y) for label, f in fits.items()}
    fe_auc = local_metrics.area_under_roc_curve(fe_only["result"].model.score(held_ds), held_y)
    _log(f"projected GAME held-out AUC on {shape['held_out']} rows ({card}): "
         + json.dumps(aucs) + f"; fixed effect alone {fe_auc:.6f}")
    assert all(a > fe_auc > 0.5 for a in aucs.values()), (aucs, fe_auc)
    for label, f in fits.items():
        _log(f"projected fit {label} ({card}): seconds per sweep {f['seconds_per_sweep']:.4f}, "
             f"by coordinate {json.dumps(f['per_sweep'])}, rescoring "
             f"{f['rescoring_per_sweep']:.4f}, host rest {f['host_rest_per_sweep']:.4f}; lane "
             f"iterations {json.dumps(f['lane_iteration_histogram'])}")

    # the lanes' wall and device time per update, with kernels and host reads
    for label, (lanes, shard, kw) in plan.items():
        if "identity" in label or "diagonal" in label:
            continue
        est = _projected_estimator(lanes, shard, 1, **{k: v for k, v in kw.items()
                                                       if k not in ("kernel_unit",
                                                                    "kernel_aux")})
        share = _lane_loop_share(torch, est, ds)
        _log(f"lane loop, one per-user update, {label} ({card}): {json.dumps(share)}")

    # the kernels on this path's own fixed-effect inputs (fit a's model)
    model = fits["a. index-map newton"]["result"].model
    x = ds.feature_shards["global"]
    w = model.get("fixed").glm.coefficients.means.float().contiguous()
    o = (ds.offsets + model.score(ds) - x @ w).contiguous()
    aux = packed_glm.pack_aux(ds.labels, o, ds.weights)
    loss = LogisticLoss()
    n = x.shape[0]
    r = torch.rand(n, device=dev)
    library = lambda: (torch.matmul(x, w), torch.matmul(r, x))  # noqa: E731
    nbytes = n * x.shape[1] * 4 + 12 * n + 8 * x.shape[1] + 8
    limits = torch_kernel_probe.limits("float32")
    tf32 = torch_kernel_probe.tf32_slack(loss, x, ds.labels, o, ds.weights, w, None, "mma",
                                         "mma")
    launches = {k: sum(f["launches"][k] for f in fits.values())
                for k in ("packed_launches", "mma_launches", "columns_launches",
                          "reduce_launches")}
    path = {
        "packed_glm": dict(_path_check(
            torch, "packed_glm on the projected slice's fixed effect",
            lambda: packed_glm.packed_core(loss, x, aux, w, with_rsum=False),
            lambda: packed_glm.packed_core_reference(loss, x, aux, w, with_rsum=False),
            library, limits, nbytes, x.shape),
            launches=launches["packed_launches"] - launches["mma_launches"]),
        "packed_glm[mma]": dict(_path_check(
            torch, "packed_glm[mma] on the projected slice's fixed effect",
            lambda: packed_glm.packed_core(loss, x, aux, w, with_rsum=False, margin_unit="mma",
                                           grad_unit="mma"),
            lambda: packed_glm.packed_core_reference(loss, x, aux, w, with_rsum=False,
                                                     margin_unit="mma", grad_unit="mma"),
            library, limits, nbytes, x.shape, tf32), launches=launches["mma_launches"]),
        "packed_glm[columns]": dict(_path_check(
            torch, "packed_glm[columns] on the projected slice's fixed effect",
            lambda: packed_glm.columns_core(loss, x, ds.labels, ds.weights, o, w,
                                            with_rsum=False),
            lambda: packed_glm.columns_core_reference(loss, x, ds.labels, ds.weights, o, w,
                                                      with_rsum=False),
            library, limits, nbytes, x.shape), launches=launches["columns_launches"]),
    }
    fe_args = (loss, x, aux, None, None, None, w, None, False, "fma", "fma")
    path["packed_glm_reduce"] = dict(
        _reduce_entry(torch, "packed_glm_reduce on the projected slice's fixed effect",
                      lambda: packed_glm.launch_partials(*fe_args), packed_glm.reduce_partials,
                      packed_glm.reduce_partials_reference),
        launches=launches["reduce_launches"])
    assert all(v["launches"] > 0 for v in path.values()), {k: v["launches"]
                                                           for k, v in path.items()}
    _log(f"kernels on the projected slice's fixed effect {list(x.shape)} ({card}): "
         + json.dumps(path))
    del fits, fe_only, ds, held_ds, x, aux, model, fe_args
    torch.cuda.empty_cache()
    return path


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


def _write_game_part(args) -> float:
    """Write one GAME part file of ``_game_arrays`` rows (logistic labels,
    ``global`` and ``perEntityFeatures`` bags, user and item ids in the
    metadata map) with the port's pure-Python writer; seconds. A module
    function, so a process pool can run it."""
    path, x_fe, x_re, y, users, items, offset = args
    x_fe, x_re, y = x_fe.tolist(), x_re.tolist(), y.tolist()
    users, items = users.tolist(), items.tolist()
    return _write_avro(path, _game_avro_schema(), len(y), lambda i: {
        "uid": str(offset + i), "label": y[i], "features": _ntv("g", x_fe[i]),
        "perEntityFeatures": _ntv("e", x_re[i]), "weight": 1.0, "offset": 0.0, "foldId": None,
        "metadataMap": {"userId": users[i], "itemId": items[i]}})


def _game_parts(part, directory, offset: int, parts: int) -> list:
    """The pool arguments writing ``part``'s rows as ``parts`` part files
    of ``directory`` (row order kept across the sorted part names)."""
    n = len(part["labels"]["LOGISTIC_REGRESSION"])
    bounds = [n * i // parts for i in range(parts + 1)]
    return [(os.path.join(directory, f"part-{i:05d}.avro"), part["x_fe"][lo:hi],
             part["x_re"][lo:hi], part["labels"]["LOGISTIC_REGRESSION"][lo:hi],
             part["keys"]["user"][lo:hi], part["keys"]["item"][lo:hi], offset + lo)
            for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]))]


def _same_read(torch, np, a, b) -> None:
    """Two reads of the same files hold equal arrays (labels, offsets,
    weights, uids, shards, entity indices and vocabs, id columns, index maps
    and intercepts)."""
    da, db = a.dataset, b.dataset
    for name in ("labels", "offsets", "weights"):
        assert torch.equal(getattr(da, name), getattr(db, name)), name
    assert np.array_equal(da.unique_ids, db.unique_ids)
    assert set(da.feature_shards) == set(db.feature_shards)
    for k, v in da.feature_shards.items():
        assert torch.equal(v, db.feature_shards[k]), k
    assert set(da.entity_idx) == set(db.entity_idx)
    for t, v in da.entity_idx.items():
        assert torch.equal(v, db.entity_idx[t]) and np.array_equal(
            da.entity_vocabs[t], db.entity_vocabs[t]), t
    assert {k: list(v) for k, v in a.index_maps.items()} == \
        {k: list(v) for k, v in b.index_maps.items()}
    assert a.intercept_indices == b.intercept_indices


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
    from photon_ml_torch.io import avro_native, photon_schemas
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
    avro_native.fallbacks = 0  # every driver read below must take the native decoder
    with tempfile.TemporaryDirectory(prefix="photon-drivers-") as tmp:
        tmp = Path(tmp)
        # a. TrainingExample Avro from --seed with the port's writer
        n, nv = cfg["game_rows"], cfg["validation_rows"]
        train, held = _game_arrays(np, seed + 3, n=n, d_fe=cfg["d_fe"], d_re=cfg["d_re"],
                                   users=cfg["users"], items=cfg["items"], held_out=nv)
        # the training set in two part files: the date-range run reads one a day
        write_s = {"game training": sum(map(_write_game_part,
                                            _game_parts(train, tmp / "game/train", 0, 2))),
                   "game validation": sum(map(_write_game_part,
                                              _game_parts(held, tmp / "game/validation", n,
                                                          1)))}
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

        # e. the GAME training driver again, the per-user effect projected
        # (INDEX_MAP) with elastic-net (OWL-QN) lanes, and the scoring driver
        # on its saved model: the same checks as the run above
        for name in ("packed_launches", "mma_launches", "columns_launches", "reduce_launches"):
            setattr(packed_glm, name, 0)
        t0 = time.perf_counter()
        proj = game_training_driver.main([
            "--input-data-path", str(tmp / "game/train"),
            "--validation-data-path", str(tmp / "game/validation"),
            "--root-output-dir", str(tmp / "game/out-projected"), "--task-type",
            "LOGISTIC_REGRESSION", *shards,
            "--coordinate-configurations",
            "name=fixed,feature.shard=global,reg.weights=1|10,max.iter=10",
            "--coordinate-configurations",
            "name=per_user,feature.shard=per_entity,reg.weights=1,max.iter=10,"
            "projector=INDEX_MAP,reg.alpha=0.5,random.effect.type=userId",
            "--coordinate-configurations", f"name=per_item,{re_spec}itemId",
            "--coordinate-descent-iterations", "2", "--evaluators", "AUC"], device=dev)
        torch.cuda.synchronize()
        proj_s = time.perf_counter() - t0
        proj_launches = {"packed_glm": packed_glm.packed_launches,
                         "packed_glm_reduce": packed_glm.reduce_launches}
        assert proj_launches["packed_glm"] > 0 \
            and proj_launches["packed_glm_reduce"] == proj_launches["packed_glm"], proj_launches
        proj_fe = proj["metric_history"][0]["metrics"][0]
        assert proj_fe["coordinate"] == "fixed" and proj["best_metric"] > \
            proj_fe["validate:AUC"] > 0.5, (proj["best_metric"], proj_fe)
        game_scoring_driver.main([
            "--input-data-path", str(tmp / "game/validation"),
            "--model-input-dir", str(tmp / "game/out-projected/best"),
            "--output-dir", str(tmp / "game/scored-projected"), "--evaluators", "AUC",
            *shards], device=dev)
        proj_scores = np.asarray([r["predictionScore"]
                                  for r in read_scores(tmp / "game/scored-projected/scores")])
        proj_maps = IndexMap.load_directory(tmp / "game/out-projected/index-maps")
        proj_model = load_game_model(tmp / "game/out-projected/best", proj_maps, device=dev)
        proj_ds = read_merged(tmp / "game/validation", shard_cfg, index_maps=proj_maps,
                              random_effect_id_columns=("itemId", "userId"),
                              entity_vocabs={m.random_effect_type: m.entity_keys
                                             for m in proj_model.models.values()
                                             if hasattr(m, "entity_keys")},
                              device=dev).dataset
        proj_in_process = (proj_model.score(proj_ds) + proj_ds.offsets).cpu().numpy()
        assert np.array_equal(proj_scores, proj_in_process.astype(np.float64)), \
            float(np.abs(proj_scores - proj_in_process).max())
        _log(f"GAME training driver, per-user INDEX_MAP with elastic-net lanes ({card}): "
             f"{proj_s:.2f} s, {proj_launches['packed_glm']} packed kernels, validation AUC "
             f"{proj['best_metric']:.6f} (λ {proj['best_reg_weights']}) against the fixed "
             f"effect alone {proj_fe['validate:AUC']:.6f}; its {nv} Avro scores bitwise equal "
             f"to the loaded model's in-process scores")
        del proj_model, proj_ds

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
                                  evaluations=evaluations["packed"],
                                  projected_run_launches=proj_launches["packed_glm"])
        fe_args = (loss, x, aux, None, None, None, w, None, False, "fma", "fma")
        path["packed_glm_reduce"] = dict(
            _reduce_entry(torch, "packed_glm_reduce on the GAME driver's fixed effect",
                          lambda: packed_glm.launch_partials(*fe_args),
                          packed_glm.reduce_partials, packed_glm.reduce_partials_reference),
            launches=packed_launches["packed_glm_reduce"], evaluations=evaluations["packed"],
            projected_run_launches=proj_launches["packed_glm_reduce"])
        _log(f"packed_glm on the GAME driver's fixed effect {list(x.shape)} ({card}): "
             + json.dumps(path["packed_glm"]))
        del ds, x, aux, r, fe_args
        _log(f"driver phase ({card}): Avro decode {n / read_s:.0f} records/s ({n} GAME training "
             f"records of 272 features in {read_s:.2f} s), write "
             f"{rows_written['game training'] / write_s['game training']:.0f} records/s; peak "
             f"device memory {(torch.cuda.max_memory_allocated() - resident) / 2**20:.1f} MiB "
             f"above the {resident / 2**20:.1f} MiB earlier phases still hold")

        # g. the native decoder against the Python codec on the same files:
        # array for array, with each codec's records per second
        game_cfg = {"global": FeatureShardConfiguration(feature_bags=("features",)),
                    "per_entity": FeatureShardConfiguration(
                        feature_bags=("perEntityFeatures",), has_intercept=False)}
        glm_cfg = {"features": FeatureShardConfiguration(feature_bags=("features",))}
        codec_rates = {}
        for label, where, cfgs, ids, rows in (
                ("GAME training", tmp / "game/train", game_cfg, ("itemId", "userId"), n),
                ("GLM training", tmp / "glm/train", glm_cfg, (), ng)):
            reads, seconds = [], []
            for native in (True, False):
                if not native:
                    os.environ["PHOTON_NO_NATIVE_AVRO"] = "1"
                t0 = time.perf_counter()
                try:
                    reads.append(read_merged(where, cfgs, random_effect_id_columns=ids,
                                             device=dev))
                finally:
                    os.environ.pop("PHOTON_NO_NATIVE_AVRO", None)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
            _same_read(torch, np, *reads)
            codec_rates[label] = {"native_records_per_s": rows / seconds[0],
                                  "python_records_per_s": rows / seconds[1],
                                  "native_s": seconds[0], "python_s": seconds[1]}
            del reads
        assert avro_native.fallbacks == 0, avro_native.fallbacks
        _log(f"Avro read, native decoder against the Python codec ({card}): the datasets equal "
             f"array for array; " + json.dumps(codec_rates))

        # h. the GAME training driver with an MF coordinate (user × item, k=16)
        # beside the fixed effect, then the scoring driver on its saved model
        for name in ("packed_launches", "mma_launches", "columns_launches", "reduce_launches"):
            setattr(packed_glm, name, 0)
        t0 = time.perf_counter()
        mf_run = game_training_driver.main([
            "--input-data-path", str(tmp / "game/train"),
            "--validation-data-path", str(tmp / "game/validation"),
            "--root-output-dir", str(tmp / "game/out-mf"), "--task-type", "LOGISTIC_REGRESSION",
            *shards, "--coordinate-configurations",
            "name=fixed,feature.shard=global,reg.weights=1,max.iter=10",
            "--coordinate-configurations",
            "name=mf,mf.row.effect.type=userId,mf.col.effect.type=itemId,mf.latent.factors=16,"
            "reg.weights=10,max.iter=10",
            "--coordinate-descent-iterations", "2", "--evaluators", "AUC"], device=dev)
        torch.cuda.synchronize()
        mf_s = time.perf_counter() - t0
        mf_launches = {"packed_glm": packed_glm.packed_launches,
                       "packed_glm_reduce": packed_glm.reduce_launches}
        assert mf_launches["packed_glm"] > 0 \
            and mf_launches["packed_glm_reduce"] == mf_launches["packed_glm"], mf_launches
        assert os.path.isdir(tmp / "game/out-mf/best/matrix-factorization/mf/row-latent-factors")
        game_scoring_driver.main([
            "--input-data-path", str(tmp / "game/validation"),
            "--model-input-dir", str(tmp / "game/out-mf/best"),
            "--output-dir", str(tmp / "game/scored-mf"), "--evaluators", "AUC", *shards],
            device=dev)
        mf_scores = np.asarray([r["predictionScore"]
                                for r in read_scores(tmp / "game/scored-mf/scores")])
        mf_maps = IndexMap.load_directory(tmp / "game/out-mf/index-maps")
        mf_model = load_game_model(tmp / "game/out-mf/best", mf_maps, device=dev)
        mf_sub = mf_model.get("mf")
        mf_ds = read_merged(tmp / "game/validation", shard_cfg, index_maps=mf_maps,
                            random_effect_id_columns=("itemId", "userId"),
                            entity_vocabs={"userId": mf_sub.row_keys, "itemId": mf_sub.col_keys},
                            device=dev).dataset
        mf_in_process = (mf_model.score(mf_ds) + mf_ds.offsets).cpu().numpy()
        assert np.array_equal(mf_scores, mf_in_process.astype(np.float64)), \
            float(np.abs(mf_scores - mf_in_process).max())
        _log(f"GAME training driver with an MF coordinate (userId × itemId, k=16) ({card}): "
             f"{mf_s:.2f} s, {mf_launches['packed_glm']} packed kernels, validation AUC "
             f"{mf_run['best_metric']:.6f}, factors {list(mf_sub.row_factors.shape)} and "
             f"{list(mf_sub.col_factors.shape)}; the scoring driver's {nv} Avro scores bitwise "
             f"equal to the loaded model's in-process scores; stages "
             + json.dumps({k: round(v["total"], 4) for k, v in mf_run["timings"].items()}))
        del mf_model, mf_ds, mf_sub

        # i. --input-date-range over two daily directories equals the same
        # part files read as one directory
        for day, part in ((1, "part-00000.avro"), (2, "part-00001.avro")):
            daily = tmp / f"game/days/daily/2026/01/{day:02d}"
            daily.mkdir(parents=True)
            shutil.copy(tmp / "game/train" / part, daily / part)
        dated = {}
        for label, extra in (("one directory", ["--input-data-path", str(tmp / "game/train")]),
                             ("date range", ["--input-data-path", str(tmp / "game/days"),
                                             "--input-date-range", "20260101-20260102"])):
            dated[label] = game_training_driver.main([
                *extra, "--validation-data-path", str(tmp / "game/validation"),
                "--root-output-dir", str(tmp / f"game/out-{label.replace(' ', '-')}"),
                "--task-type", "LOGISTIC_REGRESSION", *shards, "--coordinate-configurations",
                "name=fixed,feature.shard=global,reg.weights=1,max.iter=10",
                "--coordinate-configurations", f"name=per_user,{re_spec}userId",
                "--coordinate-descent-iterations", "2", "--evaluators", "AUC"], device=dev)
        best_files = sorted(p.relative_to(tmp / "game/out-one-directory/best")
                            for p in (tmp / "game/out-one-directory/best").rglob("*")
                            if p.is_file())
        for f in best_files:
            assert (tmp / "game/out-one-directory/best" / f).read_bytes() == \
                (tmp / "game/out-date-range/best" / f).read_bytes(), f
        assert dated["date range"]["best_metric"] == dated["one directory"]["best_metric"]
        _log(f"GAME training driver with --input-date-range 20260101-20260102 over two daily "
             f"directories ({card}): validation AUC {dated['date range']['best_metric']:.6f}, "
             f"its {len(best_files)} model files byte-identical to the one-directory run's")
        assert avro_native.fallbacks == 0, avro_native.fallbacks

        # j. the GAME training driver at the flagship's rows, uncut: Avro
        # written by a pool of the port's pure-Python writers, one part each
        path["packed_glm"].update(mf_run_launches=mf_launches["packed_glm"])
        path["packed_glm_reduce"].update(mf_run_launches=mf_launches["packed_glm_reduce"])
        path["packed_glm"]["flagship_run"] = _flagship_driver_run(
            torch, np, seed, dev, tmp, card, shards, re_spec)
        assert avro_native.fallbacks == 0, avro_native.fallbacks

        # f. the sparse drivers: sparse Avro with a compact random effect,
        # LibSVM into the GLM and GAME drivers
        t0 = time.perf_counter()
        sparse = _sparse_driver_slice(torch, np, seed, dev, tmp, card)
        _log(f"sparse drivers: {time.perf_counter() - t0:.2f} s")
    assert avro_native.fallbacks == 0, f"{avro_native.fallbacks} reads left the native decoder"
    path["fused_glm"]["libsvm_run_launches"] = sparse["GLM, LibSVM"]["fused_glm"]
    path["fused_glm_reduce"]["libsvm_run_launches"] = sparse["GLM, LibSVM"]["fused_glm_reduce"]
    # each run's launches and the checks of G1 on its own inputs; the row and
    # segment counters include compact scoring's launches, which stand apart
    gather = {k: v for k, v in sparse.items() if "compact" in v}
    path["sparse_gather"] = {
        "launches": sum(v["rows"] + v["segments"] - v["compact"] for v in gather.values()),
        "runs": {k: {c: v[c] for c in ("rows", "segments", "compact")} for k, v in
                 gather.items()},
        "checks": [c for v in gather.values() for c in v["checks"]]}
    path["sparse_gather_chunks"] = {
        "launches": sum(v["chunks"] for v in gather.values()),
        "checks": [c for v in gather.values() for c in v["checks"] if c["chunk_rows"]]}
    path["sparse_gather_compact"] = {
        "launches": sum(v["compact"] for v in gather.values()),
        "checks": [v["compact_check"] for v in gather.values() if "compact_check" in v]}
    return path


def _flagship_driver_run(torch, np, seed: int, dev, tmp: Path, card: str, shards,
                         re_spec: str) -> dict:
    """Phase 8's GAME training driver at the flagship's rows, uncut (2^17
    training and 2^15 validation rows at the flagship widths): the Avro
    written by a pool of processes, each running the port's pure-Python
    writer on one part file; the driver's stages printed (``util/timed``);
    the packed kernel held against its plain version on the run's own
    fixed-effect inputs, read back from its Avro. Returns that check with
    the run's launches."""
    import multiprocessing

    from dev import torch_kernel_probe
    from photon_ml_torch.cli import game_training_driver
    from photon_ml_torch.io.data_reader import FeatureShardConfiguration, read_merged
    from photon_ml_torch.io.index_map import IndexMap
    from photon_ml_torch.io.model_io import load_game_model
    from photon_ml_torch.ops import packed_glm
    from photon_ml_torch.ops.losses import LogisticLoss

    # the global bag one narrower than the flagship's d = 256: the driver
    # appends the intercept, as the 8,192-row runs' 255 features do
    shape = dict(GAME["flagship"], d_fe=GAME["flagship"]["d_fe"] - 1)
    n, nv = shape["n"], shape["held_out"]
    train, held = _game_arrays(np, seed + 12, **shape)
    workers = min(8, os.cpu_count() or 1)
    jobs = _game_parts(train, tmp / "flagship/train", 0, 2 * workers) \
        + _game_parts(held, tmp / "flagship/validation", n, workers)
    del train, held
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        pool.map(_write_game_part, jobs)
    write_s = time.perf_counter() - t0
    del jobs
    for name in ("packed_launches", "mma_launches", "columns_launches", "reduce_launches"):
        setattr(packed_glm, name, 0)
    t0 = time.perf_counter()
    run = game_training_driver.main([
        "--input-data-path", str(tmp / "flagship/train"),
        "--validation-data-path", str(tmp / "flagship/validation"),
        "--root-output-dir", str(tmp / "flagship/out"), "--task-type", "LOGISTIC_REGRESSION",
        *shards, "--coordinate-configurations",
        "name=fixed,feature.shard=global,reg.weights=1,max.iter=10",
        "--coordinate-configurations", f"name=per_user,{re_spec}userId",
        "--coordinate-configurations", f"name=per_item,{re_spec}itemId",
        "--coordinate-descent-iterations", "2", "--evaluators", "AUC"], device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"packed_glm": packed_glm.packed_launches,
                "packed_glm_reduce": packed_glm.reduce_launches}
    assert launches["packed_glm"] > 0 \
        and launches["packed_glm_reduce"] == launches["packed_glm"], launches
    fe_alone = run["metric_history"][0]["metrics"][0]
    assert fe_alone["coordinate"] == "fixed" and run["best_metric"] > \
        fe_alone["validate:AUC"] > 0.5, (run["best_metric"], fe_alone)
    decode = run["timings"]["avro decode"]["total"]
    _log(f"GAME training driver at the flagship's rows, uncut ({card}): {n} training + {nv} "
         f"validation rows written in {write_s:.2f} s by {workers} processes of the port's "
         f"pure-Python writer ({(n + nv) / write_s:.0f} records/s), training run "
         f"{run_s:.2f} s, {launches['packed_glm']} packed kernels, validation AUC "
         f"{run['best_metric']:.6f} against the fixed effect alone "
         f"{fe_alone['validate:AUC']:.6f}; native Avro decode {(n + nv) / decode:.0f} records/s; "
         f"stages " + json.dumps({k: round(v["total"], 4) for k, v in run["timings"].items()}))
    maps = IndexMap.load_directory(tmp / "flagship/out/index-maps")
    model = load_game_model(tmp / "flagship/out/best", maps, device=dev)
    cfg = {"global": FeatureShardConfiguration(feature_bags=("features",)),
           "per_entity": FeatureShardConfiguration(feature_bags=("perEntityFeatures",),
                                                   has_intercept=False)}
    ds = read_merged(tmp / "flagship/train", cfg, index_maps=maps,
                     random_effect_id_columns=("itemId", "userId"),
                     entity_vocabs={m.random_effect_type: m.entity_keys
                                    for m in model.models.values() if hasattr(m, "entity_keys")},
                     device=dev).dataset
    x = ds.feature_shards["global"]
    assert tuple(x.shape) == (n, shape["d_fe"] + 1), x.shape
    w = model.get("fixed").glm.coefficients.means.float().contiguous()
    aux = packed_glm.pack_aux(ds.labels, ds.offsets + model.score(ds) - x @ w, ds.weights)
    loss = LogisticLoss()
    r = torch.rand(n, device=dev)
    check = _path_check(
        torch, "packed_glm on the flagship driver run's fixed effect",
        lambda: packed_glm.packed_core(loss, x, aux, w, with_rsum=False),
        lambda: packed_glm.packed_core_reference(loss, x, aux, w, with_rsum=False),
        lambda: (torch.matmul(x, w), torch.matmul(r, x)), torch_kernel_probe.limits("float32"),
        x.shape[0] * x.shape[1] * 4 + 12 * n + 8 * x.shape[1] + 8, x.shape)
    _log(f"packed_glm on the flagship driver run's fixed effect {list(x.shape)} ({card}): "
         + json.dumps(check))
    return dict(check, launches=launches["packed_glm"],
                reduce_launches=launches["packed_glm_reduce"], write_seconds=write_s,
                run_seconds=run_s, timings={k: v["total"] for k, v in run["timings"].items()})


#: phase 9's shapes: bench.py:721 (bench_game_sweep_composed), none cut: n = 2^16 rows of
#: 16 Zipf columns (γ = 24) over d = 10^6, values N(0,1)/4, 2000 users, linear labels
#: (row sum + 0.1 noise), 2^14 held-out rows over the same users; the per-user effect
#: lives on the same sparse shard as the fixed effect, so it is compact. ``small`` is
#: the card-vs-CPU problem.
SPARSE_GAME = dict(n=1 << 16, d=1_000_000, per_row=16, users=2000, held_out=1 << 14,
                   hot_cols=256, sweeps=4, small=dict(n=4096, d=1 << 16, users=64))
#: the scaled fit's held-out RMSE after its last sweep and after its first
#: update (the fixed effect alone) in the JAX package on the CPU at this
#: phase's full size, float32, by seed (``python -m tests.torch_sparse_game_witness``):
#: the fit overfits there too, its RMSE ending above the fixed effect's
SCALED_FIT_REFERENCE = {0: dict(held_out_rmse=5.0303113442097045,
                                fe_alone_held_out_rmse=4.851650575806711)}


def _sparse_game_arrays(np, seed: int, n: int, d: int, per_row: int, users: int,
                        held_out: int = 0):
    """bench.py:721's data from ``seed + 13`` (bench.py's own seed at seed 0):
    (train, held) dicts of COO entries, labels and user keys."""
    rng = np.random.default_rng(seed + 13)
    total = n + held_out
    cols = _zipf_cols(np, rng, total * per_row, d)
    vals = (rng.normal(size=total * per_row) / np.sqrt(per_row)).astype(np.float32)
    y = vals.reshape(total, per_row).sum(axis=1) + 0.1 * rng.normal(size=total).astype(
        np.float32)
    keys = np.array([f"u{i}" for i in rng.integers(0, users, size=total)])

    def part(lo, hi):
        sl = slice(lo * per_row, hi * per_row)
        return {"rows": np.repeat(np.arange(hi - lo), per_row), "cols": cols[sl],
                "vals": vals[sl], "labels": y[lo:hi], "users": keys[lo:hi], "n": hi - lo}

    return part(0, n), part(n, total)


def _sparse_game_dataset(part, d: int, device, dtype=None, vocabs=None, policy=None):
    import numpy as np

    from photon_ml_torch.data.game_data import build_game_dataset
    from photon_ml_torch.data.sparse_batch import SparseShard

    dtype = dtype or np.float32
    shard = SparseShard(rows=part["rows"].astype(np.int64), cols=part["cols"].astype(np.int64),
                        vals=part["vals"].astype(dtype), num_samples=part["n"], feature_dim=d,
                        hybrid_policy=policy)
    return build_game_dataset(labels=part["labels"], feature_shards={"global": shard},
                              entity_keys={"user": part["users"]}, entity_vocabs=vocabs,
                              dtype=dtype, device=device)


def _sparse_game_estimator(lanes: str, sweeps: int, *, normalization: str = "NONE",
                           compute_variance: bool = False, evaluators=("RMSE",)):
    """Phase 9's GAME model: a fixed effect (L-BFGS, 10 iterations) and a
    per-user random effect (``lanes``, 10 iterations), both on ``global``,
    L2 weight 1, linear regression."""
    from photon_ml_torch.algorithm.coordinates import CoordinateOptimizationConfig
    from photon_ml_torch.estimators import (
        FixedEffectCoordinateConfig,
        GameEstimator,
        RandomEffectCoordinateConfig,
    )
    from photon_ml_torch.ops.normalization import NormalizationType
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.types import TaskType

    def opt(kind, **kw):
        return CoordinateOptimizationConfig(
            optimizer=OptimizerConfig(OptimizerType[kind], max_iterations=10), l2_weight=1.0,
            **kw)

    return GameEstimator(
        task=TaskType.LINEAR_REGRESSION,
        coordinate_configs={
            "fixed": FixedEffectCoordinateConfig("global", opt("LBFGS")),
            "per_user": RandomEffectCoordinateConfig(
                "user", "global", opt(lanes, compute_variance=compute_variance,
                                      variance_mode="full"))},
        num_iterations=sweeps, normalization=NormalizationType[normalization],
        validation_evaluators=tuple(evaluators))


def _gather_counts():
    from photon_ml_torch.models import game
    from photon_ml_torch.ops import sparse_gather

    return {"rows": sparse_gather.launches, "segments": sparse_gather.segment_launches,
            "chunks": sparse_gather.chunk_launches, "compact": game.compact_launches}


def _reset_gather_counts():
    from photon_ml_torch.models import game
    from photon_ml_torch.ops import sparse_gather

    sparse_gather.launches = sparse_gather.segment_launches = sparse_gather.chunk_launches = 0
    game.compact_launches = 0


class _SweepModels:
    """The models each coordinate's ``update_model`` returns during one fit,
    by wrapping the port's methods (restored on exit): after each sweep, the
    fixed and per-user models and their coordinates."""

    def __init__(self):
        self.sweeps: list = []
        self._saved = []

    def __enter__(self):
        from photon_ml_torch.algorithm import coordinates

        latest = {}
        for cls in (coordinates.FixedEffectCoordinate, coordinates.RandomEffectCoordinate):
            fn = cls.update_model

            def recorded(coord, *args, _fn=fn, **kw):
                out = _fn(coord, *args, **kw)
                latest[coord.coordinate_id] = (coord, out[0])
                if coord.coordinate_id == "per_user":  # the last of a sweep
                    self.sweeps.append(dict(latest))
                return out

            self._saved.append((cls, fn))
            cls.update_model = recorded
        return self

    def __exit__(self, *exc):
        for cls, fn in self._saved:
            cls.update_model = fn


def _cd_objective(torch, sweep: dict, dataset) -> float:
    """The objective block coordinate descent lowers, in f64: the weighted
    squared loss of the whole model plus each coordinate's L2 penalty on its
    coefficients in the space it solves in (normalized for a normalized
    fit). Each update lowers its own block's part from its warm start, so
    the sum does not rise over the sweeps."""
    from photon_ml_torch.ops.normalization import no_normalization

    (fe_coord, fe), (re_coord, re) = sweep["fixed"], sweep["per_user"]
    margins = (fe.score_dataset(dataset) + re.score_dataset(dataset)).double() \
        + dataset.offsets.double()
    data = float((dataset.weights.double() * 0.5 * (margins - dataset.labels.double()) ** 2)
                 .sum())
    fe_norm = fe_coord.normalization or no_normalization()
    re_norm = re_coord.normalization or no_normalization()
    w = fe_norm.from_model_space(fe.glm.coefficients.means, fe_coord.intercept_index).double()
    t = re_norm.from_model_space_compact(re.coefficients, torch.as_tensor(
        re.active_cols, device=re.coefficients.device)).double()
    return data + 0.5 * fe_coord.config.l2_weight * float(w @ w) \
        + 0.5 * re_coord.config.l2_weight * float((t * t).sum())


def _sparse_game_fit(torch, label: str, estimator, dataset, held, sweeps: int,
                     reference: dict | None = None) -> dict:
    """One ``GameEstimator.fit`` of phase 9 with the gather counters set to 0
    just before and read just after: the training loss and the
    coordinate-descent objective (:func:`_cd_objective`) non-increasing over
    the sweeps; the held-out RMSE of the whole model below that of its first
    update (the fixed effect alone, the random effect at 0), or, given a
    ``reference`` (the JAX package's two RMSEs for this fit), each within 1%
    of it; seconds a sweep by coordinate.

    The scaled fit takes a reference: its blocks are regularized in
    normalized space, where this data's rare columns get large factors, so
    it fits the training rows far more closely than it predicts held-out
    ones and its held-out RMSE ends above the fixed effect's, in the JAX
    package as in the port (``SCALED_FIT_REFERENCE``)."""
    _reset_gather_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _GameTimers(torch) as timers, _SweepModels() as recorded:
        result = estimator.fit(dataset, validation_dataset=held)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _gather_counts()
    history = result.metric_history
    loss_name = next(k for k in history[0] if k.startswith("train:"))
    last = [h[loss_name] for h in history if h["coordinate"] == history[-1]["coordinate"]]
    assert len(last) == sweeps and all(math.isfinite(v) for v in last), f"{label}: {last}"
    assert all(b <= a * (1 + 1e-5) for a, b in zip(last, last[1:])), \
        f"{label}: training loss rose over the sweeps: {last}"
    objective = [_cd_objective(torch, sweep, dataset) for sweep in recorded.sweeps]
    assert len(objective) == sweeps and all(b <= a * (1 + 1e-5) for a, b in
                                            zip(objective, objective[1:])), \
        f"{label}: the coordinate-descent objective rose over the sweeps: {objective}"
    fe_alone = history[0]
    assert fe_alone["iteration"] == 0 and fe_alone["coordinate"] == "fixed"
    rmse = history[-1]["validate:RMSE"]
    assert math.isfinite(rmse), (label, rmse)
    if reference is None:
        assert rmse < fe_alone["validate:RMSE"], (label, rmse, fe_alone["validate:RMSE"])
    else:
        got = {"held_out_rmse": rmse, "fe_alone_held_out_rmse": fe_alone["validate:RMSE"]}
        for key, want in reference.items():
            assert abs(got[key] - want) <= 0.01 * want, (label, key, got[key], want)
    assert launches["compact"] > 0 and launches["rows"] + launches["segments"] > 0, launches
    known = sum(v for k, v in timers.seconds.items() if k.startswith("solve ")) \
        + timers.seconds.get("rescoring", 0.0) + timers.seconds.get("bucket builder", 0.0)
    out = {"fit": label, "seconds": seconds, "sweeps": sweeps,
           "seconds_per_sweep": (seconds - timers.seconds.get("bucket builder", 0.0)) / sweeps,
           "fe_per_sweep": timers.seconds.get("solve fixed", 0.0) / sweeps,
           "re_per_sweep": timers.seconds.get("solve per_user", 0.0) / sweeps,
           "rescoring_per_sweep": timers.seconds.get("rescoring", 0.0) / sweeps,
           "host_rest_per_sweep": (seconds - known) / sweeps,
           "bucket_builder_seconds": timers.seconds.get("bucket builder", 0.0),
           "loss_per_sweep": last, "objective_per_sweep": objective, "held_out_rmse": rmse,
           "fe_alone_held_out_rmse": fe_alone["validate:RMSE"], "launches": launches}
    _log(f"sparse GAME fit {json.dumps(out)}")
    out["result"] = result
    return out


def _compact_entry(torch, replaces: str, entries, table, check: dict) -> dict:
    """The kernels-line entry of compact scoring (G1 over the flattened
    [E, K+1] table): device and eager time of the scoring as the path calls
    it, its plain version's (a gather and an ``index_add_``), cuSPARSE's CSR
    product over the flat slots (``library_ms``, bf16 never: f32 values),
    and the bound from the bytes the function needs (each entry's value and
    slot, the row pointers, the output and each distinct slot of the table
    once) and 2 operations an entry."""
    from photon_ml_torch.models.game import score_random_effect_compact_reference

    e, k = table.shape
    flat, row_ptr, _ = entries.plan(e, k)
    n, nnz = entries.num_samples, entries.vals.numel()
    nbytes = nnz * (entries.vals.element_size() + 4) + 4 * (n + 1) + 4 * n \
        + 4 * int(torch.unique(flat).numel())
    bound, by = _bound_ms(nbytes, 2.0 * nnz)
    csr = torch.sparse_csr_tensor(row_ptr, flat, entries.vals.float(), (n, e * (k + 1)),
                                  check_invariants=False)

    def library():
        return csr @ torch.cat([table, table.new_zeros((e, 1))], dim=1).reshape(-1)

    lib = library()
    torch.cuda.synchronize()
    assert float((lib.double() - entries.score(table).double()).abs().max()) \
        <= 1e-5 * check["scale_max"] + 1e-30
    return {"name": "sparse_gather_compact", "route": "cuda",
            "source": "photon_ml_torch/csrc/sparse_gather.cu", "replaces": replaces,
            "launches": None, "max_abs_err": check["max_abs_err"],
            "ms": _device_ms(torch, lambda: entries.score(table)),
            "eager_ms": _eager_ms(torch, lambda: entries.score(table)),
            "plain_ms": _device_ms(torch, lambda: score_random_effect_compact_reference(
                table, entries.ent, entries.pos, entries.rows, entries.vals, n)),
            "bound_ms": bound, "bound_by": by, "library_ms": _device_ms(torch, library),
            "worst_err_share_of_limit": check["max_err_over_scale"] / check["rel_limit"],
            "shape": [n, nnz], "table": [e, k], "layout": "compact scoring (segment kernel)",
            "dtype": "float32", "bytes": nbytes}


def _compact_check(torch, tag: str, entries, table, rel: float = 1e-5) -> dict:
    """Compact scoring through the gather kernel, twice (bitwise equal),
    against its plain version in f64 on the same entries and table: per row
    |k - p| <= rel * sum|v * t|."""
    from photon_ml_torch.models.game import score_random_effect_compact_reference

    k1, k2 = entries.score(table), entries.score(table)
    args = (entries.ent, entries.pos, entries.rows)
    n = entries.num_samples
    plain = score_random_effect_compact_reference(table.double(), *args,
                                                  entries.vals.double(), n)
    scale = score_random_effect_compact_reference(table.double().abs(), *args,
                                                  entries.vals.double().abs(), n)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2), f"compact scoring not bitwise repeatable: {tag}"
    assert k1.dtype == torch.float32 and bool(torch.isfinite(k1).all()), tag
    err = (k1.double() - plain).abs()
    bad = int((err > rel * scale + 1e-30).sum())
    assert bad == 0, f"compact scoring off its plain version in {bad} of {n} rows: {tag}"
    return {"case": tag, "rows": n, "rel_limit": rel, "max_abs_err": float(err.max()),
            "max_err_over_scale": float((err / (scale + 1e-30)).max()),
            "scale_max": float(scale.max())}


def _batch_gather_args(batch) -> dict:
    """The ELL block, flat tail and chunk plan of a sparse batch, as its
    margins pass them to ``gather_sum``."""
    return dict(ell=(batch.ell_vals, batch.ell_cols) if batch.has_ell_view else None,
                tail=(batch.values, batch.col_indices, batch.row_ids, batch.row_ptr)
                if batch.nnz else None, chunks=batch.row_chunks)


def _fe_gather_checks(torch, tag: str, batch, w) -> list:
    """G1 as a sparse fixed effect calls it on ``batch`` (a path's own
    training batch at its fitted coefficients ``w``), each held against its
    plain version by :func:`_gather_check` (twice, bitwise equal; per row
    |k - p| <= 1e-5 sum|v w| in f64): the margins X w over the ELL block and
    flat tail with the batch's chunk plan, and the transpose Xᵀr over the
    column-sorted plan with its chunk plan (Zipf-hot columns run the chunk
    kernel), r being the squared loss's row weights at w. A hybrid batch's
    head is a dense product and not G1's, so it is not part of these."""
    from photon_ml_torch.data.sparse_batch import feature_product, transpose_plan

    n = batch.num_samples
    w = w.float().contiguous()
    margins = _gather_check(torch, f"{tag}: margins X w", w, n, **_batch_gather_args(batch))
    r = (batch.weights * (feature_product(batch, w) + batch.offsets - batch.labels)) \
        .float().contiguous()
    vals, rows, col_ptr, chunks = transpose_plan(batch)
    transpose = _gather_check(torch, f"{tag}: transpose Xᵀr", r, batch.dim,
                              tail=(vals, rows, None, col_ptr), chunks=chunks)
    layout = "hybrid" if batch.has_hybrid_view else "ell" if batch.has_ell_view else "flat"
    return [dict(margins, layout=layout, chunk_rows=0 if batch.row_chunks is None
                 else int(batch.row_chunks.rows.numel())),
            dict(transpose, layout="column-sorted plan", chunk_rows=0 if chunks is None
                 else int(chunks.rows.numel()))]


class _FitCapture:
    """The dataset and result of every ``GameEstimator.fit`` while open (a
    driver's own training data, for the checks on its inputs), by wrapping
    the method (restored on exit)."""

    def __init__(self):
        self.fits: list = []

    def __enter__(self):
        from photon_ml_torch.estimators import GameEstimator

        self._fit = fit = GameEstimator.fit

        def recorded(est, dataset, *args, **kw):
            out = fit(est, dataset, *args, **kw)
            self.fits.append((dataset, out))
            return out

        GameEstimator.fit = recorded
        return self

    def __exit__(self, *exc):
        from photon_ml_torch.estimators import GameEstimator

        GameEstimator.fit = self._fit


def _driver_gather_checks(torch, tag: str, capture: _FitCapture, run: dict) -> None:
    """G1 on a driver's own training data, into ``run`` (its launch counts):
    ``checks``, :func:`_fe_gather_checks` on the last fit's batch of the
    ``global`` shard at its fixed effect's coefficients, and, where the
    model has a compact per-user effect, ``compact_check``
    (:func:`_compact_check` of its table on the training rows). A run that
    launched the chunk kernel must have had it checked."""
    from photon_ml_torch.models.game import compact_entries

    dataset, result = capture.fits[-1]
    w = result.model.get("fixed").glm.coefficients.means
    run["checks"] = _fe_gather_checks(torch, tag, dataset.fixed_effect_batch("global"), w)
    assert not run["chunks"] or any(c["chunk_rows"] for c in run["checks"]), run
    user = result.model.models.get("per_user")
    if user is not None:
        entries = compact_entries(
            dataset.feature_shards[user.feature_shard_id],
            dataset.host_array(f"entity_idx/{user.random_effect_type}"), user.active_cols,
            user.coefficients.device)
        run["compact_check"] = _compact_check(torch, f"{tag}: compact scores", entries,
                                              user.coefficients.float().contiguous())


def _small_compact_agreement(torch, np, seed: int, dev, card: str) -> None:
    """One per-user update (Newton lanes, from zero) of a small compact
    problem on the card in f32 against the CPU in f64: tables within
    1e-3 max|w|."""
    s = SPARSE_GAME["small"]
    part, _ = _sparse_game_arrays(np, seed + 1, s["n"], s["d"], SPARSE_GAME["per_row"],
                                  s["users"])
    tables = {}
    for where, dtype in ((dev, np.float32), (torch.device("cpu"), np.float64)):
        ds = _sparse_game_dataset(part, s["d"], where, dtype=dtype)
        _, coords = _sparse_game_estimator("NEWTON", 1)._build_coordinates(ds, None)
        coord = coords["per_user"]
        new, _ = coord.update_model(coord.initial_model(), None)
        tables[where.type] = new.coefficients.double().cpu()
        shape = list(new.coefficients.shape)
    gap = float((tables[dev.type] - tables["cpu"]).abs().max())
    scale = float(tables["cpu"].abs().max())
    _log(f"small compact problem n={s['n']} d={s['d']} users={s['users']} table {shape}: one "
         f"per-user Newton update, card f32 vs cpu f64 max |dw| {gap:.3g} (limit 1e-3 · max|w| "
         f"= {1e-3 * scale:.3g}) ({card})")
    assert gap <= 1e-3 * scale


def _sparse_game_slice(torch, np, seed: int, dev, card: str) -> tuple[dict, dict]:
    """Phase 9, the sparse GAME slice at bench.py:721's shapes (none cut): a
    fixed effect and a compact per-user random effect on one sparse shard,
    through ``GameEstimator.fit``. Returns (the path: for each kernel this
    path runs, its launches here and its checks on the path's own inputs,
    the fixed effect's margins and transposes over fits a's and b's batches
    and compact scoring over fit a's table; the kernels-line entry of
    compact scoring). The path's ``sparse_gather`` launches are the fixed
    effect's; compact scoring's row or segment launches stand apart."""
    import dataclasses

    from photon_ml_torch.data.game_data import build_random_effect_dataset
    from photon_ml_torch.data.sparse_batch import HybridPolicy
    from photon_ml_torch.models import game
    from photon_ml_torch.ops.normalization import NormalizationType, build_normalization

    cfg = SPARSE_GAME
    sweeps = cfg["sweeps"]
    t0 = time.perf_counter()
    train, held = _sparse_game_arrays(np, seed, cfg["n"], cfg["d"], cfg["per_row"],
                                      cfg["users"], cfg["held_out"])
    t_arrays = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = _sparse_game_dataset(train, cfg["d"], dev)
    held_ds = _sparse_game_dataset(held, cfg["d"], dev, vocabs=ds.entity_vocabs)
    torch.cuda.synchronize()
    rows_per_user = np.bincount(ds.host_array("entity_idx/user"))
    shard = ds.feature_shards["global"]
    _log(f"sparse GAME data (bench.py:721, none cut) n={cfg['n']} (+{cfg['held_out']} held "
         f"out) d={cfg['d']}, {cfg['per_row']} Zipf columns a row ({shard.nnz} entries, "
         f"{len(shard.coalesced()[0])} after duplicates add up), {cfg['users']} users with "
         f"{rows_per_user.min()}-{rows_per_user.max()} rows (mean {rows_per_user.mean():.1f}): "
         f"numpy {t_arrays:.2f} s, build_game_dataset x2 {time.perf_counter() - t0:.2f} s")

    # the host builders: the compact buckets and the entries' table slots
    t0 = time.perf_counter()
    re_ds = build_random_effect_dataset(ds, "user", "global")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    k = re_ds.table_width
    support = (re_ds.active_cols < cfg["d"]).sum(axis=1)
    fields = ("features", "labels", "weights", "entity_rows", "sample_rows", "col_index")
    bucket_bytes = sum(getattr(b, f).numel() * getattr(b, f).element_size()
                       for b in re_ds.buckets for f in fields)
    t0 = time.perf_counter()
    game.compact_entry_positions(shard, ds.host_array("entity_idx/user"), re_ds.active_cols)
    positions_s = time.perf_counter() - t0
    _log(f"compact per-user effect ({card}): K = {k} (active columns a user {support.min()}-"
         f"{support.max()}, mean {support.mean():.1f}), buckets "
         f"{[list(b.features.shape) for b in re_ds.buckets]}, {bucket_bytes} bytes (a dense "
         f"[{cfg['users']}, {cfg['d']}] f32 table alone would be "
         f"{4 * cfg['users'] * cfg['d']} bytes); host build: "
         f"_build_sparse_random_effect_dataset {build_s:.3f} s, compact_entry_positions "
         f"{positions_s:.3f} s")
    del re_ds

    # STANDARDIZATION has mean shifts, which would densify the shard: refused
    stats = shard.summarize(ds.host_array("weights"))
    stat = {key: torch.as_tensor(np.asarray(stats[key]), dtype=torch.float32, device=dev)
            for key in ("mean", "variance", "max_magnitude")}
    standard = build_normalization(NormalizationType.STANDARDIZATION, **stat, intercept_index=0)
    try:
        build_random_effect_dataset(ds, "user", "global", normalization=standard)
        raise AssertionError("STANDARDIZATION on a compact random effect was not refused")
    except ValueError as e:
        assert "SCALE-only" in str(e), e
    del stat, standard

    _sparse_game_estimator("NEWTON", 1).fit(ds)  # warm up outside the times
    hybrid = dataclasses.replace(shard, hybrid_policy=HybridPolicy(hot_cols=cfg["hot_cols"],
                                                                   label="sparse_game"))
    ds_hybrid = dataclasses.replace(ds, feature_shards={"global": hybrid}, _sparse_batches={})
    plan = {
        "a. ELL, compact L-BFGS lanes": (ds, "LBFGS", {}),
        "a. ELL, compact L-BFGS lanes, again": (ds, "LBFGS", {}),
        "b. hybrid 256-column head, compact Newton lanes": (ds_hybrid, "NEWTON", {}),
        "c. scaled, compact L-BFGS lanes, full variances": (
            ds, "LBFGS", dict(normalization="SCALE_WITH_MAX_MAGNITUDE",
                              compute_variance=True)),
    }
    fits = {}
    for label, (data, lanes, kw) in plan.items():
        reference = SCALED_FIT_REFERENCE.get(seed) if "normalization" in kw else None
        if "normalization" in kw and reference is None:
            _log(f"no JAX reference for the scaled fit at seed {seed}: its held-out RMSE is "
                 "printed, not held")
            reference = {}
        fits[label] = _sparse_game_fit(torch, label, _sparse_game_estimator(lanes, sweeps, **kw),
                                       data, held_ds, sweeps, reference)
        torch.cuda.empty_cache()

    # a. twice: bitwise equal tables and scores
    runs = [fits[label]["result"].model for label in list(plan)[:2]]
    for cid in ("fixed", "per_user"):
        m1, m2 = runs[0].get(cid), runs[1].get(cid)
        t1 = m1.glm.coefficients.means if cid == "fixed" else m1.coefficients
        t2 = m2.glm.coefficients.means if cid == "fixed" else m2.coefficients
        assert torch.equal(t1, t2), f"fit a's two runs differ in {cid}"
    assert torch.equal(runs[0].score(held_ds), runs[1].score(held_ds))
    # c. variances finite and positive on each user's support, NaN off it
    user = fits["c. scaled, compact L-BFGS lanes, full variances"]["result"].model.get("per_user")
    var = user.variances.double().cpu().numpy()
    on = user.active_cols < cfg["d"]
    assert np.isfinite(var[on]).all() and (var[on] > 0).all() and np.isnan(var[~on]).all()
    _log(f"sparse GAME checks ({card}): fit a's two runs bitwise equal (tables, coefficients, "
         f"held-out scores); variances on support {var[on].min():.4g}-{var[on].max():.4g}, NaN "
         f"off it; held-out RMSE " + json.dumps(
             {label: [f["held_out_rmse"], f["fe_alone_held_out_rmse"]]
              for label, f in fits.items()}) + " (GAME, fixed effect alone)")
    del user, var, runs

    _small_compact_agreement(torch, np, seed, dev, card)

    # one lane update's wall and device time, with kernels
    for lanes in ("LBFGS", "NEWTON"):
        share = _lane_loop_share(torch, _sparse_game_estimator(lanes, 1, evaluators=()), ds)
        _log(f"lane loop, one compact per-user update, {lanes} lanes ({card}): "
             + json.dumps(share))

    # compact scoring on this path's own inputs (fit a's table on the
    # training rows): through G1 against its plain version in f64
    model = fits["a. ELL, compact L-BFGS lanes"]["result"].model.get("per_user")
    table = model.coefficients.float().contiguous()
    entries = game.compact_entries(shard, ds.host_array("entity_idx/user"), model.active_cols,
                                   dev)
    check = _compact_check(torch, "compact scoring on the sparse GAME training rows", entries,
                           table)
    _reset_gather_counts()
    entry = _compact_entry(torch, "experiments/sparse_gather_probe.py:70", entries, table, check)
    _log(f"compact scoring through G1 [{entries.num_samples} rows, {entries.vals.numel()} "
         f"entries] table {list(table.shape)} ({card}): " + json.dumps(check) + " "
         + json.dumps(entry))
    # the fixed effect's gathers on this path's own inputs: fit a's ELL
    # batch and fit b's hybrid batch at their fitted coefficients
    fe_checks = []
    for label, data in (("a. ELL, compact L-BFGS lanes", ds),
                        ("b. hybrid 256-column head, compact Newton lanes", ds_hybrid)):
        w = fits[label]["result"].model.get("fixed").glm.coefficients.means
        fe_checks += _fe_gather_checks(torch, f"sparse GAME fit {label}",
                                       data.fixed_effect_batch("global"), w)
    _log(f"the fixed effect's gathers on the sparse GAME training batches ({card}): "
         + json.dumps(fe_checks))
    chunked = [c for c in fe_checks if c["chunk_rows"]]
    assert chunked, "the Zipf-hot columns should take the chunk kernel"
    launches = {key: sum(f["launches"][key] for f in fits.values())
                for key in ("rows", "segments", "chunks", "compact")}
    entry["launches"] = launches["compact"]
    # the row and segment counters include compact scoring's launches
    fe_launches = launches["rows"] + launches["segments"] - launches["compact"]
    path = {"sparse_gather": {"launches": fe_launches, "row_kernel": launches["rows"],
                              "segment_kernel": launches["segments"],
                              "compact_scoring": launches["compact"], "checks": fe_checks},
            "sparse_gather_chunks": {"launches": launches["chunks"], "checks": chunked},
            "sparse_gather_compact": dict(check, launches=launches["compact"])}
    for label, f in fits.items():
        _log(f"sparse GAME fit {label} ({card}): seconds a sweep {f['seconds_per_sweep']:.4f} "
             f"(fixed effect {f['fe_per_sweep']:.4f}, per-user {f['re_per_sweep']:.4f}, "
             f"rescoring {f['rescoring_per_sweep']:.4f}, host rest "
             f"{f['host_rest_per_sweep']:.4f}); launches {json.dumps(f['launches'])}")
    assert all(v["launches"] > 0 for v in path.values()), path
    del fits, ds, held_ds, ds_hybrid, model, table, entries
    torch.cuda.empty_cache()
    return path, entry


#: phase 8's sparse drivers: GAME on sparse Avro at phase 9's distribution
#: (name-term bag over d = 10^6 Zipf columns, 16 a row), rows cut to 8,192 +
#: 2,048 as the dense drivers' are (the pure-Python codec) and users to 250,
#: so a user keeps about phase 9's 33 rows; the GLM driver on LibSVM at
#: LIBSVM a1a's widths (123 binary features, 14 a row, 1,605 training rows;
#: validation as many); the GAME driver on LibSVM at phase 9's full width
#: and rows (pre-indexed, d = 10^6, 2^16 rows of 16 entries), fixed effect
#: only (LibSVM carries no id columns).
SPARSE_DRIVERS = dict(game_rows=8192, validation_rows=2048, users=250, d=1_000_000,
                      a1a_rows=1605, a1a_d=123, a1a_per_row=14, libsvm_rows=1 << 16)


def _write_libsvm(np, path, labels, rows, cols, vals, n: int) -> float:
    """LibSVM text of row-sorted entries, 1-based indices, one line a row;
    seconds."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    starts = [0, *np.cumsum(np.bincount(rows, minlength=n)).tolist()]
    with open(path, "w") as f:
        for i in range(n):
            feats = " ".join(f"{c + 1}:{v!r}" for c, v in
                             zip(cols[starts[i]:starts[i + 1]].tolist(),
                                 vals[starts[i]:starts[i + 1]].tolist()))
            f.write(f"{labels[i]!r} {feats}\n")
    return time.perf_counter() - t0


def _sparse_driver_slice(torch, np, seed: int, dev, tmp: Path, card: str) -> dict:
    """Phase 8's sparse drivers (``SPARSE_DRIVERS``): (i) the GAME training
    driver on sparse Avro with a compact per-user effect on the fixed
    effect's shard, its index maps from the port's feature indexing driver,
    then the scoring driver on its model (Avro scores bitwise the loaded
    model's in-process scores); (ii) the GLM driver on LibSVM (validation AUC
    above 0.6); (iii) the GAME training driver on pre-indexed LibSVM at full
    width. Returns each run's kernel launches (counters set to 0 before it)."""
    from photon_ml_torch.cli import (
        feature_indexing_driver,
        game_scoring_driver,
        game_training_driver,
        glm_driver,
    )
    from photon_ml_torch.io import photon_schemas
    from photon_ml_torch.io.data_reader import read_merged
    from photon_ml_torch.io.index_map import IndexMap
    from photon_ml_torch.io.model_io import load_game_model, read_scores
    from photon_ml_torch.cli.configs import parse_feature_shard_config
    from photon_ml_torch.models.game import compact_entries
    from photon_ml_torch.ops import fused_glm

    cfg = SPARSE_DRIVERS
    launches = {}
    # (i) GAME on sparse Avro, a name-term bag
    n, nv = cfg["game_rows"], cfg["validation_rows"]
    train, held = _sparse_game_arrays(np, seed + 6, n, cfg["d"], SPARSE_GAME["per_row"],
                                      cfg["users"], nv)

    def record(part, offset):
        cols, vals = part["cols"].tolist(), part["vals"].tolist()
        y, users, per_row = part["labels"].tolist(), part["users"].tolist(), \
            SPARSE_GAME["per_row"]
        return lambda i: {
            "uid": str(offset + i), "label": y[i], "weight": 1.0, "offset": 0.0,
            "foldId": None, "metadataMap": {"userId": users[i]},
            "features": [{"name": "w", "term": str(c), "value": v} for c, v in
                         zip(cols[i * per_row:(i + 1) * per_row],
                             vals[i * per_row:(i + 1) * per_row])]}

    te = photon_schemas.TRAINING_EXAMPLE_AVRO
    write_s = _write_avro(tmp / "sparse/train/part-00000.avro", te, n, record(train, 0))
    _write_avro(tmp / "sparse/validation/part-00000.avro", te, nv, record(held, n))
    spec = "name=global,feature.bags=features,intercept=true,sparse=true"
    t0 = time.perf_counter()
    sizes = feature_indexing_driver.main([
        "--input-data-path", str(tmp / "sparse/train"), "--output-dir",
        str(tmp / "sparse/index-maps"), "--feature-shard-configurations", spec])
    index_s = time.perf_counter() - t0
    _reset_gather_counts()
    t0 = time.perf_counter()
    with _FitCapture() as capture:
        game = game_training_driver.main([
            "--input-data-path", str(tmp / "sparse/train"),
            "--validation-data-path", str(tmp / "sparse/validation"),
            "--root-output-dir", str(tmp / "sparse/out"), "--task-type", "LINEAR_REGRESSION",
            "--index-maps-dir", str(tmp / "sparse/index-maps"),
            "--feature-shard-configurations", spec,
            "--coordinate-configurations",
            "name=fixed,feature.shard=global,reg.weights=1,max.iter=10",
            "--coordinate-configurations",
            "name=per_user,feature.shard=global,reg.weights=1,max.iter=10,"
            "random.effect.type=userId",
            "--coordinate-descent-iterations", "2", "--evaluators", "RMSE"], device=dev)
        torch.cuda.synchronize()
    game_s = time.perf_counter() - t0
    launches["GAME training, sparse Avro"] = _gather_counts()
    # G1 on the driver's own training batch, after its launches were read
    _driver_gather_checks(torch, "GAME training driver, sparse Avro", capture,
                          launches["GAME training, sparse Avro"])
    del capture
    fe_alone = game["metric_history"][0]["metrics"][0]
    assert fe_alone["coordinate"] == "fixed" and game["best_metric"] < fe_alone["validate:RMSE"], \
        (game["best_metric"], fe_alone)
    run = launches["GAME training, sparse Avro"]
    assert run["compact"] > 0 and run["rows"] + run["segments"] > 0, run
    _reset_gather_counts()
    scored = game_scoring_driver.main([
        "--input-data-path", str(tmp / "sparse/validation"),
        "--model-input-dir", str(tmp / "sparse/out/best"),
        "--output-dir", str(tmp / "sparse/scored"), "--evaluators", "RMSE",
        "--feature-shard-configurations", spec, "--compact-random-effect-threshold", "0"],
        device=dev)
    torch.cuda.synchronize()
    launches["GAME scoring, sparse Avro"] = _gather_counts()
    assert launches["GAME scoring, sparse Avro"]["compact"] > 0
    avro_scores = np.asarray([r["predictionScore"]
                              for r in read_scores(tmp / "sparse/scored/scores")])
    maps = IndexMap.load_directory(tmp / "sparse/out/index-maps")
    model = load_game_model(tmp / "sparse/out/best", maps, compact_random_effect_threshold=0,
                            device=dev)
    assert model.get("per_user").is_compact
    ds = read_merged(tmp / "sparse/validation", dict([parse_feature_shard_config(spec)]),
                     index_maps=maps, random_effect_id_columns=("userId",),
                     entity_vocabs={"userId": model.get("per_user").entity_keys},
                     device=dev).dataset
    in_process = (model.score(ds) + ds.offsets).cpu().numpy()
    assert avro_scores.shape == (nv,) and np.array_equal(avro_scores,
                                                         in_process.astype(np.float64)), \
        float(np.abs(avro_scores - in_process).max())
    # G1 on the scoring run's own inputs: the loaded model's margins and
    # compact scores over the validation rows
    user = model.get("per_user")
    table = user.coefficients
    scoring = launches["GAME scoring, sparse Avro"]
    batch = ds.fixed_effect_batch("global")
    scoring["checks"] = [dict(_gather_check(
        torch, "GAME scoring driver, sparse Avro: margins X w",
        model.get("fixed").glm.coefficients.means.float().contiguous(), nv,
        **_batch_gather_args(batch)), chunk_rows=0 if batch.row_chunks is None
        else int(batch.row_chunks.rows.numel()))]
    scoring["compact_check"] = _compact_check(
        torch, "GAME scoring driver, sparse Avro: compact scores", compact_entries(
            ds.feature_shards["global"], ds.host_array(f"entity_idx/{user.random_effect_type}"),
            user.active_cols, dev), table.float().contiguous())
    _log(f"GAME drivers on sparse Avro ({card}): {n} + {nv} rows of a name-term bag (written "
         f"at {n / write_s:.0f} records/s), feature indexing driver {index_s:.2f} s ({sizes}), "
         f"training {game_s:.2f} s, validation RMSE {game['best_metric']:.6f} against the fixed "
         f"effect alone {fe_alone['validate:RMSE']:.6f}, compact per-user table "
         f"{list(table.shape)}; scoring driver RMSE {scored['evaluations']['RMSE']:.6f}, its "
         f"{nv} Avro scores bitwise equal to the loaded model's in-process scores; launches "
         + json.dumps(launches) + "; stages "
         + json.dumps({k: round(v["total"], 4) for k, v in game["timings"].items()}))
    del model, ds, table, user, batch

    # (ii) the GLM driver on LibSVM at a1a's widths
    rng = np.random.default_rng(seed + 8)
    na, da, pa = cfg["a1a_rows"], cfg["a1a_d"], cfg["a1a_per_row"]
    w_true = rng.normal(size=da)
    for name in ("train", "validation"):
        cols = np.sort(np.argsort(rng.random((na, da)), axis=1)[:, :pa], axis=1)
        margin = w_true[cols].sum(axis=1) / np.sqrt(pa)
        y = np.where(rng.uniform(size=na) < 1.0 / (1.0 + np.exp(-margin)), 1, -1)
        _write_libsvm(np, tmp / f"a1a/{name}.txt", y.tolist(), np.repeat(np.arange(na), pa),
                      cols.ravel(), np.ones(na * pa), na)
    fused_glm.launches = fused_glm.reduce_launches = 0
    t0 = time.perf_counter()
    glm = glm_driver.main([
        "--input-data-path", str(tmp / "a1a/train.txt"),
        "--validation-data-path", str(tmp / "a1a/validation.txt"),
        "--output-dir", str(tmp / "a1a/out"), "--task-type", "LOGISTIC_REGRESSION",
        "--regularization-weights", "1,10", "--input-format", "libsvm"],
        device=dev)
    torch.cuda.synchronize()
    glm_s = time.perf_counter() - t0
    launches["GLM, LibSVM"] = {"fused_glm": fused_glm.launches,
                               "fused_glm_reduce": fused_glm.reduce_launches}
    aucs = {lam: m["AUC"] for lam, m in glm.validation_metrics.items()}
    assert launches["GLM, LibSVM"]["fused_glm"] > 0 and glm.stage.name == "VALIDATED"
    assert aucs[glm.best_lambda] > 0.6, aucs
    _log(f"GLM driver on LibSVM at a1a's widths ({na} + {na} rows, {da} features, {pa} a row) "
         f"({card}): {glm_s:.2f} s, validation AUC {json.dumps(aucs)}, best λ "
         f"{glm.best_lambda}, launches {json.dumps(launches['GLM, LibSVM'])}")

    # (iii) the GAME driver on pre-indexed LibSVM at full width
    nl = cfg["libsvm_rows"]
    part, _ = _sparse_game_arrays(np, seed + 7, nl, cfg["d"], SPARSE_GAME["per_row"],
                                  SPARSE_GAME["users"])
    text_s = _write_libsvm(np, tmp / "libsvm/train.txt", part["labels"].tolist(), part["rows"],
                           part["cols"], part["vals"], nl)
    _reset_gather_counts()
    t0 = time.perf_counter()
    with _FitCapture() as capture:
        pre = game_training_driver.main([
            "--input-data-path", str(tmp / "libsvm/train.txt"), "--input-format", "libsvm",
            "--root-output-dir", str(tmp / "libsvm/out"), "--task-type", "LINEAR_REGRESSION",
            "--feature-shard-configurations",
            f"name=global,feature.bags=features,intercept=false,pre.indexed=true,"
            f"dimension={cfg['d']},sparse=true",
            "--coordinate-configurations",
            "name=fixed,feature.shard=global,reg.weights=1,max.iter=10",
            "--model-output-mode", "BEST"], device=dev)
        torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    launches["GAME training, pre-indexed LibSVM"] = _gather_counts()
    run = launches["GAME training, pre-indexed LibSVM"]
    assert run["rows"] + run["segments"] > 0, run
    _driver_gather_checks(torch, "GAME training driver, pre-indexed LibSVM", capture, run)
    del capture
    parse_s = pre["timings"]["libsvm parse"]["total"]
    loss = [h["metrics"] for h in pre["metric_history"]][0]
    _log(f"GAME driver on pre-indexed LibSVM, d={cfg['d']}, {nl} rows of "
         f"{SPARSE_GAME['per_row']} entries ({card}): {pre_s:.2f} s; LibSVM text written in "
         f"{text_s:.2f} s, parsed at {nl / parse_s:.0f} records/s ({parse_s:.2f} s); training "
         f"loss {json.dumps(loss)}; launches {json.dumps(run)}; stages "
         + json.dumps({k: round(v["total"], 4) for k, v in pre["timings"].items()}))
    return launches


#: phase 10, matrix factorization (ROADMAP item 13): (a) bench.py's flagship
#: GAME widths (bench.py:542-560) with a user × item MF coordinate (k = 16,
#: 2 alternations) beside the fixed effect and the per-user effect, linear
#: labels carrying a planted rank-16 user·item term; (b) MovieLens-1M's
#: published widths (GroupLens ml-1m: 6,040 users, 3,706 movies, 1,000,209
#: ratings, at least 20 a user), none cut: the ``global`` shard is the
#: one-hot of its own attributes (intercept, gender 2, age 7, occupation 21,
#: genres 18: d = 49), k = 32; (c) a small problem on the card against the CPU.
MF = {
    "flagship": dict(GAME["flagship"], k=16, alternations=2),
    "movielens": dict(users=6040, movies=3706, ratings=1_000_209, min_count=20,
                      max_count=2314, held_out=1 << 16, k=32, sweeps=4, genders=2, ages=7,
                      occupations=21, genres=18),
    "small": dict(GAME["small"], k=4),
}


def _planted_mf(np, seed: int, part, users: int, items: int, k: int, scale: float = 0.5):
    """``part``'s linear labels plus a planted rank-k term u_user · v_item
    (u, v ~ N(0, scale²), so the term's variance is k·scale⁴); the user rows
    cover the held-out users never trained on too."""
    rng = np.random.default_rng(seed)
    u = (scale * rng.normal(size=(2 * users, k))).astype(np.float32)
    v = (scale * rng.normal(size=(items, k))).astype(np.float32)
    ui = np.char.lstrip(part["keys"]["user"], "u").astype(np.int64)
    ii = np.char.lstrip(part["keys"]["item"], "i").astype(np.int64)
    part["labels"]["LINEAR_REGRESSION"] = part["labels"]["LINEAR_REGRESSION"] + np.einsum(
        "nk,nk->n", u[ui], v[ii]).astype(np.float32)
    return part


def _mf_estimator(sweeps: int, *, k: int, mf_lanes: str = "AUTO", mf: bool = True,
                  per_user: bool = True, alternations: int = 2, mf_l2: float = 10.0, **kw):
    """The flagship configuration of ``_game_estimator`` with the per-user
    effect only, plus (``mf``) a user × item MF coordinate with ``mf_lanes``
    (AUTO resolves to Newton lanes), 10 iterations, L2 weight ``mf_l2``: at
    weight 1 the factors of an entity's 66-87 rows fit its noise (held-out
    RMSE above the fit without MF, by a CPU rehearsal at a sixteenth of the
    rows); at 30 they shrink to the zero saddle."""
    from photon_ml_torch.algorithm.coordinates import CoordinateOptimizationConfig
    from photon_ml_torch.estimators import MatrixFactorizationCoordinateConfig

    est = _game_estimator("LINEAR_REGRESSION", "NEWTON", sweeps, **kw)
    configs = {c: v for c, v in est.coordinate_configs.items()
               if c == "fixed" or (per_user and c == "per_user")}
    if mf:
        from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType

        configs["mf"] = MatrixFactorizationCoordinateConfig(
            "user", "item", num_latent_factors=k, num_alternations=alternations,
            optimization=CoordinateOptimizationConfig(
                optimizer=OptimizerConfig(OptimizerType[mf_lanes], max_iterations=10),
                l2_weight=mf_l2))
    est.coordinate_configs = configs
    return est


def _rmse(torch, np, model, dataset) -> float:
    scores = (model.score(dataset) + dataset.offsets).double().cpu().numpy()
    assert np.isfinite(scores).all()
    return float(np.sqrt(np.mean((scores - dataset.host_array("labels")) ** 2)))


def _mf_buckets(mf_dataset, k: int) -> dict:
    """Each side's bucket shapes and bytes (labels, weights, entity and
    sample rows), and the bytes of the [e, cap, k] f32 features one solve
    gathers."""
    out = {}
    for side in ("row", "col"):
        buckets = getattr(mf_dataset, f"{side}_buckets")
        out[side] = {
            "shapes": [[b.num_entities, int(b.labels.shape[1])] for b in buckets],
            "bytes": sum(getattr(b, f).numel() * getattr(b, f).element_size() for b in buckets
                         for f in ("labels", "weights", "entity_rows", "sample_rows")),
            "feature_bytes_per_solve": [b.num_entities * int(b.labels.shape[1]) * k * 4
                                        for b in buckets]}
    return out


def _mf_half_step(coord, model):
    """A callable running one MF half-step of ``coord`` from ``model``: every
    row bucket's lane solve against the fixed column factors."""
    from photon_ml_torch.algorithm.coordinates import _solve_config
    from photon_ml_torch.algorithm.mf_coordinate import solve_mf_side_bucket
    from photon_ml_torch.ops.losses import loss_for_task
    from photon_ml_torch.ops.objective import GLMObjective

    objective = GLMObjective(loss_for_task(coord.task), l2_weight=coord.config.l2_weight,
                             use_kernel=False)
    opt = _solve_config(coord.config, loss=objective.loss, small_dense=True)
    col_idx = coord.dataset.entity_idx[coord.mf_dataset.col_effect_type]

    def run():
        rows = model.row_factors
        for b in coord.mf_dataset.row_buckets:
            rows, _ = solve_mf_side_bucket(objective, opt, b.labels, b.weights, b.entity_rows,
                                           b.sample_rows, col_idx, model.col_factors,
                                           coord.dataset.offsets, rows)
        return rows

    return run


def _movielens_arrays(np, seed: int, users: int, movies: int, ratings: int, min_count: int,
                      max_count: int, held_out: int, k: int, genders: int, ages: int,
                      occupations: int, genres: int, **_):
    """Ratings at MovieLens-1M's published widths from ``seed``: per-user
    counts Zipf-like from ``min_count`` to ``max_count`` summing to
    ``ratings``, each user's movies drawn without replacement by a Zipf
    popularity; user attributes (gender, age, occupation) and 1-3 genres a
    movie one-hot in the ``global`` shard with an intercept; ratings 1-5
    from a planted model (attribute effects plus a rank-k user·movie term)
    plus noise, rounded and clipped. ``held_out`` more ratings of the same
    model follow (users and movies all seen)."""
    rng = np.random.default_rng(seed)
    rank = np.arange(1, users + 1, dtype=np.float64)
    lo, hi = 1e-3, 3.0  # the Zipf exponent whose counts sum to ``ratings``

    def counts_for(s):  # min_count at the last rank, max_count at the first
        tail = users ** -s
        return min_count + np.floor((max_count - min_count) * (rank ** -s - tail)
                                    / (1.0 - tail) + 1e-9).astype(np.int64)

    for _ in range(60):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if counts_for(mid).sum() > ratings else (lo, mid)
    counts = counts_for(hi)
    short = ratings - int(counts.sum())
    counts[np.argsort(counts)[:short]] += 1  # the smallest users take the rest
    assert counts.sum() == ratings and counts.min() >= min_count and counts.max() == max_count
    counts = rng.permutation(counts)
    pop = 1.0 / np.arange(1, movies + 1) ** 0.9
    pop /= pop.sum()
    movie_perm = rng.permutation(movies)
    total = ratings + held_out
    extra = rng.integers(0, users, size=held_out)
    per_user = counts + np.bincount(extra, minlength=users)
    user_idx = np.repeat(np.arange(users), per_user)
    movie_idx = np.concatenate([movie_perm[rng.choice(movies, size=c, replace=False, p=pop)]
                                for c in per_user])
    gender = rng.integers(0, genders, size=users)
    age = rng.integers(0, ages, size=users)
    occupation = rng.integers(0, occupations, size=users)
    movie_genres = np.zeros((movies, genres), dtype=np.float32)
    for m in range(movies):
        movie_genres[m, rng.choice(genres, size=rng.integers(1, 4), replace=False)] = 1.0
    d = 1 + genders + ages + occupations + genres
    x = np.zeros((total, d), dtype=np.float32)
    x[:, 0] = 1.0
    rows = np.arange(total)
    x[rows, 1 + gender[user_idx]] = 1.0
    x[rows, 1 + genders + age[user_idx]] = 1.0
    x[rows, 1 + genders + ages + occupation[user_idx]] = 1.0
    x[:, 1 + genders + ages + occupations:] = movie_genres[movie_idx]
    w = np.concatenate([[3.58], 0.3 * rng.normal(size=d - 1)])
    u = 0.45 * rng.normal(size=(users, k))
    v = 0.45 * rng.normal(size=(movies, k))
    z = x @ w + np.einsum("nk,nk->n", u[user_idx], v[movie_idx]) \
        + 0.5 * rng.normal(size=total)
    y = np.clip(np.rint(z), 1, 5).astype(np.float32)
    order = rng.permutation(total)
    held = order[:held_out]
    train = np.sort(order[held_out:])
    keys = {"user": np.char.add("u", user_idx.astype(str)),
            "item": np.char.add("m", movie_idx.astype(str))}

    def part(sel):
        return dict(x=x[sel], labels=y[sel], keys={t: v_[sel] for t, v_ in keys.items()})

    return part(train), part(held), counts


def _mf_slice(torch, np, seed: int, dev, card: str) -> dict:
    """Phase 10: matrix factorization through ``GameEstimator.fit`` (``MF``),
    printing as it goes. Returns, for each kernel this path runs, its
    launches here and its check on the path's own fixed-effect inputs."""
    from dev import torch_kernel_probe
    from photon_ml_torch import convert
    from photon_ml_torch.algorithm import mf_coordinate
    from photon_ml_torch.data.game_data import build_game_dataset
    from photon_ml_torch.models.game import GameModel
    from photon_ml_torch.ops import packed_glm
    from photon_ml_torch.ops.losses import SquaredLoss

    # a. the flagship widths with a planted rank-16 user·item term
    shape = MF["flagship"]
    sweeps, k = shape["sweeps"], shape["k"]
    t0 = time.perf_counter()
    train, held = _game_arrays(np, seed + 7, **shape)
    train = _planted_mf(np, seed + 8, train, shape["users"], shape["items"], k)
    held = _planted_mf(np, seed + 8, held, shape["users"], shape["items"], k)
    lin = "LINEAR_REGRESSION"
    ds = _game_dataset(train, lin, dev)
    held_ds = _game_dataset(held, lin, dev, vocabs=ds.entity_vocabs)
    torch.cuda.synchronize()
    unseen = (held_ds.entity_idx["user"] < 0).cpu().numpy()
    assert unseen.any()
    _log(f"MF GAME data n={shape['n']} (+{shape['held_out']} held out, {int(unseen.sum())} of "
         f"unseen users) global d={shape['d_fe']} per_entity d={shape['d_re']} "
         f"users={shape['users']} items={shape['items']}, linear labels plus a planted rank-{k} "
         f"user·item term: {time.perf_counter() - t0:.2f} s")
    del train, held
    alt = shape["alternations"]
    # warm up outside the times
    _mf_estimator(1, k=k, alternations=alt).fit(ds)
    fits = {}
    for label, kw in (("a. fixed + per-user + mf, newton mf lanes", {}),
                      ("a. the same fit again", {}),
                      ("a. mf with l-bfgs lanes", {"mf_lanes": "LBFGS"}),
                      ("a. fixed + per-user, no mf, mma", {"mf": False, "kernel_unit": "mma"})):
        fits[label] = _game_fit(torch, label, _mf_estimator(sweeps, k=k, alternations=alt, **kw),
                                ds, sweeps)
        torch.cuda.empty_cache()
    main_fit = fits["a. fixed + per-user + mf, newton mf lanes"]
    model = main_fit["result"].model
    again = fits["a. the same fit again"]["result"].model
    plain_model, plain_again = (convert.game_model_to_numpy(m) for m in (model, again))
    bitwise = all(np.array_equal(v, plain_again[c][f], equal_nan=True)
                  for c, m in plain_model.items() for f, v in m.items()
                  if isinstance(v, np.ndarray))
    gap = _rel_gap(fits["a. mf with l-bfgs lanes"]["loss_per_sweep"][-1],
                   main_fit["loss_per_sweep"][-1])
    rmse = {label: _rmse(torch, np, f["result"].model, held_ds) for label, f in fits.items()}
    mf_held = model.get("mf").score_dataset(held_ds).cpu().numpy()
    _log(f"a. MF flagship ({card}): held-out RMSE {json.dumps(rmse)}; L-BFGS against Newton MF "
         f"lanes final training loss rel gap {gap:.3g} (limit 1e-3); the Newton fit twice "
         f"bitwise equal: {bitwise}; MF scores of the {int(unseen.sum())} unseen users all 0: "
         f"{bool((mf_held[unseen] == 0).all())}")
    for label, f in fits.items():
        _log(f"MF fit {label} ({card}): seconds per sweep {f['seconds_per_sweep']:.4f}, by "
             f"coordinate {json.dumps(f['per_sweep'])}, rescoring "
             f"{f['rescoring_per_sweep']:.4f}, host rest {f['host_rest_per_sweep']:.4f}, bucket "
             f"builders {f['bucket_builder_seconds']:.3f} s; lane iterations "
             f"{json.dumps(f['lane_iteration_histogram'])}")
    assert bitwise, "the Newton MF fit did not repeat bitwise"
    assert gap <= 1e-3, f"L-BFGS MF lanes off Newton's by {gap}"
    assert bool((mf_held[unseen] == 0).all()), "an unseen user's MF score is not 0"
    no_mf = rmse["a. fixed + per-user, no mf, mma"]
    assert all(v < no_mf for label, v in rmse.items() if "no mf" not in label), rmse

    # the kernels on this path's own fixed-effect inputs (the main fit's model)
    x = ds.feature_shards["global"]
    w = model.get("fixed").glm.coefficients.means.float().contiguous()
    o = (ds.offsets + model.score(ds) - x @ w).contiguous()
    aux = packed_glm.pack_aux(ds.labels, o, ds.weights)
    loss = SquaredLoss()
    n = x.shape[0]
    r = torch.rand(n, device=dev)
    library = lambda: (torch.matmul(x, w), torch.matmul(r, x))  # noqa: E731
    nbytes = n * x.shape[1] * 4 + 12 * n + 8 * x.shape[1] + 8
    limits = torch_kernel_probe.limits("float32")
    tf32 = torch_kernel_probe.tf32_slack(loss, x, ds.labels, o, ds.weights, w, None, "mma", "mma")
    launches = {c: sum(f["launches"][c] for f in fits.values())
                for c in ("packed_launches", "mma_launches", "reduce_launches")}
    path = {
        "packed_glm": dict(_path_check(
            torch, "packed_glm on the MF slice's fixed effect",
            lambda: packed_glm.packed_core(loss, x, aux, w, with_rsum=False),
            lambda: packed_glm.packed_core_reference(loss, x, aux, w, with_rsum=False),
            library, limits, nbytes, x.shape),
            launches=launches["packed_launches"] - launches["mma_launches"]),
        "packed_glm[mma]": dict(_path_check(
            torch, "packed_glm[mma] on the MF slice's fixed effect",
            lambda: packed_glm.packed_core(loss, x, aux, w, with_rsum=False, margin_unit="mma",
                                           grad_unit="mma"),
            lambda: packed_glm.packed_core_reference(loss, x, aux, w, with_rsum=False,
                                                     margin_unit="mma", grad_unit="mma"),
            library, limits, nbytes, x.shape, tf32), launches=launches["mma_launches"]),
    }
    fe_args = (loss, x, aux, None, None, None, w, None, False, "fma", "fma")
    path["packed_glm_reduce"] = dict(
        _reduce_entry(torch, "packed_glm_reduce on the MF slice's fixed effect",
                      lambda: packed_glm.launch_partials(*fe_args), packed_glm.reduce_partials,
                      packed_glm.reduce_partials_reference),
        launches=launches["reduce_launches"])
    assert all(v["launches"] > 0 for v in path.values()), {c: v["launches"]
                                                           for c, v in path.items()}
    _log(f"kernels on the MF slice's fixed effect {list(x.shape)} ({card}): "
         + json.dumps(path))
    del fits, main_fit, model, again, ds, held_ds, x, aux, o, r, fe_args
    torch.cuda.empty_cache()

    # b. MovieLens-1M's widths, nothing cut
    ml = MF["movielens"]
    t0 = time.perf_counter()
    train, held, counts = _movielens_arrays(np, seed + 9, **ml)
    t_arrays = time.perf_counter() - t0
    t0 = time.perf_counter()
    mds = build_game_dataset(labels=train["labels"], feature_shards={"global": train["x"]},
                             entity_keys=train["keys"], device=dev)
    mheld = build_game_dataset(labels=held["labels"], feature_shards={"global": held["x"]},
                               entity_keys=held["keys"], entity_vocabs=mds.entity_vocabs,
                               device=dev)
    torch.cuda.synchronize()
    _log(f"b. MovieLens-1M widths: {mds.num_samples} ratings (+{mheld.num_samples} held out) of "
         f"{len(mds.entity_vocabs['user'])} users ({counts.min()}-{counts.max()} ratings each) "
         f"and {len(mds.entity_vocabs['item'])} movies, global d={train['x'].shape[1]}, "
         f"ratings 1-5 (mean {train['labels'].mean():.3f}): numpy {t_arrays:.2f} s, "
         f"build_game_dataset x2 {time.perf_counter() - t0:.2f} s")
    del train, held
    t0 = time.perf_counter()
    built = mf_coordinate.build_mf_dataset(mds, "user", "item")
    torch.cuda.synchronize()
    builder_s = time.perf_counter() - t0
    buckets = _mf_buckets(built, ml["k"])
    _log(f"MovieLens MF buckets ({card}): host builder {builder_s:.3f} s; " + json.dumps(buckets))
    del built
    kw = dict(k=ml["k"], per_user=False, alternations=2)
    _mf_estimator(1, **kw).fit(mds)  # warm up
    ml_fits = {"b. movielens fixed + mf k=32": _game_fit(
        torch, "b. movielens fixed + mf k=32", _mf_estimator(ml["sweeps"], **kw), mds,
        ml["sweeps"])}
    torch.cuda.empty_cache()
    ml_fits["b. movielens fixed effect only"] = _game_fit(
        torch, "b. movielens fixed effect only", _mf_estimator(1, mf=False, **kw), mds, 1)
    ml_rmse = {label: _rmse(torch, np, f["result"].model, mheld) for label, f in ml_fits.items()}
    ml_main = ml_fits["b. movielens fixed + mf k=32"]
    _log(f"b. MovieLens MF ({card}): seconds per sweep {ml_main['seconds_per_sweep']:.4f}, by "
         f"coordinate {json.dumps(ml_main['per_sweep'])}, rescoring "
         f"{ml_main['rescoring_per_sweep']:.4f}, host rest {ml_main['host_rest_per_sweep']:.4f}, "
         f"bucket builders {ml_main['bucket_builder_seconds']:.3f} s; held-out RMSE "
         + json.dumps(ml_rmse))
    assert ml_rmse["b. movielens fixed + mf k=32"] < ml_rmse["b. movielens fixed effect only"], \
        ml_rmse
    _, coords = _mf_estimator(1, **kw)._build_coordinates(mds, None)
    coord = coords["mf"]
    half = _profiled(torch, _mf_half_step(coord, ml_main["result"].model.get("mf")))
    _log(f"MovieLens MF half-step, the {len(coord.mf_dataset.row_buckets)} user buckets' Newton "
         f"lanes at k={ml['k']} ({card}): " + json.dumps(half))
    for label, f in ml_fits.items():
        path["packed_glm"].setdefault("movielens_launches", 0)
        path["packed_glm"]["movielens_launches"] += f["launches"]["packed_launches"]
        path["packed_glm_reduce"].setdefault("movielens_launches", 0)
        path["packed_glm_reduce"]["movielens_launches"] += f["launches"]["reduce_launches"]
    del ml_fits, ml_main, mds, mheld, coord, coords
    torch.cuda.empty_cache()

    # c. a small problem: one MF update from the same factors, card f32
    # against CPU f64
    small = MF["small"]
    arrays, _ = _game_arrays(np, seed + 10, **small)
    arrays = _planted_mf(np, seed + 11, arrays, small["users"], small["items"], small["k"])
    got, start = {}, None
    for where, dtype in ((dev, None), ("cpu", np.float64)):
        sds = _game_dataset(arrays, lin, where, dtype=dtype)
        _, coords = _mf_estimator(1, k=small["k"], per_user=False)._build_coordinates(sds, None)
        coord = coords["mf"]
        init = coord.initial_model()
        if start is None:
            start = convert.game_model_to_numpy(GameModel(models={"mf": init}))["mf"]
        carried = convert.game_model_from_numpy({"mf": dict(start)}, device=where).get("mf")
        carried = carried.with_factors(carried.row_factors.to(init.row_factors.dtype),
                                       carried.col_factors.to(init.col_factors.dtype))
        new, _ = coord.update_model(carried)
        got[str(where)] = torch.cat([new.row_factors.double().cpu().reshape(-1),
                                     new.col_factors.double().cpu().reshape(-1)])
    gap = float((got[str(dev)] - got["cpu"]).abs().max())
    scale = float(got["cpu"].abs().max())
    _log(f"c. small MF problem n={small['n']} k={small['k']}: one update, card f32 vs cpu f64 "
         f"max |d factor| {gap:.3g} (max |factor| {scale:.3g}, limit 1e-3·max)")
    assert gap <= 1e-3 * scale
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
    t0 = time.perf_counter()
    worst = _kernel_cases(torch, fused_glm, losses, LabeledPointBatch, NormalizationContext,
                          args.seed)
    _log(f"kernel checks: {json.dumps(worst)} ({time.perf_counter() - t0:.2f} s)")

    # 4. the slice at n=2^18, d=512
    n, d = 1 << 18, 512
    t_dense = t0 = time.perf_counter()
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
    _log(f"dense phases (4 and 6): {time.perf_counter() - t_dense:.2f} s")
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

    # 7b. the projected GAME slice, its launches and kernel checks as its own path
    t0 = time.perf_counter()
    projected_path = _projected_slice(torch, np, args.seed, dev, card)
    _log(f"projected GAME phase: {time.perf_counter() - t0:.2f} s, launches "
         + json.dumps({k: v["launches"] for k, v in projected_path.items()}))

    # 8. the drivers: each kernel of that path with its launches there, and
    # its check and times on that path's own inputs
    t0 = time.perf_counter()
    driver_path = _driver_slice(torch, np, args.seed, dev, card)
    _log(f"driver phase: {time.perf_counter() - t0:.2f} s, launches "
         + json.dumps({k: v["launches"] for k, v in driver_path.items()}))

    # 9. the sparse GAME slice: its launches, and compact scoring held on its
    # own inputs as a kernels-line entry of its own
    t0 = time.perf_counter()
    sparse_game_path, compact_entry = _sparse_game_slice(torch, np, args.seed, dev, card)
    line["kernels"].append(compact_entry)
    _log(f"sparse GAME phase: {time.perf_counter() - t0:.2f} s, launches "
         + json.dumps({k: v["launches"] for k, v in sparse_game_path.items()}))

    # 10. matrix factorization: its launches and kernel checks as its own path
    t0 = time.perf_counter()
    mf_path = _mf_slice(torch, np, args.seed, dev, card)
    _log(f"MF GAME phase: {time.perf_counter() - t0:.2f} s, launches "
         + json.dumps({k: v["launches"] for k, v in mf_path.items()}))
    for key, path in (("projected_path", projected_path), ("driver_path", driver_path),
                      ("sparse_game_path", sparse_game_path), ("mf_path", mf_path)):
        for entry in line["kernels"]:
            if entry["name"] in path:
                entry[key] = path[entry["name"]]
        assert all(any(e["name"] == k for e in line["kernels"]) for k in path), key
    _log(card)
    _log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
