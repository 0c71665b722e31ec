#!/usr/bin/env python3
"""Compare other versions of the port's kernels with the ones in the repo, on one GPU.

    python3 dev/torch_kernel_ab.py OTHER.cu [OTHER.cu ...] [--rounds 3] [--seed 0]
                                   [--other-flags=-DNAME ...]

Each OTHER.cu is a variant of the repo's ``photon_ml_torch/csrc/<name>.cu``
with the same file name (for example the parent commit's copy, written with
``git show <parent>:photon_ml_torch/csrc/packed_glm.cu``): ``fused_glm.cu``,
``packed_glm.cu`` or ``sparse_gather.cu``. ``--other-flags`` adds nvcc flags
to the other build only (a variant of the repo's own source). Both builds
use the port's nvcc flags, are checked against the plain PyTorch version on
every case before they are timed, and are timed in alternating order
(other, repo, repo, other, ...). One JSON line per case, build and round:
device time ``ms`` (CUDA graph replay, ``chip_smoke._device_ms``), and for
B1 the partials kernel's time and the eager time of one call.

- fused_glm: n=2^18, d=512, logistic loss with a standardization context,
  f32 and bf16 feature blocks, and the wide blocks n=2^17, d=2048 and 4099;
  then the repo build alone: the packed kernel's ``fma`` form of the same
  function at d=512 (separate columns with offsets and Σr) as a yardstick,
  and a sweep of B1's tile plans (``B1_PLANS``) at d=512, each a build of the
  repo's source that takes that plan
  (``-DFUSED_GLM_PLAN_ROWS/STAGES/PHASES``).
- packed_glm: the probe forms at [2^17, 512] (separate columns, no offsets,
  no Σr, logistic: bf16 mma/mma with w rounded to bf16, mma_tf32 on both
  products, mma_tf32/mma, fma/fma; f32 fma/fma, mma/mma, mma/fma, fma/mma)
  and the GAME fixed effect's packed aux at [2^17, 256] f32 (fma/fma,
  mma/mma), on the source's 16-row build (the training path's).
- sparse_gather: the ELL margins at [2^19, 36], d=10^7, f32 and bf16; an
  ELL+tail block ([2^19, 17] and 0-8 flat entries a row); long flat rows
  (2^16 rows of 48-80 entries, a warp a row); G1's one segment of 2^24
  entries, d=2^22 (chunked); and the transposes (the segment kernel over a
  column-sorted plan): of the ELL block with f32 and bf16 values, and of
  chip_smoke.py's hybrid tails at d=10^7 and d=10^8, of two batches of few
  rows at d=2^16 (chip_smoke.py's small problem, 4096 rows, and 2^14 rows of
  32), and of the ELL block with its rows taken modulo 2^14 (r's gathers
  then stay in 64 KB). Each transpose row says whether the two builds'
  outputs are bitwise equal, and gives cuSPARSE's CSR ``[d, n] @ r`` of the
  same entries (bf16 values widened to f32). Then the repo build alone: the
  ELL kernel's plans (``GATHER_PLANS``) at [2^19, 36], d=10^7, and its chosen
  plan there and over the same rows with columns taken modulo 2^22 (a 16 MB
  w), each beside cuSPARSE's CSR product of the same entries.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
KERNELS = ("fused_glm", "packed_glm", "sparse_gather")
#: (lanes a row, entries a vector) of the gather's ELL kernel timed at L = 36
GATHER_PLANS = ((4, 4), (8, 4), (16, 4), (16, 2), (16, 1))
#: (rows a tile, stages, row phases) of B1's one-pass kernel timed at d=512
B1_PLANS = ((16, 2, 1), (16, 2, 2), (16, 2, 4), (16, 4, 4), (8, 2, 2))


def _plan_flags(plan) -> list:
    """nvcc flags of a fused_glm build that takes this tile plan."""
    return [f"-DFUSED_GLM_PLAN_{k}={v}" for k, v in zip(("ROWS", "STAGES", "PHASES"), plan)]


def _build(build, sources: dict, flags: dict, tmp: Path) -> dict:
    """One nvcc per (tag, source), all at once; the loaded libraries."""
    procs = {}
    for tag, src in sources.items():
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags.get(tag, ()), "-o",
               str(tmp / f"lib{tag}.so"), str(src)]
        procs[tag] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    for tag, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {sources[tag]}:\n{log}")
    return {tag: ctypes.CDLL(str(tmp / f"lib{tag}.so")) for tag in sources}


def _order(rounds: int):
    return [k for i in range(rounds) for k in (("other", "repo") if i % 2 == 0
                                                else ("repo", "other"))]


def _fused(torch, chip_smoke, libs, sweep, args):
    from photon_ml_torch import build
    from photon_ml_torch.data.batch import LabeledPointBatch
    from photon_ml_torch.ops import fused_glm, packed_glm
    from photon_ml_torch.ops.losses import LogisticLoss
    from photon_ml_torch.ops.normalization import NormalizationContext

    bound = {}
    for which, lib in {**libs, **sweep}.items():
        fused_glm._LIB = None
        build._LOADED["fused_glm"] = lib
        bound[which] = fused_glm._lib()

    def use(which):
        fused_glm._LIB = bound[which]
        fused_glm._GRID.clear()

    dev = torch.device("cuda")
    loss = LogisticLoss()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for n, d in ((1 << 18, 512), (1 << 17, 2048), (1 << 17, 4099)):
        x = torch.randn(n, d, device=dev, generator=gen)
        y = (torch.rand(n, device=dev, generator=gen) < 0.5).float()
        norm = NormalizationContext(0.5 + torch.rand(d, device=dev, generator=gen),
                                    0.1 * torch.randn(d, device=dev, generator=gen))
        w = 0.05 * torch.randn(d, device=dev, generator=gen) * (512 / d) ** 0.5
        for dtype in (torch.float32, torch.bfloat16):
            b = LabeledPointBatch.create(x, y, dtype=dtype, device=dev)
            vr, gr = fused_glm.fused_value_and_gradient_reference(loss, w, b, normalization=norm)
            vtol = 1e-5 if dtype == torch.float32 else 1e-4
            for which in _order(args.rounds):
                use(which)
                v, g = fused_glm.fused_value_and_gradient(loss, w, b, normalization=norm)
                v2, g2 = fused_glm.fused_value_and_gradient(loss, w, b, normalization=norm)
                ok = (abs(float(v - vr)) <= vtol * abs(float(vr))
                      and bool(torch.allclose(g, gr, rtol=1e-4,
                                              atol=1e-4 * float(gr.abs().max())))
                      and bool(torch.equal(v, v2)) and bool(torch.equal(g, g2)))
                call = lambda: fused_glm.fused_value_and_gradient(loss, w, b, normalization=norm)  # noqa: E731
                yield {
                    "kernel": "fused_glm", "shape": [n, d], "dtype": str(dtype)[6:],
                    "build": which, "matches_plain": ok,
                    "partials_ms": chip_smoke._device_ms(torch, lambda: fused_glm.fused_partials(
                        loss, b.features, b.labels, b.offsets, b.weights, w, None)),
                    "ms": chip_smoke._device_ms(torch, call),
                    "eager_ms": chip_smoke._eager_ms(torch, call),
                }
            if d == 512:
                # the repo build alone: the packed kernel's fma form of the same
                # function, and B1's plans
                use("repo")
                xs, ys, os_, ws = b.features, b.labels, b.offsets, b.weights
                yield {"kernel": "packed_glm fma/fma, B1's function", "shape": [n, d],
                       "dtype": str(dtype)[6:], "build": "repo",
                       "partials_ms": chip_smoke._device_ms(
                           torch, lambda: packed_glm.launch_partials(
                               loss, xs, None, ys, os_, ws, w, None, True, "fma", "fma"))}
                chosen = fused_glm.tile_plan(d, dtype)
                for which in sweep:
                    use(which)
                    plan = fused_glm.tile_plan(d, dtype)
                    yield {"kernel": "fused_glm", "shape": [n, d], "dtype": str(dtype)[6:],
                           "build": which, "plan": list(plan[:3]), "chosen": plan == chosen,
                           "partials_ms": chip_smoke._device_ms(
                               torch, lambda: fused_glm.fused_partials(
                                   loss, xs, ys, os_, ws, w, None))}
            del b
        del x
    use("repo")


def _packed(torch, chip_smoke, libs, args):
    from dev import torch_kernel_probe as tkp
    from photon_ml_torch import build
    from photon_ml_torch.ops import packed_glm
    from photon_ml_torch.ops.losses import LogisticLoss

    def use(which):
        build._LOADED["packed_glm"] = libs[which]
        packed_glm._LIBS.clear()
        packed_glm._GRID.clear()
        packed_glm._lib(16)

    loss = LogisticLoss()
    dev = torch.device("cuda")
    x, y, o, ws, w = tkp._inputs(torch, dev, args.seed, tkp.N, tkp.D)
    ones = torch.ones_like(ws)
    cases = []
    for dtype, units in ((torch.bfloat16, ("mma", "mma")), (torch.bfloat16, ("mma_tf32",) * 2),
                         (torch.bfloat16, ("mma_tf32", "mma")), (torch.bfloat16, ("fma", "fma")),
                         (torch.float32, ("fma", "fma")), (torch.float32, ("mma", "mma")),
                         (torch.float32, ("mma", "fma")), (torch.float32, ("fma", "mma"))):
        xt = x.to(dtype)
        # w rounded to the block's type, as probes 2 and 3 do (probe 1's
        # mma_tf32/mma form keeps it in f32)
        wk = w if units == ("mma_tf32", "mma") else w.to(dtype).float()
        kw = dict(with_rsum=False, margin_unit=units[0], grad_unit=units[1])
        case = f"probe form [{tkp.N}, {tkp.D}] {str(dtype)[6:]} {units[0]}/{units[1]}"
        cases.append((case, xt, units, (xt, y, None, ones, wk, None),
                      lambda xt=xt, wk=wk, kw=kw: packed_glm.columns_core(
                          loss, xt, y, ones, None, wk, **kw),
                      lambda xt=xt, wk=wk, kw=kw: packed_glm.columns_core_reference(
                          loss, xt, y, ones, None, wk, **kw)))
    xg, wg = x[:, :256].contiguous(), w[:256].contiguous()
    aux = packed_glm.pack_aux(y, o, ws)
    for units in (("fma", "fma"), ("mma", "mma")):
        kw = dict(with_rsum=False, margin_unit=units[0], grad_unit=units[1])
        cases.append((f"GAME packed aux [{tkp.N}, 256] {units[0]}/{units[1]}", xg, units,
                      (xg, y, o, ws, wg, None),
                      lambda kw=kw: packed_glm.packed_core(loss, xg, aux, wg, **kw),
                      lambda kw=kw: packed_glm.packed_core_reference(loss, xg, aux, wg, **kw)))
    for case, xt, units, inputs, kernel, plain in cases:
        name = str(xt.dtype)[6:]
        slack = tkp.tf32_slack(loss, *inputs, *units)
        for which in _order(args.rounds):
            use(which)
            err = tkp.compare(torch, f"{which} {case}", kernel, plain, *tkp.limits(name),
                              float(inputs[3].sum()), slack)
            yield {"kernel": "packed_glm", "case": case, "dtype": name, "build": which,
                   "limit_share": err["limit_share"], "ms": chip_smoke._device_ms(torch, kernel)}


class _RowsShim:
    """A sparse_gather library whose ``sparse_gather_rows`` predates the
    lane-group plan: the wrapper's two plan arguments are dropped."""

    def __init__(self, lib):
        self._lib = lib
        vp = ctypes.c_void_p
        lib.sparse_gather_rows.argtypes = [ctypes.c_int, vp, vp, ctypes.c_int, vp, vp, vp, vp, vp,
                                           vp, ctypes.c_longlong, vp, vp]
        lib.sparse_gather_rows.restype = ctypes.c_int

    def sparse_gather_rows(self, is_bf16, lanes, vec, *rest):
        del lanes, vec
        return self._lib.sparse_gather_rows(is_bf16, *rest)

    def __getattr__(self, name):
        return getattr(self._lib, name)


class _RunlessGather:
    """A sparse_gather library from before the segment kernel's runs (a
    thread a row): it reports the repo's run geometry, which its kernel does
    not use, so the wrapper binds it."""

    def __init__(self, lib, sparse_gather):
        self._lib = lib
        self.sparse_gather_segment_run = \
            lambda: sparse_gather.RUN_SEGMENTS * 1000 + sparse_gather.PIECE

    def __getattr__(self, name):
        return getattr(self._lib, name)


def _column_sorted(torch, sparse_gather, ev, ec, d):
    """An ELL block's entries sorted by column: (vals, rows, col_ptr, chunks)."""
    width = ev.shape[1]
    order = torch.argsort(ec.reshape(-1), stable=True)
    t_cols = ec.reshape(-1)[order]
    t_rows = (order // width).to(torch.int32)
    t_vals = ev.reshape(-1)[order]
    del order
    tptr, tchunks = sparse_gather.segment_plan(t_cols, d)
    return t_vals, t_rows, tptr, tchunks


def _transpose_cases(torch, np, chip_smoke, sparse_gather, dev, ev, ec, n, d, seed):
    """(case, r, d, gather kwargs, CSR [d, n]) of the transposes: the ELL
    block's (f32 and bf16 values), chip_smoke.py's two hybrid tails, and two
    with few rows, whose r stays in L1: chip_smoke.py's small problem
    (n=4096, d=2^16, 16 entries a row and an intercept column) and n=2^14
    rows of 32 at d=2^16."""
    from photon_ml_torch.data.sparse_batch import (HybridPolicy, SparseLabeledPointBatch,
                                                   transpose_plan)

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    t_vals, t_rows, tptr, tchunks = _column_sorted(torch, sparse_gather, ev, ec, d)
    r = torch.rand(n, device=dev, generator=gen)
    plans = [(f"transpose of the ELL block f32: [{d}] columns, {t_vals.numel()} entries", r, d,
              (t_vals, t_rows, tptr, tchunks)),
             (f"transpose of the ELL block bf16: [{d}] columns, {t_vals.numel()} entries", r, d,
              (t_vals.to(torch.bfloat16), t_rows, tptr, tchunks)),
             # the same entries gathering r from 64 KB (rows modulo 2^14): what
             # the random gathers of r from L2 cost
             (f"transpose of the ELL block f32, rows modulo 2^14: [{d}] columns", r, d,
              (t_vals, t_rows % (1 << 14), tptr, tchunks))]
    for key, seed_off in (("hybrid", 11), ("hybrid_1e8", 5)):
        cfg = chip_smoke.SPARSE[key]
        rows, cols, vals, y = chip_smoke._zipf_data(np, seed + seed_off, cfg["n"], cfg["d"],
                                                    cfg["per_row"])
        batch = SparseLabeledPointBatch.from_coo(rows, cols, vals, y, dim=cfg["d"],
                                                 hybrid=HybridPolicy(hot_cols=cfg["hot_cols"]),
                                                 device=dev)
        del rows, cols, vals
        plan = transpose_plan(batch)
        rk = torch.rand(cfg["n"], device=dev, generator=gen)
        plans.append((f"transpose of the hybrid tail d={cfg['d']}: {plan[0].numel()} entries",
                      rk, cfg["d"], plan))
        del batch
    small = chip_smoke.SPARSE["small"]
    for rows_s, per_row, intercept in ((small["n"], small["per_row"], True), (1 << 14, 32, False)):
        ds = small["d"]
        sv = 0.5 + torch.rand(rows_s, per_row, device=dev, generator=gen)
        sc = torch.randint(0, ds - 1, (rows_s, per_row), device=dev, generator=gen,
                           dtype=torch.int32)
        if intercept:
            sv = torch.cat([sv, torch.ones(rows_s, 1, device=dev)], dim=1)
            sc = torch.cat([sc, torch.full((rows_s, 1), ds - 1, dtype=torch.int32, device=dev)],
                           dim=1)
        plans.append((f"transpose of [{rows_s}, {sv.shape[1]}] at d={ds} (r in L1)",
                      torch.rand(rows_s, device=dev, generator=gen), ds,
                      _column_sorted(torch, sparse_gather, sv, sc, ds)))
    for case, rk, dk, (vals, rows, col_ptr, chunks) in plans:
        # bf16 values widened to f32: cuSPARSE's product of the same function
        csr = torch.sparse_csr_tensor(col_ptr, rows, vals.float(), (dk, rk.shape[0]),
                                      check_invariants=False)
        yield case, rk, dk, dict(tail=(vals, rows, None, col_ptr), chunks=chunks), csr


def _gather(torch, chip_smoke, libs, sources, args):
    import numpy as np

    from photon_ml_torch import build
    from photon_ml_torch.ops import sparse_gather

    bound = {}
    for which, lib in libs.items():
        text = Path(sources[which]).read_text()
        if "sparse_gather_segment_run" not in text:
            lib = _RunlessGather(lib, sparse_gather)
        build._LOADED["sparse_gather"] = lib
        sparse_gather._LIB = None
        sparse_gather._lib()  # binds the repo's argtypes and checks the chunk size
        planned = "int lanes, int vec" in text
        bound[which] = sparse_gather._LIB if planned else _RowsShim(lib)

    def use(which):
        sparse_gather._LIB = bound[which]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n, d, width = 1 << 19, 10**7, 36
    ev = torch.randn(n, width, device=dev, generator=gen)
    ec = torch.randint(0, d, (n, width), device=dev, generator=gen, dtype=torch.int32)
    w = torch.randn(d, device=dev, generator=gen)
    cases = [(f"ELL [{n}, {width}] d={d} f32", w, n, dict(ell=(ev, ec))),
             (f"ELL [{n}, {width}] d={d} bf16", w, n, dict(ell=(ev.to(torch.bfloat16), ec)))]
    # ELL + flat tail: a 17-wide block and 0-8 entries a row past it
    counts = torch.randint(0, 9, (n,), device=dev, generator=gen)
    row_ids = torch.repeat_interleave(torch.arange(n, device=dev), counts).to(torch.int32)
    tv = torch.randn(row_ids.numel(), device=dev, generator=gen)
    tc = torch.randint(0, d, (row_ids.numel(),), device=dev, generator=gen, dtype=torch.int32)
    row_ptr, chunks = sparse_gather.segment_plan(row_ids, n)
    cases.append((f"ELL [{n}, 17] + flat tail {row_ids.numel()} d={d} f32", w, n,
                  dict(ell=(ev[:, :17].contiguous(), ec[:, :17].contiguous()),
                       tail=(tv, tc, row_ids, row_ptr), chunks=chunks)))
    # long flat rows: a warp a row
    m = 1 << 16
    counts = torch.randint(48, 81, (m,), device=dev, generator=gen)
    lrow = torch.repeat_interleave(torch.arange(m, device=dev), counts).to(torch.int32)
    lv = torch.randn(lrow.numel(), device=dev, generator=gen)
    lc = torch.randint(0, d, (lrow.numel(),), device=dev, generator=gen, dtype=torch.int32)
    lptr, lchunks = sparse_gather.segment_plan(lrow, m)
    cases.append((f"flat rows [{m}] of 48-80 entries d={d} f32", w, m,
                  dict(tail=(lv, lc, lrow, lptr), chunks=lchunks)))
    # G1: one segment of 2^24 entries, chunked
    nnz, dg = 1 << 24, 1 << 22
    gi = torch.randint(0, dg, (nnz,), device=dev, generator=gen, dtype=torch.int32)
    gvals = torch.randn(nnz, device=dev, generator=gen)
    wg = torch.randn(dg, device=dev, generator=gen)
    gz = torch.zeros(nnz, dtype=torch.int32, device=dev)
    gptr, gchunks = sparse_gather.segment_plan(gz, 1)
    cases.append((f"G1 one segment {nnz} d={dg} (chunked)", wg, 1,
                  dict(tail=(gvals, gi, gz, gptr), chunks=gchunks)))
    cases = [(*c, None) for c in cases]
    cases.extend(_transpose_cases(torch, np, chip_smoke, sparse_gather, dev, ev, ec, n, d,
                                  args.seed))
    for case, vec, rows, kw, csr in cases:
        outs = {}
        for which in _order(args.rounds):
            use(which)
            check = chip_smoke._gather_check(torch, f"{which} {case}", vec, rows, **kw)
            outs.setdefault(which, sparse_gather.gather_sum(vec, rows, **kw))
            yield {"kernel": "sparse_gather", "case": case, "build": which,
                   "max_err_over_scale": check["max_err_over_scale"],
                   "ms": chip_smoke._device_ms(torch, lambda: sparse_gather.gather_sum(
                       vec, rows, **kw))}
        if csr is not None:
            # the transposes: the two builds' sums bitwise equal, or the
            # largest difference in units of 1e-5·Σ|v·r| of its column
            tail = kw["tail"]
            scale = sparse_gather.gather_sum_reference(
                vec.abs().double(), rows, tail=(tail[0].double().abs(), *tail[1:]))
            diff = (outs["repo"].double() - outs["other"].double()).abs()
            yield {"kernel": "sparse_gather", "case": case, "build": "both",
                   "bitwise_equal_builds": bool(torch.equal(outs["repo"], outs["other"])),
                   "max_diff_in_1e-5_scale": float((diff / (1e-5 * scale + 1e-30)).max()),
                   "library_ms": chip_smoke._device_ms(torch, lambda: csr @ vec)}
        del outs
    # the repo build alone: its ELL plans (lanes a row, entries a vector) at
    # the main shape, and the chosen plan over a w small enough to stay in L2
    use("repo")
    chosen = sparse_gather.ell_plan
    small = 1 << 22
    try:
        for vals, dtype in ((ev, "f32"), (ev.to(torch.bfloat16), "bf16")):
            for plan in GATHER_PLANS:
                sparse_gather.ell_plan = lambda *a, plan=plan: plan  # noqa: E731
                yield {"kernel": "sparse_gather", "build": "repo", "plan": list(plan),
                       "case": f"ELL [{n}, {width}] d={d} {dtype}",
                       "ms": chip_smoke._device_ms(torch, lambda: sparse_gather.gather_sum(
                           w, n, ell=(vals, ec)))}
            sparse_gather.ell_plan = chosen
            for cols, wd in ((ec, w), (ec % small, w[:small].contiguous())):
                # cuSPARSE's CSR product of the same entries, w in the values' type
                crow = torch.arange(n + 1, dtype=torch.int32, device=dev) * width
                csr = torch.sparse_csr_tensor(crow, cols.reshape(-1), vals.reshape(-1),
                                              (n, wd.shape[0]), check_invariants=False)
                w_lib = wd.to(vals.dtype)
                yield {"kernel": "sparse_gather", "build": "repo",
                       "plan": list(chosen(width, vals.data_ptr(), cols.data_ptr(),
                                           vals.element_size())),
                       "case": f"ELL [{n}, {width}] d={wd.shape[0]} {dtype}",
                       "ms": chip_smoke._device_ms(torch, lambda: sparse_gather.gather_sum(
                           wd, n, ell=(vals, cols))),
                       "library_ms": chip_smoke._device_ms(torch, lambda: csr @ w_lib)}
    finally:
        sparse_gather.ell_plan = chosen


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", type=Path, nargs="+")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--other-flags", action="append", default=[])
    args = parser.parse_args(argv)
    for path in args.other:
        if path.stem not in KERNELS:
            parser.error(f"{path}: the file name must be one of {[k + '.cu' for k in KERNELS]}")

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from photon_ml_torch import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        sources, flags = {}, {}
        for path in args.other:
            sources[f"other_{path.stem}"] = path.resolve()
            sources[f"repo_{path.stem}"] = build.CSRC / f"{path.stem}.cu"
            flags[f"other_{path.stem}"] = args.other_flags
        if any(path.stem == "fused_glm" for path in args.other):
            for plan in B1_PLANS:
                tag = "plan_{}_{}_{}".format(*plan)
                sources[tag] = build.CSRC / "fused_glm.cu"
                flags[tag] = _plan_flags(plan)
        built = _build(build, sources, flags, Path(tmp))
        sweep = {k: lib for k, lib in built.items() if k.startswith("plan_")}
        for path in args.other:
            libs = {k: built[f"{k}_{path.stem}"] for k in ("other", "repo")}
            pair = {k: sources[f"{k}_{path.stem}"] for k in ("other", "repo")}
            rows = {"fused_glm": lambda: _fused(torch, chip_smoke, libs, sweep, args),
                    "packed_glm": lambda: _packed(torch, chip_smoke, libs, args),
                    "sparse_gather": lambda: _gather(torch, chip_smoke, libs, pair, args),
                    }[path.stem]()
            for row in rows:
                print(json.dumps(row), flush=True)
                if row.get("matches_plain") is False:
                    return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
