#!/usr/bin/env python3
"""Compare other versions of the port's kernels with the ones in the repo, on one GPU.

    python3 dev/torch_kernel_ab.py OTHER.cu [OTHER.cu ...] [--rounds 3] [--chunk-rounds N] [--seed 0]
                                   [--other-flags=-DNAME ...]

Each OTHER.cu is a variant of the repo's ``photon_ml_torch/csrc/<name>.cu``
with the same file name (for example the parent commit's copy, written with
``git show <parent>:photon_ml_torch/csrc/packed_glm.cu``, beside that
commit's ``glm_tile.cuh``, which it includes): ``fused_glm.cu``,
``packed_glm.cu`` or ``sparse_gather.cu``. A source in the repo's interface
or in the one before it (a gather whose chunk plan has ``[n+1]`` chunk
pointers) is taken. ``--other-flags`` adds
nvcc flags to the other build only (a variant of the repo's own source).
Both builds use the port's nvcc flags, are checked against the plain
PyTorch version on every case before they are timed, and are timed in
alternating order (other, repo, repo, other, ...). One JSON line per case,
build and round: device time ``ms`` (CUDA graph replay,
``chip_smoke._device_ms``); for B1 and the packed kernel also the partials
kernel alone (``partials_ms``) and, after the rounds, whether the two
builds' outputs are bitwise equal. The reduction's cost is the core's time
less the partials': the packed kernel's ``ms`` is its core; B1's core is
``core_ms``, and its ``ms`` and ``eager_ms`` the whole wrapper
(``fused_value_and_gradient``, normalization included).

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
  mma/mma; with Σr), on the source's 16-row build (the training path's).
- sparse_gather: the ELL margins at [2^19, 36], d=10^7, f32 and bf16; an
  ELL+tail block ([2^19, 17] and 0-8 flat entries a row); long flat rows
  (2^16 rows of 48-80 entries, a warp a row); G1's one segment of 2^24
  entries, d=2^22, and G2's of 2^22, d=2^21 (chunked); the chunk kernel
  alone over G1, G2 and the planted transpose's chunks (``--chunk-rounds``
  alternating rounds, then cuSPARSE's product of a CSR matrix whose rows are
  the chunks, ``chip_smoke._chunk_csr``); and the transposes
  (the segment kernel over a column-sorted plan): of the ELL block with f32
  and bf16 values, of the same block with its last 4 columns a row drawn
  from a 256-column planted support (chip_smoke.py's ELL batch: about 1100
  chunks), of chip_smoke.py's hybrid tails at d=10^7 and d=10^8, of two
  batches of few rows at d=2^16 (chip_smoke.py's small problem, 4096 rows,
  and 2^14 rows of 32), and of the ELL block with its rows taken modulo 2^14
  (r's gathers then stay in 64 KB). Each transpose row says whether the two
  builds' outputs are bitwise equal, and gives cuSPARSE's CSR ``[d, n] @ r``
  of the same entries (bf16 values widened to f32). Then the repo build
  alone: the ELL kernel's plans (``GATHER_PLANS``) at [2^19, 36], d=10^7,
  and its chosen plan there and over the same rows with columns taken
  modulo 2^22 (a 16 MB w), each beside cuSPARSE's CSR product of the same
  entries.
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
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
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
            outs = {}
            for which in _order(args.rounds):
                use(which)
                v, g = fused_glm.fused_value_and_gradient(loss, w, b, normalization=norm)
                outs.setdefault(which, (v, g))
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
                    "core_ms": chip_smoke._device_ms(torch, lambda: fused_glm._kernel_core(
                        loss, b.features, b.labels, b.offsets, b.weights, w, None)),
                    "ms": chip_smoke._device_ms(torch, call),
                    "eager_ms": chip_smoke._eager_ms(torch, call),
                }
            yield {"kernel": "fused_glm", "shape": [n, d], "dtype": str(dtype)[6:],
                   "build": "both", "bitwise_equal_builds": all(
                       torch.equal(a, b_) for a, b_ in zip(outs["repo"], outs["other"]))}
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

    bound = {}
    for which, lib in libs.items():
        build._LOADED["packed_glm"] = lib
        packed_glm._LIBS.clear()
        bound[which] = packed_glm._lib(16)

    def use(which):
        packed_glm._LIBS.clear()
        packed_glm._LIBS[16] = bound[which]
        packed_glm._GRID.clear()

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
                          loss, xt, y, ones, None, wk, **kw),
                      lambda xt=xt, wk=wk, units=units: packed_glm.launch_partials(
                          loss, xt, None, y, None, ones, wk, None, False, *units)))
    aux = packed_glm.pack_aux(y, o, ws)
    for width, units, with_rsum in ((256, ("fma", "fma"), False), (256, ("fma", "fma"), True),
                                    (256, ("mma", "mma"), False), (512, ("fma", "fma"), False)):
        xg, wg = x[:, :width].contiguous(), w[:width].contiguous()
        kw = dict(with_rsum=with_rsum, margin_unit=units[0], grad_unit=units[1])
        cases.append((f"GAME packed aux [{tkp.N}, {width}] {units[0]}/{units[1]}"
                      + (" with Σr" if with_rsum else ""), xg, units, (xg, y, o, ws, wg, None),
                      lambda xg=xg, wg=wg, kw=kw: packed_glm.packed_core(loss, xg, aux, wg, **kw),
                      lambda xg=xg, wg=wg, kw=kw: packed_glm.packed_core_reference(
                          loss, xg, aux, wg, **kw),
                      lambda xg=xg, wg=wg, units=units, with_rsum=with_rsum:
                          packed_glm.launch_partials(loss, xg, aux, None, None, None, wg, None,
                                                     with_rsum, *units)))
    for case, xt, units, inputs, kernel, plain, partials in cases:
        name = str(xt.dtype)[6:]
        slack = tkp.tf32_slack(loss, *inputs, *units)
        outs = {}
        for which in _order(args.rounds):
            use(which)
            err = tkp.compare(torch, f"{which} {case}", kernel, plain, *tkp.limits(name),
                              float(inputs[3].sum()), slack)
            outs.setdefault(which, [t for t in kernel() if t is not None])
            yield {"kernel": "packed_glm", "case": case, "dtype": name, "build": which,
                   "limit_share": err["limit_share"], "ms": chip_smoke._device_ms(torch, kernel),
                   "partials_ms": chip_smoke._device_ms(torch, partials)}
        yield {"kernel": "packed_glm", "case": case, "build": "both", "bitwise_equal_builds": all(
            torch.equal(a, b) for a, b in zip(outs["repo"], outs["other"]))}


class _ChunkPointerGather:
    """A sparse_gather library of the interface before the compact chunk
    plan, whose chunk kernel and consumers read chunk_row [C] and chunk_ptr
    [n+1]: ``launch`` is the wrapper that interface had (the plan built from
    the tail's row pointers, once a case), ``chunk_partials`` its chunk
    kernel alone."""

    def __init__(self, lib, torch, sparse_gather):
        self._lib, self._torch, self._sg, self._plans = lib, torch, sparse_gather, {}
        lib.sparse_gather_rows.argtypes = [_I, _I, _I, _VP, _VP, _I, _VP, _VP, _VP, _VP, _VP,
                                           _VP, _LL, _VP, _VP]
        lib.sparse_gather_chunks.argtypes = [_I] + [_VP] * 6 + [_LL, _VP, _VP]
        lib.sparse_gather_segments.argtypes = [_I] + [_VP] * 6 + [_LL, _VP, _VP]

    def forget(self):
        self._plans.clear()

    def _plan(self, row_ptr, chunks):
        """(chunk_row, chunk_ptr) of the tail, kept with the repo's plan."""
        torch = self._torch
        if id(chunks) not in self._plans:
            k = self._sg.SEGMENT_CHUNK
            lens = (row_ptr[1:] - row_ptr[:-1]).long()
            per_row = torch.where(lens > k, (lens + k - 1) // k, 0)
            chunk_ptr = torch.zeros(lens.numel() + 1, dtype=torch.int64, device=lens.device)
            torch.cumsum(per_row, 0, out=chunk_ptr[1:])
            chunk_row = torch.repeat_interleave(torch.arange(lens.numel(), device=lens.device),
                                                per_row)
            self._plans[id(chunks)] = (chunks, chunk_row.int(), chunk_ptr.int())
        return self._plans[id(chunks)][1:]

    def chunk_partials(self, w, tail, chunks):
        torch = self._torch
        vals, cols, _, row_ptr = tail
        chunk_row, chunk_ptr = self._plan(row_ptr, chunks)
        partials = torch.empty((chunk_row.numel(),), dtype=torch.float32, device=w.device)
        err = self._lib.sparse_gather_chunks(
            int(vals.dtype == torch.bfloat16), vals.data_ptr(), cols.data_ptr(),
            row_ptr.data_ptr(), chunk_row.data_ptr(), chunk_ptr.data_ptr(), w.data_ptr(),
            chunk_row.numel(), partials.data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return partials

    def launch(self, w, n, ell, tail, chunks):
        torch, sg = self._torch, self._sg
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        ev = ec = tv = tc = row_ptr = partials = chunk_ptr = None
        width, is_bf16 = 0, False
        if ell is not None:
            ev, ec = ell
            width, is_bf16 = ev.shape[1], ev.dtype == torch.bfloat16
        if tail is not None and tail[0].numel():
            tv, tc, _, row_ptr = tail
            is_bf16 = tv.dtype == torch.bfloat16
            if chunks is not None:
                partials = self.chunk_partials(w, tail, chunks)
                chunk_ptr = self._plan(row_ptr, chunks)[1]
        out = torch.empty((n,), dtype=torch.float32, device=w.device)
        stream = torch.cuda.current_stream().cuda_stream
        if n and ev is None and tv is not None and tv.shape[0] < sg.SHORT_ROWS * n:
            err = self._lib.sparse_gather_segments(
                int(is_bf16), tv.data_ptr(), tc.data_ptr(), row_ptr.data_ptr(), ptr(partials),
                ptr(chunk_ptr), w.data_ptr(), n, out.data_ptr(), stream)
        else:
            lanes, vec = sg.ell_plan(width, ptr(ev) or 0, ptr(ec) or 0, 2 if is_bf16 else 4)
            err = self._lib.sparse_gather_rows(
                int(is_bf16), lanes, vec, ptr(ev), ptr(ec), width, ptr(tv), ptr(tc),
                ptr(row_ptr), ptr(partials), ptr(chunk_ptr), w.data_ptr(), n, out.data_ptr(),
                stream)
        assert err == 0, err
        return out


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


def _transpose_cases(torch, np, chip_smoke, sparse_gather, dev, ev, ec, ec_planted, n, d, seed):
    """(case, r, d, gather kwargs, CSR [d, n]) of the transposes: the ELL
    block's (f32 and bf16 values; random columns, then with the planted
    support's columns, chunked), chip_smoke.py's two hybrid tails, and two
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
    p_vals, p_rows, p_ptr, p_chunks = _column_sorted(torch, sparse_gather, ev, ec_planted, d)
    for dtype in (torch.float32, torch.bfloat16):
        plans.append((f"transpose of the planted ELL block {str(dtype)[6:]}: [{d}] columns",
                      r, d, (p_vals.to(dtype), p_rows, p_ptr, p_chunks)))
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

    launchers = {}
    for which, lib in libs.items():
        if "const void* chunk_row" in Path(sources[which]).read_text():
            launchers[which] = _ChunkPointerGather(lib, torch, sparse_gather)
        else:
            build._LOADED["sparse_gather"] = lib
            sparse_gather._LIB = None
            launchers[which] = sparse_gather._lib()  # binds and checks the sizes
    repo_launch, repo_chunks = sparse_gather._launch, sparse_gather.chunk_partials

    def use(which):
        got = launchers[which]
        if isinstance(got, _ChunkPointerGather):
            sparse_gather._launch, sparse_gather.chunk_partials = got.launch, got.chunk_partials
        else:
            sparse_gather._LIB = got
            sparse_gather._launch, sparse_gather.chunk_partials = repo_launch, repo_chunks

    def forget():
        for got in launchers.values():
            if isinstance(got, _ChunkPointerGather):
                got.forget()

    try:
        yield from _gather_cases(torch, np, chip_smoke, sparse_gather, use, forget, args)
    finally:
        sparse_gather._launch, sparse_gather.chunk_partials = repo_launch, repo_chunks


def _gather_cases(torch, np, chip_smoke, sparse_gather, use, forget, args):
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
    # G1 and G2: one segment each, chunked
    singles = []
    for key, (nnz, dg) in (("G1", (1 << 24, 1 << 22)), ("G2", (1 << 22, 1 << 21))):
        gi = torch.randint(0, dg, (nnz,), device=dev, generator=gen, dtype=torch.int32)
        gvals = torch.randn(nnz, device=dev, generator=gen)
        wg = torch.randn(dg, device=dev, generator=gen)
        gz = torch.zeros(nnz, dtype=torch.int32, device=dev)
        gptr, gchunks = sparse_gather.segment_plan(gz, 1)
        cases.append((f"{key} one segment {nnz} d={dg} (chunked)", wg, 1,
                      dict(tail=(gvals, gi, gz, gptr), chunks=gchunks)))
        singles.append((f"chunk kernel alone, {key}: {gchunks.count} chunks", wg,
                        (gvals, gi, gz, gptr), gchunks))
    cases = [(*c, None) for c in cases]
    # the ELL block with 4 columns a row from a 256-column planted support
    # (chip_smoke.py's planted batch): about 1100 chunks in its transpose
    support = torch.randperm(d, device=dev, generator=gen)[:256].to(torch.int32)
    ec_planted = ec.clone()
    ec_planted[:, -4:] = support[torch.randint(0, 256, (n, 4), device=dev, generator=gen)]
    for case, rk, dk, kw, csr in _transpose_cases(torch, np, chip_smoke, sparse_gather, dev, ev,
                                                  ec, ec_planted, n, d, args.seed):
        cases.append((case, rk, dk, kw, csr))
        if kw["chunks"] is not None and "planted" in case:
            singles.append((f"chunk kernel alone, {case}: {kw['chunks'].count} chunks", rk,
                            kw["tail"], kw["chunks"]))
    for case, vec, tail, plan in singles:
        wide = (tail[0].double(), *tail[1:])
        plain = sparse_gather.chunk_partials_reference(vec.double(), wide, plan)
        scale = sparse_gather.chunk_partials_reference(vec.double().abs(),
                                                       (wide[0].abs(), *tail[1:]), plan)
        for which in _order(args.chunk_rounds or args.rounds):
            use(which)
            got = sparse_gather.chunk_partials(vec, tail, plan)
            share = float(((got.double() - plain).abs() / (1e-5 * scale + 1e-30)).max())
            yield {"kernel": "sparse_gather chunks", "case": case, "build": which,
                   "matches_plain": share <= 1.0, "max_err_over_1e-5_scale": share,
                   "ms": chip_smoke._device_ms(torch, lambda: sparse_gather.chunk_partials(
                       vec, tail, plan))}
        csr = chip_smoke._chunk_csr(torch, tail, plan, vec.shape[0])[0]
        yield {"kernel": "sparse_gather chunks", "case": case, "build": "library",
               "library_ms": chip_smoke._device_ms(torch, lambda: csr @ vec)}
        forget()
        del plain, scale, csr
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
        forget()
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
    parser.add_argument("--chunk-rounds", type=int, default=0,
                        help="rounds of the chunk-kernel-alone cases (default: --rounds)")
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
