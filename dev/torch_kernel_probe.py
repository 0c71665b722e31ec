#!/usr/bin/env python3
"""Operand-form and unit study of the port's fused GLM kernels, on one GPU.

    python3 dev/torch_kernel_probe.py [--seed 0] [--check-only]

The port's entry point for what ``experiments/kernel_probe.py``,
``kernel_probe2.py``, ``kernel_probe3.py``, ``kernel_probe5.py``,
``kernel_probe6.py`` and ``kernel_probe7.py`` measured: at N = 2^17,
D = 512 (logistic loss, f32 and bf16 feature blocks) it holds every variant
of ``photon_ml_torch/ops/packed_glm.py`` against its plain version (twice,
bitwise equal) and times it by CUDA-graph replay
(``chip_smoke._device_ms``), beside a one-read stream of X from the same
run, and prints one JSON line per variant:

- separate columns: the repo's separate-column kernel (``ops/fused_glm.py``)
  called directly and through its wrapper; the separate form with offsets
  and Σr, without offsets, without Σr;
- packed aux: prebuilt with and without Σr, and packed anew in every call;
- units: margin x gradient in {fma, mma}, f32 and bf16, 16 and 32 rows a tile;
- probes 1-3 (P1, P2, P3): every variant of each probe's list, as the
  separate-column form with neither offsets nor Σr (unit weights, as the
  probes run), each product mode mapped to the port's unit (``probe_form``);
  besides its check and times, each variant takes ``STEPS`` gradient steps
  ``w <- w - 1e-4 g`` (the probes' measured step), whose kernel launches are
  the row's ``launches``; and the two-pass closed form (``X@w``, loss,
  ``r@X``), which stands in for the probes' autodiff step.

``--check-only`` stops after the comparisons (the first run of a new build).
Limits: value rel 1e-5 (f32) or 1e-4 (bf16, the same rounded inputs on both
sides), gradient rtol 1e-4 and atol 1e-4 max|g|; a product in TF32 (``mma``
on an f32 block, ``mma_tf32`` on either) against the plain version's f32:
value rel 1e-4 and gradient atol 5e-3 max|g|.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
N, D = 1 << 17, 512
RAGGED = (1000 + 7, 123)


#: gradient steps per probe-1-3 variant (the launches on that path)
STEPS = 16

#: (variant, margin mode, gradient mode, row tile, feature block) as each
#: probe lists them: experiments/kernel_probe.py:152-164 (P1, w in f32),
#: kernel_probe2.py:142-151 and kernel_probe3.py:154-163 (P2, P3: ``fused``
#: rounds w to the block's type first)
PROBE_VARIANTS = {
    "P1": (("vpu/vpu t1024 f32", "vpu", "vpu", 1024, "x"),
           ("mxu/vpu t1024 f32", "mxu", "vpu", 1024, "x"),
           ("vpu/mxu t1024 f32", "vpu", "mxu", 1024, "x"),
           ("mxu/mxu t1024 f32", "mxu", "mxu", 1024, "x"),
           ("mxu/mxu t512  f32", "mxu", "mxu", 512, "x"),
           ("mxu/mxu t2048 f32", "mxu", "mxu", 2048, "x"),
           ("mxu/mxu t256  f32", "mxu", "mxu", 256, "x"),
           ("mxu/mxu t1024 f32 arb", "mxu", "mxu", 1024, "x"),
           ("mxu/mxu t1024 bf16", "mxu", "mxu", 1024, "xbf"),
           ("mxu/mxu t2048 bf16", "mxu", "mxu", 2048, "xbf"),
           ("vpu/vpu t1024 bf16", "vpu", "vpu", 1024, "xbf")),
    "P2": (("mxu_col/mxu  t1024 f32", "mxu_col", "mxu", 1024, "x"),
           ("mxu_col/mxu  t1024 bf16", "mxu_col", "mxu", 1024, "xbf"),
           ("mxu_w128/vpu t1024 bf16", "mxu_w128", "vpu", 1024, "xbf"),
           ("mxu_w128/mxu_r128 t1024 bf16", "mxu_w128", "mxu_r128", 1024, "xbf"),
           ("vpu/mxu_r128 t1024 bf16", "vpu", "mxu_r128", 1024, "xbf"),
           ("mxu_w128/mxu_r128 t2048 bf16", "mxu_w128", "mxu_r128", 2048, "xbf"),
           ("vpu/vpu t512 bf16", "vpu", "vpu", 512, "xbf"),
           ("vpu/vpu t2048 bf16", "vpu", "vpu", 2048, "xbf")),
    "P3": (("mxu_col/mxu t512 f32", "mxu_col", "mxu", 512, "x"),
           ("mxu_col/mxu t2048 f32", "mxu_col", "mxu", 2048, "x"),
           ("mxu_cast/mxu_cast t512 bf16", "mxu_cast", "mxu_cast", 512, "xbf"),
           ("mxu_cast/mxu_cast t1024 bf16", "mxu_cast", "mxu_cast", 1024, "xbf"),
           ("mxu_cast/vpu t512 bf16", "mxu_cast", "vpu", 512, "xbf"),
           ("vpu/mxu_cast t512 bf16", "vpu", "mxu_cast", 512, "xbf"),
           ("mxu_cast/mxu_cast t2048 bf16", "mxu_cast", "mxu_cast", 2048, "xbf"),
           ("vpu/vpu t256 bf16", "vpu", "vpu", 256, "xbf")),
}

#: the TPU functions the three probes' variants run
PROBE_REPLACES = {"P1": "experiments/kernel_probe.py:74",
                  "P2": "experiments/kernel_probe2.py:73",
                  "P3": "experiments/kernel_probe3.py:85"}

#: a probe's product mode -> the port's unit: ``vpu`` is f32 arithmetic on
#: the widened tile; ``mxu`` and its layout workarounds (``mxu_col``,
#: ``mxu_w128``, ``mxu_r128``) multiply the operands in the tile's type;
#: ``mxu_cast`` multiplies in f32 on the widened tile
MODES = {"vpu": "fma", "mxu": "mma", "mxu_col": "mma", "mxu_w128": "mma",
         "mxu_r128": "mma", "mxu_cast": "mma_tf32"}


def probe_form(probe: str, margin_mode: str, grad_mode: str, bf16: bool):
    """(margin unit, gradient unit, round w to the block's type) of one
    probe variant. Probe 1 passes w in f32, so its ``mxu`` margins on a bf16
    block promote to an f32 product on the widened tile (``mma_tf32``);
    probes 2 and 3 round w to the block's type before the kernel, as their
    ``fused`` does."""
    margin_unit, grad_unit = MODES[margin_mode], MODES[grad_mode]
    round_w = probe != "P1"
    if bf16 and not round_w and margin_unit == "mma":
        margin_unit = "mma_tf32"
    return margin_unit, grad_unit, round_w


def limits(dtype_name: str, margin_unit: str, grad_unit: str) -> tuple[float, float]:
    """(value rel, gradient atol as a share of max|g|) for one variant."""
    units = (margin_unit, grad_unit)
    if "mma_tf32" in units or (dtype_name == "float32" and "mma" in units):
        return 1e-4, 5e-3
    return (1e-5 if dtype_name == "float32" else 1e-4), 1e-4


def compare(torch, tag, kernel, plain, value_rel, grad_share, rsum_scale):
    """Call ``kernel`` twice and ``plain`` once; returns the errors, raising
    when the kernel is not bitwise repeatable or misses its plain version
    (Σr within 0.1 * value_rel * rsum_scale, the sum of the weights)."""
    v1, g1, s1 = kernel()
    v2, g2, s2 = kernel()
    vr, gr, sr = plain()
    torch.cuda.synchronize()
    assert torch.equal(v1, v2) and torch.equal(g1, g2), f"not bitwise repeatable: {tag}"
    assert bool(torch.isfinite(v1)) and bool(torch.isfinite(g1).all()), f"not finite: {tag}"
    rel = abs(float(v1 - vr)) / max(abs(float(vr)), 1e-30)
    gmax = float(gr.abs().max())
    gerr = float((g1 - gr).abs().max())
    assert rel <= value_rel, f"value rel {rel} > {value_rel}: {tag}"
    assert torch.allclose(g1, gr, rtol=1e-4, atol=grad_share * gmax), \
        f"gradient off by {gerr} (max |g| {gmax}, atol {grad_share} of it): {tag}"
    out = {"value_rel": rel, "grad_abs": gerr, "grad_over_max": gerr / gmax}
    assert (s1 is None) == (sr is None), f"Σr presence differs: {tag}"
    if s1 is not None:
        assert torch.equal(s1, s2), f"Σr not bitwise repeatable: {tag}"
        out["rsum_abs"] = abs(float(s1 - sr))
        assert out["rsum_abs"] <= 0.1 * value_rel * rsum_scale, \
            f"Σr {float(s1)} vs {float(sr)}: {tag}"
    return out


def _inputs(torch, dev, seed, n, d):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, d, device=dev, generator=gen)
    w_true = torch.randn(d, device=dev, generator=gen) / d ** 0.5
    y = (torch.rand(n, device=dev, generator=gen) < torch.sigmoid(x @ w_true)).float()
    o = 0.1 * torch.randn(n, device=dev, generator=gen)
    ws = 0.2 + 1.8 * torch.rand(n, device=dev, generator=gen)
    ws[::5] = 0.0
    w = 0.3 * torch.randn(d, device=dev, generator=gen) / (d / 16) ** 0.5
    return x, y, o, ws, w


def run(torch, device_ms, seed: int = 0, dev=None, times: bool = True) -> list[dict]:
    """Every variant's row: name, kernel ("P1"-"P3", "P5"-"P7" or the separate-
    column kernel "B1"), errors against the plain version, and with ``times``
    the device time ``ms``, the plain version's ``plain_ms`` and the share of
    the stream's rate ``frac``."""
    from photon_ml_torch.data.batch import LabeledPointBatch
    from photon_ml_torch.ops import fused_glm, packed_glm
    from photon_ml_torch.ops.losses import LogisticLoss

    dev = dev or torch.device("cuda")
    loss = LogisticLoss()
    rows: list[dict] = []

    # ragged shape first: every form, unit and dtype masks n and d in the kernel
    x, y, o, ws, w = _inputs(torch, dev, seed + 1, *RAGGED)
    shift = torch.tensor(0.05, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        xt, name = x.to(dtype), str(dtype)[6:]
        aux = packed_glm.pack_aux(y, o, ws)
        for mu in packed_glm.UNITS:
            for gu in packed_glm.UNITS:
                for rpt in sorted(packed_glm.SOURCES):
                    for with_rsum in (True, False):
                        kw = dict(with_rsum=with_rsum, margin_unit=mu, grad_unit=gu)
                        tag = f"ragged packed {name} {mu}/{gu} rows={rpt} rsum={with_rsum}"
                        compare(torch, tag,
                                lambda: packed_glm.packed_core(loss, xt, aux, w, shift,
                                                               rows_per_tile=rpt, **kw),
                                lambda: packed_glm.packed_core_reference(loss, xt, aux, w, shift,
                                                                         **kw),
                                *limits(name, mu, gu), float(ws.sum()))
        for with_o in (True, False):
            for with_rsum in (True, False):
                off = o if with_o else None
                tag = f"ragged columns {name} o={with_o} rsum={with_rsum}"
                compare(torch, tag,
                        lambda: packed_glm.columns_core(loss, xt, y, ws, off, w,
                                                        with_rsum=with_rsum),
                        lambda: packed_glm.columns_core_reference(loss, xt, y, ws, off, w,
                                                                  with_rsum=with_rsum),
                        *limits(name, "fma", "fma"), float(ws.sum()))
    rows.append({"variant": f"ragged shape {list(RAGGED)}: every form, unit, dtype and tile",
                 "kernel": "P5 P6 P7", "ok": True})

    x, y, o, ws, w = _inputs(torch, dev, seed, N, D)
    xs = {"float32": x, "bfloat16": x.to(torch.bfloat16)}
    aux = packed_glm.pack_aux(y, o, ws)
    stream = {}
    if times:
        for name, xt in xs.items():
            wt = w.to(xt.dtype)
            stream[name] = device_ms(torch, lambda: torch.mv(xt, wt))
            rows.append({"variant": f"stream: one read of X {name}", "kernel": None,
                         "ms": stream[name],
                         "GBps": xt.numel() * xt.element_size() / stream[name] / 1e6})

    def add(variant, kernel_id, name, fn, plain, mu="fma", gu="fma", **extra):
        row = {"variant": variant, "kernel": kernel_id, "dtype": name, "shape": [N, D],
               **compare(torch, variant, fn, plain, *limits(name, mu, gu), float(ws.sum())),
               **extra}
        if times:
            row["ms"] = device_ms(torch, fn)
            row["plain_ms"] = device_ms(torch, plain)
            row["frac"] = stream[name] / row["ms"]
        rows.append(row)

    # separate columns (kernel_probe5's a-e): the repo kernel direct and
    # through its wrapper, then the separate form with and without o and Σr
    batch = LabeledPointBatch(features=x, labels=y, offsets=o, weights=ws)

    def full_wrapper():
        v, g = fused_glm.fused_value_and_gradient(loss, w, batch)
        return v, g, None

    def full_wrapper_plain():
        v, g = fused_glm.fused_value_and_gradient_reference(loss, w, batch)
        return v, g, None

    add("a) separate-column repo kernel direct (o + Σr)", "B1", "float32",
        lambda: fused_glm.reduce_partials(*fused_glm.fused_partials(loss, x, y, o, ws, w)),
        lambda: packed_glm.columns_core_reference(loss, x, y, ws, o, w))
    for variant, with_o, with_rsum in (("b) columns o + Σr", True, True),
                                       ("c) columns Σr only (no offsets input)", False, True),
                                       ("d) columns o only (no Σr output)", True, False)):
        off = o if with_o else None
        add(variant, "P5", "float32",
            lambda: packed_glm.columns_core(loss, x, y, ws, off, w, with_rsum=with_rsum),
            lambda: packed_glm.columns_core_reference(loss, x, y, ws, off, w,
                                                      with_rsum=with_rsum))
    add("e) separate-column full wrapper", "B1", "float32", full_wrapper, full_wrapper_plain)

    # packed aux (kernel_probe6's v1, v2, v5)
    add("v1 packed aux prebuilt, Σr", "P6", "float32",
        lambda: packed_glm.packed_core(loss, x, aux, w),
        lambda: packed_glm.packed_core_reference(loss, x, aux, w))
    add("v2 packed aux stacked in every call, Σr", "P6", "float32",
        lambda: packed_glm.packed_core(loss, x, packed_glm.pack_aux(y, o, ws), w),
        lambda: packed_glm.packed_core_reference(loss, x, packed_glm.pack_aux(y, o, ws), w))
    add("v5 packed aux prebuilt, no Σr", "P6", "float32",
        lambda: packed_glm.packed_core(loss, x, aux, w, with_rsum=False),
        lambda: packed_glm.packed_core_reference(loss, x, aux, w, with_rsum=False))
    add("v1 packed aux prebuilt, Σr", "P6", "bfloat16",
        lambda: packed_glm.packed_core(loss, xs["bfloat16"], aux, w),
        lambda: packed_glm.packed_core_reference(loss, xs["bfloat16"], aux, w))

    # units (kernel_probe7): margin x gradient unit, dtype, rows per tile
    for name, xt in xs.items():
        for rpt in sorted(packed_glm.SOURCES):
            for mu in ("fma", "mma"):
                for gu in ("fma", "mma"):
                    kw = dict(margin_unit=mu, grad_unit=gu)
                    add(f"{name} {mu}/{gu} rows={rpt}", "P7", name,
                        lambda: packed_glm.packed_core(loss, xt, aux, w, rows_per_tile=rpt, **kw),
                        lambda: packed_glm.packed_core_reference(loss, xt, aux, w, **kw),
                        mu, gu, margin_unit=mu, grad_unit=gu, rows_per_tile=rpt)

    # probes 1-3: unit weights, no offsets, no Σr, logistic loss
    ones = torch.ones_like(ws)
    for name, xt in xs.items():
        if times:
            closed = lambda: packed_glm.columns_core_reference(  # noqa: E731
                loss, xt, y, ones, None, w, with_rsum=False)
            # the same two products as single PyTorch calls, in X's type
            wt, rt = w.to(xt.dtype), torch.rand(N, device=dev).to(xt.dtype)
            rows.append({"variant": f"two-pass closed form {name} (X@w, loss, r@X)",
                         "kernel": None, "dtype": name, "ms": device_ms(torch, closed),
                         "library_ms": device_ms(torch, lambda: (torch.matmul(xt, wt),
                                                                 torch.matmul(rt, xt)))})
    for probe, variants in PROBE_VARIANTS.items():
        for variant, margin_mode, grad_mode, tile, xkey in variants:
            xt = xs["bfloat16" if xkey == "xbf" else "float32"]
            name = str(xt.dtype)[6:]
            mu, gu, round_w = probe_form(probe, margin_mode, grad_mode, xkey == "xbf")
            wk = w.to(xt.dtype).float() if round_w else w
            kw = dict(with_rsum=False, margin_unit=mu, grad_unit=gu)

            def kernel(wk=wk, xt=xt, kw=kw):
                return packed_glm.columns_core(loss, xt, y, ones, None, wk, **kw)

            def plain(wk=wk, xt=xt, kw=kw):
                return packed_glm.columns_core_reference(loss, xt, y, ones, None, wk, **kw)

            before = packed_glm.columns_launches
            step_w = w.clone()
            for _ in range(STEPS):  # the probes' measured step
                sw = step_w.to(xt.dtype).float() if round_w else step_w
                _, g, _ = packed_glm.columns_core(loss, xt, y, ones, None, sw, **kw)
                step_w = step_w - 1e-4 * g
            launches = packed_glm.columns_launches - before
            assert launches == STEPS, f"{probe} {variant}: {launches} launches in {STEPS} steps"
            add(f"{probe} {variant}", probe, name, kernel, plain, mu, gu, margin_unit=mu,
                grad_unit=gu, round_w=round_w, probe_modes=[margin_mode, grad_mode],
                probe_tile=tile, launches=launches)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--check-only", action="store_true")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_probe: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from photon_ml_torch import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"build: {json.dumps(build.build_all())}", flush=True)
    for row in run(torch, chip_smoke._device_ms, args.seed, times=not args.check_only):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
