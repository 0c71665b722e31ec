#!/usr/bin/env python3
"""Operand-form and unit study of the port's fused GLM kernels, on one GPU.

    python3 dev/torch_kernel_probe.py [--seed 0] [--check-only]

The port's entry point for what ``experiments/kernel_probe5.py``,
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
- units: margin x gradient in {fma, mma}, f32 and bf16, 16 and 32 rows a tile.

``--check-only`` stops after the comparisons (the first run of a new build).
Limits: value rel 1e-5 (f32) or 1e-4 (bf16, the same rounded inputs on both
sides), gradient rtol 1e-4 and atol 1e-4 max|g|; an f32 block with a product
in ``mma`` (TF32 operands against the plain version's f32) value rel 1e-4
and gradient atol 5e-3 max|g|.
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


def limits(dtype_name: str, margin_unit: str, grad_unit: str) -> tuple[float, float]:
    """(value rel, gradient atol as a share of max|g|) for one variant."""
    if dtype_name == "float32" and "mma" in (margin_unit, grad_unit):
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
    """Every variant's row: name, kernel ("P5", "P6", "P7" or the separate-
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
            for mu in packed_glm.UNITS:
                for gu in packed_glm.UNITS:
                    kw = dict(margin_unit=mu, grad_unit=gu)
                    add(f"{name} {mu}/{gu} rows={rpt}", "P7", name,
                        lambda: packed_glm.packed_core(loss, xt, aux, w, rows_per_tile=rpt, **kw),
                        lambda: packed_glm.packed_core_reference(loss, xt, aux, w, **kw),
                        mu, gu, margin_unit=mu, grad_unit=gu, rows_per_tile=rpt)
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
