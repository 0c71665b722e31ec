"""The port's forms of the three earliest TPU kernels, P1-P3
(``experiments/kernel_probe.py``, ``kernel_probe2.py``, ``kernel_probe3.py``:
logistic value + gradient, no offsets, no Σr), held on the CPU against the
probes' own ``fused`` run in Pallas interpret mode.

Every variant of each probe's list runs in interpret mode (none fails to
lower). Each maps to the port's separate-column form with a margin unit, a
gradient unit and whether w is rounded to the block's type first
(``dev/torch_kernel_probe.probe_form``); the port's plain version of that
form computes the probe's function. Limits: f32 blocks value rel 1e-5 and
gradient atol 1e-5 max|g|; bf16 blocks (the same rounded inputs on both
sides) 1e-4.
"""

import ast
import functools
import importlib.util
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jax_pallas

from dev import torch_kernel_probe as tkp
from photon_ml_torch.ops import packed_glm
from photon_ml_torch.ops.losses import LogisticLoss

REPO = Path(__file__).resolve().parents[1]
N, D = 2048, 128
PROBE_FILES = {"P1": "kernel_probe", "P2": "kernel_probe2", "P3": "kernel_probe3"}


@functools.lru_cache(maxsize=None)
def _probe(name: str):
    """experiments/<name>.py with ``pl.pallas_call`` in interpret mode."""
    spec = importlib.util.spec_from_file_location(f"_torch_probe_{name}",
                                                  REPO / "experiments" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    pl = types.SimpleNamespace(**vars(jax_pallas))
    pl.pallas_call = functools.partial(jax_pallas.pallas_call, interpret=True)
    module.pl = pl
    return module


def _probe_list(name: str) -> list[tuple]:
    """The ``variants`` list of the probe's ``main()``, read from its source."""
    tree = ast.parse((REPO / "experiments" / f"{name}.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "variants":
            return [tuple(v) for v in ast.literal_eval(node.value)]
    raise AssertionError(f"no variants list in {name}.main")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, D)).astype(np.float32)
    w_true = rng.normal(size=D).astype(np.float32) / np.sqrt(D)
    y = (rng.uniform(size=N) < 1 / (1 + np.exp(-(x @ w_true)))).astype(np.float32)
    w = (0.3 * rng.normal(size=D) / np.sqrt(D / 16)).astype(np.float32)
    return x, y, w


@pytest.mark.parametrize("probe", sorted(PROBE_FILES))
def test_variant_lists_are_the_probes_own(probe):
    """Every variant each probe measures has a port form, in the probe's order."""
    listed = _probe_list(PROBE_FILES[probe])
    ours = [tuple(v) for v in tkp.PROBE_VARIANTS[probe]]
    if probe == "P1":  # (name, margin, grad, tile, x key, dimension semantics)
        listed = [v[:5] for v in listed]
    assert ours == listed


CASES = [(p, v) for p in sorted(PROBE_FILES) for v in tkp.PROBE_VARIANTS[p]]


@pytest.mark.parametrize("probe,variant", CASES, ids=[f"{p} {v[0]}" for p, v in CASES])
def test_plain_form_matches_probe(data, probe, variant):
    x, y, w = data
    name, margin_mode, grad_mode, tile, xkey = variant
    bf16 = xkey == "xbf"
    module = _probe(PROBE_FILES[probe])
    jx = jnp.asarray(x, jnp.bfloat16) if bf16 else jnp.asarray(x)
    col = lambda v: jnp.asarray(v).reshape(-1, 1)  # noqa: E731
    args = (margin_mode, grad_mode, tile, jx, col(y), col(np.ones(N, np.float32)), jnp.asarray(w))
    if probe == "P1":
        semantics = "arbitrary" if name.endswith("arb") else None
        ref_v, ref_g = module.fused(*args, semantics)
    else:
        ref_v, ref_g = module.fused(*args)

    margin_unit, grad_unit, round_w = tkp.probe_form(probe, margin_mode, grad_mode, bf16)
    tx = torch.from_numpy(x).to(torch.bfloat16) if bf16 else torch.from_numpy(x)
    tw = torch.from_numpy(w)
    if round_w:
        tw = tw.to(tx.dtype).float()
    value, grad, rsum = packed_glm.columns_core_reference(
        LogisticLoss(), tx, torch.from_numpy(y), torch.ones(N), None, tw, with_rsum=False,
        margin_unit=margin_unit, grad_unit=grad_unit)
    assert rsum is None
    rtol = 1e-4 if bf16 else 1e-5
    rg = np.asarray(ref_g, dtype=np.float64)
    np.testing.assert_allclose(float(value), float(ref_v), rtol=rtol)
    np.testing.assert_allclose(grad.double().numpy(), rg, rtol=rtol, atol=rtol * np.abs(rg).max())


def test_forms_and_limits():
    """The mapping's three rules, and the base limits under every TF32 slack."""
    # probe 1 keeps w in f32: a bf16 block's mxu margins promote to f32
    assert tkp.probe_form("P1", "mxu", "mxu", True) == ("mma_tf32", "mma", False)
    assert tkp.probe_form("P1", "mxu", "mxu", False) == ("mma", "mma", False)
    # probes 2 and 3 round w to the block's type; mxu_cast casts the tile up
    assert tkp.probe_form("P2", "mxu_w128", "mxu_r128", True) == ("mma", "mma", True)
    assert tkp.probe_form("P3", "mxu_cast", "vpu", True) == ("mma_tf32", "fma", True)
    assert tkp.limits("bfloat16") == (1e-4, 1e-4)
    assert tkp.limits("float32") == (1e-5, 1e-4)
    assert tkp.tf32_units("float32", "mma", "fma") == (True, False)
    assert tkp.tf32_units("bfloat16", "mma", "mma_tf32") == (False, True)
    assert tkp.tf32_units("bfloat16", "mma", "mma") == (False, False)
    assert set(tkp.MODES.values()) <= set(packed_glm.UNITS)
    assert set(tkp.PROBE_REPLACES) == set(PROBE_FILES)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_tf32_unit_plain_version_keeps_f32_operands(data, bf16):
    """``mma_tf32``'s plain version is f32 arithmetic on the widened block,
    the same function as ``fma`` (the kernel's TF32 rounding is the card's);
    the bf16 ``mma`` rounds w and r to bf16 and so differs on a bf16 block."""
    x, y, w = data
    tx = torch.from_numpy(x).to(torch.bfloat16) if bf16 else torch.from_numpy(x)
    args = (LogisticLoss(), tx, torch.from_numpy(y), torch.ones(N), None, torch.from_numpy(w))
    fma = packed_glm.columns_core_reference(*args, with_rsum=False)
    tf32 = packed_glm.columns_core_reference(*args, with_rsum=False, margin_unit="mma_tf32",
                                             grad_unit="mma_tf32")
    mma = packed_glm.columns_core_reference(*args, with_rsum=False, margin_unit="mma",
                                            grad_unit="mma")
    assert torch.equal(fma[0], tf32[0]) and torch.equal(fma[1], tf32[1])
    assert torch.equal(fma[1], mma[1]) != bf16


def test_cpu_block_launches_nothing(data):
    """On a CPU tensor the wrapper runs the plain version and counts no launch."""
    x, y, w = data
    before = packed_glm.columns_launches
    got = packed_glm.columns_core(LogisticLoss(), torch.from_numpy(x), torch.from_numpy(y),
                                  torch.ones(N), None, torch.from_numpy(w), with_rsum=False,
                                  margin_unit="mma_tf32", grad_unit="mma_tf32")
    assert packed_glm.columns_launches == before and got[2] is None


def test_tf32_unit_is_logistic_only(data):
    """``mma_tf32`` is built for the probes' logistic loss only: the plain
    version and the objective refuse it for another loss, as the kernel's
    wrapper does."""
    from photon_ml_torch.ops.losses import SquaredLoss
    from photon_ml_torch.ops.objective import GLMObjective

    x, y, w = data
    args = (SquaredLoss(), torch.from_numpy(x), torch.from_numpy(y), torch.ones(N), None,
            torch.from_numpy(w))
    with pytest.raises(ValueError, match="logistic loss only"):
        packed_glm.columns_core(*args, with_rsum=False, margin_unit="fma", grad_unit="mma_tf32")
    with pytest.raises(ValueError, match="logistic loss only"):
        GLMObjective(SquaredLoss(), kernel_unit="mma_tf32")
    GLMObjective(LogisticLoss(), kernel_unit="mma_tf32")


def _tf32(t):
    """Round f32 to TF32 as cvt.rna does: to nearest, ties away from zero."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_emulation(x, y, ws, w, margin_unit, grad_unit):
    """The kernel's function with TF32 operands, emulated on the CPU: (value,
    gradient, None); every product in f64 so that only the roundings differ
    from the plain version."""
    loss = LogisticLoss()
    tm, tg = tkp.tf32_units(str(x.dtype)[6:], margin_unit, grad_unit)
    xm = (_tf32(x) if x.dtype == torch.float32 else x.float()).double()
    m = (xm if tm else x.double()) @ (_tf32(w) if tm else w).double()
    l, dz = loss.loss_and_dz(m, y.double())
    r = (ws.double() * dz).float()
    r = _tf32(r) if tg else (r.to(torch.bfloat16).float() if grad_unit == "mma" else r)
    return ((ws.double() * l).sum().float(), (r.double() @ (xm if tg else x.double())).float(),
            None)


UNIT_FORMS = [(("mma", "mma"), False), (("mma", "fma"), False), (("fma", "mma"), False),
              (("mma_tf32", "mma_tf32"), True), (("mma_tf32", "mma"), True),
              (("fma", "mma_tf32"), True)]


@pytest.mark.parametrize("units,bf16", UNIT_FORMS,
                         ids=[f"{u[0]}-{u[1]}-{'bf16' if b else 'f32'}" for u, b in UNIT_FORMS])
def test_tf32_limit_holds_rounding_and_catches_a_dropped_chunk(data, units, bf16):
    """The derived TF32 limit (``tf32_slack`` over the f32 or bf16 limits):
    the kernel's function with TF32 operands, emulated, stays within it; the
    plain version with one 16-column k chunk of w dropped, fed to the check
    in the kernel's place, misses it by more than 100x."""
    x, y, w = data
    tx = torch.from_numpy(x).to(torch.bfloat16) if bf16 else torch.from_numpy(x)
    ty, tw, ones = torch.from_numpy(y), torch.from_numpy(w), torch.ones(N)
    loss = LogisticLoss()
    kw = dict(with_rsum=False, margin_unit=units[0], grad_unit=units[1])
    plain = lambda: packed_glm.columns_core_reference(loss, tx, ty, ones, None, tw, **kw)  # noqa: E731
    dropped = tw.clone()
    dropped[16:32] = 0.0
    name = str(tx.dtype)[6:]
    slack = tkp.tf32_slack(loss, tx, ty, None, ones, tw, None, *units)
    assert slack is not None
    held = tkp.compare(torch, "emulated TF32", lambda: _tf32_emulation(tx, ty, ones, tw, *units),
                       plain, *tkp.limits(name), float(N), slack)
    assert held["limit_share"] < 1.0
    with pytest.raises(AssertionError, match="off by"):
        tkp.compare(torch, "dropped chunk", lambda: packed_glm.columns_core_reference(
            loss, tx, ty, ones, None, dropped, **kw), plain, *tkp.limits(name), float(N),
            slack)
    vr, gr, _ = plain()
    vf, gf, _ = packed_glm.columns_core_reference(loss, tx, ty, ones, None, dropped, **kw)
    base_v, base_g = tkp.limits(name)
    share = max(abs(float(vf - vr)) / (base_v * abs(float(vr)) + slack[0]),
                float(((gf - gr).double().abs() / (1e-4 * gr.double().abs()
                                                   + base_g * float(gr.abs().max())
                                                   + slack[1])).max()))
    assert share > 100.0, share
