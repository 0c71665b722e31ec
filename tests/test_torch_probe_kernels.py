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
    """The mapping's three rules, and the TF32 limit for ``mma_tf32``."""
    # probe 1 keeps w in f32: a bf16 block's mxu margins promote to f32
    assert tkp.probe_form("P1", "mxu", "mxu", True) == ("mma_tf32", "mma", False)
    assert tkp.probe_form("P1", "mxu", "mxu", False) == ("mma", "mma", False)
    # probes 2 and 3 round w to the block's type; mxu_cast casts the tile up
    assert tkp.probe_form("P2", "mxu_w128", "mxu_r128", True) == ("mma", "mma", True)
    assert tkp.probe_form("P3", "mxu_cast", "vpu", True) == ("mma_tf32", "fma", True)
    assert tkp.limits("bfloat16", "mma_tf32", "fma") == (1e-4, 5e-3)
    assert tkp.limits("bfloat16", "mma", "mma") == (1e-4, 1e-4)
    assert tkp.limits("float32", "fma", "fma") == (1e-5, 1e-4)
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
