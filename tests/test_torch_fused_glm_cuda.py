"""The CUDA kernel of ops/fused_glm.py against its plain version, on the card.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed. Every test needs an NVIDIA GPU and skips without one; on the
card run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_glm_cuda.py
"""

import numpy as np
import pytest
import torch

from photon_ml_torch.data.batch import LabeledPointBatch
from photon_ml_torch.ops import fused_glm, losses
from photon_ml_torch.ops.normalization import NormalizationContext

pytestmark = pytest.mark.cuda

LOSS_NAMES = ["LogisticLoss", "SquaredLoss", "PoissonLoss", "SmoothedHingeLoss"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(n, d, binary, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = ((rng.uniform(size=n) < 0.5) if binary else rng.uniform(0, 3, size=n)).astype(np.float32)
    o = rng.normal(scale=0.1, size=n).astype(np.float32)
    ws = rng.uniform(0.2, 2.0, size=n).astype(np.float32)
    ws[::5] = 0.0
    batch = LabeledPointBatch.create(x, y, o, ws, dtype=dtype, device=device)
    w = torch.tensor(rng.normal(size=d) * 0.3 / np.sqrt(d / 16), dtype=torch.float32,
                     device=device)
    norm = NormalizationContext(
        torch.tensor(rng.uniform(0.5, 2.0, size=d), dtype=torch.float32, device=device),
        torch.tensor(rng.normal(scale=0.1, size=d), dtype=torch.float32, device=device))
    return batch, w, norm


def _hold(loss, w, batch, norm):
    """Kernel twice (bitwise equal, two launches) against the plain version
    on the same (bf16-rounded) inputs: value rel 1e-5, gradient rtol 1e-4,
    atol 1e-4·max|g|."""
    before = fused_glm.launches
    kw = dict(l2_weight=0.5, normalization=norm)
    v1, g1 = fused_glm.fused_value_and_gradient(loss, w, batch, **kw)
    v2, g2 = fused_glm.fused_value_and_gradient(loss, w, batch, **kw)
    vr, gr = fused_glm.fused_value_and_gradient_reference(loss, w, batch, **kw)
    torch.cuda.synchronize()
    assert fused_glm.launches == before + 2
    # deterministic reduction: repeated calls are bitwise equal
    assert torch.equal(v1, v2) and torch.equal(g1, g2)
    np.testing.assert_allclose(float(v1), float(vr), rtol=1e-5)
    scale = float(gr.abs().max())
    np.testing.assert_allclose(g1.cpu().numpy(), gr.cpu().numpy(), rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("shape", [(1000, 123), (4096, 512), (512, 8192), (7, 3),
                                   (300, 8193)],
                         ids=lambda s: f"n{s[0]}_d{s[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", LOSS_NAMES)
def test_kernel_matches_plain_version(cuda, name, dtype, shape):
    loss = getattr(losses, name)()
    batch, w, norm = _case(*shape, name in ("LogisticLoss", "SmoothedHingeLoss"), dtype, cuda)
    _hold(loss, w, batch, norm)


@pytest.mark.parametrize("shift", [False, True], ids=["scaled", "shifted"])
@pytest.mark.parametrize("d", [1, 15, 512, 1537, 2048, 3072, 4099])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", LOSS_NAMES)
def test_one_pass_widths(cuda, name, dtype, d, shift):
    """Every plan of the one-pass kernel (16 rows a tile down to 2, 2-4
    stages, 1-16 row phases, 1-8 column vectors a thread) at a ragged n,
    with the margin shift of a standardization or only its scaling."""
    loss = getattr(losses, name)()
    batch, w, norm = _case(1001, d, name in ("LogisticLoss", "SmoothedHingeLoss"), dtype, cuda,
                           seed=d)
    if not shift:
        norm = NormalizationContext(norm.factors, None)
    assert fused_glm.tile_plan(d, dtype).rows > 0
    _hold(loss, w, batch, norm)


@pytest.mark.parametrize("d", [1, 3, 15, 16, 17, 123, 512, 1536, 1537, 2048, 3072, 4099, 8191,
                               8192, 8193, 10**5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_tile_plan(cuda, d, dtype):
    """The plan the library chooses: the most rows (a power of two up to 16)
    whose two stages (plus a work tile for bf16 rows of odd d, staged raw)
    fit in 96 KB, 2-4 stages, more than two only while they keep at most
    48 KB in flight, at most 200 KB of shared memory, the most row phases
    (up to the rows) that give every 16-byte column vector a thread, and at
    most 32 gradient registers a thread; one pass to d = 8192, the
    two-pass form (rows 0) above."""
    plan = fused_glm.tile_plan(d, dtype)
    if d > 8192:
        assert plan == (0, 0, 0, 0, 0)
        return
    itemsize = 2 if dtype == torch.bfloat16 else 4
    padded = -(-d // 16) * 16
    raw = d * itemsize % 4 != 0
    # a slot: the rows at the pitch and 32 bytes of slack for a raw span
    stage = lambda rows: rows * (padded + 8) * itemsize + 32  # noqa: E731
    assert plan.rows in (1, 2, 4, 8, 16) and 2 <= plan.stages <= 4
    if plan.stages > 2:
        assert plan.stages * stage(plan.rows) <= 48 * 1024
    tiles = plan.stages + raw
    assert plan.smem_bytes == 4 * padded + 2 * 16 * 4 + tiles * stage(plan.rows) <= 200 * 1024
    if plan.rows > 1:
        assert (2 + raw) * stage(plan.rows) <= tiles * stage(plan.rows) <= 96 * 1024
    if plan.rows < 16:  # twice the rows would not fit
        assert (2 + raw) * stage(2 * plan.rows) > 96 * 1024
    nvec = padded * itemsize // 16
    per_phase = 256 // plan.phases
    assert plan.phases in (1, 2, 4, 8, 16) and plan.phases <= plan.rows
    assert plan.vectors * per_phase >= nvec > (plan.vectors - 1) * per_phase
    assert plan.vectors * (16 // itemsize) <= 32
    if plan.phases < plan.rows:  # twice the phases would leave a vector without a thread
        assert per_phase // 2 < nvec


def test_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(8, 4, device=cuda)
    v = torch.zeros(8, device=cuda)
    w = torch.zeros(4, device=cuda)
    loss = losses.LogisticLoss()
    with pytest.raises(ValueError):
        fused_glm.fused_partials(loss, x.t().contiguous().t(), v, v, v, w)  # not contiguous
    with pytest.raises(ValueError):
        fused_glm.fused_partials(loss, x.double(), v, v, v, w)
    with pytest.raises(ValueError):
        fused_glm.fused_partials(loss, x, v.double(), v, v, w)
    with pytest.raises(ValueError):
        fused_glm.fused_partials(loss, x, v, v, v, torch.zeros(5, device=cuda))


def _graph_replay_equals_eager(fn):
    """fn captured in a CUDA graph (after a warm-up on a side stream): two
    replays give bitwise the eager call's tensors."""
    eager = fn()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(2):
        for t in out:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, eager))


@pytest.mark.parametrize("d", [17, 512, 2048, 4099, 8200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ordered_reduce_matches_the_order_model(cuda, dtype, d):
    """The reduction kernel: value, gradient and Σr bitwise equal to the
    plain f32 model of its order (``reduce_partials_in_order``, elementwise
    f32 adds on the card) over the partials kernel's partials; an
    evaluation (both kernels) captures into a CUDA graph and replays
    bitwise; and two evaluations on two streams at once give the same sums
    (no state is kept between calls). d=8200 is the two-pass form."""
    n = 20_011
    batch, w, _ = _case(n, d, True, dtype, cuda, seed=d)
    loss = losses.LogisticLoss()
    args = (loss, batch.features, batch.labels, batch.offsets, batch.weights, w)
    before = (fused_glm.launches, fused_glm.reduce_launches)
    parts = fused_glm.fused_partials(*args)
    got = fused_glm.reduce_partials(*parts)
    torch.cuda.synchronize()
    assert (fused_glm.launches, fused_glm.reduce_launches) == (before[0] + 1, before[1] + 1)
    assert parts[2].shape[0] > 32 or n // 16 < 64  # many blocks: every stride of the order
    want = fused_glm.reduce_partials_in_order(*parts)
    for a, b in zip(got, want):
        assert torch.equal(a, b), (float((a - b).abs().max()))

    def evaluate():
        return fused_glm.reduce_partials(*fused_glm.fused_partials(*args))

    got = evaluate()
    _graph_replay_equals_eager(evaluate)
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            outs.append(evaluate())
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    for out in outs:
        assert all(torch.equal(a, b) for a, b in zip(out, got))
