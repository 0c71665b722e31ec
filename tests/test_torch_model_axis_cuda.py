"""The column-sharded GLM's kernels on the card, over a one-rank NCCL mesh.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed. Every test needs an NVIDIA GPU and skips without one; on the
card run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_model_axis_cuda.py

A column block on the card launches G1 (the partial margins and the
own-column transpose) or raises: its value, gradient and Hv in f32 agree
with the same block on the CPU in f64, two evaluations are bitwise equal,
and a float64 block, which has no kernel, raises instead of taking the
plain version.
"""

import numpy as np
import pytest
import torch

from photon_ml_torch.data.sparse_batch import SparseShard
from photon_ml_torch.ops import sparse_gather
from photon_ml_torch.ops.losses import LogisticLoss
from photon_ml_torch.parallel import column_sharded as cs
from photon_ml_torch.parallel import mesh as mesh_ops
from photon_ml_torch.parallel import multihost

pytestmark = pytest.mark.cuda


@pytest.fixture
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    info = multihost.initialize()
    assert info.backend == "nccl" and info.device.type == "cuda"
    try:
        yield mesh_ops.make_mesh(data=1, model=1)
    finally:
        multihost.shutdown()


def _problem(seed=0, n=3001, d=5003, per_row=12):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = rng.integers(0, d, size=n * per_row)
    cols[::7] = 3  # one long column: the transpose's chunk kernel
    vals = rng.normal(size=n * per_row).astype(np.float32)
    shard = SparseShard(rows=rows, cols=cols, vals=vals, num_samples=n, feature_dim=d)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return shard, y, rng.normal(scale=0.1, size=d), rng.normal(size=d)


def _block(shard, y, mesh, device):
    return cs.shard_column_batch(cs.build_column_sharded_batch(
        shard, y, 1, only_block=0, device=device), mesh, put_fn=lambda t: t.to(device))


def _f64(shard):
    return SparseShard(rows=shard.rows, cols=shard.cols, vals=shard.vals.astype(np.float64),
                       num_samples=shard.num_samples, feature_dim=shard.feature_dim)


def test_column_block_launches_g1_and_matches_the_cpu(mesh):
    shard, y, w, v = _problem()
    obj = cs.ColumnShardedGLMObjective(LogisticLoss(), mesh, l2_weight=0.5)
    card = _block(shard, y, mesh, torch.device("cuda"))
    host = _block(_f64(shard), y, mesh, torch.device("cpu"))
    wc, vc = torch.tensor(w, dtype=torch.float32, device="cuda"), \
        torch.tensor(v, dtype=torch.float32, device="cuda")
    sparse_gather.launches = sparse_gather.segment_launches = sparse_gather.chunk_launches = 0
    value, grad = obj.value_and_gradient(wc, card)
    again = obj.value_and_gradient(wc, card)
    hv = obj.hessian_vector(wc, vc, card)
    torch.cuda.synchronize()
    assert sparse_gather.launches + sparse_gather.segment_launches >= 6
    assert sparse_gather.chunk_launches >= 3
    assert torch.equal(value, again[0]) and torch.equal(grad, again[1])
    rv, rg = obj.value_and_gradient(torch.tensor(w), host)
    rhv = obj.hessian_vector(torch.tensor(w), torch.tensor(v), host)
    assert float(value) == pytest.approx(float(rv), rel=1e-5)
    for got, ref in ((grad, rg), (hv, rhv)):
        ref = ref.numpy()
        np.testing.assert_allclose(got.double().cpu().numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


def test_a_float64_block_on_the_card_raises(mesh):
    shard, y, w, _ = _problem()
    obj = cs.ColumnShardedGLMObjective(LogisticLoss(), mesh, l2_weight=0.5)
    card = _block(_f64(shard), y, mesh, torch.device("cuda"))
    with pytest.raises(ValueError, match="float32"):
        obj.value_and_gradient(torch.tensor(w, device="cuda"), card)
