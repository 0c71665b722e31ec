"""Partitioned training with two ranks on the card.

Imports only torch, numpy and the port (the fixture writer included), so it
also runs where JAX is not installed. Every test needs an NVIDIA GPU and
skips without one; on the card run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_partitioned_cuda.py

Two spawned ranks share card 0 over gloo with CUDA tensors (NCCL refuses two
ranks on one device). The input's users span both ranks and sit in buckets
of different capacities, so the solved table rows of several lanes land on
one row: the last lane in bucket order, then rank order, must win on every
run and every rank, bitwise (a CUDA ``index_copy`` of repeated rows would
land in an unspecified order). The f32 card state must stay within
1e-3·max|w| of the same partitioned run in f64 on CPU ranks.
"""

import numpy as np
import pytest
import torch

try:
    from tests import torch_mesh_worker as W
    from tests import torch_partitioned_parity as PP
except ImportError:  # run with --noconftest where another "tests" package is importable
    import torch_mesh_worker as W
    import torch_partitioned_parity as PP

pytestmark = pytest.mark.cuda


def _flat(state: dict) -> dict:
    out = {"fe": state["fe_coefficients"]}
    out.update({f"re/{k}": v for k, v in state["re_tables"].items()})
    return out


def test_spanning_entities_repeat_bitwise_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = PP.write_input(tmp_path / "in", num_files=4, rows_per_file=400, clustered=False,
                          uneven=True, users_per_file=24, task="LOGISTIC_REGRESSION")
    task = dict(kind="partitioned_train", path=path, configs=PP.CONFIGS["dense"],
                re_columns=["userId"], program=PP.program("LOGISTIC_REGRESSION"), sweeps=3)
    (tmp_path / "card").mkdir()
    (tmp_path / "cpu").mkdir()
    card = W.spawn_ranks(2, [dict(task, dtype="float32")] * 2, tmp_path / "card",
                         device="cuda")
    cpu = W.spawn_ranks(2, [dict(task, dtype="float64")], tmp_path / "cpu")[0]
    assert card[0][0]["read"]["presence"]["userId"].max() == 2
    ref = _flat(card[0][0]["state"])
    for run in card:
        for r in run:
            got = _flat(r["state"])
            assert all(np.array_equal(got[k], ref[k]) for k in ref), "not bitwise"
    f64 = _flat(cpu[0]["state"])
    for k, v in f64.items():
        scale = float(np.abs(v).max())
        assert float(np.abs(ref[k].astype(np.float64) - v).max()) <= 1e-3 * scale, k
