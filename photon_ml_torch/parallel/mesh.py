"""The ("data", "model") mesh and the explicit collectives of the port.

Counterpart of ``photon_ml_tpu/parallel/mesh.py``. There a mesh places
global arrays and XLA inserts the collectives; here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over one process per rank, every
rank holds the block of rows (and of entity lanes) that it owns, and each
collective the JAX program gets implicitly is one call below, in a fixed
order on every rank. ``shard_map`` has no counterpart: a rank's code already
is the per-device body.

Padding contract (the JAX package's): rows appended to make the sample axis
divide the data axis carry weight 0, entity index -1 and zero features, so
they contribute nothing.

Only the data axis is ported: ``model > 1`` raises naming ROADMAP.md item
15. The counts in :data:`counts` (calls and bytes per collective) are what
``chip_smoke.py`` reports per sweep.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from photon_ml_torch.data.batch import LabeledPointBatch


@dataclasses.dataclass
class CollectiveCounts:
    """Calls and payload bytes of each collective, since the last reset."""

    calls: dict = dataclasses.field(default_factory=dict)
    bytes: dict = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()

    def record(self, op: str, nbytes: int) -> None:
        self.calls[op] = self.calls.get(op, 0) + 1
        self.bytes[op] = self.bytes.get(op, 0) + int(nbytes)

    def snapshot(self) -> dict:
        return {op: {"calls": self.calls[op], "bytes": self.bytes[op]} for op in sorted(self.calls)}


#: the collectives issued by this process (payload bytes of this rank's input)
counts = CollectiveCounts()


def make_mesh(data: int | None = None, model: int = 1):
    """A ("data", "model") DeviceMesh over the initialized group's ranks
    (``multihost.initialize``); all ranks on "data" by default."""
    from torch.distributed.device_mesh import init_device_mesh

    from photon_ml_torch.parallel.multihost import ITEM_15, process_info

    if model != 1:
        raise NotImplementedError(
            f"a mesh with model={model} (the model axis: feature-sharded fixed effects, "
            f"parallel/column_sharded.py) is not ported yet: ROADMAP.md item {ITEM_15}")
    info = process_info()
    if data is None:
        data = info.world_size // model
    if data * model != info.world_size:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, the group has "
                         f"{info.world_size}")
    return init_device_mesh(info.device.type, (data, model), mesh_dim_names=("data", "model"))


def check_data_mesh(mesh) -> None:
    """Refuse a mesh the port cannot run: dims other than ("data",
    "model"), or a model axis wider than 1 (ROADMAP.md item 15)."""
    from photon_ml_torch.parallel.multihost import ITEM_15

    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if names != ("data", "model"):
        raise ValueError(f"a mesh is a DeviceMesh with dims ('data', 'model') "
                         f"(parallel/mesh.make_mesh), got {mesh!r}")
    if mesh.size(1) != 1:
        raise NotImplementedError(
            f"a mesh with model={mesh.size(1)} (the model axis) is not ported yet: "
            f"ROADMAP.md item {ITEM_15}")


def data_rank(mesh) -> int:
    return mesh.get_local_rank("data")


def data_size(mesh) -> int:
    return mesh.size(0)


def _group(mesh):
    return mesh.get_group("data")


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise sum of ``t`` over the data axis (a new tensor; every
    rank receives the same bits)."""
    out = t.contiguous().clone()
    counts.record("all_reduce", out.numel() * out.element_size())
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=_group(mesh))
    return out


def all_gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's equal-shaped ``t`` concatenated along axis 0, in rank
    order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(data_size(mesh))]
    counts.record("all_gather", t.numel() * t.element_size())
    dist.all_gather(parts, t, group=_group(mesh))
    return torch.cat(parts)


def broadcast(t: torch.Tensor, mesh, src: int = 0) -> torch.Tensor:
    """Data rank ``src``'s ``t`` on every rank (a new tensor)."""
    out = t.contiguous().clone()
    counts.record("broadcast", out.numel() * out.element_size())
    group = _group(mesh)
    dist.broadcast(out, src=dist.get_global_rank(group, src), group=group)
    return out


def row_block(n: int, mesh) -> slice:
    """This rank's rows of an ``n``-row axis that divides the data axis."""
    size = data_size(mesh)
    if n % size:
        raise ValueError(f"{n} rows do not divide the data axis of {size}; pad first")
    per = n // size
    r = data_rank(mesh)
    return slice(r * per, (r + 1) * per)


def default_put(device):
    """The ``put_fn`` of a rank: (tensor, rows) -> the rows' block on the
    rank's device, contiguous."""
    def put(t: torch.Tensor, rows: slice) -> torch.Tensor:
        return t[rows].to(device).contiguous()

    return put


def replicate(tree, mesh):
    """Data rank 0's tensors on every rank (the reference's broadcast):
    every tensor leaf of a dict/list/tuple tree is broadcast."""
    if isinstance(tree, torch.Tensor):
        return broadcast(tree, mesh)
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    return tree


def shard_batch(batch: LabeledPointBatch, mesh, *,
                feature_sharded: bool = False) -> LabeledPointBatch:
    """This rank's rows of ``batch``, padded first with zero-weight rows to
    a multiple of the data axis."""
    if feature_sharded:
        from photon_ml_torch.parallel.multihost import ITEM_15

        raise NotImplementedError("shard_batch(feature_sharded=True) (the model axis) is not "
                                  f"ported yet: ROADMAP.md item {ITEM_15}")
    check_data_mesh(mesh)
    n = batch.num_samples
    batch = batch.pad_to(n + (-n) % data_size(mesh))
    rows = row_block(batch.num_samples, mesh)
    return LabeledPointBatch(features=batch.features[rows].contiguous(),
                             labels=batch.labels[rows], offsets=batch.offsets[rows],
                             weights=batch.weights[rows])


def shard_game_dataset(dataset, mesh):
    """This rank's rows of a GameDataset whose sample count divides the data
    axis (pad with ``data.game_data.pad_game_dataset`` first); entity
    vocabularies stay whole."""
    from photon_ml_torch.data.game_data import game_dataset_rows

    check_data_mesh(mesh)
    n = dataset.num_samples
    if n % data_size(mesh):
        raise ValueError(f"sample count {n} not divisible by data-axis size "
                         f"{data_size(mesh)}; pad with zero-weight rows first")
    return game_dataset_rows(dataset, row_block(n, mesh))
