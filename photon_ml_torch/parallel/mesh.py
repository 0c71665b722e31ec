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

Rank r of a ``data x model`` mesh sits at ``(r // model, r % model)``: the
model index varies fastest, as in the JAX grid's ``reshape(data, model)``.
The ranks of one data row hold the same sample rows and split a
feature-sharded fixed effect's columns (``parallel/column_sharded.py``);
the ranks of one model column hold the same coefficient block. Every
collective below takes ``axis="data"`` (the default) or ``axis="model"``
and runs over this rank's group along that axis. The counts in
:data:`counts` (calls and bytes per collective and axis) are what
``chip_smoke.py`` reports per sweep.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from photon_ml_torch.data.batch import LabeledPointBatch


@dataclasses.dataclass
class CollectiveCounts:
    """Calls and payload bytes of each collective, since the last reset, one
    tally per axis: a data-axis op is keyed by its name (``"all_reduce"``),
    a model-axis op by ``"model/<name>"``."""

    calls: dict = dataclasses.field(default_factory=dict)
    bytes: dict = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()

    def record(self, op: str, nbytes: int, axis: str = "data") -> None:
        key = op if axis == "data" else f"{axis}/{op}"
        self.calls[key] = self.calls.get(key, 0) + 1
        self.bytes[key] = self.bytes.get(key, 0) + int(nbytes)

    def snapshot(self) -> dict:
        return {op: {"calls": self.calls[op], "bytes": self.bytes[op]} for op in sorted(self.calls)}

    def by_axis(self) -> dict:
        """``{axis: {op: {"calls", "bytes"}}}`` of :meth:`snapshot`."""
        out: dict = {}
        for key, v in self.snapshot().items():
            axis, _, op = key.rpartition("/")
            out.setdefault(axis or "data", {})[op] = v
        return out


#: the collectives issued by this process (payload bytes of this rank's input)
counts = CollectiveCounts()


def make_mesh(data: int | None = None, model: int = 1):
    """A ("data", "model") DeviceMesh over the initialized group's ranks
    (``multihost.initialize``); all ranks on "data" by default. Rank r sits
    at ``(r // model, r % model)``."""
    from torch.distributed.device_mesh import init_device_mesh

    from photon_ml_torch.parallel.multihost import process_info

    info = process_info()
    if model < 1:
        raise ValueError(f"the model axis must be at least 1, got {model}")
    if data is None:
        data = info.world_size // model
    if data * model != info.world_size:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, the group has "
                         f"{info.world_size}")
    return init_device_mesh(info.device.type, (data, model), mesh_dim_names=("data", "model"))


def check_data_mesh(mesh) -> None:
    """Refuse anything but a DeviceMesh with dims ("data", "model")."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if names != ("data", "model"):
        raise ValueError(f"a mesh is a DeviceMesh with dims ('data', 'model') "
                         f"(parallel/mesh.make_mesh), got {mesh!r}")


def data_rank(mesh) -> int:
    return mesh.get_local_rank("data")


def data_size(mesh) -> int:
    return mesh.size(0)


def model_rank(mesh) -> int:
    return mesh.get_local_rank("model")


def model_size(mesh) -> int:
    return mesh.size(1)


def _group(mesh, axis: str = "data"):
    if axis not in ("data", "model"):
        raise ValueError(f"axis must be 'data' or 'model', got {axis!r}")
    return mesh.get_group(axis)


def all_reduce_sum(t: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The elementwise sum of ``t`` over the mesh axis ``axis`` (a new
    tensor; every rank of the axis group receives the same bits)."""
    out = t.contiguous().clone()
    counts.record("all_reduce", out.numel() * out.element_size(), axis)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=_group(mesh, axis))
    return out


def all_gather_rows(t: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """Every rank's equal-shaped ``t`` along ``axis`` concatenated along
    dimension 0, in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size(0 if axis == "data" else 1))]
    counts.record("all_gather", t.numel() * t.element_size(), axis)
    dist.all_gather(parts, t, group=_group(mesh, axis))
    return torch.cat(parts)


def broadcast(t: torch.Tensor, mesh, src: int = 0, axis: str = "data") -> torch.Tensor:
    """Rank ``src``'s ``t`` along ``axis`` on every rank of the axis group
    (a new tensor)."""
    out = t.contiguous().clone()
    counts.record("broadcast", out.numel() * out.element_size(), axis)
    group = _group(mesh, axis)
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
    a multiple of the data axis; with ``feature_sharded`` its ``[n/D, d/M]``
    block, the feature axis padded with zero columns to a multiple of the
    model axis (the JAX package's ``P("data", "model")``)."""
    check_data_mesh(mesh)
    n = batch.num_samples
    batch = batch.pad_to(n + (-n) % data_size(mesh))
    rows = row_block(batch.num_samples, mesh)
    features = batch.features[rows]
    if feature_sharded:
        from photon_ml_torch.parallel.column_sharded import fe_columns_of, feature_block

        features = feature_block(features, fe_columns_of(int(features.shape[1]), mesh))
    return LabeledPointBatch(features=features.contiguous(),
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
