"""Mesh-sharded scoring of a trained GameModel.

Counterpart of ``photon_ml_tpu/parallel/scoring.py`` (``DistributedScorer``);
reference photon-api transformers/GameTransformer.scala:156-203 (scoring on
the executors). Over a data-axis mesh each rank scores its block of the
(padded) rows with the sub-models' own scoring (so a rank's scores are the
one-device scores of those rows: the fused kernels where the one-device path
runs them), and the blocks meet in one ``all_gather``; the device
evaluators (``evaluation/sharded.py``) reduce the gathered vector on the
device. Every rank holds the whole model: the JAX package keeps entity
tables entity-sharded and rotates them around the ring, which the port's
data axis does not need.

``score_partitioned`` scores a partitioned read's blocks (partitioned I/O):
each rank its own block, with no gather.

``fe_feature_sharded`` (True, or a fixed-effect coordinate id) lays that
coordinate's feature axis over the mesh's "model" axis, padded with zero
columns to a multiple of it (the training estimator's ``fe_pad``): each
rank keeps a dense ``[n/D, d/M]`` block or a sparse column block of its
rows, scores it against its ``d/M`` coefficients, and the partial scores
are all-reduced over "model" (``parallel/column_sharded.block_scores``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_ml_torch.data.game_data import GameDataset, game_dataset_rows, pad_game_dataset
from photon_ml_torch.data.sparse_batch import SparseShard
from photon_ml_torch.models.game import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
    compact_entry_positions,
    score_layout,
)
from photon_ml_torch.models.matrix_factorization import MatrixFactorizationModel
from photon_ml_torch.ops import sparse_gather
from photon_ml_torch.parallel import mesh as mesh_ops
from photon_ml_torch.telemetry.program_ledger import ledger_call

#: the floor of a flat entry axis's power-of-two length in the resident
#: program: tiny requests share one signature instead of one each
MIN_NNZ_BUCKET = 64


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def nnz_bucket(nnz: int, data_axis: int = 1) -> int:
    """The padded length of a flat entry axis of ``nnz`` entries: a power of
    two, at least MIN_NNZ_BUCKET and the mesh's data axis."""
    return max(next_pow2(max(int(nnz), 1)), MIN_NNZ_BUCKET, int(data_axis))


def _pad_nnz(arrays: dict, target: int, pad_values: dict | None = None) -> dict:
    """Host (numpy) flat entry arrays padded to exactly ``target`` entries.
    The pads are inert: values 0, ``rows`` its last id repeated (the
    row-sorted order holds; an empty block takes ``pad_values["rows"]``,
    else 0) and ``pad_values`` for the other keys, else 0 (a compact axis's
    slots pad with the scratch slot)."""
    nnz = int(arrays["vals"].shape[0])
    pad = target - nnz
    if pad < 0:
        raise ValueError(f"flat block has {nnz} entries but the agreed length is {target}")
    if not pad:
        return arrays
    pad_values = pad_values or {}
    last_row = arrays["rows"][-1:] if nnz \
        else np.full(1, pad_values.get("rows", 0), arrays["rows"].dtype)
    out = {}
    for k, v in arrays.items():
        if k == "rows":
            out[k] = np.concatenate([v, np.broadcast_to(last_row, (pad,))])
        else:
            out[k] = np.pad(v, (0, pad), constant_values=pad_values.get(k, 0))
    return out


def params_layout_fingerprint(model: GameModel) -> dict:
    """Per coordinate: its kind, shard or effect types, and every parameter
    tensor's (shape, dtype). Two models with equal fingerprints swap into a
    scorer without a new layout."""
    fp: dict = {"coordinates": ",".join(model.models)}

    def leaf(arr) -> str:
        shape = tuple(int(s) for s in arr.shape)
        dtype = str(arr.dtype).replace("torch.", "")
        return f"{shape}:{dtype}"

    for cid, m in model.models.items():
        if isinstance(m, FixedEffectModel):
            fp[f"{cid}/kind"] = "fe"
            fp[f"{cid}/shard"] = m.feature_shard_id
            fp[f"{cid}/w"] = leaf(m.glm.coefficients.means)
        elif isinstance(m, RandomEffectModel):
            fp[f"{cid}/kind"] = "re_compact" if m.is_compact else "re"
            fp[f"{cid}/shard"] = m.feature_shard_id
            fp[f"{cid}/re_type"] = m.random_effect_type
            fp[f"{cid}/table"] = leaf(m.coefficients)
            if m.is_compact:
                fp[f"{cid}/active_cols"] = leaf(np.asarray(m.active_cols))
        elif isinstance(m, MatrixFactorizationModel):
            fp[f"{cid}/kind"] = "mf"
            fp[f"{cid}/re_type"] = f"{m.row_effect_type}x{m.col_effect_type}"
            fp[f"{cid}/rows"] = leaf(m.row_factors)
            fp[f"{cid}/cols"] = leaf(m.col_factors)
        else:
            fp[f"{cid}/kind"] = type(m).__name__
    return fp


def _fingerprint_mismatch(new: dict, old: dict) -> str | None:
    keys = sorted(set(new) | set(old))
    diff = [k for k in keys if new.get(k) != old.get(k)]
    if not diff:
        return None
    return "differs in " + ", ".join(f"{k} ({old.get(k)} -> {new.get(k)})" for k in diff)


def _model_kinds(model: GameModel) -> dict[str, str]:
    kinds: dict[str, str] = {}
    for cid, m in model.models.items():
        if isinstance(m, FixedEffectModel):
            kinds[cid] = "fe"
        elif isinstance(m, RandomEffectModel):
            kinds[cid] = "re_compact" if m.is_compact else "re"
        elif isinstance(m, MatrixFactorizationModel):
            kinds[cid] = "mf"
        else:
            raise TypeError(f"coordinate '{cid}': cannot build a distributed scoring "
                            f"program for sub-model type {type(m).__name__}")
    return kinds


class DistributedScorer:
    """Scores a GameModel over a ("data", "model") mesh (or on one device
    with ``mesh=None``).

    fe_feature_sharded: shard the named FE coordinate's feature axis (and
    its coefficient vector) over the mesh's "model" axis: True picks the
    single FE coordinate (an error if there are several), or pass the
    coordinate id."""

    def __init__(self, model: GameModel, mesh=None, *, fe_feature_sharded: "bool | str" = False):
        if mesh is not None:
            mesh_ops.check_data_mesh(mesh)
        self.model = model
        self.mesh = mesh
        # the batch scoring program's label (telemetry/program_ledger.py):
        # data and parameters both enter as arguments
        self._score_prepared = ledger_call(self._score_program, label="score/score_dataset")
        self._kinds = _model_kinds(model)
        fe_cids = [c for c, k in self._kinds.items() if k == "fe"]
        if fe_feature_sharded is True:
            if len(fe_cids) != 1:
                raise ValueError(
                    "fe_feature_sharded=True needs exactly one fixed-effect coordinate to "
                    f"pick; model has {fe_cids}. Pass the coordinate id instead.")
            self.fe_sharded_cid: str | None = fe_cids[0]
        elif fe_feature_sharded:
            if self._kinds.get(fe_feature_sharded) != "fe":
                raise ValueError(f"fe_feature_sharded={fe_feature_sharded!r} is not a "
                                 f"fixed-effect coordinate of the model ({fe_cids})")
            self.fe_sharded_cid = str(fe_feature_sharded)
        else:
            self.fe_sharded_cid = None
        if self.fe_sharded_cid is not None and mesh is None:
            raise ValueError("fe_feature_sharded requires a mesh")
        #: layout signature -> the sub-models that score it
        self._params_cache: dict = {}
        #: (layout signature, bf16) -> the resident program's parameter
        #: tensors, at addresses that stay fixed: a captured CUDA graph reads
        #: them, so a swap copies into them (:meth:`swap_model_params`)
        self._resident: dict = {}

    # -- data and params -----------------------------------------------------

    def prepare(self, dataset: GameDataset):
        """(data, params, n_true): over a mesh the rows padded to a multiple
        of the data axis and this rank's block kept; params are the
        sub-models for the dataset's layout."""
        from photon_ml_torch.parallel.distributed import MeshLayout

        n_true = dataset.num_samples
        layout = None
        if self.mesh is not None:
            dataset, n_true = pad_game_dataset(dataset, mesh_ops.data_size(self.mesh))
            rows = mesh_ops.row_block(dataset.num_samples, self.mesh)
            layout = MeshLayout(mesh=self.mesh, rows=rows, num_rows=dataset.num_samples)
            dataset = game_dataset_rows(dataset, rows)
        data = {"dataset": dataset, "mesh": layout}
        self._attach_feature_block(data)
        return data, self.params_for_layouts(self._layouts(dataset)), n_true

    def _sharded(self) -> bool:
        """Whether a coordinate scores over the model axis (a model axis of
        1 holds one column block: the plain path)."""
        return self.fe_sharded_cid is not None and mesh_ops.model_size(self.mesh) > 1

    def _attach_feature_block(self, data: dict) -> None:
        """The sharded coordinate's column block of the rank's rows and its
        ``d/M`` coefficients (``data["fe_block"]``)."""
        if not self._sharded():
            return
        from photon_ml_torch.parallel.column_sharded import (
            build_column_sharded_batch,
            feature_block,
            fe_columns_of,
            split_fe,
        )

        m = self.model.models[self.fe_sharded_cid]
        dataset = data["dataset"]
        means = m.glm.coefficients.means
        columns = fe_columns_of(int(means.shape[0]), self.mesh)
        feats = dataset.shard_features(m.feature_shard_id)
        if isinstance(feats, SparseShard):
            zeros = np.zeros(dataset.num_samples)
            block = build_column_sharded_batch(
                feats, zeros, mesh_ops.model_size(self.mesh), offsets=zeros, weights=zeros,
                hybrid=False, only_block=mesh_ops.model_rank(self.mesh), device=means.device)
        else:
            block = feature_block(feats, columns)
        data["fe_block"] = (self.fe_sharded_cid, block, split_fe(means, columns))

    def _layouts(self, dataset: GameDataset) -> dict[str, str]:
        """Each coordinate's layout over this dataset: "dense"/"sparse" FE,
        "re", "entries"/"compact_dense" compact RE, "mf"."""
        layouts: dict[str, str] = {}
        for cid, m in self.model.models.items():
            kind = self._kinds[cid]
            if kind in ("fe", "re_compact"):
                sparse = isinstance(dataset.feature_shards[m.feature_shard_id], SparseShard)
                layouts[cid] = {("fe", True): "sparse", ("fe", False): "dense",
                                ("re_compact", True): "entries",
                                ("re_compact", False): "compact_dense"}[(kind, sparse)]
            else:
                layouts[cid] = kind
        return layouts

    def params_for_layouts(self, layouts: dict) -> dict:
        """The scoring parameters for one layout signature, built once: each
        coordinate's sub-model (its tensors already on its device)."""
        key = tuple(sorted(layouts.items()))
        cache = self._params_cache
        if key not in cache:
            cache[key] = {cid: self.model.models[cid] for cid in layouts}
        return cache[key]

    def swap_model_params(self, new_model: GameModel) -> None:
        """Refresh the model in place. A model whose parameter layout differs
        (:func:`params_layout_fingerprint`) raises ``ValueError`` naming the
        fields, before anything changes. Otherwise the new resident values
        are built off to the side, then committed: the sub-model references,
        and a ``copy_`` into every resident parameter tensor, whose address a
        captured graph keeps (a rebound reference would leave the graph
        scoring the old model). The caller keeps scoring out of the commit
        (``serving/resident.py`` holds its lock around both)."""
        mismatch = _fingerprint_mismatch(params_layout_fingerprint(new_model),
                                         params_layout_fingerprint(self.model))
        if mismatch is not None:
            raise ValueError(f"the new model's params layout {mismatch}; a layout-changing "
                             "refresh must build a fresh scorer instead of hot-swapping")
        rebuilt = {key: {cid: new_model.models[cid] for cid in new_model.models
                         if cid in dict(key)} for key in self._params_cache}
        staged = {key: self._resident_values(new_model, dict(key[0]), key[1])
                  for key in self._resident}
        self.model = new_model
        self._params_cache = rebuilt
        cuda = set()
        for key, values in staged.items():
            live = self._resident[key]
            for cid, tensors in values.items():
                for name, t in tensors.items():
                    live[cid][name].copy_(t)
                    if t.is_cuda:
                        cuda.add(t.device)
        for dev in cuda:
            torch.cuda.synchronize(dev)
        from photon_ml_torch.telemetry import serving_counters

        serving_counters.set_resident_params_bytes(self.resident_params_bytes())

    # -- the resident program: fixed-shape inputs, no host sync ---------------

    def resident_params(self, layouts: dict, *, bf16: bool = False) -> dict:
        """The resident program's parameters for one layout signature, placed
        once (copies of the model's tensors, which a swap overwrites in
        place): an FE's ``w``; a random effect's ``table``; a compact one's
        ``table`` and long ``active_cols`` on a dense shard, or on a sparse
        shard its ``table_ext`` ``[E, K+1]`` with the zero scratch column. With
        ``bf16`` the products' operands are bf16, and the gather kernel's
        (a sparse FE's ``w``, ``table_ext``) are rounded to bf16 and kept in
        their own dtype, since the kernel reads an f32 ``w``."""
        key = (tuple(sorted(layouts.items())), bool(bf16))
        params = self._resident.get(key)
        if params is None:
            params = self._resident[key] = self._resident_values(self.model, layouts, bf16)
        from photon_ml_torch.telemetry import serving_counters

        serving_counters.set_resident_params_bytes(self.resident_params_bytes())
        return params

    def resident_params_bytes(self) -> int:
        """Device bytes of every resident parameter set."""
        return sum(t.numel() * t.element_size() for params in self._resident.values()
                   for tensors in params.values() for t in tensors.values())

    def _resident_values(self, model: GameModel, layouts: dict, bf16: bool) -> dict:
        """Fresh resident parameter tensors of ``model`` (see
        :meth:`resident_params`)."""

        def cast(t):
            return t.to(torch.bfloat16) if bf16 else t.clone()

        def rounded(t):
            return t.to(torch.bfloat16).to(t.dtype) if bf16 else t.clone()

        out = {}
        for cid in layouts:
            m, layout = model.models[cid], layouts[cid]
            if layout == "dense":
                out[cid] = {"w": cast(m.glm.coefficients.means)}
            elif layout == "sparse":
                out[cid] = {"w": rounded(m.glm.coefficients.means).contiguous()}
            elif layout == "re":
                out[cid] = {"table": cast(m.coefficients)}
            elif layout == "compact_dense":
                out[cid] = {"table": cast(m.coefficients),
                            "active_cols": torch.as_tensor(np.asarray(m.active_cols),
                                                           dtype=torch.long,
                                                           device=m.coefficients.device)}
            elif layout == "entries":
                t = rounded(m.coefficients)
                out[cid] = {"table_ext": torch.cat([t, t.new_zeros((t.shape[0], 1))],
                                                   dim=1).contiguous()}
            else:  # mf
                out[cid] = {"rows": cast(m.row_factors), "cols": cast(m.col_factors)}
        return out

    def resident_inputs(self, dataset: GameDataset, bucket: int, *, bf16: bool = False):
        """The resident program's inputs for ``dataset`` padded to ``bucket``
        rows, built on the host: (inputs, layouts, entry signature).

        ``inputs`` maps a name to (numpy array, torch dtype): ``offsets``;
        per coordinate its dense rows ``x`` (the padding contract of
        ``pad_game_dataset_to``: zero rows, offsets 0, entity index -1),
        ``idx``/``row_idx``/``col_idx``, and for a flat entry axis (a sparse
        FE's coalesced triple, or a compact effect's entries on a sparse
        shard, whose columns are the flat slots ent·(K+1)+pos) ``rows``,
        ``cols``, ``vals`` padded by :func:`_pad_nnz` to :func:`nnz_bucket`
        (values 0, the last row repeated, the scratch slot), ``row_ptr`` and,
        where a row holds more than ``SEGMENT_CHUNK`` entries, the chunk
        plan's ``chunk_rows``/``chunk_ptr``. Every plan is built here with
        numpy, so nothing syncs with the device. The entry signature holds,
        per entry axis, (cid, padded length, long rows, chunks): with the
        bucket and layouts it fixes every launch parameter of the program."""
        n = dataset.num_samples
        if n > bucket:
            raise ValueError(f"a {n}-row dataset does not fit a {bucket}-row bucket")
        layouts = self._layouts(dataset)

        def padded(a, fill=0):
            out = np.full((bucket,) + a.shape[1:], fill, dtype=a.dtype)
            out[:n] = a
            return out

        inputs = {"offsets": (padded(dataset.host_array("offsets")), dataset.offsets.dtype)}
        entry_sig = []

        def entry_axis(cid, arrays, dtype, pad_values=None):
            target = nnz_bucket(len(arrays["vals"]))
            arrays = _pad_nnz(arrays, target, pad_values)
            row_ptr, long_rows, chunk_ptr, count = sparse_gather.host_segment_plan(
                arrays["rows"], bucket)
            inputs.update({f"{cid}/rows": (arrays["rows"].astype(np.int32), torch.int32),
                           f"{cid}/cols": (arrays["cols"].astype(np.int32), torch.int32),
                           f"{cid}/vals": (arrays["vals"], dtype),
                           f"{cid}/row_ptr": (row_ptr, torch.int32)})
            if count:
                inputs[f"{cid}/chunk_rows"] = (long_rows, torch.int32)
                inputs[f"{cid}/chunk_ptr"] = (chunk_ptr, torch.int32)
            entry_sig.append((cid, target, 0 if long_rows is None else len(long_rows), count))

        for cid, layout in layouts.items():
            m = self.model.models[cid]
            if layout in ("dense", "re", "compact_dense"):
                shard = dataset.feature_shards[m.feature_shard_id]
                inputs[f"{cid}/x"] = (padded(dataset.host_array(f"shard/{m.feature_shard_id}")),
                                      torch.bfloat16 if bf16 else shard.dtype)
            if layout in ("re", "compact_dense"):
                inputs[f"{cid}/idx"] = (padded(dataset.host_array(
                    f"entity_idx/{m.random_effect_type}"), -1), torch.int32)
            elif layout == "sparse":
                shard = dataset.feature_shards[m.feature_shard_id]
                rows, cols, vals = (np.asarray(a) for a in shard.coalesced())
                entry_axis(cid, {"rows": rows, "cols": cols, "vals": vals},
                           torch.bfloat16 if bf16 else shard.dtype)
            elif layout == "entries":
                shard = dataset.feature_shards[m.feature_shard_id]
                e, k = (int(x) for x in m.coefficients.shape)
                if e * (k + 1) >= 2**31:
                    raise ValueError(f"compact table [{e}, {k}+1] has 2^31 slots or more; the "
                                     "gather kernel takes int32 column ids")
                ent, pos, rows, vals = compact_entry_positions(
                    shard, dataset.host_array(f"entity_idx/{m.random_effect_type}"),
                    np.asarray(m.active_cols))
                flat = ent.astype(np.int64) * (k + 1) + pos
                entry_axis(cid, {"rows": rows, "cols": flat, "vals": vals},
                           torch.bfloat16 if bf16 else shard.dtype, pad_values={"cols": k})
            elif layout == "mf":
                for name, t in (("row_idx", m.row_effect_type), ("col_idx", m.col_effect_type)):
                    inputs[f"{cid}/{name}"] = (padded(dataset.host_array(f"entity_idx/{t}"), -1),
                                               torch.int32)
        return inputs, layouts, tuple(entry_sig)

    def score_resident(self, layouts: dict, inputs: dict, params: dict, n: int,
                       chunk_counts: dict) -> torch.Tensor:
        """The resident program: ``[n]`` scores, offsets included, of the
        tensors :meth:`resident_inputs` describes (on the params' device)
        with :meth:`resident_params`: each coordinate through
        ``models/game.score_layout``, the program the sub-models'
        ``score_dataset`` runs, summed in model order, then the offsets
        (``score_dataset``'s order), so the same padded rows score bitwise
        alike. It reads no value on the host: a CUDA graph can capture it.
        ``chunk_counts`` gives each entry axis's chunk count (0: no plan)."""
        total = None
        for cid, layout in layouts.items():
            arrays = {k[len(cid) + 1:]: v for k, v in inputs.items() if k.startswith(cid + "/")}
            if layout in ("sparse", "entries"):
                count = chunk_counts.get(cid, 0)
                arrays["chunks"] = sparse_gather.ChunkPlan(
                    arrays.pop("chunk_rows"), arrays.pop("chunk_ptr"), count) if count else None
            s = score_layout(layout, params[cid], arrays, n)
            total = s if total is None else total + s
        if total is None:
            raise ValueError("GameModel has no sub-models")
        return total + inputs["offsets"]

    # -- scoring -------------------------------------------------------------

    def _score_program(self, data, params) -> torch.Tensor:
        """This rank's scores, offsets included (``self._score_prepared`` is
        this under its program label)."""
        dataset = data["dataset"]
        block = data.get("fe_block")
        total = None
        for cid, m in params.items():
            if block is not None and cid == block[0]:
                from photon_ml_torch.parallel.column_sharded import block_scores

                s = block_scores(block[2], block[1], self.mesh)
            else:
                s = m.score_dataset(dataset)
            total = s if total is None else total + s
        if total is None:
            raise ValueError("GameModel has no sub-models")
        # the one-device transform's order: the sub-models' sum, then offsets
        return total + dataset.offsets

    def _host(self, scores: torch.Tensor, data, n_true: int) -> np.ndarray:
        if data["mesh"] is not None:
            scores = data["mesh"].gather(scores)
        return scores.detach().cpu().numpy()[:n_true]

    def score_dataset(self, dataset: GameDataset) -> np.ndarray:
        """[n] host scores including offsets (GameTransformer's), every
        rank's rows gathered, mesh padding dropped."""
        data, params, n_true = self.prepare(dataset)
        return self._host(self._score_prepared(data, params), data, n_true)

    def _evaluate_scores(self, scores, dataset: GameDataset, evaluator_specs, data, n_true,
                         host_scores_fn, use_device_forms: bool = True) -> dict[str, float]:
        from photon_ml_torch.evaluation.evaluators import EvaluationData, parse_evaluator
        from photon_ml_torch.evaluation.sharded import (
            evaluate_prepared,
            prepare_device_evaluators,
        )

        evaluators = [parse_evaluator(s) if isinstance(s, str) else s for s in evaluator_specs]
        eval_data = EvaluationData(labels=dataset.host_array("labels"),
                                   offsets=dataset.host_array("offsets"),
                                   weights=dataset.host_array("weights"), ids=dataset.ids)
        layout = data["mesh"]
        if layout is not None and use_device_forms:
            device_evals = prepare_device_evaluators(evaluators, eval_data,
                                                     n_pad=layout.num_rows,
                                                     device=scores.device)
        else:
            device_evals = [None] * len(evaluators)
        values = evaluate_prepared(evaluators, device_evals, scores, eval_data, host_scores_fn,
                                   layout=layout)
        return {ev.name: v for ev, v in zip(evaluators, values)}

    def evaluate_dataset(self, dataset: GameDataset, evaluator_specs) -> dict[str, float]:
        """Score and evaluate; over a mesh the metrics reduce on the device
        and no host copy of the scores is made (validation-style runs)."""
        data, params, n_true = self.prepare(dataset)
        scores = self._score_prepared(data, params)
        return self._evaluate_scores(scores, dataset, evaluator_specs, data, n_true,
                                     lambda: self._host(scores, data, n_true))

    def score_and_evaluate(self, dataset: GameDataset, evaluator_specs=()
                           ) -> tuple[np.ndarray, dict[str, float]]:
        """(host scores, metrics) from one scoring pass: the scores are
        gathered anyway, so the metrics are the exact host evaluators'."""
        data, params, n_true = self.prepare(dataset)
        host = self._host(self._score_prepared(data, params), data, n_true)
        if not evaluator_specs:
            return host, {}
        return host, self._evaluate_scores(None, dataset, evaluator_specs, data, n_true,
                                           lambda: host, use_device_forms=False)

    # -- partitioned scoring: each rank keeps its rows ------------------------

    def score_partitioned(self, parts, partition, exchange=None) -> "dict[int, np.ndarray]":
        """Scores of a partitioned read's blocks: each rank scores its own
        block (``io/partitioned_reader.py`` layout) and gets back only its
        true rows, offsets included; no score vector of global size is built
        or gathered (``io/score_writer.ShardedScoreWriter`` then writes each
        rank's part).

        parts: ``{rank: local padded GameDataset}``, this process's rank only.
        partition: the reader's PartitionInfo. A sparse fixed-effect
        coordinate scores over entry blocks of one agreed length (one
        allgather through ``exchange``, the run's MetadataExchange, which a
        run of several ranks must pass). Compact random-effect coordinates
        on sparse shards are not supported; use score_dataset."""
        if self.mesh is None:
            raise ValueError("score_partitioned requires a mesh")
        data_axis = mesh_ops.data_size(self.mesh)
        if partition.global_rows % data_axis:
            raise ValueError(
                f"partitioned sample axis {partition.global_rows} does not "
                f"divide the mesh data axis {data_axis}; "
                "read with pad_multiple = data_axis // num_ranks"
            )
        rank = mesh_ops.data_rank(self.mesh)
        for r in parts:
            if r != rank:
                start = r * partition.block_rows
                raise ValueError(
                    f"rank {r}: rows [{start}, {start + int(partition.local_rows[r])}) are not "
                    "fully addressable from this process — each rank may only extract its "
                    "own block")
        from photon_ml_torch.parallel.distributed import MeshLayout

        dataset = parts[rank]
        layouts = self._layouts(dataset)
        for cid, kind in layouts.items():
            if kind == "entries":
                raise ValueError(
                    f"coordinate '{cid}': compact random-effect "
                    "coordinates are not supported by partitioned "
                    "scoring; use score_dataset"
                )
        shards = dict(dataset.feature_shards)
        for cid, kind in sorted(layouts.items()):
            if kind == "sparse":
                shard_id = self.model.models[cid].feature_shard_id
                shards[shard_id] = self._assemble_sparse_coord(
                    cid, shards[shard_id], partition, exchange)
        dataset = dataclasses.replace(dataset, feature_shards=shards, _sparse_batches={})
        rows = slice(partition.base_row, partition.base_row + partition.block_rows)
        data = {"dataset": dataset, "mesh": MeshLayout(mesh=self.mesh, rows=rows,
                                                       num_rows=partition.global_rows)}
        self._attach_feature_block(data)
        scores = self._score_prepared(data, self.params_for_layouts(layouts))
        return {rank: self._extract_rank_rows(scores, partition, rank)}

    def _assemble_sparse_coord(self, cid, shard: SparseShard, partition,
                               exchange) -> SparseShard:
        """One sparse FE coordinate's entries of this rank's block, padded to
        the ranks' agreed entry-block length (the largest, rounded up to the
        data axis; pads carry value 0, column 0 and the block's last row, or
        row 0 of an empty block). Rows stay rank-local: each rank scores its
        own block."""
        rows, cols, vals = (np.asarray(a) for a in shard.coalesced())
        local_nnz = int(vals.shape[0])
        if partition.num_ranks == 1:
            block_nnz = local_nnz
        else:
            if exchange is None:
                raise ValueError(
                    f"coordinate '{cid}': multi-process partitioned "
                    "scoring of a sparse shard needs the run's "
                    "MetadataExchange (pass score_partitioned("
                    "exchange=...)) so ranks agree on the entry-block "
                    "length"
                )
            block_nnz = max(int(g) for g in exchange.allgather(f"score_sparse_nnz/{cid}",
                                                               local_nnz))
        data_axis = mesh_ops.data_size(self.mesh)
        block_nnz = max(-(-block_nnz // data_axis) * data_axis, data_axis)
        p = _pad_nnz({"rows": rows, "cols": cols, "vals": vals}, block_nnz)
        padded = (p["rows"], p["cols"], p["vals"])
        # the padded triple is the shard's entry list as it stands (its pads
        # must not coalesce away)
        return SparseShard(rows=padded[0], cols=padded[1], vals=padded[2],
                           num_samples=shard.num_samples, feature_dim=shard.feature_dim,
                           _coalesced=padded)

    @staticmethod
    def _extract_rank_rows(scores: torch.Tensor, partition, rank: int) -> np.ndarray:
        """The rank's true (unpadded) rows of its block's scores, on the host."""
        if int(scores.shape[0]) != partition.block_rows:
            raise ValueError(f"rank {rank}: {int(scores.shape[0])} scores for a block of "
                             f"{partition.block_rows} rows")
        return scores[: int(partition.local_rows[rank])].detach().cpu().numpy()
