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

``score_partitioned`` (partitioned I/O) and ``fe_feature_sharded`` (the
model axis) are not ported: ROADMAP.md item 15.
"""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_torch.data.game_data import GameDataset, game_dataset_rows, pad_game_dataset
from photon_ml_torch.data.sparse_batch import SparseShard
from photon_ml_torch.models.game import FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_torch.models.matrix_factorization import MatrixFactorizationModel
from photon_ml_torch.parallel import mesh as mesh_ops
from photon_ml_torch.parallel.multihost import ITEM_15


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
    """Scores a GameModel over a data-axis mesh (or on one device with
    ``mesh=None``)."""

    def __init__(self, model: GameModel, mesh=None, *, fe_feature_sharded: "bool | str" = False):
        if fe_feature_sharded:
            raise NotImplementedError("DistributedScorer(fe_feature_sharded=...) (the model "
                                      f"axis) is not ported yet: ROADMAP.md item {ITEM_15}")
        if mesh is not None:
            mesh_ops.check_data_mesh(mesh)
        self.model = model
        self.mesh = mesh
        self._kinds = _model_kinds(model)
        #: layout signature -> the sub-models that score it
        self._params_cache: dict = {}

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
        return data, self.params_for_layouts(self._layouts(dataset)), n_true

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
        fields, before anything changes."""
        mismatch = _fingerprint_mismatch(params_layout_fingerprint(new_model),
                                         params_layout_fingerprint(self.model))
        if mismatch is not None:
            raise ValueError(f"the new model's params layout {mismatch}; a layout-changing "
                             "refresh must build a fresh scorer instead of hot-swapping")
        rebuilt = {key: {cid: new_model.models[cid] for cid in new_model.models
                         if cid in dict(key)} for key in self._params_cache}
        self.model = new_model
        self._params_cache = rebuilt

    # -- scoring -------------------------------------------------------------

    def _score_prepared(self, data, params) -> torch.Tensor:
        """This rank's scores, offsets included."""
        dataset = data["dataset"]
        total = None
        for m in params.values():
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

    def score_partitioned(self, parts, partition, exchange=None):
        """Scores of per-rank partitioned inputs: not ported (ROADMAP.md
        item 15, partitioned I/O)."""
        raise NotImplementedError("DistributedScorer.score_partitioned (partitioned I/O) is "
                                  f"not ported yet: ROADMAP.md item {ITEM_15}")
