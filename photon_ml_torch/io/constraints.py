"""Coefficient box-constraint maps (the port's own copy of
``photon_ml_tpu/io/constraints.py``).

Reference parity: the legacy driver's constraint string (photon-client
io/deprecated/ConstraintMapKeys.scala, GLMSuite.createConstraintFeatureMap
:207-280, Params.constraintString) — a JSON list of maps with mandatory
``name``/``term`` and optional ``lowerBound``/``upperBound`` (missing bound
= ±inf). Wildcard semantics:

- name="*" and term="*": the bounds apply to every non-intercept feature and
  must be the only constraint given;
- term="*" with a concrete name: the bounds apply to every term of that
  name;
- wildcard in name alone is rejected.

Per-entry validation matches the reference: at least one finite bound, and
lower < upper. The output is a dense (lower[d], upper[d]) pair aligned to an
IndexMap, feeding the solvers' box projection (optim/optimizer.solve).
"""

from __future__ import annotations

import json
import logging

import numpy as np

from photon_ml_torch.io.index_map import (
    INTERCEPT_KEY,
    IndexMap,
    feature_key,
    split_feature_key,
)

logger = logging.getLogger(__name__)

WILDCARD = "*"


def parse_constraint_maps(constraint_string: str) -> list[dict]:
    """Parse and validate the JSON constraint list (bounds defaulted)."""
    parsed = json.loads(constraint_string)
    if not isinstance(parsed, list):
        raise ValueError(
            f"constraint string must be a JSON list of maps, got {type(parsed).__name__}"
        )
    out = []
    for entry in parsed:
        if not isinstance(entry, dict) or "name" not in entry or "term" not in entry:
            raise ValueError(
                f"each constraint map needs 'name' and 'term' fields; got {entry!r}"
            )
        lower = float(entry.get("lowerBound", -np.inf))
        upper = float(entry.get("upperBound", np.inf))
        if not (np.isfinite(lower) or np.isfinite(upper)):
            raise ValueError(
                f"constraint for name={entry['name']!r} term={entry['term']!r} "
                "has neither bound finite"
            )
        if lower >= upper:
            raise ValueError(
                f"lower bound {lower} must be < upper bound {upper} for "
                f"name={entry['name']!r} term={entry['term']!r}"
            )
        out.append(
            {"name": str(entry["name"]), "term": str(entry["term"]),
             "lower": lower, "upper": upper}
        )
    return out


def build_bound_arrays(
    constraint_string: str,
    index_map: IndexMap,
    *,
    dtype=np.float64,
) -> tuple[np.ndarray, np.ndarray]:
    """Dense (lower[d], upper[d]) arrays from a constraint string."""
    entries = parse_constraint_maps(constraint_string)
    d = index_map.size
    lower = np.full((d,), -np.inf, dtype=dtype)
    upper = np.full((d,), np.inf, dtype=dtype)
    constrained: set[int] = set()

    def apply(j: int, lo: float, hi: float, name: str, term: str) -> None:
        if j in constrained:
            raise ValueError(
                f"conflicting constraints: feature name={name!r} term={term!r} "
                "was bounded more than once"
            )
        constrained.add(j)
        lower[j], upper[j] = lo, hi

    # one pass over the forward map (no reverse-lookup scans per entry)
    key_index = [(key, index_map[key]) for key in index_map]
    for entry in entries:
        name, term = entry["name"], entry["term"]
        if name == WILDCARD:
            if term != WILDCARD:
                raise ValueError(
                    "a wildcard feature name requires a wildcard term too"
                )
            if len(entries) > 1:
                raise ValueError(
                    "a full-wildcard constraint must be the only constraint"
                )
            for key, j in key_index:
                if key != INTERCEPT_KEY:
                    apply(j, entry["lower"], entry["upper"], name, term)
        elif term == WILDCARD:
            hits = [
                j for key, j in key_index
                if key != INTERCEPT_KEY and split_feature_key(key)[0] == name
            ]
            if not hits:
                logger.warning(
                    "constraint name=%r term=* matched no feature in the "
                    "index map — it will have no effect", name,
                )
            for j in hits:
                apply(j, entry["lower"], entry["upper"], name, term)
        else:
            j = index_map.get_index(feature_key(name, term))
            if j >= 0:
                apply(j, entry["lower"], entry["upper"], name, term)
            else:
                logger.warning(
                    "constraint for name=%r term=%r names a feature absent "
                    "from the index map — it will have no effect (typo?)",
                    name, term,
                )
    return lower, upper
