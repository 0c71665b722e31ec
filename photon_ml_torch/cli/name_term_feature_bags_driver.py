"""Name-and-term feature bag extraction driver (the port's).

Counterpart of ``photon_ml_tpu/cli/name_term_feature_bags_driver.py``;
reference photon-client data/avro/NameAndTermFeatureBagsDriver.scala:153-229:
scan the data, collect the distinct (name, term) pairs of each feature bag
and write them as text, one "name\\tterm" line a feature, sorted, in
``<output-dir>/<bag>/part-00000.tsv``. Host only.

    python -m photon_ml_torch.cli.name_term_feature_bags_driver \\
        --input-data-path data/train --output-dir bags --feature-bags features
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Sequence

from photon_ml_torch.io.data_reader import _record_bags, read_avro_records, read_libsvm

logger = logging.getLogger(__name__)


def run(*, input_data_path: str, output_dir: str, feature_bags: Sequence[str],
        input_format: str = "avro") -> dict[str, int]:
    records = (read_avro_records(input_data_path) if input_format == "avro"
               else read_libsvm(input_data_path))
    wanted = set(feature_bags)
    pairs: dict[str, set[tuple[str, str]]] = {b: set() for b in wanted}
    for record in records:
        for bag, feats in _record_bags(record).items():
            if bag in wanted:
                for feat in feats:
                    pairs[bag].add((feat["name"], feat.get("term", "") or ""))

    counts = {}
    for bag, found in pairs.items():
        bag_dir = os.path.join(output_dir, bag)
        os.makedirs(bag_dir, exist_ok=True)
        with open(os.path.join(bag_dir, "part-00000.tsv"), "w", encoding="utf-8") as f:
            for name, term in sorted(found):
                f.write(f"{name}\t{term}\n")
        counts[bag] = len(found)
        logger.info("bag '%s': %d distinct (name, term) pairs", bag, len(found))
    return counts


def main(argv: Sequence[str] | None = None) -> dict[str, int]:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(prog="name_term_feature_bags_driver")
    p.add_argument("--input-data-path", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--feature-bags", required=True, help="comma-separated bag names")
    p.add_argument("--input-format", default="avro", choices=["avro", "libsvm"])
    args = p.parse_args(argv)
    return run(input_data_path=args.input_data_path, output_dir=args.output_dir,
               feature_bags=[b.strip() for b in args.feature_bags.split(",") if b.strip()],
               input_format=args.input_format)


if __name__ == "__main__":
    main()
