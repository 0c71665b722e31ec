"""Feature indexing driver: build and save per-shard feature index maps
(the port's).

Counterpart of ``photon_ml_tpu/cli/feature_indexing_driver.py``; reference
photon-client index/FeatureIndexingDriver.scala:177-290: scan the data once,
collect the distinct (name, term) keys of each shard and save its index map
as a plain ``<shard>.keys`` store or, with ``--index-store-format offheap``,
as ``--num-partitions`` native off-heap stores (``io/offheap_index_map.py``,
the reference's partitioned PalDB layout). The GAME training and scoring
drivers read either back through ``--index-maps-dir``. Host only.

    python -m photon_ml_torch.cli.feature_indexing_driver \\
        --input-data-path data/train --output-dir index-maps \\
        --feature-shard-configurations name=global,feature.bags=features
"""

from __future__ import annotations

import argparse
import logging
from typing import Sequence

from photon_ml_torch.cli.configs import parse_feature_shard_config
from photon_ml_torch.io.data_reader import build_index_maps, read_avro_records, read_libsvm
from photon_ml_torch.io.offheap_index_map import build_offheap_store

logger = logging.getLogger(__name__)


def run(*, input_data_path: str, output_dir: str, feature_shards: dict,
        input_format: str = "avro", store_format: str = "plain",
        num_partitions: int = 1) -> dict[str, int]:
    records = (read_avro_records(input_data_path) if input_format == "avro"
               else read_libsvm(input_data_path))
    sizes = {}
    for shard_id, imap in build_index_maps(records, feature_shards).items():
        if store_format == "offheap":
            build_offheap_store(output_dir, imap, num_partitions=num_partitions, name=shard_id)
        else:
            imap.save(output_dir, shard_id)
        sizes[shard_id] = imap.size
        logger.info("shard '%s': %d features indexed", shard_id, imap.size)
    return sizes


def main(argv: Sequence[str] | None = None) -> dict[str, int]:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(prog="feature_indexing_driver")
    p.add_argument("--input-data-path", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--feature-shard-configurations", action="append", required=True)
    p.add_argument("--input-format", default="avro", choices=["avro", "libsvm"])
    p.add_argument("--index-store-format", default="plain", choices=["plain", "offheap"],
                   help="offheap = partitioned native mmap stores (the reference's "
                        "PalDB layout)")
    p.add_argument("--num-partitions", type=int, default=1)
    args = p.parse_args(argv)
    shards = dict(parse_feature_shard_config(s) for s in args.feature_shard_configurations)
    return run(input_data_path=args.input_data_path, output_dir=args.output_dir,
               feature_shards=shards, input_format=args.input_format,
               store_format=args.index_store_format, num_partitions=args.num_partitions)


if __name__ == "__main__":
    main()
