"""LibSVM text -> TrainingExampleAvro converter (the port's).

Counterpart of ``photon_ml_tpu/cli/libsvm_to_avro.py``; reference
dev-scripts/libsvm_text_to_trainingexample_avro.py, which converts LibSVM
files (e.g. a1a) into the TrainingExampleAvro container format the drivers
read. Field mapping: feature name = str(0-based index), term = "", ±1 labels
-> {0, 1}. The output is byte for byte the JAX tool's.

    python -m photon_ml_torch.cli.libsvm_to_avro \\
        --input a1a --output data/train/part-00000.avro [--zero-based]
"""

from __future__ import annotations

import argparse
import os
from typing import Sequence

from photon_ml_torch.io import avro as avro_io
from photon_ml_torch.io import photon_schemas as schemas
from photon_ml_torch.io.data_reader import read_libsvm


def convert(input_path: str | os.PathLike, output_path: str | os.PathLike, *,
            zero_based: bool = False) -> int:
    """Convert one LibSVM file; returns the number of records written."""
    out_dir = os.path.dirname(str(output_path))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    return avro_io.write_container(output_path, schemas.TRAINING_EXAMPLE_AVRO,
                                   read_libsvm(input_path, zero_based=zero_based))


def main(argv: Sequence[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True, help="LibSVM text file")
    p.add_argument("--output", required=True, help="output .avro path")
    p.add_argument("--zero-based", action="store_true",
                   help="feature indices in the input are 0-based")
    args = p.parse_args(argv)
    n = convert(args.input, args.output, zero_based=args.zero_based)
    print(f"wrote {n} records to {args.output}")
    return n


if __name__ == "__main__":
    main()
