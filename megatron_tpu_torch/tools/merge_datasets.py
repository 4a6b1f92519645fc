"""Merge indexed datasets into one (counterpart of the repo's
tools/merge_datasets.py, with the same flags and output):

    python -m megatron_tpu_torch.tools.merge_datasets \\
        --input prefix_a prefix_b --output merged
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from megatron_tpu_torch.data.indexed_dataset import (
        MMapIndexedDataset, MMapIndexedDatasetBuilder, data_file_path,
        index_file_path,
    )

    p = argparse.ArgumentParser()
    p.add_argument("--input", nargs="+", required=True,
                   help="dataset prefixes to merge, in order")
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)

    first = MMapIndexedDataset(args.input[0])
    builder = MMapIndexedDatasetBuilder(data_file_path(args.output),
                                        dtype=first.dtype)
    total = 0
    for prefix in args.input:
        builder.merge_file_(prefix)
        total += len(MMapIndexedDataset(prefix))
    builder.finalize(index_file_path(args.output))
    print(f"merged {len(args.input)} datasets ({total} sequences) "
          f"into {args.output}")


if __name__ == "__main__":
    main()
