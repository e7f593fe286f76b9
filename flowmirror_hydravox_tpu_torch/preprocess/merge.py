"""Stage 5: merge saved stage-4 datasets (port of
flowmirror_hydravox_tpu/preprocess/merge.py; reference data_tab.py:710
run_stage4_merge -> datasets.concatenate_datasets), through the port's
`utils/hf_dataset.concatenate_datasets`. It runs on the host only.

Usage:
  python -m flowmirror_hydravox_tpu_torch.preprocess.merge \\
      --input_dir stage4_a/,stage4_b/ --output_dir merged/
"""

from __future__ import annotations

import argparse
import logging

logger = logging.getLogger("hydravox.merge")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_dir", required=True,
                   help="comma-separated list of stage-4 dataset dirs")
    p.add_argument("--output_dir", required=True)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from .extract_tokens import merge_datasets

    paths = [s.strip() for s in args.input_dir.split(",") if s.strip()]
    n = merge_datasets(paths, args.output_dir)
    logger.info("merged %d datasets -> %d rows at %s", len(paths), n, args.output_dir)


if __name__ == "__main__":
    main()
