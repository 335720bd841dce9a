"""jsonl corpus -> tokenize -> torch batches on a device.

Run: python -m ray_tpu_torch.examples.data_pipeline [--device cpu]
"""
import argparse
import json
import os
import tempfile

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch import data as rd


def tokenize(batch):
    return {"tokens": np.stack([np.arange(16) + d_
                                for d_ in batch["doc_id"]]),
            "doc_id": batch["doc_id"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the batches land (default: the card)")
    args = ap.parse_args(argv)
    ray_tpu_torch.init(num_cpus=4)
    d = tempfile.mkdtemp()
    with open(os.path.join(d, "corpus.jsonl"), "w") as f:
        for i in range(256):
            f.write(json.dumps({"doc_id": i, "text": f"document {i}"}) + "\n")

    ds = rd.read_json(os.path.join(d, "corpus.jsonl"),
                      rows_per_block=32).map_batches(tokenize)
    print("dataset:", ds, "rows:", ds.count())

    for i, batch in enumerate(ds.iterator().iter_torch_batches(
            batch_size=64, dtypes={"tokens": torch.int32},
            device=args.device)):
        print(f"batch {i}: tokens {tuple(batch['tokens'].shape)} "
              f"{batch['tokens'].dtype} on {batch['tokens'].device}")
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
