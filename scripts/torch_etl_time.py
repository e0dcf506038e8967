#!/usr/bin/env python3
"""Time the port's ETL of the synthetic dataset shapes.

Run from the root of a checkout::

    python3 scripts/torch_etl_time.py [shape ...]     # default: ml-1m-shape

For each shape (``recstudio_torch.data.synthetic.SHAPES``) it writes the
``.inter`` file if it is not there yet (``build/recstudio_torch/
synthetic/``, seed 7, as ``chip_smoke.py`` does), then times, on the host
clock: the parse of that file alone (``data.dataset._read_table``), and
the ETL of ``chip_smoke.py``'s training phases: ``SeqDataset`` at L 200
(parse, ids, tables) and its ``build`` (the sorted, leave-one-out splits
with their history tables). It prints one JSON line a shape. The script
reads nothing but the port's public entry points, so it can be copied into
an older checkout to time that tree's ETL the same way.
"""
from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_shape(shape: str) -> dict:
    from recstudio_torch.data import SeqDataset
    from recstudio_torch.data.dataset import _read_table
    from recstudio_torch.data.synthetic import SHAPES, generate
    from recstudio_torch.utils import get_model
    t0 = time.perf_counter()
    name, config = generate(shape, *SHAPES[shape], seed=7)
    t1 = time.perf_counter()
    path = os.path.join(config["url"], config["inter_feat_name"])
    table, _ = _read_table(path, config["inter_feat_header"], "\t",
                           config["inter_feat_field"], "utf-8")
    t2 = time.perf_counter()
    rows = len(table["rating"])
    del table
    config["max_seq_len"] = 200
    ds = SeqDataset(name, config=config)
    t3 = time.perf_counter()
    ds.build(**get_model("NARM")[1]["data"])
    t4 = time.perf_counter()
    return {"shape": shape, "rows": rows, "file_bytes": os.path.getsize(path),
            "generate_s": t1 - t0, "parse_s": t2 - t1, "dataset_s": t3 - t2,
            "build_s": t4 - t3, "etl_s": t4 - t2}


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    for shape in sys.argv[1:] or ["ml-1m-shape"]:
        print(json.dumps(time_shape(shape)), flush=True)
