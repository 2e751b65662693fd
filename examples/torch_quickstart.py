"""Quickstart on the PyTorch port: the full Deep Lake ML loop in one script.

Create a dataset -> version it -> query it with TQL (evaluated by the torch
engine on the CUDA device; ``--device cpu`` for the CPU) -> stream it ->
visualize a row.  Runs in seconds.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse

import numpy as np

import repro_torch.core as dl
from repro_torch.core.tql import execute_query
from repro_torch.core.visualize import plan_layout, render_ascii


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the query; default: the CUDA device")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)

    # 1. create + ingest -----------------------------------------------------
    ds = dl.dataset()  # in-memory; pass "file:///tmp/lake" or s3sim:// too
    ds.create_tensor("images", htype="image", dtype="uint8",
                     sample_compression="quant8")
    ds.create_tensor("labels", htype="class_label")
    ds.create_tensor("boxes", htype="bbox", strict=False)
    for i in range(200):
        ds.append({
            "images": rng.integers(0, 255, (48, 48, 3), dtype=np.uint8),
            "labels": np.int64(i % 5),
            "boxes": rng.uniform(0, 48, (2, 4)).astype(np.float32),
        })
    print(ds.summary())

    # 2. version control ------------------------------------------------------
    first = ds.commit("initial 200 rows")
    ds.checkout("relabel", create=True)
    ds.labels[0] = np.int64(4)
    ds.commit("fix label 0")
    ds.checkout("main")
    ds.merge("relabel")
    print(f"\nbranches: {ds.branches}; label[0] after merge: {int(ds.labels[0])}")
    old = ds.tensor_at("labels", first)
    print(f"time travel: label[0] at {first[:8]} was {int(old.read(0))}")

    # 3. TQL, on the device ----------------------------------------------------
    view = execute_query(ds, """
        SELECT images[8:40, 8:40, :] AS crop, labels
        FROM dataset
        WHERE labels == 4 AND MEAN(images) > 100
        ORDER BY MEAN(images) DESC
        LIMIT 32
    """, engine="torch", device=args.device)
    print(f"\nTQL view: {len(view)} rows; crop shape "
          f"{view.row(0)['crop'].shape}")

    # 4. stream ---------------------------------------------------------------
    loader = view.dataloader(batch_size=8, shuffle=True, num_workers=4)
    for batch in loader:
        pass
    print(f"streamed {loader.stats.samples} samples at "
          f"{loader.stats.throughput():.0f} samples/s")

    # 5. visualize -------------------------------------------------------------
    print("\nlayout:", [(p.primary, p.overlays) for p in plan_layout(ds)])
    row = render_ascii(ds, 0, width=40)
    print(row)
    return row


if __name__ == "__main__":
    main()
