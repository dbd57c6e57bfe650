#!/usr/bin/env python3
"""A/B of the CUDA kernels' tile-row split on one GPU, in one process.

    python3 tools/ab_row_split.py            # needs one CUDA card

For each of the four ELL/SELL SpMV/SpMM kernels on ``gen_zipf(8192)`` at
bs=128 (64 block-rows, the input the split is for) and on
``gen_spatial(524288)`` at bs=32 (16,384 block-rows, no split), times the
kernel with one CTA per whole tile (``rows_per_cta = bs``, the kernels
without the split) and with the split the wrappers choose, in the order
whole, split, split, whole; each time is the median of 20 launches (CUDA
events). Prints one JSON line per kernel x input.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ab_row_split: needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import card_line, cuda_timer, kernel_args
    from repro_torch.core import Schedule, gen_spatial, gen_zipf
    from repro_torch.kernels.bsr_spmv import kernel as K
    from repro_torch.sparse import SparseTensor

    print(card_line(), flush=True)
    chosen = K.rows_per_cta
    rng = np.random.default_rng(0)
    for name, A, bs in (("zipf_8192_bs128", gen_zipf(8192, seed=0), 128),
                        ("spatial_524288_bs32", gen_spatial(524288, seed=0),
                         32)):
        for layout in ("ell", "sell"):
            sched = (Schedule("bsr", bs, 1.0, layout="sell", slice_height=8)
                     if layout == "sell" else Schedule("bsr", bs, 1.0))
            st = SparseTensor.from_csr(A, schedule=sched, shape_bucket=True)
            n_bc = -(-st.meta.shape[1] // bs)
            for multi in (False, True):
                kname, fn, _, idx, count = kernel_args(st, multi)
                shape = (n_bc, bs, 8) if multi else (n_bc, bs)
                xb = torch.as_tensor(
                    rng.standard_normal(shape).astype(np.float32),
                    device="cuda")
                blocks = st.arrays["blocks"]
                times = {"whole": [], "split": []}
                for arm in ("whole", "split", "split", "whole"):
                    K.rows_per_cta = ((lambda b, n: b) if arm == "whole"
                                      else chosen)
                    times[arm].append(cuda_timer(
                        lambda: fn(*idx, blocks, xb, **count)))
                K.rows_per_cta = chosen
                print(json.dumps({
                    "kernel": kname, "input": name,
                    "whole_ms": times["whole"], "split_ms": times["split"],
                    "rows_per_cta": chosen(bs, st.meta.n_block_rows)}),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
