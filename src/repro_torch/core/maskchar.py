"""Attention-mask characterization: SpChar metrics over attention patterns
(port of ``repro.core.maskchar``; numpy, a copy).

An attention mask is a sparse boolean matrix; the paper's static metrics
apply verbatim (DESIGN.md §4/§5): a sliding window is a banded matrix
(maximal index affinity, zero entropy), strided/global-token patterns look
like the 'stride'/'column' synthetic categories. This module builds the
CSR of a layer's mask at a given sequence length and characterizes it —
used to pick block-sparse attention schedules for long_500k archs and to
report how far a pattern is from the dense worst case.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..configs.base import ArchConfig
from .csr import CSR
from .metrics import characterize


def mask_csr(kind: str, seq_len: int, window: int = 0,
             sample_rows: int = 256) -> CSR:
    """CSR of the (row-sampled) attention reachability pattern.

    Rows are query positions (uniformly subsampled to keep nnz bounded);
    columns are key positions. kinds: "attn" (causal full), "local_attn" /
    "swa_attn" (causal banded), "bidirectional".
    """
    step = max(seq_len // sample_rows, 1)
    rows_idx = np.arange(0, seq_len, step)
    rows, cols = [], []
    for r_out, q in enumerate(rows_idx):
        if kind == "bidirectional":
            lo, hi = 0, seq_len
        elif kind in ("local_attn", "swa_attn") and window > 0:
            lo, hi = max(0, q - window + 1), q + 1
        else:  # causal full
            lo, hi = 0, q + 1
        # column subsampling keeps the metric pass O(sample_rows^2)
        c = np.arange(lo, hi, step)
        rows.append(np.full(c.size, r_out))
        cols.append(c // step)
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    n = rows_idx.size
    return CSR.from_coo(r, c, np.ones(r.size, np.float32),
                        (n, seq_len // step + 1))


def characterize_attention(cfg: ArchConfig, seq_len: int) -> Dict[str, Dict]:
    """Per layer-kind SpChar metrics of the arch's attention patterns,
    plus the density vs dense-causal (the block-sparse savings bound)."""
    out: Dict[str, Dict] = {}
    for kind in dict.fromkeys(cfg.layer_pattern):
        if kind not in ("attn", "local_attn", "swa_attn"):
            continue
        m = mask_csr(kind, seq_len, cfg.window)
        feats = characterize(m)
        causal_nnz = mask_csr("attn", seq_len, 0).nnz
        feats["fraction_of_causal"] = m.nnz / max(causal_nnz, 1)
        out[kind] = feats
    return out
