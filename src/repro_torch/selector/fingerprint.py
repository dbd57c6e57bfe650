"""Matrix and routing fingerprints: the cache/prediction keys of the
selection service and of the MoE decode cache (copy of
``repro.selector.fingerprint``).

A matrix fingerprint is the paper's static characterization vector
(metrics.py Eq. 1-6 — no schedule simulation, no kernel run) plus the exact
shape/nnz, canonicalized to a fixed decimal precision and hashed. Rounding
before hashing makes the key deterministic: the float features come out of
subsampled streams and log transforms whose last bits are not meaningful,
so two byte-identical matrices must map to one key while structurally
different matrices keep distinct keys (shape/nnz are exact, and the cache
double-checks the full rounded vector on every hit, so a hash collision is
served as a miss). The keys are the same sha1 as the JAX package's for the
same matrix, or the same histogram, ``d_model`` and platform name.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Tuple

import numpy as np

from ..core import metrics as metrics_mod
from ..core.csr import CSR

# Decimal digits kept per feature when forming the hash key. All features
# are O(1)-magnitude (affinities/entropies in [0,1], log10 sizes < ~10), so
# absolute decimal rounding is a uniform relative precision too.
FP_PRECISION = 6


def _canon(value: float, precision: int) -> str:
    """Fixed-precision canonical text for one feature (rounds and formats in
    one step; normalizes -0.0 and non-finite values)."""
    v = float(value)
    if v != v:  # NaN never equals itself: pin a canonical spelling
        return "nan"
    if v in (float("inf"), float("-inf")):
        return "inf" if v > 0 else "-inf"
    text = f"{v:.{precision}f}"
    return f"{0.0:.{precision}f}" if float(text) == 0.0 else text


@dataclasses.dataclass(frozen=True)
class Fingerprint:
    """Stable identity of an operand for schedule selection."""

    key: str                                   # sha1 hex digest
    canonical: Tuple[Tuple[str, str], ...]     # (feature, rounded text) pairs
    features: Dict[str, float]                 # unrounded, for the predictor
    shape: Tuple[int, int]
    nnz: int


def fingerprint(csr: CSR, precision: int = FP_PRECISION) -> Fingerprint:
    """Characterize ``csr`` once and derive the stable cache key."""
    feats = metrics_mod.characterize(csr)
    canonical = tuple(sorted((k, _canon(v, precision))
                             for k, v in feats.items()))
    payload = "|".join(
        [f"v1;shape={csr.shape[0]}x{csr.shape[1]};nnz={csr.nnz}"]
        + [f"{k}={t}" for k, t in canonical])
    key = hashlib.sha1(payload.encode("utf-8")).hexdigest()
    return Fingerprint(key=key, canonical=canonical, features=dict(feats),
                       shape=(int(csr.shape[0]), int(csr.shape[1])),
                       nnz=int(csr.nnz))


def routing_fingerprint(tokens_per_expert, d_model: int, platform: str = "",
                        precision: int = FP_PRECISION) -> Fingerprint:
    """Fingerprint of an MoE routing histogram for the serving decode cache.

    Tokens-per-expert is the paper's nnz-per-row partition problem, so the
    decode-time grouped-GEMM tile choice caches the same way a matrix's
    schedule does: Eq. 5 imbalance + size features, rounded and hashed.
    Used by ``repro_torch.sparse.moe_tile_schedule``.
    """
    counts = np.asarray(tokens_per_expert, np.float64).reshape(-1)
    n_e = int(counts.size)
    total = float(counts.sum())
    feats = {
        "moe_imbalance": metrics_mod.partition_imbalance(counts,
                                                       max(n_e, 1)),
        "moe_log_tokens": float(np.log10(total + 1.0)),
        "moe_n_experts": float(n_e),
        "moe_d_model": float(d_model),
        "moe_top_share": float(counts.max() / total) if total > 0 else 0.0,
    }
    canonical = tuple(sorted((k, _canon(v, precision))
                             for k, v in feats.items()))
    # The tile rule is platform-specific, so the platform is part of the
    # key: a shared cache must never serve one platform's tile to another.
    payload = "|".join([f"moe1;experts={n_e};d={int(d_model)};p={platform}"]
                       + [f"{k}={t}" for k, t in canonical])
    key = hashlib.sha1(payload.encode("utf-8")).hexdigest()
    return Fingerprint(key=key, canonical=canonical, features=feats,
                       shape=(n_e, int(d_model)), nnz=int(total))
