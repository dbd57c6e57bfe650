"""Deterministic Zipf request-trace generation over a multi-tenant
population (port of ``repro.serving.trace_gen``; numpy only).

The serving engine's realism comes from its traffic, not its internals:
iterative sparse workloads (CG / PageRank — the SpMV-survey pattern) reuse
the same matrix thousands of times, and multi-tenant serving sees that
reuse skewed — a few hot tenants dominate while a long tail stays cold.
Both properties fall out of one generator:

* a **tenant population** — distinct matrices drawn from the
  characterization corpus, one per tenant, so tenants genuinely differ in
  structure (different schedules, different prepared-operand footprints);
* a **Zipf-distributed request trace** — tenant picks follow rank
  ``(i+1)^-a`` popularity, arrivals follow a Poisson process at the offered
  QPS. Everything is seeded through one ``numpy`` Generator, so the same
  ``(seed, qps, n_requests)`` triple replays the identical trace — and
  the identical matrices — in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..core.csr import CSR
from ..core.dataset import corpus


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One offered request: arrival time (seconds since trace start),
    tenant index into the population, and a stable request name."""

    t_s: float
    tenant: int
    name: str


def zipf_weights(n_tenants: int, a: float = 1.1) -> np.ndarray:
    """Normalized rank-``(i+1)^-a`` popularity over ``n_tenants`` tenants
    (tenant 0 is the hottest)."""
    w = (np.arange(max(int(n_tenants), 1)) + 1.0) ** -float(a)
    return w / w.sum()


def tenant_population(n_tenants: int, n_min: int = 256, n_max: int = 512,
                      seed: int = 0) -> List[Tuple[str, CSR]]:
    """``n_tenants`` distinct (name, matrix) tenants from the
    characterization corpus — domain + synthetic categories, so the
    population spans layouts/schedules the way real multi-tenant traffic
    would, rather than n copies of one structure."""
    mats = corpus(n_matrices=max(int(n_tenants), 9), n_min=n_min,
                  n_max=n_max, seed=seed, include_synthetic=True)
    if len(mats) < n_tenants:
        raise ValueError(f"corpus produced {len(mats)} matrices "
                         f"< {n_tenants} tenants")
    return [(f"t{i}:{name}", A)
            for i, (name, _, A) in enumerate(mats[:int(n_tenants)])]


def generate_trace(n_requests: int, qps: float, n_tenants: int,
                   a: float = 1.1, seed: int = 0) -> List[TraceRequest]:
    """Seeded Zipf trace: Poisson arrivals at ``qps`` offered rate, tenant
    picks Zipf(``a``)-skewed over the population. Deterministic — one
    Generator, fixed draw order — and sorted by arrival by construction
    (cumulative exponential gaps)."""
    if n_requests <= 0:
        return []
    if qps <= 0:
        raise ValueError(f"offered qps must be positive, got {qps}")
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1.0 / float(qps), int(n_requests)))
    tenants = rng.choice(int(n_tenants), size=int(n_requests),
                         p=zipf_weights(n_tenants, a))
    return [TraceRequest(float(t[i]), int(tenants[i]),
                         f"r{i}:t{int(tenants[i])}")
            for i in range(int(n_requests))]
