"""Matrix corpus emulating the SuiteSparse slice used by the paper (§3.3).

The port's own copy of ``repro.core.dataset`` (numpy only).

The paper takes the 600 largest SuiteSparse matrices across 9 domains.
This container is offline, so we synthesize a corpus whose *structural
families* mirror those domains (banded FEM, power-law social graphs, grid
stencils, bipartite recsys, ...). Sizes are scaled down (the metrics and
schedules are structure-driven, not size-driven) and are log-uniform over
[n_min, n_max] like the collection's spread.

Each entry: (name, domain, CSR). Deterministic in ``seed``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np

from .csr import CSR
from . import synthetic

Matrix = Tuple[str, str, CSR]


def _coo_to_csr(rows, cols, n, rng) -> CSR:
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return CSR.from_coo(np.asarray(rows), np.asarray(cols), vals, (n, n))


def _banded(n: int, rng: np.random.Generator, band: int = 3, fill: float = 1.0) -> CSR:
    rows, cols = [], []
    for off in range(-band, band + 1):
        i = np.arange(max(0, -off), min(n, n - off))
        keep = rng.random(i.size) < fill
        rows.append(i[keep])
        cols.append((i + off)[keep])
    return _coo_to_csr(np.concatenate(rows), np.concatenate(cols), n, rng)


def _grid_stencil(n: int, rng: np.random.Generator, points: int = 5) -> CSR:
    side = max(int(np.sqrt(n)), 2)
    n = side * side
    i = np.arange(n)
    offs = [0, -1, 1, -side, side]
    if points == 9:
        offs += [-side - 1, -side + 1, side - 1, side + 1]
    rows, cols = [], []
    for off in offs:
        j = i + off
        ok = (j >= 0) & (j < n)
        if off in (-1, 1):
            ok &= (i // side) == (j // side)
        rows.append(i[ok])
        cols.append(j[ok])
    return _coo_to_csr(np.concatenate(rows), np.concatenate(cols), n, rng)


def _power_law(n: int, rng: np.random.Generator, alpha: float = 2.1,
               mean_deg: int = 8, clustered: bool = False) -> CSR:
    # Degree sequence from a Pareto tail, clipped.
    deg = np.minimum((rng.pareto(alpha - 1, n) + 1) * mean_deg / 2, n // 2).astype(np.int64)
    deg = np.sort(deg)[::-1]  # hubs first: contiguous imbalance like real crawls
    rows = np.repeat(np.arange(n), deg)
    if clustered:
        # preferential attachment to low ids -> locality within communities
        cols = (rng.pareto(1.5, rows.size) * n / 20).astype(np.int64) % n
    else:
        cols = rng.integers(0, n, rows.size)
    return _coo_to_csr(rows, cols, n, rng)


def _block_diag(n: int, rng: np.random.Generator, block: int = 32, fill: float = 0.4) -> CSR:
    rows, cols = [], []
    for b0 in range(0, n, block):
        sz = min(block, n - b0)
        m = rng.random((sz, sz)) < fill
        r, c = np.nonzero(m)
        rows.append(r + b0)
        cols.append(c + b0)
    return _coo_to_csr(np.concatenate(rows), np.concatenate(cols), n, rng)


def _bipartite_uniform(n: int, rng: np.random.Generator, mean_deg: int = 6) -> CSR:
    deg = rng.poisson(mean_deg, n)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, rows.size)
    return _coo_to_csr(rows, cols, n, rng)


def _circuit(n: int, rng: np.random.Generator) -> CSR:
    i = np.arange(n)
    extra = rng.integers(0, n, size=2 * n)
    rows = np.concatenate([i, i[: extra.size // 2], extra[extra.size // 2:] % n])
    cols = np.concatenate([i, extra[: extra.size // 2], i[: extra.size - extra.size // 2]])
    return _coo_to_csr(rows, cols, n, rng)


DOMAINS: Dict[str, Callable[[int, np.random.Generator], CSR]] = {
    "structural": lambda n, r: _banded(n, r, band=int(r.integers(2, 8)), fill=0.9),
    "semiconductors": lambda n, r: _banded(n, r, band=int(r.integers(8, 24)), fill=0.25),
    "social_networks": lambda n, r: _power_law(n, r, clustered=False),
    "web": lambda n, r: _power_law(n, r, clustered=True),
    "road_networks": lambda n, r: _banded(n, r, band=2, fill=0.6),
    "optimization": lambda n, r: _block_diag(n, r, block=int(r.integers(16, 64))),
    "computer_vision": lambda n, r: _grid_stencil(n, r, points=int(r.choice([5, 9]))),
    "recommender": lambda n, r: _bipartite_uniform(n, r),
    "circuit_simulation": _circuit,
}


def corpus(n_matrices: int = 90, n_min: int = 256, n_max: int = 4096,
           seed: int = 0, include_synthetic: bool = True) -> List[Matrix]:
    """Generate the characterization corpus: 9 domains + 9 synthetic categories."""
    rng = np.random.default_rng(seed)
    out: List[Matrix] = []
    names = list(DOMAINS)
    per = max(n_matrices // len(names), 1)
    for d_i, dom in enumerate(names):
        for j in range(per):
            n = int(np.exp(rng.uniform(np.log(n_min), np.log(n_max))))
            sub = np.random.default_rng(seed * 1000 + d_i * 100 + j)
            out.append((f"{dom}_{j}", dom, DOMAINS[dom](n, sub)))
    if include_synthetic:
        for cat, gen in synthetic.GENERATORS.items():
            for j in range(max(per // 2, 1)):
                n = int(np.exp(rng.uniform(np.log(n_min), np.log(n_max))))
                out.append((f"synthetic_{cat}_{j}", f"synthetic_{cat}",
                            gen(n, seed=seed + j)))
    return out
