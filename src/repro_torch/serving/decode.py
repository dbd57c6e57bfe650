"""The MoE decode loop (port of ``examples/serve_lm.py::decode_moe_ticks``).

Each tick routes the decode batch, takes the grouped-GEMM tile from the
selector-backed ``ScheduleCache`` (``moe_tile_schedule``), pads the routed
tokens with ``route_and_pad`` and executes ``plan("moe_gmm", ...)`` through
the ``PreparedStore``. Routing alternates between a balanced and a
hot-expert regime, the recurring traffic the caches exist for.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.platforms import H100_SXM, Platform
from ..selector.cache import ScheduleCache
from ..sparse import PreparedStore, moe_tile_schedule, plan, route_and_pad


def decode_moe_ticks(n_ticks: int, d_model: int = 256, d_ff: int = 512,
                     n_experts: int = 8, batch: int = 4,
                     cache: Optional[ScheduleCache] = None,
                     store: Optional[PreparedStore] = None, seed: int = 0,
                     platform: Platform = H100_SXM, device="cuda",
                     w: Optional[torch.Tensor] = None) -> Dict:
    """Run ``n_ticks`` decode ticks of MoE expert compute on ``device``.

    The numpy stream is the JAX function's: with ``w=None`` the expert
    weights (E, d_model, d_ff) are its first draw, then each tick draws the
    routing and the tokens, so at equal sizes both packages see the same
    tokens, routing and tile choices. A caller that already holds the
    weights on the device passes them as ``w``: they are used as they are
    (no copy), and the stream then starts at the first tick's draws.

    Returns the JAX function's summary (per tick ``(tile_m, out shape)``,
    the cache and prepared-store hit rates and entries) plus, per tick,
    its output (``outputs``, on ``device``) and the routed host inputs
    (``routed``: ``(x, tile_expert)``).
    """
    rng = np.random.default_rng(seed)
    cache = cache if cache is not None else ScheduleCache()
    store = store if store is not None else PreparedStore()
    if w is None:
        w = rng.standard_normal((n_experts, d_model, d_ff)).astype(np.float32)
    ticks, outputs, routed = [], [], []
    for t in range(n_ticks):
        if t % 2 == 0:  # balanced routing regime
            eot = rng.integers(0, n_experts, batch)
        else:           # hot-expert regime: everyone routes to expert 0
            eot = np.zeros(batch, dtype=np.int64)
        counts = np.bincount(eot, minlength=n_experts).astype(np.float64)
        sched = moe_tile_schedule(counts, d_model, platform, cache=cache)
        tokens = rng.standard_normal((batch, d_model)).astype(np.float32)
        x, tile_e, _ = route_and_pad(tokens, eot, n_experts,
                                     tile_m=sched.block_size)
        p = plan("moe_gmm", (tile_e,), schedule=sched, store=store,
                 device=device)
        out = p.execute(x, w)
        ticks.append((sched.block_size, tuple(out.shape)))
        outputs.append(out)
        routed.append((x, tile_e))
    tel = cache.telemetry()
    prep = store.telemetry()
    return {"ticks": ticks, "cache_hit_rate": tel["hit_rate"],
            "cache_entries": tel["entries"],
            "prep_hit_rate": prep["hit_rate"],
            "prep_entries": prep["entries"],
            "outputs": outputs, "routed": routed}
