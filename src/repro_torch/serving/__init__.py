"""Serving loops of the port (of ``repro.serving``; DESIGN.md §13, §15).

The continuous-batching sparse serving engine, where selection quality
(selector), resilience (guarded execution, deadlines, shedding,
durability) and observability (registry + tracer) are measured jointly
under load, on the card unless its service was built with
``device="cpu"``:

    from repro_torch.serving import ServingEngine, generate_trace, replay

    engine = ServingEngine(service, slot_max=8, deadline_ms=50, slo_ms=25)
    trace = generate_trace(n_requests=256, qps=400, n_tenants=8, seed=0)
    rep = replay(engine, trace, population)   # throughput / p99 / SLO / shed

``decode_moe_ticks`` drives the MoE decode path through the plan/execute
facade.

CLI: ``python -m repro_torch.serving.serve --requests 64 --qps 200``
(``--device cpu`` for the plain PyTorch versions).
"""
from .admission import BoundedQueue, EngineRequest
from .checkpoint import CHECKPOINT_VERSION, EngineCheckpoint
from .decode import decode_moe_ticks
from .engine import ServingEngine
from .journal import JournalScan, RequestJournal, reconcile
from .replay import replay, report, tenant_rhs
from .slots import Slot, SlotTable, slot_label
from .supervisor import recover_engine, recovery_telemetry, run_with_restarts
from .trace_gen import (TraceRequest, generate_trace, tenant_population,
                        zipf_weights)

__all__ = [
    "BoundedQueue", "CHECKPOINT_VERSION", "EngineCheckpoint", "EngineRequest",
    "JournalScan", "RequestJournal", "ServingEngine", "Slot", "SlotTable",
    "TraceRequest", "decode_moe_ticks", "generate_trace", "reconcile",
    "recover_engine", "recovery_telemetry", "replay", "report",
    "run_with_restarts", "slot_label", "tenant_population", "tenant_rhs",
    "zipf_weights",
]
