"""A served model's decode loop: the driver of a configuration whose file
names ``"driver": "lm_decode"``.

The entry the window drives is the port's serving path as
``repro_torch.launch.serve`` uses it: ``Model(cfg).prefill(batch,
cache_len=...)`` then ``Model.decode(cache, token, pos)`` step after step,
greedy. The configuration's file gives the published sizes (``model``),
the registered architecture they belong to (``arch``) and the port's
settings changed for the deployment (``overrides``); the benchmark draws
the weights (``spbench.lm_weights``) and hands them to the program, and
names no kernel.

Parameters of a mix (``traffic/<mix>.json``):

- ``batch``: the sessions decoded together, each step one token each;
- ``prompt_len``: every session's prompt, ids uniform over the vocabulary
  from the seed; ``cache_len``: the cache's slots, the prompt and the
  longest answer;
- ``prefill_group``: sessions prefilled together in set-up, their caches
  copied into one cache for the whole batch;
- ``warmup_steps``: decode steps run in set-up, after the prefill;
- ``kept_sequences``: sessions kept for the check, one drawn from the
  seed in each equal share of the batch: every token served to them is
  judged, and their logits at the kept steps;
  ``kept_steps``: the window's steps whose logits are kept, a uniform
  sample drawn from the seed (reservoir sampling), each copied into a slot
  made in set-up.

The loop is closed, as a server that streams tokens runs it: each step's
tokens are copied to the host, and the next step is due when they arrive.
A step's latency runs from when it was due to when its tokens are on the
host. A step whose position would pass the cache is not run: the window
stops with an error.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Dict, List, Optional

import numpy as np

from spbench import harness, lm_reference, lm_weights, timeline, work
from spbench.drive import TRACE_SECONDS, Window, _Run


@dataclasses.dataclass
class Context:
    """What the readers read."""
    batch: int
    window: Window
    setup_s: float
    prefill_s: float                # set-up's prefill (host clock)
    kv_cache_bytes: int             # the cache tensors the program holds
    window_flops: float             # model FLOPs of the window's steps
    memory_peak_bytes: Optional[int]
    timeline: Optional[timeline.Timeline]


class CacheFull(RuntimeError):
    pass


def port_config(config: Dict):
    """The port's configuration of ``config["arch"]`` with the file's sizes
    and its ``overrides``."""
    from repro_torch.configs import get_config
    base = get_config(config["arch"])
    fields = {f.name for f in dataclasses.fields(base)}
    sizes = {k: v for k, v in config["model"].items() if k in fields}
    over = {k: tuple(v) if isinstance(v, list) else v
            for k, v in config["overrides"].items()}
    return dataclasses.replace(base, **sizes, **over)


def load_weights(model, m: Dict, seed: int, device) -> None:
    """The benchmark's weights of ``seed`` into the program's parameters
    (vocabulary padding zero); every parameter must be written."""
    import torch
    written = set()

    def put(dst, src):
        dst.zero_()
        dst[tuple(slice(0, n) for n in src.shape)].copy_(src)
        written.add(id(dst))

    with torch.no_grad():
        o = lm_weights.outer(m, seed, device)
        put(model.embed, o["embed"])
        put(model.unembed, o["unembed"])
        put(model.final_norm.scale, o["final_norm"])
        del o
        for i, blk in enumerate(model.blocks):
            w = lm_weights.layer(m, seed, i, device)
            for name in ("wq", "wk", "wv", "wo"):
                put(getattr(blk.mixer, name), w[name])
            put(blk.norm1.scale, w["attn_norm"])
            put(blk.norm2.scale, w["ffn_norm"])
            put(blk.ffn.router, w["router"])
            put(blk.ffn.wi_gate, w["w_gate"])
            put(blk.ffn.wi_up, w["w_up"])
            put(blk.ffn.wo, w["w_down"])
            del w
    missed = [n for n, p in model.named_parameters() if id(p) not in written]
    if missed:
        raise ValueError(f"parameters the benchmark does not draw: {missed}")


def kept_rows(seed: int, batch: int, n: int) -> List[int]:
    """One session drawn from the seed in each of ``n`` equal shares of the
    batch (so a fault in any half of it is seen)."""
    rng = np.random.default_rng([int(seed), 2])
    edges = [batch * i // n for i in range(n + 1)]
    return [int(rng.integers(a, b)) for a, b in zip(edges, edges[1:])]


class Server:
    """The batch's sessions on the program: its model, its cache, the next
    tokens and where they sit, and the tokens served so far."""

    def __init__(self, model, traffic: Dict, m: Dict, seed: int,
                 device) -> None:
        import torch
        self.model = model
        self.traffic = traffic
        self.vocab = int(m["vocab_size"])
        self.batch = int(traffic["batch"])
        self.cache_len = int(traffic["cache_len"])
        self.device = torch.device(device)
        self.rows = kept_rows(seed, self.batch,
                              int(traffic["kept_sequences"]))
        self.n_slots = int(traffic["kept_steps"])
        self._rows_t = torch.as_tensor(self.rows, device=self.device)
        self._sample_rng = np.random.default_rng([int(seed), 1])
        self.annotate = False
        self.cache = None
        self.tok = None
        self.pos = 0
        self.served: List[np.ndarray] = []   # per position from the prompt's end
        self.slots = torch.empty((self.n_slots, len(self.rows), self.vocab),
                                 dtype=torch.float32, device=self.device)
        self.slot_pos: Dict[int, int] = {}

    # ------------------------------------------------------------ set-up
    def prefill(self, prompts) -> None:
        """The prompts through ``Model.prefill`` in groups, their caches
        joined into one; the first tokens from the last logits."""
        import torch
        b, s = prompts.shape
        group = int(self.traffic["prefill_group"])
        self.cache = self.model.init_cache(b, self.cache_len)
        first = torch.empty((b,), dtype=torch.long, device=self.device)
        for a in range(0, b, group):
            logits, part = self.model.prefill(
                {"tokens": prompts[a:a + group]}, cache_len=self.cache_len)
            for whole, got in zip(self.cache, part):
                for k, t in got["self"].items():
                    whole["self"][k][a:a + group].copy_(t)
            first[a:a + group] = logits[:, :self.vocab].argmax(-1)
            del logits, part
        self.tok, self.pos = first, s
        self.served.append(first.cpu().numpy())

    def warm(self) -> None:
        for _ in range(int(self.traffic["warmup_steps"])):
            _, tok, host = self._step()
            self._advance(tok, host)
        self._sync()

    def cache_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for c in self.cache
                   for t in c["self"].values())

    # ------------------------------------------------------------- steps
    def _sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self):
        """One decode step of the whole batch; its logits over the
        vocabulary and its tokens, copied to the host."""
        if self.pos >= self.cache_len:
            raise CacheFull(f"position {self.pos} would pass the cache's "
                            f"{self.cache_len} slots")
        logits, self.cache = self.model.decode(self.cache, self.tok,
                                               self.pos)
        logits = logits[:, :self.vocab]
        tok = logits.argmax(-1)
        return logits, tok, tok.cpu().numpy()

    def _advance(self, tok, host) -> None:
        self.tok = tok
        self.pos += 1
        self.served.append(host)

    def _range(self, name: str):
        if not self.annotate:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def window(self, seconds: float, stop_trace=None) -> Window:
        """Steps for ``seconds`` (``drive.Loop.window``'s contract: with
        ``stop_trace`` the profiler records the first ``TRACE_SECONDS``)."""
        run = _Run(time.monotonic())
        traced = 0
        if stop_trace is not None:
            self.annotate = True
            with self._range("spbench.window"):
                self._steps(run, min(TRACE_SECONDS, seconds))
                self._sync()
            self.annotate = False
            traced = run.i
            stop_trace()
            run.done = time.monotonic()
        resume = run.done
        self._steps(run, seconds)
        self._sync()
        samples = [(row, self.slot_pos[j], self.slots[j, n])
                   for j in sorted(self.slot_pos)
                   for n, row in enumerate(self.rows)]
        return Window(ops=run.i, failed=run.failed,
                      wall_s=run.done - run.t0, latencies_s=run.latencies,
                      execute_s=run.execute, samples=samples,
                      traced_ops=traced, untraced_s=run.done - resume,
                      error=run.error)

    def _steps(self, run: _Run, seconds: float) -> None:
        while run.error is None and run.done - run.t0 < seconds:
            ts = time.monotonic()
            try:
                with self._range("spbench.execute"):
                    logits, tok, host = self._step()
            except Exception as e:   # the window's boundary: record
                run.failed, run.error = 1, f"{type(e).__name__}: {e}"
                return
            due, run.done = run.done, time.monotonic()
            run.latencies.append(run.done - due)
            run.execute.append(run.done - ts)
            self._keep(run.i, logits)
            self._advance(tok, host)
            run.i += 1

    def _keep(self, i: int, logits) -> None:
        """Reservoir sampling (Vitter's algorithm R) over the window's
        steps: the kept sessions' logits into slot ``j``."""
        if i < self.n_slots:
            j = i
        else:
            j = int(self._sample_rng.integers(0, i + 1))
            if j >= self.n_slots:
                return
        self.slots[j].copy_(logits.index_select(0, self._rows_t))
        self.slot_pos[j] = self.pos

    def sequences(self, prompts) -> Dict[int, np.ndarray]:
        """Each kept session's ids: its prompt, then the tokens served."""
        served = np.stack(self.served, axis=1)
        host = prompts.cpu().numpy()
        return {r: np.concatenate([host[r], served[r]]) for r in self.rows}


def window_flops(m: Dict, batch: int, start: int, steps: int) -> float:
    """Model FLOPs of ``steps`` steps whose first input sits at ``start``."""
    return float(sum(batch * work.decode_token_flops(m, p + 1)
                     for p in range(start, start + steps)))


def reference_gaps(m: Dict, seed: int, samples, seqs: Dict, prompt_len: int,
                   device, control: bool = False) -> Dict[str, float]:
    """``logit_gap`` of ``samples`` ((row, position, logits)) and
    ``token_gap`` of every token served to the sessions ``seqs`` (their ids:
    the prompt, then the tokens served), against the reference; with
    ``control``, those of the float8 control's logits and of the tokens it
    puts first, at the same positions, instead."""
    rows = sorted(seqs)
    # the first token served comes from the prompt's last position
    asked = {r: list(range(prompt_len - 1, len(seqs[r]) - 1)) for r in rows}

    def by_position(ref):
        got = ref.logits([seqs[r] for r in rows], [asked[r] for r in rows])
        return {(r, p): paths for r, per in zip(rows, got)
                for p, paths in zip(asked[r], per)}

    refs = by_position(lm_reference.Reference(m, seed, device))
    served = [(r, p, int(seqs[r][p + 1])) for r in rows for p in asked[r]]
    if control:
        ctrl = by_position(lm_reference.Reference(
            m, seed, device, rounding=lm_reference.fp8_round, tie_margin=0))
        samples = [(r, p, ctrl[(r, p)][0]) for r, p, _ in samples]
        served = [(r, p, int(ctrl[(r, p)][0].argmax())) for r, p, _ in served]
    return {"logit_gap": lm_reference.logit_gap(samples, refs),
            "token_gap": lm_reference.token_gap(served, refs)}


def serve(cell, seed: int, device, t0: float, log=print):
    """Set-up: the model with the benchmark's weights, the prompts'
    prefill and the warm-up steps. Returns (server, prompts, prefill
    seconds)."""
    from repro_torch.models.model import Model
    m, tr = cell.config["model"], cell.traffic
    cfg = port_config(cell.config)
    model = Model(cfg, device=device)
    load_weights(model, m, seed, device)
    prompts = lm_weights.prompts(seed, int(tr["batch"]),
                                 int(tr["prompt_len"]), int(m["vocab_size"]),
                                 device)
    server = Server(model, tr, m, seed, device)
    t = time.monotonic()
    server.prefill(prompts)
    server._sync()
    prefill_s = time.monotonic() - t
    server.warm()
    log(json.dumps({"model": cell.config["name"], "layers": cfg.n_layers,
                    "layer_pattern": list(cfg.layer_pattern),
                    "param_dtype": cfg.param_dtype,
                    "capacity_factor": cfg.capacity_factor,
                    "batch": server.batch, "prompt_len": int(tr["prompt_len"]),
                    "cache_len": server.cache_len, "kept_rows": server.rows,
                    "prefill_s": prefill_s,
                    "to_setup_end_s": time.monotonic() - t0}), flush=True)
    return server, prompts, prefill_s


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             t0: Optional[float] = None, log=print):
    """Set up, warm up, decode for ``seconds``, read, free the program,
    then check the kept logits against the reference."""
    import torch
    t0 = time.monotonic() if t0 is None else t0
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = cell.config["model"]
    server, prompts, prefill_s = serve(cell, seed, device, t0, log)
    start = server.pos
    setup_s = time.monotonic() - t0

    tl = None
    if trace:
        win, _, tl = harness._traced_window(server, seconds, device)
    else:
        win = server.window(seconds)
    peak = (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else None)
    ctx = Context(batch=server.batch, window=win, setup_s=setup_s,
                  prefill_s=prefill_s, kv_cache_bytes=server.cache_bytes(),
                  window_flops=window_flops(m, server.batch, start, win.ops),
                  memory_peak_bytes=peak, timeline=tl)
    metrics = harness.read_metrics(cell, ctx, trace)

    # the program's state goes before the reference runs on the card
    seqs = server.sequences(prompts)
    server.model = server.cache = None
    del server, prompts
    harness.free_cuda()
    gaps = reference_gaps(m, seed, win.samples, seqs,
                          int(cell.traffic["prompt_len"]), device)
    steps = len(win.samples) // max(len(seqs), 1)
    correct, checks = lm_reference.judge(gaps, steps, cell.limits, win.ops,
                                         win.failed)
    return harness.Outcome(pick={"model": cell.config["name"]},
                           correct=correct, checks=checks, context=ctx,
                           metrics=metrics)


def readings(cell, seeds, seconds: float, device="cuda", log=print):
    """Per seed: the program's ``logit_gap`` and ``token_gap`` over a
    window at the cell's own load (the lower readings), and the control's,
    the reference in float8 on the same prompts and served tokens (the
    upper)."""
    import torch
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = cell.config["model"]
    out = []
    for seed in seeds:
        server, prompts, _ = serve(cell, seed, device, time.monotonic(),
                                   log=lambda *a, **k: None)
        win = server.window(seconds)
        seqs = server.sequences(prompts)
        server.model = server.cache = None
        del server, prompts
        harness.free_cuda()
        plen = int(cell.traffic["prompt_len"])
        prog = reference_gaps(m, seed, win.samples, seqs, plen, device)
        ctrl = reference_gaps(m, seed, win.samples, seqs, plen, device,
                              control=True)
        row = {"seed": seed, "steps": win.ops,
               "positions": len(win.samples),
               "program": {k: prog[k] for k in ("logit_gap", "token_gap")},
               "control": {k: ctrl[k] for k in ("logit_gap", "token_gap")},
               "failed": win.failed}
        log(json.dumps(row), flush=True)
        out.append(row)
        del win
        harness.free_cuda()
    return out
