"""The plain reference of a served mixture-of-experts decoder, and the
comparison that decides ``correct`` in a model cell.

The reference is the published model's full causal forward pass over a
sequence (its prompt and the tokens the program served), in plain
PyTorch and float32 with TF32 off: no cache, no batching, no kernel.
Per layer, as Mixtral of Experts (arXiv:2401.04088) writes it:

- ``h = RMSNorm(x)``; q, k, v = h Wq, h Wk, h Wv; rotary positions on q
  and k (the halves of each head rotated, theta from the configuration);
  causal softmax attention, each key-value head shared by ``H / KV``
  query heads; ``x += out Wo``;
- ``h = RMSNorm(x)``; the router's softmax over all experts, the top
  ``k`` kept and renormalised; each expert's SwiGLU ``(silu(h Wg) * h Wu)
  Wd`` on the tokens routed to it, weighted by its gate; ``x += ``
  their sum;
- at the end ``RMSNorm`` and the output head, at the positions asked for.

The weights are the benchmark's own (``lm_weights``: the served type's
values, upcast), drawn again layer by layer so that one layer's float32
copy is held at a time. It imports nothing of the program.

The control is the same forward pass with both operands of every matrix
product rounded to ``float8_e4m3fn`` under a per-tensor scale (the
operand's largest magnitude mapped to 448), the step below the served
bfloat16 that a later change might take.

``logit_gap``: at each kept position, the largest difference between the
program's logits and the reference's over the vocabulary, over the root
mean square of the reference's logits there; the widest over the kept
positions. ``token_gap``: at every position whose token was served, how
far the served token's logit lies below the reference's best there, over
the same root mean square; the widest over the served tokens. It judges
every step's output, where ``logit_gap`` judges a sample of steps: a token
altered where it is produced reaches the next step's context, which the
reference reads too, so only the token's own position shows it. Where a
layer's router puts two experts within ``TIE_MARGIN`` of each other at the
top-k boundary, rounding decides which one a program takes, and the two
choices give logits that differ by the size of the logits themselves: the
reference follows both, and a position reads its gap to the nearest of its
paths. A position whose logits have the wrong shape or are not finite, or
whose token lies outside the vocabulary, reads infinity.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import lm_weights

QUERY_BLOCK = 256           # query rows of the attention per block
FP8_MAX = 448.0             # the largest finite float8_e4m3fn
TIE_MARGIN = 0.02           # router probabilities this close: both routings
MAX_PATHS = 64              # paths followed per position asked for


def fp8_round(t):
    """``t`` rounded to float8_e4m3fn under a per-tensor scale, in float32."""
    import torch
    amax = float(t.abs().amax()) if t.numel() else 0.0
    if amax == 0.0 or not math.isfinite(amax):
        return t
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    """The forward pass of configuration ``model`` (the sizes of its file)
    with the weights of ``seed``; ``rounding`` is applied to each operand of
    every product (None: plain float32).

    ``tie_margin``: where, at a position asked for, a layer's router gives
    its ``k``-th and ``k+1``-th expert probabilities closer than this, the
    routings that rounding can reach are all the model's (a program in
    bfloat16 may take any of them), and the position's path is followed
    down each: a branch goes on from that layer with its own top-k set
    (``_branch``), its own query, key and value meeting the other
    positions' keys and values. Each position then has one set of logits
    per path (at most ``MAX_PATHS``); 0 follows the reference's own routing
    only."""

    def __init__(self, model: Dict, seed: int, device,
                 rounding: Optional[Callable] = None,
                 tie_margin: float = TIE_MARGIN) -> None:
        import torch
        self.m = model
        self.seed = seed
        self.device = torch.device(device)
        self.round = rounding or (lambda t: t)
        self.tie_margin = tie_margin

    def _mm(self, a, b):
        return self.round(a) @ self.round(b)

    def _norm(self, x, scale):
        import torch
        var = (x * x).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.m["rms_norm_eps"]) * scale

    def _angles(self, pos):
        """cos and sin of the rotary angles at positions ``pos`` (n,), each
        (n, 1, D / 2): position / theta^(2i / D)."""
        import torch
        half = self.m["d_head"] // 2
        inv = self.m["rope_theta"] ** (
            -torch.arange(half, dtype=torch.float64, device=pos.device)
            / half)
        ang = pos.double()[:, None] * inv[None, :]
        return torch.cos(ang).float()[:, None, :], \
            torch.sin(ang).float()[:, None, :]

    def _rope(self, x, pos):
        """Rotary positions on (n, heads, D): each head's halves rotated."""
        import torch
        cos, sin = self._angles(pos)
        half = x.shape[-1] // 2
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def _qkv(self, h, w, pos):
        m = self.m
        n = h.shape[0]
        nh, kv, dh = m["n_heads"], m["n_kv_heads"], m["d_head"]
        q = self._rope(self._mm(h, w["wq"]).view(n, nh, dh), pos)
        k = self._rope(self._mm(h, w["wk"]).view(n, kv, dh), pos)
        v = self._mm(h, w["wv"]).view(n, kv, dh)
        rep = nh // kv
        return (q / math.sqrt(dh), k.repeat_interleave(rep, dim=1),
                v.repeat_interleave(rep, dim=1))

    def _attention(self, h, w):
        """Causal attention of every position; also its keys and values
        (T, H, D), each key-value head repeated for its query heads."""
        import torch
        t = h.shape[0]
        keys = torch.arange(t, device=h.device)
        q, k, v = self._qkv(h, w, keys)
        q, kt, vt = q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1)
        out = torch.empty_like(q)                             # (H, T, D)
        for a in range(0, t, QUERY_BLOCK):
            b = min(a + QUERY_BLOCK, t)
            s = self._mm(q[:, a:b], kt[:, :b].transpose(1, 2))  # (H, q, b)
            causal = keys[None, :b] <= keys[a:b, None]
            s = s.masked_fill(~causal[None], float("-inf"))
            out[:, a:b] = self._mm(torch.softmax(s, dim=-1), vt[:, :b])
        return self._out(out.transpose(0, 1), w), k, v

    def _out(self, o, w):
        return self._mm(o.reshape(o.shape[0], -1), w["wo"])

    def _attend_paths(self, h, pos, w, k, v):
        """Attention of path states ``h`` (n, d) at positions ``pos`` (n,):
        each query meets the keys and values ``k``, ``v`` of the positions
        before its own, and its own."""
        import torch
        q, k_own, v_own = self._qkv(h, w, pos)                 # (n, H, D)
        s = torch.einsum("nhd,thd->nht", self.round(q), self.round(k))
        before = torch.arange(k.shape[0], device=h.device)[None, :] \
            < pos[:, None]
        s = s.masked_fill(~before[:, None, :], float("-inf"))
        own = (self.round(q) * self.round(k_own)).sum(-1, keepdim=True)
        p = torch.softmax(torch.cat([s, own], -1), dim=-1)
        out = torch.einsum("nht,thd->nhd", self.round(p[..., :-1]),
                           self.round(v)) \
            + self.round(p[..., -1:]) * self.round(v_own)
        return self._out(out, w)

    def _routes(self, h, w):
        """(probabilities (T, E), the top-k experts (T, k) and their
        renormalised gates (T, k))."""
        import torch
        probs = torch.softmax(self._mm(h, w["router"]), dim=-1)
        vals, idx = torch.topk(probs, self.m["top_k"], dim=-1)
        return probs, idx, vals / vals.sum(-1, keepdim=True)

    def _experts(self, h, w, idx, gates):
        """Each row's experts ``idx`` (T, k), weighted by ``gates``."""
        import torch
        y = torch.zeros_like(h)
        for e in range(self.m["n_experts"]):
            chosen = idx == e                                   # (T, k)
            rows = chosen.any(-1).nonzero()[:, 0]
            if not rows.numel():
                continue
            gate = (gates * chosen)[rows].sum(-1, keepdim=True)
            he = h[rows]
            act = torch.nn.functional.silu(self._mm(he, w["w_gate"][e])) \
                * self._mm(he, w["w_up"][e])
            y.index_add_(0, rows, gate * self._mm(act, w["w_down"][e]))
        return y

    def _branch(self, probs, idx, gates, owner):
        """The paths' routings: each path's own, and where its ``k``-th and
        ``k+1``-th probabilities lie within ``tie_margin``, one more path
        for each other top-k set that moves by less than the margin can
        give: the experts above the boundary by less than it may drop out,
        those below it by less than it may come in, three or more of them
        where they lie that close together (while its position has fewer
        than ``MAX_PATHS``). Returns (parent of each path, idx, gates)."""
        import itertools
        import torch
        k = self.m["top_k"]
        parent = list(range(idx.shape[0]))
        if self.tie_margin <= 0 or k >= probs.shape[1]:
            return parent, idx, gates
        srt, order = torch.sort(probs, dim=-1, descending=True)
        near = (srt[:, k - 1] - srt[:, k]) < self.tie_margin
        count: Dict[int, int] = {}
        for o in owner:
            count[o] = count.get(o, 0) + 1
        extra_idx, extra_gates = [], []
        for n in near.nonzero()[:, 0].tolist():
            row = srt[n].tolist()
            # ranks that may cross the boundary, and the sure ones above it
            loose = [j for j in range(len(row))
                     if (j < k and row[j] - row[k] < self.tie_margin)
                     or (j >= k and row[k - 1] - row[j] < self.tie_margin)]
            sure = [j for j in range(k) if j not in loose]
            for pick in itertools.combinations(loose, k - len(sure)):
                if set(pick) == set(range(k)) - set(sure):
                    continue                       # the path's own routing
                if count[owner[n]] >= MAX_PATHS:
                    break
                count[owner[n]] += 1
                alt = order[n, sorted(sure + list(pick))]
                g = probs[n, alt]
                parent.append(n)
                extra_idx.append(alt)
                extra_gates.append(g / g.sum())
        if not extra_idx:
            return parent, idx, gates
        return (parent, torch.cat([idx, torch.stack(extra_idx)]),
                torch.cat([gates, torch.stack(extra_gates)]))

    def logits(self, seqs: Sequence, positions: Sequence[Sequence[int]]
               ) -> List[List[List]]:
        """For each sequence, for each of its ``positions``, the list of its
        paths' logits (V,), float32; a sequence is run as far as its last
        position."""
        import torch
        m = self.m
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            out = lm_weights.outer(m, self.seed, self.device)
            xs, paths = [], []
            for ids, pos in zip(seqs, positions):
                ids = torch.as_tensor(ids[:max(pos) + 1], device=self.device)
                xs.append(out["embed"][ids].float())
                at = torch.as_tensor(list(pos), device=self.device)
                # one path per position asked for: (its index in ``pos``,
                # its position, its state)
                paths.append((list(range(len(pos))), at, xs[-1][at]))
            del out
            for i in range(m["n_layers"]):
                w = {k: v.float() for k, v in
                     lm_weights.layer(m, self.seed, i, self.device).items()}
                for j, x in enumerate(xs):
                    xs[j], paths[j] = self._layer(x, paths[j], w)
                del w
            out = {k: v.float() for k, v in
                   lm_weights.outer(m, self.seed, self.device).items()
                   if k != "embed"}
            res = []
            for (owner, _, state), pos in zip(paths, positions):
                lg = self._mm(self._norm(state, out["final_norm"]),
                              out["unembed"])
                per = [[] for _ in pos]
                for n, o in enumerate(owner):
                    per[o].append(lg[n])
                res.append(per)
            return res
        finally:
            torch.backends.cuda.matmul.allow_tf32, \
                torch.backends.cudnn.allow_tf32 = prev

    def _layer(self, x, paths, w):
        """One layer over a sequence ``x`` (T, d) and its paths."""
        a, k, v = self._attention(self._norm(x, w["attn_norm"]), w)
        x = x + a
        del a
        h = self._norm(x, w["ffn_norm"])
        _, idx, gates = self._routes(h, w)
        x = x + self._experts(h, w, idx, gates)
        owner, pos, state = paths
        state = state + self._attend_paths(
            self._norm(state, w["attn_norm"]), pos, w, k, v)
        h = self._norm(state, w["ffn_norm"])
        probs, idx, gates = self._routes(h, w)
        parent, idx, gates = self._branch(probs, idx, gates, owner)
        state, h = state[parent], h[parent]
        state = state + self._experts(h, w, idx, gates)
        return x, ([owner[n] for n in parent], pos[parent], state)


def position_gap(got, refs) -> float:
    """The gap of one position's logits against the nearest of its paths'
    (see above)."""
    import torch
    gap = math.inf
    for ref in refs:
        if got is None or tuple(got.shape) != tuple(ref.shape):
            continue
        diff = (got.to(ref.device, torch.float32) - ref).abs()
        rms = float(ref.pow(2).mean().sqrt())
        if bool(torch.isfinite(diff).all()) and rms > 0:
            gap = min(gap, float(diff.max()) / rms)
    return gap


def logit_gap(samples: Sequence[Tuple], refs: Dict) -> float:
    """The widest gap over ``samples`` ((row, position, logits) triples)
    against the paths' logits ``refs[(row, position)]``."""
    gap = 0.0
    for row, pos, got in samples:
        gap = max(gap, position_gap(got, refs[(row, pos)]))
    return gap


def token_gap(served: Sequence[Tuple], refs: Dict) -> float:
    """The widest gap over ``served`` ((row, position, token) triples: the
    token served from that position's logits) against the paths' logits
    ``refs[(row, position)]``: the reference's best logit less the token's,
    over the root mean square, to the nearest path."""
    gap = 0.0
    for row, pos, tok in served:
        near = math.inf
        for ref in refs[(row, pos)]:
            rms = float(ref.pow(2).mean().sqrt())
            if 0 <= tok < ref.shape[0] and rms > 0:
                near = min(near, float(ref.max() - ref[tok]) / rms)
        gap = max(gap, near)
    return gap


def judge(gaps: Dict, steps: int, limits: Dict, ops: int,
          failed: int) -> Tuple[bool, Dict]:
    """``correct`` and each number compared beside its limit; ``gaps`` holds
    ``logit_gap`` and ``token_gap``."""
    checks = {name: {"value": gaps[name], "limit": limits[name]}
              for name in ("logit_gap", "token_gap")}
    checks["steps_checked"] = {"value": steps, "limit": limits["min_steps"]}
    checks["failed_steps"] = {"value": failed, "limit": 0}
    correct = (all(c["value"] <= c["limit"] for c in
                   (checks["logit_gap"], checks["token_gap"]))
               and steps >= limits["min_steps"] and failed == 0 and ops > 0)
    return correct, checks
