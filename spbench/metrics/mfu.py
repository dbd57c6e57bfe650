"""mfu: the whole decode step's share of the card's bf16 peak, in percent:
the window's model FLOPs (``spbench.work.decode_token_flops`` for every
token generated, from the configuration's sizes alone) over its wall time
(host clock) times ``peaks.BF16_FLOP_PER_S``."""
from spbench import peaks


def read(ctx):
    w = ctx.window
    flops = getattr(ctx, "window_flops", None)
    if not flops or not w.ops or w.wall_s <= 0:
        return None
    return 100.0 * flops / (w.wall_s * peaks.BF16_FLOP_PER_S)
