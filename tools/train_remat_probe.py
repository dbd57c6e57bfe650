"""One llama3.2-3b train step (4 x 512 tokens, 2 microbatches, attention
chunk 256) on the card under each remat policy, split into its forwards,
backwards and AdamW (``chip_smoke.step_split``), with peak memory; each
policy twice, in turns. Needs one CUDA card.

    PYTHONPATH=src python3 tools/train_remat_probe.py
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

POLICIES = ("full", "dots_no_batch", "none")


def main() -> int:
    if not torch.cuda.is_available():
        print("train_remat_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cfg = get_config("llama3.2-3b")
    model = Model(cfg, device="cuda").init(seed=0)
    opt = AdamW(model.parameters(), learning_rate=1e-5)
    batch = cs.train_batch(cfg, 4, 512, 0, "cuda")
    for remat in POLICIES + POLICIES:
        torch.cuda.reset_peak_memory_stats()
        step = make_train_step(model, opt, remat=remat, attn_chunk=256,
                               microbatches=2)
        split = cs.step_split(step, model, opt, batch, "cuda")
        cs.emit({"remat_probe": {
            "remat": remat, **split,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "card": card}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
