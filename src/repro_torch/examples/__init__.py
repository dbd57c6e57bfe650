"""Runnable examples of the port (``python -m repro_torch.examples.<name>``):
``quickstart`` (the characterization loop end to end, then a tuner-picked
SpMV on the card) and ``characterize`` (one matrix's metrics, modeled
forecasts and schedule picks, or ``--serve N`` through the selector
service), ``serve_lm`` (a reduced LM served, then the MoE and
multi-RHS SpMM decode paths) and ``train_lm`` (a ~100M llama trained with
checkpoints and simulated preemptions)."""
