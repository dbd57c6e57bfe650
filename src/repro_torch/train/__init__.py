"""Training and serving steps of the LM substrate (port of
``repro.train``): the train step, checkpointing, fault tolerance, and the
prefill / decode steps."""
from .checkpoint import CheckpointManager  # noqa: F401
from .serve_step import make_decode_step, make_prefill_step  # noqa: F401
from .train_step import TrainState, make_train_step  # noqa: F401
