"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on an H100.

One run is ``python -m spbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. The cells, the metrics and
their bounds are listed in ``BENCHMARK.json`` at that root; everything
that belongs to one configuration, traffic mix or metric is a file of its
own here, found by its name:

- ``configs/<config>.json``: the deployment (matrix generator and sizes,
  precision, the selector's settings), with its source and its cuts;
- ``gen/<generator>.py``: frozen copies of the matrix generators;
- ``traffic/<mix>.json``: the parameters that the one traffic loop
  (``drive.py``) reads;
- ``limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from;
- ``metrics/<metric>.py``: one reader per metric; a quantity split by
  the cells that report it (``useful_gflop_s.spmv``, ``useful_gflop_s.spmm``,
  each with its own bound) shares the reader of its base name;
- ``drivers/<driver>.py``: the run of a configuration whose file names
  that driver (``lm_decode``: a served model's decode loop); a
  configuration without one runs through ``harness.run_cell``.

The yardstick (the plain references, ``reference.py`` and
``lm_reference.py``, the weights a model cell draws, the work a product or
a token needs, the H100's peaks, the reading of the profiler's trace)
lives here too, so that a change to the program cannot move it. Nothing
here imports JAX or the JAX package ``repro``.
"""
