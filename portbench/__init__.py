"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One run serves one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) for ``--seconds``, from weights and prompts drawn from
``--seed``, and prints one JSON line::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, metric or model
family sits in a file of its own, found by its name:

* ``configs/<config>.json``: the stages' model configurations as run, and
  how their random weights are drawn;
* ``traffic/<traffic>.json``: the mix (burst size, length distributions),
  the stages' slots, the cascade's threshold and the cell's limits;
* ``metrics/<metric>.py``: one reader per metric, ``read(record)``;
* ``reference/<family>.py``: a plain float32 forward of one model family,
  which imports nothing of the port.

The rest is the yardstick shared by every cell: the traffic generator
(``traffic.py``), the weights (``weights.py``), the counting of operations
and bytes (``counting.py``), the spans around the port's calls
(``recorder.py``), the profiler slices (``trace.py``) and the comparison
that decides ``correct`` (``check.py``). Nothing here imports ``jax`` or the
JAX package.
"""
