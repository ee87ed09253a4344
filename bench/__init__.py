"""The benchmark of ``repro_torch``, the PyTorch/CUDA port, on NVIDIA H100s.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once, from the root of
a checkout. Everything that belongs to one configuration, traffic mix,
per-layer metric or cell sits in a file of its own that the harness finds
by its name: ``configs/<config>.json`` (the sizes as run) beside
``configs/<config>.py`` (its weights, its plain fp32 reference and its
counts of operations and bytes), ``traffic/<traffic>.json``,
``metrics/<metric>.py`` and ``limits/<cell>.json``.

Nothing here imports ``jax`` or the JAX package; the references import
nothing of ``repro_torch`` either.
"""
