"""The benchmark of ``tpusort_torch`` on one NVIDIA H100.

``portbench/run.py`` runs one cell of ``BENCHMARK.json`` once and prints
one JSON line.  Everything that belongs to one configuration, traffic mix
or metric is a file of its own, found by the name ``BENCHMARK.json`` gives:
``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py``;
a configuration's ``entry`` names ``entries/<entry>.py``, which makes the
inputs, calls the program and checks its outputs against
``reference.py``.  Nothing here imports ``jax`` or the JAX package
``tpusort``; ``reference.py`` and ``datagen.py`` import nothing of
``tpusort_torch`` either.
"""
