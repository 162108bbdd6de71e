"""portbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once on an NVIDIA card.  Everything a cell
needs is found by name: ``workloads/<cell>.json`` names its configuration
(``configs/<config>.json``, built by ``families/<family>.py`` and checked
against ``reference/<family>.py``) and its traffic kind
(``traffic/<kind>.py``); ``BENCHMARK.json`` at the root lists the metrics,
each per-layer metric read by ``metrics/<metric>.py``.

Nothing here imports ``jax`` or the JAX package ``repro``; the reference
imports nothing of ``repro_torch`` either.
"""
