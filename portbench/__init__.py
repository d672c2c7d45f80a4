"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on NVIDIA H100s.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once (see :mod:`portbench.run`).  The cells,
mixes, configurations and per-layer metrics are data and small files under
this directory, found by the names ``BENCHMARK.json`` gives
(:mod:`portbench.harness`)."""
