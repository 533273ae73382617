"""The serving benchmark of the PyTorch / CUDA port (``repro_torch``).

``python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the CUDA device it
is started on and prints one JSON result line.  Everything that belongs to
one configuration, traffic mix, check, model family or per-layer metric is
a file of its own under this directory, found by its name.
"""
