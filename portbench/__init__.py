"""The benchmark of pggan-tpu's PyTorch port (``pggan_tpu_torch``) on one
NVIDIA H100: ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once (``BENCHMARK.json``
lists the cells and metrics); ``python3 -m portbench.study`` reads the
numbers behind each limit of ``correct``; ``python -m pytest
portbench/tests`` holds the harness on the CPU.
"""
