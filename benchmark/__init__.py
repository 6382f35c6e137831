"""The benchmark of ``csts_torch`` on one CUDA card; ``python3 benchmark/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` from the checkout's root."""
