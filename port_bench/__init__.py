"""The benchmark of ocean_model_arch_torch: ``python port_bench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` (README.md)."""
