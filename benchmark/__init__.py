"""The benchmark of ``deepgemm_ascend_tpu_torch`` on one H100: run a cell as
``python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` from the repository's root (``BENCHMARK.json`` names the
cells; ``registry.py`` says where each part lives)."""
