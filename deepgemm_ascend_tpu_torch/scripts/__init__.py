"""The port's measurement entry points, each a twin of a JAX script:

* ``straggler_probe`` — the dispatch floor through P0, and the probe rows
  (``scripts/straggler_probe.py``);
* ``profile_kernel`` — one GEMM, timed, optionally checked and traced
  (``scripts/profile_kernel.py``);
* ``headline`` — the fp8 4096³ headline number (the root ``bench.py``);
* ``serve_bench`` — decode tokens/s of the model and the engine
  (``scripts/serve_bench.py``);
* ``layer_bench`` — one full-size MoE decoder layer
  (``scripts/layer_bench.py``).

Each runs as ``python -m deepgemm_ascend_tpu_torch.scripts.<name> ...``,
on ``cuda`` unless given ``--device cpu``, and has ``main(argv)`` for a
caller in the same process (``chip_smoke.py`` phase 7, the tests).
"""
