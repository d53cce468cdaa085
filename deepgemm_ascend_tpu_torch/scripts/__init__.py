"""The port's measurement entry points, each a twin of a JAX script:

* ``straggler_probe`` — the dispatch floor through P0, and the probe rows
  (``scripts/straggler_probe.py``);
* ``profile_kernel`` — one GEMM, timed, optionally checked and traced
  (``scripts/profile_kernel.py``);
* ``headline`` — the fp8 4096³ headline number (the root ``bench.py``);
* ``serve_bench`` — decode tokens/s of the model and the engine
  (``scripts/serve_bench.py``);
* ``layer_bench`` — one full-size MoE decoder layer
  (``scripts/layer_bench.py``);
* ``eval_quality`` — kernel fidelity at full depth against ``exact_mode``
  (``scripts/eval_quality.py``);
* ``gen_golden``, ``verify_output``, ``torch_matmul`` — golden GEMM files,
  their check, and the ``torch.matmul`` cross-check (``scripts/
  gen_golden.py``, ``verify_output.py``, ``xla_matmul.py``);
* ``prefix_spread`` (no JAX twin) — the prefix cache's warm vs cold
  first-token logits over system prompts from several seeds, the spread
  that ``chip_smoke.py`` phase 4's prefix bound must cover.

Each runs as ``python -m deepgemm_ascend_tpu_torch.scripts.<name> ...``,
on ``cuda`` unless given ``--device cpu`` (``gen_golden`` and
``verify_output`` touch no device), and has ``main(argv)`` for a caller in
the same process (``chip_smoke.py`` phases 7 and 9, the tests).
"""
