"""The port's measurement scripts, run in process on the CPU at small sizes.

Each script's ``main([... "--device", "cpu"])`` — or, where its shapes are
fixed at full size (the probe's rows, the headline), the function the CLI
calls with those shapes — runs the plain path and prints its line with the
JAX script's keys. No number printed here is a device measurement; the
tests check the lines' form and the counts of kernels reached (plain
versions on the CPU); ``serve_bench --mode scaling`` runs its ranks in
spawned gloo groups. The golden, verify and quality scripts are held
against the JAX scripts' files, exit codes and keys.
"""

import json

import pytest
import torch

from deepgemm_ascend_tpu_torch.ops import _kernels
from deepgemm_ascend_tpu_torch.scripts import (decode_sweep, headline,
                                               k8_ablation,
                                               k12_fold_ablation,
                                               ksplit_sweep, layer_bench,
                                               phase2_ab, prefill_sweep,
                                               profile_kernel, ring_sweep,
                                               serve_bench, straggler_probe)

CPU = ["--device", "cpu"]
T_KW = dict(iters=2, repeats=1, min_chain_seconds=0.0)


def _json_lines(out: str):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def _plain_calls():
    return {n: c.plain_calls for n, c in _kernels.COUNTERS.items()
            if c.plain_calls}


def test_probe_dispatch_floor_on_cpu(capsys):
    _kernels.reset_counters()
    floor = straggler_probe.dispatch_floor(torch.device("cpu"), 5, T_KW)
    assert set(floor) == {"cpu_chain_us", "host_us"}
    assert all(v > 0 for v in floor.values())
    assert "[probe] dispatch floor (P0" in capsys.readouterr().out
    assert set(_plain_calls()) == {"copy_probe"}
    assert _kernels.COUNTERS["copy_probe"].launches == 0
    assert _kernels.COUNTERS["copy_probe"].bare_launches == 0


@pytest.mark.parametrize("row", straggler_probe.ROWS)
def test_probe_rows_at_small_shapes(row, capsys):
    cpu = torch.device("cpu")
    _kernels.reset_counters()
    if row == "fp8small":
        res = straggler_probe.row_fp8small(16, 256, 256, cpu, T_KW)
        want = {"fp8_gemm", "fp8_gemm_folded"}
    elif row == "masked":
        res = straggler_probe.row_masked(2, 32, 256, 256, cpu, T_KW)
        want = {"grouped_gemm", "grouped_gemm_contiguous"}
    elif row == "primes":
        res = straggler_probe.row_primes(((33, 97, 300),), cpu, T_KW)
        want = {"gemm"}
    else:
        res = straggler_probe.row_bf16cube(128, cpu, T_KW)
        want = {"gemm"}
    out = capsys.readouterr().out
    assert set(_plain_calls()) == want
    timed = [r for r in res if "us" in r]
    assert timed and all(r["us"] > 0 and r["pct_ls"] > 0 for r in timed)
    na = [r for r in res if "na" in r]
    assert all(r["tag"] in out for r in res)
    if row == "masked":          # JAX's six Pallas blocks; K3's own tiles
        assert len(na) == 6 and all(r["na"] == straggler_probe.TPU_BLOCK
                                    for r in na)
        assert {r["tag"] for r in timed} >= {"K3 ring 16x64",
                                             "K3 ring 64x64"}
    else:                        # the kernels' compiled variants now run
        assert not na
    if row in ("fp8small", "bf16cube"):
        assert any(r["tag"].startswith(("K1 variant", "variant"))
                   for r in timed)
        assert any("XLA family" in r["tag"] for r in timed)


@pytest.mark.parametrize("op", ["fp8_gemm", "gemm"])
def test_profile_kernel_main(op, tmp_path, capsys):
    argv = ["--op", op, "-m", "64", "-n", "256", "-k", "256", "--check",
            "--iters", "2", "--min-chain", "0", "--trace-dir",
            str(tmp_path)] + CPU
    assert profile_kernel.main(argv) == 0
    out = capsys.readouterr().out
    assert "[profile] correctness: ok=True" in out
    assert f"[profile] {op} 64x256x256 cfg=auto:" in out
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_headline_line_at_small_size():
    line = headline.run(256, "cpu", iters=2)
    assert set(line) >= {"metric", "value", "unit", "vs_baseline"}
    # value is rounded to 0.01 TFLOP/s, as in bench.py: 0.0 on a slow CPU.
    assert line["metric"] == "fp8_gemm_256_tflops" and line["value"] >= 0
    assert "error" not in line and line["unit"] == "TFLOP/s"


SERVE = ["--model", "tiny", "--batch", "2", "--steps", "4"] + CPU


@pytest.mark.parametrize("mode,quant,keys", [
    ("scan", "fp8", {"metric", "mode", "expert_quant", "model", "batch",
                     "steps", "max_seq", "flash_decode", "tokens_per_s",
                     "ms_per_step"}),
    ("scan", "int8", {"tokens_per_s", "ms_per_step"}),
    ("engine", "fp8", {"metric", "mode", "expert_quant", "speculative_k",
                       "spec_drafting", "spec_accept_rate", "model", "slots",
                       "decode_chunk", "tokens_per_s", "decode_steps"}),
    ("mixed", "fp8", {"metric", "mode", "model", "slots", "requests",
                      "decode_chunk", "tokens_per_s_wall", "prefills",
                      "prefill_dispatches"})])
def test_serve_bench_modes(mode, quant, keys, capsys):
    _kernels.reset_counters()
    assert serve_bench.main(["--mode", mode, "--expert-quant", quant]
                            + SERVE) == 0
    (line,) = _json_lines(capsys.readouterr().out)
    assert keys <= set(line) and line["mode"] == mode
    rate = line.get("tokens_per_s", line.get("tokens_per_s_wall"))
    assert rate > 0
    experts = "int8_grouped_masked" if quant == "int8" else "grouped_gemm"
    assert experts in _plain_calls()


@pytest.mark.parametrize("argv", [["--mode", "scaling"]])
def test_serve_bench_unported_modes_raise(argv, capsys):
    """The mode that raised before the sharded slice now runs: --mode
    scaling times the sharded decode step at one rank and at two, in
    spawned gloo groups on the CPU, with the JAX script's keys, and says
    which backend ran and that it is not a scaling figure."""
    assert serve_bench.main(argv + ["--devices", "2"] + SERVE) == 0
    (line,) = _json_lines(capsys.readouterr().out)
    assert {"metric", "mode", "devices", "backend", "tokens_per_s_1dev",
            "tokens_per_s_ndev", "efficiency", "note"} <= set(line)
    assert line["mode"] == "scaling" and line["devices"] == 2
    assert line["backend"] == "gloo-cpu" and "not a scaling" in line["note"]
    assert line["tokens_per_s_1dev"] > 0 and line["tokens_per_s_ndev"] > 0


def test_serve_bench_chunksweep(capsys):
    """One line a chunk of serve_bench.CHUNKS; utilization ≤ 1, and 1 at
    chunk 1 (no wasted step)."""
    assert serve_bench.main(["--mode", "chunksweep"] + SERVE) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert [ln["decode_chunk"] for ln in lines] == list(serve_bench.CHUNKS)
    for ln in lines:
        assert {"metric", "mode", "expert_quant", "model", "slots",
                "decode_chunk", "tokens_per_s_decode", "tokens_per_s_wall",
                "utilization", "decode_steps", "graph_capture_s"} <= set(ln)
        assert 0 < ln["utilization"] <= 1 and ln["graph_capture_s"] == 0
    assert lines[0]["utilization"] == 1


def test_serve_bench_prefix(capsys):
    """Two requests share a 32-token system prompt (--max-seq 64): the warm
    wave hits the stored prefix for both."""
    assert serve_bench.main(["--mode", "prefix", "--max-seq", "64"]
                            + SERVE) == 0
    (line,) = _json_lines(capsys.readouterr().out)
    assert {"metric", "mode", "model", "requests", "system_tokens",
            "cold_admission_s", "warm_admission_s", "speedup",
            "prefix_hits", "tokens_reused"} <= set(line)
    assert (line["requests"], line["system_tokens"]) == (2, 32)
    assert (line["prefix_hits"], line["tokens_reused"]) == (2, 64)


@pytest.mark.parametrize("oracle", [False, True])
def test_serve_bench_speculative(oracle, capsys):
    """Engine mode with --speculative-k 2: the drafting and its accept
    rate; the oracle drafts a speculative engine's own recording, so every
    draft lands."""
    argv = ["--mode", "engine", "--speculative-k", "2"] + SERVE
    assert serve_bench.main(argv + (["--spec-oracle"] if oracle else [])) == 0
    (line,) = _json_lines(capsys.readouterr().out)
    assert line["speculative_k"] == 2 and line["tokens_per_s"] > 0
    assert line["spec_drafting"] == ("oracle" if oracle else "prompt_lookup")
    assert 0 <= line["spec_accept_rate"] <= 1
    if oracle:
        assert line["spec_accept_rate"] == 1


@pytest.mark.parametrize("quant", ["fp8", "int8"])
def test_layer_bench_main(quant, capsys):
    _kernels.reset_counters()
    assert layer_bench.main(["--configs", "tiny:1", "tiny:2", "--batch", "4",
                             "--cache-len", "64", "--iters", "2",
                             "--min-chain", "0", "--expert-quant", quant]
                            + CPU) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and all(ln.startswith("[layer_bench] tiny ep=")
                                   and "ms/layer" in ln and "tok/s" in ln
                                   for ln in lines)
    assert "(E_local=4)" in lines[1]
    experts = "int8_grouped_masked" if quant == "int8" else "grouped_gemm"
    assert set(_plain_calls()) == {"fp8_gemm", "flash_decode", experts}


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only host: the default device is CUDA")
    for main in (straggler_probe.main, headline.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_kernel.main(["-m", "8", "-n", "128", "-k", "128"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_bench.main(["--model", "tiny"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        layer_bench.main(["--configs", "tiny:1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        k12_fold_ablation.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        k8_ablation.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ksplit_sweep.main(["--m", "16", "--nk", "512x2048"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ring_sweep.main(["--k1", "16x512x2048", "--k3"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode_sweep.main(["--k2", "16x4x4x4096:serving", "--k6"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prefill_sweep.main(["--shapes", "phase2-start0"])


def test_decode_sweep_rows():
    """The sweep's K2 lengths are phase 4's (prompts of 16..1024 tokens and
    up to 32 decoded) or phase 2's (a fresh, a full and a freed slot
    first); its K6 rows carry the MoE layer's hint, ceil(M_max / E), and
    its default rows parse."""
    serving = decode_sweep.decode_lengths(16, 4096, "serving")
    assert serving.min() >= 16 and serving.max() <= 1056
    phase2 = decode_sweep.decode_lengths(16, 4096)
    assert list(phase2[:3]) == [1, 4096, 4096] and phase2.max() <= 4096
    assert set(decode_sweep.decode_lengths(4, 80, "ones")) == {1}
    assert set(decode_sweep.decode_lengths(4, 80, "full")) == {80}
    for spec in decode_sweep.K6:
        e, cap, n, k, hint = (int(x) for x in spec.split("x"))
        assert hint == -(-cap // e) and n % 64 == 0 and k % 16 == 0
    for spec in decode_sweep.K2:
        shape, _, lengths = spec.partition(":")
        assert len(shape.split("x")) == 4 and lengths in (
            "", "serving", "ones", "full")


def test_prefill_sweep_rows():
    """The sweep's shapes are chip_smoke's K4 rows (phase 4's 1024-bucket
    prompts of its default_rng(2) draw plus a padding row; phase 6's
    prompt), its variants parse into the kernel's defines (the package's
    64x4:heavy among them) and refuse what the kernel has no build for;
    the bound counts each visible key once."""
    import numpy as np
    rng = np.random.default_rng(2)
    first = rng.integers(16, 1025, size=24)[:16]
    b, kvh, g, s, s_max, starts, lens = prefill_sweep.SHAPES["bucket1024"]
    assert lens == [int(x) for x in first if x > 512] + [1]
    assert (b, s, s_max) == (len(lens), 1024, 4096) and set(starts) == {0}
    assert prefill_sweep.SHAPES["cp16384"][3:5] == (16384, 16384)
    assert "192x2:heavy" in prefill_sweep.VARIANTS
    assert prefill_sweep.defines("128x3:q") == [
        "-DDGA_K4_WARPS=8", "-DDGA_K4_STAGES=3", "-DDGA_K4_HEAVY_FIRST=0"]
    for bad in ("96x4:heavy", "256x2:heavy", "64x4:light"):
        with pytest.raises(ValueError):
            prefill_sweep.defines(bad)
    # 16 rows from position 0 read 16 key rows; rows before 0 read none.
    ms, by = prefill_sweep.k4_bound(1, 1, 1, 16, 64, [0], [16])
    assert by == "bytes" and ms == pytest.approx(
        (16 * 128 * 6 + 16 * (2 * 128 + 8)) / 3.35e9)
    assert prefill_sweep.k4_bound(1, 1, 1, 16, 64, [-40], [16])[0] == \
        pytest.approx(16 * 128 * 6 / 3.35e9)


def _ab_run(label, k2_ms, k6_ms, device_ms, k2_kernel):
    top = [{"kernel": "void at::native::elementwise_kernel<128, 4>(int)",
            "ms": 0.5, "count": 9},
           {"kernel": f"void (anonymous namespace)::{k2_kernel}<4, true>"
                      "(CUtensorMap_st, int)", "ms": 0.125, "count": 8}]
    return {"label": label, "tree": ".", "seconds": 1.0, "checks": {
        "flash_decode": [{"shape": "b=16", "ms": k2_ms, "route": "live/460"}],
        "int8_grouped_masked": [{"shape": "E=32", "ms": k6_ms}],
        "gemm": [{"shape": "only in " + label, "ms": 1.0}]},
        "serving": [{"run": "int8", "decode_tok_s": 300.0, "plans": {},
                     "prefill_tok_s": 4000.0,
                     "profile": {"device_ms": device_ms, "wall_ms": 40.0,
                                 "launches": 1400, "top": top},
                     "prefill_profile": {"bucket": 1024, "wall_ms": 300.0,
                                         "unprofiled_wall_ms": 290.0,
                                         "device_ms": 2 * device_ms,
                                         "k4_ms": k2_ms * 10,
                                         "k4_launches": 8}}]}


def test_phase2_ab_summary(tmp_path, capsys):
    """The summary of a call's phase2_<label>.json files: runs that differ
    in their trailing digits form one side, parent first; a row that every
    side ran gets each side's mean and the ratio; each profiled step its
    device ms and the port's own kernels (not PyTorch's) in it."""
    for label, k2, k6, dev_ms in (("parent1", 0.09, 0.11, 6.5),
                                  ("change1", 0.04, 0.08, 6.0),
                                  ("change2", 0.05, 0.08, 6.1),
                                  ("parent2", 0.07, 0.11, 6.7)):
        kernel = "live::live_kernel" if label[0] == "c" else "span_kernel"
        (tmp_path / f"phase2_{label}.json").write_text(json.dumps(
            _ab_run(label, k2, k6, dev_ms, kernel)))
    assert phase2_ab.main(["--out", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("sides: parent (parent1, parent2), change (change1, "
                        "change2)")
    k2 = next(ln for ln in lines if ln.startswith("flash_decode"))
    assert "parent 0.0800 change 0.0450 ratio 0.562 live/460" in k2
    assert any(ln.startswith("int8_grouped_masked") and "ratio 0.727" in ln
               for ln in lines)
    assert not any("only in" in ln for ln in lines)
    assert "serving int8 parent mean device_ms 6.600" in lines
    assert "serving int8 change mean device_ms 6.050" in lines
    assert ("prefill int8 parent1    bucket 1024 wall_ms 300.00 "
            "unprofiled_wall_ms 290.00 device_ms 13.000 k4_ms 0.900 "
            "k4_launches 8 prefill_tok_s 4000.0") in lines
    step = next(ln for ln in lines if "change1" in ln and "device_ms" in ln
                and ln.startswith("serving"))
    assert "live_kernel 0.125 ms/8" in step and "elementwise" not in step


@pytest.mark.parametrize("change_digest,want", [("ab", "equal"),
                                                 ("cd", "DIFFER")])
def test_phase2_ab_summary_compares_k2_digests(tmp_path, capsys,
                                               change_digest, want):
    """Where every run kept K2's digests, the summary says whether they
    are all equal (the two commits' K2 gave the same bits); where one did
    not, it prints no digest line."""
    for label, digest in (("parent1", "ab"), ("change1", change_digest)):
        run = _ab_run(label, 0.05, 0.08, 6.0, "live::live_kernel")
        run["k2_digests"] = {"v2_lite": digest, "serving": "ef"}
        (tmp_path / f"phase2_{label}.json").write_text(json.dumps(run))
    assert phase2_ab.main(["--out", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].startswith(f"K2 digests {want}: ")
    (tmp_path / "phase2_change2.json").write_text(json.dumps(
        _ab_run("change2", 0.05, 0.08, 6.0, "live::live_kernel")))
    assert phase2_ab.main(["--out", str(tmp_path)]) == 0
    assert not any(ln.startswith("K2 digests")
                   for ln in capsys.readouterr().out.splitlines())


def test_k8_ablation_swaps_only_k8_entry():
    """K8's ablation runs its variants through the package's K8 wrapper by
    swapping that one C entry for the duration, then puts it back."""
    real = _kernels.entry
    variant = object()
    with k8_ablation.k8_entry(variant):
        assert _kernels.entry("grouped_gemm_contiguous") is variant
    assert _kernels.entry is real


def test_k12_ablation_swaps_only_k12_entry():
    """The ablation runs its variants through the package's K12 wrapper by
    swapping that one C entry for the duration, then puts it back."""
    real = _kernels.entry
    variant = object()
    with k12_fold_ablation.k12_entry(variant):
        assert _kernels.entry("fp8_gemm_folded") is variant
    assert _kernels.entry is real


@pytest.mark.parametrize("op", ["gemm", "int8_gemm_nt", "fp8_gemm_nt"])
def test_autotune_sweep_then_the_tiling_scripts(op, tmp_path, capsys):
    """autotune_sweep at small shapes on the CPU (the plain versions, a
    host clock), one shape in a child process and one in process; then
    report_benchmarks, publish_tilings, train_predictor and
    calibrate_cost_model on its records."""
    from deepgemm_ascend_tpu_torch.scripts import (autotune_sweep,
                                                   calibrate_cost_model,
                                                   publish_tilings,
                                                   report_benchmarks,
                                                   train_predictor)
    from deepgemm_ascend_tpu_torch.tiling.cache import TilingCache
    out = str(tmp_path / "sw")
    assert autotune_sweep.main(["--op", op, "--shapes", "16", "256", "256",
                                "--out-dir", out] + CPU) == 0
    assert autotune_sweep.main(["--op", op, "--shapes", "64", "128", "256",
                                "--out-dir", out, "--in-process"] + CPU) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [(r["m"], r["op"]) for r in rows] == [(16, op), (64, op)]
    assert all(r["winner"] and r["clock"] == "host (rehearsal)" for r in rows)
    cache = TilingCache(str(tmp_path / "sw" / "tilings.jsonl"))
    assert len(cache) == 2
    files = str(tmp_path / "sw" / "*.jsonl")
    report = str(tmp_path / "report.md")
    assert report_benchmarks.main([files, "--device", "cpu", "--out",
                                   report]) == 0
    text = open(report).read()
    assert text.count(f"| {op} |") == 2
    with pytest.raises(ValueError, match="docs"):
        report_benchmarks.main([files, "--device", "cpu", "--out",
                                str(tmp_path / "docs" / "x.md")])
    table = str(tmp_path / "table.jsonl")
    assert publish_tilings.main([files, "--device", "cpu", "--out",
                                 table]) == 0
    assert len(TilingCache(table)) == 2
    assert train_predictor.main([files, "--op", op, "--device", "cpu",
                                 "--out-dir", str(tmp_path), "--epochs", "3",
                                 "--holdout", "0.5"]) == 0
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert meta["device_kind"] == "cpu" and meta["op"] == op
    cal = str(tmp_path / "cal.json")
    assert calibrate_cost_model.main([files, "--device", "cpu", "--out",
                                      cal]) == 0
    fit = json.load(open(cal))["cpu"][op]
    assert fit["mean_abs_log_err"] <= fit["default_mean_abs_log_err"]


@pytest.mark.parametrize("op,argv,keys", [
    ("grouped_gemm_masked_nt", ["2", "32", "256", "256", "--expected-m",
                                "3", "20"],
     ["grouped_gemm_masked_nt:m32n256k256:float8_e4m3fn->bfloat16:g128e3",
      "grouped_gemm_masked_nt:m32n256k256:float8_e4m3fn->bfloat16:g128e20"]),
    ("int8_grouped_gemm_masked", ["2", "32", "256", "128"],
     ["int8_grouped_gemm_masked:m32n256k128:int8->bfloat16:g128"]),
    ("grouped_gemm_contiguous_nt", ["2", "64", "256", "128", "--uneven"],
     ["grouped_gemm_nt:m64n256k128:float8_e4m3fn->bfloat16:g128"])])
def test_autotune_sweep_grouped_ops(op, argv, keys, tmp_path, capsys):
    """The grouped ops on the CPU (plain versions, a host clock): E M N K
    quadruples, a masked op at each ``--expected-m`` (two keys at one
    M_max), a contiguous op keyed on its layout's m-tile; each winner a
    compiled tile of the op's route, written under the selector's key."""
    from deepgemm_ascend_tpu_torch.scripts import autotune_sweep
    from deepgemm_ascend_tpu_torch.tiling import analytic
    from deepgemm_ascend_tpu_torch.tiling.cache import TilingCache
    out = str(tmp_path / "sw")
    assert autotune_sweep.main(["--op", op, "--shapes", *argv, "--out-dir",
                                out, "--in-process"] + CPU) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert len(rows) == len(keys)
    sop = autotune_sweep.selector_op(op)
    for r in rows:
        rt = analytic.expected_route(sop, r["m"], r["n"], r["k"], torch.int8
                                     if op.startswith("int8") else
                                     torch.float8_e4m3fn)
        tiles = [f"{bm}x{bn}" for _, (bm, bn) in analytic.route_tiles(sop,
                                                                      rt)]
        assert r["winner"] in tiles and r["default"] in r["candidates_ms"]
        assert r["clock"] == "host (rehearsal)"
    cache = TilingCache(str(tmp_path / "sw" / "tilings.jsonl"))
    assert sorted(key for key, _ in cache) == sorted(keys)


def test_grouped_sweep_runs_on_routed_loads():
    """The grouped sweep times its candidates on routed top-6 loads
    (``bench.loads``): a masked op's valid rows an expert and a contiguous
    op's layout are those of routing the tokens, skewed, not one count
    for every expert."""
    from deepgemm_ascend_tpu_torch.bench import loads
    from deepgemm_ascend_tpu_torch.ops import grouped_gemm as gg
    from deepgemm_ascend_tpu_torch.scripts import autotune_sweep as sw
    cpu = torch.device("cpu")
    _, plain, _, key_m, _ = sw.grouped_problem(
        "grouped_gemm_masked_nt", 8, 64, 128, 128, 3, cpu, expected_m=12)
    want = loads.routed_masked_m(8, 64, 12, generator=torch.Generator(
        ).manual_seed(3))
    valid = (plain().float().abs().sum(-1) > 0).sum(-1)
    assert key_m == 64 and valid.tolist() == want.tolist()
    assert len(set(want.tolist())) > 1 and int(want.sum()) == 8 * 12
    _, _, _, key_m, tiles = sw.grouped_problem(
        "int8_grouped_gemm_contiguous_nt", 8, 128, 128, 128, 3, cpu)
    counts = loads.routed_counts(8, 128, generator=torch.Generator(
        ).manual_seed(3))
    _, ids, _ = gg.make_contiguous_layout(counts, 128)
    assert key_m == 128 and tiles == ids.size and len(set(counts)) > 1


def test_publish_tilings_never_publishes_the_xla_yardstick():
    """A sweep's XLA record (a library call for the dense GEMM), even the
    fastest, is not published: the shape's table entry is its fastest
    kernel config."""
    from deepgemm_ascend_tpu_torch.config import GemmConfig, KernelType
    from deepgemm_ascend_tpu_torch.scripts import publish_tilings

    def rec(cfg, secs):
        return {"m": 2048, "n": 2048, "k": 2048, "op": "gemm",
                "config": cfg.to_dict(), "time_s": secs,
                "tflops": 2 * 2048 ** 3 / secs / 1e12, "correct": True,
                "idx": 0}
    recs = [rec(GemmConfig(128, 256, 64), 4e-4),
            rec(GemmConfig(64, 64, 64), 6e-4),
            rec(GemmConfig(kernel_type=KernelType.XLA), 3e-4)]
    (key, cfg, ms), = publish_tilings.winners(recs)
    assert cfg == GemmConfig(128, 256, 64).to_dict() and ms == 0.4
    assert key == "gemm:m2048n2048k2048:bfloat16->float32:g128"


# ---- the golden, verify and quality scripts against the JAX scripts ----

def _jax_script(name):
    """A JAX script of ``scripts/`` as a module (its ``main(argv)``)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / name
    spec = importlib.util.spec_from_file_location(f"jax_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GOLDEN_FILES = ("input/x1_gm.bin", "input/x2_gm.bin", "output/golden.bin")


@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32"])
def test_gen_golden_files_byte_equal_to_jax(dtype, heavy, tmp_path):
    from deepgemm_ascend_tpu_torch.scripts import gen_golden
    extra = ["--dtype", dtype, "--seed", "3"] + (["--heavy-tail"] if heavy
                                                  else [])
    assert _jax_script("gen_golden.py").main(
        ["16", "24", "40", "--out-dir", str(tmp_path / "jax")] + extra) == 0
    assert gen_golden.main(
        ["16", "24", "40", "--out-dir", str(tmp_path / "port")] + extra) == 0
    for name in GOLDEN_FILES:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def _verify_case(case, tmp_path):
    """(argv of verify_output) for one case over a fresh golden file."""
    import numpy as np
    from deepgemm_ascend_tpu_torch.scripts import gen_golden
    shape = ("64", "64", "16") if case == "outliers" else ("8", "8", "8")
    gen_golden.main([*shape, "--out-dir", str(tmp_path)])
    g = tmp_path / "output" / "golden.bin"
    arr = np.fromfile(g, np.float32)
    extra = []
    if case == "double":
        arr = arr * 2.0
    elif case == "short":
        arr = arr[:-1]
    elif case == "outliers":          # 1 of 4096: passes at 1e-3
        arr[0] *= 100.0
        extra = ["--max-ratio", "1e-3"]
    out = tmp_path / "out.bin"
    arr.tofile(out)
    return [str(out), str(g)] + extra


@pytest.mark.parametrize("case,rc", [("identical", 0), ("double", 1),
                                     ("short", 2), ("outliers", 0)])
def test_verify_output_agrees_with_jax(case, rc, tmp_path, capsys):
    from deepgemm_ascend_tpu_torch.scripts import verify_output
    argv = _verify_case(case, tmp_path)
    capsys.readouterr()
    assert _jax_script("verify_output.py").main(argv) == rc
    want = capsys.readouterr().out.splitlines()[-1]
    assert verify_output.main(argv) == rc
    assert capsys.readouterr().out.splitlines()[-1] == want
    assert want.split(":")[0].endswith(
        {0: "PASS", 1: "FAIL", 2: "size mismatch"}[rc])


@pytest.mark.parametrize("dtype,stored", [("float16", "float16"),
                                          ("bfloat16", "float32")])
def test_torch_matmul_cross_check(dtype, stored, tmp_path, capsys):
    """torch_matmul over gen_golden's files passes verify_output against
    the golden (a bf16 golden stores its inputs as f32)."""
    from deepgemm_ascend_tpu_torch.scripts import (gen_golden, torch_matmul,
                                                   verify_output)
    shape = ["16", "24", "32"]
    assert gen_golden.main(shape + ["--dtype", dtype, "--out-dir",
                                    str(tmp_path)]) == 0
    assert torch_matmul.main(shape + ["--dtype", stored, "--dir",
                                      str(tmp_path)] + CPU) == 0
    out = tmp_path / "output" / "torch_out.bin"
    assert verify_output.main([str(out), str(tmp_path / "output" /
                                             "golden.bin")]) == 0
    assert "PASS" in capsys.readouterr().out


@pytest.fixture(scope="module")
def jax_quality_keys():
    """The keys of the JAX eval_quality line, fp8 and int8 (tiny, a few
    steps)."""
    import contextlib
    import io
    mod = _jax_script("eval_quality.py")
    keys = {}
    for quant in ("fp8", "int8"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(["--model", "tiny", "--steps", "3", "--batch", "2",
                      "--expert-quant", quant])
        keys[quant] = set(json.loads(buf.getvalue().splitlines()[-1]))
    return keys


@pytest.mark.parametrize("quant", ["fp8", "int8"])
def test_eval_quality_keys_and_gate(quant, jax_quality_keys, capsys):
    from deepgemm_ascend_tpu_torch.scripts import eval_quality
    _kernels.reset_counters()
    rc = eval_quality.main(["--model", "tiny", "--steps", "6", "--batch",
                            "2", "--expert-quant", quant] + CPU)
    (line,) = _json_lines(capsys.readouterr().out)
    assert set(line) == jax_quality_keys[quant]
    assert rc == 0 and line["ok"] and line["expert_quant"] == quant
    experts = "int8_grouped_masked" if quant == "int8" else "grouped_gemm"
    assert experts in _plain_calls()


def test_prefix_spread_lines(capsys):
    """One line a seed with the distance of the prefix cache's warm and
    cold admissions, which the CPU's plain versions compute alike."""
    from deepgemm_ascend_tpu_torch.scripts import prefix_spread
    assert prefix_spread.main(["--model", "tiny", "--seeds", "2",
                               "--system", "32"] + CPU) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert [ln["seed"] for ln in lines] == [0, 1]
    for ln in lines:
        assert len(ln["rel_l2"]) == 16
        assert 0 <= ln["max_rel_l2"] < 0.25
        assert ln["first_tokens_differing"] <= ln["requests_differing"]
