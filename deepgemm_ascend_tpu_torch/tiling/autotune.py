"""Profiled grid-search autotuner — tier 1.5 of the tiling system.

Port of ``deepgemm_ascend_tpu/tiling/autotune.py`` (≙ the reference's
benchmark-driven tuner, ``framework/benchmark/benchmark.py``), with its
record format and failure containment:

* the candidates are the compiled variants of the op's kernel that fit
  the shape and the card (``analytic.enumerate_candidates``: tiles, K11's
  and K1's split counts, the padded configs of a ragged dense shape); the
  XLA family (plain torch ops, JAX's product outside Pallas, a library
  call for the dense GEMM) is timed beside them where
  :func:`xla_candidate_ok` admits it, as a yardstick: it is recorded but
  never wins, so no sweep puts a library call in a kernel's place;
* ``time_fn(config) -> seconds`` times a candidate (the sweep scripts use
  ``bench.timing.cold_ms``); ``check_fn(config) -> bool``, where given,
  holds its output against the plain version first (the tolerances of
  ``PERF.md`` §2) — a candidate that fails the gate or raises is recorded
  with ``time_s < 0`` and never wins;
* a time faster than the shape's light speed (``bench/records``, the
  card's data-sheet roofline) is re-timed once (a glitch) and, if still
  impossible, rejected;
* JSONL records (:class:`SweepResult`, one a line), resume keyed by the
  normalised config, an in-flight marker written before each candidate so
  that a process that dies on one (a fault poisons the CUDA context)
  records it as poisoned on resume (``retry_failed`` measures such records
  again), and a wall-clock watchdog that hard-exits a hung candidate;
* the winning kernel config is written into the tiling cache
  (persisted), so the next ``select_config`` of the shape hits it.

The sweep scripts run each shape in a child process, so that a fault ends
that child alone and its resume skips the poisoned candidate.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, Optional, Sequence

import torch

from ..config import GemmConfig, KernelType
from . import analytic
from . import platform as plat
from .cache import TilingCache, cache_key, dtype_name, global_cache
from .selector import FOLDED, key_extra


@dataclasses.dataclass
class SweepResult:
    """One (shape, config) measurement — ≙ ``Result`` (`benchmark.py:195-225`)."""

    m: int
    n: int
    k: int
    op: str
    config: dict
    time_s: float          # < 0 => failed/poisoned config
    tflops: float
    correct: bool
    idx: int = -1

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, line: str) -> "SweepResult":
        return cls(**json.loads(line))


# The XLA family's gate (JAX :71-73): a block-scaled op's torch realization
# materializes a (k/128, m, n) f32 partial, so it is timed only where the
# product is small (≤ 3e10 operations: ~30 µs at the card's bf16 rate,
# where a launch's fixed cost still shows) and the partial stays modest.
_XLA_FLOPS_CEILING = 3e10
_XLA_PARTIAL_BYTES_CEILING = 128e6


def xla_candidate_ok(op: str, m: int, n: int, k: int,
                     flops_scale: float = 1.0) -> bool:
    """Time the XLA-family yardstick (``KernelType.XLA``)? JAX's rule:
    never for the contiguous grouped layout (no such realization); for the
    block-scaled ops (fp8, masked grouped) only in the small regime above;
    for the plain dense family (16-bit and f32 GEMMs, W8A8 int8) at every
    size."""
    if "grouped" in op and "masked" not in op:
        return False
    if op.startswith(("fp8_gemm", "grouped_gemm_masked")):
        if 2.0 * m * n * k * flops_scale > _XLA_FLOPS_CEILING:
            return False
        return (flops_scale * (k // 128) * m * n * 4
                <= _XLA_PARTIAL_BYTES_CEILING)
    return True


class Autotuner:
    """Per-shape profiled sweep with JSONL records and crash resume."""

    def __init__(
        self,
        time_fn: Callable[[GemmConfig], float],
        *,
        op: str = "gemm",
        results_path: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
        cache: Optional[TilingCache] = None,
        retry_failed: bool = False,
        check_fn: Optional[Callable[[GemmConfig], bool]] = None,
        info: Optional[plat.PlatformInfo] = None,
    ):
        """``time_fn(config) -> seconds`` (may raise: the config is then
        poisoned); ``check_fn(config) -> bool``: the correctness gate;
        ``retry_failed`` measures poisoned records again (after a
        systematic failure)."""
        self._time = time_fn
        self._check = check_fn
        self._op = op
        self._results_path = results_path
        self._ckpt_path = checkpoint_path
        self._cache = cache if cache is not None else global_cache()
        self._retry_failed = retry_failed
        self._info = info or plat.H100

    def _timed_with_watchdog(self, cfg: GemmConfig) -> float:
        """The timing callback under a wall-clock watchdog
        (``DGA_CANDIDATE_TIMEOUT_S``, default 1800 s; ≤ 0 turns it off). A
        hung launch cannot be cancelled from Python, so on timeout a
        watchdog thread logs and hard-exits the process (code 17); the
        in-flight marker is already written, so the resume records the
        candidate as poisoned. The callback itself runs on the calling
        thread, where the sweep's CUDA work lives (a launch from a fresh
        thread can find an error another runtime call left there)."""
        tmo = float(os.environ.get("DGA_CANDIDATE_TIMEOUT_S", "1800"))
        if tmo <= 0:
            return self._time(cfg)
        done = threading.Event()

        def watchdog():
            if not done.wait(tmo):
                print(f"[DGA] autotune: candidate {cfg} exceeded {tmo:.0f}s "
                      f"watchdog — exiting (resume marks it poisoned)",
                      flush=True)
                os._exit(17)

        threading.Thread(target=watchdog, daemon=True).start()
        try:
            return self._time(cfg)
        finally:
            done.set()

    # -- persistence ------------------------------------------------------
    @staticmethod
    def _cfg_key(config: dict) -> str:
        """Canonical config key, normalised through GemmConfig (JAX :190):
        records of an older schema still match their candidates, and keys
        of a newer one stay in the key."""
        try:
            norm = GemmConfig.from_dict(config).to_dict()
            norm.update({k: v for k, v in config.items() if k not in norm})
            config = norm
        except (TypeError, ValueError):
            pass
        return json.dumps(config, sort_keys=True)

    def _load_done(self) -> dict:
        """Completed records keyed by config; a later line overrides an
        earlier one."""
        done: dict = {}
        if self._results_path and os.path.exists(self._results_path):
            with open(self._results_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        r = SweepResult.from_json(line)
                        done[self._cfg_key(r.config)] = r
                    except (json.JSONDecodeError, TypeError):
                        continue
        return done

    def _poisoned_marker(self):
        """(config key, legacy index) in flight when a previous process
        died (≙ `last_process_idx`, `benchmark.py:256-298`)."""
        if self._ckpt_path and os.path.exists(self._ckpt_path):
            try:
                with open(self._ckpt_path) as f:
                    d = json.load(f)
                cfg = d.get("in_flight_cfg")
                if cfg is not None:
                    try:
                        cfg = self._cfg_key(json.loads(cfg))
                    except (json.JSONDecodeError, TypeError):
                        pass
                return cfg, d.get("in_flight_idx")
            except (json.JSONDecodeError, OSError):
                return None, None
        return None, None

    def _mark_in_flight(self, idx: Optional[int],
                        config: Optional[dict] = None) -> None:
        if self._ckpt_path:
            os.makedirs(os.path.dirname(os.path.abspath(self._ckpt_path)),
                        exist_ok=True)
            cfg_key = self._cfg_key(config) if config is not None else None
            with open(self._ckpt_path, "w") as f:
                json.dump({"in_flight_idx": idx, "in_flight_cfg": cfg_key,
                           "ts": time.time()}, f)

    def _append(self, r: SweepResult) -> None:
        if self._results_path:
            os.makedirs(os.path.dirname(os.path.abspath(self._results_path)),
                        exist_ok=True)
            with open(self._results_path, "a") as f:
                f.write(r.to_json() + "\n")

    def _measure(self, cfg: GemmConfig, floor_s: float, ls: float) -> float:
        """The gate, then the time with the faster-than-light check (one
        re-time after a glitch)."""
        if self._check is not None and not self._check(cfg):
            raise RuntimeError("output outside the tolerance of the plain "
                               "version")
        secs = self._timed_with_watchdog(cfg)
        if secs < floor_s:
            secs = self._timed_with_watchdog(cfg)   # a glitch? once more
        if secs < floor_s:
            raise RuntimeError(f"implausible timing {secs:.3e}s < light-speed "
                               f"{ls:.3e}s, rejecting the measurement")
        return secs

    # -- sweep ------------------------------------------------------------
    def sweep_shape(
        self,
        m: int, n: int, k: int,
        candidates: Optional[Sequence[GemmConfig]] = None,
        *,
        in_dtype=torch.bfloat16,
        out_dtype=torch.float32,
        k_granularity: int = 128,
        max_candidates: Optional[int] = None,
        verbose: bool = False,
        flops_scale: float = 1.0,
        batch: int = 1,
        expected_m: Optional[int] = None,
        route: Optional[str] = None,
    ) -> Optional[GemmConfig]:
        """Sweep one shape; returns the winning kernel config (None if
        every kernel candidate failed). ``max_candidates`` keeps the
        analytically fastest prefix (``analytic.estimate_time``); the XLA
        yardstick is appended where :func:`xla_candidate_ok` admits it
        (last, so that resumed indices stay aligned) and never wins. A
        grouped op's ``flops_scale`` is its experts (masked) or m-tiles
        (contiguous), counted in the light-speed screen; ``expected_m``
        (a masked op's hint) and ``route`` (K12's "folded") go into the
        winner's key as the selector keys them."""
        info = self._info
        if candidates is None:
            candidates = analytic.enumerate_candidates(
                self._op, m, n, k, in_dtype, out_dtype, info, batch,
                route=route)
        candidates = list(candidates)
        if max_candidates:
            candidates.sort(key=lambda c: analytic.estimate_time(
                self._op, m, n, k, c, info, in_dtype, out_dtype,
                batch, route=route).time_s)
            candidates = candidates[:max_candidates]
        if route != FOLDED and xla_candidate_ok(self._op, m, n, k,
                                                flops_scale):
            xcfg = GemmConfig(kernel_type=KernelType.XLA)
            if xcfg not in candidates:
                candidates.append(xcfg)

        done = self._load_done()
        poisoned_cfg, poisoned_idx = self._poisoned_marker()
        best: Optional[SweepResult] = None
        flops = 2 * m * n * k * flops_scale * batch
        from ..bench import records
        in_dt, out_dt = (in_dtype, out_dtype)
        ls = records.light_speed_floor_s(self._op, m, n, k, in_dt, out_dt,
                                         flops_scale) * batch
        floor_s = ls / records.DEFAULT_TOL

        for idx, cfg in enumerate(candidates):
            cfg_dict = cfg.to_dict()
            ckey = self._cfg_key(cfg_dict)
            prev = done.get(ckey)
            hit_poison = (ckey == poisoned_cfg if poisoned_cfg is not None
                          else idx == poisoned_idx)
            if prev is not None and (prev.time_s > 0
                                     or not self._retry_failed):
                r = prev
            elif hit_poison and not self._retry_failed:
                r = SweepResult(m, n, k, self._op, cfg_dict, time_s=-1.0,
                                tflops=0.0, correct=False, idx=idx)
                self._append(r)
            else:
                self._mark_in_flight(idx, cfg_dict)
                try:
                    secs = self._measure(cfg, floor_s, ls)
                    r = SweepResult(m, n, k, self._op, cfg_dict, time_s=secs,
                                    tflops=flops / secs / 1e12, correct=True,
                                    idx=idx)
                except Exception as e:  # failure → poisoned record
                    if verbose:
                        print(f"[DGA] autotune {m}x{n}x{k} #{idx} "
                              f"{describe(cfg)} failed: "
                              f"{type(e).__name__}: {str(e)[:300]}",
                              flush=True)
                    r = SweepResult(m, n, k, self._op, cfg_dict, time_s=-1.0,
                                    tflops=0.0, correct=False, idx=idx)
                self._append(r)
                self._mark_in_flight(None)
            if verbose and r.time_s > 0:
                print(f"[DGA] autotune {m}x{n}x{k} #{idx} {describe(cfg)}: "
                      f"{r.time_s * 1e3:.4f} ms ({r.tflops:.1f} TF/s)",
                      flush=True)
            if (r.time_s > 0 and cfg.kernel_type != KernelType.XLA
                    and (best is None or r.time_s < best.time_s)):
                best = r

        if best is None:
            return None
        win = GemmConfig.from_dict(best.config)
        key = cache_key(self._op, m, n, k, dtype_name(in_dtype),
                        dtype_name(out_dtype),
                        key_extra(self._op, m, k_granularity, batch,
                                  expected_m, route))
        self._cache.set(key, win, persist=True)
        return win


def describe(cfg: GemmConfig) -> str:
    """A config as a sweep prints it: ``xla``, or ``BMxBN`` with ``/S`` for
    S splits and ``+pad`` for a padded one."""
    if cfg.kernel_type == KernelType.XLA:
        return "xla"
    s = f"{cfg.block_m}x{cfg.block_n}"
    if cfg.kernel_type == KernelType.KSPLIT and cfg.k_split > 1:
        s += f"/{cfg.k_split}"
    return s + ("+pad" if cfg.pad_k else "")
