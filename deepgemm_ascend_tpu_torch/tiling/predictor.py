"""Learned tiling cost predictor — tier 2 of the tiling system.

Port of ``deepgemm_ascend_tpu/tiling/predictor.py`` (≙ the reference's MLP
predictor, ``get_best_config.py:166-670``): a small MLP maps (M, N, K,
block_m, block_n, block_k) → log kernel time; the op's candidate tiles
are scored in a batch and the best is chosen, under JAX's decline policy
(``:119-250``): the predictor declines — and the selector falls back to
the analytic tier — where fewer than ``min_candidates`` tiles exist,
where the pick is not ``margin`` faster than the analytic config by the
model's own times (the margin raised to the held-out pick/oracle
regression of weights that show no win over analytic), or where the
analytic model prices the pick ``guard_factor``× slower than its own
config (the roofline guardrail).

The same features (:func:`_features`: log2 of the shape and tile, and the
full-K bit) and the same numpy forward, ``.npz`` save and load as JAX's,
so weights trained by either package score alike in both. The
candidates are the port's: the compiled tiles of the op's kernel that fit
the shape and the card (``analytic.enumerate_candidates``), at most three
a route, so :data:`MIN_CANDIDATES` is 2 where JAX's Pallas grid asked for
60; a pick's family and split count are the analytic tier's for that
tile. :func:`train` fits the MLP with ``torch.optim.Adam`` (JAX: optax)
from an explicit ``torch.Generator``, on the CPU, and returns numpy
weights.

The packaged default (``data/predictor_<op>.npz`` of the port) installs
only where its ``meta["device_kind"]`` is the detected card's kind;
``DGA_PREDICTOR_PATH`` names weights for ``fp8_gemm_nt`` with no kind
check, as JAX's does for its ``fp8_gemm``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import GemmConfig, KernelType
from . import analytic
from . import platform as plat

FEATURES = 7  # m, n, k, bm, bn, bk (log2-scaled) + full-K kernel-family bit
DEFAULT_HIDDEN = (64, 128, 64)
MIN_CANDIDATES = 2         # JAX: 60 (≙ min_tiling); the port has ≤ 3 tiles
NATIVE_MARGIN = 0.03       # ≙ 3% fallback margin (`get_best_config.py:601`)
MAX_BATCH = 2048           # ≙ predict_batch cap (`get_best_config.py:309`)
DEFAULT_WEIGHTS_ENV = "DGA_PREDICTOR_PATH"
# The op the environment's weights stand for (JAX: "fp8_gemm", whose
# counterpart on the port's K-major weights is "fp8_gemm_nt").
ENV_OP = "fp8_gemm_nt"
DATA_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                        "data"))


def _features(m, n, k, tiles: np.ndarray) -> np.ndarray:
    """(N, 7) feature matrix — JAX's: log2(shape + 1), log2(tile) and
    ``block_k ≥ K``."""
    shape = np.log2(np.asarray([m, n, k], np.float64) + 1.0)
    out = np.empty((len(tiles), FEATURES), np.float64)
    out[:, :3] = shape
    out[:, 3:6] = np.log2(tiles.astype(np.float64))
    out[:, 6] = (tiles[:, 2] >= k).astype(np.float64)
    return out


@dataclasses.dataclass
class MLPWeights:
    """Plain-numpy MLP: Linear→ReLU stack → scalar log-time; ``meta``
    carries the training provenance (``device_kind``, held-out metrics)."""

    ws: List[np.ndarray]
    bs: List[np.ndarray]
    mean: np.ndarray
    std: np.ndarray
    meta: dict = dataclasses.field(default_factory=dict)

    def forward(self, x: np.ndarray) -> np.ndarray:
        h = (x - self.mean) / np.maximum(self.std, 1e-12)
        for w, b in zip(self.ws[:-1], self.bs[:-1]):
            h = np.maximum(h @ w + b, 0.0)
        return (h @ self.ws[-1] + self.bs[-1])[:, 0]

    def save(self, path: str, meta: Optional[dict] = None) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if meta is not None:
            self.meta = dict(meta)
        payload = {"mean": self.mean, "std": self.std,
                   "n_layers": np.asarray(len(self.ws))}
        if self.meta:
            payload["meta_json"] = np.asarray(json.dumps(self.meta))
        for i, (w, b) in enumerate(zip(self.ws, self.bs)):
            payload[f"w{i}"] = w
            payload[f"b{i}"] = b
        np.savez(path, **payload)

    @classmethod
    def load(cls, path: str) -> "MLPWeights":
        z = np.load(path)
        n = int(z["n_layers"])
        meta = {}
        if "meta_json" in z.files:
            try:
                meta = json.loads(str(z["meta_json"]))
            except (json.JSONDecodeError, TypeError):
                meta = {}
        return cls(ws=[z[f"w{i}"] for i in range(n)],
                   bs=[z[f"b{i}"] for i in range(n)],
                   mean=z["mean"], std=z["std"], meta=meta)

    @classmethod
    def init(cls, hidden: Sequence[int] = DEFAULT_HIDDEN,
             seed: int = 0) -> "MLPWeights":
        rng = np.random.default_rng(seed)
        dims = [FEATURES, *hidden, 1]
        ws, bs = [], []
        for i, o in zip(dims[:-1], dims[1:]):
            ws.append(rng.normal(0, np.sqrt(2.0 / i), (i, o)))  # Kaiming
            bs.append(np.zeros((o,)))
        return cls(ws=ws, bs=bs, mean=np.zeros(FEATURES),
                   std=np.ones(FEATURES))


class TilingPredictor:
    """Scores the op's candidate tiles with the MLP; declines when unsure
    (JAX's policy, module docstring)."""

    def __init__(self, weights: MLPWeights, *,
                 strategy: str = "greedy",
                 min_candidates: int = MIN_CANDIDATES,
                 margin: float = NATIVE_MARGIN,
                 guard_factor: float = 1.25,
                 candidate_pool: int = 48,
                 op: str = "gemm"):
        if strategy not in ("greedy", "topk_median", "topk_consensus"):
            raise ValueError(f"unknown strategy {strategy!r}")
        self.weights = weights
        self.strategy = strategy
        self.min_candidates = min_candidates
        self.margin = margin
        self.guard_factor = guard_factor
        self.candidate_pool = candidate_pool
        self.op = op
        # Evidence-based margin (JAX :139-150): weights whose held-out report
        # shows a pick/oracle regression and no win over analytic must
        # predict at least that regression's worth of advantage.
        po = self.weights.meta.get("holdout_pick_oracle")
        wr = self.weights.meta.get("holdout_winrate")
        if po and float(po) > 1.0 and (wr is None or float(wr) < 0.5):
            self.margin = max(self.margin, float(po) - 1.0)

    def predict_batch(self, feats: np.ndarray) -> np.ndarray:
        """Batched MLP inference, ≤ MAX_BATCH rows a chunk."""
        outs = []
        for i in range(0, len(feats), MAX_BATCH):
            outs.append(self.weights.forward(feats[i:i + MAX_BATCH]))
        return np.concatenate(outs) if outs else np.zeros((0,))

    def _select(self, times: np.ndarray,
                tiles: Optional[np.ndarray] = None) -> int:
        if self.strategy == "greedy":
            return int(np.argmin(times))
        k = max(1, min(8, len(times) // 10))
        top = np.argsort(times)[:k]
        if self.strategy == "topk_median" or tiles is None:
            return int(top[len(top) // 2])  # median of the top-k
        # topk_consensus: among the top-k, the tile closest (log-block
        # space) to their per-dimension median (JAX :186-197).
        logt = np.log2(tiles[top].astype(np.float64))
        med = np.median(logt, axis=0)
        return int(top[np.argmin(np.abs(logt - med).sum(axis=1))])

    def decide(self, times: np.ndarray, tiles: np.ndarray,
               native_time: float) -> Optional[int]:
        """The decline policy on predicted times: the index of the pick, or
        None where it is not ``margin`` faster than the analytic config's
        predicted ``native_time`` (or there are too few candidates)."""
        if len(times) < self.min_candidates:
            return None
        idx = self._select(times, tiles)
        if float(times[idx]) > (1.0 - self.margin) * native_time:
            return None
        return idx

    def predict(self, m: int, n: int, k: int, in_dtype, out_dtype,
                *, op: str = "gemm", info: Optional[plat.PlatformInfo] = None,
                batch: int = 1,
                expected_m: Optional[int] = None) -> Optional[GemmConfig]:
        """Best config by predicted time, or None to decline (fallback).
        ``expected_m``: a masked grouped op's hint, which moves its
        analytic config (the features are JAX's and do not carry it)."""
        if op != self.op:
            return None
        if self.weights.mean.shape[0] != FEATURES:
            return None   # stale weights (older feature schema) → decline
        info = info or plat.H100
        native = analytic.get_best_config(m, n, k, in_dtype, out_dtype, op=op,
                                          info=info, batch=batch,
                                          expected_m=expected_m)
        if native.pad_k:
            return None   # the padding tier's answer stands
        cands = {(c.block_m, c.block_n, c.block_k)
                 for c in analytic.enumerate_candidates(
                     op, m, n, k, in_dtype, out_dtype, info, batch,
                     splits=False)}
        cands = sorted(cands)
        if len(cands) < self.min_candidates:
            return None

        def est(bm, bn):
            cfg = native.replace(block_m=bm, block_n=bn)
            return analytic.estimate_time(op, m, n, k, cfg, info, in_dtype,
                                          out_dtype, batch).time_s

        if len(cands) > self.candidate_pool:
            cands.sort(key=lambda t: est(t[0], t[1]))
            cands = cands[:self.candidate_pool]
        tiles = np.asarray(cands, np.int64)
        times = np.exp(self.predict_batch(_features(m, n, k, tiles)))
        nat_feat = _features(m, n, k, np.asarray(
            [[native.block_m, native.block_n, native.block_k]], np.int64))
        native_time = float(np.exp(self.predict_batch(nat_feat)[0]))
        idx = self.decide(times, tiles, native_time)
        if idx is None:
            return None
        bm, bn, bk = (int(v) for v in tiles[idx])
        # Roofline guardrail (JAX :229-243): decline a pick the analytic
        # model prices guard_factor× slower than its own config.
        if est(bm, bn) > self.guard_factor * est(native.block_m,
                                                 native.block_n):
            return None
        return native.replace(block_m=bm, block_n=bn, block_k=bk)


# ---- default weights discovery -------------------------------------------

def default_weights_path(op: str = ENV_OP) -> Optional[str]:
    """``$DGA_PREDICTOR_PATH`` for :data:`ENV_OP`, else the port's packaged
    ``data/predictor_<op>.npz``, or None."""
    env = os.environ.get(DEFAULT_WEIGHTS_ENV)
    if env and op == ENV_OP and os.path.exists(env):
        return env
    packaged = os.path.join(DATA_DIR, f"predictor_{op}.npz")
    return packaged if os.path.exists(packaged) else None


def enable_default_predictor(op: str = ENV_OP, kind: Optional[str] = None,
                             **kw) -> bool:
    """Install the op's default predictor as selector tier 2 — the
    environment's weights (:data:`ENV_OP`), or packaged weights trained on
    ``kind`` (default: the current card's; ``meta["device_kind"]``).
    Returns False, changing nothing, where there are none."""
    from . import selector
    from .cache import device_kind
    path = default_weights_path(op)
    if path is None:
        return False
    weights = MLPWeights.load(path)
    env = os.environ.get(DEFAULT_WEIGHTS_ENV)
    from_env = bool(env) and op == ENV_OP and path == env
    if kind is None:
        kind = device_kind("cuda" if torch.cuda.is_available() else "cpu")
    if not from_env and weights.meta.get("device_kind") != kind:
        return False
    selector.register_predictor(TilingPredictor(weights, op=op, **kw))
    return True


# ---- training from autotuner sweep JSONL --------------------------------

def load_sweep_records(paths: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
    """JSONL SweepResults → (features, log-times). Poisoned records
    (time_s ≤ 0) and the XLA family (its block fields mean nothing) are
    skipped."""
    feats, times = [], []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("time_s", -1) <= 0:
                    continue
                c = r["config"]
                if c.get("kernel_type") == int(KernelType.XLA):
                    continue
                feats.append([r["m"], r["n"], r["k"],
                              c["block_m"], c["block_n"], c["block_k"]])
                times.append(r["time_s"])
    if not feats:
        return np.zeros((0, FEATURES)), np.zeros((0,))
    arr = np.asarray(feats, np.float64)
    f = np.empty((len(arr), FEATURES), np.float64)
    f[:, :3] = np.log2(arr[:, :3] + 1.0)
    f[:, 3:6] = np.log2(arr[:, 3:6])
    f[:, 6] = (arr[:, 5] >= arr[:, 2]).astype(np.float64)
    return f, np.log(np.asarray(times, np.float64))


def train(feats: np.ndarray, log_times: np.ndarray, *,
          hidden: Sequence[int] = DEFAULT_HIDDEN, epochs: int = 200,
          lr: float = 1e-3, seed: int = 0, batch: int = 256) -> MLPWeights:
    """Adam-trained MLP on (features → log time), in f64 on the CPU, the
    batches drawn from a ``torch.Generator`` seeded with ``seed``; the
    initial weights are :meth:`MLPWeights.init`'s. Returns numpy
    weights."""
    mean = feats.mean(0)
    std = feats.std(0) + 1e-8
    x = torch.from_numpy((feats - mean) / std)
    y = torch.from_numpy(np.asarray(log_times, np.float64))
    w0 = MLPWeights.init(hidden, seed)
    ws = [torch.tensor(w, requires_grad=True) for w in w0.ws]
    bs = [torch.tensor(b, requires_grad=True) for b in w0.bs]
    opt = torch.optim.Adam(ws + bs, lr=lr)
    gen = torch.Generator().manual_seed(seed)

    def fwd(xx):
        h = xx
        for w, b in zip(ws[:-1], bs[:-1]):
            h = torch.relu(h @ w + b)
        return (h @ ws[-1] + bs[-1])[:, 0]

    n = len(x)
    for _ in range(epochs):
        order = torch.randperm(n, generator=gen)
        for i in range(0, n, batch):
            idx = order[i:i + batch]
            opt.zero_grad()
            loss = torch.mean((fwd(x[idx]) - y[idx]) ** 2)
            loss.backward()
            opt.step()
    return MLPWeights(ws=[w.detach().numpy().copy() for w in ws],
                      bs=[b.detach().numpy().copy() for b in bs],
                      mean=mean, std=std)
