"""Sharded serving steps: explicit dp/ep/tp SPMD over a (data, expert,
model) mesh.

Port of ``deepgemm_ascend_tpu/parallel/sharded.py``. JAX runs one
controller and ``shard_map``; PyTorch runs one process a rank, so every
rank runs the same step on its own shard (:func:`shard_params`,
:func:`shard_caches`) and the kernels run as on one device, at the shard's
shapes. The collectives are ``parallel/mesh.py``'s over each axis's
process group (identity on a group of one):

* data axis (dp): batch — caches and the step's rows split on batch; the
  logits or next tokens are gathered, so every rank's scheduler sees all
  slots;
* model axis (tp): q heads shard wq and wo (the o-projection's f32
  partials psummed), lm_head shards vocab (the logits gathered, or sampled
  without a gather: :func:`_sample_sharded`); wk/wv and the cache shard on
  kv heads where that is congruent (:func:`tp_kv_sharding`), else they are
  replicated and attention runs the plain path with ``head_offset``;
* expert axis (ep): the experts shard on the expert dim; every shard routes
  identically (replicated router) and computes only its experts' tokens
  through the masked grouped kernel; partial outputs psum over "expert".

Dense-FFN layers, the shared expert, norms and embeddings are replicated.
The steps take the batch's tokens and lengths whole (the same on every
rank, as the engine keeps them) and cut their own rows.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..models.attention import KVCache
from ..models.config import ModelConfig
from ..models.layers import Fp8Linear
from ..models.model import ModelParams, forward
from ..models.moe import MoEParams
from ..utils.logging import metrics
from .mesh import all_gather, axis_size, pmax, pmin, psum, replicated, shard

__all__ = ["tp_kv_sharding", "shard_params", "shard_caches",
           "make_sharded_decode_step", "make_sharded_prefill_step",
           "clear_program_memo"]

_CACHE_FIELDS = ("k_q", "k_s", "v_q", "v_s")


def tp_kv_sharding(mesh, cfg: ModelConfig) -> bool:
    """True when kv heads shard congruently with the q-head shards:
    kv_heads % tp == 0 and each shard's kv projection a whole number of
    128-wide fp8 blocks. wk/wv and the KV cache then shard on the kv-head
    dim, and the flash kernels run on every shard."""
    tp = axis_size(mesh, "model")
    return (tp > 1 and cfg.num_kv_heads % tp == 0
            and (cfg.kv_dim // tp) % 128 == 0)


def _map_tensors(obj, fn):
    """A parameter tree with ``fn`` applied to every tensor."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if obj is None:
        return None
    return dataclasses.replace(obj, **{
        f.name: _map_tensors(getattr(obj, f.name), fn)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
        or dataclasses.is_dataclass(getattr(obj, f.name))})


def shard_params(mesh, params: ModelParams, cfg: ModelConfig) -> ModelParams:
    """This rank's parameters (JAX's ``param_specs`` placement): wq's output
    rows and wo's input columns over "model" (weights and their 128-block
    scales), wk/wv too where :func:`tp_kv_sharding`, every expert tensor
    (fp8 or int8) on its expert dim over "expert", lm_head's vocab columns
    over "model"; the rest replicated. Each tensor is a contiguous copy."""
    kv = ("model",) if tp_kv_sharding(mesh, cfg) else ()

    def rows(lin: Fp8Linear, *spec) -> Fp8Linear:
        return Fp8Linear(w_q=shard(lin.w_q, mesh, *spec),
                         scales=shard(lin.scales, mesh, *spec))

    def rep(obj):
        return _map_tensors(obj, lambda x: replicated(x, mesh))

    layers = []
    for layer in params.layers:
        a = layer.attn
        attn = dataclasses.replace(
            a, wq=rows(a.wq, "model"), wk=rows(a.wk, *kv),
            wv=rows(a.wv, *kv), wo=rows(a.wo, None, "model"))
        ffn = layer.ffn
        if isinstance(ffn, MoEParams):
            ffn = dataclasses.replace(
                rep(ffn), experts=_map_tensors(
                    ffn.experts, lambda x: shard(x, mesh, "expert")))
        else:
            ffn = rep(ffn)
        layers.append(dataclasses.replace(
            layer, attn_norm=replicated(layer.attn_norm, mesh), attn=attn,
            ffn_norm=replicated(layer.ffn_norm, mesh), ffn=ffn))
    return ModelParams(embed=replicated(params.embed, mesh), layers=layers,
                       final_norm=replicated(params.final_norm, mesh),
                       lm_head=shard(params.lm_head, mesh, None, "model"))


def shard_caches(mesh, caches: List[KVCache],
                 cfg: Optional[ModelConfig] = None) -> List[KVCache]:
    """This rank's KV caches: batch over "data", and kv heads over "model"
    too when ``cfg`` is given and :func:`tp_kv_sharding` holds."""
    kv = "model" if cfg is not None and tp_kv_sharding(mesh, cfg) else None
    return [KVCache(**{n: shard(getattr(c, n), mesh, "data", kv)
                       for n in _CACHE_FIELDS}) for c in caches]


class _Shard(NamedTuple):
    """A rank's place on the mesh and what its layers are called with."""
    dp: int
    d: int
    data: object           # the axes' process groups
    model: object
    attn_kw: dict
    moe_kw: dict


def _shard_of(mesh, cfg: ModelConfig) -> _Shard:
    tp = axis_size(mesh, "model")
    ep = axis_size(mesh, "expert")
    if cfg.num_heads % tp:
        raise ValueError(f"num_heads {cfg.num_heads} % tp {tp} != 0")
    if cfg.num_experts % ep:
        raise ValueError(f"num_experts {cfg.num_experts} % ep {ep} != 0")
    local_heads = cfg.num_heads // tp
    local_experts = cfg.num_experts // ep
    model = mesh.get_group("model")
    if tp == 1:
        # No head sharding: the flash kernels as on one device.
        attn_kw = {}
    elif tp_kv_sharding(mesh, cfg):
        # Congruent kv heads: the shard-local cache, flash kernels.
        attn_kw = dict(tp_heads=local_heads, group=model)
    else:
        attn_kw = dict(tp_heads=local_heads, group=model,
                       head_offset=mesh.get_local_rank("model") * local_heads)
    moe_kw = dict(local_experts=local_experts,
                  expert_offset=mesh.get_local_rank("expert") * local_experts,
                  group=mesh.get_group("expert"))
    return _Shard(axis_size(mesh, "data"), mesh.get_local_rank("data"),
                  mesh.get_group("data"), model, attn_kw, moe_kw)


_TOPP_ROUNDS = 6      # k-ary threshold-search rounds (16-way each)
_TOPP_GRID = 16       # thresholds evaluated per round (one psum each)


def _topp_threshold_sharded(x: torch.Tensor, p: float, group) -> torch.Tensor:
    """Nucleus cutoff of vocab-sharded scaled logits x (b, v_local) f32,
    without a gather: the largest t found with B(t) = Σ_{x>t} softmax(x) ≥
    p, so that {x > cutoff} is the gathered reference's kept set unless a
    logit lies in the final bracket. Each of ``_TOPP_ROUNDS`` rounds
    evaluates B at ``_TOPP_GRID`` points of the bracket with one psum of
    (b, 16) floats; the bracket starts at [max(min−1, max−33), max], since
    logits below max−33 carry < e⁻³³ of the top token's mass (JAX
    ``sharded.py:135-207``)."""
    neg = -3.4e38
    finite = x > neg / 2
    mx = pmax(x.amax(dim=1), group)                                # (b,)
    mn = pmin(torch.where(finite, x, float("inf")).amin(dim=1), group)
    e = torch.where(finite, torch.exp(x - mx[:, None]), 0.0)
    # The shard's vocab sorted once; B(t) is then a searchsorted a row.
    xs, order = torch.sort(x, dim=1, stable=True)
    cum = torch.cumsum(torch.gather(e, 1, order), dim=1)
    z_local = cum[:, -1]
    z = psum(z_local.clone(), group)
    cum_pad = torch.nn.functional.pad(cum, (1, 0))

    def above_local(ts):
        """Σ_{x > t} e a row: z_local − cum[#entries ≤ t]. (b, G)"""
        idx = torch.searchsorted(xs, ts.contiguous(), right=True)
        return z_local[:, None] - torch.gather(cum_pad, 1, idx)

    lo = mn - 1.0                         # B(lo) = 1 ≥ p
    if p <= 1.0 - 1e-6:
        lo = torch.maximum(lo, mx - 33.0)
    hi = mx                               # B(hi) = 0 < p
    f = (torch.arange(1, _TOPP_GRID + 1, dtype=torch.float32,
                      device=x.device) / (_TOPP_GRID + 1))
    for _ in range(_TOPP_ROUNDS):
        ts = lo[:, None] + (hi - lo)[:, None] * f[None, :]         # (b, G)
        mass = psum(above_local(ts), group) / z[:, None]
        # New lo: the largest grid point with B ≥ p (or lo); new hi: the
        # next one (or hi). B is monotone decreasing.
        idx = (mass >= p).sum(dim=1, keepdim=True)
        ts_pad = torch.cat([lo[:, None], ts, hi[:, None]], dim=1)
        lo = torch.gather(ts_pad, 1, idx)[:, 0]
        hi = torch.gather(ts_pad, 1, idx + 1)[:, 0]
    return lo


def _sample_sharded(logits_local: torch.Tensor,
                    generator: Optional[torch.Generator], *,
                    temperature: float, top_k: int, top_p: float = 1.0,
                    group=None, row0: int = 0, batch: Optional[int] = None,
                    col0: int = 0, vocab: Optional[int] = None
                    ) -> torch.Tensor:
    """Sample from vocab-sharded logits (b, v_local) — rows [row0, row0 +
    b) of a ``batch``-row batch, vocab columns [col0, col0 + v_local) of
    ``vocab`` — without gathering the distribution; returns (b,) int32
    token ids, the same on every rank of ``group`` (the "model" axis).

    * greedy (temperature 0): each shard's (max, argmax), the (tp, b)
      tables gathered, the winning shard's id — the argmax of the gathered
      logits exactly (ties to the lowest id);
    * temperature: Gumbel-max, argmax(x/T − log q) with q ~ Exp(1), one
      categorical draw; q is drawn for the whole (batch, vocab) from
      ``generator`` on every rank alike and each shard takes its block, so
      data and model shards use distinct bits and expert shards identical
      ones — the draw of the unsharded sampler, which then picks the same
      token up to rounding;
    * top-k: each shard's k candidates gathered, the global k-th value a
      threshold;
    * top-p: :func:`_topp_threshold_sharded`.
    """
    b, v_local = logits_local.shape
    x = logits_local.to(torch.float32)
    if temperature > 0.0:
        x = x / temperature
        if top_k > 0:
            k = min(top_k, v_local)   # per-shard candidates; union ⊇ global
            cand = torch.topk(x, k, dim=1).values                  # (b, k)
            pool = all_gather(cand, group, dim=1)                  # (b, tp·k)
            kth = torch.topk(pool, min(top_k, pool.shape[1]),
                             dim=1).values[:, -1:]
            x = torch.where(x < kth, float("-inf"), x)
        if top_p < 1.0:
            cut = _topp_threshold_sharded(x, top_p, group)
            # The top-1 always survives: its logit is above the bracket.
            x = torch.where(x > cut[:, None], x, float("-inf"))
        q = torch.empty((batch or b, vocab or v_local), device=x.device)
        q.exponential_(1, generator=generator)
        x = x - torch.log(q[row0:row0 + b, col0:col0 + v_local])
    local_max = x.amax(dim=1)                                      # (b,)
    local_arg = x.argmax(dim=1).to(torch.int32)                    # (b,)
    all_max = all_gather(local_max[None], group, dim=0)            # (tp, b)
    all_arg = all_gather(local_arg[None], group, dim=0)            # (tp, b)
    win = all_max.argmax(dim=0)                                    # (b,)
    picked = all_arg.gather(0, win[None])[0]
    return picked + (win * v_local).to(torch.int32)


# The steps, memoized per (mesh, cfg, variant) as JAX memoizes its compiled
# programs; here a step is a closure over its shard's place and process
# groups, so the memo saves only their set-up. It is keyed by the mesh
# object (kept alive in the entry, so its id is not reused): two
# DeviceMeshes of one shape compare equal whatever their groups, and a
# process that joins a group again must not get steps over the old one.
# :func:`clear_program_memo` drops it.
_PROGRAM_MEMO: dict = {}


def _memo(key, mesh, build):
    hit = _PROGRAM_MEMO.get(key)
    if hit is None:
        hit = _PROGRAM_MEMO[key] = (mesh, build())
    return hit[1]


def clear_program_memo() -> None:
    """Drop the memoized steps."""
    _PROGRAM_MEMO.clear()


def make_sharded_decode_step(mesh, cfg: ModelConfig, params: ModelParams,
                             *, sample: Optional[dict] = None):
    """This rank's decode step on ``mesh``.

    Default: ``step(params, tokens, caches, seq_lens) -> (logits, caches)``
    with ``params`` and ``caches`` this rank's (:func:`shard_params`,
    :func:`shard_caches`; the caches updated in place), tokens and
    seq_lens (batch,) whole, and the logits (batch, vocab) f32 gathered
    whole on every rank.

    ``sample={"temperature": t, "top_k": k, "top_p": p}``: sampling moves
    into the step — ``step(params, tokens, caches, seq_lens, generator) ->
    (next_tokens (batch,) int32, caches)`` — through
    :func:`_sample_sharded`, so no rank gathers the (batch, vocab) logits;
    greedy (t = 0) gives the argmax of the gathered logits exactly.
    ``params`` (the whole parameters, as in JAX) is not read: the step's
    shapes follow ``cfg``."""
    return _memo(("decode", id(mesh), cfg,
                  tuple(sorted(sample.items())) if sample else None), mesh,
                 lambda: _decode_step(mesh, cfg, sample))


def _decode_step(mesh, cfg: ModelConfig, sample: Optional[dict]):
    sh = _shard_of(mesh, cfg)
    model_rank = mesh.get_local_rank("model")

    def local_forward(params, tokens, caches, seq_lens):
        b = caches[0].k_q.shape[0]
        r0 = sh.d * b
        toks, lens = tokens[r0:r0 + b], seq_lens[r0:r0 + b]
        logits, caches = forward(params, toks[:, None], caches,
                                 lens[:, None], lens + 1, cfg,
                                 attn_kw=sh.attn_kw, moe_kw=sh.moe_kw)
        return logits[:, 0], caches, r0

    if sample is None:
        def step(params, tokens, caches, seq_lens):
            logits, caches, _ = local_forward(params, tokens, caches,
                                              seq_lens)
            logits = all_gather(logits, sh.model, dim=1)
            return all_gather(logits, sh.data, dim=0), caches
    else:
        temp = float(sample.get("temperature", 0.0))
        top_k = int(sample.get("top_k", 0))
        top_p = float(sample.get("top_p", 1.0))

        def step(params, tokens, caches, seq_lens, generator=None):
            logits, caches, r0 = local_forward(params, tokens, caches,
                                               seq_lens)
            nxt = _sample_sharded(
                logits, generator, temperature=temp, top_k=top_k,
                top_p=top_p, group=sh.model, row0=r0,
                batch=tokens.shape[0], col0=model_rank * logits.shape[1],
                vocab=cfg.vocab_size)
            return all_gather(nxt, sh.data, dim=0), caches
    return step


def make_sharded_prefill_step(mesh, cfg: ModelConfig, params: ModelParams,
                              bucket: int, n_slots: int = 1):
    """This rank's batched-admission prefill on ``mesh``: up to ``n_slots``
    bucket-padded prompts through the full model.

    ``step(params, caches, tokens, slots, true_lens) -> (last_logits,
    caches)`` with tokens (n_slots, bucket), slots (n_slots,) (-1 =
    padding row) and true_lens (n_slots,) the same on every rank (host
    arrays or tensors); the last real position's logits (n_slots, vocab)
    f32 come back whole on every rank, and the caches are updated in
    place.

    The rows split over "data": shard d computes rows [d·⌈S/dp⌉,
    (d+1)·⌈S/dp⌉) (rows past S reuse row 0's tokens at length 1 and are
    dropped) on scratch copies of cache rows, while tp/ep work within each
    row. The fresh KV prefixes (``bucket`` positions) are then gathered over
    "data" and each shard writes the rows whose slots it owns; the others
    are dropped, as JAX's ``mode="drop"`` scatter drops them. Per-row math
    has no cross-row reduction, so with tp = 1 the caches equal the
    one-device batched prefill's."""
    dp = axis_size(mesh, "data")
    S = n_slots
    S_local = -(-S // dp)
    metrics.gauge("engine.prefill_rows_per_shard", S_local)
    return _memo(("prefill", id(mesh), cfg, bucket, n_slots), mesh,
                 lambda: _prefill_step(mesh, cfg, bucket, S, S_local))


def _prefill_step(mesh, cfg: ModelConfig, bucket: int, S: int,
                  S_local: int):
    sh = _shard_of(mesh, cfg)

    def step(params, caches, tokens, slots, true_lens):
        dev = caches[0].k_q.device
        slots = np.asarray(torch.as_tensor(slots).cpu(), np.int64)
        true_lens = np.asarray(torch.as_tensor(true_lens).cpu(), np.int64)
        tokens = torch.as_tensor(tokens)
        local_slots = caches[0].k_q.shape[0]
        my_rows = sh.d * S_local + np.arange(S_local)
        pad_row = my_rows >= S
        safe = np.where(pad_row, 0, my_rows)
        lens = np.where(pad_row, 1, np.maximum(true_lens[safe], 1))
        # The cache rows this shard computes into: its rows' slots where it
        # owns them, else a scratch copy of local row 0; the results reach
        # their owners through the gather below.
        comp = torch.from_numpy(np.clip(slots[safe] - sh.d * local_slots, 0,
                                        local_slots - 1)).to(dev)
        sub = [KVCache(**{n: getattr(c, n)[comp] for n in _CACHE_FIELDS})
               for c in caches]
        lens_t = torch.from_numpy(lens.astype(np.int32)).to(dev)
        pos = torch.arange(bucket, dtype=torch.int32, device=dev)[None]
        logits, sub = forward(
            params, tokens[torch.from_numpy(safe)].to(dev), sub,
            pos.expand(S_local, bucket), lens_t, cfg,
            prefill_start=torch.zeros_like(lens_t), attn_kw=sh.attn_kw,
            moe_kw=sh.moe_kw)
        last = logits[torch.arange(S_local, device=dev),
                      lens_t.to(torch.int64) - 1]       # (S_local, v_local)
        last = all_gather(all_gather(last, sh.model, dim=1), sh.data,
                          dim=0)[:S]
        local_slot = slots - sh.d * local_slots
        owned = np.nonzero((slots >= 0) & (local_slot >= 0)
                           & (local_slot < local_slots))[0]
        src = torch.from_numpy(owned).to(dev)
        dst = torch.from_numpy(local_slot[owned]).to(dev)
        for c, s in zip(caches, sub):
            for n in _CACHE_FIELDS:
                rows = all_gather(getattr(s, n)[:, :, :bucket], sh.data,
                                  dim=0)[:S]
                getattr(c, n)[dst, :, :bucket] = rows[src]
        return last, caches
    return step
