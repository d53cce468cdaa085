"""Three-tier tiling selection front door (``select_config``).

Port of ``deepgemm_ascend_tpu/tiling/selector.py`` (≙ the reference's
``SelectKernelWithCache`` → predictor → analytic chain,
``op_tiling/select_kernel.cpp:333-388``), with JAX's tier order and metric
names:

    override  →  cache hit  →  learned predictor  →  analytic

* a caller's config wins (JAX :108-109);
* a hit in the cache (``tiling.cache_hit``; else ``tiling.cache_miss``):
  the process-wide cache of the device's kind (``tiling/cache.py``: the
  port's packaged table, the ``DGA_CACHE_FILE_PATH`` file, the autotuner's
  winners) unless the caller passes its own;
* the op's registered predictor (``tiling.predictor_pick`` /
  ``tiling.predictor_decline``, each also per op); the packaged default
  installs on the first miss only where its weights were trained on the
  device's kind (``tiling/predictor.py``), ``DGA_PREDICTOR_PATH`` names
  weights for ``fp8_gemm_nt`` (no kind check, as in JAX), and
  ``DGA_DISABLE_PREDICTOR=1`` opts out;
* the analytic config (``tiling.analytic_pick``): the tile, family and
  split count the kernels picked before their tiles became selectable
  (``tiling/analytic.py:get_best_config``).

The winner is written back to the in-memory cache (not to its file), so a
repeated shape is one lookup. The wrappers ask :func:`launch_config`,
which memoises the tiers' answer fitted to the operands' route by
everything the tiers read (≙ JAX choosing a config once, when it traces a
shape): a launch of a seen shape pays one dictionary lookup, and the
tiers' metrics count its first selection only.

The key is JAX's (``cache_key``; ``extra`` = ``g{k_granularity}``, and
``b{batch}`` after it for a batch of more than one, whose tile the whole
grid decides), with two additions (:func:`key_extra`): ``e{expected_m}``
for a masked grouped op given the rows an expert is expected to hold
below M_max (the tile follows them: decode and prefill at one capacity
are two keys; JAX keys on M_max alone), and ``/folded`` for K12, whose
tiles are not K1's though its op is. The device's kind picks the cache
and the predictor, and its envelope the analytic answer (a CPU tensor:
one core, as before).

The grouped ops are keyed as JAX keys them: a masked op on M_max, a
contiguous one on the layout's m-tile (``block_m``), which the layout
fixes. A contiguous op's selected config names its kernel tile itself —
``block_m × block_n`` one of the route's compiled tiles, whose rows
divide the key's m-tile (:func:`analytic.tile_admits`) — where a caller's
config keeps JAX's meaning of block_m, the layout's m-tile
(``ops.grouped_gemm.contiguous_tiles``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..config import GemmConfig, KernelType
from . import analytic
from . import platform as plat
from . import cache as cachemod
from .cache import TilingCache, cache_key, dtype_name, global_cache

# Learned predictors, one per op (≙ the reference's per-operator MLPs);
# registered lazily, off the hot path.
_predictors: dict = {}
_default_predictor_tried = False

# Ops a predictor may serve: the ops whose kernels have tile variants.
PREDICTOR_OPS = ("gemm", "gemm_nt", "gemm_tn", "gemm_tt", "bgemm",
                 "int8_gemm_nt", "fp8_gemm_nt") + analytic.GROUPED_OPS
# The route with a key of its own: K12's, the fp8 ops' folded scale mode.
FOLDED = "folded"


# launch_config's answers, valid while cache.generation() is _memo_gen.
_memo: dict = {}
_memo_gen = -1


def register_predictor(predictor) -> None:
    """Install a learned cost predictor (tier 2) for ``predictor.op``; the
    analytic tier stays the fallback (≙ ``Predictor::UsePredictApi``)."""
    global _default_predictor_tried
    _predictors[predictor.op] = predictor
    _default_predictor_tried = True   # explicit registration wins
    cachemod._bump()


def clear_predictors() -> None:
    """Drop all registered predictors (test hook); the packaged default is
    not tried again."""
    global _default_predictor_tried
    _predictors.clear()
    _default_predictor_tried = True
    cachemod._bump()


def _maybe_enable_default_predictor(kind: str) -> None:
    """On the first cache miss, install each op's packaged predictor whose
    weights were trained on ``kind`` (``predictor.enable_default_predictor``
    checks); ``DGA_PREDICTOR_PATH`` installs ``fp8_gemm_nt``'s from that
    path, and ``DGA_DISABLE_PREDICTOR=1`` opts out."""
    global _default_predictor_tried
    if _default_predictor_tried:
        return
    _default_predictor_tried = True
    if os.environ.get("DGA_DISABLE_PREDICTOR") == "1":
        return
    from .predictor import enable_default_predictor
    for op in PREDICTOR_OPS:
        enable_default_predictor(op=op, strategy="topk_median", kind=kind)


def key_extra(op: str, m: int, k_granularity: int = 128, batch: int = 1,
              expected_m: Optional[int] = None,
              route: Optional[str] = None) -> str:
    """The ``extra`` field of a selection's cache key (module docstring):
    ``g{k_granularity}``, ``b{batch}`` for a batch of more than one,
    ``e{expected_m}`` for a masked op's hint below M_max, ``/folded`` on
    K12's route."""
    em = analytic.expected_rows(op, m, expected_m)
    return (f"g{k_granularity}" + (f"b{batch}" if batch > 1 else "")
            + (f"e{em}" if em is not None else "")
            + ("/" + FOLDED if route == FOLDED else ""))


def select_config(
    m: int, n: int, k: int,
    in_dtype=torch.bfloat16,
    out_dtype=torch.float32,
    *,
    op: str = "gemm",
    k_granularity: int = 128,
    cache: Optional[TilingCache] = None,
    override: Optional[GemmConfig] = None,
    device="cuda",
    batch: int = 1,
    expected_m: Optional[int] = None,
    route: Optional[str] = None,
) -> GemmConfig:
    """The tile config of an (m, n, k) problem of ``op`` on ``device``
    (tiers as in the module docstring). ``batch``: the batch of a
    ``bgemm``, counted in the tile's grid; ``expected_m``: a masked
    grouped op's rows an expert is expected to hold; ``route="folded"``:
    K12's tile for an fp8 op (no predictor serves it: the op's was
    trained on K1)."""
    if override is not None:
        return override
    from ..utils.logging import metrics

    in_name, out_name = dtype_name(in_dtype), dtype_name(out_dtype)
    folded = route == FOLDED
    key = cache_key(op, m, n, k, in_name, out_name,
                    key_extra(op, m, k_granularity, batch, expected_m, route))
    info = plat.detect(device)
    kind = info.device_kind
    cache = cache if cache is not None else global_cache(kind)

    hit = cache.get(key)
    if hit is not None:
        metrics.inc("tiling.cache_hit")
        return hit
    metrics.inc("tiling.cache_miss")

    _maybe_enable_default_predictor(kind)
    pred = None if folded else _predictors.get(op)
    if pred is not None:
        hint = {} if expected_m is None else {"expected_m": expected_m}
        cfg = pred.predict(m, n, k, in_dtype, out_dtype, op=op,
                           info=info, batch=batch, **hint)
        if cfg is not None:
            metrics.inc("tiling.predictor_pick")
            metrics.inc(f"tiling.predictor_pick.{op}")
            cache.set(key, cfg, persist=False)
            return cfg
        metrics.inc("tiling.predictor_decline")
        metrics.inc(f"tiling.predictor_decline.{op}")

    metrics.inc("tiling.analytic_pick")
    cfg = analytic.get_best_config(m, n, k, in_dtype, out_dtype, op=op,
                                   info=info, batch=batch,
                                   route=route if folded else None,
                                   expected_m=expected_m)
    cache.set(key, cfg, persist=False)  # analytic results are re-derivable
    return cfg


def fit_route(cfg: GemmConfig, route: str, m: int, n: int, k: int,
              in_dtype, out_dtype, *, op: str, device,
              batch: int = 1, expected_m: Optional[int] = None) -> GemmConfig:
    """A selected config for operands that take ``route``: ``cfg`` where
    its tile is one of that route's compiled tiles that can run the
    problem (:func:`analytic.tile_admits`), unsplit on K1's tile route,
    K12's and the grouped kernels', else the route's analytic config — the case of an
    offset view or a forced plan, which the shape-keyed tiers cannot see,
    or of an entry no kernel on the route can run. The XLA family and a
    padded config (whose operands are new tensors) pass unchanged."""
    if cfg.kernel_type == KernelType.XLA or cfg.pad_k:
        return cfg
    fam = analytic.family(op)
    tile = (cfg.block_m, cfg.block_n)
    splits_ok = cfg.k_split == 1 or (fam in ("gemm", "int8", "fp8")
                                     and route not in ("tile", FOLDED))
    if (tile in [t for _, t in analytic.route_tiles(op, route)]
            and analytic.tile_admits(op, route, *tile, m, n) and splits_ok):
        return cfg
    return analytic.get_best_config(m, n, k, in_dtype, out_dtype, op=op,
                                    info=plat.detect(device), batch=batch,
                                    route=route, expected_m=expected_m)


def launch_config(m: int, n: int, k: int, in_dtype, out_dtype, *, op: str,
                  device, route: Optional[str] = None,
                  k_granularity: int = 128, batch: int = 1,
                  expected_m: Optional[int] = None) -> GemmConfig:
    """The config a wrapper launches when its caller gives none:
    :func:`select_config`'s on ``device``, fitted to the ``route`` the
    operands take on the card (:func:`fit_route`; None on the CPU, but
    K12's "folded" always). Memoised, by everything the tiers read —
    ``expected_m`` too —, while no cache entry changes value, no cache is
    cleared or replaced and no predictor is registered or cleared
    (``cache.generation``)."""
    global _memo_gen
    gen = cachemod.generation()
    if gen != _memo_gen:
        _memo.clear()
        _memo_gen = gen
    key = (op, m, n, k, in_dtype, out_dtype, k_granularity, batch, device,
           route, expected_m)
    cfg = _memo.get(key)
    if cfg is None:
        cfg = select_config(m, n, k, in_dtype, out_dtype, op=op,
                            k_granularity=k_granularity, device=device,
                            batch=batch, expected_m=expected_m, route=route)
        if route is not None:
            cfg = fit_route(cfg, route, m, n, k, in_dtype, out_dtype, op=op,
                            device=device, batch=batch,
                            expected_m=expected_m)
        _memo[key] = cfg
    return cfg
