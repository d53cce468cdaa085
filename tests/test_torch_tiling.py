"""The port's tiling tiers against the JAX package's and against the picks
the kernels made before their tiles became selectable.

* ``cache_key`` equals JAX's; a JSONL that the port's cache writes reads
  back in both packages, and JAX's in the port (configs compared as
  dicts, exactly);
* the selector's tier order (override → cache → predictor → analytic) and
  its ``tiling.*`` metric names, beside JAX's selector on the same stubs;
* ``get_best_config`` / ``select_config`` (no cache file, no predictor)
  equal to the parent's picks — the kernel family and split count of the
  fitted split gate, the tile of the rule that lived in the C entries
  (``sm90::large_tile``, the ffma rule, K1's ``ring_plan``) — over a grid
  of the shapes the serving path, phase 2 and phase 5 call;
* the grouped ops and K12's folded route: with no cache, the tile the
  wrappers' and the C entry's rules picked; the masked ops' key carries
  ``expected_m``; a cached grouped tile is what the wrappers select;
* the padding tag on aligned and prime shapes, and a padded GEMM equal to
  the unpadded one (the plain version on the CPU, bit for bit);
* the packaged table's path never points into the JAX package's data.
"""

import itertools
import json
import os

import numpy as np
import pytest
import torch

from deepgemm_ascend_tpu.config import GemmConfig as JConfig
from deepgemm_ascend_tpu.tiling import cache as jcache
from deepgemm_ascend_tpu.tiling import padding as jpadding
from deepgemm_ascend_tpu.tiling import selector as jselector
from deepgemm_ascend_tpu.utils.logging import metrics as jmetrics
import deepgemm_ascend_tpu_torch as tdga
from deepgemm_ascend_tpu_torch import compat
from deepgemm_ascend_tpu_torch.config import GemmConfig, KernelType
from deepgemm_ascend_tpu_torch.tiling import (analytic, cache, padding,
                                              platform, selector)
from deepgemm_ascend_tpu_torch.utils.common import ceil_div
from deepgemm_ascend_tpu_torch.utils.logging import metrics

H100 = platform.H100
BF16, F32, INT8 = torch.bfloat16, torch.float32, torch.int8
FP8 = torch.float8_e4m3fn


# ---- the parent's picks, as the kernels and selector made them ----------

def _parent_split(op, m, n, k):
    """The parent's select_config family: the fitted gate on 64 × 64 × 64,
    K11 for the nn ops only."""
    kt, s = analytic.select_kernel_type(m, n, k, 64, 64, 64, H100)
    if kt == KernelType.KSPLIT and op not in ("gemm", "bgemm"):
        return KernelType.COMMON, 1
    return kt, s


def _parent_tile(route, m, n, batch=1, splits=1):
    """The tile the parent's C entries chose (gemm.cu, int8_gemm.cu)."""
    if route == "wgmma":
        tiles = ceil_div(m, 128) * ceil_div(n, 256) * batch * splits
        return (128, 256) if m > 64 and tiles >= 100 else (64, 64)
    if route == "ffma":
        if m <= 16:
            return 16, 128
        tiles = ceil_div(m, 128) * ceil_div(n, 128) * batch * splits
        return (128, 128) if m > 64 and tiles >= 100 else (64, 64)
    return 64, 64


def _parent_ring_plan(m, n, k, sms=132):
    """The parent's ops/fp8_gemm.py:ring_plan."""
    tile = 0 if m <= 16 else 1
    bm = (16, 64)[tile]
    tiles = ceil_div(m, bm) * (n // 64)
    groups = k // 128
    if 2 * tiles > sms:
        return tile, 1
    return tile, max(1, min(8, groups // 2, max(sms // tiles,
                                                 ceil_div(groups, 12))))


def _parent_grouped_tile(op, m, expected_m):
    """The tile the parent's grouped wrappers chose on their Hopper routes
    (ops/grouped_gemm.py: ring_tile, contiguous_tile; ops/int8_gemm.py:
    masked_plan) for M_max or the layout's block_m ``m``."""
    rows = m if expected_m is None else max(0, min(m, expected_m))
    if op.startswith("grouped_gemm_masked"):
        return (16, 64) if rows <= 16 else (64, 64)
    if op.startswith("int8_grouped_gemm_masked"):
        if rows <= 16:
            return 16, 64
        return (128, 256) if rows > 64 else (64, 64)
    if op.startswith("grouped_gemm"):
        return (128, 128) if m % 128 == 0 else (64, 128)
    return (128, 256) if m % 128 == 0 else (64, 64)


def _parent_folded_tile(m, n):
    """The tile of the parent's csrc/fp8_gemm.cu:tile_folded."""
    rows128 = -(-m // 128)
    if n % 256 == 0 and m > 64 and rows128 * (n // 256) >= 100:
        return 128, 256
    if n % 256 != 0 and m > 64 and rows128 * (n // 128) >= 100:
        return 128, 128
    return 64, 64


LITE_GEMMS = [(2048, 2048), (512, 2048), (22016, 2048), (2048, 11008),
              (2816, 2048), (2048, 1408), (2048, 10944)]
DENSE_M = (1, 16, 64, 128, 1024, 2048)


def _dense_grid():
    rows = [(op, m, n, k, dt, 1) for (n, k), m, op, dt in itertools.product(
        LITE_GEMMS, DENSE_M, ("gemm", "gemm_nt"), (BF16, F32))]
    rows += [("gemm", 2048, 2048, 2048, dt, 1) for dt in (BF16, F32)]
    rows += [(op, 2048, 2048, 2048, F32, 1)
             for op in ("gemm_nt", "gemm_tn", "gemm_tt")]
    rows += [("gemm", 16, 22016, 2048, F32, 1), ("gemm", 16, 2048, 11008,
                                                 BF16, 1),
             ("gemm", 4096, 4096, 4096, BF16, 1), ("gemm", 16, 512, 2048,
                                                   BF16, 1)]
    rows += [("bgemm", m, 2048, 2048, dt, 4) for m in (16, 2048)
             for dt in (BF16, F32)]
    return rows


@pytest.mark.parametrize("op,m,n,k,dt,batch", _dense_grid())
def test_get_best_config_equals_the_parent_picks_dense(op, m, n, k, dt,
                                                       batch):
    cfg = analytic.get_best_config(m, n, k, dt, F32, op=op, info=H100,
                                   batch=batch)
    kt, s = _parent_split(op, m, n, k)
    rt = analytic.expected_route(op, m, n, k, dt)
    assert not cfg.pad_k
    assert (cfg.kernel_type, cfg.k_split) == (kt, s)
    splits = s if kt == KernelType.KSPLIT else 1
    assert (cfg.block_m, cfg.block_n) == _parent_tile(rt, m, n, batch,
                                                      splits)
    assert cfg.block_k == 64


@pytest.mark.parametrize("m", [1, 16, 64, 128, 512, 1024, 2048])
@pytest.mark.parametrize("n,k", LITE_GEMMS[:6] + [(2048, 10880)])
def test_get_best_config_equals_the_parent_picks_fp8(m, n, k):
    """K1 at the V2_LITE projections (the serving path's decode and
    prefill rows): the parent's ring plan."""
    n = -(-n // 128) * 128
    cfg = analytic.get_best_config(m, n, k, FP8, BF16, op="fp8_gemm_nt",
                                   info=H100)
    tile, splits = _parent_ring_plan(m, n, k)
    assert (cfg.block_m, cfg.block_n) == analytic.RING_TILES[tile]
    assert cfg.k_split == splits
    assert cfg.kernel_type == (KernelType.KSPLIT if splits > 1
                               else KernelType.COMMON)
    tile_route = analytic.get_best_config(m, n, k, FP8, BF16, op="fp8_gemm",
                                          info=H100)
    assert (tile_route.block_m, tile_route.block_n, tile_route.k_split) == \
        (64, 64, 1)


@pytest.mark.parametrize("m,n,k,b_t", [(16, 22016, 2048, True),
                                       (2048, 22016, 2048, True),
                                       (64, 2048, 2048, True),
                                       (33, 384, 1000, False),
                                       (16, 2048, 1000, True)])
def test_get_best_config_equals_the_parent_picks_int8(m, n, k, b_t):
    op = "int8_gemm_nt" if b_t else "int8_gemm"
    cfg = analytic.get_best_config(m, n, k, INT8, BF16, op=op, info=H100)
    rt = "wgmma" if b_t and k % 16 == 0 else "int8_tile"
    assert analytic.expected_route(op, m, n, k, INT8) == rt
    assert (cfg.block_m, cfg.block_n, cfg.block_k) == (*_parent_tile(
        rt, m, n), 128)
    assert (cfg.kernel_type, cfg.k_split) == (KernelType.COMMON, 1)


def test_select_config_with_no_cache_and_no_predictor_is_the_parent(
        monkeypatch):
    """The front door, with an empty cache and no predictor, answers the
    analytic config: the parent's family, split count and tile."""
    monkeypatch.setattr(platform, "detect", lambda device="cuda": H100)
    selector.clear_predictors()
    for op, m, n, k, dt, batch in _dense_grid():
        c = cache.TilingCache()
        got = selector.select_config(m, n, k, dt, F32, op=op, cache=c,
                                     batch=batch)
        assert got == analytic.get_best_config(m, n, k, dt, F32, op=op,
                                               info=H100, batch=batch)
        kt, s = _parent_split(op, m, n, k)
        assert (got.kernel_type, got.k_split) == (kt, s)


GROUPED = [op + sfx for op in ("grouped_gemm_masked", "grouped_gemm",
                                "int8_grouped_gemm_masked",
                                "int8_grouped_gemm") for sfx in ("", "_nt")]


@pytest.mark.parametrize("op", GROUPED)
def test_grouped_select_config_with_no_cache_is_the_parent_rule(
        op, monkeypatch):
    """Every grouped op, with an empty cache and no predictor, answers the
    tile its wrapper's rule picked, on the route its stored operands take
    (B K-major: the Hopper routes; else the tile routes' 64 × 64), over
    M_max / block_m × expected_m; never split."""
    monkeypatch.setattr(platform, "detect", lambda device="cuda": H100)
    selector.clear_predictors()
    masked = "masked" in op
    dt = INT8 if op.startswith("int8") else FP8
    ms = (1, 16, 96, 768, 3072, 12288) if masked else (64, 96, 128, 192,
                                                       256)
    hints = (None, -1, 0, 3, 16, 17, 24, 64, 65, 384, 20000) if masked \
        else (None,)
    for m, em, (n, k) in itertools.product(ms, hints, ((2816, 2048),
                                                       (2048, 1408))):
        got = selector.select_config(m, n, k, dt, BF16, op=op,
                                     cache=cache.TilingCache(),
                                     expected_m=em)
        rt = analytic.expected_route(op, m, n, k, dt)
        hopper = op.endswith("_nt") and (masked or m % 64 == 0)
        want = _parent_grouped_tile(op, m, em) if hopper else (64, 64)
        assert (got.block_m, got.block_n) == want, (m, em, n, k)
        assert rt in (("tile", "int8_tile") if not hopper else
                      ("ring", "wgmma", "wgmma16"))
        assert (got.kernel_type, got.k_split) == (KernelType.COMMON, 1)
        assert got.block_k == 128


@pytest.mark.parametrize("op", ["fp8_gemm", "fp8_gemm_nt"])
def test_folded_route_with_no_cache_is_the_kernels_rule(op, monkeypatch):
    """K12's tile from the tiers (route "folded") is the rule that the C
    entry compiled in (sm90::large_tile), whatever K1 picked at the shape
    before it: the route has a key of its own."""
    monkeypatch.setattr(platform, "detect", lambda device="cuda": H100)
    monkeypatch.setattr(selector, "_memo", {})
    selector.clear_predictors()
    c = cache.TilingCache()
    monkeypatch.setattr(selector, "global_cache", lambda kind=None: c)
    for m, (n, k) in itertools.product((1, 16, 64, 65, 200, 2048, 4096),
                                       LITE_GEMMS[:6] + [(2944, 2048),
                                                         (1408, 2048)]):
        k1 = selector.launch_config(m, n, k, FP8, BF16, op=op, device="cuda",
                                    route="ring" if op.endswith("_nt")
                                    else "tile", k_granularity=128)
        got = selector.launch_config(m, n, k, FP8, BF16, op=op,
                                     device="cuda", route="folded",
                                     k_granularity=128)
        assert (got.block_m, got.block_n) == _parent_folded_tile(m, n)
        assert k1.block_k == got.block_k == 128
    assert any(key.endswith("g128/folded") for key, _ in c)


def test_two_expected_m_at_one_m_max_get_two_keys(monkeypatch):
    """Decode and prefill at one capacity are two keys (and two tiles);
    without a hint, or with one not below M_max, the key is JAX's."""
    monkeypatch.setattr(platform, "detect", lambda device="cuda": H100)
    selector.clear_predictors()
    c = cache.TilingCache()
    picks = {em: selector.select_config(768, 2816, 2048, INT8, BF16,
                                        op="int8_grouped_gemm_masked_nt",
                                        cache=c, expected_m=em)
             for em in (3, 96, None, 768, 5000)}
    keys = sorted(key for key, _ in c)
    base = "int8_grouped_gemm_masked_nt:m768n2816k2048:int8->bfloat16:g128"
    assert keys == sorted([base, base + "e3", base + "e96"])
    assert base == jcache.cache_key("int8_grouped_gemm_masked_nt", 768, 2816,
                                    2048, "int8", "bfloat16", "g128")
    assert (picks[3].block_m, picks[96].block_m, picks[None].block_m) == \
        (16, 128, 128)
    assert picks[768] == picks[5000] == picks[None]


@pytest.mark.parametrize("op,em,cached,label", [
    ("grouped_gemm_masked_nt", 3, (64, 64), "ring 64x64"),
    ("int8_grouped_gemm_masked_nt", 3, (128, 256), "wgmma 128x256"),
    ("int8_grouped_gemm_masked_nt", 96, (16, 64), "ring 16x64"),
    ("grouped_gemm_nt", None, (64, 128), "wgmma16 64x128"),
    ("int8_grouped_gemm_nt", None, (64, 64), "wgmma 64x64")])
def test_a_cached_grouped_tile_is_what_the_wrapper_launches(
        op, em, cached, label, monkeypatch):
    """A cache entry under the grouped op's key (the autotuner's winner) is
    what ``launch_config`` returns for the wrapper's route and what the
    wrapper selects and counts (``grouped_gemm.selected_tile``, the tile
    code and the plan label of its launch); the analytic pick before it
    was another tile. A contiguous op keys on the layout's block_m."""
    from deepgemm_ascend_tpu_torch.ops import fp8_gemm as tf
    from deepgemm_ascend_tpu_torch.ops import grouped_gemm as gg
    from deepgemm_ascend_tpu_torch.ops import int8_gemm as i8
    monkeypatch.setattr(platform, "detect", lambda device="cuda": H100)
    selector.clear_predictors()
    c = cache.TilingCache()
    monkeypatch.setattr(selector, "global_cache", lambda kind=None: c)
    monkeypatch.setattr(selector, "_memo", {})
    int8 = op.startswith("int8")
    dt = INT8 if int8 else FP8
    m = 96 if "masked" in op else 128
    rt = analytic.expected_route(op, m, 2816, 2048, dt)
    dev = torch.device("cuda")
    before = gg.selected_tile(op, rt, m, 2816, 2048, dt, BF16, dev, em)
    assert before != cached
    c.set(cache.cache_key(op, m, 2816, 2048, cache.dtype_name(dt),
                          "bfloat16", selector.key_extra(op, m, 128, 1, em)),
          GemmConfig(*cached, 128), persist=False)
    got = selector.launch_config(m, 2816, 2048, dt, BF16, op=op, device=dev,
                                 route=rt, k_granularity=128, expected_m=em)
    assert (got.block_m, got.block_n) == cached
    tile = gg.selected_tile(op, rt, m, 2816, 2048, dt, BF16, dev, em)
    assert tile == cached
    kr, code = analytic.kernel_plan(op, rt, *tile)
    if op.startswith("grouped_gemm_masked"):
        assert tf.plan_label(kr, code) == label
    elif op.startswith("int8"):
        assert i8.masked_plan_label(kr, code) == label
    else:
        assert gg.contiguous_plan_label(kr, code) == label


def test_grouped_launch_config_counts_the_tiers_once_a_shape(monkeypatch):
    """The wrappers' memoised grouped selection: the tiers' counters move
    once for each (shape, expected_m), and a repeated launch is a lookup."""
    monkeypatch.setattr(platform, "detect", lambda device="cuda": H100)
    selector.clear_predictors()
    c = cache.TilingCache()
    monkeypatch.setattr(selector, "global_cache", lambda kind=None: c)
    monkeypatch.setattr(selector, "_memo", {})
    metrics.reset()
    for _ in range(5):
        for em in (3, 24, 384):
            selector.launch_config(12288, 2816, 2048, FP8, BF16,
                                   op="grouped_gemm_masked_nt",
                                   device="cuda", route="ring",
                                   k_granularity=128, expected_m=em)
    assert _tiling_counts(metrics.snapshot()) == {
        "tiling.cache_miss": 3, "tiling.analytic_pick": 3}


@pytest.mark.parametrize("op,rt,tile,why", [
    ("grouped_gemm_masked_nt", "ring", (128, 128), "no compiled"),
    ("grouped_gemm_masked", "tile", (16, 64), "no compiled"),
    ("grouped_gemm_nt", "wgmma16", (128, 256), "no compiled"),
    ("int8_grouped_gemm_masked_nt", "wgmma", (128, 128), "no compiled"),
    ("int8_grouped_gemm_nt", "wgmma", (16, 64), "no compiled"),
    ("fp8_gemm_nt", "folded", (16, 64), "no compiled")])
def test_an_uncompiled_grouped_or_folded_tile_raises(op, rt, tile, why):
    with pytest.raises(ValueError, match=why) as e:
        analytic.kernel_plan(op, rt, *tile)
    for _, t in analytic.route_tiles(op, rt):
        assert "%dx%d" % t in str(e.value)


@pytest.mark.parametrize("op,rt,block_m,block_n,want", [
    ("grouped_gemm_nt", "wgmma16", 128, 128, (128, 128)),
    ("grouped_gemm_nt", "wgmma16", 192, 128, (64, 128)),
    ("grouped_gemm_nt", "wgmma16", 128, 256, None),
    ("grouped_gemm", "tile", 96, 64, (64, 64)),
    ("grouped_gemm", "tile", 96, 256, None),
    ("int8_grouped_gemm_nt", "wgmma", 256, 256, (128, 256)),
    ("int8_grouped_gemm_nt", "wgmma", 192, 256, None),
    ("int8_grouped_gemm_nt", "wgmma", 192, 64, (64, 64))])
def test_a_caller_contiguous_config_names_a_compiled_tile(op, rt, block_m,
                                                          block_n, want):
    """A caller's config on a contiguous op: block_m the layout's m-tile,
    the tile the compiled one of block_n columns whose rows are the
    largest that divide it; none such raises, naming the compiled
    tiles."""
    from deepgemm_ascend_tpu_torch.ops import grouped_gemm as gg
    if want is None:
        with pytest.raises(ValueError, match="compiled"):
            gg.caller_contiguous_tile(op, rt, block_m, block_n)
    else:
        assert gg.caller_contiguous_tile(op, rt, block_m, block_n) == want


# ---- cache ---------------------------------------------------------------

@pytest.mark.parametrize("args", [
    ("gemm", 16, 2048, 11008, "bfloat16", "float32", "g128"),
    ("fp8_gemm_nt", 2048, 22016, 2048, "float8_e4m3fn", "bfloat16", "g128"),
    ("int8_gemm_nt", 1, 2, 3, "int8", "float32", ""),
    ("bgemm", 16, 2048, 2048, "float32", "float32", "g128b4")])
def test_cache_key_equals_jax(args):
    assert cache.cache_key(*args) == jcache.cache_key(*args)


def test_cache_key_dtype_names_are_jax_names():
    import jax.numpy as jnp
    for t, j in ((BF16, jnp.bfloat16), (F32, jnp.float32), (INT8, jnp.int8),
                 (FP8, jnp.float8_e4m3fn), (torch.float16, jnp.float16)):
        assert cache.dtype_name(t) == jnp.dtype(j).name


def test_a_jsonl_the_port_writes_reads_back_in_both_packages(tmp_path):
    path = str(tmp_path / "t.jsonl")
    c = cache.TilingCache(path)
    entries = {
        "gemm:m16n2048k11008:bfloat16->float32:g128": GemmConfig(
            64, 64, 64, kernel_type=KernelType.KSPLIT, k_split=8),
        "fp8_gemm_nt:m16n22016k2048:float8_e4m3fn->bfloat16:g128":
            GemmConfig(16, 64, 128),
        "gemm:m1279n5003k7681:bfloat16->float32:g128": GemmConfig(
            128, 256, 64, pad_k=True),
        "int8_gemm_nt:m16n22016k2048:int8->bfloat16:g128": GemmConfig(
            kernel_type=KernelType.XLA)}
    for key, cfg in entries.items():
        c.set(key, cfg)
    c.set(next(iter(entries)), next(iter(entries.values())))  # idempotent
    with open(path) as f:
        assert len([line for line in f if line.strip()]) == len(entries)
    with open(path, "a") as f:
        f.write('{"key": "partial", "config": {"block_m"\n')  # a torn line
    port, jax_ = cache.TilingCache(path), jcache.TilingCache(path)
    assert len(port) == len(jax_) == len(entries)
    for key, cfg in entries.items():
        assert port.get(key) == cfg
        assert jax_.get(key).to_dict() == cfg.to_dict()
    # and a file JAX writes reads back in the port
    jpath = str(tmp_path / "j.jsonl")
    jc = jcache.TilingCache(jpath)
    jc.set("gemm:m8n8k8:bfloat16->float32:g128", JConfig(128, 256, 512))
    assert cache.TilingCache(jpath).get(
        "gemm:m8n8k8:bfloat16->float32:g128").to_dict() == \
        JConfig(128, 256, 512).to_dict()


def test_cache_environment_variables(tmp_path, monkeypatch):
    for var in ("DGA_CACHE_FILE_PATH", "DGA_TPU_CACHE"):
        monkeypatch.delenv("DGA_CACHE_FILE_PATH", raising=False)
        monkeypatch.delenv("DGA_TPU_CACHE", raising=False)
        path = str(tmp_path / f"{var}.jsonl")
        monkeypatch.setenv(var, path)
        c = cache.TilingCache()
        assert c.path == path
        c.set("k", GemmConfig(64, 64, 64))
        assert os.path.exists(path)


def test_global_cache_per_device_kind(tmp_path):
    a = cache.global_cache("kind-a")
    assert cache.global_cache("kind-a") is a
    assert cache.global_cache("kind-b") is not a
    b = cache.reset_global_cache(str(tmp_path / "x.jsonl"), kind="kind-a")
    assert cache.global_cache("kind-a") is b and b is not a


@pytest.mark.parametrize("kind", ["tpu v5e", "tpu_v5e", "NVIDIA H100 80GB "
                                  "HBM3", "cpu"])
def test_packaged_path_never_points_into_the_jax_package(kind):
    path = cache.packaged_tilings_path(kind)
    jax_data = os.path.abspath(os.path.join(
        os.path.dirname(jcache.__file__), "..", "data"))
    assert cache.DATA_DIR.startswith(os.path.dirname(
        os.path.dirname(os.path.abspath(cache.__file__))))
    assert not cache.DATA_DIR.startswith(jax_data)
    assert path is None or (path.startswith(cache.DATA_DIR)
                            and not path.startswith(jax_data))
    if kind == "tpu v5e":   # the JAX package ships one; the port reads none
        assert os.path.exists(os.path.join(jax_data,
                                           "tilings_tpu_v5e.jsonl"))
        assert path is None


# ---- selector ------------------------------------------------------------

class _Stub:
    def __init__(self, op, cfg):
        self.op, self.cfg, self.calls = op, cfg, 0

    def predict(self, m, n, k, in_dtype, out_dtype, *, op="gemm", **kw):
        self.calls += 1
        return self.cfg


def _tiling_counts(snap):
    return {k: v for k, v in snap.items() if k.startswith("tiling.")}


def test_selector_tier_order_and_metric_names_equal_jax(monkeypatch):
    """override → cache hit → predictor (pick, then decline) → analytic,
    with JAX's metric names, run beside JAX's selector on the same stubs:
    the same counters move."""
    import jax.numpy as jnp
    monkeypatch.setattr(platform, "detect", lambda device="cuda": H100)
    over = GemmConfig(128, 128, 64)
    pick = GemmConfig(128, 256, 64)
    seen = {}
    for name, sel, mets, Cache, Cfg, dt, odt in (
            ("port", selector, metrics, cache.TilingCache, GemmConfig,
             BF16, F32),
            ("jax", jselector, jmetrics, jcache.TilingCache, JConfig,
             jnp.bfloat16, jnp.float32)):
        c = Cache()
        mets.reset()
        sel.clear_predictors()
        assert sel.select_config(256, 256, 256, dt, odt, cache=c,
                                 override=Cfg(128, 128, 64)).block_n == 128
        stub = _Stub("gemm", Cfg(128, 256, 64))
        sel.register_predictor(stub)
        first = sel.select_config(512, 512, 512, dt, odt, cache=c)
        again = sel.select_config(512, 512, 512, dt, odt, cache=c)
        assert first.to_dict() == again.to_dict() == pick.to_dict()
        assert stub.calls == 1                 # the second was a cache hit
        sel.register_predictor(_Stub("gemm", None))     # declines
        sel.select_config(1024, 1024, 1024, dt, odt, cache=c)
        seen[name] = _tiling_counts(mets.snapshot())
        sel.clear_predictors()
    assert seen["port"] == seen["jax"]
    assert seen["port"] == {
        "tiling.cache_hit": 1, "tiling.cache_miss": 2,
        "tiling.predictor_pick": 1, "tiling.predictor_pick.gemm": 1,
        "tiling.predictor_decline": 1, "tiling.predictor_decline.gemm": 1,
        "tiling.analytic_pick": 1}
    assert over.block_m == 128


def test_selector_analytic_answer_is_cached_in_memory_only(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(platform, "detect", lambda device="cuda": H100)
    selector.clear_predictors()
    path = tmp_path / "c.jsonl"
    c = cache.TilingCache(str(path))
    got = selector.select_config(2048, 2048, 2048, BF16, F32, cache=c)
    key = cache.cache_key("gemm", 2048, 2048, 2048, "bfloat16", "float32",
                          "g128")
    assert c.get(key) == got and not path.exists()
    # a bgemm's key carries its batch
    selector.select_config(16, 2048, 2048, BF16, F32, op="bgemm", cache=c,
                           batch=4)
    assert c.get(cache.cache_key("bgemm", 16, 2048, 2048, "bfloat16",
                                 "float32", "g128b4")) is not None


def test_a_cache_entry_is_what_the_wrapper_runs_on_the_cpu(monkeypatch):
    """A cached KSPLIT config reaches the dense GEMM's wrapper (the CPU
    runs K11's plain version) where the analytic answer was K10's."""
    c = cache.TilingCache()
    key = cache.cache_key("gemm", 64, 32, 256, "float32", "float32", "g128")
    c.set(key, GemmConfig(16, 128, 64, kernel_type=KernelType.KSPLIT,
                          k_split=2), persist=False)
    monkeypatch.setattr(cache, "global_cache", lambda kind=None: c)
    monkeypatch.setattr(selector, "global_cache", lambda kind=None: c)
    monkeypatch.setattr(selector, "_memo", {})   # no earlier process answer
    from deepgemm_ascend_tpu_torch.ops import _kernels
    k11 = _kernels.COUNTERS["gemm_ksplit"]
    before = k11.plain_calls
    a, b = torch.randn(64, 256), torch.randn(256, 32)
    tdga.gemm(a, b)
    assert k11.plain_calls == before + 1


def test_launch_config_memoises_until_an_answer_may_change(monkeypatch):
    """The wrappers' selection runs the tiers once a shape (their metrics
    count that once) and answers again from its memo, until a cache entry
    changes value, a cache is cleared or replaced, or a predictor is
    registered or cleared; a new entry of another shape keeps it."""
    c = cache.TilingCache()
    monkeypatch.setattr(selector, "global_cache", lambda kind=None: c)
    monkeypatch.setattr(selector, "_memo", {})
    selector.clear_predictors()
    args = (512, 512, 512, BF16, F32)
    key = cache.cache_key("gemm", *args[:3], "bfloat16", "float32", "g128")

    def pick():
        return selector.launch_config(*args, op="gemm", device="cpu")
    metrics.reset()
    first = pick()
    assert first == selector.select_config(*args, device="cpu", cache=c)
    metrics.reset()
    assert pick() == first and pick() == first
    assert _tiling_counts(metrics.snapshot()) == {}
    gen = cache.generation()
    c.set(cache.cache_key("gemm", 64, 64, 64, "bfloat16", "float32",
                          "g128"), GemmConfig(64, 64, 64))
    assert cache.generation() == gen and pick() == first
    other = GemmConfig(128, 128, 64, kernel_type=KernelType.KSPLIT,
                       k_split=2)
    assert other != first
    c.set(key, other, persist=False)
    assert cache.generation() > gen and pick() == other
    metrics.reset()
    c.clear()
    assert pick() == first
    assert _tiling_counts(metrics.snapshot()) == {
        "tiling.cache_miss": 1, "tiling.analytic_pick": 1}
    stub = _Stub("gemm", other)
    selector.register_predictor(stub)
    c.clear()
    assert pick() == other and stub.calls == 1
    selector.clear_predictors()
    c.clear()
    assert pick() == first
    gen = cache.generation()
    cache.reset_global_cache(None, kind="memo-test")
    assert cache.generation() > gen


# ---- candidates, tiles and the envelope ----------------------------------

@pytest.mark.parametrize("op,dt", [("gemm", BF16), ("gemm", F32),
                                   ("gemm_tt", F32), ("int8_gemm_nt", INT8),
                                   ("fp8_gemm_nt", FP8), ("bgemm", BF16),
                                   ("grouped_gemm_masked_nt", FP8),
                                   ("int8_grouped_gemm_masked_nt", INT8),
                                   ("grouped_gemm_nt", FP8),
                                   ("int8_grouped_gemm_nt", INT8)])
@pytest.mark.parametrize("m,n,k", [(16, 2048, 11008), (2048, 22016, 2048),
                                   (200, 1024, 640)])
def test_candidates_are_compiled_variants_that_fit(op, dt, m, n, k):
    cands = analytic.enumerate_candidates(op, m, n, k, dt, BF16, H100)
    fam = analytic.family(op)
    rt = analytic.expected_route(op, m, n, k, dt)
    assert cands
    for c in cands:
        kr, _ = analytic.instance(op, rt, c.block_m, c.block_n)
        assert (c.block_m, c.block_n) in [t for _, t in
                                          analytic.route_tiles(op, rt)]
        assert analytic.judge_space(kr, c.block_m, c.block_n, H100)
        assert c.block_k == analytic.K_STEP[fam]
        assert c.block_m <= max(-(-m // 64) * 64, 16)
        if fam in analytic.CONTIGUOUS and rt not in ("tile", "int8_tile"):
            assert m % c.block_m == 0
        if c.kernel_type == KernelType.KSPLIT:
            assert fam == "fp8" or op in analytic.KSPLIT_OPS
    assert analytic.get_best_config(m, n, k, dt, BF16, op=op,
                                    info=H100).replace(
        swizzle=cands[0].swizzle) in cands


def test_judge_space_holds_each_instance_to_the_card():
    for (rt, tile) in analytic._INSTANCES:
        assert analytic.judge_space(rt, *tile, H100), (rt, tile)
    small = platform.PlatformInfo("small", 132, smem_per_sm=64 * 1024,
                                  smem_per_block=64 * 1024)
    assert not analytic.judge_space("wgmma", 128, 256, small)
    assert not analytic.judge_space("wgmma", 96, 96, H100)   # not compiled


@pytest.mark.parametrize("op,rt,tile", [("gemm", "wgmma", (128, 128)),
                                        ("gemm", "ffma", (16, 128)),
                                        ("gemm", "mma_tile", (64, 64)),
                                        ("int8_gemm_nt", "wgmma", (128, 256)),
                                        ("fp8_gemm_nt", "ring", (16, 64)),
                                        ("fp8_gemm", "folded", (128, 256)),
                                        ("grouped_gemm_masked_nt", "ring",
                                         (64, 64)),
                                        ("grouped_gemm_nt", "wgmma16",
                                         (64, 128)),
                                        ("int8_grouped_gemm_nt", "wgmma",
                                         (128, 256))])
def test_tile_code_is_the_index_of_a_compiled_tile(op, rt, tile):
    fam = analytic.family(op)
    assert analytic.tile_code(op, rt, *tile) == \
        analytic.TILES[(fam, rt)].index(tile)


@pytest.mark.parametrize("op,rt,tile", [("gemm", "wgmma", (256, 256)),
                                        ("gemm", "mma_tile", (128, 256)),
                                        ("gemm", "ffma", (128, 256)),
                                        ("int8_gemm", "int8_tile", (128, 128)),
                                        ("fp8_gemm_nt", "ring", (128, 128))])
def test_a_tile_outside_the_compiled_set_raises(op, rt, tile):
    with pytest.raises(ValueError, match="no compiled"):
        analytic.tile_code(op, rt, *tile)


def test_estimate_time_is_the_split_gate_model_on_its_variant():
    for m, n, k, s in ((16, 2048, 11008, 1), (16, 2048, 11008, 8),
                       (64, 512, 4096, 4)):
        cfg = GemmConfig(64, 64, 64, kernel_type=(
            KernelType.KSPLIT if s > 1 else KernelType.COMMON), k_split=s)
        est = analytic.estimate_time("gemm", m, n, k, cfg, H100, BF16, F32)
        # model_seconds counts no output bytes: the f32 output adds to both
        ref = analytic.model_seconds(m, n, k, s, 64, 64, 64, H100)
        assert est.time_s >= ref and est.time_s < ref * 1.5


# ---- padding ---------------------------------------------------------------

@pytest.mark.parametrize("m,n,k", [(2048, 2048, 2048), (16, 22016, 2048),
                                   (64, 512, 128)])
def test_padding_tag_none_on_aligned_shapes(m, n, k):
    got = padding.get_padding_tag(m, n, k, info=H100)
    assert (got.mask_s, got.pad_s, got.tag) == (0.0, 0.0,
                                                padding.PaddingTag.NONE)
    # JAX's decision on a block_k that divides K is NONE too
    jgot = jpadding.get_padding_tag(m, n, k, 128, 128, 128)
    assert int(jgot.tag) == int(got.tag) == 0


@pytest.mark.parametrize("m,n,k", [(1279, 5003, 7681), (3511, 6151, 8191),
                                   (5119, 6997, 9901)])
def test_padding_tag_pads_the_prime_shapes(m, n, k):
    got = padding.get_padding_tag(m, n, k, info=H100)
    assert got.tag == padding.PaddingTag.PAD_K
    assert got.mask_s > got.pad_s > 0
    cfg = analytic.get_best_config(m, n, k, BF16, F32, info=H100)
    pn, pk = padding.padded_dims("gemm", m, n, k, BF16)
    assert cfg.pad_k and pk % 64 == 0 and pn % 8 == 0 and pn - n < 8
    assert (cfg.block_m, cfg.block_n) == _parent_tile("wgmma", m, pn)
    # amortised over many calls the pad wins more often, never less
    assert padding.get_padding_tag(m, n, k, info=H100,
                                   calls_amortized=8).tag == got.tag


def test_padding_tag_on_a_small_ragged_shape_masks():
    got = padding.get_padding_tag(33, 97, 1000, info=H100)
    assert got.tag == padding.PaddingTag.NONE and got.mask_s > 0
    cfg = analytic.get_best_config(33, 97, 1000, BF16, F32, info=H100)
    assert not cfg.pad_k and (cfg.block_m, cfg.block_n) == (64, 64)


@pytest.mark.parametrize("dt", [BF16, F32])
def test_a_padded_gemm_equals_the_unpadded_one(dt):
    """pad_k pads K with zeros and N to a 16-byte pitch; the output's
    padded columns are sliced off (the plain version, exact)."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn(33, 1001, generator=g).to(dt)
    b = torch.randn(1001, 97, generator=g).to(dt)
    want = tdga.gemm_with_config(a, b, config=GemmConfig(64, 64, 64))
    got = tdga.gemm_with_config(a, b, config=GemmConfig(64, 64, 64,
                                                        pad_k=True))
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-4)


# ---- compat knobs --------------------------------------------------------

@pytest.mark.parametrize("asked,rt,want", [
    ((64, 128), "wgmma", (64, 64)), ((128, 256), "wgmma", (128, 256)),
    ((256, 512), "wgmma", (128, 256)), ((128, 128), "ffma", (128, 128)),
    ((32, 128), "ffma", (16, 128)), ((8, 128), "wgmma", (64, 64)),
    ((512, 512), "mma_tile", (64, 64))])
def test_run_mmad_bench_maps_to_the_largest_compiled_tile(asked, rt, want):
    assert compat.bench_tile(*asked, rt) == want
    assert compat.BENCH_TILES[(*asked, rt)] == want


def test_packaged_table_is_json_lines_when_present():
    kind = platform.H100.device_kind
    path = cache.packaged_tilings_path(kind)
    if path is None:
        assert not os.path.exists(os.path.join(
            cache.DATA_DIR, f"tilings_{kind.replace(' ', '_')}.jsonl"))
        return
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            GemmConfig.from_dict(rec["config"])
