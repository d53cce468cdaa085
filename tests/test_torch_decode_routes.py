"""The CPU-side pieces of K2's "live" route and K6's routes.

K2 (``ops.flash_decode``): the grid of route "live" is fixed by the shapes
(``live_blocks``), and its blocks deal the live keys of all sequences out
on the card (``live_plan``, ``live_block_range``, which the kernel
computes the same way). The
tests pin that every live key is covered exactly once, that blocks differ
by at most one chunk, and that empty and freed slots (a length of 0, or
one at or past S, clamped) are handled. A plain PyTorch emulation of the
kernel's schedule — blocks over chunks, four warps of 16 keys a chunk each
with its own online softmax and bf16 rounding of p·v_scale against its
own running max, merged in the block and then across blocks — is held
against the JAX op (its Pallas kernel in interpret mode, eagerly) within
(2⁻⁷ + 2⁻¹²)·Σ w·|v| per element (``flash_common.PV_ROUNDING``, the scale
from the plain version run on |v|), plus 1e-4 of the output for l's f32
sum order.

K6 (``ops.int8_gemm``): ``tiling.analytic.masked_plan`` picks the route
and tile from the rows an expert is expected to hold; the hint changes no
result, and the MoE layer passes it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepgemm_ascend_tpu import models as jmodels
from deepgemm_ascend_tpu.ops import flash_decode as jd
from deepgemm_ascend_tpu_torch import models as tmodels
from deepgemm_ascend_tpu_torch.models import moe as tm
from deepgemm_ascend_tpu_torch.ops import flash_decode as td
from deepgemm_ascend_tpu_torch.ops import int8_gemm as ti
from deepgemm_ascend_tpu_torch.ops.flash_common import NEG_INF, PV_ROUNDING
from deepgemm_ascend_tpu_torch.tiling import analytic
from torch_bridge import to_numpy, to_torch, tree_of

H100_SMS = 132


# ---- K2: the block plan


@pytest.mark.parametrize("b,kvh,s_max,want", [
    (16, 4, 4096, 64 + 396),    # V2_LITE serving: 64 heads + 3 blocks an SM
    (16, 16, 4096, 256 + 396),  # V2_LITE_FULL's kv heads
    (64, 16, 2048, 1024 + 396),  # layer_bench V3_STYLE shard
    (16, 4, 80, 64 * 3),        # serve_bench engine: a block a chunk at most
    (16, 4, 104, 64 * 3),
    (1, 1, 64, 2),
])
def test_live_blocks(b, kvh, s_max, want):
    assert td.live_blocks(b, kvh, s_max, H100_SMS) == want


LENGTHS = {
    "ragged": [0, 1, 63, 64, 65, 77, 256, 1056, 4095, 4096],
    "serving": list(np.random.default_rng(0).integers(16, 1057, size=16)),
    "empty": [0, 0, 0],
    "full": [4096] * 4,
}


@pytest.mark.parametrize("lengths", sorted(LENGTHS))
@pytest.mark.parametrize("kvh", [1, 4])
@pytest.mark.parametrize("extra", [1, 3, 40, 396])
def test_live_plan_covers_every_key_once(lengths, kvh, extra):
    """For any grid of b·kvh + extra blocks: every live key of every
    (sequence, kv head) is taken by exactly one block, in order; a
    sequence's blocks differ by at most one chunk and each holds one; no
    block takes more than ceil(C / extra) chunks (C: all live chunks) but
    where LIVE_MAX_SPLITS caps a sequence; an empty sequence gets one block
    (which writes its zeros) and no key; the blocks past the plan take
    nothing."""
    lens = LENGTHS[lengths]
    blocks = len(lens) * kvh + extra
    plan = td.live_plan(lens, kvh, blocks)
    assert len(plan) == blocks
    chunk = td.LIVE_CHUNK
    total = sum(-(-n // chunk) for n in lens) * kvh
    quota = max(1, -(-total // extra))
    taken = {}
    for entry in plan:
        if entry is None:
            continue
        i, h, split, nb = entry
        t0, t1 = td.live_block_range(lens[i], split, nb)
        taken.setdefault((i, h), []).append((t0, t1))
        if nb < td.LIVE_MAX_SPLITS:
            assert -(-(t1 - t0) // chunk) <= quota
    assert sorted(taken) == [(i, h) for i in range(len(lens))
                             for h in range(kvh)]
    for (i, h), ranges in taken.items():
        keys = [t for t0, t1 in ranges for t in range(t0, t1)]
        assert keys == list(range(lens[i])), (i, h)
        counts = [-(-(t1 - t0) // chunk) for t0, t1 in ranges]
        assert max(counts) - min(counts) <= 1
        assert lens[i] == 0 or min(counts) >= 1
        assert all(t0 % chunk == 0 for t0, t1 in ranges)
    past = [k for k, e in enumerate(plan) if e is None]
    assert past == list(range(blocks - len(past), blocks))


def test_live_route_needs_aligned_tensors():
    cache = torch.zeros(2, 2, 64, 128, dtype=torch.int8)
    new = torch.zeros(2, 2, 128, dtype=torch.int8)
    assert td.route(cache, cache, new, new) == "live"
    off = torch.zeros(2 * 2 * 128 + 1, dtype=torch.int8)[1:].view(2, 2, 128)
    assert td.route(cache, cache, off, new) == "span"


@pytest.mark.parametrize("hd,k_off,v_off,want", [
    (128, 0, 0, "live"),
    (128, 16, 0, "live"),       # 16 bytes into the buffer: still aligned
    (128, 1, 0, "span"),        # TMA cannot read a cache off 16 bytes
    (128, 0, 8, "span"),
    (64, 0, 0, "span"),         # route "live" is built for head size 128
])
def test_read_route_by_head_size_and_alignment(hd, k_off, v_off, want):
    """K5a's and K5b's route: "live" at head size 128 where TMA can read
    both caches, else "span"; K2's adds its new rows' alignment."""
    def cache(off):
        n = 2 * 2 * 64 * hd
        return torch.zeros(n + off, dtype=torch.int8)[off:].view(2, 2, 64, hd)
    k_q, v_q = cache(k_off), cache(v_off)
    assert td.read_route(k_q, v_q) == want
    new = torch.zeros(2, 2, hd, dtype=torch.int8)
    off = torch.zeros(2 * 2 * hd + 1, dtype=torch.int8)[1:].view(2, 2, hd)
    assert td.route(k_q, v_q, new, new) == want
    assert td.route(k_q, v_q, off, new) == "span"


@pytest.mark.parametrize("plan", [None, ("live", 9), ("span", 128),
                                  ("live", 4)])
@pytest.mark.parametrize("state", [False, True])
def test_read_plans_leave_a_cpu_tensor_on_the_plain_version(plan, state):
    """``plan`` picks the kernel's route on the card; a CPU tensor runs
    the plain version whatever the plan (even one the kernel would refuse):
    one plain call, no launch, no plan counted, the plain result."""
    rng = np.random.default_rng(7)
    b, kvh, g, s_max, hd = 3, 2, 4, 64, 128
    cache = [torch.from_numpy(x) for x in (
        rng.integers(-127, 128, (b, kvh, s_max, hd), dtype=np.int8),
        (rng.random((b, kvh, s_max)) * 0.02 + 1e-3).astype(np.float32),
        rng.integers(-127, 128, (b, kvh, s_max, hd), dtype=np.int8),
        (rng.random((b, kvh, s_max)) * 0.02 + 1e-3).astype(np.float32))]
    q = torch.from_numpy(rng.normal(size=(b, kvh * g, hd)).astype(
        np.float32)).to(torch.bfloat16)
    lens = torch.tensor([0, 17, 64], dtype=torch.int32)
    fn = td.flash_decode_gqa_state if state else td.flash_decode_gqa
    plain = td.flash_decode_state_plain if state else td.flash_decode_plain
    counter = td.STATE_COUNTER if state else td.READ_COUNTER
    before = (counter.launches, counter.plain_calls, dict(counter.plans))
    got = fn(q, *cache, lens, plan=plan)
    assert (counter.launches, counter.plain_calls, counter.plans) == (
        before[0], before[1] + 1, before[2])
    want = plain(q, *cache, lens)
    if state:
        for x, y in zip(got, want):
            assert torch.equal(x, y.reshape(x.shape))
    else:
        assert torch.equal(got, want.reshape(got.shape))


def test_live_arrivals_are_kept_per_stream():
    """Route "live"'s arrival counts: one zeroed buffer per (device,
    stream), reused by the launches of that stream and grown when a launch
    needs more, never shared between two streams."""
    dev = torch.device("cpu")
    td._ARRIVALS.clear()
    a = td._arrivals(8, dev, 1)
    assert a.dtype == torch.int32 and a.numel() == 8 and not a.any()
    assert td._arrivals(4, dev, 1) is a
    b = td._arrivals(8, dev, 2)
    assert b is not a and not b.any()
    c = td._arrivals(16, dev, 1)
    assert c.numel() == 16 and not c.any()
    assert td._arrivals(8, dev, 1) is c and td._arrivals(8, dev, 2) is b
    td._ARRIVALS.clear()


# ---- K2: the kernel's schedule against JAX


def _warp_steps(t0, t1):
    """The 16-key steps of each of the four warps of a block over keys
    [t0, t1): in every chunk, warp w takes keys 16w .. 16w + 15."""
    chunk = td.LIVE_CHUNK
    steps = [[] for _ in range(4)]
    for c in range(t0, t1, chunk):
        for w in range(4):
            if c + 16 * w < t1:
                steps[w].append(c + 16 * w)
    return steps


def _merge(states):
    """The exact merge of (acc, m, l) states, as the kernels' merges."""
    m_all = torch.stack([m for _, m, _ in states]).amax(0)
    acc = sum(a * torch.exp(m - m_all)[:, None] for a, m, _ in states)
    l = sum(l * torch.exp(m - m_all) for _, m, l in states)
    return acc, m_all, l


def live_schedule(q, k_q, k_s, v_q, v_s, lens, n_blocks):
    """K2's route "live" in plain PyTorch over a grid of ``n_blocks``
    blocks (``live_plan``), on caches that already hold the new rows (the
    kernel splices them in; the values are the same). q (b, kvh, g, hd)
    f32 of bf16 values; lens clamped. Returns (b, kvh, g, hd) f32."""
    b, kvh, g, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    out = torch.zeros(b, kvh, g, hd)
    plan = [e for e in td.live_plan([int(n) for n in lens], kvh, n_blocks)
            if e is not None]
    for bi in range(b):
        length = int(lens[bi])
        for h in range(kvh):
            qh, kc, vc = q[bi, h], k_q[bi, h].float(), v_q[bi, h].float()
            ksc, vsc = k_s[bi, h], v_s[bi, h]
            blocks = []
            for _, _, split, nb in (e for e in plan if e[:2] == (bi, h)):
                t0, t1 = td.live_block_range(length, split, nb)
                if t1 == t0:
                    continue
                warps = []
                for steps in _warp_steps(t0, t1):
                    acc = torch.zeros(g, hd)
                    m = torch.full((g,), NEG_INF)
                    l = torch.zeros(g)
                    for k0 in steps:
                        keys = torch.arange(k0, k0 + 16)
                        valid = keys < t1
                        kk = keys.clamp(max=length - 1)
                        s = (qh @ kc[kk].T) * (ksc[kk] * scale)
                        s = torch.where(valid, s, torch.tensor(NEG_INF))
                        m_new = torch.maximum(m, s.amax(1))
                        alpha = torch.exp(m - m_new)
                        live = (m_new > NEG_INF * 0.5)[:, None]
                        p = torch.where(live, torch.exp(s - m_new[:, None]),
                                        torch.zeros_like(s))
                        l = l * alpha + p.sum(1)
                        w = torch.where(valid, (p * vsc[kk]).to(
                            torch.bfloat16).float(), torch.zeros_like(p))
                        acc = acc * alpha[:, None] + w @ vc[kk]
                        m = m_new
                    warps.append((acc, m, l))
                blocks.append(_merge(warps))
            if blocks:
                acc, _, l = _merge(blocks)
                out[bi, h] = acc / torch.where(l > 0, l, torch.ones_like(l))[
                    :, None]
    return out


def _decode_inputs(b, kvh, g, s_max, seed):
    rng = np.random.default_rng(seed)
    hd = 128
    k_q = rng.integers(-127, 128, size=(b, kvh, s_max, hd), dtype=np.int8)
    v_q = rng.integers(-127, 128, size=(b, kvh, s_max, hd), dtype=np.int8)
    k_s = (rng.random((b, kvh, s_max)) * 0.02 + 1e-3).astype(np.float32)
    v_s = (rng.random((b, kvh, s_max)) * 0.02 + 1e-3).astype(np.float32)
    q = rng.normal(size=(b, kvh * g, hd)).astype(np.float32)
    k_new = rng.integers(-127, 128, size=(b, kvh, hd), dtype=np.int8)
    v_new = rng.integers(-127, 128, size=(b, kvh, hd), dtype=np.int8)
    ks_new = (rng.random((b, kvh)) * 0.02 + 1e-3).astype(np.float32)
    vs_new = (rng.random((b, kvh)) * 0.02 + 1e-3).astype(np.float32)
    return q, (k_q, k_s, v_q, v_s), (k_new, v_new, ks_new, vs_new)


@pytest.mark.parametrize("kvh,g", [(2, 1), (1, 4), (1, 8)])
@pytest.mark.parametrize("extra", [1, 7])
def test_live_schedule_matches_jax(kvh, g, extra):
    """Lengths 0, 1, ragged (across chunk and warp edges), S and past S."""
    b, s_max, hd = 5, 256, 128
    q, cache, new = _decode_inputs(b, kvh, g, s_max, seed=10 * kvh + g)
    lens = np.asarray([0, 1, 77, s_max, s_max + 9], np.int32)
    qj = jnp.asarray(q, jnp.bfloat16)
    with jax.disable_jit():
        j_out = jd.flash_decode_gqa_inplace(
            qj, *(jnp.asarray(x) for x in cache),
            *(jnp.asarray(x) for x in new), jnp.asarray(lens))[0]
    want = np.array(j_out).reshape(b, kvh * g, hd)
    # The caches with the new rows written (the plain version's write).
    written = [torch.from_numpy(x.copy()) for x in cache]
    qt = to_torch(qj).float()
    clamped = torch.from_numpy(np.minimum(lens, s_max))
    td._write_new_rows(*written, *(torch.from_numpy(x) for x in new),
                       clamped)
    got = live_schedule(qt.reshape(b, kvh, g, hd), *written, clamped,
                        b * kvh + extra).reshape(b, kvh * g, hd)
    k_q, k_s, v_q, v_s = written
    pv = td.flash_decode_plain(qt, k_q, k_s, v_q.float().abs(), v_s,
                               clamped).reshape(b, kvh * g, hd)
    tol = PV_ROUNDING * pv + 1e-4 * torch.from_numpy(np.abs(want))
    err = (got - torch.from_numpy(want)).abs()
    assert bool((err <= tol).all()), float((err - tol).max())
    assert not got[0].any()


# ---- K6: route and tile


@pytest.mark.parametrize("m_max,expected_m,want", [
    (96, 3, ("ring", 0)),              # V2_LITE decode, 16 slots
    (96, 2, ("ring", 0)),              # V2_LITE_FULL decode
    (384, 12, ("ring", 0)),            # serve_bench scan, batch 64
    (96, 16, ("ring", 0)),
    (96, 17, ("wgmma", 0)),            # 17 rows: the 64-row tile
    (768, 24, ("wgmma", 0)),           # a 128-token prefill forward
    (1536, 48, ("wgmma", 0)),          # 256 tokens
    (96, 64, ("wgmma", 0)),            # 64 rows fit the 64-row tile
    (3072, 96, ("wgmma", 1)),          # 512 tokens
    (96, None, ("wgmma", 1)),          # no hint: M_max rows
    (12288, 384, ("wgmma", 1)),        # a 2048-token prefill chunk
    (12288, 0, ("ring", 0)),
])
def test_masked_plan(m_max, expected_m, want):
    assert analytic.masked_plan(m_max, expected_m) == want


def test_masked_plan_labels():
    assert ti.masked_plan_label("ring", 0) == "ring 16x64"
    assert ti.masked_plan_label("wgmma", 0) == "wgmma 64x64"
    assert ti.masked_plan_label("wgmma", 1) == "wgmma 128x256"
    assert ti.masked_plan_label("int8_tile", 0) == "int8_tile"


@pytest.mark.parametrize("expected_m", [None, 1, 40])
def test_masked_hint_changes_no_result(expected_m):
    """On the CPU the plain version runs whatever the hint; the result is
    the same bits."""
    rng = np.random.default_rng(3)
    e, m_max, n, k = 3, 40, 64, 96
    a_q = torch.from_numpy(rng.integers(-127, 128, (e, m_max, k),
                                        dtype=np.int8))
    b_q = torch.from_numpy(rng.integers(-127, 128, (e, n, k), dtype=np.int8))
    a_s = torch.from_numpy(rng.random((e, m_max, 1)).astype(np.float32))
    b_s = torch.from_numpy(rng.random((e, 1, n)).astype(np.float32))
    mm = torch.tensor([0, 7, 40], dtype=torch.int32)
    want = ti.m_grouped_int8_gemm_masked(a_q, a_s, b_q, b_s, mm, b_layout="t")
    got = ti.m_grouped_int8_gemm_masked(a_q, a_s, b_q, b_s, mm, b_layout="t",
                                        expected_m=expected_m)
    assert torch.equal(got, want)


def test_int8_moe_layer_hints_the_mean_rows_an_expert(monkeypatch):
    """The int8 MoE layer passes K6 ceil(T·top_k / E) as ``expected_m``,
    as the fp8 layer does K3; the result is unchanged."""
    cfg = jmodels.TINY
    tp = tmodels.params_from_numpy(
        tree_of(jmodels.init_params(jax.random.PRNGKey(0), cfg)), cfg,
        device="cpu")
    ffn = tmodels.params_with_int8_experts(tp).layers[1].ffn
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(24, cfg.hidden_size)).astype(np.float32)).to(torch.bfloat16)
    want = tm.moe_block(ffn, x, cfg)
    seen = []
    real = ti.m_grouped_int8_gemm_masked

    def spy(*args, **kw):
        seen.append(kw.get("expected_m"))
        return real(*args, **kw)

    monkeypatch.setattr(ti, "m_grouped_int8_gemm_masked", spy)
    got = tm.moe_block(ffn, x, cfg)
    assert seen == [-(-24 * cfg.top_k // cfg.num_experts)] * 2
    assert torch.equal(got, want)
    assert to_numpy(got).shape == (24, cfg.hidden_size)
