"""Expert loads of routed MoE traffic, for the grouped GEMMs' sweeps.

The masked grouped GEMMs (K3, K6) run on the rows the router sends each
expert, and the contiguous ones (K8, K9) on a layout of those rows; which
tile is fastest depends on how skewed those loads are. The sweeps
(``scripts/autotune_sweep.py``, ``ring_sweep.py``, ``decode_sweep.py``)
draw them here, so that a tile is timed on the traffic it will serve:
every token picks ``top_k`` distinct experts uniformly at random, as a
router with random weights does.
"""

from __future__ import annotations

from typing import List, Optional

import torch

# V2_LITE's experts a token (the MoE layer's top_k).
TOP_K = 6


def routed_loads(e: int, tokens: int, top_k: int = TOP_K,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """(E,) int32: the rows each of ``e`` experts receives when ``tokens``
    tokens each pick min(top_k, e) distinct experts at random (one draw of
    ``generator``)."""
    picks = torch.rand(tokens, e, generator=generator, device=device).argsort(
        dim=1)[:, :min(top_k, e)]
    return torch.bincount(picks.flatten(), minlength=e).to(torch.int32)


def tokens_for(e: int, rows: int, top_k: int = TOP_K) -> int:
    """Tokens whose routing gives each of ``e`` experts ``rows`` rows on
    average (at least one token): the inverse of the MoE layer's
    ``expected_m`` = ceil(tokens · top_k / E)."""
    return max(1, -(-e * rows // min(top_k, e)))


def routed_masked_m(e: int, m_max: int, rows: int, top_k: int = TOP_K,
                    generator: Optional[torch.Generator] = None,
                    device=None) -> torch.Tensor:
    """A masked grouped GEMM's ``masked_m`` for E experts of ``m_max`` rows
    expected to hold ``rows`` rows each: the routed loads of
    :func:`tokens_for` tokens, an expert's rows past ``m_max`` dropped
    (its capacity)."""
    loads = routed_loads(e, tokens_for(e, rows, top_k), top_k, generator,
                         device)
    return loads.clamp(max=m_max)


def routed_counts(e: int, rows: int, top_k: int = TOP_K,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> List[int]:
    """A contiguous grouped GEMM's tokens an expert, ``rows`` on average:
    the routed loads of :func:`tokens_for` tokens, as host ints."""
    return routed_loads(e, tokens_for(e, rows, top_k), top_k, generator,
                        device).tolist()
