"""The reader of ``serving.prefill_graph_share`` on the engine's counters,
and on a program that keeps no prefill graphs."""

import types
from pathlib import Path

import pytest

from benchmark import registry

ROOT = Path(__file__).resolve().parents[2]


def _read(counters):
    cell = registry.Cell("x", {}, {}, {}, {}, [], [], ROOT)
    return cell.reader("serving.prefill_graph_share")(
        types.SimpleNamespace(counters=counters))


@pytest.mark.parametrize("replays,dispatches,want", [(45, 50, 90.0), (0, 8, 0.0), (8, 8, 100.0)])
def test_prefill_graph_share_reads_replays_over_dispatches(replays, dispatches, want):
    assert _read({"stats.prefill_graph_replays": float(replays),
                  "metrics.engine.prefill_dispatches": float(dispatches)}) == pytest.approx(want)


@pytest.mark.parametrize("counters", [
    {"metrics.engine.prefill_dispatches": 8.0},            # a program without the counter
    {"stats.prefill_graph_replays": 0.0},                  # no prefill in the window
])
def test_prefill_graph_share_has_nothing_to_read(counters):
    assert _read(counters) is None
