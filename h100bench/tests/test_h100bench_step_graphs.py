"""``step_graph_hit_pct.train`` on made-up segments: the replays of step
graphs over the segment's ``step`` spans; None where the segment holds no
``step`` span, where no device trace ran, or where the program counted no
step graph (an eager step)."""

import pytest

from h100bench import run
from h100bench.trace import Segment
from emg_tpu_torch.utils import profiling


def recording(steps, counts):
    spans = [profiling.Span("data.pack", 0, None, None, 0, 1000)]
    for k in range(steps):
        at = 1000 + 5000 * k
        spans.append(profiling.Span("step", len(spans), None, k, at, at + 4000))
        spans.append(profiling.Span("step.replay", len(spans), len(spans) - 1, k, at + 2000,
                                    at + 2100))
    return profiling.Recording(spans, counts)


SEGMENT = Segment(0.05, [("Memcpy HtoD (Pageable -> Device)", 10.0, 20.0),
                         ("kernel", 30.0, 900.0)])


def read(monkeypatch, rec, segment=SEGMENT):
    monkeypatch.setattr(profiling, "recorded", lambda: rec)
    return run.load_module("metrics", "step_graph_hit_pct.train").read({"segment": segment})


@pytest.mark.parametrize("steps, counts, want", [
    (8, {"step_graphs.replay": 6, "step_graphs.capture": 2, "host_syncs": 48}, 75.0),
    (4, {"step_graphs.replay": 4}, 100.0),
    (3, {"step_graphs.capture": 3}, 0.0),
], ids=["some_captures", "all_replays", "all_captures"])
def test_replays_over_steps(monkeypatch, steps, counts, want):
    assert read(monkeypatch, recording(steps, counts)) == pytest.approx(want)


def test_none_without_a_step_span(monkeypatch):
    rec = profiling.Recording([profiling.Span("data.pack", 0, None, None, 0, 1000)],
                              {"step_graphs.replay": 2})
    assert read(monkeypatch, rec) is None


def test_none_for_an_eager_step_or_without_a_trace(monkeypatch):
    assert read(monkeypatch, recording(4, {"host_syncs": 24})) is None
    assert read(monkeypatch, recording(4, {"step_graphs.replay": 4}), Segment(0.05, [])) is None
