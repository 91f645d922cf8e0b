"""The spans helper (``spans.py``) and the five readers of the program's
spans on a made-up segment and recording, and on the CPU tiny cells.

The made-up run: one microbatch whose staging holds two blocking copies,
on a host clock a second ahead of the device's. Device-idle time inside
the ``step`` span counts, time outside it does not; the offset is the
quickest wake-up after a copy; clocks that drift are followed, and a jump
of them between two steps too, unless the jump leaves the reading unsure;
anchors that do not pair (a copy missing or one more, or a copy that
cannot lie inside its span) give no offset and no
``idle_in_step_ms.train``; on the CPU no profiler runs, so no reader of
the spans reports.
"""

import pytest

from h100bench import run, spans
from h100bench.trace import Segment
from emg_tpu_torch.utils import profiling

AHEAD_US = 1_000_000.0  # the host clock less the device clock
COPY = "Memcpy HtoD (Pageable -> Device)"
READERS = ("batch_span_ms.train", "stage_ms.train", "issue_ms.train", "host_syncs.train",
           "idle_in_step_ms.train")


STEP = [("step", None, 1000, 5000), ("step.stage", 0, 1000, 2000), ("sync", 1, 1100, 1500),
        ("sync", 1, 1500, 1900), ("step.forward", 0, 2000, 3500), ("step.backward", 0, 3500, 4800)]


def made_up(copies=((1200, 1500), (1600, 1900)), steps=1, rate=0.0, jump=0.0):
    """(segment, recording): a ``data.pack`` span, then a step every 5 ms,
    each with two copies (the first step's ``copies``) and three kernels;
    the wall ends 2 ms after the last step. Made in device microseconds;
    the host clock is ``AHEAD_US`` ahead, gains ``rate`` of the time and,
    from the third step on, ``jump`` more."""
    def host_ns(t):
        return int((AHEAD_US + t * (1 + rate) + (jump if t >= 11000 else 0.0)) * 1e3)

    made = [profiling.Span("data.pack", 0, None, None, host_ns(0), host_ns(1000))]
    events = []
    for k in range(steps):
        at, base = 5000 * k, len(made)
        for name, parent, a, b in STEP:
            made.append(profiling.Span(name, len(made), None if parent is None else base + parent,
                                       k, host_ns(at + a), host_ns(at + b)))
        events += [(COPY, float(at + a), float(at + b))
                   for a, b in (copies if k == 0 else ((1200, 1500), (1600, 1900)))]
        events += [("kernel", at + a, at + b) for a, b in ((2100, 2600), (3000, 4500), (5500, 6000))]
    wall = 5000 * steps + 2000
    return Segment(wall * 1e-6, events), profiling.Recording(made, {"host_syncs": 2 * steps})


@pytest.fixture
def recorded(monkeypatch):
    """Hands the readers a made-up recording in the program's place."""
    def use(rec):
        monkeypatch.setattr(profiling, "recorded", lambda: rec)
    return use


def read_all(seg):
    ctx = {"segment": seg}
    return {name: run.load_module("metrics", name).read(ctx)
            for name in READERS + ("device_idle_pct.train",)}


def test_idle_inside_a_step_counts_and_outside_does_not(recorded):
    seg, rec = made_up()
    alignment = spans.align(seg, rec)
    assert alignment == spans.Alignment([1500 + AHEAD_US], [AHEAD_US], 0.0, 0.0, 0.0, 0.0, 2)
    idle = spans.idle_by_span(seg, rec, alignment)
    assert idle.window == pytest.approx((0.0, 7000.0))
    assert idle.by_span == pytest.approx({"data.pack": 1000, "step.stage": 200, "sync": 200,
                                          "step.forward": 500, "step.backward": 300,
                                          "step": 200, None: 1500})
    assert idle.in_step_us == pytest.approx(1400) and idle.idle_us == pytest.approx(3900)
    assert idle.idle_us == pytest.approx(1e6 * (seg.wall_s - seg.busy_s()))
    recorded(rec)
    assert read_all(seg) == pytest.approx({
        "batch_span_ms.train": 1.0, "stage_ms.train": 1.0, "issue_ms.train": 2.8,
        "host_syncs.train": 2.0, "idle_in_step_ms.train": 1.4,
        "device_idle_pct.train": 100 * 3900 / 7000})


@pytest.mark.parametrize("copies,offset,spread", [
    (((1200, 1480), (1600, 1860)), 20, 20),  # the second copy's host woke 20 us later
    (((1200, 1490), (1500, 1700)), 10, 190),  # a late wake-up spreads, and stays inside
])
def test_the_offset_is_the_quickest_wake_up(copies, offset, spread):
    seg, rec = made_up(copies)
    alignment = spans.align(seg, rec)
    assert alignment.offsets_us == [pytest.approx(AHEAD_US + offset)]
    assert alignment.wake_us == pytest.approx(spread) and alignment.misfit_us == 0.0


def test_clocks_that_drift_are_followed_step_by_step(recorded):
    """The host clock gains 2% on the device's (0.1 ms a step): each step's
    idle lands where it would with one offset."""
    seg, rec = made_up(steps=3, rate=0.02)
    alignment = spans.align(seg, rec)
    assert alignment.offsets_us == pytest.approx([AHEAD_US + 0.02 * (1500 + 5000 * k)
                                                  for k in range(3)])
    assert alignment.rate == pytest.approx(0.02 / 1.02) and alignment.misfit_us == 0.0
    assert alignment.jump_us == pytest.approx(0.0, abs=1e-6)
    assert alignment.wake_us == pytest.approx(0.02 * 400)  # the second copy's, 0.4 ms later
    idle = spans.idle_by_span(seg, rec, alignment)
    assert idle.window == pytest.approx((0.0, 17000.0))
    # each step's 1400 us as in the single step; outside them the first
    # data.pack, the 500 us before each next step and the wall's end
    assert idle.in_step_us == pytest.approx(3 * 1400)
    assert idle.by_span["data.pack"] == pytest.approx(1000)
    assert idle.idle_us == pytest.approx(1e6 * (seg.wall_s - seg.busy_s())) == pytest.approx(7700)
    recorded(rec)
    assert read_all(seg)["idle_in_step_ms.train"] == pytest.approx(1.4)


@pytest.mark.parametrize("jump,in_step", [(150.0, 8283.5), (-300.0, 8623.4)])
def test_a_jump_of_the_clocks_between_steps_is_followed(recorded, jump, in_step):
    """The host clock jumps ahead (or back) as the third of six steps
    starts: the offset interpolated between the second and third steps'
    anchors puts that interval's idle within the jump of where it lies;
    the other steps' lines hold, and the reading is sure enough."""
    seg, rec = made_up(steps=6, jump=jump)
    alignment = spans.align(seg, rec)
    assert alignment.offsets_us == pytest.approx([AHEAD_US] * 2 + [AHEAD_US + jump] * 4)
    assert alignment.rate == 0.0 and alignment.jump_us == pytest.approx(abs(jump))
    assert spans.idle_in_step(seg, rec, alignment) == pytest.approx(in_step, abs=0.1)
    assert abs(in_step - 6 * 1400) <= 2 * abs(jump)
    recorded(rec)
    assert read_all(seg)["idle_in_step_ms.train"] == pytest.approx(in_step / 6e3, abs=1e-4)


@pytest.mark.parametrize("jump", [500.0, -2000.0])
def test_a_jump_that_leaves_the_reading_unsure_reads_none(recorded, jump):
    """A step's end and the next one's start each fall in the jump's range
    with the device idle there: more than 1% of the 32 ms wall is unsure."""
    seg, rec = made_up(steps=6, jump=jump)
    alignment = spans.align(seg, rec)
    assert alignment is not None and alignment.jump_us == pytest.approx(abs(jump))
    assert spans.idle_in_step(seg, rec, alignment) is None
    recorded(rec)
    assert read_all(seg)["idle_in_step_ms.train"] is None


@pytest.mark.parametrize("copies", [((1200, 1500),), ((1200, 1500), (1600, 1900), (2700, 2800)),
                                    ((1200, 1500), (2700, 2800))],
                         ids=["a copy missing", "a copy more", "a copy outside its span"])
def test_anchors_that_do_not_pair_read_none(recorded, copies):
    seg, rec = made_up(copies)
    assert spans.align(seg, rec) is None
    recorded(rec)
    got = read_all(seg)
    assert got["idle_in_step_ms.train"] is None
    assert got["host_syncs.train"] == 2.0 and got["stage_ms.train"] == pytest.approx(1.0)


def test_without_a_trace_or_spans_no_reader_reports(recorded, monkeypatch):
    seg, rec = made_up()
    recorded(rec)
    assert all(v is None for k, v in read_all(Segment(0.5)).items())
    recorded(profiling.Recording([s for s in rec.spans if s.name != "step"], rec.counts))
    assert all(read_all(seg)[name] is None for name in READERS)
    # a program that records no spans (the parent of the readers)
    monkeypatch.delattr(profiling, "recorded")
    assert all(read_all(seg)[name] is None for name in READERS)


def test_the_cpu_tiny_cells_omit_the_span_metrics(tiny):
    home, bench = tiny
    result = run.run_cell(bench, "tiny_tf_train", 2 ** 31 + 5, 0.3, True, device="cpu",
                          home=home)
    assert result["correct"]
    assert not set(READERS) & set(result["metrics"])
    assert "host_batch_ms.train" in result["metrics"]
