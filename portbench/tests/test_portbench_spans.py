"""The readers of the serving engine's own records (``queue_wait_ms.*``,
``slot_occupancy.*``, ``decode_host_ms_per_call``,
``prefill_stall_share``) on a hand-built ``Record``: known values where
the program keeps its call log and wall stamps, and no value, not an
error, where it keeps none."""
from collections import deque, namedtuple
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import bench
from portbench.record import Record
from portbench.recorder import Burst, Call, Recorder

# the fields of the engine's ``CallSpan``, read by name
Span = namedtuple("Span", "kind t_enter t_launched t_synced t_exit rows k")


class _Stage:
    """A stage with nothing but its call log and the entry points the
    recorder wraps."""

    def __init__(self, name, n_slots, spans=None):
        self.name, self.n_slots = name, n_slots
        self.stats = SimpleNamespace()
        if spans is not None:       # else an engine that keeps no spans
            self.stats.spans = deque(Span(*s) for s in spans)

    def prefill_batch(self, prompts):
        raise AssertionError("not called")

    decode_fused = release = prefill_batch


def _result(rid, stage_times, first, done, resolver, stamped=True):
    r = SimpleNamespace(rid=rid, tokens=[1, 2], resolver=resolver)
    if stamped:     # else a result as an engine without stamps gives it
        r.stage_times, r.first_token_t, r.done_t = stage_times, first, done
    return r


def _hand_built(stamped=True):
    """One burst over [0, 10] s of three logical steps, (0, 2), (2, 5)
    (traced) and (5, 10); stage a of 4 slots, b of 2."""
    a = [("decode", -5.0, -4.8, -4.7, -4.6, 4, 1),         # set-up
         ("prefill", 0.1, 0.5, 0.8, 0.9, 3, 0),
         ("decode", 1.1, 1.3, 1.8, 1.9, 3, 1),
         ("decode", 2.1, 2.3, 2.8, 2.9, 2, 2),             # traced
         ("decode", 5.1, 5.3, 5.8, 5.9, 1, 4)]
    b = [("prefill", 3.1, 3.5, 3.8, 3.9, 1, 0),            # traced
         ("decode", 4.1, 4.3, 4.8, 4.9, 1, 1),             # traced
         ("decode", 6.1, 6.5, 6.8, 6.9, 1, 3),
         ("prefill", 7.1, 7.5, 7.8, 7.9, 1, 0)]
    stages = [_Stage("a", 4, a if stamped else None),
              _Stage("b", 2, b if stamped else None)]
    rec = Recorder(stages)
    calls = [Call(0, "prefill", 0.0, 1.0, 0, 0),
             Call(0, "decode", 1.0, 2.0, 0, 0),
             Call(0, "decode", 2.0, 3.0, 0, 1),
             Call(1, "prefill", 3.0, 4.0, 0, 1),
             Call(1, "decode", 4.0, 5.0, 0, 1),
             Call(0, "decode", 5.0, 6.0, 0, 2),
             Call(1, "decode", 6.0, 7.0, 0, 2),
             Call(1, "prefill", 7.0, 8.0, 0, 3)]
    results = {r[0]: _result(*r, stamped=stamped) for r in (
        (0, {0: (0.0, 0.1)}, 0.9, 5.9, 0),
        (1, {0: (0.0, 0.1), 1: (4.5, 5.5)}, 3.9, 8.0, 1),
        (2, {0: (0.0, 3.5)}, 1.0, 1.5, 0),
        (3, {0: (0.0, 0.1), 1: (5.5, 6.5)}, 6.5, 9.5, 1))}
    reqs = [SimpleNamespace(rid=i, prompt=np.zeros(1, np.int32))
            for i in range(4)]
    rec.bursts.append(Burst(0.0, 10.0, reqs, results, calls=calls))
    rec.steps_traced.add((0, 1))
    return Record([{}, {}], ["a", "b"], {}, rec, 0.0, 0.0)


# queue waits: a (0.1 + 0.1 + (3.5 - 1.5) + 0.1) / 4 s, b ((1.0 - 0.5) +
# 1.0) / 2 s; occupancy: a (3 + 4 + 4) / (4 * 7), b (1 + 3) / (2 * 4);
# host part of the untraced decodes: (0.3 + 0.3 + 0.5) / 3 s; stalls: 0.8
# of request 1's 3.0 untraced seconds and 0.8 of request 3's 3.0, over
# 2.0 + 3.0 + 0.5 + 3.0
EXPECTED = {"queue_wait_ms.a": 575.0, "queue_wait_ms.b": 750.0,
            "slot_occupancy.a": 100.0 * 11 / 28,
            "slot_occupancy.b": 50.0,
            "decode_host_ms_per_call": 1100.0 / 3,
            "prefill_stall_share": 100.0 * 1.6 / 8.5}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_hand_built_record(name):
    got = bench.reader(name)(_hand_built())
    assert got == pytest.approx(EXPECTED[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing_where_the_program_records_nothing(name):
    """A program that keeps no spans or stamps reads as no value, not as
    an error."""
    assert bench.reader(name)(_hand_built(stamped=False)) is None
