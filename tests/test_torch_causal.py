"""The port's causal context (kubeflow_tpu_torch.telemetry.causal) against
the reference's (kubeflow_tpu.telemetry.causal): the same traceparent
headers parse the same way, ids and the header round-trip, and ``use``
nests and restores per thread."""
import re
import threading

import pytest

from kubeflow_tpu.telemetry import causal as ref
from kubeflow_tpu_torch.telemetry import causal as port

TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
SPAN = "00f067aa0ba902b7"


@pytest.mark.parametrize("header", [
    f"00-{TRACE}-{SPAN}-01",
    f"00-{TRACE}-{SPAN}-00",
    f"ff-{TRACE}-{SPAN}-09",
    f"00-{TRACE.upper()}-{SPAN.upper()}-01",
    f"  00-{TRACE}-{SPAN}-01\t",
    f"00-{TRACE}-{SPAN}-01-extra",
    f"00-{TRACE}-{SPAN}",
    f"0-{TRACE}-{SPAN}-01",
    f"00-{TRACE[:-1]}-{SPAN}-01",
    f"00-{TRACE}0-{SPAN}-01",
    f"00-{TRACE}-{SPAN[:-1]}-01",
    f"00-{TRACE[:-1]}g-{SPAN}-01",
    f"00_{TRACE}_{SPAN}_01",
    f"00-{TRACE}-{SPAN}-1",
    "", "   ", None, "garbage",
])
def test_headers_parse_like_reference(header):
    want = ref.parse_traceparent(header)
    got = port.parse_traceparent(header)
    if want is None:
        assert got is None
    else:
        assert (got.trace_id, got.span_id, got.stamped_ts) == (
            want.trace_id, want.span_id, want.stamped_ts)
        assert got.to_traceparent() == want.to_traceparent()


def test_ids_and_the_header_round_trip():
    assert port.TRACEPARENT_HEADER == ref.TRACEPARENT_HEADER
    ctx = port.mint()
    assert re.fullmatch(r"[0-9a-f]{32}", ctx.trace_id)
    assert re.fullmatch(r"[0-9a-f]{16}", ctx.span_id)
    header = ctx.to_traceparent()
    assert header == f"00-{ctx.trace_id}-{ctx.span_id}-01"
    back = port.parse_traceparent(header)
    assert (back.trace_id, back.span_id) == (ctx.trace_id, ctx.span_id)
    # The reference reads the port's header, and the other way round.
    theirs = ref.parse_traceparent(header)
    assert (theirs.trace_id, theirs.span_id) == (ctx.trace_id, ctx.span_id)
    mine = port.parse_traceparent(ref.mint().to_traceparent())
    assert mine is not None
    kid = port.child(ctx)
    assert kid.trace_id == ctx.trace_id and kid.span_id != ctx.span_id
    ids = {port.new_trace_id() for _ in range(1000)}
    assert len(ids) == 1000
    assert len({port.new_span_id() for _ in range(1000)}) == 1000


def _trace_ids(mod, a, b):
    """The current trace id at each point of one nesting sequence."""
    seen = [mod.current()]
    with mod.use(a):
        seen.append(mod.current())
        with mod.use(None):
            seen.append(mod.current())
        with mod.use(b):
            seen.append(mod.current())
            seen.append(mod.current_traceparent())
        seen.append(mod.current())
    seen.append(mod.current())
    return [s if s is None or isinstance(s, str) else s.trace_id
            for s in seen]


def test_use_nests_and_restores_like_reference():
    header_a, header_b = f"00-{TRACE}-{SPAN}-01", port.mint().to_traceparent()
    got = _trace_ids(port, port.parse_traceparent(header_a),
                     port.parse_traceparent(header_b))
    want = _trace_ids(ref, ref.parse_traceparent(header_a),
                      ref.parse_traceparent(header_b))
    assert got == want
    assert got == [None, TRACE, TRACE, header_b.split("-")[1], header_b,
                   TRACE, None]


def test_current_context_is_per_thread():
    ctx = port.mint()
    seen = {}
    entered, release = threading.Event(), threading.Event()

    def other():
        entered.wait(10)
        seen["other"] = port.current()
        release.set()

    t = threading.Thread(target=other, daemon=True)
    t.start()
    with port.use(ctx):
        entered.set()
        assert release.wait(10)
        assert port.current() is ctx
    t.join(timeout=10)
    assert not t.is_alive()
    assert seen["other"] is None and port.current() is None
    port.set_current(ctx)
    try:
        assert port.current_traceparent() == ctx.to_traceparent()
    finally:
        port.set_current(None)
