"""The program's spans in a trace (portbench/spans.py) and the readers that
select by them, on synthetic traces; on the card (marked `cuda`), the
match by launch order against the profiler's correlation ids on a short
traced window of a c4 cell.

    python -m pytest portbench/tests/test_portbench_spans.py -q
"""

import dataclasses
import time

import pytest

from portbench import spans, spec
from portbench.trace import Op, Trace, breakdown

NEW = ("candidates_ms_per_frame", "outputs_ms_per_frame",
       "program_idle_ms_per_frame", "host_syncs_per_frame")
OLD = ("launches_per_frame", "torch_ops_ms_per_frame", "kf_ms_per_frame",
       "split_kernels_ms_per_frame", "mesh_tile_ms_per_frame",
       "device_idle_share")
P = spans.PREFIX


def _trace(program: bool = True, frames: int = 4) -> Trace:
    """One call (1-6 s) of a 10 s window: a kernel in the pass, a kernel,
    a copy and a wait inside mesh_candidates, the output stack; the
    harness's count (6.6 s)."""
    host = [Op("portbench.window", 0.0, 10.0), Op("portbench.call", 0.9, 6.2),
            Op("portbench.count", 6.5, 6.8),
            Op("cudaLaunchKernel", 1.20, 1.25),
            Op("aten::add", 2.05, 2.15), Op("cudaLaunchKernel", 2.10, 2.12),
            Op("cudaMemcpyAsync", 2.50, 2.52),
            Op("cudaStreamSynchronize", 2.60, 2.70),
            Op("cudaLaunchKernel", 5.10, 5.12),
            Op("cudaLaunchKernel", 6.55, 6.56),
            Op("cudaDeviceSynchronize", 6.90, 7.00)]
    if program:
        host += [Op(P + "render_sequence", 1.0, 6.0), Op(P + "pass", 1.1, 5.9),
                 Op(P + "mesh_candidates", 2.0, 3.0),
                 Op(P + "outputs", 5.0, 5.8)]
    device = [Op("void elementwise_kernel<a>", 1.3, 1.9),
              Op("void elementwise_kernel<b>", 2.2, 2.4),
              Op("Memcpy DtoH (Device -> Pageable)", 2.55, 2.6),
              Op("void CatArrayBatchedCopy<c>", 5.2, 5.5)]
    harness = [Op("void reduce_kernel<h>", 6.6, 6.7)]
    return Trace(device=device, harness=harness, host=host,
                 window=(0.0, 10.0), frames=frames)


def test_operations_go_under_the_spans_that_launched_them():
    tr = _trace()
    sp = spans.of(tr)
    call = (P + "render_sequence", P + "pass")
    cand = call + (P + "mesh_candidates",)
    assert sp.ops == [call, cand, cand, call + (P + "outputs",)]
    assert sp.unmatched == 0
    assert sp.syncs == [cand]
    assert spans.of(tr) is sp        # computed once per trace


def test_new_readers_read_their_spans():
    tr = _trace()
    read = {m: spec.reader(m).read(tr) for m in NEW}
    assert read["candidates_ms_per_frame"] == pytest.approx(
        (0.2 + 0.05) * 1e3 / 4)
    assert read["outputs_ms_per_frame"] == pytest.approx(0.3 * 1e3 / 4)
    # inside 1-6 s the union covers 0.6 + 0.2 + 0.05 + 0.3 s
    assert read["program_idle_ms_per_frame"] == pytest.approx(
        (5.0 - 1.15) * 1e3 / 4)
    assert read["host_syncs_per_frame"] == pytest.approx(1 / 4)


@pytest.mark.parametrize("metric", NEW)
def test_new_readers_report_nothing_without_program_spans(metric):
    assert spec.reader(metric).read(_trace(program=False)) is None


def test_existing_readers_and_breakdown_read_as_before():
    with_spans, without = _trace(), _trace(program=False)
    before = {m: spec.reader(m).read(without) for m in OLD}
    spans.of(with_spans)
    after = {m: spec.reader(m).read(with_spans) for m in OLD}
    assert after == before
    b0, b1 = breakdown(without), breakdown(with_spans)
    assert b1["device_ops"] == b0["device_ops"]
    total = lambda b: sum(v for _n, v in b["idle_gaps"])
    assert total(b1) == pytest.approx(total(b0))
    assert dataclasses.asdict(with_spans) == dataclasses.asdict(_trace())


def test_stacks_of_nested_spans():
    s = [(0.0, 10.0, "a"), (1.0, 4.0, "b"), (2.0, 3.0, "c"), (5.0, 6.0, "d"),
         (11.0, 12.0, "e")]
    assert spans.stacks_at(s, [0.5, 2.5, 3.5, 4.5, 5.5, 10.5, 11.5]) == [
        ("a",), ("a", "b", "c"), ("a", "b"), ("a",), ("a", "d"), (), ("e",)]


def test_a_lost_launch_record_leaves_its_kind_unmatched():
    ops = [Op("k0", 1.0, 1.1), Op("k1", 2.0, 2.1), Op("Memcpy HtoD", 3.0, 3.1)]
    # the launch of one kernel was lost: by order every later kernel would
    # take the wrong launch, so no kernel is matched; the copy still is
    out, unmatched = spans._match(ops, {"kernel": [0.5], "copy": [2.9]})
    assert out == {id(ops[2]): 2.9} and unmatched == 2
    # a device clock a little ahead of the host's changes nothing
    out, unmatched = spans._match(ops, {"kernel": [0.5, 2.0000001]})
    assert out == {id(ops[0]): 0.5, id(ops[1]): 2.0000001}
    assert unmatched == 1


def test_a_large_window_is_read_in_seconds():
    """500,000 device operations, as a 51 s c4 window holds, with their
    launches, and per call of 1,000 operations its span and ten inside it
    end to end."""
    n, per, u = 500_000, 1_000, 2.0 ** -14    # times exact in binary
    end = n * 64 * u + 1.0
    device, host = [], [Op("portbench.window", 0.0, end)]
    for c in range(n // per):
        t = c * per * 64 * u
        host.append(Op(P + "render_sequence", t, t + per * 64 * u))
        for k in range(10):
            a = t + k * per * 6.4 * u
            host.append(Op(P + f"s{k}", a, a + per * 6.4 * u))
    for i in range(n):
        t = i * 64 * u
        host.append(Op("cudaLaunchKernel", t + u, t + 2 * u))
        device.append(Op("void elementwise_kernel<x>", t + 3 * u, t + 32 * u))
    tr = Trace(device=device, harness=[], host=host, window=(0.0, end),
               frames=16 * (n // per))
    t0 = time.perf_counter()
    read = {m: spec.reader(m).read(tr) for m in NEW}
    assert time.perf_counter() - t0 < 30.0
    assert read["candidates_ms_per_frame"] is None
    assert read["host_syncs_per_frame"] == 0
    assert spans.of(tr).unmatched == 0
    assert all(len(p) == 2 for p in spans.of(tr).ops)


@pytest.mark.cuda
def test_launch_order_matches_correlation_ids_on_card():
    """A c4 cell at 480x272 for two seconds, traced: every device
    operation with a correlation id (all but the hand kernels, 187 of
    46,552 on the H100) under the same program spans by launch order as
    by the id, and every operation outside the harness's own under a
    program span."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import harness
    from portbench import trace as trace_mod
    bench = harness.Bench(spec.cell("c4.seq16.config"), size=(480, 272))
    kept = {}

    def keep(prof, frames):
        kept["prof"] = prof
        return trace_mod.from_profile(prof, frames)

    real = harness.from_profile
    harness.from_profile = keep
    try:
        w = bench.window(4100000000021, 2.0, time.perf_counter(), trace=True)
    finally:
        harness.from_profile = real
    got = spans.correlated(kept["prof"], w.trace)
    print(got)
    assert got["differ"] == 0 and got["with_correlation"] > 0.99 * got["ops"]
    sp = spans.of(w.trace)
    assert sp.unmatched == 0
    assert all(p for p in sp.ops)
    assert spec.reader("host_syncs_per_frame").read(w.trace) > 0
