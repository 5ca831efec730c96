"""The decoder's split in the trace: a ``TraceView`` built from synthetic
profiler events puts each kernel in the harness's ``init_state``,
``decode_loop`` and ``decode_step`` op ranges (``decoder_ranges``) where the
host launched it inside them or inside a range nested in them; the four
readers of the split read their values there; every field and reading that
existed before is the same with the program's ``mellow.*`` spans and the
new ranges in the trace as without them; and on a CPU run of the tiny cell
the ranges cover the program's one call and nothing is read."""

import time

import pytest

import pb_tiny
from port_bench import decoder_ranges, harness, spec, trace

NEW = ("prefill_device_ms", "decode_step_device_ms", "decode_idle_ms", "decode_launches_per_step")
OLD = ("encoder_device_ms", "decoder_device_ms", "launches_per_call", "swin_block_roofline",
       "prefill_blocks_roofline", "idle_pct", "mfu")


class Event:
    """A profiler event as ``trace.read`` reads it."""

    def __init__(self, kind, name, start, end, corr=0, cuda=False):
        self.kind, self._name, self._start, self._end, self._corr, self._cuda = kind, name, start, end, corr, cuda

    def activity_type(self):
        return "ActivityType." + self.kind.upper()

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return 0

    def device_type(self):
        return "DeviceType.CUDA" if self._cuda else "DeviceType.CPU"


class Prof:
    def __init__(self, events):
        class Results:
            def events(_):
                return events

        class Profiler:
            kineto_results = Results()

        self.profiler = Profiler()


def host(name, start, end):
    return Event("user_annotation", name, start, end)


def launch(name, t, corr):
    return Event("cuda_runtime", name, t, t + 5, corr)


def kernel(name, start, end, corr):
    return Event("kernel", name, start, end, corr, cuda=True)


def harness_events():
    """One call: the harness's ranges, a roofline's op range, and the device
    work of a prefill, a done check, a token choice and two decode steps,
    the second a graph replay of three kernels."""
    return [
        host("port_bench.call", 0, 10_000),
        host("port_bench.decoder", 1_100, 9_800),
        host('port_bench.op.mlp_block:{"rows":2,"S":4,"D":8,"I":16}', 1_250, 1_450),
        launch("cudaLaunchKernel", 1_300, 1), kernel("mlp_gate_up", 1_350, 2_350, 1),
        launch("cudaLaunchKernelExC", 1_400, 2), kernel("flash_prefill", 2_350, 2_850, 2),
        launch("cudaLaunchKernel", 2_150, 3), kernel("reduce_sum", 2_900, 2_910, 3),
        launch("cudaMemcpyAsync", 2_200, 4), Event("gpu_memcpy", "Memcpy DtoH", 2_920, 2_930, 4, cuda=True),
        launch("cuLaunchKernel", 3_100, 5), kernel("argmax", 3_200, 3_300, 5),
        launch("cudaLaunchKernel", 4_100, 6), kernel("decode_attention", 4_200, 4_400, 6),
        launch("cudaLaunchKernel", 5_000, 7), kernel("gemv", 5_100, 5_200, 7),
        launch("cudaGraphLaunch", 6_600, 8),
        kernel("decode_attention", 6_700, 6_800, 8), kernel("gemv", 6_800, 6_900, 8), kernel("add", 6_900, 7_000, 8),
    ]


def decoder_op_ranges():
    """The op ranges the four readers ask the harness for, around that work."""
    return [host("port_bench.op.init_state:{}", 1_200, 2_000), host("port_bench.op.decode_loop:{}", 2_100, 9_000),
            host("port_bench.op.decode_step:{}", 4_000, 6_000), host("port_bench.op.decode_step:{}", 6_500, 8_500)]


def program_spans():
    """The program's spans around the same work, on the host and (as the
    profiler projects a range that launched device work) on the device."""
    spans = [("mellow.generate_tokens", 50, 9_900), ("mellow.prefill", 1_200, 2_000),
             ("mellow.host_sync", 2_100, 2_900), ("mellow.decode_window", 3_000, 9_000),
             ("mellow.token_choice", 3_000, 3_500), ("mellow.decode_step", 4_000, 6_000),
             ("mellow.decode_step", 6_500, 8_500)]
    return ([host(n, s, e) for n, s, e in spans]
            + [Event("gpu_user_annotation", "mellow.decode_step", 4_200, 5_200, cuda=True),
               Event("gpu_user_annotation", "mellow.generate_tokens", 1_350, 7_000, cuda=True)])


def view(events):
    return trace.read(Prof(events), 1)


def readings(v, names):
    run = harness.Run({}, {}, [], [], 0.0, 0.0)
    return {n: spec.metric(pb_tiny.REPO, n).read(v, run) for n in names}


def test_kernels_launched_inside_nested_op_ranges_belong_to_the_outer_range():
    v = view(harness_events() + decoder_op_ranges())
    names = lambda ops: [(o.name, o.start) for o in ops]  # noqa: E731
    assert names(decoder_ranges.inside(v, "init_state")) == [("mlp_gate_up", 1_350), ("flash_prefill", 2_350)]
    assert all(o.op.name.startswith("mlp_block:") for o in v.ops[:2])  # the innermost range is the nested one
    loop = decoder_ranges.inside(v, "decode_loop")
    assert len(loop) == 8 and ("Memcpy DtoH", 2_920) in names(loop)
    assert names(decoder_ranges.inside(v, "decode_step", v.kernels)) == [
        ("decode_attention", 4_200), ("gemv", 5_100), ("decode_attention", 6_700), ("gemv", 6_800), ("add", 6_900)]
    assert len(decoder_ranges.ranges(v, "decode_step")) == 2
    assert all(o.label == "decoder" for o in v.ops)


def test_a_graph_replay_counts_each_kernel_it_runs():
    r = readings(view(harness_events() + decoder_op_ranges()), ("decode_launches_per_step", "launches_per_call"))
    assert r == {"decode_launches_per_step": 2.5, "launches_per_call": 9.0}


def test_the_program_spans_change_nothing_the_trace_reads():
    plain = view(harness_events() + decoder_op_ranges())
    assert view(harness_events() + decoder_op_ranges() + program_spans()) == plain
    assert readings(view(harness_events() + program_spans()), OLD + NEW) == readings(view(harness_events()), OLD + NEW)


def test_fields_and_readings_that_existed_are_the_same_with_the_new_ranges():
    plain, ranged = view(harness_events()), view(harness_events() + decoder_op_ranges())
    assert plain.calls == ranged.calls and plain.window == ranged.window
    assert [o[:5] for o in plain.ops] == [o[:5] for o in ranged.ops]
    assert plain.gaps() == ranged.gaps() and plain.busy_s == ranged.busy_s
    assert trace.breakdown(plain) == trace.breakdown(ranged)
    assert plain.op_calls("mlp_block") == ranged.op_calls("mlp_block")
    before = readings(plain, OLD)
    assert before == readings(ranged, OLD)
    assert before["decoder_device_ms"] == pytest.approx((1_000 + 500 + 10 + 100 + 200 + 100 + 300) / 1e6)
    assert before["prefill_blocks_roofline"] is not None


def test_the_new_readers_on_the_synthetic_view():
    r = readings(view(harness_events() + decoder_op_ranges()), NEW)
    assert r["prefill_device_ms"] == pytest.approx((1_000 + 500) / 1e6)
    assert r["decode_step_device_ms"] == pytest.approx((200 + 100 + 300) / 2 / 1e6)
    # gaps ended by the loop's work: the done check's kernel and copy, the argmax, both steps' kernels, the graph
    assert r["decode_idle_ms"] == pytest.approx((50 + 10 + 270 + 900 + 700 + 1_500) / 1e6)
    assert r["decode_launches_per_step"] == 2.5
    assert readings(view(harness_events()), NEW) == dict.fromkeys(NEW)


def test_the_new_readers_read_nothing_on_a_cpu_run(tmp_path, monkeypatch):
    root = pb_tiny.make_root(str(tmp_path), metrics=NEW)
    views = []
    orig = trace.read

    def keep(prof, calls):
        views.append(orig(prof, calls))
        return views[-1]

    monkeypatch.setattr(trace, "read", keep)
    r = harness.run_cell(root, pb_tiny.CELL, 2 ** 31 + 4321, 0.5, True, "cpu", time.perf_counter())
    assert r["correct"] is True
    assert not set(NEW) & set(r["metrics"])
    plain, ranged = views
    assert not plain.op_spans and not ranged.kernels
    names = [s.name for s in ranged.op_spans]
    assert {n: names.count(n) for n in set(names)} == {"init_state:{}": 1, "decode_loop:{}": 1, "decode_step:{}": 3}
