"""The program's spans (`utils/metrics.span`), the count of states handed to
the kernels (`perm_cuda.states`) and the benchmark's reader of both
(`hbench/spans.py`), on the CPU.

Under `torch.profiler` each span is an annotation on the profiler's clock;
with metrics enabled it adds its calls and host time to `snapshot()`;
otherwise it records nothing. The reader attributes each device operation
to the spans open at its launch, which the hand-made traces below stand in
for (this host has no card).
"""

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hades252_tpu_torch import field, fri, fri_cuda, plonk, prover_cuda
from hades252_tpu_torch.gadget import Composer, Constraint
from hades252_tpu_torch.models import merkle
from hades252_tpu_torch.ops import perm_cuda
from hades252_tpu_torch.utils import graphs, metrics, native
from hbench import spans, tracing

torch.set_num_threads(1)


def _square(v: int, public: bool = False) -> Composer:
    """v * v, and with `public` v bound to a public input."""
    c = Composer()
    a = c.append_witness(v)
    c.gate_mul(Constraint().mult(1).a(a).b(a))
    if public:
        c.append_gate(Constraint().left(1).a(a).public(-v))
    return c


def _prove_batched():
    cs = [_square(3), _square(11)]
    key = plonk.preprocess(cs[0])
    return lambda: prover_cuda.prove_batched(cs, key, device="cpu")


def _succinct(monkeypatch):
    """A tiny device succinct proof on CPU tensors, its permutations through
    the native engine (the kernels' bits)."""
    def kernel(states, schedule):
        out = native.perm_batch_digits(states.numpy().astype(np.uint32))
        return torch.from_numpy(out.astype(np.int32))

    monkeypatch.setattr(fri_cuda, "permute_cuda", kernel)
    c = _square(3, public=True)
    pk, _ = fri.preprocess_succinct(c, fri.FriParams(blowup=4, n_queries=3, final_degree=8,
                                                     pow_bits=0), fri.default_pcs_perm())
    return lambda: fri_cuda.prove_succinct_device(c, pk, device="cpu")


def _merkle():
    """A build, openings and their verification through the permutation's
    wrapper (its plain version on the CPU)."""
    perm = functools.partial(perm_cuda.permute_cuda_mont, schedule="opt")
    leaves = torch.from_numpy(field.np_random_elements((4,), np.random.default_rng(5))
                              .astype(np.int32))
    idx = torch.tensor([0, 3])

    def run():
        levels = merkle.merkle_levels(leaves, perm)
        root = field.from_mont(levels[-1][0])
        sibs, poss = merkle.merkle_open_batched(levels, idx)
        assert merkle.merkle_verify_batched(root, leaves[idx], sibs, poss, 1, perm).all()
    return run


#: Each path's spans and the program span each sits in (None: none).
NESTED = {
    "prove_batched": {"prove.host": None, "prove.phase1": None, "prove.phase2": None,
                      "prove.phase3": None, "prove.fetch": None},
    "succinct": {"fri.witness": None, "prove.phase1": "fri.witness",
                 "prove.phase2": "fri.witness", "prove.phase3": "fri.witness",
                 "fri.host": None, "fri.coset": None, "fri.commit": None,
                 "fri.fetch": {"fri.commit", "fri.evals", "fri.fold", "fri.host", "fri.open"},
                 "fri.evals": None, "fri.deep": None, "fri.deep.invert": "fri.deep",
                 "fri.fold": None, "fri.grind": None, "fri.open": None},
    "merkle": {"merkle.convert": {None, "merkle.verify"}, "merkle.level": None,
               "perm.call": {"merkle.level", "merkle.verify"}, "merkle.open": None,
               "merkle.verify": None},
}


def _parents(evs) -> dict:
    """Each program span's name -> the names of the innermost program spans
    around its occurrences (None at the top)."""
    notes = sorted((s, -e, n) for n, dev, s, e, note, _, _ in evs
                   if note and not dev and n.startswith(spans.PREFIXES))
    out: dict = {}
    open_: list = []
    for s, neg_e, n in notes:
        while open_ and open_[-1][0] <= s:
            open_.pop()
        out.setdefault(n, set()).add(open_[-1][1] if open_ else None)
        open_.append((-neg_e, n))
    return out


@pytest.mark.parametrize("path", sorted(NESTED))
def test_spans_under_the_profiler_nest_as_named(monkeypatch, path):
    run = {"prove_batched": _prove_batched, "merkle": _merkle,
           "succinct": lambda: _succinct(monkeypatch)}[path]()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    evs = list(spans.events(prof))
    got = _parents(evs)
    want = {n: p if isinstance(p, set) else {p} for n, p in NESTED[path].items()}
    assert set(got) == set(want)
    for name, parents in got.items():
        assert parents <= want[name], name
    # the reader counts the same spans; the CPU runs no device operation
    read = spans.attribute(evs)
    assert set(read["by_span"]) == set(want)
    assert read["outside_ms"] == read["unlinked_ms"] == read["idle_outside_ms"] == 0
    assert all(s["device_ms"] == s["idle_ms"] == 0 and s["host_ms"] >= 0
               for s in read["by_span"].values())
    if path == "merkle":
        assert read["by_span"]["merkle.level"]["calls"] == 1
        assert read["by_span"]["merkle.verify"]["calls"] == 1
    if path == "prove_batched":
        assert {n: read["by_span"][n]["calls"] for n in NESTED[path]} == {
            "prove.host": 4, "prove.phase1": 1, "prove.phase2": 1, "prove.phase3": 1,
            "prove.fetch": 3}


def test_spans_off_record_nothing(monkeypatch):
    """No profiler and metrics disabled: no annotation is made and nothing
    is kept."""
    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name) or pytest.fail(name))
    metrics.reset()
    assert metrics.span("merkle.level") is metrics.span("fri.deep")  # the one idle span
    _merkle()()
    proofs = _prove_batched()()
    assert len(proofs) == 2 and made == []
    assert metrics.snapshot() == {"counters": {}, "spans": {}}


def test_enable_fills_snapshot_spans():
    metrics.reset()
    metrics.enable()
    try:
        _prove_batched()()
        with profile(activities=[ProfilerActivity.CPU]) as prof:  # both at once
            _merkle()()
        snap = metrics.snapshot()
    finally:
        metrics.disable()
        metrics.reset()
    got = {n: s["calls"] for n, s in snap["spans"].items()}
    assert got == {"prove.host": 4, "prove.phase1": 1, "prove.phase2": 1, "prove.phase3": 1,
                   "prove.fetch": 3, "merkle.convert": 3, "merkle.level": 1, "perm.call": 2,
                   "merkle.open": 1, "merkle.verify": 1}
    assert all(s["host_s"] > 0 and s["device_ms"] == 0 for s in snap["spans"].values())
    assert snap["counters"]["merkle.levels"] == 1
    assert "merkle.level" in _parents(list(spans.events(prof)))


class _FakeCuda:
    """The pieces of torch.cuda that utils/graphs.CudaGraph calls, as no-ops:
    the capture and the replays run nothing, as on a card."""

    class Stream:
        def __init__(self, device):
            pass

        def wait_stream(self, other):
            pass

    class CUDAGraph:
        def replay(self):
            pass

    @staticmethod
    def stream(s):
        return _Null()

    @staticmethod
    def graph(g, pool=None):
        return _Null()

    @staticmethod
    def current_stream(device=None):
        return _FakeCuda.Stream(device)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_graph_counts_states_at_replays_not_at_capture(monkeypatch):
    """A capture keeps what its wrappers counted as `held` (launches) and
    `held_states`, takes the states back out (it ran nothing), and each
    replay adds `held_states` to `perm_cuda.states`; the spans
    `graph.capture` and `graph.replay` mark both."""
    for name in ("Stream", "CUDAGraph", "stream", "graph", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, getattr(_FakeCuda, name))

    def body(x):  # what perm_cuda._launch counts for a batch of 100 and of 28
        for n in (100, 28):
            perm_cuda.launches["hybp"] += 1
            perm_cuda.states["hybp"] += n
        return x + 1

    before = dict(perm_cuda.states)
    metrics.reset()
    metrics.enable()
    try:
        g = graphs.CudaGraph(body, (torch.zeros(3),))
        assert g.held == {**dict.fromkeys(perm_cuda.SCHEDULES, 0), "hybp": 2}
        assert g.held_states == {**dict.fromkeys(perm_cuda.SCHEDULES, 0), "hybp": 128}
        # the warm-up run before the capture ran: its states count once
        assert perm_cuda.states == {**before, "hybp": before["hybp"] + 128}
        for k in (1, 2, 3):
            out = g(torch.full((3,), float(k)))
            assert torch.equal(g._inputs[0], torch.full((3,), float(k)))  # copied in
            assert torch.equal(out, torch.ones(3))  # the stand-in replays nothing
            assert perm_cuda.states["hybp"] == before["hybp"] + 128 * (k + 1)
        calls = {n: s["calls"] for n, s in metrics.snapshot()["spans"].items()}
    finally:
        metrics.disable()
        metrics.reset()
    assert g.replays == 3 and calls == {"graph.capture": 1, "graph.replay": 3}
    assert {s: n for s, n in perm_cuda.states.items() if s != "hybp"} == \
        {s: n for s, n in before.items() if s != "hybp"}


def _ev(name, start, end, *, dev=False, note=False, corr=0, tid=1):
    return (name, dev, start, end, note, corr, tid)


#: A hand-made trace (ns): two steps' worth of spans on thread 1, launches
#: with correlation ids, and the device operations they launched.
TRACE = [
    _ev("hbench.step", 0, 10_000, note=True),
    _ev("fri.deep", 100, 3_000, note=True),
    _ev("fri.deep.invert", 200, 1_000, note=True),
    _ev("perm.call", 300, 900, note=True),
    _ev("cudaLaunchKernel", 400, 410, corr=11),            # inside the wrapper
    _ev("cudaLaunchKernel", 500, 510, corr=12),
    _ev("cudaLaunchKernel", 1_500, 1_510, corr=13),        # in fri.deep itself
    _ev("fri.fetch", 2_000, 2_800, note=True),
    _ev("cudaMemcpyAsync", 2_010, 2_790, corr=14),
    _ev("fri.fold", 3_100, 4_000, note=True),
    _ev("graph.replay", 3_200, 3_900, note=True),
    _ev("cudaGraphLaunch", 3_300, 3_320, corr=15),
    _ev("cudaLaunchKernel", 5_000, 5_010, corr=16),        # outside every span
    _ev("aten::add", 5_000, 5_020, corr=17),               # a host op sharing no launch
    _ev("cudaLaunchKernel", 6_000, 6_010, corr=18, tid=2),  # another thread: outside
    # the device: kernels run after their launches
    _ev("void hades_perm_opt<1>", 1_000, 1_400, dev=True, corr=11),
    _ev("elementwise_kernel", 1_400, 1_500, dev=True, corr=12),
    _ev("reduce_kernel", 1_600, 1_800, dev=True, corr=13),
    _ev("Memcpy DtoH", 2_100, 2_700, dev=True, corr=14),
    _ev("graph kernel a", 3_400, 3_500, dev=True, corr=15),
    _ev("void hades_perm_opt<4>", 3_500, 3_800, dev=True, corr=15),
    _ev("fill_kernel", 5_100, 5_150, dev=True, corr=16),
    _ev("copy_kernel", 6_100, 6_130, dev=True, corr=18),
    _ev("lost_kernel", 7_000, 7_040, dev=True, corr=99),  # its launch is not in the trace
    _ev("fri.deep", 1_000, 1_400, dev=True, note=True),    # a device-side annotation: skipped
]


def test_reader_attributes_kernels_to_the_innermost_span_by_correlation():
    got = spans.attribute(TRACE)
    by = got["by_span"]
    assert set(by) == {"fri.deep", "fri.deep.invert", "perm.call", "fri.fetch", "fri.fold",
                       "graph.replay"}
    ms = 1e-6
    # inclusive: everything launched inside at any depth
    assert by["fri.deep"]["device_ms"] == pytest.approx((400 + 100 + 200 + 600) * ms)
    assert by["fri.deep.invert"]["device_ms"] == pytest.approx(500 * ms)
    # self: where it is the innermost span; the package's own kernels apart
    assert by["perm.call"]["self_ms"] == pytest.approx(500 * ms)
    assert by["perm.call"]["self_own_ms"] == pytest.approx(400 * ms)
    assert by["fri.deep.invert"]["self_ms"] == 0
    assert by["fri.deep"]["self_ms"] == pytest.approx(200 * ms)
    assert by["fri.fetch"]["self_ms"] == pytest.approx(600 * ms)
    # a graph replay's kernels belong to its one cudaGraphLaunch
    assert by["graph.replay"]["device_ms"] == pytest.approx(400 * ms)
    assert by["graph.replay"]["self_own_ms"] == pytest.approx(300 * ms)
    assert by["fri.fold"]["device_ms"] == pytest.approx(400 * ms)
    assert by["fri.fold"]["self_ms"] == 0
    assert got["outside_ms"] == pytest.approx((50 + 30) * ms)
    assert got["unlinked_ms"] == pytest.approx(40 * ms)


def test_reader_counts_launches_calls_and_host_time_less_fetches():
    by = spans.attribute(TRACE)["by_span"]
    assert {n: s["launches"] for n, s in by.items()} == {
        "fri.deep": 3, "fri.deep.invert": 2, "perm.call": 2, "fri.fetch": 0, "fri.fold": 1,
        "graph.replay": 1}
    assert all(s["calls"] == 1 for s in by.values())
    ms = 1e-6
    assert by["fri.deep"]["host_ms"] == pytest.approx((2_900 - 800) * ms)  # less its fetch
    assert by["fri.fetch"]["host_ms"] == pytest.approx(800 * ms)
    assert by["fri.fold"]["host_ms"] == pytest.approx(900 * ms)


def test_reader_books_idle_gaps_to_the_innermost_span_over_them():
    """The device's idle time in the step, split where the host's innermost
    program span changes: the gap at 0-1,000 is 100 ns under no span, then
    fri.deep, fri.deep.invert, perm.call, fri.deep.invert again."""
    got = spans.attribute(TRACE)
    idle = {n: s["idle_ms"] * 1e6 for n, s in got["by_span"].items()}
    assert idle == pytest.approx({"fri.deep": 600, "fri.deep.invert": 200, "perm.call": 600,
                                  "fri.fetch": 200, "fri.fold": 200, "graph.replay": 300})
    assert got["idle_outside_ms"] * 1e6 == pytest.approx(100 + 100 + 1_100 + 950 + 870 + 2_960)
    busy = 400 + 100 + 200 + 600 + 400 + 50 + 30 + 40
    assert sum(idle.values()) + got["idle_outside_ms"] * 1e6 == pytest.approx(10_000 - busy)


def test_readers_give_nothing_without_spans_and_per_work_with_them():
    for name, (read, cells) in spans.METRICS.items():
        assert cells and read({"traced": None}) is None, name
        assert read({"traced": {"works": [1], "n_steps": 1}}) is None, name  # a parent's slice
    slice_ = {"works": [2, 2], "n_steps": 2, "spans": spans.attribute(TRACE),
              "states": {**dict.fromkeys(perm_cuda.SCHEDULES, 0), "opt": 20}}
    ctx = {"traced": slice_}
    assert spans.deep_ms_per_proof(ctx) == pytest.approx(1_300e-6 / 4)
    assert spans.wrapper_glue_ms_per_step(ctx) == pytest.approx(100e-6 / 2)
    assert spans.states_per_work(ctx) == 5
    assert spans.host_stop_ms_per_proof(ctx) == 0
    assert spans.convert_ms_per_tree(ctx) == 0


def test_summarize_reads_a_fixed_trace_as_before():
    """The benchmark's own slice summary over the same hand-made trace: the
    spans are host annotations, so an idle gap under one is named by it."""
    evs = [(n, dev, s, e, note) for n, dev, s, e, note, _, _ in TRACE]
    got = tracing.summarize(evs, [2, 2])
    assert got["n_steps"] == 1 and got["works"] == [2, 2]
    assert got["window_s"] == pytest.approx(10_000e-9)
    assert got["busy_s"] == pytest.approx((400 + 100 + 200 + 600 + 400 + 50 + 30 + 40) * 1e-9)
    assert got["own_kernel_s"] == pytest.approx(700e-9)
    assert got["glue_s"] == pytest.approx(1_120e-9)
    assert got["kernel_launches"] == 5 and got["graph_launches"] == 1
    # each gap under the innermost host span open at its middle: the launch
    # at 500 for 0-1,000; fri.deep alone for 1,500-1,600 and 1,800-2,100
    assert dict(got["breakdown"]["idle_gaps"]) == pytest.approx({
        "cudaLaunchKernel": 1_000e-9, "fri.deep": 400e-9,
        "host, no traced call": (700 + 1_300 + 950 + 870 + 2_960) * 1e-9})
    assert got["breakdown"]["device_ops"][0] == ["Memcpy DtoH", pytest.approx(600e-9)]


def test_succinct_states_count_every_state_the_prover_hands_the_kernel(monkeypatch):
    """`hbench/stages.succinct_states`, from the proof's shapes and its
    nonce, against the batches the device prover hands its kernel seam (the
    FRI phase's body runs eagerly here, as a graph's capture sees it)."""
    from hbench import stages

    handed = []

    def kernel(states, schedule):
        handed.append(states.shape[0])
        out = native.perm_batch_digits(states.numpy().astype(np.uint32))
        return torch.from_numpy(out.astype(np.int32))

    monkeypatch.setattr(fri_cuda, "permute_cuda", kernel)
    c = _square(3, public=True)
    params = fri.FriParams(blowup=4, n_queries=3, final_degree=8, pow_bits=2)
    pk, vk = fri.preprocess_succinct(c, params, fri.default_pcs_perm())
    proof = fri_cuda.prove_succinct_device(c, pk, device="cpu")
    assert sum(handed) == stages.succinct_states(vk.n, params, [proof.pow_nonce])
    assert fri.verify_succinct(vk, proof, [g.pi for g in c.gates])
