"""The batched prover's three phases as CUDA graphs (prover_cuda.phase_graph),
routed here on the CPU through a stand-in graph.

On the card `prover_cuda._select_phases` returns callables that replay one
graph a phase and shape. There is no card here, so the card's branch runs
with CPU tensors through `StandInGraph`: it keeps static input buffers as
`utils/graphs.CudaGraph` does, copies each call's arguments into them, runs
the body on the buffers and records the key it was made for. The proofs
that come out must be the JAX package's host prover's, bit for bit.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from hades252_tpu import gadget as jgadget
from hades252_tpu import plonk as jplonk
from hades252_tpu_torch import gadget, plonk, prover_cuda
from hades252_tpu_torch.ops import perm_cuda
from hades252_tpu_torch.params import P
from hades252_tpu_torch.parallel import dist
from hades252_tpu_torch.utils import graphs

torch.set_num_threads(1)


class StandInGraph:
    """utils/graphs.CudaGraph's interface on the CPU: static buffers, the
    arguments copied in, the body run on the buffers, clones out."""

    made: list = []

    def __init__(self, fn, inputs, pool=None):
        self.fn, self.inputs, self.pool = fn, inputs, pool
        self.held = {s: 0 for s in perm_cuda.SCHEDULES}  # the phases launch no kernel
        self.replays = 0
        StandInGraph.made.append(self)

    def __call__(self, *args):
        for buf, x in zip(self.inputs, args, strict=True):
            buf.copy_(x)
        self.replays += 1
        return graphs._clone(self.fn(*self.inputs))


@pytest.fixture
def card_branch(monkeypatch):
    """Route prover_cuda's card branch through StandInGraph on CPU tensors:
    every prove_batched(device="cpu") takes the graph callables, the pool
    handles are tokens, and the graph cache starts empty."""
    StandInGraph.made = []
    pools = iter(range(1 << 20))
    monkeypatch.setattr(prover_cuda, "CudaGraph", StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool", next(pools)))
    monkeypatch.setattr(prover_cuda, "_PHASE_GRAPHS", type(prover_cuda._PHASE_GRAPHS)())
    select = prover_cuda._select_phases
    monkeypatch.setattr(prover_cuda, "_select_phases",
                        lambda mesh, device: select(mesh, torch.device("cuda")))
    return StandInGraph.made


def _instance(mod, v1, v2):
    """tests/test_torch_prover.py's tiny circuit, through `mod`'s Composer."""
    c = mod.Composer()
    a = c.append_witness(v1)
    b = c.append_witness(v2)
    c.gate_mul(mod.Constraint().mult(1).a(a).b(b))
    c.gate_add(mod.Constraint().left(1).a(a).right(1).b(b).public(-((v1 + v2) % P)))
    return c


def _chain(mod, values):
    """A circuit of 2 len(values) gates with shared wires (n = 64 at 30)."""
    c = mod.Composer()
    ws = [c.append_witness(v) for v in values]
    acc = ws[0]
    for w in ws[1:]:
        prod = c.gate_mul(mod.Constraint().mult(1).a(acc).b(w))
        acc = c.gate_add(mod.Constraint().left(1).a(prod).right(2).b(w).fourth(3).d(ws[0]).constant(5))
    c.append_gate(mod.Constraint().left(1).a(acc).public(-c.value(acc)))
    return c


def _ints(rng, k):
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(k)]


def _phases(selected) -> tuple:
    """The phases `_select_phases` handed out, each out of its span."""
    assert [f.__qualname__.startswith("_spanned") for f in selected] == [True] * 3
    return tuple(f.__wrapped__ for f in selected)


def test_select_phases_dispatches_by_device_and_mesh(monkeypatch):
    assert _phases(prover_cuda._select_phases(None, "cpu")) == prover_cuda._PHASES
    assert _phases(prover_cuda._select_phases(None, torch.device("cpu"))) == (
        prover_cuda._phase1_wires, prover_cuda._phase2_grand_product, prover_cuda._phase3_quotient)
    on_card = _phases(prover_cuda._select_phases(None, "cuda"))
    assert len(on_card) == 3 and not set(on_card) & set(prover_cuda._PHASES)
    assert all(f.__qualname__.startswith("_replayed") for f in on_card)
    on_card = _phases(prover_cuda._select_phases(None, torch.device("cuda", 0)))
    assert all(f.__qualname__.startswith("_replayed") for f in on_card)
    sharded = (object(), object(), object())
    seen = []
    monkeypatch.setattr(dist, "sharded_phases", lambda mesh: seen.append(mesh) or sharded)
    mesh = dist.Mesh(None, 1, 0, torch.device("cpu"))
    assert _phases(prover_cuda._select_phases(mesh, "cpu")) == sharded
    assert _phases(prover_cuda._select_phases(mesh, "cuda")) == sharded
    assert seen == [mesh, mesh]


@pytest.mark.parametrize("which", ["tiny", "chain"])
def test_prove_batched_through_the_graphs_equals_jax_host_prover(rng, card_branch, which):
    if which == "tiny":
        args = [(3, 5), (11, 13), (2**200, 7)]
        jcs = [_instance(jgadget, *a) for a in args]
        cs = [_instance(gadget, *a) for a in args]
    else:
        values = [_ints(rng, 30) for _ in range(2)]
        jcs, cs = [_chain(jgadget, v) for v in values], [_chain(gadget, v) for v in values]
    jkey, key = jplonk.preprocess(jcs[0]), plonk.preprocess(cs[0])
    assert key.n == (4 if which == "tiny" else 64)
    proofs = prover_cuda.prove_batched(cs, key, device="cpu")
    # one graph a phase, each replayed once, all three in one pool
    assert len(card_branch) == 3 and [g.replays for g in card_branch] == [1, 1, 1]
    assert len({g.pool for g in card_branch}) == 1
    for jc, c, pr in zip(jcs, cs, proofs):
        want = jplonk.prove(jc, jkey)
        assert (pr.wires, pr.z, pr.t, pr.commitments) == (want.wires, want.z, want.t,
                                                          want.commitments)
        assert plonk.verify(key, pr, [g.pi for g in c.gates])


def test_two_keys_of_one_shape_share_the_graphs(card_branch):
    """The key's tables are graph inputs: a second circuit of the same
    shape (B, n and every table's shape) replays the first one's graphs
    and gets its own proofs; another B gets graphs of its own."""
    c1 = [_instance(gadget, 3, 5), _instance(gadget, 4, 6)]
    other = []
    for v in (7, 8):
        c = gadget.Composer()
        a = c.append_witness(v)
        b = c.append_witness(v + 1)
        c.gate_add(gadget.Constraint().left(2).a(a).right(3).b(b).public(-((5 * v + 3) % P)))
        c.gate_mul(gadget.Constraint().mult(1).a(a).b(a))
        other.append(c)
    k1, k2 = plonk.preprocess(c1[0]), plonk.preprocess(other[0])
    assert k1.n == k2.n and k1.selectors != k2.selectors
    p1 = prover_cuda.prove_batched(c1, k1, device="cpu")
    assert len(card_branch) == 3
    p2 = prover_cuda.prove_batched(other, k2, device="cpu")
    assert len(card_branch) == 3 and [g.replays for g in card_branch] == [2, 2, 2]
    for c, k, got in zip(c1 + other, [k1, k1, k2, k2], p1 + p2):
        want = plonk.prove(c, k)
        assert (got.wires, got.z, got.t, got.commitments) == (want.wires, want.z, want.t,
                                                               want.commitments)
    # another batch size: three more graphs in a pool of their own
    prover_cuda.prove_batched(c1[:1], k1, device="cpu")
    assert len(card_branch) == 6 and [g.replays for g in card_branch[3:]] == [1, 1, 1]
    assert card_branch[3].pool != card_branch[0].pool
    assert len({g.pool for g in card_branch[3:]}) == 1
    # no graph keeps a key alive: its tables went in as copies
    gone = weakref.ref(k2)
    del k2, other, p2, got, want, k
    gc.collect()
    assert gone() is None and len(card_branch) == 6


def test_the_graph_cache_is_bounded(card_branch):
    """At most graphs._GRAPHS (B, n, device) groups stay cached, the least
    recently used evicted first; a group that is used again moves last."""
    cs = [_instance(gadget, 3 + i, 5) for i in range(graphs._GRAPHS + 2)]
    key = plonk.preprocess(cs[0])
    cache = prover_cuda._PHASE_GRAPHS
    for b in range(1, graphs._GRAPHS + 1):
        prover_cuda.prove_batched(cs[:b], key, device="cpu")
    assert [k[0] for k in cache] == list(range(1, graphs._GRAPHS + 1))
    prover_cuda.prove_batched(cs[:1], key, device="cpu")          # used again: moves last
    assert len(card_branch) == 3 * graphs._GRAPHS
    prover_cuda.prove_batched(cs[:graphs._GRAPHS + 1], key, device="cpu")
    assert len(cache) == graphs._GRAPHS
    assert [k[0] for k in cache] == [*range(3, graphs._GRAPHS + 1), 1, graphs._GRAPHS + 1]
    prover_cuda.prove_batched(cs[:2], key, device="cpu")          # evicted: captured anew
    assert len(card_branch) == 3 * (graphs._GRAPHS + 2)
    assert len(cache) == graphs._GRAPHS and 3 not in [k[0] for k in cache]


def test_phase_graph_flattens_the_selector_tables():
    """phase 3's q_mont dict goes in as tensors in sorted key order and
    comes back as the same dict."""
    q = {name: torch.full((4, 16), i, dtype=torch.int32) for i, name in
         enumerate(["q_m", "q_l", "q_r", "q_o", "q_4", "q_c"])}
    args = (torch.zeros(2, 3), q, torch.ones(5))
    flat, layout = prover_cuda._flatten(args)
    assert layout == (None, ("q_4", "q_c", "q_l", "q_m", "q_o", "q_r"), None)
    assert len(flat) == 8 and flat[1] is q["q_4"] and flat[-1] is args[2]
    back = prover_cuda._unflatten(flat, layout)
    assert back[0] is args[0] and back[2] is args[2] and back[1] == q


def test_a_failed_capture_raises(monkeypatch):
    """A capture that fails raises out of the phase: nothing falls back to
    the eager body."""
    def refuse(*_a, **_k):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(prover_cuda, "CudaGraph", refuse)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(prover_cuda, "_PHASE_GRAPHS", type(prover_cuda._PHASE_GRAPHS)())
    phase1, _, _ = prover_cuda._select_phases(None, "cuda")
    x = torch.from_numpy(np.zeros((1, 4, 4, 16), np.int32))
    with pytest.raises(RuntimeError, match="capture refused"):
        phase1(x)


def test_cuda_graph_holds_every_field_kernel_counter(monkeypatch):
    """utils/graphs.CudaGraph's bookkeeping, with torch.cuda's stream and
    graph calls stood in for on the CPU and a body that counts as
    field_cuda's wrappers count a launch: the capture holds the launches
    and elements of the inversion, the conversion and each element-wise op;
    the capture's elements are taken back out (it runs nothing), the
    launches are not; each replay adds the held elements and no launch."""
    import contextlib

    from hades252_tpu_torch.ops import field_cuda

    class Stream:
        def __init__(self, *_a):
            pass

        def wait_stream(self, _other):
            pass

    class Graph:
        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *_a: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda _s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda _g, pool=None: contextlib.nullcontext())
    for name in ("launches", "inverted", "conversions", "converted"):
        monkeypatch.setattr(field_cuda, name, 0)
    monkeypatch.setattr(field_cuda, "arith_launches", dict.fromkeys(field_cuda.ARITH_OPS, 0))
    monkeypatch.setattr(field_cuda, "arith_elements", dict.fromkeys(field_cuda.ARITH_OPS, 0))

    def body(x):
        field_cuda.launches += 1
        field_cuda.inverted += 3
        field_cuda.conversions += 2
        field_cuda.converted += 10
        field_cuda.arith_launches["mul"] += 4
        field_cuda.arith_elements["mul"] += 40
        field_cuda.arith_launches["sub"] += 1
        field_cuda.arith_elements["sub"] += 5
        return x + 1

    x = torch.zeros(3)
    graph = graphs.CudaGraph(body, (x.clone(),))
    assert (graph.held_inverts, graph.held_inverted) == (1, 3)
    assert (graph.held_conversions, graph.held_converted) == (2, 10)
    assert graph.held_arith == {"mul": 4, "add": 0, "sub": 1}
    assert graph.held_arith_elements == {"mul": 40, "add": 0, "sub": 5}
    # the warm-up's and the capture's launches, the warm-up's elements alone
    assert (field_cuda.launches, field_cuda.inverted) == (2, 3)
    assert (field_cuda.conversions, field_cuda.converted) == (4, 10)
    assert field_cuda.arith_launches == {"mul": 8, "add": 0, "sub": 2}
    assert field_cuda.arith_elements == {"mul": 40, "add": 0, "sub": 5}
    for k in (1, 2):
        assert torch.equal(graph(x), x + 1) and graph.replays == k
        assert (field_cuda.inverted, field_cuda.converted) == (3 * (1 + k), 10 * (1 + k))
        assert field_cuda.arith_elements == {"mul": 40 * (1 + k), "add": 0, "sub": 5 * (1 + k)}
    assert field_cuda.launches == 2 and field_cuda.conversions == 4
    assert field_cuda.arith_launches == {"mul": 8, "add": 0, "sub": 2}
