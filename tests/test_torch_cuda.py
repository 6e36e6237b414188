"""The port's CUDA kernels on the card: each against its plain PyTorch
version and the int oracle, exactly.

Every test here needs a CUDA device and carries the `cuda` marker; without
a card they skip. The file imports neither JAX nor `hades252_tpu`, so on
the GPU host (which has neither) it runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q -m cuda
"""

import os

import numpy as np
import pytest
import torch

from hades252_tpu_torch import field, selftest
from hades252_tpu_torch.models import cipher, merkle, sponge
from hades252_tpu_torch.ops import field_cuda, make_perm_mont_fn, perm_cuda, permute
from hades252_tpu_torch.strategy import ScalarStrategy
from hades252_tpu_torch.utils import checkpoint
from hades252_tpu_torch.utils.graphs import _LIVE_GRAPHS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


_NO_LAUNCHES = {s: 0 for s in perm_cuda.SCHEDULES}


def _elements(shape, seed: int) -> torch.Tensor:
    """Seeded canonical field elements, (..., 16) int32 on the CPU."""
    x = field.np_random_elements(shape, np.random.default_rng(seed))
    return torch.from_numpy(x.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 1000, 4096])
@pytest.mark.parametrize("schedule", perm_cuda.SCHEDULES)
@pytest.mark.parametrize("convert", [True, False])
def test_kernel_matches_plain(cuda_device, b, schedule, convert):
    x = _elements((5, b), 20 + b).permute(0, 2, 1).contiguous().to(cuda_device)
    before = perm_cuda.launches[schedule]
    got = perm_cuda.permute_planar(x, convert=convert, schedule=schedule)
    torch.cuda.synchronize()
    assert perm_cuda.launches[schedule] == before + 1
    want = perm_cuda.permute_planar_plain(x, convert=convert, schedule=schedule)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [5, 63, 65, 127, 129, (1 << 14) + 1])
@pytest.mark.parametrize("schedule", perm_cuda.SCHEDULES)
@pytest.mark.parametrize("convert", [True, False])
def test_ragged_edges_of_lane_groups_and_small_blocks(cuda_device, b, schedule, convert):
    """naive and opt run a group of lanes a state (4 lanes, 32 states a
    block, at most of these sizes, fewer above), hyb, hybp, hyb13 and
    hybp13 64 states a block, and mxu8 and mxu one warpgroup of 128: batches
    that end inside a group, a warp, a warpgroup or a block, against the
    plain version and, for opt, the native engine's sparse schedule."""
    from hades252_tpu_torch.utils import native

    x = _elements((b, 5), 40 + b)
    planar = x.permute(1, 2, 0).contiguous().to(cuda_device)
    got = perm_cuda.permute_planar(planar, convert=convert, schedule=schedule)
    want = perm_cuda.permute_planar_plain(planar, convert=convert, schedule=schedule)
    assert torch.equal(got, want)
    if schedule == "opt" and convert:
        engine = native.perm_batch_digits(x.numpy())
        assert np.array_equal(got.permute(2, 0, 1).cpu().numpy(), engine)


@pytest.mark.cuda
def test_kat_gate(cuda_device):
    selftest.assert_device_correct(device=cuda_device)


@pytest.mark.cuda
def test_scalar_strategy_cuda_backend(cuda_device):
    x = _elements((7, 5), 2)
    got = ScalarStrategy("cuda").perm(x)
    assert got.is_cuda and torch.equal(got.cpu(), permute(x))


@pytest.mark.cuda
def test_wrapper_rejects_bad_cuda_input(cuda_device):
    x = _elements((5, 8), 1).permute(0, 2, 1).contiguous().to(cuda_device)
    with pytest.raises(ValueError):
        perm_cuda.permute_planar(x.to(torch.int64))
    with pytest.raises(ValueError):
        perm_cuda.permute_planar(x[:, :, ::2])  # not contiguous
    assert perm_cuda.permute_planar(x[:, :, :0].contiguous()).shape == (5, 16, 0)


@pytest.mark.cuda
def test_merkle_and_sponge(cuda_device):
    leaves = _elements((256,), 500)
    msgs = _elements((8, 9), 501)
    perm_cuda.reset_launches()
    root = merkle.merkle_root(leaves.to(cuda_device))
    digest = sponge.sponge_hash(msgs.to(cuda_device))
    assert perm_cuda.launches == {**_NO_LAUNCHES, "opt": merkle.tree_levels(256) + 3}
    naive = merkle.merkle_root(leaves.to(cuda_device), make_perm_mont_fn("cuda", schedule="naive"))
    assert perm_cuda.launches["naive"] == merkle.tree_levels(256)
    assert torch.equal(root.cpu(), merkle.merkle_root(leaves))
    assert torch.equal(naive, root)
    assert torch.equal(digest.cpu(), sponge.sponge_hash(msgs))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(16, 32, 8), (64, 160, 128), (320, 160, 1000), (45, 70, 129)])
def test_mxu8_dot_matches_float64_matmul(cuda_device, m, k, n):
    g = torch.Generator().manual_seed(m * k + n)
    w = torch.randint(0, 256, (m, k), dtype=torch.uint8, generator=g)
    x = torch.randint(0, 256, (k, n), dtype=torch.uint8, generator=g)
    got = perm_cuda.mxu8_dot(w.to(cuda_device), x.to(cuda_device))
    want = torch.matmul(w.double(), x.double()).to(cuda_device)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.double(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(16, 32, 8), (64, 160, 128), (320, 160, 1000), (45, 70, 129)])
def test_mxu_dot_matches_float64_matmul(cuda_device, m, k, n):
    g = torch.Generator().manual_seed(m * k + n + 1)
    w = torch.randint(0, 256, (m, k), dtype=torch.uint8, generator=g)
    x = torch.randint(0, 256, (k, n), dtype=torch.uint8, generator=g)
    got = perm_cuda.mxu_dot(w.to(cuda_device), x.to(cuda_device))
    want = torch.matmul(w.double(), x.double()).to(cuda_device)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.double(), want)


@pytest.mark.cuda
def test_mxu_dot_is_exact_at_its_largest_sum(cuda_device):
    """All-255 operands at K = 160: every sum is 160 * 255^2 = 10,404,000,
    the largest the bf16 dot meets, below 2^24 and so exact in its f32
    accumulation."""
    w = torch.full((320, 160), 255, dtype=torch.uint8, device=cuda_device)
    x = torch.full((160, 300), 255, dtype=torch.uint8, device=cuda_device)
    got = perm_cuda.mxu_dot(w, x)
    assert got.shape == (320, 300) and bool((got == 160 * 255 * 255).all())
    # one operand short of the top: the odd sums just below it
    x[7] = 254
    assert bool((perm_cuda.mxu_dot(w, x) == 160 * 255 * 255 - 255).all())


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["hyb13", "hybp13"])
def test_base13_kernels_take_unnormalised_squares(cuda_device, schedule):
    """States of 0, 1 and p - 1 drive the S-box's x^2 and x^4 to both ends
    of [0, 2p); the kernel must agree with the opt kernel on them."""
    from hades252_tpu_torch.params import P
    from hades252_tpu_torch.utils.encoding import ints_to_digits

    words = [0, 1, 2, P - 1, P - 2, (P + 1) // 2, 3, 1 << 254]
    states = [[words[(i + j) % len(words)] for j in range(5)] for i in range(len(words))]
    x = torch.from_numpy(ints_to_digits(states, shape=(len(words), 5)).astype(np.int32))
    x = x.to(cuda_device)
    got = perm_cuda.permute_cuda(x, schedule=schedule)
    assert torch.equal(got, perm_cuda.permute_cuda(x, schedule="opt"))
    assert torch.equal(got.cpu(), permute(x.cpu()))


@pytest.mark.cuda
def test_checkpointed_build_and_resumes(cuda_device, tmp_path):
    n, d = 1000, str(tmp_path / "ckpt")
    leaves = _elements((n,), 800).to(cuda_device)
    height = merkle.tree_levels(n)  # 5: 1000 leaves pad to 1024
    want = merkle.merkle_root(leaves)  # the default opt kernel
    perm_cuda.reset_launches()
    root = checkpoint.merkle_root_checkpointed(leaves, d, make_perm_mont_fn("cuda", schedule="mxu"))
    assert perm_cuda.launches == {**_NO_LAUNCHES, "mxu": height}
    assert root.is_cuda and torch.equal(root, want)
    assert np.array_equal(checkpoint.load_level(d, height, 1)[0], want.cpu().numpy())
    whole = {k: open(os.path.join(d, f"level_{k}.bin"), "rb").read() for k in range(1, height + 1)}
    # the files are what the CPU build (plain versions) writes
    cpu_dir = str(tmp_path / "cpu")
    checkpoint.merkle_root_checkpointed(leaves.cpu(), cpu_dir)
    assert all(open(os.path.join(cpu_dir, f"level_{k}.bin"), "rb").read() == v
               for k, v in whole.items())
    assert open(os.path.join(cpu_dir, "meta.json")).read() == open(os.path.join(d, "meta.json")).read()
    for schedule in ("hyb13", "hybp13"):
        for k in (4, 5):
            os.remove(os.path.join(d, f"level_{k}.bin"))
        with open(os.path.join(d, "level_3.bin"), "r+b") as f:
            f.truncate(31)
        assert checkpoint.highest_saved_level(d, height, 1024) == 2
        perm_cuda.reset_launches()
        again = checkpoint.merkle_root_checkpointed(
            leaves, d, make_perm_mont_fn("cuda", schedule=schedule))
        assert perm_cuda.launches == {**_NO_LAUNCHES, schedule: 3}
        assert torch.equal(again, want)
        assert all(open(os.path.join(d, f"level_{k}.bin"), "rb").read() == v
                   for k, v in whole.items())
    other = leaves.clone()
    other[17, 2] ^= 1
    perm_cuda.reset_launches()
    with pytest.raises(ValueError, match="different build"):
        checkpoint.merkle_root_checkpointed(other, d)
    assert perm_cuda.launches == _NO_LAUNCHES


@pytest.mark.cuda
def test_native_engine_agrees_with_the_kernels(cuda_device):
    from hades252_tpu_torch.utils import native

    x = _elements((64, 5), 801)
    want = native.perm_batch_digits(x.numpy())
    for schedule in ("opt", "mxu", "hyb13", "hybp13"):
        got = perm_cuda.permute_cuda(x.to(cuda_device), schedule=schedule)
        assert np.array_equal(got.cpu().numpy(), want), schedule
    leaves = _elements((256,), 802)
    assert np.array_equal(native.merkle_root_digits(leaves.numpy()),
                          merkle.merkle_root(leaves.to(cuda_device)).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["hyb", "hybp"])
def test_merkle_openings_and_batched_verification(cuda_device, schedule):
    n, k = 1000, 300
    leaves = _elements((n,), 700).to(cuda_device)
    fn = make_perm_mont_fn("cuda", schedule=schedule)
    height = merkle.tree_levels(n)
    perm_cuda.reset_launches()
    levels = merkle.merkle_levels(leaves, fn)
    assert perm_cuda.launches == {**_NO_LAUNCHES, schedule: height}
    root = field.from_mont(levels[-1][0])
    assert torch.equal(root, merkle.merkle_root(leaves))  # the default opt kernel
    idx = torch.from_numpy(np.random.default_rng(701).integers(0, n, k)).to(cuda_device)
    sibs, poss = merkle.merkle_open_batched(levels, idx)
    assert sibs.shape == (k, height, 3, 16) and poss.shape == (k, height)
    for row in (0, 7, k - 1):
        s, p = merkle.merkle_open_compact(levels, int(idx[row]))
        assert torch.equal(sibs[row], s) and torch.equal(poss[row], p)
    perm_cuda.reset_launches()
    ok = merkle.merkle_verify_batched(root, leaves[idx], sibs, poss, height, fn)
    assert perm_cuda.launches == {**_NO_LAUNCHES, schedule: height}
    assert ok.dtype == torch.bool and bool(ok.all())
    assert torch.equal(ok, merkle.merkle_verify_batched(root, leaves[idx], sibs, poss, height))
    tampered = sibs.clone()
    tampered[5, 2, 1, 0] ^= 1
    bad = merkle.merkle_verify_batched(root, leaves[idx], tampered, poss, height, fn)
    assert not bool(bad[5]) and int(bad.sum()) == k - 1
    out_of_range = poss.clone()
    out_of_range[9, 0] = 4
    bad = merkle.merkle_verify_batched(root, leaves[idx], sibs, out_of_range, height, fn)
    assert not bool(bad[9]) and int(bad.sum()) == k - 1
    # a path of another length than the verifier's height rejects every row
    assert not bool(merkle.merkle_verify_batched(root, leaves[idx], sibs, poss, height - 1,
                                                 fn).any())
    assert merkle.merkle_verify(root, leaves[idx[0]], merkle.merkle_open(levels, int(idx[0])),
                                height, fn)


@pytest.mark.cuda
def test_cipher_through_mxu8(cuda_device):
    b, l = 1000, 32
    key, nonce, msgs = _elements((b, 2), 600), _elements((b,), 601), _elements((b, l), 602)
    key, nonce, msgs = key.to(cuda_device), nonce.to(cuda_device), msgs.to(cuda_device)
    perm_cuda.reset_launches()
    ct, tag = cipher.encrypt(key, nonce, msgs, make_perm_mont_fn("cuda", schedule="mxu8"))
    torch.cuda.synchronize()
    assert perm_cuda.launches == {**_NO_LAUNCHES, "mxu8": 1 + l // cipher.RATE}
    ct_opt, tag_opt = cipher.encrypt(key, nonce, msgs)  # the default opt kernel
    assert torch.equal(ct, ct_opt) and torch.equal(tag, tag_opt)
    ct_p, tag_p = cipher.encrypt(key[:16], nonce[:16], msgs[:16], _plain_mont_fn("mxu8"))
    assert torch.equal(ct[:16], ct_p) and torch.equal(tag[:16], tag_p)
    pt, ok = cipher.decrypt(key, nonce, ct, tag, make_perm_mont_fn("cuda", schedule="mxu8"))
    assert bool(ok.all()) and torch.equal(pt, msgs)


def _plain_mont_fn(schedule):
    def fn(x):
        out = perm_cuda.permute_planar_plain(x.permute(1, 2, 0).contiguous(), convert=False,
                                             schedule=schedule)
        return out.permute(2, 0, 1).contiguous()
    return fn


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", perm_cuda.SCHEDULES)
def test_cuda_tensor_never_takes_the_plain_path(cuda_device, monkeypatch, schedule):
    x = _elements((5, 300), 3).permute(0, 2, 1).contiguous().to(cuda_device)
    want = perm_cuda.permute_planar_plain(x, schedule=schedule)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(perm_cuda, "permute_planar_plain", refuse)
    monkeypatch.setitem(perm_cuda._PLAIN, schedule, refuse)
    before = perm_cuda.launches[schedule]
    got = perm_cuda.permute_planar(x, schedule=schedule)
    torch.cuda.synchronize()
    assert perm_cuda.launches[schedule] == before + 1 and torch.equal(got, want)
    # an input the kernel cannot take raises instead of falling back
    with pytest.raises(ValueError):
        perm_cuda.permute_planar(x[:, :, ::2], schedule=schedule)


def _invert_inputs(shape, seed: int, mont_in: bool, device) -> torch.Tensor:
    """Seeded elements on the card, the first one 0 (DEEP's x - point where
    the point is x), in the Montgomery form for mont_in."""
    x = _elements(shape, seed).to(device)
    x.view(-1, 16)[0] = 0
    return field.to_mont(x) if mont_in else x


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1,), (63,), (65,), (1000,), (2, 1 << 15)])
@pytest.mark.parametrize("mont_in", [False, True])
def test_field_invert_kernel_matches_plain(cuda_device, shape, mont_in):
    """hades_field_invert against its plain version (field's torch ops on
    the card): ragged sizes around its 64-thread blocks, one element, and
    DEEP's 2 x 2^15 block of a prod proof; one launch a call, and an input
    it cannot take refused."""
    x = _invert_inputs(shape, 60 + len(shape) + shape[-1] % 97, mont_in, cuda_device)
    before = field_cuda.launches
    got = field_cuda.invert(x, mont_in=mont_in)
    torch.cuda.synchronize()
    assert field_cuda.launches == before + 1
    assert torch.equal(got, field_cuda.invert_plain(x, mont_in=mont_in))
    assert not got.view(-1, 16)[0].any()
    strided = torch.stack([x.view(-1, 16)] * 2, dim=-1)[..., 0]  # digits 2 int32 apart
    with pytest.raises(ValueError):
        field_cuda.invert(strided, mont_in=mont_in)


@pytest.mark.cuda
def test_field_invert_kernel_replays_in_a_graph(cuda_device):
    """The kernel captured in a CudaGraph (as phase 2 is): two replays give
    the plain version's output, and each adds the elements the graph holds
    to field_cuda.inverted."""
    from hades252_tpu_torch.utils.graphs import CudaGraph

    x = _invert_inputs((16, 1024), 71, True, cuda_device)
    n = x.numel() // 16
    want = field_cuda.invert_plain(x, mont_in=True)
    launches, inverted = field_cuda.launches, field_cuda.inverted
    graph = CudaGraph(lambda a: field_cuda.invert(a, mont_in=True), (x.clone(),))
    assert field_cuda.launches == launches + 2  # the warm-up's and the capture's
    assert graph.held_inverts == 1 and graph.held_inverted == n
    assert field_cuda.inverted == inverted + n  # the warm-up's; the capture ran nothing
    before = field_cuda.inverted
    clones = [graph(x) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(c, want) for c in clones) and clones[0].data_ptr() != clones[1].data_ptr()
    assert field_cuda.inverted == before + 2 * n
    assert field_cuda.launches == launches + 2  # a replay calls no wrapper


def _convert_inputs(layout: str, n: int, seed: int, device) -> torch.Tensor:
    """n seeded elements on the card, the first three 0, 1 and p - 1: as
    rows, or as a column of a (n, 5, 16) permutation output (rows 80
    digits apart, the Merkle verifier's node)."""
    from hades252_tpu_torch.params import P, int_to_digits

    x = _elements((n,), seed)
    edges = torch.from_numpy(np.stack([int_to_digits(v) for v in (0, 1, P - 1)]).astype(np.int32))
    x[:3] = edges[:n]
    x = x.to(device)
    return x if layout == "rows" else torch.stack([x.flip(0)] * 2 + [x] * 3, dim=1)[:, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, (1 << 14) + 3, 1 << 16])
@pytest.mark.parametrize("layout", ["rows", "strided_rows"])
@pytest.mark.parametrize("to", [True, False])
def test_field_convert_kernel_matches_plain(cuda_device, n, layout, to):
    """hades_field_convert against field's torch ops on the card: one
    element, a size that ends inside a warp, 2^16; rows contiguous or read
    in place 80 digits apart; into and out of the Montgomery form, and
    into it from leaves zero-padded to a power of four, as the Merkle build
    converts them. One launch a call, n elements counted."""
    x = _convert_inputs(layout, n, 90 + n % 89, cuda_device)
    assert x.stride(0) == (16 if layout == "rows" else 80)
    convert, plain = (field_cuda.to_mont, field.to_mont) if to else \
        (field_cuda.from_mont, field.from_mont)
    launches, converted = field_cuda.conversions, field_cuda.converted
    got = convert(x)
    torch.cuda.synchronize()
    assert field_cuda.conversions == launches + 1 and field_cuda.converted == converted + n
    assert torch.equal(got, plain(x)) and got.is_contiguous()
    if to:
        padded = field_cuda.to_mont(merkle._pad_to_pow4(x))
        rows = merkle.ARITY ** merkle.tree_levels(n)
        assert field_cuda.converted == converted + n + rows
        assert padded.shape == (rows, 16) and torch.equal(padded[:n], got)
        assert not padded[n:].any()


@pytest.mark.cuda
def test_field_convert_kernel_reads_unaligned_rows_through_a_copy(cuda_device):
    """Rows the 16-byte vectors cannot reach in place (18 digits apart) are
    made contiguous first, then converted in one launch."""
    x = _elements((1000,), 95).to(cuda_device)
    odd = torch.cat([x, x[:, :2]], dim=1)[:, :16]
    launches = field_cuda.conversions
    got = field_cuda.to_mont(odd)
    torch.cuda.synchronize()
    assert field_cuda.conversions == launches + 1 and torch.equal(got, field.to_mont(x))


@pytest.mark.cuda
def test_merkle_drivers_never_take_the_plain_conversion(cuda_device, monkeypatch):
    """The Merkle drivers on a card convert through hades_field_convert
    only: with field's conversions made to raise, the build, the root, the
    batched and the single verification run, each conversion one launch,
    and agree bit for bit with the same drivers on the CPU."""
    n, k = 1000, 300
    leaves = _elements((n,), 96)
    height = merkle.tree_levels(n)
    idx = torch.from_numpy(np.random.default_rng(97).integers(0, n, k))
    cpu_levels = merkle.merkle_levels(leaves)
    cpu_root = field.from_mont(cpu_levels[-1][0])
    cpu_path = merkle.merkle_open(cpu_levels, 17)
    cpu_single = [merkle.merkle_verify(cpu_root, leaves[i], cpu_path, height) for i in (17, 18)]
    assert cpu_single == [True, False]
    cpu_sibs, cpu_poss = merkle.merkle_open_batched(cpu_levels, idx)
    tampered = cpu_sibs.clone()
    tampered[5, 2, 1, 0] ^= 1
    cpu_ok = merkle.merkle_verify_batched(cpu_root, leaves[idx], tampered, cpu_poss, height)
    assert not bool(cpu_ok[5]) and int(cpu_ok.sum()) == k - 1

    def refuse(*args, **kwargs):
        raise AssertionError("the plain conversion ran for a CUDA tensor")

    monkeypatch.setattr(field, "to_mont", refuse)
    monkeypatch.setattr(field, "from_mont", refuse)
    dev = leaves.to(cuda_device)
    merkle._tag_mont(dev.device)  # the node rule's tag, converted once a device
    launches, converted = field_cuda.conversions, field_cuda.converted
    levels = merkle.merkle_levels(dev)
    root = merkle.merkle_root(dev)
    torch.cuda.synchronize()
    assert field_cuda.conversions - launches == 3  # the levels', the root's in and out
    assert field_cuda.converted - converted == 2 * 4**height + 1  # leaves padded to 4^height
    assert len(levels) == len(cpu_levels)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(levels, cpu_levels))
    assert torch.equal(root.cpu(), cpu_root)
    sibs, poss = merkle.merkle_open_batched(levels, idx.to(cuda_device))
    assert torch.equal(sibs.cpu(), cpu_sibs) and torch.equal(poss.cpu(), cpu_poss)
    launches, converted = field_cuda.conversions, field_cuda.converted
    ok = merkle.merkle_verify_batched(root, dev[idx.to(cuda_device)], tampered.to(cuda_device),
                                      poss, height)
    torch.cuda.synchronize()
    assert field_cuda.conversions - launches == 2 and field_cuda.converted - converted == 2 * k
    assert torch.equal(ok.cpu(), cpu_ok)
    path = merkle.merkle_open(levels, 17)
    launches = field_cuda.conversions
    assert [merkle.merkle_verify(root, dev[i], path, height) for i in (17, 18)] == cpu_single
    assert field_cuda.conversions - launches == 3  # 17's in and out; 18 fails at the leaf


def _chain_circuit(values):
    """A circuit of 2 len(values) gates with shared wires and a public
    output."""
    from hades252_tpu_torch.gadget import Composer, Constraint

    c = Composer()
    ws = [c.append_witness(v) for v in values]
    acc = ws[0]
    for w in ws[1:]:
        prod = c.gate_mul(Constraint().mult(1).a(acc).b(w))
        acc = c.gate_add(Constraint().left(1).a(prod).right(2).b(w).fourth(3).d(ws[0]).constant(5))
    c.append_gate(Constraint().left(1).a(acc).public(-c.value(acc)))
    return c


@pytest.mark.cuda
def test_prove_batched_on_the_card_equals_the_cpu(cuda_device):
    """The batched prover on its default device, the card, against the
    same torch code on the CPU and the host prover: the same proofs."""
    from hades252_tpu_torch import plonk, prover_cuda

    rng = np.random.default_rng(7)
    cs = [_chain_circuit([int(v) for v in rng.integers(0, 1 << 62, 30)]) for _ in range(4)]
    key = plonk.preprocess(cs[0])
    on_card = prover_cuda.prove_batched(cs, key)
    on_cpu = prover_cuda.prove_batched(cs, key, device="cpu")
    host = plonk.prove(cs[0], key)
    for a, b in zip(on_card, on_cpu):
        assert (a.wires, a.z, a.t, a.commitments) == (b.wires, b.z, b.t, b.commitments)
    assert (on_card[0].t, on_card[0].commitments) == (host.t, host.commitments)
    assert all(plonk.verify(key, pr, [g.pi for g in c.gates]) for c, pr in zip(cs, on_card))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
def test_prover_phase_graphs_replay_their_eager_bodies(cuda_device, b, monkeypatch):
    """Each of the three prover phases on the card is one graph replay:
    its output on a prove_batched's own arguments, and one more replay of
    the same graph, equal the eager body's bit for bit; the proofs equal
    the host prover's; the phases launch no kernel."""
    from hades252_tpu_torch import plonk, prover_cuda

    rng = np.random.default_rng(11 + b)
    cs = [_chain_circuit([int(v) for v in rng.integers(0, 1 << 62, 30)]) for _ in range(b)]
    key = plonk.preprocess(cs[0])
    seen, select = {}, prover_cuda._select_phases

    def spying(mesh, device):
        def spy(i, fn):
            def run(*args):
                seen[i] = (args, fn(*args))
                return seen[i][1]
            return run
        return tuple(spy(i, fn) for i, fn in enumerate(select(mesh, device)))

    monkeypatch.setattr(prover_cuda, "_select_phases", spying)
    perm_cuda.reset_launches()
    proofs = prover_cuda.prove_batched(cs, key)
    torch.cuda.synchronize()
    assert perm_cuda.launches == _NO_LAUNCHES
    for i in range(3):
        args, got = seen[i]
        flat, layout = prover_cuda._flatten(args)
        graph = prover_cuda.phase_graph(i, flat, layout)
        assert graph.replays >= 1 and graph.held == _NO_LAUNCHES
        want = prover_cuda._PHASES[i](*args)
        assert torch.equal(got, want) and torch.equal(graph(*flat), want)
    for c, pr in zip(cs, proofs, strict=True):
        host = plonk.prove(c, key)
        assert (pr.wires, pr.z, pr.t, pr.commitments) == (host.wires, host.z, host.t,
                                                          host.commitments)


@pytest.mark.cuda
def test_entry_gates_then_returns_the_kernel(cuda_device):
    from hades252_tpu_torch import entry

    perm_cuda.reset_launches()
    fn, (x,) = entry.entry()
    out = fn(x)
    torch.cuda.synchronize()
    assert perm_cuda.launches == {**_NO_LAUNCHES, perm_cuda.DEFAULT_SCHEDULE: 2}
    assert x.shape == (5, 16, 1024) and x.is_cuda
    assert torch.equal(out, perm_cuda.permute_planar_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 64, 1024])
def test_ntt_on_the_card_equals_the_cpu(cuda_device, n):
    from hades252_tpu_torch.ops import ntt

    x = _elements((3, n), 700 + n)
    for invert in (False, True):
        got = ntt.ntt_batched(x.to(cuda_device), invert=invert)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), ntt.ntt_batched(x, invert=invert))
    ev = ntt.coset_eval_batched(x.to(cuda_device), 7)
    assert torch.equal(ev.cpu(), ntt.coset_eval_batched(x, 7))
    assert torch.equal(ntt.coset_interp_batched(ev, 7).cpu(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 1000, 4096])
@pytest.mark.parametrize("schedule", ["opt", "hybp"])
def test_device_pool_perm_equals_the_native_engine(cuda_device, b, schedule):
    """The succinct argument's card seam on seeded canonical states: the
    kernel's launch, no padding, the native engine's outputs."""
    from hades252_tpu_torch import fri_cuda
    from hades252_tpu_torch.utils import native

    states = field.np_random_elements((b, 5), np.random.default_rng(900 + b)).astype(np.uint32)
    perm = fri_cuda.device_pool_perm(schedule)
    before = perm_cuda.launches[schedule]
    got = perm(states)
    assert perm_cuda.launches[schedule] == before + 1
    assert got.dtype == np.uint32 and got.shape == (b, 5, 16)
    assert np.array_equal(got, native.perm_batch_digits(states))


@pytest.mark.cuda
def test_prove_succinct_through_the_card_equals_the_native_engine(cuda_device):
    """A "fast"-preset succinct proof whose trees, leaf sponges and grind
    run on the card: byte-identical to the native engine's, and verified
    through the card."""
    from hades252_tpu_torch import fri, fri_cuda, serialize

    rng = np.random.default_rng(11)
    c = _chain_circuit([int(v) for v in rng.integers(0, 1 << 62, 30)])
    params = fri.FriParams(blowup=4, n_queries=16, final_degree=64, pow_bits=8)
    pk, vk = fri.preprocess_succinct(c, params, fri.default_pcs_perm())
    perm = fri_cuda.device_pool_perm("opt")
    perm_cuda.reset_launches()
    on_card = fri.prove_succinct(c, pk, perm)
    assert perm_cuda.launches["opt"] > 0
    host = fri.prove_succinct(c, pk, fri.default_pcs_perm())
    assert serialize.proof_to_bytes(on_card, vk) == serialize.proof_to_bytes(host, vk)
    assert fri.verify_succinct(vk, on_card, [g.pi for g in c.gates],
                               fri_cuda.device_pool_perm("hybp"))


def _fast_instances(b: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [_chain_circuit([int(v) for v in rng.integers(0, 1 << 62, 30)]) for _ in range(b)]


_FAST = dict(blowup=4, n_queries=16, final_degree=64, pow_bits=8)


@pytest.mark.cuda
@pytest.mark.parametrize("zk", [False, True])
@pytest.mark.parametrize("b", [1, 4])
def test_device_prover_equals_the_native_engine(cuda_device, b, zk):
    """The device-resident succinct prover on its default device, the card,
    at the "fast" preset with 8 PoW bits: each proof byte-identical to the
    native engine's fri.prove_succinct for the same instance and rng, and
    verified through the card; only the opt kernel launches."""
    from hades252_tpu_torch import fri, fri_cuda, serialize

    cs = _fast_instances(b, 12 + b)
    pk, vk = fri.preprocess_succinct(cs[0], fri.FriParams(**_FAST, zk=zk), fri.default_pcs_perm())
    perm_cuda.reset_launches()
    proofs = fri_cuda.prove_succinct_device_batch(
        cs, pk, [np.random.default_rng(40 + k) for k in range(b)])
    torch.cuda.synchronize()
    assert perm_cuda.launches["opt"] > 0
    assert all(n == 0 for s, n in perm_cuda.launches.items() if s != "opt")
    for k, (c, proof) in enumerate(zip(cs, proofs)):
        host = fri.prove_succinct(c, pk, fri.default_pcs_perm(), rng=np.random.default_rng(40 + k))
        assert serialize.proof_to_bytes(proof, vk) == serialize.proof_to_bytes(host, vk)
    assert all(fri.verify_succinct_batched(vk, proofs, [[g.pi for g in c.gates] for c in cs],
                                           fri_cuda.device_pool_perm("hybp")))


def _flat(out) -> list:
    cur, state, evals, levels = out
    return [cur, state, *evals, *(lv for lvs in levels for lv in lvs)]


@pytest.mark.cuda
def test_fri_phase_graph_replays_the_eager_body(cuda_device):
    """The FRI commit phase captured as one CUDA graph: its replays equal the
    eager body on the same inputs, tensor for tensor, for two inputs in
    turn (the static buffers are reused); a replay calls no wrapper, and
    the graph holds the launches the eager body makes."""
    from hades252_tpu_torch import fri_cuda

    dev = torch.device("cuda", torch.cuda.current_device())
    b, m0, n_folds = 2, 1024, 5  # layers (1, 4) and (3, 4): trees of heights 4 and 3
    graph = fri_cuda.fri_phase_graph(b, m0, n_folds, "opt", dev)
    assert graph.held == {**_NO_LAUNCHES, "opt": n_folds + (1 + 4 + 1) + (1 + 3 + 1)}
    for seed in (31, 32):
        f0, tr = _elements((b, m0), seed).to(dev), _elements((b, 5), seed + 100).to(dev)
        perm_cuda.reset_launches()
        replays = graph.replays
        got = _flat(graph(f0, tr))
        torch.cuda.synchronize()
        assert perm_cuda.launches == _NO_LAUNCHES and graph.replays == replays + 1
        consts = fri_cuda._fri_phase_consts(m0, n_folds, dev)
        want = _flat(fri_cuda._fri_phase_body(f0, tr, *consts, fri_cuda._perm_fn("opt")))
        assert perm_cuda.launches == graph.held
        assert len(got) == len(want) and all(torch.equal(x, y) for x, y in zip(got, want))
        # the graph holds its own constant tables: dropping the cache's
        # copies and reusing their memory changes no replay
        del consts, want
        fri_cuda._on_device.cache_clear()
        junk = [torch.full((1 << 16, 16), 0x5A5A, dtype=torch.int32, device=dev) for _ in range(8)]
    del junk


@pytest.mark.cuda
def test_device_prover_honours_the_schedule(cuda_device):
    """schedule="hybp": every launch of the proof, eager and in the FRI
    phase's graph, is hybp's, as many as the plan says; the bytes are the
    default opt proof's."""
    import sys
    from pathlib import Path

    from hades252_tpu_torch import fri, fri_cuda, serialize

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    dev = torch.device("cuda", torch.cuda.current_device())
    cs = _fast_instances(2, 77)
    pk, vk = fri.preprocess_succinct(cs[0], fri.FriParams(**_FAST), fri.default_pcs_perm())
    schema = fri.proof_schema(vk.n, vk.params)
    graph = fri_cuda.fri_phase_graph(2, schema["m0"], schema["n_folds"], "hybp", dev)
    perm_cuda.reset_launches()
    replays = graph.replays
    proofs = fri_cuda.prove_succinct_device_batch(cs, pk, schedule="hybp")
    torch.cuda.synchronize()
    eager, in_graph = chip_smoke.device_proof_launches(vk, [p.pow_nonce for p in proofs])
    assert perm_cuda.launches == {**_NO_LAUNCHES, "hybp": eager}
    assert graph.replays == replays + 1 and graph.held == {**_NO_LAUNCHES, "hybp": in_graph}
    opt = fri_cuda.prove_succinct_device_batch(cs, pk)
    assert [serialize.proof_to_bytes(p, vk) for p in proofs] == \
        [serialize.proof_to_bytes(p, vk) for p in opt]


def test_device_pool_perm_raises_without_a_card():
    """The card's seam never falls back: without a card its default device
    raises; the plain version runs only when the caller asks for the CPU."""
    from hades252_tpu_torch import fri_cuda

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fri_cuda.device_pool_perm()
    with pytest.raises(ValueError, match="unknown schedule"):
        fri_cuda.device_pool_perm("nope", device="cpu")
    states = field.np_random_elements((2, 5), np.random.default_rng(3)).astype(np.uint32)
    perm_cuda.reset_launches()
    got = fri_cuda.device_pool_perm(device="cpu")(states)
    assert perm_cuda.launches == _NO_LAUNCHES
    assert np.array_equal(got, permute(torch.from_numpy(states.astype(np.int32))).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("zk", [False, True])
@pytest.mark.parametrize("b", [1, 4])
def test_device_aggregate_equals_the_native_engine(cuda_device, b, zk):
    """The device aggregate prover on its default device, the card, at the
    "fast" preset: byte-identical to the native engine's
    aggregate.prove_aggregate for the same instances and generator, and
    accepted by the device verifier; only the opt kernel launches."""
    from hades252_tpu_torch import aggregate, fri, fri_cuda, serialize

    cs = _fast_instances(b, 50 + b)
    pk, vk = fri.preprocess_succinct(cs[0], fri.FriParams(**_FAST, zk=zk), fri.default_pcs_perm())
    perm_cuda.reset_launches()
    agg = fri_cuda.prove_aggregate_device(cs, pk, np.random.default_rng(60 + b))
    torch.cuda.synchronize()
    assert perm_cuda.launches["opt"] > 0
    assert all(n == 0 for s, n in perm_cuda.launches.items() if s != "opt")
    host = aggregate.prove_aggregate(cs, pk, fri.default_pcs_perm(), rng=np.random.default_rng(60 + b))
    assert serialize.aggregate_to_bytes(agg, vk) == serialize.aggregate_to_bytes(host, vk)
    assert fri_cuda.verify_aggregate_device(vk, agg, [[g.pi for g in c.gates] for c in cs],
                                            schedule="hybp")


def _spoiled_fast_proofs(zk: bool):
    """Four fast proofs, the second with a changed pruned node (caught in the
    pooled Merkle phase), the fourth with a changed claimed evaluation."""
    from dataclasses import replace

    from hades252_tpu_torch import fri
    from hades252_tpu_torch.params import P

    cs = _fast_instances(4, 90)
    pk, vk = fri.preprocess_succinct(cs[0], fri.FriParams(**_FAST, zk=zk), fri.default_pcs_perm())
    proofs = [fri.prove_succinct(c, pk, fri.default_pcs_perm()) for c in cs]
    nodes = {k: np.array(v, copy=True) for k, v in proofs[1].open_nodes.items()}
    nodes["t"][0, 0] ^= 1
    proofs[1] = replace(proofs[1], open_nodes=nodes)
    proofs[3] = replace(proofs[3], evals={**proofs[3].evals, "a": (proofs[3].evals["a"] + 1) % P})
    return vk, proofs, [[g.pi for g in c.gates] for c in cs]


@pytest.mark.cuda
@pytest.mark.parametrize("zk", [False, True])
def test_device_verifiers_equal_the_host(cuda_device, zk):
    """verify_succinct_device_batch, fused (one graph replay) and not (a
    launch a call), through hybp: the native engine's verdicts, false in the
    two spoiled slots only; the fused phase launches only in its graph."""
    import sys
    from pathlib import Path

    from hades252_tpu_torch import fri, fri_cuda

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    vk, proofs, pis = _spoiled_fast_proofs(zk)
    want = fri.verify_succinct_batched(vk, proofs, pis, fri.default_pcs_perm())
    assert list(want) == [True, False, True, False]
    perm_cuda.reset_launches()
    unfused = fri_cuda.verify_succinct_device_batch(vk, proofs, pis, False, schedule="hybp")
    assert perm_cuda.launches == {**_NO_LAUNCHES, "hybp": chip_smoke.pooled_merkle_launches(vk)}
    fri_cuda.verify_succinct_device_batch(vk, proofs, pis, schedule="hybp")  # captures the graph
    graphs = {g: g.replays for g in _LIVE_GRAPHS}
    perm_cuda.reset_launches()
    fused = fri_cuda.verify_succinct_device_batch(vk, proofs, pis, schedule="hybp")
    torch.cuda.synchronize()
    assert perm_cuda.launches == _NO_LAUNCHES
    (graph,) = [g for g in _LIVE_GRAPHS if g.replays != graphs.get(g, 0)]
    assert graph.replays == graphs[graph] + 1
    assert graph.held == {**_NO_LAUNCHES, "hybp": chip_smoke.pooled_merkle_launches(vk)}
    assert np.array_equal(unfused, want) and np.array_equal(fused, want)
    assert list(fri_cuda.verify_succinct_device_batch(vk, proofs[:1], pis[:1])) == [True]


@pytest.mark.cuda
def test_verifier_graphs_replay_their_eager_bodies(cuda_device):
    """The chain's and the fused pool's graphs: their replays equal the
    eager bodies on the same inputs, tensor for tensor, for two inputs in
    turn; the graph holds the launches its body makes."""
    from hades252_tpu_torch import fri, fri_cuda

    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(5)
    for k, h in ((64, 3), (1000, 7)):
        graph = fri_cuda.chain_graph(k, h, "opt", dev)
        assert graph.held == {**_NO_LAUNCHES, "opt": h}
        for _ in range(2):
            node = _elements((k,), int(rng.integers(1 << 30))).to(dev)
            sibs = _elements((k, h, 3), int(rng.integers(1 << 30))).to(dev)
            poss = torch.from_numpy(rng.integers(0, 4, (k, h))).to(dev)
            got = graph(node, sibs, poss)
            want = merkle.chain_nodes(node, sibs, poss, fri_cuda._node_tag(dev),
                                      fri_cuda._perm_fn("opt"))
            assert torch.equal(got, want)

    vk, proofs, pis = _spoiled_fast_proofs(False)
    plans = []

    def spy(entries):
        plans.append(fri_cuda._fused_verify_plan(entries, vk.params.n_queries))
        return fri.pooled_entries_verify(entries, fri.default_pcs_perm())

    fri.verify_succinct_batched(vk, proofs[:2], pis[:2], entries_check=spy)
    fri.verify_succinct_batched(vk, proofs[2:], pis[2:], entries_check=spy)
    for plan in plans:
        got = fri_cuda._fused_pool_run(plan, "hybp", dev)
        flat, counts = fri_cuda._pool_tensors(plan)
        consts = fri_cuda._fused_pool_consts({b.shape[1] for b in plan[0]}, dev)
        want = fri_cuda._fused_pool_body(*fri_cuda._split(tuple(x.to(dev) for x in flat), counts),
                                         fri_cuda._perm_fn("hybp"), *consts)
        assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_device_chain_fn_equals_the_host_loop(cuda_device):
    from hades252_tpu_torch import fri, fri_cuda

    rng = np.random.default_rng(8)
    leaves = [int(v) for v in rng.integers(0, 1 << 62, 4096)]
    levels = fri.tree_build(leaves, fri.default_pcs_perm())
    idx = sorted(int(i) for i in rng.choice(4096, 100, replace=False))
    sibs, poss = fri.tree_open_batched(levels, idx)
    values = [leaves[i] for i in idx]
    values[7] += 1
    args = (fri.tree_root(levels), values, sibs, poss, len(levels) - 1, idx,
            fri.default_pcs_perm())
    for schedule in ("hybp", "opt"):
        def chain(n, s, p, schedule=schedule):
            return fri_cuda.device_chain_fn(n, s, p, schedule=schedule)

        fri.tree_verify_batched(*args, chain)  # captures the (100, 6) graph
        perm_cuda.reset_launches()
        got = fri.tree_verify_batched(*args, chain)
        assert perm_cuda.launches == _NO_LAUNCHES  # a graph replay, no wrapper
        assert np.array_equal(got, fri.tree_verify_batched(*args))
        assert not got[7] and int(got.sum()) == 99


@pytest.fixture(scope="module")
def nccl_mesh():
    """A world-1 NCCL group in this process (TCP on localhost) and its
    mesh on the card; the group is destroyed after the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import socket

    from hades252_tpu_torch.parallel import multihost

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0, backend="nccl", timeout_s=120)
    try:
        yield multihost.global_mesh()
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 4096])
def test_sharded_tree_over_nccl_equals_merkle_root(nccl_mesh, n):
    from hades252_tpu_torch.parallel import dist

    leaves = _elements((n,), 1300 + n).to(nccl_mesh.device)
    perm_cuda.reset_launches()
    root = dist.merkle_root_sharded(leaves, nccl_mesh)
    assert perm_cuda.launches == {**_NO_LAUNCHES, "opt": merkle.tree_levels(n)}
    assert root.device == nccl_mesh.device and torch.equal(root, merkle.merkle_root(leaves))


@pytest.mark.cuda
def test_prove_batched_over_nccl_equals_the_unsharded_prover(nccl_mesh):
    from hades252_tpu_torch import plonk, prover_cuda

    cs = _fast_instances(2, 13)
    key = plonk.preprocess(cs[0])
    sharded = prover_cuda.prove_batched(cs, key, mesh=nccl_mesh)
    single = prover_cuda.prove_batched(cs, key)
    for a, b in zip(sharded, single, strict=True):
        assert (a.wires, a.z, a.t, a.commitments) == (b.wires, b.z, b.t, b.commitments)


@pytest.mark.cuda
def test_states_count_launches_and_graph_replays(cuda_device):
    """perm_cuda.states counts the states handed to the kernels: a wrapper's
    batch at each launch, a graph's `held_states` at each replay, and
    nothing for the capture, which runs nothing."""
    from hades252_tpu_torch.utils.graphs import CudaGraph

    x = _elements((64, 5), 41).to(cuda_device)
    before = perm_cuda.states["opt"]
    want = perm_cuda.permute_cuda_mont(x, schedule="opt")
    assert perm_cuda.states["opt"] == before + 64
    graph = CudaGraph(lambda s: perm_cuda.permute_cuda_mont(s, schedule="opt"), (x.clone(),))
    assert graph.held == {**_NO_LAUNCHES, "opt": 1}
    assert graph.held_states == {**_NO_LAUNCHES, "opt": 64}
    assert perm_cuda.states["opt"] == before + 2 * 64  # the eager warm-up before the capture
    for k in (1, 2):
        assert torch.equal(graph(x), want)
        assert perm_cuda.states["opt"] == before + (2 + k) * 64


@pytest.mark.cuda
def test_enabled_spans_time_the_card(cuda_device):
    """With metrics enabled each span records CUDA events on the card:
    snapshot() gives device ms beside the calls and host seconds; a span
    inside a capture counts its call there but records no event."""
    from hades252_tpu_torch.utils import metrics
    from hades252_tpu_torch.utils.graphs import CudaGraph

    leaves = _elements((4096,), 43).to(cuda_device)
    x = _elements((64, 5), 44).to(cuda_device)
    metrics.reset()
    metrics.enable()
    try:
        merkle.merkle_root(leaves)
        graph = CudaGraph(lambda s: perm_cuda.permute_cuda_mont(s, schedule="opt"), (x.clone(),))
        graph(x)
        snap = metrics.snapshot()["spans"]
    finally:
        metrics.disable()
        metrics.reset()
    assert snap["merkle.level"]["calls"] == 6 and snap["merkle.convert"]["calls"] == 2
    assert snap["perm.call"]["calls"] == 6 + 2  # the tree's levels, the warm-up and the capture
    assert snap["graph.capture"]["calls"] == snap["graph.replay"]["calls"] == 1
    for name in ("merkle.level", "merkle.convert", "perm.call", "graph.replay"):
        assert snap[name]["device_ms"] > 0 and snap[name]["host_s"] > 0, name


@pytest.mark.cuda
def test_profiled_spans_own_the_kernels_they_launch(cuda_device):
    """Under torch.profiler on the card, hbench/spans.py pairs every device
    operation with its launch: the permutation kernels' time is the
    wrapper's own, the tree's levels hold the wrapper's, and a graph
    replay's kernels belong to its span."""
    from torch.profiler import ProfilerActivity, profile

    from hades252_tpu_torch.utils.graphs import CudaGraph
    from hbench import spans

    leaves = _elements((4096,), 45).to(cuda_device)
    x = _elements((64, 5), 46).to(cuda_device)
    graph = CudaGraph(lambda s: perm_cuda.permute_cuda_mont(s, schedule="opt"), (x.clone(),))
    merkle.merkle_root(leaves)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        merkle.merkle_root(leaves)
        graph(x)
        torch.cuda.synchronize()
    got = spans.attribute(spans.events(prof))
    by = got["by_span"]
    assert got["unlinked_ms"] == 0
    assert by["perm.call"]["self_own_ms"] > 0 and by["perm.call"]["launches"] >= 6
    assert by["merkle.level"]["device_ms"] >= by["perm.call"]["device_ms"]  # replays call no wrapper
    assert by["graph.replay"]["self_own_ms"] > 0 and by["graph.replay"]["launches"] == 1
    assert by["merkle.convert"]["device_ms"] > 0


def _arith_operands(case: str, device) -> tuple:
    """Operand pairs of hades_field_arith on the card, at the callers'
    shapes: a (B, 1, 1, 16) challenge against (1, 4, n, 16) key columns; an
    NTT stage's strided upper half against its (L/2, 16) twiddle row and
    its two halves against each other (B = 2, 4 columns, N = 1024, at the
    first, a middle and the last stage); ragged rows around the kernel's
    32-element warps and 256-element blocks; one element against rows;
    and empty operands. The first rows of each are 0, 1 and p - 1."""
    from hades252_tpu_torch.params import P, int_to_digits

    x, y = _elements((2, 4, 1024), 800).to(device), _elements((2, 4, 1024), 801).to(device)
    edges = torch.from_numpy(np.stack([int_to_digits(v) for v in (0, 1, P - 1)]).astype(np.int32))
    x.view(-1, 16)[:9] = edges.repeat(3, 1).to(device)
    y.view(-1, 16)[:9] = edges.repeat_interleave(3, 0).to(device)
    if case.startswith("stage_"):
        length = int(case.split("_")[-1])
        xr = x.reshape(2, 4, 1024 // length, length, 16)
        tw = y[0, 0, : length // 2]
        return (xr[..., length // 2 :, :], tw) if "twiddle" in case else \
            (xr[..., : length // 2, :], xr[..., length // 2 :, :])
    rows = x.view(-1, 16)
    return {
        "challenge_table": lambda: (y[:, 0, :1][:, None], x[:1]),
        "rows_1": lambda: (rows[:1], y.view(-1, 16)[:1]),
        "rows_33": lambda: (rows[:33], y.view(-1, 16)[5:38]),
        "rows_8191": lambda: (rows[:8191], y.view(-1, 16)[1:8192]),
        "row_element": lambda: (rows, y[1, 2, 3]),
        "empty": lambda: (rows[:0], y.view(-1, 16)[:1]),
    }[case]()


ARITH_CARD_CASES = ["challenge_table", "stage_twiddle_2", "stage_twiddle_64", "stage_twiddle_1024",
                    "stage_halves_2", "stage_halves_64", "stage_halves_1024", "rows_1", "rows_33",
                    "rows_8191", "row_element", "empty"]


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
@pytest.mark.parametrize("case", ARITH_CARD_CASES)
def test_field_arith_kernel_matches_plain(cuda_device, op, case):
    """hades_field_arith against field's torch ops on the card, bit for bit,
    at every shape and layout of `_arith_operands`: one launch a call (none
    for an empty output), its output elements counted, a new contiguous
    int32 tensor of the broadcast shape."""
    name = {"mul": "mont_mul", "add": "add_mod", "sub": "sub_mod"}[op]
    a, b = _arith_operands(case, cuda_device)
    launches, elements = field_cuda.arith_launches[op], field_cuda.arith_elements[op]
    got = getattr(field_cuda, name)(a, b)
    torch.cuda.synchronize()
    n = got.numel() // 16
    assert field_cuda.arith_launches[op] == launches + (1 if n else 0)
    assert field_cuda.arith_elements[op] == elements + n
    assert got.is_contiguous() and got.dtype == torch.int32 and got.device == a.device
    assert got.shape == torch.broadcast_shapes(a.shape, b.shape)
    assert torch.equal(got, getattr(field, name)(a, b))


@pytest.mark.cuda
def test_field_arith_kernel_replays_in_a_graph(cuda_device):
    """The element-wise kernels and the conversion captured in a CudaGraph
    (as the prover's phases are): replays give the eager outputs, each
    launch is held once, and each replay adds the elements the graph holds
    to field_cuda.arith_elements and .converted."""
    from hades252_tpu_torch.utils.graphs import CudaGraph

    x, y = _elements((4, 256), 810).to(cuda_device), _elements((256,), 811).to(cuda_device)

    def body(a, b):
        s = field_cuda.add_mod(a, b)
        prod = field_cuda.mont_mul(field_cuda.sub_mod(s, b), field_cuda.to_mont(s))
        return field_cuda.from_mont(prod)

    want = body(x, y)
    arith, elements = dict(field_cuda.arith_launches), dict(field_cuda.arith_elements)
    conversions, converted = field_cuda.conversions, field_cuda.converted
    graph = CudaGraph(body, (x.clone(), y.clone()))
    held = {"mul": 1, "add": 1, "sub": 1}
    assert graph.held_arith == held and graph.held_conversions == 2
    assert graph.held_arith_elements == {op: 1024 for op in held}
    assert graph.held_converted == 2048
    # the warm-up's and the capture's launches; the warm-up's elements alone
    assert field_cuda.arith_launches == {op: arith[op] + 2 for op in held}
    assert field_cuda.arith_elements == {op: elements[op] + 1024 for op in held}
    assert field_cuda.conversions == conversions + 4 and field_cuda.converted == converted + 2048
    for k in (1, 2):
        assert torch.equal(graph(x, y), want)
        assert field_cuda.arith_elements == {op: elements[op] + (1 + k) * 1024 for op in held}
        assert field_cuda.converted == converted + (1 + k) * 2048
    # a replay calls no wrapper
    assert field_cuda.arith_launches == {op: arith[op] + 2 for op in held}


def _refuse_plain_field_ops_on_the_card(monkeypatch) -> None:
    """field's element-wise ops and conversions raise when handed a CUDA
    tensor, so a device path that still reaches the torch composition
    fails; CPU tensors pass through."""
    for name in ("mont_mul", "add_mod", "sub_mod", "to_mont", "from_mont"):
        plain = getattr(field, name)

        def guard(*args, _plain=plain, _name=name):
            if any(isinstance(x, torch.Tensor) and x.is_cuda for x in args):
                raise AssertionError(f"field.{_name} ran on a CUDA tensor")
            return _plain(*args)

        monkeypatch.setattr(field, name, guard)


@pytest.mark.cuda
def test_prove_batched_takes_no_plain_field_op_on_the_card(cuda_device, monkeypatch):
    """prove_batched at B = 2 with field's ops refusing CUDA tensors: every
    element-wise op and conversion of its phases runs through field_cuda's
    kernels, all of them inside the phases' three graphs (no eager launch:
    a graph captured in the call launched what it holds at its warm-up and
    its capture, and each replay adds exactly the elements it holds), and
    the proofs equal the host prover's byte for byte."""
    from hades252_tpu_torch import plonk, prover_cuda
    from hades252_tpu_torch.utils.graphs import _LIVE_GRAPHS

    cs = _fast_instances(2, 820)
    key = plonk.preprocess(cs[0])
    _refuse_plain_field_ops_on_the_card(monkeypatch)
    replays = {g: g.replays for g in _LIVE_GRAPHS}
    launches, elements = dict(field_cuda.arith_launches), dict(field_cuda.arith_elements)
    proofs = prover_cuda.prove_batched(cs, key)
    torch.cuda.synchronize()
    (group,) = [g for (b, n, _), (_, g) in prover_cuda._PHASE_GRAPHS.items()
                if (b, n) == (2, key.n)]
    assert sorted(phase for phase, _, _ in group) == [0, 1, 2]
    phases = list(group.values())
    assert all(g.replays == replays.get(g, 0) + 1 and g.held_arith["mul"] > 0 for g in phases)
    new = [g for g in phases if g not in replays]
    for op in field_cuda.ARITH_OPS:
        assert field_cuda.arith_launches[op] - launches[op] == sum(2 * g.held_arith[op]
                                                                   for g in new)
        assert field_cuda.arith_elements[op] - elements[op] == (
            sum(g.held_arith_elements[op] for g in phases)
            + sum(g.held_arith_elements[op] for g in new))
    for c, pr in zip(cs, proofs, strict=True):
        host = plonk.prove(c, key)
        assert (pr.wires, pr.z, pr.t, pr.commitments) == (host.wires, host.z, host.t,
                                                          host.commitments)


@pytest.mark.cuda
def test_device_succinct_prover_takes_no_plain_field_op(cuda_device, monkeypatch):
    """prove_succinct_device at the "fast" preset with field's ops refusing
    CUDA tensors: its eager coset transforms, claimed evaluations, DEEP
    composition and folds launch field_cuda's kernels, and the proof equals
    the native engine's byte for byte."""
    from hades252_tpu_torch import fri, fri_cuda, serialize

    (c,) = _fast_instances(1, 821)
    pk, vk = fri.preprocess_succinct(c, fri.FriParams(**_FAST), fri.default_pcs_perm())
    _refuse_plain_field_ops_on_the_card(monkeypatch)
    launches = dict(field_cuda.arith_launches)
    proof = fri_cuda.prove_succinct_device(c, pk, np.random.default_rng(822))
    torch.cuda.synchronize()
    assert all(field_cuda.arith_launches[op] > launches[op] for op in launches)
    host = fri.prove_succinct(c, pk, fri.default_pcs_perm(), rng=np.random.default_rng(822))
    assert serialize.proof_to_bytes(proof, vk) == serialize.proof_to_bytes(host, vk)
