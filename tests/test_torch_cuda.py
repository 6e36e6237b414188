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
from hades252_tpu_torch.ops import make_perm_mont_fn, perm_cuda, permute
from hades252_tpu_torch.strategy import ScalarStrategy
from hades252_tpu_torch.utils import checkpoint


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
    selftest.assert_device_correct(cuda_device)


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
