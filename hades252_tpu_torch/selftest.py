"""Known-answer gate for the permutation kernels, run on the real device.

Port of `hades252_tpu/selftest.py`. A batch of known inputs (the four
SURVEY §2.3 vectors and seeded random states) runs through each kernel
schedule, on the canonical path and on the Montgomery path the sponge and
Merkle models use, and every output digit is compared with the exact
Python-int oracle (`ScalarStrategy` on ints), independent of every tensor
backend. The oracle itself is first held against the hard-coded SURVEY
outputs.

On a CUDA device the gate runs the kernels; on the CPU the wrappers run
their plain versions, which is how the CPU tests exercise it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .ops.perm_cuda import SCHEDULES, permute_cuda, permute_cuda_mont
from .params import P, R_MOD_P, WIDTH
from .strategy import ScalarStrategy
from .utils.encoding import ints_to_digits

#: Distinct known-answer states (the 4 SURVEY §2.3 vectors + seeded random).
N_VECTORS = 128

#: The gate's batch on the card: the 128 vectors tiled to 2^14 lanes.
BENCH_LANES = 1 << 14

#: SURVEY §2.3 known answers: input state -> the permuted state.
KATS = {
    (0, 0, 0, 0, 0): (
        0x4448679E00A28DD381089245EFAAB4249E99C5825CEEC146D8AAC63A3C3BBC95,
        0x5089F35C1040B4F2E69EC8477F36E6C9F53AA0337601ED010D42F815C408D2CF,
        0x5996FB9E63398915914EA31A6DA434F33102EA0CFCAE356F07011A82EAD4930C,
        0x5412A3D268D48157E41185620CB5587B6C4C02B86B530A2F1339FC0CFC557689,
        0x739C65CC0ABBDCA8A7CE87EDB2363AC0AAF217903C9B1729E8D9682FA82BF971,
    ),
    (1, 1, 1, 1, 1): (
        0x71A5B8040ED5C21F5900C854F34748E89DFB577514B9BD816E62E1B3E3F039C3,
        0x6A5FF1C447767085E400326CA1CC91306D6EB47C1C02BC6FE92AA34508F22C2B,
        0x2D188D45C00E483864F22F663ECDEB6833A660DBC5A53AB56A20ADA360308A45,
        0x620490481DAA92D41FCA6CE913BA69A769C4F6C705B78F4AEB2ED48020FCD3E5,
        0x4390D7DEC01AFE00E2F7E5148B8070D99021DF24B53D4BFFEC7D42433E4B8CA2,
    ),
    (17, 17, 17, 17, 17): (
        0x4A335A5BE470B8C178E7E78DFD8ABCEDEE607C75AFBFF0491C074BAE3415B320,
        0x04F108127CC563090C4724A4C394334FD38B6B59654E38FAE442351793024684,
        0x4C5A86584CB6661CCE9074CC64D18D56AAF1DC1A0C6C0DAE0319A5AFCD6C1033,
        0x432C2C79D317CC36030483F9B06879DCE6F0B7C5A421555EE32DE0DBB8FB5444,
        0x5E0F4E5BF6FA474CF727CE87DD64E6A4753F60758BB8273E04715A469AB14F91,
    ),
    (0, 1, 2, 3, 4): (
        0x4C78FE2E2CDB6E76B43742B08A782A771258F76F57B5FFE586F2391A0363013A,
        0x24CE8F38F8E02C94B2E0B44EDEE20579D1CB7E0E34EA5889B76AF5531DE48654,
        0x41BD94C473E11F8A1FA63BDA8DB2C872467187EC72668B90FF20DAAD076D2FD9,
        0x5C6ABBEF811655FF079FAB41E11932F1D784F363C4C36C1234C5C0F600E55E43,
        0x02E47CFE251226D450F518946A0ABCF1E7F721C0685A4382CAB9409AEE71FF9A,
    ),
}


@functools.cache
def _vectors() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(inputs, expected, inputs_mont, expected_mont) as (N_VECTORS, 5, 16)
    uint32: the same states from the same seed as the JAX package's
    selftest, with expected outputs from the exact int oracle."""
    rng = np.random.default_rng(0x4B41_5453)  # "KATS"
    states = [list(k) for k in KATS]
    while len(states) < N_VECTORS:
        states.append(
            [int.from_bytes(rng.bytes(40), "little") % P for _ in range(WIDTH)]
        )
    strat = ScalarStrategy()
    expected = [strat.perm(list(s)) for s in states]
    for s, e in zip(states, expected):
        known = KATS.get(tuple(s))
        if known is not None and tuple(e) != known:
            raise RuntimeError(f"int oracle disagrees with the SURVEY KAT for {s}")
    to_mont = lambda ws: [(w * R_MOD_P) % P for w in ws]  # noqa: E731
    return (
        ints_to_digits(states, shape=(N_VECTORS, WIDTH)),
        ints_to_digits(expected, shape=(N_VECTORS, WIDTH)),
        ints_to_digits([to_mont(s) for s in states], shape=(N_VECTORS, WIDTH)),
        ints_to_digits([to_mont(e) for e in expected], shape=(N_VECTORS, WIDTH)),
    )


def _tile(arr: np.ndarray, lanes: int) -> np.ndarray:
    reps = -(-lanes // arr.shape[0])
    return np.tile(arr, (reps, 1, 1))[:lanes]


def verify_device(schedules=SCHEDULES, *, device="cuda", lanes: int | None = None,
                  include_mont: bool = True) -> list[str]:
    """Run the KAT batch through the kernel of each schedule named on
    `device`: the canonical path, and with include_mont the Montgomery path
    the sponge and Merkle models use, for every schedule named (wider than
    the JAX package's gate, which runs the Montgomery path for its default
    schedule only). lanes: the batch, the vectors tiled to it; by default
    BENCH_LANES on a CUDA device and N_VECTORS elsewhere. With no arguments
    it covers all eight schedules on both paths on the card.

    Returns a list of failure descriptions (empty = all bit-exact).
    """
    device = torch.device(device)
    if lanes is None:
        lanes = BENCH_LANES if device.type == "cuda" else N_VECTORS
    inputs, expected, inputs_m, expected_m = (
        _tile(a, lanes).astype(np.int32) for a in _vectors()
    )
    paths = [("convert=True", permute_cuda, inputs, expected)]
    if include_mont:
        paths.append(("convert=False", permute_cuda_mont, inputs_m, expected_m))
    failures: list[str] = []
    for sched in schedules:
        for label, fn, x, want in paths:
            out = fn(torch.from_numpy(x).to(device), schedule=sched).cpu().numpy()
            if not np.array_equal(out, want):
                bad = int(np.argwhere((out != want).any(axis=(1, 2))).reshape(-1)[0])
                failures.append(f"schedule {sched!r} ({label}): lane {bad} mismatch")
    return failures


def assert_device_correct(schedules=SCHEDULES, *, device="cuda", lanes: int | None = None,
                          include_mont: bool = True) -> None:
    """Raise RuntimeError if any schedule's output deviates from the oracle:
    the gate `entry.entry()` and `chip_smoke.py` run before trusting the
    kernels. Arguments as verify_device's."""
    failures = verify_device(schedules, device=device, lanes=lanes, include_mont=include_mont)
    if failures:
        raise RuntimeError(
            "on-device KAT verification FAILED (kernel output != int oracle): "
            + "; ".join(failures)
        )
