"""The product-round schedules of csrc/miller.cu (torchbls.rounds): the
tables the kernel runs, executed here on Python integers with the card's
parallel semantics, against the plain versions. Tolerance: exact equality
of every Fq coefficient (Montgomery form).
"""

from types import SimpleNamespace

import numpy as np
import pytest

from lighthouse_tpu_torch.crypto.bls381.constants import P

# torch and the port's modules load when this file's first test runs, not
# at collection, so a test worker that only runs the JAX package's tests
# never loads torch.
torch = R = TL = TP = TW = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    global torch, R, TL, TP, TW
    import torch
    from lighthouse_tpu_torch.crypto.torchbls import limbs as TL
    from lighthouse_tpu_torch.crypto.torchbls import pairing_ops as TP
    from lighthouse_tpu_torch.crypto.torchbls import rounds as R
    from lighthouse_tpu_torch.crypto.torchbls import tower as TW

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


R_INV = pow(1 << 384, -1, P)


def run(prog, values, slots=None):
    """Execute a rounds.Program on Montgomery-form integers, as
    csrc/rounds.cuh runs it: `values` fill the input slots (or pass `slots`,
    a whole slot array, updated in place); each pass reads every operand
    before it writes any result. Returns the slot array. Raises on a pass
    whose operations collide (one reads or writes a slot another writes)."""
    if slots is None:
        slots = list(values) + [0] * (prog.slots - len(values))
    for p, ops in enumerate(prog.passes):
        writes = [o for _k, o, _a, _b in ops]
        reads = {x for _k, _o, a, b in ops for x in (a, b)}
        if len(set(writes)) != len(writes) or reads.intersection(writes):
            raise AssertionError(f"{prog.name}: pass {p} reads or writes a slot twice")
        res = []
        for kind, _o, a, b in ops:
            x, y = slots[a], slots[b]
            if kind == R.MUL:
                res.append(x * y * R_INV % P)
            elif kind == R.ADD:
                res.append((x + y) % P)
            elif kind == R.SUB:
                res.append((x - y) % P)
            else:
                res.append(x)
        for o, r in zip(writes, res):
            slots[o] = r
    return slots


def miller_pair(xp, yp, xq, yq, one):
    """One pair's Miller value conj(f) through the dbl/add programs, as
    miller.cu's phase 1 runs them: the 12 Fq coefficients (Montgomery form;
    `one` is R mod p)."""
    progs = R.programs()
    state = [xp, yp, xq[0], xq[1], yq[0], yq[1], xq[0], xq[1], yq[0], yq[1], one, 0,
             one] + [0] * 11 + [0]
    slots = state + [0] * (max(progs["dbl"].slots, progs["add"].slots) - len(state))
    for bit in TP.X_BITS:
        run(progs["dbl"], None, slots)
        if bit:
            run(progs["add"], None, slots)
    f = slots[12:24]
    return f[:6] + [(-x) % P for x in f[6:]]


def fq12_mul(a, b):
    """The dense Fq12 product through its program (12 + 12 coefficients)."""
    prog = R.programs()["fq12_mul"]
    slots = run(prog, list(a) + list(b) + [0])
    return [slots[s] for s in prog.out_slots]


def fq_values(rng, n):
    return [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]


def limbs(values, shape):
    return torch.as_tensor(np.stack([TL.pack(v) for v in values]).reshape(shape + (TL.NL,))
                           .astype(np.int64))


def coefficients(t):
    return [TL.unpack(c) for c in t.reshape(-1, TL.NL).numpy()]


def test_miller_schedules_match_the_plain_per_pair_loop():
    """63 doubling and 5 addition programs per pair give conj(f_i) of
    pairing_ops.miller_loop_batch, for two seeded pairs."""
    rng = np.random.default_rng(17)
    xp, yp = fq_values(rng, 2), fq_values(rng, 2)
    xq, yq = fq_values(rng, 4), fq_values(rng, 4)
    want = TP.miller_loop_batch((limbs(xp, (2,)), limbs(yp, (2,))),
                                (limbs(xq, (2, 2)), limbs(yq, (2, 2))), torch.tensor([True, True]))
    for i in range(2):
        got = miller_pair(xp[i], yp[i], tuple(xq[2 * i:2 * i + 2]), tuple(yq[2 * i:2 * i + 2]),
                            TL.R_MONT % P)
        assert got == coefficients(want[i])


def test_fq12_mul_schedule_matches_the_plain_product():
    rng = np.random.default_rng(18)
    a, b = fq_values(rng, 12), fq_values(rng, 12)
    want = TW.fq12_mul(limbs(a, (2, 3, 2)), limbs(b, (2, 3, 2)))
    assert fq12_mul(a, b) == coefficients(want)


@pytest.mark.parametrize("name,products,rounds", [("dbl", 106, 4), ("add", 79, 5),
                                                  ("fq12_mul", 54, 1)])
def test_programs_are_product_rounds_over_a_block(name, products, rounds):
    """Each program does the plain formula's Fq products (Fq12 squaring 36,
    doubling step 31, sparse line product 39; addition step 40; dense
    product 54) in its product depth of rounds, no pass wider than a block
    of 64 threads, in slots that fit the 10-bit fields of an op word."""
    prog = R.programs()[name]
    assert (prog.products, prog.product_rounds) == (products, rounds)
    assert prog.widest() <= 64
    assert prog.slots < 1 << R.SLOT_BITS
    for ops in prog.passes:
        assert len({op[0] == R.MUL for op in ops}) == 1     # a round holds products only


def test_run_refuses_a_pass_with_colliding_slots():
    bad = SimpleNamespace(name="bad", slots=32,
                          passes=[[(R.ADD, 30, 0, 1), (R.MUL, 31, 30, 2)]])  # reads a slot it writes
    with pytest.raises(AssertionError, match="pass 0"):
        run(bad, [1] * 25)


def test_header_carries_every_program():
    text = R.header()
    for name, prog in R.programs().items():
        up = f"MR_{name.upper()}"
        assert f"#define {up}_PASSES {len(prog.passes)}" in text
        assert f"{up}_OPS[{sum(len(ops) for ops in prog.passes)}]" in text
    assert "MR_FQ12_MUL_OUT[12]" in text and "#define MR_SLOT_ZERO 24" in text
    assert R.miller_rounds(65) == 63 * 4 + 5 * 5 + 7
    assert R.miller_rounds(1) == 63 * 4 + 5 * 5
    assert R.miller_products(64, 65) == 64 * (63 * 106 + 5 * 79) + 64 * 54
