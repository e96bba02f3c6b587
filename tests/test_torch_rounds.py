"""The product-round schedules of csrc/miller.cu, csrc/hard_part.cu and
csrc/easy_part.cu (torchbls.rounds): the tables the kernels run, executed
here on Python integers with the card's parallel semantics, against the
plain versions.
Tolerance: exact equality of every Fq coefficient (Montgomery form).
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


def form_terms(prog, f):
    """Form f of a rounds.FormProgram: its (slot, coefficient) terms."""
    out = []
    for s, c, last in prog.terms[prog.forms[f]:]:
        out.append((s, c))
        if last:
            return out


def run(prog, values, slots=None):
    """Execute a rounds.Program or FormProgram on Montgomery-form integers,
    as csrc/rounds.cuh runs it: `values` fill the input slots (or pass
    `slots`, a whole slot array, updated in place); each pass reads every
    operand (a slot, or a form: the sum of its terms mod p) before it
    writes any result. Returns the slot array. Raises on a pass whose
    operations collide (one reads or writes a slot another writes)."""
    if slots is None:
        slots = list(values) + [0] * (prog.slots - len(values))
    forms = isinstance(prog, R.FormProgram)

    def operand(x):
        if forms:
            return sum(c * slots[s] for s, c in form_terms(prog, x)) % P
        return slots[x]

    for p, ops in enumerate(prog.passes):
        writes = [o for _k, o, _a, _b in ops]
        reads = {x for _k, _o, a, b in ops for x in (a, b)}
        if forms:
            reads = {s for f in reads for s, _c in form_terms(prog, f)}
        if len(set(writes)) != len(writes) or reads.intersection(writes):
            raise AssertionError(f"{prog.name}: pass {p} reads or writes a slot twice")
        res = []
        for kind, _o, a, b in ops:
            x, y = operand(a), operand(b)
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


def hard_state(t):
    """hard_part.cu's state for an easy-part output t: t in the areas t, b
    and a0, the Frobenius coefficient blocks, zero elsewhere."""
    area = {name: [0] * 12 for name in R.HARD_AREAS}
    area["t"] = area["b"] = area["a0"] = list(t)
    for k in (1, 2):
        area[f"frob{k}"] = [TL.unpack(c) for c in TW.FROB12_COEFF[k].reshape(12, TL.NL)]
    return [x for name in R.HARD_AREAS for x in area[name]]


def area_of(slots, name):
    k = 12 * R.HARD_AREAS.index(name)
    return slots[k:k + 12]


@pytest.mark.parametrize("name", ["sqr0", "sqr1", "mul0", "mul1"])
def test_hard_step_programs_match_the_plain_versions(name):
    """The cyclotomic squaring and the product by the base, from one
    accumulator area into the other, on seeded random Fq12 off the
    cyclotomic subgroup (where only Granger-Scott's own wiring gives
    tower.fq12_cyclotomic_sqr's values): equal to the plain squaring or
    tower.fq12_mul, and no other area of the state changes."""
    rng = np.random.default_rng(19)
    state = fq_values(rng, len(R.HARD_STATE))
    src, dst = f"a{name[-1]}", f"a{1 - int(name[-1])}"
    a, b = limbs(area_of(state, src), (2, 3, 2)), limbs(area_of(state, "b"), (2, 3, 2))
    want = TW.fq12_cyclotomic_sqr(a) if name.startswith("sqr") else TW.fq12_mul(a, b)
    slots = run(R.hard_programs()[name], state)
    assert area_of(slots, dst) == coefficients(want)
    for other in R.HARD_AREAS:
        if other != dst:
            assert area_of(slots, other) == area_of(state, other)


def test_hard_part_sequence_matches_the_plain_hard_part():
    """Every program of rounds.hard_sequence, in the order hard_part.cu runs
    them, on the easy-part output of a seeded Fq12 and on t = 1: the result
    (area a1) equals pairing_ops.final_exp_hard_part. Slots no program has
    written yet hold junk, so a read before a write would show."""
    rng = np.random.default_rng(20)
    t = TP.final_exp_easy_part(limbs(fq_values(rng, 12), (2, 3, 2)))
    one = TL.R_MONT % P
    progs = R.hard_programs()
    size = max(p.slots for p in progs.values())
    assert len(R.hard_sequence()) == 5 * (len(TP.X_BITS) + sum(TP.X_BITS)) + 5
    for value, want in ((coefficients(t), coefficients(TP.final_exp_hard_part(t))),
                        ([one] + [0] * 11, [one] + [0] * 11)):
        slots = hard_state(value)
        slots += [12345] * (size - len(slots))
        for name in R.hard_sequence():
            run(progs[name], None, slots)
        assert area_of(slots, "a1") == want


def easy_part(m):
    """easy_part.cu's sequence on the 12 Fq coefficients of m: the state
    (m, the p^2-Frobenius coefficients, junk elsewhere, so a read before a
    write would show), EP_NORM, the norm's inverse (one thread's fp_inv:
    x^-1 R^2 in Montgomery form, 0 for 0), EP_UP; returns the out area."""
    progs, st = R.easy_programs(), R.EASY_STATE
    slots = [12345] * max(p.slots for p in progs.values())
    slots[st.index("m_0"):st.index("m_0") + 12] = m
    frob = [TL.unpack(c) for c in TW.FROB12_COEFF[2].reshape(12, TL.NL)]
    slots[st.index("frob2_0"):st.index("frob2_0") + 12] = frob
    run(progs["norm"], None, slots)
    slots[st.index("ninv")] = pow(slots[st.index("norm")], P - 2, P) * pow(1 << 384, 2, P) % P
    run(progs["up"], None, slots)
    return slots[st.index("out_0"):st.index("out_0") + 12]


@pytest.mark.parametrize("case", ["seeded", "zero_w_half", "zero_first_half", "one"])
def test_easy_part_programs_match_the_plain_easy_part(case):
    """The norm program, the inversion and the way back up, as
    easy_part.cu runs them, on a seeded Fq12, on ones with a zero Fq6 half
    and on 1: equal to pairing_ops.final_exp_easy_part."""
    rng = np.random.default_rng(22)
    m = fq_values(rng, 12)
    if case == "zero_w_half":
        m[6:] = [0] * 6
    elif case == "zero_first_half":
        m[:6] = [0] * 6
    elif case == "one":
        m = [TL.R_MONT % P] + [0] * 11
    want = TP.final_exp_easy_part(limbs(m, (2, 3, 2)))
    assert easy_part(m) == coefficients(want)


def test_form_programs_cut_the_linear_passes():
    """Traced as a slot program (two-operand linear passes and a COPY pass
    into the state, as the Miller programs are), the squaring takes 11
    passes and the product by the base 13; as form programs both take 2,
    with the same products in the same round."""
    for name, formula, passes in (("sqr0", lambda a, _b: R.f12_cyclotomic_sqr(a), 11),
                                  ("mul0", R.f12_mul, 13)):
        t = R.Tracer()
        ins = [t.input(f"x{k}") for k in range(24)]
        slot = R.Program(name, t, ins, R._flat(formula(R._f12(ins[:12]), R._f12(ins[12:]))),
                         in_place=ins[:12])
        form = R.hard_programs()[name]
        assert (slot.products, slot.product_rounds) == (form.products, form.product_rounds)
        assert (len(slot.passes), len(form.passes)) == (passes, 2)


def test_form_reduction_quotient_is_at_most_one_short():
    """rounds.cuh's form_load reduces v in [0, FORM_BOUND p) with
    q = floor((v >> 330) FORM_RECIP / 2^64): q is floor(v / p) or one
    less, so one conditional subtraction of p finishes it."""
    rng = np.random.default_rng(21)
    top = R.FORM_BOUND * P
    vs = [k * P + d for k in (0, 1, 2, 3, 511, 1022, 1023) for d in (-1, 0, 1, P // 2, P - 1)]
    vs += [int.from_bytes(rng.bytes(49), "little") % top for _ in range(2000)]
    for v in (v for v in vs if 0 <= v < top):
        q = ((v >> 330) * R.FORM_RECIP) >> 64
        assert v // P - 1 <= q <= v // P


@pytest.mark.parametrize("name,products,rounds", [("dbl", 106, 4), ("add", 79, 5),
                                                  ("fq12_mul", 54, 1), ("sqr0", 18, 1),
                                                  ("sqr1", 18, 1), ("mul0", 54, 1),
                                                  ("mul1", 54, 1), ("easy_norm", 62, 4),
                                                  ("easy_up", 165, 6)])
def test_programs_are_product_rounds_over_a_block(name, products, rounds):
    """Each program does the plain formula's Fq products (Fq12 squaring 36,
    doubling step 31, sparse line product 39; addition step 40; dense
    product 54; the hard part's cyclotomic squaring 18 and product by the
    base 54; the easy part's norm chain 62, down through two Fq6 squares,
    the adjugate and T's norm, and its way back up 165, up through T^-1,
    t^-1, m^-1, two dense products and a p^2-Frobenius) in its product
    depth of rounds, no pass wider than a block of 64 threads, in slots
    that fit the 10-bit fields of an op word."""
    easy = {f"easy_{k}": p for k, p in R.easy_programs().items()}
    prog = {**R.programs(), **R.hard_programs(), **easy}[name]
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
    assert R.miller_passes(65) == 63 * 37 + 5 * 31 + 7 * 12
    hard = R.hard_programs()
    assert f"HP_PROG_NPASSES[{len(hard)}]" in text
    assert f"HP_SEQ[{len(R.hard_sequence())}]" in text
    assert f"HP_OPS[{sum(len(ops) for p in hard.values() for ops in p.passes)}]" in text
    assert f"HP_FORMS[{sum(len(p.forms) for p in hard.values())}]" in text
    assert f"HP_TERMS[{sum(len(p.terms) for p in hard.values())}]" in text
    assert "#define HP_OUT 36" in text and f"RND_FORM_RECIP 0x{R.FORM_RECIP:016x}ull" in text
    easy = R.easy_programs()
    assert f"EP_PROG_NPASSES[{len(easy)}]" in text and "#define EP_UP 1" in text
    assert f"EP_TERMS[{sum(len(p.terms) for p in easy.values())}]" in text
    for area in ("M", "FROB2", "NORM", "NINV", "OUT"):
        assert f"#define EP_SLOT_{area} " in text
    assert R.easy_work() == {"kernel_fq_products": 62 + 165, "product_rounds": 4 + 6,
                             "passes": 5 + 7}
    # five chains of 68 one-round, two-pass steps; the links 7 rounds, 12
    # passes, seven dense products, t^2 (36), frob(y1, 1) (13: the
    # coefficient 1 dropped, one in Fq, one in u Fq) and frob(y2, 2) (10:
    # all in Fq)
    assert R.hard_work() == {"kernel_fq_products": 5 * (63 * 18 + 5 * 54) + 7 * 54 + 36 + 13 + 10,
                             "product_rounds": 5 * 68 + 7, "passes": 5 * 68 * 2 + 12}
