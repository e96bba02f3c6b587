"""Product-round schedules: Fq12 arithmetic spread over the threads of a block.

A schedule is straight-line Fq code, traced once from the tower formulas
below and cut into passes that csrc/rounds.cuh runs with one operation per
thread and a block barrier after each pass. Every product of product-depth
k (products on its longest input path) sits in *round* k, a pass of
independent Montgomery products, so the rounds a program takes are its
product depth; a dependent chain of rounds is the latency floor of the
design. There are two kinds of schedule:

- `Program` (the Miller loop of csrc/miller.cu: the doubling and addition
  steps with their Fq12 squaring and sparse line product, and the dense
  Fq12 product of its tree): the sums, differences and copies between the
  rounds are *linear passes* of two-operand ops (x xi, x 3, x 8 and
  negation are sums and differences too), and a final COPY pass writes an
  in-place program's outputs into its state;
- `FormProgram` (the final exponentiation's hard part, csrc/hard_part.cu:
  the Granger-Scott cyclotomic squaring, the product by the chain's base,
  and the link programs between the five |x|-exponentiations; its easy
  part, csrc/easy_part.cu: the Fq12 inversion's norm chain down to Fq and
  the way back up, around one thread's Fq inversion): every
  operand is a *form*, a short sum of slots with small integer
  coefficients that the reading thread evaluates itself, so a program is
  its rounds of products of two forms and one pass that writes each output
  form into its state slot: two passes for a squaring or a product, where
  linear passes take 11 and 13.

Operands live in shared-memory slots; `header()` emits each program as a
table of 32-bit operation words (kind, out, a, b: 2 + 3 x 10 bits; in a
form program a and b index its table of forms) into the generated header
round_programs.cuh. tests/test_torch_rounds.py executes the same tables on
Python integers, pass by pass with the parallel semantics of the card
(every operand read before any result of the pass is written), against the
plain versions, and refuses a pass in which one operation reads or writes a
slot another one writes.

All results are exact mod p and fully reduced, so any formula for the same
polynomial gives the plain versions' bits; the point formulas and line
scaling of pairing_ops and the Granger-Scott squaring (which equals a^2
only in the cyclotomic subgroup) are followed term for term.
"""

from __future__ import annotations

import functools

from ..bls381.constants import P
from . import limbs as lb
from . import tower as tw
from .pairing_ops import X_BITS

MUL, ADD, SUB, COPY = 0, 1, 2, 3       # csrc/rounds.cuh's RND_* kinds
SLOT_BITS = 10
# a term of a form: slot | TERM_LAST on a form's last term | coefficient << 16
# (int16); rounds.cuh's form_load reduces sums below FORM_BOUND * p
TERM_LAST = 1 << 15
FORM_BOUND = 1 << 10
# its quotient estimate: floor(v / p) is floor((v >> 330) FORM_RECIP / 2^64)
# or one more, for v < FORM_BOUND p
FORM_RECIP = (1 << 64) // ((P >> 330) + 1)


# ------------------------------------------------------------ tracing


class Tracer:
    """Records Fq operations as nodes; identical operations are one node."""

    def __init__(self):
        self.kind: list = []      # "in" or MUL / ADD / SUB
        self.args: list = []      # (a, b) node ids; the name for an input
        self._memo: dict = {}

    def input(self, name: str) -> "Fq":
        self.kind.append("in")
        self.args.append(name)
        return Fq(self, len(self.kind) - 1)

    def op(self, kind: int, a: int, b: int) -> "Fq":
        if kind in (MUL, ADD) and a > b:
            a, b = b, a
        key = (kind, a, b)
        hit = self._memo.get(key)
        if hit is None:
            self.kind.append(kind)
            self.args.append((a, b))
            hit = self._memo[key] = len(self.kind) - 1
        return Fq(self, hit)


class Fq:
    __slots__ = ("t", "i")

    def __init__(self, t: Tracer, i: int):
        self.t, self.i = t, i

    def __add__(self, o):
        return self.t.op(ADD, self.i, o.i)

    def __sub__(self, o):
        return self.t.op(SUB, self.i, o.i)

    def __mul__(self, o):
        return self.t.op(MUL, self.i, o.i)


# Fq2 = (re, im), Fq6 = three Fq2, Fq12 = two Fq6: the tower of tower.cuh,
# flattened in the (2, 3, 2) order of the interchange layout.


def f2_add(a, b):
    return (a[0] + b[0], a[1] + b[1])


def f2_sub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def f2_neg(a, zero):
    return (zero - a[0], zero - a[1])


def f2_dbl(a):
    return f2_add(a, a)


def f2_mul3(a):
    return f2_add(f2_dbl(a), a)


def f2_mul8(a):
    return f2_dbl(f2_dbl(f2_dbl(a)))


def f2_mul_by_xi(a):
    """(a0 + a1 u)(1 + u) = (a0 - a1) + (a0 + a1) u"""
    return (a[0] - a[1], a[0] + a[1])


def f2_mul(a, b):
    """Karatsuba: 3 products"""
    t0, t1 = a[0] * b[0], a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return (t0 - t1, t2 - t0 - t1)


def f2_sqr(a):
    """(a0 + a1)(a0 - a1) + 2 a0 a1 u: 2 products"""
    c1 = a[0] * a[1]
    return ((a[0] + a[1]) * (a[0] - a[1]), c1 + c1)


def f2_mul_fp(a, k):
    return (a[0] * k, a[1] * k)


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_mul_by_v(a):
    return (f2_mul_by_xi(a[2]), a[0], a[1])


def f6_mul(a, b):
    """Karatsuba over Fq2: 6 Fq2 products, 18 Fq products"""
    t0, t1, t2 = f2_mul(a[0], b[0]), f2_mul(a[1], b[1]), f2_mul(a[2], b[2])
    c0 = f2_mul(f2_add(a[1], a[2]), f2_add(b[1], b[2]))
    c0 = f2_add(f2_mul_by_xi(f2_sub(f2_sub(c0, t1), t2)), t0)
    c1 = f2_mul(f2_add(a[0], a[1]), f2_add(b[0], b[1]))
    c1 = f2_add(f2_sub(f2_sub(c1, t0), t1), f2_mul_by_xi(t2))
    c2 = f2_mul(f2_add(a[0], a[2]), f2_add(b[0], b[2]))
    c2 = f2_add(f2_sub(f2_sub(c2, t0), t2), t1)
    return (c0, c1, c2)


def f12_mul(a, b):
    """Karatsuba over Fq6: 3 Fq6 products, 54 Fq products"""
    t0, t1 = f6_mul(a[0], b[0]), f6_mul(a[1], b[1])
    c1 = f6_sub(f6_sub(f6_mul(f6_add(a[0], a[1]), f6_add(b[0], b[1])), t0), t1)
    return (f6_add(t0, f6_mul_by_v(t1)), c1)


def f12_sqr(a):
    """complex squaring: t = a0 a1, s = (a0 + a1)(a0 + v a1); c0 = s - t - v t,
    c1 = 2t; 36 Fq products"""
    t = f6_mul(a[0], a[1])
    s = f6_mul(f6_add(a[0], a[1]), f6_add(a[0], f6_mul_by_v(a[1])))
    return (f6_sub(f6_sub(s, t), f6_mul_by_v(t)), f6_add(t, t))


def f12_mul_by_014(a, l0, l1, l2):
    """a (l0 + l1 v + l2 v w): tower.fq12_mul_by_014's 13 Fq2 products"""
    (f0, f1, f2), (g0, g1, g2) = a
    l01, l12 = f2_add(l0, l1), f2_add(l1, l2)
    c0, c1, c2 = f2_add(f0, g0), f2_add(f1, g1), f2_add(f2, g2)
    p1, p2 = f2_mul(f0, l0), f2_mul(f1, l1)
    p3 = f2_mul(f2_add(f0, f1), l01)
    p4, p5 = f2_mul(f2, l0), f2_mul(f2, l1)
    q1, q2, q3 = f2_mul(g0, l2), f2_mul(g1, l2), f2_mul(g2, l2)
    r1, r2 = f2_mul(c0, l0), f2_mul(c1, l12)
    r3 = f2_mul(f2_add(c0, c1), f2_add(l0, l12))
    r4, r5 = f2_mul(c2, l0), f2_mul(c2, l12)
    t00 = f2_add(p1, f2_mul_by_xi(p5))
    t01 = f2_sub(f2_sub(p3, p1), p2)
    t02 = f2_add(p2, p4)
    t10 = f2_mul_by_xi(q3)
    t20 = f2_add(r1, f2_mul_by_xi(r5))
    t21 = f2_sub(f2_sub(r3, r1), r2)
    t22 = f2_add(r2, r4)
    out0 = (f2_add(t00, f2_mul_by_xi(q2)), f2_add(t01, t10), f2_add(t02, q1))
    out1 = (f2_sub(f2_sub(t20, t00), t10), f2_sub(f2_sub(t21, t01), q1),
            f2_sub(f2_sub(t22, t02), q2))
    return (out0, out1)


def f12_conj(a, zero):
    return (a[0], tuple(f2_neg(x, zero) for x in a[1]))


def f12_cyclotomic_sqr(a):
    """tower.fq12_cyclotomic_sqr term for term (a change there is repeated
    here): Fq4 squarings of the pairs (g0, g4), (g3, g2), (g1, g5); the
    real half 3 c0 - 2 (g0, g1, g2), the w-half 3 (xi cC1, cA1, cB1) +
    2 (g3, g4, g5). 18 Fq products."""
    (g0, g1, g2), (g3, g4, g5) = a
    pairs = ((g0, g4), (g3, g2), (g1, g5))
    t0 = [f2_sqr(x) for x, _y in pairs]
    t1 = [f2_sqr(y) for _x, y in pairs]
    ts = [f2_sqr(f2_add(x, y)) for x, y in pairs]
    r0 = [f2_add(x, f2_mul_by_xi(y)) for x, y in zip(t0, t1)]
    r1 = [f2_sub(f2_sub(s, x), y) for s, x, y in zip(ts, t0, t1)]
    lo = tuple(f2_add(r, f2_dbl(f2_sub(r, g))) for r, g in zip(r0, (g0, g1, g2)))
    hi_t = (f2_mul_by_xi(r1[2]), r1[0], r1[1])
    hi = tuple(f2_add(h, f2_dbl(f2_add(h, g))) for h, g in zip(hi_t, (g3, g4, g5)))
    return (lo, hi)


def f12_frobenius(a, power, coeff, values, zero):
    """tower.fq12_frobenius: for odd powers conjugate every Fq2 component,
    then multiply component (h, j) by the coefficient block `coeff` (its 12
    Fq inputs; `values`, their Montgomery-form integers). A product by the
    coefficient 1 is dropped and one by a coefficient in Fq or in u Fq
    takes two products: the same values as the Fq2 product."""
    one = lb.R_MONT % P
    out = []
    for h in range(2):
        row = []
        for j in range(3):
            x = a[h][j] if power % 2 == 0 else (a[h][j][0], zero - a[h][j][1])
            k = 6 * h + 2 * j
            c = _f2(coeff, k)
            if (values[k], values[k + 1]) == (one, 0):
                row.append(x)
            elif values[k + 1] == 0:
                row.append(f2_mul_fp(x, c[0]))
            elif values[k] == 0:            # (x0 + x1 u) c1 u = -x1 c1 + x0 c1 u
                row.append((zero - x[1] * c[1], x[0] * c[1]))
            else:
                row.append(f2_mul(x, c))
        out.append(tuple(row))
    return tuple(out)


def dbl_step(r, xp, yp, zero):
    """pairing_ops._dbl_step term for term (a change there is repeated
    here): Jacobian doubling of R and the tangent line at P, scaled by
    2 Y Z^3."""
    X, Y, Z = r
    A, B = f2_sqr(X), f2_sqr(Y)
    C = f2_sqr(B)
    D = f2_dbl(f2_sub(f2_sub(f2_sqr(f2_add(X, B)), A), C))
    E = f2_mul3(A)
    X3 = f2_sub(f2_sqr(E), f2_dbl(D))
    Y3 = f2_sub(f2_mul(E, f2_sub(D, X3)), f2_mul8(C))
    ZZ = f2_sqr(Z)
    Z3 = f2_dbl(f2_mul(Y, Z))
    l0 = f2_sub(f2_mul(E, X), f2_dbl(B))
    l1 = f2_mul_fp(f2_neg(f2_mul(E, ZZ), zero), xp)
    l2 = f2_mul_fp(f2_mul(Z3, ZZ), yp)
    return (X3, Y3, Z3), (l0, l1, l2)


def add_step(r, xq, yq, xp, yp, zero):
    """pairing_ops._add_step term for term (a change there is repeated
    here): mixed addition R + Q and the line through R, Q at P, scaled by
    Z3 = Z1 H."""
    X1, Y1, Z1 = r
    Z1Z1 = f2_sqr(Z1)
    U2 = f2_mul(xq, Z1Z1)
    S2 = f2_mul(f2_mul(yq, Z1), Z1Z1)
    H, R = f2_sub(U2, X1), f2_sub(S2, Y1)
    HH = f2_sqr(H)
    HHH = f2_mul(H, HH)
    V = f2_mul(X1, HH)
    X3 = f2_sub(f2_sub(f2_sqr(R), HHH), f2_dbl(V))
    Y3 = f2_sub(f2_mul(R, f2_sub(V, X3)), f2_mul(Y1, HHH))
    Z3 = f2_mul(Z1, H)
    l0 = f2_sub(f2_mul(R, xq), f2_mul(yq, Z3))
    l1 = f2_mul_fp(f2_neg(R, zero), xp)
    l2 = f2_mul_fp(Z3, yp)
    return (X3, Y3, Z3), (l0, l1, l2)


def _flat(x) -> list:
    if isinstance(x, Fq):
        return [x]
    return [e for y in x for e in _flat(y)]


def _f2(v, i):
    return (v[i], v[i + 1])


def _f12(v):
    return tuple(tuple(_f2(v, 6 * h + 2 * j) for j in range(3)) for h in range(2))


# ------------------------------------------------------------ scheduling


def _assign_slots(name, by_pass, last_use, slot, first) -> int:
    """Temporaries by liveness: each node of by_pass[p] gets a slot from
    `first` on (into `slot`), reusing one whose last reader was pass p - 1
    or earlier. Returns the slot count."""
    free: list = []
    nxt = first
    releases: dict = {}
    for n in sorted(n for nodes in by_pass for n in nodes):
        releases.setdefault(last_use[n], []).append(n)
    for p, nodes in enumerate(by_pass):
        for n in releases.get(p - 1, []):
            free.append(slot[n])
        for n in nodes:
            if free:
                slot[n] = free.pop()
            else:
                slot[n] = nxt
                nxt += 1
    if nxt >= 1 << SLOT_BITS:
        raise ValueError(f"{name}: {nxt} slots do not fit {SLOT_BITS} bits")
    return nxt


class _Schedule:
    passes: list

    @property
    def products(self) -> int:
        return sum(1 for ops in self.passes for op in ops if op[0] == MUL)

    @property
    def product_rounds(self) -> int:
        return sum(1 for ops in self.passes if any(op[0] == MUL for op in ops))

    def widest(self) -> int:
        return max(len(ops) for ops in self.passes)


class Program(_Schedule):
    """A schedule over slots: `inputs` name the first slots in order, ops are
    (kind, out, a, b) slot tuples grouped into passes, `out_slots[k]` holds
    the k-th output after the last pass (with `in_place`, a final COPY pass
    writes output k into input slot `in_place[k]`)."""

    def __init__(self, name, tracer, inputs, outputs, in_place=None):
        self.name = name
        kind, args = tracer.kind, tracer.args
        slot_of_input = {x.i: k for k, x in enumerate(inputs)}
        outs = [x.i for x in outputs]
        # live nodes, and each one's product depth and pass
        live, stack = set(), list(outs)
        while stack:
            n = stack.pop()
            if n in live:
                continue
            live.add(n)
            if kind[n] != "in":
                stack.extend(args[n])
            elif n not in slot_of_input:
                raise ValueError(f"{name}: input {args[n]} is not in the layout")
        order = sorted(n for n in live if kind[n] != "in")   # topological: ids grow
        mdepth, ldepth = {}, {}
        for n in live:
            if kind[n] == "in":
                mdepth[n], ldepth[n] = 0, 0
        for n in order:
            a, b = args[n]
            if kind[n] == MUL:
                mdepth[n], ldepth[n] = 1 + max(mdepth[a], mdepth[b]), 0
            else:
                md = max(mdepth[a], mdepth[b])
                ld = [ldepth[x] for x in (a, b) if mdepth[x] == md and kind[x] not in ("in", MUL)]
                mdepth[n], ldepth[n] = md, 1 + max(ld, default=0)
        depth = max(mdepth[n] for n in live)
        # pass order: linear passes of depth 0, then per depth k the product
        # round k and the linear passes of depth k
        keys = []
        for k in range(depth + 1):
            if k:
                keys.append((k, 0))
            keys += [(k, l) for l in range(1, 1 + max([ldepth[n] for n in order
                                                         if mdepth[n] == k and kind[n] != MUL],
                                                        default=0))]
        index = {key: p for p, key in enumerate(keys)}
        pass_of = {n: index[(mdepth[n], ldepth[n])] for n in order}
        # slots: the inputs first, then temporaries by liveness (a slot last
        # read in pass p is reused from pass p + 1 on)
        n_passes = len(keys) + (1 if in_place else 0)
        last_use = {n: -1 for n in order}
        for n in order:
            for x in args[n]:
                if x in last_use:
                    last_use[x] = max(last_use[x], pass_of[n])
        for n in outs:
            if n in last_use:
                last_use[n] = n_passes      # read by the copy pass or after the program
        slot = dict(slot_of_input)
        by_pass = [[n for n in order if pass_of[n] == p] for p in range(len(keys))]
        self.slots = _assign_slots(name, by_pass, last_use, slot, len(inputs))
        self.passes = [[(kind[n], slot[n], slot[args[n][0]], slot[args[n][1]]) for n in nodes]
                       for nodes in by_pass]
        if in_place:
            targets = [slot_of_input[x.i] for x in in_place]
            if any(kind[n] == "in" for n in outs):
                raise ValueError(f"{name}: an output is an input")
            self.passes.append([(COPY, t, slot[n], slot[n]) for t, n in zip(targets, outs)])
            self.out_slots = targets
        else:
            self.out_slots = [slot[n] for n in outs]


class FormProgram(_Schedule):
    """A schedule whose operands are forms: `inputs` name the first slots in
    order (an input named "zero" is the empty form, and takes no slot);
    `outputs` are (target slot, node) pairs. Every node is a form, a sum
    sum_i c_i x_i with integer c_i over *basis* nodes x_i (inputs and
    products); products with the same two forms are one. Pass k < D holds
    the products of depth k + 1 as (MUL, out, a, b), a and b the indexes of
    their operand forms; pass D writes each output as (COPY, target, f, f),
    f its form's index. Form i is the terms of `terms` from `forms[i]` up to
    the one marked last; a term is (slot, coefficient, last)."""

    def __init__(self, name, tracer, inputs, outputs):
        self.name = name
        kind, args = tracer.kind, tracer.args
        slot_of_input = {x.i: k for k, x in enumerate(inputs)}
        form, operands, depth, mul_of = {}, {}, {}, {}
        for n in range(1 + max(x.i for _t, x in outputs)):
            if kind[n] == "in":
                if args[n] == "zero":
                    form[n] = {}
                elif n in slot_of_input:
                    form[n], depth[n] = {n: 1}, 0
                continue
            fa, fb = (form.get(x) for x in args[n])
            if fa is None or fb is None:
                continue            # reads an input that is not in the layout
            if kind[n] != MUL:
                f = dict(fa)
                for x, c in fb.items():
                    f[x] = f.get(x, 0) + (c if kind[n] == ADD else -c)
                form[n] = {x: c for x, c in f.items() if c}
            elif fa and fb:
                key = tuple(sorted(tuple(sorted(f.items())) for f in (fa, fb)))
                m = mul_of.setdefault(key, n)
                if m == n:
                    operands[n] = (fa, fb)
                    depth[n] = 1 + max(depth[x] for f in (fa, fb) for x in f)
                form[n] = {m: 1}
            else:
                form[n] = {}        # a product by zero
        outs = [(target, form.get(x.i)) for target, x in outputs]
        if any(not f for _t, f in outs):
            raise ValueError(f"{name}: an output is zero or reads an input not in the layout")
        # the products the outputs need, by round; the last pass reads them
        live, stack = set(), [x for _t, f in outs for x in f]
        while stack:
            x = stack.pop()
            if x not in live:
                live.add(x)
                stack.extend(y for f in operands.get(x, ()) for y in f)
        muls = sorted(x for x in live if kind[x] == MUL)
        rounds = max((depth[x] for x in muls), default=0)
        last_use = {x: -1 for x in muls}
        for u in muls:
            for y in {y for f in operands[u] for y in f}.intersection(last_use):
                last_use[y] = max(last_use[y], depth[u] - 1)
        for y in {y for _t, f in outs for y in f}.intersection(last_use):
            last_use[y] = rounds
        slot = dict(slot_of_input)
        by_pass = [[x for x in muls if depth[x] == k + 1] for k in range(rounds)]
        self.slots = _assign_slots(name, by_pass, last_use, slot, len(inputs))
        self.terms: list = []
        self.forms: list = []
        index: dict = {}

        def encode(f) -> int:
            items = tuple(sorted((slot[x], c) for x, c in f.items()))
            if items not in index:
                if sum(abs(c) for _s, c in items) >= FORM_BOUND:
                    raise ValueError(f"{name}: a form's coefficients reach {FORM_BOUND}")
                index[items] = len(self.forms)
                self.forms.append(len(self.terms))
                self.terms += [(s, c, k == len(items) - 1) for k, (s, c) in enumerate(items)]
            return index[items]

        self.passes = [[(MUL, slot[x], encode(operands[x][0]), encode(operands[x][1]))
                        for x in nodes] for nodes in by_pass]
        self.passes.append([(COPY, t, encode(f), encode(f)) for t, f in outs])
        self.out_slots = [t for t, _f in outs]
        read = {s for _t, f in outs for s in (slot[x] for x in f)}
        if read.intersection(self.out_slots) or len(set(self.out_slots)) != len(outs):
            raise ValueError(f"{name}: the last pass reads or writes a target twice")
        if len(self.forms) > 1 << SLOT_BITS:
            raise ValueError(f"{name}: {len(self.forms)} forms do not fit {SLOT_BITS} bits")


MILLER_STATE = (["xp", "yp", "xq0", "xq1", "yq0", "yq1", "X0", "X1", "Y0", "Y1", "Z0", "Z1"]
                + [f"f{k}" for k in range(12)] + ["zero"])
TREE_INPUTS = [f"a{k}" for k in range(12)] + [f"b{k}" for k in range(12)] + ["zero"]


def _miller_inputs(t):
    v = {name: t.input(name) for name in MILLER_STATE}
    state = [v[n] for n in MILLER_STATE]
    r = (_f2(state, 6), _f2(state, 8), _f2(state, 10))
    f = _f12(state[12:24])
    return v, state, r, f


@functools.lru_cache(maxsize=None)
def programs() -> dict:
    """The three schedules: the Miller loop's doubling step (f^2, the step,
    f times the line) and addition step (the step, f times the line), both
    in place over MILLER_STATE, and the dense Fq12 product of the tree."""
    out = {}
    t = Tracer()
    v, state, r, f = _miller_inputs(t)
    r2, (l0, l1, l2) = dbl_step(r, v["xp"], v["yp"], v["zero"])
    f2 = f12_mul_by_014(f12_sqr(f), l0, l1, l2)
    out["dbl"] = Program("dbl", t, state, _flat(r2) + _flat(f2), in_place=state[6:24])
    t = Tracer()
    v, state, r, f = _miller_inputs(t)
    xq, yq = (v["xq0"], v["xq1"]), (v["yq0"], v["yq1"])
    r2, (l0, l1, l2) = add_step(r, xq, yq, v["xp"], v["yp"], v["zero"])
    f2 = f12_mul_by_014(f, l0, l1, l2)
    out["add"] = Program("add", t, state, _flat(r2) + _flat(f2), in_place=state[6:24])
    t = Tracer()
    ins = [t.input(n) for n in TREE_INPUTS]
    out["fq12_mul"] = Program("fq12_mul", t, ins, _flat(f12_mul(_f12(ins[:12]), _f12(ins[12:24]))))
    return out


def miller_rounds(pairs: int) -> int:
    """Dependent product rounds of miller_loop_product over `pairs` pairs:
    the per-pair chain, then one dense product per tree level."""
    progs = programs()
    adds = sum(X_BITS)
    levels = max(pairs - 1, 0).bit_length()
    return (len(X_BITS) * progs["dbl"].product_rounds + adds * progs["add"].product_rounds
            + levels * progs["fq12_mul"].product_rounds)


def miller_products(live_pairs: int, pairs: int) -> int:
    """Fq products miller_loop_product's kernels do: the per-pair loop of
    each unmasked pair and P - 1 dense products."""
    progs = programs()
    per_pair = len(X_BITS) * progs["dbl"].products + sum(X_BITS) * progs["add"].products
    return live_pairs * per_pair + (pairs - 1) * progs["fq12_mul"].products


def miller_passes(pairs: int) -> int:
    """Passes (product rounds and linear passes, one block barrier each) of
    miller_loop_product over `pairs` pairs: the per-pair chain, then the
    tree levels."""
    progs = programs()
    levels = max(pairs - 1, 0).bit_length()
    return (len(X_BITS) * len(progs["dbl"].passes) + sum(X_BITS) * len(progs["add"].passes)
            + levels * len(progs["fq12_mul"].passes))


# ------------------------------------------------- the final exponentiation's hard part

# The hard part's state, twelve slots per area: the easy-part output t, the
# base b of the current |x|-exponentiation, its accumulator in a0 or a1 (a
# squaring or product reads one and writes the other, so no copy pass), the
# saved y2, the off-chain product k, the Frobenius coefficient blocks.
HARD_AREAS = ("t", "b", "a0", "a1", "y2", "k", "frob1", "frob2")
HARD_STATE = [f"{area}_{k}" for area in HARD_AREAS for k in range(12)]
_FROB_VALUES = {k: [lb.unpack(c) for c in tw.FROB12_COEFF[k].reshape(12, lb.NL)] for k in (1, 2)}


def _hard_program(name, build) -> FormProgram:
    """A form program over HARD_STATE; `build(area, frob, zero)` returns
    {area: Fq12} for the areas it writes."""
    t = Tracer()
    ins = [t.input(n) for n in HARD_STATE]
    area = {a: _f12(ins[12 * k:12 * k + 12]) for k, a in enumerate(HARD_AREAS)}
    zero = t.input("zero")

    def frob(x, power):
        k = 12 * HARD_AREAS.index(f"frob{power}")
        return f12_frobenius(x, power, ins[k:k + 12], _FROB_VALUES[power], zero)

    outputs = [(12 * HARD_AREAS.index(a) + k, x)
               for a, value in build(area, frob, zero).items() for k, x in enumerate(_flat(value))]
    return FormProgram(name, t, ins, outputs)


def _links():
    """The programs between the |x|-exponentiations of
    pairing_ops.final_exp_hard_part. Chain c takes its base from b and its
    accumulator in a{c % 2}, and leaves acc = base^|x| there (so
    _exp_neg_x(base) = conj(acc)); link c reads it and sets b and
    a{(c + 1) % 2} for chain c + 1. t^3, frob(y2, 2) and conj(y2) t^3 are
    computed beside the chain, in k, so the last link is one round:
      link0  y0 = conj(acc) conj(t)           k = t^2
      link1  y1 = conj(acc) conj(y0)          k = t^3
      link2  y2 = conj(acc) frob(y1, 1)       saved in y2
      link3  base = conj(acc) = y2^x          k = frob(y2, 2) conj(y2) t^3
      fin    out = conj(acc) k into a1"""
    def link0(v, frob, zero):
        y0 = f12_mul(f12_conj(v["a0"], zero), f12_conj(v["t"], zero))
        return {"b": y0, "a1": y0, "k": f12_sqr(v["t"])}

    def link1(v, frob, zero):
        y1 = f12_mul(f12_conj(v["a1"], zero), f12_conj(v["b"], zero))
        return {"b": y1, "a0": y1, "k": f12_mul(v["k"], v["t"])}

    def link2(v, frob, zero):
        y2 = f12_mul(f12_conj(v["a0"], zero), frob(v["b"], 1))
        return {"b": y2, "a1": y2, "y2": y2}

    def link3(v, frob, zero):
        base = f12_conj(v["a1"], zero)
        k = f12_mul(frob(v["y2"], 2), f12_mul(f12_conj(v["y2"], zero), v["k"]))
        return {"b": base, "a0": base, "k": k}

    def fin(v, frob, zero):
        return {"a1": f12_mul(f12_conj(v["a0"], zero), v["k"])}

    return {"link0": link0, "link1": link1, "link2": link2, "link3": link3, "fin": fin}


@functools.lru_cache(maxsize=None)
def hard_programs() -> dict:
    """csrc/hard_part.cu's form programs: the cyclotomic squaring and the
    product by the base from each accumulator area into the other, and the
    links (`_links`)."""
    out = {}
    for src in (0, 1):
        dst = f"a{1 - src}"
        out[f"sqr{src}"] = _hard_program(
            f"sqr{src}", lambda v, frob, zero, s=src, d=dst: {d: f12_cyclotomic_sqr(v[f"a{s}"])})
        out[f"mul{src}"] = _hard_program(
            f"mul{src}", lambda v, frob, zero, s=src, d=dst: {d: f12_mul(v[f"a{s}"], v["b"])})
    for name, build in _links().items():
        out[name] = _hard_program(name, build)
    return out


HARD_OUT = 12 * HARD_AREAS.index("a1")       # fin writes the result here


@functools.lru_cache(maxsize=None)
def hard_sequence() -> tuple:
    """The programs hard_part.cu runs, in order: per chain, for each bit of
    |x| after the leading one a squaring and on a set bit a product (each
    from one accumulator area into the other), then the chain's link."""
    seq = []
    for c, link in enumerate(_links()):
        acc = c % 2
        for bit in X_BITS:
            seq.append(f"sqr{acc}")
            acc ^= 1
            if bit:
                seq.append(f"mul{acc}")
                acc ^= 1
        if acc != c % 2:
            raise ValueError("a chain must end in the area it started in")
        seq.append(link)
    return tuple(seq)


def hard_work() -> dict:
    """final_exp_hard_part's kernel over its sequence: its Fq products,
    dependent product rounds and passes (one block barrier each)."""
    progs = hard_programs()
    seq = [progs[s] for s in hard_sequence()]
    return {"kernel_fq_products": sum(p.products for p in seq),
            "product_rounds": sum(p.product_rounds for p in seq),
            "passes": sum(len(p.passes) for p in seq)}


# ------------------------------------------------- the final exponentiation's easy part

# The easy part's state, one slot per Fq: the Miller value m, the
# p^2-Frobenius coefficient block, the adjugate c of tower.fq6_inv (three
# Fq2), the Fq2 element T that fq6_inv inverts, T's Fq norm and its
# inverse, and the result.
EASY_STATE = ([f"m_{k}" for k in range(12)] + [f"frob2_{k}" for k in range(12)]
              + [f"c_{k}" for k in range(6)] + ["T_0", "T_1", "norm", "ninv"]
              + [f"out_{k}" for k in range(12)])


def _easy_program(name, build) -> FormProgram:
    """A form program over EASY_STATE; `build(v, zero)`, v the state's
    inputs by name, returns {state name: node} for the slots it writes."""
    t = Tracer()
    ins = [t.input(n) for n in EASY_STATE]
    v = dict(zip(EASY_STATE, ins))
    zero = t.input("zero")
    return FormProgram(name, t, ins,
                       [(EASY_STATE.index(k), x) for k, x in build(v, zero).items()])


def _easy_norm(v, zero):
    """m -> the Fq norm of tower.fq12_inv's chain, by tower.fq12_inv's,
    fq6_inv's and fq2_inv's formulas: t = a0^2 - v a1^2 (Fq6), its adjugate
    c and T = t0 c0 + xi (t1 c2 + t2 c1) (Fq2), then T0^2 + T1^2."""
    a0, a1 = _f12([v[f"m_{k}"] for k in range(12)])
    t = f6_sub(f6_mul(a0, a0), f6_mul_by_v(f6_mul(a1, a1)))
    sq = [f2_sqr(x) for x in t]
    p01, p12, p20 = f2_mul(t[0], t[1]), f2_mul(t[1], t[2]), f2_mul(t[2], t[0])
    c = (f2_sub(sq[0], f2_mul_by_xi(p12)), f2_sub(f2_mul_by_xi(sq[2]), p01), f2_sub(sq[1], p20))
    T = f2_add(f2_mul(t[0], c[0]), f2_mul_by_xi(f2_add(f2_mul(t[1], c[2]), f2_mul(t[2], c[1]))))
    out = {f"c_{k}": x for k, x in enumerate(_flat(c))}
    out.update(T_0=T[0], T_1=T[1], norm=T[0] * T[0] + T[1] * T[1])
    return out


def _easy_up(v, zero):
    """The way back up from the norm's inverse: T^-1, t^-1 = c T^-1,
    m^-1 = (a0 t^-1, -a1 t^-1); then conj(m) m^-1 = m^(p^6 - 1) and its
    product with its p^2-Frobenius (pairing_ops.final_exp_easy_part)."""
    m = _f12([v[f"m_{k}"] for k in range(12)])
    c = [_f2([v[f"c_{k}"] for k in range(6)], 2 * j) for j in range(3)]
    ninv = v["ninv"]
    T_inv = (v["T_0"] * ninv, zero - v["T_1"] * ninv)
    t_inv = tuple(f2_mul(x, T_inv) for x in c)
    m_inv = (f6_mul(m[0], t_inv), tuple(f2_neg(x, zero) for x in f6_mul(m[1], t_inv)))
    t = f12_mul(f12_conj(m, zero), m_inv)
    frob = f12_frobenius(t, 2, [v[f"frob2_{k}"] for k in range(12)], _FROB_VALUES[2], zero)
    return {f"out_{k}": x for k, x in enumerate(_flat(f12_mul(frob, t)))}


@functools.lru_cache(maxsize=None)
def easy_programs() -> dict:
    """csrc/easy_part.cu's form programs, run in this order with the norm's
    inversion between them: the norm chain down, and the way back up."""
    return {"norm": _easy_program("easy_norm", _easy_norm),
            "up": _easy_program("easy_up", _easy_up)}


def easy_work() -> dict:
    """final_exp_easy_part's kernel: its form programs' Fq products,
    dependent product rounds and passes (one block barrier each; the
    inversion between them is one more)."""
    progs = easy_programs().values()
    return {"kernel_fq_products": sum(p.products for p in progs),
            "product_rounds": sum(p.product_rounds for p in progs),
            "passes": sum(len(p.passes) for p in progs)}


# ------------------------------------------------------------ the header


def _c_words(ctype: str, name: str, words: list) -> str:
    rows = [", ".join(f"{w}u" for w in words[i:i + 12]) for i in range(0, len(words), 12)]
    return f"static __constant__ {ctype} {name}[{len(words)}] = {{\n  " + ",\n  ".join(rows) + "};"


def _op_words(passes) -> tuple:
    words, offsets = [], [0]
    for ops in passes:
        words += [(k << 3 * SLOT_BITS) | (o << 2 * SLOT_BITS) | (a << SLOT_BITS) | b
                  for k, o, a, b in ops]
        offsets.append(len(words))
    return words, offsets


def _form_tables(prefix: str, progs: dict) -> list:
    """A family of form programs as one table each of op words, pass
    offsets, forms (offsets into the terms, which are global to the family)
    and terms, and every program's offsets into the first three and its
    pass count ({prefix}_PROG_*, in the dict's order)."""
    ops, passes, forms, terms, cols, lines = [], [], [], [], [], []
    for k, (name, prog) in enumerate(progs.items()):
        words, offsets = _op_words(prog.passes)
        cols.append((len(ops), len(passes), len(forms), len(prog.passes)))
        ops += words
        passes += offsets
        forms += [len(terms) + f for f in prog.forms]
        terms += [((c & 0xFFFF) << 16) | (TERM_LAST if last else 0) | s for s, c, last in prog.terms]
        lines.append(f"// {prefix} program {k}, {name}: {prog.products} products in "
                     f"{prog.product_rounds} rounds, {len(prog.passes)} passes, "
                     f"{len(prog.terms)} terms, {prog.slots} slots")
    if len(terms) > 1 << 16:
        raise ValueError(f"{len(terms)} terms do not fit {prefix}_FORMS' 16-bit offsets")
    cols = list(zip(*cols))
    return lines + [
        f"#define {prefix}_SLOTS {max(p.slots for p in progs.values())}",
        f"#define {prefix}_NOPS {len(ops)}",
        f"#define {prefix}_NPASS {len(passes)}",
        f"#define {prefix}_NFORMS {len(forms)}",
        f"#define {prefix}_NTERMS {len(terms)}",
        _c_words("uint32_t", f"{prefix}_OPS", ops),
        _c_words("uint16_t", f"{prefix}_PASS", passes),
        _c_words("uint16_t", f"{prefix}_FORMS", forms),
        _c_words("uint32_t", f"{prefix}_TERMS", terms),
        _c_words("uint16_t", f"{prefix}_PROG_OPS", cols[0]),
        _c_words("uint16_t", f"{prefix}_PROG_PASS", cols[1]),
        _c_words("uint16_t", f"{prefix}_PROG_FORMS", cols[2]),
        _c_words("uint16_t", f"{prefix}_PROG_NPASSES", cols[3]),
    ]


def header() -> str:
    """round_programs.cuh, for csrc/rounds.cuh: each Miller program's
    operation words, pass offsets and slot layout (MR_*); the hard part's
    form programs (HP_*, `_form_tables`) with its sequence of programs and
    its state layout; the easy part's (EP_*) with its state layout; the
    constant of form_load's reduction."""
    progs = programs()
    lines = ["// generated by lighthouse_tpu_torch.crypto.torchbls.rounds.header",
             "#pragma once", "#include <stdint.h>"]
    for name, prog in progs.items():
        up = f"MR_{name.upper()}"
        words, offsets = _op_words(prog.passes)
        lines += [
            f"// {name}: {prog.products} products in {prog.product_rounds} rounds, "
            f"{len(prog.passes)} passes, {prog.slots} slots",
            f"#define {up}_SLOTS {prog.slots}",
            f"#define {up}_PASSES {len(prog.passes)}",
            f"#define {up}_NOPS {len(words)}",
            _c_words("uint32_t", f"{up}_OPS", words),
            _c_words("uint16_t", f"{up}_PASS", offsets),
        ]
        if name == "fq12_mul":
            lines.append(_c_words("uint16_t", f"{up}_OUT", prog.out_slots))
    for k, name in enumerate(MILLER_STATE):
        lines.append(f"#define MR_SLOT_{name.upper()} {k}")
    hard = hard_programs()
    lines += _form_tables("HP", hard)
    seq = hard_sequence()
    index = {name: k for k, name in enumerate(hard)}
    lines += [
        f"#define HP_STATE_SLOTS {len(HARD_STATE)}",
        f"#define HP_SEQ_LEN {len(seq)}",
        f"#define HP_OUT {HARD_OUT}",
        _c_words("uint8_t", "HP_SEQ", [index[s] for s in seq]),
    ]
    for k, area in enumerate(HARD_AREAS):
        lines.append(f"#define HP_AREA_{area.upper()} {12 * k}")
    easy = easy_programs()
    lines += _form_tables("EP", easy)
    lines += [f"#define EP_{name.upper()} {k}" for k, name in enumerate(easy)]
    lines += [f"#define EP_SLOT_{area} {EASY_STATE.index(first)}"
              for area, first in (("M", "m_0"), ("FROB2", "frob2_0"), ("NORM", "norm"),
                                  ("NINV", "ninv"), ("OUT", "out_0"))]
    lines.append(f"#define EP_STATE_SLOTS {len(EASY_STATE)}")
    lines.append(f"#define RND_FORM_RECIP 0x{FORM_RECIP:016x}ull")
    return "\n".join(lines) + "\n"
