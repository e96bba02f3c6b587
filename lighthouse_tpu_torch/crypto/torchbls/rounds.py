"""Product-round schedules: Fq12 arithmetic spread over the threads of a block.

A schedule is straight-line Fq code, traced once from the tower formulas
below (the Miller loop's doubling and addition steps with their Fq12
squaring and sparse line product, and the dense Fq12 product), and cut into
passes that csrc/rounds.cuh runs with one operation per thread and a block
barrier after each pass:

- a *product round* holds the Montgomery products whose operands are ready,
  one per thread (a block of 64 threads runs the 45 products of a doubling
  step's first round at once);
- *linear passes* between the rounds form the sums, differences and copies
  (x xi, x 3, x 8 and negation are sums and differences too).

Every product of product-depth k (products on its longest input path) sits in
round k, so the rounds a step takes are its product depth; a dependent chain
of rounds is the latency floor of the design. Operands live in shared-memory
slots; `header()` emits each program as a table of 32-bit operation words
(kind, out, a, b: 2 + 3 x 10 bits) into the generated header
miller_rounds.cuh. tests/test_torch_rounds.py executes the same programs
on Python integers, pass by pass with the parallel semantics of the card
(every operand read before any result of the pass is written), against the
plain versions, and refuses a pass in which one operation reads or writes a
slot another one writes.

All results are exact mod p and fully reduced, so any exact formula gives
the plain versions' bits; only the point formulas and line scaling of
pairing_ops are followed term for term.
"""

from __future__ import annotations

import functools

from .pairing_ops import X_BITS

MUL, ADD, SUB, COPY = 0, 1, 2, 3       # csrc/rounds.cuh's RND_* kinds
SLOT_BITS = 10


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


class Program:
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
        free: list = []
        nxt = len(inputs)
        by_pass = [[n for n in order if pass_of[n] == p] for p in range(len(keys))]
        releases: dict = {}
        for n in order:
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
        self.slots = nxt
        if nxt >= 1 << SLOT_BITS:
            raise ValueError(f"{name}: {nxt} slots do not fit {SLOT_BITS} bits")
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

    @property
    def products(self) -> int:
        return sum(1 for ops in self.passes for op in ops if op[0] == MUL)

    @property
    def product_rounds(self) -> int:
        return sum(1 for ops in self.passes if any(op[0] == MUL for op in ops))

    def widest(self) -> int:
        return max(len(ops) for ops in self.passes)


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


# ------------------------------------------------------------ the header


def _c_words(ctype: str, name: str, words: list) -> str:
    rows = [", ".join(f"{w}u" for w in words[i:i + 12]) for i in range(0, len(words), 12)]
    return f"static __constant__ {ctype} {name}[{len(words)}] = {{\n  " + ",\n  ".join(rows) + "};"


def header() -> str:
    """miller_rounds.cuh: each program's operation words, pass offsets and
    slot layout, for csrc/rounds.cuh's run_program."""
    progs = programs()
    lines = ["// generated by lighthouse_tpu_torch.crypto.torchbls.rounds.header",
             "#pragma once", "#include <stdint.h>"]
    for name, prog in progs.items():
        up = f"MR_{name.upper()}"
        words, offsets = [], [0]
        for ops in prog.passes:
            words += [(k << 3 * SLOT_BITS) | (o << 2 * SLOT_BITS) | (a << SLOT_BITS) | b
                      for k, o, a, b in ops]
            offsets.append(len(words))
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
    return "\n".join(lines) + "\n"
