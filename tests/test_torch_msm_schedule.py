"""csrc/msm.cu's schedules for msm_fixed, msm_varying and msm_precompute,
restated in Python on the pure-Python curve (bls381/curve.py) and held
against the host's sum_i s_i P_i bit for bit.

msm_fixed: the two 8-bit windows of each 16-bit comb chunk, the counting
sort by bucket (msm_hist_kernel, msm_scatter_kernel; the order inside a
bucket shuffled, since the card's atomic cursors fix none), the group
trees of msm_level_kernel (entry and worker offsets, the binary search,
the grid bound of the host code), the buckets' sums by bit and the join
of msm_join_kernel. msm_varying: the scalar rebuilt from its digits at
every width and reduced mod r a bit at a time, the GLV split by long
division, the slots and their bit windows, the join. msm_precompute: its
teams' layout (point, block, team, lane and the rows each lane stores)
and a team's doubling in the join's three rounds of Montgomery products
on Python integers, against the port's plain curve_ops.jac_double and
msm.precompute_plain. The constants are read from msm.cu. No JAX, no
kernel. Tolerance: exact equality.
"""

import random
import re
from bisect import bisect_right
from pathlib import Path

import numpy as np
import pytest

from lighthouse_tpu_torch.crypto.bls381 import curve as pc
from lighthouse_tpu_torch.crypto.bls381.constants import P, R

MSM_CU = (Path(__file__).resolve().parents[1] / "lighthouse_tpu_torch" / "crypto" / "torchbls"
          / "csrc" / "msm.cu")


def cu_defines(path):
    """The `#define NAME expr` lines of a CUDA source whose expression is
    integer arithmetic on earlier names, evaluated in order (C's division
    of nonnegative integers as Python's //)."""
    consts = {}
    for name, expr in re.findall(r"^#define (\w+) ([\w ()*/+-]+?)\s*(?://.*)?$",
                                 path.read_text(), re.M):
        try:
            consts[name] = eval(expr.replace("/", "//"), {"__builtins__": {}}, dict(consts))
        except NameError:
            pass
    return consts


CU = cu_defines(MSM_CU)

# torch and the port's modules load when this file's first test runs, not
# at collection, so a test worker that only runs the JAX package's tests
# never loads torch.
TM = CO = LB = torch = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    global TM, CO, LB, torch
    import torch
    from lighthouse_tpu_torch.crypto.torchbls import curve_ops as CO
    from lighthouse_tpu_torch.crypto.torchbls import limbs as LB
    from lighthouse_tpu_torch.crypto.torchbls import msm as TM


# affine G1 on Python ints (None the identity): curve.add and
# curve.double's formulas with pow(x, -1, p) for the inverse, which keeps
# the file's thousands of point operations within seconds


def add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0]:
        return dbl(p) if p[1] == q[1] else None
    lam = (q[1] - p[1]) * pow(q[0] - p[0], -1, P) % P
    x = (lam * lam - p[0] - q[0]) % P
    return x, (lam * (p[0] - x) - p[1]) % P


def dbl(p):
    if p is None or p[1] == 0:
        return None
    lam = 3 * p[0] * p[0] * pow(2 * p[1], -1, P) % P
    x = (lam * lam - 2 * p[0]) % P
    return x, (lam * (p[0] - x) - p[1]) % P


def mul(p, k):
    acc = None
    for bit in bin(k)[2:]:
        acc = dbl(acc)
        if bit == "1":
            acc = add(acc, p)
    return acc


def host_msm(points, scalars):
    acc = None
    for pt, k in zip(points, scalars):
        if pt is not None and k % R:
            acc = add(acc, mul(pt, k % R))
    return acc


def points(n, seed, every_identity=0):
    """n seeded points a + i b (two seeded multiples of the generator), every
    every_identity-th the identity."""
    rng = random.Random(seed)
    a, b = mul(pc.G1_GEN, rng.randrange(1, R)), mul(pc.G1_GEN, rng.randrange(1, R))
    out = []
    for i in range(n):
        out.append(None if every_identity and i % every_identity == every_identity - 1 else a)
        a = add(a, b)
    return out


def test_the_files_curve_is_the_packages():
    pt, k = points(1, 0x17)[0], random.Random(0x18).randrange(R)
    assert mul(pt, k) == pc.g1_mul(pt, k)
    assert add(pt, pc.g1_neg(pt)) is None and add(pt, pt) == pc.g1_add(pt, pt)


# ------------------------------------------------------------ the level kernel


def exclusive_scan(v):
    out, run = [], 0
    for c in v:
        out.append(run)
        run += c
    return out + [run]


def tree_levels(most, fan):
    h, c = 1, fan
    while c < most:
        c *= fan
        h += 1
    return h


def level_points(groups, entries, fan):
    return groups + entries // fan + 1


def run_levels(load0, counts, fan, levels):
    """msm_level_kernel `levels` times (run_levels of msm.cu): group g has
    counts[g] entries at level 0, loaded by load0(g, pos, e), and max(1,
    ceil(n / fan)) at each later level; returns the group sums."""
    groups, entries = len(counts), sum(counts)
    cur = None
    c = list(counts)
    for h in range(levels):
        ws = [max(1, -(-n // fan)) for n in c]
        eo, wo = exclusive_scan(c), exclusive_scan(ws)
        bound = level_points(groups, entries, fan)
        assert wo[-1] <= bound, "the host's grid would miss a worker"
        out = []
        for w in range(wo[-1]):
            lo, hi = 0, groups - 1          # the kernel's binary search
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                lo, hi = (mid, hi) if wo[mid] <= w else (lo, mid - 1)
            g = lo
            assert g == bisect_right(wo[:groups], w) - 1
            n = eo[g + 1] - eo[g]
            begin = (w - wo[g]) * fan
            acc = None
            for e in range(begin, min(n, begin + fan)):
                acc = add(acc, load0(g, eo[g] + e, e) if h == 0 else cur[eo[g] + e])
            out.append(acc)
        cur, c, entries = out, ws, bound
    assert len(cur) == groups
    return cur


def join(terms):
    """msm_join_kernel: sum_j 2^j X_j by a tree whose level l doubles each
    pair's upper term 2^(l - 1) times."""
    sh, span = list(terms), 1
    while len(sh) > 1:
        nxt = []
        for t in range(len(sh) // 2):
            b = sh[2 * t + 1]
            for _ in range(span):
                b = dbl(b)
            nxt.append(add(sh[2 * t], b))
        sh, span = nxt, 2 * span
    return sh[0]


def test_constants_are_the_kernels():
    assert CU["BUCKETS"] == (1 << CU["WINDOW_BITS"]) - 1
    assert CU["FIXED_GROUPS"] == 2 * CU["BUCKETS"] <= CU["MAX_GROUPS"]
    assert 2 * CU["WINDOW_BITS"] == CU["CHUNK_BITS"] == CU["BIT_TERMS"] <= 2 * CU["JOIN_TEAMS"]
    assert CU["GLV_BITS"] <= 2 * CU["JOIN_TEAMS"] and CU["GLV_BITS"] <= CU["MAX_GROUPS"]
    assert CU["JOIN_LANES"] >= 4                 # an addition's widest round


@pytest.mark.parametrize("fan", [2, 4])
@pytest.mark.parametrize("counts", [[0], [1], [5, 0, 3], [0, 0, 17, 1, 0], [64] * 3, [1] * 9])
def test_level_trees_sum_each_group(counts, fan):
    """Every group's entries, empty groups included, in one sum each."""
    pts = points(sum(counts), 0x5EED + sum(counts))
    offs = exclusive_scan(counts)
    got = run_levels(lambda g, pos, e: pts[pos], counts, fan, tree_levels(max(counts), fan))
    for g, n in enumerate(counts):
        want = None
        for pt in pts[offs[g]:offs[g] + n]:
            want = add(want, pt)
        assert got[g] == want


# ------------------------------------------------------------ msm_fixed


def comb_tables(pts):
    """msm_precompute's lanes as host points: lane j n + i is 2^(16 j) P_i."""
    n = len(pts)
    return [None if pts[i] is None else mul(pts[i], 1 << (16 * j))
            for j in range(CU["N_CHUNKS"]) for i in range(n)]


def chunks_of(scalars, n_chunks):
    """lane (j, i): chunk j of scalar i (FixedBaseMSM._bits' layout)."""
    return [(k % R) >> (16 * j) & 0xFFFF for j in range(n_chunks) for k in scalars]


def fixed_model(tables, chunks, seed):
    """msm_fixed on the card: buckets, their sums by bit, the join."""
    wb, nb = CU["WINDOW_BITS"], CU["BUCKETS"]
    groups = [[] for _ in range(CU["FIXED_GROUPS"])]
    for lane, (pt, c) in enumerate(zip(tables, chunks)):
        if pt is None:                          # the identity adds nothing
            continue
        for w in range(2):
            d = c >> (wb * w) & 0xFF
            if d:
                groups[w * nb + d - 1].append(lane)
    rng = random.Random(seed)
    for g in groups:
        rng.shuffle(g)                          # atomic cursors: any order
    order = [lane for g in groups for lane in g]
    counts = [len(g) for g in groups]
    sums = run_levels(lambda g, pos, e: tables[order[pos]], counts, CU["LANE_FAN"],
                      tree_levels(len(chunks), CU["LANE_FAN"]))

    def by_bit(g, pos, e):
        w, b = divmod(g, wb)
        d = (e >> b) << (b + 1) | 1 << b | (e & ((1 << b) - 1))
        assert 1 <= d <= nb and d >> b & 1
        return sums[w * nb + d - 1]

    half = 1 << (wb - 1)                        # digits with a given bit set
    terms = run_levels(by_bit, [half] * CU["BIT_TERMS"], CU["TREE_FAN"],
                       tree_levels(half, CU["TREE_FAN"]))
    return join(terms)


def test_bucket_bits_cover_each_digit_once_per_set_bit():
    wb = CU["WINDOW_BITS"]
    for b in range(wb):
        ds = [(e >> b) << (b + 1) | 1 << b | (e & ((1 << b) - 1)) for e in range(1 << (wb - 1))]
        assert sorted(ds) == [d for d in range(1, 1 << wb) if d >> b & 1]


@pytest.mark.parametrize("case", ["random", "one_bucket", "zero", "quarter_identity",
                                  "opposite", "equal"])
def test_fixed_schedule_is_the_sum(case):
    """Random scalars; every lane's chunk equal (one bucket a window); all
    chunks 0; every fourth point the identity; [P, -P] and [P, P] under
    equal scalars (each pair's lanes in one bucket)."""
    rng = random.Random(0xF1 + len(case))
    if case in ("opposite", "equal"):
        (pt,) = points(1, 0x400)
        pts = [pt, pc.g1_neg(pt) if case == "opposite" else pt]
        k = rng.randrange(R)
        scalars = [k, k]
    else:
        pts = points(4, 0x115, every_identity=4 if case == "quarter_identity" else 0)
        scalars = [rng.randrange(R) for _ in pts]
    tables = comb_tables(pts)
    if case == "one_bucket":
        chunks = [0xA5C3] * len(tables)
        comb = sum(0xA5C3 << (16 * j) for j in range(CU["N_CHUNKS"]))
        scalars = [comb] * len(pts)
    elif case == "zero":
        chunks = [0] * len(tables)
        scalars = [0] * len(pts)
    else:
        chunks = chunks_of(scalars, CU["N_CHUNKS"])
    got = fixed_model(tables, chunks, seed=len(case))
    assert got == host_msm(pts, scalars)
    if case in ("zero", "opposite"):
        assert got is None


# ------------------------------------------------------------ msm_varying


def fr_shift_in(k, bit):
    """fr_shift_in: k = 2k + bit mod r on 8 words, for k < r."""
    k = 2 * k + bit
    assert k < 1 << 256
    return k - R if k >= R else k


def rebuild(digits_row, w):
    """msm_recode_kernel's rebuild: digits MSB first at width w (4 at w =
    0), a bit at a time mod r; None where a digit is outside its range."""
    width = w or 4
    k = 0
    for d in digits_row:
        if not 0 <= d < 1 << width:
            return None
        for b in range(width - 1, -1, -1):
            k = fr_shift_in(k, d >> b & 1)
    return k


def glv_split(k):
    """glv_split: long division by lambda a bit at a time, the remainder in
    5 words; returns (k1, k2) with k = k2 lambda + k1."""
    lam = TM.GLV_LAMBDA
    assert k < R < 1 << 255
    rem = q = 0
    for b in range(255, -1, -1):
        rem = 2 * rem + (k >> b & 1)
        assert rem < 1 << 160
        if rem >= lam:
            rem -= lam
            q |= 1 << b
    assert q < 1 << 128
    return rem, q


def phi(pt):
    return None if pt is None else (TM.GLV_BETA * pt[0] % P, pt[1])


def varying_model(pts, live, digits, w):
    """msm_varying on the card: the recode, the bit windows, the join;
    "refused" for a digit outside its range on a live lane."""
    n = len(pts)
    slots, halves = [None] * (2 * n), [0] * (2 * n)
    for i in range(n):
        if not live[i]:
            continue
        k = rebuild([int(d) for d in digits[i]], w)
        if k is None:
            return "refused"
        halves[i], halves[n + i] = glv_split(k)
        slots[i], slots[n + i] = pts[i], phi(pts[i])
    bits = CU["GLV_BITS"]
    windows = run_levels(lambda j, pos, e: slots[e] if halves[e] >> j & 1 else None,
                         [2 * n] * bits, CU["TREE_FAN"], tree_levels(2 * n, CU["TREE_FAN"]))
    return join(windows)


def test_glv_constants_and_split():
    lam, beta = TM.GLV_LAMBDA, TM.GLV_BETA
    assert (lam * lam + lam + 1) % R == 0 and lam < 1 << CU["GLV_BITS"]
    assert pow(beta, 3, P) == 1 != beta
    for pt in points(3, 0x61):
        assert phi(pt) == mul(pt, lam)
    rng = random.Random(0x5917)
    for k in [0, 1, lam - 1, lam, lam + 1, lam * lam, R - 1] + [rng.randrange(R) for _ in range(64)]:
        k1, k2 = glv_split(k)
        assert (k1, k2) == (k % lam, k // lam)
        assert k1 < lam and k2 <= lam + 1 and k1 + k2 * lam == k


@pytest.mark.parametrize("w", [0, 2, 4, 5, 6])
def test_rebuild_reduces_every_width(w):
    """Each width's digits (msm_digits) rebuild to k mod r, also for digits
    that encode an integer past 2^256 (every digit at its maximum)."""
    rng = random.Random(0xD1 + w)
    ks = [0, 1, R - 1, R, 2 * R + 5] + [rng.randrange(R) for _ in range(16)]
    digits = TM.msm_digits(ks, w)
    for k, row in zip(ks, digits):
        assert rebuild([int(d) for d in row], w) == k % R
    width = w or 4
    nd = digits.shape[1]
    top = [(1 << width) - 1] * nd
    assert rebuild(top, w) == ((1 << (width * nd)) - 1) % R
    assert rebuild(top[:-1] + [1 << width], w) is None
    assert rebuild([-1] + top[1:], w) is None


@pytest.mark.parametrize("w", [0, 2, 4, 5, 6])
def test_varying_schedule_is_the_sum(w):
    """Six points (one masked, one the identity's lane masked) at each
    width, the edge scalars among them, against the host sum; a digit
    past its range refused."""
    pts = points(6, 0x200 + w)
    live = [True, True, False, True, True, True]
    lam = TM.GLV_LAMBDA
    scalars = [random.Random(w).randrange(R), R - 1, 7, lam, lam + 1, 0]
    digits = TM.msm_digits(scalars, w).astype(np.int64)
    want = host_msm([p if on else None for p, on in zip(pts, live)], scalars)
    assert varying_model(pts, live, digits, w) == want
    digits[1, 3] = 1 << (w or 4)
    assert varying_model(pts, live, digits, w) == "refused"
    digits[1, 3] = 0
    digits[2, 3] = -1                            # on a masked lane: never read
    assert varying_model(pts, live, digits, w) != "refused"


@pytest.mark.parametrize("pair", ["opposite", "equal"])
def test_varying_schedule_on_opposite_and_equal_points(pair):
    (pt,) = points(1, 0x400)
    pts = [pt, pc.g1_neg(pt) if pair == "opposite" else pt]
    k = random.Random(0x401).randrange(R)
    digits = TM.msm_digits([k, k], 4).astype(np.int64)
    got = varying_model(pts, [True, True], digits, 4)
    assert got == host_msm(pts, [k, k]) == (None if pair == "opposite" else mul(pt, 2 * k % R))


# ------------------------------------------------------------ msm_precompute

MONT_ONE = pow(2, 384, P)                 # R mod p: one in Montgomery form
R_INV = pow(2, -384, P)


def precompute_layout(n):
    """msm_precompute_kernel's threads: the launch's blocks, and per thread
    (block, threadIdx) its team, lane, warp, point i (live below n) and
    the (coordinate, table lane) it stores for each row."""
    lanes, teams, threads = CU["JOIN_LANES"], CU["PRE_TEAMS"], CU["MSM_THREADS"]
    blocks = (n + teams - 1) // teams     # lh_msm_precompute's grid
    out = []
    for b in range(blocks):
        for t in range(threads):
            team, lane = divmod(t, lanes)
            i = b * teams + team
            live = i < n                  # a team past n takes the rounds with no work
            stores = [(lane, j * n + i) for j in range(CU["N_CHUNKS"])] if live and lane < 3 else []
            out.append({"block": b, "thread": t, "team": team, "lane": lane, "warp": t // 32,
                        "point": i, "live": live, "stores": stores})
    return blocks, out


def test_precompute_launch_is_the_layouts():
    """The layout above is the kernel's: its grid and block in msm.cu."""
    text = MSM_CU.read_text()
    assert re.search(r"msm_precompute_kernel<<<\(n \+ PRE_TEAMS - 1\) / PRE_TEAMS, MSM_THREADS,",
                     text)
    assert re.search(r"const int i = blockIdx.x \* PRE_TEAMS \+ tm.team;", text)
    assert CU["PRE_TEAMS"] * CU["JOIN_LANES"] == CU["MSM_THREADS"]
    assert 32 % CU["JOIN_LANES"] == 0 and CU["MSM_THREADS"] % 32 == 0   # no team spans warps


@pytest.mark.parametrize("n", [1, 6, 129, 132 * 32 + 1, 4096])
def test_precompute_layout_covers_every_lane_once(n):
    """Every (coordinate, table lane) of the 16 n rows is stored by exactly
    one thread, the thread of its point's team whose lane is the
    coordinate; each team is JOIN_LANES lanes of one warp; every thread of
    the grid runs (whole warps meet the round barriers) and the tail block
    holds only the teams left over as live ones."""
    blocks, threads = precompute_layout(n)
    assert len(threads) == blocks * CU["MSM_THREADS"]
    stores = [s for th in threads for s in th["stores"]]
    assert sorted(stores) == [(c, lane) for c in range(3) for lane in range(CU["N_CHUNKS"] * n)]
    by_point = {}
    for th in threads:
        if th["live"]:
            by_point.setdefault(th["point"], []).append(th)
    assert sorted(by_point) == list(range(n))
    for i, team in by_point.items():
        assert sorted(th["lane"] for th in team) == list(range(CU["JOIN_LANES"]))
        assert len({(th["block"], th["warp"]) for th in team}) == 1
        assert team[0]["block"] == i // CU["PRE_TEAMS"]
    tail = n - (blocks - 1) * CU["PRE_TEAMS"]
    assert 1 <= tail <= CU["PRE_TEAMS"]
    assert sum(th["block"] == blocks - 1 and th["live"] for th in threads) == tail * CU["JOIN_LANES"]
    if n == 4096:
        assert blocks == 128              # 4096 points reach 128 of the card's 132 SMs


def mont(a, b):
    """fq.cuh fp_mul: a b R^-1 mod p, fully reduced."""
    return a * b * R_INV % P


def team_round(a, b, n):
    """join_round: lane k < n of the team computes a[k] b[k]; after the
    team's barrier every lane reads all n products."""
    assert n <= CU["JOIN_LANES"] == len(a) == len(b)
    return [mont(a[k], b[k]) for k in range(n)]


def team_dbl(pt):
    """join_dbl on Montgomery-form Python integers: lane k's operands as
    fp_pick gives them, the three rounds {X^2, Y^2, Y Z}, {B^2, (X + B)^2,
    E^2}, {E (D - X3)}, and the additions every lane repeats."""
    X, Y, Z = pt
    A, B, YZ = team_round([X, Y, Y, Y], [X, Y, Z, Z], 3)
    E = (2 * A + A) % P
    XB = (X + B) % P
    C, T, F = team_round([B, XB, E, E], [B, XB, E, E], 3)
    D = 2 * ((T - A - C) % P) % P
    X3 = (F - 2 * D) % P
    (EDX,) = team_round([E] * 4, [(D - X3) % P] * 4, 1)
    return X3, (EDX - 8 * C) % P, 2 * YZ % P


def jac_tensor(pts):
    """Montgomery Jacobian Python integers -> curve_ops' limb tensors."""
    return tuple(torch.as_tensor(LB.pack_batch([pt[c] for pt in pts]).astype(np.int64))
                 for c in range(3))


def test_team_doubling_rounds_are_jac_double():
    """240 doublings (a point's whole precompute chain) of seeded points in
    Montgomery form, one with a Z other than one, the identity (one, one,
    zero) and the precompute's identity (0, 0, 0), bit for bit after every
    doubling against curve_ops.jac_double on the limb tensors."""
    pts = []
    for x, y in points(3, 0x7EA4):
        pts.append((x * MONT_ONE % P, y * MONT_ONE % P, MONT_ONE))
    x, y = points(1, 0x7EA5)[0]
    z = random.Random(0x7EA6).randrange(2, P)
    pts.append((x * z * z * MONT_ONE % P, y * z ** 3 * MONT_ONE % P, z * MONT_ONE % P))
    pts += [(MONT_ONE, MONT_ONE, 0), (0, 0, 0)]
    jac = jac_tensor(pts)
    doublings = (CU["N_CHUNKS"] - 1) * CU["CHUNK_BITS"]
    assert doublings == 240
    for _ in range(doublings):
        pts = [team_dbl(pt) for pt in pts]
        jac = CO.jac_double(jac, CO.FQ_OPS)
        assert [tuple(LB.unpack_batch(c.numpy())) for c in jac] == [
            tuple(pt[c] for pt in pts) for c in range(3)]
    assert pts[-2] == (MONT_ONE, MONT_ONE, 0) and pts[-1] == (0, 0, 0)
    assert all(pt[2] for pt in pts[:-2])


def precompute_model(pts):
    """msm_precompute_kernel on standard-form affine points (None: the
    identity, loaded from zeros): each team's chain of team_dbl, its rows
    stored by the layout's lanes. Returns (tx, ty, tz) as lists of ints."""
    n = len(pts)
    tables = [[None] * (CU["N_CHUNKS"] * n) for _ in range(3)]
    _blocks, threads = precompute_layout(n)
    stores = {}
    for th in threads:
        stores.setdefault(th["point"], []).extend(th["stores"])
    for i in range(n):
        x, y = pts[i] or (0, 0)
        p = (x * MONT_ONE % P, y * MONT_ONE % P, 0 if pts[i] is None else MONT_ONE)
        rows = []
        for j in range(CU["N_CHUNKS"]):
            rows.append(p)
            if j + 1 < CU["N_CHUNKS"]:
                for _ in range(CU["CHUNK_BITS"]):
                    p = team_dbl(p)
        for c, lane in stores[i]:
            assert tables[c][lane] is None
            tables[c][lane] = rows[lane // n][c]
    return tables


@pytest.mark.parametrize("n, every_identity", [(1, 0), (6, 3), (33, 4)])
def test_precompute_model_is_precompute_plain(n, every_identity):
    """The whole kernel restated (layout, rounds, stores) equals
    msm.precompute_plain's tables limb for limb, identities included, and
    its rows are 2^(16 j) P_i on the curve; 33 points leave a tail block of
    one team."""
    pts = points(n, 0x9E0 + n, every_identity)
    args = [torch.as_tensor(LB.pack_batch([0 if pt is None else pt[c] for pt in pts])
                            .astype(np.int64)) for c in range(2)]
    args.append(torch.as_tensor(np.array([pt is None for pt in pts])))
    plain = TM.precompute_plain(*args)
    model = precompute_model(pts)
    assert [LB.unpack_batch(t.numpy()) for t in plain] == model
    for i, want in enumerate(pts):
        for j in range(CU["N_CHUNKS"]):
            X, Y, Z = (model[c][j * n + i] * R_INV % P for c in range(3))
            if want is None:
                assert Z == 0
                continue
            zi = pow(Z, -1, P)
            assert (X * zi * zi % P, Y * zi ** 3 % P) == want
            for _ in range(CU["CHUNK_BITS"]):
                want = dbl(want)
