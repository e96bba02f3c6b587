// Teams: lanes of one warp that evaluate a G1/G2 point step or a
// hash-to-G2 step together (prepare.cu, h2c.cu).
//
// A team is up to 32 lanes of a warp with its state in shared-memory slots
// (one Fq element each, 16-byte aligned). It runs the form programs of the
// generated team_programs.cuh (torchbls/team.py) level by level: in a level
// lane l of a team of nl takes the products l, l + nl, ... (each the product
// of two forms its lane evaluates, rounds.cuh round_op), then the team
// synchronises with __syncwarp over its lanes' mask, never a block barrier.
// A program ends with the pass that writes its outputs' forms into their
// state slots, so the sums between levels take no level of their own.
//
// The tables of a prefix (TG1: G1 points, TG2: G2 points, TSW: the SWU map)
// are staged from constant into shared memory once per block; the
// per-program offsets stay in constant memory, which a team reads
// uniformly. On top of the programs this file has the point steps the
// kernels use: jac_add with its cases as branches that are uniform over a
// team (p2 = O, then p1 = O, then H = 0 with R = 0, the doubling, or R != 0,
// the identity), the double-and-add scalar multiplication, and the slot
// copies between them.
#pragma once
#include "rounds.cuh"
#include "team_programs.cuh"

struct team {
  int lane;       // index within the team
  int nl;         // lanes in the team
  unsigned mask;  // the team's lanes in the warp
};

static __device__ __forceinline__ void team_sync(const team &tm) { __syncwarp(tm.mask); }

// one program: per pass, lane l takes ops l, l + nl, ...; then a team
// sync. Out of line, so a kernel holds one copy of the interpreter's code;
// sp is rounds.cuh's cycle hook (latency.cu's split; none in the kernels).
template <class Split = no_split>
static __device__ __noinline__ void team_run(fp *S, const uint32_t *ops, const uint16_t *pass,
                                             int npasses, const uint16_t *forms,
                                             const uint32_t *terms, team tm, Split sp = Split()) {
  for (int p = 0; p < npasses; p++) {
    const int end = pass[p + 1];
    for (int k = pass[p] + tm.lane; k < end; k += tm.nl)
      round_op<true>(S, ops[k], forms, terms, sp);
    sp.begin();
    team_sync(tm);
    sp.mark(SPLIT_SYNC);
  }
}

// A prefix's tables in shared memory: declare `__shared__ TG1_tables t;`,
// stage with every thread of the block (then a block barrier), run program
// `prog` (a <prefix>_<NAME> id) on the state S with a team.
#define TEAM_TABLES(P)                                                                 \
  struct P##_tables {                                                                  \
    uint32_t ops[P##_NOPS], terms[P##_NTERMS];                                         \
    uint16_t pass[P##_NPASS], forms[P##_NFORMS];                                       \
    __device__ __forceinline__ void stage(int t, int nt) {                             \
      stage_tables(ops, P##_OPS, P##_NOPS, terms, P##_TERMS, P##_NTERMS, pass, P##_PASS, \
                   P##_NPASS, forms, P##_FORMS, P##_NFORMS, t, nt);                    \
    }                                                                                  \
    __device__ __forceinline__ void run(fp *S, int prog, const team &tm) const {       \
      team_run(S, ops + P##_PROG_OPS[prog], pass + P##_PROG_PASS[prog],                \
               P##_PROG_NPASSES[prog], forms + P##_PROG_FORMS[prog], terms, tm);       \
    }                                                                                  \
  };

static __device__ __forceinline__ void stage_tables(uint32_t *ops, const uint32_t *ops_c, int nops,
                                                    uint32_t *terms, const uint32_t *terms_c,
                                                    int nterms, uint16_t *pass,
                                                    const uint16_t *pass_c, int npass,
                                                    uint16_t *forms, const uint16_t *forms_c,
                                                    int nforms, int t, int nt) {
  for (int k = t; k < nops; k += nt) ops[k] = ops_c[k];
  for (int k = t; k < nterms; k += nt) terms[k] = terms_c[k];
  for (int k = t; k < npass; k += nt) pass[k] = pass_c[k];
  for (int k = t; k < nforms; k += nt) forms[k] = forms_c[k];
}

TEAM_TABLES(TG1)
TEAM_TABLES(TG2)
TEAM_TABLES(TSW)

// ------------------------------------------------------------ slots

static __device__ __forceinline__ bool slot_is_zero(const fp *S, int k) {
  fp x;
  slot_load(x, S, k);
  return fp_is_zero(x);
}

static __device__ __forceinline__ bool slots_equal(const fp *S, int a, int b) {
  fp x, y;
  slot_load(x, S, a);
  slot_load(y, S, b);
  uint32_t d = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) d |= x.v[i] ^ y.v[i];
  return d == 0;
}

static __device__ __forceinline__ void slot_set(fp *S, int k, bool one) {
  fp x;
  if (one)
    fp_set_one(x);
  else
    fp_set_zero(x);
  slot_store(S, k, x);
}

// lanes copy n slots from Ssrc into S, then the team syncs
static __device__ __forceinline__ void team_copy(fp *S, int dst, const fp *Ssrc, int src, int n,
                                                 const team &tm) {
  for (int k = tm.lane; k < n; k += tm.nl) {
    fp x;
    slot_load(x, Ssrc, src + k);
    slot_store(S, dst + k, x);
  }
  team_sync(tm);
}

// ------------------------------------------------------------ register teams
//
// An Fq2 value in the registers of every lane of a team, for chains of
// Fq2 steps with no more than three products each: a level gives one Fq
// product to each of the first lanes (every lane runs the same fp_mul on
// operands it selects, so none diverges) and shares the results by warp
// shuffles, with no shared memory and no table.

// r = x of the team's lane src, in every lane
static __device__ __forceinline__ void team_bcast(fp &r, const fp &x, int src, const team &tm) {
  const int lane = __ffs(tm.mask) - 1 + src;
#pragma unroll
  for (int w = 0; w < 12; w++) r.v[w] = __shfl_sync(tm.mask, x.v[w], lane);
}

static __device__ __forceinline__ void fp_select(fp &r, bool c, const fp &a, const fp &b) {
#pragma unroll
  for (int w = 0; w < 12; w++) r.v[w] = c ? a.v[w] : b.v[w];
}

// (a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u: lane 0 the first
// product, lane 1 the second
static __device__ __forceinline__ void team_fp2_sqr(fp &a0, fp &a1, const team &tm) {
  fp s, d, x, y, r, r2;
  fp_add(s, a0, a1);
  fp_sub(d, a0, a1);
  fp_select(x, tm.lane == 0, s, a0);
  fp_select(y, tm.lane == 0, d, a1);
  fp_mul(r, x, y);
  fp_add(r2, r, r);
  team_bcast(a0, r, 0, tm);
  team_bcast(a1, r2, 1, tm);
}

// a b by Karatsuba: lanes 0, 1, 2 take a0 b0, a1 b1, (a0 + a1)(b0 + b1)
static __device__ __forceinline__ void team_fp2_mul(fp &a0, fp &a1, const fp &b0, const fp &b1,
                                                    const team &tm) {
  fp sa, sb, x, y, r, t0, t1, t2;
  fp_add(sa, a0, a1);
  fp_add(sb, b0, b1);
  fp_select(x, tm.lane == 0, a0, a1);
  fp_select(x, tm.lane >= 2, sa, x);
  fp_select(y, tm.lane == 0, b0, b1);
  fp_select(y, tm.lane >= 2, sb, y);
  fp_mul(r, x, y);
  team_bcast(t0, r, 0, tm);
  team_bcast(t1, r, 1, tm);
  team_bcast(t2, r, 2, tm);
  fp_sub(a0, t0, t1);
  fp_sub(a1, t2, t0);
  fp_sub(a1, a1, t1);
}

// ------------------------------------------------------------ points
//
// A point area of a TG1/TG2 state is NC slots (X, Y, Z; for G2 each as its
// two Fq components): the accumulators A (area 0) and B (area 1), the
// operand P (area 2), then jac_add's H and R (NC / 3 slots each).

template <int NC>
struct team_group;

// the tables and program ids of a group: dbl(a), add(a) from area a
template <>
struct team_group<3> {
  typedef TG1_tables tables;
  static constexpr int slots = TG1_SLOTS;
  static __device__ __forceinline__ int dbl(int a) { return a ? TG1_DBL_BA : TG1_DBL_AB; }
  static __device__ __forceinline__ int add(int a) { return a ? TG1_ADD_BA : TG1_ADD_AB; }
};

template <>
struct team_group<6> {
  typedef TG2_tables tables;
  static constexpr int slots = TG2_SLOTS;
  static __device__ __forceinline__ int dbl(int a) { return a ? TG2_DBL_BA : TG2_DBL_AB; }
  static __device__ __forceinline__ int add(int a) { return a ? TG2_ADD_BA : TG2_ADD_AB; }
};

static_assert(TG1_S_B_X == 3 && TG1_S_P_X == 6 && TG1_S_H == 9 && TG1_S_R == 10,
              "team.cuh's G1 areas are team.point_state('g1')");
static_assert(TG2_S_B_X0 == 6 && TG2_S_P_X0 == 12 && TG2_S_H0 == 18 && TG2_S_R0 == 20 &&
                  TG2_S_CX0 == 22,
              "team.cuh's G2 areas are team.point_state('g2')");

template <int NC>
static __device__ __forceinline__ bool team_is_identity(const fp *S, int area) {
  bool z = true;
#pragma unroll
  for (int k = 2 * NC / 3; k < NC; k++) z = z && slot_is_zero(S, area * NC + k);
  return z;
}

// the identity (1, 1, 0) into an area (lanes), then a team sync
template <int NC>
static __device__ __forceinline__ void team_set_identity(fp *S, int area, const team &tm) {
  for (int k = tm.lane; k < NC; k += tm.nl) slot_set(S, area * NC + k, k == 0 || k == NC / 3);
  team_sync(tm);
}

// 2 acc, acc in area a; returns the area of the result
template <int NC>
static __device__ __forceinline__ int team_dbl(const typename team_group<NC>::tables &T, fp *S,
                                               int a, const team &tm) {
  T.run(S, team_group<NC>::dbl(a), tm);
  return a ^ 1;
}

// acc + P, acc in area a, curve_ops.jac_add's cases in its priority order;
// returns the area of the result
template <int NC>
static __device__ __forceinline__ int team_add(const typename team_group<NC>::tables &T, fp *S,
                                               int a, const team &tm) {
  if (team_is_identity<NC>(S, 2)) return a;    // p2 = O: p1
  if (team_is_identity<NC>(S, a)) {            // p1 = O: p2
    team_sync(tm);                             // every lane has read Z before it changes
    team_copy(S, a * NC, S, 2 * NC, NC, tm);
    return a;
  }
  T.run(S, team_group<NC>::add(a), tm);
  bool h = true, r = true;
#pragma unroll
  for (int k = 0; k < NC / 3; k++) {
    h = h && slot_is_zero(S, 3 * NC + k);
    r = r && slot_is_zero(S, 3 * NC + NC / 3 + k);
  }
  if (h) {
    if (r)
      T.run(S, team_group<NC>::dbl(a), tm);    // p1 == p2: the doubling of p1
    else
      team_set_identity<NC>(S, a ^ 1, tm);     // p1 == -p2
  }
  return a ^ 1;
}

// P * k, k as nbits 0/1 words MSB first: per bit a doubling and, on a set
// bit, an add, from the identity (curve_ops.scalar_mul_bits, with the add
// taken only where the reference selects it); returns the result's area
template <int NC>
static __device__ __forceinline__ int team_scalar_mul(const typename team_group<NC>::tables &T,
                                                      fp *S, const int32_t *bits, int nbits,
                                                      const team &tm) {
  team_set_identity<NC>(S, 0, tm);
  int a = 0;
  for (int i = 0; i < nbits; i++) {
    a = team_dbl<NC>(T, S, a, tm);
    if (bits[i] == 1) a = team_add<NC>(T, S, a, tm);
  }
  return a;
}
