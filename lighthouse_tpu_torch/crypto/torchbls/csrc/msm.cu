// The G1 multi-scalar multiplication's three device programs on the card.
//
// Replaces the XLA programs of lighthouse_tpu/crypto/jaxbls/msm.py, which
// have no Pallas form:
//   msm_precompute  _precompute_kernel (:134): standard-form affine points
//                   -> Montgomery Jacobian comb tables T[j][i] =
//                   2^(16 j) P_i, row j written before its 16 doublings, as
//                   the scan emits it; a team of JOIN_LANES lanes per point;
//   msm_fixed       _msm_kernel (:157): sum_l c_l T_l over the comb lanes l
//                   with 16-bit chunks c_l, its affine form in standard
//                   form and the infinity flag;
//   msm_varying     varying_base_msm_kernel (:99): sum_i s_i P_i over
//                   standard-form affine points with 256-bit scalars given
//                   as MSB-first digits at any width msm.msm_window()
//                   allows (0, 2, 4, 5, 6), masked lanes adding nothing.
//
// Both sums return affine coordinates, which are unique (every identity
// the formulas make is (one, one, zero), which doubling keeps), so they may
// be taken in any order and still equal the plain versions' bits. They are
// bound on this card by the depth of dependent point operations, not by
// bytes or by the card's multiply rate, so each is a short tree of point
// sums spread over many threads, one point operation a thread, and a
// serial tail (the join) on teams of threads:
//
// msm_fixed, by buckets (Pippenger). Each 16-bit chunk is two 8-bit
// windows; a lane whose table point is the identity, or whose window digit
// is 0, adds nothing there. msm_hist_kernel counts the lanes of each of
// the 2 x 255 buckets (window, digit) and msm_scatter_kernel sorts the
// lane indices by bucket (a counting sort: a scan of the counts, then
// atomic cursors, so the order inside a bucket is arbitrary). Then
// msm_level_kernel sums every bucket as a tree over its sorted lanes: at
// each level a worker thread adds up to LANE_FAN entries of one bucket, the
// workers of all buckets laid out by a scan of their counts, so a bucket of
// any size takes log4 of its size levels. The weights: sum_k k B_k =
// sum_b 2^b S_b with S_b the sum of the 128 buckets whose digit has bit b
// set, 16 trees (two windows x 8 bits) on the same level kernel; the low
// window's S_b weighs 2^b and the high window's 2^(b + 8). msm_join_kernel
// sums the 16 weighted terms as a tree whose level l doubles its upper
// half 2^(l - 1) times (15 doublings and 4 additions deep), a team of
// JOIN_LANES threads per pair spreading each step's Fq products over its
// lanes, then converts to affine with one fp_inv and a product by 1 (out
// of Montgomery form).
// Work: ~16 Fq products per lane and window where the comb's per-lane
// double-and-add did ~225 a lane.
//
// msm_varying, by the GLV split and bit windows. msm_recode_kernel (a
// thread per point) rebuilds each scalar from its digits at their width,
// reduced mod r bit by bit, and splits it as k = k2 lambda + k1 with
// lambda = x^2 - 1 (lambda^2 + lambda + 1 = r, so k1 < lambda and k2 <=
// lambda + 1, both below 2^128): k P = k1 P + k2 phi(P), phi(x, y) =
// (beta x, y). Each of the 128 bit windows sums the slots (P_i, phi(P_i))
// whose half-scalar has that bit set, as a tree on the level kernel, and
// msm_join_kernel joins the windows: 127 doublings and 7 additions deep,
// where a chain per point is ~256 doublings and ~64 additions. A digit
// outside [0, 2^w) (16 at w = 0) is never used: the recode flags it, and
// the sum comes back as x = y = 2^384 - 1, which no standard-form
// coordinate is, so the host's read of it (msm.affine_result) refuses it.
//
// msm_precompute, by teams. Its one chain is 240 doublings a point, which
// no shorter chain may replace (the tables are Jacobian, bit for bit), so
// each point runs on a team of JOIN_LANES lanes that takes a doubling's
// products in the join's three rounds, and the teams spread over the card
// (PRE_TEAMS a block: 4096 points are 128 blocks); lane k < 3 stores
// coordinate k of each row.
//
// The point formulas are curve_ops' jac_double and its complete jac_add
// (the identity on either side, P == Q takes the doubling, P == -Q gives
// the identity (one, one, zero)), inline, one thread each or a team;
// points between kernels sit in global scratch as 36 32-bit words, and no
// kernel keeps a point table. The interchange layout (24 16-bit limbs in int64) is
// repacked to 12 32-bit words at the boundary (fq.cuh).
// tests/test_torch_msm_schedule.py restates every index map here in
// Python and holds it against the curve.
#include "fq.cuh"

#define MSM_THREADS 128      // threads of every block but the join's
#define JOIN_TEAMS 64        // msm_join_kernel's teams: up to 128 terms
#define JOIN_LANES 4         // threads of a team: products of a round
#define PRE_TEAMS (MSM_THREADS / JOIN_LANES)   // msm_precompute_kernel's teams a block
#define CHUNK_BITS 16        // bits of a comb chunk (msm.py CHUNK_BITS)
#define N_CHUNKS 16          // comb rows (msm.py N_CHUNKS)
#define WINDOW_BITS 8        // msm_fixed: a chunk is two 8-bit windows
#define BUCKETS 255          // digits 1..255 of a window (0 adds nothing)
#define FIXED_GROUPS (2 * BUCKETS)
#define MAX_GROUPS 512       // groups a level kernel's block scans
#define LANE_FAN 4           // entries a worker adds at msm_fixed's bucket levels
#define TREE_FAN 2           // ... at the bit sums' and the windows' levels
#define BIT_TERMS (2 * WINDOW_BITS)   // msm_fixed's weighted terms S_b
#define GLV_BITS 128         // bits of each half of msm_varying's split

struct g1 {
  fp x, y, z;
};

#define G1_WORDS 36          // a g1 in scratch: three Fq elements of 12 words

static __device__ __forceinline__ void g1_set_identity(g1 &r) {
  fp_set_one(r.x);
  fp_set_one(r.y);
  fp_set_zero(r.z);
}

// r = k a for a small constant k, by additions (any method gives the same
// fully reduced value as curve_ops' mul_small)
static __device__ __forceinline__ void fp_x2(fp &r, const fp &a) { fp_add(r, a, a); }

// curve_ops.jac_double: A = X^2, B = Y^2, C = B^2, E = 3A, D = 2((X + B)^2
// - A - C), X3 = E^2 - 2D, Y3 = E(D - X3) - 8C, Z3 = 2YZ. The identity
// (Z = 0) stays Z = 0, and (one, one, zero) maps to itself. r may be p.
static __device__ __forceinline__ void g1_dbl(g1 &r, const g1 &p) {
  fp A, B, YZ, E, XB, C, t, F, D, X3, Y3;
  fp_mul(A, p.x, p.x);
  fp_mul(B, p.y, p.y);
  fp_mul(YZ, p.y, p.z);
  fp_x2(E, A);
  fp_add(E, E, A);
  fp_add(XB, p.x, B);
  fp_mul(C, B, B);
  fp_mul(t, XB, XB);
  fp_mul(F, E, E);
  fp_sub(D, t, A);
  fp_sub(D, D, C);
  fp_x2(D, D);
  fp_x2(t, D);
  fp_sub(X3, F, t);
  fp_sub(t, D, X3);
  fp_mul(Y3, E, t);
  fp_x2(C, C);
  fp_x2(C, C);
  fp_x2(C, C);
  fp_sub(r.y, Y3, C);
  fp_x2(r.z, YZ);
  r.x = X3;
}

// curve_ops.jac_add, complete: p when q is the identity, q when p is; the
// doubling of p when H == r == 0 (P == Q), the identity (one, one, zero)
// when H == 0 != r (P == -Q); else the general sum, U1 = X1 Z2^2, U2 = X2
// Z1^2, S1 = Y1 Z2^3, S2 = Y2 Z1^3, H = U2 - U1, r = S2 - S1, X3 = r^2 -
// H^3 - 2 U1 H^2, Y3 = r (U1 H^2 - X3) - S1 H^3, Z3 = Z1 Z2 H. Only the
// branch taken is computed; each gives the select's value. r may be p or q.
static __device__ __forceinline__ void g1_add(g1 &r, const g1 &p, const g1 &q) {
  if (fp_is_zero(q.z)) {
    r = p;
    return;
  }
  if (fp_is_zero(p.z)) {
    r = q;
    return;
  }
  fp Z1Z1, Z2Z2, U1, U2, S1, S2, H, R, t;
  fp_mul(Z1Z1, p.z, p.z);
  fp_mul(Z2Z2, q.z, q.z);
  fp_mul(U1, p.x, Z2Z2);
  fp_mul(U2, q.x, Z1Z1);
  fp_mul(t, p.y, q.z);
  fp_mul(S1, t, Z2Z2);
  fp_mul(t, q.y, p.z);
  fp_mul(S2, t, Z1Z1);
  fp_sub(H, U2, U1);
  fp_sub(R, S2, S1);
  if (fp_is_zero(H)) {
    if (fp_is_zero(R))
      g1_dbl(r, p);
    else
      g1_set_identity(r);
    return;
  }
  fp HH, HHH, V, X3, Y3, Z3;
  fp_mul(HH, H, H);
  fp_mul(HHH, H, HH);
  fp_mul(V, U1, HH);
  fp_mul(t, R, R);
  fp_sub(X3, t, HHH);
  fp_x2(t, V);
  fp_sub(X3, X3, t);
  fp_sub(t, V, X3);
  fp_mul(Y3, R, t);
  fp_mul(t, S1, HHH);
  fp_sub(Y3, Y3, t);
  fp_mul(t, p.z, q.z);
  fp_mul(Z3, t, H);
  r.x = X3;
  r.y = Y3;
  r.z = Z3;
}

// a standard-form affine point -> Montgomery Jacobian, Z = 0 where inf
static __device__ __forceinline__ void g1_load_affine(g1 &p, const int64_t *x, const int64_t *y,
                                                      bool inf) {
  fp a;
  fp_load(a, x);
  fp_to_mont(p.x, a);
  fp_load(a, y);
  fp_to_mont(p.y, a);
  if (inf)
    fp_set_zero(p.z);
  else
    fp_set_one(p.z);
}

static __device__ __forceinline__ void g1_store_words(uint32_t *dst, const g1 &p) {
#pragma unroll
  for (int k = 0; k < 12; k++) {
    dst[k] = p.x.v[k];
    dst[12 + k] = p.y.v[k];
    dst[24 + k] = p.z.v[k];
  }
}

static __device__ __forceinline__ void g1_load_words(g1 &p, const uint32_t *src) {
#pragma unroll
  for (int k = 0; k < 12; k++) {
    p.x.v[k] = src[k];
    p.y.v[k] = src[12 + k];
    p.z.v[k] = src[24 + k];
  }
}

// ------------------------------------------------------------ teams
//
// The serial chains of both sums' join and of the precompute run on teams
// of JOIN_LANES consecutive lanes of one warp: a point step runs as rounds
// of up to JOIN_LANES independent Fq products, lane k taking product k, the
// products exchanged through shared memory between barriers of the warp (a
// team never spans warps; a barrier of the team's lanes alone would leave
// a warp's teams diverged, their rounds issued one team after another); a
// doubling 3 rounds, an addition 5, plus 3 rounds kept for the P == Q
// doubling. Every team of a block takes every round, so the barriers are
// uniform; a team with no work in a round computes nothing there. Every
// lane of a team holds the team's points. The exchange is indexed by the
// block's array and the team at every round, as the shared array itself:
// handing each team a pointer to its own slice made the join ~35 % slower.

struct join_team {
  int team, lane, parity;
  fp (*xch)[JOIN_TEAMS][JOIN_LANES];   // two buffers of each round's products
};

static __device__ __forceinline__ void fp_pick(fp &r, int k, const fp &a0, const fp &a1,
                                               const fp &a2, const fp &a3) {
#pragma unroll
  for (int w = 0; w < 12; w++)
    r.v[w] = k == 0 ? a0.v[w] : k == 1 ? a1.v[w] : k == 2 ? a2.v[w] : a3.v[w];
}

// one round: lane k < n of a working team computes its own a b, then the
// warp's barrier; returns the team's products of the round (the buffers
// alternate, so a round's writes never meet the reads of the one before)
static __device__ __forceinline__ const fp *join_round(join_team &tm, const fp &a, const fp &b,
                                                       int n, bool work) {
  fp *out = tm.xch[tm.parity][tm.team];
  if (work && tm.lane < n) fp_mul(out[tm.lane], a, b);
  __syncwarp();
  tm.parity ^= 1;
  return out;
}

// p = 2 p where work: g1_dbl's products in three rounds
static __device__ __forceinline__ void join_dbl(join_team &tm, g1 &p, bool work) {
  fp a, b, A, B, YZ, E, XB, C, t, D, X3;
  fp_pick(a, tm.lane, p.x, p.y, p.y, p.y);
  fp_pick(b, tm.lane, p.x, p.y, p.z, p.z);
  const fp *r = join_round(tm, a, b, 3, work);   // X^2, Y^2, Y Z
  A = r[0];
  B = r[1];
  YZ = r[2];
  fp_x2(E, A);
  fp_add(E, E, A);
  fp_add(XB, p.x, B);
  fp_pick(a, tm.lane, B, XB, E, E);
  r = join_round(tm, a, a, 3, work);             // B^2, (X + B)^2, E^2
  C = r[0];
  fp_sub(D, r[1], A);
  fp_sub(D, D, C);
  fp_x2(D, D);
  fp_x2(t, D);
  fp_sub(X3, r[2], t);
  fp_sub(t, D, X3);
  r = join_round(tm, E, t, 1, work);             // E (D - X3)
  if (!work) return;
  fp_x2(C, C);
  fp_x2(C, C);
  fp_x2(C, C);
  fp_sub(p.y, r[0], C);
  fp_x2(p.z, YZ);
  p.x = X3;
}

// p = p + q where work, with g1_add's cases: its products in five rounds,
// then three rounds that double p where P == Q
static __device__ __forceinline__ void join_add(join_team &tm, g1 &p, const g1 &q, bool work) {
  const bool q_inf = fp_is_zero(q.z), p_inf = fp_is_zero(p.z);
  const bool both = work && !q_inf && !p_inf;
  fp a, b, U1, S1, H, R, RR, HH, HHH, V, Z3, X3;
  fp_pick(a, tm.lane, p.z, q.z, p.y, q.y);
  fp_pick(b, tm.lane, p.z, q.z, q.z, p.z);
  const fp *r = join_round(tm, a, b, 4, both);   // Z1^2, Z2^2, Y1 Z2, Y2 Z1
  fp_pick(a, tm.lane, p.x, q.x, r[2], r[3]);
  fp_pick(b, tm.lane, r[1], r[0], r[1], r[0]);
  r = join_round(tm, a, b, 4, both);             // U1, U2, S1 = Y1 Z2^3, S2
  U1 = r[0];
  S1 = r[2];
  fp_sub(H, r[1], U1);
  fp_sub(R, r[3], S1);
  const bool h0 = fp_is_zero(H), r0 = fp_is_zero(R);
  const bool general = both && !h0;
  fp_pick(a, tm.lane, p.z, H, R, R);
  fp_pick(b, tm.lane, q.z, H, R, R);
  r = join_round(tm, a, b, 3, general);          // Z1 Z2, H^2, R^2
  HH = r[1];
  RR = r[2];
  fp_pick(a, tm.lane, H, U1, r[0], r[0]);
  fp_pick(b, tm.lane, HH, HH, H, H);
  r = join_round(tm, a, b, 3, general);          // H^3, V = U1 H^2, Z3 = Z1 Z2 H
  HHH = r[0];
  V = r[1];
  Z3 = r[2];
  fp_sub(X3, RR, HHH);
  fp_x2(a, V);
  fp_sub(X3, X3, a);
  fp_sub(a, V, X3);
  fp_pick(a, tm.lane, a, S1, S1, S1);
  fp_pick(b, tm.lane, R, HHH, HHH, HHH);
  r = join_round(tm, a, b, 2, general);          // R (V - X3), S1 H^3
  fp_sub(b, r[0], r[1]);
  join_dbl(tm, p, both && h0 && r0);             // P == Q: the doubling of p
  if (!work || q_inf) return;
  if (p_inf) {
    p = q;
  } else if (general) {
    p.x = X3;
    p.y = b;
    p.z = Z3;
  } else if (!r0) {
    g1_set_identity(p);                          // P == -Q
  }
}

// ------------------------------------------------------------ precompute

// team t of block b takes point i = b PRE_TEAMS + t: its 16 rows, each
// stored before its 16 doublings, lane k < 3 storing coordinate k of row
// j at lane j n + i; the teams past n (in the last block) take the rounds
// with no work, so every warp meets its barriers whole
__global__ void __launch_bounds__(MSM_THREADS)
    msm_precompute_kernel(const int64_t *px, const int64_t *py, const int32_t *inf, int n,
                          int64_t *tx, int64_t *ty, int64_t *tz) {
  __shared__ fp xch[2][JOIN_TEAMS][JOIN_LANES];   // PRE_TEAMS of the JOIN_TEAMS used
  join_team tm{(int)threadIdx.x / JOIN_LANES, (int)threadIdx.x % JOIN_LANES, 0, xch};
  const int i = blockIdx.x * PRE_TEAMS + tm.team;
  const bool live = i < n;
  g1 p;
  g1_set_identity(p);
  if (live) g1_load_affine(p, px + 24 * (size_t)i, py + 24 * (size_t)i, inf[i] != 0);
  int64_t *dst = tm.lane == 0 ? tx : tm.lane == 1 ? ty : tz;
#pragma unroll 1
  for (int j = 0; j < N_CHUNKS; j++) {
    if (live && tm.lane < 3) {
      fp c;
      fp_pick(c, tm.lane, p.x, p.y, p.z, p.z);
      fp_store(dst + 24 * ((size_t)j * n + i), c);
    }
    if (j + 1 < N_CHUNKS) {
#pragma unroll 1
      for (int k = 0; k < CHUNK_BITS; k++) join_dbl(tm, p, live);
    }
  }
}

// ------------------------------------------------------------ bucket sort

// exclusive prefix sums of v[0..n) in place (n <= MAX_GROUPS), the total
// in v[n]; every thread of a block of MSM_THREADS calls it
static __device__ void block_scan(uint32_t *v, int n, uint32_t *part) {
  const int t = threadIdx.x, per = (n + MSM_THREADS - 1) / MSM_THREADS;
  const int lo = min(n, t * per), hi = min(n, lo + per);
  uint32_t s = 0;
  for (int k = lo; k < hi; k++) s += v[k];
  part[t] = s;
  __syncthreads();
  for (int d = 1; d < MSM_THREADS; d <<= 1) {
    const uint32_t a = t >= d ? part[t - d] : 0;
    __syncthreads();
    part[t] += a;
    __syncthreads();
  }
  uint32_t run = part[t] - s;
  for (int k = lo; k < hi; k++) {
    const uint32_t c = v[k];
    v[k] = run;
    run += c;
  }
  if (t == MSM_THREADS - 1) v[n] = part[t];
  __syncthreads();
}

// per lane its chunk's two window digits as bucket groups (window w, digit
// d: group w BUCKETS + d - 1), packed one plus each group in 16 bits of
// keys[l], 0 where the digit is 0 or the table point the identity; the
// lanes of each group counted into counts
__global__ void __launch_bounds__(MSM_THREADS)
    msm_hist_kernel(const int64_t *tz, const int32_t *bits, int lanes, uint32_t *keys,
                    uint32_t *counts) {
  __shared__ uint32_t hist[FIXED_GROUPS];
  for (int g = threadIdx.x; g < FIXED_GROUPS; g += MSM_THREADS) hist[g] = 0;
  __syncthreads();
  const int l = blockIdx.x * MSM_THREADS + threadIdx.x;
  if (l < lanes) {
    const int32_t *b = bits + (size_t)l * CHUNK_BITS;
    uint32_t chunk = 0;
#pragma unroll
    for (int k = 0; k < CHUNK_BITS; k++) chunk = chunk << 1 | (b[k] != 0);   // MSB first
    fp z;
    fp_load(z, tz + 24 * (size_t)l);
    if (fp_is_zero(z)) chunk = 0;
    uint32_t key = 0;
#pragma unroll
    for (int w = 0; w < 2; w++) {
      const uint32_t d = chunk >> (WINDOW_BITS * w) & 0xFF;
      if (d) {
        const uint32_t g = w * BUCKETS + d - 1;
        atomicAdd(&hist[g], 1u);
        key |= (g + 1) << (16 * w);
      }
    }
    keys[l] = key;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < FIXED_GROUPS; g += MSM_THREADS)
    if (hist[g]) atomicAdd(&counts[g], hist[g]);
}

// order: the lane of every (lane, window) entry, grouped by bucket in group
// order (a scan of counts), each bucket's entries in arbitrary order
__global__ void __launch_bounds__(MSM_THREADS)
    msm_scatter_kernel(const uint32_t *keys, int lanes, const uint32_t *counts, uint32_t *cursor,
                       uint32_t *order) {
  __shared__ uint32_t off[MAX_GROUPS + 1], part[MSM_THREADS];
  for (int g = threadIdx.x; g < FIXED_GROUPS; g += MSM_THREADS) off[g] = counts[g];
  __syncthreads();
  block_scan(off, FIXED_GROUPS, part);
  const int l = blockIdx.x * MSM_THREADS + threadIdx.x;
  if (l >= lanes) return;
  const uint32_t key = keys[l];
#pragma unroll
  for (int w = 0; w < 2; w++) {
    const uint32_t g1p = key >> (16 * w) & 0xFFFF;
    if (g1p) order[off[g1p - 1] + atomicAdd(&cursor[g1p - 1], 1u)] = l;
  }
}

// ------------------------------------------------------------ group sums

// where a level's entries come from: the previous level's sums (WORDS) or,
// at level 0, msm_fixed's sorted table lanes (TABLES), its bucket sums by
// bit (BUCKETS: entry e of group (w, b) is the bucket of the e-th digit
// with bit b set), or msm_varying's slots (SLOTS: slot e in group j where
// bit j of its half-scalar is set, else the identity)
enum { SRC_WORDS, SRC_TABLES, SRC_BUCKETS, SRC_SLOTS };

struct level_in {
  int src;
  const uint32_t *pts;                // points of G1_WORDS: WORDS, BUCKETS, SLOTS
  const int64_t *tx, *ty, *tz;        // TABLES
  const uint32_t *order;              // TABLES: the lane of each sorted entry
  const uint32_t *scalars;            // SLOTS: 4 words a slot
};

// entry e of group g, at position pos of the level's entries
static __device__ __forceinline__ void level_entry(g1 &p, const level_in &in, int g,
                                                   uint32_t pos, uint32_t e) {
  if (in.src == SRC_TABLES) {
    const size_t l = in.order[pos];
    fp_load(p.x, in.tx + 24 * l);
    fp_load(p.y, in.ty + 24 * l);
    fp_load(p.z, in.tz + 24 * l);
  } else if (in.src == SRC_BUCKETS) {
    const uint32_t w = g / WINDOW_BITS, b = g % WINDOW_BITS;
    const uint32_t d = (e >> b) << (b + 1) | 1u << b | (e & ((1u << b) - 1));
    g1_load_words(p, in.pts + (size_t)(w * BUCKETS + d - 1) * G1_WORDS);
  } else if (in.src == SRC_SLOTS) {
    if (in.scalars[4 * (size_t)e + g / 32] >> (g % 32) & 1)
      g1_load_words(p, in.pts + (size_t)e * G1_WORDS);
    else
      g1_set_identity(p);
  } else {
    g1_load_words(p, in.pts + (size_t)pos * G1_WORDS);
  }
}

// One level of the groups' trees. Group g has n_g entries at level 0
// (counts[g], or fixed_count for every group) and max(1, ceil(n / fan))
// at each later level; worker t of group g adds the group's entries fan t
// .. fan t + fan - 1 of this level (none: the identity) into out at the
// group's next-level offset plus t. Entry and worker offsets are scans of
// those counts, which every block recomputes; a worker finds its group by
// a binary search of the worker offsets.
__global__ void __launch_bounds__(MSM_THREADS)
    msm_level_kernel(level_in in, const uint32_t *counts, uint32_t fixed_count, int groups,
                     int level, int fan, uint32_t *out) {
  __shared__ uint32_t eo[MAX_GROUPS + 1], wo[MAX_GROUPS + 1], part[MSM_THREADS];
  for (int g = threadIdx.x; g < groups; g += MSM_THREADS) {
    uint32_t c = counts ? counts[g] : fixed_count;
    for (int h = 0; h < level; h++) c = max(1u, (c + fan - 1) / fan);
    eo[g] = c;
    wo[g] = max(1u, (c + fan - 1) / fan);
  }
  __syncthreads();
  block_scan(eo, groups, part);
  block_scan(wo, groups, part);
  const uint32_t w = blockIdx.x * MSM_THREADS + threadIdx.x;
  if (w >= wo[groups]) return;
  int lo = 0, hi = groups - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (wo[mid] <= w)
      lo = mid;
    else
      hi = mid - 1;
  }
  const int g = lo;
  const uint32_t n = eo[g + 1] - eo[g], begin = (w - wo[g]) * fan;
  const uint32_t end = min(n, begin + fan);
  g1 acc;
  g1_set_identity(acc);
#pragma unroll 1
  for (uint32_t e = begin; e < end; e++) {
    g1 p;
    level_entry(p, in, g, eo[g] + e, e);
    g1_add(acc, acc, p);
  }
  g1_store_words(out + (size_t)w * G1_WORDS, acc);
}

// ------------------------------------------------------------ join, affine

// sum_j 2^j X_j over `count` points X (a power of two, at most 2
// JOIN_TEAMS) in one block of count / 2 teams: level l adds to each pair's
// lower term its upper term doubled 2^(l - 1) times (an identity is not
// doubled: it stays (one, one, zero)); then curve_ops.jac_to_affine (Z^-1
// of 1 for the identity, which keeps its X and Y) and the product by 1 out
// of Montgomery form, one thread. A refused flag set gives x = y =
// 2^384 - 1 and no identity.
__global__ void __launch_bounds__(JOIN_TEAMS * JOIN_LANES)
    msm_join_kernel(const uint32_t *pts, int count, const uint32_t *refused, int64_t *x,
                    int64_t *y, int32_t *inf) {
  __shared__ fp xch[2][JOIN_TEAMS][JOIN_LANES];
  __shared__ g1 sh[JOIN_TEAMS];
  join_team tm{(int)threadIdx.x / JOIN_LANES, (int)threadIdx.x % JOIN_LANES, 0, xch};
  g1 acc;
  if (count == 1) g1_load_words(acc, pts);
  int span = 1;
#pragma unroll 1
  for (int m = count / 2; m >= 1; m /= 2, span *= 2) {
    const bool on = tm.team < m;
    g1 a, b;
    g1_set_identity(a);
    b = a;
    if (on) {
      if (span == 1) {
        g1_load_words(a, pts + (size_t)(2 * tm.team) * G1_WORDS);
        g1_load_words(b, pts + (size_t)(2 * tm.team + 1) * G1_WORDS);
      } else {
        a = sh[2 * tm.team];
        b = sh[2 * tm.team + 1];
      }
    }
    const bool b_on = on && !fp_is_zero(b.z);
#pragma unroll 1
    for (int k = 0; k < span; k++) join_dbl(tm, b, b_on);
    join_add(tm, a, b, on);
    __syncthreads();                             // every team has read sh
    if (on && tm.lane == 0) sh[tm.team] = a;
    __syncthreads();
    acc = a;
  }
  if (threadIdx.x != 0) return;
  if (refused && *refused) {
    for (int k = 0; k < 24; k++) x[k] = y[k] = 0xffff;
    inf[0] = 0;
    return;
  }
  const bool is_inf = fp_is_zero(acc.z);
  fp z = acc.z, zi, zi2, zi3, ax, ay, one;
  if (is_inf) fp_set_one(z);
  fp_inv(zi, z);
  fp_mul(zi2, zi, zi);
  fp_mul(zi3, zi2, zi);
  fp_mul(ax, acc.x, zi2);
  fp_mul(ay, acc.y, zi3);
  fp_set_zero(one);
  one.v[0] = 1;
  fp_mul(ax, ax, one);
  fp_mul(ay, ay, one);
  fp_store(x, ax);
  fp_store(y, ay);
  inf[0] = is_inf;
}

// ------------------------------------------------------------ GLV recode

// k = 2 k + bit mod r for k < r (r < 2^255, so 2k + 1 fits 8 words)
static __device__ __forceinline__ void fr_shift_in(uint32_t *k, uint32_t bit) {
  uint32_t c = bit, d[8];
#pragma unroll
  for (int j = 0; j < 8; j++) {
    const uint32_t top = k[j] >> 31;
    k[j] = k[j] << 1 | c;
    c = top;
  }
  d[0] = sub_cc(k[0], FR_R[0]);
#pragma unroll
  for (int j = 1; j < 8; j++) d[j] = subc_cc(k[j], FR_R[j]);
  const bool lt = subc(0, 0) != 0;   // k < r
#pragma unroll
  for (int j = 0; j < 8; j++) k[j] = lt ? k[j] : d[j];
}

// k = k2 lambda + k1 with k1 < lambda, for k < r: long division, a bit a
// step (the remainder below 2 lambda < 2^129 in 5 words; k2 < 2^128)
static __device__ __forceinline__ void glv_split(const uint32_t *k, uint32_t *k1, uint32_t *k2) {
  uint32_t rem[5] = {0, 0, 0, 0, 0}, q[8];
#pragma unroll
  for (int j = 7; j >= 0; j--) {
    q[j] = 0;
#pragma unroll 1
    for (int b = 31; b >= 0; b--) {
      uint32_t c = k[j] >> b & 1;
#pragma unroll
      for (int i = 0; i < 5; i++) {
        const uint32_t top = rem[i] >> 31;
        rem[i] = rem[i] << 1 | c;
        c = top;
      }
      uint32_t d[5];
      d[0] = sub_cc(rem[0], GLV_LAMBDA[0]);
#pragma unroll
      for (int i = 1; i < 4; i++) d[i] = subc_cc(rem[i], GLV_LAMBDA[i]);
      d[4] = subc_cc(rem[4], 0);
      const bool lt = subc(0, 0) != 0;   // rem < lambda
#pragma unroll
      for (int i = 0; i < 5; i++) rem[i] = lt ? rem[i] : d[i];
      q[j] |= (uint32_t)!lt << b;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; j++) {
    k1[j] = rem[j];
    k2[j] = q[j];
  }
}

// per point i: its digits (checked against the width's range, live lanes
// only, as the table index of a windowed chain would be) rebuilt into k mod
// r, the GLV split, and two slots: i holds P and k1, n + i holds phi(P) =
// (beta X, Y, Z) and k2; a masked lane's slots are the identity with 0
__global__ void __launch_bounds__(MSM_THREADS)
    msm_recode_kernel(const int64_t *px, const int64_t *py, const int32_t *mask,
                      const int32_t *digits, int n, int nd, int w, uint32_t *slots,
                      uint32_t *scalars, uint32_t *refused) {
  const int i = blockIdx.x * MSM_THREADS + threadIdx.x;
  if (i >= n) return;
  const int width = w ? w : 4;       // w = 0: base-16 digits, expanded to bits
  g1 p, q;
  g1_set_identity(p);
  q = p;
  uint32_t k[8] = {0, 0, 0, 0, 0, 0, 0, 0}, k1[4], k2[4];
  if (mask[i] != 0) {
    const int32_t *d = digits + (size_t)i * nd;
    bool outside = false;
#pragma unroll 1
    for (int j = 0; j < nd && !outside; j++) {
      const uint32_t dj = (uint32_t)d[j];
      outside = dj >= 1u << width;
#pragma unroll 1
      for (int b = width - 1; b >= 0 && !outside; b--) fr_shift_in(k, dj >> b & 1);
    }
    if (outside) atomicOr(refused, 1u);
    g1_load_affine(p, px + 24 * (size_t)i, py + 24 * (size_t)i, false);
    fp beta;
#pragma unroll
    for (int j = 0; j < 12; j++) beta.v[j] = FP_BETA[j];
    q = p;
    fp_mul(q.x, p.x, beta);
  }
  glv_split(k, k1, k2);
  g1_store_words(slots + (size_t)i * G1_WORDS, p);
  g1_store_words(slots + (size_t)(n + i) * G1_WORDS, q);
#pragma unroll
  for (int j = 0; j < 4; j++) {
    scalars[4 * (size_t)i + j] = k1[j];
    scalars[4 * (size_t)(n + i) + j] = k2[j];
  }
}

// ------------------------------------------------------------ host side

static int blocks_for(long long n) { return (int)((n + MSM_THREADS - 1) / MSM_THREADS); }

// levels of fan-`fan` trees that bring a group of `most` entries to one
static int tree_levels(long long most, int fan) {
  int h = 1;
  for (long long c = fan; c < most; c *= fan) h++;
  return h;
}

// points a level's output may need: every group's workers
static long long level_points(int groups, long long entries, int fan) {
  return groups + entries / fan + 1;
}

// `levels` levels of the groups' trees from `in` (level 0) through the
// buffers a and b in turn; returns the buffer whose point g is group g's sum
static uint32_t *run_levels(level_in in, const uint32_t *counts, uint32_t fixed_count, int groups,
                            long long entries, int fan, int levels, uint32_t *a, uint32_t *b,
                            cudaStream_t s, int *err) {
  uint32_t *out = a, *other = b;
  for (int h = 0; h < levels; h++) {
    const long long workers = level_points(groups, entries, fan);
    msm_level_kernel<<<blocks_for(workers), MSM_THREADS, 0, s>>>(in, counts, fixed_count, groups,
                                                                 h, fan, out);
    *err = (int)cudaGetLastError();
    if (*err) return out;
    in = level_in{SRC_WORDS, out, nullptr, nullptr, nullptr, nullptr, nullptr};
    entries = workers;
    uint32_t *t = out;
    out = other;
    other = t;
  }
  return other;
}

// msm_fixed's scratch (32-bit words): the counts and cursors of the
// buckets, a key per lane, the sorted order, two level buffers
static long long fixed_buffer_points(long long lanes) {
  const long long buckets = level_points(FIXED_GROUPS, 2 * lanes, LANE_FAN);
  const long long bits = level_points(BIT_TERMS, BIT_TERMS * 128, TREE_FAN);
  return buckets > bits ? buckets : bits;
}

extern "C" long long lh_msm_fixed_scratch_words(long long lanes) {
  return 2 * MAX_GROUPS + 3 * lanes + 2 * fixed_buffer_points(lanes) * G1_WORDS;
}

// msm_varying's scratch: the refused flag (padded to 4 words), 2n slots'
// points and half-scalars, two level buffers
static long long varying_buffer_points(long long n) {
  return level_points(GLV_BITS, GLV_BITS * 2 * n, TREE_FAN);
}

extern "C" long long lh_msm_varying_scratch_words(long long n) {
  return 4 + 2 * n * (G1_WORDS + 4) + 2 * varying_buffer_points(n) * G1_WORDS;
}

extern "C" int lh_msm_precompute(const void *px, const void *py, const void *inf, int n,
                                 void *tx, void *ty, void *tz, void *stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  msm_precompute_kernel<<<(n + PRE_TEAMS - 1) / PRE_TEAMS, MSM_THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const int64_t *)px, (const int64_t *)py, (const int32_t *)inf, n, (int64_t *)tx,
      (int64_t *)ty, (int64_t *)tz);
  return (int)cudaGetLastError();
}

extern "C" int lh_msm_fixed(const void *tx, const void *ty, const void *tz, const void *bits,
                            int lanes, void *scratch, void *x, void *y, void *inf,
                            void *stream) {
  if (lanes <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t *counts = (uint32_t *)scratch, *cursor = counts + MAX_GROUPS;
  uint32_t *keys = cursor + MAX_GROUPS, *order = keys + lanes;
  uint32_t *a = order + 2 * (size_t)lanes;
  uint32_t *b = a + (size_t)fixed_buffer_points(lanes) * G1_WORDS;
  int err = (int)cudaMemsetAsync(counts, 0, 2 * MAX_GROUPS * sizeof(uint32_t), s);
  if (err) return err;
  msm_hist_kernel<<<blocks_for(lanes), MSM_THREADS, 0, s>>>((const int64_t *)tz,
                                                            (const int32_t *)bits, lanes, keys,
                                                            counts);
  if ((err = (int)cudaGetLastError())) return err;
  msm_scatter_kernel<<<blocks_for(lanes), MSM_THREADS, 0, s>>>(keys, lanes, counts, cursor,
                                                               order);
  if ((err = (int)cudaGetLastError())) return err;
  // the buckets' sums, point g of `sums` for group g
  const level_in tables{SRC_TABLES, nullptr, (const int64_t *)tx, (const int64_t *)ty,
                        (const int64_t *)tz, order, nullptr};
  uint32_t *sums = run_levels(tables, counts, 0, FIXED_GROUPS, 2 * (long long)lanes, LANE_FAN,
                              tree_levels(lanes, LANE_FAN), a, b, s, &err);
  if (err) return err;
  // S_b of each window, term w 8 + b; the first level writes the buffer
  // the bucket sums are not in
  const level_in by_bit{SRC_BUCKETS, sums, nullptr, nullptr, nullptr, nullptr, nullptr};
  uint32_t *free_buf = sums == a ? b : a;
  uint32_t *terms = run_levels(by_bit, nullptr, 128, BIT_TERMS, BIT_TERMS * 128, TREE_FAN,
                               tree_levels(128, TREE_FAN), free_buf, sums, s, &err);
  if (err) return err;
  msm_join_kernel<<<1, BIT_TERMS / 2 * JOIN_LANES, 0, s>>>(
      terms, BIT_TERMS, nullptr, (int64_t *)x, (int64_t *)y, (int32_t *)inf);
  return (int)cudaGetLastError();
}

extern "C" int lh_msm_varying(const void *px, const void *py, const void *mask,
                              const void *digits, int n, int nd, int w, void *scratch, void *x,
                              void *y, void *inf, void *stream) {
  if (n <= 0 || !(w == 0 || w == 2 || w == 4 || w == 5 || w == 6)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t *refused = (uint32_t *)scratch, *slots = refused + 4;
  uint32_t *scalars = slots + 2 * (size_t)n * G1_WORDS;
  uint32_t *a = scalars + 2 * (size_t)n * 4;
  uint32_t *b = a + (size_t)varying_buffer_points(n) * G1_WORDS;
  int err = (int)cudaMemsetAsync(refused, 0, sizeof(uint32_t), s);
  if (err) return err;
  msm_recode_kernel<<<blocks_for(n), MSM_THREADS, 0, s>>>(
      (const int64_t *)px, (const int64_t *)py, (const int32_t *)mask, (const int32_t *)digits, n,
      nd, w, slots, scalars, refused);
  if ((err = (int)cudaGetLastError())) return err;
  const level_in by_bit{SRC_SLOTS, slots, nullptr, nullptr, nullptr, nullptr, scalars};
  uint32_t *windows = run_levels(by_bit, nullptr, 2 * n, GLV_BITS, GLV_BITS * 2 * (long long)n,
                                 TREE_FAN, tree_levels(2 * n, TREE_FAN), a, b, s, &err);
  if (err) return err;
  msm_join_kernel<<<1, GLV_BITS / 2 * JOIN_LANES, 0, s>>>(
      windows, GLV_BITS, refused, (int64_t *)x, (int64_t *)y, (int32_t *)inf);
  return (int)cudaGetLastError();
}
