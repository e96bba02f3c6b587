// stage_prepare: stage 1 of batched verification on the card.
//
// Replaces the Pallas kernel _prepare_kernel
// (lighthouse_tpu/crypto/jaxbls/pallas_ops.py:410, wrapper
// stage_prepare_fused :517), itself the fused form of
// backend._stage_prepare: Montgomery conversion of pubkeys and signatures,
// the per-set halving-tree sum of the masked pubkeys (G1), the `bad` flag
// for an aggregate at infinity, ONE 64-bit double-and-add by z_i of the
// aggregates (G1) and of the signatures (G2), masking of padded sets to the
// identity, and the halving-tree sum of z_i * sig_i (G2).
//
// Bound on this card: the latency of dependent Fq products, not bytes (a
// few hundred KB) and not the card's multiply rate: a set's G2 chain is 64
// doublings and ~32 additions, each a few levels of independent products.
// So every point step runs on a *team* of lanes (team.cuh): each level's Fq
// products spread over the lanes, one per lane, a __syncwarp between levels
// (a G2 doubling 3 levels, an addition 5, each plus the pass that writes the
// result). Three launches:
//   prepare_aggregate  one block per set: its threads convert and mask the
//                      pubkeys, then teams of 16 lanes add the halving
//                      tree's pairs, level by level, in global scratch;
//   prepare_scale      one warp per set and group (blockIdx.y: 0 the G1
//                      aggregate and the bad flag, 1 the G2 signature), so
//                      the chains spread over the SMs; the bits of z are
//                      uniform over a warp, so no lane diverges;
//   prepare_sig_sum    one block: teams add the cross-set G2 tree's pairs.
// The sequence of point operations is the reference's (curve_ops: double
// then add per set bit from the identity, the trees' halving order), and
// every field result is exact, so the outputs equal the plain version's
// bits. There is no size gate: the JAX package kept this kernel off for
// more than 8 pubkeys per set because of Mosaic compile times, which nvcc
// does not pay, so the port launches it at every bucket.
#include "team.cuh"

#define TEAM_LANES 16
#define AGG_TEAMS 16      // teams per prepare_aggregate block
#define SUM_TEAMS 8       // teams of prepare_sig_sum

// a point in global scratch: NC Fq elements
template <int NC>
struct gpoint {
  fp c[NC];
};

static __device__ __forceinline__ team half_warp_team() {
  const int l = threadIdx.x & 31;
  return team{l & 15, TEAM_LANES, 0xFFFFu << (l & 16)};
}

// lanes load a point from global scratch into area `area`, then sync
template <int NC>
static __device__ __forceinline__ void team_load(fp *S, int area, const gpoint<NC> &p,
                                                 const team &tm) {
  for (int k = tm.lane; k < NC; k += tm.nl) slot_store(S, area * NC + k, p.c[k]);
  team_sync(tm);
}

template <int NC>
static __device__ __forceinline__ void team_store(gpoint<NC> &p, const fp *S, int area,
                                                  const team &tm) {
  for (int k = tm.lane; k < NC; k += tm.nl) slot_load(p.c[k], S, area * NC + k);
}

// Halving-tree sum of pts[0..n) into pts[0] by the teams of a block (n a
// power of two): per round, pair i adds pts[i + half] into pts[i], the order
// of curve_ops.tree_sum; S holds each team's state.
template <int NC>
static __device__ __forceinline__ void team_tree_sum(const typename team_group<NC>::tables &T,
                                                     fp *S, gpoint<NC> *pts, int n, int nteams) {
  const team tm = half_warp_team();
  const int id = threadIdx.x / TEAM_LANES;
  fp *St = S + id * team_group<NC>::slots;
  for (int half = n / 2; half >= 1; half /= 2) {
    if (id < nteams) {
      for (int i = id; i < half; i += nteams) {
        team_load<NC>(St, 0, pts[i], tm);
        team_load<NC>(St, 2, pts[i + half], tm);
        const int a = team_add<NC>(T, St, 0, tm);
        team_store<NC>(pts[i], St, a, tm);
        team_sync(tm);
      }
    }
    __syncthreads();
  }
}

// one block per set: convert, mask and tree-sum that set's m pubkeys
__global__ void prepare_aggregate(const int64_t *pk_x, const int64_t *pk_y, const int32_t *pk_mask,
                                  int m, gpoint<3> *pts, gpoint<3> *aggpk) {
  __shared__ TG1_tables T;
  __shared__ __align__(16) fp S[AGG_TEAMS * TG1_SLOTS];
  T.stage(threadIdx.x, blockDim.x);
  const size_t s = blockIdx.x;
  gpoint<3> *Pt = pts + s * m;
  for (int i = threadIdx.x; i < 2 * m; i += blockDim.x) {
    const size_t e = s * m + i / 2;
    fp c;
    fp_load(c, (i & 1 ? pk_y : pk_x) + 24 * e);
    fp_to_mont(Pt[i / 2].c[i & 1], c);
    if (i & 1) {
      if (pk_mask[e])
        fp_set_one(Pt[i / 2].c[2]);
      else
        fp_set_zero(Pt[i / 2].c[2]);
    }
  }
  __syncthreads();
  team_tree_sum<3>(T, S, Pt, m, min(AGG_TEAMS, max(m / 2, 1)));
  if (threadIdx.x == 0) aggpk[s] = Pt[0];
}

// blockIdx.y == 0: z_s * aggpk_s (G1) and the bad flag;
// blockIdx.y == 1: z_s * sig_s (G2), identity for padded sets.
// One warp, one team of 32 lanes (no level is wider than 13 products).
__global__ void __launch_bounds__(32) prepare_scale(const gpoint<3> *aggpk, const int64_t *sig_x,
                                                    const int64_t *sig_y, const int32_t *zbits,
                                                    const int32_t *set_mask, int nbits,
                                                    int64_t *zx, int64_t *zy, int64_t *zz,
                                                    gpoint<6> *zsig, int32_t *bad) {
  __shared__ TG1_tables T1;
  __shared__ TG2_tables T2;
  __shared__ __align__(16) fp S[TG2_SLOTS];
  const int s = blockIdx.x, lane = threadIdx.x;
  const team tm{lane, 32, 0xFFFFFFFFu};
  const int32_t *bits = zbits + (size_t)s * nbits;
  if (blockIdx.y == 0) {
    T1.stage(lane, 32);
    __syncwarp();
    const gpoint<3> &p = aggpk[s];
    if (lane < 3) slot_store(S, 2 * 3 + lane, p.c[lane]);
    if (lane == 0 && set_mask[s] && fp_is_zero(p.c[2])) atomicOr(bad, 1);
    __syncwarp();
    const int a = team_scalar_mul<3>(T1, S, bits, nbits, tm);
    if (lane < 3) {
      fp c;
      slot_load(c, S, 3 * a + lane);
      fp_store((lane == 0 ? zx : lane == 1 ? zy : zz) + 24 * s, c);
    }
  } else {
    T2.stage(lane, 32);
    __syncwarp();
    if (lane < 6) {          // P = (x0, x1, y0, y1, z0, z1)
      fp c;
      if (lane < 4) {
        fp_load(c, (lane < 2 ? sig_x : sig_y) + 48 * s + 24 * (lane & 1));
        fp_to_mont(c, c);
      } else if (lane == 4 && set_mask[s]) {
        fp_set_one(c);
      } else {
        fp_set_zero(c);
      }
      slot_store(S, 2 * 6 + lane, c);
    }
    __syncwarp();
    int a = team_scalar_mul<6>(T2, S, bits, nbits, tm);
    if (!set_mask[s]) {
      team_set_identity<6>(S, a, tm);
    }
    team_store<6>(zsig[s], S, a, tm);
  }
}

// one block: the cross-set halving tree of z_i * sig_i
__global__ void prepare_sig_sum(gpoint<6> *zsig, int n, int64_t *sx, int64_t *sy, int64_t *sz) {
  __shared__ TG2_tables T;
  __shared__ __align__(16) fp S[SUM_TEAMS * TG2_SLOTS];
  T.stage(threadIdx.x, blockDim.x);
  __syncthreads();
  team_tree_sum<6>(T, S, zsig, n, min(SUM_TEAMS, max(n / 2, 1)));
  if (threadIdx.x < 6) {
    int64_t *dst = threadIdx.x < 2 ? sx : threadIdx.x < 4 ? sy : sz;
    fp_store(dst + 24 * (threadIdx.x & 1), zsig[0].c[threadIdx.x]);
  }
}

// scratch: n*m G1 points, n G1 points, n G2 points (uint32 words)
extern "C" long long lh_prepare_scratch_words(int n, int m) {
  return ((long long)n * m + n) * (long long)(sizeof(gpoint<3>) / 4) +
         (long long)n * (long long)(sizeof(gpoint<6>) / 4);
}

static int team_threads(int pairs, int cap) {
  const int teams = pairs < 1 ? 1 : pairs < cap ? pairs : cap;
  return (teams * TEAM_LANES + 31) / 32 * 32;
}

extern "C" int lh_stage_prepare(const void *pk_x, const void *pk_y, const void *pk_mask,
                                const void *sig_x, const void *sig_y, const void *zbits,
                                const void *set_mask, int n, int m, int nbits, void *zx, void *zy,
                                void *zz, void *sx, void *sy, void *sz, void *bad, void *scratch,
                                void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  gpoint<3> *pts = (gpoint<3> *)scratch;
  gpoint<3> *aggpk = pts + (size_t)n * m;
  gpoint<6> *zsig = (gpoint<6> *)(aggpk + n);
  const int agg_threads = team_threads(m / 2, AGG_TEAMS);
  prepare_aggregate<<<n, agg_threads < 64 ? 64 : agg_threads, 0, st>>>(
      (const int64_t *)pk_x, (const int64_t *)pk_y, (const int32_t *)pk_mask, m, pts, aggpk);
  int err = (int)cudaGetLastError();
  if (err) return err;
  prepare_scale<<<dim3(n, 2), 32, 0, st>>>(aggpk, (const int64_t *)sig_x, (const int64_t *)sig_y,
                                          (const int32_t *)zbits, (const int32_t *)set_mask, nbits,
                                          (int64_t *)zx, (int64_t *)zy, (int64_t *)zz, zsig,
                                          (int32_t *)bad);
  err = (int)cudaGetLastError();
  if (err) return err;
  prepare_sig_sum<<<1, team_threads(n / 2, SUM_TEAMS), 0, st>>>(zsig, n, (int64_t *)sx,
                                                                  (int64_t *)sy, (int64_t *)sz);
  return (int)cudaGetLastError();
}
