// hash_to_g2: hash-to-G2 of a batch of messages on the card.
//
// Replaces the Pallas kernel _h2c_kernel
// (lighthouse_tpu/crypto/jaxbls/pallas_ops.py:641, wrapper hash_to_g2_fused
// :669), the fused form of h2c_ops.hash_to_g2_jacobian: from the
// standard-form u-values of each message (the host did expand_message_xmd
// and hash_to_field), the Montgomery conversion, the simplified SWU map
// with its 758-bit sqrt_ratio exponentiation, the 3-isogeny to E2, the add
// of the two mapped points and psi-based cofactor clearing. Output is the
// Jacobian point (X, Y, Z) of each message.
//
// Bound on this card: the latency of dependent Fq products (~7400 per
// message in two chains, one SWU map per u-value, then the cofactor
// clearing's two 64-bit scalar multiplications), not the card's multiply
// rate and not bytes (192 B in, 288 B out per message). So a message gets
// one warp, and every step runs on a team of its lanes (team.cuh): each
// level's independent Fq products one per lane, a __syncwarp between levels.
// Lanes 0-15 map u_0 and lanes 16-31 map u_1, in lockstep (the same
// programs of team.TSW on two states): swu1, swu2, the table of t^1..t^15;
// sqrt_ratio's 758-bit exponent over 4-bit digits as a chain of Fq2
// squarings (a level of 2 products) and table products (3) in the lanes'
// registers, the results shared by warp shuffles (team_fp2_sqr,
// team_fp2_mul); the eight candidates and their checks, y2x2 and the
// isogeny. Then the warp as one team adds the
// two points and clears the cofactor with the G2 point programs (team.TG2:
// a doubling 3 levels, an addition 5, psi 1, each plus its output pass).
// The branches between programs are uniform over a team: xd == 0 selects
// Z A, sqrt_ratio keeps the first matching candidate in h2c_ops' order
// (is_qr when it is one of the first four), the is_qr selects, the sgn0
// sign, jac_add's cases.
//
// Bit-exactness: where the result is a point, the formulas are those of
// h2c_ops and curve_ops (the isogeny's X, Y, Z, jac_add,
// clear_cofactor_g2's order of doublings, adds, psi maps and negations,
// scalar_mul_static's double-then-add-on-a-set-bit from the identity);
// where the result is a field element, any exact method gives the same
// fully reduced value (the a^E exponentiation uses a 4-bit window, as the
// plain version does). tests/test_torch_team.py runs this sequence on the
// same tables against the plain version.
#include "team.cuh"

// the cofactor clearing's state: TG2's slots, then four stored points
#define CL_R (TG2_SLOTS)
#define CL_T1 (TG2_SLOTS + 6)
#define CL_T2 (TG2_SLOTS + 12)
#define CL_T3 (TG2_SLOTS + 18)
#define CL_SLOTS (TG2_SLOTS + 24)

// T_d, d = 1..15, are consecutive Fq2 slots from T1
#define SW_T(d) (TSW_S_T10 + 2 * ((d) - 1))

// One u-value (in the u slots, Montgomery) -> its point on E2 in the q
// slots: h2c_ops.sswu_projective, then iso_map_jacobian.
static __device__ __forceinline__ void map_to_curve(const TSW_tables &T, fp *S, const team &tm) {
  T.run(S, TSW_SWU1, tm);
  if (slot_is_zero(S, TSW_S_XD0) && slot_is_zero(S, TSW_S_XD1)) {   // xd == 0: Z A
    team_sync(tm);
    team_copy(S, TSW_S_XD0, S, TSW_S_ZA0, 2, tm);
  }
  T.run(S, TSW_SWU2, tm);
  T.run(S, TSW_TABLE, tm);
  // e = t^E over the window digits, in registers: the first digit's table
  // entry, then per digit four squarings and, for a digit d > 0, the
  // product by t^d (h2c_ops.fq2_sqrt_ratio's pow_static)
  fp a0, a1;
  slot_load(a0, S, SW_T(SW_E_DIGITS[0]));
  slot_load(a1, S, SW_T(SW_E_DIGITS[0]) + 1);
  for (int k = 1; k < SW_E_NDIGITS; k++) {
#pragma unroll 1
    for (int s = 0; s < 4; s++) team_fp2_sqr(a0, a1, tm);
    const int d = SW_E_DIGITS[k];
    if (d) {
      fp b0, b1;
      slot_load(b0, S, SW_T(d));
      slot_load(b1, S, SW_T(d) + 1);
      team_fp2_mul(a0, a1, b0, b1, tm);
    }
  }
  if (tm.lane < 2) slot_store(S, TSW_S_E0 + tm.lane, tm.lane ? a1 : a0);
  team_sync(tm);
  T.run(S, TSW_CANDS, tm);
  // lane c < 8: does candidate c check (y^2 v == u for the first four,
  // == Z u for the last four)
  bool ok = false;
  if (tm.lane < 8) {
    const int ref = tm.lane < 4 ? TSW_S_GX10 : TSW_S_ZU0;
    ok = slots_equal(S, TSW_S_CHK00 + 2 * tm.lane, ref) &&
         slots_equal(S, TSW_S_CHK00 + 2 * tm.lane + 1, ref + 1);
  }
  const unsigned shift = __ffs(tm.mask) - 1;
  const unsigned found = (__ballot_sync(tm.mask, ok) >> shift) & 0xFFu;
  const bool is_qr = (found & 0xFu) != 0;
  if (tm.lane < 2) {           // y1: the first match (zero if none)
    fp y;
    if (found)
      slot_load(y, S, TSW_S_YS00 + 2 * (__ffs(found) - 1) + tm.lane);
    else
      fp_set_zero(y);
    slot_store(S, TSW_S_Y10 + tm.lane, y);
  }
  team_sync(tm);
  T.run(S, TSW_Y2X2, tm);
  if (tm.lane < 4) {           // xn = is_qr ? x1n : x2n, ysg = is_qr ? y1 : y2
    const int c = tm.lane & 1;
    fp x;
    if (tm.lane < 2) {
      slot_load(x, S, (is_qr ? TSW_S_X1N0 : TSW_S_X2N0) + c);
      slot_store(S, TSW_S_XN0 + c, x);
    } else {
      slot_load(x, S, (is_qr ? TSW_S_Y10 : TSW_S_Y20) + c);
      slot_store(S, TSW_S_YSG0 + c, x);
    }
  }
  team_sync(tm);
  // sgn0 of ysg and of u on the standard form (the product by the integer
  // 1): lanes 0..3 take ysg0, ysg1, u0, u1
  bool odd = false, zero = false;
  if (tm.lane < 4) {
    fp v, one;
    fp_set_zero(one);
    one.v[0] = 1;
    slot_load(v, S, (tm.lane < 2 ? TSW_S_YSG0 : TSW_S_U0) + (tm.lane & 1));
    fp_mul(v, v, one);
    odd = v.v[0] & 1u;
    zero = fp_is_zero(v);
  }
  const unsigned par = (__ballot_sync(tm.mask, odd) >> shift) & 0xFu;
  const unsigned zer = (__ballot_sync(tm.mask, zero) >> shift) & 0xFu;
  const unsigned sgn_y = (par & 1u) | (zer & (par >> 1) & 1u);
  const unsigned sgn_u = ((par >> 2) & 1u) | ((zer >> 2) & (par >> 3) & 1u);
  if (sgn_y != sgn_u && tm.lane < 2) {
    fp y;
    slot_load(y, S, TSW_S_YSG0 + tm.lane);
    fp_neg(y, y);
    slot_store(S, TSW_S_YSG0 + tm.lane, y);
  }
  team_sync(tm);
  T.run(S, TSW_ISO, tm);
}

// a G2 point into slots dst of D from slots src of Src, Y negated if neg
static __device__ __forceinline__ void team_put(fp *D, int dst, const fp *Src, int src, bool neg,
                                                const team &tm) {
  for (int k = tm.lane; k < 6; k += tm.nl) {
    fp x;
    slot_load(x, Src, src + k);
    if (neg && (k == 2 || k == 3)) fp_neg(x, x);
    slot_store(D, dst + k, x);
  }
  team_sync(tm);
}

// x p = -(|x| p) for p in the slots src, into the slots dst: per bit of |x|
// (64, MSB first) a doubling and, on a set bit, an add, from the identity
// (curve_ops.scalar_mul_static), then the negation
static __device__ __forceinline__ void team_xmul(const TG2_tables &T, fp *C, int src, int dst,
                                                 const team &tm) {
  team_put(C, 12, C, src, false, tm);
  team_set_identity<6>(C, 0, tm);
  int a = 0;
  for (int b = 63; b >= 0; b--) {
    a = team_dbl<6>(T, C, a, tm);
    if ((X_ABS >> b) & 1ull) a = team_add<6>(T, C, a, tm);
  }
  team_put(C, dst, C, 6 * a, true, tm);
}

// slots d = slots p1 + (-)slots p2 (curve_ops.jac_add)
static __device__ __forceinline__ void team_add_into(const TG2_tables &T, fp *C, int d, int p1,
                                                     int p2, bool neg2, const team &tm) {
  team_put(C, 0, C, p1, false, tm);
  team_put(C, 12, C, p2, neg2, tm);
  const int a = team_add<6>(T, C, 0, tm);
  team_put(C, d, C, 6 * a, false, tm);
}

// h_eff r = [x^2 - x - 1] r + [x - 1] psi(r) + psi^2(2 r) for r in CL_R,
// in curve_ops.clear_cofactor_g2's order; the result in CL_T3
static __device__ __forceinline__ void clear_cofactor(const TG2_tables &T, fp *C,
                                                      const team &tm) {
  team_xmul(T, C, CL_R, CL_T1, tm);                 // t1 = x r
  team_put(C, 0, C, CL_R, false, tm);
  T.run(C, TG2_PSI_AB, tm);
  team_put(C, CL_T2, C, 6, false, tm);              // t2 = psi(r)
  team_put(C, 0, C, CL_R, false, tm);
  team_dbl<6>(T, C, 0, tm);
  T.run(C, TG2_PSI_BA, tm);
  T.run(C, TG2_PSI_AB, tm);
  team_put(C, CL_T3, C, 6, false, tm);              // t3 = psi^2(2 r)
  team_add_into(T, C, CL_T3, CL_T3, CL_T2, true, tm);   // t3 - t2
  team_add_into(T, C, CL_T2, CL_T1, CL_T2, false, tm);  // t1 + t2
  team_xmul(T, C, CL_T2, CL_T2, tm);                // x (t1 + t2)
  team_add_into(T, C, CL_T3, CL_T3, CL_T2, false, tm);
  team_add_into(T, C, CL_T3, CL_T3, CL_T1, true, tm);
  team_add_into(T, C, CL_T3, CL_T3, CL_R, true, tm);
}

__global__ void __launch_bounds__(32) h2c_kernel(const int64_t *us, int64_t *X, int64_t *Y,
                                                 int64_t *Z) {
  __shared__ TSW_tables TS;
  __shared__ TG2_tables T2;
  __shared__ __align__(16) fp SW[2 * TSW_SLOTS];
  __shared__ __align__(16) fp C[CL_SLOTS];
  const int i = blockIdx.x, l = threadIdx.x, j = l >> 4;
  TS.stage(l, 32);
  T2.stage(l, 32);
  // team j maps u_j: the constants, u_j in Montgomery form
  const team tm{l & 15, 16, 0xFFFFu << (16 * j)};
  fp *S = SW + j * TSW_SLOTS;
  for (int k = tm.lane; k < SW_NCONSTS; k += tm.nl) {
    fp c;
#pragma unroll
    for (int w = 0; w < 12; w++) c.v[w] = SW_CONST_WORDS[12 * k + w];
    slot_store(S, k, c);
  }
  if (tm.lane < 2) {
    fp c;
    fp_load(c, us + (2 * i + j) * 48 + 24 * tm.lane);   // us[i, j]: standard form
    fp_to_mont(c, c);
    slot_store(S, TSW_S_U0 + tm.lane, c);
  }
  if (l < 4) {                 // psi's coefficients for the clearing
    fp c;
#pragma unroll
    for (int w = 0; w < 12; w++) c.v[w] = l < 2 ? PSI_CX[l][w] : PSI_CY[l - 2][w];
    slot_store(C, TG2_S_CX0 + l, c);
  }
  __syncwarp();
  map_to_curve(TS, S, tm);
  __syncwarp();
  // the warp: r = q0 + q1, then the cofactor clearing
  const team w{l, 32, 0xFFFFFFFFu};
  team_put(C, 0, SW, TSW_S_QX0, false, w);
  team_put(C, 12, SW + TSW_SLOTS, TSW_S_QX0, false, w);
  const int a = team_add<6>(T2, C, 0, w);
  team_put(C, CL_R, C, 6 * a, false, w);
  clear_cofactor(T2, C, w);
  if (l < 6) {
    fp c;
    slot_load(c, C, CL_T3 + l);
    fp_store((l < 2 ? X : l < 4 ? Y : Z) + 48 * i + 24 * (l & 1), c);
  }
}

extern "C" int lh_hash_to_g2(const void *us, int n, void *X, void *Y, void *Z, void *stream) {
  if (n > 0)
    h2c_kernel<<<n, 32, 0, (cudaStream_t)stream>>>((const int64_t *)us, (int64_t *)X, (int64_t *)Y,
                                                  (int64_t *)Z);
  return (int)cudaGetLastError();
}
