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
// Bound on this card: integer multiply-adds (~7400 Fq products per
// message, in two dependent chains: one SWU map per u-value, then the
// cofactor clearing's two 64-bit scalar multiplications), not bytes (192 B
// in, 288 B out per message). The simple design gives each message a block
// of two threads: thread j maps u_j (the two maps run side by side), the
// two points meet in shared memory, and thread 0 adds them and clears the
// cofactor. Blocks are small so the messages spread over the SMs.
//
// Bit-exactness: where the result is a point, the formulas are those of
// h2c_ops and curve_ops term for term (the isogeny's X, Y, Z, jac_add,
// clear_cofactor_g2's order of doublings, adds, psi maps and negations,
// scalar_mul_static's double-then-add-on-a-set-bit from the identity);
// where the result is a field element, any exact method gives the same
// fully reduced value (the a^E exponentiation here uses a 4-bit window,
// as the plain version does). sqrt_ratio checks all eight candidates and
// keeps the first match in H2C_CANDS order; xd == 0 selects Z * A. The
// constants come from the generated bls_consts.cuh.
#include "curve.cuh"

static __device__ __forceinline__ void fp2_const(fp2 &r, const uint32_t c[2][12]) {
#pragma unroll
  for (int i = 0; i < 12; i++) {
    r.c0.v[i] = c[0][i];
    r.c1.v[i] = c[1][i];
  }
}

static __device__ __forceinline__ bool fp2_eq(const fp2 &a, const fp2 &b) {
  uint32_t d = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) d |= (a.c0.v[i] ^ b.c0.v[i]) | (a.c1.v[i] ^ b.c1.v[i]);
  return d == 0;
}

// RFC 9380 sgn0 for Fq2, on the standard form (the product by the integer 1)
static __device__ __noinline__ uint32_t fp2_sgn0(const fp2 &a) {
  fp one, s0, s1;
  fp_set_zero(one);
  one.v[0] = 1;
  fp_mul(s0, a.c0, one);
  fp_mul(s1, a.c1, one);
  const uint32_t z0 = fp_is_zero(s0) ? 1u : 0u;
  return (s0.v[0] & 1u) | (z0 & s1.v[0] & 1u);
}

// a^E with E = (q - 9) / 16: a table of a^0..a^15, then per 4-bit digit
// after the first four squarings and a table product where it is nonzero
static __device__ __noinline__ void fp2_pow_e(fp2 &r, const fp2 &a) {
  fp2 table[16];
  fp2_set_one(table[0]);
  table[1] = a;
  for (int j = 2; j < 16; j++) fp2_mul(table[j], table[j / 2], table[j - j / 2]);
  const int nd = (H2C_E_BITS + 3) / 4;
  fp2 acc = table[(H2C_E[(4 * (nd - 1)) >> 5] >> ((4 * (nd - 1)) & 31)) & 15u];
  for (int d = nd - 2; d >= 0; d--) {
    const uint32_t digit = (H2C_E[(4 * d) >> 5] >> ((4 * d) & 31)) & 15u;
    for (int k = 0; k < 4; k++) fp2_sqr(acc, acc);
    if (digit) fp2_mul(acc, acc, table[digit]);
  }
  r = acc;
}

// sqrt_ratio (q = 9 mod 16): s = u v^7 (u v^15)^E, y = s * c for the
// first candidate c with y^2 v == u (QR, the first four) or y^2 v == Z u
// (non-QR, the last four). Returns is_qr.
static __device__ __noinline__ bool fp2_sqrt_ratio(fp2 &y, const fp2 &u, const fp2 &v) {
  fp2 v2, v4, v8, v7, v15, s, t, zu;
  fp2_sqr(v2, v);
  fp2_sqr(v4, v2);
  fp2_sqr(v8, v4);
  fp2_mul(t, v2, v);
  fp2_mul(v7, v4, t);
  fp2_mul(v15, v8, v7);
  fp2_mul(t, u, v15);
  fp2_pow_e(t, t);
  fp2_mul(s, u, v7);
  fp2_mul(s, s, t);
  fp2_const(t, H2C_Z);
  fp2_mul(zu, t, u);
  bool found = false, is_qr = false;
  fp2_set_zero(y);
  for (int c = 0; c < 8; c++) {
    fp2 ys, chk;
    fp2_const(t, H2C_CANDS[c]);
    fp2_mul(ys, s, t);
    fp2_sqr(chk, ys);
    fp2_mul(chk, chk, v);
    const bool ok = fp2_eq(chk, c < 4 ? u : zu);
    if (ok && !found) y = ys;
    if (ok && c < 4) is_qr = true;
    found = found || ok;
  }
  return is_qr;
}

// One u-value (Montgomery) -> its point on E2, Jacobian: the simplified SWU
// map to E2' (h2c_ops.sswu_projective), then the 3-isogeny with all four
// polynomials on the monomials [xd^3, xn xd^2, xn^2 xd, xn^3]
// (h2c_ops.iso_map_jacobian; xd^2 and xd^3 are the map's own).
static __device__ __noinline__ void map_to_curve(jac<fp2> &q, const fp2 &u) {
  fp2 Z, A, B, u2, tv1, tv2, x1n, x2n, xd, xd2, xd3, gx1, t, y1, y2, xn, y;
  fp2_const(Z, H2C_Z);
  fp2_const(A, H2C_A);
  fp2_const(B, H2C_B);
  fp2_sqr(u2, u);
  fp2_mul(tv1, Z, u2);
  fp2_sqr(tv2, tv1);
  fp2_add(tv2, tv2, tv1);
  fp2_set_one(t);
  fp2_add(t, tv2, t);
  fp2_mul(x1n, B, t);
  fp2_const(t, H2C_NEG_A);
  fp2_mul(xd, t, tv2);
  if (fp2_is_zero(xd)) fp2_const(xd, H2C_ZA);
  fp2_sqr(xd2, xd);
  fp2_mul(xd3, xd2, xd);
  fp2_sqr(gx1, x1n);
  fp2_mul(t, A, xd2);
  fp2_add(gx1, gx1, t);
  fp2_mul(gx1, gx1, x1n);
  fp2_mul(t, B, xd3);
  fp2_add(gx1, gx1, t);
  const bool is_qr = fp2_sqrt_ratio(y1, gx1, xd3);
  fp2_mul(x2n, tv1, x1n);
  fp2_mul(t, u2, u);
  fp2_mul(t, Z, t);
  fp2_mul(y2, t, y1);
  xn = is_qr ? x1n : x2n;
  y = is_qr ? y1 : y2;
  if (fp2_sgn0(y) != fp2_sgn0(u)) fp2_neg(y, y);

  fp2 xn2, m[4], sums[4];
  fp2_sqr(xn2, xn);
  m[0] = xd3;
  fp2_mul(m[1], xn, xd2);
  fp2_mul(m[2], xn2, xd);
  fp2_mul(m[3], xn2, xn);
  for (int k = 0; k < 4; k++) {     // x_num, x_den, y_num, y_den, all times xd^3
    fp2_set_zero(sums[k]);
    for (int j = 0; j < 4; j++) {
      fp2_const(t, H2C_ISO_K[k][j]);
      fp2_mul(t, t, m[j]);
      fp2_add(sums[k], sums[k], t);
    }
  }
  fp2 yon, xod2, yod2;
  fp2_mul(yon, y, sums[2]);
  fp2_mul(q.z, sums[1], sums[3]);
  fp2_sqr(yod2, sums[3]);
  fp2_mul(t, sums[0], sums[1]);
  fp2_mul(q.x, t, yod2);
  fp2_sqr(xod2, sums[1]);
  fp2_mul(t, yon, xod2);
  fp2_mul(yod2, sums[1], yod2);
  fp2_mul(q.y, t, yod2);
}

// psi: (c_x conj(X), c_y conj(Y), conj(Z)) (curve_ops.psi_jac)
static __device__ __noinline__ void psi_jac(jac<fp2> &r, const jac<fp2> &p) {
  fp2 c, t;
  fp2_conj(t, p.x);
  fp2_const(c, PSI_CX);
  fp2_mul(r.x, t, c);
  fp2_conj(t, p.y);
  fp2_const(c, PSI_CY);
  fp2_mul(r.y, t, c);
  fp2_conj(r.z, p.z);
}

// x p = -(|x| p): per bit of |x| (64, MSB first) a doubling and, on a set
// bit, an add, from the identity (curve_ops.scalar_mul_static), then the
// negation
static __device__ __noinline__ void xmul(jac<fp2> &r, const jac<fp2> &p) {
  jac<fp2> acc;
  jac_set_identity(acc);
  for (int b = 63; b >= 0; b--) {
    jac_double(acc, acc);
    if ((X_ABS >> b) & 1ull) jac_add(acc, acc, p);
  }
  fp2_neg(acc.y, acc.y);
  r = acc;
}

static __device__ __forceinline__ void jac_neg(jac<fp2> &r, const jac<fp2> &p) {
  r = p;
  fp2_neg(r.y, p.y);
}

// h_eff p = [x^2 - x - 1] p + [x - 1] psi(p) + psi^2(2 p)
// (curve_ops.clear_cofactor_g2, in its order)
static __device__ __noinline__ void clear_cofactor(jac<fp2> &r, const jac<fp2> &p) {
  jac<fp2> t1, t2, t3, np;
  xmul(t1, p);                      // x p
  psi_jac(t2, p);                   // psi(p)
  jac_double(t3, p);
  psi_jac(t3, t3);
  psi_jac(t3, t3);                  // psi^2(2 p)
  jac_neg(np, t2);
  jac_add(t3, t3, np);
  jac_add(t2, t1, t2);
  xmul(t2, t2);                     // x^2 p + x psi(p)
  jac_add(t3, t3, t2);
  jac_neg(np, t1);
  jac_add(t3, t3, np);
  jac_neg(np, p);
  jac_add(r, t3, np);
}

__global__ void h2c_kernel(const int64_t *us, int64_t *X, int64_t *Y, int64_t *Z) {
  __shared__ jac<fp2> q[2];
  const int i = blockIdx.x, j = threadIdx.x;
  fp r2;
#pragma unroll
  for (int k = 0; k < 12; k++) r2.v[k] = FP_R2[k];
  fp2 u;
  fp2_load(u, us + (2 * i + j) * 48);   // us[i, j]: standard form
  fp_mul(u.c0, u.c0, r2);
  fp_mul(u.c1, u.c1, r2);
  jac<fp2> qj;
  map_to_curve(qj, u);
  q[j] = qj;
  __syncthreads();
  if (j == 0) {
    jac<fp2> r;
    jac_add(r, q[0], q[1]);
    clear_cofactor(r, r);
    fp2_store(X + 48 * i, r.x);
    fp2_store(Y + 48 * i, r.y);
    fp2_store(Z + 48 * i, r.z);
  }
}

extern "C" int lh_hash_to_g2(const void *us, int n, void *X, void *Y, void *Z, void *stream) {
  if (n > 0)
    h2c_kernel<<<n, 2, 0, (cudaStream_t)stream>>>((const int64_t *)us, (int64_t *)X,
                                                 (int64_t *)Y, (int64_t *)Z);
  return (int)cudaGetLastError();
}
