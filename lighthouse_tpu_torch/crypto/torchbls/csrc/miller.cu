// miller_loop_product: the shared-accumulator multi-Miller loop on the card.
//
// Replaces the Pallas kernel _miller_kernel
// (lighthouse_tpu/crypto/jaxbls/pallas_ops.py:229, wrapper
// miller_loop_product_fused :271), the fused form of
// pairing_ops.miller_loop_product: over P = n_sets + 1 affine pairs with a
// validity mask, per bit of |x| after the leading 1 (63 bits, MSB first) one
// Fq12 squaring of the shared f, one doubling step and tangent line per
// pair, the product of all lines folded into f, and on the five 1-bits an
// addition step and its lines likewise; at the end f is conjugated (x < 0).
//
// Bound on this card: the sequential chain of Fq12 products (per bit the
// squaring, the line tree of depth ~log2(P) and the fold; ~600 dependent
// Fq12 products of ~54 Fq products each), not bytes (a few KB in and out).
// The simple design is one block: one thread per pair updates R and
// evaluates its line, threads pair the lines up and halve the Fq12 tree in
// a global scratch buffer, and thread 0 carries f, with __syncthreads
// between the phases. The bit pattern is a compile-time constant (the TPU
// kernel read it from SMEM only to please Mosaic). Fq12 products are exact
// mod p, so the tree's order is invisible in the result; lines are
// multiplied densely. Masked pairs contribute the identity line (1, 0, 0),
// as in the reference. No size gate (see prepare.cu).
#include "curve.cuh"

struct line_t {
  fp2 l0, l1, l2;  // l0 + l1 v + l2 v w
};

// Jacobian doubling of R and the tangent line at P, scaled by 2 Y Z^3
// (pairing_ops._dbl_step)
static __device__ __noinline__ void dbl_step(jac<fp2> &r, line_t &ln, const fp &xp, const fp &yp) {
  fp2 A, B, C, T, D, E, F, X3, Y3, ZZ, Z3, t;
  fp2_sqr(A, r.x);
  fp2_sqr(B, r.y);
  fp2_sqr(C, B);
  fp2_add(T, r.x, B);
  fp2_sqr(T, T);
  fp2_sub(D, T, A);
  fp2_sub(D, D, C);
  fp2_dbl(D, D);
  fp2_mul3(E, A);
  fp2_sqr(F, E);
  fp2_dbl(t, D);
  fp2_sub(X3, F, t);
  fp2_sub(t, D, X3);
  fp2_mul(Y3, E, t);
  fp2_mul8(t, C);
  fp2_sub(Y3, Y3, t);
  fp2_sqr(ZZ, r.z);
  fp2_mul(Z3, r.y, r.z);
  fp2_dbl(Z3, Z3);
  // l0 = 3X^3 - 2Y^2; l1 = -3 X^2 Z^2 xp; l2 = Z3 Z^2 yp
  fp2_mul(ln.l0, E, r.x);
  fp2_dbl(t, B);
  fp2_sub(ln.l0, ln.l0, t);
  fp2_mul(t, E, ZZ);
  fp2_neg(t, t);
  fp2_mul_fp(ln.l1, t, xp);
  fp2_mul(t, Z3, ZZ);
  fp2_mul_fp(ln.l2, t, yp);
  r.x = X3;
  r.y = Y3;
  r.z = Z3;
}

// mixed addition R + Q and the line through R, Q at P, scaled by Z3 = Z1 H
// (pairing_ops._add_step)
static __device__ __noinline__ void add_step(jac<fp2> &r, line_t &ln, const fp2 &xq, const fp2 &yq,
                                             const fp &xp, const fp &yp) {
  fp2 Z1Z1, U2, S2, H, R, HH, HHH, V, X3, Y3, Z3, t;
  fp2_sqr(Z1Z1, r.z);
  fp2_mul(U2, xq, Z1Z1);
  fp2_mul(t, yq, r.z);
  fp2_mul(S2, t, Z1Z1);
  fp2_sub(H, U2, r.x);
  fp2_sub(R, S2, r.y);
  fp2_sqr(HH, H);
  fp2_mul(HHH, H, HH);
  fp2_mul(V, r.x, HH);
  fp2_sqr(X3, R);
  fp2_sub(X3, X3, HHH);
  fp2_dbl(t, V);
  fp2_sub(X3, X3, t);
  fp2_sub(t, V, X3);
  fp2_mul(Y3, R, t);
  fp2_mul(t, r.y, HHH);
  fp2_sub(Y3, Y3, t);
  fp2_mul(Z3, r.z, H);
  // l0 = R xq - yq Z3; l1 = -R xp; l2 = Z3 yp
  fp2_mul(ln.l0, R, xq);
  fp2_mul(t, yq, Z3);
  fp2_sub(ln.l0, ln.l0, t);
  fp2_neg(t, R);
  fp2_mul_fp(ln.l1, t, xp);
  fp2_mul_fp(ln.l2, Z3, yp);
  r.x = X3;
  r.y = Y3;
  r.z = Z3;
}

static __device__ __forceinline__ void line_to_fp12(fp12 &r, const line_t &ln) {
  r.c0.c0 = ln.l0;
  r.c0.c1 = ln.l1;
  fp2_set_zero(r.c0.c2);
  fp2_set_zero(r.c1.c0);
  r.c1.c1 = ln.l2;
  fp2_set_zero(r.c1.c2);
}

static __device__ __forceinline__ void line_mul_line(fp12 &r, const line_t &a, const line_t &b) {
  fp12 x, y;
  line_to_fp12(x, a);
  line_to_fp12(y, b);
  fp12_mul(r, x, y);
}

// The product of the P lines into tree[0]: lines paired across halves, an
// odd straggler folded into lane 0, then halving rounds. Whole block.
static __device__ void lines_product(const line_t *lines, fp12 *tree, int P) {
  const int h = P / 2;
  if (P == 1) {
    if (threadIdx.x == 0) line_to_fp12(tree[0], lines[0]);
    __syncthreads();
    return;
  }
  for (int j = threadIdx.x; j < h; j += blockDim.x) {
    line_mul_line(tree[j], lines[j], lines[j + h]);
    if (j == 0 && (P & 1)) {
      fp12 x;
      line_to_fp12(x, lines[P - 1]);
      fp12_mul(tree[0], tree[0], x);
    }
  }
  __syncthreads();
  for (int cnt = h; cnt > 1; cnt /= 2) {
    const int half = cnt / 2;
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      fp12_mul(tree[j], tree[j], tree[j + half]);
      if (j == 0 && (cnt & 1)) fp12_mul(tree[0], tree[0], tree[cnt - 1]);
    }
    __syncthreads();
  }
}

__global__ void miller_kernel(const int64_t *xp_in, const int64_t *yp_in, const int64_t *xq_in,
                              const int64_t *yq_in, const int32_t *mask, int P, jac<fp2> *R,
                              line_t *lines, fp12 *tree, int64_t *out) {
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    fp2_load(R[i].x, xq_in + 48 * i);
    fp2_load(R[i].y, yq_in + 48 * i);
    fp2_set_one(R[i].z);
  }
  fp12 f;  // carried by thread 0
  fp12_set_one(f);
  __syncthreads();
  for (int b = 62; b >= 0; b--) {
    const bool add = (X_ABS >> b) & 1ull;
    for (int step = 0; step < (add ? 2 : 1); step++) {
      if (threadIdx.x == 0 && step == 0) fp12_sqr(f, f);
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        fp xp, yp;
        fp_load(xp, xp_in + 24 * i);
        fp_load(yp, yp_in + 24 * i);
        line_t ln;
        if (step == 0) {
          dbl_step(R[i], ln, xp, yp);
        } else {
          fp2 xq, yq;
          fp2_load(xq, xq_in + 48 * i);
          fp2_load(yq, yq_in + 48 * i);
          add_step(R[i], ln, xq, yq, xp, yp);
        }
        if (!mask[i]) {
          fp2_set_one(ln.l0);
          fp2_set_zero(ln.l1);
          fp2_set_zero(ln.l2);
        }
        lines[i] = ln;
      }
      __syncthreads();
      lines_product(lines, tree, P);
      if (threadIdx.x == 0) fp12_mul(f, f, tree[0]);
      __syncthreads();
    }
  }
  if (threadIdx.x == 0) {
    fp12_conj(f, f);
    fp12_store(out, f);
  }
}

// scratch: P G2 points, P lines, ceil(P/2) Fq12 (uint32 words)
extern "C" long long lh_miller_scratch_words(int P) {
  return (long long)P * (long long)((sizeof(jac<fp2>) + sizeof(line_t)) / 4) +
         (long long)((P + 1) / 2) * (long long)(sizeof(fp12) / 4);
}

extern "C" int lh_miller_loop_product(const void *xp, const void *yp, const void *xq,
                                      const void *yq, const void *mask, int P, void *out,
                                      void *scratch, void *stream) {
  jac<fp2> *R = (jac<fp2> *)scratch;
  line_t *lines = (line_t *)(R + P);
  fp12 *tree = (fp12 *)(lines + P);
  const int threads = P < 128 ? ((P + 31) / 32) * 32 : 128;
  miller_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t *)xp, (const int64_t *)yp, (const int64_t *)xq, (const int64_t *)yq,
      (const int32_t *)mask, P, R, lines, tree, (int64_t *)out);
  return (int)cudaGetLastError();
}
