// Bound-tracked limb NTT with mod-q hints, one signature per thread block.
//
// The CUDA twin of ops/ntt_limb.ntt_with_hints: (batch, n) coefficients in
// [0, q) go in; the quotient limbs t (kLimbs, batch, n) and remainders b
// (batch, n) of the final mod-q hint come out, bit-equal to the XLA path.
//
// The XLA path writes the whole (limbs, batch, n) tensor to device memory
// and reads it back at each of the log n butterfly stages.  Here one
// signature's limb state (kLimbs x n int32, 44 KB at n = 1024) lives in
// shared memory for all stages and the final divmod, so a signature costs
// one read of its coefficients and one write of (t, b).
//
// Thread i owns butterfly i of every stage: positions j0 and j1 = j0 + half
// of group g = i / half.  With s the group's twiddle and c the stage bound
// (a multiple of q that dominates v = x[j1] * s):
//
//     x[j0] = u + v,   x[j1] = u + (c - v),   u = x[j0]
//
// computed limb by limb with exact carry chains in registers (v's chain and
// the two output chains).  Limbs above the stage's active count stay zero,
// so the sweep stops there.  A barrier separates stages.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a (ops/ntt_cuda.py builds
// it on first use).

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kLimbs = 11;  // ops/limbs.NUM_LIMBS: 176 bits
constexpr int kLimbBits = 16;
constexpr int32_t kLimbMask = (1 << kLimbBits) - 1;
constexpr int32_t kQ = 12289;

template <int LOGN>
__global__ void __launch_bounds__(1 << (LOGN - 1))
    ntt_hints_kernel(const int32_t* __restrict__ x,
                     const int32_t* __restrict__ table,
                     const int32_t* __restrict__ bounds,
                     const int32_t* __restrict__ active,
                     int32_t* __restrict__ t, int32_t* __restrict__ b,
                     int64_t batch) {
  constexpr int N = 1 << LOGN;
  constexpr int kThreads = N / 2;
  __shared__ int32_t st[kLimbs][N];

  const int i = threadIdx.x;
  const int64_t row = blockIdx.x;
  const int32_t* xr = x + row * N;

  for (int j = i; j < N; j += kThreads) {
    st[0][j] = xr[j];
#pragma unroll
    for (int k = 1; k < kLimbs; ++k) st[k][j] = 0;
  }
  __syncthreads();

#pragma unroll 1
  for (int l = 0; l < LOGN; ++l) {
    const int shift = LOGN - 1 - l;  // half = 1 << shift
    const int half = 1 << shift;
    const int g = i >> shift;
    const int j0 = (g << (shift + 1)) + (i & (half - 1));
    const int j1 = j0 + half;
    const int32_t s = __ldg(table + (1 << l) + g);
    const int32_t* c = bounds + (l + 1) * kLimbs;
    const int act = __ldg(active + l);
    int32_t cv = 0, c0 = 0, c1 = 0;
#pragma unroll
    for (int k = 0; k < kLimbs; ++k) {
      if (k < act) {
        const int32_t u = st[k][j0];
        const int32_t tv = st[k][j1] * s + cv;
        const int32_t v = tv & kLimbMask;
        cv = tv >> kLimbBits;
        const int32_t o0 = u + v + c0;
        const int32_t o1 = u + (__ldg(c + k) - v) + c1;
        st[k][j0] = o0 & kLimbMask;
        st[k][j1] = o1 & kLimbMask;
        c0 = o0 >> kLimbBits;  // arithmetic shift: exact borrow
        c1 = o1 >> kLimbBits;
      }
    }
    __syncthreads();
  }

  // divmod by q from the top limb: r < q keeps (r << 16) + limb < 2^31
  for (int j = i; j < N; j += kThreads) {
    int32_t r = 0;
#pragma unroll
    for (int k = kLimbs - 1; k >= 0; --k) {
      const int32_t cur = (r << kLimbBits) + st[k][j];
      const int32_t qt = cur / kQ;
      r = cur - qt * kQ;
      t[(static_cast<int64_t>(k) * batch + row) * N + j] = qt;
    }
    b[row * N + j] = r;
  }
}

template <int LOGN>
void launch(cudaStream_t stream, const int32_t* x, const int32_t* table,
            const int32_t* bounds, const int32_t* active, int32_t* t,
            int32_t* b, int64_t batch) {
  ntt_hints_kernel<LOGN><<<static_cast<unsigned>(batch), 1 << (LOGN - 1), 0,
                           stream>>>(x, table, bounds, active, t, b, batch);
}

ffi::Error NttHintsImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> x,
                        ffi::Buffer<ffi::S32> table,
                        ffi::Buffer<ffi::S32> bounds,
                        ffi::Buffer<ffi::S32> active,
                        ffi::ResultBuffer<ffi::S32> t,
                        ffi::ResultBuffer<ffi::S32> b) {
  const auto dims = x.dimensions();
  if (dims.size() != 2) {
    return ffi::Error::InvalidArgument("ntt_hints: x must be (batch, n)");
  }
  const int64_t batch = dims[0];
  const int64_t n = dims[1];
  const auto bdims = bounds.dimensions();
  if (bdims.size() != 2 || bdims[1] != kLimbs ||
      table.element_count() != static_cast<size_t>(n)) {
    return ffi::Error::InvalidArgument(
        "ntt_hints: tables do not match n or the limb count");
  }
  if (batch == 0) return ffi::Error::Success();
  if (batch > 0x7fffffff) {
    return ffi::Error::InvalidArgument("ntt_hints: batch exceeds the grid");
  }
  const int32_t* xp = x.typed_data();
  const int32_t* tp = table.typed_data();
  const int32_t* bp = bounds.typed_data();
  const int32_t* ap = active.typed_data();
  int32_t* to = t->typed_data();
  int32_t* bo = b->typed_data();
  switch (n) {
    case 512:
      launch<9>(stream, xp, tp, bp, ap, to, bo, batch);
      break;
    case 1024:
      launch<10>(stream, xp, tp, bp, ap, to, bo, batch);
      break;
    default:
      return ffi::Error::InvalidArgument("ntt_hints: n must be 512 or 1024");
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("ntt_hints launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(FalconNttHints, NttHintsImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()  // x
                                  .Arg<ffi::Buffer<ffi::S32>>()  // table
                                  .Arg<ffi::Buffer<ffi::S32>>()  // bounds
                                  .Arg<ffi::Buffer<ffi::S32>>()  // active
                                  .Ret<ffi::Buffer<ffi::S32>>()  // t
                                  .Ret<ffi::Buffer<ffi::S32>>()  // b
);
