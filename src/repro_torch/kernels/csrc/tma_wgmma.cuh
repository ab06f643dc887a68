// TMA, mbarrier and wgmma building blocks shared by the two tensor-core
// attention kernels (flash_attention_wgmma.cu, bf16, and
// flash_attention_tf32x3.cu, fp32), and the host's tensor maps of their
// [b, t, heads, hd] operands.  Each .cu includes it into its own anonymous
// namespace; a library is one translation unit.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait of more
// than 2^34 cycles (about 10 s) traps, so a lost phase faults the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// TMA: the box of `map` at (c0, c1, c2, c3) into shared memory at `dst`,
// completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets, each in 16-byte units, and the swizzle (1: 128-byte, the
// default; 2: 64-byte).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo,
                                              uint64_t swizzle = 1) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are pending (all by default).
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before the
// async proxy's reads (wgmma, TMA) that an mbarrier arrive then releases.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A producer thread's writes to shared memory are done: fence them for the
// async proxy (wgmma) and arrive on the mbarrier that releases them.
__device__ __forceinline__ void release(uint32_t bar) {
  fence_proxy_async();
  mbar_arrive(bar);
}

// wgmma with A in registers, D[64 x N] (+)= A[64 x K] B[K x N] with B in
// shared memory, as `wgmma_rs(d, a, b_desc, accumulate)` for float d[R],
// R = N / 2 accumulators a thread: WGMMA_RS(R, shape, imm) defines it for
// the instruction `wgmma.mma_async.sync.aligned.<shape>` with immediates
// `imm` after the accumulate flag.  The four A registers, B's descriptor
// and the flag are operands %0-%5, listed read-write (they are copies) so
// that the accumulators come after them at %6 whatever R is: WG_ACC<R>
// names their operands in the instruction, WG_D<R> binds them.
#define WG_ACC8 "%6, %7, %8, %9, %10, %11, %12, %13"
#define WG_ACC16 WG_ACC8 ", %14, %15, %16, %17, %18, %19, %20, %21"
#define WG_ACC24 WG_ACC16 ", %22, %23, %24, %25, %26, %27, %28, %29"
#define WG_ACC32 WG_ACC24 ", %30, %31, %32, %33, %34, %35, %36, %37"
#define WG_ACC40 WG_ACC32 ", %38, %39, %40, %41, %42, %43, %44, %45"
#define WG_ACC48 WG_ACC40 ", %46, %47, %48, %49, %50, %51, %52, %53"
#define WG_ACC56 WG_ACC48 ", %54, %55, %56, %57, %58, %59, %60, %61"
#define WG_ACC64 WG_ACC56 ", %62, %63, %64, %65, %66, %67, %68, %69"
#define WG_ACC72 WG_ACC64 ", %70, %71, %72, %73, %74, %75, %76, %77"
#define WG_ACC80 WG_ACC72 ", %78, %79, %80, %81, %82, %83, %84, %85"
#define WG_ACC88 WG_ACC80 ", %86, %87, %88, %89, %90, %91, %92, %93"
#define WG_ACC96 WG_ACC88 ", %94, %95, %96, %97, %98, %99, %100, %101"
#define WG_ACC104 WG_ACC96 ", %102, %103, %104, %105, %106, %107, %108, %109"
#define WG_ACC112 WG_ACC104 ", %110, %111, %112, %113, %114, %115, %116, %117"
#define WG_ACC120 WG_ACC112 ", %118, %119, %120, %121, %122, %123, %124, %125"
#define WG_ACC128 WG_ACC120 ", %126, %127, %128, %129, %130, %131, %132, %133"
#define WG_D8_(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D8 WG_D8_(0)
#define WG_D16 WG_D8, WG_D8_(8)
#define WG_D24 WG_D16, WG_D8_(16)
#define WG_D32 WG_D24, WG_D8_(24)
#define WG_D40 WG_D32, WG_D8_(32)
#define WG_D48 WG_D40, WG_D8_(40)
#define WG_D56 WG_D48, WG_D8_(48)
#define WG_D64 WG_D56, WG_D8_(56)
#define WG_D72 WG_D64, WG_D8_(64)
#define WG_D80 WG_D72, WG_D8_(72)
#define WG_D88 WG_D80, WG_D8_(80)
#define WG_D96 WG_D88, WG_D8_(88)
#define WG_D104 WG_D96, WG_D8_(96)
#define WG_D112 WG_D104, WG_D8_(104)
#define WG_D120 WG_D112, WG_D8_(112)
#define WG_D128 WG_D120, WG_D8_(120)
#define WGMMA_RS(R, SHAPE, IMM)                                              \
  __device__ __forceinline__ void wgmma_rs(                                  \
      float(&d)[R], const uint32_t(&a)[4], uint64_t b, int accumulate) {     \
    uint32_t a0 = a[0], a1 = a[1], a2 = a[2], a3 = a[3];                     \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"                 \
                 "wgmma.mma_async.sync.aligned." SHAPE " {" WG_ACC##R "}, "  \
                 "{%0, %1, %2, %3}, %4, p, " IMM ";\n}\n"                     \
                 : "+r"(a0), "+r"(a1), "+r"(a2), "+r"(a3), "+l"(b),           \
                   "+r"(accumulate), WG_D##R);                                \
  }

// Offset of byte `byte` of row `row` in a tile of 128-byte rows cut into
// chunks of `chunk_bytes` (64 bf16 or 32 fp32 columns a row each), as TMA's
// 128-byte swizzle lays it out from a 1024-byte aligned base: chunk c at
// c * chunk_bytes, row r of a chunk at r * 128, its 16-byte unit u at
// (u ^ (r % 8)) * 16.
__device__ __forceinline__ uint32_t swizzled(int row, int byte,
                                             uint32_t chunk_bytes) {
  const int unit = byte >> 4;
  return (unit >> 3) * chunk_bytes + row * 128 +
         (((unit & 7) ^ (row & 7)) << 4) + (byte & 15);
}

// The first `units` 16-byte units of the `rows` rows of a swizzled tile
// whose rows r have r0 + r < t, by a warpgroup's thread `tid`, to rows
// r0 + r of head `head` of batch `batch` of dst, a [b, t, heads, units * 16
// bytes] tensor.
__device__ __forceinline__ void store_rows(uint8_t* dst, const uint8_t* tile,
                                           uint32_t chunk_bytes, int t,
                                           int heads, int units, int batch,
                                           int head, int r0, int rows,
                                           int tid) {
  const int live_rows = min(rows, t - r0);
  const size_t stride = (size_t)heads * units * 16;
  uint8_t* const base = dst + (((size_t)batch * t + r0) * heads + head) *
                                  units * 16;
  for (int e = tid; e < live_rows * units; e += 128) {
    const int row = e / units, u = e % units;
    *reinterpret_cast<uint4*>(base + row * stride + u * 16) =
        *reinterpret_cast<const uint4*>(tile + swizzled(row, u * 16,
                                                        chunk_bytes));
  }
}

// Keeps the compiler from moving an accumulator across wgmma issue / wait.
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The 4-D map (hd, heads, t, b) of a contiguous [b, t, heads, hd] tensor of
// `elem`-byte elements of type `type`, boxes of (cols, 1, rows, 1) with the
// 128-byte swizzle (cols * elem = 128).  TMA needs each row's stride,
// hd * elem, to be a multiple of 16 bytes and the tensor 16-byte aligned
// (and a box's first column to start on 16 bytes: a map over whole
// tokens, boxes from column head * hd, faults there); the wrapper pads
// any other hd.
int make_map(CUtensorMap* map, CUtensorMapDataType type, int elem,
             const void* ptr, int b, int t, int heads, int hd, int cols,
             int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)t, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * elem,
                                 (cuuint64_t)heads * hd * elem,
                                 (cuuint64_t)t * heads * hd * elem};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = fn(
      map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
