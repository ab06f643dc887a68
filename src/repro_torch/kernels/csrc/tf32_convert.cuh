// The TF32 split and the converters of the 3xTF32 attention kernels
// (flash_attention_tf32x3.cu, the forward, and flash_attention_bwd_tf32x3.cu,
// the backward), which include this header into their anonymous namespace
// after tma_wgmma.cuh, whose `swizzled` (TMA's 128-byte swizzle) it uses.
// Written without PTX, so that tests/cuda_emu/ compiles it with g++.
//
// A TF32 operand of the tensor cores keeps an fp32 value's top 19 bits, so
// a product a b runs as three: a_hi b_hi + a_hi b_lo + a_lo b_hi, with
// x_hi = x with its low 13 mantissa bits cleared and x_lo = x - x_hi (exact
// in fp32); the dropped a_lo b_lo is under 2^-22 of the product.  An operand
// in shared memory is read as its hi term, so a stage holds x as it is and,
// where the lo term is a B operand, x_lo beside it.
//
// wgmma's .tf32 form reads B K-major only.  Where a product's natural B is
// MN-major (the forward's V in P V, the backward's dO, Q and K), producer
// threads write it transposed: row n of the copy holds column n of the
// tile, keys (or query rows) contiguous, each 8 in the order 0 2 4 6 1 3 5 7.
// That is the order in which an m64nNk8 accumulator's registers form the A
// fragment of the next product: element 4 kk + 2 r + j of a thread holds
// key 8 kk + 2 tg + j, and the fragment's k index tg stands for key 2 tg,
// tg + 4 for key 2 tg + 1.

// x with the low 13 mantissa bits cleared: the value a TF32 operand keeps.
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}

// x as TF32 terms hi and lo = x - hi (exact), as the bits of two operands.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const float h = tf32_hi(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(x - h);
}

// The lo terms of a tile of `bytes` bytes of fp32 (any layout: element by
// element), from src to dst, by thread `tid` of `threads`.
__device__ __forceinline__ void lo_tile(const uint8_t* src, uint8_t* dst,
                                        uint32_t bytes, int tid,
                                        int threads) {
  for (int e = tid; e < (int)(bytes / 16); e += threads) {
    const float4 x = reinterpret_cast<const float4*>(src)[e];
    reinterpret_cast<float4*>(dst)[e] =
        make_float4(x.x - tf32_hi(x.x), x.y - tf32_hi(x.y),
                    x.z - tf32_hi(x.z), x.w - tf32_hi(x.w));
  }
}

// Byte offset of 16-byte unit u (keys 4 u .. 4 u + 3 in the order above) of
// row n of a transposed tile of kKeys keys a row and `t_rows` rows: 16 keys,
// one 64-byte row (the 64-byte swizzle: unit u at u ^ ((n / 2) % 4)); 32 or
// 64, 128-byte rows of 32 keys (the 128-byte swizzle), a chunk of t_rows
// rows per 32 keys.
template <int kKeys>
__device__ __forceinline__ uint32_t t_unit(int n, int u, int t_rows) {
  if constexpr (kKeys == 16)
    return n * 64 + ((u ^ ((n >> 1) & 3)) << 4);
  else
    return (u / 8) * t_rows * 128 + swizzled(n, 16 * (u % 8), 0);
}

// Rows [0, rows) of the transposed copy of a TMA tile `src` of kKeys rows
// ([32-column chunk][kKeys rows][128 bytes], 128-byte swizzle): row n holds
// column c0 + n of the tile's rows, in t_unit's layout (t_rows rows), as
// written (dst) and as lo terms (dst_lo); by thread `tid` of `threads`.
// Columns past the tensor's width are zeros in the tile (TMA's fill), and
// so are the rows they become.
template <int kKeys>
__device__ __forceinline__ void transpose_tile(const uint8_t* src,
                                               uint8_t* dst, uint8_t* dst_lo,
                                               int c0, int rows, int t_rows,
                                               int tid, int threads) {
  // Item (n, g4): column c0 + n of rows 8 (g4 / 2) + 2 i + g4 % 2, i < 4,
  // to unit g4 of row n.
  for (int e = tid; e < rows * (kKeys / 4); e += threads) {
    const int n = e % rows, g4 = e / rows;
    const int key0 = 8 * (g4 / 2) + g4 % 2;
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float*>(
          src + swizzled(key0 + 2 * i, 4 * (c0 + n), kKeys * 128));
    const uint32_t off = t_unit<kKeys>(n, g4, t_rows);
    *reinterpret_cast<float4*>(dst + off) = make_float4(x[0], x[1], x[2],
                                                        x[3]);
    *reinterpret_cast<float4*>(dst_lo + off) = make_float4(
        x[0] - tf32_hi(x[0]), x[1] - tf32_hi(x[1]), x[2] - tf32_hi(x[2]),
        x[3] - tf32_hi(x[3]));
  }
}
