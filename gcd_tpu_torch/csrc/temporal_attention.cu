// K2: frame-axis (temporal) self-attention on the natural (B*T, S, C)
// layout, for Hopper (sm_90a): TMA-fed, on mma.sync tensor cores.
//
// Replaces gcd_tpu/ops/temporal_attention.py::_kernel (pallas_call in
// _pallas_fwd, entry temporal_attention). For every video b, spatial
// position s and head h, the T frames attend to each other:
//     s_tt' = (q_t . k_t') * scale                     fp32
//     p_tt' = exp(s_tt' - max_t' s_tt')                fp32, unnormalised
//     o_t   = (sum_t' bf16(p_tt') v_t') / sum_t' p_tt'  fp32 sums
// and o is rounded once to bf16: the TPU kernel's rounding points (P to
// bf16 before PV, the fp32 row sum of the unrounded P, the division after
// PV), which temporal_attention_plain repeats.
//
// What bounds it: bytes. q, k, v are read once and o written once, 8 bytes
// a value: 110 MB at the UNet's ds1 shape (28, 1536, 320), 0.033 ms at 3.35
// TB/s. The products are 4 T^2 D flops a (b, s, h), 0.77 GFLOP at ds1, well
// under a microsecond of the tensor cores. So the design keeps many loads
// in flight on every SM to cover the memory's latency, and keeps the little
// arithmetic on the tensor cores, out of the loads' way.
//
// Design.
//  - A unit of work is one (video b, position s, head h). Each tensor is
//    read through a 4D TMA map over (C, S, T, B) -- innermost first, strides
//    2, 2 C, 2 S C and 2 T S C bytes -- and one box (64, 1, 16 MT, 1) at
//    (h D + 64 j, s, 0, b) brings channels h D + 64 j .. + 63 of all the
//    video's frames at s: 16 MT rows of 128 bytes, 128-byte swizzled. Frames
//    t >= T lie outside the map's T dimension and are zero-filled, so T is
//    padded to MT row tiles of 16 (the m16 of mma.sync) without reading the
//    next video: MT = 1 for T <= 16, MT = 2 for T = 17 .. 32. D = 128 takes
//    two boxes; a D below 64 uses the first D channels of its box (channels
//    past C are zero-filled too).
//  - Every warp owns a ring of STAGES units (q, k and v of one unit a stage)
//    with a full mbarrier a stage. The grid is persistent: warp w of the
//    grid's N takes units w, w + N, ...; unit u is head u % H of position
//    (u / H) % S of video u / (H S), so neighbouring warps read neighbouring
//    128-byte pieces of the same frame rows. When the warp is done with a
//    stage, its lane 0 loads the unit STAGES rounds ahead into it. There is
//    no producer warp and no empty barrier, and no warp ever waits for
//    another: each keeps one unit's loads (5.25 KB of HBM at D = 64) in
//    flight while it computes another, 16 warps an SM (four blocks of WARPS,
//    49 KB of shared memory each). What a warp waits on is the chain of its
//    unit's arithmetic rather than the loads: on the H100 rings of 3 or 4
//    units at 8 to 12 warps an SM ran slower than 2 units at 15 or 16.
//  - Products with mma.sync m16n8k16, bf16 in, fp32 accumulate, one warp a
//    unit, which takes its MT query strips of 16 rows one after the other.
//    A strip's S = Q K^T is 16 x 16 MT (D / 16 k-steps, 2 MT n-tiles; Q and
//    K through ldmatrix). Key columns >= T get -inf before the row max (quad
//    shuffles); P = exp(s - max) in fp32, the row sums from that fp32 P, and
//    P rounded to bf16 straight into the A fragments of PV (the accumulator
//    layout of two n-tiles of S is the m16n8k16 A layout of one k-step). V
//    comes through ldmatrix.trans; O = P V takes D / 8 n-tiles of MT
//    k-steps.
//  - O is divided by the row sum (one rounded reciprocal a row and a
//    residual step, the same bits as a division: `div_by`), rounded to bf16
//    and written over the strip's own Q rows in the same swizzle (the next
//    strip reads only its own Q rows), then, once every strip is done, read
//    back 16 bytes a lane and stored: 8 lanes write one frame's 128
//    contiguous bytes of the head; rows t >= T are not stored.
//  - The swizzle puts chunk j of frame row t at chunk j ^ (t % 8), so the
//    eight rows one ldmatrix matrix reads (frames 8 i .. 8 i + 7 of a
//    chunk), and the output's writes and read-back, fall in distinct banks.
//  - At MT = 2 a stage is twice the bytes, so an SM holds half the warps
//    (8 at D <= 64, 4 at D = 80 .. 128) with the same bytes in flight.
//  - No atomics and nothing shared between warps: bit-identical from call
//    to call.
// The TPU's 8-position striped mask and head-pair packing fitted the MXU's
// 128-wide tiles; a 16-row mma.sync tile needs neither.
//
// Wide heads (D = 192 .. 512, a multiple of 64: the VAE decoder's
// VideoAttnBlock, one head of width 128 to 512) take a second family,
// temporal_attention_wide_kernel, reached by the same C entry and the same
// maps. A unit's stage is 3 D / 64 boxes (48 KB at D = 512), and O = P V
// over all D / 8 n-tiles would need 4 D / 8 fp32 accumulators a lane (256
// at D = 512). So S = Q K^T runs as above over D / 16 k-steps (one 16 x 16
// tile), P stays in registers as the A fragment, and PV, the division and
// the write over the Q rows go 64 channels (8 n-tiles, 32 accumulators) at
// a time; a block is one warp with a ring of two units, so an SM holds two
// to five blocks as D falls from 512 to 192. Each output value is computed
// by the same instructions as in the narrow family. At the decoder's
// (14, 1536, 512), H = 1, q, k, v and o are 88 MB: 0.026 ms at 3.35 TB/s.
//
// Every other shape up to D = 1024 takes the general family, two kernels
// that take any T >= 1 (clips past 32 frames; the wide heads past 16), any
// D (40, 72, 100, 160: the UNet built with `num_heads` rather than
// `num_head_channels`) and any C, with D padded to DP, the next multiple of
// 16, by zero channels (they add nothing to S, and their O is never
// stored). Where a unit fits (res_takes: T <= 16 RES_MAX_TILES and one
// unit's q, k and v in a block's shared memory), the resident kernel,
// temporal_attention_resident_kernel, holds all of it on chip, as the TPU
// kernel holds its block of frames in VMEM:
//  - A unit is one (video, position, head), a block of MT warps, one a
//    query strip of 16 frames. Its q, k and v come into shared memory once,
//    in the narrow family's layout (boxes of 64 channels x 16 MT frames,
//    128-byte swizzled): by TMA through the same maps where D is a multiple
//    of 16 and C of 8 (a box's channels past D are other heads' and never
//    read), else by 16-byte cp.async (C and D multiples of 8) or 2-byte
//    copies into the same layout, zeros past T and D. The copies complete on
//    the unit's full barrier (cp.async through cp.async.mbarrier.arrive).
//  - The grid is persistent. A block's ring holds two units where two fit
//    and cost the SM no block (res_stages), so the next unit's copies run
//    while the block computes the current one; else one, and the SM's
//    blocks overlap each other's copies (at the one head of 512, two blocks
//    of one unit keep twice the warps of one block of two busy). One block
//    barrier a unit, before its slot is refilled.
//  - A strip's first warp computes its S = Q K^T over every key tile at
//    once, in registers (8 MT fp32 a lane), in the streamed kernel's
//    k-order; then the exact row max, P = exp(s - max) against it, the fp32
//    row sums tile by tile in the streamed kernel's order, and P rounded to
//    bf16 A fragments (4 MT registers). O = P V runs over 64 channels at a
//    time with V from shared memory; O / sum goes over the strip's own Q
//    rows and is stored 16 bytes (or 2) a lane. S is computed once, and q,
//    k, v read from HBM once: the same instructions on the same values as
//    the streamed kernel, so the same bits.
//  - Where D is wide and a unit takes most of an SM's shared memory (the
//    VAE's one head of 512: two units an SM), a strip has 2 or 4 warps
//    (res_wps): the first passes P and the sums to the others through
//    shared memory, and they split O's 64-channel chunks, so the SM runs
//    16 warps instead of 4.
// The rest (T past 128, or a unit past shared memory: one head of 1024
// past 32 frames, of 512 past 64) takes the streamed kernel,
// temporal_attention_general_kernel, which streams the keys:
//  - A unit is still one (video, position, head), a block of W warps: its
//    query strips of 16 frames (T padded to MT = ceil(T / 16) strips), one
//    a warp, W = min(MT, 4) at a time (fewer where shared memory does not
//    hold four at a wide D), take the key and value tiles of 16 frames in
//    turn, each tile loaded once for the W strips. Two passes: the first
//    only computes S = Q K^T tile by tile for the row maxima; the second
//    computes S again (the same instructions: the same bits) and from it P
//    = exp(s - max) against the final row max, the fp32 row sums of that
//    P, P rounded to bf16 and O += P V, then divides O by the sums: the
//    TPU kernel's rounding points. A one-pass online softmax would round P
//    against a running max.
//  - Above DP = 128 the second pass runs once for each 64 channels of O (32
//    accumulators a lane, as the wide family), recomputing S each time.
//  - No TMA: cp.async copies 16 bytes a thread where C and D are multiples
//    of 8 and zero-fills frames past T and channels past D (src-size 0);
//    elsewhere threads load and store 2 bytes each. The block keeps the
//    tiles of its next job (a key tile, its value chunk, a new group of
//    query strips) in flight while it computes the current one.
//  - Shared rows are padded by 16 bytes (an odd multiple of 16 bytes a
//    row), so the eight rows an ldmatrix matrix reads fall in distinct
//    banks without a swizzle at any DP.
//  - Each warp divides its O by the row sums into its own staging tile of
//    the chunk's channels, then stores it 16 bytes (or 2) a lane; frames t
//    >= T and channels past D are not stored.
// Both sum in a fixed order with no atomics: bit-identical from call to
// call. At the UNet's ds1 at T = 100 with CFG, (200, 1536, 320), q, k, v
// and o are 786 MB: 0.235 ms at 3.35 TB/s.

// Requires D = C / H a multiple of 16 up to 128 with T <= 32 (the narrow
// family), or of 64 from 192 up to 512 with T <= 16 (the wide family), or
// any D up to 1024 (the general family's resident or streamed kernel), and
// q, k, v, o 16-byte aligned (the wrapper checks).

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 4;           // warps a block, each with its own ring
constexpr int STAGES = 2;          // units a warp's ring holds
constexpr int ROWS = 16;           // frames a row tile holds (the m16 of mma.sync)
constexpr int MAX_ROW_TILES = 2;   // row tiles a narrow unit takes: T <= 32
constexpr int BOX = ROWS * 128;    // one row tile's box: 16 frames x 64 bf16 channels

template <int DC, int MT = 1>
__host__ __device__ constexpr int stage_bytes() {
  return 3 * DC * MT * BOX;  // q, k, v
}

template <int DC, int MT = 1>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + WARPS * STAGES * (stage_bytes<DC, MT>() + (int)sizeof(uint64_t));
}

// Blocks an SM holds: its 233,472 bytes of shared memory, 1 KB of them
// reserved a block.
template <int DC, int MT = 1>
__host__ __device__ constexpr int blocks_per_sm() {
  return 233472 / (smem_bytes<DC, MT>() + 1024);
}

constexpr int WIDE_WARPS = 1;      // warps a block of the wide family
constexpr int WIDE_STAGES = 2;     // units its ring holds

template <int DC>
__host__ __device__ constexpr int wide_smem_bytes() {
  return 1024 + WIDE_WARPS * WIDE_STAGES * (stage_bytes<DC>() + (int)sizeof(uint64_t));
}

template <int DC>
__host__ __device__ constexpr int wide_blocks_per_sm() {
  return 233472 / (wide_smem_bytes<DC>() + 1024);
}

constexpr int GEN_MAX_D = 1024;      // the general family's largest head size
constexpr int GEN_CHUNK = 64;        // O's channels a second pass above DP = 128
constexpr int GEN_PAD = 8;           // bf16 padding a shared row: rows an odd multiple of 16 B
constexpr int GEN_WARPS = 4;         // most warps a block: one a query strip of the unit
constexpr int GEN_SM_WARPS = 16;     // warps an SM at 128 registers a thread
constexpr int GEN_STAGES = 2;        // jobs a block's ring holds: the one computed, the next
constexpr int GEN_MAX_SMEM = 232448; // dynamic shared memory a block may take
constexpr int RES_MAX_TILES = 8;     // a resident unit's most row tiles: T <= 128, S in registers
constexpr int RES_SM_WARPS = 16;     // warps an SM at 128 registers a thread
constexpr int RES_STAGES = 2;        // units a resident block's ring holds where two fit
constexpr int RES_MAX_WPS = 4;       // most warps a resident query strip
constexpr int RES_WPS_TILES = 4;     // most row tiles a unit of several warps a strip
constexpr int RES_TMA = 0;           // a resident unit's loads: TMA boxes,
constexpr int RES_VEC = 1;           // 16-byte cp.async,
constexpr int RES_SCALAR = 2;        // or 2-byte copies

// D padded to the m16n8k16 depth.
__host__ __device__ constexpr int gen_padded(int d) { return (d + 15) / 16 * 16; }

// O's channels a second pass at padded head size dp.
__host__ __device__ constexpr int gen_chunk(int dp) { return dp <= 128 ? dp : GEN_CHUNK; }

// A block of w warps: GEN_STAGES groups of w query strips and GEN_STAGES
// key tiles (rows of dp), GEN_STAGES value chunks and w output staging tiles
// (rows of the chunk), and 16 bytes to align them.
__host__ __device__ constexpr int gen_smem_bytes(int dp, int w) {
  return 16 + ROWS * 2 * (GEN_STAGES * (w + 1) * (dp + GEN_PAD) +
                          (GEN_STAGES + w) * (gen_chunk(dp) + GEN_PAD));
}

// The warps of a block: one a query strip of the unit's mt, at most
// GEN_WARPS, as many as fit in shared memory.
__host__ __device__ constexpr int gen_warps(int mt, int dp) {
  return mt > 1 && gen_smem_bytes(dp, mt < GEN_WARPS ? mt : GEN_WARPS) > GEN_MAX_SMEM
             ? gen_warps(mt - 1 < GEN_WARPS ? mt - 1 : GEN_WARPS - 1, dp)
             : (mt < GEN_WARPS ? mt : GEN_WARPS);
}

// Blocks an SM holds: its registers, and its 233,472 bytes of shared memory
// with 1 KB reserved a block.
__host__ __device__ constexpr int gen_blocks_per_sm(int dp, int w) {
  return 233472 / (gen_smem_bytes(dp, w) + 1024) < GEN_SM_WARPS / w
             ? 233472 / (gen_smem_bytes(dp, w) + 1024)
             : GEN_SM_WARPS / w;
}

// One resident unit: q, k and v, nb boxes each of 64 channels x 16 mt frames.
__host__ __device__ constexpr int res_unit_bytes(int nb, int mt) { return 3 * nb * mt * BOX; }

// A strip's exchange between its warps: P's A fragments (16 bytes a lane a
// k-step) and a lane's two row sums; a block's, at wps warps a strip.
__host__ __device__ constexpr int res_xch_strip(int mt) { return 512 * mt + 256; }
__host__ __device__ constexpr int res_xch_bytes(int mt, int wps) {
  return wps > 1 ? mt * res_xch_strip(mt) : 0;
}

// A resident block whose ring holds `stages` units at wps warps a strip: 1
// KB to align the boxes, the units, 16 bytes of full barriers, the
// exchange.
__host__ __device__ constexpr int res_smem(int nb, int mt, int stages, int wps) {
  return 1024 + stages * res_unit_bytes(nb, mt) + 16 + res_xch_bytes(mt, wps);
}

// Resident blocks an SM holds at `stages` units a ring and wps warps a
// strip: its 233,472 bytes of shared memory with 1 KB reserved a block, and
// RES_SM_WARPS warps; none where a block's shared memory is past
// GEN_MAX_SMEM.
__host__ __device__ constexpr int res_blocks(int nb, int mt, int stages, int wps) {
  return res_smem(nb, mt, stages, wps) > GEN_MAX_SMEM ? 0
         : 233472 / (res_smem(nb, mt, stages, wps) + 1024) < RES_SM_WARPS / (mt * wps)
             ? 233472 / (res_smem(nb, mt, stages, wps) + 1024)
             : RES_SM_WARPS / (mt * wps);
}

// Units a resident block's ring holds: two where they cost the SM no
// block, else one (the SM's blocks then overlap each other's loads).
__host__ __device__ constexpr int res_stages(int nb, int mt, int wps) {
  return res_blocks(nb, mt, RES_STAGES, wps) >= res_blocks(nb, mt, 1, wps) ? RES_STAGES : 1;
}

// Warps an SM runs at wps warps a strip.
__host__ __device__ constexpr int res_sm_warps(int nb, int mt, int wps) {
  return res_blocks(nb, mt, res_stages(nb, mt, wps), wps) * mt * wps;
}

// Warps a resident block gives each query strip: 1, 2 or 4 (up to
// RES_WPS_TILES strips, no more than O's nb chunks), the most warps an SM
// runs, the fewest a strip on a tie.
__host__ __device__ constexpr int res_wps(int nb, int mt) {
  int best = 1;
  for (int w = 2; w <= RES_MAX_WPS && w <= nb && mt <= RES_WPS_TILES; w *= 2)
    if (res_sm_warps(nb, mt, w) > res_sm_warps(nb, mt, best)) best = w;
  return best;
}

// Whether the resident kernel takes units of mt row tiles at padded head
// size dp: a strip's S in registers, one unit in shared memory.
__host__ __device__ constexpr bool res_takes(int mt, int dp) {
  return mt <= RES_MAX_TILES && res_smem((dp + 63) / 64, mt, 1, 1) <= GEN_MAX_SMEM;
}

// Shared address of 16-byte chunk c (of the head's channels) of frame row r
// in a tensor's boxes of MT row tiles at `tile`.
template <int MT = 1>
__device__ __forceinline__ uint32_t chunk_at(uint32_t tile, int r, int c) {
  return tile + (c >> 3) * (MT * BOX) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// a / b rounded to nearest, as a division gives it, from r = 1 / b rounded
// to nearest: q = a r, then q + r (a - q b) with fused multiply-adds
// (Markstein: exact rounding for quotients of normal range). One rounded
// reciprocal a row replaces a div.rn for each of the row's values.
__device__ __forceinline__ float div_by(float a, float b, float r) {
  const float q = a * r;
  return fmaf(fmaf(-q, b, a), r, q);
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}

__device__ __forceinline__ void st_shared_v2f(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}

__device__ __forceinline__ float2 ld_shared_v2f(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_u16(uint32_t addr, unsigned short v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(v) : "memory");
}

__device__ __forceinline__ unsigned short ld_shared_u16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr) : "memory");
  return v;
}

// 16 bytes from global to shared memory, asynchronously; zeros when !valid
// (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most the N newest committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// An arrival on `bar` once this thread's earlier cp.async copies are done
// (noinc: the barrier's count includes it).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Frames t0 .. t0 + rows - 1 of channels c0 .. c0 + w - 1 of a head slab
// (`src`: frame 0 of one (video, position, head), frames `fs` elements
// apart) into a shared tile of rows `rs` bytes apart, by threads `tid` of
// `threads`: frames >= T and channels >= D read as zero. VEC: 16-byte
// cp.async a thread (C, D and c0 multiples of 8); else 2-byte loads and
// stores.
template <bool VEC>
__device__ __forceinline__ void load_rows(uint32_t dst, int rs, const bf16* src, size_t fs,
                                          int t0, int rows, int T, int c0, int w, int D,
                                          int tid, int threads) {
  // Thread tid copies pieces tid, tid + threads, ... of the rows x per_row
  // pieces: row r, piece c, stepped without a division.
  const int per_row = VEC ? w / 8 : w, width = VEC ? 8 : 1;
  const int dr = threads / per_row, dc = threads % per_row;
  int r = tid / per_row, c = tid % per_row;
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
  for (int idx = tid; idx < rows * per_row; idx += threads) {
    const bool ok = t0 + r < T && c0 + width * c < D;
    const size_t at = (size_t)(t0 + r) * fs + c0 + width * c;
    if (VEC)
      cp_async_16(dst + r * rs + 16 * c, ok ? src + at : src, ok);
    else
      st_shared_u16(dst + r * rs + 2 * c, ok ? s16[at] : 0);
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// Frames 0 .. 16 MT - 1 of channels 0 .. DP - 1 of a head slab (`src`,
// frames `fs` elements apart) into boxes of MT row tiles at `tile`, in the
// TMA layout (chunk_at), by threads `tid` of `threads`: frames >= T and
// channels >= D read as zero. VEC: 16-byte cp.async a thread (C and D
// multiples of 8); else 2-byte loads and stores.
template <int MT, bool VEC>
__device__ __forceinline__ void load_boxes(uint32_t tile, const bf16* src, size_t fs, int T,
                                           int D, int DP, int tid, int threads) {
  const int per_row = VEC ? DP / 8 : DP;
  const int dr = threads / per_row, dc = threads % per_row;
  int r = tid / per_row, c = tid % per_row;
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
  for (int idx = tid; idx < MT * ROWS * per_row; idx += threads) {
    if (VEC) {
      const bool ok = r < T && 8 * c < D;
      cp_async_16(chunk_at<MT>(tile, r, c), ok ? src + (size_t)r * fs + 8 * c : src, ok);
    } else {
      const bool ok = r < T && c < D;
      st_shared_u16(chunk_at<MT>(tile, r, c >> 3) + 2 * (c & 7), ok ? s16[(size_t)r * fs + c] : 0);
    }
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// A block's place in the general family's job order: unit u (frame 0 of
// its head at `at`), strip group g, pass p, key tile n; and the jobs and
// strip groups since the block's first, whose residues mod GEN_STAGES are
// the ring slots a job loads into.
struct GenJob {
  long long u;
  size_t at;
  int g, p, n;
  unsigned job, group;
};

template <int KC, int MT>  // D = 16 KC, T padded to 16 MT rows
__global__ void __launch_bounds__(WARPS * 32, blocks_per_sm<(KC + 3) / 4, MT>())
temporal_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                          int T, int S, int H, long long units, float scale) {
  constexpr int D = 16 * KC;
  constexpr int DC = (D + 63) / 64;  // boxes a tensor
  constexpr int CHUNKS = D / 8;      // 16-byte chunks of a frame's head
  constexpr int TBOX = MT * BOX;     // one box of all the unit's rows
  constexpr int STAGE = stage_bytes<DC, MT>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* ring = base + warp * STAGES * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + WARPS * STAGES * STAGE) + warp * STAGES;
  const long long step = (long long)gridDim.x * WARPS;
  const long long first = (long long)blockIdx.x * WARPS + warp;
  const size_t C = (size_t)H * D;

  auto load = [&](long long u, int st) {
    const int h = (int)(u % H), s = (int)((u / H) % S), b = (int)(u / H / S);
    unsigned char* dst = ring + st * STAGE;
    mbar_arrive_expect_tx(&full[st], STAGE);
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      tma_load_4d(dst + j * TBOX, &qmap, &full[st], h * D + 64 * j, s, 0, b);
      tma_load_4d(dst + (DC + j) * TBOX, &kmap, &full[st], h * D + 64 * j, s, 0, b);
      tma_load_4d(dst + (2 * DC + j) * TBOX, &vmap, &full[st], h * D + 64 * j, s, 0, b);
    }
  };
  if (lane == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(&full[st], 1);
    mbar_fence_init();
    for (int st = 0; st < STAGES; ++st)
      if (first + st * step < units) load(first + st * step, st);
  }
  __syncwarp();

  // ldmatrix rows: Q (A) and V (B, transposed) take frame lane % 16 of chunk
  // pair lane / 16 (of their row tile); K (B) takes key frame lane % 8 + 8
  // (lane / 16) of chunk (lane / 8) % 2.
  const int a_row = lane & 15, a_chunk = lane >> 4;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_chunk = (lane >> 3) & 1;
  const int g = lane >> 2, cq = 2 * (lane & 3);  // accumulator row and column
  int i = 0;
  for (long long u = first; u < units; u += step, ++i) {
    const int st = i % STAGES;
    const uint32_t qs = smem_u32(ring + st * STAGE), ks = qs + DC * TBOX, vs = ks + DC * TBOX;
    mbar_wait(&full[st], (i / STAGES) & 1);

#pragma unroll 1
    for (int m = 0; m < MT; ++m) {  // query strip m: rows 16 m .. 16 m + 15
      const int row0 = ROWS * m;
      float sc[2 * MT][4] = {};
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t a[4];
        ldsm_x4(a, chunk_at<MT>(qs, row0 + a_row, 2 * kc + a_chunk));
#pragma unroll
        for (int n = 0; n < MT; ++n) {
          uint32_t kb[4];
          ldsm_x4(kb, chunk_at<MT>(ks, ROWS * n + k_row, 2 * kc + k_chunk));
          mma_bf16_16816(sc[2 * n], a, kb[0], kb[1]);
          mma_bf16_16816(sc[2 * n + 1], a, kb[2], kb[3]);
        }
      }
      // sc[n][0..1]: row g, key columns 8 n + cq + {0, 1}; sc[n][2..3]: row g + 8.
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 2 * MT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = 8 * n + cq + (e & 1) < T ? sc[n][e] * scale : -INFINITY;
          sc[n][e] = x;
          if (e < 2) m0 = fmaxf(m0, x);
          else m1 = fmaxf(m1, x);
        }
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
      float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
      for (int n = 0; n < 2 * MT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(sc[n][e] - (e < 2 ? m0 : m1));
          sc[n][e] = p;
          if (e < 2) l0 += p;
          else l1 += p;
        }
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      uint32_t pa[MT][4];  // k-step n: key columns 16 n .. 16 n + 15
#pragma unroll
      for (int n = 0; n < MT; ++n) {
        pa[n][0] = pack_bf16(sc[2 * n][0], sc[2 * n][1]);
        pa[n][1] = pack_bf16(sc[2 * n][2], sc[2 * n][3]);
        pa[n][2] = pack_bf16(sc[2 * n + 1][0], sc[2 * n + 1][1]);
        pa[n][3] = pack_bf16(sc[2 * n + 1][2], sc[2 * n + 1][3]);
      }
      float acc[CHUNKS][4] = {};
#pragma unroll
      for (int j = 0; j < CHUNKS; j += 2)
#pragma unroll
        for (int n = 0; n < MT; ++n) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, chunk_at<MT>(vs, ROWS * n + a_row, j + a_chunk));
          mma_bf16_16816(acc[j], pa[n], vb[0], vb[1]);
          mma_bf16_16816(acc[j + 1], pa[n], vb[2], vb[3]);
        }

      // O / rowsum over this strip's Q rows (every lane's ldmatrix of them
      // is done).
      __syncwarp();
      const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);
#pragma unroll
      for (int j = 0; j < CHUNKS; ++j) {
        st_shared_u32(chunk_at<MT>(qs, row0 + g, j) + 2 * cq,
                      pack_bf16(div_by(acc[j][0], l0, r0), div_by(acc[j][1], l0, r0)));
        st_shared_u32(chunk_at<MT>(qs, row0 + g + 8, j) + 2 * cq,
                      pack_bf16(div_by(acc[j][2], l1, r1), div_by(acc[j][3], l1, r1)));
      }
    }
    // 16-byte stores of frames t < T.
    __syncwarp();
    const int h = (int)(u % H), s = (int)((u / H) % S), b = (int)(u / H / S);
    bf16* out = o + ((size_t)b * T * S + s) * C + (size_t)h * D;
#pragma unroll
    for (int idx = lane; idx < MT * ROWS * CHUNKS; idx += 32) {
      const int t = idx / CHUNKS, c = idx % CHUNKS;
      if (t < T)
        *reinterpret_cast<uint4*>(out + (size_t)t * S * C + 8 * c) =
            ld_shared_v4(chunk_at<MT>(qs, t, c));
    }
    // This warp's reads and writes of the stage come before the TMA refill.
    fence_proxy_async();
    __syncwarp();
    if (lane == 0 && u + STAGES * step < units) load(u + STAGES * step, st);
  }
}

// The wide family (D = 64 DC, DC = 3 .. 8): the narrow kernel's schedule
// with one warp a block, and PV in 64-channel chunks.
template <int DC>
__global__ void __launch_bounds__(WIDE_WARPS * 32, wide_blocks_per_sm<DC>())
temporal_attention_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               bf16* __restrict__ o, int T, int S, int H, long long units,
                               float scale) {
  constexpr int D = 64 * DC;
  constexpr int KC = D / 16;       // k-steps of S = Q K^T
  constexpr int CHUNKS = D / 8;    // 16-byte chunks of a frame's head
  constexpr int STAGE = stage_bytes<DC>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* ring = base + warp * WIDE_STAGES * STAGE;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(base + WIDE_WARPS * WIDE_STAGES * STAGE) + warp * WIDE_STAGES;
  const long long step = (long long)gridDim.x * WIDE_WARPS;
  const long long first = (long long)blockIdx.x * WIDE_WARPS + warp;
  const size_t C = (size_t)H * D;

  auto load = [&](long long u, int st) {
    const int h = (int)(u % H), s = (int)((u / H) % S), b = (int)(u / H / S);
    unsigned char* dst = ring + st * STAGE;
    mbar_arrive_expect_tx(&full[st], STAGE);
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      tma_load_4d(dst + j * BOX, &qmap, &full[st], h * D + 64 * j, s, 0, b);
      tma_load_4d(dst + (DC + j) * BOX, &kmap, &full[st], h * D + 64 * j, s, 0, b);
      tma_load_4d(dst + (2 * DC + j) * BOX, &vmap, &full[st], h * D + 64 * j, s, 0, b);
    }
  };
  if (lane == 0) {
    for (int st = 0; st < WIDE_STAGES; ++st) mbar_init(&full[st], 1);
    mbar_fence_init();
    for (int st = 0; st < WIDE_STAGES; ++st)
      if (first + st * step < units) load(first + st * step, st);
  }
  __syncwarp();

  const int a_row = lane & 15, a_chunk = lane >> 4;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_chunk = (lane >> 3) & 1;
  const int g = lane >> 2, cq = 2 * (lane & 3);
  int i = 0;
  for (long long u = first; u < units; u += step, ++i) {
    const int st = i % WIDE_STAGES;
    const uint32_t qs = smem_u32(ring + st * STAGE), ks = qs + DC * BOX, vs = ks + DC * BOX;
    mbar_wait(&full[st], (i / WIDE_STAGES) & 1);

    float sc[2][4] = {};
#pragma unroll 8
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t a[4], kb[4];
      ldsm_x4(a, chunk_at(qs, a_row, 2 * kc + a_chunk));
      ldsm_x4(kb, chunk_at(ks, k_row, 2 * kc + k_chunk));
      mma_bf16_16816(sc[0], a, kb[0], kb[1]);
      mma_bf16_16816(sc[1], a, kb[2], kb[3]);
    }
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = 8 * n + cq + (e & 1) < T ? sc[n][e] * scale : -INFINITY;
        sc[n][e] = x;
        if (e < 2) m0 = fmaxf(m0, x);
        else m1 = fmaxf(m1, x);
      }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[n][e] - (e < 2 ? m0 : m1));
        sc[n][e] = p;
        if (e < 2) l0 += p;
        else l1 += p;
      }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
    const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);

    // Every lane's ldmatrix of the Q rows is done: each 64-channel chunk of
    // O / rowsum goes over them as soon as it is summed.
    __syncwarp();
#pragma unroll 1
    for (int cb = 0; cb < DC; ++cb) {
      float acc[8][4] = {};
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, chunk_at(vs, a_row, 8 * cb + j + a_chunk));
        mma_bf16_16816(acc[j], pa, vb[0], vb[1]);
        mma_bf16_16816(acc[j + 1], pa, vb[2], vb[3]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        st_shared_u32(chunk_at(qs, g, 8 * cb + j) + 2 * cq,
                      pack_bf16(div_by(acc[j][0], l0, r0), div_by(acc[j][1], l0, r0)));
        st_shared_u32(chunk_at(qs, g + 8, 8 * cb + j) + 2 * cq,
                      pack_bf16(div_by(acc[j][2], l1, r1), div_by(acc[j][3], l1, r1)));
      }
    }
    __syncwarp();
    const int h = (int)(u % H), s = (int)((u / H) % S), b = (int)(u / H / S);
    bf16* out = o + ((size_t)b * T * S + s) * C + (size_t)h * D;
#pragma unroll 4
    for (int idx = lane; idx < ROWS * CHUNKS; idx += 32) {
      const int t = idx / CHUNKS, c = idx % CHUNKS;
      if (t < T)
        *reinterpret_cast<uint4*>(out + (size_t)t * S * C + 8 * c) =
            ld_shared_v4(chunk_at(qs, t, c));
    }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0 && u + WIDE_STAGES * step < units) load(u + WIDE_STAGES * step, st);
  }
}

// The general family (any T, any D up to GEN_MAX_D): a block of W warps
// takes a unit's query strips W at a time (a strip group), warp w strip
// W g + w of group g, and streams the unit's key tiles through shared
// memory for all of them, in two passes; PV over CW = 16 NCH channels at a
// time. A block's jobs, in order (GenJob, `next`): for each of its units
// (first, first + step, ...), for each strip group g, pass 0 over the key
// tiles n (the row maxima), then pass 1 + c over them for each channel
// chunk c (P, the row sums in chunk 0, O += P V). A job loads into slot
// job % GEN_STAGES of the key and value tiles and, when it starts a strip
// group, into query slot group % GEN_STAGES; every thread issues the
// copies of the job GEN_STAGES - 1 ahead before the block computes the
// current one.
template <int NCH, bool VEC>
__global__ void __launch_bounds__(GEN_WARPS * 32, GEN_SM_WARPS / GEN_WARPS)
temporal_attention_general_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, bf16* __restrict__ o, int T,
                                  int S, int H, int D, long long units, float scale) {
  constexpr int CW = 16 * NCH;
  const int W = blockDim.x / 32, threads = blockDim.x;
  const int DP = gen_padded(D), KC = DP / 16;
  const int RQ = 2 * (DP + GEN_PAD), RV = 2 * (CW + GEN_PAD);  // row strides, bytes
  const int MT = (T + ROWS - 1) / ROWS;
  const int passes = 1 + (DP + CW - 1) / CW, groups = (MT + W - 1) / W;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qb = (smem_u32(smem_raw) + 15) & ~15u, kb = qb + GEN_STAGES * W * ROWS * RQ,
                 vb = kb + GEN_STAGES * ROWS * RQ, ob = vb + GEN_STAGES * ROWS * RV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long step = gridDim.x, first = blockIdx.x;
  const size_t C = (size_t)H * D, fs = (size_t)S * C;

  auto slab = [&](long long u) {  // offset of frame 0 of unit u's head
    const int h = (int)(u % H), s = (int)((u / H) % S);
    return ((size_t)(u / H / S) * T * S + s) * C + (size_t)h * D;
  };
  auto next = [&](GenJob& j) {  // the job after j in the block's order
    ++j.job;
    if (++j.n < MT) return;
    j.n = 0;
    if (++j.p < passes) return;
    j.p = 0;
    ++j.group;
    if (++j.g < groups) return;
    j.g = 0;
    j.u += step;
    if (j.u < units) j.at = slab(j.u);
  };
  auto issue = [&](const GenJob& j) {
    const int slot = (int)(j.job % GEN_STAGES);
    if (j.p == 0 && j.n == 0)
      load_rows<VEC>(qb + (int)(j.group % GEN_STAGES) * W * ROWS * RQ, RQ, q + j.at, fs,
                     ROWS * W * j.g, ROWS * W, T, 0, DP, D, tid, threads);
    load_rows<VEC>(kb + slot * ROWS * RQ, RQ, k + j.at, fs, ROWS * j.n, ROWS, T, 0, DP, D, tid,
                   threads);
    if (j.p > 0)
      load_rows<VEC>(vb + slot * ROWS * RV, RV, v + j.at, fs, ROWS * j.n, ROWS, T,
                     CW * (j.p - 1), CW, D, tid, threads);
  };

  const int a_row = lane & 15, a_chunk = lane >> 4;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_chunk = (lane >> 3) & 1;
  const int g4 = lane >> 2, cq = 2 * (lane & 3);
  const uint32_t os = ob + warp * ROWS * RV;  // this warp's output staging tile
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f, r0 = 0.0f, r1 = 0.0f;
  float acc[2 * NCH][4];
  if (first >= units) return;
  GenJob cur{first, slab(first), 0, 0, 0, 0u, 0u}, ahead = cur;
  for (int i = 0; i < GEN_STAGES - 1; ++i) {
    if (ahead.u < units) {
      issue(ahead);
      next(ahead);
    }
    cp_async_commit();
  }
  for (; cur.u < units; next(cur)) {
    __syncthreads();  // every thread is done with the slots the job ahead refills
    if (ahead.u < units) {
      issue(ahead);
      next(ahead);
    }
    cp_async_commit();
    cp_async_wait<GEN_STAGES - 1>();
    __syncthreads();  // this job's tiles, every thread's copies
    const int p = cur.p, n = cur.n, m = W * cur.g + warp;  // m: this warp's query strip
    if (m >= MT) continue;  // no strip for this warp in the unit's last group
    const uint32_t qs = qb + ((int)(cur.group % GEN_STAGES) * W + warp) * ROWS * RQ,
                   ks = kb + (int)(cur.job % GEN_STAGES) * ROWS * RQ,
                   vs = vb + (int)(cur.job % GEN_STAGES) * ROWS * RV;

    // S = Q K^T of key tile n: sc[i][0..1] row g4, key columns 16 n + 8 i +
    // cq + {0, 1}; sc[i][2..3] row g4 + 8.
    float sc[2][4] = {};
#pragma unroll 4
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t a[4], kf[4];
      ldsm_x4(a, qs + a_row * RQ + (2 * kc + a_chunk) * 16);
      ldsm_x4(kf, ks + k_row * RQ + (2 * kc + k_chunk) * 16);
      mma_bf16_16816(sc[0], a, kf[0], kf[1]);
      mma_bf16_16816(sc[1], a, kf[2], kf[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[i][e] = ROWS * n + 8 * i + cq + (e & 1) < T ? sc[i][e] * scale : -INFINITY;

    if (p == 0) {  // the row maxima, over every key tile
      if (n == 0) m0 = m1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m0 = fmaxf(m0, fmaxf(sc[i][0], sc[i][1]));
        m1 = fmaxf(m1, fmaxf(sc[i][2], sc[i][3]));
      }
      if (n == MT - 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
      }
      continue;
    }
    if (n == 0) {
#pragma unroll
      for (int i = 0; i < 2 * NCH; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
      if (p == 1) l0 = l1 = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = expf(sc[i][e] - (e < 2 ? m0 : m1));
    if (p == 1) {
      l0 += (sc[0][0] + sc[0][1]) + (sc[1][0] + sc[1][1]);
      l1 += (sc[0][2] + sc[0][3]) + (sc[1][2] + sc[1][3]);
    }
    // P of this tile, rounded to bf16, is the A fragment of one PV k-step.
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
    const int c0 = CW * (p - 1);
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      if (c0 + 16 * i < DP) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, vs + a_row * RV + (2 * i + a_chunk) * 16);
        mma_bf16_16816(acc[2 * i], pa, vf[0], vf[1]);
        mma_bf16_16816(acc[2 * i + 1], pa, vf[2], vf[3]);
      }
    }
    if (n < MT - 1) continue;

    // The strip's chunk of O is summed: divide, stage, store.
    if (p == 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      r0 = __frcp_rn(l0);
      r1 = __frcp_rn(l1);
    }
#pragma unroll
    for (int i = 0; i < 2 * NCH; ++i) {
      st_shared_u32(os + g4 * RV + 2 * (8 * i + cq),
                    pack_bf16(div_by(acc[i][0], l0, r0), div_by(acc[i][1], l0, r0)));
      st_shared_u32(os + (g4 + 8) * RV + 2 * (8 * i + cq),
                    pack_bf16(div_by(acc[i][2], l1, r1), div_by(acc[i][3], l1, r1)));
    }
    __syncwarp();
    bf16* out = o + cur.at + (size_t)ROWS * m * fs + c0;
    if (VEC) {
      for (int idx = lane; idx < ROWS * CW / 8; idx += 32) {
        const int r = idx / (CW / 8), c = 8 * (idx % (CW / 8));
        if (ROWS * m + r < T && c0 + c < D)
          *reinterpret_cast<uint4*>(out + (size_t)r * fs + c) = ld_shared_v4(os + r * RV + 2 * c);
      }
    } else {
      unsigned short* o16 = reinterpret_cast<unsigned short*>(out);
      for (int idx = lane; idx < ROWS * CW; idx += 32) {
        const int r = idx / CW, c = idx % CW;
        if (ROWS * m + r < T && c0 + c < D) o16[(size_t)r * fs + c] = ld_shared_u16(os + r * RV + 2 * c);
      }
    }
  }
}

// The resident general kernel (units of MT row tiles, any D up to
// GEN_MAX_D where res_takes): block b takes units b, b + grid, ...; warp w
// of its MT WPS takes query strip w % MT and, of O's 64-channel chunks,
// those w / MT + WPS i; a ring of `stages` units, unit u computed from slot
// i % stages (its i-th unit), loaded when the slot's previous unit is done.
// The first MT warps compute their strips' S, P and sums; with WPS > 1
// they pass P and the sums to the strip's other warps through shared memory,
// behind the strip's named barrier.
template <int MT, int WPS>
__global__ void __launch_bounds__(MT * WPS * 32, RES_SM_WARPS / (MT * WPS))
temporal_attention_resident_kernel(const __grid_constant__ CUtensorMap qmap,
                                   const __grid_constant__ CUtensorMap kmap,
                                   const __grid_constant__ CUtensorMap vmap,
                                   const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, bf16* __restrict__ o, int T,
                                   int S, int H, int D, int mode, int stages, long long units,
                                   float scale) {
  constexpr int TBOX = MT * BOX;  // one box of all the unit's rows
  constexpr int THREADS = MT * WPS * 32;
  const int DP = gen_padded(D), KC = DP / 16, NB = (DP + 63) / 64;
  const int UNIT = res_unit_bytes(NB, MT);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + stages * UNIT);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int strip = warp % MT, part = warp / MT;
  // This strip's exchange: P's A fragments (16 bytes a lane a k-step), then
  // the lane's two row sums.
  const uint32_t xs = smem_u32(base + stages * UNIT + 16) + strip * res_xch_strip(MT);
  const long long step = gridDim.x, first = blockIdx.x;
  const size_t C = (size_t)H * D, fs = (size_t)S * C;
  if (first >= units) return;

  auto slab = [&](long long u) {  // offset of frame 0 of unit u's head
    const int h = (int)(u % H), s = (int)((u / H) % S);
    return ((size_t)(u / H / S) * T * S + s) * C + (size_t)h * D;
  };
  auto load = [&](long long u, int st) {  // unit u into slot st, completing on full[st]
    unsigned char* dst = base + st * UNIT;
    if (mode == RES_TMA) {
      if (tid == 0) {
        const int h = (int)(u % H), s = (int)((u / H) % S), b = (int)(u / H / S);
        mbar_arrive_expect_tx(&full[st], UNIT);
        for (int j = 0; j < NB; ++j) {
          tma_load_4d(dst + j * TBOX, &qmap, &full[st], h * D + 64 * j, s, 0, b);
          tma_load_4d(dst + (NB + j) * TBOX, &kmap, &full[st], h * D + 64 * j, s, 0, b);
          tma_load_4d(dst + (2 * NB + j) * TBOX, &vmap, &full[st], h * D + 64 * j, s, 0, b);
        }
      }
      return;
    }
    const size_t at = slab(u);
    const uint32_t qd = smem_u32(dst), kd = qd + NB * TBOX, vd = kd + NB * TBOX;
    if (mode == RES_VEC) {
      load_boxes<MT, true>(qd, q + at, fs, T, D, DP, tid, THREADS);
      load_boxes<MT, true>(kd, k + at, fs, T, D, DP, tid, THREADS);
      load_boxes<MT, true>(vd, v + at, fs, T, D, DP, tid, THREADS);
      cp_async_arrive(&full[st]);
    } else {
      load_boxes<MT, false>(qd, q + at, fs, T, D, DP, tid, THREADS);
      load_boxes<MT, false>(kd, k + at, fs, T, D, DP, tid, THREADS);
      load_boxes<MT, false>(vd, v + at, fs, T, D, DP, tid, THREADS);
      mbar_arrive(&full[st]);
    }
  };
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(&full[st], mode == RES_TMA ? 1 : THREADS);
    mbar_fence_init();
  }
  __syncthreads();
  for (int st = 0; st < stages; ++st)
    if (first + st * step < units) load(first + st * step, st);

  // ldmatrix rows as in the narrow family; this warp's strip is rows row0
  // .. row0 + 15.
  const int a_row = lane & 15, a_chunk = lane >> 4;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_chunk = (lane >> 3) & 1;
  const int g = lane >> 2, cq = 2 * (lane & 3);
  const int row0 = ROWS * strip;
  int i = 0;
  for (long long u = first; u < units; u += step, ++i) {
    const int st = i % stages;
    const uint32_t qs = smem_u32(base + st * UNIT), ks = qs + NB * TBOX, vs = ks + NB * TBOX;
    mbar_wait(&full[st], (i / stages) & 1);

    float l0 = 0.0f, l1 = 0.0f;
    uint32_t pa[MT][4];
    if (part == 0) {
      // S = Q K^T of the strip against every key tile: sc[2 n + i][0..1]
      // row g, key columns 16 n + 8 i + cq + {0, 1}; [2..3] row g + 8.
      float sc[2 * MT][4] = {};
#pragma unroll(MT <= 2 ? 8 : 2)
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t a[4];
        ldsm_x4(a, chunk_at<MT>(qs, row0 + a_row, 2 * kc + a_chunk));
#pragma unroll
        for (int n = 0; n < MT; ++n) {
          uint32_t kf[4];
          ldsm_x4(kf, chunk_at<MT>(ks, ROWS * n + k_row, 2 * kc + k_chunk));
          mma_bf16_16816(sc[2 * n], a, kf[0], kf[1]);
          mma_bf16_16816(sc[2 * n + 1], a, kf[2], kf[3]);
        }
      }
      // Key columns >= T get -inf: only the last key tile holds any (T > 16
      // (MT - 1)).
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 2 * MT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[n][e] = n < 2 * MT - 2 || 8 * n + cq + (e & 1) < T ? sc[n][e] * scale : -INFINITY;
        m0 = fmaxf(m0, fmaxf(sc[n][0], sc[n][1]));
        m1 = fmaxf(m1, fmaxf(sc[n][2], sc[n][3]));
      }
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
      // P against the final max, the row sums tile by tile, P as bf16 A
      // fragments: k-step n takes key columns 16 n .. 16 n + 15. The last
      // n-tile, if it is past T, is exp(-inf) = 0 without the exp.
#pragma unroll
      for (int n = 0; n < MT; ++n) {
#pragma unroll
        for (int j = 2 * n; j < 2 * n + 2; ++j) {
          if (j < 2 * MT - 1 || 16 * MT - 8 < T) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][e] = expf(sc[j][e] - (e < 2 ? m0 : m1));
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
          }
        }
        l0 += (sc[2 * n][0] + sc[2 * n][1]) + (sc[2 * n + 1][0] + sc[2 * n + 1][1]);
        l1 += (sc[2 * n][2] + sc[2 * n][3]) + (sc[2 * n + 1][2] + sc[2 * n + 1][3]);
        pa[n][0] = pack_bf16(sc[2 * n][0], sc[2 * n][1]);
        pa[n][1] = pack_bf16(sc[2 * n][2], sc[2 * n][3]);
        pa[n][2] = pack_bf16(sc[2 * n + 1][0], sc[2 * n + 1][1]);
        pa[n][3] = pack_bf16(sc[2 * n + 1][2], sc[2 * n + 1][3]);
      }
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      if (WPS > 1) {
#pragma unroll
        for (int n = 0; n < MT; ++n)
          st_shared_v4(xs + (n * 32 + lane) * 16, pa[n][0], pa[n][1], pa[n][2], pa[n][3]);
        st_shared_v2f(xs + MT * 512 + lane * 8, l0, l1);
      }
    }
    if (WPS > 1) {  // the strip's warps: P and the sums are written
      named_barrier(1 + strip, 32 * WPS);
      if (part > 0) {
#pragma unroll
        for (int n = 0; n < MT; ++n) {
          const uint4 w = ld_shared_v4(xs + (n * 32 + lane) * 16);
          pa[n][0] = w.x;
          pa[n][1] = w.y;
          pa[n][2] = w.z;
          pa[n][3] = w.w;
        }
        const float2 l = ld_shared_v2f(xs + MT * 512 + lane * 8);
        l0 = l.x;
        l1 = l.y;
      }
    }
    const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);

    // O = P V, this warp's 64-channel chunks (box cb of V), each divided by
    // the sums, written over the strip's Q rows of box cb (every warp's
    // ldmatrix of them is done) and stored: frames t < T, channels < D, 16
    // bytes (2 bytes) a lane.
    __syncwarp();
    bf16* out = o + slab(u) + (size_t)row0 * fs;
    const int rows = T - row0 < ROWS ? T - row0 : ROWS;
#pragma unroll(MT <= 2 ? 2 : 1)
    for (int cb = part; cb < NB; cb += WPS) {
      const int nj = DP - 64 * cb < 64 ? (DP - 64 * cb) / 8 : 8;  // n-tiles: even
      float acc[8][4] = {};
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        if (j < nj) {
#pragma unroll
          for (int n = 0; n < MT; ++n) {
            uint32_t vf[4];
            ldsm_x4_trans(vf, chunk_at<MT>(vs, ROWS * n + a_row, 8 * cb + j + a_chunk));
            mma_bf16_16816(acc[j], pa[n], vf[0], vf[1]);
            mma_bf16_16816(acc[j + 1], pa[n], vf[2], vf[3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nj) {
          st_shared_u32(chunk_at<MT>(qs, row0 + g, 8 * cb + j) + 2 * cq,
                        pack_bf16(div_by(acc[j][0], l0, r0), div_by(acc[j][1], l0, r0)));
          st_shared_u32(chunk_at<MT>(qs, row0 + g + 8, 8 * cb + j) + 2 * cq,
                        pack_bf16(div_by(acc[j][2], l1, r1), div_by(acc[j][3], l1, r1)));
        }
      }
      __syncwarp();
      const int dw = D - 64 * cb < 64 ? D - 64 * cb : 64;  // the chunk's channels < D
      const int per_row = mode == RES_SCALAR ? dw : dw / 8;
      const int dr = 32 / per_row, dc = 32 % per_row;
      int r = lane / per_row, c = lane % per_row;
#pragma unroll 4
      for (int idx = lane; idx < rows * per_row; idx += 32) {
        if (mode == RES_SCALAR)
          reinterpret_cast<unsigned short*>(out)[(size_t)r * fs + 64 * cb + c] =
              ld_shared_u16(chunk_at<MT>(qs, row0 + r, 8 * cb + (c >> 3)) + 2 * (c & 7));
        else
          *reinterpret_cast<uint4*>(out + (size_t)r * fs + 64 * cb + 8 * c) =
              ld_shared_v4(chunk_at<MT>(qs, row0 + r, 8 * cb + c));
        r += dr;
        c += dc;
        if (c >= per_row) {
          c -= per_row;
          ++r;
        }
      }
    }
    // Every warp is done with the slot (and, for TMA, its generic accesses
    // come before the async proxy's refill): one block barrier a unit.
    fence_proxy_async();
    __syncthreads();
    if (u + stages * step < units) load(u + stages * step, st);
  }
}

// A 4D map over a (B*T, S, C) tensor seen as (C, S, T, B): boxes of 64
// channels x 1 position x 16 MT frames (frames past T read as zero).
bool frames_map(CUtensorMap* map, const void* p, int B, int T, int S, int C, int MT = 1) {
  const uint64_t dims[4] = {(uint64_t)C, (uint64_t)S, (uint64_t)T, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)C * 2, (uint64_t)S * C * 2, (uint64_t)T * S * C * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)(MT * ROWS), 1};
  return cached_bf16_map(map, p, 4, dims, strides, box);
}

template <int KC, int MT>
int launch(const void* q, const void* k, const void* v, void* o, int B, int T, int S, int H,
           float scale, cudaStream_t stream) {
  constexpr int DC = (16 * KC + 63) / 64;
  const int C = H * 16 * KC;
  CUtensorMap qm, km, vm;
  if (!frames_map(&qm, q, B, T, S, C, MT) || !frames_map(&km, k, B, T, S, C, MT) ||
      !frames_map(&vm, v, B, T, S, C, MT))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes<DC, MT>();
  static std::atomic<uint64_t> smem_set{0};  // one per (KC, MT)
  cudaError_t err = smem_limit_once(temporal_attention_kernel<KC, MT>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const long long units = (long long)B * S * H;
  const long long blocks = (units + WARPS - 1) / WARPS;
  const long long resident = (long long)sms * blocks_per_sm<DC, MT>();
  temporal_attention_kernel<KC, MT>
      <<<(unsigned)(blocks < resident ? blocks : resident), WARPS * 32, smem, stream>>>(
          qm, km, vm, (bf16*)o, T, S, H, units, scale);
  return (int)cudaGetLastError();
}

template <int KC>
int launch_narrow(const void* q, const void* k, const void* v, void* o, int B, int T, int S,
                  int H, float scale, cudaStream_t stream) {
  return T <= ROWS ? launch<KC, 1>(q, k, v, o, B, T, S, H, scale, stream)
                   : launch<KC, 2>(q, k, v, o, B, T, S, H, scale, stream);
}

template <int DC>
int launch_wide(const void* q, const void* k, const void* v, void* o, int B, int T, int S,
                int H, float scale, cudaStream_t stream) {
  const int C = H * 64 * DC;
  CUtensorMap qm, km, vm;
  if (!frames_map(&qm, q, B, T, S, C) || !frames_map(&km, k, B, T, S, C) ||
      !frames_map(&vm, v, B, T, S, C))
    return (int)cudaErrorInvalidValue;
  const int smem = wide_smem_bytes<DC>();
  static std::atomic<uint64_t> smem_set{0};  // one per DC
  cudaError_t err = smem_limit_once(temporal_attention_wide_kernel<DC>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const long long units = (long long)B * S * H;
  const long long blocks = (units + WIDE_WARPS - 1) / WIDE_WARPS;
  const long long resident = (long long)sms * wide_blocks_per_sm<DC>();
  temporal_attention_wide_kernel<DC>
      <<<(unsigned)(blocks < resident ? blocks : resident), WIDE_WARPS * 32, smem, stream>>>(
          qm, km, vm, (bf16*)o, T, S, H, units, scale);
  return (int)cudaGetLastError();
}

template <int NCH, bool VEC>
int launch_general(const void* q, const void* k, const void* v, void* o, int B, int T, int S,
                   int H, int D, float scale, cudaStream_t stream) {
  const int dp = gen_padded(D), w = gen_warps((T + ROWS - 1) / ROWS, dp);
  const int smem = gen_smem_bytes(dp, w);
  static std::atomic<uint64_t> smem_set{0};  // one per (NCH, VEC)
  cudaError_t err =
      smem_limit_once(temporal_attention_general_kernel<NCH, VEC>, GEN_MAX_SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const long long units = (long long)B * S * H;
  const long long resident = (long long)sms * gen_blocks_per_sm(dp, w);
  temporal_attention_general_kernel<NCH, VEC>
      <<<(unsigned)(units < resident ? units : resident), 32 * w, smem, stream>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, T, S, H, D, units, scale);
  return (int)cudaGetLastError();
}

template <int MT, int WPS>
int launch_resident(const void* q, const void* k, const void* v, void* o, int B, int T, int S,
                    int H, int D, float scale, cudaStream_t stream) {
  const int C = H * D, nb = (gen_padded(D) + 63) / 64;
  const int mode = D % 16 == 0 && C % 8 == 0   ? RES_TMA
                   : D % 8 == 0 && C % 8 == 0 ? RES_VEC
                                              : RES_SCALAR;
  CUtensorMap qm{}, km{}, vm{};
  if (mode == RES_TMA &&
      (!frames_map(&qm, q, B, T, S, C, MT) || !frames_map(&km, k, B, T, S, C, MT) ||
       !frames_map(&vm, v, B, T, S, C, MT)))
    return (int)cudaErrorInvalidValue;
  const int stages = res_stages(nb, MT, WPS), smem = res_smem(nb, MT, stages, WPS);
  static std::atomic<uint64_t> smem_set{0};  // one per (MT, WPS)
  cudaError_t err =
      smem_limit_once(temporal_attention_resident_kernel<MT, WPS>, GEN_MAX_SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const long long units = (long long)B * S * H;
  const long long resident = (long long)sms * res_blocks(nb, MT, stages, WPS);
  temporal_attention_resident_kernel<MT, WPS>
      <<<(unsigned)(units < resident ? units : resident), MT * WPS * 32, smem, stream>>>(
          qm, km, vm, (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, T, S, H, D,
          mode, stages, units, scale);
  return (int)cudaGetLastError();
}

// The resident kernel at MT row tiles with res_wps warps a strip (one past
// RES_WPS_TILES).
template <int MT>
int launch_resident_wps(const void* q, const void* k, const void* v, void* o, int B, int T,
                        int S, int H, int D, float scale, cudaStream_t stream) {
  if constexpr (MT <= RES_WPS_TILES) {
    switch (res_wps((gen_padded(D) + 63) / 64, MT)) {
      case 2: return launch_resident<MT, 2>(q, k, v, o, B, T, S, H, D, scale, stream);
      case 4: return launch_resident<MT, 4>(q, k, v, o, B, T, S, H, D, scale, stream);
      default: break;
    }
  }
  return launch_resident<MT, 1>(q, k, v, o, B, T, S, H, D, scale, stream);
}

template <bool VEC>
int launch_general_vec(const void* q, const void* k, const void* v, void* o, int B, int T,
                       int S, int H, int D, float scale, cudaStream_t stream) {
  const int dp = gen_padded(D);
  switch (gen_chunk(dp) / 16) {
    case 1: return launch_general<1, VEC>(q, k, v, o, B, T, S, H, D, scale, stream);
    case 2: return launch_general<2, VEC>(q, k, v, o, B, T, S, H, D, scale, stream);
    case 3: return launch_general<3, VEC>(q, k, v, o, B, T, S, H, D, scale, stream);
    case 4: return launch_general<4, VEC>(q, k, v, o, B, T, S, H, D, scale, stream);
    case 5: return launch_general<5, VEC>(q, k, v, o, B, T, S, H, D, scale, stream);
    case 6: return launch_general<6, VEC>(q, k, v, o, B, T, S, H, D, scale, stream);
    case 7: return launch_general<7, VEC>(q, k, v, o, B, T, S, H, D, scale, stream);
    case 8: return launch_general<8, VEC>(q, k, v, o, B, T, S, H, D, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: (B*T, S, C) bf16, contiguous, 16-byte aligned; C = H D. D a
// multiple of 16 up to 128 with T <= 32 takes the narrow family, D a
// multiple of 64 from 192 up to 512 with T <= 16 the wide family, and any
// other D up to GEN_MAX_D, at any T, the general family: its resident
// kernel where a unit fits (res_takes), else its streamed kernel.
extern "C" int gcd_temporal_attention(const void* q, const void* k, const void* v, void* o,
                                      int BT, int T, int S, int C, int H, float scale,
                                      void* stream) {
  if (T <= 0 || H <= 0 || C % H || BT % T || BT <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const int D = C / H, B = BT / T;
  cudaStream_t st = (cudaStream_t)stream;
  if (D > 128 && D <= 512 && D % 64 == 0 && T <= ROWS) {
    switch (D / 64) {
      case 3: return launch_wide<3>(q, k, v, o, B, T, S, H, scale, st);
      case 4: return launch_wide<4>(q, k, v, o, B, T, S, H, scale, st);
      case 5: return launch_wide<5>(q, k, v, o, B, T, S, H, scale, st);
      case 6: return launch_wide<6>(q, k, v, o, B, T, S, H, scale, st);
      case 7: return launch_wide<7>(q, k, v, o, B, T, S, H, scale, st);
      case 8: return launch_wide<8>(q, k, v, o, B, T, S, H, scale, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (D <= 128 && D % 16 == 0 && T <= MAX_ROW_TILES * ROWS) {
    switch (D / 16) {
      case 1: return launch_narrow<1>(q, k, v, o, B, T, S, H, scale, st);
      case 2: return launch_narrow<2>(q, k, v, o, B, T, S, H, scale, st);
      case 3: return launch_narrow<3>(q, k, v, o, B, T, S, H, scale, st);
      case 4: return launch_narrow<4>(q, k, v, o, B, T, S, H, scale, st);
      case 5: return launch_narrow<5>(q, k, v, o, B, T, S, H, scale, st);
      case 6: return launch_narrow<6>(q, k, v, o, B, T, S, H, scale, st);
      case 7: return launch_narrow<7>(q, k, v, o, B, T, S, H, scale, st);
      case 8: return launch_narrow<8>(q, k, v, o, B, T, S, H, scale, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (D > GEN_MAX_D) return (int)cudaErrorInvalidValue;
  if (res_takes((T + ROWS - 1) / ROWS, gen_padded(D))) {
    switch ((T + ROWS - 1) / ROWS) {
      case 1: return launch_resident_wps<1>(q, k, v, o, B, T, S, H, D, scale, st);
      case 2: return launch_resident_wps<2>(q, k, v, o, B, T, S, H, D, scale, st);
      case 3: return launch_resident_wps<3>(q, k, v, o, B, T, S, H, D, scale, st);
      case 4: return launch_resident_wps<4>(q, k, v, o, B, T, S, H, D, scale, st);
      case 5: return launch_resident_wps<5>(q, k, v, o, B, T, S, H, D, scale, st);
      case 6: return launch_resident_wps<6>(q, k, v, o, B, T, S, H, D, scale, st);
      case 7: return launch_resident_wps<7>(q, k, v, o, B, T, S, H, D, scale, st);
      case 8: return launch_resident_wps<8>(q, k, v, o, B, T, S, H, D, scale, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return C % 8 == 0 && D % 8 == 0
             ? launch_general_vec<true>(q, k, v, o, B, T, S, H, D, scale, st)
             : launch_general_vec<false>(q, k, v, o, B, T, S, H, D, scale, st);
}
