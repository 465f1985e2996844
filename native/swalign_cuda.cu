// Banded affine Smith-Waterman forward pass for NVIDIA Hopper (sm_90a),
// called from JAX through the XLA FFI (savont_tpu/ops/align_cuda.py).
//
// Same recurrence, path metadata and tie-breaks as the plain-JAX reference
// savont_tpu/ops/align_jax.py (sw_forward_meta with smooth=False, and
// _forward_payload), exact on RAW planner bands (any per-row advance).
//
// Layout: one warp per pair.  The band lies across the 32 lanes, CPL
// consecutive cells per lane (cell j lives in lane j / CPL), so the whole
// row loop runs inside one launch.  Previous-row accesses at a band advance
// dl are warp shuffles by dl (same column) and dl-1 (diagonal); the E-term
// prefix max is an in-lane scan plus a warp scan of the lane totals.
//
// Two variants share the row step:
//   meta    -> (6, B) int32: score, q_start, t_start, q_end, t_end, nm
//   payload -> (3, B) int32: score, ri, bj, plus (B, Lq * band) uint8
//              decision bytes for the traceback walk:
//              bit0 use_g  bit1 g_zero  bit2 g_f  bit3 exitE  bit4 from_h
//              bit5 mismatch

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace {

constexpr int kNeg = -20000;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

struct Scoring {
  int match, mismatch, gap_open, gap_ext;
};

// a[s] for a warp-uniform runtime index s (kept in registers: no local
// memory indexing).
template <int CPL>
__device__ __forceinline__ int pick(const int (&a)[CPL], int s) {
  int v = a[0];
#pragma unroll
  for (int c = 1; c < CPL; ++c) v = (s == c) ? a[c] : v;
  return v;
}

// out[c] = plane[lane * CPL + c + k] when that index lies in [0, band),
// else fill.  k is warp-uniform and >= -1.
template <int CPL>
__device__ __forceinline__ void shifted(const int (&a)[CPL], int (&out)[CPL],
                                        int k, int fill, int lane, int band) {
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int ck = c + k;
    const int sc = ((ck % CPL) + CPL) % CPL;  // source cell, warp-uniform
    const int src = lane + (ck - sc) / CPL;   // source lane
    const int v = __shfl_sync(kFull, pick<CPL>(a, sc), src & 31);
    const int g = lane * CPL + ck;
    out[c] = (g >= 0 && g < band && src >= 0 && src < 32) ? v : fill;
  }
}

// Argmax element of the E prefix scan: the largest v, ties to the larger
// column (the right operand), with the path metadata riding along.
struct Run {
  int v, nm, qs, ts;
};

__device__ __forceinline__ Run combine(const Run& a, const Run& b) {
  return b.v >= a.v ? b : a;
}

__device__ __forceinline__ Run shfl_up_run(const Run& x, int d) {
  Run y;
  y.v = __shfl_up_sync(kFull, x.v, d);
  y.nm = __shfl_up_sync(kFull, x.nm, d);
  y.qs = __shfl_up_sync(kFull, x.qs, d);
  y.ts = __shfl_up_sync(kFull, x.ts, d);
  return y;
}

template <int CPL, bool kPayload>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sw_forward_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ t,
                  const int32_t* __restrict__ lo,
                  const int32_t* __restrict__ tlens, int B, int Lq, int Lt,
                  int band, Scoring sc, int32_t* __restrict__ out,
                  uint8_t* __restrict__ payload) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const int32_t* qb = q + static_cast<size_t>(b) * Lq;
  const int32_t* tb = t + static_cast<size_t>(b) * Lt;
  const int32_t* lob = lo + static_cast<size_t>(b) * (Lq + 1);
  const int tlen = tlens[b];
  const int ooe = sc.gap_open + sc.gap_ext;

  int j[CPL];
  int H[CPL], F[CPL];
  int nmh[CPL], qsh[CPL], tsh[CPL], nmf[CPL], qsf[CPL], tsf[CPL];
  int bv[CPL], brow[CPL], bqs[CPL], bts[CPL], bte[CPL], bnm[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    j[c] = lane * CPL + c;
    H[c] = 0;
    F[c] = kNeg;
    nmh[c] = qsh[c] = tsh[c] = nmf[c] = qsf[c] = tsf[c] = 0;
    bv[c] = brow[c] = bqs[c] = bts[c] = bte[c] = bnm[c] = 0;
  }

  int prev_l = lob[0];
  for (int r = 1; r <= Lq; ++r) {
    const int l = lob[r];
    const int dl = l - prev_l;
    prev_l = l;
    const int qc = qb[r - 1];

    // previous row: same column (j + dl) and diagonal (j + dl - 1)
    int Hup[CPL], Hdg[CPL], Fup[CPL];
    shifted<CPL>(H, Hup, dl, kNeg, lane, band);
    shifted<CPL>(H, Hdg, dl - 1, kNeg, lane, band);
    shifted<CPL>(F, Fup, dl, kNeg, lane, band);
    int nmh_up[CPL], nmd[CPL], qsh_up[CPL], qsd[CPL], tsh_up[CPL], tsd[CPL];
    int nmf_up[CPL], qsf_up[CPL], tsf_up[CPL];
    if (!kPayload) {
      shifted<CPL>(nmh, nmh_up, dl, 0, lane, band);
      shifted<CPL>(nmh, nmd, dl - 1, 0, lane, band);
      shifted<CPL>(qsh, qsh_up, dl, 0, lane, band);
      shifted<CPL>(qsh, qsd, dl - 1, 0, lane, band);
      shifted<CPL>(tsh, tsh_up, dl, 0, lane, band);
      shifted<CPL>(tsh, tsd, dl - 1, 0, lane, band);
      shifted<CPL>(nmf, nmf_up, dl, 0, lane, band);
      shifted<CPL>(qsf, qsf_up, dl, 0, lane, band);
      shifted<CPL>(tsf, tsf_up, dl, 0, lane, band);
    }

    int col[CPL], mm[CPL], Fr[CPL], Gr[CPL], from_h[CPL], g_zero[CPL],
        g_f[CPL];
    int nmf_n[CPL], qsf_n[CPL], tsf_n[CPL], nmg[CPL], qsg[CPL], tsg[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      col[c] = l + j[c];
      const int tc =
          tlen > 0 ? __ldg(tb + min(col[c], tlen - 1)) : 6;  // never matches
      const bool is_match = tc == qc && qc < 4 && tc < 4;
      mm[c] = !is_match;
      const int s = is_match ? sc.match : sc.mismatch;
      // left of the band is the free zero boundary only at column 0
      const bool left_edge = j[c] == 0 && col[c] == 0;
      if (left_edge) Hdg[c] = 0;
      from_h[c] = (Hup[c] - sc.gap_open) >= Fup[c];
      Fr[c] = max(max(Hup[c] - sc.gap_open, Fup[c]) - sc.gap_ext, kNeg);
      Gr[c] = max(max(0, Hdg[c] + s), Fr[c]);
      g_zero[c] = Gr[c] == 0;
      g_f[c] = !g_zero[c] && Gr[c] == Fr[c];
      if (!kPayload) {
        if (left_edge) {
          nmd[c] = 0;
          qsd[c] = r - 1;
          tsd[c] = col[c];
        }
        nmf_n[c] = (from_h[c] ? nmh_up[c] : nmf_up[c]) + 1;
        qsf_n[c] = from_h[c] ? qsh_up[c] : qsf_up[c];
        tsf_n[c] = from_h[c] ? tsh_up[c] : tsf_up[c];
        nmg[c] = g_zero[c] ? 0 : (g_f[c] ? nmf_n[c] : nmd[c] + mm[c]);
        qsg[c] = g_zero[c] ? r : (g_f[c] ? qsf_n[c] : qsd[c]);
        tsg[c] = g_zero[c] ? col[c] + 1 : (g_f[c] ? tsf_n[c] : tsd[c]);
      }
    }

    // E[j] from the exclusive prefix argmax of (G + e*j) over j' < j:
    // in-lane inclusive scan, warp scan of the lane totals, then each cell
    // combines the previous lanes' total with its in-lane predecessors.
    Run p[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      Run x{Gr[c] + sc.gap_ext * j[c], 0, 0, 0};
      if (!kPayload) x = Run{x.v, nmg[c] - j[c], qsg[c], tsg[c]};
      p[c] = c == 0 ? x : combine(p[c - 1], x);
    }
    Run tot = p[CPL - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Run o = shfl_up_run(tot, d);
      if (lane >= d) tot = combine(o, tot);
    }
    Run before = shfl_up_run(tot, 1);
    if (lane == 0) before = Run{kNeg, 0, 0, 0};

    int Gprev0 = __shfl_up_sync(kFull, Gr[CPL - 1], 1);
    if (lane == 0) Gprev0 = kNeg;

#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const Run ex = c == 0 ? before : combine(before, p[c - 1]);
      int Er = j[c] == 0 ? kNeg : ex.v - sc.gap_open - sc.gap_ext * j[c];
      Er = max(Er, kNeg);
      const bool use_g = Gr[c] >= Er;
      int Hr = use_g ? Gr[c] : Er;
      const bool live = col[c] < tlen && j[c] < band;
      Hr = live ? Hr : kNeg;
      const bool better = Hr > bv[c];
      if (kPayload) {
        const int Gprev = c == 0 ? Gprev0 : Gr[c - 1];
        const bool exitE = Er == Gprev - ooe;
        if (j[c] < band) {
          payload[(static_cast<size_t>(b) * Lq + (r - 1)) * band + j[c]] =
              static_cast<uint8_t>(use_g | (g_zero[c] << 1) | (g_f[c] << 2) |
                                   (exitE << 3) | (from_h[c] << 4) |
                                   (mm[c] << 5));
        }
      } else {
        const int nmh_n = use_g ? nmg[c] : ex.nm + j[c];
        const int qsh_n = use_g ? qsg[c] : ex.qs;
        const int tsh_n = use_g ? tsg[c] : ex.ts;
        if (better) {
          bqs[c] = qsh_n;
          bts[c] = tsh_n;
          bte[c] = col[c] + 1;
          bnm[c] = nmh_n;
        }
        nmh[c] = nmh_n;
        qsh[c] = qsh_n;
        tsh[c] = tsh_n;
        nmf[c] = nmf_n[c];
        qsf[c] = qsf_n[c];
        tsf[c] = tsf_n[c];
      }
      if (better) {
        bv[c] = Hr;
        brow[c] = r;
      }
      H[c] = Hr;
      F[c] = Fr[c];
    }
  }

  // the start cell: largest score, then the earliest row, then the lowest
  // column -- the row-major argmax of the full DP matrix
  int wv = kNeg - 1, wr = 0, wj = 0;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const bool take = j[c] < band &&
                      (bv[c] > wv || (bv[c] == wv && brow[c] < wr));
    if (take) {
      wv = bv[c];
      wr = brow[c];
      wj = j[c];
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const int ov = __shfl_xor_sync(kFull, wv, m);
    const int orow = __shfl_xor_sync(kFull, wr, m);
    const int oj = __shfl_xor_sync(kFull, wj, m);
    const bool take =
        ov > wv || (ov == wv && (orow < wr || (orow == wr && oj < wj)));
    if (take) {
      wv = ov;
      wr = orow;
      wj = oj;
    }
  }
  if (lane != wj / CPL) return;
  const int wc = wj % CPL;
  if (kPayload) {
    out[b] = wv;
    out[B + b] = wr;
    out[2 * B + b] = wj;
  } else {
    out[b] = wv;
    out[B + b] = pick<CPL>(bqs, wc);
    out[2 * B + b] = pick<CPL>(bts, wc);
    out[3 * B + b] = wr;
    out[4 * B + b] = pick<CPL>(bte, wc);
    out[5 * B + b] = pick<CPL>(bnm, wc);
  }
}

}  // namespace

// ---- XLA FFI handlers ----

namespace ffi = xla::ffi;

namespace {

constexpr int kMaxBand = 128;

template <bool kPayload>
ffi::Error Launch(cudaStream_t stream, ffi::BufferR2<ffi::S32> q,
                  ffi::BufferR2<ffi::S32> t, ffi::BufferR2<ffi::S32> lo,
                  ffi::BufferR1<ffi::S32> tlens, int32_t band, Scoring sc,
                  int32_t* out, uint8_t* payload) {
  const int B = static_cast<int>(q.dimensions()[0]);
  const int Lq = static_cast<int>(q.dimensions()[1]);
  const int Lt = static_cast<int>(t.dimensions()[1]);
  if (t.dimensions()[0] != B || lo.dimensions()[0] != B ||
      lo.dimensions()[1] != Lq + 1 || tlens.dimensions()[0] != B) {
    return ffi::Error::InvalidArgument(
        "expected q (B, Lq), t (B, Lt), lo (B, Lq + 1), tlens (B,)");
  }
  if (band < 1 || band > kMaxBand) {
    return ffi::Error::InvalidArgument("band must lie in [1, 128]");
  }
  if (B == 0) return ffi::Error::Success();
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
  const int32_t* args[] = {q.typed_data(), t.typed_data(), lo.typed_data(),
                           tlens.typed_data()};
  if (band <= 32) {
    sw_forward_kernel<1, kPayload><<<grid, block, 0, stream>>>(
        args[0], args[1], args[2], args[3], B, Lq, Lt, band, sc, out, payload);
  } else if (band <= 64) {
    sw_forward_kernel<2, kPayload><<<grid, block, 0, stream>>>(
        args[0], args[1], args[2], args[3], B, Lq, Lt, band, sc, out, payload);
  } else {
    sw_forward_kernel<4, kPayload><<<grid, block, 0, stream>>>(
        args[0], args[1], args[2], args[3], B, Lq, Lt, band, sc, out, payload);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error ForwardMeta(cudaStream_t stream, ffi::BufferR2<ffi::S32> q,
                       ffi::BufferR2<ffi::S32> t, ffi::BufferR2<ffi::S32> lo,
                       ffi::BufferR1<ffi::S32> tlens, int32_t band,
                       int32_t match, int32_t mismatch, int32_t gap_open,
                       int32_t gap_ext, ffi::ResultBufferR2<ffi::S32> meta) {
  return Launch<false>(stream, q, t, lo, tlens, band,
                       Scoring{match, mismatch, gap_open, gap_ext},
                       meta->typed_data(), nullptr);
}

ffi::Error ForwardPayload(cudaStream_t stream, ffi::BufferR2<ffi::S32> q,
                          ffi::BufferR2<ffi::S32> t,
                          ffi::BufferR2<ffi::S32> lo,
                          ffi::BufferR1<ffi::S32> tlens, int32_t band,
                          int32_t match, int32_t mismatch, int32_t gap_open,
                          int32_t gap_ext, ffi::ResultBufferR2<ffi::S32> meta,
                          ffi::ResultBufferR2<ffi::U8> payload) {
  return Launch<true>(stream, q, t, lo, tlens, band,
                      Scoring{match, mismatch, gap_open, gap_ext},
                      meta->typed_data(), payload->typed_data());
}

}  // namespace

#define SW_BINDING                                 \
  ffi::Ffi::Bind()                                 \
      .Ctx<ffi::PlatformStream<cudaStream_t>>()    \
      .Arg<ffi::BufferR2<ffi::S32>>()             \
      .Arg<ffi::BufferR2<ffi::S32>>()             \
      .Arg<ffi::BufferR2<ffi::S32>>()             \
      .Arg<ffi::BufferR1<ffi::S32>>()             \
      .Attr<int32_t>("band")                       \
      .Attr<int32_t>("match")                      \
      .Attr<int32_t>("mismatch")                   \
      .Attr<int32_t>("gap_open")                   \
      .Attr<int32_t>("gap_ext")

XLA_FFI_DEFINE_HANDLER_SYMBOL(SwForwardMeta, ForwardMeta,
                              SW_BINDING.Ret<ffi::BufferR2<ffi::S32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(SwForwardPayload, ForwardPayload,
                              SW_BINDING.Ret<ffi::BufferR2<ffi::S32>>()
                                  .Ret<ffi::BufferR2<ffi::U8>>());
