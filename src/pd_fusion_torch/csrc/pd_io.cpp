// pd_io — native host-IO tier of the embed path (the port's own copy of
// native/pd_io.cpp, equal to it below this header).
//
// A NIfTI-1 reader (plain or gzip: libdeflate when built with
// -DPD_HAVE_LIBDEFLATE, else zlib), a thread-parallel align-corners
// trilinear resampler and the fused embed prep (read + resize + 1-99%
// percentile normalize + multi-axis slice gather, f32 or f16 output),
// exposed through a plain C ABI consumed with ctypes. ctypes releases
// the GIL for each call, so the prefetch pool in
// pd_fusion_torch.imaging.pipeline decodes volumes in parallel.
//
// Built at first use by pd_fusion_torch/imaging/native.py (g++ -O3
// -march=native -shared -fPIC, libdeflate first, then zlib).
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <string>
#include <vector>
#include <thread>
#include <algorithm>
#include <limits>
#include <memory>
#include <mutex>
#include <type_traits>
#include <zlib.h>
#ifdef PD_HAVE_LIBDEFLATE
#include <libdeflate.h>
#endif
#ifdef __AVX512F__
#include <immintrin.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// file reading (plain or gzip)
// ---------------------------------------------------------------------------

// Slow-but-always-available path: zlib streaming via gzFile (reads both
// gzip and plain files). `hint` pre-sizes the output buffer.
bool read_gz_zlib(const char* path, size_t hint, std::vector<uint8_t>& out) {
  gzFile f = gzopen(path, "rb");
  if (!f) return false;
  gzbuffer(f, 1 << 18);
  out.clear();
  out.resize(hint ? hint : (1 << 20));
  size_t filled = 0;
  int n;
  while (true) {
    if (filled == out.size()) out.resize(out.size() * 2);
    n = gzread(f, out.data() + filled, static_cast<unsigned>(out.size() - filled));
    if (n <= 0) break;
    filled += n;
  }
  bool ok = (n == 0);
  out.resize(filled);
  gzclose(f);
  return ok;
}

// Fills `out`/`out_n` with the whole (decompressed) file. The buffer is
// allocated UNinitialized (new[]) — both the libdeflate and zlib paths
// overwrite every byte they report, and a std::vector here would memset
// ~26 MB per volume first.
bool read_file_maybe_gz(const char* path, std::unique_ptr<uint8_t[]>& out, size_t& out_n) {
  // Probe the magic and the gzip ISIZE trailer (decompressed size mod
  // 2^32 — exact for NIfTI volumes, which are far below 4 GiB).
  size_t hint = 0;
  long file_size = 0;
  bool is_gzip = false;
  if (FILE* rf = fopen(path, "rb")) {
    uint8_t magic[2] = {0, 0};
    if (fread(magic, 1, 2, rf) == 2) {
      fseek(rf, 0, SEEK_END);
      file_size = ftell(rf);
      if (magic[0] == 0x1f && magic[1] == 0x8b) {
        is_gzip = true;
        if (file_size >= 4 && fseek(rf, -4, SEEK_END) == 0) {
          uint8_t tr[4];
          if (fread(tr, 1, 4, rf) == 4) {
            hint = static_cast<size_t>(tr[0]) | (static_cast<size_t>(tr[1]) << 8) |
                   (static_cast<size_t>(tr[2]) << 16) | (static_cast<size_t>(tr[3]) << 24);
            // deflate's max expansion is ~1032:1 — a larger ISIZE is a
            // forged trailer; ignore it rather than pre-allocating GiBs
            // (the doubling loop below sizes to the real data instead)
            if (hint > static_cast<size_t>(file_size) * 1032 + 64) hint = 0;
          }
        }
      } else if (file_size > 0) {
        hint = static_cast<size_t>(file_size);
      }
    }
    fclose(rf);
  }

#ifdef PD_HAVE_LIBDEFLATE
  // Fast path: whole-buffer gzip decompress with libdeflate (~2-3x the
  // throughput of zlib's streaming inflate — the measured floor of the
  // embed pipeline on this 1-core host). Any anomaly (truncated file,
  // multi-member beyond what we loop over, bad ISIZE) falls back to zlib.
  if (is_gzip && file_size > 18) {
    const size_t comp_n = static_cast<size_t>(file_size);
    std::unique_ptr<uint8_t[]> comp(new uint8_t[comp_n]);
    bool read_ok = false;
    if (FILE* rf = fopen(path, "rb")) {
      read_ok = fread(comp.get(), 1, comp_n, rf) == comp_n;
      fclose(rf);
    }
    if (read_ok) {
      if (libdeflate_decompressor* d = libdeflate_alloc_decompressor()) {
        size_t cap = hint ? hint : comp_n * 4;
        // +8 tail pad: the int16 resize fast path gathers 32-bit words at
        // scale 2, so the final element's gather reads 2 bytes past the
        // data (the garbage is shifted out of the lane, but the bytes
        // must be readable)
        out.reset(new uint8_t[cap + 8]);
        size_t in_pos = 0, out_pos = 0;
        bool ok = true;
        // loop over gzip members (NIfTI is single-member; be robust)
        while (in_pos < comp_n &&
               !(comp_n - in_pos < 18)) {  // min gzip member size
          size_t in_used = 0, out_used = 0;
          libdeflate_result r = libdeflate_gzip_decompress_ex(
              d, comp.get() + in_pos, comp_n - in_pos,
              out.get() + out_pos, cap - out_pos, &in_used, &out_used);
          if (r == LIBDEFLATE_INSUFFICIENT_SPACE) {
            size_t new_cap = cap * 2;
            std::unique_ptr<uint8_t[]> bigger(new uint8_t[new_cap + 8]);
            std::memcpy(bigger.get(), out.get(), out_pos);
            out = std::move(bigger);
            cap = new_cap;
            continue;
          }
          if (r != LIBDEFLATE_SUCCESS) {
            ok = false;
            break;
          }
          in_pos += in_used;
          out_pos += out_used;
        }
        libdeflate_free_decompressor(d);
        if (ok && out_pos > 0) {
          out_n = out_pos;
          return true;
        }
      }
    }
  }
#endif

  std::vector<uint8_t> buf;
  if (!read_gz_zlib(path, hint, buf)) return false;
  out_n = buf.size();
  out.reset(new uint8_t[out_n + 8]);  // same +8 gather tail pad
  std::memcpy(out.get(), buf.data(), out_n);
  return true;
}

template <typename T>
void convert_to_f32(const uint8_t* src, int64_t count, bool swap, float* dst) {
  const T* p = reinterpret_cast<const T*>(src);
  if (!swap && std::is_integral<T>::value) {
    // integer sources can never be non-finite; the bare widening loop
    // auto-vectorizes (the std::isfinite call below does not at -O3)
    for (int64_t i = 0; i < count; ++i) dst[i] = static_cast<float>(p[i]);
    return;
  }
  for (int64_t i = 0; i < count; ++i) {
    T v = p[i];
    if (swap) {
      T t = v;
      uint8_t* b = reinterpret_cast<uint8_t*>(&t);
      std::reverse(b, b + sizeof(T));
      v = t;
    }
    float f = static_cast<float>(v);
    dst[i] = std::isfinite(f) ? f : 0.0f;
  }
}

// float32 fast path: NaN/Inf <=> exponent bits all-ones; the bit test
// auto-vectorizes where std::isfinite (a libm call at -O3 without
// -ffinite-math) does not.
template <>
void convert_to_f32<float>(const uint8_t* src, int64_t count, bool swap, float* dst) {
  if (swap) {
    const uint8_t* p = src;
    for (int64_t i = 0; i < count; ++i, p += 4) {
      uint32_t bits = (static_cast<uint32_t>(p[0]) << 24) |
                      (static_cast<uint32_t>(p[1]) << 16) |
                      (static_cast<uint32_t>(p[2]) << 8) | p[3];
      bits = ((bits >> 23) & 0xFF) == 0xFF ? 0 : bits;
      std::memcpy(dst + i, &bits, 4);
    }
    return;
  }
  // memcpy load: vox_offset need not be 4-byte aligned, and this avoids
  // the aliasing UB of a reinterpret_cast load; compilers emit the same
  // vectorized code either way.
  for (int64_t i = 0; i < count; ++i) {
    uint32_t bits;
    std::memcpy(&bits, src + 4 * i, 4);
    bits = ((bits >> 23) & 0xFF) == 0xFF ? 0 : bits;
    std::memcpy(dst + i, &bits, 4);
  }
}

inline int16_t rd_i16(const uint8_t* p, bool swap) {
  int16_t v;
  std::memcpy(&v, p, 2);
  if (swap) {
    uint8_t* b = reinterpret_cast<uint8_t*>(&v);
    std::swap(b[0], b[1]);
  }
  return v;
}

inline float rd_f32(const uint8_t* p, bool swap) {
  float v;
  std::memcpy(&v, p, 4);
  if (swap) {
    uint8_t* b = reinterpret_cast<uint8_t*>(&v);
    std::swap(b[0], b[3]);
    std::swap(b[1], b[2]);
  }
  return v;
}

inline int32_t rd_i32(const uint8_t* p, bool swap) {
  int32_t v;
  std::memcpy(&v, p, 4);
  if (swap) {
    uint8_t* b = reinterpret_cast<uint8_t*>(&v);
    std::swap(b[0], b[3]);
    std::swap(b[1], b[2]);
  }
  return v;
}

// Align-corners trilinear resize core. With TRACK_MAX, also accumulates
// the per-coordinate maximum of the RESIZED values along each output
// axis (max_a[o0], max_b[o1], max_c[o2]; caller zero/lowest-initialises)
// — one fused pass replaces a separate maxima sweep in the prep path.
// With TRACK_MAX, also builds the positive-value histogram the prep
// path's percentile select needs (top-16 float bits; hist[65536] and
// n_pos, caller zero-initialised) — the rows are L1-resident right
// after being written, so this replaces a separate full-volume stream.
//
// TSrc may be float (the classic path), int16_t, or uint16_t: NIfTI
// int16/uint16 volumes (the common T1w case) resize straight from the
// inflated bytes, converting per-gather in-register. int->f32
// conversion is exact, so the results are BIT-IDENTICAL to converting
// the whole volume first — the full-volume f32 scratch and its
// convert pass just disappear.
template <bool TRACK_MAX, typename TSrc = float>
void resize3d_impl(const TSrc* in, int64_t i0, int64_t i1, int64_t i2,
                   float* out, int64_t o0, int64_t o1, int64_t o2,
                   int n_threads, float* max_a, float* max_b, float* max_c,
                   uint32_t* hist = nullptr, int64_t* n_pos = nullptr) {
  auto axis_coords = [](int64_t in_len, int64_t out_len, std::vector<int64_t>& lo,
                        std::vector<float>& t) {
    lo.resize(out_len);
    t.resize(out_len);
    for (int64_t j = 0; j < out_len; ++j) {
      if (in_len == 1 || out_len == 1) {
        float pos = (out_len == 1) ? 0.0f
                                   : static_cast<float>(j) * (in_len - 1) / (out_len - 1);
        int64_t l = static_cast<int64_t>(pos);
        if (l > in_len - 2) l = std::max<int64_t>(in_len - 2, 0);
        lo[j] = l;
        t[j] = (in_len == 1) ? 0.0f : pos - l;
      } else {
        float pos = static_cast<float>(j) * (in_len - 1) / (out_len - 1);
        int64_t l = static_cast<int64_t>(pos);
        if (l > in_len - 2) l = in_len - 2;
        lo[j] = l;
        t[j] = pos - l;
      }
    }
  };

  std::vector<int64_t> l0, l1, l2;
  std::vector<float> t0, t1, t2;
  axis_coords(i0, o0, l0, t0);
  axis_coords(i1, o1, l1, t1);
  axis_coords(i2, o2, l2, t2);

  const int64_t in_s0 = i1 * i2, in_s1 = i2;
  const int64_t out_s0 = o1 * o2, out_s1 = o2;

#ifdef __AVX512F__
  // 32-bit copies of the inner-axis coordinate tables for vector gathers
  // (c0/c1 always fit: volume extents are far below 2^31).
  std::vector<int32_t> c0_32(o2), c1_32(o2);
  for (int64_t c = 0; c < o2; ++c) {
    c0_32[c] = static_cast<int32_t>(l2[c]);
    c1_32[c] = static_cast<int32_t>((i2 > 1) ? l2[c] + 1 : l2[c]);
  }
#endif

  std::mutex merge_mu;
  auto work = [&](int64_t z_begin, int64_t z_end) {
    // thread-local maxima merged under a lock after the sweep
    const float NEG_INF = -std::numeric_limits<float>::infinity();
    std::vector<float> lmax_b, lmax_c;
    std::vector<uint32_t> lhist;
    int64_t ln_pos = 0;
    if (TRACK_MAX) {
      lmax_b.assign(o1, NEG_INF);
      lmax_c.assign(o2, NEG_INF);
      if (hist) lhist.assign(65536, 0);
    }
#ifdef __AVX512F__
    // staging row for histogram indices compressed out of the vector loop
    std::vector<uint32_t> rowbits(TRACK_MAX && hist ? o2 : 0);
#endif
    for (int64_t a = z_begin; a < z_end; ++a) {
      const int64_t a0 = l0[a];
      const float ta = t0[a];
      const int64_t a1 = (i0 > 1) ? a0 + 1 : a0;
      float amax = NEG_INF;
      for (int64_t b = 0; b < o1; ++b) {
        const int64_t b0 = l1[b];
        const float tb = t1[b];
        const int64_t b1 = (i1 > 1) ? b0 + 1 : b0;
        float* dst = out + a * out_s0 + b * out_s1;
        const TSrc* p00 = in + a0 * in_s0 + b0 * in_s1;
        const TSrc* p01 = in + a0 * in_s0 + b1 * in_s1;
        const TSrc* p10 = in + a1 * in_s0 + b0 * in_s1;
        const TSrc* p11 = in + a1 * in_s0 + b1 * in_s1;
        float bmax = NEG_INF;
        float* lc = TRACK_MAX ? lmax_c.data() : nullptr;
#ifdef __AVX512F__
        // 16-lane gather + lerp chain; each lane performs the scalar
        // path's arithmetic (FMA-contracted like the -O3 scalar build;
        // consumers compare at f32-eps tolerance, not bitwise).
        {
          const __m512 vtb = _mm512_set1_ps(tb), vrtb = _mm512_set1_ps(1.0f - tb);
          const __m512 vta = _mm512_set1_ps(ta), vrta = _mm512_set1_ps(1.0f - ta);
          const __m512 vzero = _mm512_setzero_ps();
          const __m512 vneginf = _mm512_set1_ps(NEG_INF);
          __m512 vbmax = vneginf;
          int64_t nrow = 0;
          for (int64_t c = 0; c < o2; c += 16) {
            const __mmask16 m = (o2 - c >= 16)
                ? static_cast<__mmask16>(0xFFFF)
                : static_cast<__mmask16>((1u << (o2 - c)) - 1);
            const __m512i vi0 = _mm512_maskz_loadu_epi32(m, c0_32.data() + c);
            const __m512i vi1 = _mm512_maskz_loadu_epi32(m, c1_32.data() + c);
            const __m512 vtc = _mm512_maskz_loadu_ps(m, t2.data() + c);
            const __m512 vrtc = _mm512_sub_ps(_mm512_set1_ps(1.0f), vtc);
            auto lerp_row = [&](const TSrc* p) {
              __m512 g0, g1;
              if constexpr (std::is_same<TSrc, float>::value) {
                g0 = _mm512_mask_i32gather_ps(vzero, m, vi0, p, 4);
                g1 = _mm512_mask_i32gather_ps(vzero, m, vi1, p, 4);
              } else {
                // 16-bit elements: 32-bit gathers at scale 2 pull the
                // target and its neighbour; the neighbour (or the tail
                // pad byte at the buffer end) is masked/shifted out
                const __m512i zi = _mm512_setzero_si512();
                const __m512i r0 = _mm512_mask_i32gather_epi32(zi, m, vi0, p, 2);
                const __m512i r1 = _mm512_mask_i32gather_epi32(zi, m, vi1, p, 2);
                if constexpr (std::is_same<TSrc, int16_t>::value) {
                  g0 = _mm512_cvtepi32_ps(
                      _mm512_srai_epi32(_mm512_slli_epi32(r0, 16), 16));
                  g1 = _mm512_cvtepi32_ps(
                      _mm512_srai_epi32(_mm512_slli_epi32(r1, 16), 16));
                } else {  // uint16_t
                  const __m512i lo16 = _mm512_set1_epi32(0xFFFF);
                  g0 = _mm512_cvtepu32_ps(_mm512_and_si512(r0, lo16));
                  g1 = _mm512_cvtepu32_ps(_mm512_and_si512(r1, lo16));
                }
              }
              return _mm512_fmadd_ps(g1, vtc, _mm512_mul_ps(g0, vrtc));
            };
            const __m512 v00 = lerp_row(p00);
            const __m512 v01 = lerp_row(p01);
            const __m512 v10 = lerp_row(p10);
            const __m512 v11 = lerp_row(p11);
            const __m512 v0 = _mm512_fmadd_ps(v01, vtb, _mm512_mul_ps(v00, vrtb));
            const __m512 v1 = _mm512_fmadd_ps(v11, vtb, _mm512_mul_ps(v10, vrtb));
            const __m512 v = _mm512_fmadd_ps(v1, vta, _mm512_mul_ps(v0, vrta));
            _mm512_mask_storeu_ps(dst + c, m, v);
            if (TRACK_MAX) {
              const __m512 cur = _mm512_mask_loadu_ps(vneginf, m, lc + c);
              _mm512_mask_storeu_ps(lc + c, m, _mm512_max_ps(cur, v));
              vbmax = _mm512_mask_max_ps(vbmax, m, vbmax, v);
              if (hist) {
                // positive lanes -> top-16-bit bucket ids, compressed into
                // the staging row (replaces the scalar second row sweep)
                const __mmask16 mp =
                    _mm512_mask_cmp_ps_mask(m, v, vzero, _CMP_GT_OQ);
                const __m512i vb =
                    _mm512_srli_epi32(_mm512_castps_si512(v), 16);
                _mm512_mask_compressstoreu_epi32(rowbits.data() + nrow, mp, vb);
                nrow += __builtin_popcount(mp);
              }
            }
          }
          if (TRACK_MAX) {
            bmax = _mm512_reduce_max_ps(vbmax);
            if (hist) {
              for (int64_t r = 0; r < nrow; ++r) ++lhist[rowbits[r]];
              ln_pos += nrow;
            }
          }
        }
#else
        for (int64_t c = 0; c < o2; ++c) {
          const int64_t c0 = l2[c];
          const float tc = t2[c];
          const int64_t c1 = (i2 > 1) ? c0 + 1 : c0;
          const float v00 = static_cast<float>(p00[c0]) * (1 - tc) + static_cast<float>(p00[c1]) * tc;
          const float v01 = static_cast<float>(p01[c0]) * (1 - tc) + static_cast<float>(p01[c1]) * tc;
          const float v10 = static_cast<float>(p10[c0]) * (1 - tc) + static_cast<float>(p10[c1]) * tc;
          const float v11 = static_cast<float>(p11[c0]) * (1 - tc) + static_cast<float>(p11[c1]) * tc;
          const float v0 = v00 * (1 - tb) + v01 * tb;
          const float v1 = v10 * (1 - tb) + v11 * tb;
          const float v = v0 * (1 - ta) + v1 * ta;
          dst[c] = v;
          if (TRACK_MAX) {
            lc[c] = lc[c] > v ? lc[c] : v;
            bmax = bmax > v ? bmax : v;
          }
        }
#endif
        if (TRACK_MAX) {
          lmax_b[b] = lmax_b[b] > bmax ? lmax_b[b] : bmax;
          amax = amax > bmax ? amax : bmax;
#ifndef __AVX512F__
          if (hist) {
            // second, scalar sweep over the row while it is still in L1
            for (int64_t c = 0; c < o2; ++c) {
              const float v = dst[c];
              if (v > 0.0f) {
                uint32_t bits;
                std::memcpy(&bits, &v, 4);
                ++lhist[bits >> 16];
                ++ln_pos;
              }
            }
          }
#endif
        }
      }
      if (TRACK_MAX) max_a[a] = amax;  // `a` ranges are disjoint per thread
    }
    if (TRACK_MAX) {
      std::lock_guard<std::mutex> g(merge_mu);
      for (int64_t b = 0; b < o1; ++b)
        max_b[b] = max_b[b] > lmax_b[b] ? max_b[b] : lmax_b[b];
      for (int64_t c = 0; c < o2; ++c)
        max_c[c] = max_c[c] > lmax_c[c] ? max_c[c] : lmax_c[c];
      if (hist) {
        for (int64_t h = 0; h < 65536; ++h) hist[h] += lhist[h];
        *n_pos += ln_pos;
      }
    }
  };

  int nt = n_threads > 0 ? n_threads : 1;
  nt = std::min<int64_t>(nt, o0);
  if (nt <= 1) {
    work(0, o0);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (o0 + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t begin = t * chunk;
    int64_t end = std::min<int64_t>(begin + chunk, o0);
    if (begin >= end) break;
    threads.emplace_back(work, begin, end);
  }
  for (auto& th : threads) th.join();
}

// Parsed NIfTI-1 file: header fields + (unless header_only) the whole
// inflated byte buffer, so callers can convert OR resize straight from
// the typed voxel bytes.
struct ParsedNifti {
  std::unique_ptr<uint8_t[]> raw;
  size_t raw_n = 0;
  int64_t dims[3] = {1, 1, 1};
  int64_t count = 1;
  bool swap = false;
  int16_t datatype = 0;
  size_t elem = 0;
  size_t offset = 352;
  float scl_slope = 0.0f, scl_inter = 0.0f;
  bool needs_scale = false;  // whether the scl_slope/inter pass applies
  const uint8_t* data() const { return raw.get() + offset; }
};

// Shared reader+parser behind pd_read_nifti / pd_prep_slices /
// pd_read_resize_nifti. Returns the public API's error codes.
int parse_nifti(const char* path, bool header_only, ParsedNifti& pn) {
  if (header_only) {
    // inflate just the first block instead of the whole file
    gzFile f = gzopen(path, "rb");
    if (!f) return 1;
    pn.raw.reset(new uint8_t[352]);
    int n = gzread(f, pn.raw.get(), 352);
    gzclose(f);
    if (n < 348) return 2;
    pn.raw_n = static_cast<size_t>(n);
  } else if (!read_file_maybe_gz(path, pn.raw, pn.raw_n)) {
    return 1;
  }
  if (pn.raw_n < 348) return 2;
  const uint8_t* h = pn.raw.get();

  pn.swap = false;
  int32_t sizeof_hdr = rd_i32(h, false);
  if (sizeof_hdr != 348) {
    if (rd_i32(h, true) == 348) {
      pn.swap = true;
    } else {
      return 3;  // not NIfTI-1
    }
  }
  if (!(std::memcmp(h + 344, "n+1", 3) == 0 || std::memcmp(h + 344, "ni1", 3) == 0)) {
    return 4;
  }

  int16_t ndim = rd_i16(h + 40, pn.swap);
  if (ndim < 1 || ndim > 7) return 5;
  int64_t shape[7] = {1, 1, 1, 1, 1, 1, 1};
  pn.count = 1;
  for (int i = 0; i < ndim; ++i) {
    shape[i] = rd_i16(h + 42 + 2 * i, pn.swap);
    if (shape[i] <= 0) shape[i] = 1;
    pn.count *= shape[i];
    // corrupt headers can claim up to 32767^7 voxels — cap before the
    // product overflows int64 (2^40 voxels = 8 TiB of f64, far beyond
    // any real volume; keeps count*elem exact in uint64 below)
    if (pn.count > (int64_t(1) << 40)) return 6;
  }
  for (int i = 0; i < 3; ++i) pn.dims[i] = (i < ndim) ? shape[i] : 1;
  if (ndim > 3) {
    // collapse trailing singleton dims; reject true 4-D+ volumes
    for (int i = 3; i < ndim; ++i) {
      if (shape[i] != 1) return 6;
    }
  }

  pn.datatype = rd_i16(h + 70, pn.swap);
  float vox_offset = rd_f32(h + 108, pn.swap);
  pn.scl_slope = rd_f32(h + 112, pn.swap);
  pn.scl_inter = rd_f32(h + 116, pn.swap);
  // vox_offset comes from untrusted bytes: casting NaN / negative /
  // >=2^63 floats to size_t is UB, and a near-2^64 value lets
  // offset + count*elem wrap past the size check below (fuzz-found:
  // vox_offset = 2^64 - 2^40 with 2^40 uint8 voxels aborted the
  // process). NaN fails the >= comparison.
  if (!(vox_offset >= 0.0f) || vox_offset > 9.0e18f) return 9;
  pn.offset = static_cast<size_t>(vox_offset);
  if (pn.offset < 352) pn.offset = 352;

  switch (pn.datatype) {
    case 2: pn.elem = 1; break;    // uint8
    case 4: pn.elem = 2; break;    // int16
    case 8: pn.elem = 4; break;    // int32
    case 16: pn.elem = 4; break;   // float32
    case 64: pn.elem = 8; break;   // float64
    case 256: pn.elem = 1; break;  // int8
    case 512: pn.elem = 2; break;  // uint16
    case 768: pn.elem = 4; break;  // uint32
    default: return 7;
  }
  if (!header_only) {
    // overflow-safe form of raw_n < offset + count*elem (count capped
    // at 2^40 above, so the uint64 product is exact)
    const uint64_t need =
        static_cast<uint64_t>(pn.count) * static_cast<uint64_t>(pn.elem);
    if (pn.offset > pn.raw_n || need > pn.raw_n - pn.offset) return 8;
  }

  bool has_slope =
      std::isfinite(pn.scl_slope) && pn.scl_slope != 0.0f && pn.scl_slope != 1.0f;
  bool has_inter = std::isfinite(pn.scl_inter) && pn.scl_inter != 0.0f;
  pn.needs_scale = has_slope || (has_inter && pn.scl_slope == 1.0f);
  return 0;
}

// Typed voxel bytes -> scaled float32 (the pd_read_nifti output pass).
void convert_and_scale(const ParsedNifti& pn, float* out) {
  const uint8_t* data = pn.data();
  const int64_t count = pn.count;
  switch (pn.datatype) {
    case 2: convert_to_f32<uint8_t>(data, count, false, out); break;
    case 4: convert_to_f32<int16_t>(data, count, pn.swap, out); break;
    case 8: convert_to_f32<int32_t>(data, count, pn.swap, out); break;
    case 16: convert_to_f32<float>(data, count, pn.swap, out); break;
    case 64: convert_to_f32<double>(data, count, pn.swap, out); break;
    case 256: convert_to_f32<int8_t>(data, count, false, out); break;
    case 512: convert_to_f32<uint16_t>(data, count, pn.swap, out); break;
    case 768: convert_to_f32<uint32_t>(data, count, pn.swap, out); break;
  }
  bool has_slope =
      std::isfinite(pn.scl_slope) && pn.scl_slope != 0.0f && pn.scl_slope != 1.0f;
  bool has_inter = std::isfinite(pn.scl_inter) && pn.scl_inter != 0.0f;
  if (has_slope) {
    float inter = has_inter ? pn.scl_inter : 0.0f;
    for (int64_t i = 0; i < count; ++i) out[i] = out[i] * pn.scl_slope + inter;
  } else if (has_inter && pn.scl_slope == 1.0f) {
    for (int64_t i = 0; i < count; ++i) out[i] += pn.scl_inter;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success. On success fills dims[0..2] and, if out != null,
// writes the float32 voxel data (Fortran/x-fastest order, scaled,
// NaN/Inf -> 0). Call once with out == null to get dims, then again with
// a buffer of product(dims) floats. On the full-read call, positive
// caller-provided dims are treated as the out-buffer's capacity: if the
// re-parsed header no longer matches (file replaced between the two
// calls), the call fails instead of overflowing the buffer.
int pd_read_nifti(const char* path, int64_t* dims, float* out) try {
  ParsedNifti pn;
  const int64_t cap0 = dims[0], cap1 = dims[1], cap2 = dims[2];
  if (int rc = parse_nifti(path, out == nullptr, pn)) {
    // the header-only probe does not validate datatype/size/offset
    // fields the full read needs; keep its historical (dims-only)
    // error surface
    if (out == nullptr && (rc == 7 || rc == 8 || rc == 9)) {
      for (int i = 0; i < 3; ++i) dims[i] = pn.dims[i];
      return 0;
    }
    return rc;
  }
  if (out != nullptr && cap0 > 0 &&
      (pn.dims[0] != cap0 || pn.dims[1] != cap1 || pn.dims[2] != cap2)) {
    // the same parse that would drive the write no longer matches the
    // capacity the caller allocated from its probe call — the file
    // changed between the two calls; fail instead of overflowing
    return 11;
  }
  for (int i = 0; i < 3; ++i) dims[i] = pn.dims[i];
  if (out == nullptr) return 0;
  convert_and_scale(pn, out);
  return 0;
} catch (...) {
  // bad_alloc from corrupt-size allocations (e.g. a forged gzip ISIZE
  // trailer) must surface as an error code, not terminate the process
  // that loaded this library
  return 10;
}

// Align-corners trilinear resize (matches scipy.ndimage.zoom order=1 /
// pd_fusion.ops.image.resize3d). in/out are C-ORDER [d0, d1, d2] float32.
// Parallel over the leading output axis.
void pd_resize3d(const float* in, int64_t i0, int64_t i1, int64_t i2,
                 float* out, int64_t o0, int64_t o1, int64_t o2,
                 int n_threads) {
  resize3d_impl<false>(in, i0, i1, i2, out, o0, o1, o2, n_threads,
                       nullptr, nullptr, nullptr);
}

// Convenience: read + resize in one call (the embed path's host stage).
// target dims given by (t0,t1,t2); out buffer must hold t0*t1*t2 floats.
// NOTE: NIfTI data is Fortran-ordered; the caller treats the array as
// C-order [i2, i1, i0] and resizes in that layout, which is equivalent.
int pd_read_resize_nifti(const char* path, int64_t t0, int64_t t1, int64_t t2,
                         float* out, int n_threads) try {
  ParsedNifti pn;
  if (int rc = parse_nifti(path, false, pn)) return rc;
  // Fortran [x,y,z] buffer == C-order [z,y,x]; resize with reversed dims.
  const int64_t i0 = pn.dims[2], i1 = pn.dims[1], i2 = pn.dims[0];
  // 16-bit fast path: resize straight from the inflated bytes (exact —
  // int->f32 conversion commutes with the f32 lerp arithmetic)
  const bool direct16 = !pn.swap && !pn.needs_scale && pn.offset % 2 == 0;
  if (direct16 && pn.datatype == 4) {
    resize3d_impl<false>(reinterpret_cast<const int16_t*>(pn.data()),
                         i0, i1, i2, out, t2, t1, t0, n_threads,
                         nullptr, nullptr, nullptr);
    return 0;
  }
  if (direct16 && pn.datatype == 512) {
    resize3d_impl<false>(reinterpret_cast<const uint16_t*>(pn.data()),
                         i0, i1, i2, out, t2, t1, t0, n_threads,
                         nullptr, nullptr, nullptr);
    return 0;
  }
  // new float[] stays UNinitialized: convert_and_scale overwrites it all
  std::unique_ptr<float[]> vol(new float[static_cast<size_t>(pn.count)]);
  convert_and_scale(pn, vol.get());
  pd_resize3d(vol.get(), i0, i1, i2, out, t2, t1, t0, n_threads);
  return 0;
} catch (...) {
  return 10;  // see pd_read_nifti: never let bad_alloc cross the ABI
}

}  // extern "C"

// f32 -> IEEE binary16 with round-to-nearest-even — the same conversion
// numpy's astype(np.float16) performs (bit-equality tested). Software
// routine for portability; the AVX-512/F16C build uses vcvtps2ph.
static inline uint16_t f32_to_f16_rne(float v) {
#ifdef __AVX512F__
  return static_cast<uint16_t>(
      _cvtss_sh(v, _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC));
#else
  uint32_t x;
  std::memcpy(&x, &v, 4);
  const uint32_t sign = (x >> 16) & 0x8000u;
  x &= 0x7FFFFFFFu;
  if (x >= 0x47800000u) {  // overflow -> inf; NaN keeps a mantissa bit
    return static_cast<uint16_t>(sign | (x > 0x7F800000u ? 0x7E00u : 0x7C00u));
  }
  if (x < 0x38800000u) {  // subnormal half (or zero)
    // add the implicit bit, shift with round-to-nearest-even; shift > 18
    // would need a >= 32-bit shift (UB) and those magnitudes (< 2^-31)
    // all round to zero anyway
    const uint32_t shift = 113u - (x >> 23);
    if (shift > 18u) return static_cast<uint16_t>(sign);
    const uint32_t mant = (x & 0x7FFFFFu) | 0x800000u;
    uint32_t h = mant >> (shift + 13u);
    const uint32_t rem = mant & ((1u << (shift + 13u)) - 1u);
    const uint32_t half = 1u << (shift + 12u);
    if (rem > half || (rem == half && (h & 1u))) ++h;
    return static_cast<uint16_t>(sign | h);
  }
  // normal: rebias exponent, round mantissa to 10 bits (nearest-even)
  uint32_t h = ((x >> 13) & 0x3FFu) + ((x >> 23) - 112u) * 0x400u;
  const uint32_t rem = x & 0x1FFFu;
  if (rem > 0x1000u || (rem == 0x1000u && (h & 1u))) ++h;
  return static_cast<uint16_t>(sign | h);
#endif
}

static inline void store_px(float*& dst, float v) { *dst++ = v; }
static inline void store_px(uint16_t*& dst, float v) { *dst++ = f32_to_f16_rne(v); }

// Full host prep for the embedding pipeline: read + resize + 1-99%%
// nonzero-mask percentile normalize + multi-axis nonzero-extent slice
// select. Mirrors pd_fusion.imaging.pipeline.{normalize_volume_host,
// select_slices_host} exactly (equality-tested). out must hold
// sum(counts) * h * w pixels where (h, w) are the per-axis slice dims of
// a CUBIC target (t0 == t1 == t2 is required for multi-axis use).
// OutT = float (exact mirror) or uint16_t (f16 bits for the half-width
// wire mode — equals the f32 output's astype(np.float16) bitwise).
// Layout notes: the volume buffer is Fortran [t0,t1,t2] == C [t2,t1,t0].
template <typename OutT>
static int prep_slices_impl(const char* path, int64_t t0, int64_t t1, int64_t t2,
                            const int64_t* axes, const int64_t* counts, int n_axes,
                            OutT* out, int n_threads) {
  ParsedNifti pn;
  if (int rc = parse_nifti(path, false, pn)) return rc;

  // Resize with fused per-coordinate RAW maxima (buffer is C-order
  // [t2, t1, t0], so axis a=z/t2, b=y/t1, c=x/t0). The maxima later give
  // the nonzero-extent flags without a normalize-the-whole-volume pass:
  // normalized > 0  <=>  raw > lo  (the normalizing scale is positive).
  const float NEG_INF = -std::numeric_limits<float>::infinity();
  std::vector<float> rawmax0(t0, NEG_INF), rawmax1(t1, NEG_INF), rawmax2(t2, NEG_INF);
  std::vector<uint32_t> hist(65536, 0);
  int64_t n_pos = 0;
  const size_t vol_n = static_cast<size_t>(t0) * t1 * t2;
  std::unique_ptr<float[]> vol_buf(new float[vol_n]);  // fully overwritten by the resize
  float* const vol = vol_buf.get();
  const int64_t i0 = pn.dims[2], i1 = pn.dims[1], i2 = pn.dims[0];
  const bool direct16 = !pn.swap && !pn.needs_scale && pn.offset % 2 == 0;
  if (direct16 && pn.datatype == 4) {
    // int16 fast path (the common T1w case): resize straight from the
    // inflated bytes — the full-volume f32 convert pass and its ~26 MB
    // scratch disappear; int->f32 conversion is exact so the resized
    // values are bit-identical to the convert-first path
    resize3d_impl<true>(reinterpret_cast<const int16_t*>(pn.data()),
                        i0, i1, i2, vol, t2, t1, t0, n_threads,
                        rawmax2.data(), rawmax1.data(), rawmax0.data(),
                        hist.data(), &n_pos);
  } else if (direct16 && pn.datatype == 512) {
    resize3d_impl<true>(reinterpret_cast<const uint16_t*>(pn.data()),
                        i0, i1, i2, vol, t2, t1, t0, n_threads,
                        rawmax2.data(), rawmax1.data(), rawmax0.data(),
                        hist.data(), &n_pos);
  } else {
    // new float[] stays UNinitialized (POD default-init): a std::vector
    // here memsets ~26 MB that convert_and_scale immediately overwrites
    std::unique_ptr<float[]> raw(new float[static_cast<size_t>(pn.count)]);
    convert_and_scale(pn, raw.get());
    resize3d_impl<true>(raw.get(), i0, i1, i2, vol, t2, t1, t0,
                        n_threads, rawmax2.data(), rawmax1.data(), rawmax0.data(),
                        hist.data(), &n_pos);
  }
  pn.raw.reset();
  const int64_t count = static_cast<int64_t>(vol_n);

  // percentile over the positive mask (numpy 'linear' interpolation),
  // computed by EXACT histogram select: positive IEEE-754 floats compare
  // the same as their bit patterns, so the 65536-bin histogram on the
  // top 16 mantissa/exponent bits (built inside the resize pass while
  // rows are L1-resident) finds the bucket holding each rank; only that
  // bucket's members (typically a few hundred) are then collected and
  // order-selected. Replaces the former push_back-all +
  // nth_element-over-4M approach (~4x faster on the 1-core host,
  // identical results — the k-th order statistic is exact).
  float lo, hi;
  if (n_pos == 0) {
    lo = *std::min_element(vol, vol + count);
    hi = *std::max_element(vol, vol + count);
  } else {
    // ranks needed: k and k+1 for both quantiles (numpy 'linear');
    // map each to its bucket via the cumulative histogram, then collect
    // all flagged buckets' members in ONE pass over the volume.
    int64_t ranks[4];
    int n_ranks = 0;
    double posq[2], fracs[2];
    int64_t ks[2];
    const double qs[2] = {1.0, 99.0};
    for (int qi = 0; qi < 2; ++qi) {
      posq[qi] = (n_pos - 1) * qs[qi] / 100.0;
      ks[qi] = static_cast<int64_t>(posq[qi]);
      fracs[qi] = posq[qi] - ks[qi];
      ranks[n_ranks++] = ks[qi];
      if (fracs[qi] != 0.0 && ks[qi] + 1 < n_pos) ranks[n_ranks++] = ks[qi] + 1;
    }
    uint32_t rank_bucket[4];
    int64_t bucket_base[4];  // count of positives strictly below the bucket
    {
      std::vector<int64_t> cum(65537, 0);
      for (uint32_t b = 0; b < 65536; ++b) cum[b + 1] = cum[b] + hist[b];
      for (int r = 0; r < n_ranks; ++r) {
        uint32_t b = static_cast<uint32_t>(
            std::upper_bound(cum.begin() + 1, cum.end(), ranks[r]) - (cum.begin() + 1));
        rank_bucket[r] = b;
        bucket_base[r] = cum[b];
      }
    }
    std::vector<char> wanted(65536, 0);
    for (int r = 0; r < n_ranks; ++r) wanted[rank_bucket[r]] = 1;
    std::vector<float> members[4];
    for (int r = 0; r < n_ranks; ++r) {
      bool dup = false;
      for (int s = 0; s < r; ++s) dup = dup || rank_bucket[s] == rank_bucket[r];
      if (!dup) members[r].reserve(hist[rank_bucket[r]]);
    }
#ifdef __AVX512F__
    {
      // distinct buckets (<= 4): one vector compare + compress-store per
      // bucket per 16 lanes — replaces the scalar lookup-table walk
      int n_distinct = 0;
      uint32_t dbuck[4];
      int dslot[4];
      for (int r = 0; r < n_ranks; ++r) {
        bool dup = false;
        for (int s = 0; s < n_distinct; ++s) dup = dup || dbuck[s] == rank_bucket[r];
        if (!dup) {
          dbuck[n_distinct] = rank_bucket[r];
          dslot[n_distinct] = r;
          members[r].resize(hist[rank_bucket[r]]);
          ++n_distinct;
        }
      }
      int64_t fill[4] = {0, 0, 0, 0};
      const __m512 vzero = _mm512_setzero_ps();
      for (int64_t i = 0; i < count; i += 16) {
        const __mmask16 m = (count - i >= 16)
            ? static_cast<__mmask16>(0xFFFF)
            : static_cast<__mmask16>((1u << (count - i)) - 1);
        const __m512 v = _mm512_maskz_loadu_ps(m, vol + i);
        const __mmask16 mp = _mm512_mask_cmp_ps_mask(m, v, vzero, _CMP_GT_OQ);
        if (!mp) continue;
        const __m512i vb = _mm512_srli_epi32(_mm512_castps_si512(v), 16);
        for (int u = 0; u < n_distinct; ++u) {
          const __mmask16 ms = _mm512_mask_cmpeq_epi32_mask(
              mp, vb, _mm512_set1_epi32(static_cast<int32_t>(dbuck[u])));
          if (ms) {
            _mm512_mask_compressstoreu_ps(members[dslot[u]].data() + fill[u], ms, v);
            fill[u] += __builtin_popcount(ms);
          }
        }
      }
      for (int u = 0; u < n_distinct; ++u) members[dslot[u]].resize(fill[u]);
    }
#else
    for (int64_t i = 0; i < count; ++i) {
      float v = vol[i];
      if (v > 0.0f) {
        uint32_t bits;
        std::memcpy(&bits, &v, 4);
        uint32_t b = bits >> 16;
        if (wanted[b]) {
          for (int r = 0; r < n_ranks; ++r) {
            if (rank_bucket[r] == b) {
              members[r].push_back(v);
              break;  // dedup: identical buckets share members[first]
            }
          }
        }
      }
    }
#endif
    auto select_rank = [&](int r) -> float {
      // find the slot whose bucket matches (members stored at first use)
      int slot = r;
      for (int s = 0; s < r; ++s) {
        if (rank_bucket[s] == rank_bucket[r]) { slot = s; break; }
      }
      int64_t off = ranks[r] - bucket_base[r];
      std::vector<float> tmp(members[slot]);  // keep slot reusable across ranks
      std::nth_element(tmp.begin(), tmp.begin() + off, tmp.end());
      return tmp[off];
    };
    float qv[2];
    int r_idx = 0;
    for (int qi = 0; qi < 2; ++qi) {
      float vk = select_rank(r_idx++);
      if (fracs[qi] != 0.0 && ks[qi] + 1 < n_pos) {
        float vk1 = select_rank(r_idx++);
        qv[qi] = static_cast<float>(vk * (1.0 - fracs[qi]) + vk1 * fracs[qi]);
      } else {
        qv[qi] = vk;
      }
    }
    lo = qv[0];
    hi = qv[1];
  }
  const float inv = 1.0f / (hi - lo + 1e-6f);
  auto norm = [&](float v) {
    float c = v < lo ? lo : (v > hi ? hi : v);
    return (c - lo) * inv;
  };

  const int64_t s_z = t1 * t0;  // C stride of z in the buffer
  const int64_t s_y = t0;

  // Nonzero-extent flags from the raw maxima captured during the resize:
  // the python mirror normalizes the whole volume then scans for
  // normalized > 0, which is exactly raw > lo (clamp at lo maps to 0 and
  // the scale 1/(hi-lo+1e-6) is positive). Only the gathered slices are
  // ever normalized — the full-volume normalize pass is gone.
  // flag = norm(rawmax) > 0, the python mirror's exact predicate — this
  // keeps parity even in the sub-denormal edge where (v-lo)*inv
  // underflows to 0 despite v > lo.
  std::vector<char> nz0(t0, 0), nz1(t1, 0), nz2(t2, 0);
  for (int64_t x = 0; x < t0; ++x) nz0[x] = norm(rawmax0[x]) > 0.0f;
  for (int64_t y = 0; y < t1; ++y) nz1[y] = norm(rawmax1[y]) > 0.0f;
  for (int64_t z = 0; z < t2; ++z) nz2[z] = norm(rawmax2[z]) > 0.0f;

  OutT* dst = out;
  for (int a = 0; a < n_axes; ++a) {
    const int64_t axis = axes[a];
    const int64_t cnt = counts[a];
    const int64_t axis_len = (axis == 0) ? t0 : (axis == 1) ? t1 : t2;
    const std::vector<char>& nz = (axis == 0) ? nz0 : (axis == 1) ? nz1 : nz2;
    int64_t lo_i = 0, hi_i = axis_len - 1;
    bool any = false;
    for (int64_t i = 0; i < axis_len; ++i) {
      if (nz[i]) { lo_i = i; any = true; break; }
    }
    if (any) {
      for (int64_t i = axis_len - 1; i >= 0; --i) {
        if (nz[i]) { hi_i = i; break; }
      }
    }
    // np.linspace(lo, hi, cnt).astype(int), replicated operation-for-
    // operation (step = delta/div rounded once; y_k = fl(fl(k*step)+lo);
    // endpoint forced to hi) — the obvious lo + d*(k/(cnt-1)) associates
    // differently and truncates to a different index at some (lo, extent)
    // pairs (f64 rounding straddles an integer), breaking bit-parity
    // with the python mirror (pipeline.select_slices_host:123) and the
    // reference (openneuro_features.py:144). Separate statements keep
    // the compiler from FMA-contracting k*step+lo into one rounding.
    const double step = (cnt == 1)
        ? 0.0
        : static_cast<double>(hi_i - lo_i) / static_cast<double>(cnt - 1);
    for (int64_t k = 0; k < cnt; ++k) {
      double pos = static_cast<double>(k) * step;
      pos = pos + static_cast<double>(lo_i);
      if (cnt > 1 && k == cnt - 1) pos = static_cast<double>(hi_i);  // endpoint
      int64_t idx = static_cast<int64_t>(pos);
      if (axis == 0) {
        // out[k][y][z] = norm(vol[x=idx, y, z])
        for (int64_t y = 0; y < t1; ++y)
          for (int64_t z = 0; z < t2; ++z)
            store_px(dst, norm(vol[z * s_z + y * s_y + idx]));
      } else if (axis == 1) {
        // out[k][x][z] = norm(vol[x, y=idx, z])
        for (int64_t x = 0; x < t0; ++x)
          for (int64_t z = 0; z < t2; ++z)
            store_px(dst, norm(vol[z * s_z + idx * s_y + x]));
      } else {
        // out[k][x][y] = norm(vol[x, y, z=idx])
        const float* plane = vol + idx * s_z;
        for (int64_t x = 0; x < t0; ++x)
          for (int64_t y = 0; y < t1; ++y)
            store_px(dst, norm(plane[y * s_y + x]));
      }
    }
  }
  return 0;
}

extern "C" {

int pd_prep_slices(const char* path, int64_t t0, int64_t t1, int64_t t2,
                   const int64_t* axes, const int64_t* counts, int n_axes,
                   float* out, int n_threads) try {
  return prep_slices_impl<float>(path, t0, t1, t2, axes, counts, n_axes, out, n_threads);
} catch (...) {
  return 10;  // see pd_read_nifti: never let bad_alloc cross the ABI
}

// Half-width variant for the f16 wire mode (PD_FUSION_PUT_DTYPE=f16):
// emits IEEE binary16 bits straight from the gather epilogue, replacing
// the worker-thread numpy astype pass AND halving the output-buffer
// traffic. Bitwise-equal to pd_prep_slices(...).astype(np.float16).
int pd_prep_slices_f16(const char* path, int64_t t0, int64_t t1, int64_t t2,
                       const int64_t* axes, const int64_t* counts, int n_axes,
                       uint16_t* out, int n_threads) try {
  return prep_slices_impl<uint16_t>(path, t0, t1, t2, axes, counts, n_axes, out, n_threads);
} catch (...) {
  return 10;  // see pd_read_nifti: never let bad_alloc cross the ABI
}

}  // extern "C"
