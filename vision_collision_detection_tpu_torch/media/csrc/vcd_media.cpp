// Video decode / probe / encode library (FFmpeg 5.x, C ABI), the port's copy
// of the JAX package's media library, consumed from Python through ctypes
// (media/decoder.py):
//
//   vcd_probe(path)                 -> width/height/fps/frames/duration
//   vcd_decode(path, indices, ...)  -> RGB24 frames, optionally scaled or
//                                      letterboxed on the host (swscale) so
//                                      fixed-shape uint8 batches go straight
//                                      to the device.
//   vcd_encode(path, frames, ...)   -> MP4 writer (synthetic test fixtures).
//
// Decode strategy: indices must be ascending. Seek once to the keyframe at or
// before the first wanted frame, then decode forward, converting exactly the
// wanted frames. Frame numbering derives from pts via the stream time base
// and average frame rate (display order; libav reorders B-frames for us).
//
// Two changes from the JAX package's copy, each commented where it is made:
// the reduced-resolution (lowres) request in Reader::open, and the
// letterbox of content one column narrower than its canvas in vcd_decode3.
//
// Build: see ../build.py (g++ -O3 -shared, links avformat/avcodec/avutil/swscale).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <atomic>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <string>
#include <thread>
#include <vector>

#if defined(__SSE4_1__) && defined(__FMA__)
#include <immintrin.h>
#define VCD_SIMD_RESIZE 1
#if defined(__AVX512F__) && defined(__AVX512BW__)
#define VCD_AVX512_RESIZE 1
#endif
#endif

static thread_local std::string g_last_error;

// ---------------------------------------------------------------------------
// Stage profiling: thread-safe ns accumulators over the decode hot path so
// the per-clip cost breakdown (libav decode vs YUV→RGB vs AA resize vs copy)
// is measured, not guessed. Off by default; ~zero overhead when off.
// Slots: 0=demux+decode 1=sws(yuv→rgb) 2=aa_resize 3=copy/pad 4=open
// Counts: 0=frames_decoded 1=frames_converted 2=seeks 3=frames_skipped_by_seek
//         4=frames_skipped_nonref
// ---------------------------------------------------------------------------
namespace {

std::atomic<long long> g_prof_ns[5];
std::atomic<long long> g_prof_ct[5];
std::atomic<int> g_prof_on{0};

// Decode-side frame skipping for unneeded NON-REFERENCE frames (default on).
// H.264 dashcam streams carry disposable B-frames (nal_ref_idc == 0); when a
// packet's display index is not in the wanted set, the decoder is told
// AVDISCARD_NONREF for that packet, so it drops the macroblock decode of
// disposable frames entirely. Reference frames are always decoded, and wanted
// frames are never marked, so the pixels of every RETURNED frame are
// bit-identical with or without skipping (pinned by
// tests/test_media.py::test_nonref_skip_bitexact). I/P-only streams (e.g. the
// mpeg4 test fixtures) are unaffected — every frame is a reference.
std::atomic<int> g_skip_unneeded{1};

// Planar-YUV fast resize (default off — the exact path is the default).
// When on, 4:2:0 frames skip the native-resolution swscale YUV→RGB pass:
// the Y/U/V planes are AA-resampled at DECODED resolution (chroma straight
// from its half-resolution plane, folding the 2×2 upsample into the
// resample) and the BT.601 YUV→RGB matrix is applied once at TARGET
// resolution in float — ~26× fewer pixels through the color convert and
// ~2× less resample arithmetic. Output differs from the exact
// convert-then-resize path only by chroma-interpolation order and one
// dropped uint8 quantization (the affine YUV→RGB matrix commutes with the
// weight-normalized resample in exact arithmetic); the A/B bound is pinned
// by tests/test_media.py and AUC parity by scripts/parity_harness.py
// --fast-resize.
//
// This global is only the DEFAULT: vcd_decode2/vcd_decode_batch2 take the
// mode per call (fast_resize >= 0), so concurrent decodes with different
// modes never race on it. The setter remains as a test/diagnostic hook.
std::atomic<int> g_fast_resize{0};

// AV_CODEC_FLAG2_FAST (default off): lets the codec use non-spec-compliant
// speedup tricks. Exposed as an opt-in A/B knob (round-4 review suggestion);
// it is adopted only where the repo's bit-exactness tests pass with it on —
// tests/test_media.py::test_flag2_fast_bitexact compares full decodes with
// the flag on vs off on both the mpeg4 and H.264-with-B-frames fixture
// families. Applies at Reader::open, so it affects newly opened clips only.
std::atomic<int> g_fast_decode{0};

// Reduced-resolution decode (default 0 = full resolution). libavcodec's
// `lowres` decodes mpeg4/mjpeg/mpeg2 streams directly at 1/2^k size (the
// IDCT runs on the top-left coefficient block), cutting the dominant
// libavcodec share of per-clip decode cost when the model input is far
// below source resolution anyway (720p → 224px). The requested level is a
// MAXIMUM: Reader::open clamps it per clip to (a) the codec's max_lowres
// (0 for H.264 → transparent full-res fallback) and (b) the largest level
// whose decoded frame still covers the letterbox content box, so the AA
// resampler always DOWNsamples — reduced-res decode never introduces
// upscaling. Output is NOT bit-exact vs full-res decode+resize (the DCT
// crop is a different low-pass than the AA triangle filter); the accuracy
// envelope is pinned by tests/test_media.py and AUC parity by
// scripts/parity_harness.py --lowres. This global is only the DEFAULT:
// vcd_decode3/vcd_decode_batch3 take the level per call (lowres >= 0).
std::atomic<int> g_lowres{0};

inline long long now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (long long)ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

struct ProfScope {
  int slot;
  long long t0;
  bool on;
  explicit ProfScope(int s)
      : slot(s), t0(0), on(g_prof_on.load(std::memory_order_relaxed)) {
    if (on) t0 = now_ns();
  }
  ~ProfScope() {
    if (on)
      g_prof_ns[slot].fetch_add(now_ns() - t0, std::memory_order_relaxed);
  }
};

inline void prof_count(int slot, long long n = 1) {
  if (g_prof_on.load(std::memory_order_relaxed))
    g_prof_ct[slot].fetch_add(n, std::memory_order_relaxed);
}

}  // namespace

static void set_error(const std::string& msg) { g_last_error = msg; }

static std::string av_err(int code) {
  char buf[AV_ERROR_MAX_STRING_SIZE] = {0};
  av_strerror(code, buf, sizeof(buf));
  return std::string(buf);
}

extern "C" {

typedef struct {
  int width;
  int height;
  double fps;
  long num_frames;
  double duration;  // seconds
} VcdProbe;

const char* vcd_last_error() { return g_last_error.c_str(); }

void vcd_profile_enable(int on) {
  g_prof_on.store(on ? 1 : 0, std::memory_order_relaxed);
}

// Toggle decode-skip of unneeded non-reference frames (diagnostics/tests).
void vcd_set_skip_unneeded(int on) {
  g_skip_unneeded.store(on ? 1 : 0, std::memory_order_relaxed);
}

// Toggle the planar-YUV fast resize path (see g_fast_resize above).
void vcd_set_fast_resize(int on) {
  g_fast_resize.store(on ? 1 : 0, std::memory_order_relaxed);
}

int vcd_get_fast_resize() {
  return g_fast_resize.load(std::memory_order_relaxed);
}

// Toggle AV_CODEC_FLAG2_FAST on subsequently opened decoders (see
// g_fast_decode above). A/B + bit-exactness hook, default off.
void vcd_set_fast_decode(int on) {
  g_fast_decode.store(on ? 1 : 0, std::memory_order_relaxed);
}

int vcd_get_fast_decode() {
  return g_fast_decode.load(std::memory_order_relaxed);
}

// Process-global DEFAULT for reduced-resolution decode (see g_lowres above);
// production callers pass the level per call into vcd_decode3/_batch3.
void vcd_set_lowres(int level) {
  g_lowres.store(level < 0 ? 0 : level, std::memory_order_relaxed);
}

int vcd_get_lowres() {
  return g_lowres.load(std::memory_order_relaxed);
}

// libav log verbosity (AV_LOG_QUIET=-8 .. AV_LOG_DEBUG=48). The Python
// loader defaults this to AV_LOG_ERROR so encoder info banners (x264
// prints ~20 lines per open at AV_LOG_INFO) do not pollute bench/driver
// output; pass a higher level to re-enable for debugging.
void vcd_set_log_level(int level) { av_log_set_level(level); }

void vcd_profile_reset() {
  for (auto& a : g_prof_ns) a.store(0, std::memory_order_relaxed);
  for (auto& a : g_prof_ct) a.store(0, std::memory_order_relaxed);
}

// out[0..4] = ns in {demux+decode, sws yuv→rgb, aa resize, copy/pad, open};
// out[5..9] = counts {frames_decoded, frames_converted, seeks,
//                     frames_skipped_by_seek, frames_skipped_nonref}.
// n = len(out), up to 10 filled.
void vcd_profile_get(long long* out, int n) {
  for (int i = 0; i < n && i < 5; i++)
    out[i] = g_prof_ns[i].load(std::memory_order_relaxed);
  for (int i = 5; i < n && i < 10; i++)
    out[i] = g_prof_ct[i - 5].load(std::memory_order_relaxed);
}

// ---------------------------------------------------------------------------
// Internal: open a demuxer + decoder for the best video stream.
// ---------------------------------------------------------------------------
namespace {

void letterbox_geometry(int h, int w, int target_h, int target_w, int* new_h,
                        int* new_w, int* pad_h, int* pad_w);

struct Reader {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  int stream_index = -1;
  AVStream* stream = nullptr;
  double fps = 0.0;
  bool cfr = false;  // constant-frame-rate sanity (gates pts→index tricks)
  int lowres = 0;    // effective (post-clamp) reduced-resolution level

  ~Reader() {
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
  }

  // lowres_req > 0 requests reduced-resolution decode; it is clamped to the
  // codec's max_lowres (0 for H.264 → full-res) and, when the output
  // geometry is given, to the largest level whose decoded frame still
  // covers the letterbox content box computed from FULL-resolution dims —
  // so the AA resample after a reduced-res decode always downsamples.
  bool open(const char* path, int lowres_req = 0, int out_w = 0,
            int out_h = 0, int want_letterbox = 0) {
    int ret = avformat_open_input(&fmt, path, nullptr, nullptr);
    if (ret < 0) {
      set_error("open_input failed for '" + std::string(path) + "': " + av_err(ret));
      return false;
    }
    ret = avformat_find_stream_info(fmt, nullptr);
    if (ret < 0) {
      set_error("find_stream_info failed: " + av_err(ret));
      return false;
    }
    const AVCodec* codec = nullptr;
    stream_index = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
    if (stream_index < 0 || !codec) {
      set_error("no video stream found");
      return false;
    }
    stream = fmt->streams[stream_index];
    dec = avcodec_alloc_context3(codec);
    if (!dec) {
      set_error("alloc codec context failed");
      return false;
    }
    if ((ret = avcodec_parameters_to_context(dec, stream->codecpar)) < 0) {
      set_error("parameters_to_context failed: " + av_err(ret));
      return false;
    }
    dec->thread_count = 0;  // auto frame/slice threading
    if (g_fast_decode.load(std::memory_order_relaxed))
      dec->flags2 |= AV_CODEC_FLAG2_FAST;
    if (lowres_req > 0 && codec->max_lowres > 0) {
      int lr = std::min(lowres_req, (int)codec->max_lowres);
      const int cw = stream->codecpar->width, ch = stream->codecpar->height;
      if (out_w > 0 && out_h > 0 && cw > 0 && ch > 0) {
        int sc_h = out_h, sc_w = out_w, ph = 0, pw = 0;
        if (want_letterbox)
          letterbox_geometry(ch, cw, out_h, out_w, &sc_h, &sc_w, &ph, &pw);
        while (lr > 0 && ((cw >> lr) < sc_w || (ch >> lr) < sc_h)) lr--;
      } else {
        // Repaired here: with no output canvas (native size) or codec
        // parameters of 0x0, no clamp can show that a reduced frame still
        // covers what the caller sized its buffer for, so no lowres is
        // asked for. The JAX package's copy skipped the clamp and kept lr.
        lr = 0;
      }
      dec->lowres = lr;
      lowres = lr;  // frames (and dec->width/height post-open) are >> lr
    }
    if ((ret = avcodec_open2(dec, codec, nullptr)) < 0) {
      set_error("codec open failed: " + av_err(ret));
      return false;
    }
    AVRational r = stream->avg_frame_rate.num ? stream->avg_frame_rate
                                              : stream->r_frame_rate;
    fps = r.den ? av_q2d(r) : 0.0;
    // CFR sanity: the non-ref skip and seek-ahead both key decisions off a
    // pts→frame-index mapping that assumes constant frame rate. On VFR
    // streams that mapping can mark a WANTED disposable frame unwanted and
    // silently replace it via the '<=' catch — so both optimizations are
    // gated off unless avg_frame_rate and r_frame_rate agree (the standard
    // container-level CFR signal; VFR muxers record a lower average than
    // the nominal tick rate).
    if (stream->avg_frame_rate.num > 0 && stream->avg_frame_rate.den > 0 &&
        stream->r_frame_rate.num > 0 && stream->r_frame_rate.den > 0) {
      double a = av_q2d(stream->avg_frame_rate);
      double b = av_q2d(stream->r_frame_rate);
      cfr = std::abs(a - b) <= 1e-3 * std::max(a, b);
    }
    return true;
  }

  long frame_index_of(int64_t pts) const {
    int64_t start = stream->start_time == AV_NOPTS_VALUE ? 0 : stream->start_time;
    double t = (pts - start) * av_q2d(stream->time_base);
    return (long)llround(t * fps);
  }

  int64_t pts_of_frame(long idx) const {
    int64_t start = stream->start_time == AV_NOPTS_VALUE ? 0 : stream->start_time;
    double t = idx / fps;
    return start + (int64_t)llround(t / av_q2d(stream->time_base));
  }

  // Frame index of the keyframe at/before `idx` per the demuxer's index
  // (MP4/MOV builds a full sample index at open), or -1 when the container
  // has no usable index. Lets the decode loop prove a forward seek skips
  // frames BEFORE paying for it — decode-ahead stays optimal for dense
  // sampling while sparse sampling (uniform over long videos) jumps
  // keyframe-to-keyframe instead of decoding every intermediate frame.
  //
  // CAVEAT: index entry timestamps are DTS, so for B-frame streams this
  // OVER-estimates the keyframe's display index by up to the reorder depth
  // (dec->has_b_frames) — and the demuxer's own seek resolves on PTS, so a
  // seek toward such a keyframe can land a whole GOP earlier. Callers must
  // subtract the reorder depth before judging a seek profitable.
  long keyframe_before(long idx) const {
    int e = av_index_search_timestamp(stream, pts_of_frame(idx),
                                      AVSEEK_FLAG_BACKWARD);
    while (e >= 0) {
      const AVIndexEntry* ent = avformat_index_get_entry(stream, e);
      if (!ent) return -1;
      if (ent->flags & AVINDEX_KEYFRAME) return frame_index_of(ent->timestamp);
      e--;  // index search is not keyframe-filtered; walk back to one
    }
    return -1;
  }

  long estimated_frames() const {
    if (stream->nb_frames > 0) return (long)stream->nb_frames;
    double dur = 0.0;
    if (stream->duration != AV_NOPTS_VALUE)
      dur = stream->duration * av_q2d(stream->time_base);
    else if (fmt->duration != AV_NOPTS_VALUE)
      dur = fmt->duration / (double)AV_TIME_BASE;
    return (long)(dur * fps + 0.5);
  }
};

// Reference letterbox arithmetic (the reference's nexar_video_aug.py):
// double-precision scale, int-floor new dims, centered // 2 padding.
// Generalized to rectangular targets (square is the reference case); a
// rectangular content box lets the Python side ship only content rows to the
// device and pad the black bars there (transfer-bandwidth optimization).
void letterbox_geometry(int h, int w, int target_h, int target_w, int* new_h,
                        int* new_w, int* pad_h, int* pad_w) {
  double scale = std::min((double)target_h / h, (double)target_w / w);
  *new_h = (int)(h * scale);
  *new_w = (int)(w * scale);
  *pad_h = (target_h - *new_h) / 2;
  *pad_w = (target_w - *new_w) / 2;
}

// ---------------------------------------------------------------------------
// Antialiased bilinear (triangle) resampler matching torchvision
// F.resize(antialias=True) — the reference's resize filter
// (the reference's nexar_video_aug.py). PIL-style coefficient
// construction: support scaled by the downscale ratio, window clipped to the
// image and re-normalized; float accumulation; round-to-nearest uint8. The
// only remaining difference vs the reference's float pipeline is the uint8
// wire quantization (≤ 0.5/255 per pixel). swscale's SWS_AREA approximation
// produced edge errors up to 0.18 in [0,1] units; this is exact.
// ---------------------------------------------------------------------------
struct AAFilter {
  std::vector<int> xmin, xsize;
  std::vector<float> weights;  // [out_size, ksize]
  int ksize = 0;
};

AAFilter make_aa_filter(int in_size, int out_size) {
  AAFilter f;
  double scale = (double)in_size / out_size;
  double filterscale = std::max(1.0, scale);
  double support = filterscale;  // triangle filter support = 1.0
  f.ksize = (int)std::ceil(support) * 2 + 1;
  f.xmin.resize(out_size);
  f.xsize.resize(out_size);
  f.weights.assign((size_t)out_size * f.ksize, 0.0f);
  double ss = 1.0 / filterscale;
  for (int i = 0; i < out_size; i++) {
    double center = (i + 0.5) * scale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    int n = xmax - xmin;
    double total = 0.0;
    std::vector<double> w((size_t)n);
    for (int k = 0; k < n; k++) {
      double x = (k + xmin - center + 0.5) * ss;
      double v = 1.0 - std::abs(x);
      w[k] = v > 0.0 ? v : 0.0;
      total += w[k];
    }
    f.xmin[i] = xmin;
    f.xsize[i] = n;
    for (int k = 0; k < n; k++)
      f.weights[(size_t)i * f.ksize + k] =
          (float)(total > 0.0 ? w[k] / total : 0.0);
  }
  return f;
}

// src [sh, sw, 3] u8 (src_stride bytes/row) → dst [dh, dw, 3] u8 packed;
// tmp is caller scratch.
//
// SIMD layout: the horizontal pass emits RGBx (4 floats/pixel) so one
// FMA covers all channels of a tap; the vertical pass is an axpy over
// whole rows (the compiler vectorizes it to the full register width —
// AVX-512 on this class of host). Accuracy contract: the AVX-512 and SSE
// bodies use multi-accumulator/pairwise combines that REORDER the float
// tap sum relative to the scalar reference (a ~1e-7-level perturbation),
// so a value sitting exactly on a .5 rounding boundary can differ by
// 1 LSB across SIMD variants — the guarantee is ≤1 LSB vs the scalar
// path, bounded end-to-end by the 0.5/255-tolerance torch-parity test
// (tests/test_content_box.py::test_cpp_resampler_matches_torch_antialias).
// Downstream code must not assume bit-exactness across SIMD variants.
//
// Contract: each src row must be readable for sw*3 + 4 bytes (the AVX-512
// 16-byte group load reads up to 4 bytes past the last tap's pixel; the
// SSE path reads 1). native_rgb's 64-byte-aligned stride + 64-byte tail
// slack satisfies this.
void resize_bilinear_aa(const unsigned char* src, int sh, int sw,
                        size_t src_stride, unsigned char* dst, int dh, int dw,
                        const AAFilter& fx, const AAFilter& fy,
                        std::vector<float>& tmp) {
  (void)sw;
  const size_t row_elems = (size_t)dw * 4;
  // Tiled ring of horizontally-resampled rows: the naive two-pass layout
  // streams a full [sh, dw, 4] float intermediate through HBM and the
  // vertical pass re-reads it ksize times (~12 MB/frame at 720p→224 —
  // memory-bound). The ring holds only the fy.ksize rows the current
  // output row needs (~50 KB, cache-resident); every source row is still
  // resampled exactly once (fy.xmin is monotonic), and per-element
  // accumulation order is unchanged, so output is bit-identical.
  const int ring = std::max(1, fy.ksize);
  tmp.resize((size_t)ring * row_elems + row_elems);
  float* rowbuf = tmp.data() + (size_t)ring * row_elems;

  int next_src = 0;  // next source row not yet horizontally resampled

  auto hpass_row = [&](int y) {  // u8 RGB row → f32 RGBx ring slot
    const unsigned char* srow = src + (size_t)y * src_stride;
    float* trow = tmp.data() + (size_t)(y % ring) * row_elems;
    for (int x = 0; x < dw; x++) {
      const float* w = &fx.weights[(size_t)x * fx.ksize];
      const unsigned char* p = srow + (size_t)fx.xmin[x] * 3;
      const int n = fx.xsize[x];
#if defined(VCD_AVX512_RESIZE)
      // 4 taps per iteration in one zmm: 16 source bytes shuffled into
      // four RGBx byte groups, widened u8→f32, fmadd'd against the
      // per-tap weights broadcast into the matching 4-lane groups. One
      // fmadd covers 4 taps (vs 4 with the SSE path). The 4-group
      // pairwise combine reorders the float sum — a 1e-7-level
      // perturbation, far inside the torch-parity budget and the uint8
      // rounding margin.
      const __m128i SHUF = _mm_setr_epi8(0, 1, 2, -1, 3, 4, 5, -1,
                                         6, 7, 8, -1, 9, 10, 11, -1);
      const __m512i WIDX = _mm512_setr_epi32(0, 0, 0, 0, 1, 1, 1, 1,
                                             2, 2, 2, 2, 3, 3, 3, 3);
      __m512 acc4 = _mm512_setzero_ps();
      __m128 acc = _mm_setzero_ps();
      int k = 0;
      for (; k + 4 <= n; k += 4, p += 12) {
        // reads up to 4 bytes past the last tap's pixel (row slack
        // contract below)
        __m128i raw = _mm_loadu_si128((const __m128i*)p);
        __m512 pix = _mm512_cvtepi32_ps(
            _mm512_cvtepu8_epi32(_mm_shuffle_epi8(raw, SHUF)));
        __m512 wv = _mm512_permutexvar_ps(
            WIDX, _mm512_castps128_ps512(_mm_loadu_ps(w + k)));
        acc4 = _mm512_fmadd_ps(wv, pix, acc4);
      }
      for (; k < n; k++, p += 3) {
        int four;
        std::memcpy(&four, p, 4);
        __m128 pix =
            _mm_cvtepi32_ps(_mm_cvtepu8_epi32(_mm_cvtsi32_si128(four)));
        acc = _mm_fmadd_ps(_mm_set1_ps(w[k]), pix, acc);
      }
      __m256 lo = _mm512_castps512_ps256(acc4);
      __m256 hi = _mm512_extractf32x8_ps(acc4, 1);
      __m256 s = _mm256_add_ps(lo, hi);
      acc = _mm_add_ps(acc, _mm_add_ps(_mm256_castps256_ps128(s),
                                       _mm256_extractf128_ps(s, 1)));
      _mm_storeu_ps(trow + (size_t)x * 4, acc);
#elif defined(VCD_SIMD_RESIZE)
      // Four independent accumulators hide the FMA latency chain (a single
      // accumulator serializes at ~4 cycles/tap); the pairwise combine at
      // the end reorders the float sum, which only perturbs the result at
      // the 1e-7 level — far inside the torch-parity budget and the uint8
      // rounding margin.
      auto tap = [](const unsigned char* q) {
        int four;  // 4 bytes: R,G,B of this tap + first byte of the next
        std::memcpy(&four, q, 4);
        return _mm_cvtepi32_ps(_mm_cvtepu8_epi32(_mm_cvtsi32_si128(four)));
      };
      __m128 a0 = _mm_setzero_ps(), a1 = a0, a2 = a0, a3 = a0;
      int k = 0;
      for (; k + 4 <= n; k += 4, p += 12) {
        a0 = _mm_fmadd_ps(_mm_set1_ps(w[k]), tap(p), a0);
        a1 = _mm_fmadd_ps(_mm_set1_ps(w[k + 1]), tap(p + 3), a1);
        a2 = _mm_fmadd_ps(_mm_set1_ps(w[k + 2]), tap(p + 6), a2);
        a3 = _mm_fmadd_ps(_mm_set1_ps(w[k + 3]), tap(p + 9), a3);
      }
      for (; k < n; k++, p += 3)
        a0 = _mm_fmadd_ps(_mm_set1_ps(w[k]), tap(p), a0);
      _mm_storeu_ps(trow + (size_t)x * 4,
                    _mm_add_ps(_mm_add_ps(a0, a1), _mm_add_ps(a2, a3)));
#else
      float r = 0.f, g = 0.f, b = 0.f;
      for (int k = 0; k < n; k++, p += 3) {
        r += w[k] * p[0];
        g += w[k] * p[1];
        b += w[k] * p[2];
      }
      trow[x * 4 + 0] = r;
      trow[x * 4 + 1] = g;
      trow[x * 4 + 2] = b;
      trow[x * 4 + 3] = 0.f;
#endif
    }
  };

  for (int y = 0; y < dh; y++) {  // vertical pass: axpy over ring rows
    const float* w = &fy.weights[(size_t)y * fy.ksize];
    const int lo = fy.xmin[y];
    const int n = fy.xsize[y];
    while (next_src < lo + n && next_src < sh) hpass_row(next_src++);
    {
      const float w0 = w[0];
      const float* s0 = tmp.data() + (size_t)(lo % ring) * row_elems;
      for (size_t j = 0; j < row_elems; j++) rowbuf[j] = w0 * s0[j];
    }
    for (int k = 1; k < n; k++) {
      const float wk = w[k];
      const float* sk = tmp.data() + (size_t)((lo + k) % ring) * row_elems;
      for (size_t j = 0; j < row_elems; j++) rowbuf[j] += wk * sk[j];
    }
    unsigned char* drow = dst + (size_t)y * dw * 3;
    for (int x = 0; x < dw; x++) {  // quantize RGBx → packed RGB u8
      for (int c = 0; c < 3; c++) {
        int v = (int)(rowbuf[(size_t)x * 4 + c] + 0.5f);
        drow[x * 3 + c] = (unsigned char)(v < 0 ? 0 : (v > 255 ? 255 : v));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Planar-YUV fast path pieces (g_fast_resize; exact path above stays the
// default). Single u8 plane → packed f32 plane with the SAME filter
// construction as the exact path; taps of one channel are CONTIGUOUS bytes,
// so SIMD loads cover 16 taps per fmadd (vs 4 RGBx taps) and every load
// stays inside the tap window — no row-slack contract needed.
// ---------------------------------------------------------------------------
void resize_plane_aa_f32(const unsigned char* src, int sh, int sw,
                         size_t src_stride, float* dst, int dh, int dw,
                         const AAFilter& fx, const AAFilter& fy,
                         std::vector<float>& tmp) {
  // VERTICAL-FIRST (the opposite order of the exact RGB path): the
  // vertical reduction is an axpy over sw-wide contiguous f32 rows — pure
  // full-width FMA streams with no per-output reduction — and the
  // horizontal tap-window reduction then runs on only dh rows instead of
  // sh (5-6× fewer masked-reduce iterations at 720p→224). Both passes use
  // weight rows that sum to 1, so pass order only reorders the float
  // accumulation (~1e-4 on [0,255] values) — inside the fast path's
  // tolerance, which is A/B-bounded against the exact path by
  // tests/test_media.py.
  const int ring = std::max(1, fy.ksize);
  // tmp: ring of u8→f32-converted source rows + one vertical accumulator.
  tmp.resize(((size_t)ring + 1) * sw);
  float* vrow = tmp.data() + (size_t)ring * sw;
  int next_src = 0;

  auto cvt_row = [&](int yy) {  // u8 source row → f32 ring slot, once
    const unsigned char* srow = src + (size_t)yy * src_stride;
    float* trow = tmp.data() + (size_t)(yy % ring) * sw;
    int j = 0;
#if defined(VCD_AVX512_RESIZE)
    for (; j + 16 <= sw; j += 16)
      _mm512_storeu_ps(trow + j,
                       _mm512_cvtepi32_ps(_mm512_cvtepu8_epi32(
                           _mm_loadu_si128((const __m128i*)(srow + j)))));
#elif defined(VCD_SIMD_RESIZE)
    for (; j + 4 <= sw; j += 4) {
      int four;
      std::memcpy(&four, srow + j, 4);
      _mm_storeu_ps(trow + j, _mm_cvtepi32_ps(_mm_cvtepu8_epi32(
                                  _mm_cvtsi32_si128(four))));
    }
#endif
    for (; j < sw; j++) trow[j] = srow[j];
  };

  for (int y = 0; y < dh; y++) {
    const float* w = &fy.weights[(size_t)y * fy.ksize];
    const int lo = fy.xmin[y];
    const int n = fy.xsize[y];
    while (next_src < lo + n && next_src < sh) cvt_row(next_src++);
    {
      const float w0 = w[0];
      const float* s0 = tmp.data() + (size_t)(lo % ring) * sw;
      for (int j = 0; j < sw; j++) vrow[j] = w0 * s0[j];
    }
    for (int k = 1; k < n; k++) {
      const float wk = w[k];
      const float* sk = tmp.data() + (size_t)((lo + k) % ring) * sw;
      for (int j = 0; j < sw; j++) vrow[j] += wk * sk[j];
    }
    float* drow = dst + (size_t)y * dw;
    for (int x = 0; x < dw; x++) {
      const float* wx = &fx.weights[(size_t)x * fx.ksize];
      const float* p = vrow + fx.xmin[x];
      const int nx = fx.xsize[x];
      float acc;
      int k = 0;
#if defined(VCD_AVX512_RESIZE) && defined(__AVX512VL__)
      // Masked groups: downscale filters here have ksize ~7-13, so a
      // full-width-only loop would never vectorize; masks keep every
      // load inside the tap window.
      __m512 a16 = _mm512_setzero_ps();
      for (; k < nx; k += 16) {
        const int rem = nx - k;
        const __mmask16 m =
            rem >= 16 ? (__mmask16)0xFFFF : (__mmask16)((1u << rem) - 1);
        a16 = _mm512_fmadd_ps(_mm512_maskz_loadu_ps(m, wx + k),
                              _mm512_maskz_loadu_ps(m, p + k), a16);
      }
      acc = _mm512_reduce_add_ps(a16);
#elif defined(VCD_SIMD_RESIZE)
      __m128 a4 = _mm_setzero_ps();
      for (; k + 4 <= nx; k += 4)
        a4 = _mm_fmadd_ps(_mm_loadu_ps(wx + k), _mm_loadu_ps(p + k), a4);
      __m128 s = _mm_add_ps(a4, _mm_movehl_ps(a4, a4));
      acc = _mm_cvtss_f32(_mm_add_ss(s, _mm_shuffle_ps(s, s, 1)));
#else
      acc = 0.f;
#endif
      for (; k < nx; k++) acc += wx[k] * p[k];
      drow[x] = acc;
    }
  }
}

// f32 Y/U/V planes (already at target size) → packed RGB24 rows. BT.601,
// limited (MPEG) or full (JPEG) range per the stream's color_range — the
// same default matrix swscale applies to untagged 4:2:0 streams.
void yuv_f32_planes_to_rgb(const float* Y, const float* U, const float* V,
                           int h, int w, bool full_range, unsigned char* dst,
                           size_t dst_row_stride) {
  const float cy = full_range ? 1.0f : 255.0f / 219.0f;
  const float yoff = full_range ? 0.0f : 16.0f;
  const float s = full_range ? 1.0f : 255.0f / 224.0f;
  const float crv = 1.402f * s;
  const float cgu = 0.344136f * s;
  const float cgv = 0.714136f * s;
  const float cbu = 1.772f * s;
  for (int row = 0; row < h; row++) {
    const float* yp = Y + (size_t)row * w;
    const float* up = U + (size_t)row * w;
    const float* vp = V + (size_t)row * w;
    unsigned char* d = dst + (size_t)row * dst_row_stride;
    for (int x = 0; x < w; x++) {
      const float yv = cy * (yp[x] - yoff);
      const float uv = up[x] - 128.0f;
      const float vv = vp[x] - 128.0f;
      const float rgb[3] = {yv + crv * vv, yv - cgu * uv - cgv * vv,
                            yv + cbu * uv};
      for (int c = 0; c < 3; c++) {
        const int q = (int)(rgb[c] + 0.5f);
        d[x * 3 + c] = (unsigned char)(q < 0 ? 0 : (q > 255 ? 255 : q));
      }
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Probe
// ---------------------------------------------------------------------------
int vcd_probe(const char* path, VcdProbe* out) {
  Reader r;
  if (!r.open(path)) return -1;
  out->width = r.dec->width;
  out->height = r.dec->height;
  out->fps = r.fps;
  out->num_frames = r.estimated_frames();
  out->duration = r.fps > 0 ? out->num_frames / r.fps : 0.0;
  return 0;
}

// ---------------------------------------------------------------------------
// Decode
//
// indices: ascending frame numbers (display order).
// target_w/target_h: output size; 0 means native size.
// letterbox: if nonzero, aspect-preserving scale into a square
//            target_h x target_w canvas with centered black padding
//            (target_w must equal target_h).
// out: caller buffer of n_indices * out_h * out_w * 3 bytes.
// Returns number of frames written (frames past EOF are left for the caller
// to pad), or -1 on error.
// ---------------------------------------------------------------------------
// fast_resize < 0 → use the process-global default (g_fast_resize);
// 0/1 → per-call override, safe under concurrent decodes with different
// modes (the global-toggle race was an advisor finding). lowres < 0 → the
// process-global default (g_lowres); >= 0 → per-call reduced-resolution
// decode level, clamped per clip in Reader::open (see g_lowres).
long vcd_decode3(const char* path, const long* indices, long n_indices,
                 int target_w, int target_h, int letterbox, int fast_resize,
                 int lowres, unsigned char* out) {
  if (n_indices <= 0) return 0;
  for (long i = 1; i < n_indices; i++) {
    if (indices[i] < indices[i - 1]) {
      set_error("indices must be ascending");
      return -1;
    }
  }
  Reader r;
  {
    ProfScope po(4);
    const int lr =
        lowres >= 0 ? lowres : g_lowres.load(std::memory_order_relaxed);
    if (!r.open(path, lr, target_w, target_h, letterbox)) return -1;
  }
  if (r.fps <= 0) {
    set_error("stream has no frame rate");
    return -1;
  }

  const int src_w = r.dec->width, src_h = r.dec->height;
  const int out_w = target_w > 0 ? target_w : src_w;
  const int out_h = target_h > 0 ? target_h : src_h;
  int sc_w = out_w, sc_h = out_h, pad_h = 0, pad_w = 0;
  if (letterbox) {
    letterbox_geometry(src_h, src_w, out_h, out_w, &sc_h, &sc_w, &pad_h,
                       &pad_w);
  }

  // swscale only converts pixel format at native size; all scaling goes
  // through the torch-exact AA resampler above. SWS_BILINEAR keeps the
  // chroma upsampling identical to the native-decode path.
  const bool needs_resize = (sc_w != src_w || sc_h != src_h);
  SwsContext* sws = sws_getContext(src_w, src_h, r.dec->pix_fmt, src_w, src_h,
                                   AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr,
                                   nullptr, nullptr);
  if (!sws) {
    set_error("sws_getContext failed");
    return -1;
  }

  const size_t frame_bytes = (size_t)out_h * out_w * 3;
  // 64-byte-aligned stride + tail slack: swscale's SIMD writers can run a
  // register width past an exactly-sized unpadded row (the standard
  // av_image_alloc alignment practice).
  const size_t nat_stride = ((size_t)src_w * 3 + 63) / 64 * 64;
  // thread_local scratch: a loader thread decodes many clips of the same
  // geometry, so reusing buffers across vcd_decode calls removes a
  // multi-MB allocate+fault cycle per clip (measured ~10% of dense decode)
  static thread_local std::vector<unsigned char> native_rgb;
  static thread_local std::vector<unsigned char> scaled;
  static thread_local std::vector<float> aa_tmp;
  native_rgb.resize(nat_stride * src_h + 64);
  // When the scaled content spans the canvas's width (the content-box fast
  // path), the AA resampler writes straight into the output frame; `scaled`
  // is only needed where bars remain at a side. Repaired here: the JAX
  // package's copy tested pad_w == 0, which also holds when the content is
  // one column narrower than the canvas (the odd leftover column goes to
  // the right); the resampler then wrote rows sc_w wide at a stride of
  // out_w, skewing every row and leaving the frame's last bytes unwritten.
  const bool direct_resize = letterbox && needs_resize && sc_w == out_w;
  if (needs_resize && letterbox && !direct_resize)
    scaled.resize((size_t)sc_h * sc_w * 3);
  AAFilter fx, fy;
  if (needs_resize) {
    fx = make_aa_filter(src_w, sc_w);
    fy = make_aa_filter(src_h, sc_h);
  }

  // Planar-YUV fast path (g_fast_resize): applies when resizing into a
  // bar-free-width canvas (direct_resize) or to a plain resize. Chroma is
  // resampled straight from its half-resolution plane with filters built
  // on the chroma grid — (i+0.5)-center construction makes the chroma taps
  // land on exactly the same continuous luma positions as fx/fy, so the
  // fold is geometry-exact for center-sited 4:2:0. Portrait bars
  // (pad_w != 0) and non-4:2:0 frames fall back to the exact path.
  const bool fast_geom = needs_resize && (direct_resize || !letterbox);
  const bool fast_requested =
      fast_resize >= 0 ? fast_resize != 0
                       : g_fast_resize.load(std::memory_order_relaxed) != 0;
  const bool fast_on = fast_requested && fast_geom;
  AAFilter fxc, fyc;
  static thread_local std::vector<float> fast_planes;
  static thread_local std::vector<float> aa_tmp_plane;
  if (fast_on) {
    fxc = make_aa_filter((src_w + 1) / 2, sc_w);
    fyc = make_aa_filter((src_h + 1) / 2, sc_h);
    fast_planes.resize((size_t)3 * sc_h * sc_w);
  }

  // Seek to the keyframe at/before the first wanted frame.
  int64_t first_pts = r.pts_of_frame(indices[0]);
  int ret = av_seek_frame(r.fmt, r.stream_index, first_pts, AVSEEK_FLAG_BACKWARD);
  if (ret < 0) {
    // Fall back to decoding from the start (some fixtures aren't seekable).
    av_seek_frame(r.fmt, r.stream_index, 0,
                  AVSEEK_FLAG_BACKWARD | AVSEEK_FLAG_BYTE);
  }
  avcodec_flush_buffers(r.dec);

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  long want_pos = 0;  // next position in indices[] to fill
  bool eof = false;
  // Packets marked AVDISCARD_NONREF whose frame never came back out of the
  // decoder — i.e. macroblock decodes actually saved. Marked frames that DO
  // appear (they were reference frames) are decremented on arrival.
  long skipped_nonref = 0;
  // CFR-gated (see Reader::open): on VFR streams the pts→index mapping
  // that drives skip marking can misclassify a wanted disposable frame.
  const bool skip_unneeded =
      g_skip_unneeded.load(std::memory_order_relaxed) != 0 && r.cfr;

  auto convert_and_store = [&](AVFrame* f, long out_slot) {
    unsigned char* dst_frame = out + (size_t)out_slot * frame_bytes;
    if (fast_on && (f->format == AV_PIX_FMT_YUV420P ||
                    f->format == AV_PIX_FMT_YUVJ420P)) {
      if (letterbox) {  // direct_resize ⇒ pad_w == 0: clear only the bars
        ProfScope ps(3);
        if (pad_h != 0) std::memset(dst_frame, 0, (size_t)pad_h * out_w * 3);
        const size_t bottom = (size_t)(pad_h + sc_h) * out_w * 3;
        if (bottom < frame_bytes)
          std::memset(dst_frame + bottom, 0, frame_bytes - bottom);
      }
      float* py = fast_planes.data();
      float* pu = py + (size_t)sc_h * sc_w;
      float* pv = pu + (size_t)sc_h * sc_w;
      {
        ProfScope pr(2);
        const int ch = (src_h + 1) / 2, cw = (src_w + 1) / 2;
        resize_plane_aa_f32(f->data[0], src_h, src_w, (size_t)f->linesize[0],
                            py, sc_h, sc_w, fx, fy, aa_tmp_plane);
        resize_plane_aa_f32(f->data[1], ch, cw, (size_t)f->linesize[1], pu,
                            sc_h, sc_w, fxc, fyc, aa_tmp_plane);
        resize_plane_aa_f32(f->data[2], ch, cw, (size_t)f->linesize[2], pv,
                            sc_h, sc_w, fxc, fyc, aa_tmp_plane);
      }
      {
        ProfScope ps(1);  // color convert stays under the yuv→rgb slot
        const bool full = f->format == AV_PIX_FMT_YUVJ420P ||
                          f->color_range == AVCOL_RANGE_JPEG;
        unsigned char* content =
            dst_frame + (letterbox ? (size_t)pad_h * out_w * 3 : 0);
        yuv_f32_planes_to_rgb(py, pu, pv, sc_h, sc_w, full, content,
                              (size_t)out_w * 3);
      }
      prof_count(1);
      return;
    }
    uint8_t* nat_data[1] = {native_rgb.data()};
    int nat_linesize[1] = {(int)nat_stride};
    {
      ProfScope ps(1);
      sws_scale(sws, f->data, f->linesize, 0, src_h, nat_data, nat_linesize);
    }
    prof_count(1);
    if (letterbox) {
      {
        // Clear only the black bars, not the content the resize overwrites
        // (with a content-box target there are no bars at all). Repaired
        // here as above: pad_w == 0 with sc_w < out_w leaves a bar column
        // at the right, which the JAX package's copy never cleared.
        ProfScope ps(3);
        if (sc_w != out_w) {
          std::memset(dst_frame, 0, frame_bytes);
        } else {
          // `//2` centering puts the odd leftover row at the BOTTOM, so the
          // bottom bar can be non-empty even when pad_h == 0.
          if (pad_h != 0)
            std::memset(dst_frame, 0, (size_t)pad_h * out_w * 3);
          const size_t bottom = (size_t)(pad_h + sc_h) * out_w * 3;
          if (bottom < frame_bytes)
            std::memset(dst_frame + bottom, 0, frame_bytes - bottom);
        }
      }
      if (direct_resize) {
        ProfScope pr(2);
        resize_bilinear_aa(native_rgb.data(), src_h, src_w, nat_stride,
                           dst_frame + (size_t)pad_h * out_w * 3, sc_h, sc_w,
                           fx, fy, aa_tmp);
      } else if (needs_resize) {
        {
          ProfScope pr(2);
          resize_bilinear_aa(native_rgb.data(), src_h, src_w, nat_stride,
                             scaled.data(), sc_h, sc_w, fx, fy, aa_tmp);
        }
        ProfScope ps(3);
        for (int row = 0; row < sc_h; row++) {
          std::memcpy(dst_frame + ((size_t)(pad_h + row) * out_w + pad_w) * 3,
                      scaled.data() + (size_t)row * sc_w * 3,
                      (size_t)sc_w * 3);
        }
      } else {
        ProfScope ps(3);
        for (int row = 0; row < sc_h; row++) {
          std::memcpy(dst_frame + ((size_t)(pad_h + row) * out_w + pad_w) * 3,
                      native_rgb.data() + (size_t)row * nat_stride,
                      (size_t)sc_w * 3);
        }
      }
    } else if (needs_resize) {
      ProfScope pr(2);
      resize_bilinear_aa(native_rgb.data(), src_h, src_w, nat_stride,
                         dst_frame, sc_h, sc_w, fx, fy, aa_tmp);
    } else {
      ProfScope ps(3);
      for (int row = 0; row < out_h; row++) {
        std::memcpy(dst_frame + (size_t)row * out_w * 3,
                    native_rgb.data() + (size_t)row * nat_stride,
                    (size_t)out_w * 3);
      }
    }
  };

  long cur_fidx = -1;       // display index of the last decoded frame
  bool just_sought = false;  // suppress re-seek until a frame lands
  long sought_want = -1;     // wanted index we already sought toward

  while (want_pos < n_indices && !eof) {
    // Seek-ahead: when the next wanted frame's keyframe lies beyond the
    // current decode position, every frame in between is both unwanted
    // and unnecessary for prediction — jump over it. The container index
    // proves profitability before the seek, so dense sampling (stride 1-2)
    // never seeks and sparse sampling (uniform over minutes of video)
    // skips whole GOPs. This is the decode-cost analogue of the
    // reference's random-access reads (nexar_videos.py:422).
    //
    // Two B-frame-stream guards (the index maps keyframes by DTS, the
    // demuxer seeks by PTS — see keyframe_before): the reorder-depth
    // margin keeps a DTS-overestimated keyframe index from triggering a
    // seek that lands BEHIND the current position, and `sought_want`
    // caps the loop at one seek per wanted index so a mispredicted
    // landing degrades to linear decode instead of a re-seek cycle.
    if (r.cfr && !just_sought && cur_fidx >= 0 &&
        indices[want_pos] != sought_want) {
      ProfScope pd(0);
      long kf = r.keyframe_before(indices[want_pos]);
      long margin = r.dec->has_b_frames;
      if (kf - margin > cur_fidx + 1) {
        ret = av_seek_frame(r.fmt, r.stream_index,
                            r.pts_of_frame(indices[want_pos]),
                            AVSEEK_FLAG_BACKWARD);
        if (ret >= 0) {
          avcodec_flush_buffers(r.dec);
          just_sought = true;
          sought_want = indices[want_pos];
          prof_count(2);
          prof_count(3, kf - margin - cur_fidx - 1);
        }
      }
    }

    {
      ProfScope pd(0);
      ret = av_read_frame(r.fmt, pkt);
    }
    if (ret == AVERROR_EOF) {
      avcodec_send_packet(r.dec, nullptr);  // flush decoder
      eof = true;
    } else if (ret < 0) {
      set_error("read_frame failed: " + av_err(ret));
      break;
    } else if (pkt->stream_index != r.stream_index) {
      av_packet_unref(pkt);
      continue;
    } else {
      ProfScope pd(0);
      // Per-packet skip marking: packets whose display index is outside the
      // wanted set decode only if they are reference frames. libav snapshots
      // skip_frame at packet submission (also under frame threading), so
      // toggling between packets is well-defined.
      if (skip_unneeded && pkt->pts != AV_NOPTS_VALUE) {
        long pidx = r.frame_index_of(pkt->pts);
        bool wanted = std::binary_search(indices + want_pos,
                                         indices + n_indices, pidx);
        r.dec->skip_frame = wanted ? AVDISCARD_DEFAULT : AVDISCARD_NONREF;
        if (!wanted) skipped_nonref++;
      } else {
        r.dec->skip_frame = AVDISCARD_DEFAULT;
      }
      avcodec_send_packet(r.dec, pkt);
      av_packet_unref(pkt);
    }

    while (want_pos < n_indices) {
      {
        ProfScope pd(0);
        ret = avcodec_receive_frame(r.dec, frame);
      }
      if (ret == AVERROR(EAGAIN)) break;
      if (ret == AVERROR_EOF) { eof = true; break; }
      if (ret < 0) {
        set_error("receive_frame failed: " + av_err(ret));
        eof = true;
        break;
      }
      prof_count(0);
      int64_t pts = frame->best_effort_timestamp != AV_NOPTS_VALUE
                        ? frame->best_effort_timestamp
                        : frame->pts;
      long fidx = r.frame_index_of(pts);
      cur_fidx = fidx;
      just_sought = false;
      if (skip_unneeded &&
          !std::binary_search(indices + want_pos, indices + n_indices, fidx))
        skipped_nonref--;  // marked packet survived: it was a reference frame
      while (want_pos < n_indices && indices[want_pos] <= fidx) {
        // `<=` also catches wanted frames the seek jumped past.
        convert_and_store(frame, want_pos);
        want_pos++;
      }
      av_frame_unref(frame);
    }
  }

  av_frame_free(&frame);
  av_packet_free(&pkt);
  sws_freeContext(sws);
  if (skipped_nonref > 0) prof_count(4, skipped_nonref);
  return want_pos;
}

long vcd_decode2(const char* path, const long* indices, long n_indices,
                 int target_w, int target_h, int letterbox, int fast_resize,
                 unsigned char* out) {
  return vcd_decode3(path, indices, n_indices, target_w, target_h, letterbox,
                     fast_resize, /*lowres=*/-1, out);
}

long vcd_decode(const char* path, const long* indices, long n_indices,
                int target_w, int target_h, int letterbox,
                unsigned char* out) {
  return vcd_decode3(path, indices, n_indices, target_w, target_h, letterbox,
                     /*fast_resize=*/-1, /*lowres=*/-1, out);
}

// ---------------------------------------------------------------------------
// Batch decode: B clips in parallel on an internal std::thread pool — the
// native data-loader worker replacing the reference's torch DataLoader
// worker processes (the reference's distributed_video_classifier.py).
// No Python in the loop: one call fills a contiguous
// [n_clips, n_per_clip, out_h, out_w, 3] buffer; frames past EOF are padded
// with the last decoded frame (the reference's policy,
// the reference's nexar_videos.py); per-clip status lands in
// frames_written (-1 on error → caller applies its zero-fallback).
// ---------------------------------------------------------------------------
long vcd_decode_batch3(const char** paths, long n_clips, const long* indices,
                       long n_per_clip, int target_w, int target_h,
                       int letterbox, int fast_resize, int lowres,
                       int n_threads, unsigned char* out,
                       long* frames_written) {
  if (n_clips <= 0 || n_per_clip <= 0) {
    set_error("empty batch");
    return -1;
  }
  const size_t clip_bytes =
      (size_t)n_per_clip * target_h * target_w * 3;
  std::atomic<long> next{0};

  auto worker = [&]() {
    while (true) {
      long i = next.fetch_add(1);
      if (i >= n_clips) break;
      unsigned char* dst = out + (size_t)i * clip_bytes;
      long got = vcd_decode3(paths[i], indices + (size_t)i * n_per_clip,
                             n_per_clip, target_w, target_h, letterbox,
                             fast_resize, lowres, dst);
      if (got <= 0) {
        std::memset(dst, 0, clip_bytes);
        frames_written[i] = -1;
        continue;
      }
      for (long f = got; f < n_per_clip; f++) {  // EOF pad
        std::memcpy(dst + (size_t)f * target_h * target_w * 3,
                    dst + (size_t)(got - 1) * target_h * target_w * 3,
                    (size_t)target_h * target_w * 3);
      }
      frames_written[i] = got;
    }
  };

  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  nt = (int)std::max<long>(1, std::min<long>(nt, n_clips));
  std::vector<std::thread> pool;
  for (int t = 0; t < nt - 1; t++) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return 0;
}

long vcd_decode_batch2(const char** paths, long n_clips, const long* indices,
                       long n_per_clip, int target_w, int target_h,
                       int letterbox, int fast_resize, int n_threads,
                       unsigned char* out, long* frames_written) {
  return vcd_decode_batch3(paths, n_clips, indices, n_per_clip, target_w,
                           target_h, letterbox, fast_resize, /*lowres=*/-1,
                           n_threads, out, frames_written);
}

long vcd_decode_batch(const char** paths, long n_clips, const long* indices,
                      long n_per_clip, int target_w, int target_h,
                      int letterbox, int n_threads, unsigned char* out,
                      long* frames_written) {
  return vcd_decode_batch3(paths, n_clips, indices, n_per_clip, target_w,
                           target_h, letterbox, /*fast_resize=*/-1,
                           /*lowres=*/-1, n_threads, out, frames_written);
}

// ---------------------------------------------------------------------------
// Streaming encode: open → append chunks → close. Bounded memory for
// arbitrarily long videos (the batch vcd_encode below wraps this for the
// one-shot case). RGB24 in, MP4/mpeg4/yuv420p out.
// ---------------------------------------------------------------------------
struct VcdEncoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* enc = nullptr;
  AVStream* stream = nullptr;
  SwsContext* sws = nullptr;
  AVFrame* yuv = nullptr;
  AVPacket* pkt = nullptr;
  long next_pts = 0;
  int w = 0, h = 0;
};

static void encoder_free(VcdEncoder* e) {
  if (!e) return;
  if (e->pkt) av_packet_free(&e->pkt);
  if (e->yuv) av_frame_free(&e->yuv);
  if (e->sws) sws_freeContext(e->sws);
  if (e->enc) avcodec_free_context(&e->enc);
  if (e->fmt) {
    if (!(e->fmt->oformat->flags & AVFMT_NOFILE) && e->fmt->pb)
      avio_closep(&e->fmt->pb);
    avformat_free_context(e->fmt);
  }
  delete e;
}

static bool encoder_drain(VcdEncoder* e) {
  while (true) {
    int r2 = avcodec_receive_packet(e->enc, e->pkt);
    if (r2 == AVERROR(EAGAIN) || r2 == AVERROR_EOF) break;
    if (r2 < 0) return false;
    av_packet_rescale_ts(e->pkt, e->enc->time_base, e->stream->time_base);
    e->pkt->stream_index = e->stream->index;
    av_interleaved_write_frame(e->fmt, e->pkt);
    av_packet_unref(e->pkt);
  }
  return true;
}

// Extended open: codec_name selects the encoder ("mpeg4", "libx264", ...);
// gop_size > 0 sets the keyframe interval; max_b_frames >= 0 sets the
// B-frame budget (x264 layers disposable B-frames the decoder's NONREF skip
// can drop); crf >= 0 switches x264-family encoders to constant-quality mode
// (bit_rate is used otherwise); preset (may be NULL) maps to the x264 preset.
void* vcd_encode_open2(const char* path, int w, int h, double fps,
                       const char* codec_name, int gop_size, int max_b_frames,
                       double crf, const char* preset) {
  if (w % 2 || h % 2) {
    set_error("encode requires even dimensions (yuv420p)");
    return nullptr;
  }
  VcdEncoder* e = new VcdEncoder();
  e->w = w;
  e->h = h;
  int ret = avformat_alloc_output_context2(&e->fmt, nullptr, nullptr, path);
  if (ret < 0 || !e->fmt) {
    set_error("alloc_output_context failed: " + av_err(ret));
    encoder_free(e);
    return nullptr;
  }
  const AVCodec* codec =
      codec_name && codec_name[0]
          ? avcodec_find_encoder_by_name(codec_name)
          : avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (!codec) {
    set_error(std::string("encoder unavailable: ") +
              (codec_name ? codec_name : "mpeg4"));
    encoder_free(e);
    return nullptr;
  }
  auto fail = [&](const std::string& msg) -> void* {
    set_error(msg);
    encoder_free(e);
    return nullptr;
  };
  e->stream = avformat_new_stream(e->fmt, nullptr);
  if (!e->stream) return fail("avformat_new_stream failed");
  e->enc = avcodec_alloc_context3(codec);
  if (!e->enc) return fail("avcodec_alloc_context3 failed");
  e->enc->width = w;
  e->enc->height = h;
  e->enc->pix_fmt = AV_PIX_FMT_YUV420P;
  AVRational fr = av_d2q(fps, 1000000);
  e->enc->time_base = av_inv_q(fr);
  e->enc->framerate = fr;
  // crf is an x264-family private option; on encoders without it,
  // av_opt_set_double fails — fall back to bit-rate mode instead of
  // silently leaving bit_rate at 0 (advisor finding).
  if (crf < 0.0 || av_opt_set_double(e->enc->priv_data, "crf", crf, 0) < 0)
    e->enc->bit_rate = (int64_t)w * h * 8;
  if (preset && preset[0])
    av_opt_set(e->enc->priv_data, "preset", preset, 0);
  if (gop_size > 0) e->enc->gop_size = gop_size;
  if (max_b_frames >= 0) e->enc->max_b_frames = max_b_frames;
  if (e->fmt->oformat->flags & AVFMT_GLOBALHEADER)
    e->enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if ((ret = avcodec_open2(e->enc, codec, nullptr)) < 0)
    return fail("encoder open failed: " + av_err(ret));
  avcodec_parameters_from_context(e->stream->codecpar, e->enc);
  e->stream->time_base = e->enc->time_base;
  e->stream->avg_frame_rate = fr;
  if (!(e->fmt->oformat->flags & AVFMT_NOFILE)) {
    if ((ret = avio_open(&e->fmt->pb, path, AVIO_FLAG_WRITE)) < 0)
      return fail("avio_open failed: " + av_err(ret));
  }
  if ((ret = avformat_write_header(e->fmt, nullptr)) < 0)
    return fail("write_header failed: " + av_err(ret));
  e->sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, w, h, AV_PIX_FMT_YUV420P,
                          SWS_BILINEAR, nullptr, nullptr, nullptr);
  if (!e->sws) return fail("encoder sws_getContext failed");
  e->yuv = av_frame_alloc();
  if (!e->yuv) return fail("av_frame_alloc failed");
  e->yuv->format = AV_PIX_FMT_YUV420P;
  e->yuv->width = w;
  e->yuv->height = h;
  if ((ret = av_frame_get_buffer(e->yuv, 0)) < 0)
    return fail("av_frame_get_buffer failed: " + av_err(ret));
  e->pkt = av_packet_alloc();
  if (!e->pkt) return fail("av_packet_alloc failed");
  return e;
}

void* vcd_encode_open(const char* path, int w, int h, double fps) {
  // Legacy default: mpeg4, gop 12 (frequent keyframes → cheap seeks),
  // no B-frames, bit-rate mode.
  return vcd_encode_open2(path, w, h, fps, "mpeg4", 12, 0, -1.0, nullptr);
}

// frames: n * h * w * 3 bytes appended in display order. Returns 0 on
// success, -1 on error (encoder left usable for close).
int vcd_encode_append(void* handle, const unsigned char* frames, long n) {
  VcdEncoder* e = (VcdEncoder*)handle;
  if (!e) {
    set_error("null encoder handle");
    return -1;
  }
  for (long i = 0; i < n; i++) {
    av_frame_make_writable(e->yuv);
    const uint8_t* src_data[1] = {frames + (size_t)i * e->h * e->w * 3};
    int src_linesize[1] = {e->w * 3};
    sws_scale(e->sws, src_data, src_linesize, 0, e->h, e->yuv->data,
              e->yuv->linesize);
    e->yuv->pts = e->next_pts++;  // one tick per frame (time_base == 1/fps)
    if (avcodec_send_frame(e->enc, e->yuv) < 0 || !encoder_drain(e)) {
      set_error("encode failed at frame " + std::to_string(e->next_pts));
      return -1;
    }
  }
  return 0;
}

// Flush, write trailer, free. Returns 0 on success.
int vcd_encode_close(void* handle) {
  VcdEncoder* e = (VcdEncoder*)handle;
  if (!e) return 0;
  avcodec_send_frame(e->enc, nullptr);
  bool ok = encoder_drain(e);
  av_write_trailer(e->fmt);
  encoder_free(e);
  return ok ? 0 : -1;
}

// ---------------------------------------------------------------------------
// One-shot encode: RGB24 frames -> MP4 (wraps the streaming encoder).
// frames: n * h * w * 3 bytes. Returns 0 on success.
// ---------------------------------------------------------------------------
int vcd_encode(const char* path, const unsigned char* frames, long n, int w,
               int h, double fps) {
  void* e = vcd_encode_open(path, w, h, fps);
  if (!e) return -1;
  int rc = vcd_encode_append(e, frames, n);
  int rc2 = vcd_encode_close(e);
  return rc != 0 ? rc : rc2;
}

}  // extern "C"
