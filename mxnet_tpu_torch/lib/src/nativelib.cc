// Native IO runtime of mxnet_tpu_torch (the port's own copy of the JAX
// package's lib/src/nativelib.cc, without the StableHLO runner).
//
// Reference: dmlc-core's C++ RecordIO (include/dmlc/recordio.h,
// src/recordio.cc) and the C++ iterator tier (src/io/iter_csv.cc,
// src/io/iter_image_recordio_2.cc).  The host-side input path (record
// scanning, framed reads, CSV tokenizing, JPEG decode) is byte-churning
// work Python does slowly; this library is that tier, exposed over a
// plain C ABI consumed via ctypes (mxnet_tpu_torch/lib/nativelib.py),
// with the pure-Python implementation as the always-available fallback.
//
// ABI version 2: every export below (mxnative_has_jpeg included, and
// mxjpeg_decode_batch when libjpeg is linked).  The loader checks the
// version and every symbol; a library that lacks one is rebuilt.
//
// Format (byte-compatible with mxnet_tpu_torch/recordio.py and dmlc):
//   [magic:u32 LE][lrec:u32 LE][payload][pad to 4B]
//   lrec = cflag<<29 | len ; multipart cflags 1/2/3 re-join with the
//   magic word (payloads containing the magic are split on write).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xced7230a;
constexpr uint32_t kLenMask = (1u << 29) - 1;

struct Reader {
  FILE* f = nullptr;
  int64_t size = 0;
};

inline int64_t pad4(int64_t n) { return (4 - n % 4) % 4; }

}  // namespace

extern "C" {

// ---------------------------------------------------------------- reader
void* mxrec_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new Reader();
  r->f = f;
  std::fseek(f, 0, SEEK_END);
  r->size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  return r;
}

void mxrec_close(void* h) {
  if (!h) return;
  auto* r = static_cast<Reader*>(h);
  if (r->f) std::fclose(r->f);
  delete r;
}

// Scan the file, writing the byte offset of each *logical* record
// (multipart = one record) into `offsets` (capacity `cap`; pass cap=0 to
// count only).  Returns the record count, or -1 on a framing error.
int64_t mxrec_index(void* h, int64_t* offsets, int64_t cap) {
  auto* r = static_cast<Reader*>(h);
  std::fseek(r->f, 0, SEEK_SET);
  int64_t pos = 0, count = 0;
  while (pos + 8 <= r->size) {
    int64_t record_start = pos;
    bool logical_start = true;
    // walk the (possibly multipart) frame chain
    while (true) {
      uint32_t head[2];
      if (std::fseek(r->f, pos, SEEK_SET) != 0) return -1;
      if (std::fread(head, 4, 2, r->f) != 2) return count;  // EOF
      if (head[0] != kMagic) return -1;
      uint32_t cflag = head[1] >> 29;
      int64_t len = head[1] & kLenMask;
      pos += 8 + len + pad4(len);
      if (logical_start && cflag != 0 && cflag != 1) return -1;
      logical_start = false;
      if (cflag == 0 || cflag == 3) break;
    }
    if (offsets && count < cap) offsets[count] = record_start;
    ++count;
  }
  return count;
}

// Read the logical record at `offset`, re-joining multipart frames with
// the magic word.  Returns payload length; if it exceeds `cap` nothing is
// written and the required size is returned (call again with a bigger
// buffer).  Returns -1 on framing errors.
int64_t mxrec_read_at(void* h, int64_t offset, char* buf, int64_t cap) {
  auto* r = static_cast<Reader*>(h);
  int64_t pos = offset, total = 0;
  bool measuring_done = false;
  // first pass: measure; second: copy (single pass when it fits)
  std::vector<std::pair<int64_t, int64_t>> spans;  // (file_pos, len)
  while (true) {
    uint32_t head[2];
    if (std::fseek(r->f, pos, SEEK_SET) != 0) return -1;
    if (std::fread(head, 4, 2, r->f) != 2) return -1;
    if (head[0] != kMagic) return -1;
    uint32_t cflag = head[1] >> 29;
    int64_t len = head[1] & kLenMask;
    if (!spans.empty()) total += 4;  // joining magic
    spans.emplace_back(pos + 8, len);
    total += len;
    pos += 8 + len + pad4(len);
    if (cflag == 0 || cflag == 3) break;
  }
  if (total > cap || !buf) return total;
  char* out = buf;
  for (size_t i = 0; i < spans.size(); ++i) {
    if (i > 0) {
      std::memcpy(out, &kMagic, 4);
      out += 4;
    }
    std::fseek(r->f, spans[i].first, SEEK_SET);
    if (std::fread(out, 1, spans[i].second, r->f) !=
        static_cast<size_t>(spans[i].second))
      return -1;
    out += spans[i].second;
  }
  (void)measuring_done;
  return total;
}

// ---------------------------------------------------------------- writer
void* mxrec_create(const char* path) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  auto* r = new Reader();
  r->f = f;
  return r;
}

// Write one logical record, splitting embedded magic words into multipart
// frames exactly like dmlc::RecordIOWriter.  Returns bytes written, -1 on
// IO error.
int64_t mxrec_write(void* h, const char* data, int64_t len) {
  auto* r = static_cast<Reader*>(h);
  // find split points at embedded magics
  std::vector<std::pair<const char*, int64_t>> parts;
  const char* p = data;
  const char* end = data + len;
  const char* part_start = p;
  while (p + 4 <= end) {
    uint32_t w;
    std::memcpy(&w, p, 4);
    if (w == kMagic) {
      parts.emplace_back(part_start, p - part_start);
      p += 4;
      part_start = p;
    } else {
      ++p;
    }
  }
  parts.emplace_back(part_start, end - part_start);
  int64_t written = 0;
  const size_t n = parts.size();
  for (size_t i = 0; i < n; ++i) {
    uint32_t cflag = 0;
    if (n > 1) cflag = (i == 0) ? 1 : (i == n - 1 ? 3 : 2);
    int64_t plen = parts[i].second;
    uint32_t lrec = (cflag << 29) | static_cast<uint32_t>(plen);
    if (std::fwrite(&kMagic, 4, 1, r->f) != 1) return -1;
    if (std::fwrite(&lrec, 4, 1, r->f) != 1) return -1;
    if (plen && std::fwrite(parts[i].first, 1, plen, r->f) !=
                    static_cast<size_t>(plen))
      return -1;
    static const char zeros[4] = {0, 0, 0, 0};
    int64_t pad = pad4(plen);
    if (pad && std::fwrite(zeros, 1, pad, r->f) !=
                   static_cast<size_t>(pad))
      return -1;
    written += 8 + plen + pad;
  }
  return written;
}

// ------------------------------------------------------------------- csv
// Count values and rows of a comma/newline-separated float file.
// Returns rows; *n_vals gets the total value count; -1 on open failure.
int64_t mxcsv_shape(const char* path, int64_t* n_vals) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int64_t rows = 0, vals = 0;
  bool in_field = false, line_had_data = false;
  int c;
  char bufc[1 << 16];
  size_t got;
  while ((got = std::fread(bufc, 1, sizeof bufc, f)) > 0) {
    for (size_t i = 0; i < got; ++i) {
      c = bufc[i];
      if (c == ',' || c == '\n') {
        if (in_field) ++vals;
        in_field = false;
        if (c == '\n') {
          if (line_had_data) ++rows;
          line_had_data = false;
        }
      } else if (c != '\r' && c != ' ' && c != '\t') {
        in_field = true;
        line_had_data = true;
      }
    }
  }
  if (in_field) ++vals;
  if (line_had_data) ++rows;
  std::fclose(f);
  *n_vals = vals;
  return rows;
}

// Parse floats into `out` (capacity cap).  Returns values parsed, -1 on
// open failure, -2 on overflow, -3 on a non-numeric field (e.g. a CSV
// header) — callers must fail loudly, matching np.loadtxt's ValueError.
int64_t mxcsv_parse(const char* path, float* out, int64_t cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  // stream with a field buffer: fields never exceed 64 chars for floats
  char field[64];
  int flen = 0;
  int64_t n = 0;
  char bufc[1 << 16];
  size_t got;
  int err = 0;
  auto flush = [&]() -> bool {
    if (flen == 0) return true;
    field[flen] = 0;
    if (n >= cap) { err = -2; return false; }
    char* endp = nullptr;
    float v = std::strtof(field, &endp);
    // trailing spaces are fine; any other unconsumed char is not a float
    while (endp && (*endp == ' ' || *endp == '\t')) ++endp;
    if (endp == field || (endp && *endp != 0)) { err = -3; return false; }
    out[n++] = v;
    flen = 0;
    return true;
  };
  while ((got = std::fread(bufc, 1, sizeof bufc, f)) > 0) {
    for (size_t i = 0; i < got; ++i) {
      char c = bufc[i];
      if (c == ',' || c == '\n' || c == '\r') {
        if (!flush()) { std::fclose(f); return err; }
      } else if (flen < 63) {
        field[flen++] = c;
      }
    }
  }
  bool ok = flush();
  std::fclose(f);
  return ok ? n : err;
}

int mxnative_abi_version() { return 2; }

}  // extern "C"

// --------------------------------------------------------------------------
// Threaded JPEG decode tier (reference: src/io/iter_image_recordio_2.cc —
// the reference's C++ decode/augment worker POOL; SURVEY.md §2.1 Data
// iterators, §7.3).  One C call decodes a whole batch on OS threads:
// libjpeg DCT-domain scaling (scale_denom) toward the resize target, a
// fused bilinear resize+crop gather (no intermediate full-size image),
// optional horizontal mirror, CHW uint8 output.  Crop positions come in
// as fractions so augmentation randomness stays under Python's seeded
// RNG while all byte churn happens here, GIL-free.
// --------------------------------------------------------------------------
#ifndef MXNATIVE_NO_JPEG

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <csetjmp>
#include <thread>

namespace {

struct JErr {
  jpeg_error_mgr mgr;
  std::jmp_buf jb;
};

void jerr_exit(j_common_ptr cinfo) {
  std::longjmp(reinterpret_cast<JErr*>(cinfo->err)->jb, 1);
}

void jerr_silent(j_common_ptr, int) {}

bool decode_one(const uint8_t* buf, int64_t len, int min_side,
                std::vector<uint8_t>* px, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jerr_exit;
  jerr.mgr.emit_message = jerr_silent;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  if (min_side > 0) {
    // largest denom in {1,2,4,8} that keeps the short side >= target:
    // 1/denom decode happens in the DCT domain — decoding a 4x-reduced
    // image costs ~1/16th the IDCT work
    unsigned denom = 1;
    unsigned short_side = std::min(cinfo.image_width, cinfo.image_height);
    while (denom < 8 && short_side / (denom * 2) >=
                            static_cast<unsigned>(min_side))
      denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3) {  // grayscale promoted by JCS_RGB;
    jpeg_destroy_decompress(&cinfo);   // anything else is unsupported
    return false;
  }
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  px->resize(static_cast<size_t>(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW rp = px->data() +
                  static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &rp, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Fused bilinear resize(short side -> R) + crop(out_h x out_w at
// fractional offset) + mirror, sampling straight from the decoded image
// into CHW uint8 output.
void resize_crop(const std::vector<uint8_t>& px, int w0, int h0,
                 int resize_min, int out_h, int out_w, float cy_frac,
                 float cx_frac, bool mirror, uint8_t* out) {
  float scale = 1.0f;
  if (resize_min > 0)
    scale = static_cast<float>(resize_min) / std::min(w0, h0);
  int rw = std::max(out_w, static_cast<int>(w0 * scale + 0.5f));
  int rh = std::max(out_h, static_cast<int>(h0 * scale + 0.5f));
  float sx = static_cast<float>(w0) / rw;
  float sy = static_cast<float>(h0) / rh;
  // INTEGER crop offsets, exactly like the Python/cv2 tier (randint /
  // floor-div-2 center) — a fractional offset is a half-pixel phase
  // shift versus that tier.  frac < 0 = center crop; otherwise the
  // fraction maps uniformly onto {0..range} inclusive.
  auto crop_at = [](float frac, int range) -> float {
    if (frac < 0.0f) return static_cast<float>(range / 2);
    return static_cast<float>(
        std::min(static_cast<int>(frac * (range + 1)), range));
  };
  float cy = crop_at(cy_frac, rh - out_h);
  float cx = crop_at(cx_frac, rw - out_w);
  const size_t plane = static_cast<size_t>(out_h) * out_w;
  for (int i = 0; i < out_h; ++i) {
    float fy = (cy + i + 0.5f) * sy - 0.5f;
    fy = std::min(std::max(fy, 0.0f), static_cast<float>(h0 - 1));
    int y0 = static_cast<int>(fy);
    int y1 = std::min(y0 + 1, h0 - 1);
    float wy = fy - y0;
    for (int j = 0; j < out_w; ++j) {
      float fx = (cx + j + 0.5f) * sx - 0.5f;
      fx = std::min(std::max(fx, 0.0f), static_cast<float>(w0 - 1));
      int x0 = static_cast<int>(fx);
      int x1 = std::min(x0 + 1, w0 - 1);
      float wx = fx - x0;
      const uint8_t* p00 = &px[(static_cast<size_t>(y0) * w0 + x0) * 3];
      const uint8_t* p01 = &px[(static_cast<size_t>(y0) * w0 + x1) * 3];
      const uint8_t* p10 = &px[(static_cast<size_t>(y1) * w0 + x0) * 3];
      const uint8_t* p11 = &px[(static_cast<size_t>(y1) * w0 + x1) * 3];
      int jo = mirror ? out_w - 1 - j : j;
      for (int c = 0; c < 3; ++c) {
        float v = (1 - wy) * ((1 - wx) * p00[c] + wx * p01[c]) +
                  wy * ((1 - wx) * p10[c] + wx * p11[c]);
        out[c * plane + static_cast<size_t>(i) * out_w + jo] =
            static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

int mxnative_has_jpeg() { return 1; }

// Decode n JPEGs into out (n, 3, out_h, out_w) uint8 on n_threads OS
// threads.  status[i]: 0 = ok, 1 = decode failed (caller re-tries that
// image on its fallback path).  Returns the success count.
int64_t mxjpeg_decode_batch(const uint8_t* const* bufs,
                            const int64_t* lens, int64_t n,
                            int resize_min, int out_h, int out_w,
                            const float* cy_frac, const float* cx_frac,
                            const uint8_t* mirror, uint8_t* out,
                            uint8_t* status, int64_t n_threads) {
  const size_t stride = static_cast<size_t>(3) * out_h * out_w;
  std::atomic<int64_t> next(0), ok_count(0);
  auto worker = [&]() {
    std::vector<uint8_t> px;
    int64_t i;
    while ((i = next.fetch_add(1)) < n) {
      int w0 = 0, h0 = 0;
      if (!decode_one(bufs[i], lens[i], resize_min, &px, &w0, &h0) ||
          w0 < 1 || h0 < 1) {
        status[i] = 1;
        continue;
      }
      resize_crop(px, w0, h0, resize_min, out_h, out_w, cy_frac[i],
                  cx_frac[i], mirror[i] != 0, out + i * stride);
      status[i] = 0;
      ok_count.fetch_add(1);
    }
  };
  int64_t nt = std::min<int64_t>(std::max<int64_t>(n_threads, 1), n);
  std::vector<std::thread> pool;
  for (int64_t t = 1; t < nt; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return ok_count.load();
}

}  // extern "C"

#else  // MXNATIVE_NO_JPEG

extern "C" {
int mxnative_has_jpeg() { return 0; }
}

#endif  // MXNATIVE_NO_JPEG
