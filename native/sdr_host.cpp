// sdr_host — native host-side runtime for sdr_tpu.
//
// The reference is a header-only C++ DSP library (lib/inc/*.hpp); in
// sdr_tpu the numerics live in XLA, so the native layer's job moves
// to the HOST data path: high-rate byte/bit framing, streaming ring
// buffers feeding the device, CRC frame integrity, and an independent
// C++ golden oracle of the reference PHY contract (FFT conventions,
// Gray 16-QAM) that the JAX ops are parity-tested against.
//
// Everything is exported with C linkage and driven from Python via
// ctypes (sdr_tpu/native). Contract notes cite the reference file:line
// they reproduce; the implementations are written fresh (precomputed
// twiddle tables rather than the reference's recurrence, fft.hpp:113-150;
// formula-generated Gray tables rather than literals, modulation.hpp:29-47).

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Ring buffer (float32) — utils::sliding_buffer semantics
// (sliding_buffer.hpp:52-99): logical index pos -> data[(cur+pos)%size],
// push wraps at the physical end, cursor lands one past the last write.
// ---------------------------------------------------------------------------

struct SdrRing {
  std::vector<float> data;
  size_t cur;
};

SdrRing* sdr_ring_create(size_t size) {
  auto* r = new SdrRing();
  r->data.assign(size, 0.0f);
  r->cur = 0;
  return r;
}

void sdr_ring_destroy(SdrRing* r) { delete r; }

size_t sdr_ring_size(const SdrRing* r) { return r->data.size(); }

// Returns 0 on success, -1 if n - free > size (the reference's
// untested overflow, SURVEY.md component #11 — rejected).
int sdr_ring_push(SdrRing* r, const float* vals, size_t n) {
  const size_t size = r->data.size();
  const size_t free_slots = size - r->cur;
  if (n > free_slots && n - free_slots > size) return -1;
  const size_t head = n < free_slots ? n : free_slots;
  std::memcpy(r->data.data() + r->cur, vals, head * sizeof(float));
  if (head == free_slots && n > head) {
    const size_t rest = n - head;
    std::memcpy(r->data.data(), vals + head, rest * sizeof(float));
    r->cur = rest;
  } else {
    r->cur += head;
    if (r->cur == size) r->cur = 0;
  }
  return 0;
}

// Copy the buffer in logical order (oldest at index 0) into out[size].
void sdr_ring_window(const SdrRing* r, float* out) {
  const size_t size = r->data.size();
  const size_t tail = size - r->cur;
  std::memcpy(out, r->data.data() + r->cur, tail * sizeof(float));
  std::memcpy(out + tail, r->data.data(), r->cur * sizeof(float));
}

// ---------------------------------------------------------------------------
// Bit packing — MSB-first within each byte (modulation.hpp:87-91, 108).
// ---------------------------------------------------------------------------

void sdr_unpack_bits(const uint8_t* bytes, size_t n, uint8_t* bits_out) {
  for (size_t i = 0; i < n; ++i) {
    const uint8_t b = bytes[i];
    uint8_t* o = bits_out + 8 * i;
    for (int j = 0; j < 8; ++j) o[j] = (b >> (7 - j)) & 1;
  }
}

void sdr_pack_bits(const uint8_t* bits, size_t n_bits, uint8_t* bytes_out) {
  const size_t n = n_bits / 8;
  for (size_t i = 0; i < n; ++i) {
    uint8_t b = 0;
    const uint8_t* p = bits + 8 * i;
    for (int j = 0; j < 8; ++j) b = static_cast<uint8_t>((b << 1) | (p[j] & 1));
    bytes_out[i] = b;
  }
}

// ---------------------------------------------------------------------------
// CRC-32 (IEEE 802.3, reflected) — frame integrity for streaming links.
// The reference has no framing at all; real SDR payloads need an FCS.
// ---------------------------------------------------------------------------

namespace {
struct Crc32Table {
  uint32_t t[256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};
}  // namespace

uint32_t sdr_crc32(const uint8_t* data, size_t n) {
  // Magic static: thread-safe one-time init (ctypes calls drop the GIL,
  // so concurrent first calls are possible).
  static const Crc32Table table;
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i)
    crc = table.t[(crc ^ data[i]) & 0xFFu] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// Golden-oracle FFT — double precision, iterative radix-2 DIT with a
// PRECOMPUTED twiddle table (not the reference's on-the-fly recurrence,
// fft.hpp:113-150). Conventions match fft.hpp:176-205: forward kernel
// e^{-2πi nk/N} unscaled; inverse e^{+2πi nk/N} scaled by 1/N.
// Returns 0 on success, -1 if n is not a power of two (fft.hpp:90-92).
// ---------------------------------------------------------------------------

static void bit_reverse_reorder(std::complex<double>* x, size_t n) {
  const int log2n = static_cast<int>(std::log2(static_cast<double>(n)) + 0.5);
  for (size_t i = 0; i < n; ++i) {
    size_t rev = 0;
    for (int b = 0; b < log2n; ++b)
      if (i & (size_t{1} << b)) rev |= size_t{1} << (log2n - 1 - b);
    if (rev > i) std::swap(x[i], x[rev]);
  }
}

int sdr_fft(double* re, double* im, size_t n, int inverse) {
  if (n == 0 || (n & (n - 1)) != 0) return -1;
  std::vector<std::complex<double>> x(n);
  for (size_t i = 0; i < n; ++i) x[i] = {re[i], im[i]};
  bit_reverse_reorder(x.data(), n);

  // Twiddle table for the largest stage, strided for smaller ones.
  const double sign = inverse ? 1.0 : -1.0;
  std::vector<std::complex<double>> tw(n / 2);
  for (size_t k = 0; k < n / 2; ++k) {
    const double ang = sign * 2.0 * kPi * static_cast<double>(k) / static_cast<double>(n);
    tw[k] = {std::cos(ang), std::sin(ang)};
  }

  for (size_t len = 2; len <= n; len <<= 1) {
    const size_t stride = n / len;
    for (size_t blk = 0; blk < n; blk += len) {
      for (size_t j = 0; j < len / 2; ++j) {
        const std::complex<double> w = tw[j * stride];
        const std::complex<double> a = x[blk + j];
        const std::complex<double> b = x[blk + j + len / 2] * w;
        x[blk + j] = a + b;
        x[blk + j + len / 2] = a - b;
      }
    }
  }

  const double scale = inverse ? 1.0 / static_cast<double>(n) : 1.0;
  for (size_t i = 0; i < n; ++i) {
    re[i] = x[i].real() * scale;
    im[i] = x[i].imag() * scale;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Golden-oracle Gray QAM — formula-generated (binary-reflected Gray per
// axis, unit-Es normalization), covering the whole roster the reference
// names (modulation.hpp:13-14, 70-72). bits_per_symbol in {1,2,4,6,8,10}.
// Symbol index: MSB half -> I Gray index, LSB half -> Q (modulation.hpp
// 16-QAM table reproduced for bps=4; validated against it in tests).
// ---------------------------------------------------------------------------

static uint32_t gray_to_binary(uint32_t g) {
  for (uint32_t s = 1; s < 32; s <<= 1) g ^= g >> s;
  return g;
}

int sdr_qam_map(const uint8_t* bits, size_t n_bits, int bits_per_symbol,
                double* re_out, double* im_out) {
  if (bits_per_symbol < 1 || bits_per_symbol > 10 ||
      (bits_per_symbol > 1 && bits_per_symbol % 2))
    return -1;
  if (n_bits % static_cast<size_t>(bits_per_symbol)) return -1;
  const int m = bits_per_symbol == 1 ? 1 : bits_per_symbol / 2;
  const int L = 1 << m;
  const double es =
      bits_per_symbol == 1 ? (L * L - 1) / 3.0 : 2.0 * (L * L - 1) / 3.0;
  const double norm = 1.0 / std::sqrt(es);
  const size_t n_sym = n_bits / static_cast<size_t>(bits_per_symbol);
  for (size_t s = 0; s < n_sym; ++s) {
    uint32_t idx = 0;
    for (int j = 0; j < bits_per_symbol; ++j)
      idx = (idx << 1) | (bits[s * bits_per_symbol + j] & 1);
    if (bits_per_symbol == 1) {
      const int lev = 2 * static_cast<int>(gray_to_binary(idx)) - (L - 1);
      re_out[s] = lev * norm;
      im_out[s] = 0.0;
    } else {
      const uint32_t gi = idx >> m;
      const uint32_t gq = idx & static_cast<uint32_t>(L - 1);
      re_out[s] = (2 * static_cast<int>(gray_to_binary(gi)) - (L - 1)) * norm;
      im_out[s] = (2 * static_cast<int>(gray_to_binary(gq)) - (L - 1)) * norm;
    }
  }
  return 0;
}

int sdr_qam_demap_hard(const double* re, const double* im, size_t n_sym,
                       int bits_per_symbol, uint8_t* bits_out) {
  if (bits_per_symbol < 1 || bits_per_symbol > 10 ||
      (bits_per_symbol > 1 && bits_per_symbol % 2))
    return -1;
  const int m = bits_per_symbol == 1 ? 1 : bits_per_symbol / 2;
  const int L = 1 << m;
  const double es =
      bits_per_symbol == 1 ? (L * L - 1) / 3.0 : 2.0 * (L * L - 1) / 3.0;
  const double inorm = std::sqrt(es);
  auto axis_gray = [&](double v) -> uint32_t {
    // Nearest odd level via round+clip (equivalent to the reference's
    // brute-force min scan, modulation.hpp:55-65, restricted per axis).
    int i = static_cast<int>(std::lround((v * inorm + (L - 1)) * 0.5));
    if (i < 0) i = 0;
    if (i > L - 1) i = L - 1;
    const uint32_t u = static_cast<uint32_t>(i);
    return u ^ (u >> 1);
  };
  for (size_t s = 0; s < n_sym; ++s) {
    uint32_t idx;
    if (bits_per_symbol == 1) {
      idx = axis_gray(re[s]);
    } else {
      idx = (axis_gray(re[s]) << m) | axis_gray(im[s]);
    }
    for (int j = 0; j < bits_per_symbol; ++j)
      bits_out[s * bits_per_symbol + j] =
          static_cast<uint8_t>((idx >> (bits_per_symbol - 1 - j)) & 1);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Full host oracle link: bytes -> QAM -> IFFT+CP -> (identity) -> RX.
// The host twin of the reference demo frame (QFDemoWindow.cpp:210-222),
// used to cross-check the jitted device loopback end to end.
// Layout per OFDM symbol: [cp | n_fft] with cp = copy of the LAST cp
// time samples (ofdm.hpp:17-21). Returns 0 on success.
// ---------------------------------------------------------------------------

int sdr_ofdm_tx(const double* re_in, const double* im_in, size_t n_fft,
                size_t cp, double* re_out, double* im_out) {
  if (cp > n_fft) return -1;
  std::vector<double> r(re_in, re_in + n_fft), i(im_in, im_in + n_fft);
  if (sdr_fft(r.data(), i.data(), n_fft, 1) != 0) return -1;
  std::memcpy(re_out + cp, r.data(), n_fft * sizeof(double));
  std::memcpy(im_out + cp, i.data(), n_fft * sizeof(double));
  std::memcpy(re_out, r.data() + (n_fft - cp), cp * sizeof(double));
  std::memcpy(im_out, i.data() + (n_fft - cp), cp * sizeof(double));
  return 0;
}

int sdr_ofdm_rx(const double* re_in, const double* im_in, size_t n_total,
                size_t cp, double* re_out, double* im_out) {
  if (cp >= n_total) return -1;
  const size_t n_fft = n_total - cp;
  std::memcpy(re_out, re_in + cp, n_fft * sizeof(double));
  std::memcpy(im_out, im_in + cp, n_fft * sizeof(double));
  return sdr_fft(re_out, im_out, n_fft, 0);
}

}  // extern "C"
