// mellow_tpu native audio runtime.
//
// TPU-native replacement for the reference's native audio substrate
// (torchaudio C++ wav I/O + sinc resampler, used at mellow/wrapper.py:144-148).
// Exposes a C ABI consumed via ctypes (mellow_tpu/native/binding.py):
//
//   * wav decode: RIFF/WAVE PCM 8/16/24/32 and IEEE float32/64,
//     WAVE_FORMAT_EXTENSIBLE; output float32 in [-1, 1] with torchaudio's
//     normalization (divide by 2^(bits-1)).
//   * polyphase windowed-sinc resampler with torchaudio's filter design
//     (hann window, lowpass_filter_width 6, rolloff 0.99) — identical math
//     to mellow_tpu/io/resample.py, double accumulation.
//   * segment preparation: channel-flatten + tile-repeat to the segment
//     length or crop at a host-chosen offset (the Python layer owns the
//     random crop draw for reference parity, wrapper.py:161-167).
//
// Build: make -C mellow_tpu/native   (g++ -O3 -shared; no external deps)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

struct WavData {
  std::vector<float> samples;  // interleaved
  int channels = 0;
  int sample_rate = 0;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) { return (uint16_t)(p[0] | (p[1] << 8)); }

// Returns 0 on success, negative error code otherwise.
int parse_wav(const uint8_t* buf, size_t len, WavData* out) {
  if (len < 12 || memcmp(buf, "RIFF", 4) != 0 || memcmp(buf + 8, "WAVE", 4) != 0)
    return -1;
  size_t pos = 12;
  int fmt_code = -1, channels = 0, sr = 0, bits = 0;
  const uint8_t* data = nullptr;
  size_t data_len = 0;
  while (pos + 8 <= len) {
    const uint8_t* cid = buf + pos;
    uint32_t csize = rd_u32(buf + pos + 4);
    pos += 8;
    if (pos + csize > len) csize = (uint32_t)(len - pos);
    if (memcmp(cid, "fmt ", 4) == 0 && csize >= 16) {
      fmt_code = rd_u16(buf + pos);
      channels = rd_u16(buf + pos + 2);
      sr = (int)rd_u32(buf + pos + 4);
      bits = rd_u16(buf + pos + 14);
      if (fmt_code == 0xFFFE && csize >= 26) fmt_code = rd_u16(buf + pos + 24);
    } else if (memcmp(cid, "data", 4) == 0) {
      data = buf + pos;
      data_len = csize;
    }
    pos += csize + (csize & 1);
    if (fmt_code >= 0 && data) break;
  }
  if (fmt_code < 0 || !data || channels <= 0 || sr <= 0) return -2;

  size_t n = 0;
  std::vector<float>& s = out->samples;
  if (fmt_code == 1) {  // PCM
    if (bits == 16) {
      n = data_len / 2;
      s.resize(n);
      for (size_t i = 0; i < n; ++i) {
        int16_t v = (int16_t)rd_u16(data + 2 * i);
        s[i] = (float)v / 32768.0f;
      }
    } else if (bits == 8) {
      n = data_len;
      s.resize(n);
      for (size_t i = 0; i < n; ++i) s[i] = ((float)data[i] - 128.0f) / 128.0f;
    } else if (bits == 24) {
      n = data_len / 3;
      s.resize(n);
      for (size_t i = 0; i < n; ++i) {
        int32_t v = (int32_t)data[3 * i] | ((int32_t)data[3 * i + 1] << 8) |
                    ((int32_t)data[3 * i + 2] << 16);
        if (v >= (1 << 23)) v -= (1 << 24);
        s[i] = (float)v / (float)(1 << 23);
      }
    } else if (bits == 32) {
      n = data_len / 4;
      s.resize(n);
      for (size_t i = 0; i < n; ++i) {
        int32_t v = (int32_t)rd_u32(data + 4 * i);
        s[i] = (float)((double)v / 2147483648.0);
      }
    } else {
      return -3;
    }
  } else if (fmt_code == 3) {  // IEEE float
    if (bits == 32) {
      n = data_len / 4;
      s.resize(n);
      memcpy(s.data(), data, n * 4);
    } else if (bits == 64) {
      n = data_len / 8;
      s.resize(n);
      for (size_t i = 0; i < n; ++i) {
        double v;
        memcpy(&v, data + 8 * i, 8);
        s[i] = (float)v;
      }
    } else {
      return -3;
    }
  } else {
    return -4;
  }
  size_t frames = n / channels;
  s.resize(frames * channels);
  out->channels = channels;
  out->sample_rate = sr;
  return 0;
}

int read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -10;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n < 0) { fclose(f); return -11; }
  out->resize((size_t)n);
  size_t got = fread(out->data(), 1, (size_t)n, f);
  fclose(f);
  return got == (size_t)n ? 0 : -12;
}

int gcd_int(int a, int b) { return b == 0 ? a : gcd_int(b, a % b); }

// torchaudio-compatible polyphase resample of a mono buffer.
// Mirrors mellow_tpu/io/resample.py (same filter formula).
void resample_mono(const float* x, size_t T, int orig_freq, int new_freq,
                   int lowpass_filter_width, double rolloff,
                   std::vector<float>* out) {
  if (orig_freq == new_freq) {
    out->assign(x, x + T);
    return;
  }
  int g = gcd_int(orig_freq, new_freq);
  int orig = orig_freq / g, nw = new_freq / g;
  double base_freq = (double)(orig < nw ? orig : nw) * rolloff;
  int width = (int)std::ceil((double)lowpass_filter_width * orig / base_freq);
  int K = 2 * width + orig;

  // kernels[p][k], p in [0, nw)
  std::vector<double> kernels((size_t)nw * K);
  for (int p = 0; p < nw; ++p) {
    for (int k = 0; k < K; ++k) {
      double idx = (double)(k - width) / orig;
      double t = -(double)p / nw + idx;
      t *= base_freq;
      if (t < -lowpass_filter_width) t = -lowpass_filter_width;
      if (t > lowpass_filter_width) t = lowpass_filter_width;
      double window = std::cos(t * kPi / lowpass_filter_width / 2.0);
      window *= window;
      double tp = t * kPi;
      double sinc = (tp == 0.0) ? 1.0 : std::sin(tp) / tp;
      kernels[(size_t)p * K + k] = sinc * window * (base_freq / orig);
    }
  }

  size_t target_len = (size_t)std::ceil((double)nw * T / orig);
  size_t num_frames = T / orig + 1;
  out->assign(target_len, 0.0f);
  // padded signal: [width zeros] x [width + orig zeros]
  for (size_t f = 0; f < num_frames; ++f) {
    long start = (long)f * orig - width;  // index into x of kernel tap 0
    for (int p = 0; p < nw; ++p) {
      size_t oi = f * nw + (size_t)p;
      if (oi >= target_len) break;
      const double* kr = &kernels[(size_t)p * K];
      double acc = 0.0;
      long lo = start < 0 ? -start : 0;
      long hi = (long)K;
      if (start + hi > (long)T) hi = (long)T - start;
      for (long k = lo; k < hi; ++k) acc += (double)x[start + k] * kr[k];
      (*out)[oi] = (float)acc;
    }
  }
}

}  // namespace

extern "C" {

// Decode a wav file. Two-call protocol:
//   1) wav_info(path, &channels, &frames, &sample_rate) -> 0 or error
//   2) wav_read(path, out_buffer /* channels*frames floats, channel-major */)
int mellow_wav_info(const char* path, int* channels, long* frames,
                    int* sample_rate) {
  std::vector<uint8_t> buf;
  int rc = read_file(path, &buf);
  if (rc != 0) return rc;
  WavData w;
  rc = parse_wav(buf.data(), buf.size(), &w);
  if (rc != 0) return rc;
  *channels = w.channels;
  *frames = (long)(w.samples.size() / w.channels);
  *sample_rate = w.sample_rate;
  return 0;
}

int mellow_wav_read(const char* path, float* out) {
  std::vector<uint8_t> buf;
  int rc = read_file(path, &buf);
  if (rc != 0) return rc;
  WavData w;
  rc = parse_wav(buf.data(), buf.size(), &w);
  if (rc != 0) return rc;
  size_t frames = w.samples.size() / w.channels;
  // de-interleave to channel-major (torchaudio layout: (C, T))
  for (size_t t = 0; t < frames; ++t)
    for (int c = 0; c < w.channels; ++c)
      out[(size_t)c * frames + t] = w.samples[t * w.channels + c];
  return 0;
}

// Resample mono float32. Returns output length, or negative error.
// out must have capacity ceil(new_freq * T / orig_freq).
long mellow_resample(const float* x, long T, int orig_freq, int new_freq,
                     float* out) {
  std::vector<float> y;
  resample_mono(x, (size_t)T, orig_freq, new_freq, 6, 0.99, &y);
  memcpy(out, y.data(), y.size() * sizeof(float));
  return (long)y.size();
}

// Full preprocessing for one file: decode, optional resample to target_sr,
// channel-flatten (concat channels, reference wrapper.py:149), then
// tile-repeat to segment_len or crop at crop_start (crop_start < 0 means
// "caller must crop"; we then fail, the Python layer draws the random
// start for reference parity). Writes exactly segment_len floats.
// Returns 0 ok; 1 = needs crop (audio longer than segment, crop_start<0).
int mellow_load_segment(const char* path, int target_sr, long segment_len,
                        long crop_start, int do_resample, float* out,
                        long* full_len_out) {
  std::vector<uint8_t> buf;
  int rc = read_file(path, &buf);
  if (rc != 0) return rc;
  WavData w;
  rc = parse_wav(buf.data(), buf.size(), &w);
  if (rc != 0) return rc;

  size_t frames = w.samples.size() / w.channels;
  // de-interleave to channel-major (torchaudio layout: (C, T))
  std::vector<float> chans((size_t)w.channels * frames);
  for (size_t t = 0; t < frames; ++t)
    for (int c = 0; c < w.channels; ++c)
      chans[(size_t)c * frames + t] = w.samples[t * w.channels + c];

  // Resample each channel independently, THEN flatten (concat channels) —
  // matching the reference order (wrapper.py:146-149: T.Resample over (C,T),
  // then reshape(-1)). Resampling the concatenation would smear the sinc
  // filter across the channel seam and change the output length.
  std::vector<float> res;
  const float* sig = chans.data();
  size_t n = chans.size();
  if (do_resample && w.sample_rate != target_sr) {
    std::vector<float> one;
    for (int c = 0; c < w.channels; ++c) {
      resample_mono(chans.data() + (size_t)c * frames, frames, w.sample_rate,
                    target_sr, 6, 0.99, &one);
      res.insert(res.end(), one.begin(), one.end());
    }
    sig = res.data();
    n = res.size();
  }
  *full_len_out = (long)n;

  if ((long)n <= segment_len) {  // tile-repeat then truncate
    for (long i = 0; i < segment_len; ++i) out[i] = sig[i % n];
    return 0;
  }
  if (crop_start < 0) return 1;  // caller draws the random start
  if (crop_start + segment_len > (long)n) return -20;
  memcpy(out, sig + crop_start, segment_len * sizeof(float));
  return 0;
}

}  // extern "C"
