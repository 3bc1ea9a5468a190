// Native WAV decoder + threaded batch loader: this package's own copy of
// espnet_slurp_tpu/native/wavio.cpp.
//
// Parity target: the reference's data path rides torch DataLoader's C++
// worker pool and soundfile/libsndfile native decoding; this is the
// equivalent native IO layer of the input pipeline
// (espnet2/train/dataset.py sound loader + DataLoader num_workers).
//
// Exposed via ctypes (no pybind11 in the image). PCM16/PCM32/float32 RIFF
// parsing; multichannel files return channel 0 (matching data/fileio.py
// load_wav semantics). wavio_read_batch decodes B files on a std::thread
// pool straight into one caller-owned zero-padded [B, pad_to] float32
// buffer — no per-file Python round trip, no intermediate copies.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Wav {
  std::vector<float> samples;  // channel 0
  int sample_rate = 0;
};

bool read_wav(const char* path, Wav* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  char riff[4], wave[4];
  uint32_t riff_size;
  if (std::fread(riff, 1, 4, f) != 4 || std::memcmp(riff, "RIFF", 4) ||
      std::fread(&riff_size, 4, 1, f) != 1 ||
      std::fread(wave, 1, 4, f) != 4 || std::memcmp(wave, "WAVE", 4)) {
    std::fclose(f);
    return false;
  }
  uint16_t audio_format = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  bool ok = false;
  // chunk walk: fmt then data (chunks are word-aligned)
  for (;;) {
    char id[4];
    uint32_t size;
    if (std::fread(id, 1, 4, f) != 4 || std::fread(&size, 4, 1, f) != 1)
      break;
    if (!std::memcmp(id, "fmt ", 4)) {
      uint8_t buf[16];
      if (size < 16 || std::fread(buf, 1, 16, f) != 16) break;
      std::memcpy(&audio_format, buf + 0, 2);
      std::memcpy(&channels, buf + 2, 2);
      std::memcpy(&sample_rate, buf + 4, 4);
      std::memcpy(&bits, buf + 14, 2);
      if (size > 16) std::fseek(f, (size - 16 + (size & 1)), SEEK_CUR);
    } else if (!std::memcmp(id, "data", 4)) {
      if (!channels || !sample_rate) break;
      const uint32_t bytes_per = bits / 8;
      if (bytes_per == 0) break;
      const uint64_t frames = size / (bytes_per * channels);
      std::vector<uint8_t> raw(size);
      if (std::fread(raw.data(), 1, size, f) != size) break;
      out->samples.resize(frames);
      out->sample_rate = (int)sample_rate;
      const uint8_t* p = raw.data();
      if (audio_format == 1 && bits == 16) {
        for (uint64_t i = 0; i < frames; ++i) {
          int16_t v;
          std::memcpy(&v, p + (i * channels) * 2, 2);
          out->samples[i] = (float)v / 32768.0f;
        }
      } else if (audio_format == 1 && bits == 32) {
        for (uint64_t i = 0; i < frames; ++i) {
          int32_t v;
          std::memcpy(&v, p + (i * channels) * 4, 4);
          out->samples[i] = (float)((double)v / 2147483648.0);
        }
      } else if (audio_format == 3 && bits == 32) {
        for (uint64_t i = 0; i < frames; ++i) {
          float v;
          std::memcpy(&v, p + (i * channels) * 4, 4);
          out->samples[i] = v;
        }
      } else {
        break;  // unsupported codec -> python fallback
      }
      ok = true;
      break;
    } else {
      std::fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  std::fclose(f);
  return ok;
}

}  // namespace

extern "C" {

// Decode one file. Returns sample count (>=0) and sets *out (free with
// wavio_free) + *sr, or -1 on failure.
long wavio_read(const char* path, float** out, int* sr) {
  Wav w;
  if (!read_wav(path, &w)) return -1;
  float* buf = (float*)std::malloc(w.samples.size() * sizeof(float));
  if (!buf && !w.samples.empty()) return -1;
  std::memcpy(buf, w.samples.data(), w.samples.size() * sizeof(float));
  *out = buf;
  *sr = w.sample_rate;
  return (long)w.samples.size();
}

void wavio_free(float* p) { std::free(p); }

// Sample count from the header only (no sample decode).
long wavio_num_samples(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char riff[4], wave[4];
  uint32_t riff_size;
  if (std::fread(riff, 1, 4, f) != 4 || std::memcmp(riff, "RIFF", 4) ||
      std::fread(&riff_size, 4, 1, f) != 1 ||
      std::fread(wave, 1, 4, f) != 4 || std::memcmp(wave, "WAVE", 4)) {
    std::fclose(f);
    return -1;
  }
  uint16_t channels = 0, bits = 0;
  long frames = -1;
  for (;;) {
    char id[4];
    uint32_t size;
    if (std::fread(id, 1, 4, f) != 4 || std::fread(&size, 4, 1, f) != 1)
      break;
    if (!std::memcmp(id, "fmt ", 4)) {
      uint8_t buf[16];
      if (size < 16 || std::fread(buf, 1, 16, f) != 16) break;
      std::memcpy(&channels, buf + 2, 2);
      std::memcpy(&bits, buf + 14, 2);
      if (size > 16) std::fseek(f, (size - 16 + (size & 1)), SEEK_CUR);
    } else if (!std::memcmp(id, "data", 4)) {
      if (channels && bits)
        frames = (long)(size / ((bits / 8) * channels));
      break;
    } else {
      std::fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  std::fclose(f);
  return frames;
}

// Threaded batch decode into caller-owned buf [b, pad_to] (zero-padded).
// lengths[i] receives each file's sample count (clipped to pad_to).
// Returns 0, or -1 if any file failed.
int wavio_read_batch(const char** paths, int b, float* buf, long pad_to,
                     int* lengths, int n_threads) {
  std::atomic<int> next(0), failed(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= b) return;
      Wav w;
      if (!read_wav(paths[i], &w)) {
        failed.store(1);
        lengths[i] = 0;
        continue;
      }
      long n = (long)w.samples.size();
      if (n > pad_to) n = pad_to;
      std::memcpy(buf + (long)i * pad_to, w.samples.data(),
                  n * sizeof(float));
      lengths[i] = (int)n;
    }
  };
  if (n_threads < 1) n_threads = 1;
  if (n_threads > b) n_threads = b;
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return failed.load() ? -1 : 0;
}

}  // extern "C"
