// Native sample feeder: the tracker runtime's hot path.
//
// Re-implements, as a C library callable from Python via ctypes, the state
// machine of the reference's producer thread (src/producer_thread.cpp):
//   - uint8 IQ -> complex float conversion ((x-127)/128),
//   - the fractional LTE sample clock mod 19200 advanced by
//     (FS_LTE/16)/(fs_programmed*k_factor) per sample,
//   - searcher capture-buffer filling triggered at clock zero crossings,
//   - per-cell 128-sample OFDM symbol window extraction at
//     frame_timing + target_cap_start_time with cyclic-prefix skipping.
//
// The Python SampleFeeder (lte_cell_scanner/tracker/producer.py) is the
// behavioral reference; tests/test_native_feeder.py asserts equivalence.
//
// Build: see native/Makefile (g++ -O2 -shared -fPIC).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kFrame = 19200.0;
constexpr int kSymLen = 128;

struct CellCapture {
  int n_id_cell = -1;
  int64_t abs_start = 0;
  int serial_num = 0;
  int n_symb_dl = 7;  // 7 normal CP, 6 extended
  int slot_num = 0;
  int sym_num = 0;
  double target_cap_start_time = 0.0;
  bool filling = false;
  int buffer_offset = 0;
  double late = 0.0;
  double frequency_offset = 0.0;
  double frame_timing_at_start = 0.0;
  double frame_timing = 0.0;  // updated from Python before each feed
  float buffer[2 * kSymLen];
};

struct Pdu {
  int n_id_cell;
  int slot_num;
  int sym_num;
  double late;
  double frequency_offset;
  double frame_timing;
  int64_t start;  // absolute stream index (descriptor mode)
  float data[2 * kSymLen];
};

struct Feeder {
  double sample_time = -1.0;
  double step = 1.0;
  bool emit_descriptors = false;  // batch engine: PDUs carry stream
                                  // indices instead of sample copies
  int64_t abs_sample = 0;

  // Searcher capture
  bool searcher_request = false;
  bool searcher_filling = false;
  double searcher_late = 0.0;
  size_t searcher_idx = 0;
  std::vector<float> searcher_capbuf;  // interleaved re,im
  bool searcher_ready = false;

  std::vector<CellCapture> cells;
  std::vector<Pdu> pdus;
};

inline double wrap_half_frame(double x) {
  double r = std::fmod(x + kFrame / 2, kFrame);
  if (r < 0) r += kFrame;
  return r - kFrame / 2;
}

}  // namespace

extern "C" {

Feeder* feeder_create(long searcher_capbuf_len) {
  Feeder* f = new Feeder();
  f->searcher_capbuf.resize(2 * searcher_capbuf_len);
  return f;
}

void feeder_destroy(Feeder* f) { delete f; }

void feeder_set_step(Feeder* f, double step) { f->step = step; }

void feeder_set_descriptor_mode(Feeder* f, int on) {
  f->emit_descriptors = on != 0;
}

double feeder_sample_time(const Feeder* f) { return f->sample_time; }

void feeder_request_searcher(Feeder* f) { f->searcher_request = true; }

int feeder_searcher_ready(const Feeder* f) { return f->searcher_ready ? 1 : 0; }

double feeder_searcher_late(const Feeder* f) { return f->searcher_late; }

// Copies the completed searcher capture out (interleaved float32 re,im)
// and clears the ready flag. Returns the number of complex samples.
long feeder_take_searcher(Feeder* f, float* out) {
  if (!f->searcher_ready) return 0;
  std::memcpy(out, f->searcher_capbuf.data(),
              f->searcher_capbuf.size() * sizeof(float));
  f->searcher_ready = false;
  return static_cast<long>(f->searcher_capbuf.size() / 2);
}

// Register (or refresh) a tracked cell. Passing serial_num different from
// the stored one resets the capture state machine.
void feeder_set_cell(Feeder* f, int n_id_cell, int serial_num, int n_symb_dl,
                     double frame_timing) {
  for (auto& c : f->cells) {
    if (c.n_id_cell == n_id_cell) {
      c.frame_timing = frame_timing;
      if (c.serial_num != serial_num) {
        c.serial_num = serial_num;
        c.n_symb_dl = n_symb_dl;
        c.slot_num = 0;
        c.sym_num = 0;
        c.target_cap_start_time = (n_symb_dl == 7) ? 10.0 : 32.0;
        c.filling = false;
        c.buffer_offset = 0;
      }
      return;
    }
  }
  CellCapture c;
  c.n_id_cell = n_id_cell;
  c.serial_num = serial_num;
  c.n_symb_dl = n_symb_dl;
  c.target_cap_start_time = (n_symb_dl == 7) ? 10.0 : 32.0;
  c.frame_timing = frame_timing;
  f->cells.push_back(c);
}

void feeder_remove_cell(Feeder* f, int n_id_cell) {
  for (size_t i = 0; i < f->cells.size(); ++i) {
    if (f->cells[i].n_id_cell == n_id_cell) {
      f->cells.erase(f->cells.begin() + i);
      return;
    }
  }
}

// Feed one block of raw uint8 IQ bytes (2*n_samples bytes). frequency_offset
// is the current global FO (recorded into emitted PDUs). Completed symbol
// windows accumulate in an internal PDU list fetched afterwards with
// feeder_pdu_count / feeder_get_pdus.
void feeder_feed(Feeder* f, const uint8_t* bytes, long n_samples,
                 double frequency_offset) {
  f->pdus.clear();
  const double step = f->step;

  for (long t = 0; t < n_samples; ++t) {
    const float re = (static_cast<float>(bytes[2 * t]) - 127.0f) / 128.0f;
    const float im = (static_cast<float>(bytes[2 * t + 1]) - 127.0f) / 128.0f;
    f->sample_time += step;
    if (f->sample_time > kFrame) f->sample_time -= kFrame;

    // Searcher capture
    if (f->searcher_request && !f->searcher_filling) {
      const double d = wrap_half_frame(f->sample_time);
      if (std::fabs(d) < 0.5) {
        f->searcher_request = false;
        f->searcher_filling = true;
        f->searcher_idx = 0;
        f->searcher_late = d;
      }
    }
    if (f->searcher_filling) {
      f->searcher_capbuf[2 * f->searcher_idx] = re;
      f->searcher_capbuf[2 * f->searcher_idx + 1] = im;
      if (++f->searcher_idx == f->searcher_capbuf.size() / 2) {
        f->searcher_filling = false;
        f->searcher_ready = true;
      }
    }

    // Per-cell symbol windows
    for (auto& c : f->cells) {
      if (!c.filling) {
        const double d =
            wrap_half_frame(f->sample_time -
                            (c.frame_timing + c.target_cap_start_time));
        if (std::fabs(d) < 0.5 || (d > 0 && d < 3)) {
          c.filling = true;
          c.late = d;
          c.buffer_offset = 0;
          c.frequency_offset = frequency_offset;
          c.frame_timing_at_start = c.frame_timing;
          c.abs_start = f->abs_sample + t;
        }
      }
      if (c.filling) {
        if (!f->emit_descriptors) {
          c.buffer[2 * c.buffer_offset] = re;
          c.buffer[2 * c.buffer_offset + 1] = im;
        }
        if (++c.buffer_offset == kSymLen) {
          Pdu p;
          p.n_id_cell = c.n_id_cell;
          p.slot_num = c.slot_num;
          p.sym_num = c.sym_num;
          p.late = c.late;
          p.frequency_offset = c.frequency_offset;
          p.frame_timing = c.frame_timing_at_start;
          p.start = c.abs_start;
          if (!f->emit_descriptors)
            std::memcpy(p.data, c.buffer, sizeof(p.data));
          f->pdus.push_back(p);

          c.filling = false;
          if (c.n_symb_dl == 6) {
            c.target_cap_start_time += 32 + 128;
          } else {
            c.target_cap_start_time += (c.sym_num == 6) ? 128 + 10 : 128 + 9;
          }
          c.target_cap_start_time = std::fmod(c.target_cap_start_time, kFrame);
          c.sym_num = (c.sym_num + 1) % c.n_symb_dl;
          if (c.sym_num == 0) c.slot_num = (c.slot_num + 1) % 20;
        }
      }
    }
  }
  f->abs_sample += n_samples;
}

long feeder_pdu_count(const Feeder* f) {
  return static_cast<long>(f->pdus.size());
}

// Fetch PDU metadata and payloads.
//   meta: n_pdus rows of [n_id_cell, slot, sym] (int32)
//   vals: n_pdus rows of [late, frequency_offset, frame_timing] (float64)
//   data: n_pdus * 256 float32 (interleaved re,im)
void feeder_get_pdus(const Feeder* f, int32_t* meta, double* vals,
                     float* data) {
  for (size_t i = 0; i < f->pdus.size(); ++i) {
    const Pdu& p = f->pdus[i];
    meta[3 * i] = p.n_id_cell;
    meta[3 * i + 1] = p.slot_num;
    meta[3 * i + 2] = p.sym_num;
    vals[3 * i] = p.late;
    vals[3 * i + 1] = p.frequency_offset;
    vals[3 * i + 2] = p.frame_timing;
    std::memcpy(data + i * 2 * kSymLen, p.data, sizeof(p.data));
  }
}

// Descriptor mode: fetch the absolute stream index of each PDU's window.
void feeder_get_pdu_starts(const Feeder* f, int64_t* starts) {
  for (size_t i = 0; i < f->pdus.size(); ++i) starts[i] = f->pdus[i].start;
}

}  // extern "C"
