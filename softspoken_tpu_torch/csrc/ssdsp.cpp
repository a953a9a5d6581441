// ssdsp.cpp — native host-DSP kernels for softspoken_tpu.
//
// The reference leaned on librosa/soxr/soundfile C backends for its host
// audio path (voice_activity.py:32-69); this is our own native equivalent:
// a multithreaded rational polyphase resampler with semantics identical to
// scipy.signal.resample_poly(x, up, down, window=taps) — same taps, same
// group-delay alignment, same ceil(n·up/down) output length — so the Python
// and native paths are interchangeable (tests assert near-equality).
//
// Built at first use via g++ (see softspoken_tpu/io/native.py); exposed
// through ctypes — no pybind11 dependency.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// y[m] = sum_i h[i] * x_up[m*down + half - i],  x_up = zero-stuffed x (xup[k*up]=x[k])
// h = taps * up (scaling applied here), half = (n_taps-1)/2.
// Output length n_out must be ceil(n*up/down).
void ss_resample_f32(const float* x, int64_t n, float* y, int64_t n_out,
                     const double* taps, int64_t n_taps,
                     int64_t up, int64_t down, int32_t n_threads) {
    const int64_t half = (n_taps - 1) / 2;
    if (n_threads < 1) n_threads = 1;

    auto worker = [&](int64_t m0, int64_t m1) {
        for (int64_t m = m0; m < m1; ++m) {
            const int64_t c = m * down + half;     // upsampled-domain position
            const int64_t r = c % up;              // tap phase
            const int64_t k0 = (c - r) / up;       // first (highest) x index
            // j bounds: 0 <= r + j*up < n_taps  and  0 <= k0 - j < n
            int64_t j_lo = k0 - (n - 1);           // k <= n-1
            if (j_lo < 0) j_lo = 0;
            // phases beyond the tap array (possible when up > n_taps)
            // contribute nothing; C++ division truncates toward zero, so
            // a negative numerator would yield 0 instead of -1 and the
            // j=0 iteration would read taps[r] past the end — heap OOB
            // (review r3 batch 10)
            int64_t j_hi_taps = (r <= n_taps - 1) ? (n_taps - 1 - r) / up : -1;
            int64_t j_hi = j_hi_taps < k0 ? j_hi_taps : k0;  // k >= 0
            double acc = 0.0;
            const double* tp = taps + r;
            for (int64_t j = j_lo; j <= j_hi; ++j) {
                acc += tp[j * up] * (double)x[k0 - j];
            }
            y[m] = (float)(acc * (double)up);
        }
    };

    if (n_threads == 1 || n_out < 4096) {
        worker(0, n_out);
        return;
    }
    std::vector<std::thread> threads;
    const int64_t step = (n_out + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        const int64_t m0 = (int64_t)t * step;
        int64_t m1 = m0 + step;
        if (m0 >= n_out) break;
        if (m1 > n_out) m1 = n_out;
        threads.emplace_back(worker, m0, m1);
    }
    for (auto& th : threads) th.join();
}

// Fused multichannel downmix: interleaved (frames, channels) f32 → mono mean.
void ss_downmix_f32(const float* x, int64_t frames, int32_t channels, float* y,
                    int32_t n_threads) {
    if (channels == 1) {
        for (int64_t i = 0; i < frames; ++i) y[i] = x[i];
        return;
    }
    const double inv = 1.0 / (double)channels;
    auto worker = [&](int64_t a, int64_t b) {
        for (int64_t i = a; i < b; ++i) {
            double acc = 0.0;
            const float* row = x + i * channels;
            for (int32_t c = 0; c < channels; ++c) acc += row[c];
            y[i] = (float)(acc * inv);
        }
    };
    if (n_threads <= 1 || frames < 65536) { worker(0, frames); return; }
    std::vector<std::thread> threads;
    const int64_t step = (frames + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        int64_t a = (int64_t)t * step, b = a + step;
        if (a >= frames) break;
        if (b > frames) b = frames;
        threads.emplace_back(worker, a, b);
    }
    for (auto& th : threads) th.join();
}

// Interleaved PCM16 → mono float mean in one pass (decode + downmix fused).
void ss_pcm16_to_mono_f32(const int16_t* x, int64_t frames, int32_t channels,
                          float* y, int32_t n_threads) {
    const double scale = 1.0 / (32768.0 * (double)channels);
    auto worker = [&](int64_t a, int64_t b) {
        for (int64_t i = a; i < b; ++i) {
            int64_t acc = 0;
            const int16_t* row = x + i * channels;
            for (int32_t c = 0; c < channels; ++c) acc += row[c];
            y[i] = (float)((double)acc * scale);
        }
    };
    if (n_threads <= 1 || frames < 65536) { worker(0, frames); return; }
    std::vector<std::thread> threads;
    const int64_t step = (frames + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        int64_t a = (int64_t)t * step, b = a + step;
        if (a >= frames) break;
        if (b > frames) b = frames;
        threads.emplace_back(worker, a, b);
    }
    for (auto& th : threads) th.join();
}

// Zero-phase FIR decimation by integer M for the upload wire
// (softspoken_tpu/io/decimate.py).  Contract: xbuf[i] = nat[start*M-half+i]
// with half=(T-1)/2 (caller zero-pads outside the file), L=(n_out-1)*M+T,
//     y[j] = clip(rint(sum_k h[k] * xbuf[j*M + k])).
// Strategy: deinterleave the input into M contiguous float phases once,
// then tap k = q*M+p contributes h[k]*phase_p[j+q] — every inner loop is a
// contiguous saxpy over j that g++ -O3 -march=native turns into FMA vector
// code (the generic ss_resample_f32 above is scalar per-output and ~20x
// slower per tap; this kernel sits on the fused pipeline's 1-core host
// critical path).  Per-output summation order is FIXED (p outer, q inner,
// j independent), so a given absolute output sample is bit-identical no
// matter how requests are windowed or tiled — the purity the fused
// engine's overlapping chunk reads rely on.
void ss_fir_decim_i16(const int16_t* x, int64_t L, int16_t* y, int64_t n_out,
                      const float* h, int32_t T, int32_t M,
                      int32_t n_threads) {
    if (n_out <= 0) return;
    const int64_t phn = (L + M - 1) / M + 1;
    // thread_local scratch: the fused pipeline calls this per chunk from one
    // fill thread, and a fresh ~20 MB vector per call costs ~3-5 ms of page
    // faults on the 1-core host.  No zero-fill needed: every element the
    // conv loop reads (index <= n_out-1 + nq-1 per phase) is written by the
    // deinterleave below (it writes n_out + nq - 1 elements per phase).
    static thread_local std::vector<float> ph;
    ph.resize((size_t)M * phn);
    for (int32_t p = 0; p < M; ++p) {
        float* d = ph.data() + (size_t)p * phn;
        for (int64_t i = 0, k = p; k < L; ++i, k += M) d[i] = (float)x[k];
    }
    const int64_t TILE = 4096;
    auto worker = [&](int64_t w0, int64_t w1) {
        std::vector<float> acc(TILE);
        for (int64_t j0 = w0; j0 < w1; j0 += TILE) {
            const int64_t jn = (w1 - j0 < TILE) ? (w1 - j0) : TILE;
            for (int64_t j = 0; j < jn; ++j) acc[j] = 0.0f;
            for (int32_t p = 0; p < M; ++p) {
                const int32_t nq_full = (T - 1 - p) / M + 1;  // taps in phase p
                // trim to the nonzero tap range: decim_taps snaps the sinc
                // nulls to exact 0.0, and for the (common) M=2 half-band
                // cutoff at sr/4 one whole phase collapses to the single
                // center tap — skipping exact-zero taps is a bit-exact
                // no-op (acc += 0.0f*finite leaves acc unchanged), so this
                // halves the FIR work without changing any output bit
                int32_t qlo = 0, nq = nq_full;
                while (qlo < nq_full && h[(int64_t)qlo * M + p] == 0.0f) ++qlo;
                while (nq > qlo && h[(int64_t)(nq - 1) * M + p] == 0.0f) --nq;
                if (qlo >= nq) continue;  // all-zero phase
                const float* base = ph.data() + (size_t)p * phn + j0;
                int32_t q = qlo;
                // 8 taps per j-pass: the plain 1-tap loop is L1-bound on
                // the acc[j] load+store (measured ~3,000 audio-s/s for the
                // 147-tap 32 kHz filter); amortizing it 8x approaches the
                // FMA-port bound instead
                for (; q + 8 <= nq; q += 8) {
                    const float h0 = h[(q + 0) * (int64_t)M + p];
                    const float h1 = h[(q + 1) * (int64_t)M + p];
                    const float h2 = h[(q + 2) * (int64_t)M + p];
                    const float h3 = h[(q + 3) * (int64_t)M + p];
                    const float h4 = h[(q + 4) * (int64_t)M + p];
                    const float h5 = h[(q + 5) * (int64_t)M + p];
                    const float h6 = h[(q + 6) * (int64_t)M + p];
                    const float h7 = h[(q + 7) * (int64_t)M + p];
                    const float* xp = base + q;
                    for (int64_t j = 0; j < jn; ++j) {
                        acc[j] += h0 * xp[j] + h1 * xp[j + 1]
                                + h2 * xp[j + 2] + h3 * xp[j + 3]
                                + h4 * xp[j + 4] + h5 * xp[j + 5]
                                + h6 * xp[j + 6] + h7 * xp[j + 7];
                    }
                }
                for (; q < nq; ++q) {
                    const float hk = h[q * (int64_t)M + p];
                    const float* xp = base + q;
                    for (int64_t j = 0; j < jn; ++j) acc[j] += hk * xp[j];
                }
            }
            for (int64_t j = 0; j < jn; ++j) {
                float v = nearbyintf(acc[j]);
                if (v > 32767.0f) v = 32767.0f;
                if (v < -32768.0f) v = -32768.0f;
                y[j0 + j] = (int16_t)v;
            }
        }
    };
    if (n_threads <= 1 || n_out < 65536) { worker(0, n_out); return; }
    std::vector<std::thread> threads;
    const int64_t step = (n_out + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        int64_t a = (int64_t)t * step, b = a + step;
        if (a >= n_out) break;
        if (b > n_out) b = n_out;
        threads.emplace_back(worker, a, b);
    }
    for (auto& th : threads) th.join();
}

// 8-bit mu-law transport encode: one table gather per sample (the 64 Ki
// int8 LUT is built in Python — ops/mulaw.encode_lut — so companding math
// lives in exactly one place).  The numpy fancy-index equivalent costs
// ~35 ms per 4.8M-sample chunk on this 1-core host and sits on the fused
// pipeline's critical path (engine/fused.py prepare); this loop is ~5x
// faster (memory-bound on the sequential int16 read).
void ss_mulaw_encode_i16(const int16_t* x, int64_t n, const int8_t* lut,
                         int8_t* q, int32_t n_threads) {
    auto worker = [&](int64_t a, int64_t b) {
        for (int64_t i = a; i < b; ++i) {
            q[i] = lut[(uint16_t)x[i]];
        }
    };
    if (n_threads <= 1 || n < 262144) { worker(0, n); return; }
    std::vector<std::thread> threads;
    const int64_t step = (n + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        int64_t a = (int64_t)t * step, b = a + step;
        if (a >= n) break;
        if (b > n) b = n;
        threads.emplace_back(worker, a, b);
    }
    for (auto& th : threads) th.join();
}

// 4-bit IMA-ADPCM transport encode for the fused upload wire
// (softspoken_tpu/ops/adpcm.py — see its docstring for the wire format).
// Blocks are independent (per-block header carries predictor seed + initial
// step index), so blocks could thread, but the 1-core host runs this at
// ~300 M samples/s scalar anyway: the loop is ~15 int ops per sample, no
// memory traffic beyond the sequential int16 read and nibble write.
// Semantics are kept bit-identical to the numpy path in ops/adpcm.py
// (tests assert byte equality): same quantizer, same decoder-mirrored
// reconstruction, same per-block mean-|delta| initial index.
static const int32_t SS_IMA_INDEX[16] = {-1, -1, -1, -1, 2, 4, 6, 8,
                                         -1, -1, -1, -1, 2, 4, 6, 8};
static const int32_t SS_IMA_STEPS[89] = {
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};

// x: n int16 samples (conceptually zero-padded to a whole block);
// out: n_blocks * (4 + spb/2) bytes.  spb must be even and >= 2.
// one sample of the branchless quantize + reconstruct (shared by the
// scalar and the interleaved group paths so semantics cannot diverge):
// data-dependent branches on audio mispredict constantly (measured 84 ms
// -> 58 ms per 4.8M samples going branchless); every conditional is a
// mask or cmov.
static inline uint8_t ss_ima_step1(int32_t v, int32_t& pred, int32_t& idx) {
    const int32_t step = SS_IMA_STEPS[idx];
    const int32_t delta = v - pred;
    const int32_t sm = delta >> 31;           // -1 if negative
    int32_t mag = (delta ^ sm) - sm;          // |delta|
    int32_t nib = sm & 8;
    int32_t temp = step;
    int32_t ge = -(int32_t)(mag >= temp);
    nib |= ge & 4; mag -= temp & ge;
    temp >>= 1;
    ge = -(int32_t)(mag >= temp);
    nib |= ge & 2; mag -= temp & ge;
    temp >>= 1;
    nib |= (int32_t)(mag >= temp);
    // reconstruct exactly like the decoder
    int32_t diff = (step >> 3)
        + ((step >> 2) & -(nib & 1))
        + ((step >> 1) & -((nib >> 1) & 1))
        + (step & -((nib >> 2) & 1));
    const int32_t ds = -((nib >> 3) & 1);     // -1 to subtract
    pred += (diff ^ ds) - ds;
    if (pred > 32767) pred = 32767;           // g++ emits cmovs
    if (pred < -32768) pred = -32768;
    idx += SS_IMA_INDEX[nib];
    if (idx < 0) idx = 0;
    if (idx > 88) idx = 88;
    return (uint8_t)nib;
}

// header for one block whose samples are in buf[spb]: writes pred/idx seed,
// returns the initial index (first step >= mean |delta|, matching
// np.searchsorted(STEP_TABLE, mean, side='left') on a float mean).
static inline int32_t ss_ima_header(const int32_t* buf, int32_t spb,
                                    uint8_t* blk) {
    int64_t sum_d = 0;
    for (int64_t k = 1; k < spb; ++k) {
        int32_t d = buf[k] - buf[k - 1];
        sum_d += (d ^ (d >> 31)) - (d >> 31);
    }
    const double mean_d = (double)sum_d / (double)(spb - 1);
    int32_t lo = 0, hi = 89;
    while (lo < hi) {
        int32_t mid = (lo + hi) / 2;
        if ((double)SS_IMA_STEPS[mid] >= mean_d) hi = mid;
        else lo = mid + 1;
    }
    const int32_t idx = lo > 88 ? 88 : lo;
    blk[0] = (uint8_t)(buf[0] & 0xFF);
    blk[1] = (uint8_t)((buf[0] >> 8) & 0xFF);
    blk[2] = (uint8_t)idx;
    blk[3] = 0;
    return idx;
}

void ss_ima_encode_i16(const int16_t* x, int64_t n, int32_t spb,
                       uint8_t* out) {
    const int64_t nb = (n + spb - 1) / spb;
    const int64_t block_bytes = 4 + spb / 2;
    // Blocks are fully independent, and one block's quantizer is a serial
    // pred->nib->pred dependency chain (~36 cycles/sample on its own).
    // Interleaving G blocks in the inner loop runs G chains in parallel in
    // registers, hiding the chain latency behind ILP (measured 58 ms ->
    // ~17 ms per 4.8M noise samples on the 1-core host).  Scratch is a
    // dense int32 copy: the lambda-with-EOF-branch version was 4x slower.
    constexpr int G = 8;
    static thread_local std::vector<int32_t> buf;
    buf.resize((size_t)G * spb);
    int64_t b = 0;
    for (; b + G <= nb && (b + G) * spb <= n; b += G) {
        int32_t pred[G], idx[G];
        uint8_t* data[G];
        for (int g = 0; g < G; ++g) {
            const int16_t* src = x + (b + g) * spb;
            int32_t* bg = buf.data() + (size_t)g * spb;
            for (int32_t k = 0; k < spb; ++k) bg[k] = (int32_t)src[k];
            uint8_t* blk = out + (b + g) * block_bytes;
            idx[g] = ss_ima_header(bg, spb, blk);
            pred[g] = bg[0];
            data[g] = blk + 4;
            for (int64_t i = 0; i < spb / 2; ++i) data[g][i] = 0;
        }
        for (int32_t k = 0; k < spb - 1; ++k) {
            const int32_t sh = (k & 1) << 2;
            const int64_t byte = k >> 1;
            for (int g = 0; g < G; ++g) {
                const uint8_t nib = ss_ima_step1(
                    buf[(size_t)g * spb + k + 1], pred[g], idx[g]);
                data[g][byte] |= (uint8_t)(nib << sh);
            }
        }
    }
    for (; b < nb; ++b) {   // tail blocks (incl. the zero-padded last one)
        const int64_t s0 = b * spb;
        const int64_t nvalid = (s0 + spb <= n) ? spb : (n - s0);
        for (int64_t k = 0; k < nvalid; ++k) buf[k] = (int32_t)x[s0 + k];
        for (int64_t k = nvalid; k < spb; ++k) buf[k] = 0;
        uint8_t* blk = out + b * block_bytes;
        int32_t idx = ss_ima_header(buf.data(), spb, blk);
        int32_t pred = buf[0];
        uint8_t* data = blk + 4;
        for (int64_t i = 0; i < spb / 2; ++i) data[i] = 0;
        for (int32_t k = 0; k < spb - 1; ++k) {
            const uint8_t nib = ss_ima_step1(buf[k + 1], pred, idx);
            data[k >> 1] |= (uint8_t)(nib << ((k & 1) << 2));
        }
    }
}

}  // extern "C"
