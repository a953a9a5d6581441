// Native FLAC decoder for softspoken_tpu (csrc/ssflac.cpp).
//
// The reference incidentally reads FLAC through soundfile
// (voice_activity.py:37 — libsndfile); this framework vendors no audio
// libraries, so FLAC support is implemented directly. Scope: everything a
// field-recorder corpus needs — 8/16/24/32-bit, any channel count, all
// subframe types (constant / verbatim / fixed 0-4 / LPC), rice and rice2
// residual partitions, left/right/mid-side stereo decorrelation, UTF-8
// frame numbers, variable and fixed blocking, SEEKTABLE-assisted seeking.
// CRC fields are parsed but not verified (decode speed on the 1-core host
// matters more than tamper detection for this pipeline).
//
// Built at first use via g++ (softspoken_tpu/io/flac.py, same mechanism as
// ssdsp.cpp); exposed through ctypes with a handle-based streaming API.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// buffered bit reader (big-endian bit order, refills from FILE*)
// ---------------------------------------------------------------------------
struct BitReader {
    FILE* f = nullptr;
    std::vector<uint8_t> buf;
    size_t pos = 0;       // byte index into buf
    size_t filled = 0;    // valid bytes in buf
    uint64_t acc = 0;     // bit accumulator (top-aligned semantics via count)
    int bits = 0;         // valid low bits in acc
    bool eof = false;
    long long base_off = 0;  // file offset of buf[0]
    // byte tape: when enabled, every byte fetched into acc is recorded so
    // decode_frame can verify the frame CRC-16 (review r3 batch 14 — the
    // unverified CRC let random corruption decode as garbage audio)
    bool taping = false;
    std::vector<uint8_t> tape;

    explicit BitReader(FILE* fp) : f(fp), buf(1 << 20) {}

    long long byte_offset() const {
        return base_off + (long long)pos - bits / 8;
    }

    bool refill_byte() {
        if (pos >= filled) {
            base_off += (long long)filled;
            filled = fread(buf.data(), 1, buf.size(), f);
            pos = 0;
            if (filled == 0) { eof = true; return false; }
        }
        uint8_t byte = buf[pos++];
        // 16 MB cap: larger than any legal frame; an adversarial stream
        // must not balloon the tape (overflow skips CRC verification)
        if (taping && tape.size() < (1u << 24)) tape.push_back(byte);
        acc = (acc << 8) | byte;
        bits += 8;
        return true;
    }

    // read n (<= 57) bits unsigned
    uint64_t read(int n) {
        while (bits < n) {
            if (!refill_byte()) return 0;
        }
        uint64_t v = (acc >> (bits - n)) & ((n == 64) ? ~0ull : ((1ull << n) - 1));
        bits -= n;
        return v;
    }

    int64_t read_signed(int n) {
        uint64_t v = read(n);
        if (n > 0 && (v >> (n - 1)) & 1) return (int64_t)(v | (~0ull << n));
        return (int64_t)v;
    }

    // unary: count zero bits before the first 1
    uint32_t read_unary() {
        uint32_t q = 0;
        for (;;) {
            if (bits == 0 && !refill_byte()) return q;
            // scan the valid bits
            while (bits > 0) {
                uint64_t bit = (acc >> (bits - 1)) & 1;
                bits--;
                if (bit) return q;
                q++;
            }
        }
    }

    void align_byte() { bits -= bits % 8; }

    // absolute byte seek (drops accumulator)
    bool seek_to(long long off) {
        if (fseek(f, off, SEEK_SET) != 0) return false;
        filled = 0; pos = 0; acc = 0; bits = 0; eof = false;
        taping = false; tape.clear();
        base_off = off;
        return true;
    }

    // start taping at a frame boundary: seed with the two sync bytes plus
    // any bytes already fetched into acc but not yet consumed (they belong
    // to the frame and will not pass through refill_byte again)
    void start_frame_tape(uint8_t sync2) {
        tape.clear();
        tape.push_back(0xFF);
        tape.push_back(sync2);
        for (int k = bits / 8 - 1; k >= 0; k--)
            tape.push_back((uint8_t)((acc >> (k * 8)) & 0xFF));
        taping = true;
    }
};

static uint16_t crc16_flac(const uint8_t* p, size_t n) {
    uint16_t crc = 0;
    for (size_t i = 0; i < n; i++) {
        crc ^= (uint16_t)(p[i]) << 8;
        for (int b = 0; b < 8; b++)
            crc = (crc & 0x8000) ? (uint16_t)((crc << 1) ^ 0x8005)
                                 : (uint16_t)(crc << 1);
    }
    return crc;
}

struct SeekPoint { uint64_t sample, offset; uint16_t nframes; };

struct Decoder {
    FILE* f = nullptr;
    BitReader* br = nullptr;
    std::string err;        // active error (cleared once reported to the caller)
    std::string last_err;   // message of the most recently reported error

    // STREAMINFO
    uint32_t sr = 0, channels = 0, bps = 0;
    uint64_t total = 0;
    long long first_frame_off = 0;
    std::vector<SeekPoint> seektable;

    // decode state
    uint64_t next_sample = 0;        // stream position of the next sample out
    std::vector<int64_t> chan[8];    // per-channel block buffer
    uint32_t block_n = 0;            // samples in the current decoded block
    uint32_t block_used = 0;         // samples already consumed from it
    // fixed-blocking streams number frames in units of the nominal (first)
    // blocksize; sample offset = frame_number * nominal_bs
    uint32_t nominal_bs = 0;
};

const int FIXED_ORDER_MAX = 4;

uint64_t read_utf8(BitReader& b, bool* ok) {
    uint64_t x = b.read(8);
    *ok = true;
    if (x < 0x80) return x;
    int n = 0;
    uint64_t v = 0;
    if ((x & 0xE0) == 0xC0) { n = 1; v = x & 0x1F; }
    else if ((x & 0xF0) == 0xE0) { n = 2; v = x & 0x0F; }
    else if ((x & 0xF8) == 0xF0) { n = 3; v = x & 0x07; }
    else if ((x & 0xFC) == 0xF8) { n = 4; v = x & 0x03; }
    else if ((x & 0xFE) == 0xFC) { n = 5; v = x & 0x01; }
    else if (x == 0xFE) { n = 6; v = 0; }
    else { *ok = false; return 0; }
    for (int i = 0; i < n; i++) {
        uint64_t c = b.read(8);
        if ((c & 0xC0) != 0x80) { *ok = false; return 0; }
        v = (v << 6) | (c & 0x3F);
    }
    return v;
}

bool decode_residual(BitReader& b, uint32_t blocksize, uint32_t order,
                     int64_t* out /* blocksize, first `order` skipped */) {
    uint32_t method = (uint32_t)b.read(2);
    if (method > 1) return false;
    int pbits = method == 0 ? 4 : 5;
    uint32_t escape = method == 0 ? 0xF : 0x1F;
    uint32_t porder = (uint32_t)b.read(4);
    uint32_t parts = 1u << porder;
    // misaligned partitioning is invalid per the spec: reject up front
    // instead of decoding garbage partitions and failing only on the final
    // sample count (review r3 — the old condition was a near-no-op)
    if (parts > blocksize || blocksize % parts) return false;
    uint32_t idx = order;
    for (uint32_t p = 0; p < parts; p++) {
        uint32_t n = blocksize >> porder;
        if (p == 0) {
            if (n < order) return false;
            n -= order;
        }
        uint32_t param = (uint32_t)b.read(pbits);
        if (param == escape) {
            uint32_t raw = (uint32_t)b.read(5);
            for (uint32_t i = 0; i < n; i++) out[idx++] = b.read_signed((int)raw);
        } else {
            for (uint32_t i = 0; i < n; i++) {
                uint32_t q = b.read_unary();
                uint64_t r = param ? b.read((int)param) : 0;
                uint64_t u = ((uint64_t)q << param) | r;
                out[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);  // zigzag
            }
        }
    }
    return idx == blocksize;
}

bool decode_subframe(BitReader& b, uint32_t blocksize, uint32_t bps,
                     std::vector<int64_t>& out) {
    out.resize(blocksize);
    if (b.read(1) != 0) return false;               // reserved
    uint32_t type = (uint32_t)b.read(6);
    uint32_t wasted = 0;
    if (b.read(1)) {                                 // wasted bits flag
        wasted = 1 + b.read_unary();
        // wasted >= bps would wrap the unsigned bps to ~4e9 and feed
        // negative/oversized shift amounts into the bit reader (UB) —
        // reject like libFLAC does (review r3 fuzz finding)
        if (wasted >= bps) return false;
        bps -= wasted;
    }

    if (type == 0) {                                 // CONSTANT
        int64_t v = b.read_signed((int)bps);
        for (uint32_t i = 0; i < blocksize; i++) out[i] = v;
    } else if (type == 1) {                          // VERBATIM
        for (uint32_t i = 0; i < blocksize; i++) out[i] = b.read_signed((int)bps);
    } else if (type >= 8 && type <= 8 + FIXED_ORDER_MAX) {   // FIXED
        uint32_t order = type - 8;
        // warm-up samples must fit in the block: order > blocksize on a
        // crafted frame wrote past the end of `out` (review r3 heap-
        // overflow finding; libFLAC rejects order >= blocksize too)
        if (order > blocksize) return false;
        for (uint32_t i = 0; i < order; i++) out[i] = b.read_signed((int)bps);
        if (!decode_residual(b, blocksize, order, out.data())) return false;
        switch (order) {
            case 0: break;
            case 1:
                for (uint32_t i = 1; i < blocksize; i++) out[i] += out[i - 1];
                break;
            case 2:
                for (uint32_t i = 2; i < blocksize; i++)
                    out[i] += 2 * out[i - 1] - out[i - 2];
                break;
            case 3:
                for (uint32_t i = 3; i < blocksize; i++)
                    out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
                break;
            case 4:
                for (uint32_t i = 4; i < blocksize; i++)
                    out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4];
                break;
        }
    } else if (type >= 32) {                         // LPC, order = type-31
        uint32_t order = type - 31;
        if (order > blocksize) return false;         // see FIXED warm-up note
        for (uint32_t i = 0; i < order; i++) out[i] = b.read_signed((int)bps);
        uint32_t prec = (uint32_t)b.read(4) + 1;
        if (prec == 16) return false;                // 0b1111 invalid
        int shift = (int)b.read_signed(5);
        if (shift < 0) return false;
        int32_t coef[32];
        for (uint32_t i = 0; i < order; i++) coef[i] = (int32_t)b.read_signed((int)prec);
        if (!decode_residual(b, blocksize, order, out.data())) return false;
        for (uint32_t i = order; i < blocksize; i++) {
            int64_t sum = 0;
            for (uint32_t j = 0; j < order; j++) sum += (int64_t)coef[j] * out[i - 1 - j];
            out[i] += sum >> shift;
        }
    } else {
        return false;                                // reserved types
    }
    if (wasted)
        for (uint32_t i = 0; i < blocksize; i++)
            // shift via uint64_t: left-shifting a negative signed value is
            // UB pre-C++20 (review r3 batch 14)
            out[i] = (int64_t)((uint64_t)out[i] << wasted);
    return true;
}

// decode one frame into dec.chan[]; returns frame's first sample number or -1
long long decode_frame(Decoder& d) {
    BitReader& b = *d.br;
    // sync
    b.align_byte();
    uint64_t w = 0;
    bool have_w = false;
    for (;;) {
        b.taping = false;  // only on between sync match and CRC check
        if (b.eof) return -1;
        if (!have_w) w = b.read(8);
        have_w = false;
        if (b.eof) return -1;
        if (w != 0xFF) continue;
        uint64_t x = b.read(8);
        if ((x & 0xFC) == 0xF8) { // 111110xx : second sync byte
            b.start_frame_tape((uint8_t)x);
            // blocking strategy = x & 1
            bool variable = x & 1;
            uint32_t bs_code = (uint32_t)b.read(4);
            uint32_t sr_code = (uint32_t)b.read(4);
            uint32_t ch_code = (uint32_t)b.read(4);
            uint32_t ss_code = (uint32_t)b.read(3);
            b.read(1); // reserved
            bool ok = true;
            uint64_t number = read_utf8(b, &ok);
            if (!ok) continue;
            uint32_t blocksize;
            switch (bs_code) {
                case 0: continue;                       // reserved
                case 1: blocksize = 192; break;
                case 2: case 3: case 4: case 5:
                    blocksize = 576u << (bs_code - 2); break;
                case 6: blocksize = (uint32_t)b.read(8) + 1; break;
                case 7: blocksize = (uint32_t)b.read(16) + 1; break;
                default: blocksize = 256u << (bs_code - 8); break;
            }
            if (sr_code == 12) b.read(8);
            else if (sr_code == 13 || sr_code == 14) b.read(16);
            b.read(8);  // header CRC-8 (unverified)

            uint32_t nch = d.channels;
            uint32_t mode = 0;  // 0 independent, 1 L/S, 2 R/S, 3 M/S
            if (ch_code < 8) { nch = ch_code + 1; }
            else if (ch_code == 8) { nch = 2; mode = 1; }
            else if (ch_code == 9) { nch = 2; mode = 2; }
            else if (ch_code == 10) { nch = 2; mode = 3; }
            else continue;
            if (nch != d.channels) continue;  // mid-stream change unsupported

            uint32_t bps = d.bps;
            switch (ss_code) {   // sample size override codes
                case 0: break;
                case 1: bps = 8; break;
                case 2: bps = 12; break;
                case 4: bps = 16; break;
                case 5: bps = 20; break;
                case 6: bps = 24; break;
                case 7: bps = 32; break;
                default: continue;
            }

            for (uint32_t c = 0; c < nch; c++) {
                uint32_t sub_bps = bps;
                if ((mode == 1 && c == 1) || (mode == 2 && c == 0) ||
                    (mode == 3 && c == 1))
                    sub_bps += 1;  // the side channel carries one extra bit
                if (!decode_subframe(b, blocksize, sub_bps, d.chan[c])) {
                    d.err = "subframe decode failed";
                    return -1;
                }
            }
            b.align_byte();
            // frame CRC-16: covers every byte from the sync up to here.
            // Unconsumed fetched bytes (bits/8) sit at the tape's tail and
            // are NOT part of the checksummed span.
            bool tape_ok = b.tape.size() < (1u << 24);
            size_t covered = b.tape.size() - (size_t)(b.bits / 8);
            uint16_t want = tape_ok ? crc16_flac(b.tape.data(), covered) : 0;
            uint64_t got_crc = b.read(16);
            b.taping = false;
            if (b.eof) {
                // the header parsed but the payload/CRC ran past EOF: the
                // 'decoded' samples are fabricated zeros from exhausted
                // reads, not audio — report EOF instead of emitting up to
                // a block of silence (review r3 batch 14)
                return -1;
            }
            if (tape_ok && (uint16_t)got_crc != want) {
                d.err = "frame CRC-16 mismatch (corrupt frame)";
                return -1;
            }

            // undo stereo decorrelation
            if (mode == 1) {        // left/side: R = L - S
                for (uint32_t i = 0; i < blocksize; i++)
                    d.chan[1][i] = d.chan[0][i] - d.chan[1][i];
            } else if (mode == 2) { // right/side: L = S + R
                for (uint32_t i = 0; i < blocksize; i++)
                    d.chan[0][i] = d.chan[0][i] + d.chan[1][i];
            } else if (mode == 3) { // mid/side
                for (uint32_t i = 0; i < blocksize; i++) {
                    int64_t side = d.chan[1][i];
                    int64_t mid = (int64_t)(((uint64_t)d.chan[0][i] << 1)
                                            | (uint64_t)(side & 1));
                    d.chan[0][i] = (mid + side) >> 1;
                    d.chan[1][i] = (mid - side) >> 1;
                }
            }
            d.block_n = blocksize;
            d.block_used = 0;
            if (variable) return (long long)number;
            if (d.nominal_bs == 0) d.nominal_bs = blocksize;
            return (long long)(number * d.nominal_bs);
        }
        // not a frame start; keep scanning.  If x is itself 0xFF it may
        // be the FIRST byte of a real sync (… FF FF F8 …): carry it as the
        // next candidate instead of discarding both bytes, which skipped a
        // whole valid frame during resync (review r3 batch 14)
        if (x == 0xFF) { w = x; have_w = true; }
    }
}

}  // namespace

extern "C" {

void* ssflac_open(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    char magic[4];
    if (fread(magic, 1, 4, f) != 4 || memcmp(magic, "fLaC", 4) != 0) {
        fclose(f);
        return nullptr;
    }
    Decoder* d = new Decoder();
    d->f = f;
    // metadata blocks
    bool last = false;
    while (!last) {
        uint8_t hdr[4];
        if (fread(hdr, 1, 4, f) != 4) { delete d; fclose(f); return nullptr; }
        last = hdr[0] & 0x80;
        uint32_t type = hdr[0] & 0x7F;
        uint32_t len = ((uint32_t)hdr[1] << 16) | ((uint32_t)hdr[2] << 8) | hdr[3];
        if (type == 0 && len >= 34) {                     // STREAMINFO
            uint8_t si[34];
            if (fread(si, 1, 34, f) != 34) { delete d; fclose(f); return nullptr; }
            if (len > 34) fseek(f, len - 34, SEEK_CUR);
            d->sr = ((uint32_t)si[10] << 12) | ((uint32_t)si[11] << 4) | (si[12] >> 4);
            d->channels = ((si[12] >> 1) & 0x7) + 1;
            d->bps = (((si[12] & 1) << 4) | (si[13] >> 4)) + 1;
            d->total = ((uint64_t)(si[13] & 0x0F) << 32) | ((uint64_t)si[14] << 24) |
                       ((uint64_t)si[15] << 16) | ((uint64_t)si[16] << 8) | si[17];
            // fixed-blocking streams declare min == max blocksize here; use
            // it as the authoritative nominal size.  Latching the first
            // DECODED frame's size instead mis-positions frame numbers when
            // a seek lands on the short final frame first (review r3)
            uint32_t minbs = ((uint32_t)si[0] << 8) | si[1];
            uint32_t maxbs = ((uint32_t)si[2] << 8) | si[3];
            if (minbs == maxbs && minbs > 0) d->nominal_bs = minbs;
        } else if (type == 3) {                            // SEEKTABLE
            uint32_t n = len / 18;
            std::vector<uint8_t> body(len);
            if (fread(body.data(), 1, len, f) != len) { delete d; fclose(f); return nullptr; }
            for (uint32_t i = 0; i < n; i++) {
                const uint8_t* e = body.data() + i * 18;
                SeekPoint sp;
                sp.sample = 0; sp.offset = 0;
                for (int k = 0; k < 8; k++) sp.sample = (sp.sample << 8) | e[k];
                for (int k = 8; k < 16; k++) sp.offset = (sp.offset << 8) | e[k];
                sp.nframes = ((uint16_t)e[16] << 8) | e[17];
                if (sp.sample != 0xFFFFFFFFFFFFFFFFull)   // placeholder points
                    d->seektable.push_back(sp);
            }
        } else {
            fseek(f, len, SEEK_CUR);
        }
    }
    if (d->sr == 0 || d->channels == 0 || d->channels > 8 || d->bps == 0) {
        delete d; fclose(f); return nullptr;
    }
    d->first_frame_off = ftell(f);
    d->br = new BitReader(f);
    d->br->seek_to(d->first_frame_off);
    return d;
}

void ssflac_info(void* h, long long* total, int* sr, int* ch, int* bits) {
    Decoder* d = (Decoder*)h;
    *total = (long long)d->total;
    *sr = (int)d->sr;
    *ch = (int)d->channels;
    *bits = (int)d->bps;
}

// decode up to max_frames interleaved int32 samples (native bit depth,
// NOT rescaled); returns frames produced (0 at EOF, -1 on error)
long long ssflac_read_i32(void* h, int32_t* out, long long max_frames) {
    Decoder* d = (Decoder*)h;
    long long produced = 0;
    while (produced < max_frames) {
        if (!d->err.empty()) {
            // deliver salvaged samples first; the NEXT call reports the
            // error (-1) exactly once and clears it so the decoder can
            // resync past the corruption — a permanently-set err used to
            // fail even a clean later EOF (review r3 batch 14)
            if (produced) return produced;
            d->last_err = d->err;
            d->err.clear();
            return -1;
        }
        if (d->block_used >= d->block_n) {
            long long first = decode_frame(*d);
            if (first < 0) {
                if (!d->err.empty()) continue;  // loop top reports it
                break;  // EOF
            }
            // frames arrive in order on the sequential path; trust position
            d->next_sample = (uint64_t)first;
        }
        uint32_t avail = d->block_n - d->block_used;
        uint32_t want = (uint32_t)((max_frames - produced) < (long long)avail
                                       ? (max_frames - produced) : avail);
        for (uint32_t i = 0; i < want; i++) {
            uint32_t s = d->block_used + i;
            for (uint32_t c = 0; c < d->channels; c++)
                out[(produced + i) * d->channels + c] = (int32_t)d->chan[c][s];
        }
        d->block_used += want;
        d->next_sample += want;
        produced += want;
    }
    return produced;
}

// position the decoder so the next read returns `frame`; 0 ok, -1 error
int ssflac_seek(void* h, long long frame) {
    Decoder* d = (Decoder*)h;
    uint64_t target = (uint64_t)frame;
    // inside the current block?
    uint64_t block_start = d->next_sample - d->block_used;
    if (d->block_n && target >= block_start && target < block_start + d->block_n) {
        d->block_used = (uint32_t)(target - block_start);
        d->next_sample = target;
        return 0;
    }
    long long off = d->first_frame_off;
    uint64_t base = 0;
    for (const auto& sp : d->seektable) {
        if (sp.sample <= target && d->first_frame_off + (long long)sp.offset > off) {
            off = d->first_frame_off + (long long)sp.offset;
            base = sp.sample;
        }
    }
    if (target < d->next_sample || off > d->br->byte_offset()) {
        if (!d->br->seek_to(off)) return -1;
        d->block_n = d->block_used = 0;
        d->next_sample = base;
    }
    // decode forward until the block containing target
    bool retried = false;
    while (true) {
        if (d->block_n) {
            uint64_t bs = d->next_sample - d->block_used;
            if (target < bs + d->block_n) {
                d->block_used = (uint32_t)(target - bs);
                d->next_sample = target;
                return 0;
            }
        }
        long long first = decode_frame(*d);
        if (first < 0) return -1;
        d->next_sample = (uint64_t)first;
        if ((uint64_t)first > target) {
            // bogus/sparse seektable landed past the target: restart ONCE
            // from the first audio frame and decode forward (slow but exact
            // — returning success here would silently shift all subsequent
            // reads by (first - target) frames). If even the stream's first
            // frame starts past the target (malformed header / nonzero
            // first frame number), a second restart would re-decode the
            // same frame forever: accept the overshot position instead.
            if (retried) {
                d->block_used = 0;
                return 0;
            }
            retried = true;
            if (!d->br->seek_to(d->first_frame_off)) return -1;
            d->block_n = d->block_used = 0;
            d->next_sample = 0;
        }
    }
}

const char* ssflac_error(void* h) {
    Decoder* d = (Decoder*)h;
    // err is cleared when the -1 is returned; last_err keeps the message
    // for the caller building the exception (review r3 batch 14)
    return d->err.empty() ? d->last_err.c_str() : d->err.c_str();
}

void ssflac_close(void* h) {
    Decoder* d = (Decoder*)h;
    if (d->br) delete d->br;
    if (d->f) fclose(d->f);
    delete d;
}

}  // extern "C"
