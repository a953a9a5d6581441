"""The port's Ogg/Opus reader (``softspoken_tpu_torch/io/opus.py``),
mirroring tests/test_opus.py, and held to the JAX package's reader on the
same files: the same system libogg and libopus decode on both sides, so the
samples are equal bit for bit.

The layers are only half-shared: encode muxes pages by hand through
libogg's stream API while decode demuxes with ogg_sync and the module's own
page parser, so a framing or granule bug on either side breaks the round
trip.
"""

import os
import struct
import zlib

import numpy as np
import pytest

from softspoken_tpu.io import opus as jopus
from softspoken_tpu_torch.io import opus
from softspoken_tpu_torch.io import wavio
from softspoken_tpu_torch.project import Table
from softspoken_tpu_torch.silence import SilenceRunner
from torch_codec_ref import (assert_dispatch_equals_jax, assert_fused_detect_equals_jax,
                             assert_missing_library_as_jax)

pytestmark = pytest.mark.skipif(
    not opus.available(), reason="system libogg/libopus not installed")


def _tone(sr=48000, seconds=5.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.normal(size=len(t))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def opus_file(tmp_path_factory):
    sr = 48000
    x = _tone(sr)
    p = str(tmp_path_factory.mktemp("opus") / "tone.opus")
    opus.write_opus(p, x, sr)
    return p, x, sr


def test_info_exact_length(opus_file):
    p, x, sr = opus_file
    inf = opus.info(p)
    assert inf.samplerate == 48000
    assert inf.channels == 1
    assert inf.frames == len(x)  # end-trim granule recovers the exact count
    assert inf.subtype == "OPUS"
    assert abs(inf.duration - 5.0) < 1e-6


def test_roundtrip_close(opus_file):
    p, x, sr = opus_file
    y, sr2 = opus.read(p)
    assert sr2 == 48000 and len(y) == len(x)
    # lossy codec: assert strong correlation, not equality
    assert np.corrcoef(x, y)[0, 1] > 0.97


def test_range_read_converged(opus_file):
    """start>0 re-enters with the RFC 7845 80 ms pre-roll: converged (not
    bit-exact) output; start=0 restarts the stream and IS bit-exact."""
    p, x, sr = opus_file
    full, _ = opus.read(p)
    part, _ = opus.read(p, start=sr, frames=sr)
    # measured with the system libopus: max |diff| ~3e-7 after pre-roll
    np.testing.assert_allclose(part, full[sr:2 * sr], atol=1e-4)
    head, _ = opus.read(p, start=0, frames=sr)
    assert np.array_equal(head, full[:sr])
    tail, _ = opus.read(p, start=len(x) - 100, frames=1000)  # EOF clamp
    assert len(tail) == 100


def test_stereo_roundtrip(tmp_path):
    sr = 48000
    t = np.arange(2 * sr) / sr
    x = np.stack([0.3 * np.sin(2 * np.pi * 300 * t),
                  0.3 * np.sin(2 * np.pi * 500 * t)], axis=1).astype(np.float32)
    p = str(tmp_path / "st.opus")
    opus.write_opus(p, x, sr)
    inf = opus.info(p)
    assert inf.channels == 2 and inf.frames == len(t)
    y, _ = opus.read(p)
    assert y.shape == x.shape
    assert np.corrcoef(x[:, 0], y[:, 0])[0, 1] > 0.95
    assert np.corrcoef(x[:, 1], y[:, 1])[0, 1] > 0.95


def test_non_48k_input_decodes_at_48k(tmp_path):
    """Opus decodes at 48 kHz whatever the encoder's input rate was — the
    info/read surface must report the 48 kHz frame count (libsndfile
    behaves the same way)."""
    sr = 16000
    x = _tone(sr, seconds=2.0, seed=1)
    p = str(tmp_path / "t16.opus")
    opus.write_opus(p, x, sr)
    inf = opus.info(p)
    assert inf.samplerate == 48000
    assert inf.frames == len(x) * 3  # 16k -> 48k
    y, sr2 = opus.read(p)
    assert sr2 == 48000 and len(y) == inf.frames


def test_sequential_reader_bit_exact(opus_file):
    """Forward reads with backward overlap must be bit-exact vs one
    continuous decode (the history buffer serves the overlap — the decoder
    itself never seeks)."""
    p, x, sr = opus_file
    full, _ = opus.read(p)
    with opus.SequentialMonoReader(p) as smr:
        assert smr.info.frames == len(x)
        a = smr.read(0, 30000)
        b = smr.read(29000, 30000)      # backward overlap
        c = smr.read(100000, 10 ** 9)   # forward skip + EOF clamp
    assert np.array_equal(a, full[:30000])
    assert np.array_equal(b, full[29000:59000])
    assert np.array_equal(c, full[100000:])


def test_sequential_reader_history_limit(opus_file):
    p, x, sr = opus_file
    with opus.SequentialMonoReader(p, history=1000) as smr:
        smr.read(50000, 1000)
        with pytest.raises(opus.OpusFormatError, match="backward"):
            smr.read(0, 1000)


def test_probe_and_read_any_dispatch(opus_file):
    from softspoken_tpu_torch.io.audio import get_audio_data, read_any, read_mono

    p, x, sr = opus_file
    dur, native_sr = get_audio_data(p)
    assert native_sr == 48000 and abs(dur - 5.0) < 1e-6
    data, sr2 = read_any(p, start=100, frames=50)
    assert sr2 == 48000 and len(data) == 50
    mono, sr3 = read_mono(p)
    assert sr3 == 48000 and mono.ndim == 1 and len(mono) == len(x)


def test_ogg_container_disambiguation(opus_file, tmp_path):
    """Vorbis and Opus share the OggS container: the sniffers must tell
    them apart, and probe() must route each to its own decoder."""
    from softspoken_tpu_torch.io import oggvorbis as ov
    from softspoken_tpu_torch.io.audio import probe

    p_opus, x, sr = opus_file
    assert opus.is_opus(p_opus)
    assert ov.is_ogg(p_opus)  # it IS an Ogg file — Opus must win dispatch
    assert probe(p_opus).subtype == "OPUS"
    if ov.available():
        p_ogg = str(tmp_path / "t.ogg")
        ov.write_vorbis(p_ogg, x[:sr], sr)
        assert not opus.is_opus(p_ogg)
        assert probe(p_ogg).subtype == "VORBIS"
        with pytest.raises(opus.OpusFormatError):
            opus.read(p_ogg)


def test_stream_chunks_concat_equals_load(opus_file):
    """The OPUS branch of stream_chunks (persistent forward-only handle)
    must reproduce load_audio output exactly when concatenated — including
    the backward filter-context overlap between chunks."""
    from softspoken_tpu_torch.io.audio import load_audio, stream_chunks

    p, x, sr = opus_file
    whole, _ = load_audio(p)
    parts = list(stream_chunks(p, chunk_samples=30000))
    assert parts[-1].is_last and not parts[0].is_last
    cat = np.concatenate([c.data for c in parts])
    assert len(cat) == len(whole)
    np.testing.assert_allclose(cat, whole, atol=2e-6)


def test_opushead_parse_families():
    """Unit-level parse of the three channel-mapping families (the encoder
    only writes family 0, so 1/255 are covered here)."""
    h = opus._parse_opushead(
        b"OpusHead" + bytes([1, 2]) + struct.pack("<HIh", 312, 48000, 0)
        + bytes([0]))
    assert (h.channels, h.streams, h.coupled) == (2, 1, 1)
    assert h.mapping == b"\x00\x01" and h.gain_scale == 1.0

    h = opus._parse_opushead(
        b"OpusHead" + bytes([1, 3]) + struct.pack("<HIh", 0, 44100, 0)
        + bytes([1, 2, 1, 0, 1, 2]))  # family 1: 2 streams, 1 coupled
    assert (h.channels, h.streams, h.coupled) == (3, 2, 1)
    assert h.mapping == b"\x00\x01\x02"

    h = opus._parse_opushead(
        b"OpusHead" + bytes([1, 2]) + struct.pack("<HIh", 0, 48000, 0)
        + bytes([255, 2, 0, 0, 1]))  # family 255: discrete
    assert (h.channels, h.streams, h.coupled) == (2, 2, 0)

    with pytest.raises(opus.OpusFormatError):  # major version != 0
        opus._parse_opushead(
            b"OpusHead" + bytes([16, 1]) + struct.pack("<HIh", 0, 48000, 0)
            + bytes([0]))
    with pytest.raises(opus.OpusFormatError):  # family 0 with 3 channels
        opus._parse_opushead(
            b"OpusHead" + bytes([1, 3]) + struct.pack("<HIh", 0, 48000, 0)
            + bytes([0]))
    with pytest.raises(opus.OpusFormatError):  # truncated mapping table
        opus._parse_opushead(
            b"OpusHead" + bytes([1, 3]) + struct.pack("<HIh", 0, 48000, 0)
            + bytes([1, 2]))
    with pytest.raises(opus.OpusFormatError):  # mapping index out of range
        opus._parse_opushead(
            b"OpusHead" + bytes([1, 2]) + struct.pack("<HIh", 0, 48000, 0)
            + bytes([1, 1, 0, 0, 7]))


def _ogg_crc(page: bytes) -> int:
    """Ogg page CRC: CRC-32/BZIP2-style (poly 0x04c11db7, init 0, no
    reflection, no final xor) over the page with a zeroed CRC field."""
    crc = 0
    for byte in page:
        crc ^= byte << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7) if crc & 0x80000000 else crc << 1
            crc &= 0xFFFFFFFF
    return crc


def test_output_gain_applied(opus_file, tmp_path):
    """RFC 7845 §5.1: the OpusHead output_gain (Q7.8 dB) must scale the
    decoded output.  Patch -6.02 dB into page 0 (and fix its CRC — the
    demux CRC-checks pages) and expect the samples to halve."""
    p, x, sr = opus_file
    base, _ = opus.read(p, frames=sr)
    raw = bytearray(open(p, "rb").read())
    nseg = raw[26]
    body_off = 27 + nseg
    assert raw[body_off:body_off + 8] == b"OpusHead"
    gain_q8 = int(round(-6.02 * 256))
    struct.pack_into("<h", raw, body_off + 16, gain_q8)
    page_len = body_off + sum(raw[27:27 + nseg])
    struct.pack_into("<I", raw, 22, 0)
    struct.pack_into("<I", raw, 22, _ogg_crc(bytes(raw[:page_len])))
    p2 = str(tmp_path / "gain.opus")
    open(p2, "wb").write(bytes(raw))
    scaled, _ = opus.read(p2, frames=sr)
    np.testing.assert_allclose(scaled, base * 10 ** (gain_q8 / 5120.0),
                               rtol=1e-5, atol=1e-7)


def test_page_index_cache_reused(opus_file):
    """Two seeking reads of an unchanged file must build the page index
    once (per realpath/size/mtime, like mp3's scan cache)."""
    p, x, sr = opus_file
    key = opus._index_cache_key(p)
    opus.read(p, start=sr, frames=100)
    with opus._index_cache_lock:
        assert key in opus._index_cache
        idx1 = opus._index_cache[key][1]
    opus.read(p, start=2 * sr, frames=100)
    with opus._index_cache_lock:
        assert opus._index_cache[key][1] is idx1  # same object: no rebuild


def test_truncated_file_reads_short_not_hang(opus_file, tmp_path):
    p, x, sr = opus_file
    raw = open(p, "rb").read()
    p2 = str(tmp_path / "trunc.opus")
    open(p2, "wb").write(raw[: len(raw) * 2 // 3])
    inf = opus.info(p2)  # tail scan finds the last COMPLETE page's granule
    assert 0 < inf.frames < len(x)
    y, _ = opus.read(p2)
    assert 0 < len(y) <= inf.frames


def test_corrupt_and_foreign_files_raise_cleanly(tmp_path):
    p = str(tmp_path / "x.wav")
    wavio.write(p, _tone(22050, 0.2), 22050)
    assert not opus.is_opus(p)
    with pytest.raises(opus.OpusFormatError):
        opus.info(p)
    junk = str(tmp_path / "junk.opus")
    open(junk, "wb").write(b"OggS" + os.urandom(200))
    assert not opus.is_opus(junk)
    with pytest.raises(opus.OpusFormatError):
        opus.read(junk)
    # header-only stream (no audio packets): an empty-but-valid stream —
    # frames 0 and an empty read, not an error or a hang
    hdr = str(tmp_path / "hdr.opus")
    full = open(str(tmp_path / "full.opus"), "wb")
    opus.write_opus(full.name, _tone(48000, 0.1), 48000)
    raw = open(full.name, "rb").read()
    nseg = raw[26]
    open(hdr, "wb").write(raw[: 27 + nseg + sum(raw[27:27 + nseg])])
    assert opus.info(hdr).frames == 0
    y, _ = opus.read(hdr)
    assert len(y) == 0


def test_write_bad_path_raises_and_failure_leaves_no_file(tmp_path):
    with pytest.raises(OSError):
        opus.write_opus(str(tmp_path / "no" / "dir.opus"),
                        _tone(48000, 0.1), 48000)
    bad = str(tmp_path / "badrate.opus")
    with pytest.raises(opus.OpusFormatError, match="input rate"):
        opus.write_opus(bad, _tone(22050, 0.1), 22050)  # not an Opus rate
    assert not os.path.exists(bad)


def test_detect_file_on_opus(tmp_path):
    """Fused detect on an Opus file (the persistent forward-only reader):
    the JAX package's grid and intervals."""
    sr = 48000
    x = (0.02 * np.random.default_rng(3).normal(size=10 * sr)).astype(np.float32)
    p = str(tmp_path / "field.opus")
    opus.write_opus(p, x, sr)
    assert opus.info(p).frames == 10 * sr
    assert_fused_detect_equals_jax(p)


def test_silencer_on_opus(tmp_path):
    """The silence workflow must cover every format probe() dispatches
    (OpusInfo.data_bytes=0 falls back to frames * bytes-per-frame in the
    stream gate, like OggInfo/Mp3Info)."""
    sr = 48000
    x = _tone(sr, seconds=4.0, seed=3)
    src = str(tmp_path / "rec.opus")
    opus.write_opus(src, x, sr)

    review = Table(["file_path", "file_name", "start_time", "end_time", "erase"],
                   [{"file_path": str(tmp_path), "file_name": "rec.opus",
                     "start_time": 1.0, "end_time": 2.0, "erase": 1}])
    report = SilenceRunner(str(tmp_path / "out")).run(review)
    assert report.files_failed == 0 and report.files_done == 1
    y, osr = wavio.read(report.outputs[0])
    assert osr == 48000 and len(y) == len(x)
    s0, s1 = int(1.0 * 48000), int(2.0 * 48000)
    assert np.all(y[s0:s1] == 0)
    assert np.abs(y[: s0 - 1]).max() > 0.05


def test_zlib_crc_sanity():
    """The hand-rolled Ogg CRC differs from zlib's (reflected) CRC-32 —
    make sure the helper isn't accidentally the wrong one."""
    data = b"OggS\x00\x02" + bytes(20)
    assert _ogg_crc(data) != zlib.crc32(data)


def _remux_split_packets(src: str, dst: str, lacing_per_page: int = 3) -> int:
    """Re-laminate an Ogg/Opus file into pages of at most N lacing values,
    IGNORING packet boundaries — i.e. produce the legal continued-packet
    pages (RFC 3533 §6, header flag 0x01) that libogg's own lamination
    never emits for Opus-sized packets (it always cuts after a completed
    packet below 255 lacing values).  Returns the number of continued
    pages written.  Headers keep their own pages per RFC 7845 §3."""
    raw = open(src, "rb").read()

    # --- parse: pages → ordered packets ---
    off = 0
    serial = None
    page_list = []  # (granule, [segments...]) per page, our stream only
    while True:
        i = raw.find(b"OggS", off)
        if i < 0:
            break
        g = int.from_bytes(raw[i + 6:i + 14], "little", signed=True)
        ser = struct.unpack("<I", raw[i + 14:i + 18])[0]
        nseg = raw[i + 26]
        lac = list(raw[i + 27:i + 27 + nseg])
        body = raw[i + 27 + nseg:i + 27 + nseg + sum(lac)]
        off = i + 27 + nseg + sum(lac)
        if serial is None:
            serial = ser
        if ser == serial:
            page_list.append((g, lac, body))
    packets = []
    cur = b""
    for g, lac, body in page_list:
        p = 0
        for v in lac:
            cur += body[p:p + v]
            p += v
            if v < 255:
                packets.append(cur)
                cur = b""
    assert not cur, "source file ends mid-packet"
    assert len(packets) >= 4
    head, tags, audio = packets[0], packets[1], packets[2:]
    final_granule = page_list[-1][0]
    granules = [(i + 1) * 960 for i in range(len(audio))]
    granules[-1] = final_granule  # end-trim granule from the source

    def page_bytes(lacing, body, granule, pageno, flags):
        hdr = (b"OggS\x00" + bytes([flags])
               + granule.to_bytes(8, "little", signed=True)
               + struct.pack("<II", serial, pageno) + b"\x00\x00\x00\x00"
               + bytes([len(lacing)]) + bytes(lacing))
        page = bytearray(hdr + body)
        struct.pack_into("<I", page, 22, _ogg_crc(bytes(page)))
        return bytes(page)

    def whole_packet_lacing(pkt):
        q, r = divmod(len(pkt), 255)
        return [255] * q + [r]  # r==0 is the required explicit terminator

    out = [
        page_bytes(whole_packet_lacing(head), head, 0, 0, 0x02),  # BOS
        page_bytes(whole_packet_lacing(tags), tags, 0, 1, 0x00),  # OpusTags
    ]

    # flatten audio packets into (fragment, final, packet_index) pieces of
    # <=255 bytes, then page them N lacing values at a time
    pieces = []
    for pi, pkt in enumerate(audio):
        frs = [pkt[k:k + 255] for k in range(0, len(pkt), 255)]
        if len(pkt) % 255 == 0:
            frs.append(b"")  # explicit 0-lacing terminator
        for j, fr in enumerate(frs):
            pieces.append((fr, j == len(frs) - 1, pi))
    pageno = 2
    ncont = 0
    k = 0
    mid_packet = False
    while k < len(pieces):
        chunk = pieces[k:k + lacing_per_page]
        k += len(chunk)
        gran = -1
        for fr, final, pi in chunk:
            if final:
                gran = granules[pi]
        flags = 0x01 if mid_packet else 0x00
        if k >= len(pieces):
            flags |= 0x04  # EOS
        if flags & 0x01:
            ncont += 1
        body = b"".join(fr for fr, _f, _p in chunk)
        # one lacing value per piece: 255 marks "packet continues", the
        # final piece carries its true length (possibly 0)
        lacing = [(255 if not f else len(fr)) for fr, f, _p in chunk]
        out.append(page_bytes(lacing, body, gran, pageno, flags))
        pageno += 1
        mid_packet = not chunk[-1][1]
    open(dst, "wb").write(b"".join(out))
    return ncont


def test_seek_exact_with_continued_packet_pages(tmp_path):
    """Seeks must not time-shift on files whose pages start mid-packet
    (legal per RFC 3533; produced by remuxing since libogg itself never
    splits Opus-sized packets).  A resume page whose first packet is a
    continuation used to be decoded with that dropped packet's duration
    unaccounted, shifting every later sample."""
    sr = 48000
    t = np.arange(sr * 5) / sr
    # aperiodic chirp: a one-packet (20 ms) time shift cannot alias into
    # a near-match the way a steady tone could
    x = (0.25 * np.sin(2 * np.pi * (300.0 + 200.0 * t) * t)).astype(np.float32)
    src = str(tmp_path / "a.opus")
    # 500 kbps: ~650-byte packets = 3 lacing values each; 2 lacing values
    # per page makes the page boundary drift THROUGH packets
    opus.write_opus(src, x, sr, bitrate_kbps=500)
    dst = str(tmp_path / "split.opus")
    ncont = _remux_split_packets(src, dst, lacing_per_page=2)
    assert ncont > 10, "vector must actually contain continued pages"

    inf = opus.info(dst)
    assert inf.frames == len(x)
    base, _ = opus.read(src)
    full, _ = opus.read(dst)
    # remux is a pure container transform: sequential decode bit-identical
    np.testing.assert_array_equal(full, base)

    for start in (sr // 2, sr, 2 * sr + 333, 3 * sr + 7):
        part, _ = opus.read(dst, start=start, frames=9600)
        ref = full[start:start + 9600]
        # CELT convergence at 500 kbps: ~2e-2 right after the 80 ms
        # pre-roll, decaying to ~1e-4 within 0.2 s (measured; larger than
        # the 64 kbps SILK figure in test_range_read_converged)
        assert float(np.abs(part - ref).max()) < 0.05, f"start={start}"
        assert float(np.abs(part[4800:] - ref[4800:]).max()) < 2e-3
        # the pre-fix failure mode: output shifted by one dropped
        # 960-sample packet — err ~0.5 here, far outside convergence
        shifted = full[start + 960:start + 960 + 9600]
        assert float(np.abs(part - shifted).max()) > 0.2


# ---------------------------------------------------------------------------
# the port against the JAX package

def test_reader_equals_jax_bit_for_bit(opus_file):
    """info, read (from 0, after a seek with pre-roll, EOF), the sequential
    reader with backward overlap and the audio dispatch give the JAX
    module's values."""
    p, x, sr = opus_file
    assert opus.info(p).__dict__ == jopus.info(p).__dict__
    for kw in ({}, {"start": 0, "frames": sr}, {"start": sr, "frames": sr},
               {"start": len(x) - 100, "frames": 1000}, {"always_2d": True}):
        got, want = opus.read(p, **kw), jopus.read(p, **kw)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
    with opus.SequentialMonoReader(p) as a, jopus.SequentialMonoReader(p) as b:
        for start, n in ((0, 30000), (29000, 30000), (100000, 10**9)):
            np.testing.assert_array_equal(a.read(start, n), b.read(start, n))
    assert_dispatch_equals_jax(p)


def test_writer_bytes_equal_jax(tmp_path):
    x = _tone(48000, seconds=1.0, seed=4)
    a, b = str(tmp_path / "a.opus"), str(tmp_path / "b.opus")
    opus.write_opus(a, x, 48000)
    jopus.write_opus(b, x, 48000)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_without_libopus_as_jax(monkeypatch, tmp_path, opus_file):
    assert_missing_library_as_jax(monkeypatch, tmp_path, opus, jopus, opus_file[0],
                                  opus.OpusFormatError, jopus.OpusFormatError)
