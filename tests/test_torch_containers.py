"""The port's PCM container readers (AIFF/AIFC, W64, CAF, AU, SPHERE) and
WAV subtypes (RIFX, wide integers, G.711, MS-ADPCM, IMA-ADPCM) against the
JAX package's: for every (format, subtype) the header probe, the samples of
``read_any`` (whole file and a range), ``read_mono`` and ``load_audio`` are
exactly equal.  Files are written with the JAX tests' own writers.  MP3,
Ogg Vorbis and Opus files, written with the JAX package's encoders, go
through the same dispatch in the JAX order and read the same samples."""

import struct

import numpy as np
import pytest
import torch

from softspoken_tpu import Config as JConfig
from softspoken_tpu import ckpt as jckpt
from softspoken_tpu.engine import Detector as JDetector
from softspoken_tpu.io import audio as jaudio
from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu_torch import Config
from softspoken_tpu_torch.ckpt import fixture_state_dict
from softspoken_tpu_torch.engine import Detector
from softspoken_tpu_torch.io import audio
from test_adpcm import _write_ima, _write_ms, _write_ms_stereo
from test_aiff import write_aiff
from test_pcm_containers import write_caf, write_sphere, write_w64
from test_wav_interop import _write_rifx_pcm16

torch.set_num_threads(2)


def _sig(frames, channels, seed=0):
    """Float samples in (-1, 1) that survive a PCM16 round trip."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames) / 16000.0
    x = np.stack([0.4 * np.sin(2 * np.pi * (440 + 110 * c) * t)
                  + 0.05 * rng.standard_normal(frames) for c in range(channels)], 1)
    return np.clip(x, -0.99, 0.99)


def _i16(x):
    return np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int64)


def _wav_chunks(path, tag, ch, sr, bits, align, payload, riff=b"RIFF", en="<"):
    with open(path, "wb") as f:
        f.write(riff + struct.pack(en + "I", 36 + len(payload) + (len(payload) & 1))
                + b"WAVE")
        f.write(b"fmt " + struct.pack(en + "IHHIIHH", 16, tag, ch, sr, sr * align,
                                      align, bits))
        f.write(b"data" + struct.pack(en + "I", len(payload)) + payload)
        if len(payload) & 1:
            f.write(b"\x00")


def _au(path, x, sr, encoding):
    frames, ch = x.shape
    if encoding == 3:
        payload = _i16(x).astype(">i2").tobytes()
    elif encoding == 6:
        payload = x.astype(">f4").tobytes()
    else:  # G.711 codes (1 mu-law, 27 A-law): any byte is a code
        payload = np.random.default_rng(7).integers(0, 256, frames * ch,
                                                    dtype=np.uint8).tobytes()
    with open(path, "wb") as f:
        f.write(b".snd" + struct.pack(">5I", 24, len(payload), encoding, sr, ch) + payload)


def _wide(path, x, sr, nbytes):
    """Signed PCM in ``nbytes``-byte little-endian containers (5-8 bytes)."""
    frames, ch = x.shape
    v = np.rint(x * 2.0 ** 31).astype(np.int64) << (8 * (nbytes - 4))
    raw = v.astype("<i8").view(np.uint8).reshape(-1, 8)[:, 8 - nbytes:]
    _wav_chunks(path, 1, ch, sr, 8 * nbytes, ch * nbytes, raw.tobytes())


def _g711_wav(path, x, sr, tag):
    frames, ch = x.shape
    codes = np.random.default_rng(3).integers(0, 256, frames * ch, dtype=np.uint8)
    _wav_chunks(path, tag, ch, sr, 8, ch, codes.tobytes())


def _write(kind, path, sr=16000, frames=9000):
    x1, x2 = _sig(frames, 1), _sig(frames, 2, seed=1)
    fmt, sub = kind
    if fmt == "aiff":
        if sub == "PCM_16":
            write_aiff(path, _i16(x2), sr)
        elif sub == "PCM_24":
            v = np.rint(x2 * 2 ** 23).astype(">i4").view(np.uint8).reshape(-1, 4)[:, 1:]
            write_aiff(path, x2.shape, sr, payload=v.tobytes(), bits=24)
        elif sub == "sowt":
            write_aiff(path, x1.shape, sr, form=b"AIFC", comp=b"sowt",
                       payload=_i16(x1).astype("<i2").tobytes())
        elif sub == "fl32":
            write_aiff(path, x2.shape, sr, form=b"AIFC", comp=b"fl32",
                       payload=x2.astype(">f4").tobytes(), bits=32)
    elif fmt == "w64":
        write_w64(path, x1 if sub == "ULAW" else x2, sr,
                  subtype=sub.removesuffix("-ext"), extensible=sub.endswith("-ext"))
    elif fmt == "caf":
        write_caf(path, x2, sr, subtype=sub.removesuffix("-le"),
                  little=sub.endswith("-le"))
    elif fmt == "au":
        _au(path, x2, sr, {"PCM_16": 3, "FLOAT": 6, "ULAW": 1, "ALAW": 27}[sub])
    elif fmt == "sphere":
        write_sphere(path, x2 if sub != "ulaw" else x1, sr,
                     coding="ulaw" if sub == "ulaw" else "pcm",
                     byte_format="10" if sub == "pcm-be" else "01")
    elif fmt == "rifx":
        _write_rifx_pcm16(path, _i16(x2), sr, 2)
    elif fmt == "wav":
        if sub in ("PCM_40", "PCM_48", "PCM_64"):
            _wide(path, x2, sr, int(sub[4:]) // 8)
        elif sub in ("ULAW", "ALAW"):
            _g711_wav(path, x2, sr, 7 if sub == "ULAW" else 6)
        elif sub == "MS_ADPCM":
            _write_ms(path, _i16(x1[:, 0]), sr=sr, spb=128)
        elif sub == "MS_ADPCM-stereo":
            _write_ms_stereo(path, _i16(x2), sr=sr, spb=64)
        elif sub == "IMA_ADPCM":
            _write_ima(path, _i16(x1[:, 0]), sr=sr)
        elif sub == "IMA_ADPCM-stereo":
            _write_ima(path, _i16(x2), sr=sr, ch=2)
    return path


CASES = [
    ("aiff", "PCM_16"), ("aiff", "PCM_24"), ("aiff", "sowt"), ("aiff", "fl32"),
    ("w64", "PCM_16"), ("w64", "FLOAT"), ("w64", "PCM_16-ext"), ("w64", "ULAW"),
    ("caf", "PCM_16"), ("caf", "FLOAT-le"), ("caf", "ULAW"),
    ("au", "PCM_16"), ("au", "FLOAT"), ("au", "ULAW"), ("au", "ALAW"),
    ("sphere", "pcm"), ("sphere", "pcm-be"), ("sphere", "ulaw"),
    ("rifx", "PCM_16"),
    ("wav", "PCM_40"), ("wav", "PCM_48"), ("wav", "PCM_64"),
    ("wav", "ULAW"), ("wav", "ALAW"),
    ("wav", "MS_ADPCM"), ("wav", "MS_ADPCM-stereo"),
    ("wav", "IMA_ADPCM"), ("wav", "IMA_ADPCM-stereo"),
]
_FIELDS = ("samplerate", "channels", "frames", "subtype", "bits_per_sample", "duration")


@pytest.mark.parametrize("kind", CASES, ids=["-".join(k) for k in CASES])
def test_reader_equals_jax(tmp_path, kind):
    p = _write(kind, str(tmp_path / ("x." + kind[0])))
    inf, jinf = audio.probe(p), jaudio.probe(p)
    assert [getattr(inf, k) for k in _FIELDS] == [getattr(jinf, k) for k in _FIELDS]
    assert inf.frames > 1000
    for kw in (dict(always_2d=True), dict(start=777, frames=2345),
               dict(start=inf.frames - 5, frames=100)):
        got, sr = audio.read_any(p, **kw)
        want, jsr = jaudio.read_any(p, **kw)
        assert sr == jsr and got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(audio.read_mono(p)[0], jaudio.read_mono(p)[0])
    got, sr = audio.load_audio(p)
    want, jsr = jaudio.load_audio(p)
    assert sr == jsr == 22050
    np.testing.assert_array_equal(got, want)
    assert audio.get_audio_data(p) == jaudio.get_audio_data(p)


def _codec_file(path, fmt):
    """A 4 s 22,050 Hz (Opus: 48 kHz) tone in ``fmt``, written with the JAX
    package's encoder; "mp3-id3" puts an ID3v2 tag in front of the first
    frame, as taggers do."""
    from softspoken_tpu.io import mp3, oggvorbis, opus

    sr = 48000 if fmt == "opus" else 22050
    x = (0.3 * np.sin(2 * np.pi * 440 * np.arange(4 * sr) / sr)).astype(np.float32)
    if fmt.startswith("mp3"):
        mp3.write_mp3(path, x, sr)
        if fmt == "mp3-id3":
            with open(path, "rb") as f:
                body = f.read()
            with open(path, "wb") as f:  # ID3v2.4, no flags, 60 bytes of padding
                f.write(b"ID3\x04\x00\x00" + bytes([0, 0, 0, 60]) + bytes(60) + body)
    elif fmt == "vorbis":
        oggvorbis.write_vorbis(path, x, sr)
    else:
        opus.write_opus(path, x, sr)
    return path


@pytest.mark.parametrize("fmt,head", [
    ("mp3-id3", b"ID3"),
    ("mp3-frame", b"\xff"),
    ("vorbis", b"OggS"),
    ("opus", b"OggS"),
], ids=["mp3-id3", "mp3-frame", "vorbis", "opus"])
def test_unported_formats_raise_naming_the_format(tmp_path, fmt, head):
    """The formats that once raised here now read: probe, read_any,
    load_audio, get_audio_data and internal_length on a real file of each
    equal the JAX package's, bit for bit (the same system library decodes
    on both sides)."""
    p = _codec_file(str(tmp_path / "x.bin"), fmt)
    with open(p, "rb") as f:
        assert f.read(len(head)) == head
    inf, jinf = audio.probe(p), jaudio.probe(p)
    assert [getattr(inf, k) for k in _FIELDS] == [getattr(jinf, k) for k in _FIELDS]
    assert inf.frames > 1000
    for kw in ({}, dict(start=777, frames=2345)):
        got, sr = audio.read_any(p, **kw)
        want, jsr = jaudio.read_any(p, **kw)
        assert sr == jsr and got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    got, sr = audio.load_audio(p)
    want, jsr = jaudio.load_audio(p)
    assert sr == jsr == 22050
    np.testing.assert_array_equal(got, want)
    assert audio.get_audio_data(p) == jaudio.get_audio_data(p)
    assert audio.internal_length(p) == jaudio.internal_length(p)


def test_corrupt_container_is_a_decode_failure(tmp_path):
    p = _write(("aiff", "PCM_16"), str(tmp_path / "x.aiff"))
    with open(p, "r+b") as f:
        f.truncate(30)
    assert audio.load_audio(p) == (None, None) == jaudio.load_audio(p)


def _mxcsr():
    """The calling thread's MXCSR on x86-64 (rounding mode in bits 13-14,
    FTZ bit 15, DAZ bit 6), read by a four-byte ``stmxcsr [rdi]; ret``
    stub; None where that cannot run."""
    import ctypes
    import mmap
    import platform

    if platform.machine() not in ("x86_64", "AMD64"):
        return None
    try:
        buf = mmap.mmap(-1, mmap.PAGESIZE,
                        prot=mmap.PROT_READ | mmap.PROT_WRITE | mmap.PROT_EXEC)
    except (OSError, ValueError, AttributeError):
        return None
    buf.write(b"\x0f\xae\x1f\xc3")
    fn = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_uint32))(
        ctypes.addressof(ctypes.c_char.from_buffer(buf)))
    v = ctypes.c_uint32()
    fn(ctypes.byref(v))
    return v.value


def _intra_op_fp_probe():
    """What the intra-op threads' float mode does to a 2**20-element
    operation, split across the team: the distinct results of 1 + 0.75 ulp,
    1 + 0.25 ulp and -1 - 0.75 ulp (in ulps above 1; round to nearest gives
    1, 0 and -1), and how many denormal products are flushed (FTZ/DAZ)."""
    n, u = 1 << 20, 2.0 ** -23
    one = torch.ones(n)
    return {
        "1+0.75ulp": sorted(((torch.unique(one + 0.75 * u) - 1) / u).tolist()),
        "1+0.25ulp": sorted(((torch.unique(one + 0.25 * u) - 1) / u).tolist()),
        "-1-0.75ulp": sorted(((torch.unique(-one - 0.75 * u) + 1) / u).tolist()),
        "denormal inputs read as 0": int((torch.full((n,), 1e-39) * 1.0 == 0).sum()),
        "denormal results flushed": int((torch.full((n,), 1e-38) * 0.01 == 0).sum()),
    }


def _first_difference(a, b):
    if a.shape != b.shape:
        return f"shapes {a.shape} and {b.shape}"
    d = np.flatnonzero(a.reshape(-1) != b.reshape(-1))
    if d.size == 0:
        return "equal"
    i = int(d[0])
    return (f"{d.size} of {a.size} differ, first at {i}: "
            f"{a.reshape(-1)[i]!r} vs {b.reshape(-1)[i]!r}")


class _StageRecorder:
    """Records, for each ``detect_file_streaming`` call of ``det`` while it
    is on, the fused engine's stages (the decoded wire, the resampled input,
    the mel, the logits, each chunk's grid and the file's grid) and the
    process state at each chunk program's entry: torch's intra-op thread
    count, the live Python threads and whether the detector had run a
    forward before.  The arrays are small (a few seconds of audio), so the
    recorder stays on for the first runs of the bit-equality test."""

    STAGES = ("decoded", "resampled", "mel", "logits", "chunk grid", "grid")

    def __init__(self, det):
        import threading

        import softspoken_tpu_torch.engine.fused as fused
        from softspoken_tpu_torch.ops import mel as melops

        self.runs, self.forwards = [], 0
        self._mp = pytest.MonkeyPatch()
        real_poly, real_fwd = fused.polyphase_apply, det._forward
        real_mel, real_detect = melops.log_mel_windows, det.detect_file_streaming
        real_program = fused.FusedStreamingEngine._program
        rec = self

        def keep(stage, t):
            rec.runs[-1][stage].append(t.detach().cpu().numpy().copy())

        def poly(x, W, **kw):
            y = real_poly(x, W, **kw)
            keep("decoded", x)
            keep("resampled", y)
            rec.runs[-1]["align"].append((x.data_ptr() % 64, W.data_ptr() % 64))
            return y

        def mel(*args, **kw):
            y = real_mel(*args, **kw)
            keep("mel", y)
            return y

        def fwd(*args):
            y = real_fwd(*args)
            rec.forwards += 1
            keep("logits", y)
            return y

        def program(engine, *args):
            rec.runs[-1]["state"].append({
                "torch threads": torch.get_num_threads(),
                "python threads": sorted(t.name for t in threading.enumerate()),
                "first forward of the detector": rec.forwards == 0})
            out = real_program(engine, *args)
            keep("chunk grid", out[0])
            return out

        def detect(path, *args, **kw):
            rec.runs.append({k: [] for k in self.STAGES + ("align", "state")})
            res = real_detect(path, *args, **kw)
            rec.runs[-1]["grid"] = [np.asarray(res.avg_values).copy()]
            return res

        self._mp.setattr(fused, "polyphase_apply", poly)
        self._mp.setattr(melops, "log_mel_windows", mel)
        self._mp.setattr(fused.FusedStreamingEngine, "_program", program)
        self._mp.setattr(det, "_forward", fwd)
        self._mp.setattr(det, "detect_file_streaming", detect)

    def stop(self):
        self._mp.undo()
        return self.runs


def _stage(run, k):
    return np.concatenate([z.reshape(-1) for z in run[k]]) if run[k] else np.zeros(0)


def _first_departure(a, b):
    """The first stage (in pipeline order) at which two recorded runs
    differ, with that difference; "none" when every stage is equal."""
    for k in _StageRecorder.STAGES:
        d = _first_difference(_stage(a, k), _stage(b, k))
        if d != "equal":
            return f"{k} ({d})"
    return "none"


def _wire_mismatch_report(det, paths, grids, first=None):
    """Evidence for a float32-wire/int16-wire grid mismatch, gathered in the
    process where it happened: the differing bins; a second run of each
    wire with every stage recorded, and the first difference of each stage;
    with ``first`` (the recorded first runs), the first stage at which the
    float32 wire's first run departs from its rerun and from the int16
    wire, and the process state at each of the first runs' chunk programs;
    the two resampling matrices' alignment; the thread team; the main
    thread's MXCSR and the intra-op threads' float mode."""
    import threading

    from softspoken_tpu_torch.engine.fused import get_fused_engine

    a, b = grids
    d = np.flatnonzero(a != b)
    out = [f"{d.size} of {a.size} bins differ: "
           + ", ".join(f"{i}: {a[i]!r} vs {b[i]!r}" for i in d[:20])]
    try:
        rec = _StageRecorder(det)
        try:
            for path in paths:
                det.detect_file_streaming(path)
        finally:
            f32, i16 = rec.stop()
        out.append("second run: float32 wire grid vs first run "
                   + _first_difference(f32["grid"][0], a) + "; int16 wire grid vs first run "
                   + _first_difference(i16["grid"][0], b))
        for k in _StageRecorder.STAGES[:-1]:
            out.append(f"second run, {k} (float32 wire vs int16 wire): "
                       + _first_difference(_stage(f32, k), _stage(i16, k)))
        if first is not None:
            f0, i0 = first
            out.append("first run, float32 wire departs from its rerun at: "
                       + _first_departure(f0, f32))
            out.append("first run, float32 wire departs from the int16 wire's first run at: "
                       + _first_departure(f0, i0))
            out.append("first run, int16 wire departs from its rerun at: "
                       + _first_departure(i0, i16))
            for name, run in (("float32", f0), ("int16", i0)):
                out.append(f"first run, {name} wire, state at each chunk program: "
                           + "; ".join(str(s) for s in run["state"]))
        out.append(f"(input, matrix) address mod 64: float32 wire {f32['align']}, "
                   f"int16 wire {i16['align']}")
        out.append("engine matrices address mod 64: " + ", ".join(
            f"{kind} {get_fused_engine(det, 16000, kind).W.data_ptr() % 64}"
            for kind in ("f32", "i16")))
    except Exception as e:  # noqa: BLE001 — the report must not hide the failure
        out.append(f"second run failed: {e!r}")
    mx = _mxcsr()
    out.append(f"main thread MXCSR {'unknown' if mx is None else hex(mx)}; "
               f"intra-op float probe {_intra_op_fp_probe()}; "
               f"torch threads {torch.get_num_threads()}, interop "
               f"{torch.get_num_interop_threads()}, python threads {threading.active_count()}")
    out.append(torch.__config__.parallel_info())
    return "\n".join(out)


@pytest.mark.parametrize("fmt", ["aiff", "w64"])
def test_fused_detect_on_a_container_is_bit_equal_to_the_wav(tmp_path, fmt):
    """A mono PCM16 AIFF / W64 rides the float32 wire, the WAV the int16
    wire; the samples are the same floats, so the grids are bit-equal.  The
    intervals equal the JAX package's fused ones."""
    x = _sig(6 * 16000, 1, seed=4)
    p = str(tmp_path / f"x.{fmt}")
    if fmt == "aiff":
        write_aiff(p, _i16(x), 16000)
    else:
        write_w64(p, x, 16000)
    wp = str(tmp_path / "x.wav")
    jwavio.write(wp, x, 16000, subtype="PCM_16")
    eng = dict(precision="parity", device_batch=4, chunk_seconds=6.0, pipeline="fused")
    det = Detector(Config().with_engine(**eng), state_dict=fixture_state_dict(0),
                   device="cpu")
    recorder = _StageRecorder(det)  # the first runs, stage by stage
    rc, rw = det.detect_file_streaming(p), det.detect_file_streaming(wp)
    first = recorder.stop()
    report = ("" if np.array_equal(rc.avg_values, rw.avg_values) else
              _wire_mismatch_report(det, (p, wp), (rc.avg_values, rw.avg_values), first))
    np.testing.assert_array_equal(rc.avg_values, rw.avg_values, err_msg=report)
    assert rc.intervals == rw.intervals
    ref = JDetector(JConfig().with_engine(**eng),
                    variables=jckpt.fixture_variables(seed=0)).detect_file_fused(p)
    np.testing.assert_allclose(rc.avg_values, ref.avg_values, atol=1e-5)
    assert rc.intervals == ref.intervals


def test_the_wire_mismatch_report_gathers_its_evidence(tmp_path):
    """The report that a mismatch of the test above prints, on a mismatch
    made by hand: it names the bin, reruns both wires and compares their
    stages (equal here), and reads the float state (round to nearest, no
    flushing, as the suite runs)."""
    x = _sig(3 * 16000, 1, seed=4)
    p, wp = str(tmp_path / "x.aiff"), str(tmp_path / "x.wav")
    write_aiff(p, _i16(x), 16000)
    jwavio.write(wp, x, 16000, subtype="PCM_16")
    eng = dict(precision="parity", device_batch=4, chunk_seconds=6.0, pipeline="fused")
    det = Detector(Config().with_engine(**eng), state_dict=fixture_state_dict(0),
                   device="cpu")
    recorder = _StageRecorder(det)
    a = det.detect_file_streaming(p).avg_values
    det.detect_file_streaming(wp)
    first = recorder.stop()
    b = a.copy()
    b[7] = np.nextafter(b[7], np.float32(1))
    report = _wire_mismatch_report(det, (p, wp), (a, b), first)
    assert report.startswith("1 of ")
    assert "float32 wire grid vs first run equal" in report
    assert "int16 wire grid vs first run 1 of" in report
    for k in ("decoded", "resampled", "mel", "logits", "chunk grid"):
        assert f"second run, {k} (float32 wire vs int16 wire): equal" in report
    for line in ("float32 wire departs from its rerun at: none",
                 "float32 wire departs from the int16 wire's first run at: none",
                 "int16 wire departs from its rerun at: none"):
        assert "first run, " + line in report
    assert "'first forward of the detector': True" in report
    assert all(len(run[k]) > 0 for run in first for k in _StageRecorder.STAGES)
    moved = dict(first[0], logits=[z.copy() for z in first[0]["logits"]])
    moved["logits"][0].flat[3] = np.nextafter(moved["logits"][0].flat[3], np.float32(9))
    assert _first_departure(moved, first[0]).startswith("logits (1 of ")
    assert "ATen parallel backend" in report
    probe = _intra_op_fp_probe()
    assert probe["1+0.75ulp"] == [1.0] and probe["1+0.25ulp"] == [0.0]
    assert probe["-1-0.75ulp"] == [-1.0] and probe["denormal results flushed"] == 0
    mx = _mxcsr()
    assert mx is None or (mx >> 13) & 3 == 0


@pytest.mark.parametrize("offset", [4, 20, 36])
def test_the_wires_stay_bit_equal_with_a_misaligned_resampler(tmp_path, offset):
    """One suspect of the AIFF/WAV mismatch above, ruled out: each wire's
    engine holds its own resampling matrix, made by numpy, whose address
    modulo 64 bytes varies from process to process.  The float32 wire's
    matrix is moved to ``offset`` bytes past a 64-byte boundary; its grid
    stays bit-equal to the int16 wire's."""
    from softspoken_tpu_torch.engine.fused import get_fused_engine

    x = _sig(6 * 16000, 1, seed=4)
    p, wp = str(tmp_path / "x.aiff"), str(tmp_path / "x.wav")
    write_aiff(p, _i16(x), 16000)
    jwavio.write(wp, x, 16000, subtype="PCM_16")
    eng = dict(precision="parity", device_batch=4, chunk_seconds=6.0, pipeline="fused")
    det = Detector(Config().with_engine(**eng), state_dict=fixture_state_dict(0),
                   device="cpu")
    want = det.detect_file_streaming(wp).avg_values
    engine = get_fused_engine(det, 16000, "f32")
    w = engine.W
    base = torch.empty(w.numel() + 32, dtype=torch.float32)
    shift = (offset - base.data_ptr() % 64) % 64 // 4
    moved = base[shift: shift + w.numel()].view_as(w)
    moved.copy_(w)
    assert moved.data_ptr() % 64 == offset
    engine.W = moved
    try:
        got = det.detect_file_streaming(p).avg_values
    finally:
        engine.W = w
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pipeline", ["fused", "host"])
@pytest.mark.parametrize("sr", [16000, 44100])
def test_the_cpu_grid_does_not_depend_on_the_thread_count(tmp_path, sr, pipeline):
    """The cause of the two wires' rare mismatch under load: the parity grid
    on the CPU rounded differently with the intra-op thread team (the BLAS
    splits the mel product's and the 44.1 kHz resampler's reductions across
    its threads, and a 1×1 conv changes kernels on one thread).  With the
    summation orders fixed, 1, 2, 3 and 8 threads give one grid."""
    p = str(tmp_path / "x.wav")
    jwavio.write(p, _sig(3 * sr, 1, seed=4), sr, subtype="PCM_16")
    eng = dict(precision="parity", device_batch=4, chunk_seconds=6.0, pipeline=pipeline)
    det = Detector(Config().with_engine(**eng), state_dict=fixture_state_dict(0),
                   device="cpu")
    before = torch.get_num_threads()
    grids = []
    try:
        for n in (1, 2, 3, 8):
            torch.set_num_threads(n)
            grids.append(det.detect_file_streaming(p).avg_values)
    finally:
        torch.set_num_threads(before)
    for g in grids[1:]:
        np.testing.assert_array_equal(g, grids[0])


def test_the_two_wires_stay_bit_equal_under_a_competing_thread(tmp_path):
    """The AIFF (float32 wire) and WAV (int16 wire) grids, four times in one
    process, each time while a second thread runs its own detections and
    float32 matmuls under the TF32 guard: bit-equal every time, and equal to
    the first, unloaded run."""
    import threading

    x = _sig(6 * 16000, 1, seed=4)
    p, wp, other = (str(tmp_path / n) for n in ("x.aiff", "x.wav", "o.wav"))
    write_aiff(p, _i16(x), 16000)
    jwavio.write(wp, x, 16000, subtype="PCM_16")
    jwavio.write(other, _sig(9 * 16000, 1, seed=5), 16000, subtype="PCM_16")
    eng = dict(precision="parity", device_batch=4, chunk_seconds=6.0, pipeline="fused")
    det = Detector(Config().with_engine(**eng), state_dict=fixture_state_dict(0),
                   device="cpu")
    first = det.detect_file_streaming(wp).avg_values
    stop, errors = threading.Event(), []

    def compete():
        from softspoken_tpu_torch.ops import mel as melops

        det2 = Detector(Config().with_engine(**eng), state_dict=fixture_state_dict(1),
                        device="cpu")
        a = torch.randn(512, 512)
        try:
            while not stop.is_set():
                det2.detect_file_streaming(other)
                with melops.fp32_matmul():
                    (a @ a).sum()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    th = threading.Thread(target=compete)
    th.start()
    try:
        for _ in range(4):
            rc, rw = det.detect_file_streaming(p), det.detect_file_streaming(wp)
            np.testing.assert_array_equal(rc.avg_values, rw.avg_values)
            np.testing.assert_array_equal(rw.avg_values, first)
            assert rc.intervals == rw.intervals
    finally:
        stop.set()
        th.join(120)
    assert not errors
