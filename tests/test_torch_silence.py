"""The port's silencer against the JAX package's: the same review CSV, read
by pandas for the JAX ``SilenceRunner`` and by the port's table for the
port's, gives equal ``SilenceReport`` fields and byte-identical
``*_silenced.wav`` files in zero and fade mode; the port's streaming path
writes the bytes of its in-memory path.  The files: a PCM16 mono WAV, a
24-bit stereo WAV, a 24-bit stereo FLAC, a corrupt file, a malformed row,
two recordings of one name in two folders, a file whose rows are all
kept, erase cells that need pandas' coercion and a row without a path.

The streaming path writes through ``WavWriter``, which reserves a 28-byte
``JUNK`` chunk for a possible RF64 promotion, so its files hold the
in-memory files' fmt chunk and sample bytes behind that one extra chunk
(the JAX package's files do the same).
"""

import os

import numpy as np
import pandas as pd
import pytest

import flac_ref
from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu.silence import SilenceRunner as JRunner
from softspoken_tpu.silence import write_status_file as jwrite_status
from softspoken_tpu_torch.io import wavio
from softspoken_tpu_torch.project import Table, read_csv
from softspoken_tpu_torch.silence import STATUS_FILENAME, SilenceRunner, write_status_file


@pytest.fixture(scope="module")
def review_csv(tmp_path_factory):
    root = tmp_path_factory.mktemp("silence")
    d1, d2 = root / "site1", root / "site2"
    d1.mkdir()
    d2.mkdir()
    rng = np.random.default_rng(7)
    jwavio.write(str(d1 / "mono16.wav"), rng.uniform(-0.9, 0.9, 16000 * 3).astype(np.float32),
                 16000, subtype="PCM_16")
    jwavio.write(str(d1 / "st24.wav"), rng.uniform(-0.9, 0.9, (44100 * 2, 2)).astype(np.float32),
                 44100, subtype="PCM_24")
    x24 = np.clip(np.rint(rng.normal(0, 0.2, (48000 * 2, 2)) * 2 ** 23),
                  -2 ** 23, 2 ** 23 - 1).astype(np.int64)
    flac_ref.write_flac(str(d1 / "st24.flac"), x24, 48000, bits=24)
    (d1 / "corrupt.wav").write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk")
    for d, seed in ((d1, 1), (d2, 2)):
        jwavio.write(str(d / "same.wav"),
                     np.random.default_rng(seed).uniform(-0.5, 0.5, 8000).astype(np.float32),
                     8000)
    jwavio.write(str(d1 / "kept.wav"), np.zeros(8000, np.float32), 8000)
    jwavio.write(str(d1 / "badrow.wav"), np.full(8000, 0.25, np.float32), 8000)
    rows = [
        # file_path, file_name, start, end, erase
        (d1, "mono16.wav", "0.5", "1.0", "1"),
        (d1, "mono16.wav", "0.9", "1.25", "1.0"),       # overlaps the one before
        (d1, "mono16.wav", "2.0", "2.5", "0"),          # kept
        (d1, "mono16.wav", "2.9", "99", " 1"),          # past the end
        (d1, "st24.wav", "-3.0", "0.25", "1"),          # before the start
        (d1, "st24.wav", "1.0", "1.5", "yes"),          # not a number: kept
        (d1, "st24.flac", "0.25", "0.75", "1"),
        (d1, "st24.flac", "1.5", "1.2", "1"),           # degenerate
        (d1, "corrupt.wav", "0.1", "0.2", "1"),
        (d2, "same.wav", "0.1", "0.3", "1"),
        (d1, "same.wav", "0.5", "0.7", "1"),
        (d1, "kept.wav", "0.1", "0.2", ""),
        (d1, "badrow.wav", "abc", "0.5", "1"),          # malformed time
        ("", "mono16.wav", "0.0", "3.0", "1"),          # no path: dropped
    ]
    csv = root / "review.csv"
    lines = ["ID,file_path,file_name,start_time,end_time,erase,user_comment,review_datetime"]
    lines += [f"{i + 1},{p},{n},{s},{e},\"{er}\",," for i, (p, n, s, e, er) in enumerate(rows)]
    csv.write_text("\n".join(lines) + "\n")
    return root, str(csv)


def _report(r, outdir):
    return (r.files_done, r.files_failed, r.stopped,
            [os.path.relpath(p, outdir) for p in r.outputs], r.errors)


def _chunks(data: bytes) -> dict:
    """A RIFF/WAVE file's chunks by id."""
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    out, pos = {}, 12
    while pos + 8 <= len(data):
        cid, size = data[pos:pos + 4], int.from_bytes(data[pos + 4:pos + 8], "little")
        out[cid] = data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)
    return out


def _files(outdir):
    return {f: open(os.path.join(outdir, f), "rb").read() for f in sorted(os.listdir(outdir))}


@pytest.mark.parametrize("fade_ms", [0.0, 20.0])
def test_silencer_byte_identical_to_jax(tmp_path, review_csv, fade_ms):
    _root, csv = review_csv
    out, jout, sout = (str(tmp_path / k) for k in ("port", "jax", "stream"))
    seen = []
    rep = SilenceRunner(out, fade_ms=fade_ms).run(
        read_csv(csv), on_file_start=seen.append, on_progress=seen.append)
    jrep = JRunner(jout, fade_ms=fade_ms).run(pd.read_csv(csv))
    assert _report(rep, out) == _report(jrep, jout)
    assert rep.files_done == 5 and rep.files_failed == 2
    assert sorted(os.path.basename(p) for p in rep.errors) == ["badrow.wav", "corrupt.wav"]
    assert seen[-1] == 100
    files = _files(out)
    assert sorted(files) == ["mono16_silenced.wav", "same_silenced.wav", "same_silenced_2.wav",
                             "st24_silenced.wav", "st24_silenced_2.wav"]
    assert files == _files(jout)
    srep = SilenceRunner(sout, fade_ms=fade_ms, stream_threshold_bytes=0,
                         chunk_frames=10007).run(read_csv(csv))
    jsout = str(tmp_path / "jax_stream")
    jsrep = JRunner(jsout, fade_ms=fade_ms, stream_threshold_bytes=0,
                    chunk_frames=10007).run(pd.read_csv(csv))
    assert _report(srep, sout) == _report(rep, out) == _report(jsrep, jsout)
    streamed = _files(sout)
    assert streamed == _files(jsout)
    assert sorted(streamed) == sorted(files)
    for name, data in streamed.items():
        a, b = _chunks(data), _chunks(files[name])
        assert list(a) == [b"JUNK", b"fmt ", b"data"] and list(b) == [b"fmt ", b"data"]
        assert a[b"fmt "] == b[b"fmt "] and a[b"data"] == b[b"data"]
        assert len(data) == len(files[name]) + 36


def test_erased_spans_are_zero_and_the_rest_is_the_input(tmp_path, review_csv):
    root, csv = review_csv
    SilenceRunner(str(tmp_path)).run(read_csv(csv))
    x, sr = wavio.read(str(root / "site1" / "mono16.wav"))
    y, _ = wavio.read(str(tmp_path / "mono16_silenced.wav"))
    mask = np.zeros(len(x), bool)
    for st, et in ((0.5, 1.0), (0.9, 1.25), (2.9, 99.0)):
        mask[int(np.rint(st * sr)):int(np.rint(et * sr))] = True
    assert np.all(y[mask] == 0) and np.array_equal(y[~mask], x[~mask])


def test_no_erase_rows_and_a_part_of_the_table(tmp_path, review_csv):
    _root, csv = review_csv
    t = read_csv(csv)
    keep = Table(t.columns, [r for r in t.rows if r["file_name"] == "kept.wav"])
    assert _report(SilenceRunner(str(tmp_path / "a")).run(keep), "") == (0, 0, False, [], {})
    assert not os.path.exists(tmp_path / "a")
    jrep = JRunner(str(tmp_path / "b")).run(pd.read_csv(csv).iloc[11:12])
    assert _report(jrep, "") == (0, 0, False, [], {})
    rep = SilenceRunner(str(tmp_path / "c")).run(Table(t.columns, t.rows[:2]))
    assert rep.files_done == 1


def test_cooperative_stop_like_jax(tmp_path, review_csv):
    _root, csv = review_csv
    r, jr = SilenceRunner(str(tmp_path / "p")), JRunner(str(tmp_path / "j"))
    r.stop()
    jr.stop()
    assert _report(r.run(read_csv(csv)), "") == _report(jr.run(pd.read_csv(csv)), "") \
        == (0, 0, True, [], {})


def test_status_file_like_jax(tmp_path):
    a, b = {"name": "p"}, {"name": "p"}
    pa = write_status_file(a, str(tmp_path))
    with open(pa) as f:
        text = f.read()
    pb = jwrite_status(b, str(tmp_path))
    assert pa == pb == str(tmp_path / STATUS_FILENAME) and a == b
    assert open(pb).read() == text == "complete\n"
