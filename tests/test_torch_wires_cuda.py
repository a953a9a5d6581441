"""The lossy upload wires on the card: the mu-law device decode on every
code, and detect under each wire with its decode launched once per chunk
(K3 for adpcm4, bit-equal to its plain version on the main path's own
first chunk and run to run).

Card only (K1 and K3 have no CPU mode); the command is in
tests/test_torch_cuda.py's docstring.  The wires' quality is in
tests/test_torch_quality_cuda.py, their routing on the CPU in
tests/test_torch_wires.py.
"""

import numpy as np
import pytest
import torch

from torch_cuda_helpers import counted_detect, field_wav, need_card

pytestmark = pytest.mark.cuda


def test_mulaw_device_decode_on_every_code():
    """All 256 codes: the card's decode within 2 float32 ulp of the same
    formula on the CPU (which tests/test_torch_wires.py holds to 2 ulp of
    the JAX one), and no farther from the float64 ``decode_host`` than that
    formula is (up to 6 ulp: expm1 magnifies the rounding of its argument
    by up to |x| = 5.5)."""
    need_card()
    from softspoken_tpu_torch.ops import mulaw

    q = np.arange(-128, 128, dtype=np.int8)
    got = mulaw.decode_device(torch.from_numpy(q).cuda()).cpu().numpy()
    cpu = mulaw.decode_device(torch.from_numpy(q)).numpy()
    want = mulaw.decode_host(q)

    def ulps(a, b):
        return int(np.max(np.abs(a.view(np.int32).astype(np.int64)
                                 - b.view(np.int32).astype(np.int64))))

    assert ulps(got, cpu) <= 2
    assert ulps(got, want) <= ulps(cpu, want)


@pytest.fixture(scope="module")
def wav400(tmp_path_factory):
    """Three default chunks (150 s) at 32 kHz."""
    need_card()  # before any work: the test skips without a card
    return field_wav(str(tmp_path_factory.mktemp("wires") / "field_400s.wav"), 400.0, 32000, 11)


@pytest.mark.parametrize("codec,decim", [("pcm16", "auto"), ("mulaw8", "auto"), ("mulaw8", "off"),
                                         ("adpcm4", "auto"), ("adpcm4", "off")],
                         ids=["pcm16", "mulaw8_auto", "mulaw8_off", "adpcm4_auto", "adpcm4_off"])
def test_each_wire_decodes_once_per_chunk(wav400, codec, decim):
    """Fixture weights, fast mode, warm: K1 runs and the grid is finite;
    K3 runs once a chunk on adpcm4 and never otherwise, its grid equals the
    warm-up run's bit for bit, and K3 on the first chunk's own wire equals
    its plain version; a decimated lossy wire goes through the native
    decimator."""
    need_card()
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.ckpt import fixture_state_dict
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.engine.fused import get_fused_engine
    from softspoken_tpu_torch.ops import adpcm

    det = Detector(Config().with_engine(upload_codec=codec, wire_decimate=decim),
                   state_dict=fixture_state_dict(0))
    captured, decode = [], adpcm.decode_device

    def spy(w, n):  # keeps the main path's first adpcm4 wire
        if not captured:
            captured.append((w.clone(), n))
        return decode(w, n)

    adpcm.decode_device = spy
    try:
        warm = det.detect_file_streaming(wav400)
    finally:
        adpcm.decode_device = decode
    res, _counted, launches, calls = counted_detect(det, wav400)
    (sr, kind), = sorted((k[0], k[1]) for k in det._engines)
    n_chunks = -(-res.num_windows // get_fused_engine(det, sr, kind).chunk_w)
    assert launches.get("frame_mel") and np.isfinite(res.avg_values).all()
    assert launches.get("adpcm_decode", 0) == (n_chunks if kind == "adpcm4" else 0)
    if kind in ("mulaw8", "adpcm4") and decim == "auto":
        assert calls.get("fir_decim_i16")
    if kind == "adpcm4":
        np.testing.assert_array_equal(res.avg_values, warm.avg_values)
        wire, n = captured[0]
        got = adpcm.decode_device(wire, n)
        torch.cuda.synchronize()
        assert torch.equal(got, adpcm.decode_device_ref(wire, n))
