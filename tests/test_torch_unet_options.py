"""The U-Net's two inference options, ``decoder_upsample="phase"`` and
``conv_impl="packed"``, on the port, held to the JAX module
(``softspoken_tpu/models/unet.py``) as ``tests/test_model.py:101-200`` holds
the JAX ones.

In the JAX package both options compute the same function as concat/direct
another way, with the same parameters.  The port accepts their values and
computes concat/direct for each (both ran slower on the card; ROADMAP.md
§3), so a port grid with an option is bit-equal to its concat/direct grid.
Against the JAX module *with* the option and the same carried-across
weights: float32 to 1e-4 (conv summation order, as
``tests/test_torch_model.py``), bfloat16 fast mode to 2e-3 on the logits
(two bf16 ulps at their scale, 0.127).  A parity-mode ``Detector`` with each
option gives the JAX package's fused intervals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softspoken_tpu import Config as JConfig
from softspoken_tpu import ckpt as jckpt
from softspoken_tpu.engine import Detector as JDetector
from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu.models import SpecUNet2D as FlaxUNet
from softspoken_tpu.models import fold_batch_norm
from softspoken_tpu_torch import Config
from softspoken_tpu_torch.ckpt import fixture_state_dict, from_flax_variables
from softspoken_tpu_torch.engine import Detector
from softspoken_tpu_torch.models import build_model

torch.set_num_threads(2)

OPTIONS = [("phase", "direct"), ("concat", "packed"), ("phase", "packed")]
IDS = ["phase", "packed", "phase+packed"]


@pytest.fixture(scope="module")
def mel():
    return np.random.default_rng(9).uniform(0.0, 1.5, (1, 128, 256)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_vars():
    return jax.device_get(jckpt.fixture_variables(seed=3))


@pytest.mark.parametrize("du, ci", OPTIONS, ids=IDS)
def test_options_match_the_jax_module_float32(jax_vars, mel, du, ci):
    model = build_model(from_flax_variables(jax_vars))
    with torch.no_grad():
        spec, mask = model(torch.from_numpy(mel))
    jspec, jmask = FlaxUNet(folded=True, decoder_upsample=du, conv_impl=ci).apply(
        fold_batch_norm(jax_vars), jnp.asarray(mel)[..., None])
    np.testing.assert_allclose(mask.numpy(), np.asarray(jmask), atol=1e-4)
    np.testing.assert_allclose(spec.numpy().transpose(0, 2, 3, 1), np.asarray(jspec),
                               atol=1e-4)


@pytest.mark.parametrize("du, ci", [("concat", "direct")] + OPTIONS,
                         ids=["concat+direct"] + IDS)
def test_options_match_the_jax_module_bfloat16(jax_vars, mel, du, ci):
    model = build_model(from_flax_variables(jax_vars)).to(torch.bfloat16)
    with torch.no_grad():
        mask = model.mask_logits(torch.from_numpy(mel))
    _, jmask = FlaxUNet(folded=True, compute_dtype=jnp.bfloat16, decoder_upsample=du,
                        conv_impl=ci).apply(fold_batch_norm(jax_vars),
                                            jnp.asarray(mel)[..., None])
    jmask = np.asarray(jmask, np.float32)
    assert 0.05 < np.abs(jmask).max() < 0.25  # the scale the tolerance is set for
    np.testing.assert_allclose(mask.float().numpy(), jmask, atol=2e-3)


@pytest.mark.parametrize("knob, value", [("decoder_upsample", "shuffle"),
                                         ("conv_impl", "winograd")])
def test_an_unknown_option_value_raises(knob, value):
    with pytest.raises(ValueError, match=knob):
        Detector(Config().with_engine(precision="parity", **{knob: value}),
                 state_dict=fixture_state_dict(0), device="cpu")


@pytest.mark.parametrize("du, ci", OPTIONS, ids=IDS)
def test_parity_detector_with_each_option_gives_the_jax_intervals(tmp_path, du, ci):
    rng = np.random.default_rng(4)
    sr = 16000
    x = 0.02 * rng.standard_normal(7 * sr)
    x[2 * sr: 4 * sr] += 0.4 * np.sin(2 * np.pi * 600 * np.arange(2 * sr) / sr)
    p = str(tmp_path / "o.wav")
    jwavio.write(p, x.astype(np.float32), sr, subtype="PCM_16")
    eng = dict(precision="parity", device_batch=4, chunk_seconds=6.0, pipeline="fused",
               decoder_upsample=du, conv_impl=ci)
    det = Detector(Config().with_engine(**eng), state_dict=fixture_state_dict(0),
                   device="cpu")
    got = det.detect_file_streaming(p)
    base = Detector(Config().with_engine(**{**eng, "decoder_upsample": "auto",
                                            "conv_impl": "auto"}),
                    state_dict=fixture_state_dict(0), device="cpu").detect_file_streaming(p)
    ref = JDetector(JConfig().with_engine(**eng),
                    variables=jckpt.fixture_variables(seed=0)).detect_file_fused(p)
    np.testing.assert_allclose(got.avg_values, ref.avg_values, atol=1e-5)
    assert got.intervals == ref.intervals == base.intervals
    np.testing.assert_array_equal(got.avg_values, base.avg_values)
