"""The port's U-Net, BN folding and weight carry-over against the JAX package
(the Flax SpecUNet2D on fixture_variables(seed=0)) and tests/torch_ref.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softspoken_tpu import ckpt as jckpt
from softspoken_tpu.models import SpecUNet2D as FlaxUNet
from softspoken_tpu.models import fold_batch_norm
from softspoken_tpu_torch.ckpt import (fixture_state_dict, from_flax_variables,
                                       load_pth, model_keys)
from softspoken_tpu_torch.ckpt.convert import _kernel_to_torch
from softspoken_tpu_torch.models import build_model, fold_state_dict, param_count

import torch_ref

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_vars():
    return jax.device_get(jckpt.fixture_variables(seed=0))


@pytest.fixture(scope="module")
def mel():
    return np.random.default_rng(1).standard_normal((2, 128, 256)).astype(np.float32)


@pytest.fixture(scope="module")
def flax_out(jax_vars, mel):
    spec, mask = FlaxUNet(folded=False).apply(jax_vars, jnp.asarray(mel)[..., None])
    return np.asarray(spec), np.asarray(mask)


def test_fixture_state_dict_equals_jax():
    """Same numpy draws in the same order: bit-identical."""
    ours, theirs = fixture_state_dict(0), jckpt.fixture_state_dict(0)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_from_flax_variables_equals_fixture(jax_vars):
    got = from_flax_variables(jax_vars)
    want = model_keys(fixture_state_dict(0))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("folded", [False, True])
def test_unet_matches_flax_both_heads(jax_vars, mel, flax_out, folded):
    """float32 on both sides; 1e-4 covers conv summation order (measured
    ~2e-7)."""
    model = build_model(from_flax_variables(jax_vars), folded=folded)
    with torch.no_grad():
        spec, mask = model(torch.from_numpy(mel))
    assert spec.shape == (2, 2, 128, 256) and mask.shape == (2, 256)
    np.testing.assert_allclose(spec.numpy().transpose(0, 2, 3, 1), flax_out[0], atol=1e-4)
    np.testing.assert_allclose(mask.numpy(), flax_out[1], atol=1e-4)


@pytest.mark.parametrize("folded", [False, True])
def test_unet_matches_torch_ref(mel, folded):
    sd = fixture_state_dict(0)
    rspec, rmask = torch_ref.forward(sd, mel)
    with torch.no_grad():
        spec, mask = build_model(sd, folded=folded)(torch.from_numpy(mel))
    np.testing.assert_allclose(spec.numpy(), rspec, atol=1e-4)
    np.testing.assert_allclose(mask.numpy(), rmask[:, 0], atol=1e-4)


def test_mask_logits_is_the_forward_mask_head(mel):
    model = build_model(fixture_state_dict(0))
    x = torch.from_numpy(mel)
    with torch.no_grad():
        assert torch.equal(model.mask_logits(x), model(x)[1])


def test_param_count_is_the_reference_width():
    assert param_count(build_model(fixture_state_dict(0), folded=False)) == 1_713_555


def test_fold_equals_jax_fold(jax_vars):
    """Both fold in float64 and round once to float32: identical values."""
    ours = fold_state_dict(fixture_state_dict(0))
    theirs = fold_batch_norm(jax_vars)["params"]
    names = {"spec_output_conv.0": "spec_res", "mask_output_conv.0": "mask_res"}
    seqs = {"residual": "res_conv", "conv1": "conv1", "conv2": "conv2"}
    heads = {"spec_output_conv.1": "spec_conv", "conv_flatten": "conv_flatten",
             "mask_output_conv.1": "mask_conv"}
    n = 0
    for key, val in ours.items():
        prefix, leaf = key.rsplit(".", 1)
        if prefix in heads:
            node = theirs[heads[prefix]]
        else:
            blk, seq, _ = prefix.rsplit(".", 2)
            node = theirs[names.get(blk, blk)][seqs[seq]]
        want = node["bias"] if leaf == "bias" else _kernel_to_torch(np.asarray(node["kernel"]))
        np.testing.assert_array_equal(val.numpy(), want, err_msg=key)
        n += 1
    assert n == len(ours) == 12 * 3 * 2 + 3 * 2


def test_load_pth_reads_the_reference_layout(tmp_path, jax_vars):
    """A .pth written by the JAX package's torch-free exporter loads with
    torch.load(weights_only=True) into the reference key set."""
    p = str(tmp_path / "w.pth")
    jckpt.export_pth(p, jax_vars, epoch=7)
    sd, epoch = load_pth(p)
    assert epoch == 7
    want = model_keys(fixture_state_dict(0))
    assert set(sd) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(sd[k]), want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the card's channels-last plan (models/unet.py), held to the NCHW code on
# the CPU with the plain epilogues
# ---------------------------------------------------------------------------

from softspoken_tpu_torch.models import unet as U


@pytest.fixture(scope="module")
def model64():
    return build_model(fixture_state_dict(0)).double().prepare_nhwc()


def _to_nhwc_t(x):
    """(B, C, H, T) → the plan's transposed channels-last (B, C, T, H)."""
    return x.transpose(2, 3).contiguous(memory_format=torch.channels_last)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("name,cin,hw", [
    ("conv1_1", 1, (16, 24)), ("conv2_1", 32, (8, 12)), ("conv6", 256, (4, 6)),
    ("spec_output_conv.0", 32, (8, 8))])
def test_nhwc_block_plan_is_the_nchw_block_in_float64(model64, name, cin, hw):
    """conv2's bias plus the shortcut's in one epilogue, the transposed
    kernels, the bias-exact channel scales (an input scaled by ``in_scale``
    gives the output scaled by the returned scale), and conv1_1's im2col
    weights (9 taps zero-padded to 16, the shortcut on the centre tap)
    compute the NCHW block."""
    import copy

    block = copy.deepcopy(model64.get_submodule(name))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, cin) + hw))
    in_scale = None if cin == 1 else torch.from_numpy(1 + 0.004 * rng.standard_normal(cin))
    with torch.no_grad():
        out_scale = block.prepare_nhwc(in_scale, im2col=cin == 1)
        want = block(x)
        if cin == 1:
            xin = U.nhwc_im2col(x[:, 0], torch.float64)
        else:
            xin = _to_nhwc_t(x * in_scale.view(1, -1, 1, 1))
        got = block.forward_nhwc(xin, U.PlainEpilogues)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert (out_scale - 1).abs().max() <= 2.0 ** -8
    for b in (block.nhwc_b1, block.nhwc_b2r):
        assert torch.equal(b, b.to(torch.bfloat16).double())
    assert _rel(got.transpose(2, 3) / out_scale.view(1, -1, 1, 1), want) <= 1e-12


def test_nhwc_plan_is_the_nchw_forward_in_float64(model64, mel):
    """The whole plan (im2col input, transposed image, channel scales,
    index-free pooling, one-copy up-concat, conv_flatten as one GEMM) gives
    both heads of the NCHW forward."""
    x = torch.from_numpy(mel).double()
    with torch.no_grad():
        spec, mask = model64(x)
        c9 = model64._trunk(x)
        c9t = model64._trunk(x, ops=U.PlainEpilogues)
        got_mask = model64._mask_head(c9t, nhwc=True)
        block, conv = model64.spec_output_conv
        got_spec = torch.nn.functional.conv2d(block.forward_nhwc(c9t, U.PlainEpilogues),
                                              model64.nhwc_spec_w, conv.bias)
        got_spec = torch.relu(got_spec).transpose(2, 3)
        want_spec = torch.relu(conv(block(c9)))
        want_mask = model64._mask_head(c9)
    assert c9t.shape == (2, 32, 256, 128) and c9t.is_contiguous(memory_format=torch.channels_last)
    assert _rel(got_mask, want_mask) <= 1e-12 and _rel(want_mask, mask.double()) <= 1e-6
    assert _rel(got_spec, want_spec) <= 1e-12 and _rel(want_spec, spec.double()) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_nhwc_pool_and_up_cat_equal_the_nchw_ops(dtype):
    rng = np.random.default_rng(3)
    cl = torch.channels_last

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype).contiguous(memory_format=cl)

    x = draw((2, 12, 16, 24))
    x[0, 1, 2, 3] = float("nan")
    low = draw((2, 20, 8, 12))
    pooled = U.nhwc_pool(x)
    assert pooled.is_contiguous(memory_format=cl)
    assert torch.equal(pooled.nan_to_num(7.0), torch.nn.functional.max_pool2d(x, 2).nan_to_num(7.0))
    cat = U.nhwc_up_cat(x, low)
    assert cat.is_contiguous(memory_format=cl)
    assert torch.equal(cat.nan_to_num(7.0), torch.cat([x, U._up(low)], 1).nan_to_num(7.0))


def test_nhwc_im2col_holds_each_tap():
    img = torch.arange(2 * 4 * 5, dtype=torch.float32).reshape(2, 4, 5) + 1
    x = U.nhwc_im2col(img, torch.float32)                            # (2, 16, 5, 4)
    assert x.shape == (2, U.NHWC_IN_CHANNELS, 5, 4)
    padded = torch.nn.functional.pad(img, (1, 1, 1, 1))
    for dt in range(3):
        for dh in range(3):
            want = padded[:, dh: dh + 4, dt: dt + 5].transpose(1, 2)
            assert torch.equal(x[:, 3 * dt + dh], want)
    assert not x[:, 9:].any()


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "train"])
def test_prepared_model_on_the_cpu_runs_the_nchw_forward(mel, mode):
    """The plan never runs on the CPU: a prepared model's outputs are the
    unprepared one's, bit for bit, in float32, bfloat16 and training mode
    (dropout from one seed), and nothing counts ``batches_nhwc``."""
    from softspoken_tpu_torch.runtime.metrics import StageTimers, recording

    dtype = torch.bfloat16 if mode == "bfloat16" else torch.float32
    plain = build_model(fixture_state_dict(0))
    prepared = build_model(fixture_state_dict(0)).prepare_nhwc()
    outs = []
    timers = StageTimers()
    for m in (plain, prepared):
        m = m.to(dtype).train(mode == "train")
        gen = torch.Generator().manual_seed(5)
        torch.manual_seed(6)  # mask_logits' dropout in training mode
        with torch.no_grad(), recording(timers):
            outs.append(m(torch.from_numpy(mel), gen) + (m.mask_logits(torch.from_numpy(mel)),))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert "batches_nhwc" not in timers.counted()


def test_weights_digest_and_state_dict_are_those_without_the_plan():
    """The parent's digests of the committed trained checkpoint and of the
    fixture, in fast mode, so journals written before the plan still
    resume; the plan's buffers stay out of ``state_dict()``."""
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.engine.journal import variables_digest

    want = {None: "2fda79eebacb60b6", 0: "19e7cc14a99ed194"}
    for seed, digest in want.items():
        det = Detector(Config(), device="cpu",
                       state_dict=None if seed is None else fixture_state_dict(seed))
        assert det.weights_digest() == digest
        keys = list(det.model.state_dict())
        det.model.prepare_nhwc()
        assert list(det.model.state_dict()) == keys
        assert variables_digest(det.model.state_dict()) == digest


def test_nhwc_plan_follows_deep_copies_and_new_weights():
    """``parallel.MeshDetector``'s replicas are deep copies moved with
    ``.to``: they carry the plan in channels-last; a later
    ``load_state_dict`` rebuilds it from the new weights."""
    import copy

    m = build_model(fixture_state_dict(0)).prepare_nhwc()
    rep = copy.deepcopy(m).to(torch.bfloat16)
    assert rep.conv1_1.nhwc_ready and rep.conv2_1.nhwc_w1.dtype == torch.bfloat16
    assert rep.conv2_1.nhwc_w1.is_contiguous(memory_format=torch.channels_last)
    other = build_model(fixture_state_dict(1))
    m.load_state_dict(other.state_dict())
    want = other.conv2_1.conv2[0].bias.double() + other.conv2_1.residual[0].bias.double()
    assert torch.equal(m.conv2_1.nhwc_b2r, want.to(torch.bfloat16).float())
