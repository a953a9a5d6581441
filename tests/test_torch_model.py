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
