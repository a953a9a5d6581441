"""Shared helpers of the training parity tests (tests/test_torch_train*.py):
the JAX synthesizer's draws in the port's layout, and one loss + gradient
evaluation on each side.

Dropout is random in both packages: the JAX side runs with
``flax.linen.Dropout`` replaced by a pass-through (here only, while the
function traces) and the port with ``dropout_p=0``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softspoken_tpu.models import SpecUNet2D as FlaxUNet
from softspoken_tpu.train import device_data as jdd
from softspoken_tpu.train import loop as jloop
from softspoken_tpu.train.augment import PARAM_RANGES as J_PARAM_RANGES
from softspoken_tpu_torch.ckpt import from_flax_variables
from softspoken_tpu_torch.models import load_unfolded
from softspoken_tpu_torch.models.unet import SpecUNet2D
from softspoken_tpu_torch.train import loop as tloop

CLIP = 66150


class NoDropout:
    """Stands in for ``flax.linen.Dropout``: the identity."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, x):
        return x


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t.to(dtype) if dtype is not None else t


def jax_aug_params(k_aug, augs, B):
    """Each augmentation's parameters as JAX's ``make_device_augment_fn``
    draws them from ``k_aug`` (``fold_in`` on the augmentation's index in
    ``_DEVICE_AUGS``, then its ``u()`` calls)."""
    out = {}
    for a in augs:
        k = jax.random.fold_in(k_aug, jdd._DEVICE_AUGS.index(a))

        def u(kk, lohi, shape=(B, 1)):
            return jax.random.uniform(kk, shape, minval=lohi[0], maxval=lohi[1])

        if a == "change_pitch":
            p = {"semitones": u(k, (-3.0, 3.0), (B,))}
        elif a == "reduce_volume":
            p = {"level": u(k, (0.1, 0.99))}
        elif a == "gain_ramp":
            k1, k2 = jax.random.split(k)
            r = J_PARAM_RANGES["gain_ramp"]
            p = {"start_db": u(k1, r["start_db"]), "end_db": u(k2, r["end_db"])}
        elif a == "add_harmonic_distortion":
            p = {"k": u(k, (10.0, 50.0))}
        elif a == "compress_dynamics":
            k1, k2 = jax.random.split(k)
            p = {"ratio": u(k1, (1.5, 6.0)), "threshold_db": u(k2, (-40.0, -10.0))}
        elif a == "add_reverb":
            k1, k2, k3 = jax.random.split(k, 3)
            p = {"level": u(k1, (0.2, 0.8)), "decay_time": u(k2, (0.2, 1.0)),
                 "n_delays": jax.random.randint(k3, (B, 1), 1, 5).astype(jnp.float32)}
        elif a == "add_echo":
            k1, k2 = jax.random.split(k)
            p = {"delay_s": u(k1, (0.1, 0.7)), "decay": u(k2, (0.3, 0.7))}
        else:
            k1, k2 = jax.random.split(k)
            p = {"low_hz": u(k1, (100.0, 500.0)), "high_hz": u(k2, (600.0, 2500.0))}
        out[a] = {name: _t(v) for name, v in p.items()}
    return out


def jax_draws(key, B, n_speech, n_noise, augs=(), **mix_kw):
    """The draws of JAX ``make_synth_batch_fn(B, augs, **mix_kw)(…, key)``
    in the port's layout: ``sample_mix_rows`` splits the key, the roll is
    ``randint(k_roll)``, the augmentations draw from ``k_aug``."""
    mix_kw = {"snr_db_range": (-5.0, 20.0), "silence_prob": 0.2, **mix_kw}
    snr, sil = mix_kw.pop("snr_db_range"), mix_kw.pop("silence_prob")
    si, ni, keep, snr_db, k_roll, k_aug = jdd.sample_mix_rows(
        key, B, n_speech, n_noise, snr, sil, **mix_kw)
    return {"si": _t(si, torch.int64), "ni": _t(ni, torch.int64), "keep": _t(keep),
            "snr_db": _t(snr_db),
            "shift": _t(jax.random.randint(k_roll, (B,), 0, CLIP), torch.int64),
            "aug": jax_aug_params(k_aug, augs, B)}


def jax_batch(b):
    """Port layout (numpy) → the JAX trainer's NHWC batch."""
    return {"mel": jnp.asarray(b["mel"])[..., None], "mask": jnp.asarray(b["mask"]),
            "spec": jnp.asarray(b["spec"].transpose(0, 2, 3, 1))}


def port_model(variables, dropout_p=0.0) -> SpecUNet2D:
    """An unfolded float32 port model with the Flax variables' weights."""
    model = SpecUNet2D(folded=False, dropout_p=dropout_p)
    return load_unfolded(model, from_flax_variables(variables))


def jax_loss_and_grads(variables, batch, bw, compute_dtype=jnp.float32):
    """JAX ``loss_fn`` and its gradient, dropout as the identity.  With
    ``compute_dtype=jnp.float64`` the weights and the batch go in as
    float64 under ``jax.enable_x64``.  Returns (loss, metrics, gradients
    and new BN statistics in the reference state-dict layout)."""
    model = FlaxUNet(compute_dtype=compute_dtype)
    f64 = compute_dtype == jnp.float64
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(f64):
        mp.setattr(fnn, "Dropout", NoDropout)
        cast = (lambda a: np.asarray(a, np.float64)) if f64 else (lambda a: a)
        params = jax.tree.map(cast, variables["params"])
        stats = jax.tree.map(cast, variables["batch_stats"])
        jb = jax_batch({k: cast(v) for k, v in batch.items()})
        fn = jax.jit(jax.value_and_grad(
            lambda p, s, b: jloop.loss_fn(model, p, s, b, jax.random.PRNGKey(0), bw),
            has_aux=True))
        (loss, (new_stats, metrics)), grads = fn(params, stats, jb)
        out = jax.device_get((loss, metrics, grads, new_stats))
    loss, metrics, grads, new_stats = out
    tree = {"params": grads, "batch_stats": new_stats}
    sd = from_flax_variables(tree)
    if f64:
        # from_flax_variables rounds to float32: carry the float64 values
        # as float32 hi + lo parts (~48 bits) through the same layout
        lo = from_flax_variables(jax.tree.map(
            lambda a: np.asarray(a, np.float64) - np.asarray(a, np.float32), tree))
        sd = {k: sd[k].astype(np.float64) + lo[k] for k in sd}
    return float(loss), {k: float(v) for k, v in metrics.items()}, sd


def port_loss_and_grads(model, batch, bw, compute_dtype=torch.float32):
    """The port's ``loss_fn`` and its gradient in training mode; float64
    runs the model in float64."""
    if compute_dtype == torch.float64:
        model = model.double()
        tb = {k: torch.tensor(v, dtype=torch.float64) for k, v in batch.items()}
        ctx_dtype = torch.float32
    else:
        tb = {k: torch.tensor(v) for k, v in batch.items()}
        ctx_dtype = compute_dtype
    model.train()
    with tloop.autocast(torch.device("cpu"), ctx_dtype):
        loss, metrics = tloop.loss_fn(model, tb, bw)
    loss.backward()
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, grads


def rel_err(got, want):
    """max |got − want| over max |want|."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
