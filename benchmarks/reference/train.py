"""The plain training step of the round-5 recipe, from the pools and the seed.

Per step, as the port's on-device synthetic trainer defines it:

  * draws from a ``torch.Generator`` seeded with seed + 1 on the device, in
    this order: speech and noise rows, the silence flags (20%), the SNRs;
    under the protected policy a confuser row for each row, which silent
    rows take with probability ``extras_silent_prob``, and a confuser SNR
    for speech rows that drew a confuser; a circular shift per row; then
    each augmentation's per-row parameters in the recipe's order;
  * the mix: the shifted speech times its silence flag, plus the noise
    scaled to the row's SNR against the speech's RMS (silent rows keep the
    noise's level); reverb (up to 4 exponentially weighted taps, applied in
    the frequency domain over a zero pad to 2^17), volume and a dB-linear
    gain ramp;
  * log-mel (``mel.LogMel``) of the mix, the speech and the scaled noise,
    the DFT's operands rounded as the recipe states (``mel_dft``: one bf16
    pass on the card), every sum in float32; the mask target is 1 in each frame where the speech's log-mel
    exceeds 1e-4 in any band, the spec target the speech's and the noise's
    log-mel;
  * SpecUNet_2D in training mode (``specunet.forward_train``, dropout masks
    from a generator seeded from (seed, step) by numpy's SeedSequence);
    loss = mean sigmoid BCE of the mask logits + mean squared error of the
    spec head; AdamW (lr, betas 0.9/0.999, eps 1e-8, weight decay 1e-4).

Float32 with TF32 off, but for the frontend's stated DFT precision.
Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import mel, quant, specunet
from .detect import no_tf32

SR = 22050
CLIP = 3 * SR
GAIN_RAMP_DB = (-18.0, 0.0)


def _uniform(g, lohi, shape):
    lo, hi = lohi
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device)


def draws(g: torch.Generator, B: int, n_speech: int, n_noise: int, recipe: dict) -> dict:
    si = torch.randint(0, n_speech, (B,), generator=g, device=g.device)
    ni = torch.randint(0, n_noise, (B,), generator=g, device=g.device)
    keep = (torch.rand((B, 1), generator=g, device=g.device) >= recipe["silence_prob"]).float()
    snr = _uniform(g, recipe["snr_db"], (B, 1))
    start = recipe.get("extras_start")
    if start is not None and 0 < start < n_noise:
        ni_extra = torch.randint(start, n_noise, (B,), generator=g, device=g.device)
        silent = keep[:, 0] < 0.5
        force = (torch.rand((B,), generator=g, device=g.device)
                 < recipe["extras_silent_prob"]) & silent
        ni = torch.where(force, ni_extra, ni)
        is_extra = (ni >= start)[:, None]
        snr_hi = _uniform(g, recipe["extras_snr_db"], (B, 1))
        snr = torch.where(is_extra & (keep > 0.5), snr_hi, snr)
    d = {"si": si, "ni": ni, "keep": keep, "snr_db": snr,
         "shift": torch.randint(0, CLIP, (B,), generator=g, device=g.device)}
    col = (B, 1)
    aug = {}
    for a in recipe["augment"]:
        if a == "add_reverb":
            aug[a] = {"level": _uniform(g, (0.2, 0.8), col),
                      "decay_time": _uniform(g, (0.2, 1.0), col),
                      "n_delays": torch.randint(1, 5, col, generator=g, device=g.device).float()}
        elif a == "reduce_volume":
            aug[a] = {"level": _uniform(g, (0.1, 0.99), col)}
        elif a == "gain_ramp":
            aug[a] = {"start_db": _uniform(g, GAIN_RAMP_DB, col),
                      "end_db": _uniform(g, GAIN_RAMP_DB, col)}
        else:
            raise ValueError(f"augmentation {a!r} is not in the reference")
    d["aug"] = aug
    return d


def _reverb(x: torch.Tensor, p: dict) -> torch.Tensor:
    B, n = x.shape
    nfft = 1 << (n - 1).bit_length()
    theta = 2.0 * math.pi * torch.fft.rfftfreq(nfft, device=x.device)
    taps = torch.arange(5, dtype=torch.float32, device=x.device)[None, :]
    live = (taps < p["n_delays"]).float()
    delay = (taps + 1.0) / torch.clamp(p["n_delays"], min=1.0) * SR * p["decay_time"]
    gain = torch.exp(-3.0 * taps / torch.clamp(p["n_delays"] - 1.0, min=1.0)) * live
    gain = gain / gain.sum(dim=1, keepdim=True)
    resp = (gain[..., None] * torch.exp(-1j * delay[..., None] * theta)).sum(dim=1)
    H = (1.0 - p["level"]) + p["level"] * resp
    y = torch.fft.irfft(torch.fft.rfft(F.pad(x, (0, nfft - n))) * H, n=nfft)
    return y[:, :n].float()


def batch(speech_pool, noise_pool, d: dict, recipe: dict, logmel) -> Dict[str, torch.Tensor]:
    speech, noise = speech_pool[d["si"]], noise_pool[d["ni"]]
    n = speech.shape[1]
    idx = (torch.arange(n, device=speech.device)[None, :] - d["shift"][:, None]) % n
    speech = speech.gather(1, idx) * d["keep"]
    sp_rms = torch.sqrt(torch.mean(speech ** 2, dim=1, keepdim=True) + 1e-12)
    nz_rms = torch.sqrt(torch.mean(noise ** 2, dim=1, keepdim=True) + 1e-12)
    gain = sp_rms / (nz_rms * 10.0 ** (d["snr_db"] / 20.0))
    noise = noise * torch.where(d["keep"] > 0, gain, torch.ones_like(gain))
    mix = speech + noise
    for a in recipe["augment"]:
        p = d["aug"][a]
        if a == "add_reverb":
            mix = _reverb(mix, p)
        elif a == "reduce_volume":
            mix = mix * p["level"]
        elif a == "gain_ramp":
            t = torch.linspace(0.0, 1.0, n, device=mix.device)[None, :]
            mix = mix * 10.0 ** ((p["start_db"] + (p["end_db"] - p["start_db"]) * t) / 20.0)
    m_speech = logmel(speech)
    return {"mel": logmel(mix), "mask": (m_speech > 1e-4).any(dim=1).float(),
            "spec": torch.stack([m_speech, logmel(noise)], dim=1)}


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]))
    return g


def loss(params: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor], g, q=None):
    spec, logits = specunet.forward_train(b["mel"], params, g, q)
    return (F.binary_cross_entropy_with_logits(logits, b["mask"])
            + torch.mean((spec - b["spec"]) ** 2))


class Trainer:
    """The reference's steps from ``init`` (a state dict of float32
    leaves on the device) over the pools, seeded as the recipe's trainer."""

    def __init__(self, init: Dict[str, torch.Tensor], pools: Tuple[torch.Tensor, torch.Tensor],
                 recipe: dict, seed: int):
        self.recipe = recipe
        self.seed = seed
        self.pools = pools
        dev = pools[0].device
        self.params = {k: v.detach().clone().float().requires_grad_(True)
                       for k, v in init.items() if k in specunet.param_shapes()}
        self.opt = torch.optim.AdamW(list(self.params.values()), lr=recipe["lr"],
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=recipe["weight_decay"])
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed + 1)
        # the frontend's DFT in the precision the recipe states for it
        self.logmel = mel.LogMel(dev, quant.PRECISIONS[recipe["mel_dft"]])
        self.step = 0

    def run(self, steps: int) -> Sequence[dict]:
        """``steps`` steps; per step its loss and every leaf's gradient."""
        out = []
        sp, nz = self.pools
        with no_tf32():
            for _ in range(steps):
                with torch.no_grad():
                    d = draws(self.gen, self.recipe["batch_size"], sp.shape[0], nz.shape[0],
                              self.recipe)
                    b = batch(sp, nz, d, self.recipe, self.logmel)
                g = dropout_generator(self.seed, self.step, sp.device)
                value = loss(self.params, b, g)
                self.opt.zero_grad(set_to_none=True)
                value.backward()
                out.append({"loss": float(value.detach()),
                            "grads": {k: p.grad.detach().clone() for k, p in self.params.items()}})
                self.opt.step()
                self.step += 1
        return out
