"""Mesh training on the CPU over gloo (``parallel/grid.py``, the sharded
steps of ``train/loop.py`` and ``train/device_data.py``, ``fit(mesh=)``,
``fit_synthetic(mesh=)``, ``train --mesh``): each sharded step against the
port's unsharded step on the global batch and, for ``make_sharded_train_step``,
against the JAX package's on a (2, 2) mesh of the conftest's virtual CPU
devices under ``jax.enable_x64``.

The ranks run as fresh processes (tests/torch_parallel_worker.py).  The
step parities run in float64, where the only differences are reduction
orders; float32 runs are held with tests/test_torch_train_fused.py's rule
for Adam, whose first update is ±lr for every element whose gradient is
not within rounding of 0.
"""

import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from softspoken_tpu import ckpt as jckpt
from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu.models import SpecUNet2D as FlaxUNet
from softspoken_tpu.parallel import make_mesh as jmake_mesh
from softspoken_tpu.train import loop as jloop
from softspoken_tpu_torch import cli
from softspoken_tpu_torch.ckpt import from_flax_variables, load_pth
from softspoken_tpu_torch.models.unet import BatchNorm2d, SpecUNet2D
from softspoken_tpu_torch.parallel import make_mesh
from softspoken_tpu_torch.train import device_data as tdd
from softspoken_tpu_torch.train import loop as tloop
from softspoken_tpu_torch.train import synth as tsynth
from softspoken_tpu_torch.train.fit import fit, fit_synthetic

from torch_parallel_worker import run_ranks
from torch_train_ref import NoDropout, port_model, rel_err

torch.set_num_threads(2)

LR = 1e-3


def adam_close(got: dict, want: dict, before: dict, lr: float = LR) -> None:
    """tests/test_torch_train_fused.py's rule: every element moves within
    4·lr of the reference's movement, at most 0.5% of them by more than
    0.5·lr and at most 5% by more than 0.1·lr."""
    n = off_half = off_tenth = 0
    for k, w in want.items():
        if "running" in k or "num_batches" in k:
            continue
        b = np.asarray(before[k], np.float64)
        d = np.abs((np.asarray(got[k], np.float64) - b) - (np.asarray(w, np.float64) - b))
        assert d.max() <= 4 * lr, k
        n += d.size
        off_half += int((d > 0.5 * lr).sum())
        off_tenth += int((d > 0.1 * lr).sum())
    assert n > 0 and off_half <= 0.005 * n and off_tenth <= 0.05 * n, (off_half, off_tenth, n)


# ---------------------------------------------------------------------------
# layouts and the halo convolution

@pytest.mark.parametrize("shard_time", [True, False])
@pytest.mark.parametrize("axes,shape", [(("data", "seq"), (2, 2)), (("data",), (4,))])
def test_batch_partition_specs_are_jaxs_in_the_ports_layout(shard_time, axes, shape):
    """JAX's specs (NHWC: mel (B, 128, T, 1), spec (B, 128, T, 2)) carried to
    the port's layout (mel (B, 128, T), spec (B, 2, 128, T))."""
    j = jloop.batch_partition_specs(jmake_mesh(axes, shape=shape, devices=jax.devices()[:4]),
                                    shard_time)
    t = tloop.batch_partition_specs(make_mesh(axes, shape=shape, devices=["cpu"] * 4),
                                    shard_time)
    assert t["mel"] == tuple(j["mel"])[:3]
    assert t["mask"] == tuple(j["mask"])
    js = tuple(j["spec"])
    assert t["spec"] == (js[0], js[3], js[1], js[2])


@pytest.mark.parametrize("world", [2, 3])
def test_halo_convolution_matches_the_unsplit_convolution(tmp_path, world):
    """A 3×3 and a kernel-3 1-D convolution with their time axis split over
    `world` ranks (float64): each rank's output block, input gradient block
    and summed weight gradients equal the unsplit convolution's to 1e-12."""
    rng = np.random.default_rng(3)
    shapes = {"2d": ((2, 3, 5, 12), (4, 3, 3, 3)), "1d": ((2, 3, 12), (4, 3, 3))}
    inputs, ref = {}, {}
    for name, (xs, ws) in shapes.items():
        x, w = torch.tensor(rng.normal(size=xs)), torch.tensor(rng.normal(size=ws))
        b = torch.tensor(rng.normal(size=ws[0]))
        conv = (torch.nn.Conv2d if name == "2d" else torch.nn.Conv1d)(3, 4, 3, padding=1).double()
        conv.weight.data.copy_(w)
        conv.bias.data.copy_(b)
        xr = x.clone().requires_grad_(True)
        y = conv(xr)
        gout = torch.tensor(rng.normal(size=tuple(y.shape)))
        (y * gout).sum().backward()
        inputs.update({f"{name}_x": x, f"{name}_w": w, f"{name}_b": b, f"{name}_gout": gout})
        ref[name] = (y.detach(), xr.grad, conv.weight.grad, conv.bias.grad)
    torch.save(inputs, tmp_path / "inputs.pt")
    outs = run_ranks("halo", world, tmp_path, timeout=120)
    for name, (y, dx, dw, db) in ref.items():
        got_y = torch.cat([o[f"{name}_y"] for o in outs], dim=-1)
        got_dx = torch.cat([o[f"{name}_dx"] for o in outs], dim=-1)
        torch.testing.assert_close(got_y, y, rtol=0, atol=1e-12)
        torch.testing.assert_close(got_dx, dx, rtol=0, atol=1e-12)
        torch.testing.assert_close(sum(o[f"{name}_dw"] for o in outs), dw, rtol=0, atol=1e-12)
        torch.testing.assert_close(sum(o[f"{name}_db"] for o in outs), db, rtol=0, atol=1e-12)


def test_sharded_batchnorm_matches_the_unsharded_at_a_large_mean(tmp_path):
    """Float32 activations whose mean is 10^4 times their spread (channel
    means 1e4, -3e3, 0.5; unit spread), the rows split over 2 ranks: the
    statistics merged over the ranks give the unsharded BatchNorm's output,
    gradients and running statistics.  A one-pass E[x²] − mean² variance
    loses every digit here (float32 spacing at 1e8 is 8)."""
    rng = np.random.default_rng(9)
    means = np.array([1e4, -3e3, 0.5], np.float32).reshape(1, 3, 1, 1)
    x = torch.tensor((rng.normal(size=(4, 3, 5, 16)) + means).astype(np.float32))
    w = torch.tensor(rng.uniform(0.5, 1.5, 3).astype(np.float32))
    b = torch.tensor(rng.normal(size=3).astype(np.float32))
    gout = torch.tensor(rng.normal(size=(4, 3, 5, 16)).astype(np.float32))
    bn = BatchNorm2d(3)
    bn.weight.data.copy_(w)
    bn.bias.data.copy_(b)
    xr = x.clone().requires_grad_(True)
    y = bn(xr)
    (y * gout).sum().backward()
    torch.save({"x": x, "w": w, "b": b, "gout": gout}, tmp_path / "inputs.pt")
    outs = run_ranks("batchnorm", 2, tmp_path, timeout=120)
    # x's own float32 spacing at 1e4 is 1e-3 of the unit spread (measured
    # here: y 1.5e-4, dx 1.3e-5, dw and db 3e-6, running statistics equal)
    torch.testing.assert_close(torch.cat([o["y"] for o in outs]), y.detach(),
                               rtol=0, atol=1e-3)
    torch.testing.assert_close(torch.cat([o["dx"] for o in outs]), xr.grad, rtol=0, atol=1e-4)
    torch.testing.assert_close(sum(o["dw"] for o in outs), bn.weight.grad, rtol=0, atol=1e-4)
    torch.testing.assert_close(sum(o["db"] for o in outs), bn.bias.grad, rtol=0, atol=1e-4)
    for o in outs:
        torch.testing.assert_close(o["running_mean"], bn.running_mean, rtol=1e-6, atol=0)
        torch.testing.assert_close(o["running_var"], bn.running_var, rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# make_sharded_train_step at data 2 × seq 2

@pytest.fixture(scope="module")
def jax_vars():
    return jax.device_get(jckpt.fixture_variables(seed=0))


def _batch(B=2, T=64, seed=4):
    rng = np.random.default_rng(seed)
    toggles = rng.uniform(size=(B, T)) > 0.9
    return {"mel": rng.uniform(0.0, 1.5, (B, 128, T)),
            "mask": (np.cumsum(toggles, axis=1) % 2).astype(np.float64),
            "spec": rng.uniform(0.0, 1.0, (B, 2, 128, T))}


def _sd64(tree):
    """A Flax tree → the reference state-dict layout in float64
    (``from_flax_variables`` rounds to float32: the float32 part plus the
    rest, as tests/torch_train_ref.py does)."""
    hi = from_flax_variables(tree)
    lo = from_flax_variables(jax.tree.map(
        lambda a: np.asarray(a, np.float64) - np.asarray(a, np.float32), tree))
    return {k: hi[k].astype(np.float64) + lo[k] for k in hi}


def _jax_sharded_step(jax_vars, batch, bw):
    """JAX make_sharded_train_step on a (2, 2) data × seq mesh of 4 virtual
    CPU devices, float64, dropout as the identity."""
    mesh = jmake_mesh(("data", "seq"), shape=(2, 2), devices=jax.devices()[:4])
    tx = optax.adamw(LR, weight_decay=1e-4)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(fnn, "Dropout", NoDropout)
        f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
        params = jax.tree.map(f64, jax_vars["params"])
        stats = jax.tree.map(f64, jax_vars["batch_stats"])
        state = jloop.TrainState(params, stats, tx.init(params), jnp.asarray(0, jnp.int32))
        step, shardings = jloop.make_sharded_train_step(FlaxUNet(compute_dtype=jnp.float64),
                                                        tx, mesh, boundary_weight=bw)
        jb = {"mel": batch["mel"][..., None], "mask": batch["mask"],
              "spec": batch["spec"].transpose(0, 2, 3, 1)}
        jb = {k: jax.device_put(v, shardings[k]) for k, v in jb.items()}
        with mesh:
            new, metrics = step(state, jb, jax.random.PRNGKey(1))
        out = jax.device_get((new.params, new.batch_stats, new.opt_state[0], metrics))
    params, stats, adam, metrics = out
    return (_sd64({"params": params, "batch_stats": stats}),
            _sd64({"params": adam.mu, "batch_stats": stats}),
            _sd64({"params": adam.nu, "batch_stats": stats}),
            {k: float(v) for k, v in metrics.items()})


def test_sharded_train_step_equals_unsharded_and_jax(tmp_path, jax_vars):
    """One step at data 2 × seq 2 (B = 2, T = 64, boundary weight 2, dropout
    off), float64: loss, parameters, BatchNorm statistics and AdamW moments
    equal the port's unsharded step to 1e-9 (measured ~1e-11), identical on
    every rank; against JAX's sharded step, tests/test_torch_train.py's
    tolerances (loss 1e-6 relative, BN statistics 1e-6, first moments 1e-5
    of each tensor's max like its gradients) and the Adam rule for the
    parameters."""
    batch = _batch()
    bw = 2.0
    model = port_model(jax_vars).double()
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save({"state_dict": sd0, "lr": LR, "seed": 0, "dropout_p": 0.0, "bw": bw,
                "batch": {k: torch.tensor(v) for k, v in batch.items()}}, tmp_path / "inputs.pt")
    outs = run_ranks("train_step", 4, tmp_path)

    state = tloop.TrainState(model, tloop.make_optimizer(model, LR))
    m = tloop.train_step(state, {k: torch.tensor(v) for k, v in batch.items()}, bw)
    ref = {k: v.numpy() for k, v in model.state_dict().items()}
    names = dict((id(p), n) for n, p in model.named_parameters())
    moments = {f"{key}.{names[id(p)]}": st[key].numpy()
               for p, st in state.optimizer.state.items() for key in ("exp_avg", "exp_avg_sq")}
    for o in outs:
        assert int(o["step"]) == 1
        for k in ("loss", "mask_loss", "spec_loss"):
            assert abs(float(o["metrics"][k]) - float(m[k])) <= 1e-9 * abs(float(m[k])), k
        for k, v in ref.items():
            np.testing.assert_allclose(o["sd"][k].numpy(), v, rtol=0, atol=1e-9, err_msg=k)
        for k, v in moments.items():
            np.testing.assert_allclose(o[k].numpy(), v, rtol=0, atol=1e-9, err_msg=k)
    for k in ref:
        assert torch.equal(outs[0]["sd"][k], outs[3]["sd"][k]), k

    want, mu, nu, jm = _jax_sharded_step(jax_vars, batch, bw)
    got = {k: v.numpy() for k, v in outs[0]["sd"].items()}
    for k in ("loss", "mask_loss", "spec_loss"):
        assert abs(float(outs[0]["metrics"][k]) - jm[k]) <= 1e-6 * abs(jm[k]), k
    n_stats = 0
    for k, w in want.items():
        if "running" in k:
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-9, err_msg=k)
            n_stats += 1
        else:
            assert rel_err(outs[0]["exp_avg." + k].numpy(), mu[k]) <= 1e-5, k
            assert rel_err(outs[0]["exp_avg_sq." + k].numpy(), nu[k]) <= 1e-5, k
    assert n_stats == 2 * 36
    adam_close(got, want, {k: v.numpy() for k, v in sd0.items()})


def test_sharded_fused_step_equals_unsharded(tmp_path):
    """Two inner steps of make_sharded_fused_train_step at data 2 × seq 2
    (B = 4, two augmentations, dropout 0.1, float64 model): every rank
    draws the whole batch and synthesizes its two rows; parameters and BN
    statistics equal make_fused_train_step's to 1e-7 (measured ~4e-10),
    the metrics to 1e-6 relative (float32, as the model's outputs).  Two
    rows a rank synthesize bit-equal to the whole batch's rows on the CPU;
    one row a rank does not (the CPU FFT of a single row rounds otherwise,
    and the compressed mel of the augmented mix moves by up to 1e-4 near
    silence), so the rows are not one a rank here."""
    torch.manual_seed(0)
    model = SpecUNet2D(folded=False, dropout_p=0.1).double()
    sp, nz = tsynth.make_pools(np.random.default_rng(0), 3, 3)
    augs = ("add_reverb", "reduce_volume")
    torch.save({"state_dict": {k: v.clone() for k, v in model.state_dict().items()}, "lr": LR,
                "seed": 5, "dropout_p": 0.1, "batch_size": 4, "augs": augs, "n_inner": 2,
                "gen_seed": 7, "speech": torch.from_numpy(sp), "noise": torch.from_numpy(nz)},
               tmp_path / "inputs.pt")
    outs = run_ranks("fused_step", 4, tmp_path)
    state = tloop.TrainState(model, tloop.make_optimizer(model, LR), seed=5)
    fused = tdd.make_fused_train_step(tdd.make_synth_batch_fn(4, augs), n_inner=2)
    gen = torch.Generator()
    gen.manual_seed(7)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' thread count: the mels' CPU products follow it
    try:
        m = fused(state, torch.from_numpy(sp), torch.from_numpy(nz), gen)
    finally:
        torch.set_num_threads(threads)
    for o in outs:
        assert int(o["step"]) == 2
        for k in m:
            assert abs(float(o["metrics"][k]) - float(m[k])) <= 1e-6 * abs(float(m[k])), k
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(o["sd"][k].numpy(), v.numpy(), rtol=0, atol=1e-7,
                                       err_msg=k)


def test_slice_draws_cuts_every_row_tensor():
    synth = tdd.make_synth_batch_fn(4, ("add_reverb", "gain_ramp"))
    gen = torch.Generator()
    gen.manual_seed(0)
    draws = synth.draw(gen, 3, 3)
    part = tdd.slice_draws(draws, slice(2, 4))
    assert torch.equal(part["si"], draws["si"][2:])
    reverb = draws["aug"]["add_reverb"]["n_delays"]
    assert torch.equal(part["aug"]["add_reverb"]["n_delays"], reverb[2:])
    assert part["keep"].shape == (2, 1) and part["shift"].shape == (2,)


# ---------------------------------------------------------------------------
# the trainers under a mesh

@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpora")
    speech, noise = root / "speech", root / "noise"
    speech.mkdir()
    noise.mkdir()
    t = np.arange(4 * 22050) / 22050
    for i in range(2):
        jwavio.write(str(speech / f"s{i}.wav"),
                     (0.4 * np.sin(2 * np.pi * (500 + 100 * i) * t)).astype(np.float32), 22050)
    rng = np.random.default_rng(0)
    jwavio.write(str(noise / "n0.wav"), (0.1 * rng.standard_normal(5 * 22050)).astype(np.float32),
                 22050)
    jwavio.write(str(noise / "n1.wav"), (0.1 * rng.standard_normal(22050)).astype(np.float32),
                 22050)
    return str(speech), str(noise)


FIT_KW = dict(steps=2, batch_size=2, augmentations=("reduce_volume",), seed=3, log_every=1,
              device="cpu")
SYN_KW = dict(steps=2, batch_size=2, n_inner=1, pool_speech=2, pool_noise=2, seed=3,
              augmentations=("reduce_volume",), log_every_outer=1, device="cpu")


def test_fit_and_fit_synthetic_under_a_mesh(tmp_path, corpora):
    """Two steps of each trainer on a data 1 × seq 2 mesh of two ranks
    (float32): the first step's metrics are the one-process run's to 1e-6
    relative, the second's to 1e-3 (the first Adam update moves by ±lr the
    elements whose gradients lie within rounding of 0: measured 1.4e-4);
    both ranks report the same global metrics and hold the same weights,
    and rank 0 alone writes the checkpoint, those weights."""
    torch.save({"speech_dir": corpora[0], "noise_dir": corpora[1],
                "fit_kw": {k: v for k, v in FIT_KW.items() if k != "device"},
                "syn_kw": {k: v for k, v in SYN_KW.items() if k != "device"}},
               tmp_path / "inputs.pt")
    outs = run_ranks("fit", 2, tmp_path)
    def strip(ms):
        return [{k: v for k, v in m.items() if k != "wall_seconds"} for m in ms]

    for name, run in (("fit", lambda **kw: fit(*corpora, **kw)), ("syn", fit_synthetic)):
        a, b = outs[0][name], outs[1][name]
        assert strip(a["metrics"]) == strip(b["metrics"]) and len(a["metrics"]) == 2
        for k, v in a["sd"].items():
            assert torch.equal(v, b["sd"][k]), (name, k)
        saved, epoch = load_pth(str(tmp_path / f"{name}.pth"))
        assert epoch == 2
        for k, v in saved.items():
            np.testing.assert_array_equal(np.asarray(v), a["sd"][k].numpy(), err_msg=k)
        steps = []
        run(on_metrics=lambda step, m: steps.append(m), **(FIT_KW if name == "fit" else SYN_KW))
        for tol, got, want in zip((1e-6, 1e-3), a["metrics"], steps):
            for k in ("loss", "mask_loss", "spec_loss"):
                assert abs(got[k] - want[k]) <= tol * abs(want[k]), (name, k, got[k], want[k])
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".pth")) == ["fit.pth", "syn.pth"]


def test_a_one_wide_seq_axis_binds_no_halo():
    """Both sharded steps split the time axis only when the mesh's `seq`
    axis is wider than 1 (JAX: `shard_time=seq > 1`): on a 1 × 1 mesh no
    kernel-3 convolution exchanges halos, and BatchNorm binds to the group.
    (The data 2 × seq 2 parities above need the halos.)"""
    import torch.distributed as dist

    from softspoken_tpu_torch.models.unet import _HaloConv, _TrainStatsBN
    from softspoken_tpu_torch.parallel.distributed import free_port, init_process_group

    mesh = make_mesh(("data", "seq"), shape=(1, 1), devices=["cpu"])
    init_process_group(f"tcp://127.0.0.1:{free_port()}", 1, 0, torch.device("cpu"), 60)
    try:
        for make in (lambda st: tloop.make_sharded_train_step(st, mesh),
                     lambda st: tdd.make_sharded_fused_train_step(
                         st, tdd.make_synth_batch_fn(2, ("reduce_volume",)), mesh, n_inner=1)):
            state = tloop.create_train_state(0)
            make(state)
            mods = list(state.model.modules())
            assert any(isinstance(m, _HaloConv) for m in mods)
            assert all(m.shard is None for m in mods if isinstance(m, _HaloConv))
            assert all(m.shard is not None for m in mods if isinstance(m, _TrainStatsBN))
    finally:
        dist.destroy_process_group()


def test_mesh_training_needs_the_process_group(corpora):
    mesh = make_mesh(("data", "seq"), shape=(1, 2), devices=["cpu"] * 2)
    with pytest.raises(RuntimeError, match="torch.distributed initialized"):
        fit_synthetic(mesh=mesh, **SYN_KW)
    with pytest.raises(RuntimeError, match="torch.distributed initialized"):
        fit(*corpora, mesh=mesh, **FIT_KW)


def test_cli_train_mesh_on_the_cpu_is_a_one_rank_group(tmp_path, capsys):
    """`train --synthetic --mesh --device cpu` runs as a 1 × 1 gloo group in
    the process: the first step's loss is the plain run's (1e-6), the
    weights follow the Adam rule, and the group is gone afterwards."""
    import torch.distributed as dist

    common = ["train", "--synthetic", "--steps", "1", "--batch-size", "2", "--pool-size", "2",
              "--n-inner", "1", "--device", "cpu", "--augment", "reduce_volume", "--seed", "4"]
    assert cli.main([*common, "--out", str(tmp_path / "plain.pth")]) == 0
    plain = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main([*common, "--mesh", "--out", str(tmp_path / "mesh.pth")]) == 0
    meshed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not dist.is_initialized()
    assert abs(meshed["loss"] - plain["loss"]) <= 1e-6 * plain["loss"]
    before = tloop.create_train_state(4).model.state_dict()
    adam_close(load_pth(str(tmp_path / "mesh.pth"))[0], load_pth(str(tmp_path / "plain.pth"))[0],
               before)
