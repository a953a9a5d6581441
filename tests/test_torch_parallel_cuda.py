"""The port's multi-card paths on the card (``parallel/``, NCCL): a
``MeshDetector`` against one card in parity mode, ``train --mesh`` and the
sharded step in a one-rank NCCL group against the unsharded step, and
training over every card against one card.  The sharding's logic is held
on the CPU over gloo (tests/test_torch_parallel_*.py); these hold its NCCL
and card code.

Card only; a test over several cards skips with fewer than two.  The
command is in tests/test_torch_cuda.py's docstring.
"""

import json
import os

import numpy as np
import pytest
import torch

from torch_cuda_helpers import counted_detect, field_wav, need_card, need_cards

pytestmark = pytest.mark.cuda

MESH_GRID_TOL = 1e-5  # float32, TF32 off: convolutions at another batch size round apart
F64_TOL = 1e-6  # float64: reduction orders only (measured ~1e-11 on the CPU)
TRAIN_AUGS = ("add_reverb", "reduce_volume")
# two float32 steps of fit_synthetic at B = 32, compared with TF32 off
SHORT_FIT = dict(steps=2, batch_size=32, n_inner=1, pool_speech=16, pool_noise=16,
                 augmentations=TRAIN_AUGS, seed=0)
# the train cell's point at B = 32: pools 128 + 128, n_inner 10, four outer calls
LONG_FIT = dict(steps=40, batch_size=32, n_inner=10, pool_speech=128, pool_noise=128,
                augmentations=TRAIN_AUGS, seed=0, log_every_outer=1,
                save_every_outer=10 ** 6)


@pytest.fixture(scope="module")
def wav400(tmp_path_factory):
    """Three default chunks (150 s) at 32 kHz."""
    need_card()  # before any work: the test skips without a card
    return field_wav(str(tmp_path_factory.mktemp("mesh") / "field_400s.wav"), 400.0, 32000, 11)


# (engine options, kernels launched once per data entry, kernels launched once)
MESH_CASES = {
    "fused": (dict(pipeline="fused", mel_kernel="fused"), ("frame_mel",), ()),
    "host": (dict(pipeline="host", mel_kernel="pallas"), ("dft_mel",), ()),
    "adpcm4": (dict(pipeline="fused", mel_kernel="fused", upload_codec="adpcm4"),
               ("frame_mel",), ("adpcm_decode",)),
}


@pytest.mark.parametrize("cards", ["cuda0-twice", "every-card"])
@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_detect_matches_one_card(wav400, case, cards):
    """``MeshDetector`` over [cuda:0, cuda:0] or over every card against one
    card, in parity precision (float32, TF32 off) so that the grid speaks
    for the sharding: the grids within 1e-5, the intervals equal, K1 and K2
    launched once per batch per data entry, K3 once per chunk on the
    detector's card (the mesh copies the decoded, resampled chunk)."""
    if cards == "every-card":
        need_cards(2)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        need_card()
        devices = [torch.device("cuda", 0)] * 2
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.ckpt import fixture_state_dict
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.parallel import MeshDetector, make_mesh

    eng, per_entry, once = MESH_CASES[case]
    per = {**dict.fromkeys(per_entry, len(devices)), **dict.fromkeys(once, 1)}
    cfg = Config().with_engine(precision="parity", **eng)
    sd = fixture_state_dict(0)
    one, _c, l1, _n = counted_detect(Detector(cfg, state_dict=sd, device="cuda:0"), wav400)
    det = Detector(cfg, state_dict=sd, device="cuda:0")
    MeshDetector(det, make_mesh(("data",), devices=devices))
    mesh, _c, ln, _n = counted_detect(det, wav400)
    assert float(np.abs(mesh.avg_values - one.avg_values).max()) <= MESH_GRID_TOL
    assert mesh.intervals == one.intervals and mesh.num_windows == one.num_windows
    for k, m in per.items():
        assert l1.get(k, 0) > 0 and ln.get(k, 0) == m * l1[k], (k, l1, ln)


def _f64_state(device, seed: int = 0):
    from softspoken_tpu_torch.train import loop

    model = loop.create_train_state(seed, dropout_p=0.1).model.double().to(device)
    return loop.TrainState(model, loop.make_optimizer(model), seed=seed)


def _f64_batch(B: int, device, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed + 100)
    toggles = rng.uniform(size=(B, 256)) > 0.95
    b = {"mel": rng.uniform(0.0, 1.5, (B, 128, 256)),
         "mask": (np.cumsum(toggles, axis=1) % 2).astype(np.float64),
         "spec": rng.uniform(0.0, 1.0, (B, 2, 128, 256))}
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _sharded_steps_f64(mesh, rank: int, steps: int = 2) -> dict:
    """``steps`` sharded float64 steps of ``make_sharded_train_step`` over
    ``mesh`` on this rank's device, from seeded weights on a seeded global
    batch (B = 2 x data, T = 256, boundary weight 2, dropout 0.1)."""
    from softspoken_tpu_torch.train import loop

    state = _f64_state(list(mesh.devices.flat)[rank])
    step, shard = loop.make_sharded_train_step(state, mesh, boundary_weight=2.0)
    batch = _f64_batch(2 * mesh.shape["data"], state.device)
    ms = [{k: float(v) for k, v in step(state, shard(batch)).items()} for _ in range(steps)]
    return {"sd": {k: v.cpu() for k, v in state.model.state_dict().items()}, "metrics": ms}


def _unsharded_steps_f64(B: int, device, steps: int = 2) -> dict:
    from softspoken_tpu_torch.train import loop

    state = _f64_state(device)
    batch = _f64_batch(B, device)
    ms = [{k: float(v) for k, v in loop.train_step(state, batch, 2.0).items()}
          for _ in range(steps)]
    return {"sd": {k: v.cpu() for k, v in state.model.state_dict().items()}, "metrics": ms}


def _assert_f64_steps_equal(got: dict, want: dict) -> None:
    """Every state tensor within F64_TOL of its max (relative), the metrics
    within F64_TOL relative."""
    for k, v in want["sd"].items():
        if v.is_floating_point():
            err = float((got["sd"][k].double() - v.double()).abs().max()
                        / max(float(v.double().abs().max()), 1e-30))
            assert err <= F64_TOL, (k, err)
    for a, b in zip(got["metrics"], want["metrics"]):
        for k in b:
            assert abs(a[k] - b[k]) <= F64_TOL * abs(b[k]), (k, a[k], b[k])


def _movement(before: dict, got: dict, want: dict) -> float:
    """The relative L2 of the difference between two runs' parameter
    movements (tests/test_torch_parallel_train.py's comparison of float32
    runs: Adam's first update is ±lr wherever a gradient is within rounding
    of 0)."""
    num = den = 0.0
    for k, w in want.items():
        if "running" in k or "num_batches" in k:
            continue
        b = torch.as_tensor(before[k]).double()
        dw = torch.as_tensor(w).double() - b
        num += float(((torch.as_tensor(got[k]).double() - b - dw) ** 2).sum())
        den += float((dw ** 2).sum())
    return (num / max(den, 1e-30)) ** 0.5


def test_sharded_float64_steps_in_a_one_rank_nccl_group_equal_the_unsharded():
    need_card()
    import torch.distributed as dist

    from softspoken_tpu_torch.parallel import make_mesh
    from softspoken_tpu_torch.parallel.distributed import free_port, init_process_group

    dev0 = torch.device("cuda", 0)
    mesh = make_mesh(("data", "seq"), shape=(1, 1), devices=[dev0])
    init_process_group(f"tcp://localhost:{free_port()}", 1, 0, dev0, timeout_s=300)
    try:
        got = _sharded_steps_f64(mesh, 0)
    finally:
        dist.destroy_process_group()
    _assert_f64_steps_equal(got, _unsharded_steps_f64(2, dev0))


def test_train_mesh_in_a_one_rank_nccl_group_matches_train(tmp_path, capsys, monkeypatch):
    """``train --synthetic --mesh`` as one rank (B = 8, two float32 steps,
    TF32 off in both) against ``train``: loss within 1e-3, the parameters'
    movement within 0.2 relative L2, the group gone afterwards."""
    need_card()
    import torch.distributed as dist

    from softspoken_tpu_torch import cli
    from softspoken_tpu_torch.ckpt import load_pth
    from softspoken_tpu_torch.ops.mel import fp32_matmul
    from softspoken_tpu_torch.parallel.distributed import free_port
    from softspoken_tpu_torch.train.loop import create_train_state

    common = ["train", "--synthetic", "--steps", "2", "--batch-size", "8", "--pool-size", "8",
              "--n-inner", "1", "--augment", *TRAIN_AUGS, "--seed", "3"]
    plain_pth, mesh_pth = str(tmp_path / "plain.pth"), str(tmp_path / "mesh.pth")
    with fp32_matmul():  # TF32 convolutions would round the two runs apart at 1e-3
        assert cli.main([*common, "--out", plain_pth]) == 0
        plain = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        for k, v in (("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0"),
                     ("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(free_port()))):
            monkeypatch.setenv(k, v)
        assert cli.main([*common, "--mesh", "--out", mesh_pth]) == 0
        meshed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not dist.is_initialized()
    sd, epoch = load_pth(mesh_pth)
    assert epoch == 2
    assert abs(meshed["loss"] - plain["loss"]) <= 1e-3 * plain["loss"]
    assert _movement(create_train_state(3).model.state_dict(), sd, load_pth(plain_pth)[0]) <= 0.2


def _train_ranks(rank: int, world: int, init: str, work: str, devices: list,
                 short_fit: dict, long_fit: dict) -> None:
    """One rank of ``test_training_over_every_card_matches_one_card`` on a
    (world / 2, 2) mesh: two float64 sharded steps, then ``short_fit`` with
    TF32 off, then ``long_fit``; rank 0 saves what the test compares."""
    import torch.distributed as dist

    from softspoken_tpu_torch.ops.mel import fp32_matmul
    from softspoken_tpu_torch.parallel import make_mesh
    from softspoken_tpu_torch.parallel.distributed import init_process_group
    from softspoken_tpu_torch.train import fit_synthetic

    mesh = make_mesh(("data", "seq"), shape=(world // 2, 2), devices=devices)
    init_process_group(init, world, rank, list(mesh.devices.flat)[rank], timeout_s=300)
    try:
        f64 = _sharded_steps_f64(mesh, rank)
        with fp32_matmul():
            fit_synthetic(mesh=mesh, ckpt_out=os.path.join(work, "mesh_short.pth"), **short_fit)
        seen = []
        fit_synthetic(mesh=mesh, ckpt_out=os.path.join(work, "mesh_long.pth"),
                      on_metrics=lambda step, m: seen.append(m), **long_fit)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        torch.save(f64, os.path.join(work, "mesh_f64.pt"))
        with open(os.path.join(work, "mesh_long.json"), "w") as f:
            json.dump(seen, f)


def test_training_over_every_card_matches_one_card(tmp_path):
    """(n / 2, 2) training over every card in n processes against one card:
    two float64 sharded steps within 1e-6 of the unsharded ones; two
    float32 ``fit_synthetic`` steps at B = 32 with TF32 off, the parameters'
    movement within 0.2 relative L2; 40 steps at the train cell's point
    (B = 32, pools 128 + 128, n_inner 10), the loss of each outer call
    within 2% and the movement within 1.0 (runs that differ in rounding
    drift apart under Adam)."""
    need_cards(2)
    from softspoken_tpu_torch.ckpt import load_pth
    from softspoken_tpu_torch.ops.mel import fp32_matmul
    from softspoken_tpu_torch.parallel import distributed as pdist
    from softspoken_tpu_torch.train import fit_synthetic
    from softspoken_tpu_torch.train.loop import create_train_state

    world = 2 * (torch.cuda.device_count() // 2)
    devices = [torch.device("cuda", i) for i in range(world)]
    work = str(tmp_path)
    pdist.spawn(_train_ranks, world, args=(world, f"tcp://localhost:{pdist.free_port()}", work,
                                           devices, SHORT_FIT, LONG_FIT), timeout_s=900)
    dev0 = torch.device("cuda", 0)
    _assert_f64_steps_equal(torch.load(os.path.join(work, "mesh_f64.pt")),
                            _unsharded_steps_f64(2 * (world // 2), dev0))
    init = create_train_state(0).model.state_dict()
    with fp32_matmul():
        fit_synthetic(ckpt_out=os.path.join(work, "one_short.pth"), device=dev0, **SHORT_FIT)
    assert _movement(init, load_pth(os.path.join(work, "mesh_short.pth"))[0],
                     load_pth(os.path.join(work, "one_short.pth"))[0]) <= 0.2
    seen = []
    fit_synthetic(ckpt_out=os.path.join(work, "one_long.pth"), device=dev0,
                  on_metrics=lambda step, m: seen.append(m), **LONG_FIT)
    with open(os.path.join(work, "mesh_long.json")) as f:
        meshed = json.load(f)
    assert len(meshed) == len(seen) == 4
    for m, one in zip(meshed, seen):
        assert abs(m["loss"] - one["loss"]) <= 0.02 * one["loss"], (m, one)
    assert _movement(init, load_pth(os.path.join(work, "mesh_long.pth"))[0],
                     load_pth(os.path.join(work, "one_long.pth"))[0]) <= 1.0
