"""One rank of the port's multi-process CPU tests (tests/test_torch_parallel_*.py).

    python tests/torch_parallel_worker.py CASE INIT_METHOD WORLD RANK WORKDIR

joins a gloo process group of WORLD ranks at INIT_METHOD, runs CASE with
the inputs the test left in WORKDIR, and saves this rank's results to
WORKDIR/rank<RANK>.pt.  It imports torch and the port only, never JAX.
The tests start the ranks with ``run_ranks``.
"""

import os
import subprocess
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from softspoken_tpu_torch.parallel import make_mesh  # noqa: E402
from softspoken_tpu_torch.parallel.distributed import free_port, init_process_group  # noqa: E402


def run_ranks(case: str, world: int, work, timeout: float = 240.0) -> list:
    """Run CASE in WORLD fresh processes (one thread each) and return each
    rank's results.  A rank that fails, or a run past ``timeout`` seconds,
    fails the calling test; no process outlives the call."""
    init = f"tcp://127.0.0.1:{free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), case, init,
                               str(world), str(r), str(work)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {case} exited {p.returncode}:\n{out[-4000:]}"
    return [torch.load(os.path.join(str(work), f"rank{r}.pt")) for r in range(world)]


def _mesh(world):
    seq = 2 if world % 2 == 0 else 1
    return make_mesh(("data", "seq"), shape=(world // seq, seq), devices=["cpu"] * world)


def case_allreduce(rank, world, work):
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    return {"sum": t}


def case_halo(rank, world, work):
    """Kernel-3 convolutions over a time axis split in `world` blocks
    (data 1 × seq world), forward and backward, float64."""
    from softspoken_tpu_torch.models.unet import HaloConv1d, HaloConv2d
    from softspoken_tpu_torch.parallel.grid import ProcessGrid

    inp = torch.load(os.path.join(work, "inputs.pt"))
    grid = ProcessGrid(make_mesh(("data", "seq"), shape=(1, world), devices=["cpu"] * world))
    out = {}
    for name, cls in (("2d", HaloConv2d), ("1d", HaloConv1d)):
        x, w, b, gout = (inp[f"{name}_{k}"] for k in ("x", "w", "b", "gout"))
        conv = cls(w.shape[1], w.shape[0], 3, padding=1).double()
        conv.weight.data.copy_(w)
        conv.bias.data.copy_(b)
        conv.shard = grid
        W = x.shape[-1] // world
        xs = x[..., rank * W: (rank + 1) * W].clone().requires_grad_(True)
        y = conv(xs)
        (y * gout[..., rank * W: (rank + 1) * W]).sum().backward()
        out.update({f"{name}_y": y.detach(), f"{name}_dx": xs.grad,
                    f"{name}_dw": conv.weight.grad, f"{name}_db": conv.bias.grad})
    return out


def case_batchnorm(rank, world, work):
    """A training-mode BatchNorm2d with the batch rows split over `world`
    ranks (data world × seq 1), float32, forward and backward."""
    from softspoken_tpu_torch.models.unet import BatchNorm2d
    from softspoken_tpu_torch.parallel.grid import ProcessGrid

    inp = torch.load(os.path.join(work, "inputs.pt"))
    bn = BatchNorm2d(inp["x"].shape[1])
    bn.weight.data.copy_(inp["w"])
    bn.bias.data.copy_(inp["b"])
    bn.shard = ProcessGrid(make_mesh(("data", "seq"), shape=(world, 1),
                                     devices=["cpu"] * world))
    rows = inp["x"].shape[0] // world
    block = slice(rank * rows, (rank + 1) * rows)
    x = inp["x"][block].clone().requires_grad_(True)
    y = bn(x)
    (y * inp["gout"][block]).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var}


def _float64_state(work):
    """The test's weights in a float64 model, its AdamW, its seed."""
    from softspoken_tpu_torch.models.unet import SpecUNet2D
    from softspoken_tpu_torch.train import loop

    inp = torch.load(os.path.join(work, "inputs.pt"))
    model = SpecUNet2D(folded=False, dropout_p=inp["dropout_p"]).double()
    model.load_state_dict(inp["state_dict"])
    state = loop.TrainState(model, loop.make_optimizer(model, inp["lr"]), seed=inp["seed"])
    return inp, state


def _state_out(state):
    opt = state.optimizer.state
    names = dict((id(p), n) for n, p in state.model.named_parameters())
    out = {"sd": state.model.state_dict(), "step": torch.tensor(state.step)}
    for p, st in opt.items():
        out["exp_avg." + names[id(p)]] = st["exp_avg"]
        out["exp_avg_sq." + names[id(p)]] = st["exp_avg_sq"]
    return out


def case_train_step(rank, world, work):
    """One make_sharded_train_step on a data 2 × seq 2 mesh, float64."""
    from softspoken_tpu_torch.train import loop

    inp, state = _float64_state(work)
    step, shard = loop.make_sharded_train_step(state, _mesh(world),
                                               boundary_weight=inp["bw"])
    m = step(state, shard(inp["batch"]))
    return {"metrics": m, **_state_out(state)}


def case_fused_step(rank, world, work):
    """make_sharded_fused_train_step, n_inner steps, float64 model."""
    from softspoken_tpu_torch.train import device_data as dd

    inp, state = _float64_state(work)
    synth = dd.make_synth_batch_fn(inp["batch_size"], inp["augs"])
    fused = dd.make_sharded_fused_train_step(state, synth, _mesh(world),
                                             n_inner=inp["n_inner"])
    gen = torch.Generator()
    gen.manual_seed(inp["gen_seed"])
    m = fused(state, inp["speech"], inp["noise"], gen)
    return {"metrics": m, **_state_out(state)}


def case_fit(rank, world, work):
    """fit(mesh=) and fit_synthetic(mesh=): each one's metrics per step and
    the final weights of this rank."""
    from softspoken_tpu_torch.train import fit as tfit

    inp = torch.load(os.path.join(work, "inputs.pt"))
    mesh = _mesh(world)
    states, out = [], {}
    make_state = tfit.create_train_state

    def keep(*a, **k):
        states.append(make_state(*a, **k))
        return states[-1]

    tfit.create_train_state = keep
    for name, run, kw in (("fit", tfit.fit, dict(speech_dir=inp["speech_dir"],
                                                 noise_dir=inp["noise_dir"], **inp["fit_kw"])),
                          ("syn", tfit.fit_synthetic, inp["syn_kw"])):
        steps = []
        run(mesh=mesh, ckpt_out=os.path.join(work, f"{name}.pth"),
            on_metrics=lambda step, m: steps.append(dict(m)), **kw)
        out[name] = {"metrics": steps, "sd": states[-1].model.state_dict()}
    return out


def main():
    case, init_method, world, rank, work = sys.argv[1:6]
    world, rank = int(world), int(rank)
    torch.set_num_threads(1)
    init_process_group(init_method, world, rank, torch.device("cpu"), timeout_s=120)
    try:
        out = globals()["case_" + case](rank, world, work)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
