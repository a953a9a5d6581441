"""Driver: the round-5 retrain step (``train --synthetic``), on one card.

Set-up builds, once, the object ``train.fit.fit_synthetic`` builds and
loops over: ``loop.create_train_state`` (AdamW over the model, float32),
``device_data.make_synth_batch_fn`` with the recipe's augmentations, SNRs
and protected confuser policy, and ``device_data.make_fused_train_step``
(``n_inner`` steps per call, metrics averaged and read once per call), the
generator seeded with seed + 1 as ``fit_synthetic`` seeds it.  The pools
come from the benchmark's generator (``generators/clip_pools.py``) and the
initial weights are made on the card from the seed (uniform in +-1/sqrt
(fan in), as torch's default initializer bounds them; BatchNorm at 1 and
0): both are handed to the program and to the reference alike.

The first ``warmup_calls`` calls are set-up; the first three steps of the
first call are recorded for the check (the loss of each, AdamW's first
moment after step 1, the weights after step 3).  The window then calls
the same step object until ``seconds`` have passed; the metrics read that
ends each call is the sync point at both ends of the window.
"""

from __future__ import annotations

import math
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from benchmarks.harness import registry
from benchmarks.reference import specunet
from benchmarks.reference import train as ref_train

RECORDED_STEPS = 3


def init_weights(seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial state dict, made on ``device`` in one draw."""
    shapes = specunet.param_shapes()
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2**63 - 1))
    total = sum(math.prod(s) for s in shapes.values())
    u = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    sd, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        if name.endswith(".1.weight") and len(shape) == 1:      # BatchNorm scale
            sd[name] = torch.ones(shape, device=device)
        elif name.endswith(".1.bias") and len(shape) == 1 and "output_conv.1" not in name:
            sd[name] = torch.zeros(shape, device=device)        # BatchNorm shift
        else:
            fan_in = math.prod(shapes[name.replace(".bias", ".weight")][1:])
            sd[name] = u[at: at + n].view(shape) / math.sqrt(fan_in)
        at += n
    return sd


class Driver:
    def __init__(self, cell: registry.Cell, ctx):
        self.cell = cell
        self.ctx = ctx
        self.recipe = dict(cell.config["recipe"])
        self.recorded: Dict[str, object] = {"loss": []}

    # ------------------------------------------------------------------
    def setup(self, hook=None) -> None:
        r, dev, seed = self.recipe, self.ctx.device, int(self.ctx.seed)
        traffic = self.cell.traffic
        gen = registry.load_module("generators", traffic["generator"], self.cell.root)
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(gen.generate, traffic["params"], seed)
            from softspoken_tpu_torch.train import device_data, loop

            self.init = init_weights(seed, dev)
            self.state = loop.create_train_state(
                seed, r["lr"], r["weight_decay"], compute_dtype=loop.DTYPES[r["dtype"]],
                device=dev)
            missing, unexpected = self.state.model.load_state_dict(self.init, strict=False)
            if unexpected or any(not k.endswith(("running_mean", "running_var",
                                                 "num_batches_tracked")) for k in missing):
                raise RuntimeError(f"initial weights do not fit the model: {missing} "
                                   f"{unexpected}")
            pools = fut.result()
        pin = dev.type == "cuda"
        self.pools = tuple(torch.from_numpy(pools[k]).pin_memory().to(dev, non_blocking=True)
                           if pin else torch.from_numpy(pools[k]).to(dev)
                           for k in ("speech", "noise"))
        r["extras_start"] = self.extras_start(pools["noise"].shape[0])
        synth = device_data.make_synth_batch_fn(
            r["batch_size"], r["augment"], snr_db_range=tuple(r["snr_db"]),
            silence_prob=r["silence_prob"], extras_start=r["extras_start"],
            extras_snr_range=tuple(r["extras_snr_db"]),
            extras_silent_prob=r["extras_silent_prob"])
        inner = loop.train_step
        loop.train_step = self._recording(inner)
        try:
            self.step_fn = device_data.make_fused_train_step(synth, n_inner=r["n_inner"])
        finally:
            loop.train_step = inner
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed + 1)
        if hook is not None:
            hook(self)
        for _ in range(int(self.cell.settings["warmup_calls"])):
            self._call()

    def extras_start(self, n_noise: int):
        r = self.recipe
        n_extra = int(n_noise * r["extra_frac"]) if r["extra_kinds"] else 0
        return n_noise - n_extra if r["policy"] == "protected" and n_extra > 0 else None

    def _recording(self, inner):
        """``train_step`` that keeps what the check needs of the first
        steps; afterwards it only calls through."""
        rec = self.recorded

        def train_step(state, batch, boundary_weight=0.0):
            i = len(rec["loss"])
            m = inner(state, batch, boundary_weight)
            if i < RECORDED_STEPS:
                rec["loss"].append(m["loss"].detach().clone())
                named = dict(state.model.named_parameters())
                if i == 0:  # no state: the optimizer did not update
                    opt = state.optimizer.state
                    rec["exp_avg"] = {k: opt[p]["exp_avg"].detach().clone() if p in opt
                                      else torch.zeros_like(p) for k, p in named.items()}
                if i == RECORDED_STEPS - 1:
                    rec["weights"] = {k: p.detach().clone() for k, p in named.items()}
            return m

        return train_step

    def _call(self) -> List[float]:
        m = self.step_fn(self.state, self.pools[0], self.pools[1], self.gen)
        names = sorted(m)
        return torch.stack([m[k] for k in names]).tolist()  # the loop's one read

    # ------------------------------------------------------------------
    def window(self, seconds: float, spans: bool = False) -> Dict:
        calls = 0
        t0 = time.perf_counter()
        while True:
            if spans:
                with torch.profiler.record_function("bench.train_call"):
                    self._call()
            else:
                self._call()
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        steps = calls * int(self.recipe["n_inner"])
        return {"wall_s": wall, "steps": steps, "clips": steps * int(self.recipe["batch_size"]),
                "attempted": steps, "done": steps, "errors": {}}

    def release(self) -> None:
        del self.state, self.step_fn
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def check(self, windows: List[Dict]) -> List[Dict]:
        limits = self.cell.settings["limits"]
        ref = ref_train.Trainer(self.init, self.pools, self.recipe, int(self.ctx.seed))
        steps = ref.run(RECORDED_STEPS)
        values = {}
        for i in range(RECORDED_STEPS):
            want = steps[i]["loss"]
            got = float(self.recorded["loss"][i])
            values[f"loss_step{i + 1}_rel"] = abs(got - want) / abs(want)
        g_ref = {k: float(v.norm()) for k, v in steps[0]["grads"].items()}
        g_prog = {k: float(v.norm()) / 0.1 for k, v in self.recorded["exp_avg"].items()}
        med = float(np.median(list(g_ref.values())))
        # a leaf whose reference gradient is nought to rounding moves under
        # AdamW by round-off alone: left out by this rule, not by name
        leaves = [k for k, v in g_ref.items() if v >= 1e-3 * med]
        d_ref = {k: float((ref.params[k].detach() - self.init[k]).norm()) for k in leaves}
        d_prog = {k: float((self.recorded["weights"][k] - self.init[k]).norm()) for k in leaves}
        dmed = float(np.median(list(d_ref.values())))
        for tag, got, want, m in (("grad1", g_prog, g_ref, med), ("change3", d_prog, d_ref, dmed)):
            gaps = {k: abs(got[k] - want[k]) / max(want[k], m) for k in leaves}
            worst = max(gaps, key=gaps.get)
            values[f"{tag}_worst_leaf"] = gaps[worst]
            values[f"{tag}_median_leaf"] = float(np.median(list(gaps.values())))
            self.ctx.log(f"check: {tag} worst leaf {worst} {gaps[worst]:.6g} "
                         f"(norm {want[worst]:.6g}, median leaf {m:.6g}), median leaf's gap "
                         f"{values[f'{tag}_median_leaf']:.6g}")
        values["steps_timed"] = float(sum(w["steps"] for w in windows))
        self.ctx.log(f"check: {len(leaves)} of {len(g_ref)} leaves compared; step losses "
                     f"program {[round(float(x), 6) for x in self.recorded['loss']]} reference "
                     f"{[round(s['loss'], 6) for s in steps]}; cudnn.allow_tf32="
                     f"{torch.backends.cudnn.allow_tf32}; not compared: "
                     + ", ".join(f"{k} {v:.6g}" for k, v in values.items() if k not in limits))
        return [{"name": k, "value": v, "limit": limits[k]["limit"], "op": limits[k]["op"]}
                for k, v in values.items() if k in limits]

    # ------------------------------------------------------------------
    def use_control(self, precision: str) -> None:
        """The control: the program's own bfloat16 path (autocast, float32
        weights and optimizer state) from the same weights and draws."""
        from softspoken_tpu_torch.train import loop

        self.state.compute_dtype = loop.DTYPES[precision]

    def plant_fault(self, name: str, patch=setattr) -> None:
        """Break the step underneath: "state_unchanged", the optimizer's
        update does nothing; "half_batch", the loss over the first half of
        the batch's rows only."""
        from softspoken_tpu_torch.train import loop

        if name == "state_unchanged":
            patch(self.state.optimizer, "step", lambda *a, **k: None)
            return
        if name != "half_batch":
            raise KeyError(name)
        loss_fn = loop.loss_fn

        def half(model, batch, boundary_weight=0.0, generator=None):
            rows = batch["mel"].shape[0] // 2
            return loss_fn(model, {k: v[:rows] for k, v in batch.items()}, boundary_weight,
                           generator)

        patch(loop, "loss_fn", half)
